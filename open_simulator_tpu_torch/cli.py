"""Command line of the PyTorch/CUDA port: `simon apply`, `prove`, `runs`,
`sweep`, `chaos` and `server` on the port's engine.

    python -m open_simulator_tpu_torch.cli apply -f example/simon-config.yaml \\
        [--device cpu] [--output-file F] [--default-scheduler-config F] \\
        [--use-greed] [--extended-resources gpu,open-local] \\
        [-i/--interactive] [--no-auto-plan] [--run-dir D] [--resume [D]]
    python -m open_simulator_tpu_torch.cli prove [--device cpu] \\
        [--engine serial|wave] [--smoke N] [--mutate tiebreak|nocommit] \\
        [--contract PATH | --write-contract] [--chunk S] [--format text|json]
    python -m open_simulator_tpu_torch.cli runs list|show|resume [D] [--root R] \\
        [--format text|json] [-f CONFIG] [--device cpu]
    python -m open_simulator_tpu_torch.cli sweep -f CONFIG \\
        (--node-counts 4,8,16 | --capacity [--run-dir D [--resume]]) [--device cpu]
    python -m open_simulator_tpu_torch.cli chaos -f CONFIG --fault-plan PLAN \\
        [--capacity [--run-dir D]] [--device cpu]
    python -m open_simulator_tpu_torch.cli server [--port 9998] [--device cpu] \\
        [--kubeconfig F] [--master URL] [--queue-depth N] [--pack-window-ms MS] \\
        [--coalesce-ms MS] [--default-deadline-ms MS]

Runs on CUDA unless `--device` says otherwise, and fails without a card.
The text output and exit codes are the JAX package's CLI's, the device name
apart.

apply: when pods stay unscheduled and the config names a new node, the
add-node capacity search runs (engine/capacity.py) and the report shows the
planned cluster; `--interactive` runs the reference's add-node loop instead,
and `--no-auto-plan` reports the unscheduled pods. Exit code 0 when every
pod placed, 2 when some stayed unscheduled, 1 on an error, 3 when a
simulation or sweep outlived OSIM_CALL_DEADLINE_S seconds: the CLI then
exits, which ends the abandoned work with the process (the port has no CPU
degrade; with `--run-dir` the fire is journaled and `runs resume` continues
the run on the same device). `--run-dir` journals the run
(durable/journal.py), `--resume` continues a journaled one, and `--metrics-file` writes the
metrics registry's snapshot as JSON after the run. The reference's
`--devices` (other than 1) parses and then fails with exit code 1 and a
message naming the ROADMAP item that ports it.

runs: list the journaled runs under a root, show one run's summary and
journal, or resume an interrupted apply or capacity sweep from its journal.

sweep: node-count scenarios of one config through simulate_batch, or the
batched capacity search (`--capacity`), journaled with `--run-dir`.

chaos: an apply under a fault plan, with a deterministic report of what
degraded and what failed; `--capacity` runs the mid-plan-kill scenario (a
journaled chunked capacity sweep in a subprocess under the plan's device
faults, resumed when killed, its placement digest held against a clean run).

server: the REST simulation service (server/server.py) on 127.0.0.1, with
admission control, the continuous-batching scheduler loop, warm scenario
sessions, async jobs and, with --kubeconfig/--master, a cached live-cluster
snapshot held on the device. SIGTERM or SIGINT drains it and exits 0.

prove: the small-scope semantics check (analysis/semantics.py). Exit code 0
when every universe agrees with the oracle and the contract verifies, 1 on
a divergence or a contract mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _add_apply(sub) -> None:
    p = sub.add_parser("apply", help="simulate deploying applications")
    p.add_argument("-f", "--simon-config", required=True, help="path of simon config")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--output-file", default="", help="write the report to a file")
    p.add_argument("--default-scheduler-config", "--scheduler-config",
                   dest="default_scheduler_config", default="",
                   help="KubeSchedulerConfiguration YAML merged with simon's plugin set")
    p.add_argument("--use-greed", action="store_true",
                   help="order pods by descending dominant resource share first")
    p.add_argument("--extended-resources", default="",
                   help="comma list: gpu,open-local (extended report views)")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="reference-style interactive add-node loop")
    p.add_argument("--no-auto-plan", action="store_true",
                   help="report unscheduled pods instead of searching for nodes")
    # the reference's flags of items the port has not reached yet
    p.add_argument("--devices", type=int, default=1,
                   help="shard the node axis across devices (not ported: item 13b)")
    p.add_argument("--metrics-file", default="",
                   help="after the run, write the scheduler metrics snapshot as JSON here")
    p.add_argument("--run-dir", default="",
                   help="journal the run into this directory: every capacity trial is "
                   "committed as it completes")
    p.add_argument("--resume", nargs="?", const=True, default=False, metavar="RUN_DIR",
                   help="resume a journaled run: completed trials replay from the journal "
                   "instead of re-simulating (RUN_DIR defaults to --run-dir)")


def _add_runs(sub) -> None:
    p = sub.add_parser("runs", help="list, inspect, and resume journaled runs")
    p.add_argument("action", choices=("list", "show", "resume"),
                   help="list all runs / show one run / resume an interrupted apply")
    p.add_argument("run_dir", nargs="?", default="",
                   help="run directory (required for show/resume)")
    p.add_argument("--root", default="",
                   help="runs root for `list` (default: OSIM_RUNS_DIR or "
                   "~/.cache/open-simulator-tpu/runs)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("-f", "--simon-config", default="",
                   help="resume: config path override (default: the journaled one)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _add_sweep(sub) -> None:
    p = sub.add_parser("sweep", help="batched multi-scenario simulation")
    p.add_argument("-f", "--simon-config", required=True, help="path of simon config")
    p.add_argument("--node-counts", default="",
                   help="comma list of node counts; one scenario per count, each keeping "
                   "only the first N cluster nodes (e.g. 4,8,16)")
    p.add_argument("--capacity", action="store_true",
                   help="batched capacity search: minimum clones of the config's newNode "
                   "so everything schedules")
    p.add_argument("--use-greed", action="store_true",
                   help="order pods by descending dominant resource share")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--run-dir", default="",
                   help="journal a --capacity sweep into this directory")
    p.add_argument("--resume", action="store_true",
                   help="resume a journaled --capacity sweep")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _add_chaos(sub) -> None:
    p = sub.add_parser(
        "chaos", help="run an apply under a deterministic fault plan and report "
        "degraded vs failed behavior",
    )
    p.add_argument("-f", "--simon-config", required=True, help="path of simon config")
    p.add_argument("--fault-plan", default="",
                   help="fault plan YAML path (default: the OSIM_FAULT_PLAN env var)")
    p.add_argument("--default-scheduler-config", default="",
                   help="KubeSchedulerConfiguration YAML merged with simon's plugin set")
    p.add_argument("--capacity", action="store_true",
                   help="mid-plan-kill scenario: a chunked capacity sweep under the plan's "
                   "device faults, resumed, held against a clean reference")
    p.add_argument("--run-dir", default="",
                   help="--capacity: journal the faulted sweep here (default: a temporary "
                   "directory, removed afterwards)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _add_prove(sub) -> None:
    p = sub.add_parser(
        "prove", help="exhaustive small-scope semantics check against the pure oracle "
        "and commit-order contract verification",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--contract", default=None, metavar="PATH",
                   help="contract artifact to verify (default: budgets/commit_contract.json)")
    p.add_argument("--write-contract", action="store_true",
                   help="bank this run's placement digest as the contract instead of verifying")
    p.add_argument("--smoke", type=int, default=None, metavar="N",
                   help="check only N universes strided across the corpus (no contract verdict)")
    p.add_argument("--chunk", type=int, default=None, metavar="S",
                   help="universes per device call (default: 25608)")
    p.add_argument("--mutate", choices=("tiebreak", "nocommit"), default=None,
                   help="run a deliberately wrong engine; the checker must exit 1")
    p.add_argument("--engine", choices=("serial", "wave"), default="serial",
                   help="the serial scan or the conflict-parallel wave engine")


def _add_server(sub) -> None:
    p = sub.add_parser("server", help="run the REST simulation service")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--kubeconfig", default="",
                   help="snapshot this cluster when the request body carries no cluster spec")
    p.add_argument("--master", default="",
                   help="apiserver URL overriding the kubeconfig's server")
    p.add_argument("--queue-depth", type=int, default=None,
                   help="admission queue depth before 429 shedding "
                   "(default: OSIM_SERVER_QUEUE_DEPTH or 16)")
    p.add_argument("--pack-window-ms", type=float, default=None,
                   help="upper bound on how long the scheduler loop holds a partial pack "
                   "open; lone requests and full packs dispatch at once "
                   "(default: OSIM_SERVER_PACK_WINDOW_MS or 0)")
    p.add_argument("--coalesce-ms", type=float, default=None,
                   help="deprecated alias of --pack-window-ms")
    p.add_argument("--default-deadline-ms", type=float, default=None,
                   help="deadline of requests without an X-Osim-Deadline-Ms header "
                   "(default: OSIM_SERVER_DEFAULT_DEADLINE_MS or 0 = none)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="open_simulator_tpu_torch.cli")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_apply(sub)
    _add_chaos(sub)
    _add_prove(sub)
    _add_runs(sub)
    _add_server(sub)
    _add_sweep(sub)
    return ap


def _unported_apply_flags(args) -> Optional[str]:
    """The not-ported message of the first reference-only flag given."""
    from .engine.simulator import _not_ported

    if args.devices != 1:
        return str(_not_ported("--devices (a device mesh)", "13b", "parallelism"))
    return None


def _run_apply(args) -> int:
    from .api.config import SimonConfig
    from .durable.watchdog import BackendUnavailable, DeadlineExceeded
    from .engine.apply import ApplyError, run_apply

    unported = _unported_apply_flags(args)
    if unported:
        print(f"error: {unported}", file=sys.stderr)
        return 1
    try:
        ext = [s.strip() for s in args.extended_resources.split(",") if s.strip()] or None
        unknown = set(ext or ()) - {"gpu", "open-local"}
        if unknown:
            raise ApplyError(
                f"--extended-resources: unknown resource(s) {sorted(unknown)}; "
                "expected gpu, open-local"
            )
        run_dir = args.run_dir or (args.resume if isinstance(args.resume, str) else "")
        if args.resume and not run_dir:
            raise ApplyError("--resume needs a run dir (inline or --run-dir)")
        cfg = SimonConfig.load(args.simon_config)
        out = open(args.output_file, "w") if args.output_file else None
        try:
            outcome = run_apply(
                cfg, interactive=args.interactive, auto_plan=not args.no_auto_plan, out=out,
                scheduler_config=args.default_scheduler_config, use_greed=args.use_greed,
                extended_resources=ext, run_dir=run_dir, resume=bool(args.resume),
                config_path=args.simon_config, device=args.device,
            )
        finally:
            if out is not None:
                out.close()
        if args.metrics_file:
            from .utils.metrics import REGISTRY

            with open(args.metrics_file, "w") as fh:
                json.dump(REGISTRY.snapshot(), fh, indent=2)
    except (ApplyError, ValueError, OSError, BackendUnavailable) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except DeadlineExceeded as e:
        print(f"error: {e}; abandoned", file=sys.stderr)
        return 3
    return 0 if not outcome.result.unscheduled else 2


def _run_runs(args) -> int:
    from .durable import default_runs_root, list_runs, replay, summarize_run
    from .durable.watchdog import BackendUnavailable, DeadlineExceeded

    if args.action == "list":
        rows = list_runs(args.root or default_runs_root())
        if args.format == "json":
            print(json.dumps(rows, indent=2, sort_keys=True))
            return 0
        if not rows:
            print(f"no journaled runs under {args.root or default_runs_root()}")
            return 0
        print(f"{'RUN':<28} {'KIND':<6} {'STATUS':<18} {'TRIALS':>6} {'SEGS':>4} "
              f"{'DEVICE':<14} PATH")
        for r in rows:
            flag = " (cpu-fallback)" if r["fallback"] == "cpu" else ""
            print(
                f"{r['name']:<28} {r['kind']:<6} {r['status']:<18} "
                f"{r['trials']:>6} {r['segments']:>4} "
                f"{(r['device'] or '?'):<14} {r['run_dir']}{flag}"
            )
        return 0

    if not args.run_dir:
        print(f"error: `runs {args.action}` needs a run directory", file=sys.stderr)
        return 1
    summary = summarize_run(args.run_dir)
    if not summary["events"]:
        print(f"error: no journal found in {args.run_dir}", file=sys.stderr)
        return 1

    if args.action == "show":
        events = replay(args.run_dir)
        if args.format == "json":
            print(json.dumps({"summary": summary, "events": events}, indent=2, sort_keys=True))
            return 0
        for k in ("run_dir", "kind", "config", "status", "outcome", "device",
                  "fallback", "events", "trials", "segments", "resumes", "watchdogs"):
            print(f"{k:>10}: {summary[k]}")
        print("journal:")
        for e in events:
            extra = {k: v for k, v in e.items() if k not in ("seq", "ts", "event")}
            print(f"  [{e['seq']:>4}] {e['event']:<18} {json.dumps(extra, sort_keys=True)}")
        return 0

    # resume: apply and sweep runs (the reference's bench runs resume through
    # its bench script, which the port does not have yet: ROADMAP.md item 6)
    if summary["kind"] not in ("apply", "sweep"):
        print(
            f"error: run {args.run_dir} is kind={summary['kind'] or '?'}; "
            "`simon runs resume` handles apply and sweep runs — resume "
            "bench runs with `python bench.py --resume RUN_DIR`",
            file=sys.stderr,
        )
        return 1
    config_path = args.simon_config or summary["config"]
    if not config_path:
        print("error: the journal records no config path; pass -f/--simon-config",
              file=sys.stderr)
        return 1
    if summary["kind"] == "sweep":
        start = (replay(args.run_dir) or [{}])[0]
        return _run_sweep(argparse.Namespace(
            simon_config=config_path, capacity=True, node_counts="",
            use_greed=bool(start.get("use_greed")), format="text",
            run_dir=args.run_dir, resume=True, device=args.device,
        ))
    from .api.config import SimonConfig
    from .engine.apply import ApplyError, run_apply

    try:
        cfg = SimonConfig.load(config_path)
        outcome = run_apply(cfg, run_dir=args.run_dir, resume=True, config_path=config_path,
                            device=args.device)
    except (ApplyError, ValueError, OSError, BackendUnavailable) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except DeadlineExceeded as e:
        print(f"error: {e}; abandoned", file=sys.stderr)
        return 3
    return 0 if not outcome.result.unscheduled else 2


def _run_sweep(args) -> int:
    import time

    from .api.config import SimonConfig
    from .engine.apply import ApplyError, build_apps, build_cluster, load_new_node
    from .engine.simulator import Scenario, simulate_batch

    try:
        cfg = SimonConfig.load(args.simon_config)
        cluster = build_cluster(cfg)
        apps = build_apps(cfg)
    except (ApplyError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.capacity:
        from .durable.watchdog import DeadlineExceeded
        from .engine.capacity import plan_capacity

        new_node = load_new_node(cfg)
        if new_node is None:
            print("error: --capacity needs a newNode candidate in the config", file=sys.stderr)
            return 1
        journal = None
        if args.run_dir:
            from .durable import RunJournal

            journal = RunJournal.open(args.run_dir)
            if args.resume:
                journal.append("run_resume")
            else:
                journal.append("run_start", kind="sweep", simon_config=args.simon_config,
                               use_greed=bool(args.use_greed))
        elif args.resume:
            print("error: --resume needs --run-dir", file=sys.stderr)
            return 1
        t0 = time.monotonic()
        try:
            plan = plan_capacity(
                cluster, apps, new_node, use_greed=args.use_greed, journal=journal,
                resume=args.resume, sweep_mode="batched", device=args.device,
            )
        except DeadlineExceeded as e:
            if journal is not None:
                journal.append("watchdog", stage=e.stage, deadline_s=e.deadline_s)
            print(f"error: {e}; abandoned", file=sys.stderr)
            return 3
        wall = time.monotonic() - t0
        if journal is not None:
            from .durable import atomic_write
            from .engine.apply import placement_digest

            journal.append(
                "run_end", outcome="ok" if plan is not None else "does_not_fit",
                nodes_added=plan.nodes_added if plan else -1,
            )
            # timestamp-free: a killed-then-resumed sweep writes the bytes
            # an uninterrupted one does
            atomic_write(
                os.path.join(journal.run_dir, "outcome.json"),
                json.dumps(
                    {
                        "outcome": "ok" if plan else "does_not_fit",
                        "kind": "sweep",
                        "nodes_added": plan.nodes_added if plan else -1,
                        "attempts": plan.attempts if plan else 0,
                        "batched_calls": plan.batched_calls if plan else 0,
                        "retries": plan.retries if plan else 0,
                        "unscheduled": len(plan.result.unscheduled) if plan else -1,
                        "placement_digest": placement_digest(plan.result) if plan else "",
                    },
                    indent=2,
                    sort_keys=True,
                ) + "\n",
            )
            journal.close()
        if plan is None:
            print("capacity sweep failed: workload does not fit", file=sys.stderr)
            return 2
        doc = {
            "nodes_added": plan.nodes_added,
            "attempts": plan.attempts,
            "batched_calls": plan.batched_calls,
            "retries": plan.retries,
            "wall_s": round(wall, 3),
        }
        if args.format == "json":
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            print(
                f"capacity sweep: add {plan.nodes_added} x {new_node.name} "
                f"({plan.attempts} scenario verdicts in "
                f"{plan.batched_calls} batched call(s), {wall:.2f}s)"
            )
        return 0

    try:
        counts = [int(s) for s in args.node_counts.split(",") if s.strip()]
    except ValueError:
        print(f"error: --node-counts must be a comma list of integers, got "
              f"{args.node_counts!r}", file=sys.stderr)
        return 1
    if not counts:
        print("error: pass --node-counts or --capacity (nothing to sweep)", file=sys.stderr)
        return 1
    scenarios = [Scenario(name=f"nodes-{k}", node_count=k) for k in counts]
    t0 = time.monotonic()
    try:
        results = simulate_batch(cluster, apps, scenarios, use_greed=args.use_greed,
                                 device=args.device)
    except ValueError as e:  # e.g. a count outside [0, n_nodes]
        print(f"error: {e}", file=sys.stderr)
        return 1
    wall = time.monotonic() - t0
    rows = []
    for sc, res in zip(scenarios, results):
        rows.append({
            "scenario": sc.name,
            "nodes": sc.node_count,
            "pods_placed": sum(len(st.pods) for st in res.node_status),
            "unscheduled": len(res.unscheduled),
        })
    if args.format == "json":
        print(json.dumps({"scenarios": rows, "wall_s": round(wall, 3)}, indent=2,
                         sort_keys=True))
    else:
        print(f"{'SCENARIO':<16} {'NODES':>6} {'PLACED':>8} {'UNSCHEDULED':>12}")
        for r in rows:
            print(f"{r['scenario']:<16} {r['nodes']:>6} {r['pods_placed']:>8} "
                  f"{r['unscheduled']:>12}")
        print(f"{len(rows)} scenario(s) in {wall:.2f}s (one batched sweep)")
    return 0 if all(r["unscheduled"] == 0 for r in rows) else 2


def _counter_total(counter) -> int:
    return int(sum(s["value"] for s in counter.snapshot()["samples"]))


def _run_chaos(args) -> int:
    import io

    from .api.config import SimonConfig
    from .engine.apply import ApplyError, run_apply
    from .resilience import faults
    from .resilience.policy import breaker_states, reset_breakers
    from .utils import metrics

    try:
        plan = (faults.FaultPlan.load(args.fault_plan) if args.fault_plan
                else faults.FaultPlan.from_env())
    except faults.FaultInjectionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if plan is None:
        print("error: no fault plan (pass --fault-plan or set OSIM_FAULT_PLAN)",
              file=sys.stderr)
        return 1
    if args.capacity:
        return _run_chaos_capacity(args, plan)

    # a clean slate makes the report a function of (config, plan seed)
    metrics.REGISTRY.reset()
    reset_breakers()
    injector = faults.install_plan(plan)
    aborted = ""
    outcome = None
    try:
        cfg = SimonConfig.load(args.simon_config)
        outcome = run_apply(
            cfg, out=io.StringIO(),  # the chaos report replaces the apply report
            scheduler_config=args.default_scheduler_config, device=args.device,
        )
    except (ApplyError, ValueError, OSError) as e:
        aborted = str(e)
        # the abort leaves the post-mortem artifact a real crash would
        try:
            from .utils import flightrec

            flightrec.dump("chaos-abort", error=aborted)
        except Exception:
            pass
    finally:
        faults.uninstall_plan()

    lines = ["simon chaos report", "=================="]
    lines.append(f"fault plan: seed={plan.seed}, {len(plan.rules)} rule(s)")
    for i, r in enumerate(injector.summary(), 1):
        lines.append(
            f"  rule {i}: target={r['target']} op={r['op'] or '*'} "
            f"kind={r['kind']} -> injected {r['injected']} of "
            f"{r['matched']} matched call(s)"
        )
    if aborted:
        lines.append(f"outcome: failed — apply aborted: {aborted}")
        print("\n".join(lines))
        return 1

    retries = _counter_total(metrics.RETRY_ATTEMPTS)
    skips = _counter_total(metrics.EXTENDER_SKIPPED)
    stale = _counter_total(metrics.SNAPSHOT_STALE)
    # shedding is admission control working (a definite 429/503), a drop is
    # its failure (both counted by the server's admission queue)
    shed = _counter_total(metrics.REQUESTS_SHED)
    dropped = _counter_total(metrics.REQUESTS_DROPPED)
    # a resident repair is the anti-entropy loop working: degradation
    repairs = _counter_total(metrics.RESIDENT_DRIFT_REPAIRS)
    failed_apps = sorted(fa.name for fa in outcome.failed_apps)
    not_closed = sorted(ep for ep, state in breaker_states().items() if state != "closed")
    unscheduled = outcome.result.unscheduled
    degraded = bool(retries or skips or stale or failed_apps or not_closed or shed or repairs)

    lines.append("degraded:")
    lines.append(
        "  apps failed to render: "
        + (f"{len(failed_apps)} ({', '.join(failed_apps)})" if failed_apps else "0")
    )
    lines.append(f"  retries performed: {retries}")
    lines.append(f"  ignorable extenders skipped: {skips}")
    lines.append(f"  stale snapshots served: {stale}")
    lines.append(f"  requests shed with Retry-After: {shed}")
    lines.append(f"  resident drift repairs: {repairs}")
    lines.append("  circuit breakers not closed: " + (", ".join(not_closed) if not_closed else "none"))
    lines.append("failed:")
    lines.append(f"  unscheduled pods: {len(unscheduled)}")
    for reason in sorted({u.reason for u in unscheduled}):
        lines.append(f"    reason: {reason}")
    lines.append(f"  requests dropped without response: {dropped}")
    if unscheduled:
        lines.append("outcome: failed — pods went unscheduled under the fault plan")
    elif dropped:
        lines.append("outcome: failed — requests were dropped without a response")
    elif degraded:
        lines.append("outcome: degraded — simulation completed under faults")
    else:
        lines.append("outcome: clean — no degradation observed")
    print("\n".join(lines))
    return 0


def _fault_plan_doc(plan) -> dict:
    """A FaultPlan back in its YAML schema (non-default fields only), so
    chaos can hand the exact plan to a subprocess through OSIM_FAULT_PLAN."""
    rules = []
    for r in plan.rules:
        doc: dict = {"target": r.target, "kind": r.kind}
        if r.op:
            doc["op"] = r.op
        if r.times is not None:
            doc["times"] = r.times
        if r.after:
            doc["after"] = r.after
        if r.probability != 1.0:
            doc["probability"] = r.probability
        if r.latency_s:
            doc["latency_s"] = r.latency_s
        if r.status != 503:
            doc["status"] = r.status
        if r.body:
            doc["body"] = r.body
        rules.append(doc)
    return {"seed": plan.seed, "rules": rules}


def _run_chaos_capacity(args, plan) -> int:
    """`chaos --capacity`, the mid-plan-kill scenario, in three legs: a
    clean in-process chunked capacity sweep banks the reference placement
    digest; the same sweep runs journaled in a subprocess under the fault
    plan (`chunk_kill` SIGKILLs it mid-chunk, `device_lost` is recovered
    inside it from its last good carry); a killed run is resumed in-process
    with faults off, and its placement digest is compared with the
    reference. Exit 0 when faults fired, the plan still landed and the
    digests match."""
    import contextlib
    import io
    import shutil
    import subprocess
    import tempfile

    import yaml

    from .api.config import SimonConfig
    from .durable import replay
    from .engine.apply import (
        ApplyError, build_apps, build_cluster, load_new_node, placement_digest,
    )
    from .engine.capacity import plan_capacity
    from .resilience.policy import reset_breakers
    from .utils import metrics

    chunk = os.environ.get("OSIM_COMMIT_CHUNK", "").strip() or "8"
    every = os.environ.get("OSIM_CKPT_EVERY", "").strip() or "2"
    # the device-loss leg runs the wave engine unless OSIM_WAVE_COMMIT=0
    wave = os.environ.get("OSIM_WAVE_COMMIT", "").strip() or "1"
    metrics.REGISTRY.reset()
    reset_breakers()

    run_dir = args.run_dir or tempfile.mkdtemp(prefix="simon-chaos-capacity-")
    cleanup = not args.run_dir
    saved = {k: os.environ.get(k) for k in ("OSIM_COMMIT_CHUNK", "OSIM_CKPT_EVERY",
                                            "OSIM_WAVE_COMMIT")}
    os.environ["OSIM_COMMIT_CHUNK"] = chunk
    os.environ["OSIM_CKPT_EVERY"] = every
    os.environ["OSIM_WAVE_COMMIT"] = wave
    try:
        try:
            cfg = SimonConfig.load(args.simon_config)
            cluster = build_cluster(cfg)
            apps = build_apps(cfg)
            new_node = load_new_node(cfg)
        except (ApplyError, ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if new_node is None:
            print("error: chaos --capacity needs a newNode candidate in the config",
                  file=sys.stderr)
            return 1
        ref = plan_capacity(cluster, apps, new_node, sweep_mode="batched", device=args.device)
        if ref is None:
            print("error: reference capacity sweep found no fitting plan", file=sys.stderr)
            return 1
        ref_digest = placement_digest(ref.result)

        os.makedirs(run_dir, exist_ok=True)
        plan_path = os.path.join(run_dir, "fault-plan.yaml")
        with open(plan_path, "w") as fh:
            yaml.safe_dump(_fault_plan_doc(plan), fh, sort_keys=True)
        env = dict(os.environ)
        env["OSIM_FAULT_PLAN"] = plan_path
        child = subprocess.run(
            [sys.executable, "-m", "open_simulator_tpu_torch.cli", "sweep", "--capacity",
             "-f", args.simon_config, "--run-dir", run_dir, "--device", args.device],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        killed = child.returncode in (137, -9)
        if killed:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = _run_sweep(argparse.Namespace(
                    simon_config=args.simon_config, capacity=True, node_counts="",
                    use_greed=False, format="text", run_dir=run_dir, resume=True,
                    device=args.device,
                ))
            if rc != 0:
                print(f"error: resume of the killed sweep failed (rc {rc})", file=sys.stderr)
                return 1
        elif child.returncode != 0:
            print(f"error: faulted sweep exited rc {child.returncode} "
                  "(expected 0, or SIGKILL from a chunk_kill rule)", file=sys.stderr)
            return 1

        try:
            with open(os.path.join(run_dir, "outcome.json")) as fh:
                outcome = json.load(fh)
        except (OSError, ValueError):
            outcome = {}
        got_digest = str(outcome.get("placement_digest", ""))
        n_chunk_records = sum(1 for e in replay(run_dir) if e.get("event") == "plan_chunk")
        skipped = _counter_total(metrics.RESUME_CHUNKS_SKIPPED)
        art_kinds: dict = {}
        last_note = None
        for name in sorted(os.listdir(run_dir)):
            if not name.startswith("flightrec-"):
                continue
            try:
                with open(os.path.join(run_dir, name)) as fh:
                    doc = json.load(fh)
            except (OSError, ValueError):
                continue
            reason = str(doc.get("reason", "?"))
            art_kinds[reason] = art_kinds.get(reason, 0) + 1
            for ev in doc.get("events", []):
                if ev.get("kind") in ("plan-restore", "device-lost"):
                    last_note = ev

        lines = ["simon chaos report", "=================="]
        lines.append(f"fault plan: seed={plan.seed}, {len(plan.rules)} rule(s)")
        for i, r in enumerate(plan.rules, 1):
            lines.append(f"  rule {i}: target={r.target} op={r.op or '*'} kind={r.kind}")
        lines.append(
            "scenario: chunked capacity sweep "
            f"(OSIM_COMMIT_CHUNK={chunk}, snapshot every {every} chunk(s), "
            f"engine={'wave' if wave != '0' else 'serial'})"
        )
        lines.append("degraded:")
        lines.append(
            "  faulted run: "
            + ("killed mid-plan (SIGKILL), resumed from checkpoint" if killed else
               "completed — device faults recovered in place")
        )
        lines.append(f"  plan_chunk records journaled: {n_chunk_records}")
        lines.append(f"  chunks restored from snapshot on resume: {skipped}")
        lines.append(f"  device_lost recoveries: {art_kinds.get('device-lost', 0)}")
        if last_note is not None:
            where = last_note.get("restored_to", last_note.get("chunk"))
            lines.append(f"  last good chunk: {where} (carry digest {last_note.get('digest')})")
        lines.append(
            "  flight artifacts: "
            + (", ".join(f"{k}:{v}" for k, v in sorted(art_kinds.items())) or "none")
        )
        lines.append("failed:")
        match = bool(got_digest) and got_digest == ref_digest
        lines.append("  placement digest vs clean reference: " + ("match" if match else "MISMATCH"))
        if not n_chunk_records:
            lines.append("outcome: failed — the chunked commit driver never engaged "
                         "(workload too small for OSIM_COMMIT_CHUNK?)")
            print("\n".join(lines))
            return 1
        if not match:
            lines.append("outcome: failed — resumed placements diverge from the clean reference")
            print("\n".join(lines))
            return 1
        lines.append("outcome: degraded — plan survived the device fault(s); "
                     "placements byte-identical to the clean run")
        print("\n".join(lines))
        return 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if cleanup:
            shutil.rmtree(run_dir, ignore_errors=True)


def _run_prove(args) -> int:
    from .analysis import semantics

    progress = None
    if args.format == "text":
        def progress(done, total):
            print(f"prove: {done}/{total} universes", file=sys.stderr)

    report = semantics.run_prove(
        contract_path=args.contract or semantics.CONTRACT_PATH,
        write=args.write_contract,
        smoke=args.smoke,
        chunk=args.chunk or semantics.DEFAULT_CHUNK,
        mutate=args.mutate,
        progress=progress,
        engine=args.engine,
        device=args.device,
    )
    if args.format == "json":
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
    else:
        print(report.render_text())
    return 0 if report.ok else 1


def _run_server(args) -> int:
    from .server.server import serve

    try:
        return serve(
            port=args.port, kubeconfig=args.kubeconfig, master=args.master,
            queue_depth=args.queue_depth, coalesce_ms=args.coalesce_ms,
            pack_window_ms=args.pack_window_ms,
            default_deadline_ms=args.default_deadline_ms, device=args.device,
        )
    except (RuntimeError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    from .utils import flightrec
    from .utils.tracing import init_logging

    init_logging()
    # an unhandled crash dumps the recent-span/metric/journal ring first
    flightrec.install_crash_hook()
    if args.command in ("apply", "runs", "server", "sweep"):
        # env-driven fault plans for the entry points other than chaos
        # (chaos installs its own): the crash-resume checks inject their
        # SIGKILL into a plain apply or sweep this way
        from .resilience import faults

        try:
            plan = faults.FaultPlan.from_env()
        except faults.FaultInjectionError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if plan is not None:
            faults.install_plan(plan)
    return {
        "apply": _run_apply, "chaos": _run_chaos, "prove": _run_prove,
        "runs": _run_runs, "server": _run_server, "sweep": _run_sweep,
    }[args.command](args)


def _exit(rc: int) -> None:
    """End the process with `rc`. A worker abandoned by a fired deadline may
    still be inside the device runtime; interpreter shutdown would kill it
    mid-call and abort the process, so then the streams are flushed and the
    process ends without finalisation (the journal is already on disk)."""
    from .durable.watchdog import abandoned_workers

    if abandoned_workers():
        import logging

        logging.shutdown()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    sys.exit(rc)


if __name__ == "__main__":
    _exit(main())
