"""Command line of the PyTorch/CUDA port: `simon apply` and `simon prove` on
the port's engine.

    python -m open_simulator_tpu_torch.cli apply -f example/simon-config.yaml \\
        [--device cpu] [--output-file F] [--default-scheduler-config F] \\
        [--use-greed] [--extended-resources gpu,open-local] \\
        [-i/--interactive] [--no-auto-plan]
    python -m open_simulator_tpu_torch.cli prove [--device cpu] \\
        [--engine serial|wave] [--smoke N] [--mutate tiebreak|nocommit] \\
        [--contract PATH | --write-contract] [--chunk S] [--format text|json]

Runs on CUDA unless `--device` says otherwise, and fails without a card.

apply: when pods stay unscheduled and the config names a new node, the
add-node capacity search runs (engine/capacity.py) and the report shows the
planned cluster; `--interactive` runs the reference's add-node loop instead,
and `--no-auto-plan` reports the unscheduled pods. Exit code 0 when every
pod placed, 2 when some stayed unscheduled, 1 on an error, 3 when a
simulation or sweep outlived OSIM_CALL_DEADLINE_S seconds: the CLI then
exits, which ends the abandoned work with the process (the port has no CPU
degrade). The reference's `--devices` (other than 1), `--run-dir`,
`--resume` and `--metrics-file` parse and then fail with exit code 1 and a
message naming the ROADMAP item that ports them.

prove: the small-scope semantics check (analysis/semantics.py). Exit code 0
when every universe agrees with the oracle and the contract verifies, 1 on
a divergence or a contract mismatch.
"""

from __future__ import annotations

import argparse
import json
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
                   help="shard the node axis across devices (not ported: item 13)")
    p.add_argument("--metrics-file", default="",
                   help="write the metrics snapshot as JSON (not ported: item 14)")
    p.add_argument("--run-dir", default="",
                   help="journal the run into this directory (not ported: item 13)")
    p.add_argument("--resume", nargs="?", const=True, default=False, metavar="RUN_DIR",
                   help="resume a journaled run (not ported: item 13)")


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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="open_simulator_tpu_torch.cli")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_apply(sub)
    _add_prove(sub)
    return ap


def _unported_apply_flags(args) -> Optional[str]:
    """The not-ported message of the first reference-only flag given."""
    from .engine.simulator import _not_ported

    if args.devices != 1:
        return str(_not_ported("--devices (a device mesh)", 13, "durability + parallelism"))
    if args.run_dir or args.resume:
        return str(_not_ported("--run-dir / --resume (the run journal)", 13,
                               "durability + parallelism"))
    if args.metrics_file:
        return str(_not_ported("--metrics-file (the metrics registry)", 14, "tooling"))
    return None


def _run_apply(args) -> int:
    from .api.config import SimonConfig
    from .durable.watchdog import DeadlineExceeded
    from .engine.apply import ApplyError, run_apply
    from .utils.tracing import init_logging

    unported = _unported_apply_flags(args)
    if unported:
        print(f"error: {unported}", file=sys.stderr)
        return 1
    init_logging()
    try:
        ext = [s.strip() for s in args.extended_resources.split(",") if s.strip()] or None
        unknown = set(ext or ()) - {"gpu", "open-local"}
        if unknown:
            raise ApplyError(
                f"--extended-resources: unknown resource(s) {sorted(unknown)}; "
                "expected gpu, open-local"
            )
        cfg = SimonConfig.load(args.simon_config)
        out = open(args.output_file, "w") if args.output_file else None
        try:
            outcome = run_apply(
                cfg, interactive=args.interactive, auto_plan=not args.no_auto_plan, out=out,
                scheduler_config=args.default_scheduler_config, use_greed=args.use_greed,
                extended_resources=ext, device=args.device,
            )
        finally:
            if out is not None:
                out.close()
    except (ApplyError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except DeadlineExceeded as e:
        print(f"error: {e}; abandoned", file=sys.stderr)
        return 3
    return 0 if not outcome.result.unscheduled else 2


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


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "prove":
        return _run_prove(args)
    return _run_apply(args)


if __name__ == "__main__":
    sys.exit(main())
