#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

1. Prints the card (nvidia-smi name and power limit) and the torch version,
   and builds every CUDA kernel of the port from the sources in the checkout.
2. Drives the main path at full size: the headline cluster (10,000 nodes,
   100,000 pods) through `schedule_batch_fast` on the card: one warm pass,
   one timed pass, and one pass synced at each phase end for the phase
   split. It holds the timed pass's result against the placement digest the
   JAX package computes for the same input.
3. Drives every other route: each `bench_configs` workload (spread_affinity,
   gpushare, mixed) through the same passes, holding its digest, its route
   counts and its domain_pop launches against the JAX package's run, and
   printing wall, pods/s, the phase split and the microseconds per step of
   each scan body (grouped, light scan, micro, affinity pop). On `mixed` the
   port's sequential oracle `kernels.schedule_batch` runs on the card too
   (all pods, or the first 1,000 when all would take over 30 s) and must
   equal the fast path.
4. Drives the simulator engine, the entry point users call: the port's
   `simulate()` on `sim_configs.plan` (the JAX package's bench.py
   config_plan cluster and apps, 100,000 pods x 10,000 nodes, no capacity
   search; a warm call and a timed call) and on `sim_configs.preempt`
   (config_preempt; a cold and a warm call), each held against the JAX
   package's result digest and counts, with sort 1 / domain 1 and one
   domain_pop launch per plan call; prints wall, pods/s, the tracing spans
   and the preemption probe's calls, lanes and us per lane. Then the two
   example configs through `run_apply(auto_plan=False)`, held against the
   JAX report digest (text without its `device:` line) and placement
   digest.
5. Drives the capacity search (`engine/capacity.py`), the scenario axis and
   the wave commit engine: `plan_capacity` on `sim_configs.plan_spec()`
   (100,000 pods x 10,000 nodes, the 32 cpu / 64Gi template) serially, with
   each probe's wall and spans and one domain_pop launch per simulate();
   plan_small serially and in auto mode (batched; on the card the wave
   engine), with its waves, rounds per wave, conflicts and fallbacks;
   plan_full's first ladder sweep at its lanes and node bucket: 512 pods
   (cut from 1,024 to keep the whole script well under its time limit)
   through the wave driver at its default knobs and through the lane-batched
   scan (both timed, every wave round split into its probe and its replay),
   then 256 pods in waves of 16 pods, which must all converge and be adopted,
   bit-equal to the scan on the same pods; capacity_sweep in every mode;
   multi_scenario's 64 lanes through `simulate_batch`; the quickstart
   config through `run_apply(auto_plan=True)`. Every result is held against
   the JAX package's constants in `sim_configs`.
6. Drives `simon prove` (analysis/semantics.py): the whole corpus of
   151,875 universes through the serial universe scan and through the wave
   engine, each with 0 divergences against the port's oracle and verifying
   the unchanged budgets/commit_contract.json, then the tiebreak and
   nocommit mutations on the reference's PINNED universes, which must be
   caught and minimized; prints wall, device calls, universes/s, wave
   rounds per chunk and the oracle's share of the wall. The phase spends
   most of its wall in the host oracle, so it runs in a child process
   (`--phase prove`) started before the capacity phase, beside it; its
   lines are printed, and its results checked, in this place.
7. Drives scheduler extenders against stub servers on 127.0.0.1
   (tools/stubs.py): simulate() behind a filter + prioritize + preempt
   extender (two full waves of 64 pods and four preemptions),
   plan_capacity behind an extender with one transient blip injected
   (retries 1), and run_apply on a kubeConfig served by a stub apiserver,
   each against the JAX package's constants in `sim_configs`; prints walls,
   waves, HTTP calls and respills.
8. Drives durable runs (durable_phase): the chunked scenario scan at
   plan_full's first ladder width (6 lanes padded to 8 x 20,480 node rows,
   its first 512 pods, chunks of 64) under a run journal and carry
   checkpoints, with two and three injected device losses, resumes from a
   good and from a torn snapshot, each bit-equal to the monolithic scan
   and its JAX carry digest; the wave driver with a checkpointer and one
   loss; `sweep --capacity` and `apply --run-dir` killed in a subprocess
   (SIGKILL from a fault plan) and finished by `runs resume`, their
   placement digests equal to the clean runs' and the JAX CLI's; an apply
   past its deadline (exit 3, no CPU retry) resumed the same way. Prints
   the walls, snapshot bytes, restore and digest milliseconds.
9. Drives the resident cluster state (resident_phase): 32 seeded delta
   rounds of 64 node changes over config_plan's 10,000 nodes, verified
   every 8 rounds, one torn delta and one digest mismatch repaired; the
   final digest_table equal to the JAX constant; then simulate() of
   config_plan's apps on the changed cluster with and without the
   resident, equal to the JAX digest, one domain_pop launch a call. Prints
   the sync milliseconds against a full encode_nodes.
10. Drives the server (serve_phase): `simon server` embedded on a thread on
   the card, its live cluster config_plan's 10,000 nodes behind a stub
   apiserver, through ten legs (lone, fan-out, scenario pack, overload,
   deadline, job, observability, soak, resync, and the `server` verb in a
   subprocess), every response held against the JAX server's constants in
   sim_configs.SERVE_DIGESTS. Prints wall, p50/p99 latency, req/s, pack
   sizes, sheds, sync ms and domain_pop launches per leg.
11. Holds every kernel against its plain PyTorch version, bit for bit, on
   the inputs the main path gave it (the plain version on the card, which
   gives the row's plain time), on those of spread_affinity's DoNotSchedule
   group, of the simulator's plan call and of a served full request, and on
   extra seeded variants (the plain version on a host copy of the same
   inputs: a pop's few dozen tiny ops run ~4x faster on the host CPU than
   launched one by one on the card), and prints their times; holds the pop
   loop's split divide against __fdiv_rn on the spread's operands (67 M
   pairs).
12. Times the pop chain probe (csrc/pop_chain_probe.cu) with clock64() while
   nvidia-smi reads the SM clock, and prints the latency bound of the main
   path's pop loop beside the kernel's own cycles per pop.
13. Prints one JSON line of per-kernel numbers (launches summed over the
   headline's and the workloads' timed passes, the timed plan call, the warm
   preempt call, the apply runs, the capacity, prove, extender, durable,
   resident and serve phases) and, last, the result line.

Any failure exits non-zero without the result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PROBE_POPS = 4_000_000      # long enough (~0.5 s) to read the SM clock while it runs


def smi(query: str, fmt: str = "csv,noheader") -> str:
    """nvidia-smi's answer for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def pop_inputs(seed, dc, lanes, c, d, g, hard, n=12288, cap=None):
    """Seeded pop-loop inputs shaped like a domain plan: sorted per-class
    lane tables with tied (quantized) scores, classes that run out early or
    are empty, rows mapped to domains or missing the key. `cap` bounds every
    class's lane count (so all classes run out before g pops)."""
    rng = np.random.default_rng(seed)
    hscore = -np.sort(-(rng.integers(0, 40, (dc, lanes)) * 0.25)).astype(np.float32)
    for m in range(dc):
        if rng.random() < 0.3:
            hscore[m, rng.integers(0, lanes):] = -np.inf
    hnode = (rng.integers(0, n // dc, (dc, lanes)) * dc + np.arange(dc)[:, None]).astype(np.int32)
    hj = rng.integers(0, 128, (dc, lanes)).astype(np.int32)
    cap_eff = rng.integers(0, lanes + 1, dc).astype(np.int32)
    cap_eff[rng.random(dc) < 0.2] = 0
    if cap is not None:
        cap_eff = np.minimum(cap_eff, cap)
    dom_of = rng.integers(-1, d, (c, dc))
    if hard:
        dom_of[0] = rng.integers(0, d, dc)  # every class carries the hard row's key
    t_onehot = (dom_of[:, None, :] == np.arange(d)[None, :, None]).astype(np.float32)
    hard_c = np.zeros(c, np.float32)
    if hard:
        hard_c[0] = 1.0
    match = np.ones(c, np.float32)
    match[1:] = rng.integers(0, 2, c - 1)
    arrays = [
        hscore, hnode, hj, cap_eff,
        (rng.random(dc) < 0.8).astype(np.float32),                    # elig
        (rng.random(dc) < 0.9).astype(np.float32),                    # combo_valid
        rng.integers(0, 4, (c, d)).astype(np.float32),                # base_dom
        (t_onehot.sum(axis=2) > 0).astype(np.float32),                # in_key
        t_onehot,
        match, 1.0 - hard_c, hard_c,
        rng.integers(2, 6, c).astype(np.float32),                     # skew
        (dom_of >= 0).astype(np.float32),                             # has_key
    ]
    return arrays, [2.0, True, g - 5, g, hard, n]


def divide_domain(torch, exhaustive=8192, n_random=1 << 25, seed=0):
    """(n, d) operand pairs of the spread divide on the card: every count
    d = mx in [1, exhaustive) with every raw in [0, mx] (larger raws give a
    negative quotient, clipped to 0), and n_random seeded pairs with mx up
    to 2^24. n = (mx - raw) * 100, as the kernel forms it."""
    mxs = torch.arange(1, exhaustive, device="cuda")
    counts = mxs + 1
    starts = torch.cumsum(counts, 0) - counts
    idx = torch.arange(int(counts.sum()), device="cuda")
    mx = torch.repeat_interleave(mxs, counts)
    raw = idx - torch.repeat_interleave(starts, counts)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mx_r = torch.randint(1, 1 << 24, (n_random,), device="cuda", generator=gen)
    raw_r = (torch.rand(n_random, device="cuda", generator=gen, dtype=torch.float64)
             * (mx_r + 1)).long().clamp(max=mx_r)
    mx, raw = torch.cat([mx, mx_r]), torch.cat([raw, raw_r])
    return (mx - raw).float() * 100.0, mx.float()


def to_card(arrays, scalars, torch):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays] + list(scalars)


def event_ms(fn, torch, reps):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def pop_bound(args, placed):
    """(bound_ms, bound_by) of one pop loop on this run's data. Bytes: the
    [Dc] and [C,*] tables read once, the [Dc,L] head tables (score, node,
    lane) read only at the entries the loop visits (each class's first head
    and one more per placed pod: Dc + placed entries), both [G] outputs
    written once, at the HBM rate. Operations: the f32 work of the pops that
    place a pod (after that the loop ends), at the f32 peak: per class the
    raw increment, the spread norm (subtract, multiply, divide, two clips)
    and the total (multiply, add); per hard row the D domain increments and
    per class the count increment and the verdict (add, subtract, compare)."""
    tensors = [a for a in args if hasattr(a, "element_size")]
    hscore, base_dom, hard = tensors[0], tensors[6], tensors[11]
    dc = hscore.shape[0]
    d = base_dom.shape[1]
    g = args[-3]
    head_bytes = (dc + placed) * sum(t.element_size() for t in tensors[:3])
    small_bytes = sum(t.numel() * t.element_size() for t in tensors[3:])
    nbytes = head_bytes + small_bytes + 2 * 4 * g
    n_hard = int((hard > 0).sum()) if args[-2] and args[-5] else 0
    ops = (placed + 1) * (dc * 8 + n_hard * (d + 4 * dc))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_PLAIN_RUNS = []  # (name, args, plain outputs, plain ms) of the checks so far


def _same_inputs(a, b, torch):
    return len(a) == len(b) and all(
        (x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y))
        if torch.is_tensor(x) and torch.is_tensor(y) else
        (not torch.is_tensor(x) and not torch.is_tensor(y) and x == y)
        for x, y in zip(a, b))


def check_pop(name, args, dp, torch, reps, plain_on="cuda"):
    """Kernel vs plain version on the same inputs: bit-equal outputs. The
    plain version runs on the card (plain_on="cuda") or on a host copy of
    the card tensors (plain_on="cpu"). It is deterministic, so inputs equal
    to an earlier check's reuse its plain outputs and time. Returns (kernel
    ms, plain ms, max abs error, pods placed)."""
    nodes_k, jidx_k = dp.domain_pop(*args)
    torch.cuda.synchronize()
    ms = event_ms(lambda: dp.domain_pop(*args), torch, reps)
    prev = next((r for r in _PLAIN_RUNS if _same_inputs(r[1], args, torch)), None)
    if prev is not None:
        (nodes_p, jidx_p), plain_ms, plain_on = prev[2], prev[3], prev[4]
        print(f"domain_pop[{name}] inputs equal domain_pop[{prev[0]}]'s: its plain outputs "
              "are reused", flush=True)
    else:
        plain_args = [a.to(plain_on) if torch.is_tensor(a) else a for a in args]
        t0 = time.perf_counter()
        nodes_p, jidx_p = dp.domain_pop_reference(*plain_args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _PLAIN_RUNS.append((name, args, (nodes_p, jidx_p), plain_ms, plain_on))
    nodes_k, jidx_k = nodes_k.to(nodes_p.device), jidx_k.to(jidx_p.device)
    err = max(
        (nodes_k - nodes_p).abs().max().item(), (jidx_k - jidx_p).abs().max().item()
    )
    if not (torch.equal(nodes_k, nodes_p) and torch.equal(jidx_k, jidx_p)):
        raise SystemExit(f"domain_pop[{name}]: kernel and plain version disagree (max err {err})")
    placed = int((nodes_k >= 0).sum())
    print(f"domain_pop[{name}] bit-equal to plain: pops={args[-3]} placed={placed} "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms"
          + (" (on the host CPU)" if plain_on == "cpu" else ""), flush=True)
    return ms, plain_ms, float(err), placed


def capture_pops(dp, torch, keep):
    """Wrap dp.domain_pop so the calls' inputs are cloned into `keep` (until
    it holds one); returns the undo function."""
    real = dp.domain_pop

    def recording_pop(*args):
        if not keep:
            keep.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return real(*args)

    dp.domain_pop = recording_pop

    def undo():
        dp.domain_pop = real

    return undo


def run_oracle(kernels, ns, carry, batch, w, fast_result, torch, budget_s=30.0, chunk=1000):
    """The sequential oracle on the card, `chunk` pods per call threading
    the carry: the first chunk, then the rest only if the whole run, at the
    first chunk's rate, fits in `budget_s`. Returns (pods run, seconds,
    mismatch list) against the fast path's result; the carry is compared
    only when every pod ran."""
    from open_simulator_tpu_torch.ops.state import pod_rows_from_batch

    total = int(batch.valid.sum())
    rows = pod_rows_from_batch(batch, "cuda")
    outs, done = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while done < total and (done == 0 or (time.perf_counter() - t0) * total / done <= budget_s):
        n = min(chunk, total - done)
        part = kernels.PodRow(*(a[done:done + n] for a in rows))
        carry, *got = kernels.schedule_batch(ns, carry, part, w)
        outs.append([g.cpu().numpy() for g in got])
        done += n
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    bad = []
    for i, name in enumerate(("nodes", "reasons", "gpu_take", "vg_take", "dev_take")):
        got = np.concatenate([o[i] for o in outs])
        if not np.array_equal(got, fast_result[1 + i][:done]):
            bad.append(name)
    if done == total:
        for f in carry._fields:
            if not torch.equal(getattr(carry, f), getattr(fast_result[0], f)):
                bad.append(f"carry.{f}")
    return done, seconds, bad


def routes_phase(torch, dp, fast, kernels, w, captured):
    """Each bench_configs workload on the card: a warm pass, a timed pass
    (route counts and kernel launches read around it), a pass synced at
    phase ends for the phase split and the per-route step times, the digest
    against the JAX package's; on `mixed`, the port's oracle against the fast
    path. Returns (per-workload results, failure list)."""
    from open_simulator_tpu_torch import bench_configs
    from open_simulator_tpu_torch.headline import placement_digest

    results, failures = {}, []
    for name in bench_configs.WORKLOADS:
        t0 = time.perf_counter()
        ns, carry, batch = bench_configs.build_state(name, device="cuda")
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        total = int(batch.valid.sum())
        keep = [] if name == "spread_affinity" else [None]
        undo = capture_pops(dp, torch, keep)
        t0 = time.perf_counter()
        fast.schedule_batch_fast(ns, carry, batch, w, device="cuda")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        undo()
        if name == "spread_affinity":
            captured["spread_affinity"] = keep[0] if keep else None

        for k in fast.PATH_COUNTS:
            fast.PATH_COUNTS[k] = 0
        dp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fast.schedule_batch_fast(ns, carry, batch, w, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        paths = {k: v for k, v in fast.PATH_COUNTS.items() if v and k != "domain_kernel"}
        kernel_groups, launches = fast.PATH_COUNTS["domain_kernel"], dp.launches

        timings: dict = {}
        t0 = time.perf_counter()
        fast.schedule_batch_fast(ns, carry, batch, w, device="cuda", timings=timings)
        phase_s = time.perf_counter() - t0
        digest = placement_digest(*result)
        scheduled = int((result[1][:total] >= 0).sum())
        print(f"routes[{name}] {total} pods x {int(ns.valid.sum())} nodes: encode {encode_s:.2f} s, "
              f"warm pass {warm_s:.3f} s, timed pass {run_s:.3f} s, {total / run_s:.1f} pods/s, "
              f"scheduled {scheduled}", flush=True)
        print(f"routes[{name}] phase pass {phase_s:.3f} s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in timings.items()
            if not k.startswith(("select.", "steps."))), flush=True)
        steps = {}
        for key, n in timings.items():
            if key.startswith("steps.") and n:
                route = key[len("steps."):]
                sec = timings[f"select.{route}"]
                steps[route] = {"steps": n, "seconds": sec, "us_per_step": sec / n * 1e6}
                print(f"routes[{name}] {route}: {n} steps, {sec:.3f} s, "
                      f"{sec / n * 1e6:.1f} us/step (select phase incl. per-group set-up)",
                      flush=True)
        print(f"routes[{name}] paths {paths} domain_pop launches {launches} digest {digest}",
              flush=True)
        if digest != bench_configs.DIGESTS[name]:
            failures.append(f"{name}: digest {digest} != {bench_configs.DIGESTS[name]}")
        if paths != bench_configs.PATHS[name]:
            failures.append(f"{name}: paths {paths} != {bench_configs.PATHS[name]}")
        if not launches == kernel_groups == bench_configs.DOMAIN_POP_GROUPS[name]:
            failures.append(f"{name}: domain_pop launches {launches} / counted {kernel_groups}, "
                            f"expected {bench_configs.DOMAIN_POP_GROUPS[name]}")
        res = {"pods": total, "scheduled": scheduled, "encode_s": encode_s, "warm_s": warm_s,
               "run_s": run_s, "pods_per_s": total / run_s, "phase_s": phase_s,
               "phases": timings, "steps": steps, "paths": paths, "launches": launches,
               "digest": digest}
        if name == "mixed":
            done, oracle_s, bad = run_oracle(kernels, ns, carry, batch, w, result, torch)
            print(f"routes[mixed] oracle schedule_batch on the card: {done} of {total} pods "
                  f"in {oracle_s:.2f} s ({oracle_s / done * 1e6:.0f} us/pod), "
                  f"{'equal to the fast path' if not bad else 'DIFFERS: ' + ', '.join(bad)}",
                  flush=True)
            res.update(oracle_pods=done, oracle_s=oracle_s)
            if bad:
                failures.append(f"mixed: oracle differs from the fast path in {bad}")
        results[name] = res
    if captured.get("spread_affinity") is None:
        failures.append("spread_affinity made no domain_pop call")
    return results, failures


def simulate_once(torch, dp, fast, build, keep=None):
    """One simulate() on the card of freshly built inputs after
    reset_name_rng(), with the route counts and kernel launches set to 0
    just before it; with `keep`, the first domain_pop call's inputs are
    cloned into it. Returns (result, wall s, span seconds, routes,
    domain_pop launches, probe calls, probe lanes)."""
    from open_simulator_tpu_torch.core.workloads import reset_name_rng
    from open_simulator_tpu_torch.engine.simulator import simulate
    from open_simulator_tpu_torch.utils import metrics, tracing

    reset_name_rng()
    cluster, apps = build()
    for k in fast.PATH_COUNTS:
        fast.PATH_COUNTS[k] = 0
    dp.launches = 0
    calls0 = metrics.PROBE_LANES.value(unit="calls")
    lanes0 = metrics.PROBE_LANES.value(unit="lanes")
    undo = capture_pops(dp, torch, keep) if keep is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simulate(cluster, apps, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if undo is not None:
        undo()
    routes = {k: v for k, v in fast.PATH_COUNTS.items() if v}
    return (result, wall, tracing.span_seconds(tracing.recent_timings()[-1]), routes, dp.launches,
            int(metrics.PROBE_LANES.value(unit="calls") - calls0),
            int(metrics.PROBE_LANES.value(unit="lanes") - lanes0))


def simulator_phase(torch, dp, fast):
    """The port's simulate() on the card: config_plan at full size (warm
    call, timed call) and config_preempt (cold call, warm call), each held
    against the JAX package's result digest; then the two example configs
    through run_apply(auto_plan=False), held against the JAX report and
    placement digests. Returns (results, failures, domain_pop launches of
    the timed plan call, the warm preempt call and the apply runs, the
    inputs of the warm plan call's domain_pop launch)."""
    import io

    from open_simulator_tpu_torch import sim_configs as sc
    from open_simulator_tpu_torch.api.config import SimonConfig
    from open_simulator_tpu_torch.core.workloads import reset_name_rng
    from open_simulator_tpu_torch.engine.apply import placement_digest, run_apply

    results, failures, launches, captured = {}, [], 0, []
    shown = ("expand-workloads", "encode-cluster", "encode", "schedule", "bind", "preempt",
             "probe", "decode-result")
    for name, build, labels in (("plan", sc.plan, ("warm", "timed")),
                                ("preempt", sc.preempt, ("cold", "warm"))):
        for label in labels:
            result, wall, spans, routes, n_pop, calls, lanes = simulate_once(
                torch, dp, fast, build, captured if (name, label) == ("plan", "warm") else None)
            digest, counts = sc.result_digest(result), sc.result_counts(result)
            pods = counts[0] + counts[1]
            other = spans["simulate"] - sum(v for k, v in spans.items()
                                            if k in shown and k != "probe")
            print(f"simulator[{name}/{label}] {pods} pods x {len(result.node_status)} nodes: "
                  f"wall {wall:.3f} s, {pods / wall:.1f} pods/s; placed/unscheduled/preempted "
                  f"{counts}; routes {routes}; domain_pop launches {n_pop}", flush=True)
            print(f"simulator[{name}/{label}] spans (s): " + ", ".join(
                f"{k} {spans[k]:.3f}" for k in shown if k in spans)
                + f", other {other:.3f}", flush=True)
            if calls:
                print(f"simulator[{name}/{label}] preemption: {spans.get('preempt', 0.0):.3f} s, "
                      f"{calls} probe calls, {lanes} lanes, "
                      f"{spans['probe'] / lanes * 1e6:.1f} us/lane in the probe calls", flush=True)
            if digest != sc.SIM_DIGESTS[name]:
                failures.append(f"{name}/{label}: digest {digest} != {sc.SIM_DIGESTS[name]}")
            if counts != sc.SIM_COUNTS[name]:
                failures.append(f"{name}/{label}: counts {counts} != {sc.SIM_COUNTS[name]}")
            if name == "plan" and (routes.get("sort") != 1 or routes.get("domain") != 1
                                   or n_pop != 1 or routes.get("domain_kernel") != 1):
                failures.append(f"plan/{label}: routes {routes}, domain_pop launches {n_pop}; "
                                "expected sort 1, domain 1, one launch")
            if name == "preempt" and not calls:
                failures.append(f"preempt/{label}: the device probe never ran")
            results[f"{name}/{label}"] = {
                "wall_s": wall, "pods_per_s": pods / wall, "spans": spans, "routes": routes,
                "launches": n_pop, "probe_calls": calls, "probe_lanes": lanes, "digest": digest,
            }
            if label in ("timed", "warm"):
                launches += n_pop
    for path, (report_d, placement_d, unscheduled) in sc.APPLY_DIGESTS.items():
        reset_name_rng()
        dp.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        outcome = run_apply(SimonConfig.load(path), auto_plan=False, out=out, device="cuda")
        wall = time.perf_counter() - t0
        launches += dp.launches
        got = (sc.report_digest(out.getvalue()), sc.report_digest(outcome.report),
               placement_digest(outcome.result), len(outcome.result.unscheduled))
        print(f"apply[{path}] {wall:.3f} s, {out.getvalue().splitlines()[-1]}, report "
              f"{got[0]}, placement {got[2]}, unscheduled {got[3]}, domain_pop launches "
              f"{dp.launches}", flush=True)
        if got != (report_d, report_d, placement_d, unscheduled):
            failures.append(f"apply {path}: {got} != {(report_d, report_d, placement_d, unscheduled)}")
        results[f"apply/{path}"] = {"wall_s": wall, "launches": dp.launches}
    if not captured:
        failures.append("plan made no domain_pop call")
    return results, failures, launches, captured[0] if captured else None


def _new_roots(tracing, before):
    """Root span trees recorded since `before` (a recent_timings() list)."""
    seen = {id(t) for t in before}
    return [t for t in tracing.recent_timings() if id(t) not in seen]


def _wave_counters(metrics):
    return {
        "waves": metrics.PLAN_CHUNKS.value(),
        "rounds_n": metrics.COMMIT_ROUNDS.child_state()[2],
        "rounds_sum": metrics.COMMIT_ROUNDS.child_state()[1],
        "conflicts": metrics.WAVE_CONFLICTS.value(),
        "fallbacks": metrics.WAVE_FALLBACKS.value(reason="max_rounds"),
    }


class RoundClock:
    """Times every wave round on the card and splits it into its probe and
    its replay (the row commits and the prefix-carry stack): wraps
    fast.schedule_wave (a round ends synced anyway, the driver fetches its
    choices) and the probe that wave._probe_lanes builds, synced before and
    after each probe call. Counts rounds per wave (a wave is one input
    carry). A round whose probe time is negative or longer than the round
    itself is a broken split: `bad` lists them and the phase fails."""

    def __init__(self, fast, wave, torch):
        self.fast, self.wave, self.torch = fast, wave, torch
        self.real_round, self.real_probe = fast.schedule_wave, wave._probe_lanes
        self.rounds: list = []        # (wave number, pods in the wave, round s, probe s)
        self.waves = 0
        self.bad: list = []

    def __enter__(self):
        last = [None]
        probe_s = [0.0]
        sync = self.torch.cuda.synchronize

        def probe_lanes(*args, **kw):
            probe = self.real_probe(*args, **kw)

            def timed(*a):
                sync()
                t0 = time.perf_counter()
                out = probe(*a)
                sync()
                probe_s[0] += time.perf_counter() - t0
                return out

            return timed

        def timed_round(ns, carry_s, pods, *args, **kw):
            # rounds of one wave share its input carry object; the next
            # wave starts from another (the adopted exit carry)
            if carry_s is not last[0]:
                self.waves += 1
                last[0] = carry_s
            probe_s[0] = 0.0
            t0 = time.perf_counter()
            out = self.real_round(ns, carry_s, pods, *args, **kw)
            sync()
            rec = (self.waves, int(pods.req.shape[0]), time.perf_counter() - t0, probe_s[0])
            if not 0.0 <= rec[3] <= rec[2]:
                self.bad.append(f"wave {rec[0]}: probe {rec[3]:.6f} s in a {rec[2]:.6f} s round")
            self.rounds.append(rec)
            return out

        self.fast.schedule_wave = timed_round
        self.wave._probe_lanes = probe_lanes
        return self

    def __exit__(self, *exc):
        self.fast.schedule_wave = self.real_round
        self.wave._probe_lanes = self.real_probe

    def per_wave(self):
        counts: dict = {}
        for key, *_ in self.rounds:
            counts[key] = counts.get(key, 0) + 1
        return list(counts.values())

    def summary(self) -> dict:
        """Rounds per wave, and per round its wall, its probe and the
        replay's time per pod step (the round less its probe, over W)."""
        per_wave, n = self.per_wave(), len(self.rounds)
        return {
            "waves": len(per_wave), "rounds": per_wave,
            "rounds_mean": sum(per_wave) / len(per_wave), "rounds_max": max(per_wave),
            "round_ms_mean": sum(r[2] for r in self.rounds) / n * 1e3,
            "probe_ms_per_round": sum(r[3] for r in self.rounds) / n * 1e3,
            "replay_us_per_step": sum((r[2] - r[3]) / r[1] for r in self.rounds) / n * 1e6,
        }

    def line(self) -> str:
        s = self.summary()
        return (f"{s['waves']} waves, rounds per wave mean {s['rounds_mean']:.2f} max "
                f"{s['rounds_max']}, {s['round_ms_mean']:.1f} ms per round: probe "
                f"{s['probe_ms_per_round']:.1f} ms, replay {s['replay_us_per_step']:.1f} us "
                f"per step")


def plan_once(torch, dp, fast, spec, mode, label):
    """One plan_capacity on the card of freshly built inputs after
    reset_name_rng(), counts set to 0 just before it. Prints wall, attempts,
    batched sweeps, the wave counters and each probe's wall and spans;
    returns (key tuple, wall, domain_pop launches, stats)."""
    from open_simulator_tpu_torch import sim_configs as sc
    from open_simulator_tpu_torch.core.objects import Node
    from open_simulator_tpu_torch.core.workloads import reset_name_rng
    from open_simulator_tpu_torch.engine.capacity import plan_capacity
    from open_simulator_tpu_torch.ops import wave
    from open_simulator_tpu_torch.utils import metrics, tracing

    reset_name_rng()
    cluster, apps = sc._port_build(spec)
    template = Node.from_dict(sc.template_spec())
    for k in fast.PATH_COUNTS:
        fast.PATH_COUNTS[k] = 0
    dp.launches = 0
    before, roots0 = _wave_counters(metrics), tracing.recent_timings()
    clock = RoundClock(fast, wave, torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with clock:
        plan = plan_capacity(cluster, apps, template, sweep_mode=mode, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = _wave_counters(metrics)
    d = {k: after[k] - before[k] for k in after}
    key = (plan.nodes_added, plan.attempts, plan.batched_calls, sc.result_digest(plan.result))
    roots = _new_roots(tracing, roots0)
    stats = {"wall_s": wall, "key": list(key), "launches": dp.launches,
             "sims": sum(r["name"] == "capacity-probe" for r in roots),
             "sweeps": sum(r["name"] == "capacity-sweep" for r in roots), **d}
    print(f"capacity[{label}] {mode}: wall {wall:.3f} s, nodes_added {key[0]}, attempts "
          f"{key[1]}, batched_calls {key[2]}, digest {key[3]}, simulate() calls "
          f"{stats['sims']}, sweeps {stats['sweeps']}, domain_pop launches {dp.launches}",
          flush=True)
    shown = ("expand-workloads", "encode-cluster", "encode", "schedule", "bind",
             "schedule-scenarios", "decode-result")
    for r in roots:
        spans = tracing.span_seconds(r)
        meta = r.get("meta", {})
        print(f"capacity[{label}]   {r['name']} {meta}: {r['duration_s']:.3f} s; " + ", ".join(
            f"{k} {spans[k]:.3f}" for k in shown if k in spans), flush=True)
    stats["clock_bad"] = clock.bad
    if clock.rounds:
        stats.update(clock.summary())
        print(f"capacity[{label}] wave engine: {clock.line()}; {int(d['conflicts'])} "
              f"conflicts, {int(d['fallbacks'])} max-rounds fallbacks", flush=True)
    return key, wall, dp.launches, stats


_FULL_WIDTH: dict = {}


def full_width_lanes(torch):
    """plan_full's first ladder sweep at its lanes (6, padded to 8) and node
    bucket (20,480 rows), built once and kept for the phases that scan it:
    the Simulator (encoder, node table, carry), the expanded app pods, the
    lanes' valid masks and weights."""
    if _FULL_WIDTH:
        return _FULL_WIDTH
    from open_simulator_tpu_torch import sim_configs as sc
    from open_simulator_tpu_torch.core.objects import Node
    from open_simulator_tpu_torch.core.workloads import reset_name_rng
    from open_simulator_tpu_torch.engine.capacity import (
        LADDER_LANES, _TrialReuse, lower_bound_nodes,
    )
    from open_simulator_tpu_torch.engine.simulator import Simulator, simulate
    from open_simulator_tpu_torch.ops.encode import node_bucket
    from open_simulator_tpu_torch.ops.fast import scenario_bucket

    spec = sc.plan_spec()
    reset_name_rng()
    cluster, apps = sc._port_build(spec)
    template = Node.from_dict(sc.template_spec())
    n_base = len(cluster.nodes)
    base = simulate(cluster, apps, device="cuda")
    k = lower_bound_nodes(base, template)
    ladder = [k << i for i in range(LADDER_LANES) if k << i <= 1 << 14]
    n_pad = node_bucket(n_base + ladder[-1])
    reset_name_rng()
    cluster, apps = sc._port_build(spec)
    trial = type(cluster)(nodes=list(cluster.nodes) + _TrialReuse(template, n_base).fakes(ladder[-1]))
    sim = Simulator(trial, n_pad=n_pad, device="cuda")
    app_pods = sim._expand_apps(apps)
    sim._build_device_state([p for pods in app_pods for p in pods])
    table_valid = sim._table.valid
    valid = []
    for c in ladder:
        v = table_valid.copy()
        v[n_base + c:] = False
        valid.append(v)
    s = len(ladder)
    s_pad = scenario_bucket(s)
    valid += [valid[0]] * (s_pad - s)   # pad lanes copy lane 0, as run_scenarios does
    _FULL_WIDTH.update(
        sim=sim, app_pods=app_pods, n_base=n_base, n_pad=n_pad, ladder=ladder, s=s, s_pad=s_pad,
        valid_s=torch.from_numpy(np.stack(valid)).cuda(),
        weights_s=sim.weights[None].repeat(s_pad, 1),
    )
    return _FULL_WIDTH


def wave_width_check(torch, fast, n_pods=512, n_converge=256, converge_wave=16):
    """plan_full's first ladder sweep at its lanes (6, padded to 8) and node
    bucket (full_width_lanes), run twice through the wave driver, each
    against the lane-batched serial scan on the same pods (every output and
    the carry digest bit-equal):
    - timing: the first `n_pods` pods (waves of 256) at the default knobs,
      each engine timed, every wave round split into its probe and its
      replay. Here every wave runs the 24-round budget and falls back to the
      scan, so its outputs are the scan's own: this run times the rounds;
    - convergence: the first `n_converge` pods in waves of `converge_wave`
      (OSIM_WAVE_SIZE; a wave reaches its fixpoint within W + 1 rounds, under
      the budget), so every wave's outputs and exit carry are the probe's and
      the replay's. No wave may fall back."""
    import contextlib

    from open_simulator_tpu_torch.ops import wave
    from open_simulator_tpu_torch.ops.encode import encode_pods
    from open_simulator_tpu_torch.ops.state import stack_carry
    from open_simulator_tpu_torch.utils import metrics

    lanes = full_width_lanes(torch)
    sim, app_pods, s, s_pad = lanes["sim"], lanes["app_pods"], lanes["s"], lanes["s_pad"]
    valid_s, weights_s = lanes["valid_s"], lanes["weights_s"]
    n_base, n_pad, ladder = lanes["n_base"], lanes["n_pad"], lanes["ladder"]

    def run(batch, knobs, clock=None):
        before = _wave_counters(metrics)
        with _Env(**{"OSIM_WAVE_COMMIT": None, "OSIM_WAVE_SIZE": None,
                     "OSIM_COMMIT_CHUNK": None, **knobs}):
            carry_s = stack_carry(sim._carry, s_pad)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with clock or contextlib.nullcontext():
                out = fast.schedule_scenarios_host(sim._ns, carry_s, batch, weights_s, valid_s, s)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        after = _wave_counters(metrics)
        counts = {c: after[c] - before[c] for c in ("waves", "fallbacks")}
        return (fast.scenario_carry_digest(out[0]),) + tuple(out[1:]), secs, counts

    def same(a, b):
        return a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))

    pods = app_pods[0][:n_pods]
    batch = encode_pods(sim.enc, pods)
    clock = RoundClock(fast, wave, torch)
    got_w, wave_s, counts_w = run(batch, {"OSIM_WAVE_COMMIT": "1"}, clock)
    got_s, scan_s, _ = run(batch, {"OSIM_WAVE_COMMIT": "0"})
    stats = {
        "nodes": n_base, "n_pad": n_pad, "lanes": s, "s_pad": s_pad, "ladder": ladder,
        "pods": n_pods, "wave_s": wave_s, "scan_s": scan_s, "equal": same(got_w, got_s),
        "fallbacks": int(counts_w["fallbacks"]), "scan_us_per_pod": scan_s / n_pods * 1e6,
        **clock.summary(), "placed": int((got_s[1] >= 0).sum()),
    }
    print(f"wave[full width] timing, {n_pods} pods x {s} lanes ({s_pad} padded) x {n_pad} "
          f"node rows (ladder {ladder}): wave driver {wave_s:.3f} s ({clock.line()}; rounds "
          f"{stats['rounds']}; {stats['fallbacks']} of {stats['waves']} waves fell back to the "
          f"scan), lane-batched scan {scan_s:.3f} s ({stats['scan_us_per_pod']:.0f} us per "
          f"pod), {stats['placed']} (pod, lane) placed, "
          f"{'bit-equal' if stats['equal'] else 'DIFFERENT'}", flush=True)

    batch = encode_pods(sim.enc, pods[:n_converge])
    clock_c = RoundClock(fast, wave, torch)
    got_w, wave_s, counts = run(
        batch, {"OSIM_WAVE_COMMIT": "1", "OSIM_WAVE_SIZE": str(converge_wave)}, clock_c)
    got_s, scan_s, _ = run(batch, {"OSIM_WAVE_COMMIT": "0"})
    conv = {"pods": n_converge, "wave": converge_wave, "wave_s": wave_s, "scan_s": scan_s,
            "waves": int(counts["waves"]), "fallbacks": int(counts["fallbacks"]),
            "adopted": int(counts["waves"] - counts["fallbacks"]),
            "equal": same(got_w, got_s), **clock_c.summary(),
            "placed": int((got_s[1] >= 0).sum())}
    stats["converge"] = conv
    stats["clock_bad"] = clock.bad + clock_c.bad
    print(f"wave[full width] convergence, {n_converge} pods in waves of {converge_wave}: "
          f"wave driver {wave_s:.3f} s ({clock_c.line()}; rounds {conv['rounds']}), "
          f"{conv['adopted']} of {conv['waves']} waves adopted, {conv['fallbacks']} fell back; "
          f"lane-batched scan {scan_s:.3f} s, {conv['placed']} (pod, lane) placed, "
          f"{'bit-equal' if conv['equal'] else 'DIFFERENT'} (carry digest {got_w[0]:08x})",
          flush=True)
    return stats


def capacity_phase(torch, dp, fast):
    """The capacity search on the card: plan_full (100,000 pods x 10,000
    nodes) serially, plan_small in auto mode (batched, the wave engine) and
    serially, the wave engine against the lane-batched scan at plan_full's
    first ladder width, capacity_sweep in every mode, multi_scenario's 64
    lanes through simulate_batch, and the quickstart through
    run_apply(auto_plan=True); every result held against the JAX package's
    constants. Returns (results, failures, domain_pop launches)."""
    import io

    from open_simulator_tpu_torch import sim_configs as sc
    from open_simulator_tpu_torch.api.config import SimonConfig
    from open_simulator_tpu_torch.core.objects import Node
    from open_simulator_tpu_torch.core.workloads import reset_name_rng
    from open_simulator_tpu_torch.engine.apply import placement_digest, run_apply
    from open_simulator_tpu_torch.engine.simulator import (
        AppResource, ClusterResource, Scenario, simulate_batch,
    )

    results, failures, launches = {}, [], 0
    for label, spec, mode, want in (
        ("plan_full", sc.plan_spec(), "serial", "plan_full/serial"),
        ("plan_small", sc.plan_spec(*sc.PLAN_SMALL), "auto", "plan_small/auto"),
        ("plan_small", sc.plan_spec(*sc.PLAN_SMALL), "serial", "plan_small/serial"),
        ("capacity_sweep", sc.capacity_sweep_spec(), "serial", "capacity_sweep/serial"),
        ("capacity_sweep", sc.capacity_sweep_spec(), "batched", "capacity_sweep/batched"),
        ("capacity_sweep", sc.capacity_sweep_spec(), "auto", "capacity_sweep/auto"),
    ):
        key, wall, n_pop, stats = plan_once(torch, dp, fast, spec, mode, label)
        launches += n_pop
        results[want] = stats
        if key != sc.CAPACITY_DIGESTS[want]:
            failures.append(f"{want}: {key} != {sc.CAPACITY_DIGESTS[want]}")
        if label.startswith("plan") and mode == "serial" and n_pop != stats["sims"]:
            failures.append(f"{want}: {n_pop} domain_pop launches for {stats['sims']} simulate() calls")
        if label == "plan_small" and mode == "auto" and not stats.get("rounds_mean"):
            failures.append("plan_small/auto: the wave engine never ran")
        failures += [f"{want}: {b}" for b in stats["clock_bad"]]
    results["wave_full_width"] = stats = wave_width_check(torch, fast)
    conv = stats["converge"]
    if not stats["equal"]:
        failures.append("wave driver and lane-batched scan differ at full width")
    if not (conv["equal"] and conv["fallbacks"] == 0 and conv["adopted"] == conv["waves"] > 0):
        failures.append(f"wave convergence run: {conv['adopted']} of {conv['waves']} waves "
                        f"adopted, {conv['fallbacks']} fell back, equal to the scan: "
                        f"{conv['equal']}")
    failures += [f"wave[full width]: {b}" for b in stats["clock_bad"]]

    reset_name_rng()
    cluster, apps = sc._port_build(sc.multi_scenario_spec())
    counts = sc.multi_scenario_counts()
    scenarios = [Scenario(name=f"s-{i}", node_count=c) for i, c in enumerate(counts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = simulate_batch(cluster, apps, scenarios, device="cuda")
    wall = time.perf_counter() - t0
    bad = [i for i, (c, r) in enumerate(zip(counts, lanes))
           if sc.result_digest(r) != sc.MULTI_SCENARIO_DIGESTS[c]]
    print(f"multi_scenario {len(lanes)} lanes x 400 pods x 64 nodes: {wall:.3f} s, "
          f"{len(lanes) / wall:.2f} scenarios/s, {len(lanes) - len(bad)} lane digests equal",
          flush=True)
    results["multi_scenario"] = {"wall_s": wall, "lanes_equal": len(lanes) - len(bad)}
    if bad:
        failures.append(f"multi_scenario: lanes {bad} differ")

    reset_name_rng()
    dp.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    outcome = run_apply(SimonConfig.load("example/simon-config.yaml"), out=out, device="cuda")
    wall = time.perf_counter() - t0
    launches += dp.launches
    text = out.getvalue()
    got = (sc.report_digest(text), placement_digest(outcome.result),
           outcome.plan.nodes_added if outcome.plan else -1,
           outcome.plan.attempts if outcome.plan else -1)
    print(f"quickstart {wall:.3f} s: {text.splitlines()[1]!r}; report {got[0]}, placement "
          f"{got[1]}, domain_pop launches {dp.launches}", flush=True)
    results["quickstart"] = {"wall_s": wall, "launches": dp.launches}
    if got != sc.QUICKSTART_DIGEST:
        failures.append(f"quickstart: {got} != {sc.QUICKSTART_DIGEST}")
    return results, failures, launches


def prove_phase(torch, dp):
    """`simon prove` on the card: the whole corpus (151,875 universes)
    through the serial universe scan and through the wave engine, each with
    0 divergences against the port's oracle and verifying the unchanged
    budgets/commit_contract.json; then both commit-rule mutations on the
    reference's PINNED universes, which must be caught (tiebreak's
    counterexample minimized, no larger than the universe that diverged).
    Each engine runs as the CLI runs it, with its own oracle pass. Returns
    (results, failures, domain_pop launches)."""
    from open_simulator_tpu_torch.analysis import semantics
    from open_simulator_tpu_torch.utils import metrics

    results, failures = {}, []
    dp.launches = 0
    for engine in ("serial", "wave"):
        rounds0 = metrics.COMMIT_ROUNDS.child_state()
        falls0 = metrics.WAVE_FALLBACKS.value(reason="universes_max_rounds")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = semantics.run_prove(engine=engine, device="cuda")
        wall = time.perf_counter() - t0
        rounds1 = metrics.COMMIT_ROUNDS.child_state()
        chunks = rounds1[2] - rounds0[2]
        rounds = rounds1[1] - rounds0[1]
        falls = metrics.WAVE_FALLBACKS.value(reason="universes_max_rounds") - falls0
        stats = {
            "wall_s": wall, "universes": rep.universes_checked, "device_calls": rep.device_calls,
            "universes_per_s": rep.universes_checked / wall, "engine_s": rep.engine_s,
            "oracle_s": rep.oracle_s, "oracle_share": rep.oracle_s / wall,
            "divergences": rep.divergence_total, "digest": rep.digest,
            "contract_ok": rep.contract_ok, "wave_chunks": chunks,
            "rounds_per_chunk": rounds / chunks if chunks else None, "fallbacks": falls,
        }
        results[engine] = stats
        print(f"prove[{engine}] {rep.universes_checked} universes: wall {wall:.3f} s "
              f"({rep.universes_checked / wall:.1f} universes/s), {rep.device_calls} device "
              f"calls, engine {rep.engine_s:.3f} s, oracle {rep.oracle_s:.3f} s "
              f"({100 * rep.oracle_s / wall:.1f} % of the wall), divergences "
              f"{rep.divergence_total}, contract {'VERIFIED' if rep.contract_ok else 'VIOLATED'} "
              f"{rep.digest[:15]}..."
              + (f", {chunks} chunks at {rounds / chunks:.2f} rounds each, {falls:.0f} fell back"
                 if engine == "wave" else ""), flush=True)
        if not (rep.ok and rep.contract_ok and rep.divergence_total == 0
                and rep.universes_checked == 151_875):
            failures.append(f"prove[{engine}]: {rep.divergence_total} divergences, contract "
                            f"{rep.contract_ok} {rep.contract_messages}")
        if engine == "wave" and chunks != rep.device_calls:
            failures.append(f"prove[wave]: {chunks} wave drives for {rep.device_calls} chunks")
    scope = semantics.SmallScope()
    pinned = [semantics.Universe(n, p) for n, p in (
        ("B---", "ppppp"), ("AA--", "ppppp"), ("D---", "ppppp"), ("B---", "qqqqq"),
        ("A---", "rrrrr"), ("A---", "ppppq"), ("C---", "rrrrr"))]
    for mode in semantics.MUTATIONS:
        t0 = time.perf_counter()
        rep = semantics.check_universes(scope, pinned, mutate=mode, device="cuda")
        caught = rep.divergence_total > 0 and not rep.ok
        small = None
        if caught:
            bad = semantics.Universe(*rep.divergences[0].universe.split("/"))
            small = semantics.minimize(scope, bad, mode, device="cuda")
            if not (semantics._diverges(scope, small, mode, device="cuda")
                    and len(small.nodes.replace("-", "")) <= len(bad.nodes.replace("-", ""))
                    and len(small.pods) <= len(bad.pods)):
                failures.append(f"prove mutation {mode}: minimized {small.key} does not hold")
        wall = time.perf_counter() - t0
        print(f"prove mutation {mode}: caught {caught} ({rep.divergence_total} diverging fields), "
              f"minimized counterexample {small.key if small else None}, {wall:.3f} s", flush=True)
        results[f"mutate_{mode}"] = {"caught": caught, "minimized": small.key if small else None,
                                     "wall_s": wall}
        if not caught:
            failures.append(f"prove mutation {mode} was not caught")
    return results, failures, dp.launches


def extender_phase(torch, dp):
    """Scheduler extenders, their retries and kubeConfig snapshots on the
    card, against local stub servers on 127.0.0.1 (tools/stubs.py):
    simulate() of sim_configs.extender_spec() behind a filter + prioritize +
    preempt extender (two full waves of 64 pods, four preemptions through
    the preempt verb); plan_capacity behind an extender that admits only
    the clones, with one transient blip injected (retries must be 1); and
    run_apply on a kubeConfig served by a stub apiserver. Each result and
    the stubs' request counts are held against the JAX package's constants.
    Returns (results, failures, domain_pop launches)."""
    import io
    import os
    import tempfile

    from open_simulator_tpu_torch import sim_configs as sc
    from open_simulator_tpu_torch.api.config import SimonConfig
    from open_simulator_tpu_torch.core import objects, workloads
    from open_simulator_tpu_torch.engine import apply, capacity, simulator
    from open_simulator_tpu_torch.models import profiles
    from open_simulator_tpu_torch.resilience import faults, policy
    from open_simulator_tpu_torch.tools import stubs
    from open_simulator_tpu_torch.utils import httppool, metrics

    results, failures = {}, []
    dp.launches = 0
    stub = stubs.StubExtender(sc.EXTENDER_BEHAVIOR)
    cstub = stubs.StubExtender(sc.EXTENDER_CAPACITY_BEHAVIOR)
    api = stubs.StubApiServer(stubs.KUBE_APIS)
    saved = {k: os.environ.get(k) for k in ("OSIM_RETRY_BASE_S", "OSIM_BREAKER_THRESHOLD")}
    try:
        for run in ("cold", "warm"):
            workloads.reset_name_rng()
            policy.reset_breakers()
            stub.calls.clear()
            respill0 = metrics.EXTENDER_WAVE_RESPILL.value()
            waves0 = metrics.EXTENDER_WAVE_SIZE.child_state()[2]
            t0 = time.perf_counter()
            res = sc.extender_simulate(simulator, objects, profiles, stub.url, device="cuda")
            wall = time.perf_counter() - t0
            got = (sc.result_digest(res), stub.verb_counts())
            waves = metrics.EXTENDER_WAVE_SIZE.child_state()[2] - waves0
            respills = metrics.EXTENDER_WAVE_RESPILL.value() - respill0
            print(f"extenders[simulate {run}] {sc.result_counts(res)} placed/unscheduled/"
                  f"preempted: wall {wall:.3f} s, {waves} waves, {respills:.0f} respills, "
                  f"HTTP {got[1]}, digest {got[0]}", flush=True)
            results[f"simulate_{run}"] = {"wall_s": wall, "waves": waves, "respills": respills,
                                          "http": got[1], "counts": sc.result_counts(res)}
            if got != sc.EXTENDER_DIGESTS["simulate"]:
                failures.append(f"extenders[simulate {run}]: {got} != "
                                f"{sc.EXTENDER_DIGESTS['simulate']}")
        # the blip must not open the circuit, and backoff sleeps are noise
        os.environ["OSIM_RETRY_BASE_S"] = "0"
        os.environ["OSIM_BREAKER_THRESHOLD"] = "1000"
        workloads.reset_name_rng()
        policy.reset_breakers()
        httppool.reset_pools()
        faults.install_plan(faults.FaultPlan.from_dict(sc.EXTENDER_FAULT_PLAN))
        t0 = time.perf_counter()
        try:
            plan = sc.extender_capacity(simulator, objects, profiles, capacity, cstub.url,
                                        device="cuda")
        finally:
            faults.uninstall_plan()
        wall = time.perf_counter() - t0
        got = (plan.nodes_added, plan.attempts, plan.retries, sc.result_digest(plan.result),
               cstub.verb_counts())
        print(f"extenders[capacity] +{plan.nodes_added} nodes in {plan.attempts} simulations, "
              f"retries {plan.retries}: wall {wall:.3f} s, HTTP {got[4]}", flush=True)
        results["capacity"] = {"wall_s": wall, "nodes_added": plan.nodes_added,
                               "attempts": plan.attempts, "retries": plan.retries, "http": got[4]}
        if got != sc.EXTENDER_DIGESTS["capacity"] or plan.retries != 1:
            failures.append(f"extenders[capacity]: {got} != {sc.EXTENDER_DIGESTS['capacity']}")
        with tempfile.TemporaryDirectory() as tmp:
            cfg = SimonConfig.load(stubs.write_kube_apply_config(tmp, api.url))
            workloads.reset_name_rng()
            t0 = time.perf_counter()
            outcome = apply.run_apply(cfg, auto_plan=False, out=io.StringIO(), device="cuda")
            wall = time.perf_counter() - t0
        got = (sc.report_digest(outcome.report), apply.placement_digest(outcome.result),
               len(outcome.result.unscheduled))
        print(f"extenders[kubeConfig apply] wall {wall:.3f} s, {len(api.auth_seen)} apiserver "
              f"GETs, report {got[0]}, placement {got[1]}", flush=True)
        results["kube_apply"] = {"wall_s": wall, "gets": len(api.auth_seen)}
        if got != sc.KUBE_APPLY_DIGEST:
            failures.append(f"extenders[kubeConfig apply]: {got} != {sc.KUBE_APPLY_DIGEST}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for srv in (stub, cstub, api):
            srv.close()
        httppool.reset_pools()
    return results, failures, dp.launches


class _Env:
    """Set environment variables for a block (None unsets one), then put
    every one back."""

    def __init__(self, **knobs):
        self.knobs = knobs

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in self.knobs}
        for k, v in self.knobs.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _CallClock:
    """Times every call of a module function (synced before and after) for
    a block: wraps `mod.name`, restores it on exit."""

    def __init__(self, torch, mod, name):
        self.torch, self.mod, self.name = torch, mod, name
        self.real = getattr(mod, name)
        self.seconds: list = []

    def __enter__(self):
        def timed(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            self.torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)

    def ms(self) -> float:
        return sum(self.seconds) / len(self.seconds) * 1e3 if self.seconds else 0.0


def _cli_quiet(argv):
    """The port's CLI in this process with its stdout kept, and the osim
    logger back at ERROR afterwards (the CLI sets it from LogLevel)."""
    import contextlib
    import io
    import logging

    from open_simulator_tpu_torch import cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        logging.getLogger("osim").setLevel(logging.ERROR)
    return rc, buf.getvalue()


def durable_phase(torch, dp, fast):
    """Durable runs on the card.
    1. The chunked scan at full width: plan_full's first ladder sweep (6
       lanes padded to 8 x 20,480 node rows) over its first CHUNK_SCAN_PODS
       pods, OSIM_COMMIT_CHUNK=64, snapshots every 2 chunks; each run
       bit-equal to the monolithic scan (carry digest and all five
       outputs), whose digest is the JAX package's constant: (a) chunked
       under a PlanCheckpointer, (b) device_lost twice at chunk 5, recovered
       in place, (c) device_lost three times at chunk 5, which raises with
       chunks 0-4 journaled, then a resume that skips the 5 chunks its
       newest snapshot covers, (d) the same crash with its newest snapshot
       torn, whose resume falls back to the previous one (4 chunks skipped).
    2. The wave driver under a checkpointer: 256 pods in waves of 16 with one
       device_lost at wave 6; every wave adopted, bit-equal to the scan.
    3. Process kills on the card: `sweep --capacity` on the sweep fixture
       killed by a chunk_kill rule, and `apply --run-dir` on the quickstart
       killed by a journal kill rule at its second trial record, each in a
       subprocess, then `runs resume`; placement digests equal to the clean
       runs' and the JAX CLI's; and `apply --run-dir` past a tiny
       OSIM_CALL_DEADLINE_S, which exits 3 with the fire journaled, then
       `runs resume` to the same digest.
    Returns (results, failures, domain_pop launches)."""
    import os
    import shutil
    import subprocess
    import tempfile

    from open_simulator_tpu_torch import sim_configs as sc
    from open_simulator_tpu_torch.durable import RunJournal, replay
    from open_simulator_tpu_torch.durable.checkpoint import PlanCheckpointer, installed
    from open_simulator_tpu_torch.ops.encode import encode_pods
    from open_simulator_tpu_torch.ops.state import stack_carry
    from open_simulator_tpu_torch.resilience import faults
    from open_simulator_tpu_torch.utils import metrics

    results, failures, launches = {}, [], 0
    t_setup = time.perf_counter()
    lanes = full_width_lanes(torch)
    sim, s, s_pad = lanes["sim"], lanes["s"], lanes["s_pad"]
    batch = encode_pods(sim.enc, lanes["app_pods"][0][:sc.CHUNK_SCAN_PODS])
    results["setup_s"] = time.perf_counter() - t_setup
    tmp = tempfile.mkdtemp(prefix="chip-smoke-durable-")
    chunk, every = 64, 2
    n_chunks = -(-int(batch.p) // chunk)
    chunked = dict(OSIM_WAVE_COMMIT="0", OSIM_COMMIT_CHUNK=chunk, OSIM_WAVE_SIZE=None,
                   OSIM_FLIGHT_DIR=os.path.join(tmp, "flight"))

    def device_lost(i, times):
        return faults.FaultPlan.from_dict({"rules": [{
            "target": "device", "op": f"commit-chunk:{i}", "kind": "device_lost",
            "times": times}]})

    def run(b, knobs, run_dir=None, resume=False, plan=None):
        """One schedule_scenarios_host call on a fresh stacked carry ->
        ((carry digest, *outputs), wall s)."""
        journal = RunJournal.open(run_dir) if run_dir else None
        if plan is not None:
            faults.install_plan(plan)
        try:
            with _Env(**knobs):
                carry_s = stack_carry(sim._carry, s_pad)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if journal is None:
                    out = fast.schedule_scenarios_host(
                        sim._ns, carry_s, b, lanes["weights_s"], lanes["valid_s"], s)
                else:
                    with installed(PlanCheckpointer(journal, resume=resume, every=every)):
                        out = fast.schedule_scenarios_host(
                            sim._ns, carry_s, b, lanes["weights_s"], lanes["valid_s"], s)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            if plan is not None:
                faults.uninstall_plan()
            if journal is not None:
                journal.close()
        return (fast.scenario_carry_digest(out[0]),) + tuple(out[1:]), wall

    def same(a, b):
        return a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))

    def chunks_of(d):
        return [e["chunk"] for e in replay(d) if e["event"] == "plan_chunk"]

    try:
        mono, mono_s = run(batch, dict(chunked, OSIM_COMMIT_CHUNK=None))
        walls = {"monolithic": mono_s}
        if mono[0] != sc.CHUNK_SCAN_DIGEST:
            failures.append(f"monolithic scan digest {mono[0]:08x} != JAX "
                            f"{sc.CHUNK_SCAN_DIGEST:08x}")
        bytes0 = metrics.CHECKPOINT_BYTES.value()
        with _CallClock(torch, fast, "scenario_carry_digest") as dclock, \
                _CallClock(torch, fast, "carry_from_host") as rclock:
            got, walls["a_chunked"] = run(batch, chunked, os.path.join(tmp, "a"))
            snap_bytes = metrics.CHECKPOINT_BYTES.value() - bytes0
            if not same(got, mono) or chunks_of(os.path.join(tmp, "a")) != list(range(n_chunks)):
                failures.append("(a) chunked run under a checkpointer differs from the scan")
            yes0 = metrics.DEVICE_LOST.value(handled="yes")
            got, walls["b_device_lost"] = run(batch, chunked, os.path.join(tmp, "b"),
                                              plan=device_lost(5, 2))
            lost = metrics.DEVICE_LOST.value(handled="yes") - yes0
            if not same(got, mono) or lost != 2:
                failures.append(f"(b) two device losses: {lost} handled, equal "
                                f"{same(got, mono)}")
            crash = os.path.join(tmp, "c")
            t0 = time.perf_counter()
            try:
                run(batch, chunked, crash, plan=device_lost(5, 3))
                failures.append("(c) a third device loss did not raise")
            except faults.DeviceLostError:
                pass
            walls["c_crash"] = time.perf_counter() - t0
            if sorted(set(chunks_of(crash))) != [0, 1, 2, 3, 4]:
                failures.append(f"(c) journaled chunks {chunks_of(crash)}")
            torn = os.path.join(tmp, "d")
            shutil.copytree(crash, torn)
            # the rollbacks re-ran chunk 4, and its second run closed a
            # snapshot interval (the reference's counter counts re-runs),
            # so the newest snapshot covers chunks 0-4, the previous 0-3
            snaps = sorted(os.listdir(os.path.join(crash, "ckpt")))
            skip0 = metrics.RESUME_CHUNKS_SKIPPED.value()
            got, walls["c_resume"] = run(batch, chunked, crash, resume=True)
            skipped_c = metrics.RESUME_CHUNKS_SKIPPED.value() - skip0
            if not same(got, mono) or skipped_c != 5 or \
                    [n[-10:-4] for n in snaps] != ["000004", "000005"]:
                failures.append(f"(c) resume skipped {skipped_c} chunks, snapshots {snaps}, "
                                f"equal {same(got, mono)}")
            newest = sorted(os.listdir(os.path.join(torn, "ckpt")))[-1]
            path = os.path.join(torn, "ckpt", newest)
            with open(path, "rb+") as fh:
                fh.truncate(os.path.getsize(path) // 2)
            skip0 = metrics.RESUME_CHUNKS_SKIPPED.value()
            got, walls["d_torn_resume"] = run(batch, chunked, torn, resume=True)
            skipped_d = metrics.RESUME_CHUNKS_SKIPPED.value() - skip0
            if not same(got, mono) or skipped_d != 4:
                failures.append(f"(d) torn snapshot: resume skipped {skipped_d} chunks, equal "
                                f"{same(got, mono)}")
        digest_ms, restore_ms = dclock.ms(), rclock.ms()
        print(f"durable[chunked scan] {int(batch.p)} pods x {s} lanes ({s_pad} padded) x "
              f"{lanes['n_pad']} node rows, {n_chunks} chunks of {chunk}, snapshot every {every}: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
              + f"; snapshots {snap_bytes / 1e6:.1f} MB in run (a), carry digest "
              f"{digest_ms:.2f} ms a call ({len(dclock.seconds)} calls), restore "
              f"{restore_ms:.2f} ms a call ({len(rclock.seconds)} calls); resumes skipped "
              f"{skipped_c} and {skipped_d} chunks; carry digest {mono[0]:08x}", flush=True)
        results["chunked"] = {"pods": int(batch.p), "chunks": n_chunks, "walls_s": walls,
                              "scan_us_per_pod": mono_s / int(batch.p) * 1e6,
                              "snapshot_bytes": snap_bytes, "digest_ms": digest_ms,
                              "restore_ms": restore_ms, "digest": f"{mono[0]:08x}"}

        batch_w = encode_pods(sim.enc, lanes["app_pods"][0][:256])
        scan, scan_s = run(batch_w, dict(chunked, OSIM_COMMIT_CHUNK=None))
        before = _wave_counters(metrics)
        yes0 = metrics.DEVICE_LOST.value(handled="yes")
        got, wave_s = run(batch_w, dict(chunked, OSIM_WAVE_COMMIT="1", OSIM_COMMIT_CHUNK=None,
                                        OSIM_WAVE_SIZE=16),
                          os.path.join(tmp, "w"), plan=device_lost(6, 1))
        after = _wave_counters(metrics)
        waves, fallbacks = after["waves"] - before["waves"], after["fallbacks"] - before["fallbacks"]
        lost = metrics.DEVICE_LOST.value(handled="yes") - yes0
        print(f"durable[wave] 256 pods in waves of 16 with a device_lost at wave 6: wave driver "
              f"{wave_s:.3f} s ({int(waves)} waves committed, {int(fallbacks)} fell back, "
              f"{int(lost)} losses recovered), scan {scan_s:.3f} s, "
              f"{'bit-equal' if same(got, scan) else 'DIFFERENT'}", flush=True)
        results["wave"] = {"wave_s": wave_s, "scan_s": scan_s, "waves": waves,
                           "fallbacks": fallbacks, "lost": lost}
        if not (same(got, scan) and fallbacks == 0 and lost == 1 and waves >= 16):
            failures.append(f"wave driver with a checkpointer: {int(waves)} waves, "
                            f"{int(fallbacks)} fallbacks, {int(lost)} losses, equal "
                            f"{same(got, scan)}")

        # -- process kills and `runs resume` ----------------------------------
        kill_sweep = ("rules:\n  - target: device\n    op: \"commit-chunk:2\"\n"
                      "    kind: chunk_kill\n    times: 1\n")
        kill_apply = ("rules:\n  - target: journal\n    op: trial\n    kind: kill\n"
                      "    after: 1\n    times: 1\n")
        legs = (
            ("sweep", ["sweep", "--capacity", "-f", "tests/fixtures/sweep/simon-config.yaml"],
             kill_sweep, "plan_chunk"),
            ("apply", ["apply", "-f", "example/simon-config.yaml"], kill_apply, "trial"),
        )
        knobs = dict(OSIM_COMMIT_CHUNK=8, OSIM_CKPT_EVERY=every, OSIM_WAVE_COMMIT=None,
                     OSIM_FAULT_PLAN=None, OSIM_FLIGHT_DIR=os.path.join(tmp, "flight"),
                     OSIM_CALL_DEADLINE_S=None, LogLevel="error")
        root = os.path.dirname(os.path.abspath(__file__))
        for name, argv, kill_plan, record in legs:
            clean, killed = os.path.join(tmp, f"{name}-clean"), os.path.join(tmp, f"{name}-kill")
            plan_path = os.path.join(tmp, f"{name}-plan.yaml")
            with open(plan_path, "w") as fh:
                fh.write(kill_plan)
            dp.launches = 0
            with _Env(**knobs):
                t0 = time.perf_counter()
                rc_clean, _ = _cli_quiet(argv + ["--run-dir", clean, "--device", "cuda"])
                clean_s = time.perf_counter() - t0
                env = dict(os.environ, OSIM_FAULT_PLAN=plan_path, PYTHONPATH=root)
                t0 = time.perf_counter()
                child = subprocess.run(
                    [sys.executable, "-m", "open_simulator_tpu_torch.cli"] + argv
                    + ["--run-dir", killed, "--device", "cuda"],
                    env=env, cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True)
                killed_s = time.perf_counter() - t0
                records = sum(e["event"] == record for e in replay(killed))
                t0 = time.perf_counter()
                rc_resume, _ = _cli_quiet(["runs", "resume", killed, "--device", "cuda"])
                resume_s = time.perf_counter() - t0
            launches += dp.launches
            digests = []
            for d in (clean, killed):
                try:
                    with open(os.path.join(d, "outcome.json")) as fh:
                        digests.append(json.load(fh)["placement_digest"])
                except (OSError, ValueError, KeyError):
                    digests.append(None)
            print(f"durable[kill {name}] clean run {clean_s:.3f} s (rc {rc_clean}); killed "
                  f"subprocess {killed_s:.3f} s (rc {child.returncode}, {records} {record} "
                  f"records journaled); runs resume {resume_s:.3f} s (rc {rc_resume}); "
                  f"placement digests {digests} vs JAX {sc.RUN_DIR_DIGESTS[name]}; domain_pop "
                  f"launches {dp.launches}", flush=True)
            results[f"kill_{name}"] = {"clean_s": clean_s, "killed_s": killed_s,
                                       "resume_s": resume_s, "records": records,
                                       "launches": dp.launches}
            if child.returncode not in (-9, 137):
                failures.append(f"kill {name}: rc {child.returncode}, expected SIGKILL; "
                                f"stderr tail {child.stderr[-400:]!r}")
            if not records or (name == "apply" and records != 1):
                failures.append(f"kill {name}: {records} {record} records journaled")
            if (rc_clean, rc_resume) != (0, 0) or digests != [sc.RUN_DIR_DIGESTS[name]] * 2:
                failures.append(f"kill {name}: rc clean {rc_clean}, resume {rc_resume}, "
                                f"digests {digests} != {sc.RUN_DIR_DIGESTS[name]}")

        # a mid-run deadline: the child exits 3 with the fire journaled (no
        # CPU retry), and `runs resume` finishes the run on the card
        late = os.path.join(tmp, "apply-deadline")
        with _Env(**knobs):
            env = dict(os.environ, OSIM_CALL_DEADLINE_S="0.001", PYTHONPATH=root)
            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, "-m", "open_simulator_tpu_torch.cli", "apply", "-f",
                 "example/simon-config.yaml", "--run-dir", late, "--device", "cuda"],
                env=env, cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            late_s = time.perf_counter() - t0
            events = replay(late)
            t0 = time.perf_counter()
            rc_resume, _ = _cli_quiet(["runs", "resume", late, "--device", "cuda"])
            resume_s = time.perf_counter() - t0
        stages = [e["stage"] for e in events if e["event"] == "watchdog"]
        try:
            with open(os.path.join(late, "outcome.json")) as fh:
                digest = json.load(fh)["placement_digest"]
        except (OSError, ValueError, KeyError):
            digest = None
        print(f"durable[deadline apply] subprocess {late_s:.3f} s (rc {child.returncode}, "
              f"watchdog records {stages}, fallback records "
              f"{sum(e['event'] == 'backend_fallback' for e in events)}); runs resume "
              f"{resume_s:.3f} s (rc {rc_resume}); placement digest {digest}", flush=True)
        results["deadline_apply"] = {"subprocess_s": late_s, "resume_s": resume_s}
        if child.returncode != 3 or stages != ["apply-simulate"] or rc_resume != 0 or \
                digest != sc.RUN_DIR_DIGESTS["apply"]:
            failures.append(f"deadline apply: rc {child.returncode}, watchdog {stages}, resume "
                            f"rc {rc_resume}, digest {digest}; stderr tail "
                            f"{child.stderr[-400:]!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _FULL_WIDTH.clear()
    return results, failures, launches


def _planes_equal(res, encode_nodes):
    """The resident's host mirror and device planes against a fresh encode
    of its nodes and bound pods at its shapes, byte for byte."""
    import dataclasses

    from open_simulator_tpu_torch.engine.resident import DEVICE_PLANES
    from open_simulator_tpu_torch.ops.encode import NodeTable

    fresh = encode_nodes(res.enc, res._nodes, existing_usage=res._usage,
                         existing_gpu=res._gpu_usage, n_pad=res._host.n, min_axes=res._axes)
    for f in dataclasses.fields(NodeTable):
        if f.name != "names" and getattr(res._host, f.name).tobytes() != \
                getattr(fresh, f.name).tobytes():
            return False
    return all(res._dev[n].cpu().numpy().tobytes() == getattr(fresh, n).tobytes()
               for n in DEVICE_PLANES)


def resident_phase(torch, dp, fast):
    """Resident cluster state on the card: a ResidentCluster over
    sim_configs.plan's 10,000 nodes through RESIDENT_ROUNDS seeded delta
    rounds of RESIDENT_CHANGES node changes (labels, taints, allocatable,
    bound-pod usage, nodes added within the bucket), verify_now every 8
    rounds, one torn_delta and one digest_mismatch injected (both repaired
    and counted); the final digest_table equal to the JAX constant and the
    planes to a fresh encode. Then simulate() of plan's apps on the cluster
    after the rounds, with the resident (twice) and without: equal result
    digests, the JAX constant, one domain_pop launch per call. Returns
    (results, failures, domain_pop launches)."""
    import copy
    import tempfile

    from open_simulator_tpu_torch import sim_configs as sc
    from open_simulator_tpu_torch.core.objects import Node, Pod
    from open_simulator_tpu_torch.core.workloads import reset_name_rng
    from open_simulator_tpu_torch.engine.resident import ResidentCluster, digest_table
    from open_simulator_tpu_torch.engine.simulator import AppResource, ClusterResource, simulate
    from open_simulator_tpu_torch.ops.encode import Encoder, encode_nodes
    from open_simulator_tpu_torch.resilience import faults
    from open_simulator_tpu_torch.utils import metrics

    results, failures, launches = {}, [], 0
    nodes, apps = sc.plan_spec()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-resident-")
    walk = sc.ResidentWalk(Node, Pod, nodes)
    encode_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode_nodes(Encoder(topology_keys=("kubernetes.io/hostname",)), walk.nodes)
        encode_s.append(time.perf_counter() - t0)
    res = ResidentCluster(journal_dir=tmp, device="cuda")
    t0 = time.perf_counter()
    res.sync(walk.nodes, [])
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    repairs0 = {r: metrics.RESIDENT_DRIFT_REPAIRS.value(reason=r)
                for r in ("torn_delta", "digest_mismatch")}
    deltas0 = {k: metrics.RESIDENT_DELTAS.value(kind=k)
               for k in ("node_row", "node_added", "pod_usage")}
    torn = faults.FaultPlan.from_dict({"rules": [
        {"target": "resident", "op": "apply", "kind": "torn_delta", "times": 1}]})
    mismatch = faults.FaultPlan.from_dict({"rules": [
        {"target": "resident", "op": "verify", "kind": "digest_mismatch", "times": 1}]})
    sync_s, verify_s, verdicts = [], [], []
    for r, (changed, pods) in enumerate(sc.resident_rounds(nodes)):
        n, p = walk.apply(changed, pods)
        if r == 10:
            faults.install_plan(torn)
        t0 = time.perf_counter()
        res.sync(n, p)
        torch.cuda.synchronize()
        sync_s.append(time.perf_counter() - t0)
        faults.uninstall_plan()
        if (r + 1) % 8 == 0:
            if r + 1 == 16:
                faults.install_plan(mismatch)
            t0 = time.perf_counter()
            verdicts.append(res.verify_now())
            verify_s.append(time.perf_counter() - t0)
            faults.uninstall_plan()
    repaired = {k: metrics.RESIDENT_DRIFT_REPAIRS.value(reason=k) - v for k, v in repairs0.items()}
    deltas = {k: metrics.RESIDENT_DELTAS.value(kind=k) - v for k, v in deltas0.items()}
    digest = digest_table(res._host, res._dev)
    equal = _planes_equal(res, encode_nodes)
    steady = sorted(sync_s[:10] + sync_s[11:])
    print("resident[rounds] sync ms per round: "
          + ", ".join(f"{v * 1e3:.1f}" for v in sync_s), flush=True)
    print(f"resident[rounds] {len(n)} nodes, {len(p)} bound pods after {len(sync_s)} rounds of "
          f"{sc.RESIDENT_CHANGES} changes: cold sync {cold_s * 1e3:.1f} ms; delta sync median "
          f"{steady[len(steady) // 2] * 1e3:.1f} ms, max {steady[-1] * 1e3:.1f} ms; the torn "
          f"round {sync_s[10] * 1e3:.1f} ms; verify {', '.join(f'{v * 1e3:.0f}' for v in verify_s)}"
          f" ms ({verdicts}); full encode_nodes {min(encode_s) * 1e3:.1f} ms (best of 3); "
          f"deltas {deltas}; repairs {repaired}; digest_table {digest} (JAX "
          f"{sc.RESIDENT_DIGEST}), planes {'equal' if equal else 'DIFFERENT'} to a fresh encode",
          flush=True)
    results["rounds"] = {"cold_sync_s": cold_s, "sync_s": sync_s, "verify_s": verify_s,
                         "encode_s": encode_s, "deltas": deltas, "repairs": repaired,
                         "digest": digest}
    if digest != sc.RESIDENT_DIGEST or not equal:
        failures.append(f"resident digest {digest} != {sc.RESIDENT_DIGEST} or planes differ")
    if repaired != {"torn_delta": 1, "digest_mismatch": 1} or res.repairs != 2:
        failures.append(f"resident repairs {repaired}, {res.repairs} in all")
    if verdicts != [True, False, True, True]:
        failures.append(f"resident verify_now verdicts {verdicts}")

    not_covering = metrics.RESIDENT_FALLBACKS.value(reason="not_covering")
    for label, kw in (("resident", {"resident": res}), ("resident warm", {"resident": res}),
                      ("plain", {})):
        reset_name_rng()
        cluster = ClusterResource(nodes=list(n), pods=list(p))
        app_objs = [AppResource(name=a, objects=copy.deepcopy(o)) for a, o in apps]
        dp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = simulate(cluster, app_objs, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += dp.launches
        got = sc.result_digest(result)
        print(f"resident[simulate {label}] {wall:.3f} s, placed/unscheduled/preempted "
              f"{sc.result_counts(result)}, digest {got}, domain_pop launches {dp.launches}",
              flush=True)
        results[f"simulate_{label.replace(' ', '_')}"] = {"wall_s": wall, "launches": dp.launches}
        if got != sc.RESIDENT_SIM_DIGEST or dp.launches != 1:
            failures.append(f"resident simulate {label}: digest {got} (JAX "
                            f"{sc.RESIDENT_SIM_DIGEST}), {dp.launches} domain_pop launches")
    if metrics.RESIDENT_FALLBACKS.value(reason="not_covering") != not_covering:
        failures.append("simulate(resident=) fell back to a full encode")
    return results, failures, launches


class _Client:
    """HTTP client of the serve phase: every request's (path, code) is
    tallied (to hold /metrics against) and its latency kept per leg."""

    def __init__(self):
        import threading

        self.tally, self.lat, self._lock = {}, [], threading.Lock()

    def request(self, port, path, body=None, headers=None, timeout=600.0):
        import urllib.error
        import urllib.parse
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                     headers={"Content-Type": "application/json", **(headers or {})})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                out = (r.status, dict(r.headers), r.read())
        except urllib.error.HTTPError as e:
            out = (e.code, dict(e.headers), e.read())
        with self._lock:
            key = (urllib.parse.urlparse(path).path, str(out[0]))
            self.tally[key] = self.tally.get(key, 0) + 1
            if body is not None:
                self.lat.append(time.perf_counter() - t0)
        return out

    def burst(self, port, bodies):
        """POST every body to /api/deploy-apps at once, one thread each;
        results in body order."""
        import threading

        out = [None] * len(bodies)

        def one(i):
            out[i] = self.request(port, "/api/deploy-apps", bodies[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out


def _pct(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))] if vals else 0.0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(text):
    """{(family, labels): value} of a Prometheus text exposition; raises on a
    line that is neither a comment nor a sample."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        m = sample.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line {line!r}")
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def serve_phase(torch, dp, fast):
    """The port's server on the card (server/server.py), embedded on a thread
    with `serve(device="cuda", kubeconfig=...)` against a stub apiserver
    holding config_plan's 10,000 nodes in 3 zones, with the resident on.
    The full request is config_plan's apps (100,000 pods), the small one the
    `web` Deployment at 256 replicas; every response is held against
    sim_configs.SERVE_DIGESTS (the JAX package's server on the same stub and
    bodies). Legs: lone (cold, then again), fan-out (4 identical full
    requests, one simulate), scenario pack (8 small bodies differing in
    weights, twice, then a lone one served by the warm session), overload (a
    second server at queue depth 2, 16 small bodies at once, then an
    injected queue_full), deadline (a full request past a 1,500 ms deadline
    gets 504; the next full request runs beside the abandoned worker and
    matches the name-free census), resync (the stub moves by RESIDENT_ROUNDS
    rounds; the refresh lands as a resident delta sync, the fence re-keys a
    queued request, the response matches the JAX constant), job
    (capacity_sweep's batched plan through POST /v1/jobs), observability
    (/metrics against the requests sent, /debug/timings, /debug/profile
    during a full request, an incoming traceparent continued), soak (30
    small requests after 5 on the cold path, then 3 packs of the 8 small
    bodies after one more on the warm session), CLI (`cli server` in a
    subprocess, an inline request, a first /debug/profile that primes the
    profiler and records kernels, SIGTERM exits 0).
    A burst that must form one pack is posted while a gate request's pack
    sleeps in an injected slow_drain (the loop takes a lone arrival at
    once). Returns (results, failures, domain_pop launches, the captured
    domain_pop inputs of a served full request)."""
    import logging
    import os
    import resource
    import shutil
    import signal
    import tempfile
    import threading

    from open_simulator_tpu_torch import sim_configs as sc
    from open_simulator_tpu_torch.core.workloads import reset_name_rng
    from open_simulator_tpu_torch.durable.watchdog import abandoned_workers
    from open_simulator_tpu_torch.resilience import faults
    from open_simulator_tpu_torch.server import server as srv_mod
    from open_simulator_tpu_torch.tools import stubs
    from open_simulator_tpu_torch.utils import metrics

    results, failures = {}, []
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    saved_env = {k: os.environ.get(k) for k in ("OSIM_RUNS_DIR", "OSIM_FLIGHT_DIR")}
    os.environ["OSIM_RUNS_DIR"] = os.path.join(tmp, "runs")
    os.environ["OSIM_FLIGHT_DIR"] = os.path.join(tmp, "flight")
    # degradations the reference logs (cold fallback, serial re-run, stale
    # snapshot): none may fire on these legs
    degraded = []

    class _Degraded(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if any(s in msg for s in ("serving cold", "re-running serially", "serving stale")):
                degraded.append(msg)

    osim_log = logging.getLogger("osim")
    handler = _Degraded()
    quiet = {h: h.level for h in osim_log.handlers}
    for h in quiet:
        h.setLevel(logging.ERROR)
    osim_log.addHandler(handler)
    osim_log.setLevel(logging.WARNING)

    nodes, _ = sc.plan_spec()
    full = sc.serve_full_body()
    small = [sc.serve_small_body(w) for w in sc.SERVE_WEIGHTS]
    api = stubs.StubApiServer(sc.live_apis(nodes))
    kube = os.path.join(tmp, "kubeconfig")
    with open(kube, "w") as fh:
        json.dump(stubs.kubeconfig_doc(api.url), fh)
    from open_simulator_tpu_torch.utils.kubeclient import create_cluster_resource_from_kubeconfig

    fetch_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        create_cluster_resource_from_kubeconfig(kube)
        fetch_s.append(time.perf_counter() - t0)
    print(f"serve[setup] stub apiserver: {len(nodes)} nodes, snapshot fetch "
          f"{', '.join(f'{v * 1e3:.0f}' for v in fetch_s)} ms", flush=True)

    from open_simulator_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    profiling.prime("cuda")  # the profiler's client initialises on the main thread
    print(f"serve[setup] profiler prime on the main thread {time.perf_counter() - t0:.3f} s",
          flush=True)
    port = _free_port()
    ready = threading.Event()
    server_thread = threading.Thread(
        target=srv_mod.serve, name="chip-smoke-serve", daemon=True,
        kwargs=dict(port=port, ready=ready, kubeconfig=kube, device="cuda"))
    server_thread.start()
    if not ready.wait(120):
        raise SystemExit("serve: the server did not come up")
    client = _Client()
    packs, syncs = [], []

    def watch_loop(server):
        loop = server.admission._loop
        real = loop.run_pack

        def recording(pack):
            packs.append(len(pack))
            return real(pack)

        loop.run_pack = recording

    watch_loop(srv_mod._current_server)
    baseline = _scrape(client.request(port, "/metrics")[2].decode())
    shed0 = {r: metrics.REQUESTS_SHED.value(reason=r) for r in ("queue_full", "deadline", "draining")}
    dropped0, fallbacks0 = metrics.REQUESTS_DROPPED.value(), metrics.LOOP_FALLBACKS.value()
    stale0 = metrics.SNAPSHOT_STALE.value()
    dp.launches = 0
    launch_mark = [0]

    def leg(name, t0, extra=""):
        lat = client.lat
        wall = time.perf_counter() - t0
        sheds = {r: int(metrics.REQUESTS_SHED.value(reason=r) - shed0[r]) for r in shed0}
        n_launch = dp.launches - launch_mark[0]
        launch_mark[0] = dp.launches
        print(f"serve[{name}] wall {wall:.3f} s, {len(lat)} requests, p50 "
              f"{_pct(lat, 0.5) * 1e3:.0f} ms, p99 {_pct(lat, 0.99) * 1e3:.0f} ms, "
              f"{len(lat) / wall:.2f} req/s, packs {list(packs)}, sheds so far {sheds}, "
              f"sync ms {[round(v * 1e3, 1) for v in syncs]}, domain_pop launches {n_launch}"
              + (f"; {extra}" if extra else ""), flush=True)
        results[name] = {"wall_s": wall, "latency_s": list(lat), "packs": list(packs),
                         "sync_s": list(syncs), "launches": n_launch, "sheds": sheds}
        client.lat.clear()
        packs.clear()
        syncs.clear()

    def digest_of(resp):
        return sc.response_digest(json.loads(resp[2])) if resp[0] == 200 else f"HTTP {resp[0]}"

    # gate bodies simulate no pods, so they draw no workload names between a
    # reset_name_rng() and the burst they gate
    inline_gate = {"cluster": {"objects": [dict(nodes[0], kind="Node")]}, "apps": []}
    live_gate = {"apps": []}

    def gate(body):
        """Post `body` on a thread with a one-shot slow_drain of 1 s on its
        pack; returns once the loop has taken it (the fault fired)."""
        fired0 = metrics.FAULTS_INJECTED.value(target="admission", kind="slow_drain")
        faults.install_plan(faults.FaultPlan.from_dict({"rules": [
            {"target": "admission", "op": "drain", "kind": "slow_drain", "latency_s": 1.0,
             "times": 1}]}))
        out = []
        t = threading.Thread(target=lambda: out.append(
            client.request(port, "/api/deploy-apps", body)))
        t.start()
        while metrics.FAULTS_INJECTED.value(target="admission", kind="slow_drain") == fired0:
            time.sleep(0.005)
        faults.uninstall_plan()
        return t, out

    def time_syncs():
        res = srv_mod._resident
        real = res.sync

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            syncs.append(time.perf_counter() - t0)
            return out

        res.sync = timed

    try:
        # 1. lone: cold (fetch, resident creation, simulate), then again
        t0 = time.perf_counter()
        reset_name_rng()
        cold = client.request(port, "/api/deploy-apps", full)
        time_syncs()
        serve_pops = []
        undo = capture_pops(dp, torch, serve_pops)
        reset_name_rng()
        l0 = dp.launches
        warm = client.request(port, "/api/deploy-apps", full)
        warm_launches = dp.launches - l0
        undo()
        warm_s = client.lat[-1]
        census = sc.response_census(json.loads(warm[2])) if warm[0] == 200 else None
        got = [digest_of(cold), digest_of(warm)]
        leg("lone", t0, f"digests {got}")
        if got != [sc.SERVE_DIGESTS["full"]] * 2 or results["lone"]["launches"] != 2 \
                or warm_launches != 1:
            failures.append(f"serve[lone]: {got} (JAX {sc.SERVE_DIGESTS['full']}), "
                            f"launches {results['lone']['launches']}")
        resident = srv_mod._resident
        if resident is None:
            failures.append("serve[lone]: no resident state was created")

        # 2. fan-out: 4 identical full requests run as one simulate
        t0 = time.perf_counter()
        _, fsum0, fn0 = metrics.COALESCED_BATCH.child_state(mode="fanout")
        g, _ = gate(inline_gate)
        reset_name_rng()
        outs = client.burst(port, [full] * 4)
        g.join()
        _, fsum1, fn1 = metrics.COALESCED_BATCH.child_state(mode="fanout")
        same = len({o[2] for o in outs}) == 1
        leg("fan-out", t0, f"4 responses byte-identical {same}, fanout sizes observed "
            f"{int(fn1 - fn0)} summing {int(fsum1 - fsum0)}")
        if not same or digest_of(outs[0]) != sc.SERVE_DIGESTS["full"] \
                or (fn1 - fn0, fsum1 - fsum0) != (2, 5) or results["fan-out"]["launches"] != 1:
            failures.append(f"serve[fan-out]: identical {same}, digest {digest_of(outs[0])}, "
                            f"fanout observations {fn1 - fn0}/{fsum1 - fsum0}, "
                            f"launches {results['fan-out']['launches']}")

        # 3. scenario pack: 8 small bodies twice, then a lone one (warm)
        t0 = time.perf_counter()
        want = [sc.SERVE_DIGESTS[f"small/{i}"] for i in range(len(small))]
        lanes = []
        for _ in range(2):
            g, _ = gate(inline_gate)
            reset_name_rng()
            lanes.append([digest_of(o) for o in client.burst(port, small)])
            g.join()
        reset_name_rng()
        lone_small = digest_of(client.request(port, "/api/deploy-apps", small[3]))
        with srv_mod._sessions_lock:
            sessions = {k: e["session"].calls for k, e in srv_mod._sessions.items()}
        leg("scenario-pack", t0, f"session calls {list(sessions.values())}, lanes match "
            f"{[lane == want for lane in lanes]}, lone warm {lone_small == want[3]}")
        if lanes != [want, want] or lone_small != want[3] or list(sessions.values()) != [3]:
            failures.append(f"serve[scenario-pack]: lanes {lanes} (JAX {want}), lone "
                            f"{lone_small}, sessions {sessions}")

        # 4. overload: a second server at depth 2, 16 small bodies at once
        t0 = time.perf_counter()
        over = srv_mod.make_server(0, queue_depth=2, device="cuda")
        over_port = over.server_address[1]
        threading.Thread(target=over.serve_forever, daemon=True).start()
        watch_loop(over)
        # distinct replica counts: 16 coalesce keys, each served cold
        over_bodies = [sc.serve_small_body(replicas=sc.SERVE_SMALL_REPLICAS - i) for i in range(16)]
        outs = client.burst(over_port, over_bodies)
        codes = sorted(o[0] for o in outs)
        retry = [o[1].get("Retry-After") for o in outs if o[0] == 429]
        faults.install_plan(faults.FaultPlan.from_dict({"rules": [
            {"target": "admission", "op": "submit", "kind": "queue_full", "times": 1}]}))
        injected = client.request(over_port, "/api/deploy-apps", small[0])
        faults.uninstall_plan()
        over.shutdown()
        over.server_close()
        leg("overload", t0, f"codes {codes}, Retry-After {retry}, injected queue_full -> "
            f"{injected[0]} {json.loads(injected[2]).get('reason')}")
        if not set(codes) <= {200, 429} or not retry or not all(r and int(r) >= 1 for r in retry) \
                or injected[0] != 429 or json.loads(injected[2]).get("reason") != "queue_full":
            failures.append(f"serve[overload]: codes {codes}, Retry-After {retry}, "
                            f"injected {injected[0]}")

        # 5. deadline: 504, then a full request beside the abandoned worker
        t0 = time.perf_counter()
        reset_name_rng()
        late = client.request(port, "/api/deploy-apps", full,
                              headers={"X-Osim-Deadline-Ms": "1500"})
        late_s = client.lat[-1]
        abandoned = list(abandoned_workers())
        reset_name_rng()
        beside = client.request(port, "/api/deploy-apps", full)
        beside_census = sc.response_census(json.loads(beside[2])) if beside[0] == 200 else None
        t_wait = time.perf_counter()
        while abandoned_workers() and time.perf_counter() - t_wait < 300:
            time.sleep(0.1)
        leg("deadline", t0, f"{late[0]} after {late_s:.3f} s, "
            f"abandoned workers then {abandoned}, next request {beside[0]} (census "
            f"{'equal' if beside_census == census else 'DIFFERENT'}), abandoned worker "
            f"finished {time.perf_counter() - t_wait:.1f} s later")
        if late[0] != 504 or not abandoned or beside[0] != 200 or beside_census != census \
                or abandoned_workers():
            failures.append(f"serve[deadline]: {late[0]}, abandoned {abandoned}, next "
                            f"{beside[0]}, census equal {beside_census == census}")

        # 6. job: capacity_sweep's batched plan on the run journal
        t0 = time.perf_counter()
        reset_name_rng()
        sub = client.request(port, "/v1/jobs", sc.serve_job_body("capacity-sweep"))
        status = {}
        while time.perf_counter() - t0 < 600:
            status = json.loads(client.request(port, "/v1/jobs/capacity-sweep?after=-1")[2])
            if status.get("status") in ("completed", "failed", "interrupted"):
                break
            time.sleep(0.2)
        rc, listing = _cli_quiet(["runs", "list", "--root", os.environ["OSIM_RUNS_DIR"],
                                  "--format", "json"])
        listed = [r["name"] for r in json.loads(listing)] if rc == 0 else []
        leg("job", t0, f"{sub[0]}, {status.get('status')}, outcome {status.get('outcome')}, "
            f"runs list {listed}")
        if sub[0] != 202 or status.get("outcome") != sc.SERVE_JOB_OUTCOME \
                or "capacity-sweep" not in listed:
            failures.append(f"serve[job]: {sub[0]}, {status.get('status')}, "
                            f"{status.get('outcome')}, listed {listed}")

        # 7. observability
        t0 = time.perf_counter()
        profile_ms = int(warm_s * 1e3) + 4000
        prof_out = []
        pt = threading.Thread(target=lambda: prof_out.append(
            client.request(port, f"/debug/profile?ms={profile_ms}")))
        pt.start()
        time.sleep(2.5)  # the profiler's start-up
        reset_name_rng()
        traced = client.request(port, "/api/deploy-apps", full,
                                headers={"X-Osim-Deadline-Ms": "600000"})
        pt.join()
        report = json.loads(prof_out[0][2])
        kernels, pop_range, pop_kernel, events = 0, False, False, []
        if report.get("ok"):
            trace_mb = os.path.getsize(report["trace_file"]) / 2 ** 20
            with open(report["trace_file"]) as fh:
                events = json.load(fh).get("traceEvents", [])
            cats = {}
            for e in events:
                cats[str(e.get("cat"))] = cats.get(str(e.get("cat")), 0) + 1
            print(f"serve[observability] profile trace {trace_mb:.1f} MB, {len(events)} events, "
                  f"by category {sorted(cats.items(), key=lambda kv: -kv[1])[:8]}, names with "
                  f"domain_pop {sorted({(e.get('name'), e.get('cat')) for e in events if 'domain_pop' in str(e.get('name'))})[:6]}",
                  flush=True)
            kernels = sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel")
            pop_range = any(e.get("name") == "domain_pop" and str(e.get("cat", "")).lower()
                            != "kernel" for e in events)
            pop_kernel = any("domain_pop_kernel" in str(e.get("name", "")) for e in events
                             if str(e.get("cat", "")).lower() == "kernel")
        upstream = "5e" * 16
        tp = client.request(port, "/api/deploy-apps", small[3],
                            headers={"traceparent": f"00-{upstream}-00f067aa0ba902b7-01"})
        timings = client.request(port, "/debug/timings")[2].decode()
        roots = json.loads(timings)["timings"]
        continued = any(r["name"] == "http-request" and r["trace_id"] == upstream
                        and r.get("parent_id") == "00f067aa0ba902b7" for r in roots)
        serve_spans = '"stage": "serve-simulate"' in timings
        metrics_resp = client.request(port, "/metrics")
        final = _scrape(metrics_resp[2].decode())
        # the last scrape counts itself only after rendering
        tally = dict(client.tally)
        tally[("/metrics", "200")] -= 1
        http_ok = all(
            final.get(("osim_http_requests_total", f'{{path="{p}",code="{c}"}}'), 0.0)
            - baseline.get(("osim_http_requests_total", f'{{path="{p}",code="{c}"}}'), 0.0) == n
            for (p, c), n in tally.items())
        leg("observability", t0, f"profile {profile_ms} ms: ok {report.get('ok')}, "
            f"{kernels} kernel events, domain_pop range {pop_range}, domain_pop kernel "
            f"{pop_kernel}; traced request {traced[0]}; traceparent continued {continued}, "
            f"echoed {tp[1].get('X-Osim-Trace-Id') == upstream}; serve-simulate spans "
            f"{serve_spans}; /metrics {metrics_resp[1].get('Content-Type')}, "
            f"osim_http_requests_total matches {sum(tally.values())} requests {http_ok}")
        if not (report.get("ok") and kernels and pop_range and traced[0] == 200
                and digest_of(traced) == sc.SERVE_DIGESTS["full"] and continued
                and tp[1].get("X-Osim-Trace-Id") == upstream and serve_spans and http_ok
                and metrics_resp[1].get("Content-Type")
                == "text/plain; version=0.0.4; charset=utf-8"):
            failures.append(f"serve[observability]: profile {report}, kernels {kernels}, "
                            f"range {pop_range}, traced {traced[0]}, continued {continued}, "
                            f"spans {serve_spans}, http counts {http_ok}")

        # 8. soak: the cold path (a whole simulate() per request,
        # OSIM_SERVER_LOOP=0), 30 small requests after 5 warm ones; then the
        # default path, 3 packs of the 8 small bodies on the warm session
        # after one more (the first pack after the cold requests grew the
        # host's RSS by ~70 MB once)
        t0 = time.perf_counter()

        def rss_mb():
            with open("/proc/self/status") as fh:
                for line in fh:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) / 1024.0
            return 0.0

        def session_calls():
            with srv_mod._sessions_lock:
                return {k: (id(e["session"]), e["session"].calls)
                        for k, e in srv_mod._sessions.items()}

        os.environ["OSIM_SERVER_LOOP"] = "0"
        soak = []
        for i in range(35):
            reset_name_rng()
            soak.append(digest_of(client.request(port, "/api/deploy-apps", small[3])))
            if i == 4:
                torch.cuda.synchronize()
                mem0, rss0 = torch.cuda.memory_allocated(), rss_mb()
        torch.cuda.synchronize()
        os.environ.pop("OSIM_SERVER_LOOP", None)
        cold_mem = (torch.cuda.memory_allocated() - mem0) / 2 ** 20
        cold_rss = rss_mb() - rss0
        cold_lat = list(client.lat)
        warm_lanes, calls = [], [session_calls()]
        for i in range(4):
            g, _ = gate(inline_gate)
            reset_name_rng()
            warm_lanes.append([digest_of(o) for o in client.burst(port, small)])
            g.join()
            if i == 0:
                torch.cuda.synchronize()
                mem0, rss0 = torch.cuda.memory_allocated(), rss_mb()
        torch.cuda.synchronize()
        calls.append(session_calls())
        warm_mem = (torch.cuda.memory_allocated() - mem0) / 2 ** 20
        warm_rss = rss_mb() - rss0
        warm_lat = client.lat[len(cold_lat):]
        reused = (len(calls[0]) == 1 and calls[0].keys() == calls[1].keys()
                  and all(calls[1][k] == (calls[0][k][0], calls[0][k][1] + 4) for k in calls[0]))
        leg("soak", t0, f"cold path: p50 {_pct(cold_lat, 0.5) * 1e3:.0f} ms, p99 "
            f"{_pct(cold_lat, 0.99) * 1e3:.0f} ms, device memory {cold_mem:+.1f} MB, RSS "
            f"{cold_rss:+.1f} MB after the 5 warm-up requests, all {len(soak)} responses "
            f"the JAX lane {soak == [sc.SERVE_DIGESTS['small/3']] * 35}; warm sessions: "
            f"request p50 {_pct(warm_lat, 0.5) * 1e3:.0f} ms, p99 "
            f"{_pct(warm_lat, 0.99) * 1e3:.0f} ms, device memory {warm_mem:+.1f} MB, RSS "
            f"{warm_rss:+.1f} MB after the first pack, session reused {reused} ({calls}), "
            f"lanes match {[lane == want for lane in warm_lanes]}")
        results["soak"].update(cold_latency_s=cold_lat, warm_latency_s=warm_lat,
                               cold_mem_mb=cold_mem, cold_rss_mb=cold_rss,
                               warm_mem_mb=warm_mem, warm_rss_mb=warm_rss)
        if abs(cold_mem) > 64 or cold_rss >= 120 or soak != [sc.SERVE_DIGESTS["small/3"]] * 35 \
                or abs(warm_mem) > 64 or warm_rss >= 120 or warm_lanes != [want] * 4 \
                or not reused:
            failures.append(f"serve[soak]: cold device memory {cold_mem:+.1f} MB, RSS "
                            f"{cold_rss:+.1f} MB, digests {set(soak)}; warm device memory "
                            f"{warm_mem:+.1f} MB, RSS {warm_rss:+.1f} MB, lanes {warm_lanes}, "
                            f"sessions {calls}")
        # 9. resync and fence: the stub moves, the refresh is a delta sync
        t0 = time.perf_counter()
        moved, pods = list(nodes), []
        for changed, pods in sc.resident_rounds(nodes):
            for i, d in changed.items():
                if i < len(moved):
                    moved[i] = d
                else:
                    moved.append(d)
        api.apis = sc.live_apis(moved, pods)
        srv_mod._resync_s = 0.0
        deltas0 = sum(metrics.RESIDENT_DELTAS.value(kind=k)
                      for k in ("node_row", "node_added", "pod_usage"))
        fall0 = metrics.RESIDENT_FALLBACKS.snapshot()
        repairs0 = metrics.RESIDENT_DRIFT_REPAIRS.snapshot()
        rekeyed0 = metrics.ADMISSION_FENCE.value(outcome="rekeyed")
        epoch0 = resident.epoch if resident is not None else None
        g, gate_out = gate(live_gate)  # its pack refreshes the snapshot
        reset_name_rng()
        moved_resp = client.request(port, "/api/deploy-apps", full)
        g.join()
        srv_mod._resync_s = 3600.0
        deltas = sum(metrics.RESIDENT_DELTAS.value(kind=k)
                     for k in ("node_row", "node_added", "pod_usage")) - deltas0
        rekeyed = metrics.ADMISSION_FENCE.value(outcome="rekeyed") - rekeyed0
        no_fallback = metrics.RESIDENT_FALLBACKS.snapshot() == fall0
        no_repair = metrics.RESIDENT_DRIFT_REPAIRS.snapshot() == repairs0
        got = digest_of(moved_resp)
        leg("resync", t0, f"{len(moved)} nodes, {len(pods)} bound pods; {int(deltas)} delta "
            f"rows, no fallback {no_fallback}, no repair {no_repair}, epoch {epoch0} -> "
            f"{resident.epoch if resident is not None else None}, fence re-keyed {int(rekeyed)}; "
            f"digest {got} (JAX {sc.SERVE_DIGESTS['resync']})")
        if got != sc.SERVE_DIGESTS["resync"] or not deltas or not no_fallback or not no_repair \
                or rekeyed < 1 or gate_out[0][0] != 200 or results["resync"]["launches"] != 1:
            failures.append(f"serve[resync]: digest {got}, deltas {deltas}, no fallback "
                            f"{no_fallback}, no repair {no_repair}, re-keyed {rekeyed}, gate "
                            f"{gate_out[0][0]}, launches {results['resync']['launches']}")
    finally:
        faults.uninstall_plan()
        if srv_mod._current_server is not None:
            srv_mod._current_server.shutdown()
        server_thread.join(60)
        api.close()
        osim_log.removeHandler(handler)
        osim_log.setLevel(logging.ERROR)
        for h, level in quiet.items():
            h.setLevel(level)

    # 10. the CLI: `server` in a subprocess, one inline request, SIGTERM
    t0 = time.perf_counter()
    cli_port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "open_simulator_tpu_torch.cli", "server", "--port", str(cli_port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        health = None
        while health is None and time.perf_counter() - t0 < 180 and proc.poll() is None:
            try:
                health = client.request(cli_port, "/healthz", timeout=5)
            except OSError:
                time.sleep(0.25)
        up_s = time.perf_counter() - t0
        inline = (client.request(cli_port, "/api/deploy-apps", sc.serve_inline_body())
                  if health is not None else (0, {}, b""))
        # the first /debug/profile primes the profiler on the server's main
        # thread; inline requests keep the card busy while it captures
        prof, prof_kernels, prof_s = [], 0, 0.0
        if health is not None:
            t_prof = time.perf_counter()
            pt = threading.Thread(target=lambda: prof.append(
                client.request(cli_port, "/debug/profile?ms=1000", timeout=300)))
            pt.start()
            while pt.is_alive():
                client.request(cli_port, "/api/deploy-apps", sc.serve_inline_body())
                time.sleep(0.2)
            pt.join()
            prof_s = time.perf_counter() - t_prof
            cli_report = json.loads(prof[0][2]) if prof else {}
            if cli_report.get("ok"):
                with open(cli_report["trace_file"]) as fh:
                    prof_kernels = sum(1 for e in json.load(fh).get("traceEvents", [])
                                       if str(e.get("cat", "")).lower() == "kernel")
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    got = digest_of(inline)
    leg("cli", t0, f"up in {up_s:.1f} s, /healthz {health and health[0]}, inline {got} (JAX "
        f"{sc.SERVE_DIGESTS['inline']}), first /debug/profile?ms=1000 {prof_s:.3f} s with "
        f"{prof_kernels} kernel events, SIGTERM exit {proc.returncode}")
    results["cli"].update(up_s=up_s, first_profile_s=prof_s)
    if not health or health[0] != 200 or got != sc.SERVE_DIGESTS["inline"] or proc.returncode \
            or not prof_kernels:
        failures.append(f"serve[cli]: health {health and health[0]}, inline {got}, profile "
                        f"kernels {prof_kernels}, exit {proc.returncode}: {out[-2000:]}")

    dropped = metrics.REQUESTS_DROPPED.value() - dropped0
    fallbacks = metrics.LOOP_FALLBACKS.value() - fallbacks0
    stale = metrics.SNAPSHOT_STALE.value() - stale0
    wall = time.perf_counter() - t_phase
    print(f"serve phase: {wall:.1f} s; dropped {int(dropped)}, loop fallbacks "
          f"{int(fallbacks)}, stale snapshots {int(stale)}, degradations logged {degraded}, "
          f"domain_pop launches {dp.launches}, peak host RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f} MB", flush=True)
    results["wall_s"] = wall
    if dropped or fallbacks or stale or degraded:
        failures.append(f"serve: dropped {dropped}, loop fallbacks {fallbacks}, stale {stale}, "
                        f"degradations {degraded}")
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    shutil.rmtree(tmp, ignore_errors=True)
    return results, failures, dp.launches, (serve_pops[0] if serve_pops else None)


def start_phase_child(phase, tmp):
    """Start `chip_smoke.py --phase <phase>` in a child process; its output
    goes to a file in `tmp`. Returns (process, results path, log path)."""
    import os

    out, log = os.path.join(tmp, f"{phase}.json"), os.path.join(tmp, f"{phase}.log")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase", phase, "--out", out],
            stdout=fh, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, out, log


def join_phase_child(child, timeout_s):
    """Wait for a phase child, print its output here and return its
    (results, failures, domain_pop launches)."""
    proc, out, log = child
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(log) as fh:
        sys.stdout.write(fh.read())
    sys.stdout.flush()
    if proc.returncode != 0:
        return {}, [f"the phase's child process exited {proc.returncode}"], 0
    with open(out) as fh:
        got = json.load(fh)
    return got["results"], got["failures"], got["launches"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument("--phase", choices=("prove",),
                    help="run only this phase and write its results, failures and "
                         "domain_pop launches as JSON to --out")
    opts = ap.parse_args()

    import logging

    import torch

    # the simulator's root spans log their trees when slower than 1 s; this
    # script prints its own split
    logging.getLogger("osim").setLevel(logging.ERROR)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if opts.phase == "prove":
        from open_simulator_tpu_torch.ops import domain_pop as dp

        results, failures, launches = prove_phase(torch, dp)
        with open(opts.out, "w") as f:
            json.dump({"results": results, "failures": failures, "launches": launches}, f,
                      default=str)
        return 0
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-smoke-")
    children = []
    try:
        return run_all(opts, torch, tmp, children)
    finally:
        for proc, _, _ in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def run_all(opts, torch, tmp, children) -> int:
    """Every phase in order (the prove phase in a child process, started
    before the capacity phase and joined in its place); 0 when all pass."""
    from open_simulator_tpu_torch.headline import (
        HEADLINE_DIGEST_100K_10K, build_state, placement_digest,
    )
    from open_simulator_tpu_torch.ops import domain_pop as dp
    from open_simulator_tpu_torch.ops import fast, kernels
    from open_simulator_tpu_torch.ops.kernels import weights_array
    from open_simulator_tpu_torch.tools import pop_chain

    card = smi("name,power.limit")
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    dp.build_libraries(dp.SOURCE, pop_chain.SOURCE)  # one nvcc per source, together
    dp._library()
    pop_chain._library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s", flush=True)
    for line in dp.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  nvcc: {line.strip()}", flush=True)

    # -- main path at full size ------------------------------------------
    n_nodes, n_pods = 10_000, 100_000
    t0 = time.perf_counter()
    ns, carry, batch = build_state(n_nodes, n_pods, device="cuda")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    w = weights_array(device="cuda")

    captured = []
    undo = capture_pops(dp, torch, captured)
    warm_phases: dict = {}
    t0 = time.perf_counter()
    fast.schedule_batch_fast(ns, carry, batch, w, device="cuda", timings=warm_phases)
    warm_s = time.perf_counter() - t0
    undo()

    for k in fast.PATH_COUNTS:
        fast.PATH_COUNTS[k] = 0
    dp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fast.schedule_batch_fast(ns, carry, batch, w, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    paths = dict(fast.PATH_COUNTS)
    launches = dp.launches
    # the phase split comes from a third pass: timings= syncs the card at
    # every phase end, which the timed pass must not pay for
    phases: dict = {}
    t0 = time.perf_counter()
    fast.schedule_batch_fast(ns, carry, batch, w, device="cuda", timings=phases)
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t0

    carry_out, nodes = result[0], result[1]
    scheduled = int((nodes[:n_pods] >= 0).sum())
    digest = placement_digest(*result)
    finite = all(bool(torch.isfinite(getattr(carry_out, f)).all()) for f in carry_out._fields)
    print(f"headline {n_pods} pods x {n_nodes} nodes: encode {encode_s:.2f} s, "
          f"warm pass {warm_s:.2f} s, timed pass {run_s:.3f} s, "
          f"{n_pods / run_s:.1f} pods/s, scheduled {scheduled}", flush=True)
    print(f"phase pass (synced at phase ends) {phase_s:.3f} s", flush=True)
    for name, ph in (("warm", warm_phases), ("phase", phases)):
        print(f"{name}-pass phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ph.items()), flush=True)
    print(f"paths {paths} domain_pop launches {launches}", flush=True)
    print(f"digest {digest}", flush=True)
    failures = []
    if scheduled != n_pods:
        failures.append(f"scheduled {scheduled} of {n_pods} pods")
    if not (paths["sort"] > 0 and paths["domain"] > 0):
        failures.append(f"expected sort and domain groups, got {paths}")
    if not paths["domain_kernel"] == paths["domain"] == launches:
        failures.append(f"domain groups {paths['domain']} but kernel launches {launches}")
    if digest != HEADLINE_DIGEST_100K_10K:
        failures.append(f"digest {digest} != reference {HEADLINE_DIGEST_100K_10K}")
    if not finite:
        failures.append("non-finite carry leaf")
    if not captured:
        failures.append("the main path made no domain_pop call")
    if failures:
        print("chip_smoke: main path FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    del ns, carry, batch, result, carry_out

    # -- every other route: the bench_configs workloads -------------------
    route_captures: dict = {}
    routes, failures = routes_phase(torch, dp, fast, kernels, w, route_captures)
    if failures:
        print("chip_smoke: routes FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches += sum(r["launches"] for r in routes.values())

    # -- the simulator engine and simon apply -------------------------------
    sim_results, failures, sim_launches, sim_pops = simulator_phase(torch, dp, fast)
    if failures:
        print("chip_smoke: simulator FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches += sim_launches

    # -- simon prove starts in a child process: its host oracle runs beside
    # the capacity phase
    children.append(start_phase_child("prove", tmp))

    # -- the capacity search, the scenario axis and the wave engine --------
    cap_results, failures, cap_launches = capacity_phase(torch, dp, fast)
    if failures:
        print("chip_smoke: capacity FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches += cap_launches

    # -- simon prove: universe engines, oracle, commit-order contract ------
    prove_results, failures, prove_launches = join_phase_child(children[0], 420)
    if failures:
        print("chip_smoke: prove FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches += prove_launches

    # -- scheduler extenders, retries and kubeConfig snapshots -------------
    ext_results, failures, ext_launches = extender_phase(torch, dp)
    if failures:
        print("chip_smoke: extenders FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches += ext_launches

    # -- durable runs: chunk checkpoints, device loss, process kills -------
    durable_results, failures, durable_launches = durable_phase(torch, dp, fast)
    if failures:
        print("chip_smoke: durable FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches += durable_launches

    # -- resident cluster state with row-delta sync -------------------------
    resident_results, failures, resident_launches = resident_phase(torch, dp, fast)
    if failures:
        print("chip_smoke: resident FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches += resident_launches

    # -- serving: simon server with admission control and the batching loop --
    serve_results, failures, serve_launches, serve_pops = serve_phase(torch, dp, fast)
    if serve_pops is None:
        failures.append("serve: no served request made a domain_pop call")
    if failures:
        print("chip_smoke: serve FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    launches += serve_launches

    # -- kernels vs plain versions on the card -----------------------------
    main_args = captured[0]
    ms, plain_ms, err, placed = check_pop("main-path", main_args, dp, torch, reps=5)
    errs = [err]
    errs.append(check_pop("spread_affinity-hard", route_captures["spread_affinity"], dp,
                          torch, reps=5, plain_on="cpu")[2])
    errs.append(check_pop("simulator-plan", sim_pops, dp, torch, reps=3, plain_on="cpu")[2])
    errs.append(check_pop("served-request", serve_pops, dp, torch, reps=3, plain_on="cpu")[2])
    # name: (seed, Dc, L, D, G, hard, cap)
    for name, (seed, dc, lanes, d, g, hard, cap) in {
        "headline-hard": (7, 4, 26624, 4, 26624, True, None),
        "dc64-ties-exhausted": (12, 64, 4096, 4, 26624, False, None),
        "dc33-hard": (33, 33, 512, 4, 4096, True, None),
        "dc1": (1, 1, 4096, 4, 4096, False, None),
        "lanes1": (5, 8, 1, 4, 200, True, None),
        "g-odd": (9, 4, 5001, 4, 5001, False, None),
        "all-exhausted": (21, 8, 512, 4, 3000, False, 256),
    }.items():
        arrays, scalars = pop_inputs(seed, dc, lanes, 2, d, g, hard, cap=cap)
        errs.append(check_pop(name, to_card(arrays, scalars, torch), dp, torch, reps=3,
                              plain_on="cpu")[2])
    bound_ms, bound_by = pop_bound(main_args, placed)
    n_div, d_div = divide_domain(torch)
    differ = dp.check_divide(n_div, d_div)
    print(f"split divide vs __fdiv_rn: {n_div.numel()} operand pairs, {differ} differ",
          flush=True)
    if differ:
        raise SystemExit(f"domain_pop: the split divide differs from __fdiv_rn on {differ} pairs")

    # -- the measured chain floor -------------------------------------------
    g_main = main_args[-3]
    pop_chain.run(1000)  # warm
    cycles, ns, sm_mhz = pop_chain.run(
        PROBE_POPS, during=lambda: float(smi("clocks.sm", "csv,noheader,nounits"))
    )
    probe_cycles = cycles / PROBE_POPS
    latency_ms = g_main * probe_cycles / (sm_mhz * 1e3)
    kernel_cycles = ms * 1e-3 * sm_mhz * 1e6 / g_main
    print(f"pop chain probe: {probe_cycles:.1f} cycles/pop over {PROBE_POPS} pops, "
          f"SM clock {sm_mhz:.0f} MHz (nvidia-smi during the probe), "
          f"{cycles / ns * 1e3:.0f} MHz (clock64/globaltimer)", flush=True)
    print(f"domain_pop main path: {kernel_cycles:.1f} cycles/pop (kernel) vs "
          f"{probe_cycles:.1f} cycles/pop (probe); latency bound {g_main} pops x "
          f"{probe_cycles:.1f} cycles at {sm_mhz:.0f} MHz = {latency_ms:.3f} ms", flush=True)
    kernel_rows = [{
        "name": "domain_pop",
        "route": "cuda",
        "source": "open_simulator_tpu_torch/csrc/domain_pop.cu",
        "replaces": "open_simulator_tpu/ops/fast.py:1281",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "latency_bound_ms": latency_ms,
    }]
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({
                "card": card, "torch": torch.__version__, "build_s": build_s,
                "encode_s": encode_s, "warm_s": warm_s, "run_s": run_s,
                "pods_per_s": n_pods / run_s, "warm_phases": warm_phases,
                "phase_s": phase_s, "phases": phases, "probe_cycles_per_pop": probe_cycles,
                "kernel_cycles_per_pop": kernel_cycles, "sm_mhz": sm_mhz,
                "paths": paths, "digest": digest, "routes": routes, "simulator": sim_results,
                "capacity": cap_results, "prove": prove_results, "extenders": ext_results,
                "durable": durable_results, "resident": resident_results,
                "serve": serve_results,
                "kernels": kernel_rows,
            }, f, indent=1, default=str)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
