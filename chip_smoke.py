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
5. Holds every kernel against its plain PyTorch version on the card, on the
   inputs the main path gave it, on those of spread_affinity's DoNotSchedule
   group and of the simulator's plan call, and on extra seeded variants, and prints their times; holds the pop
   loop's split divide against __fdiv_rn on the spread's operands (67 M
   pairs).
6. Times the pop chain probe (csrc/pop_chain_probe.cu) with clock64() while
   nvidia-smi reads the SM clock, and prints the latency bound of the main
   path's pop loop beside the kernel's own cycles per pop.
7. Prints one JSON line of per-kernel numbers (launches summed over the
   headline's and the workloads' timed passes, the timed plan call, the warm
   preempt call and the apply runs) and, last, the result line.

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


def check_pop(name, args, dp, torch, reps):
    """Kernel vs plain version on the same card tensors: bit-equal outputs.
    Returns (kernel ms, plain ms, max abs error, pods placed)."""
    nodes_k, jidx_k = dp.domain_pop(*args)
    torch.cuda.synchronize()
    ms = event_ms(lambda: dp.domain_pop(*args), torch, reps)
    t0 = time.perf_counter()
    nodes_p, jidx_p = dp.domain_pop_reference(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(
        (nodes_k - nodes_p).abs().max().item(), (jidx_k - jidx_p).abs().max().item()
    )
    if not (torch.equal(nodes_k, nodes_p) and torch.equal(jidx_k, jidx_p)):
        raise SystemExit(f"domain_pop[{name}]: kernel and plain version disagree (max err {err})")
    placed = int((nodes_k >= 0).sum())
    print(f"domain_pop[{name}] bit-equal to plain: pops={args[-3]} placed={placed} "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON to this file")
    opts = ap.parse_args()

    import logging

    import torch

    # the simulator's root spans log their trees when slower than 1 s; this
    # script prints its own split
    logging.getLogger("osim").setLevel(logging.ERROR)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
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

    # -- kernels vs plain versions on the card -----------------------------
    main_args = captured[0]
    ms, plain_ms, err, placed = check_pop("main-path", main_args, dp, torch, reps=5)
    errs = [err]
    errs.append(check_pop(
        "spread_affinity-hard", route_captures["spread_affinity"], dp, torch, reps=5)[2])
    errs.append(check_pop("simulator-plan", sim_pops, dp, torch, reps=3)[2])
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
        errs.append(check_pop(name, to_card(arrays, scalars, torch), dp, torch, reps=3)[2])
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
                "kernels": kernel_rows,
            }, f, indent=1)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
