"""Where a simulate() call's time goes on the card, span by span.

    python3 -m open_simulator_tpu_torch.tools.sim_profile [--out results.json]

For `sim_configs.plan` (100,000 pods x 10,000 nodes) and `sim_configs.preempt`:
a warm simulate() on the card, one unprofiled (its wall and its tracing
spans), then one under torch.profiler with a record_function range for every
tracing span of the engine (expand-workloads, encode-cluster, encode,
schedule, bind, preempt, probe, decode-result). Per span name it prints the
host seconds (unprofiled), the kernels launched and their summed device
time; per call, the card's busy share (kernel time over the profiled wall;
the profiler slows the host, so the unprofiled share is lower still). The
domain_pop kernel is launched through ctypes, outside PyTorch's dispatcher,
and is not in the profiler's kernel list (chip_smoke.py times it: ~12 ms
for plan's 50,000 pops).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time

import torch
from torch.autograd import DeviceType

from .. import sim_configs
from ..core.workloads import reset_name_rng
from ..engine import preemption, simulator
from ..ops import domain_pop
from ..utils import tracing
from .route_profile import _kernels_below

SPANS = ("expand-workloads", "encode-cluster", "encode", "schedule", "bind", "preempt", "probe",
         "decode-result")


@contextlib.contextmanager
def _ranged_span(name, **meta):
    with torch.profiler.record_function(f"span.{name}"), tracing.span(name, **meta) as s:
        yield s


def _run(build):
    reset_name_rng()
    cluster, apps = build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulator.simulate(cluster, apps, device="cuda")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_config(name, build) -> dict:
    _run(build)
    wall = _run(build)
    host = tracing.span_seconds(tracing.recent_timings()[-1])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    simulator.span = preemption.span = _ranged_span
    try:
        with torch.profiler.profile(activities=acts) as prof:
            prof_wall = _run(build)
    finally:
        simulator.span = preemption.span = tracing.span
    spans, kernel_us = {}, 0.0
    for evt in (e for e in prof.events() if e.device_type == DeviceType.CPU):
        if evt.name.startswith("span."):
            n, us = _kernels_below(evt)
            s = spans.setdefault(evt.name[5:], {"kernels": 0, "device_s": 0.0})
            s["kernels"] += n
            s["device_s"] += us * 1e-6
        kernel_us += sum(k.duration for k in evt.kernels)
    busy = kernel_us * 1e-6 / prof_wall
    print(f"[{name}] wall {wall:.3f} s unprofiled; profiled {prof_wall:.3f} s with "
          f"{kernel_us * 1e-6:.3f} s of kernels: card busy {busy:.1%} of the profiled call",
          flush=True)
    rows = {}
    for span in SPANS:
        if span not in host:
            continue
        s = spans.get(span, {"kernels": 0, "device_s": 0.0})
        rows[span] = dict(s, host_s=host[span])
        print(f"[{name}] {span}: host {host[span]:.3f} s, {s['kernels']} kernels, "
              f"device {s['device_s'] * 1e3:.1f} ms", flush=True)
    return {"wall_s": wall, "profiled_wall_s": prof_wall, "kernel_s": kernel_us * 1e-6,
            "busy": busy, "spans": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON to this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sim_profile: torch.cuda.is_available() is False")
    logging.getLogger("osim").setLevel(logging.ERROR)   # slow-trace trees
    domain_pop.build_libraries(domain_pop.SOURCE)
    domain_pop._library()
    out = {name: profile_config(name, build)
           for name, build in (("plan", sim_configs.plan), ("preempt", sim_configs.preempt))}
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "results": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
