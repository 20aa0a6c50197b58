"""Where each scan body's time goes on the card: host dispatch or device work.

    python3 -m open_simulator_tpu_torch.tools.route_profile [--out results.json]

For the headline (10,000 nodes, 100,000 pods) and each bench_configs workload:
one warm pass of `schedule_batch_fast`; one pass with `timings=` (steps and
select seconds per route, the device synced at phase ends); and one pass
under torch.profiler with a record_function range around each call of a
scan body (`grouped.schedule_group`, `fast.light_scan` named scan or micro by
the group's flags, `fast._affinity_pop`). Per body it prints the steps, the
kernels launched per step, the device (kernel) time per step, the host time
per step under the profiler, and the unprofiled wall per step; the device
busy share of a body is its device time over its unprofiled wall. Per pass
it prints the device busy share of the whole profiled pass (kernel time
over the pass's wall under the profiler, an upper bound on the idle share's
complement since the profiler slows the host). The domain_pop kernel is
launched through ctypes, outside PyTorch's dispatcher, so the profiler does
not tie it to a range; `chip_smoke.py` times it with CUDA events.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch
from torch.autograd import DeviceType

from .. import bench_configs, headline
from ..ops import fast, grouped
from ..ops.kernels import weights_array


def _ranged(fn, name_of):
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with torch.profiler.record_function(f"body.{name_of(args, kw)}"):
            return fn(*args, **kw)
    return wrapper


def _scan_name(args, kw):
    flags = args[13] if len(args) > 13 else kw.get("flags", fast.ALL_DYNAMIC)
    return "micro" if flags.micro_spread else "scan"


def _kernels_below(evt) -> tuple:
    """(kernels launched, their summed device time in us) under a CPU event.
    A range's own device_time_total spans its first to its last kernel, gaps
    included, so busy time is summed from the kernels themselves."""
    n, us = len(evt.kernels), sum(k.duration for k in evt.kernels)
    for c in evt.cpu_children:
        cn, cus = _kernels_below(c)
        n, us = n + cn, us + cus
    return n, us


def profile_pass(ns, carry, batch, w):
    """(per-body {calls, kernels, device_s, host_s}, pass wall s, pass
    kernel s) of one profiled pass."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fast.schedule_batch_fast(ns, carry, batch, w, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    bodies, kernel_us = {}, 0.0
    # a range also appears as a device-side annotation event: count the CPU one
    for evt in (e for e in prof.events() if e.device_type == DeviceType.CPU):
        if evt.name.startswith("body."):
            b = bodies.setdefault(evt.name[5:], {"calls": 0, "kernels": 0, "device_s": 0.0, "host_s": 0.0})
            n, us = _kernels_below(evt)
            b["calls"] += 1
            b["kernels"] += n
            b["device_s"] += us * 1e-6
            b["host_s"] += evt.cpu_time_total * 1e-6
        kernel_us += sum(k.duration for k in evt.kernels)
    return bodies, wall, kernel_us * 1e-6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON to this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("route_profile: torch.cuda.is_available() is False")
    grouped.schedule_group = _ranged(grouped.schedule_group, lambda a, k: "grouped")
    fast.light_scan = _ranged(fast.light_scan, _scan_name)
    fast._affinity_pop = _ranged(fast._affinity_pop, lambda a, k: "affinity_pop")
    w = weights_array(device="cuda")
    workloads = [("headline", lambda: headline.build_state(10_000, 100_000, device="cuda"))] + [
        (name, functools.partial(bench_configs.build_state, name, device="cuda"))
        for name in bench_configs.WORKLOADS
    ]
    out = {}
    for name, build in workloads:
        ns, carry, batch = build()
        fast.schedule_batch_fast(ns, carry, batch, w, device="cuda")
        timings: dict = {}
        t0 = time.perf_counter()
        fast.schedule_batch_fast(ns, carry, batch, w, device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        bodies, prof_wall, prof_kernel_s = profile_pass(ns, carry, batch, w)
        route_of = {"grouped": "grouped", "scan": "scan", "micro": "micro",
                    "affinity_pop": "domain_affinity"}
        print(f"[{name}] pass {wall:.3f} s (synced at phase ends); profiled pass {prof_wall:.3f} s "
              f"with {prof_kernel_s:.3f} s of kernels: device busy {prof_kernel_s / prof_wall:.1%}",
              flush=True)
        for body, b in sorted(bodies.items()):
            steps = timings.get(f"steps.{route_of.get(body, '')}", 0)
            row = dict(b, steps=steps)
            if steps:
                sel = timings[f"select.{route_of[body]}"]
                row.update(
                    kernels_per_step=b["kernels"] / steps,
                    device_us_per_step=b["device_s"] / steps * 1e6,
                    host_us_per_step_profiled=b["host_s"] / steps * 1e6,
                    wall_us_per_step=sel / steps * 1e6,
                    device_busy=b["device_s"] / sel,
                )
                print(f"[{name}] {body}: {b['calls']} calls, {steps} steps, "
                      f"{row['kernels_per_step']:.1f} kernels/step, "
                      f"device {row['device_us_per_step']:.1f} us/step, host (profiled) "
                      f"{row['host_us_per_step_profiled']:.1f} us/step, wall "
                      f"{row['wall_us_per_step']:.1f} us/step, device busy {row['device_busy']:.1%}",
                      flush=True)
            else:
                print(f"[{name}] {body}: {b['calls']} calls, {b['kernels']} kernels, "
                      f"device {b['device_s'] * 1e3:.3f} ms, host (profiled) "
                      f"{b['host_s'] * 1e3:.3f} ms", flush=True)
            out.setdefault(name, {})[body] = row
        out.setdefault(name, {})["_pass"] = {
            "wall_s": wall, "profiled_wall_s": prof_wall, "kernel_s": prof_kernel_s,
            "timings": timings,
        }
        del ns, carry, batch
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "results": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
