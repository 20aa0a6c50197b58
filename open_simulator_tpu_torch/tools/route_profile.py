"""Where each route's time goes on the card, read from the schedule
engine's spans.

    python3 -m open_simulator_tpu_torch.tools.route_profile [--out results.json]

For the headline (10,000 nodes, 100,000 pods) and each bench_configs workload:
one warm pass of `schedule_batch_fast`; one pass inside a root span, whose
`group` spans give the groups and steps per route (their meta) and whose
`select.<route>` spans give the select seconds per route; and one pass
under torch.profiler (CUDA activity), inside a root span as well. A fill
launched right after reading the host clock ties the capture's clock to the
spans', so each kernel is charged to the `group` span, and to the
`select.<route>` span, whose window holds its start: per route the kernels
and device time of its groups (every group ends in one fetch, so its device
work lies inside its span) and of its select phases. The select phase's
device busy share is that device time over its profiled select seconds.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from .. import bench_configs, headline
from ..ops import fast
from ..ops.kernels import weights_array
from ..utils import tracing


def route_split(root: dict) -> dict:
    """Per route, from one schedule_batch_fast call's span tree: {groups,
    steps, select_s}, and for the light scans `dyn` ({"gpu": 12}: selects
    per combination of GPU, storage and port dynamics, "none" for none)
    and, on `scan`, `kernel` (the light_scan kernel's launches in its
    selects); on every route that builds a trajectory, `traj_kernel` (the
    trajectory kernel's launches, the `trajectory` spans' `kernel` meta).
    Steps and groups come from the `group` spans' meta (route that
    committed), select seconds from the `select.<route>` spans, a replayed
    verdict's select included under its own route."""
    out: dict = {}

    def row(route):
        return out.setdefault(route, {"groups": 0, "steps": 0, "select_s": 0.0})

    def walk(node):
        for c in node.get("children", ()):
            if c["name"] == "group":
                r = row(c["meta"]["route"])
                r["groups"] += 1
                r["steps"] += c["meta"]["steps"]
                for t in c.get("children", ()):
                    if t["name"] == "trajectory" and "kernel" in t.get("meta", {}):
                        r["traj_kernel"] = r.get("traj_kernel", 0) + t["meta"]["kernel"]
            elif c["name"].startswith("select."):
                r = row(c["name"][len("select."):])
                r["select_s"] += c["duration_s"]
                if "dyn" in c.get("meta", {}):
                    # a light scan's carry dynamics: selects per combination
                    key = "+".join(c["meta"]["dyn"]) or "none"
                    dyn = r.setdefault("dyn", {})
                    dyn[key] = dyn.get(key, 0) + 1
                if "kernel" in c.get("meta", {}):
                    r["kernel"] = r.get("kernel", 0) + c["meta"]["kernel"]
            walk(c)

    walk(root)
    return out


def spans_pass(ns, carry, batch, w) -> tuple:
    """(route_split of one pass, its wall s, its root span tree)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing.span("route-profile"):
        fast.schedule_batch_fast(ns, carry, batch, w, device="cuda")
    wall = time.perf_counter() - t0
    root = tracing.recent_timings()[-1]
    return route_split(root), wall, root


def _windows(root: dict, offset_ns: int) -> tuple:
    """([(route, lo, hi)] of the group spans, [(route, lo, hi)] of the
    select spans), on the device clock in ns."""
    groups, selects = [], []

    def walk(node):
        for c in node.get("children", ()):
            lo = int(round(c["start"] * 1e9)) + offset_ns
            hi = int(round((c["start"] + c["duration_s"]) * 1e9)) + offset_ns
            if c["name"] == "group":
                groups.append((c["meta"]["route"], lo, hi))
            elif c["name"].startswith("select."):
                selects.append((c["name"][len("select."):], lo, hi))
            walk(c)

    walk(root)
    return groups, selects


def _charge(kernels, windows) -> dict:
    """Per route: (kernels, device s) of the kernels whose start lies in one
    of its windows."""
    by = defaultdict(lambda: [0, 0.0])
    for _, start, dur in kernels:
        for route, lo, hi in windows:
            if lo <= start < hi:
                by[route][0] += 1
                by[route][1] += dur * 1e-9
                break
    return dict(by)


def profile_pass(ns, carry, batch, w) -> tuple:
    """(per route {group_kernels, group_device_s, select_kernels,
    select_device_s, select_s}, pass wall s, pass kernel s) of one pass
    under the profiler."""
    cuda = DeviceType.CUDA
    marker = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with tracing.span("route-profile"):
            host0 = time.time_ns()
            marker.fill_(1.0)
            fast.schedule_batch_fast(ns, carry, batch, w, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(((e.name(), int(e.start_ns()), int(e.duration_ns()))
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda), key=lambda e: e[1])
    root = tracing.recent_timings()[-1]
    offset = events[0][1] - host0 if events else 0
    kernels = [e for e in events[1:] if not e[0].startswith(("Memcpy", "Memset"))]
    groups, selects = _windows(root, offset)
    in_group, in_select = _charge(kernels, groups), _charge(kernels, selects)
    split = route_split(root)
    out = {}
    for route in sorted(set(split) | set(in_group) | set(in_select)):
        gk, gs = in_group.get(route, (0, 0.0))
        sk, ss = in_select.get(route, (0, 0.0))
        out[route] = {"group_kernels": gk, "group_device_s": gs, "select_kernels": sk,
                      "select_device_s": ss,
                      "select_s": split.get(route, {}).get("select_s", 0.0)}
    return out, wall, sum(e[2] for e in kernels) * 1e-9


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON to this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("route_profile: torch.cuda.is_available() is False")
    w = weights_array(device="cuda")
    workloads = [("headline", lambda: headline.build_state(10_000, 100_000, device="cuda"))] + [
        (name, functools.partial(bench_configs.build_state, name, device="cuda"))
        for name in bench_configs.WORKLOADS
    ]
    out = {}
    for name, build in workloads:
        ns, carry, batch = build()
        fast.schedule_batch_fast(ns, carry, batch, w, device="cuda")
        split, wall, _ = spans_pass(ns, carry, batch, w)
        prof, prof_wall, prof_kernel_s = profile_pass(ns, carry, batch, w)
        print(f"[{name}] pass {wall:.3f} s; profiled pass {prof_wall:.3f} s with "
              f"{prof_kernel_s:.3f} s of kernels: device busy {prof_kernel_s / prof_wall:.1%}",
              flush=True)
        for route in sorted(set(split) | set(prof)):
            s, p = split.get(route, {}), prof.get(route, {})
            row = dict(s, **p)
            steps, sel = s.get("steps", 0), s.get("select_s", 0.0)
            print(f"[{name}] {route}: {s.get('groups', 0)} groups, {steps} steps, select "
                  f"{sel:.3f} s" + (f" ({sel / steps * 1e6:.1f} us/step)" if steps else "")
                  + f"; profiled: {p.get('group_kernels', 0)} kernels "
                  f"{p.get('group_device_s', 0.0) * 1e3:.3f} ms in its groups, "
                  f"{p.get('select_kernels', 0)} kernels "
                  f"{p.get('select_device_s', 0.0) * 1e3:.3f} ms in its selects"
                  + (f"; dyn {s['dyn']}" if "dyn" in s else "")
                  + (f"; light_scan launches {s['kernel']}" if "kernel" in s else ""),
                  flush=True)
            if steps:
                row.update(kernels_per_step=p.get("select_kernels", 0) / steps,
                           device_us_per_step=p.get("select_device_s", 0.0) / steps * 1e6,
                           wall_us_per_step=sel / steps * 1e6)
            if p.get("select_s"):
                row["device_busy"] = p["select_device_s"] / p["select_s"]
            out.setdefault(name, {})[route] = row
        out.setdefault(name, {})["_pass"] = {
            "wall_s": wall, "profiled_wall_s": prof_wall, "kernel_s": prof_kernel_s,
        }
        del ns, carry, batch
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "results": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
