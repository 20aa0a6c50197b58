"""The control of `correct`: the plain reference put in the program's
place with every score and every partial sum of the fold rounded to
bfloat16, the precision below the float32 the scheduler states, and judged
against the float32 reference by the benchmark's own comparison. It has
to come out not correct.

    python3 -m simbench.control --workload <cell> --seeds 11,12,13 [--calls 3]

compares, per seed, the calls the cell's check would compare in a window
of `--calls` calls (default: the pool's calls), at the cell's own size,
and prints one JSON line per seed and a summary line with the smallest
reading of each number. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import gen
from .reference import compare, sched


def answer_of(res: sched.Result) -> compare.Answer:
    """A reference result in the form a program's answer takes."""
    n = len(res.node_names)
    binds = {name: list(res.binds[i]) for i, name in enumerate(res.node_names)}
    unscheduled = []
    for wl, node, _, counts in res.pods:
        if node < 0:
            parts = [f"{c} {sched.MESSAGES[f]}" for f, c in enumerate(counts) if c > 0]
            detail = ", ".join(parts) if parts else "no nodes in cluster"
            unscheduled.append((wl, f"0/{n} nodes are available: {detail}."))
    return compare.Answer(binds=binds, unscheduled=unscheduled)


def readings(config: dict, traffic: dict, seed: int, calls: int = 0) -> dict:
    """The control's numbers on one seed, summed over the compared calls."""
    nodes = gen.cluster(config, seed)
    pool = gen.check_pool(traffic, seed)
    n_calls = calls or (max(pool) + 1 if pool else 1)
    parts = []
    for c in gen.sample_calls(pool, n_calls):
        apps = gen.call_apps(traffic, seed, c)
        truth = sched.schedule(nodes, apps)
        low = sched.schedule(nodes, apps, rounding=sched.to_bf16)
        parts.append(compare.judge(answer_of(low), truth))
    out = compare.merge(parts)
    out["calls_compared"] = len(parts)
    return out


def main(argv=None) -> int:
    from .run import load_cell

    ap = argparse.ArgumentParser(prog="simbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=0)
    args = ap.parse_args(argv)
    _, config, traffic, _ = load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(config, traffic, seed, args.calls)
        r["seed"], r["seconds"] = seed, time.perf_counter() - t
        rows.append(r)
        print(json.dumps(r), flush=True)
    least = {k: min(r[k] for r in rows) for k in compare.LIMITS}
    fails = all(any(r[k] > v for k, v in compare.LIMITS.items()) for r in rows)
    print(json.dumps({"workload": args.workload, "least": least, "every_seed_fails": fails}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
