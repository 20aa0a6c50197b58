"""One run of one benchmark cell.

    python3 -m simbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the card is checked, the cell's configuration and traffic are read
(BENCHMARK.json names them; files under configs/ and traffic/), the node
manifests are made from the seed, and one warm `simulate()` call of the
cell's own shapes builds and loads every kernel and library (cached under
simbench/.cache, so only a checkout's first run builds). Its route counts
are checked against the traffic's `route`.

The window: `simulate(cluster, apps)` back to back, one caller in a closed
loop, each call a new request from the seed's stream; when `--seconds` have
passed, the window closes at the end of the call under way.
`sim_pods_per_s` is the pods the window's calls decided over the window's
whole wall time; `setup_s` runs from the start of the process to the first
timed call.

With `--trace 1` the same window runs, its calls' spans are read, and one
more call of the stream runs under the profiler; the result then carries
the cell's per-layer metrics (metrics/<name>.py), `busy_s`, `window_s` and
a breakdown.

After the window the device peak is read, the program's state is freed,
and the sampled calls (traffic `check`) are run again through the plain
reference (reference/) and compared: `correct` holds when every number is
within its limit. The compared numbers are the last lines on standard
error and the last key of the result line, the last line on standard out.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from . import gen
from .reference import compare, sched

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
CACHE = ROOT / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "open_simulator_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, a cell that does not exist,
    traffic that does not take its route, JAX loaded)."""


def environment() -> None:
    """Fixed cache directories inside the checkout, set before the port is
    imported: the nvcc and g++ libraries (OSIM_COMPILE_CACHE), and Triton's
    and torch's extension caches should anything use them. The slow-trace
    log of the port's spans is turned off: every call of a cell is slow by
    that measure, and rendering the tree is not the simulation's work."""
    for var, sub in (("OSIM_COMPILE_CACHE", "compile"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["OSIM_SLOW_TRACE"] = "1e9"
    # one process with few threads: the window's work is one caller's, and
    # host thread pools spread a run over cores the host shares
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def load_cell(name: str, root: Path = CHECKOUT) -> tuple:
    """(cell, configuration, traffic, the cell's per-layer metric entries)
    of a cell of BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = gen.load("traffic", cell["traffic"], root / "simbench")
    layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return cell, config, traffic, layer


def reader(metric: str, root: Path = ROOT):
    """The `read` function of metrics/<metric>.py."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"simbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.read


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_check(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")


def run_cell(cell, config, traffic, layer, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", root: Path = ROOT) -> tuple:
    """Set-up, window, reference check -> (result dict, check lines).
    `device` serves the benchmark's own tests, which drive a run on the
    CPU; `root` is where the metric readers are found."""
    import torch

    from . import program
    from . import trace as tracing

    dev = torch.device(device)
    nodes = gen.cluster(config, seed)
    cluster = program.cluster(nodes)

    # warm call: builds and loads the kernels, then the route check
    before = program.path_counts()
    warm = program.simulate(cluster, program.apps(gen.call_apps(traffic, seed, -1)), device)
    routes = {k: v - before[k] for k, v in program.path_counts().items() if v != before[k]}
    del warm
    want = traffic.get("route")
    groups = len(gen.slots(traffic))
    if want and routes.get(want, 0) != groups:
        raise Refused(f"the warm call's groups took {routes}, not {groups} x {want!r}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()

    # each sampled call's result is read back as plain data at once and
    # dropped, so no result outlives its call; that reading is the harness's
    # bookkeeping, and its time is taken out of the window's
    pool = gen.check_pool(traffic, seed)
    answers, final = {}, None
    spans, call_s = [], []
    pods = attempted = failed = 0
    bookkeeping = 0.0
    error = None
    start = time.perf_counter()
    setup_s = start - t0
    while True:
        call = attempted
        call_apps = gen.call_apps(traffic, seed, call)
        attempted += 1
        t_call = time.perf_counter()
        try:
            res = program.simulate(cluster, program.apps(call_apps), device)
        except Exception as e:  # a call that raises is a failed request
            failed += 1
            error = f"call {call}: {type(e).__name__}: {e}"
            break
        now = time.perf_counter()
        call_s.append(now - t_call)
        n = program.decided(res)
        pods += n
        spans.append(tracing.call_spans(program.recent_roots()[-1], n))
        if pool is None or call in pool:
            answers[call] = (call_apps, program.answer(res))
            bookkeeping += time.perf_counter() - now
        if now - start >= seconds:
            final = (call_apps, res)
            break
        res = None
    window_s = time.perf_counter() - start - bookkeeping
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"

    readings = tracing.Readings(calls=spans)
    extra = {}
    if trace:
        call = attempted
        call_apps = gen.call_apps(traffic, seed, call)
        app_res = program.apps(call_apps)
        if dev.type == "cuda":
            prof = tracing.profiled_call(
                torch, dev, lambda: program.decided(program.simulate(cluster, app_res, device)))
            readings.profile = prof
            extra["breakdown"] = tracing.breakdown(prof)
            extra["busy_s"] = tracing.gaps.busy(
                ((s, s + d) for _, s, d in prof.events), prof.lo, prof.hi) / 1e9
            extra["window_s"] = (prof.hi - prof.lo) / 1e9

    # the sample; a sampled call beyond the window's end gives way to the
    # window's last call. Then the program's state goes
    n_calls = attempted - failed
    sample = []
    for c in gen.sample_calls(pool, n_calls):
        if c not in answers and final is not None:
            answers[c] = (final[0], program.answer(final[1]))
        if c in answers:
            sample.append(answers[c])
    final = res = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    parts = [compare.judge(ans, sched.schedule(nodes, call_apps)) for call_apps, ans in sample]
    checks = compare.merge(parts)
    limits = compare.LIMITS
    correct = (failed == 0 and len(parts) > 0
               and all(checks[k] <= v for k, v in compare.LIMITS.items()))

    metrics = {}
    if trace:
        for m in layer:
            v = reader(m["name"], root)(readings)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics["sim_pods_per_s"] = {"value": pods / window_s, "unit": "pods/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if "busy_s" in extra:
        device_info["busy_s"] = extra["busy_s"]
        device_info["window_s"] = extra["window_s"]
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["routes"] = routes
    result["calls"] = n_calls
    result["calls_checked"] = len(parts)
    result["window_wall_s"] = window_s
    result["call_s"] = call_s
    result["bookkeeping_s"] = bookkeeping
    if error:
        result["error"] = error[:500]
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in checks}
    lines = [f"simbench: {n_calls} calls in {window_s:.3f} s, {len(parts)} compared "
             f"with the reference"]
    lines += [f"check {k} {checks[k]} limit {limits[k]}" for k in checks]
    return result, lines


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="simbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell, config, traffic, layer = load_cell(args.workload)
        environment()
        import torch

        device_check(torch, int(cell.get("chips", 1)))
        torch.set_num_threads(1)
        result, lines = run_cell(cell, config, traffic, layer, args.seed, args.seconds,
                                 bool(args.trace), t0)
        found = jax_modules()
        if found:
            raise Refused(f"JAX modules loaded in the run: {', '.join(found)}")
    except Refused as e:
        print(f"simbench: {e}", file=sys.stderr)
        return 2
    print("\n".join(lines), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
