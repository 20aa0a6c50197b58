"""Stage split of the domain_pop kernels on the card, in SM cycles per pop.

    python3 -m open_simulator_tpu_torch.tools.pop_stages [--out stages.json]

Captures the inputs of the first domain_pop call of one headline pass on the
card and runs two stamped kernels on them:
  * v1: tools/domain_pop_v1_stages.cu, the first version of the kernel with
    clock64() stamps around its stages (counts, raw max, divide, total max,
    argmin, head advance, count update);
  * current: a copy of csrc/domain_pop.cu, written into build/, with a
    clock64() stamp (after a __syncwarp()) in place of each "// stage:"
    comment of its loop.
Each stamped kernel's output must equal the package kernel's on the same
inputs. Stamps serialize the warp at each stage end, so a stamped loop runs
slower than the kernel itself; both totals are printed.

    python3 -m open_simulator_tpu_torch.tools.pop_stages --variant other.cu ...

also times each given copy of the kernel source (the same domain_pop_launch
interface) against csrc/domain_pop.cu on those inputs, in turns (package,
variants, variants reversed, package), after checking its output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..headline import build_state
from ..ops import domain_pop as dp
from ..ops import fast
from ..ops.kernels import weights_array

SOURCE = Path(__file__).with_name("domain_pop_v1_stages.cu")
STAGES = ("counts", "raw max", "divide", "total max", "argmin", "head advance", "count update")


def main_path_pop_args(n_nodes: int = 10_000, n_pods: int = 100_000) -> list:
    """The inputs of the first domain_pop call of one headline pass on the card."""
    ns, carry, batch = build_state(n_nodes, n_pods, device="cuda")
    captured = []
    real_pop = dp.domain_pop

    def recording_pop(*args):
        if not captured:
            captured.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return real_pop(*args)

    dp.domain_pop = recording_pop
    try:
        fast.schedule_batch_fast(ns, carry, batch, weights_array(device="cuda"), device="cuda")
    finally:
        dp.domain_pop = real_pop
    return captured[0]


def run_stamped(args):
    """(nodes, jidx, stamps) of one launch of the stamped kernel; stamps are
    the summed cycles of each stage, the loop's cycles and the loop's ns."""
    lib = ctypes.CDLL(str(dp.build_libraries(SOURCE)[0]))
    fn = lib.domain_pop_stages_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    tensors = args[:14]
    w_sp, fo_spread, valid_count, g, any_hard, big_n = args[14:]
    dc, lanes = tensors[0].shape
    c, d = tensors[6].shape
    dev = tensors[0].device
    nodes = torch.empty(g, dtype=torch.int32, device=dev)
    jidx = torch.empty(g, dtype=torch.int32, device=dev)
    stamps = torch.zeros(len(STAGES) + 2, dtype=torch.int64, device=dev)
    smem = 4 * (2 * c * d + c * d * dc + c * dc + 4 * c + dc + 8)  # that kernel's layout
    err = fn(
        *(t.data_ptr() for t in tensors), nodes.data_ptr(), jidx.data_ptr(),
        stamps.data_ptr(), dc, lanes, c, d, g, int(valid_count), int(bool(any_hard)),
        int(bool(fo_spread)), int(big_n), float(w_sp), smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stamped kernel launch failed: CUDA error {err}")
    torch.cuda.synchronize()
    return nodes, jidx, stamps.tolist()


def stamped_source() -> tuple[Path, list[str]]:
    """csrc/domain_pop.cu with a stamp at each "// stage:" comment, written
    into build/; returns its path and the stage names in loop order."""
    src = dp.SOURCE.read_text()
    marks = re.findall(r"^[ \t]*// stage: (.+)$", src, re.M)
    names = [m for m in marks if m not in ("start", "end")]
    n = len(names)
    prelude = (
        "#include <cuda_runtime.h>\n"
        f"__device__ unsigned long long g_stage[{n + 1}];\n"
    )
    k = 0

    def stamp(match):
        nonlocal k
        indent, name = match.group(1), match.group(2)
        if name == "start":
            return (f"{indent}long long st_acc[{n}] = {{}}; long long st_prev = clock64(); "
                    "const long long st_begin = st_prev;")
        if name == "end":
            return (f"{indent}if (threadIdx.x == 0) {{ for (int q = 0; q < {n}; ++q) "
                    f"g_stage[q] = st_acc[q]; g_stage[{n}] = st_prev - st_begin; }}")
        k += 1
        return (f"{indent}{{ __syncwarp(); const long long st_now = clock64(); "
                f"st_acc[{k - 1}] += st_now - st_prev; st_prev = st_now; }}")

    body = re.sub(r"^([ \t]*)// stage: (.+)$", stamp, src, flags=re.M)
    tail = (
        "\nextern \"C\" int domain_pop_stages_read(void* out) {\n"
        f"  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stage, {n + 1} * 8));\n}}\n"
    )
    dp.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = dp.BUILD_DIR / "domain_pop_stamped.cu"
    path.write_text(prelude + body + tail)
    return path, names


def launcher(source: Path):
    """(run, lib): run(args) launches domain_pop_launch of a build of
    `source` on the wrapper's arguments and returns (nodes, jidx)."""
    lib = ctypes.CDLL(str(dp.build_libraries(source)[0]))
    fn = lib.domain_pop_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int

    def run(args):
        tensors = args[:14]
        w_sp, fo_spread, valid_count, g, any_hard, big_n = args[14:]
        dc, lanes = tensors[0].shape
        c, d = tensors[6].shape
        dev = tensors[0].device
        nodes = torch.empty(g, dtype=torch.int32, device=dev)
        jidx = torch.empty(g, dtype=torch.int32, device=dev)
        err = fn(
            *(t.data_ptr() for t in tensors), nodes.data_ptr(), jidx.data_ptr(),
            dc, lanes, c, d, g, int(valid_count), int(bool(any_hard)),
            int(bool(fo_spread)), int(big_n), float(w_sp),
            dp.smem_bytes(c, d, dc, bool(any_hard) and bool(fo_spread)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"{source.name}: launch failed, CUDA error {err}")
        return nodes, jidx

    return run, lib


def run_current_stamped(args):
    """(nodes, jidx, cycles per stage, loop cycles) of one launch of the
    stamped copy of the current kernel."""
    path, names = stamped_source()
    run, lib = launcher(path)
    nodes, jidx = run(args)
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * (len(names) + 1))()
    if lib.domain_pop_stages_read(out) != 0:
        raise RuntimeError("reading the stage stamps failed")
    stamps = list(out)
    return nodes, jidx, dict(zip(names, stamps[:-1])), stamps[-1]


def compare_variants(args, variants: list[str], reps: int = 5) -> dict:
    """Event-timed ms per launch of the package kernel and each variant, in
    turns, on the same inputs; each variant's output must equal the
    package's."""
    runs = {"package": launcher(dp.SOURCE)[0]}
    runs.update({v: launcher(Path(v))[0] for v in variants})
    want = runs["package"](args)
    for name, run in runs.items():
        got = run(args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"pop_stages: variant {name} disagrees with the package kernel")
    order = list(runs) + list(reversed(runs))
    times: dict = {name: [] for name in runs}
    for name in order:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            runs[name](args)
        stop.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(stop) / reps)
    for name, ms in times.items():
        print(f"  {name}: " + ", ".join(f"{t:.3f}" for t in ms) + " ms", flush=True)
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument("--variant", action="append", default=[],
                    help="a copy of csrc/domain_pop.cu to time against it")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("pop_stages: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    args = main_path_pop_args()
    g = args[-3]
    nodes_k, jidx_k = dp.domain_pop(*args)
    run_stamped(args)  # warm
    nodes_s, jidx_s, stamps = run_stamped(args)
    if not (torch.equal(nodes_k, nodes_s) and torch.equal(jidx_k, jidx_s)):
        print("pop_stages: stamped v1 kernel disagrees with the package kernel", file=sys.stderr)
        return 1
    per_pop = {name: stamps[k] / g for k, name in enumerate(STAGES)}
    loop_cycles, loop_ns = stamps[len(STAGES)], stamps[len(STAGES) + 1]
    result = {
        "card": card, "pops": g, "shape": [list(args[0].shape), list(args[6].shape)],
        "cycles_per_pop": per_pop, "loop_cycles_per_pop": loop_cycles / g,
        "loop_ms": loop_ns / 1e6, "sm_mhz_from_timers": loop_cycles / loop_ns * 1e3,
    }
    print("v1 kernel (the first version):", flush=True)
    for name, cyc in per_pop.items():
        print(f"  {name:13s} {cyc:8.1f} cycles/pop", flush=True)
    print(f"stamped loop: {loop_cycles / g:.1f} cycles/pop, {loop_ns / 1e6:.3f} ms, "
          f"SM clock from clock64/globaltimer {result['sm_mhz_from_timers']:.0f} MHz", flush=True)

    run_current_stamped(args)  # warm
    nodes_c, jidx_c, cur, cur_loop = run_current_stamped(args)
    if not (torch.equal(nodes_k, nodes_c) and torch.equal(jidx_k, jidx_c)):
        print("pop_stages: stamped current kernel disagrees with the package kernel",
              file=sys.stderr)
        return 1
    result["current"] = {
        "cycles_per_pop": {k: v / g for k, v in cur.items()},
        "loop_cycles_per_pop": cur_loop / g,
    }
    print("current kernel (csrc/domain_pop.cu, stamped):", flush=True)
    for name, cyc in cur.items():
        print(f"  {name:13s} {cyc / g:8.1f} cycles/pop", flush=True)
    print(f"stamped loop: {cur_loop / g:.1f} cycles/pop", flush=True)
    if opts.variant:
        print("kernel ms per launch, in turns:", flush=True)
        result["variants_ms"] = compare_variants(args, opts.variant)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
