"""SM cycles of the single operations a domain_pop pop chains together.

    python3 -m open_simulator_tpu_torch.tools.chain_ops [--out ops.json]

Builds tools/chain_ops.cu and times, on the card, a chain of dependent
repetitions of each operation in one warp: the u32 redux, 5-step and 2-step
shuffle maxima, the IEEE divide, a shared-memory load, the f32/u32
conversions, an f32 add, and one pop of 4 classes kept by a single thread.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from ..ops import domain_pop as dp

SOURCE = Path(__file__).with_name("chain_ops.cu")
MODES = (
    "redux max u32", "shfl max 5 steps", "shfl max 2 steps", "fdiv_rn",
    "smem load", "f32->u32->f32", "fadd_rn", "4-class pop in one thread",
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON to this file")
    ap.add_argument("--reps", type=int, default=100_000)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chain_ops: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    lib = ctypes.CDLL(str(dp.build_libraries(SOURCE)[0]))
    fn = lib.chain_ops_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": torch.cuda.get_device_name(0), "cycles": {}}
    for mode, name in enumerate(MODES):
        per = []
        for n in (1000, opts.reps):
            io = torch.ones(32, dtype=torch.float32, device="cuda")
            out = torch.zeros(1, dtype=torch.int64, device="cuda")
            if fn(mode, n, io.data_ptr(), out.data_ptr(), stream) != 0:
                raise RuntimeError(f"chain_ops launch failed for {name}")
            per.append(out.item() / n)
        result["cycles"][name] = per[-1]
        print(f"  {name:28s} {per[-1]:8.1f} cycles", flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
