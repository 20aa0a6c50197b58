"""The measured latency floor of one domain_pop pop.

Builds csrc/pop_chain_probe.cu (one warp running only the dependent chain of
a pop: the raw-max redux, the spread quotient on the max's reciprocal, the
total's multiply-add, the total-max redux, the (key, class) min redux and the
shared-memory read of the winner's raw increment and next head) and times it
with clock64() on the card:

    cycles, ns, seen = pop_chain.run(g, during=read_sm_clock)

`during` is called while the probe runs (an nvidia-smi clock reading, say)
and its result comes back as `seen`. G pops of domain_pop can take no less
than G * cycles / g SM cycles.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..ops import domain_pop as dp

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pop_chain_probe.cu"
MAX_POPS = (1 << 24) - 1    # the probe's raw counts stay exact below 2^24

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(dp.build_libraries(SOURCE)[0]))
        fn = lib.pop_chain_probe_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def run(g: int, during=None, w_sp: float = 2.0, big_n: int = 12288, device="cuda"):
    """(loop SM cycles, loop ns, during()) of one probe launch of g pops."""
    if not 0 < g <= MAX_POPS:
        raise ValueError(f"pop_chain: g={g}; the probe takes 1..{MAX_POPS} pops")
    lib = _library()
    dev = torch.device(device)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    sink = torch.empty(32, dtype=torch.float32, device=dev)
    err = lib.pop_chain_probe_launch(
        g, float(w_sp), int(big_n), out.data_ptr(), sink.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pop_chain_probe launch failed: CUDA error {err}")
    seen = during() if during is not None else None
    cycles, ns = out.tolist()  # syncs
    return cycles, ns, seen
