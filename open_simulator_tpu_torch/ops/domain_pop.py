"""The domain-merge pop loop: CUDA kernel wrapper and its plain version.

`domain_pop` is the port of the TPU kernel
open_simulator_tpu/ops/fast.py:_domain_pop_pallas. On CUDA tensors it
launches the hand-written kernel in csrc/domain_pop.cu (built with nvcc at
first use, loaded with ctypes) or raises; only tensors on the CPU take the
plain version `domain_pop_reference`, the XLA scan step of the reference's
domain_select (spread-only branch) as a Python loop on tensors.

Inputs (Dc classes, L lanes per class, C spread rows, D domains, G pops):
  hscore f32[Dc,L], hnode/hj i32[Dc,L]  sorted per-class lane tables
  cap_eff i32[Dc]                       lanes per class (capped at L)
  elig, combo_valid f32[Dc]             spread eligibility / class has a node
  base_dom, in_key f32[C,D]             domain counts at entry / eligible domains
  t_onehot f32[C,D,Dc]                  class -> domain membership per row
  match, soft, hard, skew f32[C]        per-row constants (masks as 0/1)
  has_key f32[C,Dc]                     class carries the row's topology key
Returns (nodes i32[G], jidx i32[G]).

`check_divide` holds the kernel's split spread divide against __fdiv_rn on
the card (chip_smoke.py runs it on every operand pair the spread can meet
below 2^13 and on random ones up to 2^24).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .kernels import _EPS

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "domain_pop.cu"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
MAX_CLASSES = 64            # two classes a lane; the fast path's DM_CAP
STATIC_SMEM = 4 * MAX_CLASSES * MAX_CLASSES + 16 * MAX_CLASSES * 32  # s_R + rings
EXACT = 1 << 24             # counts are exact f32 integers below this
SMEM_BUDGET = 232448        # bytes of shared memory one block may use (H100)

launches = 0                # kernel launches since import (reset by callers)
build_log = ""              # nvcc's output (registers, spills) of the last build
_lib = None


def _spread_norm(raw: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The topology-spread score normalization; `valid` masks which entries
    may define the max."""
    mx = torch.where(valid, raw, 0.0).amax()
    out = torch.where(mx > 0, (mx - raw) * 100.0 / mx.clamp(min=1e-9), 100.0)
    return out.clamp(0.0, 100.0)


def _hard_spread_ok(dom, cnt, in_key_cd, hard_c, skew, has_key, f_spread_on):
    """DoNotSchedule skew verdict per class from the reconstructed domain
    counts. Mask args are bool; `f_spread_on` a bool or bool tensor."""
    min_dom = torch.where(in_key_cd, dom, float("inf")).amin(dim=1)
    min_c = torch.where(torch.isfinite(min_dom), min_dom, 0.0)
    ok = ((cnt + 1.0 - min_c[:, None]) <= skew[:, None] + _EPS) & has_key
    return torch.where(hard_c[:, None], ok, True).all(dim=0) | ~torch.as_tensor(
        f_spread_on, device=dom.device
    )


def domain_pop_reference(
    hscore, hnode, hj, cap_eff, elig, combo_valid, base_dom, in_key, t_onehot,
    match, soft, hard, skew, has_key, w_sp: float, fo_spread: bool,
    valid_count: int, group_size: int, any_hard: bool, big_n: int,
):
    """The plain version: one iteration of the reference's scan step per pop,
    expression for expression (no host sync inside the loop)."""
    dev = hscore.device
    Dc, L = hscore.shape
    h = torch.zeros(Dc, dtype=torch.int32, device=dev)
    y = torch.zeros(Dc, dtype=torch.float32, device=dev)
    nodes = torch.empty(group_size, dtype=torch.int32, device=dev)
    jidx = torch.empty(group_size, dtype=torch.int32, device=dev)
    soft_b, hard_b = soft > 0, hard > 0
    valid_b, in_key_b, has_key_b = combo_valid > 0, in_key > 0, has_key > 0
    classes = torch.arange(Dc, device=dev)
    for i in range(group_size):
        # integer-valued sums: exact in any order
        dom = base_dom + match[:, None] * (t_onehot * (y * elig)).sum(dim=2)
        cnt = (dom[:, :, None] * t_onehot).sum(dim=1)               # [C,Dc]
        raw = torch.where(soft_b[:, None], cnt, 0.0).sum(dim=0)
        sp = _spread_norm(raw, valid_b)
        hc = h.clamp(0, L - 1)[:, None].long()
        hs = torch.where(h < cap_eff, hscore.gather(1, hc)[:, 0], float("-inf"))
        total = hs + w_sp * sp
        if any_hard:
            ok_sp = _hard_spread_ok(dom, cnt, in_key_b, hard_b, skew, has_key_b, fo_spread)
            total = torch.where(ok_sp, total, float("-inf"))
        node_h = hnode.gather(1, hc)[:, 0]
        j_h = hj.gather(1, hc)[:, 0]
        mx_t = total.amax()
        m = torch.where(total == mx_t, node_h, big_n).argmin()
        ok = (mx_t > float("-inf")) & (i < valid_count)
        nodes[i] = torch.where(ok, node_h[m], -1)
        jidx[i] = torch.where(ok, j_h[m], 0)
        oh = (classes == m) & ok
        h = h + oh.to(torch.int32)
        y = y + oh.to(torch.float32)
    return nodes, jidx


def smem_bytes(c: int, d: int, dc: int, hard: bool = True) -> int:
    """Dynamic shared memory the kernel takes for these table sizes: the
    hard rows' tables when the DoNotSchedule verdict is on (the layout of
    `Hard` in csrc/domain_pop.cu, domains rounded up to a warp), else 0. The
    static tables take STATIC_SMEM more."""
    if not hard:
        return 0
    dp = -(-d // 32) * 32
    return 4 * (c + c * dc * dc + c * dc * dp + c * dp + c * dc)


def _nvcc() -> str:
    """$NVCC when set, else nvcc on PATH, else the toolkit's default path."""
    env = os.environ.get("NVCC")
    cands = (env,) if env else (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc")
    for cand in cands:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found: the domain_pop CUDA kernel cannot be built "
        "(set NVCC or put the CUDA toolkit's bin directory on PATH)"
    )


def build_libraries(*sources: Path) -> list[Path]:
    """Compile each CUDA source into build/ (once per source content), all
    nvcc processes started together, and return the shared libraries' paths."""
    global build_log
    sos = []
    for source in sources:
        tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        sos.append(BUILD_DIR / f"lib{source.stem}-{tag}.so")
    todo = [(src, so) for src, so in zip(sources, sos) if not so.is_file()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src, so in todo:
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            procs.append((src, so, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, so, tmp, proc in procs:
            out = proc.communicate()[0]
            build_log += f"[{src.name}]\n{out}"
            if proc.returncode != 0:
                failed.append(f"nvcc failed building {src.name}:\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    return sos


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_libraries(SOURCE)[0]))
        fn = lib.domain_pop_launch
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        check = lib.domain_pop_divide_check
        check.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
        check.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_divide(n: torch.Tensor, d: torch.Tensor) -> int:
    """The number of (n, d) pairs, f32 CUDA tensors, on which the kernel's
    split divide (the reciprocal kept per max, then the quotient) differs in
    any bit from __fdiv_rn(n, d)."""
    if n.device.type != "cuda" or n.shape != d.shape:
        raise ValueError("check_divide: n and d must be CUDA tensors of one shape")
    n, d = n.contiguous().float(), d.contiguous().float()
    differ = torch.empty(n.shape, dtype=torch.int32, device=n.device)
    err = _library().domain_pop_divide_check(
        n.data_ptr(), d.data_ptr(), n.numel(), differ.data_ptr(),
        torch.cuda.current_stream(n.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"divide check launch failed: CUDA error {err}")
    return int(differ.sum())


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"domain_pop: {name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"domain_pop: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"domain_pop: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"domain_pop: {name} must be contiguous")


def domain_pop(
    hscore, hnode, hj, cap_eff, elig, combo_valid, base_dom, in_key, t_onehot,
    match, soft, hard, skew, has_key, w_sp: float, fo_spread: bool,
    valid_count: int, group_size: int, any_hard: bool, big_n: int,
):
    """The pop loop: the CUDA kernel for CUDA tensors, the plain version for
    tensors on the CPU. Never falls back from one to the other."""
    global launches
    args = (
        hscore, hnode, hj, cap_eff, elig, combo_valid, base_dom, in_key,
        t_onehot, match, soft, hard, skew, has_key,
    )
    if hscore.device.type == "cpu":
        return domain_pop_reference(
            *args, w_sp, fo_spread, valid_count, group_size, any_hard, big_n
        )
    Dc, L = hscore.shape
    C, D = base_dom.shape
    if C * group_size >= EXACT:
        raise ValueError(
            f"domain_pop: {C} rows x {group_size} pops may carry a count past 2^24, "
            "where f32 counts stop being exact"
        )
    if not 0 < big_n < EXACT * 2:
        raise ValueError(f"domain_pop: big_n={big_n}; the argmin packs nodes below 2^25")
    lib = _library()
    dev = hscore.device
    if dev.type != "cuda":
        raise ValueError(f"domain_pop: tensors on {dev}; the kernel needs CUDA")
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("hscore", hscore, f32, (Dc, L)), ("hnode", hnode, i32, (Dc, L)),
        ("hj", hj, i32, (Dc, L)), ("cap_eff", cap_eff, i32, (Dc,)),
        ("elig", elig, f32, (Dc,)), ("combo_valid", combo_valid, f32, (Dc,)),
        ("base_dom", base_dom, f32, (C, D)), ("in_key", in_key, f32, (C, D)),
        ("t_onehot", t_onehot, f32, (C, D, Dc)), ("match", match, f32, (C,)),
        ("soft", soft, f32, (C,)), ("hard", hard, f32, (C,)),
        ("skew", skew, f32, (C,)), ("has_key", has_key, f32, (C, Dc)),
    ):
        _check(name, t, dtype, shape, dev)
    if not 1 <= Dc <= MAX_CLASSES:
        raise ValueError(f"domain_pop: {Dc} classes; the kernel takes 1..{MAX_CLASSES}")
    smem = smem_bytes(C, D, Dc, bool(any_hard) and bool(fo_spread))
    if smem + STATIC_SMEM > SMEM_BUDGET:
        raise ValueError(
            f"domain_pop: the [C,Dc,D] tables need {smem + STATIC_SMEM} bytes of shared "
            f"memory; the budget is {SMEM_BUDGET}"
        )
    nodes = torch.empty(group_size, dtype=i32, device=dev)
    jidx = torch.empty(group_size, dtype=i32, device=dev)
    err = lib.domain_pop_launch(
        *(t.data_ptr() for t in args), nodes.data_ptr(), jidx.data_ptr(),
        Dc, L, C, D, group_size, int(valid_count), int(bool(any_hard)),
        int(bool(fo_spread)), int(big_n), float(w_sp), smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"domain_pop kernel launch failed: CUDA error {err}")
    launches += 1
    return nodes, jidx
