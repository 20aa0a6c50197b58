"""The domain-merge pop loop: CUDA kernel wrapper and its plain version.

`domain_pop` is the port of the TPU kernel
open_simulator_tpu/ops/fast.py:_domain_pop_pallas. Where `takes_kernel`
says (every device but the CPU) it launches the hand-written kernel in
csrc/domain_pop.cu (registered in ops/kernel_lib.py, which builds, loads,
launches and counts it) or raises; only tensors on the CPU take the plain
version `domain_pop_reference`, the XLA scan step of the reference's
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

import torch

from . import kernel_lib, scanmark
from .kernels import _EPS

MAX_CLASSES = 64            # two classes a lane; the fast path's DM_CAP
STATIC_SMEM = 4 * MAX_CLASSES * MAX_CLASSES + 16 * MAX_CLASSES * 32  # s_R + rings
EXACT = 1 << 24             # counts are exact f32 integers below this
SMEM_BUDGET = 232448        # bytes of shared memory one block may use (H100)


def takes_kernel(device: torch.device) -> bool:
    """Whether domain_pop launches the kernel on tensors of `device`: on
    every device but the CPU (where the kernel then needs a card). ops/fast.py
    sends only spread-only groups to domain_pop, so its domain_select adds
    "no affinity term" to this rule."""
    return device.type != "cpu"


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
        # gather, not node_h[m]: a tensor index reads m to the host
        mi = m.view(1)
        nodes[i] = torch.where(ok, node_h.gather(0, mi)[0], -1)
        jidx[i] = torch.where(ok, j_h.gather(0, mi)[0], 0)
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


def check_divide(n: torch.Tensor, d: torch.Tensor) -> int:
    """The number of (n, d) pairs, f32 CUDA tensors, on which the kernel's
    split divide (the reciprocal kept per max, then the quotient) differs in
    any bit from __fdiv_rn(n, d)."""
    if n.device.type != "cuda" or n.shape != d.shape:
        raise ValueError("check_divide: n and d must be CUDA tensors of one shape")
    n, d = n.contiguous().float(), d.contiguous().float()
    differ = torch.empty(n.shape, dtype=torch.int32, device=n.device)
    err = kernel_lib.library("domain_pop").domain_pop_divide_check(
        n.data_ptr(), d.data_ptr(), n.numel(), differ.data_ptr(),
        torch.cuda.current_stream(n.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"divide check launch failed: CUDA error {err}")
    return int(differ.sum())


def domain_pop(
    hscore, hnode, hj, cap_eff, elig, combo_valid, base_dom, in_key, t_onehot,
    match, soft, hard, skew, has_key, w_sp: float, fo_spread: bool,
    valid_count: int, group_size: int, any_hard: bool, big_n: int,
):
    """The pop loop: the CUDA kernel where `takes_kernel` says, the plain
    version for tensors on the CPU. Never falls back from one to the other."""
    args = (
        hscore, hnode, hj, cap_eff, elig, combo_valid, base_dom, in_key,
        t_onehot, match, soft, hard, skew, has_key,
    )
    if not takes_kernel(hscore.device):
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
    dev = hscore.device
    f32, i32 = torch.float32, torch.int32
    kernel_lib.check_tensors("domain_pop", dev, (
        ("hscore", hscore, f32, (Dc, L)), ("hnode", hnode, i32, (Dc, L)),
        ("hj", hj, i32, (Dc, L)), ("cap_eff", cap_eff, i32, (Dc,)),
        ("elig", elig, f32, (Dc,)), ("combo_valid", combo_valid, f32, (Dc,)),
        ("base_dom", base_dom, f32, (C, D)), ("in_key", in_key, f32, (C, D)),
        ("t_onehot", t_onehot, f32, (C, D, Dc)), ("match", match, f32, (C,)),
        ("soft", soft, f32, (C,)), ("hard", hard, f32, (C,)),
        ("skew", skew, f32, (C,)), ("has_key", has_key, f32, (C, Dc)),
    ))
    if not 1 <= Dc <= MAX_CLASSES:
        raise ValueError(f"domain_pop: {Dc} classes; the kernel takes 1..{MAX_CLASSES}")
    # any_hard and fo_spread are host bools the caller passes (no device read)
    smem = smem_bytes(C, D, Dc, bool(any_hard) and bool(fo_spread))  # osim: lint-ok[tracer-coercion]
    if smem + STATIC_SMEM > SMEM_BUDGET:
        raise ValueError(
            f"domain_pop: the [C,Dc,D] tables need {smem + STATIC_SMEM} bytes of shared "
            f"memory; the budget is {SMEM_BUDGET}"
        )
    nodes = torch.empty(group_size, dtype=i32, device=dev)
    jidx = torch.empty(group_size, dtype=i32, device=dev)
    # the scalars are host numbers from the caller, converted for ctypes
    scalars = (int(valid_count), int(bool(any_hard)), int(bool(fo_spread)), int(big_n), float(w_sp))  # osim: lint-ok[tracer-coercion]
    kernel_lib.launch(
        "domain_pop", "domain_pop_launch",
        *(t.data_ptr() for t in args), nodes.data_ptr(), jidx.data_ptr(),
        Dc, L, C, D, group_size, *scalars, smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    # what the launch wrote, for an analysis that cannot see inside it: node
    # indices in [-1, big_n), lane indices from the head table (or 0)
    scanmark.custom_outputs("domain_pop", [(nodes, -1, big_n - 1), (jidx, hj)])
    return nodes, jidx
