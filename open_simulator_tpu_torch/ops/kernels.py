"""Filter/score building blocks of the scheduling step, in PyTorch.

The port's counterpart of the JAX package's ops/kernels.py, limited to what
the trajectory fast path (ops/fast.py) reaches: the static masks and scores,
the node-local dynamic masks (resources, host ports, open-local storage,
GPU share), the domain counts and the explicit left-fold score combine.

Every function computes the reference's expression with the same f32 ops in
the same order, so results are bit-identical to the JAX package. The traps:
  - count sums (domain counts, selector counts) are integer-valued f32 below
    2**24 and therefore exact in any summation order; they are written as
    `(a * b).sum(dim)` reductions, never as cuBLAS products;
  - a sum over non-integer values is written as an explicit left fold, so
    the order cannot depend on the device's reduction tree;
  - never divide a CUDA tensor by a Python scalar: PyTorch's CUDA division
    multiplies by the scalar's reciprocal instead, which can round
    differently. Divisors here are tensors, or powers of two.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .encode import (
    GPU_COUNT_IDX,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_EXISTS,
    OP_NOT_IN,
)

# Filter indices — order mirrors the kube filter plugin order so the
# first-failure reason attribution matches the reference's diagnostics.
F_UNSCHEDULABLE = 0
F_NODE_NAME = 1
F_TAINT = 2
F_NODE_AFFINITY = 3
F_NODE_PORTS = 4
F_RESOURCES = 5
F_SPREAD = 6
F_POD_AFFINITY = 7
F_STORAGE = 8
F_GPU = 9
F_EXTRA = 10  # out-of-tree device plugins
NUM_FILTERS = 11

FILTER_MESSAGES = (
    "node(s) were unschedulable",
    "node(s) didn't match the requested node name",
    "node(s) had taint that the pod didn't tolerate",
    "node(s) didn't match Pod's node affinity/selector",
    "node(s) didn't have free ports for the requested pod ports",
    "Insufficient resources",
    "node(s) didn't match pod topology spread constraints",
    "node(s) didn't match pod affinity/anti-affinity rules",
    "node(s) didn't have enough local storage",
    "node(s) didn't have enough free GPU memory",
    "node(s) were rejected by an out-of-tree filter plugin",
)

# Score weights: the default v1beta1 provider weights plus Simon at weight 1.
DEFAULT_WEIGHTS = {
    "balanced_allocation": 1.0,
    "least_allocated": 1.0,
    "node_affinity": 1.0,
    "taint_toleration": 1.0,
    "topology_spread": 2.0,
    "inter_pod_affinity": 1.0,
    "prefer_avoid_pods": 10000.0,
    "simon": 1.0,
    "gpu_share": 1.0,
    "open_local": 1.0,
}
# Fold order: node-local terms alphabetically, then the two carry-coupled
# terms LAST (inter_pod_affinity, topology_spread), so the fast paths'
# partial sums are exact left-fold prefixes.
WEIGHT_ORDER = tuple(
    sorted(k for k in DEFAULT_WEIGHTS
           if k not in ("inter_pod_affinity", "topology_spread"))
) + ("inter_pod_affinity", "topology_spread")

_EPS = 1e-3  # absolute slack for f32 resource comparisons (units: milli / MiB)
HOSTNAME_KEY_IDX = 0  # the Encoder pins kubernetes.io/hostname at topo index 0

_INF = float("inf")


def weights_array(weights: dict = DEFAULT_WEIGHTS, device=DEFAULT_DEVICE) -> torch.Tensor:
    return torch.tensor(
        [float(weights.get(k, 0.0)) for k in WEIGHT_ORDER],
        dtype=torch.float32, device=resolve_device(device),
    )


def combine_scores(by_name: dict, weights: torch.Tensor, order=WEIGHT_ORDER):
    """Weighted score combination as an EXPLICIT left fold over `order`:
    ((w0*s0 + w1*s1) + w2*s2) + ... — partial sums split exactly."""
    total = None
    for i, k in enumerate(order):
        term = weights[i] * by_name[k]
        total = term if total is None else total + term
    return total


class NodeStatic(NamedTuple):
    """Immutable per-node tensors (device resident for a whole simulation)."""
    alloc: torch.Tensor        # f32[N,R]
    label_pair: torch.Tensor   # i32[N,L]
    label_key: torch.Tensor    # i32[N,L]
    label_num: torch.Tensor    # f32[N,L]
    taint_key: torch.Tensor    # i32[N,T]
    taint_val: torch.Tensor    # i32[N,T]
    taint_effect: torch.Tensor  # i32[N,T]
    name_id: torch.Tensor      # i32[N]
    unsched: torch.Tensor      # bool[N]
    avoid_pods: torch.Tensor   # bool[N]
    topo: torch.Tensor         # i32[N,K] domain id or -1
    valid: torch.Tensor        # bool[N]
    gpu_total: torch.Tensor    # f32[N,G] per-device total GPU mem MiB (0=none)
    vg_cap: torch.Tensor       # f32[N,V] open-local VG capacity MiB (0=pad)
    vg_name: torch.Tensor      # i32[N,V] VG name id (0=pad)
    dev_cap: torch.Tensor      # f32[N,DV] exclusive-device capacity MiB (0=pad)
    dev_ssd: torch.Tensor      # bool[N,DV] device media is SSD
    has_storage: torch.Tensor  # bool[N] node carries local storage
    domain_key: torch.Tensor   # i32[D] topo-key index per domain id (-1 pad)
    topo_onehot: torch.Tensor  # f32[K,D,N] domain membership (0 for missing key)
    unsched_key_id: torch.Tensor  # i32 scalar: key id of node.kubernetes.io/unschedulable
    empty_val_id: torch.Tensor    # i32 scalar: value id of ""
    anti_topo: torch.Tensor    # i32[AT] topo-key index per registered anti term


class Carry(NamedTuple):
    """Mutable cluster state threaded through a batch."""
    free: torch.Tensor        # f32[N,R]
    sel_counts: torch.Tensor  # f32[S,N]
    gpu_free: torch.Tensor    # f32[N,G] per-device free GPU mem MiB
    vg_free: torch.Tensor     # f32[N,V] VG capacity - requested, MiB
    dev_free: torch.Tensor    # f32[N,DV] 1.0 = device free, 0.0 = allocated
    port_any: torch.Tensor    # f32[PID,N] host-port uses per (proto,port)
    port_wild: torch.Tensor   # f32[PID,N] ... with wildcard hostIP only
    port_ipc: torch.Tensor    # f32[PIP,N] uses per specific (proto,port,ip)
    anti_counts: torch.Tensor  # f32[AT,N] placed pods carrying each anti term


class PodRow(NamedTuple):
    """One pod's features (a row of the PodBatch arrays), or all rows
    stacked along a leading [P] axis."""
    req: torch.Tensor
    has_req: torch.Tensor
    node_name_id: torch.Tensor
    gpu_mem: torch.Tensor
    gpu_num: torch.Tensor
    sel_op: torch.Tensor
    sel_key: torch.Tensor
    sel_val: torch.Tensor
    sel_num: torch.Tensor
    has_terms: torch.Tensor
    ns_pair: torch.Tensor
    pref_weight: torch.Tensor
    pref_op: torch.Tensor
    pref_key: torch.Tensor
    pref_val: torch.Tensor
    pref_num: torch.Tensor
    tol_key: torch.Tensor
    tol_val: torch.Tensor
    tol_exists: torch.Tensor
    tol_effect: torch.Tensor
    tol_valid: torch.Tensor
    spread_topo: torch.Tensor
    spread_sel: torch.Tensor
    spread_skew: torch.Tensor
    spread_hard: torch.Tensor
    aff_topo: torch.Tensor
    aff_sel: torch.Tensor
    aff_anti: torch.Tensor
    aff_required: torch.Tensor
    aff_weight: torch.Tensor
    lvm_req: torch.Tensor
    lvm_vg: torch.Tensor
    dev_req: torch.Tensor
    dev_media_ssd: torch.Tensor
    has_local: torch.Tensor
    match_sel: torch.Tensor
    owned_by_rs: torch.Tensor
    hp_pid: torch.Tensor
    hp_wild: torch.Tensor
    hp_ipid: torch.Tensor
    match_anti: torch.Tensor
    own_anti: torch.Tensor
    valid: torch.Tensor


def _fold_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` as the left fold ((x0 + x1) + x2) + ... — the order a
    sequential reduction takes, independent of the device's reduction tree.
    For sums of non-integer f32 values."""
    parts = x.unbind(dim)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


# ---------------------------------------------------------------------------
# node-selector term matching (NodeAffinity filter + score)
# ---------------------------------------------------------------------------

def _term_matches(ns: NodeStatic, ops, keys, vals, nums) -> torch.Tensor:
    """Terms (AND of EXPR expressions each) vs all nodes -> bool[N,TERM].
    ops/keys/nums [TERM,EXPR], vals [TERM,EXPR,VAL]. A term with no real
    expressions matches nothing (upstream semantics)."""
    lk = ns.label_key[:, :, None, None]                         # [N,L,1,1]
    has_key = ((lk == keys) & (keys != 0)).any(dim=1)           # [N,TERM,EXPR]
    lp = ns.label_pair[:, :, None, None, None]                  # [N,L,1,1,1]
    pair_hit = ((lp == vals) & (vals != 0)).any(dim=4).any(dim=1)
    key_rows = lk == keys                                       # [N,L,TERM,EXPR]
    ln = ns.label_num[:, :, None, None]
    gt = (key_rows & (ln > nums)).any(dim=1)
    lt = (key_rows & (ln < nums)).any(dim=1)
    per_expr = torch.ones_like(has_key)  # OP_PAD: neutral inside an AND
    for op_id, hit in (
        (OP_IN, pair_hit), (OP_NOT_IN, ~pair_hit), (OP_EXISTS, has_key),
        (OP_NOT_EXISTS, ~has_key), (OP_GT, gt), (OP_LT, lt),
    ):
        per_expr = torch.where(ops == op_id, hit, per_expr)
    non_empty = (ops != 0).any(dim=1)                           # [TERM]
    return per_expr.all(dim=2) & non_empty


def node_affinity_mask(ns: NodeStatic, pod: PodRow) -> torch.Tensor:
    """NodeAffinity filter: plain nodeSelector AND required affinity terms
    (OR over terms)."""
    wanted = pod.ns_pair                                        # [NS]
    present = (ns.label_pair[:, :, None] == wanted).any(dim=1)  # [N,NS]
    ns_ok = (present | (wanted == 0)).all(dim=1)
    term_hits = _term_matches(ns, pod.sel_op, pod.sel_key, pod.sel_val, pod.sel_num)
    terms_ok = term_hits.any(dim=1) | ~pod.has_terms
    return ns_ok & terms_ok


def _tolerated(ns: NodeStatic, pod: PodRow) -> torch.Tensor:
    """bool[N,T]: taint t of node n is tolerated by one of the pod's
    tolerations."""
    tk, tv, te = ns.taint_key, ns.taint_val, ns.taint_effect   # [N,T]
    eff_ok = (pod.tol_effect == 0) | (pod.tol_effect == te[:, :, None])
    key_ok = (pod.tol_key == 0) | (pod.tol_key == tk[:, :, None])
    val_ok = pod.tol_exists | (pod.tol_val == tv[:, :, None])
    return (pod.tol_valid & eff_ok & key_ok & val_ok).any(dim=2)


def taint_mask(ns: NodeStatic, pod: PodRow) -> torch.Tensor:
    """TaintToleration filter: every NoSchedule/NoExecute taint tolerated."""
    te = ns.taint_effect
    hard = (te == 1) | (te == 3)
    return (_tolerated(ns, pod) | ~hard).all(dim=1)


def _domain_counts(ns: NodeStatic, counts_node: torch.Tensor, k: int, elig=None):
    """Per-domain sums + their per-node broadcast for topology key k (a host
    int). Hostname (k == 0) counts per node; other keys sum through the
    one-hot membership as exact integer reductions.

    Returns (dom f32[D], cnt_n f32[N], min_count f32, total f32)."""
    elig = ns.valid if elig is None else (elig & ns.valid)
    counts = torch.where(elig, counts_node, 0.0)
    if k == HOSTNAME_KEY_IDX:
        D = ns.topo_onehot.shape[1]
        dom = torch.zeros(D, dtype=torch.float32, device=counts.device)
        min_c = torch.where(elig, counts_node, _INF).amin()
        min_c = torch.where(torch.isfinite(min_c), min_c, 0.0)
        return dom, counts, min_c, counts.sum()
    onehot = ns.topo_onehot[k]                                  # [D,N]
    dom = (onehot * counts).sum(dim=1)                          # [D]
    dom_elig = (onehot * elig.to(torch.float32)).sum(dim=1) > 0.0
    topo_k = ns.topo[:, k]
    D = dom.shape[0]
    cnt_n = torch.where(topo_k >= 0, dom[topo_k.clamp(0, D - 1)], 0.0)
    in_key = (ns.domain_key == k) & dom_elig
    min_c = torch.where(in_key, dom, _INF).amin()
    min_c = torch.where(torch.isfinite(min_c), min_c, 0.0)
    total = torch.where(in_key, dom, 0.0).sum()
    return dom, cnt_n, min_c, total


# ---------------------------------------------------------------------------
# Open-Gpu-Share
# ---------------------------------------------------------------------------

def allocatable_gpus(ns: NodeStatic, carry: Carry) -> torch.Tensor:
    """Number of not-fully-used devices per node -> f32[N]."""
    usable = (carry.gpu_free > _EPS) & (ns.gpu_total > 0)
    return usable.to(torch.float32).sum(dim=1)


def gpu_mask(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """Open-Gpu-Share Filter: non-GPU pods pass everywhere; GPU pods need
    sum_d floor(free_d/mem) >= num."""
    mem = pod.gpu_mem.clamp(min=1e-9)
    caps = torch.floor((carry.gpu_free + _EPS) / mem)
    caps = torch.where(ns.gpu_total > 0, caps, 0.0)
    feasible = (pod.gpu_num >= 1) & (caps.sum(dim=1) >= pod.gpu_num)
    return torch.where(pod.gpu_mem > 0, feasible, torch.ones_like(feasible))


def gpu_allocate_rowwise(ns: NodeStatic, gpu_free: torch.Tensor, pod: PodRow) -> torch.Tensor:
    """The GPU allocation take evaluated on EVERY node independently ->
    f32[N,G]: tightest fit for one share, the two-pointer greedy for more."""
    mem = pod.gpu_mem
    total_d = ns.gpu_total
    G = gpu_free.shape[1]
    elig = (total_d > 0) & (gpu_free >= mem - _EPS)
    tight = torch.where(elig, gpu_free, _INF).argmin(dim=1)     # [N]
    cols = torch.arange(G, device=gpu_free.device)
    take_single = (
        (cols[None, :] == tight[:, None]) & elig.any(dim=1)[:, None]
    ).to(torch.float32)
    caps = torch.where(
        total_d > 0, torch.floor((gpu_free + _EPS) / mem.clamp(min=1e-9)), 0.0
    )
    prefix = caps.cumsum(dim=1) - caps
    take_multi = torch.minimum((pod.gpu_num - prefix).clamp(min=0.0), caps)
    take_multi = torch.where(
        (caps.sum(dim=1) >= pod.gpu_num)[:, None], take_multi, 0.0
    )
    take = torch.where(pod.gpu_num == 1, take_single, take_multi)
    return torch.where((mem > 0) & (pod.gpu_num >= 1), take, 0.0)


def gpu_share_raw(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """Open-Gpu-Share raw score before its NormalizeScore -> f32[N]."""
    req = pod.req[None, :]
    R = ns.alloc.shape[1]
    dyn = allocatable_gpus(ns, carry)
    is_gpu_col = torch.arange(R, device=req.device) == GPU_COUNT_IDX
    alloc = torch.where(is_gpu_col[None, :], dyn[:, None], ns.alloc)
    avail = alloc - req
    share = torch.where(
        req == 0, 0.0,
        torch.where(avail == 0, 1.0, req / torch.where(avail == 0, 1.0, avail)),
    )
    share = torch.where(avail < 0, 1.0, share)
    raw = share.amax(dim=1) * 100.0
    return torch.where(pod.has_req, raw, 100.0)


# ---------------------------------------------------------------------------
# Open-Local: LVM volume-group binpack + exclusive-device allocation
# ---------------------------------------------------------------------------

def local_storage_eval(ns: NodeStatic, carry: Carry, pod: PodRow):
    """Simulate this pod's storage allocation on EVERY node at once.

    Returns (ok bool[N], vg_take f32[N,V], dev_take f32[N,DV], raw_score
    f32[N] — the plugin's pre-normalize 0..20 score)."""
    N, V = ns.vg_cap.shape
    DV = ns.dev_cap.shape[1]
    SV = pod.lvm_req.shape[0]
    dev = ns.vg_cap.device
    vcols = torch.arange(V, device=dev)
    dcols = torch.arange(DV, device=dev)

    vg_free, vg_take = carry.vg_free, torch.zeros_like(carry.vg_free)
    lvm_ok = torch.ones(N, dtype=torch.bool, device=dev)
    for s in range(SV):
        req = pod.lvm_req[s]
        active = req > 0
        want = pod.lvm_vg[s]
        fits = (vg_free + _EPS >= req) & (ns.vg_name != 0)
        elig = torch.where(want != 0, fits & (ns.vg_name == want), fits)
        choice = torch.where(elig, vg_free, _INF).argmin(dim=1)
        any_elig = elig.any(dim=1)
        onehot = (
            (vcols[None, :] == choice[:, None]) & any_elig[:, None] & active
        ).to(torch.float32)
        vg_free = vg_free - onehot * req
        vg_take = vg_take + onehot * req
        lvm_ok = lvm_ok & (any_elig | ~active)

    avail, dev_take = carry.dev_free, torch.zeros_like(carry.dev_free)
    frac_sum = torch.zeros(N, dtype=torch.float32, device=dev)
    dev_ok = torch.ones(N, dtype=torch.bool, device=dev)
    for s in range(SV):
        req = pod.dev_req[s]
        active = req > 0
        elig = (
            (avail > 0.5)
            & (ns.dev_ssd == pod.dev_media_ssd[s])
            & (ns.dev_cap + _EPS >= req)
            & (ns.dev_cap > 0)
        )
        choice = torch.where(elig, ns.dev_cap, _INF).argmin(dim=1)
        any_elig = elig.any(dim=1)
        onehot = (
            (dcols[None, :] == choice[:, None]) & any_elig[:, None] & active
        ).to(torch.float32)
        # one selected device per row: the sum is that capacity, exactly
        cap_chosen = (onehot * ns.dev_cap).sum(dim=1)
        frac_sum = frac_sum + torch.where(
            any_elig & active, req / cap_chosen.clamp(min=1e-9), 0.0
        )
        avail = avail - onehot
        dev_take = dev_take + onehot
        dev_ok = dev_ok & (any_elig | ~active)

    ok = torch.where(
        pod.has_local, lvm_ok & dev_ok & ns.has_storage,
        torch.ones(N, dtype=torch.bool, device=dev),
    )
    used = vg_take > 0
    vg_frac = torch.where(used, vg_take / ns.vg_cap.clamp(min=1e-9), 0.0)
    lvm_cnt = used.to(torch.float32).sum(dim=1)
    lvm_score = torch.floor(torch.where(
        lvm_cnt > 0, _fold_sum(vg_frac, 1) / lvm_cnt.clamp(min=1.0) * 10.0, 0.0,
    ))
    dev_cnt = (pod.dev_req > 0).to(torch.float32).sum()
    dev_score = torch.floor(torch.where(
        dev_cnt > 0, frac_sum / dev_cnt.clamp(min=1.0) * 10.0, 0.0
    ))
    raw = torch.where(ok & pod.has_local, lvm_score + dev_score, 0.0)
    return ok, vg_take, dev_take, raw


# ---------------------------------------------------------------------------
# NodePorts + NodeResourcesFit
# ---------------------------------------------------------------------------

def ports_mask(carry: Carry, pod: PodRow) -> torch.Tensor:
    """NodePorts filter: a requested host port conflicts on a node iff the
    same (protocol, port) is used there with an overlapping hostIP."""
    conf_wild = carry.port_any[pod.hp_pid] > 0.0                # [HP,N]
    conf_spec = (carry.port_wild[pod.hp_pid] > 0.0) | (carry.port_ipc[pod.hp_ipid] > 0.0)
    conf = torch.where(pod.hp_wild[:, None], conf_wild, conf_spec)
    conf = conf & (pod.hp_pid > 0)[:, None]
    return ~conf.any(dim=0)


def _scatter_drop(rows: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros(rows).at[idx].add(vals, mode="drop"): out-of-range indices add
    nothing (their values are zeroed, so no host sync is needed)."""
    keep = (idx >= 0) & (idx < rows)
    out = torch.zeros(rows, dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.clamp(0, rows - 1), torch.where(keep, vals, 0.0))


def port_adds(pid_rows: int, pip_rows: int, pod: PodRow):
    """Per-commit increments to the port count tables for one pod ->
    (add_any f32[PID], add_wild f32[PID], add_ipc f32[PIP])."""
    active = (pod.hp_pid > 0).to(torch.float32)
    add_any = _scatter_drop(pid_rows, pod.hp_pid, active)
    add_wild = _scatter_drop(pid_rows, pod.hp_pid, active * pod.hp_wild.to(torch.float32))
    add_ipc = _scatter_drop(
        pip_rows, pod.hp_ipid,
        active * (~pod.hp_wild).to(torch.float32) * (pod.hp_ipid > 0),
    )
    # never count into the pad row — keep row 0 identically zero
    for a in (add_any, add_wild, add_ipc):
        a[0] = 0.0
    return add_any, add_wild, add_ipc


def resource_fail(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """NodeResourcesFit failure -> bool[N]; the whole-GPU count resource is
    checked against its dynamic allocatable."""
    static_fail = (pod.req[None, :] > carry.free + _EPS).any(dim=1)
    whole_req = pod.req[GPU_COUNT_IDX]
    whole_used = ns.alloc[:, GPU_COUNT_IDX] - carry.free[:, GPU_COUNT_IDX]
    whole_fail = whole_req > allocatable_gpus(ns, carry) - whole_used + _EPS
    return static_fail | whole_fail


# ---------------------------------------------------------------------------
# Score plugins
# ---------------------------------------------------------------------------

def _minmax_normalize(score: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Simon's NormalizeScore: min-max to 0..100; constant scores collapse
    to 0."""
    lo = torch.where(valid, score, _INF).amin()
    hi = torch.where(valid, score, -_INF).amax()
    rng = hi - lo
    out = torch.where(rng > 0, (score - lo) * 100.0 / rng.clamp(min=1e-9), 0.0)
    return out.clamp(0.0, 100.0)


def score_simon(ns: NodeStatic, pod: PodRow) -> torch.Tensor:
    """Simon worst-fit score over static allocatable, truncated to int, then
    min-max normalized."""
    req = pod.req[None, :]
    avail = ns.alloc - req
    share = torch.where(
        req == 0, 0.0,
        torch.where(avail == 0, 1.0, req / torch.where(avail == 0, 1.0, avail)),
    )
    share = torch.where(avail < 0, 1.0, share)
    raw = torch.floor(share.amax(dim=1) * 100.0)
    raw = torch.where(pod.has_req, raw, 100.0)
    return _minmax_normalize(raw, ns.valid)


def score_taint_toleration(ns: NodeStatic, pod: PodRow) -> torch.Tensor:
    """Fewer intolerable PreferNoSchedule taints is better; reverse
    normalized."""
    cnt = ((ns.taint_effect == 2) & ~_tolerated(ns, pod)).to(torch.float32).sum(dim=1)
    max_cnt = torch.where(ns.valid, cnt, 0.0).amax()
    out = torch.where(
        max_cnt > 0, (max_cnt - cnt) * 100.0 / max_cnt.clamp(min=1e-9), 100.0
    )
    return out.clamp(0.0, 100.0)


def score_node_affinity(ns: NodeStatic, pod: PodRow) -> torch.Tensor:
    """Sum of matching preferred term weights, normalized by the max."""
    hits = _term_matches(ns, pod.pref_op, pod.pref_key, pod.pref_val, pod.pref_num)
    raw = (hits.to(torch.float32) * pod.pref_weight).sum(dim=1)
    mx = torch.where(ns.valid, raw, 0.0).amax()
    out = torch.where(mx > 0, raw * 100.0 / mx.clamp(min=1e-9), 0.0)
    return out.clamp(0.0, 100.0)


def score_prefer_avoid(ns: NodeStatic, pod: PodRow) -> torch.Tensor:
    """NodePreferAvoidPods: 0 on annotated nodes for RS/RC-owned pods."""
    return torch.where(ns.avoid_pods & pod.owned_by_rs, 0.0, 100.0)
