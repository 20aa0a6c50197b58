"""The scheduling step in PyTorch: filters, scores, commit and the oracle.

The port of the JAX package's ops/kernels.py: every Filter plugin as a mask
over all N nodes, every Score plugin with its normalization, the explicit
left-fold score combine, the one-pod commit (`commit_onehot`), and the
sequential oracle `schedule_batch` (one `schedule_step` per pod, a Python
loop over tensors on the caller's device with no host sync inside it).

Every function computes the reference's expression with the same f32 ops in
the same order, so results are bit-identical to the JAX package. The traps:
  - count sums (domain counts, selector counts) are integer-valued f32 below
    2**24 and therefore exact in any summation order; they are written as
    `(a * b).sum(dim)` reductions, never as cuBLAS products;
  - a sum over non-integer values is written as an explicit left fold, so
    the order cannot depend on the device's reduction tree;
  - never divide a CUDA tensor by a Python scalar: PyTorch's CUDA division
    multiplies by the scalar's reciprocal instead, which can round
    differently. Divisors here are tensors, or powers of two;
  - argmax over a bool matrix goes through uint8 (CUDA has no bool argmax);
    ties go to the first index, as jnp.argmax's do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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

# kube Filter plugin name -> filter index, for scheduler-config enable/disable
# lists (models/profiles.py). The default provider's volume filters
# (VolumeBinding, VolumeRestrictions, NodeVolumeLimits, VolumeZone) are inert
# in the reference, which rewrites every PVC volume to hostPath before any
# pod reaches the scheduler; configs naming them parse, and toggling them is
# a no-op.
FILTER_PLUGIN_MAP = {
    "NodeUnschedulable": F_UNSCHEDULABLE,
    "NodeName": F_NODE_NAME,
    "TaintToleration": F_TAINT,
    "NodeAffinity": F_NODE_AFFINITY,
    "NodePorts": F_NODE_PORTS,
    "NodeResourcesFit": F_RESOURCES,
    "PodTopologySpread": F_SPREAD,
    "InterPodAffinity": F_POD_AFFINITY,
}

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


class RowKeys(NamedTuple):
    """Topology tables of one family of constraint rows (spread rows,
    affinity rows or the registered anti terms), fixed for a pod spec. An
    inactive row (key -1) reads key 0, as the reference's max(k, 0) does;
    its verdicts are masked out by the caller."""
    is_host: torch.Tensor   # bool[R] row keyed by hostname: counts per node
    onehot: torch.Tensor    # f32[R,D,N] domain membership under the row's key
    topo_k: torch.Tensor    # i64[R,N] node's domain id under the key (-1 none)
    has_key: torch.Tensor   # bool[R,N] node carries the key
    key_dom: torch.Tensor   # bool[R,D] domain belongs to the row's key


def row_keys(ns: NodeStatic, topo_idx: torch.Tensor) -> RowKeys:
    k = topo_idx.clamp(min=0).long()
    topo_k = ns.topo[:, k].T.long()
    return RowKeys(
        k == HOSTNAME_KEY_IDX, ns.topo_onehot[k], topo_k, topo_k >= 0,
        ns.domain_key[None, :] == k[:, None],
    )


class PodKeys(NamedTuple):
    """The three row families one pod's coupled terms read."""
    spread: RowKeys
    aff: RowKeys
    anti: RowKeys


def pod_keys(ns: NodeStatic, pod: PodRow) -> PodKeys:
    return PodKeys(
        row_keys(ns, pod.spread_topo), row_keys(ns, pod.aff_topo), row_keys(ns, ns.anti_topo)
    )


def _row_counts(ns: NodeStatic, rk: RowKeys, counts_node: torch.Tensor, elig=None):
    """Per-domain counts for every row of a family at once: the reference's
    `_domain_counts` under its vmap over rows. Hostname rows count per node;
    other keys sum through the one-hot membership as exact integer
    reductions. Both are computed and the row's one selected, as there.
    `elig` bool[N] restricts which nodes count (None: all valid nodes).

    counts_node f32[R,N] -> (cnt_n f32[R,N] the count of the node's domain,
    min_count f32[R] over the key's eligible domains, total f32[R])."""
    elig = ns.valid if elig is None else (elig & ns.valid)
    counts = torch.where(elig, counts_node, 0.0)
    dom = (rk.onehot * counts[:, None, :]).sum(dim=2)                  # [R,D]
    dom_elig = (rk.onehot * elig.to(torch.float32)).sum(dim=2) > 0.0
    D = dom.shape[1]
    cnt_gather = torch.where(rk.has_key, dom.gather(1, rk.topo_k.clamp(0, D - 1)), 0.0)
    cnt_n = torch.where(rk.is_host[:, None], counts, cnt_gather)
    in_key = rk.key_dom & dom_elig
    min_dom = torch.where(in_key, dom, _INF).amin(dim=1)
    min_host = torch.where(elig, counts_node, _INF).amin(dim=1)
    min_c = torch.where(rk.is_host, min_host, min_dom)
    min_c = torch.where(torch.isfinite(min_c), min_c, 0.0)
    total = torch.where(
        rk.is_host, counts.sum(dim=1), torch.where(in_key, dom, 0.0).sum(dim=1)
    )
    return cnt_n, min_c, total


def _spread_rows_ok(ns, rk: RowKeys, counts_node, pod: PodRow, elig) -> torch.Tensor:
    """PodTopologySpread DoNotSchedule verdict -> bool[N] over the hard rows,
    from the rows' current selector counts f32[C,N]."""
    cnt_n, min_c, _ = _row_counts(ns, rk, counts_node, elig)
    ok = ((cnt_n + 1.0 - min_c[:, None]) <= pod.spread_skew[:, None] + _EPS) & rk.has_key
    active = (pod.spread_topo >= 0) & pod.spread_hard
    return torch.where(active[:, None], ok, True).all(dim=0)


def _affinity_rows_ok(ns, rk: RowKeys, counts_node, pod: PodRow) -> torch.Tensor:
    """InterPodAffinity required terms -> bool[N], from the rows' current
    selector counts f32[CA,N]."""
    cnt, _, total = _row_counts(ns, rk, counts_node)
    self_match = pod.match_sel[pod.aff_sel.long()]
    aff_ok = ((cnt > 0) | (self_match & (total == 0))[:, None]) & rk.has_key
    ok = torch.where(pod.aff_anti[:, None], cnt == 0, aff_ok)
    active = (pod.aff_topo >= 0) & pod.aff_required
    return torch.where(active[:, None], ok, True).all(dim=0)


def _anti_sym_ok(ns, rk: RowKeys, anti_counts, pod: PodRow) -> torch.Tensor:
    """Existing pods' required anti-affinity repelling this pod -> bool[N],
    from the registered terms' current carrier counts f32[AT,N]."""
    cnt, _, _ = _row_counts(ns, rk, anti_counts)
    ok = (cnt == 0) | ~rk.has_key
    active = (ns.anti_topo >= 0) & pod.match_anti
    return torch.where(active[:, None], ok, True).all(dim=0)


def _spread_score(ns, rk: RowKeys, counts_node, pod: PodRow, elig) -> torch.Tensor:
    """PodTopologySpread soft score: the reverse-normalized count sum over
    the ScheduleAnyway rows."""
    cnt, _, _ = _row_counts(ns, rk, counts_node, elig)
    active = (pod.spread_topo >= 0) & ~pod.spread_hard
    raw = torch.where(active[:, None], cnt, 0.0).sum(dim=0)
    mx = torch.where(ns.valid, raw, 0.0).amax()
    out = torch.where(mx > 0, (mx - raw) * 100.0 / mx.clamp(min=1e-9), 100.0)
    return out.clamp(0.0, 100.0)


def _affinity_score(ns, rk: RowKeys, counts_node, pod: PodRow) -> torch.Tensor:
    """InterPodAffinity preferred terms: +weight per matching pod in the
    domain for affinity, -weight for anti-affinity, min-max normalized. The
    weighted counts are integers, so the row sum is exact in any order."""
    cnt, _, _ = _row_counts(ns, rk, counts_node)
    signed = torch.where(pod.aff_anti, -pod.aff_weight, pod.aff_weight)[:, None] * cnt
    active = (pod.aff_topo >= 0) & ~pod.aff_required
    raw = torch.where(active[:, None], signed, 0.0).sum(dim=0)
    return torch.where(active.any(), _minmax_normalize(raw, ns.valid), 0.0)


def spread_mask(
    ns: NodeStatic, carry: Carry, pod: PodRow, na_ok=None, keys: Optional[PodKeys] = None
) -> torch.Tensor:
    """PodTopologySpread hard constraints; `na_ok` (the pod's node-affinity
    mask, recomputed when None) restricts which nodes count."""
    elig = node_affinity_mask(ns, pod) if na_ok is None else na_ok
    rk = row_keys(ns, pod.spread_topo) if keys is None else keys.spread
    return _spread_rows_ok(ns, rk, carry.sel_counts[pod.spread_sel.long()], pod, elig)


def pod_affinity_mask(
    ns: NodeStatic, carry: Carry, pod: PodRow, keys: Optional[PodKeys] = None
) -> torch.Tensor:
    """InterPodAffinity required terms AND the anti-affinity symmetry of the
    registered terms (ns.anti_topo) this pod's labels match."""
    keys = pod_keys(ns, pod) if keys is None else keys
    req_ok = _affinity_rows_ok(ns, keys.aff, carry.sel_counts[pod.aff_sel.long()], pod)
    return req_ok & _anti_sym_ok(ns, keys.anti, carry.anti_counts, pod)


# ---------------------------------------------------------------------------
# Open-Gpu-Share
# ---------------------------------------------------------------------------

def allocatable_gpus(ns: NodeStatic, carry: Carry) -> torch.Tensor:
    """Number of not-fully-used devices per node -> f32[N]."""
    usable = (carry.gpu_free > _EPS) & (ns.gpu_total > 0)
    return usable.to(torch.float32).sum(dim=1)


def _gpu_device_caps(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """floor(free_d / mem) shares each device can still hold -> f32[N,G]."""
    caps = torch.floor((carry.gpu_free + _EPS) / pod.gpu_mem.clamp(min=1e-9))
    return torch.where(ns.gpu_total > 0, caps, 0.0)


def gpu_mask(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """Open-Gpu-Share Filter: non-GPU pods pass everywhere; GPU pods need
    sum_d floor(free_d/mem) >= num."""
    caps = _gpu_device_caps(ns, carry, pod)
    feasible = (pod.gpu_num >= 1) & (caps.sum(dim=1) >= pod.gpu_num)
    return torch.where(pod.gpu_mem > 0, feasible, torch.ones_like(feasible))


def _gpu_take(free_d: torch.Tensor, total_d: torch.Tensor, pod: PodRow) -> torch.Tensor:
    """The device allocation of one pod on each row of free_d/total_d
    f32[M,G] -> shares per device f32[M,G]: tightest fit for one share (ties
    to the lowest device), the two-pointer greedy take_d = clip(num -
    prefix_d, 0, cap_d) for more."""
    mem = pod.gpu_mem
    G = free_d.shape[1]
    elig = (total_d > 0) & (free_d >= mem - _EPS)
    tight = torch.where(elig, free_d, _INF).argmin(dim=1)
    cols = torch.arange(G, device=free_d.device)
    take_single = (
        (cols[None, :] == tight[:, None]) & elig.any(dim=1)[:, None]
    ).to(torch.float32)
    caps = torch.where(
        total_d > 0, torch.floor((free_d + _EPS) / mem.clamp(min=1e-9)), 0.0
    )
    prefix = caps.cumsum(dim=1) - caps
    take_multi = torch.minimum((pod.gpu_num - prefix).clamp(min=0.0), caps)
    take_multi = torch.where(
        (caps.sum(dim=1) >= pod.gpu_num)[:, None], take_multi, 0.0
    )
    take = torch.where(pod.gpu_num == 1, take_single, take_multi)
    return torch.where((mem > 0) & (pod.gpu_num >= 1), take, 0.0)


def gpu_allocate_rowwise(ns: NodeStatic, gpu_free: torch.Tensor, pod: PodRow) -> torch.Tensor:
    """The GPU allocation take evaluated on EVERY node independently ->
    f32[N,G]; row n equals gpu_allocate's take on node n."""
    return _gpu_take(gpu_free, ns.gpu_total, pod)


def _project(sel: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """einsum("n,n...->...") of a one-hot f32[N] selector: the selected row
    (one 1.0 times each value plus exact zeros), all zeros when none is."""
    return (sel.reshape((-1,) + (1,) * (rows.dim() - 1)) * rows).sum(dim=0)


def gpu_allocate(ns: NodeStatic, carry: Carry, pod: PodRow, node_onehot: torch.Tensor):
    """Allocate devices on the selected node -> (take f32[G] shares per
    device, new gpu_free f32[N,G])."""
    sel = node_onehot.to(torch.float32)
    free_d = _project(sel, carry.gpu_free)
    total_d = _project(sel, ns.gpu_total)
    take = _gpu_take(free_d[None], total_d[None], pod)[0]
    gpu_free = carry.gpu_free - sel[:, None] * take[None, :] * pod.gpu_mem
    return take, gpu_free


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


def local_storage_mask(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    return local_storage_eval(ns, carry, pod)[0]


def score_open_local(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """Open-Local score + its NormalizeScore; 0 for pods without volumes."""
    raw = local_storage_eval(ns, carry, pod)[3]
    return torch.where(pod.has_local, _minmax_normalize(raw, ns.valid), 0.0)


def _storage_commit(carry: Carry, sel: torch.Tensor, vg_take_all, dev_take_all):
    """Commit the selected node's storage allocation from the eval's takes:
    (vg_free, dev_free, vg_take f32[V], dev_take f32[DV])."""
    return (
        carry.vg_free - sel[:, None] * vg_take_all,
        carry.dev_free - sel[:, None] * dev_take_all,
        _project(sel, vg_take_all),
        _project(sel, dev_take_all),
    )


def local_storage_commit(ns: NodeStatic, carry: Carry, pod: PodRow, node_onehot: torch.Tensor):
    """Commit the chosen node's storage allocation -> (vg_free f32[N,V],
    dev_free f32[N,DV], vg_take f32[V], dev_take f32[DV])."""
    _, vg_take_all, dev_take_all, _ = local_storage_eval(ns, carry, pod)
    return _storage_commit(carry, node_onehot.to(torch.float32), vg_take_all, dev_take_all)


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
    """zeros(rows).at[idx].add(vals, mode="drop") for 0/1 counts:
    out-of-range indices add nothing. A one-hot sum, not index_add: under
    torch.func.vmap with a batched pod, index_add's batching rule loops over
    the lanes one by one. The sums are of small whole numbers, so exact in
    any order."""
    keep = (idx >= 0) & (idx < rows)
    hit = (torch.arange(rows, device=idx.device)[:, None] == idx[None, :]) & keep[None, :]
    return torch.where(hit, vals[None, :], 0.0).sum(dim=1)


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
    def no_pad(a):
        return torch.where(torch.arange(a.shape[0], device=a.device) == 0, 0.0, a)

    return no_pad(add_any), no_pad(add_wild), no_pad(add_ipc)


def ports_commit(carry: Carry, pod: PodRow, onehot: torch.Tensor):
    """Record the committed pod's host ports into the selected node's
    counts -> (port_any, port_wild, port_ipc)."""
    sel = onehot.to(torch.float32)
    add_any, add_wild, add_ipc = port_adds(carry.port_any.shape[0], carry.port_ipc.shape[0], pod)
    return (
        carry.port_any + add_any[:, None] * sel[None, :],
        carry.port_wild + add_wild[:, None] * sel[None, :],
        carry.port_ipc + add_ipc[:, None] * sel[None, :],
    )


def resource_fail(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """NodeResourcesFit failure -> bool[N]; the whole-GPU count resource is
    checked against its dynamic allocatable."""
    static_fail = (pod.req[None, :] > carry.free + _EPS).any(dim=1)
    whole_req = pod.req[GPU_COUNT_IDX]
    whole_used = ns.alloc[:, GPU_COUNT_IDX] - carry.free[:, GPU_COUNT_IDX]
    whole_fail = whole_req > allocatable_gpus(ns, carry) - whole_used + _EPS
    return static_fail | whole_fail


def static_fails(ns: NodeStatic, pod: PodRow, na_ok: torch.Tensor) -> list:
    """The four filters that read no cluster state, as failure masks
    bool[N] in filter order (unschedulable, node name, taints, node
    affinity). The unschedulable filter admits pods tolerating the
    synthetic node.kubernetes.io/unschedulable:NoSchedule taint."""
    unsched_tolerated = (
        pod.tol_valid
        & ((pod.tol_key == 0) | (pod.tol_key == ns.unsched_key_id))
        & (pod.tol_exists | (pod.tol_val == ns.empty_val_id))
        & ((pod.tol_effect == 0) | (pod.tol_effect == 1))
    ).any()
    return [
        ns.unsched & ~unsched_tolerated,
        (pod.node_name_id != 0) & (ns.name_id != pod.node_name_id),
        ~taint_mask(ns, pod),
        ~na_ok,
    ]


def first_failure(fails: torch.Tensor) -> torch.Tensor:
    """Index of the first failing filter per row of fails bool[N,F], or
    NUM_FILTERS where none fails -> i32[N]."""
    first = fails.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(fails.any(dim=1), first, torch.full_like(first, NUM_FILTERS))


def run_filters(
    ns: NodeStatic, carry: Carry, pod: PodRow, filter_on=None, extra_filters=(),
    keys: Optional[PodKeys] = None,
):
    """All filter plugins -> (mask bool[N], first_fail i32[N]).

    first_fail is the first failing filter per node (kube stops a node's
    filter chain there), or NUM_FILTERS when feasible. `filter_on`
    (bool[NUM_FILTERS] or None = all on) disables filters; `extra_filters`
    are out-of-tree predicates `f(ns, carry, pod) -> bool[N]` AND-ed into
    the F_EXTRA slot."""
    na_ok = node_affinity_mask(ns, pod)
    extra_fail = torch.zeros_like(ns.valid)
    for f in extra_filters:
        extra_fail = extra_fail | ~f(ns, carry, pod)
    fails = torch.stack(
        static_fails(ns, pod, na_ok) + [
            ~ports_mask(carry, pod),
            resource_fail(ns, carry, pod),
            ~spread_mask(ns, carry, pod, na_ok, keys),
            ~pod_affinity_mask(ns, carry, pod, keys),
            ~local_storage_mask(ns, carry, pod),
            ~gpu_mask(ns, carry, pod),
            extra_fail,
        ],
        dim=1,
    )                                                           # [N,F]
    if filter_on is not None:
        fails = fails & filter_on[None, :]
    return ~fails.any(dim=1) & ns.valid, first_failure(fails)


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


def _la_ba(ns: NodeStatic, pod: PodRow, free2: torch.Tensor):
    """LeastAllocated + BalancedAllocation from cpu/mem free values: the one
    definition the per-pod step and every fast path share (free2 is [N,2]
    or [N,J,2]; elementwise, so every lane matches the per-step plugins).
    The mean over two values is (a + b) * 0.5, the same rounding as
    jnp.mean's sum / 2."""
    alloc2 = ns.alloc[:, :2]
    req2 = pod.req[:2]
    if free2.dim() == 3:
        alloc2 = alloc2[:, None, :]
    free_after = free2 - req2
    frac = torch.where(alloc2 > 0, free_after / alloc2.clamp(min=1e-9), 0.0)
    la = ((frac[..., 0] + frac[..., 1]) * 0.5).clamp(0.0, 1.0) * 100.0
    used_after = alloc2 - free2 + req2
    frac_b = torch.where(alloc2 > 0, used_after / alloc2.clamp(min=1e-9), 0.0)
    frac_b = frac_b.clamp(0.0, 1.0)
    ba = (1.0 - (frac_b[..., 0] - frac_b[..., 1]).abs()) * 100.0
    return la, ba


def score_least_allocated(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """NodeResourcesLeastAllocated over cpu + memory."""
    return _la_ba(ns, pod, carry.free[:, :2])[0]


def score_balanced(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """NodeResourcesBalancedAllocation: 100 - |cpuFrac - memFrac| * 100."""
    return _la_ba(ns, pod, carry.free[:, :2])[1]


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


def score_topology_spread(
    ns: NodeStatic, carry: Carry, pod: PodRow, na_ok=None, keys: Optional[PodKeys] = None
) -> torch.Tensor:
    """PodTopologySpread soft constraints; counting spans the nodes passing
    the pod's node affinity/selector (`na_ok`, recomputed when None)."""
    elig = node_affinity_mask(ns, pod) if na_ok is None else na_ok
    rk = row_keys(ns, pod.spread_topo) if keys is None else keys.spread
    return _spread_score(ns, rk, carry.sel_counts[pod.spread_sel.long()], pod, elig)


def score_inter_pod_affinity(
    ns: NodeStatic, carry: Carry, pod: PodRow, keys: Optional[PodKeys] = None
) -> torch.Tensor:
    """InterPodAffinity preferred terms, min-max normalized."""
    rk = row_keys(ns, pod.aff_topo) if keys is None else keys.aff
    return _affinity_score(ns, rk, carry.sel_counts[pod.aff_sel.long()], pod)


def score_gpu_share(ns: NodeStatic, carry: Carry, pod: PodRow) -> torch.Tensor:
    """Open-Gpu-Share score: worst-fit share over the node's current
    allocatable, min-max normalized."""
    return _minmax_normalize(gpu_share_raw(ns, carry, pod), ns.valid)


def run_scores(
    ns: NodeStatic, carry: Carry, pod: PodRow, weights: torch.Tensor, extra_scores=(),
    keys: Optional[PodKeys] = None,
) -> torch.Tensor:
    """Weighted sum of all normalized score plugins -> f32[N]; the
    out-of-tree `extra_scores` ((fn, weight) pairs of `fn(ns, carry, pod) ->
    f32[N]`) are added after the in-tree fold."""
    na_ok = node_affinity_mask(ns, pod)
    la, ba = _la_ba(ns, pod, carry.free[:, :2])
    by_name = {
        "balanced_allocation": ba,
        "least_allocated": la,
        "node_affinity": score_node_affinity(ns, pod),
        "taint_toleration": score_taint_toleration(ns, pod),
        "topology_spread": score_topology_spread(ns, carry, pod, na_ok, keys),
        "inter_pod_affinity": score_inter_pod_affinity(ns, carry, pod, keys),
        "prefer_avoid_pods": score_prefer_avoid(ns, pod),
        "simon": score_simon(ns, pod),
        "gpu_share": score_gpu_share(ns, carry, pod),
        "open_local": score_open_local(ns, carry, pod),
    }
    score = combine_scores(by_name, weights)
    for fn, w in extra_scores:
        score = score + w * fn(ns, carry, pod)
    return score


# ---------------------------------------------------------------------------
# Commit and the sequential oracle
# ---------------------------------------------------------------------------

def commit_onehot(ns: NodeStatic, carry: Carry, pod: PodRow, onehot: torch.Tensor):
    """Apply one pod's placement (onehot bool[N], all-False = no commit) to
    the carry -> (carry, gpu_take f32[G], vg_take f32[V], dev_take f32[DV])."""
    sel = onehot.to(torch.float32)
    gpu_take, gpu_free = gpu_allocate(ns, carry, pod, onehot)
    vg_free, dev_free, vg_take, dev_take = local_storage_commit(ns, carry, pod, onehot)
    port_any, port_wild, port_ipc = ports_commit(carry, pod, onehot)
    new_carry = Carry(
        free=carry.free - sel[:, None] * pod.req[None, :],
        sel_counts=carry.sel_counts + pod.match_sel.to(torch.float32)[:, None] * sel[None, :],
        gpu_free=gpu_free, vg_free=vg_free, dev_free=dev_free,
        port_any=port_any, port_wild=port_wild, port_ipc=port_ipc,
        anti_counts=carry.anti_counts + pod.own_anti[:, None] * sel[None, :],
    )
    return new_carry, gpu_take, vg_take, dev_take


def reason_row(first_fail: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Histogram i32[F] of the valid nodes' first failing filters, as an
    integer sum of a [N,F] one-hot (no in-place scatter, so it runs under
    torch.func.vmap); a node with first_fail == NUM_FILTERS counts nowhere."""
    filters = torch.arange(NUM_FILTERS, device=first_fail.device)
    hit = (first_fail[:, None] == filters[None, :]) & valid[:, None]
    return hit.sum(dim=0, dtype=torch.int32)


def schedule_step(
    ns: NodeStatic, weights: torch.Tensor, carry: Carry, pod: PodRow, filter_on=None,
    extra_filters=(), extra_scores=(), keys: Optional[PodKeys] = None,
):
    """Filter, score, pick (first max: lowest node index wins ties) and
    commit one pod -> (carry, (node i32, reasons i32[F], gpu_take i32[G],
    vg_take f32[V], dev_take f32[DV])). Reasons are zero when the pod lands.
    No value leaves the device."""
    mask, first_fail = run_filters(ns, carry, pod, filter_on, extra_filters, keys)
    score = torch.where(mask, run_scores(ns, carry, pod, weights, extra_scores, keys), -_INF)
    node = score.argmax()
    ok = mask.any() & pod.valid
    onehot = (torch.arange(ns.valid.shape[0], device=node.device) == node) & ok
    new_carry, gpu_take, vg_take, dev_take = commit_onehot(ns, carry, pod, onehot)
    reasons = torch.where(ok, 0, reason_row(first_fail, ns.valid))
    return new_carry, (
        torch.where(ok, node, -1).to(torch.int32), reasons,
        gpu_take.to(torch.int32), vg_take, dev_take,
    )


def schedule_batch(
    ns: NodeStatic, carry: Carry, pods: PodRow, weights: torch.Tensor, filter_on=None,
    extra_filters=(), extra_scores=(),
):
    """The sequential oracle: schedule every row of the stacked PodRow in
    order, one schedule_step each, on the tensors' device.

    Returns (carry, nodes i32[P] (-1 = unschedulable), reasons i32[P,F],
    gpu_take i32[P,G], vg_take f32[P,V], dev_take f32[P,DV]) as tensors."""
    outs = []
    for i in range(pods.req.shape[0]):
        pod = PodRow(*(a[i] for a in pods))
        carry, out = schedule_step(
            ns, weights, carry, pod, filter_on, extra_filters, extra_scores, pod_keys(ns, pod)
        )
        outs.append(out)
    return (carry,) + tuple(torch.stack(col) for col in zip(*outs))


def probe_step(
    ns: NodeStatic, carry: Carry, pod: PodRow, weights: torch.Tensor, filter_on=None,
    extra_filters=(), extra_scores=(),
):
    """Filter and score ONE pod without committing -> (mask bool[N], score
    f32[N] with -inf on infeasible nodes, first_fail i32[N])."""
    mask, first_fail = run_filters(ns, carry, pod, filter_on, extra_filters)
    score = torch.where(mask, run_scores(ns, carry, pod, weights, extra_scores), -_INF)
    return mask & ns.valid, score, first_fail


def commit_step(ns: NodeStatic, carry: Carry, pod: PodRow, node: torch.Tensor):
    """Commit ONE pod to node index `node` (i32 scalar, -1 = no commit): the
    scan's state transition for the same choice -> (carry, gpu_take
    i32[G], vg_take f32[V], dev_take f32[DV])."""
    ok = (node >= 0) & pod.valid
    onehot = (torch.arange(ns.valid.shape[0], device=node.device) == node) & ok
    new_carry, gpu_take, vg_take, dev_take = commit_onehot(ns, carry, pod, onehot)
    return new_carry, gpu_take.to(torch.int32), vg_take, dev_take


def probe_many(
    ns: NodeStatic, carry: Carry, rows: PodRow, weights: torch.Tensor, filter_on=None,
    extra_filters=(), extra_scores=(),
):
    """probe_step under torch.func.vmap over a wave of W pods against ONE
    carry -> (mask bool[W,N], score f32[W,N] with -inf on infeasible nodes,
    first_fail i32[W,N]). The extender wave engine probes a whole wave up
    front so the per-pod HTTP chains can run concurrently."""

    def one(pod):
        return probe_step(ns, carry, pod, weights, filter_on, extra_filters, extra_scores)

    return torch.func.vmap(one)(rows)


def commit_wave(
    ns: NodeStatic, carry: Carry, rows: PodRow, weights: torch.Tensor,
    expected_mask: torch.Tensor, expected_ff: torch.Tensor, ext_allowed: torch.Tensor,
    ext_score: torch.Tensor, want_commit: torch.Tensor, filter_on=None,
    extra_filters=(), extra_scores=(),
):
    """The pod-order commit loop of one extender wave, with a conflict
    recheck. The wave's HTTP filter/prioritize calls saw masks probed at the
    wave-start carry (probe_many); by the time pod i commits, pods 0..i-1
    have changed the carry. So each step re-runs the filters on the LIVE
    carry and compares the mask and first failures with what the HTTP chain
    saw (`expected_mask` bool[W,N], `expected_ff` i32[W,N]). A match proves
    the serial per-pod path would have sent the same extender requests, so
    committing argmax(score' + ext_score) here, score' recomputed on the
    live carry, IS the serial placement. The first mismatch sets a sticky
    `blocked` flag: that pod and every later pod of the wave respill.

    `ext_allowed` bool[W,N] are the nodes surviving the extender filter
    chain, `ext_score` f32[W,N] the combined extender priority x weight x
    scale (0 elsewhere), `want_commit` bool[W] the pods whose chain
    succeeded with a non-empty feasible set. No value leaves the device.
    Returns (carry, nodes i32[W] (-1 = no commit), respill bool[W],
    gpu_take i32[W,G], vg_take f32[W,V], dev_take f32[W,DV])."""
    n = ns.valid.shape[0]
    dev = ns.valid.device
    nodes_idx = torch.arange(n, device=dev)
    blocked = torch.zeros((), dtype=torch.bool, device=dev)
    outs = []
    for w in range(rows.req.shape[0]):
        pod = PodRow(*(a[w] for a in rows))
        mask, first_fail = run_filters(ns, carry, pod, filter_on, extra_filters)
        mask = mask & ns.valid
        match = (mask == expected_mask[w]).all() & (first_fail == expected_ff[w]).all()
        respill = blocked | ~match
        score = run_scores(ns, carry, pod, weights, extra_scores)
        allow = mask & ext_allowed[w]
        total = torch.where(allow, score + ext_score[w], -_INF)
        node = total.argmax()   # first max: lowest node index wins ties
        ok = want_commit[w] & ~respill & allow.any() & pod.valid
        onehot = (nodes_idx == node) & ok
        carry, gpu_take, vg_take, dev_take = commit_onehot(ns, carry, pod, onehot)
        outs.append((
            torch.where(ok, node, -1).to(torch.int32), respill,
            gpu_take.to(torch.int32), vg_take, dev_take,
        ))
        blocked = respill
    return (carry,) + tuple(torch.stack(col) for col in zip(*outs))


# ---------------------------------------------------------------------------
# Row-wise commit (the wave engine's replay)
# ---------------------------------------------------------------------------

# The carry planes one commit can change, by pod feature; a pod whose
# feature is absent leaves that part bitwise unchanged (see commit_choice).
COMMIT_PARTS = frozenset(("sel", "anti", "gpu", "storage", "ports"))


def commit_parts(rows_np: dict, i: int) -> frozenset:
    """The parts of COMMIT_PARTS pod i of a PodBatch (host numpy arrays, by
    PodRow field) can change when it commits; where each row i stacks
    several pods along a further leading axis, the parts any of them can
    change."""
    parts = set()
    if rows_np["match_sel"][i].any():
        parts.add("sel")
    if rows_np["own_anti"][i].any():
        parts.add("anti")
    if ((rows_np["gpu_mem"][i] > 0) & (rows_np["gpu_num"][i] >= 1)).any():
        parts.add("gpu")
    if (rows_np["lvm_req"][i] > 0).any() or (rows_np["dev_req"][i] > 0).any():
        parts.add("storage")
    if (rows_np["hp_pid"][i] > 0).any():
        parts.add("ports")
    return frozenset(parts)


def _local_storage_take_rows(vg_cap, vg_name, dev_cap, dev_ssd, vg_free, dev_free, pod: PodRow):
    """local_storage_eval's takes on M given node rows (each arg [M,V] or
    [M,DV]) -> (vg_take f32[M,V], dev_take f32[M,DV]). The eval is
    row-local, so these are its arithmetic with the other rows dropped."""
    V = vg_cap.shape[1]
    DV = dev_cap.shape[1]
    dev = vg_cap.device
    vcols = torch.arange(V, device=dev)
    dcols = torch.arange(DV, device=dev)
    free, vg_take = vg_free, torch.zeros_like(vg_free)
    for s in range(pod.lvm_req.shape[0]):
        req = pod.lvm_req[s]
        active = req > 0
        want = pod.lvm_vg[s]
        fits = (free + _EPS >= req) & (vg_name != 0)
        elig = torch.where(want != 0, fits & (vg_name == want), fits)
        choice = torch.where(elig, free, _INF).argmin(dim=1)
        onehot = (
            (vcols[None, :] == choice[:, None]) & elig.any(dim=1)[:, None] & active
        ).to(torch.float32)
        free = free - onehot * req
        vg_take = vg_take + onehot * req
    avail, dev_take = dev_free, torch.zeros_like(dev_free)
    for s in range(pod.dev_req.shape[0]):
        req = pod.dev_req[s]
        active = req > 0
        elig = (
            (avail > 0.5)
            & (dev_ssd == pod.dev_media_ssd[s])
            & (dev_cap + _EPS >= req)
            & (dev_cap > 0)
        )
        choice = torch.where(elig, dev_cap, _INF).argmin(dim=1)
        onehot = (
            (dcols[None, :] == choice[:, None]) & elig.any(dim=1)[:, None] & active
        ).to(torch.float32)
        avail = avail - onehot
        dev_take = dev_take + onehot
    return vg_take, dev_take


def commit_choices_lanes(
    ns: NodeStatic, carry_s: Carry, pod: PodRow, choice_s: torch.Tensor,
    parts: frozenset = COMMIT_PARTS,
):
    """commit_choice on S lanes at once: `carry_s` leaves carry a leading
    [S] axis, `choice_s` i32[S] (-1 = no commit) picks one node per lane,
    and every lane shares `ns` (the row commit reads no valid mask).

    Only the chosen row (or column) of each plane changes: gather it, apply
    commit_onehot's row arithmetic, and write it back with a one-hot
    `torch.where`, so a lane whose choice is -1 (or whose pod is a pad row)
    keeps its carry bitwise. Bit-identity to the dense commit: its
    unchosen rows add or subtract an exact +0.0 (every delta is
    nonnegative) and its chosen row sees 1.0 * delta, which is delta.

    `parts` (commit_parts) may leave out planes the pod cannot change: a
    skipped plane would only have x - 0.0 (bitwise x) or x + 0.0 written
    back on its counts, which are never -0.0 (they start at +0.0 and move
    by whole units), and its takes are +0.0 either way.

    Returns (carry_s, gpu_take f32[S,G], vg_take f32[S,V], dev_take
    f32[S,DV])."""
    n = ns.valid.shape[0]
    S = choice_s.shape[0]
    dev = choice_s.device
    ok = (choice_s >= 0) & pod.valid                                   # [S]
    row = torch.where(ok, choice_s, 0).long()
    hit = (torch.arange(n, device=dev)[None, :] == choice_s[:, None]) & ok[:, None]
    hit_row = hit[:, :, None]                                          # [S,N,1]
    hit_col = hit[:, None, :]                                          # [S,1,N]
    lanes = torch.arange(S, device=dev)

    def set_row(plane, new):            # plane [S,N,X], new [S,X]
        return torch.where(hit_row, new[:, None, :], plane)

    def col(plane):                     # plane [S,X,N] -> [S,X]
        return plane[lanes, :, row]

    def set_col(plane, new):            # plane [S,X,N], new [S,X]
        return torch.where(hit_col, new[:, :, None], plane)

    c = carry_s
    new = {"free": set_row(c.free, c.free[lanes, row] - pod.req)}
    if "sel" in parts:
        new["sel_counts"] = set_col(
            c.sel_counts, col(c.sel_counts) + pod.match_sel.to(torch.float32)
        )
    if "anti" in parts:
        new["anti_counts"] = set_col(c.anti_counts, col(c.anti_counts) + pod.own_anti)
    G = c.gpu_free.shape[2]
    if "gpu" in parts:
        free_d = c.gpu_free[lanes, row]
        take = _gpu_take(free_d, ns.gpu_total[row], pod)
        gpu_take = torch.where(ok[:, None], take, 0.0)
        new["gpu_free"] = set_row(c.gpu_free, free_d - gpu_take * pod.gpu_mem)
    else:
        gpu_take = torch.zeros((S, G), dtype=torch.float32, device=dev)
    if "storage" in parts:
        vg_row = c.vg_free[lanes, row]
        dev_row = c.dev_free[lanes, row]
        vg_t, dev_t = _local_storage_take_rows(
            ns.vg_cap[row], ns.vg_name[row], ns.dev_cap[row], ns.dev_ssd[row],
            vg_row, dev_row, pod,
        )
        vg_take = torch.where(ok[:, None], vg_t, 0.0)
        dev_take = torch.where(ok[:, None], dev_t, 0.0)
        new["vg_free"] = set_row(c.vg_free, vg_row - vg_t)
        new["dev_free"] = set_row(c.dev_free, dev_row - dev_t)
    else:
        vg_take = torch.zeros((S, c.vg_free.shape[2]), dtype=torch.float32, device=dev)
        dev_take = torch.zeros((S, c.dev_free.shape[2]), dtype=torch.float32, device=dev)
    if "ports" in parts:
        add_any, add_wild, add_ipc = port_adds(c.port_any.shape[1], c.port_ipc.shape[1], pod)
        new["port_any"] = set_col(c.port_any, col(c.port_any) + add_any)
        new["port_wild"] = set_col(c.port_wild, col(c.port_wild) + add_wild)
        new["port_ipc"] = set_col(c.port_ipc, col(c.port_ipc) + add_ipc)
    return c._replace(**new), gpu_take, vg_take, dev_take


def commit_choice(
    ns: NodeStatic, carry: Carry, pod: PodRow, choice: torch.Tensor,
    parts: frozenset = COMMIT_PARTS,
):
    """commit_onehot for a known node index (i32 scalar, -1 = no commit) in
    O(row) arithmetic: commit_choices_lanes on one lane. Returns (carry,
    gpu_take f32[G], vg_take f32[V], dev_take f32[DV])."""
    carry_s = Carry(*(a[None] for a in carry))
    new_s, gpu_take, vg_take, dev_take = commit_choices_lanes(
        ns, carry_s, pod, choice.reshape(1), parts
    )
    return Carry(*(a[0] for a in new_s)), gpu_take[0], vg_take[0], dev_take[0]
