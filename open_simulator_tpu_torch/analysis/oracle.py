"""Independent reference oracle of the Filter/Score/commit semantics.

The port's own copy of the JAX package's analysis/oracle.py (the port
imports nothing of that package); the code below is unchanged.

`simon prove` (analysis/semantics.py) diffs the real device engine against
this module over an exhaustively enumerated universe corpus, so this file is
deliberately NOT allowed to share code with ops/kernels.py: it is written
straight from the kube-scheduler contract (PAPER.md; vendored plugin sources
cited per function in ops/kernels.py) in plain numpy — no framework import, no
reuse of the device kernels' helpers. Constants that both sides must agree
on (filter indices, weight fold order, the f32 comparison slack) are
REDECLARED here; tests/test_torch_prove.py cross-checks them against
the port's ops/kernels.py so a drift on either side trips the suite, not the
prover.

Scope: the small-scope universe family (docs/static-analysis.md). Features
whose carry machinery the enumerator never exercises — active topology
spread constraints, active inter-pod (anti)affinity terms, local-storage
volumes, out-of-tree extra plugins — raise OracleUnsupported instead of
guessing: an oracle that silently approximates is worse than none.

Float discipline: every arithmetic step mirrors the device kernel's exact
f32 expression structure (same guards, same fold order, same floor/clip
placement), because the contract being proven is bit-level placement
equality, and f32 addition is not associative.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# --- the shared contract constants, redeclared (see module docstring) ------

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
F_EXTRA = 10
NUM_FILTERS = 11

#: resource axis position of the whole-GPU extended resource
GPU_COUNT_IDX = 3

#: label-selector operator encoding (ops/encode.py vocabulary)
OP_PAD = 0
OP_IN = 1
OP_NOT_IN = 2
OP_EXISTS = 3
OP_NOT_EXISTS = 4
OP_GT = 5
OP_LT = 6

#: absolute f32 comparison slack (milli-cpu / MiB units)
EPS = np.float32(1e-3)

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

#: the canonical score fold order: alphabetical over the node-local plugins,
#: then the two carry-coupled plugins last (the commit-order contract's
#: fold-order clause; ops/kernels.py WEIGHT_ORDER)
WEIGHT_ORDER = tuple(
    sorted(k for k in DEFAULT_WEIGHTS
           if k not in ("inter_pod_affinity", "topology_spread"))
) + ("inter_pod_affinity", "topology_spread")


class OracleUnsupported(ValueError):
    """The universe exercises semantics outside the oracle's small-scope
    family (spread/inter-pod-affinity/local-storage/extra plugins)."""


f32 = np.float32


def _asf32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# Carry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OracleCarry:
    """Mutable cluster state, mirroring ops/kernels.Carry plane by plane."""
    free: np.ndarray         # f32[N,R]
    sel_counts: np.ndarray   # f32[S,N]
    gpu_free: np.ndarray     # f32[N,G]
    vg_free: np.ndarray      # f32[N,V]
    dev_free: np.ndarray     # f32[N,DV]
    port_any: np.ndarray     # f32[PID,N]
    port_wild: np.ndarray    # f32[PID,N]
    port_ipc: np.ndarray     # f32[PIP,N]
    anti_counts: np.ndarray  # f32[AT,N]

    def copy(self) -> "OracleCarry":
        return OracleCarry(**{
            f.name: getattr(self, f.name).copy()
            for f in dataclasses.fields(self)
        })

    def planes(self) -> Dict[str, np.ndarray]:
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        }


def carry_from_table(
    table,
    num_selectors: int = 1,
    port_rows: int = 2,
    port_ip_rows: int = 2,
    anti_rows: int = 2,
) -> OracleCarry:
    """Fresh carry for an encoded NodeTable (ops/state.carry_from_table
    defaults: zero selector/port/anti planes, free planes from the table)."""
    n = table.free.shape[0]
    sel_rows = max(int(num_selectors), 1)
    sel_rows += (-sel_rows) % 8  # selector_table_size bucketing
    return OracleCarry(
        free=_asf32(table.free).copy(),
        sel_counts=np.zeros((sel_rows, n), np.float32),
        gpu_free=_asf32(table.gpu_free).copy(),
        vg_free=_asf32(table.vg_free).copy(),
        dev_free=_asf32(table.dev_free).copy(),
        port_any=np.zeros((port_rows, n), np.float32),
        port_wild=np.zeros((port_rows, n), np.float32),
        port_ipc=np.zeros((port_ip_rows, n), np.float32),
        anti_counts=np.zeros((anti_rows, n), np.float32),
    )


# ---------------------------------------------------------------------------
# Per-pod view + family guard
# ---------------------------------------------------------------------------

class _Pod:
    """Row p of a PodBatch-shaped SoA (duck-typed: any object with the
    PodBatch field names works)."""

    def __init__(self, batch, p: int) -> None:
        self._b = batch
        self._p = p

    def __getattr__(self, name):
        return np.asarray(getattr(self._b, name))[self._p]


def _check_supported(batch) -> None:
    b = batch
    if np.any(np.asarray(b.spread_topo) >= 0):
        raise OracleUnsupported("active topology spread constraints")
    if np.any(np.asarray(b.aff_topo) >= 0):
        raise OracleUnsupported("active inter-pod (anti)affinity terms")
    if np.any(np.asarray(b.has_local)):
        raise OracleUnsupported("local-storage volumes")
    if np.any(np.asarray(b.match_anti)) or np.any(np.asarray(b.own_anti)):
        raise OracleUnsupported("required-anti-affinity symmetry terms")


# ---------------------------------------------------------------------------
# Filters (kube filter plugin order; each mirrors its device kernel)
# ---------------------------------------------------------------------------

def _expr_matches(table, op, key, val, num) -> np.ndarray:
    label_key = np.asarray(table.label_key)
    label_pair = np.asarray(table.label_pair)
    label_num = _asf32(table.label_num)
    has_key = np.any((label_key == key) & (key != 0), axis=1)
    pair_hit = np.any(
        (label_pair[:, :, None] == val[None, None, :])
        & (val != 0)[None, None, :],
        axis=(1, 2),
    )
    key_rows = label_key == key
    with np.errstate(invalid="ignore"):
        gt = np.any(key_rows & (label_num > num), axis=1)
        lt = np.any(key_rows & (label_num < num), axis=1)
    ones = np.ones_like(has_key)
    branches = {
        OP_IN: pair_hit, OP_NOT_IN: ~pair_hit, OP_EXISTS: has_key,
        OP_NOT_EXISTS: ~has_key, OP_GT: gt, OP_LT: lt,
    }
    return branches.get(int(op), ones)


def _term_matches(table, ops, keys, vals, nums) -> np.ndarray:
    n = np.asarray(table.valid).shape[0]
    non_empty = bool(np.any(np.asarray(ops) != OP_PAD))
    if not non_empty:  # pad term: matches nothing (and skips the expr work)
        return np.zeros(n, bool)
    per_expr = np.stack(
        [
            _expr_matches(table, ops[e], keys[e], vals[e], nums[e])
            for e in range(len(ops))
        ],
        axis=1,
    ) if len(ops) else np.ones((n, 0), bool)
    return np.all(per_expr, axis=1)


def node_affinity_mask(table, pod: _Pod) -> np.ndarray:
    wanted = np.asarray(pod.ns_pair)
    label_pair = np.asarray(table.label_pair)
    present = np.any(
        label_pair[:, :, None] == wanted[None, None, :], axis=1
    )
    ns_ok = np.all(present | (wanted == 0)[None, :], axis=1)
    sel_op = np.asarray(pod.sel_op)
    term_hits = np.stack(
        [
            _term_matches(
                table, sel_op[t], np.asarray(pod.sel_key)[t],
                np.asarray(pod.sel_val)[t], _asf32(pod.sel_num)[t],
            )
            for t in range(sel_op.shape[0])
        ],
        axis=1,
    ) if sel_op.shape[0] else np.zeros((ns_ok.shape[0], 0), bool)
    terms_ok = np.any(term_hits, axis=1) | (not bool(pod.has_terms))
    return ns_ok & terms_ok


def _tolerated(table, pod: _Pod) -> np.ndarray:
    """tolerated[n, t]: taint t of node n is tolerated by the pod."""
    tk = np.asarray(table.taint_key)
    tv = np.asarray(table.taint_val)
    te = np.asarray(table.taint_effect)
    tol_key = np.asarray(pod.tol_key)[None, None, :]
    tol_val = np.asarray(pod.tol_val)[None, None, :]
    tol_exists = np.asarray(pod.tol_exists)[None, None, :]
    tol_effect = np.asarray(pod.tol_effect)[None, None, :]
    tol_valid = np.asarray(pod.tol_valid)[None, None, :]
    eff_ok = (tol_effect == 0) | (tol_effect == te[:, :, None])
    key_ok = (tol_key == 0) | (tol_key == tk[:, :, None])
    val_ok = tol_exists | (tol_val == tv[:, :, None])
    return np.any(tol_valid & eff_ok & key_ok & val_ok, axis=2)


def taint_mask(table, pod: _Pod) -> np.ndarray:
    te = np.asarray(table.taint_effect)
    hard = (te == 1) | (te == 3)  # NoSchedule / NoExecute
    return np.all(_tolerated(table, pod) | ~hard, axis=1)


def ports_mask(carry: OracleCarry, pod: _Pod) -> np.ndarray:
    hp_pid = np.asarray(pod.hp_pid)
    hp_wild = np.asarray(pod.hp_wild)
    hp_ipid = np.asarray(pod.hp_ipid)
    any_tbl = carry.port_any[hp_pid]
    wild_tbl = carry.port_wild[hp_pid]
    ip_tbl = carry.port_ipc[hp_ipid]
    conf_wild = any_tbl > 0.0
    conf_spec = (wild_tbl > 0.0) | (ip_tbl > 0.0)
    conf = np.where(hp_wild[:, None], conf_wild, conf_spec)
    conf = conf & (hp_pid > 0)[:, None]
    return ~np.any(conf, axis=0)


def allocatable_gpus(table, carry: OracleCarry) -> np.ndarray:
    usable = (carry.gpu_free > EPS) & (_asf32(table.gpu_total) > 0)
    return np.sum(usable.astype(np.float32), axis=1)


def resource_fail(table, carry: OracleCarry, pod: _Pod) -> np.ndarray:
    req = _asf32(pod.req)
    alloc = _asf32(table.alloc)
    static_fail = np.any(req[None, :] > carry.free + EPS, axis=1)
    whole_req = req[GPU_COUNT_IDX]
    whole_used = alloc[:, GPU_COUNT_IDX] - carry.free[:, GPU_COUNT_IDX]
    whole_fail = whole_req > allocatable_gpus(table, carry) - whole_used + EPS
    return static_fail | whole_fail


def gpu_mask(table, carry: OracleCarry, pod: _Pod) -> np.ndarray:
    mem = f32(pod.gpu_mem)
    num = f32(pod.gpu_num)
    is_gpu = mem > 0
    caps = np.where(
        _asf32(table.gpu_total) > 0,
        np.floor((carry.gpu_free + EPS) / max(mem, f32(1e-9))),
        f32(0.0),
    )
    feasible = (num >= 1) & (np.sum(caps, axis=1) >= num)
    return feasible if is_gpu else np.ones_like(feasible)


def run_filters(table, carry: OracleCarry, pod: _Pod):
    """-> (mask bool[N], first_fail i32[N]); first_fail = NUM_FILTERS when
    feasible, else the index of the first failing filter (kube stops the
    node's filter chain at the first failure)."""
    tol_key = np.asarray(pod.tol_key)
    tol_val = np.asarray(pod.tol_val)
    tol_exists = np.asarray(pod.tol_exists)
    tol_effect = np.asarray(pod.tol_effect)
    tol_valid = np.asarray(pod.tol_valid)
    unsched_key = int(table.unsched_key_id)
    empty_val = int(table.empty_val_id)
    unsched_tolerated = bool(np.any(
        tol_valid
        & ((tol_key == 0) | (tol_key == unsched_key))
        & (tol_exists | (tol_val == empty_val))
        & ((tol_effect == 0) | (tol_effect == 1))
    ))
    na_ok = node_affinity_mask(table, pod)
    valid = np.asarray(table.valid)
    n = valid.shape[0]
    name_id = np.asarray(table.name_id)
    pod_name_id = int(pod.node_name_id)
    fails = np.stack(
        [
            np.asarray(table.unsched).astype(bool) & (not unsched_tolerated),
            (pod_name_id != 0) & (name_id != pod_name_id),
            ~taint_mask(table, pod),
            ~na_ok,
            ~ports_mask(carry, pod),
            resource_fail(table, carry, pod),
            np.zeros(n, bool),  # F_SPREAD: family has no constraints
            np.zeros(n, bool),  # F_POD_AFFINITY: family has no terms
            np.zeros(n, bool),  # F_STORAGE: family has no volumes
            ~gpu_mask(table, carry, pod),
            np.zeros(n, bool),  # F_EXTRA: no out-of-tree plugins
        ],
        axis=1,
    )
    mask = ~np.any(fails, axis=1) & valid
    first_fail = np.where(
        np.any(fails, axis=1), np.argmax(fails, axis=1), NUM_FILTERS
    ).astype(np.int32)
    return mask, first_fail


# ---------------------------------------------------------------------------
# Score plugins
# ---------------------------------------------------------------------------

def _minmax_normalize(score: np.ndarray, valid: np.ndarray) -> np.ndarray:
    lo = np.min(np.where(valid, score, np.float32(np.inf)))
    hi = np.max(np.where(valid, score, np.float32(-np.inf)))
    rng = f32(hi - lo)
    out = np.where(
        rng > 0,
        (score - lo) * f32(100.0) / np.maximum(rng, f32(1e-9)),
        f32(0.0),
    )
    return np.clip(out, f32(0.0), f32(100.0))


def score_least_allocated(table, carry, pod: _Pod) -> np.ndarray:
    alloc = _asf32(table.alloc)[:, :2]
    free_after = carry.free[:, :2] - _asf32(pod.req)[None, :2]
    frac = np.where(
        alloc > 0, free_after / np.maximum(alloc, f32(1e-9)), f32(0.0)
    )
    return np.clip(np.mean(frac, axis=1, dtype=np.float32),
                   f32(0.0), f32(1.0)) * f32(100.0)


def score_balanced(table, carry, pod: _Pod) -> np.ndarray:
    alloc = _asf32(table.alloc)[:, :2]
    used_after = alloc - carry.free[:, :2] + _asf32(pod.req)[None, :2]
    frac = np.where(
        alloc > 0, used_after / np.maximum(alloc, f32(1e-9)), f32(0.0)
    )
    frac = np.clip(frac, f32(0.0), f32(1.0))
    return (f32(1.0) - np.abs(frac[:, 0] - frac[:, 1])) * f32(100.0)


def _worst_fit_share(alloc: np.ndarray, req: np.ndarray) -> np.ndarray:
    """share(req, alloc-req) saturated to 1 on negative headroom -> f32[N]."""
    avail = alloc - req[None, :]
    denom = np.where(avail == 0, f32(1.0), avail)
    share = np.where(
        req[None, :] == 0,
        f32(0.0),
        np.where(avail == 0, f32(1.0), req[None, :] / denom),
    )
    share = np.where(avail < 0, f32(1.0), share)
    return np.max(share, axis=1)


def score_simon(table, carry, pod: _Pod) -> np.ndarray:
    raw = np.floor(
        _worst_fit_share(_asf32(table.alloc), _asf32(pod.req)) * f32(100.0)
    )
    raw = np.where(bool(pod.has_req), raw, f32(100.0))
    return _minmax_normalize(raw, np.asarray(table.valid))


def score_gpu_share(table, carry: OracleCarry, pod: _Pod) -> np.ndarray:
    alloc = _asf32(table.alloc).copy()
    alloc[:, GPU_COUNT_IDX] = allocatable_gpus(table, carry)
    raw = _worst_fit_share(alloc, _asf32(pod.req)) * f32(100.0)
    raw = np.where(bool(pod.has_req), raw, f32(100.0))
    return _minmax_normalize(raw, np.asarray(table.valid))


def score_taint_toleration(table, pod: _Pod) -> np.ndarray:
    te = np.asarray(table.taint_effect)
    valid = np.asarray(table.valid)
    intolerable = (te == 2) & ~_tolerated(table, pod)  # PreferNoSchedule
    cnt = np.sum(intolerable.astype(np.float32), axis=1)
    max_cnt = np.max(np.where(valid, cnt, f32(0.0)))
    return np.clip(
        np.where(
            max_cnt > 0,
            (max_cnt - cnt) * f32(100.0) / np.maximum(max_cnt, f32(1e-9)),
            f32(100.0),
        ),
        f32(0.0), f32(100.0),
    )


def score_node_affinity(table, pod: _Pod) -> np.ndarray:
    valid = np.asarray(table.valid)
    pref_op = np.asarray(pod.pref_op)
    hits = np.stack(
        [
            _term_matches(
                table, pref_op[t], np.asarray(pod.pref_key)[t],
                np.asarray(pod.pref_val)[t], _asf32(pod.pref_num)[t],
            )
            for t in range(pref_op.shape[0])
        ],
        axis=1,
    ) if pref_op.shape[0] else np.zeros((valid.shape[0], 0), bool)
    raw = np.sum(
        hits * _asf32(pod.pref_weight)[None, :], axis=1, dtype=np.float32
    )
    mx = np.max(np.where(valid, raw, f32(0.0)))
    return np.clip(
        np.where(
            mx > 0, raw * f32(100.0) / np.maximum(mx, f32(1e-9)), f32(0.0)
        ),
        f32(0.0), f32(100.0),
    )


def score_prefer_avoid(table, pod: _Pod) -> np.ndarray:
    avoided = np.asarray(table.avoid_pods) & bool(pod.owned_by_rs)
    return np.where(avoided, f32(0.0), f32(100.0))


def run_scores(table, carry: OracleCarry, pod: _Pod,
               weights: Dict[str, float]) -> np.ndarray:
    n = np.asarray(table.valid).shape[0]
    by_name = {
        "balanced_allocation": score_balanced(table, carry, pod),
        "least_allocated": score_least_allocated(table, carry, pod),
        "node_affinity": score_node_affinity(table, pod),
        "taint_toleration": score_taint_toleration(table, pod),
        # family-inactive plugins, at their inactive-path values:
        # spread reverse-normalizes an all-zero count sum to 100,
        # inter-pod affinity gates its normalize on any active term (0),
        # open-local scores storageless pods 0 everywhere
        "topology_spread": np.full(n, f32(100.0)),
        "inter_pod_affinity": np.zeros(n, np.float32),
        "prefer_avoid_pods": score_prefer_avoid(table, pod),
        "simon": score_simon(table, carry, pod),
        "gpu_share": score_gpu_share(table, carry, pod),
        "open_local": np.zeros(n, np.float32),
    }
    total = None
    for name in WEIGHT_ORDER:  # the explicit left fold of the contract
        term = f32(weights.get(name, 0.0)) * by_name[name]
        total = term if total is None else total + term
    return total


# ---------------------------------------------------------------------------
# Commit
# ---------------------------------------------------------------------------

def gpu_allocate(table, carry: OracleCarry, pod: _Pod,
                 node: int) -> np.ndarray:
    """Device shares taken on `node` -> f32[G] (tightest-fit for a single
    share, lowest-id-first two-pointer greedy for multi-share)."""
    mem = f32(pod.gpu_mem)
    num = f32(pod.gpu_num)
    free_d = carry.gpu_free[node]
    total_d = _asf32(table.gpu_total)[node]
    g = free_d.shape[0]

    elig = (total_d > 0) & (free_d >= mem - EPS)
    tight = int(np.argmin(np.where(elig, free_d, np.float32(np.inf))))
    take_single = (
        (np.arange(g) == tight) & np.any(elig)
    ).astype(np.float32)

    caps = np.where(
        total_d > 0,
        np.floor((free_d + EPS) / np.maximum(mem, f32(1e-9))),
        f32(0.0),
    )
    prefix = np.cumsum(caps, dtype=np.float32) - caps
    take_multi = np.clip(num - prefix, f32(0.0), caps)
    if not np.sum(caps) >= num:
        take_multi = np.zeros_like(take_multi)

    take = take_single if num == 1 else take_multi
    if not (mem > 0 and num >= 1):
        take = np.zeros_like(take)
    return take


def commit(table, carry: OracleCarry, pod: _Pod, node: int) -> np.ndarray:
    """Mutate `carry` for a placement of `pod` on `node` -> gpu take f32[G]."""
    carry.free[node] -= _asf32(pod.req)
    carry.sel_counts[:, node] += np.asarray(pod.match_sel).astype(np.float32)
    take = gpu_allocate(table, carry, pod, node)
    carry.gpu_free[node] -= take * f32(pod.gpu_mem)
    hp_pid = np.asarray(pod.hp_pid)
    hp_wild = np.asarray(pod.hp_wild)
    hp_ipid = np.asarray(pod.hp_ipid)
    for s in range(hp_pid.shape[0]):
        pid = int(hp_pid[s])
        if pid <= 0:
            continue
        carry.port_any[pid, node] += f32(1.0)
        if bool(hp_wild[s]):
            carry.port_wild[pid, node] += f32(1.0)
        elif int(hp_ipid[s]) > 0:
            carry.port_ipc[int(hp_ipid[s]), node] += f32(1.0)
    return take


# ---------------------------------------------------------------------------
# The sequential schedule loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OracleResult:
    nodes: np.ndarray     # i32[P] chosen node index or -1
    reasons: np.ndarray   # i32[P,NUM_FILTERS] unschedulable reason counts
    gpu_take: np.ndarray  # i32[P,G]
    carry: OracleCarry    # final carry
    scores: np.ndarray    # f32[P,N] post-mask scores (debugging aid)


def schedule(table, batch, weights: Optional[Dict[str, float]] = None
             ) -> OracleResult:
    """Sequentially filter/score/commit every row of `batch` against `table`
    — the reference semantics `simon prove` holds the device engine to."""
    _check_supported(batch)
    weights = DEFAULT_WEIGHTS if weights is None else weights
    carry = carry_from_table(
        table,
        num_selectors=np.asarray(batch.match_sel).shape[1],
        port_rows=2, port_ip_rows=2,
        anti_rows=np.asarray(batch.own_anti).shape[1],
    )
    p = np.asarray(batch.valid).shape[0]
    n = np.asarray(table.valid).shape[0]
    g = carry.gpu_free.shape[1]
    valid_nodes = np.asarray(table.valid)

    nodes = np.full(p, -1, np.int32)
    reasons = np.zeros((p, NUM_FILTERS), np.int32)
    takes = np.zeros((p, g), np.int32)
    scores = np.full((p, n), -np.inf, np.float32)

    for i in range(p):
        pod = _Pod(batch, i)
        mask, first_fail = run_filters(table, carry, pod)
        score = run_scores(table, carry, pod, weights)
        score = np.where(mask, score, np.float32(-np.inf))
        node = int(np.argmax(score))  # first max: lowest index wins ties
        ok = bool(np.any(mask)) and bool(pod.valid)
        scores[i] = score
        if ok:
            nodes[i] = node
            takes[i] = commit(table, carry, pod, node).astype(np.int32)
        else:
            failed = (first_fail < NUM_FILTERS) & valid_nodes
            np.add.at(
                reasons[i], np.clip(first_fail, 0, NUM_FILTERS - 1),
                failed.astype(np.int32),
            )
    return OracleResult(
        nodes=nodes, reasons=reasons, gpu_take=takes,
        carry=carry, scores=scores,
    )
