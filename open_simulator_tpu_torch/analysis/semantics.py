"""`simon prove`: exhaustive small-scope semantics checking on the device.

The port of the JAX package's analysis/semantics.py. Small-scope
verification: enumerate EVERY scheduling universe in a bounded family
(<= 4 nodes x <= 5 pods drawn from a quantized catalog), run the port's
engine over all of them, and diff every placement, reason code, GPU
assignment and final carry against the independent pure-numpy oracle
(analysis/oracle.py, the port's own copy). The family exercises
feasibility edges, score ties across equal nodes, selector mismatches,
unschedulable nodes, shared-GPU packing, priority-driven commit order and
carry mutation chains.

Universes are packed onto the lane axis by STAMPED GATHER: the catalog (4
node configs, 3 pod configs) is encoded once, and every stacked [S, ...]
input tensor is assembled by numpy fancy-indexing of catalog rows, so the
whole 151,875-universe corpus runs through `ops.fast.schedule_universes`
(or the wave engine, `ops.fast.schedule_universes_wave_host`) in six
identically shaped vmapped calls on the call's torch device.

The run verifies the canonical commit-order contract
(budgets/commit_contract.json): a digest over the canonicalized placements
of the whole corpus plus a machine-readable statement of the ordering
rules. The JAX package banked it; the port must reproduce it bit for bit
with both engines. The payload's `entry` names the banked contract's
engine and is compared verbatim.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import time
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DEFAULT_DEVICE
from . import oracle as oracle_mod

#: default contract artifact location (relative to the repo root)
CONTRACT_PATH = os.path.join("budgets", "commit_contract.json")

#: universes per device call (multiple of 8; every chunk pads to this exact
#: shape, six calls for the whole corpus)
DEFAULT_CHUNK = 25608

#: recognized commit-rule mutations (seeded fault injection: `simon prove
#: --mutate <mode>` must exit nonzero with a minimized counterexample)
MUTATIONS = ("tiebreak", "nocommit")

_GI = 1 << 30


# ---------------------------------------------------------------------------
# The quantized catalog
# ---------------------------------------------------------------------------

def _node_dict(name, cpu, mem, labels=None, anno=None, unschedulable=False,
               capacity_extra=None):
    res = {"cpu": cpu, "memory": mem, "pods": "110"}
    if capacity_extra:
        res.update(capacity_extra)
    d = {
        "metadata": {
            "name": name,
            "labels": {"kubernetes.io/hostname": name, **(labels or {})},
            "annotations": dict(anno or {}),
        },
        "status": {"allocatable": dict(res), "capacity": dict(res)},
    }
    if unschedulable:
        d["spec"] = {"unschedulable": True}
    return d


def _pod_dict(name, cpu, mem, priority=0, node_selector=None, anno=None,
              owner_kind=None):
    meta = {
        "name": name,
        "namespace": "prove",
        "annotations": dict(anno or {}),
    }
    if owner_kind:
        meta["ownerReferences"] = [{"kind": owner_kind, "name": "rs-" + name}]
    spec = {
        "containers": [
            {"name": "c", "image": "img",
             "resources": {"requests": {"cpu": cpu, "memory": mem}}}
        ],
        "priority": priority,
    }
    if node_selector:
        spec["nodeSelector"] = dict(node_selector)
    return {"metadata": meta, "spec": spec}


class SmallScope:
    """The bounded universe family: catalog + encoded tables + packers.

    Node options (4 slots each drawing from):
      A: 4 cpu / 8Gi, tier=a                    — the roomy default
      B: 2 cpu / 4Gi, tier=b                    — the tight node
      C: 4 cpu / 8Gi, tier=a, 2x8Gi GPUs,
         preferAvoidPods annotation             — GPU + avoid-pods scoring
      D: 2 cpu / 8Gi, tier=b, unschedulable     — cordoned
      -: absent (pad row; clusters of 0..4 nodes)

    Pod options (5 slots each drawing from):
      p: 1 cpu / 2Gi, ReplicaSet-owned, prio 0  — prefer-avoid sensitive
      q: 2 cpu / 2Gi, nodeSelector tier=a, prio 10
      r: 500m / 1Gi + 1 GPU share of 4Gi, prio 5

    Every (node, pod) slot assignment is one universe: 5^4 * 3^5 = 151,875
    distinct universes, all sharing one (N=8, P=8) padded shape bucket.
    The catalog is encoded on the host; tensors reach a device only in
    `_pack_chunk`.
    """

    NODE_OPTIONS = ("A", "B", "C", "D", "-")
    POD_OPTIONS = ("p", "q", "r")
    NODE_SLOTS = 4
    POD_SLOTS = 5
    N_PAD = 8
    P_PAD = 8

    def __init__(self) -> None:
        from ..core.objects import (
            ANNO_GPU_COUNT_POD,
            ANNO_GPU_MEM_POD,
            Node,
            Pod,
        )
        from ..ops import encode

        avoid = {
            "scheduler.alpha.kubernetes.io/preferAvoidPods": json.dumps(
                {"preferAvoidPods": [{"podSignature": {}}]}
            )
        }
        gpu_cap = {
            "alibabacloud.com/gpu-count": "2",
            ANNO_GPU_MEM_POD: str(16 * _GI),
        }
        self.node_dicts = {
            "A": _node_dict("prove-a", "4", "8Gi", labels={"tier": "a"}),
            "B": _node_dict("prove-b", "2", "4Gi", labels={"tier": "b"}),
            "C": _node_dict("prove-c", "4", "8Gi", labels={"tier": "a"},
                            anno=avoid, capacity_extra=gpu_cap),
            "D": _node_dict("prove-d", "2", "8Gi", labels={"tier": "b"},
                            unschedulable=True),
        }
        self.pod_dicts = {
            "p": _pod_dict("prove-p", "1", "2Gi", priority=0,
                           owner_kind="ReplicaSet"),
            "q": _pod_dict("prove-q", "2", "2Gi", priority=10,
                           node_selector={"tier": "a"}),
            "r": _pod_dict("prove-r", "500m", "1Gi", priority=5,
                           anno={ANNO_GPU_MEM_POD: str(4 * _GI),
                                 ANNO_GPU_COUNT_POD: "1"}),
        }
        self.pod_priority = {
            k: int(d["spec"]["priority"]) for k, d in self.pod_dicts.items()
        }

        self.enc = encode.Encoder()
        node_objs = [Node.from_dict(self.node_dicts[k]) for k in "ABCD"]
        pod_objs = [Pod.from_dict(self.pod_dicts[k]) for k in "pqr"]
        self.table = encode.encode_nodes(
            self.enc, node_objs, n_pad=self.N_PAD
        )
        self.batch = encode.encode_pods(self.enc, pod_objs, p_pad=self.P_PAD)
        #: catalog row index per node option ('-' maps to a pad row)
        self.node_row = {"A": 0, "B": 1, "C": 2, "D": 3, "-": 4}
        #: catalog row index per pod option
        self.pod_row = {"p": 0, "q": 1, "r": 2}
        self._np_cache: Optional[Tuple] = None

    # -- universe enumeration ----------------------------------------------

    def universes(self) -> List["Universe"]:
        """The full corpus, in canonical enumeration order."""
        return [
            Universe(nodes="".join(nc), pods="".join(pc))
            for nc in itertools.product(self.NODE_OPTIONS,
                                        repeat=self.NODE_SLOTS)
            for pc in itertools.product(self.POD_OPTIONS,
                                        repeat=self.POD_SLOTS)
        ]

    def corpus_size(self) -> int:
        return (len(self.NODE_OPTIONS) ** self.NODE_SLOTS
                * len(self.POD_OPTIONS) ** self.POD_SLOTS)

    # -- index rows ---------------------------------------------------------

    def node_rows(self, u: "Universe") -> List[int]:
        """Catalog row per packed node lane (pad lanes fill with distinct
        pad rows so every universe table is a plain row gather)."""
        rows = [self.node_row[c] for c in u.nodes]
        rows += list(range(len(rows), self.N_PAD))
        # '-' slots share pad row 4 with the first filler; harmless (both
        # are all-zero invalid rows) but keep indices in range
        return rows

    def pod_rows(self, u: "Universe") -> List[int]:
        """Catalog row per packed pod lane, in COMMIT ORDER: descending
        priority, ties broken by slot index (stable) — the harness side of
        the commit-order contract's pod-presentation clause."""
        ordered = sorted(
            range(len(u.pods)),
            key=lambda i: (-self.pod_priority[u.pods[i]], i),
        )
        rows = [self.pod_row[u.pods[i]] for i in ordered]
        n_pad_rows = self.P_PAD - len(self.POD_OPTIONS)
        rows += [len(self.POD_OPTIONS) + (i % n_pad_rows)
                 for i in range(self.P_PAD - len(rows))]
        return rows

    # -- oracle-side views --------------------------------------------------

    def oracle_table(self, u: "Universe") -> SimpleNamespace:
        idx = np.asarray(self.node_rows(u))
        t = self.table
        return SimpleNamespace(
            alloc=t.alloc[idx], free=t.free[idx],
            label_pair=t.label_pair[idx], label_key=t.label_key[idx],
            label_num=t.label_num[idx],
            taint_key=t.taint_key[idx], taint_val=t.taint_val[idx],
            taint_effect=t.taint_effect[idx],
            name_id=t.name_id[idx], unsched=t.unsched[idx],
            avoid_pods=t.avoid_pods[idx], valid=t.valid[idx],
            gpu_total=t.gpu_total[idx], gpu_free=t.gpu_free[idx],
            vg_free=t.vg_free[idx], dev_free=t.dev_free[idx],
            unsched_key_id=self.enc.unsched_key_id,
            empty_val_id=self.enc.empty_val_id,
        )

    def oracle_batch(self, u: "Universe") -> SimpleNamespace:
        from ..ops.kernels import PodRow

        idx = np.asarray(self.pod_rows(u))
        b = self.batch
        return SimpleNamespace(
            **{f: np.asarray(getattr(b, f))[idx] for f in PodRow._fields}
        )

    # -- device-side catalog leaves ----------------------------------------

    def _np_leaves(self):
        """(ns leaves dict, carry leaves dict, pod leaves dict, weights) —
        the encoded catalog as host numpy, gathered per chunk."""
        if self._np_cache is not None:
            return self._np_cache
        from ..ops import kernels, state as state_mod

        ns = state_mod.node_static_from_table(self.enc, self.table, device="cpu")
        carry = state_mod.carry_from_table(self.table, device="cpu")
        rows = state_mod.pod_rows_from_batch(self.batch, device="cpu")
        ns_np = {f: v.numpy() for f, v in zip(ns._fields, ns)}
        carry_np = {f: v.numpy() for f, v in zip(carry._fields, carry)}
        pod_np = {f: v.numpy() for f, v in zip(rows._fields, rows)}
        weights = kernels.weights_array(device="cpu").numpy()
        self._np_cache = (ns_np, carry_np, pod_np, weights)
        return self._np_cache


@dataclasses.dataclass(frozen=True, order=True)
class Universe:
    """One point of the small-scope family: a node-slot string over
    SmallScope.NODE_OPTIONS and a pod-slot string over POD_OPTIONS."""
    nodes: str
    pods: str

    @property
    def key(self) -> str:
        return f"{self.nodes}/{self.pods}"


# ---------------------------------------------------------------------------
# Stamped-gather packing (host numpy -> stacked [S, ...] device inputs)
# ---------------------------------------------------------------------------

#: NodeStatic leaf -> node-axis position (None = no node axis: broadcast;
#: "scalar" = 0-d leaf widened to [S]). Explicit by name: axis detection by
#: dim == N would mis-stamp square leaves like sel_counts.
_NS_AXIS = {
    "alloc": 0, "label_pair": 0, "label_key": 0, "label_num": 0,
    "taint_key": 0, "taint_val": 0, "taint_effect": 0, "name_id": 0,
    "unsched": 0, "avoid_pods": 0, "topo": 0, "valid": 0, "gpu_total": 0,
    "vg_cap": 0, "vg_name": 0, "dev_cap": 0, "dev_ssd": 0,
    "has_storage": 0,
    "domain_key": None, "topo_onehot": 2,
    "unsched_key_id": "scalar", "empty_val_id": "scalar",
    "anti_topo": None,
}

#: Carry leaf -> node-axis position
_CARRY_AXIS = {
    "free": 0, "sel_counts": 1, "gpu_free": 0, "vg_free": 0, "dev_free": 0,
    "port_any": 1, "port_wild": 1, "port_ipc": 1, "anti_counts": 1,
}


def _gather(leaves: Dict[str, np.ndarray], axes: Dict[str, object],
            idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Stamp a chunk: idx i32[S, lanes] catalog-row matrix -> stacked leaves
    {name: [S, ...]} with the indexed axis replaced by the lane axis."""
    s = idx.shape[0]
    out: Dict[str, np.ndarray] = {}
    for name, a in leaves.items():
        ax = axes[name]
        if ax == "scalar":
            out[name] = np.broadcast_to(np.asarray(a), (s,))
        elif ax is None:
            out[name] = np.broadcast_to(a[None], (s,) + a.shape)
        elif ax == 0:
            out[name] = a[idx]
        else:
            taken = np.take(a, idx, axis=ax)      # [..., S, lanes, ...]
            out[name] = np.moveaxis(taken, ax, 0)  # [S, ..., lanes, ...]
    return out


def _pack_chunk(scope: SmallScope, chunk: Sequence[Universe], s_pad: int, device):
    """Stacked (NodeStatic, Carry, PodRow, weights) tensors on `device` for
    one chunk; pad lanes replay universe 0 (results discarded)."""
    import torch

    from ..ops.kernels import Carry, NodeStatic, PodRow

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ns_np, carry_np, pod_np, weights = scope._np_leaves()
    ni = np.asarray(
        [scope.node_rows(u) for u in chunk]
        + [scope.node_rows(chunk[0])] * (s_pad - len(chunk))
    )
    pi = np.asarray(
        [scope.pod_rows(u) for u in chunk]
        + [scope.pod_rows(chunk[0])] * (s_pad - len(chunk))
    )
    ns_s = NodeStatic(**{k: put(v) for k, v in _gather(ns_np, _NS_AXIS, ni).items()})
    carry_s = Carry(**{k: put(v) for k, v in _gather(carry_np, _CARRY_AXIS, ni).items()})
    pods_s = PodRow(**{
        k: put(v) for k, v in _gather(pod_np, {f: 0 for f in pod_np}, pi).items()
    })
    weights_s = put(np.broadcast_to(weights[None], (s_pad,) + weights.shape))
    return ns_s, carry_s, pods_s, weights_s


# ---------------------------------------------------------------------------
# Seeded commit-rule mutations (fault injection for the checker itself)
# ---------------------------------------------------------------------------

def _mutated_engine(mode: str):
    """A deliberately wrong variant of schedule_universes: `tiebreak`
    breaks score ties to the HIGHEST node index, `nocommit` never threads
    the commit into the carry. Written against schedule_step's expressions;
    used by tests and `--mutate` to prove the checker detects commit-rule
    drift."""
    import torch

    from ..ops import kernels

    if mode not in MUTATIONS:
        raise ValueError(f"unknown mutation {mode!r}; known: {MUTATIONS}")

    def one(ns, weights, c, pod):
        if mode == "nocommit":
            _, outs = kernels.schedule_step(
                ns, weights, c, pod, None, (), (), kernels.pod_keys(ns, pod)
            )
            return c, outs
        mask, first_fail = kernels.run_filters(ns, c, pod)
        score = torch.where(mask, kernels.run_scores(ns, c, pod, weights), float("-inf"))
        n = score.shape[0]
        node = (n - 1) - score.flip(0).argmax()   # highest index
        ok = mask.any() & pod.valid
        onehot = (torch.arange(n, device=node.device) == node) & ok
        new_c, gpu_take, vg_take, dev_take = kernels.commit_onehot(ns, c, pod, onehot)
        reasons = torch.where(ok, 0, kernels.reason_row(first_fail, ns.valid))
        return new_c, (
            torch.where(ok, node, -1).to(torch.int32), reasons,
            gpu_take.to(torch.int32), vg_take, dev_take,
        )

    step = torch.func.vmap(one)

    def run(ns_s, carry_s, pods_s, weights_s):
        outs = []
        for i in range(pods_s.req.shape[1]):
            pod = kernels.PodRow(*(a[:, i] for a in pods_s))
            carry_s, out = step(ns_s, weights_s, carry_s, pod)
            outs.append(out)
        return (carry_s,) + tuple(torch.stack(col, dim=1) for col in zip(*outs))

    return run


def _dispatch(scope: SmallScope, chunk: Sequence[Universe], s_pad: int,
              mutate: Optional[str], engine: str = "serial", device=DEFAULT_DEVICE):
    from ..device import resolve_device
    from ..ops import fast

    dev = resolve_device(device)
    ns_s, carry_s, pods_s, weights_s = _pack_chunk(scope, chunk, s_pad, dev)
    if mutate is not None:
        # mutation screening always targets the serial engine: the
        # mutations are written against schedule_step's expressions, and the
        # point is to prove the CHECKER catches them
        fn = _mutated_engine(mutate)
    elif engine == "wave":
        fn = fast.schedule_universes_wave_host
    else:
        fn = fast.schedule_universes
    carry_out, nodes, reasons, gpu_take, _vt, _dt = fn(ns_s, carry_s, pods_s, weights_s)
    carry_host = {f: v.cpu().numpy() for f, v in zip(carry_out._fields, carry_out)}
    return carry_host, nodes.cpu().numpy(), reasons.cpu().numpy(), gpu_take.cpu().numpy()


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Divergence:
    universe: str   # Universe.key
    field: str      # nodes | reasons | gpu_take | carry.<plane>
    engine: str
    oracle: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProveReport:
    universes_checked: int = 0
    device_calls: int = 0
    divergences: List[Divergence] = dataclasses.field(default_factory=list)
    divergence_total: int = 0
    digest: str = ""
    mutate: Optional[str] = None
    engine: str = "serial"
    contract_path: Optional[str] = None
    contract_ok: Optional[bool] = None   # None = not verified (smoke/write)
    contract_messages: List[str] = dataclasses.field(default_factory=list)
    minimized: Optional[str] = None
    # seconds of host wall in the engine calls (pack, dispatch, copy back),
    # in the oracle runs, and in the whole check
    engine_s: float = 0.0
    oracle_s: float = 0.0
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.divergence_total == 0 and self.contract_ok is not False

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "universes_checked": self.universes_checked,
            "device_calls": self.device_calls,
            "divergences": self.divergence_total,
            "divergence_samples": [d.to_dict() for d in self.divergences],
            "digest": self.digest,
            "mutate": self.mutate,
            "engine": self.engine,
            "contract": {
                "path": self.contract_path,
                "ok": self.contract_ok,
                "messages": self.contract_messages,
            },
            "minimized_counterexample": self.minimized,
        }

    def render_text(self) -> str:
        lines = [
            f"universes checked : {self.universes_checked}",
            f"engine            : {self.engine}",
            f"device calls      : {self.device_calls}",
            f"divergences       : {self.divergence_total}",
            f"placement digest  : {self.digest}",
        ]
        if self.mutate:
            lines.append(f"mutation injected : {self.mutate}")
        if self.contract_ok is not None:
            state = "VERIFIED" if self.contract_ok else "VIOLATED"
            lines.append(f"contract          : {state} ({self.contract_path})")
        for m in self.contract_messages:
            lines.append(f"  - {m}")
        if self.minimized:
            lines.append(f"minimized counterexample: {self.minimized}")
        for d in self.divergences:
            lines.append(
                f"  DIVERGED {d.universe} [{d.field}]\n"
                f"    engine: {d.engine}\n    oracle: {d.oracle}"
            )
        verdict = "PROVED" if self.ok else "FAILED"
        lines.append(f"verdict           : {verdict}")
        return "\n".join(lines)


def _diff_universe(u: Universe, engine: Tuple, oracle_res,
                   out: List[Divergence], limit: int) -> int:
    """Compare one universe's engine lane vs its oracle run; append up to
    `limit` sample divergences; return the number of diverging fields."""
    e_nodes, e_reasons, e_take, e_carry = engine
    count = 0

    def record(field, ev, ov):
        nonlocal count
        count += 1
        if len(out) < limit:
            out.append(Divergence(
                universe=u.key, field=field,
                engine=np.array2string(np.asarray(ev), threshold=64),
                oracle=np.array2string(np.asarray(ov), threshold=64),
            ))

    if not np.array_equal(e_nodes, oracle_res.nodes):
        record("nodes", e_nodes, oracle_res.nodes)
    if not np.array_equal(e_reasons, oracle_res.reasons):
        record("reasons", e_reasons, oracle_res.reasons)
    if not np.array_equal(e_take, oracle_res.gpu_take):
        record("gpu_take", e_take, oracle_res.gpu_take)
    for plane, want in oracle_res.carry.planes().items():
        got = e_carry[plane]
        if got.tobytes() != np.ascontiguousarray(want).tobytes():
            record(f"carry.{plane}", got, want)
    return count


def check_universes(
    scope: SmallScope,
    universes: Sequence[Universe],
    chunk: int = DEFAULT_CHUNK,
    mutate: Optional[str] = None,
    max_samples: int = 8,
    progress=None,
    engine: str = "serial",
    device=DEFAULT_DEVICE,
) -> ProveReport:
    """Run the engine over `universes` (a handful of identically shaped
    calls on `device`), diff every lane against the oracle, and fold the
    canonical placement digest. `engine`: "serial" dispatches
    ops.fast.schedule_universes, "wave" drives the conflict-parallel wave
    engine (ops/wave.py) to its fixpoint; the digest must come out
    identical either way."""
    t_start = time.perf_counter()
    report = ProveReport(mutate=mutate, engine=engine)
    h = hashlib.sha256()
    s_pad = max(8, min(chunk, ((len(universes) + 7) // 8) * 8))
    # Oracle runs depend only on (node slots, presented pod rows); the
    # priority sort collapses the 3^5 pod strings to C(7,2)=21 count
    # multisets, so memoizing drops oracle work ~11x on the full corpus.
    oracle_cache: Dict[Tuple[str, Tuple[int, ...]], object] = {}
    for lo in range(0, len(universes), s_pad):
        batch = universes[lo:lo + s_pad]
        t0 = time.perf_counter()
        carry_host, nodes, reasons, takes = _dispatch(
            scope, batch, s_pad, mutate, engine, device
        )
        report.engine_s += time.perf_counter() - t0
        for j, u in enumerate(batch):
            lane_carry = {f: a[j] for f, a in carry_host.items()}
            cache_key = (u.nodes, tuple(scope.pod_rows(u)))
            oracle_res = oracle_cache.get(cache_key)
            if oracle_res is None:
                t0 = time.perf_counter()
                oracle_res = oracle_mod.schedule(
                    scope.oracle_table(u), scope.oracle_batch(u)
                )
                oracle_cache[cache_key] = oracle_res
                report.oracle_s += time.perf_counter() - t0
            report.divergence_total += _diff_universe(
                u, (nodes[j], reasons[j], takes[j], lane_carry),
                oracle_res, report.divergences, max_samples,
            )
            h.update(u.key.encode())
            h.update(nodes[j].astype("<i4").tobytes())
            h.update(reasons[j].astype("<i4").tobytes())
            h.update(takes[j].astype("<i4").tobytes())
            h.update(lane_carry["free"].astype("<f4").tobytes())
            h.update(lane_carry["gpu_free"].astype("<f4").tobytes())
        report.universes_checked += len(batch)
        report.device_calls += 1
        if progress is not None:
            progress(report.universes_checked, len(universes))
    report.digest = "sha256:" + h.hexdigest()
    report.wall_s = time.perf_counter() - t_start
    return report


# ---------------------------------------------------------------------------
# Counterexample minimization
# ---------------------------------------------------------------------------

def _diverges(scope: SmallScope, u: Universe,
              mutate: Optional[str], engine: str = "serial",
              device=DEFAULT_DEVICE) -> bool:
    rep = check_universes(scope, [u], chunk=8, mutate=mutate, max_samples=0,
                          engine=engine, device=device)
    return rep.divergence_total > 0


def minimize(scope: SmallScope, u: Universe,
             mutate: Optional[str] = None,
             engine: str = "serial", device=DEFAULT_DEVICE) -> Universe:
    """Greedily shrink a diverging universe: drop pod slots, then blank node
    slots, keeping divergence at every step (ddmin-style one-at-a-time)."""
    changed = True
    while changed:
        changed = False
        for i in range(len(u.pods)):
            if len(u.pods) <= 1:
                break
            cand = Universe(u.nodes, u.pods[:i] + u.pods[i + 1:])
            if _diverges(scope, cand, mutate, engine, device):
                u, changed = cand, True
                break
        for i in range(len(u.nodes)):
            if u.nodes[i] == "-":
                continue
            cand = Universe(u.nodes[:i] + "-" + u.nodes[i + 1:], u.pods)
            if _diverges(scope, cand, mutate, engine, device):
                u, changed = cand, True
                break
    return u


# ---------------------------------------------------------------------------
# The canonical commit-order contract
# ---------------------------------------------------------------------------

def order_contract_statement() -> dict:
    """The machine-readable commit-order contract. ROADMAP item 1's wave
    commit must either reproduce these rules bit-for-bit or ship a new
    contract version with its documented reordering. The text is the
    banked contract's, verbatim (verify_contract compares it), so it names
    the JAX package's scan."""
    return {
        "commit_order": (
            "sequential: pods commit one at a time in presented order "
            "(lax.scan); every pod observes all prior commits through the "
            "carry"
        ),
        "pod_presentation": (
            "descending priority, ties broken by original slot index "
            "(stable sort)"
        ),
        "node_tie_break": (
            "first-max argmax: equal total scores place on the lowest "
            "node index"
        ),
        "score_fold": list(oracle_mod.WEIGHT_ORDER),
        "resource_slack": float(oracle_mod.EPS),
        "dtype": "float32",
    }


def contract_payload(scope: SmallScope, report: ProveReport) -> dict:
    return {
        "version": 1,
        "entry": "ops.fast:schedule_universes",
        "corpus": {
            "node_options": "".join(scope.NODE_OPTIONS),
            "node_slots": scope.NODE_SLOTS,
            "pod_options": "".join(scope.POD_OPTIONS),
            "pod_slots": scope.POD_SLOTS,
        },
        "universes": report.universes_checked,
        "digest": report.digest,
        "order_contract": order_contract_statement(),
    }


def write_contract(path: str, scope: SmallScope,
                   report: ProveReport) -> dict:
    payload = contract_payload(scope, report)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return payload


def verify_contract(path: str, scope: SmallScope,
                    report: ProveReport) -> Tuple[bool, List[str]]:
    """Check a full-corpus run against the banked contract artifact."""
    if not os.path.exists(path):
        return False, [
            f"contract artifact missing: {path} "
            "(run `simon prove --write-contract` to bank it)"
        ]
    with open(path) as f:
        banked = json.load(f)
    fresh = contract_payload(scope, report)
    msgs: List[str] = []
    for field in ("corpus", "universes", "order_contract", "entry"):
        if banked.get(field) != fresh[field]:
            msgs.append(
                f"{field} drifted: banked {banked.get(field)!r} "
                f"vs current {fresh[field]!r}"
            )
    if banked.get("digest") != fresh["digest"]:
        msgs.append(
            f"placement digest mismatch: banked {banked.get('digest')} vs "
            f"current {fresh['digest']} — the canonical commit order "
            "changed"
        )
    return not msgs, msgs


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_prove(
    contract_path: str = CONTRACT_PATH,
    write: bool = False,
    smoke: Optional[int] = None,
    chunk: int = DEFAULT_CHUNK,
    mutate: Optional[str] = None,
    progress=None,
    engine: str = "serial",
    device=DEFAULT_DEVICE,
) -> ProveReport:
    """The `simon prove` entry point, on `device` (CUDA by default).

    Full runs (smoke=None) verify — or with write=True, bank — the
    commit-order contract. Smoke runs (smoke=N: every k-th universe so the
    sample spans the corpus) only diff engine vs oracle; the digest is
    sample-dependent, so no contract check. Any divergence triggers the
    counterexample minimizer.

    engine="wave" runs the whole corpus through the conflict-parallel
    wave engine instead of the serial scan; the contract digest is
    engine-independent by design, so a full wave run must verify against
    the SAME banked artifact — that passing run is the wave engine's
    admission proof under the commit-order contract.
    """
    scope = SmallScope()
    corpus = scope.universes()
    if smoke is not None and smoke < len(corpus):
        stride = max(1, len(corpus) // max(smoke, 1))
        corpus = corpus[::stride][:smoke]
    report = check_universes(
        scope, corpus, chunk=chunk, mutate=mutate, progress=progress,
        engine=engine, device=device,
    )
    report.contract_path = contract_path
    if smoke is None and not mutate:
        if write:
            if report.divergence_total == 0:
                write_contract(contract_path, scope, report)
                report.contract_ok = True
                report.contract_messages = [
                    f"contract banked: {contract_path}"
                ]
            else:
                report.contract_ok = False
                report.contract_messages = [
                    "refusing to bank a contract over a diverging corpus"
                ]
        else:
            report.contract_ok, report.contract_messages = verify_contract(
                contract_path, scope, report
            )
    if report.divergence_total > 0 and report.divergences:
        first = report.divergences[0].universe
        nodes, pods = first.split("/")
        report.minimized = minimize(
            scope, Universe(nodes, pods), mutate, engine, device
        ).key
    return report
