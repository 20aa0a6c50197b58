"""Resident cluster state: delta updates under a robustness envelope.

The port of the JAX package's engine/resident.py. A full `encode_nodes` of
the cluster costs the host hundreds of milliseconds at 10,000 nodes; a
`ResidentCluster` keeps the encoded node planes on the device and lands each
snapshot refresh as a handful of row scatters (ops/delta.py) instead.

The dangerous failure mode of long-lived derived state is *silent drift*: a
delta stream that diverges from the source of truth corrupts every later
answer. So the resident path is a robustness subsystem first:

  generation fencing   every mutation bumps a globally monotonic epoch (never
                       reused across instances); `fence_epoch()` is what a
                       request records at admission. Mutation builds NEW
                       host arrays (numpy planes are copied before row
                       writes) and writes the device planes into a copy
                       whenever a `table_view()` loan of them may be live,
                       so a reader that took the previous view keeps a
                       consistent snapshot.

  drift detection      a u32 digest of every resident plane (device planes
                       digested on the device: one scalar per plane comes
                       back) is checked against the digest of a full
                       re-encode of the mirror every
                       OSIM_RESIDENT_VERIFY_EVERY deltas (default 64; 0
                       turns the periodic check off; `verify_now()` is
                       always there).

  anti-entropy repair  on a digest mismatch, a torn delta, an exhausted
                       delta budget (OSIM_RESIDENT_DELTA_BUDGET) or a mid-run
                       OSIM_RESIDENT=0, the state is re-encoded in full, the
                       repair is journaled through durable/journal.py and
                       counted in osim_resident_drift_repairs_total.
                       Structural changes the planes cannot take as row
                       deltas (node removal or reorder, bucket overflow,
                       axis growth) take the same re-encode, counted in
                       osim_resident_fallbacks_total.

Correctness contract: after every sync the resident planes are byte-identical
to `encode_nodes(self.enc, nodes, usage, gpu_usage, n_pad=<resident N>,
min_axes=<resident axes>)`: the SAME encoder, the same bucketed shapes. Row
contents are always recomputed on the host by the exact encode_node_into
code path and scattered whole; nothing is adjusted incrementally in f32.

Chaos hooks (fault target "resident"): op "apply" kind torn_delta applies a
real partial device update, then repairs; op "verify" kind digest_mismatch
perturbs the resident digest so the detector fires; op "fence" kind
stale_generation makes fence_epoch return a sentinel no live epoch matches.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.objects import Node, Pod
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops import delta as delta_ops
from ..ops.encode import (
    Encoder,
    NodeTable,
    aggregate_gpu_usage,
    aggregate_usage,
    clear_node_row,
    encode_node_into,
    encode_nodes,
    node_axes,
    resource_scale,
)
from ..ops.kernels import NodeStatic
from ..ops.state import node_static_from_table
from ..resilience import faults
from ..utils import metrics
from ..utils.tracing import log

# Planes that live on the device and are updated by row scatters: exactly the
# NodeTable fields state.carry_from_table reads.
DEVICE_PLANES = ("free", "gpu_free", "vg_free", "dev_free")

# Fixed digest field order: every NodeTable array field (host mirror), then
# the device planes. Appending the device copies means the digest witnesses
# both "mirror == truth" and "device == mirror" in one number.
_DIGEST_FIELDS = tuple(
    f.name for f in dataclasses.fields(NodeTable) if f.name != "names"
)


class TornDelta(RuntimeError):
    """A delta apply stopped part-way (injected or real) — the device planes
    may be inconsistent with the mirror and must be repaired."""


# The epoch is module-globally monotonic so fence values can never collide
# across ResidentCluster instances.
_EPOCH_LOCK = threading.Lock()
_EPOCH_COUNTER = itertools.count(1)


def _next_epoch() -> int:
    with _EPOCH_LOCK:
        return next(_EPOCH_COUNTER)


def resident_enabled() -> bool:
    """OSIM_RESIDENT env knob; default on. 0/false/no/off disable."""
    return os.environ.get("OSIM_RESIDENT", "1").strip().lower() not in (
        "0", "false", "no", "off",
    )


def _verify_every() -> int:
    try:
        return int(os.environ.get("OSIM_RESIDENT_VERIFY_EVERY", "64"))
    except ValueError:
        return 64


def _delta_budget() -> int:
    try:
        return int(os.environ.get("OSIM_RESIDENT_DELTA_BUDGET", "4096"))
    except ValueError:
        return 4096


def digest_table(
    table: NodeTable, device: Optional[Dict[str, torch.Tensor]] = None
) -> int:
    """One u32 digest over every array field of `table` (host), then over the
    device planes (or the table's own planes again when `device` is None, so
    a fresh encode digests shape-compatibly with a resident digest)."""
    parts: List[int] = []
    for name in _DIGEST_FIELDS:
        parts.append(delta_ops.digest_fold_host(getattr(table, name)))
    for name in DEVICE_PLANES:
        if device is not None:
            parts.append(int(delta_ops.digest_fold(device[name]).item()))
        else:
            parts.append(delta_ops.digest_fold_host(getattr(table, name)))
    return delta_ops.combine_digests(parts)


class ResidentCluster:
    """Device-resident encoded cluster state with fencing, drift detection
    and anti-entropy repair, on `device` (CUDA by default). All mutation
    happens in `sync` / `_repair` under the internal lock."""

    def __init__(
        self, journal=None, journal_dir: Optional[str] = None, device=DEFAULT_DEVICE,
    ) -> None:
        self.device = resolve_device(device)
        self.enc = Encoder(topology_keys=("kubernetes.io/hostname",))
        self.epoch = 0
        self._lock = threading.RLock()
        self._nodes: List[Node] = []
        self._bound: List[Tuple[Pod, str]] = []
        self._usage: Dict[str, Dict[str, int]] = {}
        self._gpu_usage: Dict[str, np.ndarray] = {}
        self._host: Optional[NodeTable] = None
        self._axes: Tuple[int, int, int, int, int] = (0, 0, 0, 0, 0)
        self._dev: Dict[str, torch.Tensor] = {}
        self._ns: Optional[NodeStatic] = None
        self._ns_key: Optional[tuple] = None
        self._static_epoch = 0
        self._deltas_since_encode = 0
        self._since_verify = 0
        self._loaned = False
        self._disabled = False
        self._journal = journal
        self._journal_dir = journal_dir
        self.repairs = 0  # lifetime count, for cheap test/debug introspection

    # -- public surface ----------------------------------------------------

    def fence_epoch(self) -> int:
        """The epoch a request must record at admission; a scheduler loop
        re-keys every request whose admission-time epoch moved, so one
        batched device call never mixes cluster states (server/loop.py).
        The stale_generation chaos kind returns a
        sentinel that can never match a live epoch."""
        rule = faults.maybe_inject("resident", "fence")
        if rule is not None and rule.kind == "stale_generation":
            return -1
        return self.epoch

    def sync(self, nodes: Sequence[Node], pods: Sequence[Pod]) -> int:
        """Bring the resident state up to date with a fresh snapshot; returns
        the new epoch. Structural changes and faults degrade to a full
        re-encode — this call never raises on drift, it heals."""
        with self._lock:
            if not resident_enabled():
                had_live_state = self._host is not None and not self._disabled
                self._adopt(nodes, pods)
                self._disabled = True
                if had_live_state:
                    # mid-run degrade: journal the forced repair once, then
                    # serve full re-encodes until the knob flips back
                    self._repair("disabled")
                else:
                    self._encode_full()
                    self._bump()
                return self.epoch
            self._disabled = False
            if self._host is None:
                self._adopt(nodes, pods)
                self._reencode("cold_start", count=False)
                return self.epoch
            return self._sync_delta(nodes, pods)

    def verify_now(self) -> bool:
        """Force one drift-detector pass; True = digests matched (a mismatch
        repairs and still returns False for observability)."""
        with self._lock:
            if self._host is None:
                return True
            return self._verify()

    def covers_reason(
        self, nodes: Sequence[Node], bound: Sequence[Tuple[Pod, str]]
    ) -> Optional[str]:
        """None when the resident planes are exactly the encode of (nodes,
        bound); otherwise a fallback-reason label. Node identity is the fast
        path (a caller hands the same snapshot objects it synced); content
        equality is the correctness backstop for arbitrary callers."""
        with self._lock:
            if self._disabled or self._host is None:
                return "disabled"
            if len(nodes) != len(self._nodes):
                return "not_covering"
            for nd, mine in zip(nodes, self._nodes):
                if nd is mine:
                    continue
                if nd.name != mine.name or nd.raw != mine.raw:
                    return "not_covering"
            if aggregate_usage(bound) != self._usage:
                return "not_covering"
            gpu = aggregate_gpu_usage(nodes, bound)
            if set(gpu) != set(self._gpu_usage):
                return "not_covering"
            for name, arr in gpu.items():
                if not np.array_equal(arr, self._gpu_usage[name]):
                    return "not_covering"
            return None

    def device_state(
        self, all_pods: Sequence[Pod], bound: Sequence[Tuple[Pod, str]]
    ) -> Tuple[NodeTable, NodeStatic]:
        """The Simulator fast path (after covers_reason returned None):
        register the request's pods into the shared encoder, re-encode if the
        registration grew a shape-defining axis, and hand back the resident
        table view (device planes substituted) plus the cached NodeStatic."""
        with self._lock:
            assert self._host is not None
            self.enc.register_pods(list(all_pods))
            for pod, _ in bound:
                self.enc.register_pods([pod])
            if (
                len(self.enc.resources) != self._host.alloc.shape[1]
                or max(len(self.enc.topology_keys), 1) != self._host.topo.shape[1]
            ):
                self._reencode("shape_growth")
            return self.table_view(), self._node_static()

    def table_view(self) -> NodeTable:
        """The resident NodeTable with device planes substituted: numpy
        fields stay on the host (NodeStatic construction, names lookups),
        the four carry planes are the device tensors, so a request pays no
        node-plane transfer (carry_from_table copies them on the device).

        Handing out a view LOANS the current device planes to the caller.
        ops/delta.apply_rows writes into the plane it is given, so the next
        sync must not scatter into a loaned plane: _apply_rows checks the
        loan flag and writes into a fresh copy instead, leaving every
        outstanding view intact."""
        with self._lock:
            assert self._host is not None
            self._loaned = True
            return dataclasses.replace(self._host, **dict(self._dev))

    # -- internals (call with self._lock held) -----------------------------

    def _adopt(self, nodes: Sequence[Node], pods: Sequence[Pod]) -> None:
        self._nodes = list(nodes)
        self._bound = [(p, p.node_name) for p in pods if p.node_name]
        self._usage = aggregate_usage(self._bound)
        self._gpu_usage = aggregate_gpu_usage(self._nodes, self._bound)

    def _bump(self) -> None:
        self.epoch = _next_epoch()
        metrics.RESIDENT_EPOCH.set(self.epoch)

    def _reencode(self, reason: str, count: bool = True) -> None:
        """Structural full re-encode (still resident afterwards). Not a drift
        repair — the state was correct, it just could not absorb the change
        as row deltas."""
        if count:
            metrics.RESIDENT_FALLBACKS.inc(reason=reason)
        self._encode_full()
        self._bump()

    def _encode_full(self) -> None:
        self._host = encode_nodes(
            self.enc,
            self._nodes,
            existing_usage=self._usage,
            existing_gpu=self._gpu_usage,
        )
        self._axes = (
            self._host.label_pair.shape[1],
            self._host.taint_key.shape[1],
            self._host.gpu_total.shape[1],
            self._host.vg_cap.shape[1],
            self._host.dev_cap.shape[1],
        )
        self._dev = {
            name: torch.from_numpy(getattr(self._host, name).copy()).to(self.device)
            for name in DEVICE_PLANES
        }
        self._static_epoch += 1
        self._deltas_since_encode = 0
        self._since_verify = 0
        self._loaned = False

    def _repair(self, reason: str) -> None:
        """Anti-entropy: re-encode from the mirror of record, journal, count.
        Every drift/torn/stale path funnels here — the request that triggered
        it is answered from the repaired state, never from the drifted one."""
        self._encode_full()
        self._bump()
        self.repairs += 1
        metrics.RESIDENT_DRIFT_REPAIRS.inc(reason=reason)
        try:
            journal = self._ensure_journal()
            if journal is not None:
                journal.append(
                    "resident_repair", reason=reason, epoch=self.epoch
                )
        except Exception as e:  # journal loss must not take down serving
            log.warning("resident repair journal write failed: %s", e)
        log.warning(
            "resident state repaired (reason=%s) at epoch %d", reason, self.epoch
        )

    def _ensure_journal(self):
        if self._journal is not None:
            return self._journal
        from ..durable.journal import RunJournal, default_runs_root

        run_dir = self._journal_dir or os.path.join(
            default_runs_root(), f"resident-{os.getpid()}"
        )
        self._journal = RunJournal.open(run_dir)
        return self._journal

    def _node_static(self) -> NodeStatic:
        key = (
            self._static_epoch,
            len(self.enc.domains),
            len(self.enc.anti_terms),
        )
        if self._ns is None or self._ns_key != key:
            assert self._host is not None
            self._ns = node_static_from_table(self.enc, self._host, device=self.device)
            self._ns_key = key
        return self._ns

    # -- delta machinery ---------------------------------------------------

    def _sync_delta(self, nodes: Sequence[Node], pods: Sequence[Pod]) -> int:
        assert self._host is not None
        host = self._host
        old_nodes = self._nodes
        old_usage, old_gpu = self._usage, self._gpu_usage
        self._adopt(nodes, pods)

        # structural gates: anything the fixed-shape planes cannot absorb
        old_names = [nd.name for nd in old_nodes]
        new_names = [nd.name for nd in self._nodes]
        if new_names[: len(old_names)] != old_names:
            reason = (
                "node_removed"
                if set(old_names) - set(new_names)
                else "node_order"
            )
            self._reencode(reason)
            return self.epoch
        if len(new_names) > host.n:
            self._reencode("bucket_overflow")
            return self.epoch

        changed_rows: List[int] = []   # node object changed -> full row
        for i in range(len(old_nodes)):
            nd = self._nodes[i]
            old = old_nodes[i]
            if nd is old or nd.raw == old.raw:
                continue
            changed_rows.append(i)
        added_rows = list(range(len(old_nodes), len(self._nodes)))
        if changed_rows or added_rows:
            fit = [self._nodes[i] for i in changed_rows + added_rows]
            axes = node_axes(self.enc, fit)
            if any(a > b for a, b in zip(axes, self._axes)):
                self._reencode("bucket_overflow")
                return self.epoch

        usage_rows: List[int] = []     # only the bound-pod load changed
        touched = set(changed_rows) | set(added_rows)
        for i, nd in enumerate(self._nodes):
            if i in touched:
                continue
            if old_usage.get(nd.name) != self._usage.get(nd.name):
                usage_rows.append(i)
                continue
            a, b = old_gpu.get(nd.name), self._gpu_usage.get(nd.name)
            if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b)
            ):
                usage_rows.append(i)

        if not changed_rows and not added_rows and not usage_rows:
            return self.epoch  # no-op sync: nothing moved, epoch holds

        try:
            self._apply_rows(changed_rows, added_rows, usage_rows)
        except TornDelta:
            self._repair("torn_delta")
            return self.epoch

        if changed_rows:
            metrics.RESIDENT_DELTAS.inc(len(changed_rows), kind="node_row")
        if added_rows:
            metrics.RESIDENT_DELTAS.inc(len(added_rows), kind="node_added")
        if usage_rows:
            metrics.RESIDENT_DELTAS.inc(len(usage_rows), kind="pod_usage")
        self._bump()
        self._deltas_since_encode += 1
        self._since_verify += 1
        budget = _delta_budget()
        if budget and self._deltas_since_encode >= budget:
            self._repair("delta_budget")
            return self.epoch
        every = _verify_every()
        if every and self._since_verify >= every:
            self._verify()
        return self.epoch

    def _apply_rows(
        self, changed: List[int], added: List[int], usage_rows: List[int]
    ) -> None:
        """Copy-on-write the touched planes, replay the exact encode for the
        touched rows on the host, scatter the rows to the device planes. The
        swapped-in table is fresh arrays throughout — readers holding the
        previous view keep a consistent snapshot."""
        assert self._host is not None
        host = self._host
        full_rows = sorted(changed) + added
        if full_rows:
            # a node-object change can move any field: copy every plane
            table = dataclasses.replace(
                host,
                **{
                    f.name: getattr(host, f.name).copy()
                    for f in dataclasses.fields(NodeTable)
                    if f.name != "names"
                },
                names=list(host.names),
            )
            for i in added:
                table.names.append(self._nodes[i].name)
            for i in full_rows:
                clear_node_row(table, i)
                encode_node_into(
                    self.enc, table, i, self._nodes[i],
                    self._usage, self._gpu_usage,
                )
        else:
            table = dataclasses.replace(
                host,
                free=host.free.copy(),
                gpu_free=host.gpu_free.copy(),
            )
        for i in usage_rows:
            self._recompute_usage_row(table, i)

        rule = faults.maybe_inject("resident", "apply")
        torn = rule is not None and rule.kind == "torn_delta"

        rows = sorted(set(full_rows) | set(usage_rows))
        idx = delta_ops.pad_indices(rows, host.n)
        U = int(idx.shape[0])
        dev = dict(self._dev)
        planes = DEVICE_PLANES if full_rows else ("free", "gpu_free")
        # apply_rows writes into the plane it is given. When no table_view()
        # loan is outstanding the planes are ours alone and the scatter
        # lands in place; when a view has been handed out since the last
        # sync, write a fresh copy and leave the loaned generation intact
        # for its holder.
        loaned = self._loaned
        for k, name in enumerate(planes):
            src = getattr(table, name)
            stack = np.zeros((U,) + src.shape[1:], src.dtype)
            stack[: len(rows)] = src[rows]
            plane = dev[name].clone() if loaned else dev[name]
            dev[name] = delta_ops.apply_rows(plane, idx, stack)
            if torn and k == 0:
                # genuine partial apply: the first plane landed, the rest
                # did not — exactly the inconsistency repair must heal
                self._dev = dev
                self._host = table
                raise TornDelta("injected by fault plan: torn delta apply")
        self._dev = dev
        self._host = table
        # the planes just installed are ours alone (written in place, or
        # copies when loaned): no outstanding view holds them
        self._loaned = False
        if full_rows:
            self._static_epoch += 1

    def _recompute_usage_row(self, table: NodeTable, i: int) -> None:
        """Exact encode arithmetic for the two load-bearing planes of an
        otherwise-unchanged node (f64 intermediate, f32 on assignment — byte
        parity with encode_node_into)."""
        nd = self._nodes[i]
        for r, res in enumerate(self.enc.resources):
            a = nd.allocatable.get(res, 0) / resource_scale(res)
            used = self._usage.get(nd.name, {}).get(res, 0) / resource_scale(res)
            table.free[i, r] = a - used
        table.gpu_free[i] = 0.0
        g_cnt = nd.gpu_count()
        if g_cnt > 0:
            per_dev = np.float32(nd.gpu_mem_per_device() / float(1 << 20))
            table.gpu_free[i, :g_cnt] = per_dev
            used_g = self._gpu_usage.get(nd.name)
            if used_g is not None:
                table.gpu_free[i, : len(used_g)] -= used_g.astype(np.float32)

    # -- drift detection ---------------------------------------------------

    def _verify(self) -> bool:
        assert self._host is not None
        self._since_verify = 0
        got = digest_table(self._host, self._dev)
        rule = faults.maybe_inject("resident", "verify")
        if rule is not None and rule.kind == "digest_mismatch":
            got ^= 0xDEADBEEF
        fresh = encode_nodes(
            self.enc,
            self._nodes,
            existing_usage=self._usage,
            existing_gpu=self._gpu_usage,
            n_pad=self._host.n,
            min_axes=self._axes,
        )
        want = digest_table(fresh)
        if got == want:
            metrics.RESIDENT_VERIFICATIONS.inc(outcome="ok")
            return True
        metrics.RESIDENT_VERIFICATIONS.inc(outcome="mismatch")
        self._repair("digest_mismatch")
        return False
