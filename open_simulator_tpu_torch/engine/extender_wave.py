"""Wave-pipelined extender scheduling: overlap host HTTP with device compute.

The port of the JAX package's engine/extender_wave.py. The serial extender
path (Simulator._schedule_run_extenders' legacy loop) pays, per pod: one
probe_step, a *serial* chain of HTTP filter/prioritize round trips, then
one commit_step. This engine restructures that loop into waves of W pods
(`OSIM_EXTENDER_WAVE`, 0 = legacy serial escape hatch):

  1. **probe_many** (ops/kernels.py) filters + scores the whole wave against
     the wave-start carry in one vmapped call (the wave axis is padded to
     the scenario bucket, as the reference pads it);
  2. the per-pod extender chains — order-preserving within a pod — fan out
     across a bounded thread pool over keep-alive pooled connections
     (utils/httppool.py, `OSIM_EXTENDER_POOL`); while those HTTP calls are
     in flight the NEXT wave is already probed AND its chains queued on the
     pool (speculatively, against the pre-commit carry — the verbs are
     idempotent and faults.begin_key replays fault coins, so discarding a
     speculative chain and re-issuing it later is invisible);
  3. **commit_wave** applies the wave's placements in pod order through a
     scan that re-runs the filters against the live carry and compares with
     the mask each pod's HTTP chain actually saw. A match proves the serial
     path would have issued byte-identical requests, so the commit IS the
     serial placement; the first mismatch makes that pod and every later pod
     in the wave respill to the front of the queue (their serial outcome
     depends on commits that must land first).

Byte-identity with the serial path holds by construction (deterministic
extenders — the same assumption the serial path's own retries make), and is
pinned by tests/test_extender_wave.py digest equivalence. Progress is
guaranteed: a freshly probed wave's first pod is rechecked against the exact
carry it was probed at, so every wave commits at least one pod.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.fast import scenario_bucket
from ..ops.kernels import PodRow, commit_wave, probe_many
from ..resilience import faults
from ..utils import metrics
from ..utils.httppool import configured_pool_size
from ..utils.tracing import activate, current_context, log, span
from .extenders import (
    EXTENDER_SCORE_SCALE,
    ExtenderError,
    HTTPExtender,
    TransientExtenderError,
    _pod_uid,
)

DEFAULT_WAVE = 64


def wave_size() -> int:
    """OSIM_EXTENDER_WAVE: pods probed + dispatched per wave. 0 disables the
    wave engine entirely (documented escape hatch: the simulator falls back
    to the legacy serial per-pod loop, byte-identical by construction)."""
    try:
        w = int(os.environ.get("OSIM_EXTENDER_WAVE", "") or DEFAULT_WAVE)
    except ValueError:
        w = DEFAULT_WAVE
    return max(0, w)


class _ChainResult:
    """Host-side outcome of one pod's extender filter+prioritize chain."""

    __slots__ = (
        "feasible_names", "combined", "ext_msgs", "error", "error_transient",
        "n_device_feasible",
    )

    def __init__(self, feasible_names, combined, ext_msgs, error,
                 error_transient, n_device_feasible):
        self.feasible_names = feasible_names
        self.combined = combined
        self.ext_msgs = ext_msgs
        self.error = error
        self.error_transient = error_transient
        self.n_device_feasible = n_device_feasible


def _run_chain(
    pod, feasible, interested: Sequence[HTTPExtender]
) -> _ChainResult:
    """One pod's extender chain — the exact host logic of the legacy serial
    loop (chain order, ignorable skip, first-wins failedNodes attribution,
    prioritize errors dropped), run on a pool worker thread. Everything it
    touches is pod-local except the extenders themselves, whose shared state
    (breaker, retry rng, connection pool) is lock-guarded."""
    n_device_feasible = len(feasible)
    ext_msgs: Dict[str, str] = {}
    error: Optional[str] = None
    error_transient = False
    for ext in interested:
        if not feasible:
            break
        try:
            feasible, failed_map = ext.filter(pod, feasible)
        except ExtenderError as e:
            if ext.is_ignorable:
                # degraded mode: an erroring (or circuit-open) ignorable
                # extender is skipped, not fatal
                metrics.EXTENDER_SKIPPED.inc(endpoint=ext.base)
                log.warning("skipping ignorable extender: %s", e)
                continue
            error = str(e)
            error_transient = isinstance(e, TransientExtenderError)
            break
        for name, msg in failed_map.items():
            ext_msgs.setdefault(name, msg)
    combined = {n.name: 0.0 for n in feasible}
    if error is None and feasible:
        for ext in interested:
            if not ext.cfg.prioritize_verb:
                continue
            try:
                for host, s in ext.prioritize(pod, feasible).items():
                    if host in combined:
                        combined[host] += s
            except ExtenderError as e:
                # prioritize errors are ignored (generic_scheduler.go
                # :529-536 logs and drops them)
                metrics.EXTENDER_SKIPPED.inc(endpoint=ext.base)
                log.warning("extender prioritize failed: %s", e)
    return _ChainResult(
        [n.name for n in feasible], combined, ext_msgs, error,
        error_transient, n_device_feasible,
    )


def _chain_task(pod, feasible, interested, trace_ctx=None) -> _ChainResult:
    """Pool-thread wrapper of one chain: re-activates the trace context
    captured on the dispatching thread, so the chain's span (and every
    extender-http child under it) stays a child-by-ID of the simulate call
    that launched the wave."""
    metrics.EXTENDER_INFLIGHT.inc()
    try:
        with activate(trace_ctx):
            with span("extender-chain", pod=_pod_uid(pod)):
                return _run_chain(pod, feasible, interested)
    finally:
        metrics.EXTENDER_INFLIGHT.dec()


def _stack_rows(rows: PodRow, idx: np.ndarray) -> PodRow:
    """Wave-stacked PodRow: a gather of the run's row table on its device."""
    at = torch.from_numpy(idx).to(rows.req.device)
    return PodRow(*(a[at] for a in rows))


class _Wave:
    """One dispatched wave: pod indices, the probe it chained against (device
    refs + host copies), and the in-flight chain futures."""

    __slots__ = (
        "idx", "rows", "mask", "ff", "mask_np", "ff_np", "futures",
        "chains", "glue",
    )

    def __init__(self, idx, rows, mask, ff, mask_np, ff_np, futures):
        self.idx = idx
        self.rows = rows      # stacked PodRow, shared by probe and commit
        self.mask = mask
        self.ff = ff
        self.mask_np = mask_np
        self.ff_np = ff_np
        self.futures = futures
        self.chains: Optional[List[_ChainResult]] = None
        self.glue = None      # (ext_allowed, ext_score, want) host arrays


def run_waves(
    sim,
    pods,
    rows,
    weights,
    filter_on,
    interest: Sequence[Tuple[bool, ...]],
    wave: int,
) -> Tuple[list, int]:
    """Drive the wave pipeline over one extender-interested pod run.

    `sim` is the Simulator (carry/ns/extenders/cluster live there; commits
    mutate sim._carry), `rows` the PodRow table for `pods` on the
    simulation's device, `interest`
    the per-pod per-extender interest vector computed once by the routing
    split. Returns (failed UnscheduledPods in pod order, scheduled count).
    """
    from .simulator import UnscheduledPod

    n_nodes = len(sim.cluster.nodes)
    name_index = sim._name_index_map()
    n_pad = int(sim._ns.valid.shape[0])
    fo = filter_on
    interested_by_pod = [
        [e for e, hit in zip(sim._extenders, iv) if hit] for iv in interest
    ]

    nodes_host = sim.cluster.nodes
    pending: List[int] = list(range(len(pods)))
    failures: Dict[int, UnscheduledPod] = {}
    scheduled = 0
    workers = max(1, min(wave, configured_pool_size()))
    # pod index -> fault-counter snapshot taken at its FIRST chain dispatch;
    # restored before any re-dispatch (respill, discarded speculation) so
    # re-issued chains replay their first run's fault decisions exactly
    fault_snaps: Dict[int, object] = {}

    def padded(idx: List[int]) -> np.ndarray:
        w_pad = scenario_bucket(len(idx))
        return np.asarray(idx + [idx[0]] * (w_pad - len(idx)), np.int64)

    # Captured ONCE on the simulate thread: every chain queued on the pool
    # re-activates this context so its spans (and outbound traceparent
    # headers) stay in the dispatching request's trace.
    trace_ctx = current_context()

    with ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix="osim-extender"
    ) as pool:

        def launch(idx: List[int]) -> _Wave:
            """Probe `idx` against the CURRENT carry and queue its chains on
            the pool. Speculative when the previous wave has not committed
            yet — a stale mask is caught by commit_wave's recheck."""
            wave_rows = _stack_rows(rows, padded(idx))
            mask, _score, ff = probe_many(
                sim._ns, sim._carry, wave_rows, weights, fo,
                sim._extra_filters, sim._extra_scores,
            )
            mask_np, ff_np = mask.cpu().numpy(), ff.cpu().numpy()
            metrics.EXTENDER_WAVE_SIZE.observe(len(idx))
            futures = []
            for w, i in enumerate(idx):
                uid = _pod_uid(pods[i])
                if i in fault_snaps:
                    faults.restore_key(uid, fault_snaps[i])
                else:
                    fault_snaps[i] = faults.snapshot_key(uid)
                js = np.flatnonzero(mask_np[w, :n_nodes])
                feasible = (
                    list(nodes_host)
                    if js.size == n_nodes
                    else [nodes_host[j] for j in js]
                )
                futures.append(
                    pool.submit(
                        _chain_task, pods[i], feasible,
                        interested_by_pod[i], trace_ctx,
                    )
                )
            return _Wave(idx, wave_rows, mask, ff, mask_np, ff_np, futures)

        def prepare(wv: _Wave) -> None:
            """Gather the wave's chain results and build its commit-glue
            arrays. Idempotent; called for the NEXT wave while the current
            wave's commit is still computing on device, so this HTTP wait
            and glue Python overlap device time."""
            if wv.chains is not None:
                return
            wv.chains = [f.result() for f in wv.futures]
            w_pad = int(wv.mask_np.shape[0])
            ext_allowed = np.zeros((w_pad, n_pad), bool)
            ext_score = np.zeros((w_pad, n_pad), np.float32)
            want = np.zeros(w_pad, bool)
            for w, res in enumerate(wv.chains):
                if res.error is not None or not res.feasible_names:
                    continue
                want[w] = True
                js = np.fromiter(
                    (name_index[nm] for nm in res.feasible_names),
                    np.int64, len(res.feasible_names),
                )
                ext_allowed[w, js] = True
                ext_score[w, js] = np.fromiter(
                    (
                        res.combined[nm] * EXTENDER_SCORE_SCALE
                        for nm in res.feasible_names
                    ),
                    np.float32, len(res.feasible_names),
                )
            wv.glue = (ext_allowed, ext_score, want)

        cur: Optional[_Wave] = None
        while pending or cur is not None:
            if cur is None:
                cur, pending = launch(pending[:wave]), pending[wave:]
            # speculative overlap: probe the NEXT wave and queue its chains
            # behind cur's on the pool, so its HTTP flies while cur commits
            nxt: Optional[_Wave] = None
            if pending:
                nxt, pending = launch(pending[:wave]), pending[wave:]
            prepare(cur)

            wave_idx = cur.idx
            w_real = len(wave_idx)
            mask_np, ff_np = cur.mask_np, cur.ff_np
            chains = cur.chains
            ext_allowed, ext_score, want = cur.glue
            dev = sim._ns.valid.device
            (
                sim._carry, nodes, respill, gpu_take, vg_take, dev_take,
            ) = commit_wave(
                sim._ns, sim._carry, cur.rows, weights,
                cur.mask, cur.ff,
                torch.from_numpy(ext_allowed).to(dev), torch.from_numpy(ext_score).to(dev),
                torch.from_numpy(want).to(dev), fo,
                sim._extra_filters, sim._extra_scores,
            )
            if nxt is not None:
                # cur's commit is in flight on device: drain nxt's HTTP and
                # build its glue NOW, where both hide behind device time
                prepare(nxt)
            nodes_np, respill_np, take_np, vg_np, dev_np = (
                t.cpu().numpy() for t in (nodes, respill, gpu_take, vg_take, dev_take)
            )

            nz = np.flatnonzero(respill_np[:w_real])
            first_respill = int(nz[0]) if nz.size else w_real
            for w in range(first_respill):
                i = wave_idx[w]
                res = chains[w]
                ni = int(nodes_np[w])
                if ni >= 0:
                    sim._bind_placed(
                        pods[i], ni, take_np[w], vg_np[w], dev_np[w]
                    )
                    scheduled += 1
                elif res.error is not None:
                    failures[i] = UnscheduledPod(
                        pods[i], res.error, transient=res.error_transient
                    )
                else:
                    failures[i] = UnscheduledPod(
                        pods[i],
                        sim._extender_reason(
                            n_nodes, mask_np[w], ff_np[w], res.ext_msgs,
                            res.n_device_feasible,
                        ),
                    )
            if first_respill < w_real:
                spilled = wave_idx[first_respill:]
                metrics.EXTENDER_WAVE_RESPILL.inc(len(spilled))
                if nxt is not None:
                    # the speculative wave chained against a carry that just
                    # changed under it: discard it. Its chains are already
                    # drained (prepare(nxt) ran before the results came
                    # back), so no stale chain can still be drawing fault
                    # coins when the re-dispatch replays them
                    pending = list(nxt.idx) + pending
                    nxt = None
                # back to the FRONT: serial commit order is the contract
                pending = spilled + pending
            cur = nxt

    failed = [failures[i] for i in sorted(failures)]
    return failed, scheduled
