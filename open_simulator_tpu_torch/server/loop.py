"""Continuous-batching scheduler loop: one always-hot device loop.

The port's copy of the JAX package's server/loop.py. A persistent loop owns
the device; between consecutive device calls it packs whatever compatible
tickets are queued into the next call:

* a lone ticket on an idle server and a full pack (one SCENARIO_BUCKET, or
  the queue depth) dispatch at once; a partial pack, or a lone ticket right
  behind a multi-lane pack (the head of a re-posting herd), may wait for
  stragglers, bounded by the pack window;
* the generation fence (engine/resident.py) is read once per pack, and a
  fenced ticket whose epoch moved is re-keyed before coalescing, so one
  device call never mixes cluster states;
* expired tickets are shed before the device call; the call runs under the
  most generous live deadline (504 when the watchdog fires, 400 when the
  executor fails), and each result fans out to its key's waiters.

`AdmissionQueue` (admission.py) keeps the ticket lifecycle; this loop
decides when the device runs and with which pack, reaching into the
queue's `_cv`/`_queue`/`_shed`/`_finalize`. The pack's span is parented on
its first lane's trace and linked to the others. `guarded_call`,
`call_deadline_s` and `DeadlineExceeded` are resolved through the
admission module, so tests that monkeypatch them there intercept the call.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..resilience import faults
from ..utils import metrics
from ..utils import tracing
from . import admission as admission_mod


def default_pack_lanes() -> int:
    """Target lanes per pack: one SCENARIO_BUCKET (8), so a full pack fills
    the padded scenario shape exactly."""
    from ..ops.fast import SCENARIO_BUCKET

    return int(SCENARIO_BUCKET)


def pack_ready(
    n_queued: int, *, depth: int, pack_lanes: int, saturated: bool = False
) -> bool:
    """Dispatch-now predicate of the pack heuristic. True when waiting any
    longer cannot improve the pack:

    * a lone ticket on an IDLE server — no latency floor; the p50 of a
      lone request is one device call, exactly like serial simulate();
    * a full pack — `pack_lanes` (one scenario bucket) or the queue depth
      reached, whichever is smaller: more waiting cannot add lanes worth
      padding for.

    Anything in between is a *partial* pack: the loop may hold the window
    open (bounded by pack_window_s) for stragglers to join.

    `saturated` is the loop's recent-load signal: the previous pack was
    multi-lane and just finished. Under saturation a lone ticket is
    almost always the FIRST straggler of a thundering herd — the waiters
    of the pack that just fanned out are re-posting — so dispatching it
    alone would burn a full device call on one lane while the rest of
    the herd queues behind it. Treat it as a partial pack instead and
    let the window (an upper bound, not a floor) collect the herd."""
    if n_queued <= 0:
        return False
    if n_queued == 1:
        return not saturated
    return n_queued >= min(pack_lanes, depth)


class SchedulerLoop:
    """The always-hot half of the serving scheduler: take_pack() decides
    *when* the device runs, run_pack() is one loop iteration (deadline
    sheds -> per-pack fence re-key -> coalesce -> guarded device call ->
    fan-out). Constructed by AdmissionQueue; `queue` is the ticket store."""

    def __init__(
        self,
        queue,
        *,
        pack_lanes: Optional[int] = None,
        pack_window_s: Optional[float] = None,
    ) -> None:
        self.queue = queue
        self.pack_lanes = (
            int(pack_lanes) if pack_lanes is not None else default_pack_lanes()
        )
        # The window is an UPPER BOUND on how long a partial pack may wait,
        # not a floor; defaults to the queue's configured window (the
        # OSIM_SERVER_COALESCE_MS deprecation shim resolves into it).
        self.pack_window_s = (
            float(pack_window_s)
            if pack_window_s is not None
            else queue.coalesce_s
        )
        # Saturation signal for pack_ready's lone-ticket case: lane count
        # and completion time of the previous pack. A lone arrival within
        # one pack window of a multi-lane pack finishing is the head of a
        # re-posting herd, not an idle-server request.
        self._last_pack_lanes = 0
        self._last_pack_end: Optional[float] = None

    # -- the loop --------------------------------------------------------------

    def run_forever(self) -> None:
        """Body of the scheduler-loop thread: pack, run, repeat, until the
        queue drains out (shutdown). Crash containment lives in the
        queue's thread wrapper (_worker_main), not here."""
        while True:
            pack = self.take_pack()
            if pack is None:
                return
            self.run_pack(pack)

    def take_pack(self) -> Optional[List]:
        """Block until work exists, apply the pack heuristic, then take the
        whole backlog as the next pack. Returns None when draining and
        empty (loop exit)."""
        q = self.queue
        with q._cv:
            while not q._queue and not q._draining:
                q._cv.wait()
            if not q._queue:  # draining and empty
                return None
            if self.pack_window_s > 0:
                head = q._queue[0]
                window_end = head.enqueued_at + self.pack_window_s
                while not q._draining:
                    saturated = (
                        self._last_pack_lanes > 1
                        and self._last_pack_end is not None
                        and q._clock() - self._last_pack_end
                        < self.pack_window_s
                    )
                    if pack_ready(
                        len(q._queue), depth=q.depth,
                        pack_lanes=self.pack_lanes, saturated=saturated,
                    ):
                        break
                    remaining = window_end - q._clock()
                    if remaining <= 0:
                        break
                    q._cv.wait(remaining)
            pack = list(q._queue)
            q._queue.clear()
            metrics.ADMISSION_QUEUE_DEPTH.set(0)
            return pack or None

    # -- one loop iteration -------------------------------------------------

    def run_pack(self, pack: List) -> None:
        """One iteration of the hot loop over one pack of tickets. Always
        observes osim_loop_iteration_seconds and feeds the iteration-time
        EWMA, even when every ticket sheds — Retry-After must track what
        an iteration actually costs under the current load."""
        q = self.queue
        t_iter = q._clock()
        now = t_iter
        for t in pack:
            metrics.PACK_LATENCY.observe(max(now - t.enqueued_at, 0.0))
        # Cross-thread trace stitching: the pack runs on the loop thread,
        # but every ticket carries the trace context of its submitting
        # request. The pack's execution span is parented (by ID) on the
        # FIRST ticket's trace and records span *links* to every other
        # lane's context — one span cannot have N parents, so extra lanes
        # become links, and each handler links back via ticket.pack_ctx.
        ctx0 = next(
            (t.trace_ctx for t in pack if t.trace_ctx is not None), None
        )
        try:
            with tracing.activate(ctx0):
                with tracing.span("loop-pack", lanes=len(pack)) as s:
                    for t in pack:
                        t.pack_ctx = s.context()
                        if (
                            t.trace_ctx is not None
                            and t.trace_ctx is not ctx0
                        ):
                            s.add_link(t.trace_ctx)
                    self._run_pack_inner(pack, now)
        finally:
            self._last_pack_lanes = len(pack)
            self._last_pack_end = q._clock()
            q._note_iteration(max(q._clock() - t_iter, 0.0))

    def _run_pack_inner(self, pack: List, now: float) -> None:
        q = self.queue
        # 1. deadline sheds AT PACK TIME: expired tickets never reach the
        #    device call (the deadline_storm chaos kind relies on this).
        live: List = []
        for t in pack:
            if t.deadline_at is not None and now >= t.deadline_at:
                q._shed(t, admission_mod.REASON_DEADLINE)
            else:
                live.append(t)
        if not live:
            return
        # 2. generation fence PER PACK: a fenced ticket admitted under epoch
        #    E whose snapshot moved to E' before this pack was taken is
        #    re-keyed onto E' — it runs against the E' state and must only
        #    coalesce with other E' work. One fence() call covers the whole
        #    pack: every lane of the coming device call sees the same
        #    resident state (the stale_generation chaos kind forces the
        #    mismatch with a sentinel epoch).
        if q._fence is not None and any(
            t.fence_epoch is not None for t in live
        ):
            current = q._fence()
            for t in live:
                if t.fence_epoch is None:
                    continue
                if t.fence_epoch == current:
                    metrics.ADMISSION_FENCE.inc(outcome="current")
                else:
                    t.key += f"@fence{current}"
                    t.fence_epoch = current
                    metrics.ADMISSION_FENCE.inc(outcome="rekeyed")
        # 3. injected slow drain (models a wedged backend eating the pack)
        rule = faults.maybe_inject("admission", "drain")
        if rule is not None and rule.kind == "slow_drain" and rule.latency_s > 0:
            time.sleep(rule.latency_s)
        # 4. coalesce: one executor entry per distinct key, arrival order
        groups: Dict[str, List] = {}
        order: List[str] = []
        for t in live:
            if t.key not in groups:
                groups[t.key] = []
                order.append(t.key)
            groups[t.key].append(t)
        bodies = [groups[k][0].body for k in order]
        # 5. watchdog budget: the most generous live deadline (a stricter
        #    per-request budget would abort shared work other waiters still
        #    have time for); deadline-less waiters fall back to the global
        #    OSIM_CALL_DEADLINE_S (0 = unguarded). Resolved through the
        #    admission module so monkeypatched guarded_call intercepts.
        budgets = [t.remaining_s(now) for t in live]
        budget = (
            admission_mod.call_deadline_s()
            if any(b is None for b in budgets)
            else max(budgets)
        )
        try:
            results = admission_mod.guarded_call(
                "serve-simulate",
                lambda: q._execute(bodies),
                budget if budget and budget > 0 else 0.0,
                clock=q._clock,
                poll_s=q._poll_s,
            )
            if len(results) != len(bodies):
                raise RuntimeError(
                    f"batch executor returned {len(results)} results "
                    f"for {len(bodies)} bodies"
                )
        except admission_mod.DeadlineExceeded as e:
            for t in live:
                q._finalize(t, 504, {"error": str(e)})
            return
        except Exception as e:  # executor failure: every waiter gets a 400
            for t in live:
                q._finalize(t, 400, {"error": str(e)})
            return
        # 6. fan each group's one result back out to all of its waiters
        for k, res in zip(order, results):
            waiters = groups[k]
            # mode="fanout": N identical requests served by ONE result.
            # (mode="scenarios" — distinct bodies merged into one batched
            # device call — is observed by the executor, the layer that
            # knows the scenario grouping; see server._execute_bodies.)
            metrics.COALESCED_BATCH.observe(len(waiters), mode="fanout")
            for t in waiters:
                if isinstance(res, BaseException):
                    q._finalize(t, 400, {"error": str(res)})
                else:
                    q._finalize(t, 200, res)
