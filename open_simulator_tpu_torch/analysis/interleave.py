"""`simon interleave`: a deterministic concurrency model checker for the
serving and durability protocols.

A copy of the JAX package's analysis/interleave.py (which imports no JAX),
retargeted at the port's own modules: server/admission.py and
server/loop.py (AdmissionQueue, SchedulerLoop), server/server.py (the
warm-session LRU: `_sessions`, `_sessions_lock`, `_SESSION_CAP`,
`_checkout_session`, `_checkin_session`), durable/journal.py (RunJournal)
and resilience/policy.py (CircuitBreaker). The explorer, the scenarios,
the mutations and the report format are the reference's, so the same seed
gives the same verdicts in both packages.

`simon prove` closed the device-side gap by exhaustively checking every
small-scope universe against an oracle; this module does the same for the
HOST-side concurrency protocols that production serving depends on —
AdmissionQueue ticketing, SchedulerLoop packing, the warm-session LRU
checkout, generation fencing, the journal WAL, and the circuit breaker.
The reference's races.py reasons about these *syntactically* (lock
discipline, lock-order SCCs); interleave runs the *real code* and explores
its schedules.

The architecture is stateless model checking in the CHESS tradition:

* **Cooperative serialization.** Each protocol scenario runs the real
  production objects with the module-level `threading` name rebound to a
  shim (`_ShimThreading`). Locks, RLocks, Conditions and Events created at
  *runtime* by the code under test therefore become cooperative
  primitives: every acquire/release/wait/notify/set posts a *pending op*
  and yields to the scheduler, which runs exactly one actor at a time.
  Code between two yields is one atomic block, so a run is fully
  determined by its sequence of scheduling choices.

* **Bounded exhaustive exploration.** A DFS over scheduling choices
  re-executes the scenario from scratch per branch (threads are real but
  only one ever runs). Three bounds keep the space finite and documented:
  bounded actors/ops (each scenario is small-scope by construction), a
  context-switch bound (a switch costs budget only when the previous
  actor was still runnable — voluntary yields are free, the CHESS
  insight), and run/step budgets.

* **Partial-order reduction.** Sleep sets over an object-level
  independence relation: two pending ops commute iff they target
  different shim objects. This is sound for code that is data-race-free
  (the reference's races.py certifies its copy of these modules) — any cross-actor access to plain shared state is
  protected by a common lock, so conflicting blocks are always ordered
  by ops on a *shared* shim object. Scenario-harness state that actors
  share outside the code under test goes through `_SharedCell`, which is
  itself a shim object, preserving the argument. `--no-dpor` disables
  the reduction for cross-checking.

* **Crash choices.** Scenarios that model durability (`journal`) add one
  pseudo-actor, CRASH: at any decision point the process may stop. A
  crash kills every actor and hands the on-disk state to the scenario's
  crash invariant (journal prefix-closure: every acknowledged record is
  on disk). The crash model is process-stop at sync boundaries; torn
  single-record writes are the journal's _scan/repair territory.

* **Minimized, replayable counterexamples.** A violating run is reduced
  to its *interventions* — the decisions where the schedule diverged
  from the deterministic default policy (continue the current actor,
  else lowest id) — and ddmin-style one-at-a-time removal (mirroring
  `semantics.minimize`) shrinks them while the violation reproduces.
  The surviving `[[step, actor], ...]` list is the schedule-replay
  format: `simon interleave --replay file.json` re-executes it exactly,
  which makes every future concurrency fix regression-testable.

Seeded known-bad protocol variants (`MUTATIONS`, the `simon prove`
"prove-the-prover" idiom) give the checker teeth: a drain loop that
drops concurrent submits, a lagging generation fence, an ack-before-
append checkpoint ordering, a check-then-act session checkout and a
racy breaker probe must each be caught and minimized.

Determinism: reports carry no wall-clock — the scenario clock is the
decision counter — so the same seed produces byte-identical reports
(the digest field is the sha256 of the canonical JSON).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

#: The pseudo-choice id for a process crash (journal scenario only).
CRASH = -1

#: Documented exploration bounds (the acceptance bar: every shipped
#: scenario must complete — empty DFS stack — within these).
DEFAULT_BOUNDS = {"preemptions": 2, "max_runs": 60000, "max_steps": 500}
#: CI / pre-commit quick mode: one preemption still catches every seeded
#: mutation (they are all two-actor races) at a fraction of the states.
QUICK_BOUNDS = {"preemptions": 1, "max_runs": 8000, "max_steps": 500}


class _Killed(BaseException):
    """Raised inside an actor to unwind it when a run is abandoned
    (crash chosen, violation found, or budget exhausted). BaseException
    so production `except Exception` handlers cannot swallow it."""


class _Prune(BaseException):
    """Raised by the DFS decide hook when every admissible choice is in
    the sleep set: the state's futures are all covered elsewhere."""


# ---------------------------------------------------------------------------
# Cooperative shim primitives
# ---------------------------------------------------------------------------


class _Op:
    """One pending sync operation: what an actor wants to do next. The
    scheduler only schedules an actor whose op is enabled; `apply` runs
    on the actor thread immediately after it is scheduled."""

    __slots__ = ("kind", "obj", "enabled")

    def __init__(self, kind: str, obj: "_ShimObject", enabled) -> None:
        self.kind = kind
        self.obj = obj
        self.enabled = enabled  # Callable[[_Actor], bool]


class _Actor:
    __slots__ = (
        "id", "name", "fn", "thread", "sem", "pending", "done",
        "exc", "killed", "dying",
    )

    def __init__(self, aid: int, name: str, fn: Callable[[], None]) -> None:
        self.id = aid
        self.name = name
        self.fn = fn
        self.thread: Optional[threading.Thread] = None
        self.sem = threading.Semaphore(0)
        self.pending: Optional[_Op] = None
        self.done = False
        self.exc: Optional[BaseException] = None
        self.killed = False
        self.dying = False


class _ShimObject:
    """Base for everything the independence relation can see. Labels are
    allocated in creation order, so they are deterministic per run and
    stable across same-seed explorations."""

    def __init__(self, shim: "Shim", kind: str) -> None:
        self._shim = shim
        self.label = shim._label(kind)


def _always(_actor: "_Actor") -> bool:
    return True


class CoopLock(_ShimObject):
    """threading.Lock stand-in: acquire blocks (op enabled once free),
    release always fires. Owner is an actor id or "ext" for ops issued
    from outside any actor (scenario setup/teardown)."""

    def __init__(self, shim: "Shim", kind: str = "lock") -> None:
        super().__init__(shim, kind)
        self.owner: Optional[object] = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        sh = self._shim
        if not blocking:
            def apply_try():
                if self.owner is None:
                    self.owner = sh._owner_token()
                    return True
                return False
            return sh.op("trylock", self, _always, apply_try)

        def enabled(_a):
            return self.owner is None

        def apply():
            self.owner = sh._owner_token()
            return True
        return sh.op("acquire", self, enabled, apply)

    def release(self) -> None:
        sh = self._shim

        def apply():
            self.owner = None
        sh.op("release", self, _always, apply)

    def locked(self) -> bool:
        return self.owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class CoopRLock(_ShimObject):
    """threading.RLock stand-in: re-entrant owner/count pair."""

    def __init__(self, shim: "Shim") -> None:
        super().__init__(shim, "rlock")
        self.owner: Optional[object] = None
        self.count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        sh = self._shim
        me = sh._owner_token()

        def enabled(_a):
            return self.owner is None or self.owner == me

        def apply():
            self.owner = me
            self.count += 1
            return True
        return sh.op("acquire", self, enabled, apply)

    def release(self) -> None:
        sh = self._shim

        def apply():
            self.count -= 1
            if self.count <= 0:
                self.owner = None
                self.count = 0
        sh.op("release", self, _always, apply)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class CoopCondition(_ShimObject):
    """threading.Condition stand-in. Every op's independence object is
    the underlying lock, so condition traffic conflicts with plain users
    of the same lock (conservative, and exactly how the real primitive
    behaves). wait() is two ops — release-and-park, then
    notified-and-reacquire — so a waiter parks atomically and can only
    be rescheduled once notified (or, for timed waits, whenever the lock
    is free: a timeout may fire at any moment, which the scheduler
    models as a nondeterministic choice)."""

    def __init__(self, shim: "Shim", lock=None) -> None:
        super().__init__(shim, "cv")
        self._l = lock if lock is not None else CoopLock(shim, "cvlock")
        self._waiters: List[List[bool]] = []

    # the lock protocol delegates so `with cv:` works
    def acquire(self, *a, **kw):
        return self._l.acquire(*a, **kw)

    def release(self) -> None:
        self._l.release()

    def __enter__(self):
        self._l.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._l.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        sh = self._shim
        token = [False]
        lock = self._l

        def park():
            self._waiters.append(token)
            lock.owner = None
        sh.op("cv-park", lock, _always, park)

        if timeout is None:
            def enabled(_a):
                return token[0] and lock.owner is None
        else:
            # a timed wait may time out whenever the lock is reacquirable
            def enabled(_a):
                return lock.owner is None

        def wake():
            if token in self._waiters:
                self._waiters.remove(token)
            lock.owner = sh._owner_token()
            return token[0]
        return bool(sh.op("cv-wake", lock, enabled, wake))

    def notify(self, n: int = 1) -> None:
        sh = self._shim

        def apply():
            woken = 0
            for t in self._waiters:
                if woken >= n:
                    break
                if not t[0]:
                    t[0] = True
                    woken += 1
        sh.op("notify", self._l, _always, apply)

    def notify_all(self) -> None:
        self.notify(n=len(self._waiters) + 1)


class CoopEvent(_ShimObject):
    """threading.Event stand-in. is_set() is a non-yielding read: it is
    a single atomic load whose placement inside its atomic block cannot
    be distinguished from a block-level reordering the scheduler already
    explores."""

    def __init__(self, shim: "Shim") -> None:
        super().__init__(shim, "event")
        self._flag = False

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        sh = self._shim

        def apply():
            self._flag = True
        sh.op("event-set", self, _always, apply)

    def clear(self) -> None:
        sh = self._shim

        def apply():
            self._flag = False
        sh.op("event-clear", self, _always, apply)

    def wait(self, timeout: Optional[float] = None) -> bool:
        sh = self._shim
        if timeout is None:
            def enabled(_a):
                return self._flag
        else:
            enabled = _always
        return bool(sh.op("event-wait", self, enabled, lambda: self._flag))


class _SharedCell(_ShimObject):
    """Scenario-harness shared state as a first-class shim object. Any
    cross-actor mutable state a scenario introduces OUTSIDE the code
    under test must live in a cell (or be touched only in blocks already
    ordered by a common lock): cell ops conflict with each other, so the
    independence relation — and therefore sleep-set pruning — stays
    sound for the invariant-relevant state."""

    def __init__(self, shim: "Shim", name: str, value: Any) -> None:
        super().__init__(shim, f"cell:{name}")
        self.value = value

    def get(self) -> Any:
        return self._shim.op("cell-get", self, _always, lambda: self.value)

    def set(self, value: Any) -> None:
        def apply():
            self.value = value
        self._shim.op("cell-set", self, _always, apply)

    def incr(self, by: int = 1) -> int:
        def apply():
            self.value += by
            return self.value
        return self._shim.op("cell-incr", self, _always, apply)


class _ShimThreading:
    """Drop-in for a module's `threading` attribute: the four sync
    primitives become cooperative, everything else (current_thread,
    local, Thread, get_ident, ...) passes through to the real module."""

    def __init__(self, shim: "Shim") -> None:
        self._shim = shim

    def Lock(self) -> CoopLock:  # noqa: N802 - mirrors threading API
        return CoopLock(self._shim)

    def RLock(self) -> CoopRLock:  # noqa: N802
        return CoopRLock(self._shim)

    def Condition(self, lock=None) -> CoopCondition:  # noqa: N802
        return CoopCondition(self._shim, lock)

    def Event(self) -> CoopEvent:  # noqa: N802
        return CoopEvent(self._shim)

    def __getattr__(self, name: str):
        return getattr(threading, name)


class _FsyncFreeOs:
    """`os` proxy for the journal module during interleave runs: fsync
    becomes a no-op. The crash model is process-stop at sync boundaries,
    so the durability line is the flush that precedes the fsync — the
    real fsync only buys power-loss durability, at ~1000x the cost per
    explored state."""

    def __init__(self, real) -> None:
        self._real = real

    def fsync(self, fd: int) -> None:
        return None

    def __getattr__(self, name: str):
        return getattr(self._real, name)


# ---------------------------------------------------------------------------
# The cooperative scheduler
# ---------------------------------------------------------------------------


class Shim:
    """One scenario execution: real actor threads, exactly one runnable
    at a time, every context switch chosen by `decide`. The decision
    counter doubles as the scenario's logical clock (`clock()`), so no
    wall time ever reaches an invariant or a report."""

    def __init__(self) -> None:
        self._sched_sem = threading.Semaphore(0)
        self._actors: List[_Actor] = []
        self._by_thread: Dict[int, _Actor] = {}
        self._labels: Dict[str, int] = {}
        self._step = 0
        self.trace: List[Tuple[str, str, str]] = []
        self.status = "ok"

    # -- construction -------------------------------------------------------

    def _label(self, kind: str) -> str:
        n = self._labels.get(kind, 0)
        self._labels[kind] = n + 1
        return f"{kind}#{n}"

    def threading_shim(self) -> _ShimThreading:
        return _ShimThreading(self)

    def cell(self, name: str, value: Any) -> _SharedCell:
        return _SharedCell(self, name, value)

    def actor(self, name: str, fn: Callable[[], None]) -> None:
        a = _Actor(len(self._actors), name, fn)
        a.pending = _Op("start", _ShimObject(self, f"actor:{name}"), _always)
        self._actors.append(a)

    def clock(self) -> float:
        return float(self._step)

    # -- actor side ---------------------------------------------------------

    def _owner_token(self):
        a = self._by_thread.get(threading.get_ident())
        return a.id if a is not None else "ext"

    def op(self, kind: str, obj: _ShimObject, enabled, apply):
        """Announce a sync op and yield; execute it once scheduled. Ops
        from outside any actor (setup/teardown) or from a dying actor
        (unwinding after _Killed) execute immediately — the run is
        either not started or already abandoned, so their ordering is
        not part of the explored space."""
        a = self._by_thread.get(threading.get_ident())
        if a is None or a.dying:
            try:
                return apply()
            except Exception:
                return None
        a.pending = _Op(kind, obj, enabled)
        self._sched_sem.release()
        a.sem.acquire()
        if a.killed:
            a.killed = False
            a.dying = True
            raise _Killed()
        return apply()

    def _actor_main(self, a: _Actor) -> None:
        self._by_thread[threading.get_ident()] = a
        a.sem.acquire()
        if a.killed:
            a.dying = True
            a.done = True
            return
        try:
            a.fn()
        except _Killed:
            pass
        except BaseException as e:  # real code crashed: that IS a finding
            a.exc = e
        a.done = True
        if not a.dying:
            self._sched_sem.release()

    # -- scheduler side -----------------------------------------------------

    def drive(self, decide, *, max_steps: int, crashable: bool) -> str:
        """Run the scenario to completion under `decide`. Returns the
        run status: ok | deadlock | crashed | steps | pruned."""
        for a in self._actors:
            a.thread = threading.Thread(
                target=self._actor_main, args=(a,),
                name=f"osim-interleave-{a.name}", daemon=True,
            )
            a.thread.start()
        prev: Optional[int] = None
        status = "ok"
        while True:
            if self._step >= max_steps:
                status = "steps"
                break
            enabled = [
                a.id for a in self._actors
                if not a.done and a.pending is not None
                and a.pending.enabled(a)
            ]
            if not enabled:
                if all(a.done for a in self._actors):
                    status = "ok"
                else:
                    status = "deadlock"
                break
            try:
                c = decide(self._step, enabled, self._ops(), crashable, prev)
            except _Prune:
                status = "pruned"
                break
            if c == CRASH:
                crashable = False
                status = "crashed"
                break
            a = self._actors[c]
            op = a.pending
            assert op is not None
            self.trace.append((a.name, op.kind, op.obj.label))
            a.pending = None
            self._step += 1
            prev = c
            a.sem.release()
            self._sched_sem.acquire()
        self.status = status
        self._kill_all()
        return status

    def _ops(self) -> Dict[int, _Op]:
        return {
            a.id: a.pending for a in self._actors
            if not a.done and a.pending is not None
        }

    def _kill_all(self) -> None:
        for a in self._actors:
            if not a.done:
                a.killed = True
                a.sem.release()
        for a in self._actors:
            if a.thread is not None:
                a.thread.join(timeout=10.0)

    def blocked_summary(self) -> str:
        parts = []
        for a in self._actors:
            if not a.done and a.pending is not None:
                parts.append(f"{a.name} blocked on {a.pending.kind} "
                             f"of {a.pending.obj.label}")
        return "; ".join(parts) or "no pending actors"

    def actor_exceptions(self) -> List[Tuple[str, BaseException]]:
        return [(a.name, a.exc) for a in self._actors if a.exc is not None]


class _Patches:
    """Reversible setattr stack for per-run module/instance patching."""

    def __init__(self) -> None:
        self._saved: List[Tuple[Any, str, Any]] = []

    def set(self, obj: Any, name: str, value: Any) -> None:
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self) -> None:
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)


# ---------------------------------------------------------------------------
# Protocol scenarios: small-scope harnesses around the REAL production
# objects. Bounded actors, bounded ops; each declares the invariants it
# checks and (optionally) the seeded-bad mutation that proves the
# checker can catch its class of bug.
# ---------------------------------------------------------------------------

Violations = List[Tuple[str, str]]


class _State:
    """Per-run scenario state bag (actors registered on the shim, plus
    whatever the invariants need to read at quiescence)."""

    def __init__(self, **kw: Any) -> None:
        self.patches = _Patches()
        self.__dict__.update(kw)


class Scenario:
    name = ""
    title = ""
    crashable = False
    #: mutation name -> one-line description (None when the scenario has
    #: no seeded-bad variant).
    mutations: Dict[str, str] = {}

    def setup(self, shim: Shim, mutate: Optional[str]) -> _State:
        raise NotImplementedError

    def check(self, state: _State) -> Violations:
        return []

    def check_crash(self, state: _State) -> Violations:
        return []

    def teardown(self, state: _State) -> None:
        state.patches.restore()


def _bad_take_pack(loop):
    """Seeded lost-ticket bug: snapshot the queue under the lock but
    clear it in a SECOND acquisition — a submit landing between the two
    critical sections is wiped from the queue without ever being packed,
    so its ticket is never finalized."""
    q = loop.queue
    with q._cv:
        while not q._queue and not q._draining:
            q._cv.wait()
        if not q._queue:
            return None
        pack = list(q._queue)
    with q._cv:
        q._queue.clear()
    return pack or None


class AdmissionScenario(Scenario):
    """AdmissionQueue + SchedulerLoop ticket lifecycle: two submitters
    with distinct coalesce keys, the real continuous-batching loop, and
    a closer racing shutdown against them, over a depth-1 queue so the
    queue-full shed path is reachable. Invariants: every submitted
    ticket is finalized exactly once with a definite code (no lost
    ticket), a 200 ticket's body was executed exactly once and a shed
    ticket's never (no double dispatch)."""

    name = "admission"
    title = "AdmissionQueue/SchedulerLoop ticket lifecycle"
    mutations = {
        "lost-ticket": "take_pack snapshots and clears the queue in two "
                       "separate critical sections; a concurrent submit "
                       "is silently wiped",
    }

    def setup(self, shim: Shim, mutate: Optional[str]) -> _State:
        import types

        from ..server import admission as admission_mod

        st = _State(tickets=[], executed=[])
        st.patches.set(admission_mod, "threading", shim.threading_shim())

        def execute(bodies: List[dict]) -> List[Any]:
            st.executed.extend(b["k"] for b in bodies)
            return [{"ok": b["k"]} for b in bodies]

        q = admission_mod.AdmissionQueue(
            execute, depth=1, pack_window_ms=0.0, default_deadline_ms=0.0,
            clock=shim.clock, pack_lanes=2,
        )
        if mutate == "lost-ticket":
            q._loop.take_pack = types.MethodType(
                lambda loop: _bad_take_pack(loop), q._loop
            )
        st.queue = q

        def submitter(k: str):
            def fn() -> None:
                st.tickets.append(q.submit({"k": k}, key=k))
            return fn

        shim.actor("loop", q._loop.run_forever)
        shim.actor("submit-a", submitter("a"))
        shim.actor("submit-b", submitter("b"))
        shim.actor("closer", q.shutdown)
        return st

    def check(self, st: _State) -> Violations:
        v: Violations = []
        ok_keys = set()
        for t in st.tickets:
            if not t.done.is_set() or t.code == 0:
                v.append(("no-lost-ticket",
                          f"ticket {t.key!r} was never finalized "
                          f"(code={t.code})"))
            elif t.code == 200:
                ok_keys.add(t.key)
                n = st.executed.count(t.key)
                if n != 1:
                    kind = ("no-double-dispatch" if n > 1
                            else "no-lost-ticket")
                    v.append((kind,
                              f"ticket {t.key!r} answered 200 but its "
                              f"body was executed {n} time(s)"))
            elif t.code in (429, 503):
                if t.key in st.executed:
                    v.append(("no-double-dispatch",
                              f"shed ticket {t.key!r} ({t.code}) was "
                              "also executed"))
            else:
                v.append(("no-lost-ticket",
                          f"ticket {t.key!r} finalized with unexpected "
                          f"code {t.code}"))
        for k in st.executed:
            if k not in ok_keys:
                v.append(("no-double-dispatch",
                          f"executed body {k!r} belongs to no 200 ticket"))
        return v


def _lagged(fn: Callable[[], int]) -> Callable[[], int]:
    """Seeded fence-regression bug: a lag-1 memo over the generation
    fence — the loop re-keys tickets onto the epoch of the PREVIOUS
    pack, so a ticket can run against state newer than its stamp."""
    memo: List[Optional[int]] = [None]

    def g() -> int:
        cur = fn()
        prev = memo[0]
        memo[0] = cur
        return cur if prev is None else prev
    return g


class FenceScenario(Scenario):
    """Generation-fence epoch protocol: two fenced submitters race an
    epoch bumper while the real loop packs. The fence sample the loop
    takes once per pack must be monotone non-decreasing across packs,
    and every executed ticket's (possibly re-keyed) fence_epoch must
    equal its pack's sample — a ticket may never run against resident
    state newer than what its key encodes."""

    name = "fence"
    title = "generation-fence epoch monotonicity at dequeue"
    mutations = {
        "fence-regression": "the loop's fence read lags one pack behind "
                            "the true epoch, stamping tickets with a "
                            "stale generation",
    }

    def setup(self, shim: Shim, mutate: Optional[str]) -> _State:
        from ..server import admission as admission_mod

        st = _State(tickets=[], packs=[], samples=[])
        st.patches.set(admission_mod, "threading", shim.threading_shim())
        epoch = shim.cell("epoch", 0)
        st.epoch = epoch

        def fence() -> int:
            cur = epoch.get()
            st.samples.append(cur)  # loop actor only: single writer
            return cur

        by_key: Dict[str, Any] = {}

        def execute(bodies: List[dict]) -> List[Any]:
            pack_epoch = st.samples[-1]
            st.packs.append(
                (pack_epoch,
                 [(b["k"], by_key[b["k"]].fence_epoch) for b in bodies])
            )
            return [{"ok": b["k"]} for b in bodies]

        q = admission_mod.AdmissionQueue(
            execute, depth=4, pack_window_ms=0.0, default_deadline_ms=0.0,
            clock=shim.clock, pack_lanes=2,
            fence=_lagged(fence) if mutate == "fence-regression" else fence,
        )
        st.queue = q

        def submitter(k: str):
            def fn() -> None:
                t = q.submit({"k": k}, key=k, fence_epoch=epoch.get())
                by_key[k] = t
                st.tickets.append(t)
            return fn

        shim.actor("loop", q._loop.run_forever)
        shim.actor("submit-a", submitter("a"))
        shim.actor("bump", lambda: epoch.incr())
        shim.actor("submit-b", submitter("b"))
        shim.actor("closer", q.shutdown)
        return st

    def check(self, st: _State) -> Violations:
        v: Violations = []
        last = None
        for pack_epoch, entries in st.packs:
            if last is not None and pack_epoch < last:
                v.append(("fence-monotonic",
                          f"pack fence sample regressed {last} -> "
                          f"{pack_epoch}"))
            last = pack_epoch
            for key, stamped in entries:
                if stamped != pack_epoch:
                    v.append(("fence-stamp",
                              f"ticket {key!r} executed in a pack fenced "
                              f"at epoch {pack_epoch} but stamped "
                              f"epoch {stamped}"))
        return v


def _racy_checkout(server_mod, key):
    """Seeded double-checkout bug: the busy check and the busy set run
    in two separate critical sections (check-then-act), so two actors
    can both observe not-busy and both take the same session."""
    with server_mod._sessions_lock:
        ent = server_mod._sessions.get(key)
    if ent is None:
        return None, True
    if ent["busy"]:
        return None, False
    with server_mod._sessions_lock:
        ent["busy"] = True
        server_mod._sessions.move_to_end(key)
    return ent["session"], False


class SessionScenario(Scenario):
    """Warm-session LRU checkout (server._checkout_session /
    _checkin_session) under the real module-level lock, rebound to the
    shim: two workers race the same pre-populated key while a third
    exercises create + LRU eviction at cap 1. Invariants: a session is
    never held by two actors at once (no double checkout), and at
    quiescence nothing is marked busy and the cache respects the cap.

    The session objects are inert stand-ins — the scenario checks the
    checkout protocol, not ScenarioSession itself — so this import is
    the only place interleave touches the engine-heavy server module."""

    name = "session"
    title = "warm-session LRU checkout/checkin"
    mutations = {
        "double-checkout": "the busy check and busy set are split into "
                           "two critical sections; two actors can both "
                           "take the same session",
    }

    def setup(self, shim: Shim, mutate: Optional[str]) -> _State:
        from collections import OrderedDict

        from ..server import server as server_mod

        st = _State(live=[], holders={}, server_mod=server_mod)
        sess0 = object()
        st.patches.set(
            server_mod, "_sessions",
            OrderedDict([(("k",), {"session": sess0, "busy": False})]),
        )
        st.patches.set(
            server_mod, "_sessions_lock",
            CoopLock(shim, "sessions-lock"),
        )
        st.patches.set(server_mod, "_SESSION_CAP", 1)
        if mutate == "double-checkout":
            st.patches.set(
                server_mod, "_checkout_session",
                lambda key: _racy_checkout(server_mod, key),
            )

        def worker(key: tuple):
            def fn() -> None:
                sess, may_create = server_mod._checkout_session(key)
                if sess is None:
                    if not may_create:
                        return  # busy: the real caller falls back cold
                    sess = object()
                n = st.holders.get(id(sess), 0) + 1
                st.holders[id(sess)] = n
                if n > 1:
                    st.live.append(
                        ("no-double-checkout",
                         f"session for key {key!r} checked out by "
                         f"{n} actors at once")
                    )
                server_mod._checkin_session(key, sess, keep=True)
                st.holders[id(sess)] -= 1
            return fn

        shim.actor("warm-1", worker(("k",)))
        shim.actor("warm-2", worker(("k",)))
        shim.actor("warm-3", worker(("k2",)))
        return st

    def check(self, st: _State) -> Violations:
        v = list(st.live)
        sessions = st.server_mod._sessions
        for key, ent in sessions.items():
            if ent["busy"]:
                v.append(("no-double-checkout",
                          f"entry {key!r} still busy at quiescence"))
        cap = st.server_mod._SESSION_CAP
        if len(sessions) > cap:
            v.append(("session-cap",
                      f"{len(sessions)} cached sessions exceed cap {cap}"))
        return v


class JournalScenario(Scenario):
    """RunJournal WAL prefix-closure under crash: two appenders commit
    records through the real append path (write + flush; fsync is a
    no-op under the crash model — see _FsyncFreeOs) and acknowledge
    each record only after append returns. CRASH may fire at any
    decision point; afterwards every acknowledged seq must be on disk
    and the on-disk seqs must be gap-free from 0 (the commit-order
    commit-order contract of the run journal, schedule-checked)."""

    name = "journal"
    title = "journal WAL prefix-closure under crash"
    crashable = True
    mutations = {
        "torn-checkpoint": "records are acknowledged BEFORE the durable "
                           "append; a crash between the two loses an "
                           "acked record",
    }

    def setup(self, shim: Shim, mutate: Optional[str]) -> _State:
        from ..durable import journal as journal_mod

        st = _State(acked=[], journal_mod=journal_mod)
        st.patches.set(journal_mod, "threading", shim.threading_shim())
        st.patches.set(journal_mod, "os", _FsyncFreeOs(os))
        st.run_dir = tempfile.mkdtemp(prefix="osim-interleave-")
        j = journal_mod.RunJournal.open(st.run_dir)
        st.journal = j
        torn = mutate == "torn-checkpoint"

        def appender(name: str):
            def fn() -> None:
                for k in range(2):
                    if torn:
                        st.acked.append(j._seq)  # ack before durability
                        j.append("tick", actor=name, k=k)
                    else:
                        rec = j.append("tick", actor=name, k=k)
                        st.acked.append(rec["seq"])
            return fn

        shim.actor("append-a", appender("a"))
        shim.actor("append-b", appender("b"))
        return st

    def _disk(self, st: _State) -> List[int]:
        events, _ = st.journal_mod._scan(st.journal.path)
        return [e["seq"] for e in events]

    def _closure(self, st: _State) -> Violations:
        v: Violations = []
        disk = self._disk(st)
        if disk != sorted(set(disk)) or (disk and disk != list(
                range(disk[0], disk[0] + len(disk)))):
            v.append(("journal-seq-monotonic",
                      f"on-disk seqs not gap-free monotonic: {disk}"))
        missing = sorted(set(st.acked) - set(disk))
        if missing:
            v.append(("journal-prefix-closure",
                      f"acknowledged seq(s) {missing} not on disk "
                      f"(disk has {disk})"))
        return v

    def check(self, st: _State) -> Violations:
        return self._closure(st)

    def check_crash(self, st: _State) -> Violations:
        return self._closure(st)

    def teardown(self, st: _State) -> None:
        try:
            st.journal.close()
        finally:
            st.patches.restore()
            shutil.rmtree(st.run_dir, ignore_errors=True)


class BreakerScenario(Scenario):
    """CircuitBreaker state-machine legality: three clients race
    allow()/record_* against a breaker seeded open with an elapsed
    cooldown, under the shimmed instance lock. Invariants: every
    observed state *set* is a legal transition (in particular a
    half_open state can never be re-entered from half_open — the
    double-probe signature), and each open->half_open transition admits
    exactly one probe."""

    name = "breaker"
    title = "circuit-breaker probe admission and transitions"
    mutations = {
        "double-probe": "allow() checks the state outside the lock "
                        "(check-then-act); two clients can both be "
                        "admitted as the half-open probe",
    }

    _LEGAL = {
        ("closed", "closed"), ("closed", "open"),
        ("open", "open"), ("open", "half_open"), ("open", "closed"),
        ("half_open", "closed"), ("half_open", "open"),
    }

    def setup(self, shim: Shim, mutate: Optional[str]) -> _State:
        from ..resilience import policy as policy_mod

        st = _State(transitions=[], probes=[])
        st.patches.set(policy_mod, "threading", shim.threading_shim())
        b = policy_mod.CircuitBreaker(
            "interleave", failure_threshold=1, cooldown_s=0.0,
            clock=shim.clock,
        )
        b.force_open("seeded open")  # setup context: ops apply directly
        st.transitions.append(b.state)
        orig_export = b._export

        def export_wrap() -> None:
            # called inside the instance lock on every state set, so
            # appends are ordered by ops on a shared shim object
            st.transitions.append(b.state)
            orig_export()
        b._export = export_wrap
        if mutate == "double-probe":
            def racy_allow() -> bool:
                if b.state == b.CLOSED:
                    return True
                if (b.state == b.OPEN
                        and b.clock() - b._opened_at >= b.cooldown_s):
                    with b._lock:
                        b.state = b.HALF_OPEN
                        b._export()
                    return True
                return False
            b.allow = racy_allow
        st.breaker = b

        def client(name: str, succeed: bool):
            def fn() -> None:
                if b.allow():
                    st.probes.append((name, b.state))
                    if succeed:
                        b.record_success()
                    else:
                        b.record_failure("interleave probe failure")
            return fn

        shim.actor("probe-ok", client("probe-ok", True))
        shim.actor("probe-fail-1", client("probe-fail-1", False))
        shim.actor("probe-fail-2", client("probe-fail-2", False))
        return st

    def check(self, st: _State) -> Violations:
        v: Violations = []
        seq = st.transitions
        for prevs, nexts in zip(seq, seq[1:]):
            if (prevs, nexts) not in self._LEGAL:
                v.append(("breaker-legal-transitions",
                          f"illegal state set {prevs} -> {nexts} "
                          f"(full sequence: {seq})"))
        admissions = sum(
            1 for a, bn in zip(seq, seq[1:])
            if a == "open" and bn == "half_open"
        )
        half_open_probes = sum(
            1 for _, state in st.probes if state == "half_open"
        )
        if half_open_probes > admissions:
            v.append(("breaker-single-probe",
                      f"{half_open_probes} probe(s) admitted in "
                      f"half_open but only {admissions} open->half_open "
                      "transition(s)"))
        return v


SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in (
        AdmissionScenario(), FenceScenario(), SessionScenario(),
        JournalScenario(), BreakerScenario(),
    )
}

#: mutation name -> (scenario name, description); the seeded-bad
#: protocol variants that prove the checker's teeth (`--mutate`).
MUTATIONS: Dict[str, Tuple[str, str]] = {
    mname: (s.name, desc)
    for s in SCENARIOS.values()
    for mname, desc in s.mutations.items()
}


# ---------------------------------------------------------------------------
# The explorer: DFS over scheduling choices with a context-switch bound
# and sleep-set partial-order reduction.
# ---------------------------------------------------------------------------


@dataclass
class _Branch:
    """One unexplored DFS branch: replay `forced`, then free-run under
    the default policy. `sleep` is the sleep set in effect at decision
    index len(forced) (i.e. after taking the last forced choice)."""

    forced: List[int]
    sleep: frozenset = frozenset()


@dataclass
class _RunRecord:
    status: str = "ok"
    choices: List[int] = field(default_factory=list)
    defaults: List[int] = field(default_factory=list)
    violations: Violations = field(default_factory=list)
    trace: List[Tuple[str, str, str]] = field(default_factory=list)


def _independent(a: _Op, b: _Op) -> bool:
    """Object-level independence: ops on distinct shim objects commute.
    Sound for data-race-free code: any
    conflicting plain-state access is ordered by ops on a common lock,
    and scenario-harness state goes through _SharedCell."""
    return a.obj is not b.obj


def _sleepfree_default(prev: Optional[int], enabled: List[int]) -> int:
    """The deterministic baseline policy minimization replays against:
    continue the current actor while it is enabled, else lowest id.
    Never chooses CRASH."""
    if prev is not None and prev in enabled:
        return prev
    return min(enabled)


def _run_once(
    scenario: Scenario,
    mutate: Optional[str],
    decide,
    *,
    max_steps: int,
) -> Tuple[_RunRecord, Shim]:
    """Execute the scenario once under `decide`, check invariants, and
    tear the patches back down. Always leaves the process clean."""
    shim = Shim()
    rec = _RunRecord()
    state = scenario.setup(shim, mutate)
    try:
        status = shim.drive(
            decide, max_steps=max_steps, crashable=scenario.crashable
        )
        rec.status = status
        rec.trace = list(shim.trace)
        if status == "ok":
            rec.violations = list(scenario.check(state))
        elif status == "crashed":
            rec.violations = list(scenario.check_crash(state))
        elif status == "deadlock":
            rec.violations = [(
                "no-deadlock",
                f"semantic deadlock: {shim.blocked_summary()}",
            )]
        for name, exc in shim.actor_exceptions():
            rec.violations.append((
                "actor-exception",
                f"actor {name} raised {type(exc).__name__}: {exc}",
            ))
    finally:
        scenario.teardown(state)
    return rec, shim


def _explore(
    scenario: Scenario,
    mutate: Optional[str],
    *,
    seed: int,
    preemptions: int,
    max_runs: int,
    max_steps: int,
    use_dpor: bool,
) -> Dict[str, Any]:
    """Bounded-exhaustive DFS. Returns counters plus the first violating
    run (if any), un-minimized."""
    rng = random.Random(seed)
    stack: List[_Branch] = [_Branch(forced=[])]
    runs = states = pruned = crash_branches = 0
    deepest = 0
    first_violation: Optional[_RunRecord] = None

    while stack and runs < max_runs:
        branch = stack.pop()
        runs += 1
        sleep: Set[int] = set(branch.sleep)
        preempts = [0]
        record = _RunRecord()

        def decide(i, enabled, ops, crash_ok, prev, _b=branch,
                   _sleep=sleep, _pre=preempts, _rec=record):
            forced = _b.forced
            if i < len(forced):
                c = forced[i]
                if c != CRASH and c not in enabled:
                    raise RuntimeError(
                        f"scenario {scenario.name!r} replayed "
                        f"non-deterministically at step {i}"
                    )
            else:
                def is_preempt(x: int) -> bool:
                    return (prev is not None and prev in enabled
                            and x != prev)

                admissible = [
                    x for x in enabled
                    if _pre[0] + (1 if is_preempt(x) else 0) <= preemptions
                ]
                live = [x for x in admissible if x not in _sleep]
                if not live:
                    raise _Prune()
                c = prev if prev in live else min(live)
                siblings = [x for x in live if x != c]
                rng.shuffle(siblings)
                # push in reverse so LIFO explores c's subtree, then
                # siblings in order — each sibling sleeping on the
                # choices explored before it (Godefroid's sleep sets)
                pushes: List[_Branch] = []
                before: List[int] = [c]
                for s in siblings:
                    sl = frozenset(
                        x for x in (_sleep | set(before))
                        if x in ops and _independent(ops[x], ops[s])
                    ) if use_dpor else frozenset()
                    pushes.append(_Branch(_rec.choices[:i] + [s], sl))
                    before.append(s)
                for b in reversed(pushes):
                    stack.append(b)
                if crash_ok:
                    stack.append(_Branch(_rec.choices[:i] + [CRASH]))
                if use_dpor and c != CRASH:
                    kept = {
                        x for x in _sleep
                        if x in ops and _independent(ops[x], ops[c])
                    }
                    _sleep.clear()
                    _sleep.update(kept)
            if c != CRASH and prev is not None and prev in enabled \
                    and c != prev:
                _pre[0] += 1
            _rec.choices.append(c)
            _rec.defaults.append(_sleepfree_default(prev, enabled))
            return c

        rec, _shim = _run_once(
            scenario, mutate, decide, max_steps=max_steps
        )
        record.status = rec.status
        record.violations = rec.violations
        record.trace = rec.trace
        states += len(record.choices)
        deepest = max(deepest, len(record.choices))
        if rec.status == "pruned":
            pruned += 1
            continue
        if record.choices and record.choices[-1] == CRASH:
            crash_branches += 1
        if record.violations:
            first_violation = record
            break

    return {
        "runs": runs,
        "states": states,
        "pruned": pruned,
        "crash_branches": crash_branches,
        "deepest": deepest,
        "completed": not stack and runs <= max_runs,
        "violating_run": first_violation,
    }


def _replay_run(
    scenario: Scenario,
    mutate: Optional[str],
    interventions: List[Tuple[int, int]],
    *,
    max_steps: int,
) -> _RunRecord:
    """Execute exactly one run: follow the default policy except at the
    intervened decisions. An intervention whose actor is not enabled at
    its step falls back to the default (ddmin relies on this: removing
    an earlier intervention may shift what later steps see)."""
    forced = dict(interventions)
    rec = _RunRecord()

    def decide(i, enabled, ops, crash_ok, prev):
        want = forced.get(i)
        if want is not None and (
            want in enabled or (want == CRASH and crash_ok)
        ):
            c = want
        else:
            c = _sleepfree_default(prev, enabled)
        rec.choices.append(c)
        rec.defaults.append(_sleepfree_default(prev, enabled))
        return c

    out, _shim = _run_once(scenario, mutate, decide, max_steps=max_steps)
    out.choices = rec.choices
    out.defaults = rec.defaults
    return out


def _interventions_of(rec: _RunRecord) -> List[Tuple[int, int]]:
    return [
        (i, c) for i, (c, d) in enumerate(zip(rec.choices, rec.defaults))
        if c != d
    ]


def minimize(
    scenario: Scenario,
    mutate: Optional[str],
    rec: _RunRecord,
    *,
    max_steps: int,
) -> Tuple[List[Tuple[int, int]], _RunRecord]:
    """ddmin-style one-at-a-time reduction over the run's interventions
    (the `semantics.minimize` counterexample flow): drop each divergence
    from the default policy while the violation still reproduces. The
    result is the minimal replayable schedule."""
    interventions = _interventions_of(rec)
    best = _replay_run(scenario, mutate, interventions, max_steps=max_steps)
    if not best.violations:
        # the violating run is not reproducible from interventions alone
        # (should not happen for deterministic scenarios); keep the
        # original evidence rather than minimizing a non-repro.
        return interventions, rec
    changed = True
    while changed and interventions:
        changed = False
        for k in range(len(interventions)):
            candidate = interventions[:k] + interventions[k + 1:]
            attempt = _replay_run(
                scenario, mutate, candidate, max_steps=max_steps
            )
            if attempt.violations:
                interventions = candidate
                best = attempt
                changed = True
                break
    return interventions, best


# ---------------------------------------------------------------------------
# Report + driver
# ---------------------------------------------------------------------------


@dataclass
class InterleaveViolation:
    scenario: str
    invariant: str
    message: str
    #: the minimal replayable schedule: divergences from the default
    #: policy as [step, actor_id] pairs (actor -1 = CRASH).
    interventions: List[Tuple[int, int]]
    #: the minimized run, one (actor, op, object) row per decision.
    trace: List[Tuple[str, str, str]]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "invariant": self.invariant,
            "message": self.message,
            "interventions": [list(p) for p in self.interventions],
            "trace": [list(t) for t in self.trace],
        }


@dataclass
class ScenarioResult:
    name: str
    title: str
    runs: int = 0
    states: int = 0
    pruned: int = 0
    crash_branches: int = 0
    deepest: int = 0
    completed: bool = False
    violations: List[InterleaveViolation] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "title": self.title,
            "runs": self.runs,
            "states": self.states,
            "pruned": self.pruned,
            "crash_branches": self.crash_branches,
            "deepest": self.deepest,
            "completed": self.completed,
            "violations": [v.to_dict() for v in self.violations],
        }


@dataclass
class InterleaveReport:
    """Deterministic (wall-clock-free) result of one interleave pass:
    same seed and bounds => byte-identical to_dict()/render_text()."""

    ok: bool
    seed: int
    mutate: Optional[str]
    bounds: Dict[str, int]
    dpor: bool
    scenarios: List[ScenarioResult]
    replayed: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "ok": self.ok,
            "seed": self.seed,
            "mutate": self.mutate,
            "bounds": dict(self.bounds),
            "dpor": self.dpor,
            "scenarios": [s.to_dict() for s in self.scenarios],
        }
        if self.replayed is not None:
            d["replayed"] = self.replayed
        d["digest"] = hashlib.sha256(
            json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()
        return d

    def render_text(self) -> str:
        lines: List[str] = []
        head = "interleave: OK" if self.ok else "interleave: FAIL"
        lines.append(
            f"{head}  (seed={self.seed}, preemptions<="
            f"{self.bounds['preemptions']}, dpor={'on' if self.dpor else 'off'}"
            + (f", mutate={self.mutate}" if self.mutate else "") + ")"
        )
        for s in self.scenarios:
            status = "complete" if s.completed else "BUDGET EXHAUSTED"
            lines.append(
                f"  {s.name:<10} {s.runs} runs, {s.states} states "
                f"(deepest {s.deepest}, {s.pruned} pruned, "
                f"{s.crash_branches} crash branches) [{status}]"
            )
            for v in s.violations:
                lines.append(f"    VIOLATION [{v.invariant}] {v.message}")
                lines.append(
                    "    schedule: "
                    + json.dumps({
                        "scenario": v.scenario,
                        "interventions": [list(p) for p in v.interventions],
                    })
                )
                for i, (actor, kind, obj) in enumerate(v.trace):
                    lines.append(f"      step {i:>3}  {actor:<14} "
                                 f"{kind:<10} {obj}")
        if self.ok:
            total_runs = sum(s.runs for s in self.scenarios)
            total_states = sum(s.states for s in self.scenarios)
            lines.append(
                f"  explored {total_runs} interleavings / {total_states} "
                "states; every invariant held in every schedule"
            )
        return "\n".join(lines)


def _schedule_dict(v: InterleaveViolation, seed: int,
                   mutate: Optional[str]) -> Dict[str, Any]:
    """The on-disk schedule-replay format (`simon interleave --replay`)."""
    return {
        "scenario": v.scenario,
        "seed": seed,
        "mutate": mutate,
        "interventions": [list(p) for p in v.interventions],
    }


def run_scenario(
    scenario: Scenario,
    *,
    mutate: Optional[str] = None,
    seed: int = 0,
    preemptions: int = 2,
    max_runs: int = 60000,
    max_steps: int = 500,
    use_dpor: bool = True,
) -> ScenarioResult:
    """Explore one scenario exhaustively within bounds; on the first
    violation, stop and ddmin-minimize it to a replayable schedule."""
    out = _explore(
        scenario, mutate, seed=seed, preemptions=preemptions,
        max_runs=max_runs, max_steps=max_steps, use_dpor=use_dpor,
    )
    result = ScenarioResult(
        name=scenario.name, title=scenario.title,
        runs=out["runs"], states=out["states"], pruned=out["pruned"],
        crash_branches=out["crash_branches"], deepest=out["deepest"],
        completed=out["completed"],
    )
    bad = out["violating_run"]
    if bad is not None:
        result.completed = False
        interventions, minimized = minimize(
            scenario, mutate, bad, max_steps=max_steps
        )
        for invariant, message in minimized.violations or bad.violations:
            result.violations.append(InterleaveViolation(
                scenario=scenario.name,
                invariant=invariant,
                message=message,
                interventions=interventions,
                trace=minimized.trace or bad.trace,
            ))
    return result


def run_interleave(
    scenarios: Optional[List[str]] = None,
    *,
    seed: int = 0,
    quick: bool = False,
    mutate: Optional[str] = None,
    preemptions: Optional[int] = None,
    max_runs: Optional[int] = None,
    max_steps: Optional[int] = None,
    use_dpor: bool = True,
    replay: Optional[Dict[str, Any]] = None,
) -> InterleaveReport:
    """The `simon interleave` entry point.

    Default mode explores every requested scenario within the documented
    bounds. `mutate` narrows to the mutation's scenario and runs it with
    the seeded bug applied (the checker must find and minimize it).
    `replay` executes exactly one schedule previously emitted by a
    violation (the regression vehicle for concurrency fixes)."""
    bounds = dict(QUICK_BOUNDS if quick else DEFAULT_BOUNDS)
    if preemptions is not None:
        bounds["preemptions"] = int(preemptions)
    if max_runs is not None:
        bounds["max_runs"] = int(max_runs)
    if max_steps is not None:
        bounds["max_steps"] = int(max_steps)

    if replay is not None:
        name = replay.get("scenario", "")
        if name not in SCENARIOS:
            raise ValueError(f"replay schedule names unknown scenario "
                             f"{name!r} (have: {sorted(SCENARIOS)})")
        scn = SCENARIOS[name]
        r_mutate = replay.get("mutate") or mutate
        interventions = [
            (int(i), int(c)) for i, c in replay.get("interventions", [])
        ]
        rec = _replay_run(
            scn, r_mutate, interventions, max_steps=bounds["max_steps"]
        )
        result = ScenarioResult(
            name=scn.name, title=scn.title, runs=1,
            states=len(rec.choices), completed=True,
        )
        for invariant, message in rec.violations:
            result.violations.append(InterleaveViolation(
                scenario=scn.name, invariant=invariant, message=message,
                interventions=interventions, trace=rec.trace,
            ))
        return InterleaveReport(
            ok=not result.violations, seed=seed, mutate=r_mutate,
            bounds=bounds, dpor=use_dpor, scenarios=[result],
            replayed={"scenario": name,
                      "interventions": [list(p) for p in interventions]},
        )

    if mutate is not None:
        if mutate not in MUTATIONS:
            raise ValueError(f"unknown mutation {mutate!r} "
                             f"(have: {sorted(MUTATIONS)})")
        names = [MUTATIONS[mutate][0]]
    elif scenarios:
        unknown = [n for n in scenarios if n not in SCENARIOS]
        if unknown:
            raise ValueError(f"unknown scenario(s) {unknown} "
                             f"(have: {sorted(SCENARIOS)})")
        names = list(scenarios)
    else:
        names = sorted(SCENARIOS)

    results = [
        run_scenario(
            SCENARIOS[n], mutate=mutate, seed=seed,
            preemptions=bounds["preemptions"],
            max_runs=bounds["max_runs"], max_steps=bounds["max_steps"],
            use_dpor=use_dpor,
        )
        for n in names
    ]
    ok = all(r.completed and not r.violations for r in results)
    return InterleaveReport(
        ok=ok, seed=seed, mutate=mutate, bounds=bounds, dpor=use_dpor,
        scenarios=results,
    )
