"""Mid-plan carry checkpoints: make a long commit scan killable anywhere.

After the JAX package's durable/checkpoint.py. The run journal
(journal.py) commits *run-level* units, a capacity trial or a batched
sweep, so a crash between units loses at most one unit. But the unit that
dominates the wall is the commit scan itself: a large sweep spends minutes
inside ONE schedule_scenarios call, and a SIGKILL there threw all of it
away. This module closes that gap for the chunked commit driver and the
wave driver (ops/fast.py):

  - after every chunk (or wave), a `plan_chunk` journal record commits
    (chunk index, pods committed, the carry's `digest_fold` chain digest),
    fsync'd before the next chunk dispatches, so the journal always names
    the last chunk that finished;
  - every OSIM_CKPT_EVERY chunks (default 4) the carry and the placement
    prefix are atomically persisted to `<run_dir>/ckpt/` (np.savez through
    tmp + fsync + rename: a torn snapshot is either absent or caught by its
    embedded digest and skipped for the previous one);
  - on resume (`simon runs resume`) the newest snapshot whose recomputed
    digest matches is restored, its chunks are *skipped*, the journal tail
    is replayed (every re-executed chunk's digest is checked against the
    journaled record) and the plan continues mid-scan. The snapshot holds
    numpy leaves only, gathered whole from any mesh layout;
    ops.fast.carry_from_host re-pins them onto the carry the resumed process
    built, on the mesh it has now: a plan snapshotted on 4 slots resumes on
    2, or on none.

Plan identity: plans are keyed `<seq>:<N>x<P>x<S>c<C>` where `seq` counts
`plan_done` records belonging to *completed* top-level journal units
(trial/sweep/final/segment). A resumed process replays completed units
from their journal records without re-planning, then re-executes the
interrupted unit from its first plan — so its begin_plan calls see the
same seq values the crashed run assigned, and snapshot/journal records
line up by construction.

What is snapshotted: the stacked Carry leaves and the committed placement
prefix (nodes/reasons/takes). What is NOT: the node table, pod batch,
weights and valid masks — those are deterministic re-encodes of the run's
config, and the resumed process rebuilds them (forcing the crashed run's
search shape) before the first chunk.
"""

from __future__ import annotations

import io
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import flightrec, metrics
from ..utils.tracing import log
from .journal import RunJournal, atomic_write

CKPT_DIR = "ckpt"
OUTPUT_NAMES = ("nodes", "reasons", "gpu_take", "vg_take", "dev_take")
DEFAULT_CKPT_EVERY = 4


class CheckpointError(Exception):
    """A snapshot could not be written, or a re-executed chunk's digest
    contradicts its journaled `plan_chunk` record (non-deterministic replay
    or journal corruption — either way the resume is not byte-identical
    and must not pretend to be)."""


def checkpoint_every() -> int:
    """Chunks between carry snapshots (`OSIM_CKPT_EVERY`, default 4).
    `plan_chunk` journal records are per-chunk regardless; this knob only
    paces the (heavier) atomic carry+prefix snapshot."""
    try:
        return max(1, int(os.environ.get("OSIM_CKPT_EVERY", "") or
                          DEFAULT_CKPT_EVERY))
    except ValueError:
        return DEFAULT_CKPT_EVERY


def _safe(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


@dataclass
class PlanRestore:
    """A verified snapshot handed to the chunk loop on resume."""

    chunks_done: int
    pods_done: int
    digest: int
    carry: Dict[str, np.ndarray]
    outputs: Tuple[np.ndarray, ...]


@dataclass
class PlanState:
    """Per-plan bookkeeping between begin_plan and finish_plan."""

    key: str
    n_chunks: int
    restore: Optional[PlanRestore] = None
    # journal-tail digests from a crashed run: chunk -> digest. Re-executed
    # chunks are cross-checked against these and not re-journaled.
    journaled: Dict[int, int] = field(default_factory=dict)
    done_digest: Optional[int] = None
    since_snapshot: int = 0
    snapshots: List[str] = field(default_factory=list)


class PlanCheckpointer:
    """Checkpoint/restore driver for one journaled run's chunked plans.

    Installed around plan_capacity (engine/capacity.py) whenever the run
    has a journal; the chunked commit driver picks it up through
    `active_checkpointer()` so ops/ stays free of durable imports."""

    def __init__(
        self,
        journal: RunJournal,
        resume: bool = False,
        every: Optional[int] = None,
    ) -> None:
        self.journal = journal
        self.run_dir = journal.run_dir
        self.every = every if every else checkpoint_every()
        self._resume = resume
        self._seq = 0
        # plan key -> {"chunks": {i: digest}, "done": digest|None} for the
        # interrupted unit's records only (see module docstring)
        self._tail: Dict[str, Dict[str, Any]] = {}
        if resume:
            self._replay(journal.events())

    # -- resume bookkeeping -------------------------------------------------

    def _replay(self, events: List[Dict[str, Any]]) -> None:
        done_seen = 0
        base = 0
        tail: Dict[str, Dict[str, Any]] = {}
        for e in events:
            ev = e.get("event")
            if ev == "plan_chunk":
                t = tail.setdefault(
                    str(e.get("plan")), {"chunks": {}, "done": None}
                )
                try:
                    t["chunks"][int(e.get("chunk", -1))] = int(
                        str(e.get("digest", "")), 16
                    )
                except ValueError:
                    pass
            elif ev == "plan_done":
                t = tail.setdefault(
                    str(e.get("plan")), {"chunks": {}, "done": None}
                )
                try:
                    t["done"] = int(str(e.get("digest", "")), 16)
                except ValueError:
                    pass
                done_seen += 1
            elif ev in ("trial", "sweep", "final", "segment", "run_end"):
                # a completed top-level unit: everything before it replays
                # from its own record, never through the chunk loop
                base = done_seen
                tail = {}
        self._seq = base
        self._tail = tail

    # -- plan lifecycle -----------------------------------------------------

    def begin_plan(
        self, *, n_nodes: int, p_real: int, s_pad: int, chunk: int,
        n_chunks: int,
    ) -> PlanState:
        key = f"{self._seq}:{n_nodes}x{p_real}x{s_pad}c{chunk}"
        t = self._tail.get(key, {"chunks": {}, "done": None})
        plan = PlanState(
            key=key, n_chunks=n_chunks, journaled=dict(t["chunks"]),
            done_digest=t["done"],
        )
        if self._resume and (plan.journaled or plan.done_digest is not None):
            plan.restore = self._load_restore(key)
        return plan

    def on_chunk(
        self,
        plan: PlanState,
        chunk: int,
        pods_done: int,
        digest: int,
        carry_s,
        outs: List[Tuple[np.ndarray, ...]],
    ) -> Optional[Dict[str, np.ndarray]]:
        """Commit chunk `chunk`'s completion. Returns the host carry leaves
        when this chunk closed a snapshot interval (the caller reuses them
        as its device-loss rollback point), else None."""
        prev = plan.journaled.get(chunk)
        if prev is not None and prev != digest:
            raise CheckpointError(
                f"plan {plan.key} chunk {chunk}: re-executed digest "
                f"{digest:08x} != journaled {prev:08x} — resume is not "
                "byte-identical, refusing to continue"
            )
        if prev is None:
            self.journal.append(
                "plan_chunk", plan=plan.key, chunk=chunk, pods=pods_done,
                digest=f"{digest:08x}",
            )
        flightrec.note(
            "plan-chunk", plan=plan.key, chunk=chunk,
            digest=f"{digest:08x}",
        )
        plan.since_snapshot += 1
        if plan.since_snapshot >= self.every and chunk + 1 < plan.n_chunks:
            plan.since_snapshot = 0
            return self._snapshot(plan, chunk + 1, pods_done, digest,
                                  carry_s, outs)
        return None

    def finish_plan(self, plan: PlanState, digest: int) -> None:
        if plan.done_digest is not None and plan.done_digest != digest:
            raise CheckpointError(
                f"plan {plan.key}: final digest {digest:08x} != journaled "
                f"plan_done {plan.done_digest:08x}"
            )
        if plan.done_digest is None:
            self.journal.append(
                "plan_done", plan=plan.key, chunks=plan.n_chunks,
                digest=f"{digest:08x}",
            )
        self._seq += 1

    # -- snapshot I/O -------------------------------------------------------

    def _snapshot(
        self,
        plan: PlanState,
        chunks_done: int,
        pods_done: int,
        digest: int,
        carry_s,
        outs: List[Tuple[np.ndarray, ...]],
    ) -> Dict[str, np.ndarray]:
        from ..ops import fast as _fast  # lazy: ops must not import durable

        host = _fast.carry_to_host(carry_s)
        arrays: Dict[str, np.ndarray] = {
            f"carry_{k}": v for k, v in host.items()
        }
        for k, name in enumerate(OUTPUT_NAMES):
            arrays[f"out_{name}"] = np.concatenate(
                [o[k] for o in outs], axis=1
            )
        meta = {
            "key": plan.key, "chunks_done": chunks_done,
            "pods_done": pods_done, "digest": f"{digest:08x}",
        }
        arrays["meta"] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
        ).copy()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        data = buf.getvalue()
        ckpt_dir = os.path.join(self.run_dir, CKPT_DIR)
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(
            ckpt_dir, f"plan-{_safe(plan.key)}-c{chunks_done:06d}.npz"
        )
        atomic_write(path, data)
        metrics.CHECKPOINT_BYTES.inc(len(data))
        flightrec.note(
            "plan-snapshot", plan=plan.key, chunks=chunks_done,
            bytes=len(data), digest=f"{digest:08x}",
        )
        plan.snapshots.append(path)
        # keep the last two snapshots: the previous one is the fallback when
        # the newest turns out torn/corrupt on resume
        while len(plan.snapshots) > 2:
            try:
                os.remove(plan.snapshots.pop(0))
            except OSError:
                pass
        return host

    def _load_restore(self, key: str) -> Optional[PlanRestore]:
        from ..ops import fast as _fast  # lazy: ops must not import durable

        ckpt_dir = os.path.join(self.run_dir, CKPT_DIR)
        try:
            names = sorted(os.listdir(ckpt_dir), reverse=True)
        except OSError:
            return None
        prefix = f"plan-{_safe(key)}-c"
        for name in names:
            if not (name.startswith(prefix) and name.endswith(".npz")):
                continue
            path = os.path.join(ckpt_dir, name)
            restore = self._verify_snapshot(key, path, _fast)
            if restore is not None:
                return restore
            log.warning(
                "checkpoint %s: torn or corrupt snapshot skipped "
                "(falling back to the previous one)", path,
            )
        return None

    def _verify_snapshot(
        self, key: str, path: str, _fast
    ) -> Optional[PlanRestore]:
        """Load + verify one snapshot; None if torn/corrupt/mismatched."""
        try:
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
            meta = json.loads(bytes(arrays.pop("meta").tobytes()).decode())
            if str(meta.get("key")) != key:
                return None
            carry = {
                k[len("carry_"):]: v
                for k, v in arrays.items() if k.startswith("carry_")
            }
            outputs = tuple(
                arrays[f"out_{name}"] for name in OUTPUT_NAMES
            )
            digest = int(str(meta.get("digest", "")), 16)
            if _fast.scenario_carry_digest_host(carry) != digest:
                return None
            return PlanRestore(
                chunks_done=int(meta["chunks_done"]),
                pods_done=int(meta["pods_done"]),
                digest=digest,
                carry=carry,
                outputs=outputs,
            )
        except Exception:
            return None


# ---------------------------------------------------------------------------
# Installation point, mirroring resilience.faults: None = production, and
# the chunk loop's lookup is one attribute read.
# ---------------------------------------------------------------------------

_active: Optional[PlanCheckpointer] = None


def active_checkpointer() -> Optional[PlanCheckpointer]:
    return _active


class installed:
    """Context manager: route chunk checkpoints to `cp` for the duration
    of a block (plan_capacity installs one per journaled call)."""

    def __init__(self, cp: PlanCheckpointer) -> None:
        self.cp = cp
        self._prev: Optional[PlanCheckpointer] = None

    def __enter__(self) -> PlanCheckpointer:
        global _active
        self._prev = _active
        _active = self.cp
        return self.cp

    def __exit__(self, *exc: Any) -> None:
        global _active
        _active = self._prev
