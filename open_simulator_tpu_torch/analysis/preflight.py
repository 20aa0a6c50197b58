"""Pre-flight program auditor: device memory, cross-slot exchanges and host
transfers of every registry entry, before anything runs at scale.

The port of the JAX package's analysis/hlo_audit.py. The reference lowers
each warmup-registry entry abstractly at every node-ladder rung x mesh shape
and reads `compiled.memory_analysis()` and the HLO's collectives. Eager
PyTorch compiles nothing, so the port runs each registry capture
(analysis/entry_audit.py) on `meta` tensors, the shape-only device, and
measures what it allocates:

* **memory** — a live-bytes tracker under a `TorchDispatchMode`: every
  storage an op makes counts, rounded up to 512 B (the caching allocator's
  block), from its creation until its last tensor dies (a `weakref.finalize`
  per tensor). Per slot it reports argument, output, alias (outputs on an
  argument's storage: the port's donation is an in-place write), temp and
  peak bytes, the reference's meanings (peak = argument + output + temp -
  alias). An op whose CUDA kernel takes an allocator workspace no output
  shows (`SCRATCH_OPS`: sorts twice their outputs' bytes, scans once) holds
  it, and 16 KiB more, while it runs. The matrix resizes the captured arguments as the reference's
  `abstract_args` does (every NodeStatic / Carry node dimension, and any
  other dimension equal to the canonical 64-node bucket, goes to the rung).
  An entry that cannot run on `meta` (`ON_DEVICE`: a listed scalar read and
  the ctypes kernel launch) runs on real tensors of the device at the rung,
  its node rows padded with copies of a pad row, and is listed as such.
  On a card the canonical point of each entry also runs for real between
  `torch.cuda.reset_peak_memory_stats()` and `max_memory_allocated()`, and
  the tracker must cover that peak within the reference's envelope
  (`_estimate_covers`): the port's form of the estimator cross-check; a miss
  fails the program. With the transfer pass on, its call is the one
  measured, and a scan entry's is at its short pricing point (below).
* **scan entries** (`POD_AXIS`) would dispatch 10^5-10^6 ops a cell even on
  `meta`. They run at two short pod counts, a granule and twice it (the
  granule makes every pod-proportional storage a whole number of blocks,
  so the pricing is exact), and the pod bucket is priced linearly; the scan
  marker (ops/scanmark.py) shows the per-step growth is constant, and the
  tracker skips the dispatch mode for a loop's steps once it is.
* **collectives** — the cross-slot exchanges of parallel/slots.py, counted
  per kind with operand bytes: the node-axis combines (`all-reduce:<kind>`)
  and the gathers of node data (`all-gather:<site>`). A gather whose output
  carries a full-rung node dimension at a rescaled rung is **node-table
  replication** (`node_table_gathers`) and fails the program; a
  `LANE_PARALLEL` entry with any exchange on a scenario-only mesh fails
  it. `SCENARIO_ONLY` and `FIXED_SHAPE` skip their cells visibly, as in the
  reference. Slots may share one device, so every mesh runs here, on one
  card or on the CPU; the tracker is entered on each slot thread.
* **transfers** — the registry capture is the warm call; a second call runs
  under a mode that fails on any `_to_copy` / `copy_` between the CPU and
  the card, in either direction, and on `_local_scalar_dense`, except
  `op_audit.LISTED_TRANSFERS` (`_to_copy:to_cuda` lists an entry's host
  uploads). A scan entry's second call runs at 32 pods: the same step
  code, so a per-step transfer shows there too.
* **budget diff** — the measurements against budgets/preflight_torch.json
  (`analysis.budget.BudgetBook`); `--write-budgets` is the only update flow.
  The tracker's `meta` numbers do not depend on the device, so the CPU diffs
  against the same book as the card.
* **the plan_1m_100k verdict** — `schedule_scenarios` at rung
  node_bucket(100,000) = 102,400 and pod bucket round_up(1,000,000) =
  1,003,520 on a 1x4 node-sharded layout, on `meta`: no full-rung gather,
  and the worst slot's peak within the device memory limit (the card's
  total memory; else `--hbm-gib`, 80 GiB: the H100 80GB HBM3's).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .budget import BudgetBook, BudgetViolation, ProgramBudget, program_key

#: Canonical node bucket every capture runs at (ops.encode.NODE_BUCKET_FLOOR).
N_CANON = 64

#: Entries whose scenario lanes are independent by construction: on a
#: scenario-only mesh (one node slot per lane row) their programs must make
#: ZERO cross-slot exchanges.
LANE_PARALLEL = frozenset({
    "ops.fast:schedule_scenarios",
    "ops.fast:schedule_wave",
    "ops.fast:commit_choices",
})

#: The reference's node-indexing entry, audited at one node slot only;
#: node-sharded cells are skipped visibly (``programs_skipped``).
SCENARIO_ONLY = frozenset({"ops.fast:light_scan"})

#: Entries whose captured shapes ARE the contract (the small-scope prover's
#: universes stack every leaf on a leading axis): one run at the captured
#: shapes, unsharded; every other cell is skipped visibly.
FIXED_SHAPE = frozenset({
    "ops.fast:schedule_universes",
    "ops.fast:schedule_universes_wave",
})

#: Entries that cannot run on `meta`: two listed scalar reads and the
#: domain_pop launch (a ctypes call on the card). They run on real tensors.
ON_DEVICE = frozenset({"ops.fast:domain_select"})

#: Scan entries priced linearly in their pod count: entry -> the PodRow
#: axis the loop walks.
POD_AXIS = {
    "ops.kernels:schedule_batch": 0,
    "ops.fast:schedule_scenarios": 0,
    "ops.fast:schedule_universes": 1,
}

DEFAULT_RUNGS: Tuple[int, ...] = (64, 128)
DEFAULT_MESHES: Tuple[str, ...] = ("1", "2x1", "2x2")
#: the verdict's device memory off a card: an H100 80GB HBM3's
DEFAULT_HBM_GIB = 80.0

#: Cross-check tolerance: the tracker must cover the card's measured peak
#: within this envelope (the reference's).
ESTIMATE_REL_TOL = 0.02
ESTIMATE_ABS_SLACK = 64 * 1024

#: the caching allocator's block: every storage rounds up to it
BLOCK = 512

#: ops whose CUDA kernels take a workspace from the caching allocator that
#: no op output shows, and how many times their outputs' bytes it takes: a
#: stable sort's index iota and the radix sort's alternate key and value
#: buffers, a scan's partials; the tracker holds that, and SCRATCH_SLACK
#: more, while the op runs
SCRATCH_OPS = {"sort": 2, "argsort": 2, "topk": 2, "kthvalue": 2, "median": 2, "mode": 2,
               "unique": 2, "_unique2": 2, "cumsum": 1, "cumprod": 1, "nonzero": 1}
SCRATCH_SLACK = 16 * 1024


def _round(nbytes: int) -> int:
    return -(-int(nbytes) // BLOCK) * BLOCK


# ---------------------------------------------------------------------------
# collective census
# ---------------------------------------------------------------------------

def node_table_gathers(ops: Sequence[Tuple[str, tuple]], rung: int) -> List[str]:
    """The replication detector: gathers whose output carries a full-rung
    node dimension mean a node-sharded table came back whole. Lane scalars
    and flattened lane keys never show the rung as a distinct dimension."""
    return [f"{kind}{list(shape)}" for kind, shape in ops
            if kind.startswith("all-gather") and rung in shape]


def parse_mesh(tag: str) -> Tuple[int, int]:
    """``"1"`` -> (1, 1); ``"2x1"`` -> (scenario slots, node slots)."""
    t = tag.strip().lower()
    if t in ("1", "1x1"):
        return (1, 1)
    m = re.fullmatch(r"(\d+)x(\d+)", t)
    if m is None:
        raise ValueError(f"mesh tag {tag!r} is not SxN (e.g. 2x1, 2x2)")
    return (int(m.group(1)), int(m.group(2)))


# ---------------------------------------------------------------------------
# arguments at a rung
# ---------------------------------------------------------------------------

def _axis_tables():
    """(NodeStatic field -> node dim, Carry field -> node dim), from
    parallel.mesh's sharding specs."""
    from ..parallel import mesh as pmesh

    return pmesh.node_sharding()._asdict(), pmesh.carry_sharding()._asdict()


@dataclasses.dataclass
class _Leaf:
    """Where one argument leaf's node, lane and pod dimensions are."""

    node: Optional[int] = None
    lane: Optional[int] = None
    pod: Optional[int] = None


def _leaf_roles(cap, lanes: Optional[int]) -> Any:
    """The argument tree with a _Leaf per tensor/array leaf (the
    reference's abstract_args rules)."""
    from ..ops.kernels import Carry, NodeStatic, PodRow
    from .entry_audit import tree_map

    ns_axis, carry_axis = _axis_tables()
    pod_axis = POD_AXIS.get(cap.name, 0)

    def conv(arg):
        if isinstance(arg, NodeStatic):
            return NodeStatic(*(_Leaf(node=ns_axis[f]) for f in NodeStatic._fields))
        if isinstance(arg, Carry):
            out = []
            for f, leaf in zip(Carry._fields, arg):
                base = carry_axis[f]
                stacked = leaf.dim() == 3
                out.append(_Leaf(node=None if base is None else base + int(stacked),
                                 lane=0 if stacked else None))
            return Carry(*out)
        if isinstance(arg, PodRow):
            return PodRow(*(_Leaf(pod=pod_axis if leaf.dim() > pod_axis else None)
                            for leaf in arg))

        def one(leaf):
            shape = tuple(leaf.shape)
            node = next((i for i, d in enumerate(shape) if d == N_CANON), None)
            lane = 0 if lanes and shape and shape[0] == lanes and node != 0 else None
            return _Leaf(node=node, lane=lane)

        return tree_map(one, arg)

    return tuple(conv(a) for a in cap.args), {k: conv(v) for k, v in cap.kwargs.items()}


def _lanes_of(cap) -> Optional[int]:
    """The lane count of an entry with a stacked carry argument."""
    from ..ops.kernels import Carry

    for a in list(cap.args) + list(cap.kwargs.values()):
        if isinstance(a, Carry) and a.free.dim() == 3:
            return int(a.free.shape[0])
    return None


def _zip_tree(fn, x, roles):
    """fn(leaf, role) over the tensor/array leaves of `x` (roles from
    _leaf_roles, same structure)."""
    import numpy as np
    import torch

    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x, roles)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_zip_tree(fn, v, r) for v, r in zip(x, roles)))
    if isinstance(x, (tuple, list)):
        return type(x)(_zip_tree(fn, v, r) for v, r in zip(x, roles))
    if isinstance(x, dict):
        return {k: _zip_tree(fn, v, roles[k]) for k, v in x.items()}
    return x


def _resized(leaf, role: _Leaf, rung: int, pods: Optional[int], meta: bool):
    """One argument leaf at `rung` nodes (and `pods` on its pod axis): a
    meta tensor, or real data padded with copies of its last row."""
    import numpy as np
    import torch

    shape = list(leaf.shape)
    if role.node is not None:
        shape[role.node] = rung
    if role.pod is not None and pods is not None:
        shape[role.pod] = pods
    if isinstance(leaf, np.ndarray):
        return _pad_np(leaf, shape)
    if meta:
        return torch.empty(shape, dtype=leaf.dtype, device="meta")
    return _pad_tensor(leaf, shape)


def _pad_np(a, shape):
    import numpy as np

    for d, n in enumerate(shape):
        if a.shape[d] < n:
            tail = np.repeat(np.take(a, [a.shape[d] - 1], axis=d), n - a.shape[d], axis=d)
            a = np.concatenate([a, tail], axis=d)
        elif a.shape[d] > n:
            a = np.take(a, range(n), axis=d)
    return np.ascontiguousarray(a)


def _pad_tensor(t, shape):
    import torch

    for d, n in enumerate(shape):
        if t.shape[d] < n:
            tail = t.narrow(d, t.shape[d] - 1, 1).expand(
                *(n - t.shape[d] if i == d else -1 for i in range(t.dim())))
            t = torch.cat([t, tail], dim=d)
        elif t.shape[d] > n:
            t = t.narrow(d, 0, n)
    return t.clone()


def abstract_args(cap, rung: int, pods: Optional[int] = None, meta: bool = True,
                  resize: bool = True):
    """The capture's (args, kwargs) at `rung` (and `pods`): meta tensors,
    or real ones padded with pad rows when `meta` is False. `resize=False`
    keeps the captured shapes (FIXED_SHAPE entries)."""
    import torch

    roles = _leaf_roles(cap, _lanes_of(cap))

    def one(leaf, role):
        if not resize:
            role = _Leaf(pod=role.pod)
            return _resized(leaf, role, rung, pods, meta) if meta or pods else (
                leaf.clone() if isinstance(leaf, torch.Tensor) else leaf.copy())
        return _resized(leaf, role, rung, pods, meta)

    args = _zip_tree(one, tuple(cap.args), roles[0])
    kwargs = {k: _zip_tree(one, v, roles[1][k]) for k, v in cap.kwargs.items()}
    return args, kwargs, roles


def _layout(mesh_tag: str, device):
    """The slot grid of a mesh tag, every slot on `device` (slots share a
    device, as parallel/slots.py allows), or None for one slot."""
    import torch

    from ..parallel.slots import Layout

    s_dev, n_dev = parse_mesh(mesh_tag)
    if s_dev * n_dev == 1:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Layout(tuple(tuple(dev for _ in range(n_dev)) for _ in range(s_dev)))


def _blocks(tree, roles, layout, k: int):
    """Slot k's block of an argument tree: node dims split over the node
    slots, lane dims over the lane rows (tensor_split order), each block a
    tensor of its own."""
    import numpy as np
    import torch

    i, j = divmod(k, layout.cols)

    def one(leaf, role):
        out = leaf
        if role.lane is not None and layout.rows > 1:
            out = (np.array_split(out, layout.rows, axis=role.lane)[i] if isinstance(out, np.ndarray)
                   else out.tensor_split(layout.rows, dim=role.lane)[i])
        # host arrays (a domain plan) are whole on every slot, as the
        # dispatcher builds them from gathered node tables
        if role.node is not None and layout.cols > 1 and not isinstance(out, np.ndarray):
            out = out.tensor_split(layout.cols, dim=role.node)[j]
        if out is leaf:
            return leaf
        if isinstance(out, np.ndarray):
            return np.ascontiguousarray(out)
        if out.device.type == "meta":
            return torch.empty(out.shape, dtype=out.dtype, device="meta")
        return out.clone()

    return _zip_tree(one, tree, roles)


# ---------------------------------------------------------------------------
# the live-bytes tracker
# ---------------------------------------------------------------------------

def _skey(t) -> int:
    return t.untyped_storage()._cdata


def _slot() -> int:
    from ..parallel import slots

    return getattr(slots._tls, "slot", 0)


class _Tracker:
    """Live bytes per slot of the storages ops make (module docstring), and
    the scan marker's handler: each loop's per-step growth, and the skip of
    the dispatch mode once that growth is constant."""

    #: steps measured under the mode before a loop with constant growth runs
    #: without it
    MEASURED_STEPS = 3

    def __init__(self, arg_keys: set, steps: Optional[dict] = None) -> None:
        self.lock = threading.Lock()
        self.arg_keys = set(arg_keys)
        self.live: Dict[int, int] = {}
        self.peak: Dict[int, int] = {}
        self.windows: Dict[int, List[int]] = {}
        self.storages: Dict[int, List[int]] = {}   # key -> [slot, bytes, refs]
        #: per loop body (marker, slot, argument shapes): its measured steps
        #: and template; a program's second pricing run shares the first's
        self.steps: Dict[Any, Dict[str, Any]] = {} if steps is None else steps
        self.growth: Dict[str, List[int]] = {}     # marker -> per-step growth, slot 0
        #: per slot, the peaks of the pod loop's phases: before its first
        #: step, during its latest step, after its latest step
        self.phases: Dict[int, Dict[str, Any]] = {}
        self._on = threading.local()

    # -- accounting ---------------------------------------------------------

    def _bump(self, slot: int, value: Optional[int] = None) -> None:
        v = self.live.get(slot, 0) if value is None else value
        if v > self.peak.get(slot, 0):
            self.peak[slot] = v
        ph = self.phases.get(slot)
        if ph is None:
            ph = self.phases[slot] = _phases()
        if v > ph[ph["stage"]]:
            ph[ph["stage"]] = v
        if ph["stage"] == "post" and v > ph["post_alloc"]:
            ph["post_alloc"] = v
        win = self.windows.get(slot)
        if win:
            for i, w in enumerate(win):
                if v > w:
                    win[i] = v

    def scratch(self, nbytes: int) -> None:
        """An op's device workspace, live only while it runs (module
        docstring: SCRATCH_OPS)."""
        with self.lock:
            slot = _slot()
            self._bump(slot, self.live.get(slot, 0) + nbytes + SCRATCH_SLACK)

    def _release(self, key: int) -> None:
        with self.lock:
            rec = self.storages.get(key)
            if rec is None:
                return
            rec[2] -= 1
            if rec[2] == 0:
                del self.storages[key]
                self.live[rec[0]] = self.live.get(rec[0], 0) - rec[1]

    def track(self, t, in_keys=()) -> None:
        """Count `t`'s storage if no input shares it (a new allocation);
        either way `t` holds a reference to it until it dies."""
        key = _skey(t)
        if key in self.arg_keys:
            return
        with self.lock:
            rec = self.storages.get(key)
            if rec is None:
                if key in in_keys:
                    return       # a view of a storage made outside the program
                slot = _slot()
                rec = self.storages[key] = [slot, _round(t.untyped_storage().nbytes()), 0]
                self.live[slot] = self.live.get(slot, 0) + rec[1]
                self._bump(slot)
            rec[2] += 1
        weakref.finalize(t, self._release, key)

    # -- the dispatch mode --------------------------------------------------

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        tracker = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                import torch

                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                in_keys = set()
                for a in list(args) + list(kwargs.values()):
                    for t in (a if isinstance(a, (list, tuple)) else (a,)):
                        if isinstance(t, torch.Tensor):
                            in_keys.add(_skey(t))
                outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                         if isinstance(t, torch.Tensor)]
                for t in outs:
                    tracker.track(t, in_keys)
                factor = SCRATCH_OPS.get(func.overloadpacket.__name__)
                if factor:
                    tracker.scratch(factor * sum(_round(t.untyped_storage().nbytes())
                                                 for t in outs))
                return out

        return _Mode()

    @contextlib.contextmanager
    def on_thread(self):
        """The mode and the scan handler on this thread, unless already
        there (spmd's lane rows run on the calling thread)."""
        from ..ops import scanmark

        if getattr(self._on, "active", False):
            yield
            return
        self._on.active = True
        try:
            with scanmark.active(self), self.mode():
                yield
        finally:
            self._on.active = False

    # -- the scan marker's handler -----------------------------------------

    def muted(self) -> bool:
        """True inside a loop's second and later steps: a loop body's
        exchanges are counted once, as a compiled program lists them."""
        return getattr(self._on, "mute", 0) > 0

    def step(self, name: str, carry_arg: int, fn, args: tuple, kwargs: dict):
        """Measure a loop's first MEASURED_STEPS steps under the mode; from
        then on (a count, so every slot of a node group decides alike) the
        step runs without it, and on `meta`, where a step computes nothing,
        its outputs are made from the last measured step's shapes without
        running it. The growth of the measured steps after the first must be
        constant (`_steady`)."""
        import torch
        from torch.utils._python_dispatch import _disable_current_modes

        from ..ops import scanmark
        from .invariants import _flat_tensors, _signature

        flat_in = _flat_tensors((args, kwargs))
        if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in flat_in):
            return fn(*args, **kwargs)   # a step inside another step's vmap
        slot = _slot()
        st = self.steps.setdefault((name, slot, _signature((args, kwargs))),
                                   {"hist": [], "template": None})
        before = self.live.get(slot, 0)
        in_keys = {_skey(t) for t in flat_in}
        pod_loop = name in POD_LOOPS and not getattr(self._on, "depth", 0)
        if pod_loop:
            self._stage(slot, "loop")
        self._on.depth = getattr(self._on, "depth", 0) + 1
        n = len(st["hist"])
        self._on.mute = getattr(self._on, "mute", 0) + (1 if n else 0)
        try:
            if n >= self.MEASURED_STEPS:
                out = None
                if st["template"] is not None and all(t.device.type == "meta" for t in flat_in):
                    out = scanmark.remake(st["template"], flat_in)
                if out is None:
                    with _disable_current_modes(), scanmark.active(None):
                        out = fn(*args, **kwargs)
                for t in _flat_tensors(out):
                    self.track(t, in_keys)
                with self.lock:
                    self._bump(slot, before + st["inpeak"])
            else:
                win = self.windows.setdefault(slot, [])
                win.append(before)
                try:
                    out = fn(*args, **kwargs)
                finally:
                    inpeak = win.pop() - before
                st["hist"].append((self.live.get(slot, 0) - before, inpeak))
                st["inpeak"] = inpeak
                st["template"] = scanmark.template(out, flat_in)
        finally:
            self._on.mute -= 1 if n else 0
            self._on.depth -= 1
        if pod_loop:
            self._stage(slot, "post")
        if slot == 0:
            self.growth.setdefault(name, []).append(self.live.get(slot, 0) - before)
        return out

    def custom_outputs(self, kernel: str, outs) -> None:
        """A hand kernel's outputs were allocated by ops the mode saw."""
        return None

    def _stage(self, slot: int, stage: str) -> None:
        """Enter a phase of the pod loop: its peak restarts from the live
        bytes now. `loop` holds the latest step's peak, `post` the peak
        after the latest step, `between` the largest peak after any earlier
        step, `exits` the live bytes at each step's end."""
        with self.lock:
            ph = self.phases.get(slot)
            if ph is None:
                ph = self.phases[slot] = _phases()
            live = self.live.get(slot, 0)
            if stage == "loop" and ph["stage"] == "post":
                ph["between"] = max(ph["between"], ph["post"])
            if stage == "post":
                ph["exits"].append(live)
                ph["post_alloc"] = 0
            ph["stage"] = stage
            ph[stage] = live

def _phases() -> Dict[str, Any]:
    return {"stage": "pre", "pre": 0, "loop": 0, "post": 0, "post_alloc": 0, "between": 0,
            "exits": []}


# ---------------------------------------------------------------------------
# per-program audit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramAudit:
    """One (entry, rung, mesh) program's evidence."""

    entry: str
    rung: int
    mesh: str
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0
    est_argument_bytes: int = 0
    est_output_bytes: int = 0
    estimate_ok: bool = True
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_bytes: int = 0
    node_gathers: List[str] = dataclasses.field(default_factory=list)
    lane_parallel_violation: bool = False
    seconds: float = 0.0
    error: str = ""
    #: "meta", or the device an ON_DEVICE entry ran on
    ran_on: str = "meta"
    #: the card's measured peak above the arguments at the canonical point
    #: (0: not measured; a scan entry's short pricing point when the transfer
    #: pass measured it), and the tracker's at the same point
    cuda_peak_bytes: int = 0
    tracker_peak_bytes: int = 0
    #: the linear pod pricing of a scan entry: pods run, pods priced, bytes
    #: per pod of each field, the loop's per-step growth
    pricing: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return program_key(self.entry, self.rung, self.mesh)

    @property
    def ok(self) -> bool:
        return (
            not self.error
            and self.estimate_ok
            and not self.node_gathers
            and not self.lane_parallel_violation
        )

    def to_budget(self) -> ProgramBudget:
        return ProgramBudget(
            peak_bytes=self.peak_bytes,
            argument_bytes=self.argument_bytes,
            output_bytes=self.output_bytes,
            temp_bytes=self.temp_bytes,
            alias_bytes=self.alias_bytes,
            collectives=dict(self.collectives),
            collective_bytes=self.collective_bytes,
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        d["ok"] = self.ok
        d["seconds"] = round(self.seconds, 3)
        return d


def _estimate_close(est: int, real: int) -> bool:
    return abs(est - real) <= max(
        int(ESTIMATE_REL_TOL * max(est, real)), ESTIMATE_ABS_SLACK
    )


def _estimate_covers(est: int, real: int) -> bool:
    """Sound-upper-bound check: the estimate must cover the measured bytes
    (a small envelope for what the estimate cannot see); it may sit above
    the measurement."""
    return real <= est + max(
        int(ESTIMATE_REL_TOL * max(est, real)), ESTIMATE_ABS_SLACK
    )


def _storages_bytes(tensors) -> Dict[int, int]:
    import torch

    out: Dict[int, int] = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            out[_skey(t)] = _round(t.untyped_storage().nbytes())
    return out


def _run_program(cap, args, kwargs, roles, mesh_tag: str, rung: int, device,
                 steps: Optional[dict] = None) -> dict:
    """One run of the entry over (args, kwargs) at `mesh_tag`: the worst
    slot's byte fields and the exchanges slot 0 made. `steps` shares the
    loop bodies' measurements with an earlier run of the same program."""
    from ..parallel import slots
    from .invariants import _flat_tensors

    from ..parallel.slots import Layout

    full = _layout(mesh_tag, device)
    layout = None
    if full is not None:
        # lane rows never exchange and hold equal lane blocks: the first row
        # runs, and its slots stand for every row's
        blocks = [(_blocks(args, roles[0], full, k),
                   {key: _blocks(v, roles[1][key], full, k) for key, v in kwargs.items()})
                  for k in range(full.cols)]
        if full.cols > 1:
            layout = Layout((full.grid[0],))
    else:
        blocks = [(args, kwargs)]
    per_slot_args = [_storages_bytes(_flat_tensors(b)) for b in blocks]
    arg_keys = set().union(*(set(a) for a in per_slot_args))
    tracker = _Tracker(arg_keys, steps)
    ops: List[Tuple[str, tuple]] = []
    counts: Dict[str, int] = {}
    nbytes = [0]

    def census(kind, n, shape):
        if tracker.muted():
            return
        with tracker.lock:
            counts[kind] = counts.get(kind, 0) + 1
            nbytes[0] += n
            ops.append((kind, shape))

    with slots.census(census):
        if layout is None:
            with tracker.on_thread():
                results = [cap.fn(*blocks[0][0], **blocks[0][1])]
        else:
            sharded = slots.Sharded(layout, blocks, None, None, [])
            with slots.slot_hook(tracker.on_thread):
                results = slots.spmd(lambda ak: cap.fn(*ak[0], **ak[1]), sharded,
                                     layout=layout, n_nodes=rung)
    if any(r is None for r in results):
        raise RuntimeError("a slot's call returned nothing")
    worst = None
    for k, res in enumerate(results):
        outs = _storages_bytes(_flat_tensors(res))
        alias = sum(b for key, b in outs.items() if key in per_slot_args[k])
        out_b = sum(outs.values())
        new_out = out_b - alias
        dyn = tracker.peak.get(k, 0)
        arg_b = sum(per_slot_args[k].values())
        row = {
            "argument_bytes": arg_b, "output_bytes": out_b, "alias_bytes": alias,
            "temp_bytes": max(0, dyn - new_out), "peak_bytes": arg_b + max(dyn, new_out),
            "dyn_peak": max(dyn, new_out),
            "out_shapes": [(tuple(t.shape), t.element_size()) for t in _flat_tensors(res)
                           if _skey(t) not in per_slot_args[k]],
            "phases": tracker.phases.get(k, _phases()),
        }
        if worst is None or row["peak_bytes"] > worst["peak_bytes"]:
            worst = row
    worst["collectives"] = counts
    worst["collective_bytes"] = nbytes[0]
    worst["ops"] = ops
    worst["growth"] = {k: v for k, v in tracker.growth.items()}
    del results
    return worst


#: the two short pod counts a scan entry runs at
PRICING_PODS = (16, 32)
#: the markers of the scan entries' pod loops
POD_LOOPS = frozenset({"ops.kernels:schedule_step", "ops.fast:_scenario_step",
                       "ops.fast:_universe_step"})


def _pod_outputs(r1: dict, r2: dict, p1: int, p2: int) -> List[Tuple[int, tuple, int]]:
    """The entry's pod-proportional outputs (the final stacks), paired
    across the two runs: (itemsize, shape at p1, positions of the pod
    dims)."""
    out = []
    for (s1, isz), (s2, _) in zip(r1["out_shapes"], r2["out_shapes"]):
        pos = tuple(i for i, (a, b) in enumerate(zip(s1, s2)) if a == p1 and b == p2)
        if pos:
            out.append((isz, s1, pos))
    return out


def _rounding(pod_outs, pods: int) -> int:
    """The block-rounding excess of the pod-proportional outputs holding
    `pods` pods: the part of their bytes that is not linear in the pods."""
    tot = 0
    for isz, shape, pos in pod_outs:
        n = isz
        for i, d in enumerate(shape):
            n *= pods if i in pos else d
        tot += _round(n) - n
    return tot


def _price(res: List[dict], p1: int, p2: int, target: int) -> dict:
    """Every byte field at `target` pods from the runs at p1 and p2: linear
    in the pods once the outputs' block rounding is taken out (and put back
    at the target)."""
    pod_outs = _pod_outputs(res[0], res[1], p1, p2)
    c1, c2, ct = (_rounding(pod_outs, p) for p in (p1, p2, target))

    def line(v1, v2, rounded):
        g1, g2 = (v1 - c1, v2 - c2) if rounded else (v1, v2)
        return g1 + -(-(g2 - g1) * (target - p1) // (p2 - p1)) + (ct if rounded else 0)

    fields = {
        "output_bytes": line(res[0]["output_bytes"], res[1]["output_bytes"], True),
        "alias_bytes": line(res[0]["alias_bytes"], res[1]["alias_bytes"], False),
    }
    # the peak is the largest of the phases': before the loop (constant);
    # the last step's and the between-steps' (each the step-end level plus
    # a constant); after the last step (the step-end level plus the final
    # stacks, linear with their rounding); every phase rides on the step-end
    # level, which grows by the per-pod retained bytes
    ph0, ph1 = res[0]["phases"], res[1]["phases"]
    e0, e1 = ph0["exits"][-1], ph1["exits"][-1]
    per_pod = (e1 - e0) // (p2 - p1)
    end = e1 + (target - p2) * per_pod
    grow = (target - p2) * per_pod
    cands = [ph1["pre"], ph1["loop"] + grow, end, fields["output_bytes"] - fields["alias_bytes"]]
    if ph1["between"]:
        cands.append(ph1["between"] + grow)
    if ph0["post_alloc"] and ph1["post_alloc"]:
        cands.append(end + line(ph0["post_alloc"] - e0, ph1["post_alloc"] - e1, True))
    fields["dyn_peak"] = max(cands)
    fields["temp_bytes"] = max(0, fields["dyn_peak"] - (fields["output_bytes"]
                                                        - fields["alias_bytes"]))
    return fields


def audit_program(cap, rung: int, mesh_tag: str, pod_bucket: Optional[int] = None,
                  resize: bool = True, device=None) -> ProgramAudit:
    """Run one entry at (rung, mesh) under the tracker and the exchange
    census (module docstring). Never raises: a failure is the program's
    `error`."""
    import torch

    from ..device import resolve_device
    from . import budget as budget_mod

    dev = resolve_device("cpu" if device is None else device)
    pa = ProgramAudit(entry=cap.name, rung=int(rung), mesh=mesh_tag)
    t0 = time.perf_counter()
    try:
        meta = cap.name not in ON_DEVICE
        pa.ran_on = "meta" if meta else str(dev)
        run_dev = torch.device("meta") if meta else dev
        if cap.name in POD_AXIS:
            rows_p = _captured_pods(cap)
            target = pod_bucket or rows_p
            p1, p2 = PRICING_PODS
            # a short run measures the loop bodies; the two pricing runs then
            # remake every step alike from its measurements
            res, steps = [], {}
            for p in (_Tracker.MEASURED_STEPS + 1, p1, p2):
                a, k, roles = abstract_args(cap, rung, pods=p, meta=meta, resize=resize)
                res.append(_run_program(cap, a, k, roles, mesh_tag, rung, run_dev, steps))
            # the exchanges are the measuring run's: it alone ran the loop body
            census = {f: res[0][f] for f in ("collectives", "collective_bytes", "ops")}
            res = res[1:]
            fields = _price(res, p1, p2, target)
            # the arguments at the target pod count, priced from their shapes
            a, k, roles = abstract_args(cap, rung, pods=target, meta=True, resize=resize)
            fields["argument_bytes"] = _worst_args(a, k, roles, mesh_tag)
            fields["peak_bytes"] = fields["argument_bytes"] + fields["dyn_peak"]
            steady = _steady(res)
            pa.pricing = {"pods_run": [p1, p2], "pods": target, "short_peak": res[1]["dyn_peak"],
                          "per_pod": {f: (res[1][f] - res[0][f]) / (p2 - p1)
                                      for f in ("output_bytes", "dyn_peak")},
                          "step_growth": steady}
            if steady is None:
                raise RuntimeError("per-step growth of the pod loop is not constant; "
                                   "linear pricing does not apply")
            run = dict(res[1], **fields, **census)
        else:
            a, k, roles = abstract_args(cap, rung, meta=meta, resize=resize)
            run = _run_program(cap, a, k, roles, mesh_tag, rung, run_dev)
        for f in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes"):
            setattr(pa, f, int(run[f]))
        pa.tracker_peak_bytes = int(run["dyn_peak"])
        pa.collectives = dict(sorted(run["collectives"].items()))
        pa.collective_bytes = int(run["collective_bytes"])
        pa.est_argument_bytes = budget_mod.estimate_max_bytes_per_device(
            *_slot_trees(a, k, roles, mesh_tag), default_device="meta")
        pa.estimate_ok = _estimate_covers(pa.est_argument_bytes, pa.argument_bytes)
        # at the canonical rung every fixed 64-wide dim is indistinguishable
        # from the node dim: the replication detector has signal only off it
        pa.node_gathers = node_table_gathers(run["ops"], rung) if rung != N_CANON else []
        s_dev, n_dev = parse_mesh(mesh_tag)
        if cap.name in LANE_PARALLEL and n_dev == 1 and s_dev > 1 and pa.collectives:
            pa.lane_parallel_violation = True
    except Exception as e:  # a failure of the run is the program's finding
        pa.error = f"{type(e).__name__}: {e}"
    pa.seconds = time.perf_counter() - t0
    return pa


def _captured_pods(cap) -> int:
    from ..ops.kernels import PodRow

    rows = next(a for a in list(cap.args) + list(cap.kwargs.values()) if isinstance(a, PodRow))
    return int(rows.req.shape[POD_AXIS[cap.name]])


def _steady(res: List[dict]) -> Optional[int]:
    """The pod loop's per-step growth when every step after the first grew
    by the same bytes in both runs, else None."""
    got = None
    for r in res:
        for name, hist in r["growth"].items():
            if name not in POD_LOOPS:
                continue
            tail = set(hist[1:])
            if len(tail) > 1:
                return None
            if tail:
                v = tail.pop()
                if got is not None and v != got:
                    return None
                got = v
    return got if got is not None else 0


def _slot_trees(args, kwargs, roles, mesh_tag: str) -> List[Any]:
    layout = _layout(mesh_tag, "meta")
    if layout is None:
        return [(args, kwargs)]
    k = 0   # slot 0 holds the largest block (tensor_split gives it the remainder)
    return [(_blocks(args, roles[0], layout, k),
             {key: _blocks(v, roles[1][key], layout, k) for key, v in kwargs.items()})]


def _worst_args(args, kwargs, roles, mesh_tag: str) -> int:
    from .invariants import _flat_tensors

    return max(sum(_storages_bytes(_flat_tensors(t)).values())
               for t in _slot_trees(args, kwargs, roles, mesh_tag))


def cuda_peak(cap, device) -> int:
    """The card's peak bytes above the arguments for one real call of the
    capture at its canonical point (the registry capture was the warm
    call)."""
    import torch

    from ..utils.profiling import _fresh_args

    args = _fresh_args(cap)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = cap.fn(*args, **cap.kwargs)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return int(peak)


# ---------------------------------------------------------------------------
# transfer audit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransferCheck:
    entry: str
    ok: bool
    error: str = ""
    #: transfers seen and listed in op_audit.LISTED_TRANSFERS ("op x count")
    listed: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class TransferError(RuntimeError):
    """A host<->device transfer inside a guarded call."""


def _transfer_mode(counts: Dict[str, int]):
    """Counts (by `op:direction`) every copy between the CPU and another
    device and every scalar read to the host."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Guard(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            out = func(*args, **kwargs)
            tag = None
            if name == "_local_scalar_dense":
                tag = name
            elif name in ("_to_copy", "copy_", "copy"):
                src = args[1] if name == "copy_" and len(args) > 1 else args[0]
                dst = args[0] if name == "copy_" else out
                if isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor):
                    s, d = src.device.type, dst.device.type
                    if s != d and "meta" not in (s, d) and "cpu" in (s, d):
                        tag = f"{name}:to_cpu" if d == "cpu" else f"{name}:to_{d}"
            if tag is not None:
                counts[tag] = counts.get(tag, 0) + 1
            return out

    return _Guard()


def guarded_steady_state_check(fn: Any, args: tuple, kwargs: dict, name: str = "",
                               warm: bool = True) -> TransferCheck:
    """Warm-call once (one-time uploads land outside the guard), then call
    again under the transfer mode: any transfer the second call makes is a
    per-call host<->device sync in the hot path, unless the entry lists it
    (op_audit.LISTED_TRANSFERS) with at least that count."""
    from .op_audit import LISTED_TRANSFERS

    name = name or getattr(fn, "__name__", str(fn))
    try:
        if warm:
            fn(*args, **kwargs)
        counts: Dict[str, int] = {}
        with _transfer_mode(counts):
            fn(*args, **kwargs)
        listed = LISTED_TRANSFERS.get(name, {})
        bad = [f"{op} x{n}" for op, n in sorted(counts.items())
               if op not in listed or n > listed[op][0]]
        ok_list = [f"{op} x{n}" for op, n in sorted(counts.items())
                   if op in listed and n <= listed[op][0]]
        if bad:
            return TransferCheck(entry=name, ok=False, listed=ok_list,
                                 error=f"TransferError: host transfer in steady state: "
                                       f"{', '.join(bad)}")
        return TransferCheck(entry=name, ok=True, listed=ok_list)
    except Exception as e:
        return TransferCheck(entry=name, ok=False, error=f"{type(e).__name__}: {e}")


def _guarded_args(cap):
    """The transfer pass's call: fresh copies of the capture's arguments; a
    scan entry's cut to its short pricing point (PRICING_PODS[1] pods: the
    same step code, a sixteenth of the steps)."""
    from ..utils.profiling import _fresh_args

    if cap.name in POD_AXIS:
        args, kwargs, _ = abstract_args(cap, N_CANON, pods=PRICING_PODS[1], meta=False,
                                        resize=cap.name not in FIXED_SHAPE)
        return args, kwargs
    return _fresh_args(cap), cap.kwargs


def transfer_audit(caps: Sequence[Any], device=None,
                   peaks: Optional[Dict[str, int]] = None) -> List[TransferCheck]:
    """Steady-state transfer check of every captured entry (`_guarded_args`);
    the registry capture was the warm call. On a card the same call
    measures the CUDA peak above the arguments into `peaks`."""
    import torch

    from ..device import resolve_device

    dev = resolve_device("cpu" if device is None else device)
    out = []
    for cap in caps:
        args, kwargs = _guarded_args(cap)
        if dev.type == "cuda" and peaks is not None:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        chk = guarded_steady_state_check(cap.fn, args, kwargs, name=cap.name, warm=False)
        if dev.type == "cuda" and peaks is not None:
            torch.cuda.synchronize(dev)
            peaks[cap.name] = int(torch.cuda.max_memory_allocated(dev) - base)
        out.append(chk)
    return out


# ---------------------------------------------------------------------------
# plan_1m_100k verdict
# ---------------------------------------------------------------------------

def hbm_limit_gib(device, hbm_gib: Optional[float]) -> float:
    """The verdict's device memory: the card's total memory on a card, else
    `hbm_gib` (default DEFAULT_HBM_GIB, an H100 80GB HBM3's)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device("cpu" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory / 1024 ** 3
    return float(DEFAULT_HBM_GIB if hbm_gib is None else hbm_gib)


def plan_verdict(caps: Sequence[Any], hbm_gib: Optional[float] = None, device=None) -> dict:
    """Does plan_1m_100k's scenario program (1M pods -> pod bucket, 100k
    nodes -> rung 102400) fit per-slot device memory on a 1x4 node-sharded
    layout with the node table proven sharded (zero full-rung gathers)?
    Priced on `meta`, linearly in the pods (module docstring)."""
    from ..ops.encode import node_bucket, round_up

    rung = node_bucket(100_000)
    pods = round_up(1_000_000)
    cap = next((c for c in caps if c.name == "ops.fast:schedule_scenarios"), None)
    limit = hbm_limit_gib(device, hbm_gib)
    verdict: Dict[str, Any] = {
        "config": "plan_1m_100k",
        "entry": cap.name if cap else "",
        "rung": rung,
        "pod_bucket": pods,
        "mesh": "1x4",
        "hbm_gib": float(limit),
    }
    if cap is None:
        verdict["error"] = "schedule_scenarios not in capture registry"
        verdict["ok"] = False
        return verdict
    pa = audit_program(cap, rung, "1x4", pod_bucket=pods, device=device)
    gib = 1024 ** 3
    verdict.update(
        peak_bytes=pa.peak_bytes,
        peak_gib=round(pa.peak_bytes / gib, 3),
        argument_bytes=pa.argument_bytes,
        output_bytes=pa.output_bytes,
        temp_bytes=pa.temp_bytes,
        alias_bytes=pa.alias_bytes,
        collectives=pa.collectives,
        node_gathers=pa.node_gathers,
        node_table_sharded=not pa.node_gathers,
        fits=pa.peak_bytes <= int(limit * gib),
        compile_seconds=round(pa.seconds, 2),
        pricing=pa.pricing,
        error=pa.error,
    )
    verdict["ok"] = bool(not pa.error and verdict["fits"] and verdict["node_table_sharded"])
    return verdict


# ---------------------------------------------------------------------------
# the preflight driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PreflightReport:
    programs: List[ProgramAudit]
    transfers: List[TransferCheck]
    verdict: Optional[dict]
    violations: List[BudgetViolation]
    meshes_skipped: List[str]
    budgets_path: str = ""
    seconds: float = 0.0
    #: (entry, rung, mesh) cells not run: SCENARIO_ONLY on node-sharded
    #: meshes, FIXED_SHAPE off the canonical point
    programs_skipped: List[str] = dataclasses.field(default_factory=list)
    device: str = "cpu"

    @property
    def ok(self) -> bool:
        return (
            all(p.ok for p in self.programs)
            and all(t.ok for t in self.transfers)
            and (self.verdict is None or self.verdict.get("ok", False))
            and not self.violations
        )

    def measured(self) -> Dict[str, ProgramBudget]:
        return {p.key: p.to_budget() for p in self.programs if not p.error}

    def to_book(self, base: Optional[BudgetBook] = None) -> BudgetBook:
        """A fresh budget book from this run's measurements (the
        --write-budgets flow). Keeps ``base``'s tolerance knobs and any
        budgets for programs this run didn't measure."""
        book = BudgetBook()
        if base is not None:
            book.tolerance = base.tolerance
            book.slack_bytes = base.slack_bytes
            book.programs = dict(base.programs)
            book.verdicts = dict(base.verdicts)
        book.programs.update(self.measured())
        if self.verdict is not None:
            book.verdicts[str(self.verdict.get("config", "plan"))] = {
                k: v for k, v in self.verdict.items() if k != "compile_seconds"
            }
        return book

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "device": self.device,
            "programs": [p.to_dict() for p in self.programs],
            "transfers": [t.to_dict() for t in self.transfers],
            "verdict": self.verdict,
            "violations": [v.to_dict() for v in self.violations],
            "meshes_skipped": list(self.meshes_skipped),
            "programs_skipped": list(self.programs_skipped),
            "budgets_path": self.budgets_path,
            "seconds": round(self.seconds, 2),
        }

    def render_text(self) -> str:
        lines = [
            f"preflight: {'ok' if self.ok else 'FAILED'} — "
            f"{len(self.programs)} program(s) audited in {self.seconds:.1f}s"
        ]
        mib = 1024 ** 2
        for p in sorted(self.programs, key=lambda p: p.key):
            colls = (
                ",".join(f"{k}:{v}" for k, v in sorted(p.collectives.items()))
                or "-"
            )
            status = "ok" if p.ok else "FAIL"
            where = "" if p.ran_on == "meta" else f" (on {p.ran_on})"
            lines.append(
                f"  {status:4s} {p.key:52s} peak {p.peak_bytes / mib:9.2f} MiB"
                f"  colls {colls}{where}"
            )
            if p.cuda_peak_bytes:
                lines.append(f"       card peak {p.cuda_peak_bytes} B, tracker "
                             f"{p.tracker_peak_bytes} B")
            if p.error:
                lines.append(f"       error: {p.error}")
            if not p.estimate_ok:
                lines.append(
                    f"       estimate mismatch: est arg {p.est_argument_bytes} vs "
                    f"{p.argument_bytes}, tracker peak {p.tracker_peak_bytes} vs card "
                    f"{p.cuda_peak_bytes}"
                )
            if p.node_gathers:
                lines.append(f"       NODE TABLE REPLICATED: {p.node_gathers}")
            if p.lane_parallel_violation:
                lines.append(
                    "       lane-parallel entry exchanges across slots on a "
                    "scenario-only mesh"
                )
        for t in self.transfers:
            if not t.ok:
                lines.append(f"  transfer {t.entry}: {t.error}")
        if self.transfers and all(t.ok for t in self.transfers):
            lines.append(
                f"  transfers: {len(self.transfers)} entries steady-state "
                f"clean under the transfer mode"
            )
        if self.programs_skipped:
            lines.append(
                f"  skipped {len(self.programs_skipped)} combo(s) outside "
                f"entry capability (scenario-only on node-sharded meshes; "
                f"fixed-shape off the canonical point): "
                f"{', '.join(self.programs_skipped)}"
            )
        for v in self.violations:
            lines.append(f"  budget: {v.render()}")
        if self.verdict is not None:
            v = self.verdict
            if v.get("error"):
                lines.append(f"  verdict {v['config']}: ERROR {v['error']}")
            else:
                lines.append(
                    f"  verdict {v['config']}: "
                    f"{'fits' if v['fits'] else 'DOES NOT FIT'} — peak "
                    f"{v['peak_gib']} GiB/slot vs {v['hbm_gib']:.2f} GiB device memory "
                    f"at mesh {v['mesh']} (rung {v['rung']}, "
                    f"{v['pod_bucket']} pods; node table "
                    f"{'sharded' if v['node_table_sharded'] else 'REPLICATED'})"
                )
        return "\n".join(lines)


def run_preflight(
    rungs: Optional[Sequence[int]] = None,
    meshes: Optional[Sequence[str]] = None,
    entries: Optional[Sequence[str]] = None,
    caps: Optional[Sequence[Any]] = None,
    book: Optional[BudgetBook] = None,
    transfers: bool = True,
    verdict: bool = True,
    hbm_gib: Optional[float] = None,
    device=None,
) -> PreflightReport:
    """The full preflight: capture registry -> (entry x rung x mesh) matrix
    on `meta` -> budget diff -> transfer audit -> plan verdict. ``caps``
    skips the capture pass (tests, audit --memory, check); ``entries``
    filters by audit name. On a card the canonical point of each entry is
    also measured for real (module docstring)."""
    from ..device import DEFAULT_DEVICE, resolve_device

    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    t0 = time.perf_counter()
    if caps is None:
        from . import entry_audit

        caps = entry_audit._capture_calls(dev)
    if entries is not None:
        wanted = set(entries)
        caps = [c for c in caps if c.name in wanted]
    seen: Dict[str, Any] = {}
    for c in caps:
        seen.setdefault(c.name, c)
    caps = [seen[n] for n in sorted(seen)]
    rungs = tuple(rungs) if rungs else DEFAULT_RUNGS
    mesh_tags = list(meshes) if meshes else list(DEFAULT_MESHES)
    for t in mesh_tags:
        parse_mesh(t)

    programs: List[ProgramAudit] = []
    programs_skipped: List[str] = []
    for cap in caps:
        if cap.name in FIXED_SHAPE:
            programs.append(audit_program(cap, N_CANON, "1", resize=False, device=dev))
            programs_skipped.extend(
                program_key(cap.name, rung, tag)
                for rung in rungs for tag in mesh_tags
                if (rung, tag) != (N_CANON, "1")
            )
            continue
        # an entry with no lane axis runs the same program on every lane row:
        # its SxN cell is its 1xN cell (the first row stands for every row)
        lanes = _lanes_of(cap) is not None
        done: Dict[Tuple[int, int], ProgramAudit] = {}
        for rung in rungs:
            for tag in mesh_tags:
                s_dev, n_dev = parse_mesh(tag)
                if cap.name in SCENARIO_ONLY and n_dev > 1:
                    programs_skipped.append(program_key(cap.name, rung, tag))
                    continue
                same = done.get((rung, n_dev)) if not lanes else None
                if same is not None and not same.error:
                    programs.append(dataclasses.replace(same, mesh=tag, seconds=0.0))
                    continue
                pa = audit_program(cap, rung, tag, device=dev)
                done.setdefault((rung, n_dev), pa)
                programs.append(pa)

    peaks: Dict[str, int] = {}
    checks: List[TransferCheck] = []
    if transfers:
        checks = transfer_audit(caps, dev, peaks if dev.type == "cuda" else None)
    elif dev.type == "cuda":
        for cap in caps:
            peaks[cap.name] = cuda_peak(cap, dev)
    for p in programs:
        if (p.rung, p.mesh) == (N_CANON, "1") and p.entry in peaks:
            p.cuda_peak_bytes = peaks[p.entry]
            if transfers and p.pricing:
                # the transfer pass ran a scan entry at its short point
                p.tracker_peak_bytes = p.pricing["short_peak"]
            if not p.error:
                p.estimate_ok = p.estimate_ok and _estimate_covers(
                    p.tracker_peak_bytes, p.cuda_peak_bytes)

    violations: List[BudgetViolation] = []
    if book is not None:
        violations = book.diff({p.key: p.to_budget() for p in programs if not p.error})

    vd = plan_verdict(caps, hbm_gib=hbm_gib, device=dev) if verdict else None
    return PreflightReport(
        programs=programs,
        transfers=checks,
        verdict=vd,
        violations=violations,
        meshes_skipped=[],
        programs_skipped=programs_skipped,
        seconds=time.perf_counter() - t0,
        device=str(dev),
    )


def report_json(report: PreflightReport) -> str:
    return json.dumps(report.to_dict(), indent=2, sort_keys=True)
