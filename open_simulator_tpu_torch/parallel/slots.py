"""Mesh slots: the single-controller runtime under parallel/mesh.py.

A mesh is a grid of slots, each naming a torch.device (a device may
repeat). A tree laid out over the mesh (`Sharded`) keeps one block per
slot on that slot's device. `spmd` runs a function once per slot, one host
thread each, with that slot's blocks: the same code the unsharded path
runs. Lane blocks never talk to each other. Slots that split the node axis
of one lane block form a group, and the only places their code crosses
slots are the node-axis reductions, written through the hooks below:

  node_ids, node_sum, node_amin, node_amax, node_any, node_all,
  node_argmax, owned, local_index, count_nodes, host_nodes, on_root,
  whole_nodes.

Outside a node group (no mesh, or a slot that holds every node row) each
hook is the plain PyTorch expression of the unsharded path. Inside one, a
hook reduces its slot's block and combines the partials of the group:
amin/amax and any/all exactly; sums of integer-valued values exactly (they
stay below 2**24); an argmax as (max value, lowest global index), NaN
first as torch.argmax, so a tie across a block boundary goes to the lower
slot; a one-hot row select as the owner slot's value. The combine runs in
slot order on every slot of the group, so all of them hold the same bits.

The combines also run under torch.func.vmap (the scenario scan and the
wave probe): a partial is unwrapped from its vmap levels, batch dimensions
first, the plain tensors are combined (every combine is elementwise over
leading dimensions) and the result is wrapped back at the same levels.
The partials of one combine must sit at the same levels.

Two hooks serve the preflight (analysis/preflight.py) and cost nothing
otherwise: `census(fn)` calls fn(kind, operand bytes, output shape) on the
mesh's first slot for every combine (`all-reduce:<kind>`) and every gather
of node data (`all-gather:<site>`); `slot_hook(factory)` enters
factory() around each slot's call on that slot's thread (a dispatch mode
is thread-local, so an analysis that follows the slots' work enters its
own there).

`on_root` runs a whole-vector step (a stable sort of all lanes, a pop
loop) once, on the group's first slot: it gathers the given node vectors
there in global order, runs the function with the hooks switched off, and
hands its outputs to every slot of the group. `whole_nodes` does the same
for a function that does not go through the hooks at all (an out-of-tree
plugin): it gathers whole trees, under vmap too, and hands each slot its
block of the node vector that comes out.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

_tls = threading.local()

#: the census callback of the running preflight (None: off); a ContextVar,
#: so spmd's slot threads see the caller's
_census: contextvars.ContextVar = contextvars.ContextVar("osim_mesh_census", default=None)
#: context-manager factories entered around each slot's call (`slot_hook`)
_slot_hooks: tuple = ()
_hooks_lock = threading.Lock()


@contextlib.contextmanager
def census(fn: Callable):
    """Call fn(kind, operand_bytes, output_shape) for every cross-slot
    exchange inside the block, on the mesh's first slot (module
    docstring)."""
    token = _census.set(fn)
    try:
        yield fn
    finally:
        _census.reset(token)


def _count(kind: str, nbytes: int, shape: tuple) -> None:
    fn = _census.get()
    if fn is not None and getattr(_tls, "slot", 0) == 0:
        fn(kind, nbytes, tuple(shape))


@contextlib.contextmanager
def slot_hook(factory: Callable):
    """Enter factory() around every slot's call inside the block, on the
    slot's thread."""
    global _slot_hooks
    with _hooks_lock:
        _slot_hooks = _slot_hooks + (factory,)
    try:
        yield factory
    finally:
        with _hooks_lock:
            _slot_hooks = tuple(h for h in _slot_hooks if h is not factory)


class _Group:
    """The slots of one lane block that split its node axis. They run one
    at a time, in slot order, passing a turn at every exchange: a slot
    deposits its partial, hands the turn on and waits for it to come back,
    by which time every slot of the group has deposited. Only one of the
    group's threads is ever runnable, so they never contend for the
    interpreter. Deposits alternate between two buffers (a slot writes
    buffer k again only after every slot has taken its turn since, so
    after every slot has read buffer k)."""

    def __init__(self, size: int) -> None:
        self.size = size
        self.turns = [threading.Event() for _ in range(size)]
        self.turns[0].set()
        self.broken = False
        self.bufs = ([None] * size, [None] * size)

    def wait_turn(self, rank: int) -> None:
        self.turns[rank].wait()
        self.turns[rank].clear()
        if self.broken:
            raise threading.BrokenBarrierError

    def pass_turn(self, rank: int) -> None:
        self.turns[(rank + 1) % self.size].set()

    def abort(self) -> None:
        self.broken = True
        for t in self.turns:
            t.set()


class SlotContext:
    """What a slot's thread knows about its place in the node group."""

    def __init__(self, group: _Group, rank: int, offset: int, size: int, n_global: int,
                 device: torch.device) -> None:
        self.group, self.rank = group, rank
        self.offset, self.size, self.n_global = offset, size, n_global
        self.device = device
        self.seq = 0

    def exchange(self, obj) -> list:
        """Every slot's `obj`, in slot order."""
        buf = self.group.bufs[self.seq & 1]
        self.seq += 1
        buf[self.rank] = obj
        self.group.pass_turn(self.rank)
        self.group.wait_turn(self.rank)
        return list(buf)


def current() -> Optional[SlotContext]:
    """The calling thread's node-group context (None: no node split)."""
    return getattr(_tls, "ctx", None)


def is_root() -> bool:
    """True on the mesh's first slot (and off any mesh): the one slot that
    counts routes and records timings for a run."""
    return getattr(_tls, "slot", 0) == 0


# ---------------------------------------------------------------------------
# combines
# ---------------------------------------------------------------------------

def _reduce(kind: str, parts: list):
    """Combine the group's partials (tuples of tensors, one per slot, in
    slot order) over a new leading slot axis."""
    first = torch.stack([p[0] for p in parts])
    if kind == "argmax":
        # torch.argmax takes the first maximum (NaN first): the lowest slot
        at = first.argmax(dim=0, keepdim=True)
        idx = torch.stack([p[1] for p in parts])
        return first.gather(0, at)[0], idx.gather(0, at)[0]
    if kind == "owned":
        at = torch.stack([p[1] for p in parts]).to(torch.uint8).argmax(dim=0, keepdim=True)
        return first.gather(0, at)[0]
    if kind == "sum":
        return first.sum(dim=0, dtype=first.dtype)
    if kind == "min":
        return first.amin(dim=0)
    if kind == "max":
        return first.amax(dim=0)
    if kind == "any":
        return first.any(dim=0)
    if kind == "all":
        return first.all(dim=0)
    raise ValueError(f"unknown combine {kind!r}")


def _here(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def _exchange_reduce(kind: str, *parts):
    """The combine of `kind` over the group's plain partials `parts`, on
    this slot's device."""
    ctx = current()
    _count(f"all-reduce:{kind}", sum(t.numel() * t.element_size() for t in parts),
           tuple(parts[0].shape))
    got = ctx.exchange(parts)
    return _reduce(kind, [tuple(_here(t, ctx.device) for t in p) for p in got])


def _unbatch(t: torch.Tensor):
    """(t as a plain tensor with the batch dimension of each vmap level
    that wraps it moved to the front, the levels outermost wrapper first)."""
    levels = []
    while _ft.is_batchedtensor(t):
        levels.append(_ft.maybe_get_level(t))
        t = _ft.get_unwrapped(t).movedim(_ft.maybe_get_bdim(t), 0)
    return t, levels


def _rebatch(t: torch.Tensor, levels: list) -> torch.Tensor:
    for level in reversed(levels):
        t = _ft._add_batch_dim(t, 0, level)
    return t


def _combine(kind: str, *parts):
    """The combine of `kind` over the group's partials `parts`. Under vmap
    the partials are unwrapped to plain tensors and the result wrapped
    back at the same levels."""
    plain = [_unbatch(p) for p in parts]
    levels = plain[0][1]
    if any(lv != levels for _, lv in plain[1:]):
        raise ValueError(f"the partials of a {kind!r} combine sit at different vmap levels")
    out = _exchange_reduce(kind, *(p for p, _ in plain))
    if isinstance(out, tuple):
        return tuple(_rebatch(o, levels) for o in out)
    return _rebatch(out, levels)


_ft = torch._C._functorch


# ---------------------------------------------------------------------------
# node-axis hooks (plain expressions off a node group)
# ---------------------------------------------------------------------------

def node_ids(n: int, device) -> torch.Tensor:
    """Global indices of the n node rows of this slot's block."""
    ctx = current()
    ids = torch.arange(n, device=device)
    return ids if ctx is None else ids + ctx.offset


def node_count(n: int) -> int:
    """The node axis length over the whole group (n off a group)."""
    ctx = current()
    return n if ctx is None else ctx.n_global


def node_sum(x: torch.Tensor, dim: int, dtype=None) -> torch.Tensor:
    """x.sum(dim) over the node axis `dim`, for integer-valued values."""
    part = x.sum(dim=dim) if dtype is None else x.sum(dim=dim, dtype=dtype)
    return part if current() is None else _combine("sum", part)


def node_amin(x: torch.Tensor, dim=None) -> torch.Tensor:
    part = x.amin() if dim is None else x.amin(dim=dim)
    return part if current() is None else _combine("min", part)


def node_amax(x: torch.Tensor, dim=None) -> torch.Tensor:
    part = x.amax() if dim is None else x.amax(dim=dim)
    return part if current() is None else _combine("max", part)


def node_any(x: torch.Tensor, dim=None) -> torch.Tensor:
    part = x.any() if dim is None else x.any(dim=dim)
    return part if current() is None else _combine("any", part)


def node_all(x: torch.Tensor, dim=None) -> torch.Tensor:
    part = x.all() if dim is None else x.all(dim=dim)
    return part if current() is None else _combine("all", part)


def node_argmax(x: torch.Tensor) -> torch.Tensor:
    """x.argmax() of a node vector: the first maximum's global index."""
    ctx = current()
    if ctx is None:
        return x.argmax()
    return _combine("argmax", x.amax(), x.argmax() + ctx.offset)[1]


def argmax_value(x: torch.Tensor):
    """(node i64[1], value f32[1]) of a node vector's first maximum, the
    value read back as x.gather(0, node) reads it."""
    ctx = current()
    if ctx is None:
        node = x.argmax().view(1)
        return node, x.gather(0, node)
    val, node = _combine("argmax", x.amax(), x.argmax() + ctx.offset)
    return node.view(1), val.view(1)


def local_index(idx: torch.Tensor, n: int):
    """(local row, owned mask) of global node indices on this slot's block
    of n rows; off a group (idx, None), the unsharded expression."""
    ctx = current()
    if ctx is None:
        return idx, None
    local = idx - ctx.offset
    mine = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), mine


def owned(v: torch.Tensor, mine: Optional[torch.Tensor]) -> torch.Tensor:
    """The owner slot's value of `v` (elementwise, `mine` broadcastable to
    it): a row read at a global index, taken from the one slot holding
    that row. Off a group, v."""
    if mine is None:
        return v
    return _combine("owned", v, mine.expand_as(v))


def take(x: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """x.gather(0, node) of a node vector at global indices `node`."""
    local, mine = local_index(node, x.shape[0])
    got = x.gather(0, local)
    return owned(got, mine)


def count_nodes(n: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """zeros(n).index_add_(0, idx, val) for global node indices (in range)
    and int32 values: this slot's block of the per-node counts."""
    local, mine = local_index(idx.long(), n)
    v = val.to(torch.int32)
    if mine is not None:
        v = torch.where(mine, v, 0)
    return torch.zeros(n, dtype=torch.int32, device=idx.device).index_add_(0, local, v)


def host_nodes(t: torch.Tensor, dim: int = 0) -> np.ndarray:
    """t on the host, its node axis `dim` gathered in global order."""
    ctx = current()
    if ctx is None:
        return t.cpu().numpy()
    shape = list(t.shape)
    shape[dim] = ctx.n_global
    _count("all-gather:host_nodes", t.numel() * t.element_size(), tuple(shape))
    return np.concatenate(ctx.exchange(t.cpu().numpy()), axis=dim)


def on_root(fn: Callable, *node_vecs: torch.Tensor):
    """fn(*node_vecs) with each vector whole: in a node group, the vectors
    (node-major on dim 0) are gathered onto the group's first slot, fn runs
    there once with the hooks off, and every slot gets its outputs (a
    tensor or a tuple of tensors) on its own device."""
    ctx = current()
    if ctx is None:
        return fn(*node_vecs)
    for v in node_vecs:
        _count("all-gather:on_root", v.numel() * v.element_size(),
               (v.shape[0] * ctx.n_global // max(ctx.size, 1),) + tuple(v.shape[1:]))
    parts = ctx.exchange(node_vecs)
    out = None
    if ctx.rank == 0:
        whole = [torch.cat([p[k].to(ctx.device) for p in parts]) for k in range(len(node_vecs))]
        _tls.ctx = None
        try:
            out = fn(*whole)
        finally:
            _tls.ctx = ctx
    got = ctx.exchange(out)[0]
    if isinstance(got, tuple):
        return tuple(t.to(ctx.device) for t in got)
    return got.to(ctx.device)


def whole_nodes(fn: Callable, args: Sequence, dims: Sequence):
    """fn(*args) -> a node vector, for a function that does not go through
    the hooks (an out-of-tree plugin may reduce over nodes or read node
    indices). In a node group, each argument (a tensor or a NamedTuple of
    tensors; `dims` names its leaves' node dimensions, None for a whole
    argument or leaf) is gathered in global order onto the group's first
    slot, fn runs there once with the hooks off, and each slot gets its
    block of the result. Under vmap, leaves are unwrapped from their levels
    and wrapped back at the same levels (every slot of a group runs the
    same code, so its levels are the first slot's)."""
    ctx = current()
    if ctx is None:
        return fn(*args)
    flat = []       # per argument, per leaf: (plain, levels, node dim)
    for a, d in zip(args, dims):
        ds = leaves(d) if d is not None else [None] * len(leaves(a))
        flat.append([(*_unbatch(x), nd) for x, nd in zip(leaves(a), ds)])
    for arg in flat:
        for p, levels, nd in arg:
            if nd is not None:
                shape = list(p.shape)
                shape[nd + len(levels)] = ctx.n_global
                _count("all-gather:whole_nodes", p.numel() * p.element_size(), tuple(shape))
    parts = ctx.exchange([[p if nd is not None else None for p, _, nd in arg] for arg in flat])
    out = None
    if ctx.rank == 0:
        whole = []
        for ai, (a, arg) in enumerate(zip(args, flat)):
            got = [
                x if nd is None else _rebatch(
                    torch.cat([q[ai][li].to(ctx.device) for q in parts], dim=nd + len(levels)),
                    levels,
                )
                for li, (x, (_, levels, nd)) in enumerate(zip(leaves(a), arg))
            ]
            whole.append(rebuild(a, got))
        _tls.ctx = None
        try:
            out = _unbatch(fn(*whole))
        finally:
            _tls.ctx = ctx
    plain, levels = ctx.exchange(out)[0]
    return _rebatch(plain.to(ctx.device).narrow(len(levels), ctx.offset, ctx.size), levels)


# ---------------------------------------------------------------------------
# trees laid out over a mesh
# ---------------------------------------------------------------------------

def leaves(tree) -> list:
    """A NamedTuple's leaves, or [tree] for one tensor (or one spec)."""
    return list(tree) if hasattr(tree, "_fields") else [tree]


def rebuild(template, new_leaves):
    if hasattr(template, "_fields"):
        return type(template)(*new_leaves)
    return new_leaves[0]


def split_sizes(n: int, parts: int) -> List[int]:
    """Block lengths of n rows over `parts` blocks, torch.tensor_split's."""
    return [int(len(c)) for c in np.array_split(np.arange(n), parts)]


class Layout(NamedTuple):
    """Where a tree's blocks lie: the mesh's device grid as lane rows x node
    columns (a 1-D node mesh is one row, a scenario mesh one column)."""
    grid: tuple            # ((device, ...), ...) lane rows of node columns

    @property
    def rows(self) -> int:
        return len(self.grid)

    @property
    def cols(self) -> int:
        return len(self.grid[0])

    @property
    def slots(self) -> int:
        return self.rows * self.cols

    def device(self, k: int) -> torch.device:
        return self.grid[k // self.cols][k % self.cols]


class Sharded:
    """A tree (a NamedTuple of tensors, or one tensor) laid out over a
    mesh: `blocks[k]` is slot k's block, on slot k's device. Per leaf,
    `lane_dims` / `node_dims` name the dimension split over the lane rows /
    node columns (None: the leaf is whole in every block of that axis).
    Global index = block offset + local index, in tensor_split order."""

    def __init__(self, layout: Layout, blocks: list, lane_dims, node_dims, shapes) -> None:
        self.layout, self.blocks = layout, list(blocks)
        self.lane_dims, self.node_dims, self.shapes = lane_dims, node_dims, shapes

    @property
    def template(self):
        return self.blocks[0]

    @property
    def shape(self) -> tuple:
        """The whole shape of a one-tensor tree."""
        return tuple(self.shapes[0])

    @property
    def device(self) -> torch.device:
        """The first slot's device."""
        return self.layout.device(0)

    @property
    def n_global(self) -> Optional[int]:
        """The node axis length of the whole tree."""
        for d, shape in zip(leaves(self.node_dims), self.shapes):
            if d is not None:
                return int(shape[d])
        return None

    def with_blocks(self, blocks: list) -> "Sharded":
        """The same layout over new blocks (an op's per-slot outputs); the
        global shapes follow the blocks' row counts."""
        out = Sharded(self.layout, blocks, self.lane_dims, self.node_dims, None)
        out.shapes = [tuple(s) for s in _joined_shapes(out)]
        return out

    def gather(self, device=None):
        """The whole tree, in global order, on `device` (default: slot 0's)."""
        dev = self.layout.device(0) if device is None else torch.device(device)
        L = self.layout
        for leaf, shape in zip(leaves(self.blocks[0]), self.shapes or ()):
            _count("all-gather:gather", leaf.numel() * leaf.element_size(), tuple(shape))
        out = []
        for li, (ld, nd) in enumerate(zip(leaves(self.lane_dims), leaves(self.node_dims))):
            rows = []
            for i in range(L.rows if ld is not None else 1):
                cols = [leaves(self.blocks[i * L.cols + j])[li].to(dev)
                        for j in range(L.cols if nd is not None else 1)]
                rows.append(torch.cat(cols, dim=nd) if nd is not None else cols[0])
            out.append(torch.cat(rows, dim=ld) if ld is not None else rows[0])
        return rebuild(self.template, out)


def _joined_shapes(sh: Sharded):
    L = sh.layout
    for li, (ld, nd) in enumerate(zip(leaves(sh.lane_dims), leaves(sh.node_dims))):
        shape = list(leaves(sh.blocks[0])[li].shape)
        if nd is not None:
            shape[nd] = sum(leaves(sh.blocks[j])[li].shape[nd] for j in range(L.cols))
        if ld is not None:
            shape[ld] = sum(leaves(sh.blocks[i * L.cols])[li].shape[ld] for i in range(L.rows))
        yield shape


def lay_out(layout: Layout, tree, lane_dims, node_dims) -> Sharded:
    """Split `tree` into equal contiguous blocks, one per slot, each copied
    onto its slot's device."""
    blocks = [[] for _ in range(layout.slots)]
    for leaf, ld, nd in zip(leaves(tree), leaves(lane_dims), leaves(node_dims)):
        rows = leaf.tensor_split(layout.rows, dim=ld) if ld is not None else [leaf] * layout.rows
        for i, r in enumerate(rows):
            cols = r.tensor_split(layout.cols, dim=nd) if nd is not None else [r] * layout.cols
            for j, c in enumerate(cols):
                k = i * layout.cols + j
                blocks[k].append(c.to(layout.device(k), copy=True))
    return Sharded(
        layout, [rebuild(tree, b) for b in blocks], lane_dims, node_dims,
        [tuple(a.shape) for a in leaves(tree)],
    )


def find_sharded(*args) -> Optional[Sharded]:
    for a in args:
        if isinstance(a, Sharded):
            return a
    return None


class NodeSlice(NamedTuple):
    """A whole tensor argument of `spmd` that each slot receives split: its
    lane rows on `lane_dim`, its node columns on `node_dim`."""
    tensor: torch.Tensor
    node_dim: Optional[int] = None
    lane_dim: Optional[int] = None


def _slice_for(arg: NodeSlice, layout: Layout, k: int) -> torch.Tensor:
    t = arg.tensor
    i, j = divmod(k, layout.cols)
    if arg.lane_dim is not None:
        t = t.tensor_split(layout.rows, dim=arg.lane_dim)[i]
    if arg.node_dim is not None:
        t = t.tensor_split(layout.cols, dim=arg.node_dim)[j]
    return t


def _on_device(arg, dev: torch.device):
    if isinstance(arg, torch.Tensor):
        return arg.to(dev)
    if isinstance(arg, tuple) and hasattr(arg, "_fields") and all(
        isinstance(a, torch.Tensor) for a in arg
    ):
        return type(arg)(*(a.to(dev) for a in arg))
    return arg


def spmd(fn: Callable, *args, layout: Optional[Layout] = None, n_nodes: Optional[int] = None) -> list:
    """fn(*args) once per slot of the args' layout: a Sharded argument
    becomes the slot's block, a NodeSlice its slice, a tensor (or a
    NamedTuple of tensors) moves to the slot's device. Lane rows run one
    after another on the calling thread; the slots of a row that split its
    node axis run as one node group, a thread each, taking turns. Returns
    the per-slot results in slot order; the first error any slot raised is
    raised here, after every thread has ended."""
    first = find_sharded(*args)
    if layout is None:
        layout = first.layout
    if n_nodes is None and first is not None:
        n_nodes = first.n_global
    sizes = split_sizes(n_nodes, layout.cols) if n_nodes is not None else [0] * layout.cols
    offsets = [sum(sizes[:j]) for j in range(len(sizes))]
    results: list = [None] * layout.slots
    errors: list = []

    def work(k: int, group: Optional[_Group]) -> None:
        j = k % layout.cols
        dev = layout.device(k)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        prev = getattr(_tls, "slot", 0), current()
        _tls.slot = k
        if group is not None:
            _tls.ctx = SlotContext(group, j, offsets[j], sizes[j], n_nodes, dev)
        try:
            if group is not None:
                group.wait_turn(j)
            with contextlib.ExitStack() as hooks:
                for factory in _slot_hooks:
                    hooks.enter_context(factory())
                slot_args = [
                    a.blocks[k] if isinstance(a, Sharded)
                    else _slice_for(a, layout, k).to(dev) if isinstance(a, NodeSlice)
                    else _on_device(a, dev)
                    for a in args
                ]
                results[k] = fn(*slot_args)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors.append((k, e))
            if group is not None:
                group.abort()
        finally:
            if group is not None:
                group.pass_turn(j)
            _tls.slot, _tls.ctx = prev

    for i in range(layout.rows):
        if layout.cols == 1:
            work(i, None)
        else:
            group = _Group(layout.cols)
            threads = [
                threading.Thread(
                    target=contextvars.copy_context().run,
                    args=(work, i * layout.cols + j, group),
                    name=f"mesh-slot-{i * layout.cols + j}", daemon=True,
                )
                for j in range(layout.cols)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            break
    if errors:
        real = [e for e in errors if not isinstance(e[1], threading.BrokenBarrierError)]
        raise min(real or errors, key=lambda e: e[0])[1]
    return results


def lane_rows(results: Sequence, layout: Layout, dim: int = 0):
    """Per-slot outputs that split lanes and are whole on the node axis:
    node column 0's of each lane row, joined along `dim`."""
    firsts = [results[i * layout.cols] for i in range(layout.rows)]
    dev = layout.device(0)
    if layout.rows == 1:
        return firsts[0]
    if isinstance(firsts[0], torch.Tensor):
        return torch.cat([r.to(dev) for r in firsts], dim=dim)
    return type(firsts[0])(*(
        torch.cat([r[f].to(dev) for r in firsts], dim=dim) for f in range(len(firsts[0]))
    ))


def node_cols(results: Sequence, layout: Layout, dim: int = 0) -> torch.Tensor:
    """Per-slot outputs that split the node axis and are whole on the lanes:
    lane row 0's node blocks joined along `dim`, on the first slot's
    device."""
    dev = layout.device(0)
    return torch.cat([results[j].to(dev) for j in range(layout.cols)], dim=dim)


def with_state(res: Sequence, carry: Sharded) -> tuple:
    """(carry laid out as `carry`, the first slot's other outputs) from the
    per-slot results of an op returning (carry, ...) whose other outputs
    every slot holds whole."""
    return (carry.with_blocks([r[0] for r in res]),) + tuple(res[0][1:])

