"""Device meshes: shard the node axis, the scenario axis, or both.

The port of the JAX package's parallel/mesh.py, with a single controller
as there: one process issues to every device. A `Mesh` is a grid of
torch.devices with axis names "nodes" and/or "scenarios"; a device may
repeat, so a mesh of 4 slots on one card (or on the CPU) runs the same
split-and-combine code a 4-card mesh runs.

The node axis: the [N, ...] node tables and carry planes are laid out in
equal contiguous blocks, one per slot (`shard_state`). Per-node filters and
scores run on each slot's block; the node-axis reductions (domain counts,
host minima, the spread/affinity maxima, min-max normalizations, one-hot
row selects, the argmax) combine across slots through the hooks of
parallel/slots.py, exactly. Where the fast path needs a whole per-node or
per-lane vector (the sort path's keys, the domain path's class tables), it
gathers that vector onto the first slot's device; the tables never move.

The scenario axis: lanes of the batched commit engine are independent, so
`shard_scenarios` splits the stacked carry, valid masks and weights by lane
block, the node tables replicated, and each slot runs its lanes with no
cross-slot traffic until the host gathers the results. `product_mesh_2d`
composes both: lanes split over the scenario axis AND every node-axis
tensor splits over the node axis (`shard_scenarios_2d`).

Shard specs (`node_sharding` / `carry_sharding`) give, per leaf, the
dimension that is the node axis, or None for a replicated leaf: the
reference's PartitionSpecs with NODE_AXIS written as its position.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.kernels import CARRY_DIMS, NODE_DIMS, Carry, NodeStatic, PodRow, pod_keys, schedule_step
from .slots import Layout, Sharded, lay_out, leaves, rebuild, spmd

NODE_AXIS = "nodes"
SCENARIO_AXIS = "scenarios"


class Mesh:
    """A grid of mesh slots, each a torch.device, with named axes."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        grid = np.empty(np.shape(np.array(devices, dtype=object)), dtype=object)
        for idx, d in np.ndenumerate(np.array(devices, dtype=object)):
            grid[idx] = torch.device(d)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} axis names")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def layout(self) -> Layout:
        """The grid as lane rows (the scenario axis) x node columns (the
        node axis); a missing axis has one."""
        s, n = self.shape.get(SCENARIO_AXIS, 1), self.shape.get(NODE_AXIS, 1)
        grid = self.devices.reshape(s, n)
        return Layout(tuple(tuple(grid[i, j] for j in range(n)) for i in range(s)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D node-axis mesh over `devices` (default: every CUDA device)."""
    devices = list(devices if devices is not None else _cuda_devices())
    return Mesh(devices, (NODE_AXIS,))


def _cuda_devices() -> list:
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices_for(n: int, device) -> list:
    """n slots: the first n CUDA devices (0 = all of them), or n slots on
    the one CPU device (0 = 1)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * max(n, 1)
    cards = _cuda_devices()
    if n > len(cards):
        raise ValueError(
            f"--devices {n} requested but only {len(cards)} CUDA devices are visible"
        )
    return cards[:n] if n > 0 else cards


def product_mesh(n_devices: int = 0, device=DEFAULT_DEVICE) -> Optional[Mesh]:
    """Mesh for the product engine: the first n_devices CUDA devices (all
    when 0), or n_devices slots on the CPU. None for a single slot:
    single-device runs skip sharding entirely."""
    if n_devices < 0:
        raise ValueError(f"--devices must be >= 0, got {n_devices}")
    if n_devices == 1:
        return None
    devices = _devices_for(n_devices, device)
    return None if len(devices) == 1 else make_mesh(devices)


def product_mesh_2d(scenario_devices: int, node_devices: int, device=DEFAULT_DEVICE) -> Optional[Mesh]:
    """An explicit 2-D (SCENARIO_AXIS, NODE_AXIS) mesh over the first
    scenario_devices x node_devices CUDA devices (or slots on the CPU).
    None for the 1x1 mesh."""
    if scenario_devices < 1 or node_devices < 1:
        raise ValueError(f"mesh axes must be >= 1, got {scenario_devices}x{node_devices}")
    want = scenario_devices * node_devices
    if want == 1:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = _cuda_devices()
        if want > len(cards):
            raise ValueError(
                f"{scenario_devices}x{node_devices} mesh needs {want} devices "
                f"but only {len(cards)} CUDA devices are visible"
            )
        devices = cards[:want]
    else:
        devices = [dev] * want
    grid = np.empty(want, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(scenario_devices, node_devices), (SCENARIO_AXIS, NODE_AXIS))


def scenario_mesh(mesh: Mesh) -> Mesh:
    """The same slots as `mesh`, re-axed for the multi-scenario sweep: one
    1-D axis named SCENARIO_AXIS."""
    return Mesh(list(mesh.devices.flat), (SCENARIO_AXIS,))


def node_sharding(mesh: Optional[Mesh] = None) -> NodeStatic:
    """The node-axis dimension of each NodeStatic leaf (None: replicated)."""
    return NODE_DIMS


def carry_sharding(mesh: Optional[Mesh] = None) -> Carry:
    """The node-axis dimension of each Carry leaf."""
    return CARRY_DIMS


def _none_like(tree):
    return rebuild(tree, [None] * len(leaves(tree)))


def _shifted(spec, by: int = 1):
    return rebuild(spec, [None if d is None else d + by for d in leaves(spec)])


def replicated(mesh: Mesh, tree) -> Sharded:
    """`tree` whole on every slot of `mesh`."""
    tree = _whole(tree)
    return put(mesh, tree, _none_like(tree))


def put(mesh: Mesh, tree, node_dims, lane_dims=None) -> Sharded:
    """`tree` laid out over `mesh` (jax.device_put with a sharding): each
    leaf split on its node dimension over the node axis and on its lane
    dimension over the scenario axis (None: whole on that axis)."""
    tree = _whole(tree)
    return lay_out(mesh.layout(), tree, _none_like(tree) if lane_dims is None else lane_dims,
                   node_dims)


def shard_state(mesh: Mesh, ns: NodeStatic, carry: Carry):
    """The cluster state on the mesh, node axis split (a 2-D mesh holds
    each node block once per lane row)."""
    return put(mesh, ns, node_sharding(mesh)), put(mesh, carry, carry_sharding(mesh))


def _whole(tree):
    """A Sharded tree gathered back; anything else as it is."""
    return tree.gather() if isinstance(tree, Sharded) else tree


def shard_scenarios(mesh: Mesh, ns: NodeStatic, carry_s: Carry, valid_s, weights_s):
    """The stacked sweep state on a scenario mesh: every [S, ...] tensor
    splits on its lane axis, the shared node tables replicate. S must
    divide the slot count (scenario_bucket pads S to a multiple of 8)."""
    layout = mesh.layout()
    if layout.cols != 1:
        raise ValueError("shard_scenarios takes a 1-D scenario mesh; use shard_scenarios_2d")
    ns = _whole(ns)
    carry_s = _whole(carry_s)
    lane = rebuild(carry_s, [0] * len(Carry._fields))
    return (
        lay_out(layout, ns, _none_like(ns), _none_like(ns)),
        lay_out(layout, carry_s, lane, _none_like(carry_s)),
        lay_out(layout, _whole(valid_s), 0, None),
        lay_out(layout, _whole(weights_s), 0, None),
    )


def shard_scenarios_2d(mesh: Mesh, ns: NodeStatic, carry_s: Carry, valid_s, weights_s):
    """The stacked sweep state on a 2-D (scenarios, nodes) mesh: [S, ...]
    tensors split on the lane axis AND their node axis; the shared
    NodeStatic splits on its node axis only. S must divide the scenario
    axis and the padded node axis the node axis (node_bucket keeps N a
    multiple of 64)."""
    layout = mesh.layout()
    ns = _whole(ns)
    carry_s = _whole(carry_s)
    return (
        lay_out(layout, ns, _none_like(ns), node_sharding(mesh)),
        lay_out(layout, carry_s, rebuild(carry_s, [0] * len(Carry._fields)),
                _shifted(carry_sharding(mesh))),
        lay_out(layout, _whole(valid_s), 0, 1),
        lay_out(layout, _whole(weights_s), 0, None),
    )


def align_on_mesh(align, carry, enc, ns):
    """`align(carry, enc, ns)` (ops.state.align_carry or
    align_carry_scenarios) on a layout, block by block: the row axes it
    grows are never the node axis, and anti_topo is whole in every block.
    The same objects come back when nothing changed."""
    if not isinstance(carry, Sharded):
        return align(carry, enc, ns)
    pairs = [align(c, enc, n) for c, n in zip(carry.blocks, ns.blocks)]
    if all(p[0] is c and p[1] is n for p, c, n in zip(pairs, carry.blocks, ns.blocks)):
        return carry, ns
    return carry.with_blocks([p[0] for p in pairs]), ns.with_blocks([p[1] for p in pairs])


def gather(tree, device=None):
    """A tree laid out over a mesh, whole and in global order on `device`
    (default: the first slot's); any other tree as it is."""
    return tree.gather(device) if isinstance(tree, Sharded) else tree


def leaf_nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for d in shape:
        n *= int(d)
    return n


def leaf_bytes_by_device(leaf, default_device=None) -> dict:
    """Per-device bytes one array-like leaf (a tensor, a `meta` tensor
    standing for one not made yet, a numpy array) will occupy, attributed
    whole to `default_device` when it has no device of its own (a meta
    tensor, a numpy array) — dropped when that is None."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return {}
    if isinstance(leaf, np.ndarray):
        nbytes = int(leaf.nbytes)
    else:
        nbytes = leaf_nbytes(shape, dtype)
    dev = getattr(leaf, "device", None)
    if dev is not None and not isinstance(leaf, np.ndarray) and dev.type != "meta":
        return {str(dev): nbytes}
    if default_device is None:
        return {}
    return {str(default_device): nbytes}


def bytes_per_device(*trees, default_device=None) -> dict:
    """Bytes resident per device (per slot) for the given trees — real or
    planned. A tree laid out over a mesh counts each block on its slot;
    slots that share a device count apart, keyed `<device>#<slot>`, so a
    4-slot layout on one card shows its per-shard bytes. A plain tensor
    counts on its device; a `meta` tensor or numpy array on
    `default_device` (the first CUDA device, else the CPU). Returns
    {device: bytes}; the static estimator of analysis/budget.py is this
    function."""
    if default_device is None:
        default_device = "cuda:0" if torch.cuda.is_available() else "cpu"
    out: dict = {}
    for tree in trees:
        if isinstance(tree, Sharded):
            devs = [tree.layout.device(k) for k in range(tree.layout.slots)]
            shared = len(set(devs)) < len(devs)
            for k, block in enumerate(tree.blocks):
                key = f"{devs[k]}#{k}" if shared else str(devs[k])
                for leaf in leaves(block):
                    out[key] = out.get(key, 0) + leaf_nbytes(leaf.shape, leaf.dtype)
            continue
        for leaf in ([tree] if isinstance(tree, (torch.Tensor, np.ndarray)) else leaves(tree)):
            for key, n in leaf_bytes_by_device(leaf, default_device).items():
                out[key] = out.get(key, 0) + n
    return out


def hbm_bytes_per_device(*trees, default_device=None) -> dict:
    """bytes_per_device(*trees), snapshotted into the
    osim_hbm_bytes_per_device gauge."""
    from ..utils import metrics

    out = bytes_per_device(*trees, default_device=default_device)
    for dev, nbytes in sorted(out.items()):
        metrics.HBM_BYTES_PER_DEVICE.set(nbytes, device=dev)
    return out


def sharded_schedule_batch(mesh: Mesh):
    """The per-pod oracle scan bound to a mesh: fn(ns, carry, pods, weights)
    with ns/carry laid out by shard_state (or whole, laid out here). Each
    step's masks and scores run on the slots' node blocks; the argmax, the
    min/max normalizations and the domain counts combine across slots.
    Returns (carry laid out on the mesh, nodes, reasons, gpu_take, vg_take,
    dev_take), the outputs as tensors on the first slot's device."""

    def fn(ns, carry, pods: PodRow, weights: torch.Tensor):
        if not isinstance(ns, Sharded):
            ns, carry = shard_state(mesh, ns, carry)

        def run(ns_b, carry_b, pods_b, w_b):
            outs = []
            for i in range(pods_b.req.shape[0]):
                pod = PodRow(*(a[i] for a in pods_b))
                carry_b, out = schedule_step(ns_b, w_b, carry_b, pod, keys=pod_keys(ns_b, pod))
                outs.append(out)
            return (carry_b,) + tuple(torch.stack(col) for col in zip(*outs))

        res = spmd(run, ns, carry, pods, weights)
        return (carry.with_blocks([r[0] for r in res]),) + tuple(
            t.to(ns.layout.device(0)) for t in res[0][1:]
        )

    return fn
