"""The entry registry: every device entry of the port, captured at the
canonical shapes by running the real host dispatchers.

The counterpart of the capture half of the JAX package's
analysis/jaxpr_audit.py. It builds one canonical encoded state (24 nodes in
3 zones, four pod templates that route through every strategy of the
dispatcher), runs the host dispatchers over it with every entry wrapped by a
recorder, and keeps each entry's first call: the callable, its arguments and
its keyword arguments (`_Captured`). Capturing at the dispatcher keeps the
registry signature-proof: when an entry gains a parameter, the capture
follows. `simon warmup` (engine/warmup.py) and the dispatch-gap analyzer
(utils/profiling.py) run on this list, and the sanitizer (ops/sanitize.py)
wraps exactly these 23 callables.

`AUDIT_TARGETS` and `REQUIRED_COVERAGE` keep the reference's 23 audit names,
so `--entries` filters and the `entry=` labels of the metrics match the
reference's. Two names have no attribute of the same name in the port;
`ENTRY_ATTRS` maps them:

  - `ops.grouped:_group_jit` -> ops/grouped.py `schedule_group`, the per-pod
    grouped scan;
  - `ops.fast:schedule_universes_wave` -> ops/wave.py `universe_round`, the
    one-round universe call that `fast.schedule_universes_wave_host` drives
    to its fixpoint.

Each callable carries `__osim_donate_argnums__`, the positional arguments
it writes in place (only the delta scatters write one); the capture keeps a
copy of every tensor argument taken before the call, so the stored
arguments are the ones the entry saw.

`_run_sweeps` is the reference's canonical capacity sweep (serial, then
batched) and `warm_start_check` runs it after a warmup, demanding zero
kernel builds (utils/platform.py) and equal answers.

The audit half of the reference (forbidden host transfers, wide dtypes,
donation aliasing, the recompile guard) is analysis/op_audit.py, which runs
on this capture list and on `_run_sweeps`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

_PKG = "open_simulator_tpu_torch"

#: device entries per module, under the reference's names
AUDIT_TARGETS: Dict[str, Tuple[str, ...]] = {
    f"{_PKG}.ops.fast": (
        "build_trajectory",
        "sort_select",
        "cur_at",
        "light_scan",
        "domain_select",
        "light_reasons",
        "gather_takes",
        "exit_carry",
        "schedule_scenarios",
        "schedule_scenarios_chunked",
        "schedule_universes",
        "schedule_wave",
        "schedule_universes_wave",
        "commit_choices",
    ),
    f"{_PKG}.ops.grouped": ("_group_jit",),
    f"{_PKG}.ops.kernels": (
        "schedule_batch", "probe_step", "commit_step", "probe_many",
        "commit_wave",
    ),
    f"{_PKG}.ops.delta": ("apply_rows", "apply_flags", "digest_fold"),
}

#: entries the canonical state MUST exercise
REQUIRED_COVERAGE = frozenset(
    {
        "ops.fast:build_trajectory",
        "ops.fast:sort_select",
        "ops.fast:light_scan",
        "ops.fast:domain_select",
        "ops.fast:light_reasons",
        "ops.fast:cur_at",
        "ops.fast:gather_takes",
        "ops.fast:exit_carry",
        "ops.fast:schedule_scenarios",
        "ops.fast:schedule_scenarios_chunked",
        "ops.fast:schedule_universes",
        "ops.fast:schedule_wave",
        "ops.fast:schedule_universes_wave",
        "ops.fast:commit_choices",
        "ops.grouped:_group_jit",
        "ops.kernels:schedule_batch",
        "ops.kernels:probe_step",
        "ops.kernels:commit_step",
        "ops.kernels:probe_many",
        "ops.kernels:commit_wave",
        "ops.delta:apply_rows",
        "ops.delta:apply_flags",
        "ops.delta:digest_fold",
    }
)

#: audit names whose callable lives under another module or attribute
ENTRY_ATTRS: Dict[str, Tuple[str, str]] = {
    "ops.grouped:_group_jit": (f"{_PKG}.ops.grouped", "schedule_group"),
    "ops.fast:schedule_universes_wave": (f"{_PKG}.ops.wave", "universe_round"),
}


def _short(module: str, attr: str) -> str:
    return f"{module.split('.', 1)[1]}:{attr}"


def entry_locations() -> Dict[str, Tuple[str, str]]:
    """audit name -> (module, attribute) of the port's callable."""
    out = {}
    for module, attrs in AUDIT_TARGETS.items():
        for attr in attrs:
            name = _short(module, attr)
            out[name] = ENTRY_ATTRS.get(name, (module, attr))
    return out


# --------------------------------------------------------------------------
# canonical state


def canonical_state(device=DEFAULT_DEVICE):
    """A small synthetic cluster encoded at the production bucket family:
    24 nodes (the 64-node bucket), four pod templates tiled into runs that
    exercise the dispatcher's strategies: a large plain group (trajectory +
    sort path), a zonal topology-spread group (domain path, the domain_pop
    kernel on a card), a hostname-spread group (the general light_scan body)
    and an infeasible group (light_reasons attribution). Returns (ns, carry,
    batch) on `device`."""
    from ..core.objects import Node, Pod
    from ..ops.encode import (
        Encoder,
        encode_nodes,
        encode_pods,
        initial_anti_counts,
        initial_port_counts,
        initial_selector_counts,
    )
    from ..ops.state import carry_from_table, node_static_from_table
    from ..ops.tile import tile_pod_batch

    dev = resolve_device(device)
    nodes = [
        Node.from_dict(
            {
                "metadata": {
                    "name": f"audit-{i}",
                    "labels": {
                        "kubernetes.io/hostname": f"audit-{i}",
                        "topology.kubernetes.io/zone": f"az-{i % 3}",
                    },
                },
                "spec": {},
                "status": {"allocatable": {"cpu": "16", "memory": "32Gi", "pods": "110"}},
            }
        )
        for i in range(24)
    ]

    def pod(name, cpu, labels=None, spec_extra=None):
        spec = {"containers": [{"name": "c",
                                "resources": {"requests": {"cpu": cpu, "memory": "256Mi"}}}]}
        spec.update(spec_extra or {})
        return Pod.from_dict(
            {"metadata": {"name": name, "namespace": "audit", "labels": labels or {}},
             "spec": spec}
        )

    def spread(app, key):
        return {"topologySpreadConstraints": [{
            "maxSkew": 1, "topologyKey": key, "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": app}},
        }]}

    templates = [
        pod("plain", "100m"),
        pod("spread", "100m", {"app": "spread"}, spread("spread", "topology.kubernetes.io/zone")),
        # hostname-keyed spread counts per node, which voids both the sort
        # path and the domain merge -> the general light_scan body
        pod("hspread", "100m", {"app": "hspread"}, spread("hspread", "kubernetes.io/hostname")),
        pod("huge", "64"),  # > any node's 16 cpu -> unschedulable
    ]
    counts = [220, 60, 50, 30]

    enc = Encoder()
    enc.register_pods(templates)
    table = encode_nodes(enc, nodes)
    batch = tile_pod_batch(encode_pods(enc, templates), counts)
    ns = node_static_from_table(enc, table, device=dev)
    carry = carry_from_table(
        table,
        initial_selector_counts(enc, table, []),
        port_counts=initial_port_counts(enc, table, []),
        anti_counts=initial_anti_counts(enc, table, []),
        device=dev,
    )
    return ns, carry, batch


# --------------------------------------------------------------------------
# capture


@dataclasses.dataclass
class _Captured:
    name: str
    fn: Any  # the entry's callable (its sanitizable wrapper)
    args: tuple
    kwargs: dict
    #: wall seconds of the captured call, the entry's first in the capture
    #: (the device synchronized before and after it)
    first_seconds: float = 0.0
    #: the storages of the arguments as the dispatcher passed them, before
    #: the copies (`storages_of`): the donation check of op_audit.py
    storages: Any = None


def tree_map(fn: Callable[[Any], Any], x: Any) -> Any:
    """fn over every tensor and numpy leaf of nested NamedTuples, tuples,
    lists and dicts; other leaves are kept."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return x


def tree_leaves(x: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, x)
    return out


def copy_leaf(a):
    return a.clone() if isinstance(a, torch.Tensor) else a.copy()


def storages_of(args: tuple, kwargs: dict) -> dict:
    """{"args": [storage pointers of each positional argument's tensors],
    "kwargs": {name: pointers}}: two views of one storage share a pointer."""
    def ptrs(x):
        return {a.untyped_storage().data_ptr() for a in tree_leaves(x) if isinstance(a, torch.Tensor)}

    return {"args": [ptrs(a) for a in args], "kwargs": {k: ptrs(v) for k, v in kwargs.items()}}


def _is_concrete(x: Any) -> bool:
    """No leaf is a functorch-wrapped tensor: the call is not made inside
    another entry's torch.func.vmap (the reference skips tracers)."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return not any(isinstance(a, torch.Tensor) and wrapped(a) for a in tree_leaves(x))


def _sync(dev: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _capture_calls(device=DEFAULT_DEVICE, around=None) -> List[_Captured]:
    """Run the host dispatchers over the canonical state with every entry
    wrapped by a recorder; return each entry's first concrete call.

    `around(name, fn, args, kwargs, storages)`, when given, returns a
    context manager entered around each captured first call (the op census
    of analysis/op_audit.py observes the calls this way).

    The scenario driver is pinned to its one-scan route (neither the wave
    driver nor the chunked scan, which OSIM_WAVE_COMMIT, the core count or
    OSIM_COMMIT_CHUNK would pick), so `schedule_scenarios` itself is
    captured on every host; the wave and chunk entries get calls of their
    own below."""
    from ..ops import delta, fast, grouped, kernels
    from ..ops import state as state_mod
    from ..ops import wave
    from ..ops.kernels import PodRow, commit_parts

    dev = resolve_device(device)
    captured: Dict[str, _Captured] = {}
    patches: List[Tuple[Any, str, Any]] = []

    def pin(module, attr: str, value) -> None:
        patches.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    try:
        for name, (module_name, attr) in entry_locations().items():
            module = importlib.import_module(module_name)
            original = getattr(module, attr)

            def recorder(*args, _original=original, _name=name, **kwargs):
                if _name in captured or not _is_concrete((args, kwargs)):
                    return _original(*args, **kwargs)
                cap = captured[_name] = _Captured(
                    _name, _original, tree_map(copy_leaf, args), tree_map(copy_leaf, kwargs),
                    storages=storages_of(args, kwargs),
                )
                ctx = (contextlib.nullcontext() if around is None
                       else around(_name, _original, args, kwargs, cap.storages))
                _sync(dev)
                t0 = time.perf_counter()
                with ctx:
                    out = _original(*args, **kwargs)
                    _sync(dev)
                cap.first_seconds = time.perf_counter() - t0
                return out

            pin(module, attr, recorder)
        pin(wave, "wave_enabled", lambda *a, **k: False)
        pin(fast, "commit_chunk_size", lambda: 0)

        ns, carry, batch = canonical_state(dev)
        weights = kernels.weights_array(device=dev)

        # the trajectory dispatcher: plain group -> build_trajectory +
        # sort_select (+ cur_at/gather_takes/exit_carry), zonal spread ->
        # domain_select, hostname spread -> light_scan, infeasible ->
        # light_reasons
        fast.schedule_batch_fast(ns, carry, batch, weights, force_fast=True, device=dev)
        # the per-pod grouped scan
        grouped.schedule_batch_grouped(ns, carry, batch, weights, device=dev)
        # the sequential oracle and the extender path's single-pod entries
        rows = state_mod.pod_rows_from_batch(batch, dev)
        kernels.schedule_batch(ns, carry, rows, weights)
        row0 = PodRow(*(a[0] for a in rows))
        kernels.probe_step(ns, carry, row0, weights)
        kernels.commit_step(ns, carry, row0, torch.tensor(0, dtype=torch.int32, device=dev))
        # one bucketed extender wave of copies of pod 0 (lane 0 commits)
        w_pad = fast.scenario_bucket(2)
        rows_w = PodRow(*(a[:1].expand((w_pad,) + a.shape[1:]) for a in rows))
        mask_w, score_w, ff_w = kernels.probe_many(ns, carry, rows_w, weights)
        want_w = torch.zeros(w_pad, dtype=torch.bool, device=dev)
        want_w[0] = True
        kernels.commit_wave(
            ns, carry, rows_w, weights, mask_w, ff_w, mask_w, torch.zeros_like(score_w), want_w,
        )
        # a 2-lane what-if sweep padded to the scenario bucket (lane 1 masks
        # off half the nodes; pad lanes copy lane 0)
        s_pad = fast.scenario_bucket(2)
        valid_s = ns.valid.unsqueeze(0).repeat(s_pad, 1)
        valid_s[1, 12:] = False
        weights_s = weights.unsqueeze(0).repeat(s_pad, 1)
        fast.schedule_scenarios_host(
            ns, state_mod.stack_carry(carry, s_pad), batch, weights_s, valid_s, 2,
        )
        # one count-gated chunk (count < chunk) at the same lane shapes
        rows_c = PodRow(*(a[:4] for a in rows))
        fast.schedule_scenarios_chunked(
            ns, state_mod.stack_carry(carry, s_pad), rows_c, weights_s, valid_s, 3,
        )
        # the universe engine: every leaf stacked to the scenario bucket
        def stack_leaf(a):
            return a.unsqueeze(0).expand((s_pad,) + tuple(a.shape))

        ns_u = type(ns)(*(stack_leaf(a) for a in ns))
        rows_u = PodRow(*(stack_leaf(a) for a in rows))
        fast.schedule_universes(ns_u, state_mod.stack_carry(carry, s_pad), rows_u, weights_s)
        # one wave round from cold choices (partial count), the commit
        # phase alone, and one universes-axis round
        rows_np = {f: np.asarray(getattr(batch, f)) for f in (
            "match_sel", "own_anti", "gpu_mem", "gpu_num", "lvm_req", "dev_req", "hp_pid")}
        parts = [commit_parts(rows_np, i) for i in range(4)]
        choices_w = torch.full((s_pad, 4), -1, dtype=torch.int32, device=dev)
        fast.schedule_wave(
            ns, state_mod.stack_carry(carry, s_pad), rows_c, weights_s, valid_s, choices_w, 3,
            parts,
        )
        fast.commit_choices(ns, state_mod.stack_carry(carry, s_pad), rows_c, choices_w, 3)
        wave.universe_round(
            ns_u, weights_s, state_mod.stack_carry(carry, s_pad), rows_u,
            torch.full((s_pad, int(rows.req.shape[0])), -1, dtype=torch.int32, device=dev),
            fast.universe_parts(rows_u),
        )
        # the resident-state delta entries: two rows into the free plane
        # (pad slots dropped), a flag set, one digest
        n = int(carry.free.shape[0])
        idx = delta.pad_indices([0, 1], n)
        delta.digest_fold(carry.free)
        delta.apply_rows(
            carry.free.clone(), idx,
            np.zeros((idx.shape[0],) + tuple(carry.free.shape[1:]), np.float32),
        )
        delta.apply_flags(ns.valid.clone(), idx, np.zeros(idx.shape[0], bool))
    finally:
        for module, attr, original in reversed(patches):
            setattr(module, attr, original)
    return list(captured.values())


# --------------------------------------------------------------------------
# the canonical capacity sweep and the warm-start check


def _sweep_fixture():
    """An overloaded 3-node cluster, one Deployment that cannot fit, and the
    clone template: the smallest sweep that makes plan_capacity walk its
    exponential and bisection phases."""
    from ..core.objects import Node
    from ..engine.simulator import AppResource, ClusterResource

    def node(name: str) -> Node:
        return Node.from_dict(
            {
                "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
                "spec": {},
                "status": {"allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}},
            }
        )

    cluster = ClusterResource(nodes=[node(f"guard-{i}") for i in range(3)])
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": "load", "namespace": "guard"},
        "spec": {
            "replicas": 40,
            "selector": {"matchLabels": {"app": "load"}},
            "template": {
                "metadata": {"labels": {"app": "load"}},
                "spec": {"containers": [{
                    "name": "c", "image": "load:v1",
                    "resources": {"requests": {"cpu": "2", "memory": "1Gi"}},
                }]},
            },
        },
    }
    apps = [AppResource(name="guard", objects=[deployment])]
    return cluster, apps, node("guard-template")


def _run_sweeps(device=DEFAULT_DEVICE):
    """The canonical capacity sweep, serial then batched, on `device`.
    Returns (serial plan, batched plan); raises if either fails to
    converge."""
    from ..core.workloads import reset_name_rng
    from ..engine.capacity import plan_capacity

    plans = []
    for mode in ("serial", "batched"):
        reset_name_rng()
        cluster, apps, template = _sweep_fixture()
        plans.append(plan_capacity(
            cluster, apps, template, max_new_nodes=256, sweep_mode=mode, device=device,
        ))
    if None in plans:
        raise RuntimeError("the canonical capacity sweep did not converge")
    return plans[0], plans[1]


@dataclasses.dataclass
class WarmStartResult:
    """The canonical capacity sweep re-run after `simon warmup`: no kernel
    may be built (every library the run loads is found in the cache) and
    the serial and batched searches must agree. `native_builds` reports the
    g++ runs of the native host runtime in the check (0 on a warm cache);
    it is host code, so `ok` reads the kernel builds only."""

    backend_compiles: int
    persistent_hits: int
    nodes_added: int
    batched_nodes_added: int
    cache_dir: str = ""
    native_builds: int = 0

    @property
    def cold_compiles(self) -> int:
        return self.backend_compiles

    @property
    def ok(self) -> bool:
        return self.cold_compiles == 0 and self.nodes_added == self.batched_nodes_added

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "cold_compiles": self.cold_compiles,
            "backend_compiles": self.backend_compiles,
            "persistent_hits": self.persistent_hits,
            "nodes_added": self.nodes_added,
            "batched_nodes_added": self.batched_nodes_added,
            "cache_dir": self.cache_dir,
            "native_builds": self.native_builds,
        }

    def render_text(self) -> str:
        return (
            f"warm-start check: {'ok' if self.ok else 'FAILED'} — "
            f"{self.cold_compiles} cold compile(s) "
            f"({self.backend_compiles} compile request(s), "
            f"{self.persistent_hits} persistent-cache hit(s)) over the "
            f"full capacity sweep; answers "
            f"{'agree' if self.nodes_added == self.batched_nodes_added else 'DISAGREE'}; "
            f"{self.native_builds} g++ build(s) of the native host runtime"
        )


def warm_start_check(device=DEFAULT_DEVICE) -> WarmStartResult:
    """Run after `simon warmup`, in a process sharing OSIM_COMPILE_CACHE:
    load the hand kernels (on a card) and run the canonical capacity sweep,
    counting kernel builds and cache hits. ok demands zero builds and equal
    serial and batched answers."""
    from .. import native
    from ..engine.warmup import build_libraries
    from ..utils.platform import CompileCounter, enable_compilation_cache, install_compile_listener

    dev = resolve_device(device)
    cache_dir = enable_compilation_cache()
    install_compile_listener()
    native_builds0 = native.builds
    with CompileCounter() as counter:
        build_libraries(dev)
        plan, plan_b = _run_sweeps(dev)
    return WarmStartResult(
        backend_compiles=counter.backend_compiles,
        persistent_hits=counter.persistent_hits,
        nodes_added=plan.nodes_added,
        batched_nodes_added=plan_b.nodes_added,
        cache_dir=cache_dir,
        native_builds=native.builds - native_builds0,
    )
