"""The op census of the registry entries and the recompile guard.

The counterpart of the audit half of the JAX package's
analysis/jaxpr_audit.py (`FORBIDDEN_PRIMITIVES` to `run_audit`, lines
36-624, and `run_recompile_guard`, lines 784-840). Where the reference
retraces each captured jit entry and walks its jaxpr, the port re-runs each
captured call (analysis/entry_audit.py's capture list) under a
`TorchDispatchMode`, the hook ops/sanitize.py uses, and walks the aten op
stream it issues:

* **forbidden transfers**: `aten._local_scalar_dense` (`.item()`,
  `float(t)`, `int(t)`, `bool(t)` on a tensor) and any `_to_copy` / `copy_`
  whose result lands on the CPU while the entry runs on a card. On the CPU,
  `.cpu()` and `.tolist()` dispatch nothing and `.numpy()` only a `detach`,
  so there the census sees the scalar reads only; on a card `.cpu()` and
  `.tolist()` pass the dispatcher as a `_to_copy` to the CPU (chip_smoke.py
  checks that). A transfer an entry needs is listed in `LISTED_TRANSFERS`
  with its reason, as the reference lists its callbacks; every other one
  fails the entry.
* **wide dtypes**: any float64 output of an op or argument of the entry,
  and any int64 output that is not an index. PyTorch hands out int64 by its
  own rules (`arange`, `argmin`, a sort's indices, an integer `sum`) and
  wants it for indices, so an int64 value passes when, through a chain of
  int64 ops, it reaches an index argument (`index`, `index_put_`, `gather`,
  `scatter*`, `index_select`, `index_add`...) or an op that gives no int64
  (a copy to int32, a comparison): it never leaves the entry as int64. One
  that stays int64 to the end (returned, or dropped) is flagged. A wide
  value an entry needs is listed in `LISTED_WIDE` with its reason. Every
  float64 value is an op's output or an argument, so checking those covers
  the inputs too.
* **donation aliasing**: no storage of a positional argument the entry
  writes in place (`__osim_donate_argnums__`) may be shared with another
  argument of the same call. Storages are compared by
  `untyped_storage().data_ptr()`, because two views of one storage alias
  too; the pointers are taken from the arguments as the dispatcher passed
  them, before the capture copies them.
* **custom kernels**: a hand kernel is a ctypes call the dispatcher never
  sees, so the census reads the calling thread's launches of every kernel
  of ops/kernel_lib.py's registry around the call and lists each as
  `custom:<name>` (`custom:domain_pop`, `custom:light_scan`).

`TargetReport` keeps the reference's fields, with `n_eqns` renamed `n_ops`
(aten ops seen). The per-op work is one dictionary count keyed by the op
and the dtypes of its outputs, plus the int64 bookkeeping: a scan entry
issues ~10^5-10^6 ops a call, and the dispatch mode itself costs ~20 us an
op. So `run_audit` observes the registry capture's own first call of each
entry rather than re-running it.

The recompile guard (`run_recompile_guard`) runs the canonical capacity
sweep (entry_audit._run_sweeps, serial then batched). Eager PyTorch
compiles nothing, so a "compile" is a distinct program: an (entry, tensor
shapes and dtypes, scalar arguments) signature seen during the sweep, bound
by `RECOMPILE_BUDGET`. The reference's metric cross-check becomes: the
kernel builds `utils.platform.CompileCounter` counts equal the delta of
`osim_compile_cache_total{event="backend_compile"}`. `scenario_programs`,
`ladder_rungs`, `scenario_ok` and `ladder_ok` carry over unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops import kernel_lib
from . import entry_audit

#: The reference's forbidden primitives, kept for the tripwire against
#: open_simulator_tpu/analysis/jaxpr_audit.py; the port's transfers are
#: FORBIDDEN_OPS and the copies to the CPU.
FORBIDDEN_PRIMITIVES = frozenset(
    {
        "pure_callback",
        "io_callback",
        "debug_callback",
        "callback",
        "outside_call",
        "host_callback_call",
        "infeed",
        "outfeed",
        "device_put",
        "copy_to_host",
    }
)

#: aten ops (overload packets) that read a device value to the host
FORBIDDEN_OPS = frozenset({"_local_scalar_dense"})
#: aten copies that land on the CPU from a card
_COPY_OPS = frozenset({"_to_copy", "copy_", "copy"})

WIDE_DTYPES = frozenset({"float64", "int64", "uint64", "complex128"})

#: entry -> {op: (most per call, reason)}: transfers an entry needs
LISTED_TRANSFERS: Dict[str, Dict[str, Tuple[int, str]]] = {
    "ops.fast:domain_select": {
        "_local_scalar_dense": (2, (
            "the domain_pop kernel takes the spread weight and the spread "
            "filter bit by value: two scalar reads before the launch "
            "(ops/fast.py domain_select)"
        )),
        "_to_copy:to_cuda": (11, (
            "the domain plan is built on the host from the gathered node "
            "tables: its class tables are uploaded per call, 7 on the "
            "spread-only path, 11 with affinity terms (ops/fast.py t())"
        )),
    },
    "ops.delta:apply_rows": {
        "_to_copy:to_cuda": (2, (
            "a resident-state delta arrives from the host: its row indices "
            "and row values are uploaded per call (ops/delta.py)"
        )),
    },
    "ops.delta:apply_flags": {
        "_to_copy:to_cuda": (2, (
            "a resident-state delta arrives from the host: its row indices "
            "and flags are uploaded per call (ops/delta.py)"
        )),
    },
}

#: entry -> {dtype: reason}: wide values an entry needs
LISTED_WIDE: Dict[str, Dict[str, str]] = {
    "ops.delta:digest_fold": {
        "int64": "the u32 checksum is computed and returned in int64: PyTorch has "
        "no uint32 arithmetic (ops/delta.py)",
    },
}

#: aten ops taking int64 indices -> positions of their index arguments
_INDEX_ARGS: Dict[str, Tuple[int, ...]] = {
    "index": (1,), "_unsafe_index": (1,), "index_put": (1,), "index_put_": (1,),
    "_index_put_impl_": (1,), "_unsafe_index_put": (1,),
    "index_select": (2,), "gather": (2,), "scatter": (2,), "scatter_": (2,),
    "scatter_add": (2,), "scatter_add_": (2,), "scatter_reduce": (2,),
    "scatter_reduce_": (2,), "index_add": (2,), "index_add_": (2,), "index_copy": (2,),
    "index_copy_": (2,), "index_fill": (2,), "index_fill_": (2,), "index_reduce": (2,),
    "index_reduce_": (2,), "take": (1,), "take_along_dim": (1,), "embedding": (1,),
}

RECOMPILE_BUDGET = 48

#: max distinct scenario-axis paddings per (node bucket, pod count) key
SCENARIO_PROGRAMS_PER_BUCKET = 2


@dataclasses.dataclass
class TargetReport:
    name: str
    traced: bool
    n_ops: int = 0
    primitives: List[str] = dataclasses.field(default_factory=list)
    forbidden: List[str] = dataclasses.field(default_factory=list)
    #: transfers seen and listed in LISTED_TRANSFERS ("op x count")
    listed: List[str] = dataclasses.field(default_factory=list)
    wide_avals: List[str] = dataclasses.field(default_factory=list)
    donated: List[int] = dataclasses.field(default_factory=list)
    donation_aliased: List[str] = dataclasses.field(default_factory=list)
    #: hand-kernel launches in the call, by census name
    custom: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    error: str = ""

    @property
    def ok(self) -> bool:
        return (
            self.traced
            and not self.forbidden
            and not self.wide_avals
            and not self.donation_aliased
            and not self.error
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "traced": self.traced,
            "ok": self.ok,
            "n_ops": self.n_ops,
            "forbidden": self.forbidden,
            "listed": self.listed,
            "wide_avals": self.wide_avals,
            "donated": self.donated,
            "donation_aliased": self.donation_aliased,
            "custom": self.custom,
            "seconds": round(self.seconds, 4),
            "error": self.error,
        }


@dataclasses.dataclass
class AuditReport:
    targets: List[TargetReport]
    uncovered: List[str]
    required_missing: List[str]
    device: str = "cpu"
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.required_missing and all(t.ok for t in self.targets)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "device": self.device,
            "seconds": round(self.seconds, 4),
            "targets": [t.to_dict() for t in self.targets],
            "uncovered": self.uncovered,
            "required_missing": self.required_missing,
            "forbidden_ops": sorted(FORBIDDEN_OPS),
            "listed_transfers": {
                k: {op: n for op, (n, _why) in sorted(v.items())}
                for k, v in sorted(LISTED_TRANSFERS.items())
            },
        }

    def render_text(self) -> str:
        out = []
        for t in sorted(self.targets, key=lambda t: t.name):
            status = "ok" if t.ok else "FAIL"
            detail = f"{t.n_ops} ops"
            if t.custom:
                detail += "; " + ", ".join(f"{k} x{v}" for k, v in sorted(t.custom.items()))
            if t.donated:
                detail += f"; donates arg(s) {t.donated}"
            if t.listed:
                detail += f"; listed: {', '.join(t.listed)}"
            if t.forbidden:
                detail += f"; forbidden: {', '.join(t.forbidden)}"
            if t.wide_avals:
                detail += f"; wide: {', '.join(t.wide_avals[:4])}"
            if t.donation_aliased:
                detail += f"; DONATION ALIASED: {', '.join(t.donation_aliased)}"
            if t.error:
                detail += f"; error: {t.error}"
            out.append(f"  {status:4s} {t.name} ({detail})")
        if self.uncovered:
            out.append(f"  not exercised by canonical state: {', '.join(self.uncovered)}")
        if self.required_missing:
            out.append(f"  REQUIRED but missing: {', '.join(self.required_missing)}")
        out.append(f"op census ({self.device}): {'ok' if self.ok else 'FAILED'}")
        return "\n".join(out)


# --------------------------------------------------------------------------
# the census


def _op_name(func) -> str:
    return func.overloadpacket.__name__


class _Census(TorchDispatchMode):
    """Counts every aten op of one call by (op, output dtypes) and follows
    int64 values to where they end (module docstring)."""

    def __init__(self, on_card: bool) -> None:
        super().__init__()
        self.on_card = on_card
        self.n_ops = 0
        self.counts: Dict[Tuple[str, str], int] = {}
        self.transfers: Dict[str, int] = {}
        # int64 outputs: tensor id -> (op name, ids of its int64 inputs)
        self._i64: Dict[int, Tuple[str, Tuple[int, ...]]] = {}
        self._keep: List[torch.Tensor] = []   # keeps the ids unique for the call
        self._ends: Set[int] = set()          # int64 values that reach an index or leave int64

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        name = _op_name(func)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        dtypes = ",".join(
            str(t.dtype).rsplit(".", 1)[-1] for t in outs if isinstance(t, torch.Tensor)
        )
        key = (name, dtypes)
        self.counts[key] = self.counts.get(key, 0) + 1
        if name in FORBIDDEN_OPS:
            self.transfers[name] = self.transfers.get(name, 0) + 1
        elif self.on_card and name in _COPY_OPS:
            src = args[1] if name == "copy_" and len(args) > 1 else args[0]
            dst = args[0] if name == "copy_" else out
            if (
                isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.device.type == "cuda" and dst.device.type == "cpu"
            ):
                tag = f"{name}:to_cpu"
                self.transfers[tag] = self.transfers.get(tag, 0) + 1
        self._follow_i64(name, args, outs, "int64" in dtypes)
        return out

    def _follow_i64(self, name: str, args, outs, i64_out: bool) -> None:
        ins = []
        for a in args:
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, torch.Tensor) and t.dtype == torch.int64:
                    ins.append(id(t))
        if ins and name in _INDEX_ARGS:
            for pos in _INDEX_ARGS[name]:
                a = args[pos] if pos < len(args) else None
                for t in (a if isinstance(a, (list, tuple)) else (a,)):
                    if isinstance(t, torch.Tensor):
                        self._ends.add(id(t))
        if not i64_out:
            self._ends.update(ins)      # narrowed, compared or mixed: not int64 after
            return
        ins_t = tuple(ins)
        for t in outs:
            if isinstance(t, torch.Tensor) and t.dtype == torch.int64:
                self._i64[id(t)] = (name, ins_t)
                self._keep.append(t)

    def wide(self) -> List[str]:
        """op:dtype of every wide value: float64 anywhere, int64 outputs
        that stay int64 to the end."""
        found: Set[str] = set()
        for (name, dtypes), _n in self.counts.items():
            for d in dtypes.split(","):
                if d in WIDE_DTYPES and d != "int64":
                    found.add(f"{name}:{d}")
        ends = set(self._ends)
        stack = list(ends)
        while stack:
            for i in self._i64.get(stack.pop(), ("", ()))[1]:
                if i not in ends:
                    ends.add(i)
                    stack.append(i)
        for tid, (name, _ins) in self._i64.items():
            if tid not in ends:
                found.add(f"{name}:int64")
        return sorted(found)


def _tensor_leaves(x: Any) -> List[torch.Tensor]:
    return [a for a in entry_audit.tree_leaves(x) if isinstance(a, torch.Tensor)]


def donation_aliasing(fn, args: tuple, kwargs: dict, storages=None) -> Tuple[List[int], List[str]]:
    """The donated positional arguments of a call of `fn` and the aliasing
    findings: a storage of a donated argument shared with another argument
    (module docstring). `storages` are the pointers recorded before a
    capture copied the arguments (entry_audit.storages_of), else those of
    `args` and `kwargs` themselves."""
    donated = sorted(getattr(fn, "__osim_donate_argnums__", ()) or ())
    findings: List[str] = []
    if not donated:
        return donated, findings
    st = storages or entry_audit.storages_of(args, kwargs)
    per_arg, per_kw = st["args"], st["kwargs"]
    for d in donated:
        if d >= len(per_arg):
            findings.append(f"arg {d} not supplied positionally")
            continue
        mine = per_arg[d]
        for i, other in enumerate(per_arg):
            if i != d and mine & other:
                findings.append(f"arg {d} aliased by arg {i}")
        for k, other in sorted(per_kw.items()):
            if mine & other:
                findings.append(f"arg {d} aliased by kwarg {k!r}")
    return donated, findings


def _custom_counts() -> Dict[str, int]:
    """The calling thread's launches of each hand kernel, by census name."""
    return {f"custom:{name}": kernel_lib.thread_launches(name) for name in kernel_lib.KERNELS}


class CensusRun:
    """The census of one entry call: `with CensusRun(...) as run:` around
    the call, then `run.report`. An exception of the call propagates."""

    def __init__(self, name: str, fn, args: tuple, kwargs: dict, dev: torch.device,
                 storages=None) -> None:
        self.dev = dev
        self.report = TargetReport(name=name, traced=False)
        self.report.donated, self.report.donation_aliased = donation_aliasing(
            fn, args, kwargs, storages)
        self.wide_args = sorted({
            f"arg:{str(t.dtype).rsplit('.', 1)[-1]}"
            for t in _tensor_leaves((args, kwargs))
            if str(t.dtype).rsplit(".", 1)[-1] in WIDE_DTYPES - {"int64"}
        })
        self.census = _Census(on_card=dev.type == "cuda")

    def __enter__(self) -> "CensusRun":
        self.before = _custom_counts()
        self.t0 = time.perf_counter()
        self.census.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.census.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        report, census = self.report, self.census
        report.seconds = time.perf_counter() - self.t0
        after = _custom_counts()
        report.traced = True
        report.n_ops = census.n_ops
        report.primitives = sorted({name for name, _d in census.counts})
        report.custom = {k: after[k] - self.before[k] for k in after if after[k] > self.before[k]}
        listed = LISTED_TRANSFERS.get(report.name, {})
        for op, n in sorted(census.transfers.items()):
            ok = op in listed and n <= listed[op][0]
            (report.listed if ok else report.forbidden).append(f"{op} x{n}")
        allowed = LISTED_WIDE.get(report.name, {})
        report.wide_avals = self.wide_args + [
            w for w in census.wide() if w.rsplit(":", 1)[1] not in allowed
        ]


def audit_one(cap, device=DEFAULT_DEVICE) -> TargetReport:
    """The census of one captured call (`.name`, `.fn`, `.args`,
    `.kwargs`), re-run on fresh copies of its arguments on `device`; a
    failure of the call is reported, not raised."""
    from ..utils.profiling import _fresh_args

    dev = resolve_device(device)
    run = CensusRun(cap.name, cap.fn, cap.args, cap.kwargs, dev, getattr(cap, "storages", None))
    args = _fresh_args(cap)
    try:
        with run:
            cap.fn(*args, **cap.kwargs)
    except Exception as exc:  # a failure of the call is a finding
        run.report.error = f"call failed: {type(exc).__name__}: {exc}"
    return run.report


def run_audit(
    names: Optional[Iterable[str]] = None, device=DEFAULT_DEVICE, captures: Optional[Sequence] = None,
) -> AuditReport:
    """The census of every registry entry on `device`; `names` filters the
    entries (the filter also narrows the coverage check to them).

    With no `captures`, the census runs while the registry is captured: the
    capture's own first call of each entry (entry_audit._capture_calls) is
    the call the census observes, so no entry runs twice. Given
    `captures`, each is re-run on fresh copies of its arguments."""
    if not FORBIDDEN_OPS:
        raise RuntimeError("the forbidden-op set must be non-empty")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    wanted = set(names) if names else None
    if captures is None:
        all_names = set(entry_audit.entry_locations())
        if wanted is not None and wanted - all_names:
            raise KeyError(", ".join(sorted(wanted - all_names)))
        runs: Dict[str, CensusRun] = {}

        def around(name, fn, args, kwargs, storages):
            if wanted is not None and name not in wanted:
                return contextlib.nullcontext()
            runs[name] = CensusRun(name, fn, args, kwargs, dev, storages)
            return runs[name]

        entry_audit._capture_calls(dev, around=around)
        targets = [runs[n].report for n in runs]
    else:
        targets = [audit_one(c, dev) for c in captures if wanted is None or c.name in wanted]
    seen = {t.name for t in targets}
    scope = set(entry_audit.entry_locations()) if wanted is None else wanted
    required = entry_audit.REQUIRED_COVERAGE if wanted is None else (
        entry_audit.REQUIRED_COVERAGE & wanted
    )
    return AuditReport(
        targets=targets,
        uncovered=sorted(scope - seen),
        required_missing=sorted(required - seen),
        device=str(dev),
        seconds=time.perf_counter() - t0,
    )


# --------------------------------------------------------------------------
# the recompile guard


@dataclasses.dataclass
class GuardResult:
    compiles: int
    budget: int
    metric_compiles: int
    nodes_added: int
    attempts: int
    batched_calls: int = 0
    batched_nodes_added: int = -1
    scenario_programs: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    ladder_rungs: List[int] = dataclasses.field(default_factory=list)
    #: kernel builds counted by utils.platform.CompileCounter over the sweep
    kernel_builds: int = 0
    #: distinct programs per entry
    programs: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def scenario_ok(self) -> bool:
        return self.batched_nodes_added == self.nodes_added and all(
            len(pads) <= SCENARIO_PROGRAMS_PER_BUCKET for pads in self.scenario_programs.values()
        )

    @property
    def ladder_ok(self) -> bool:
        """Every batched program's node axis sits exactly on a ladder rung
        (ops.encode.node_bucket is idempotent on it)."""
        from ..ops.encode import node_bucket

        return all(node_bucket(n) == n for n in self.ladder_rungs)

    @property
    def ok(self) -> bool:
        return (
            0 < self.compiles <= self.budget
            and self.kernel_builds == self.metric_compiles
            and self.scenario_ok
            and self.ladder_ok
        )

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "compiles": self.compiles,
            "budget": self.budget,
            "metric_compiles": self.metric_compiles,
            "kernel_builds": self.kernel_builds,
            "nodes_added": self.nodes_added,
            "attempts": self.attempts,
            "batched_calls": self.batched_calls,
            "batched_nodes_added": self.batched_nodes_added,
            "scenario_programs": self.scenario_programs,
            "scenario_ok": self.scenario_ok,
            "ladder_rungs": self.ladder_rungs,
            "ladder_ok": self.ladder_ok,
            "programs": self.programs,
            "seconds": round(self.seconds, 4),
        }

    def render_text(self) -> str:
        worst = max((len(p) for p in self.scenario_programs.values()), default=0)
        return (
            f"recompile guard: {'ok' if self.ok else 'FAILED'} — "
            f"{self.compiles} distinct programs (budget {self.budget}); "
            f"{self.kernel_builds} kernel build(s) (metric cross-check "
            f"{self.metric_compiles}) over a capacity sweep adding "
            f"{self.nodes_added} node(s) in {self.attempts} probes; batched "
            f"sweep: {self.batched_calls} call(s), {worst} scenario "
            f"program(s)/bucket (max {SCENARIO_PROGRAMS_PER_BUCKET}), node rungs "
            f"{self.ladder_rungs} {'on-ladder' if self.ladder_ok else 'OFF-LADDER'}, "
            f"answer {'agrees' if self.batched_nodes_added == self.nodes_added else 'DISAGREES'}"
        )


def _signature(x: Any) -> Any:
    """The program key of one argument: tensors and arrays by shape and
    dtype, containers element-wise, scalars by value."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype))
    if isinstance(x, np.ndarray):
        return ("A", x.shape, str(x.dtype))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    return getattr(x, "__qualname__", type(x).__name__)


def _backend_compiles() -> int:
    from ..utils import metrics

    return int(metrics.COMPILE_CACHE.value(event="backend_compile"))


def run_recompile_guard(budget: int = RECOMPILE_BUDGET, device=DEFAULT_DEVICE) -> GuardResult:
    """Run the canonical capacity sweep on `device`, recording the signature
    of every registry entry call (ops/sanitize.call_hook), and bound its
    distinct programs (module docstring)."""
    from ..ops.fast import reset_scenario_programs, scenario_programs
    from ..utils.platform import CompileCounter, install_compile_listener

    from ..ops.sanitize import call_hook

    dev = resolve_device(device)
    install_compile_listener()
    programs: Dict[str, Set[Any]] = {}

    def record(name: str, args: tuple, kwargs: dict) -> None:
        programs.setdefault(name, set()).add((_signature(args), _signature(kwargs)))

    t0 = time.perf_counter()
    metric_before = _backend_compiles()
    reset_scenario_programs()
    with CompileCounter() as counter, call_hook(record):
        plan, plan_b = entry_audit._run_sweeps(dev)
    metric_delta = _backend_compiles() - metric_before
    sp = scenario_programs()
    return GuardResult(
        compiles=sum(len(v) for v in programs.values()),
        budget=budget,
        metric_compiles=metric_delta,
        nodes_added=plan.nodes_added,
        attempts=plan.attempts,
        batched_calls=plan_b.batched_calls,
        batched_nodes_added=plan_b.nodes_added,
        scenario_programs={f"{n}x{p}": sorted(pads) for (n, p), pads in sp.items()},
        ladder_rungs=sorted({n for (n, _p) in sp}),
        kernel_builds=counter.backend_compiles,
        programs={k: len(v) for k, v in sorted(programs.items())},
        seconds=time.perf_counter() - t0,
    )


def report_json(audit: Optional[AuditReport], guard: Optional[GuardResult]) -> str:
    return json.dumps(
        {
            "version": 1,
            "jaxpr_audit": audit.to_dict() if audit is not None else None,
            "recompile_guard": guard.to_dict() if guard is not None else None,
        },
        indent=2,
        sort_keys=True,
    )
