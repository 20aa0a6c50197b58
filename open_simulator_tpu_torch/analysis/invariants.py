"""Numeric-invariant abstract interpreter over the entries' aten op graphs.

The port of the JAX package's analysis/invariants.py. `simon lint` proves
syntactic contracts and the op census what an entry issues; this pass
proves the semantic contracts the scheduler's correctness rests on, on the
registry's canonical calls (analysis/entry_audit.py):

  * masks stay {0,1}-valued (bool dtype all the way to the entry outputs),
  * every score plugin lands in [0,100] (kube's checkPluginScores contract),
  * no float output of any registry entry can be NaN,
  * the deliberate ``-inf * 0.0 -> NaN`` sentinel pattern (the score lanes
    carry -inf on infeasible nodes) can never reach a selection point:
    argmax/argmin/amax/amin/max/min/sort/topk operands are proven NaN-free,
    and
  * commit-carry resource counters (free CPU/mem, GPU memory, local-storage
    VG/device capacity) stay non-negative through every commit scan.

The abstract domain, its transfer functions, the finding and report types
and the guarded-decrement matcher's verdict ladder are the reference's,
copied (plain Python over floats). What changes is what is walked: where
the reference walks a jaxpr, the port runs the entry on its captured
arguments under a `TorchDispatchMode` (the hook of ops/sanitize.py and the
op census) and evaluates a transfer rule per aten op, keyed by the tensor
the op produced. Each tensor has a value id (vid); an in-place op
(`copy_`, `index_put_`, `masked_fill_`, `add_`...) gives the written tensor
a new vid, and every other live tensor on the same storage (its base, its
views) a new vid joined with what was written, so a write through a view
reaches the base and the other way round. Each op is recorded as
(aten op, input vids, output vids), the def-use graph the matcher's
backward slices walk. Any op without a rule gives TOP and an
``unhandled-primitive`` finding; there is no catch-all.

**Scan bodies.** The port's scans are Python loops over a step function,
called through the marker of ops/scanmark.py. On the first step of a loop
the interpreter records the body's op graph (the step's argument tensors are
its parameters, tensors it reads from outside are further inputs, tensors
it writes outside are carries too), runs the reference's join/widen
fixpoint (`_eval_scan`) over the recorded graph by re-evaluating the rules
(no tensor runs), classifies every float carry slot with the
guarded-decrement matcher (`_classify_carry_slot`), and runs the remaining
steps with the mode suspended: their outputs are registered with the
fixpoint's abstract values, so what the loop builds afterwards (the final
`torch.stack`) is still interpreted. A later step whose inputs are not
covered by the fixpoint's re-runs it from the join. This is sound because
the bodies are shape-static and sync-free (`simon lint` enforces it); a body
that reads a value to the host or makes a data-dependent shape is reported
(``scan-body-sync``) and interpreted step by step instead of trusted.

The matcher recognises the port's spellings of a guarded commit
(kernels.commit_onehot, commit_step, the storage slot loops, the row
commit): ``free - onehot.to(f32)[:, None] * req[None, :]`` (a multiply by a
bool cast), ``where(guard, amount, 0)`` as the decrement,
``where(hit, row - amount, plane)`` (the one-hot row write-back) and an
``index_put`` of the chosen row.

Domain limits: `torch.empty` (and its kin) is bottom, the values of no
element: a buffer is assumed written before it is read (the scans fill
their lane buffers step by step). A hand kernel the dispatcher cannot see
states its output contract through `scanmark.custom_outputs`
(ops/domain_pop.py: node indices in [-1, N), lane indices from its head
table); its equality with its plain version is chip_smoke.py's check.

Abstract domain — per-array, element-uniform::

    AVal = (lo, hi, pos_inf, neg_inf, nan, nonzero, kind)

``[lo, hi]`` bounds the *finite* values under real-number semantics
(float overflow/underflow are out of scope, which is sound for the proofs
above: they are about NaN production and value ranges after explicit
clips). Infinities are NOT encoded in the interval: ``pos_inf``/``neg_inf``
say "an element may be exactly ±inf", which is what the NaN transfer rules
need (``inf - inf``, ``0 * inf``, ``inf / inf``). Widening a bound to
±math.inf therefore means "finite but unknown magnitude" and does not set
the flags. ``nan`` is the taint bit; ``nonzero`` is the refinement the
safe-division idiom ``x / torch.where(d == 0, 1.0, d)`` relies on (a
``where`` whose predicate is ``eq(d, 0)`` excludes 0 from its other
branch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

NEG = float("-inf")
POS = float("inf")

#: ops whose operands must be NaN-free: a NaN here corrupts which lane gets
#: *selected*, not just a value (the paper's placement-policy correctness
#: concern). The reference's primitive names; `_SELECTION_OPS` maps the
#: aten ops onto them.
SELECTION_PRIMITIVES = frozenset(
    {"argmax", "argmin", "reduce_max", "reduce_min", "sort"}
)


# ---------------------------------------------------------------------------
# The domain (the reference's, as it is)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AVal:
    """Element-uniform abstraction of one array. See module docstring."""

    lo: float
    hi: float
    pos_inf: bool = False
    neg_inf: bool = False
    nan: bool = False
    nonzero: bool = False
    kind: str = "f"  # 'f' float / 'i' int / 'b' bool

    def flags(self) -> List[str]:
        out = []
        if self.pos_inf:
            out.append("+inf")
        if self.neg_inf:
            out.append("-inf")
        if self.nan:
            out.append("nan")
        if self.nonzero:
            out.append("nonzero")
        return out

    def describe(self) -> str:
        core = f"[{self.lo:g}, {self.hi:g}] {self.kind}"
        fl = self.flags()
        return core + (" {" + ",".join(fl) + "}" if fl else "")


def kind_of(dtype) -> str:
    """'b', 'i' or 'f' of a torch or numpy dtype."""
    try:
        import torch

        if isinstance(dtype, torch.dtype):
            if dtype == torch.bool:
                return "b"
            if dtype.is_floating_point or dtype.is_complex:
                return "f"
            return "i"
    except ImportError:  # pragma: no cover - the port always has torch
        pass
    d = np.dtype(dtype)
    if d == np.bool_:
        return "b"
    if np.issubdtype(d, np.integer):
        return "i"
    return "f"


def top(kind: str) -> AVal:
    if kind == "b":
        return AVal(0.0, 1.0, kind="b")
    return AVal(
        NEG, POS, pos_inf=(kind == "f"), neg_inf=(kind == "f"),
        nan=(kind == "f"), kind=kind,
    )


def bottom(kind: str) -> AVal:
    """The values of no element (an unwritten `torch.empty`): the unit of
    `join`."""
    return AVal(POS, NEG, nonzero=True, kind=kind)


def const(v: float, kind: str = "f") -> AVal:
    return AVal(float(v), float(v), nonzero=(v != 0), kind=kind)


def from_concrete(x) -> AVal:
    """Abstraction of a concrete array (entry inputs, constants): a torch
    tensor's min, max, NaN, ±inf and zero in one batched host read; a numpy
    array or a number as the reference abstracts it."""
    try:
        import torch

        if isinstance(x, torch.Tensor):
            return _from_tensor(x)
    except ImportError:  # pragma: no cover
        pass
    arr = np.asarray(x)
    kind = kind_of(arr.dtype)
    if arr.size == 0:
        return AVal(0.0, 0.0, kind=kind)
    if kind == "b":
        f = arr.astype(np.float64)
        return AVal(
            float(f.min()), float(f.max()), nonzero=bool(arr.all()), kind="b"
        )
    f = arr.astype(np.float64)
    nan = bool(np.isnan(f).any())
    pos_inf = bool((f == POS).any())
    neg_inf = bool((f == NEG).any())
    finite = f[np.isfinite(f)]
    lo = float(finite.min()) if finite.size else 0.0
    hi = float(finite.max()) if finite.size else 0.0
    nonzero = not bool((f == 0).any())
    return AVal(lo, hi, pos_inf, neg_inf, nan, nonzero, kind)


def _from_tensor(t) -> AVal:
    import torch
    from torch.utils._python_dispatch import _disable_current_modes

    kind = kind_of(t.dtype)
    if t.device.type == "meta":
        return top(kind)
    if t.numel() == 0:
        return AVal(0.0, 0.0, kind=kind)
    with _disable_current_modes(), torch.no_grad():
        t = t.detach()
        wide = torch.float64
        if kind == "b":
            lo, hi, nonzero = torch.stack([t.all(), t.any(), t.all()]).to(wide).tolist()
            return AVal(lo, hi, nonzero=bool(nonzero), kind="b")
        if kind == "i":
            lo, hi, zero = torch.stack(
                [t.amin().to(wide), t.amax().to(wide), (t == 0).any().to(wide)]
            ).tolist()
            return AVal(lo, hi, nonzero=not zero, kind="i")
        finite = torch.isfinite(t)
        lo, hi, any_fin, nan, pinf, ninf, zero = torch.stack([
            torch.where(finite, t, POS).amin().to(wide),
            torch.where(finite, t, NEG).amax().to(wide),
            finite.any().to(wide), torch.isnan(t).any().to(wide),
            (t == POS).any().to(wide), (t == NEG).any().to(wide), (t == 0).any().to(wide),
        ]).tolist()
    if not any_fin:
        lo = hi = 0.0
    return AVal(lo, hi, bool(pinf), bool(ninf), bool(nan), not zero, "f")


def _promote(a: AVal, b: AVal) -> str:
    ks = {a.kind, b.kind}
    if "f" in ks:
        return "f"
    if "i" in ks:
        return "i"
    return "b"


def join(a: AVal, b: AVal) -> AVal:
    return AVal(
        min(a.lo, b.lo),
        max(a.hi, b.hi),
        a.pos_inf or b.pos_inf,
        a.neg_inf or b.neg_inf,
        a.nan or b.nan,
        a.nonzero and b.nonzero,
        _promote(a, b),
    )


def widen(old: AVal, new: AVal) -> AVal:
    """Accelerate the scan fixpoint: any bound still moving goes to
    unknown-finite (±math.inf WITHOUT the inf flags — see module doc)."""
    return AVal(
        NEG if new.lo < old.lo else old.lo,
        POS if new.hi > old.hi else old.hi,
        old.pos_inf or new.pos_inf,
        old.neg_inf or new.neg_inf,
        old.nan or new.nan,
        old.nonzero and new.nonzero,
        _promote(old, new),
    )


def leq(a: AVal, b: AVal) -> bool:
    """a ⊑ b: every value a admits, b admits."""
    return (
        (a.lo >= b.lo or a.lo > a.hi)
        and (a.hi <= b.hi or a.lo > a.hi)
        and (b.pos_inf or not a.pos_inf)
        and (b.neg_inf or not a.neg_inf)
        and (b.nan or not a.nan)
        and (a.nonzero or not b.nonzero)
    )


def may_pos(a: AVal) -> bool:
    return a.hi > 0 or a.pos_inf


def may_neg(a: AVal) -> bool:
    return a.lo < 0 or a.neg_inf


def may_zero(a: AVal) -> bool:
    return (not a.nonzero) and a.lo <= 0 <= a.hi


def inf_any(a: AVal) -> bool:
    return a.pos_inf or a.neg_inf


# Bound arithmetic that never manufactures NaN: inf-inf / inf*0 at the
# BOUND level means "unknown", resolved toward the conservative side.
def _badd(x: float, y: float, side: int) -> float:
    r = x + y
    if math.isnan(r):
        return NEG if side < 0 else POS
    return r


def _bmul(x: float, y: float) -> float:
    if x == 0 or y == 0:
        return 0.0
    return x * y


def _bdiv(x: float, y: float, side: int) -> float:
    if x == 0:
        return 0.0
    if y == 0:  # callers exclude 0 from y's interval; defensive only
        return NEG if side < 0 else POS
    r = x / y
    if math.isnan(r):
        return NEG if side < 0 else POS
    return r


# ---------------------------------------------------------------------------
# Transfer rules (the reference's)
# ---------------------------------------------------------------------------

def _r_add(a: AVal, b: AVal) -> AVal:
    return AVal(
        _badd(a.lo, b.lo, -1),
        _badd(a.hi, b.hi, +1),
        a.pos_inf or b.pos_inf,
        a.neg_inf or b.neg_inf,
        a.nan or b.nan or (a.pos_inf and b.neg_inf) or (a.neg_inf and b.pos_inf),
        False,
        _promote(a, b),
    )


def _r_sub(a: AVal, b: AVal) -> AVal:
    return AVal(
        _badd(a.lo, -b.hi, -1),
        _badd(a.hi, -b.lo, +1),
        a.pos_inf or b.neg_inf,
        a.neg_inf or b.pos_inf,
        a.nan or b.nan or (a.pos_inf and b.pos_inf) or (a.neg_inf and b.neg_inf),
        False,
        _promote(a, b),
    )


def _r_mul(a: AVal, b: AVal) -> AVal:
    prods = (
        _bmul(a.lo, b.lo), _bmul(a.lo, b.hi),
        _bmul(a.hi, b.lo), _bmul(a.hi, b.hi),
    )
    # THE sentinel rule: ±inf times a possibly-zero factor is NaN.
    nan = (
        a.nan or b.nan
        or (inf_any(a) and may_zero(b))
        or (inf_any(b) and may_zero(a))
    )
    pos_inf = (
        (a.pos_inf and may_pos(b)) or (a.neg_inf and may_neg(b))
        or (b.pos_inf and may_pos(a)) or (b.neg_inf and may_neg(a))
    )
    neg_inf = (
        (a.pos_inf and may_neg(b)) or (a.neg_inf and may_pos(b))
        or (b.pos_inf and may_neg(a)) or (b.neg_inf and may_pos(a))
    )
    return AVal(
        min(prods), max(prods), pos_inf, neg_inf, nan,
        a.nonzero and b.nonzero, _promote(a, b),
    )


def _r_div(a: AVal, b: AVal) -> AVal:
    nan = (
        a.nan or b.nan
        or (may_zero(a) and may_zero(b))          # 0 / 0
        or (inf_any(a) and inf_any(b))            # inf / inf
    )
    if may_neg(b):  # denominator sign unknown: infs can land either side
        pos_inf = inf_any(a) or (may_zero(b) and (may_pos(a) or may_neg(a)))
        neg_inf = pos_inf
    else:
        pos_inf = a.pos_inf or (may_pos(a) and may_zero(b))
        neg_inf = a.neg_inf or (may_neg(a) and may_zero(b))
    if b.nonzero and (b.lo > 0 or b.hi < 0):
        quots = (
            _bdiv(a.lo, b.lo, -1), _bdiv(a.lo, b.hi, -1),
            _bdiv(a.hi, b.lo, +1), _bdiv(a.hi, b.hi, +1),
        )
        lo, hi = min(quots), max(quots)
    else:
        # 0 in (or arbitrarily near) the denominator range: unbounded
        lo, hi = NEG, POS
    return AVal(lo, hi, pos_inf, neg_inf, nan, False, _promote(a, b))


def _r_rem(a: AVal, b: AVal) -> AVal:
    m = max(abs(b.lo), abs(b.hi))
    lo = 0.0 if a.lo >= 0 and not a.neg_inf else -m
    hi = 0.0 if a.hi <= 0 and not a.pos_inf else m
    nan = a.nan or b.nan or inf_any(a) or (
        may_zero(b) and _promote(a, b) == "f"
    )
    return AVal(lo, hi, False, False, nan, False, _promote(a, b))


def _r_max(a: AVal, b: AVal) -> AVal:
    lo_cands = [max(a.lo, b.lo)]
    if a.neg_inf:
        lo_cands.append(b.lo)
    if b.neg_inf:
        lo_cands.append(a.lo)
    return AVal(
        min(lo_cands),
        max(a.hi, b.hi),
        a.pos_inf or b.pos_inf,
        a.neg_inf and b.neg_inf,
        a.nan or b.nan,
        False,
        _promote(a, b),
    )


def _r_min(a: AVal, b: AVal) -> AVal:
    hi_cands = [min(a.hi, b.hi)]
    if a.pos_inf:
        hi_cands.append(b.hi)
    if b.pos_inf:
        hi_cands.append(a.hi)
    return AVal(
        min(a.lo, b.lo),
        max(hi_cands),
        a.pos_inf and b.pos_inf,
        a.neg_inf or b.neg_inf,
        a.nan or b.nan,
        False,
        _promote(a, b),
    )


def _r_neg(a: AVal) -> AVal:
    return AVal(
        -a.hi, -a.lo, a.neg_inf, a.pos_inf, a.nan, a.nonzero, a.kind
    )


def _r_abs(a: AVal) -> AVal:
    if a.lo >= 0:
        lo, hi = a.lo, a.hi
    elif a.hi <= 0:
        lo, hi = -a.hi, -a.lo
    else:
        lo, hi = 0.0, max(-a.lo, a.hi)
    return AVal(lo, hi, inf_any(a), False, a.nan, a.nonzero, a.kind)


def _r_sign(a: AVal) -> AVal:
    lo = -1.0 if may_neg(a) else (0.0 if may_zero(a) else 1.0)
    hi = 1.0 if may_pos(a) else (0.0 if may_zero(a) else -1.0)
    return AVal(lo, hi, False, False, a.nan, False, a.kind)


def _r_floor(a: AVal) -> AVal:
    lo = a.lo if math.isinf(a.lo) else math.floor(a.lo)
    hi = a.hi if math.isinf(a.hi) else math.floor(a.hi)
    return AVal(lo, hi, a.pos_inf, a.neg_inf, a.nan, False, a.kind)


def _bool_out() -> AVal:
    return AVal(0.0, 1.0, kind="b")


def _sum_of(a: AVal, n: int) -> AVal:
    """Sum of exactly n elements each abstracted by `a`."""
    if n <= 0:
        return AVal(0.0, 0.0, kind=a.kind)
    return AVal(
        _bmul(float(n), a.lo) if a.lo < 0 else a.lo,
        _bmul(float(n), a.hi) if a.hi > 0 else a.hi,
        a.pos_inf,
        a.neg_inf,
        a.nan or (a.pos_inf and a.neg_inf),  # mixed ±inf sum
        False,
        a.kind,
    )


def _convert(a: AVal, new_kind: str) -> AVal:
    if new_kind == a.kind:
        return a
    if new_kind == "b":
        lo = 1.0 if a.nonzero else 0.0
        all_zero = a.lo == 0 == a.hi and not inf_any(a) and not a.nan
        return AVal(lo, 0.0 if all_zero else 1.0,
                    nonzero=a.nonzero, kind="b")
    if new_kind == "i":
        if a.nan or inf_any(a):
            return top("i")  # float->int of nan/inf is undefined
        lo = a.lo if math.isinf(a.lo) else math.floor(a.lo)
        hi = a.hi if math.isinf(a.hi) else math.ceil(a.hi)
        return AVal(lo, hi, nonzero=a.nonzero, kind="i")
    return dataclasses.replace(a, kind="f")


# ---------------------------------------------------------------------------
# Findings / reports (the reference's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class InvariantFinding:
    entry: str
    kind: str       # nan-output | selection-taint | score-range | unhandled-primitive
                    # | commit-carry-nonneg | scan-body-sync
    primitive: str
    path: str       # op path, e.g. "scan[ops.kernels:schedule_step#0]/op17"
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: verdict ladder for one float carry slot of one scan, strongest first.
CARRY_PROVED = "proved"              # guard ⇒ amount ≤ slot + ε
CARRY_GUARDED = "guarded"            # bool guard tied to slot, amount not
CARRY_NON_DECREASING = "non-decreasing"
CARRY_UNCHANGED = "unchanged"
CARRY_UNRECOGNIZED = "unrecognized"  # update shape outside the idiom set
CARRY_VIRTUAL = "virtual"            # unguarded, but the final carry is
                                     # dropped: a replay carry, not state
CARRY_UNGUARDED = "unguarded"        # decrement with no bool guard: finding


@dataclasses.dataclass(frozen=True, order=True)
class CommitCarryReport:
    """Non-negativity verdict for one float carry slot of one scan."""

    path: str    # the scan, e.g. "scan[ops.kernels:schedule_step#0]"
    slot: int
    shape: str
    verdict: str
    detail: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# The recorded op graph
# ---------------------------------------------------------------------------

class _Ref:
    """An op argument that is a tensor: the index of its vid in `ins`."""

    __slots__ = ("i",)

    def __init__(self, i: int) -> None:
        self.i = i


class _Node:
    """One recorded op: its aten op (overload packet name), its arguments
    with tensors replaced by `_Ref`s into `ins` (input vids), its output
    vids and the shapes and dtypes of its tensor inputs and outputs. A scan
    step is a node too (`step` is its _ScanRecord)."""

    __slots__ = ("op", "args", "kwargs", "ins", "outs", "in_meta", "out_meta", "path", "step")

    def __init__(self, op, args, kwargs, ins, in_meta, out_meta, path, step=None) -> None:
        self.op, self.args, self.kwargs, self.ins = op, args, kwargs, ins
        self.in_meta, self.out_meta, self.path, self.step = in_meta, out_meta, path, step
        self.outs: List[int] = []


def _skeleton(obj, tensors: list):
    import torch

    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return _Ref(len(tensors) - 1)
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_skeleton(o, tensors) for o in obj)
    if isinstance(obj, dict):
        return {k: _skeleton(v, tensors) for k, v in obj.items()}
    return obj


def _meta(t) -> Tuple[tuple, Any]:
    return tuple(t.shape), t.dtype


def _base(name: str) -> str:
    """The functional name of an aten op: `add_` -> `add`."""
    if name.endswith("_") and not name.endswith("__") and not name.startswith("_"):
        return name[:-1]
    if name.startswith("_") and name.endswith("_") and not name.endswith("__"):
        return name[:-1]
    return name


_WRITES: Dict[Any, Tuple[Tuple[int, str], ...]] = {}


def _written_args(func) -> Tuple[Tuple[int, str], ...]:
    """(position, name) of the arguments an aten op writes in place."""
    got = _WRITES.get(func)
    if got is None:
        got = tuple(
            (i, a.name) for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write
        )
        _WRITES[func] = got
    return got


# ---------------------------------------------------------------------------
# Aten rule table
# ---------------------------------------------------------------------------

def _arg(node: _Node, ins: List[AVal], i: int, name: str = "", default: Any = None):
    """The abstract value of positional argument i (or keyword `name`): a
    tensor's AVal, a number's const, None when absent."""
    if i < len(node.args):
        a = node.args[i]
    elif name and name in node.kwargs:
        a = node.kwargs[name]
    else:
        return default
    return _aval_of_arg(a, ins)


def _aval_of_arg(a, ins: List[AVal]):
    if isinstance(a, _Ref):
        return ins[a.i]
    if isinstance(a, bool):
        return const(float(a), "b")
    if isinstance(a, int):
        return const(float(a), "i")
    if isinstance(a, float):
        if math.isnan(a):
            return AVal(0.0, 0.0, nan=True)
        if math.isinf(a):
            return AVal(0.0, 0.0, pos_inf=a > 0, neg_inf=a < 0)
        return const(a, "f")
    return a


def _raw(node: _Node, i: int, name: str = "", default: Any = None):
    """A non-tensor argument's Python value."""
    if i < len(node.args):
        return node.args[i]
    return node.kwargs.get(name, default) if name else default


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _reduced(node: _Node) -> int:
    """Elements folded into each output element of a reduction."""
    n_in = _numel(node.in_meta[0][0])
    n_out = _numel(node.out_meta[0][0]) if node.out_meta else 1
    return n_in // n_out if n_out else 0


def _first(node: _Node, ins: List[AVal]) -> AVal:
    """The abstract value of the op's first argument (a tensor, or a number
    a batching rule passed as it is)."""
    a = _arg(node, ins, 0)
    return a if isinstance(a, AVal) else top(kind_of(node.out_meta[0][1]) if node.out_meta else "f")


def _binary(fn: Callable[[AVal, AVal], AVal], alpha: bool = False):
    def rule(node, ins):
        a, b = _arg(node, ins, 0), _arg(node, ins, 1)
        if alpha:
            al = _raw(node, 2, "alpha", 1)
            if al not in (1, None):
                b = _r_mul(b, const(float(al)))
        return [fn(a, b)]

    return rule


def _unary(fn: Callable[[AVal], AVal]):
    return lambda node, ins: [fn(_first(node, ins))]


def _identity(node, ins):
    return [_first(node, ins)] * max(len(node.out_meta), 1)


def _join_all(node, ins):
    if not ins:
        return [bottom(kind_of(node.out_meta[0][1]))]
    out = ins[0]
    for a in ins[1:]:
        out = join(out, a)
    return [out]


def _bool_rule(node, ins):
    return [_bool_out()] * max(len(node.out_meta), 1)


def _logic_rule(node, ins):
    if all(kind_of(m[1]) == "b" for m in node.out_meta):
        return [_bool_out()]
    return [top("i")]


def _r_rsub(node, ins):
    a, b = _arg(node, ins, 0), _arg(node, ins, 1)
    al = _raw(node, 2, "alpha", 1)
    if al not in (1, None):
        a = _r_mul(a, const(float(al)))
    return [_r_sub(b, a)]


def _r_div_mode(node, ins):
    a, b = _arg(node, ins, 0), _arg(node, ins, 1)
    mode = _raw(node, 2, "rounding_mode", None)
    q = _r_div(a, b)
    if mode == "floor":
        return [_r_floor(q)]
    if mode == "trunc":
        lo = q.lo if math.isinf(q.lo) else math.floor(q.lo)
        hi = q.hi if math.isinf(q.hi) else math.ceil(q.hi)
        return [dataclasses.replace(q, lo=lo, hi=hi)]
    return [q]


def _r_floordiv(node, ins):
    return [_r_floor(_r_div(_arg(node, ins, 0), _arg(node, ins, 1)))]


def _r_ceil(node, ins):
    a = _first(node, ins)
    lo = a.lo if math.isinf(a.lo) else math.ceil(a.lo)
    hi = a.hi if math.isinf(a.hi) else math.ceil(a.hi)
    return [AVal(lo, hi, a.pos_inf, a.neg_inf, a.nan, False, a.kind)]


def _r_round(node, ins):
    a = _first(node, ins)
    lo = a.lo if math.isinf(a.lo) else math.floor(a.lo)
    hi = a.hi if math.isinf(a.hi) else math.ceil(a.hi)
    return [AVal(lo, hi, a.pos_inf, a.neg_inf, a.nan, False, a.kind)]


def _r_clamp(node, ins):
    x = _first(node, ins)
    mn = _arg(node, ins, 1, "min")
    mx = _arg(node, ins, 2, "max")
    if mn is not None:
        x = _r_max(x, mn)
    if mx is not None:
        x = _r_min(x, mx)
    return [x]


def _r_clamp_min(node, ins):
    return [_r_max(_first(node, ins), _arg(node, ins, 1, "min"))]


def _r_clamp_max(node, ins):
    return [_r_min(_first(node, ins), _arg(node, ins, 1, "max"))]


def _r_sum(node, ins):
    return [_sum_of(_first(node, ins), _reduced(node))]


def _r_mean(node, ins):
    a, n = _first(node, ins), _reduced(node)
    return [AVal(a.lo, a.hi, a.pos_inf, a.neg_inf, a.nan or n == 0 or (a.pos_inf and a.neg_inf),
                 False, a.kind)]


def _r_var(node, ins):
    a = _first(node, ins)
    return [AVal(0.0, POS, False, False, a.nan or inf_any(a), False, "f")]


def _r_minmax_reduce(node, ins):
    a = _first(node, ins)
    vals = dataclasses.replace(a, nonzero=False)
    if len(node.out_meta) == 2:        # max.dim / min.dim: (values, indices)
        return [vals, _index_range(node)]
    return [vals]


def _index_range(node: _Node) -> AVal:
    n = _reduced(node)
    return AVal(0.0, float(max(n - 1, 0)), kind="i")


def _r_argminmax(node, ins):
    return [_index_range(node)]


def _r_count_nonzero(node, ins):
    return [AVal(0.0, float(_reduced(node)), kind="i")]


def _r_cumsum(node, ins):
    dim = _raw(node, 1, "dim", 0)
    shape = node.in_meta[0][0]
    n = int(shape[dim]) if shape else 1
    a = _first(node, ins)
    s = _sum_of(a, max(n, 1))
    # a prefix sum of k<=n terms: bounds include the 1-term case too
    return [AVal(min(s.lo, a.lo, 0.0) if n > 1 else s.lo,
                 max(s.hi, a.hi, 0.0) if n > 1 else s.hi,
                 s.pos_inf, s.neg_inf, s.nan, False, a.kind)]


def _r_matmul(node, ins):
    n = int(node.in_meta[0][0][-1]) if node.in_meta[0][0] else 1
    return [_sum_of(_r_mul(_first(node, ins), _arg(node, ins, 1)), n)]


def _r_sort(node, ins):
    dim = _raw(node, 1, "dim", -1)
    if not isinstance(dim, int):       # sort.stable(self, *, stable, dim, descending)
        dim = node.kwargs.get("dim", -1)
    shape = node.in_meta[0][0]
    n = int(shape[dim]) if shape else 1
    return [_first(node, ins), AVal(0.0, float(max(n - 1, 0)), kind="i")]


def _r_topk(node, ins):
    dim = _raw(node, 2, "dim", -1)
    shape = node.in_meta[0][0]
    n = int(shape[dim]) if shape else 1
    return [_first(node, ins), AVal(0.0, float(max(n - 1, 0)), kind="i")]


def _r_argsort(node, ins):
    return [_r_sort(node, ins)[1]]


def _r_convert(node, ins):
    return [_convert(_first(node, ins), kind_of(node.out_meta[0][1]))]


def _r_copy_into(node, ins):
    """copy_(dst, src): dst takes src's values in dst's kind."""
    return [_convert(_arg(node, ins, 1), kind_of(node.in_meta[0][1]))]


def _r_arange(node, ins):
    nums = [a for a in node.args if isinstance(a, (int, float))]
    if len(nums) == 1:
        start, step = 0.0, 1.0
    else:
        start = float(nums[0])
        step = float(nums[2]) if len(nums) > 2 else 1.0
    n = _numel(node.out_meta[0][0])
    last = start + step * max(n - 1, 0)
    return [AVal(min(start, last), max(start, last), kind=kind_of(node.out_meta[0][1]))]


def _fill_value(node, ins, i: int, name: str = "fill_value") -> AVal:
    v = _arg(node, ins, i, name)
    return v if isinstance(v, AVal) else const(float(v))


def _r_full(node, ins):
    return [_fill_value(node, ins, 1)]


def _r_new_full(node, ins):
    return [_fill_value(node, ins, 2)]


def _r_fill(node, ins):
    return [_fill_value(node, ins, 1, "value")]


def _r_scalar_tensor(node, ins):
    return [_fill_value(node, ins, 0, "s")]


def _const_rule(v: float):
    return lambda node, ins: [const(v)]


def _r_empty(node, ins):
    return [bottom(kind_of(node.out_meta[0][1]))]


def _r_gather(node, ins):
    return [_first(node, ins)]


def _r_scatter(node, ins):
    """scatter / index_copy / index_put (without accumulate) / masked
    scatter: the target's values or the written ones."""
    if node.op.startswith("index_put") or node.op.startswith("_index_put") \
            or node.op.startswith("_unsafe_index_put"):
        acc = _raw(node, 3, "accumulate", False)
        vals = _arg(node, ins, 2, "values")
        return [_scatter_add(_first(node, ins), vals) if acc else join(_first(node, ins), vals)]
    src = _arg(node, ins, 3, "src")
    if src is None:
        src = _arg(node, ins, 3, "value")
    if src is None:
        src = _arg(node, ins, 2, "source")
    return [join(_first(node, ins), src)]


def _scatter_add(op: AVal, upd: AVal) -> AVal:
    # an unknown number of updates may hit one slot: only the direction
    # updates cannot push survives as a bound
    lo = NEG if may_neg(upd) else op.lo
    hi = POS if may_pos(upd) else op.hi
    nan = op.nan or upd.nan or (
        (op.pos_inf or upd.pos_inf) and (op.neg_inf or upd.neg_inf)
    )
    return AVal(lo, hi, op.pos_inf or upd.pos_inf,
                op.neg_inf or upd.neg_inf, nan, False, op.kind)


def _r_scatter_add(node, ins):
    upd = _arg(node, ins, 3, "src")
    al = _raw(node, 4, "alpha", 1)
    if al not in (1, None):
        upd = _r_mul(upd, const(float(al)))
    return [_scatter_add(_first(node, ins), upd)]


def _r_fill_like(i: int, name: str):
    def rule(node, ins):
        v = _arg(node, ins, i, name)
        return [join(_first(node, ins), v if isinstance(v, AVal) else const(float(v)))]

    return rule


def _r_pad(node, ins):
    v = _raw(node, 2, "value", 0.0)
    return [join(_first(node, ins), const(float(v or 0.0)))]


def _r_nonzero(node, ins):
    dims = node.in_meta[0][0]
    return [AVal(0.0, float(max(max(dims, default=1) - 1, 0)), kind="i")]


def _r_searchsorted(node, ins):
    n = int(node.in_meta[0][0][-1]) if node.in_meta[0][0] else 0
    return [AVal(0.0, float(n), kind="i")]


def _r_exp(node, ins):
    a = _first(node, ins)
    lo = math.exp(a.lo) if a.lo < 700 else POS
    hi = math.exp(a.hi) if a.hi < 700 else POS
    return [AVal(lo if not a.neg_inf else 0.0, hi, a.pos_inf or hi == POS, False, a.nan,
                 False, "f")]


def _r_pow(node, ins):
    a, e = _first(node, ins), _arg(node, ins, 1, "exponent")
    if e is not None and e.lo == e.hi == 2.0 and not (e.nan or inf_any(e)):
        return [_r_mul(a, a) if a.lo >= 0 or a.hi <= 0 else
                AVal(0.0, max(a.lo * a.lo, a.hi * a.hi), inf_any(a), False, a.nan, False,
                     a.kind)]
    return [top("f")]


def _r_sqrt(node, ins):
    a = _first(node, ins)
    nan = a.nan or may_neg(a)
    hi = math.sqrt(a.hi) if 0 <= a.hi < POS else (POS if a.hi > 0 else 0.0)
    return [AVal(math.sqrt(max(a.lo, 0.0)) if a.lo < POS else 0.0, hi, a.pos_inf, False, nan,
                 False, "f")]


def _r_log(node, ins):
    a = _first(node, ins)
    nan = a.nan or may_neg(a)
    neg_inf = may_zero(a) or a.lo <= 0
    lo = math.log(a.lo) if a.lo > 0 else NEG
    hi = math.log(a.hi) if 0 < a.hi < POS else (POS if a.hi > 0 else NEG)
    return [AVal(lo, hi, a.pos_inf, neg_inf, nan, False, "f")]


def _r_bitwise(node, ins):
    return _logic_rule(node, ins)


#: aten ops (functional names, `_base`) -> rule(node, ins) -> [AVal per
#: tensor output]; outputs are then fitted to their dtype's kind
_RULES: Dict[str, Callable] = {
    "add": _binary(_r_add, alpha=True),
    "sub": _binary(_r_sub, alpha=True),
    "rsub": _r_rsub,
    "mul": _binary(_r_mul),
    "div": _r_div_mode,
    "true_divide": _binary(_r_div),
    "floor_divide": _r_floordiv,
    "remainder": _binary(_r_rem),
    "fmod": _binary(_r_rem),
    "maximum": _binary(_r_max),
    "minimum": _binary(_r_min),
    "fmax": _binary(_r_max),
    "fmin": _binary(_r_min),
    "neg": _unary(_r_neg),
    "abs": _unary(_r_abs),
    "sign": _unary(_r_sign),
    "sgn": _unary(_r_sign),
    "floor": _unary(_r_floor),
    "ceil": _r_ceil,
    "round": _r_round,
    "trunc": _r_round,
    "clamp": _r_clamp,
    "clip": _r_clamp,
    "clamp_min": _r_clamp_min,
    "clamp_max": _r_clamp_max,
    "exp": _r_exp,
    "reciprocal": lambda node, ins: [_r_div(const(1.0), _first(node, ins))],
    "pow": _r_pow,
    "sqrt": _r_sqrt,
    "log": _r_log,
    "eq": _bool_rule,
    "ne": _bool_rule,
    "ge": _bool_rule,
    "gt": _bool_rule,
    "le": _bool_rule,
    "lt": _bool_rule,
    "isfinite": _bool_rule,
    "isnan": _bool_rule,
    "isinf": _bool_rule,
    "isposinf": _bool_rule,
    "isneginf": _bool_rule,
    "isin": _bool_rule,
    "logical_and": _bool_rule,
    "logical_or": _bool_rule,
    "logical_xor": _bool_rule,
    "logical_not": _bool_rule,
    "bitwise_and": _r_bitwise,
    "bitwise_or": _r_bitwise,
    "bitwise_xor": _r_bitwise,
    "bitwise_not": _r_bitwise,
    "any": _bool_rule,
    "all": _bool_rule,
    "sum": _r_sum,
    "nansum": _r_sum,
    "mean": _r_mean,
    "var": _r_var,
    "std": _r_var,
    "amax": _r_minmax_reduce,
    "amin": _r_minmax_reduce,
    "max": _r_minmax_reduce,
    "min": _r_minmax_reduce,
    "argmax": _r_argminmax,
    "argmin": _r_argminmax,
    "count_nonzero": _r_count_nonzero,
    "cumsum": _r_cumsum,
    "mm": _r_matmul,
    "bmm": _r_matmul,
    "matmul": _r_matmul,
    "dot": _r_matmul,
    "mv": _r_matmul,
    "sort": _r_sort,
    "topk": _r_topk,
    "argsort": _r_argsort,
    "_to_copy": _r_convert,
    "to": _r_convert,
    "copy": _r_copy_into,
    "_copy_from": _r_copy_into,
    "arange": _r_arange,
    "full": _r_full,
    "full_like": _r_full,
    "new_full": _r_new_full,
    "scalar_tensor": _r_scalar_tensor,
    "fill": _r_fill,
    "zero": _const_rule(0.0),
    "zeros": _const_rule(0.0),
    "zeros_like": _const_rule(0.0),
    "new_zeros": _const_rule(0.0),
    "ones": _const_rule(1.0),
    "ones_like": _const_rule(1.0),
    "new_ones": _const_rule(1.0),
    "empty": _r_empty,
    "empty_like": _r_empty,
    "new_empty": _r_empty,
    "empty_strided": _r_empty,
    "new_empty_strided": _r_empty,
    "index": _r_gather,
    "_unsafe_index": _r_gather,
    "index_select": _r_gather,
    "gather": _r_gather,
    "take": _r_gather,
    "take_along_dim": _r_gather,
    "embedding": _r_gather,
    "masked_select": _r_gather,
    "index_put": _r_scatter,
    "_index_put_impl": _r_scatter,
    "_unsafe_index_put": _r_scatter,
    "scatter": _r_scatter,
    "index_copy": _r_scatter,
    "masked_scatter": _r_scatter,
    "select_scatter": lambda node, ins: [join(_first(node, ins), _arg(node, ins, 1))],
    "slice_scatter": lambda node, ins: [join(_first(node, ins), _arg(node, ins, 1))],
    "scatter_add": _r_scatter_add,
    "index_add": _r_scatter_add,
    "index_fill": _r_fill_like(3, "value"),
    "masked_fill": _r_fill_like(2, "value"),
    "cat": lambda node, ins: _join_all(node, ins),
    "stack": lambda node, ins: _join_all(node, ins),
    "constant_pad_nd": _r_pad,
    "nonzero": _r_nonzero,
    "_local_scalar_dense": lambda node, ins: [],
    # a profiler range around a launch (ops/domain_pop.py): no value
    "_record_function_enter": lambda node, ins: [],
    "_record_function_enter_new": lambda node, ins: [],
    "_record_function_exit": lambda node, ins: [],
    "__lshift__": _r_bitwise,
    "__rshift__": _r_bitwise,
    "bitwise_left_shift": _r_bitwise,
    "bitwise_right_shift": _r_bitwise,
    "searchsorted": _r_searchsorted,
}

#: ops that pass their first operand's values through (views and copies):
#: identity rules, and the matcher looks straight through them
_SHAPE_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "expand_as",
    "unsqueeze", "squeeze", "permute", "transpose", "t", "alias", "detach", "clone",
    "contiguous", "lift_fresh", "lift_fresh_copy", "view_as", "movedim", "flatten",
    "unflatten",
})
#: ops whose outputs are parts or rearrangements of their first operand
_PART_OPS = frozenset({
    "select", "slice", "narrow", "diagonal", "as_strided", "unbind", "split",
    "split_with_sizes", "chunk", "tensor_split", "unfold", "repeat", "tile", "flip",
    "roll", "repeat_interleave",
})
for _name in _SHAPE_OPS | _PART_OPS:
    _RULES[_name] = _identity

#: aten ops that are selection points, by the reference's primitive names
_SELECTION_OPS = {
    "argmax": "argmax", "argmin": "argmin", "amax": "reduce_max", "amin": "reduce_min",
    "max": "reduce_max", "min": "reduce_min", "sort": "sort", "topk": "sort",
    "argsort": "sort",
}

#: ops that read a value to the host or make a data-dependent shape: a scan
#: body that issues one is interpreted step by step, not trusted
_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "masked_select", "unique", "_unique",
    "_unique2", "unique_consecutive", "unique_dim",
})

#: feasibility comparisons; eq/ne deliberately excluded (an equality on a
#: resource counter does not bound a decrement).
_ORDER_COMPARISONS = frozenset({"gt", "ge", "lt", "le"})

#: constant creators: a vid made by one of these (with no tensor input) is
#: a literal to the matcher
_CONST_OPS = frozenset({"scalar_tensor", "full", "zeros", "ones", "lift_fresh",
                        "lift_fresh_copy"})


class _Lit:
    """A literal operand: a Python number in an op's arguments, or a
    constant-made tensor."""

    __slots__ = ("value",)

    def __init__(self, value) -> None:
        self.value = value


# ---------------------------------------------------------------------------
# Scan records
# ---------------------------------------------------------------------------

class _ScanRecord:
    """One scan body: the op graph of its first step and its fixpoint."""

    def __init__(self, name: str, index: int, fn, key) -> None:
        self.name, self.index, self.fn, self.key = name, index, fn, key
        self.path = f"scan[{name}#{index}]"
        self.nodes: List[_Node] = []
        self.local: set = set()
        self.defs: Dict[int, _Node] = {}
        self.params: List[int] = []        # vids of the argument tensors
        self.param_set: set = set()
        self.ext: List[int] = []           # vids read from outside
        self.ext_set: set = set()
        self.ext_objs: List[Any] = []
        self.out_vids: List[int] = []      # vids of the result's tensor leaves
        self.carry_params: List[int] = []  # positions (in inputs) of the carry leaves
        self.carry_outs: List[int] = []    # out vids of the new-carry leaves
        self.carry_meta: List[Tuple[tuple, Any]] = []
        self.implicit: List[Tuple[Any, int, int]] = []  # (tensor, input position, post vid)
        self.written: Dict[int, Tuple[Any, int]] = {}   # id(tensor) -> (tensor, pre vid)
        self.untrusted: Optional[str] = None
        self.template = None
        self.cover: Optional[List[AVal]] = None
        self.cover_out: Dict[int, AVal] = {}
        self.last_carry_vids: List[int] = []
        self.reports: List[Tuple[int, str, str, str]] = []  # (slot, shape, verdict, detail)

    @property
    def inputs(self) -> List[int]:
        return self.params + self.ext

    def pairs(self) -> List[Tuple[int, int]]:
        """(input position, out vid) of every loop-carried value."""
        return list(zip(self.carry_params, self.carry_outs)) + [
            (pos, post) for _t, pos, post in self.implicit
        ]


def _signature(x: Any) -> Any:
    import torch

    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype), str(x.device))
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
    return ("O", id(x))


def _flat_tensors(x: Any) -> list:
    from .entry_audit import tree_leaves

    import torch

    return [a for a in tree_leaves(x) if isinstance(a, torch.Tensor)]


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------

def _mode_base():
    from torch.utils._python_dispatch import TorchDispatchMode

    return TorchDispatchMode


class Interpreter:
    """The abstract interpretation of one entry call (see module
    docstring). `run(fn, args, kwargs)` calls the entry under the mode with
    the scan marker's handler installed and returns its outputs."""

    MAX_FIXPOINT_ITERS = 8
    WIDEN_AFTER = 2

    def __init__(self, entry: str) -> None:
        self.entry = entry
        self._findings: Dict[Tuple, InvariantFinding] = {}
        self.carry_proofs: List[CommitCarryReport] = []
        self._vid: Dict[int, Tuple[int, Optional[int]]] = {}   # id(tensor) -> (vid, version)
        self._obj: Dict[int, Any] = {}               # id(tensor) -> tensor (kept alive)
        self._storage: Dict[int, List[int]] = {}     # storage key -> ids of its tensors
        self.aval: Dict[int, AVal] = {}
        self.defs: Dict[int, _Node] = {}
        self._next = 0
        self._top_ops = 0
        self.frames: List[_ScanRecord] = []
        self.records: Dict[Any, _ScanRecord] = {}
        self._all_records: List[_ScanRecord] = []
        self.read: set = set()

    # -- findings -----------------------------------------------------------

    def finding(self, kind: str, primitive: str, path: str, message: str):
        key = (kind, primitive, path)
        if key not in self._findings:
            self._findings[key] = InvariantFinding(self.entry, kind, primitive, path, message)

    @property
    def findings(self) -> List[InvariantFinding]:
        return sorted(self._findings.values())

    # -- values -------------------------------------------------------------

    def _new_vid(self, a: AVal, node: Optional[_Node]) -> int:
        vid = self._next
        self._next += 1
        self.aval[vid] = a
        if node is not None:
            self.defs[vid] = node
            node.outs.append(vid)
            if self.frames:
                self.frames[-1].local.add(vid)
                self.frames[-1].defs[vid] = node
        return vid

    @staticmethod
    def _version(t) -> int:
        try:
            return int(t._version)
        except RuntimeError:  # an inference tensor keeps no version counter
            return -1

    @staticmethod
    def _skey(t) -> int:
        try:
            return t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return -id(t)

    def _bind(self, t, vid: int, pending: bool = False) -> None:
        """`t` holds `vid` now. `pending`: `t` was just written in place,
        and its version counter moves only after the mode returns (the
        autograd layer above it bumps it), so the next lookup pins it."""
        i = id(t)
        if i not in self._obj:
            self._obj[i] = t
            self._storage.setdefault(self._skey(t), []).append(i)
        self._vid[i] = (vid, None if pending else self._version(t))

    def vid_of(self, t) -> int:
        """The vid a tensor holds now; an unseen (or changed-outside) tensor
        is abstracted from its values."""
        got = self._vid.get(id(t))
        if got is not None and got[1] is None:
            self._vid[id(t)] = got = (got[0], self._version(t))
        if got is not None and got[1] == self._version(t):
            vid = got[0]
        else:
            vid = self._new_vid(from_concrete(t), None)
            self._bind(t, vid)
        self.read.add(vid)
        if self.frames:
            fr = self.frames[-1]
            if vid not in fr.local and vid not in fr.param_set and vid not in fr.ext_set:
                fr.ext.append(vid)
                fr.ext_set.add(vid)
                fr.ext_objs.append(t)
        return vid

    def _write(self, t, vid: int, node: Optional[_Node]) -> None:
        """`t` was written in place and now holds `vid`; every other tensor
        on its storage may hold what was written too."""
        i = id(t)
        prev = self._vid.get(i)
        fr = self.frames[-1] if self.frames else None
        if fr is not None and prev is not None and prev[0] not in fr.local and i not in fr.written:
            fr.written[i] = (t, prev[0])
        self._bind(t, vid, pending=node is not None)
        for j in self._storage.get(self._skey(t), ()):
            if j == i:
                continue
            other = self._obj[j]
            old = self._vid.get(j)
            if old is None:
                continue
            alias = _Node("<alias>", (_Ref(0), _Ref(1)), {}, [old[0], vid],
                          [_meta(other), _meta(t)], [_meta(other)],
                          self._path("<alias>"))
            new = self._new_vid(
                _convert(join(self.aval[old[0]], self.aval[vid]), kind_of(other.dtype)), alias
            )
            if fr is not None:
                fr.nodes.append(alias)
                if old[0] not in fr.local and j not in fr.written:
                    if old[0] not in fr.param_set and old[0] not in fr.ext_set:
                        fr.ext.append(old[0])
                        fr.ext_set.add(old[0])
                        fr.ext_objs.append(other)
                    fr.written[j] = (other, old[0])
            self._vid[j] = (new, None if node is not None else self._version(other))

    def _path(self, op: str) -> str:
        if self.frames:
            fr = self.frames[-1]
            return f"{fr.path}/op{len(fr.nodes)}:{op}"
        self._top_ops += 1
        return f"op{self._top_ops - 1}:{op}"

    # -- op evaluation ------------------------------------------------------

    def dispatch(self, func, args, kwargs):
        """The mode's handler: run the op, evaluate its rule, bind its
        outputs."""
        name = func.overloadpacket.__name__
        tensors: list = []
        sk_args = _skeleton(tuple(args), tensors)
        sk_kwargs = _skeleton(dict(kwargs), tensors)
        ins = [self.vid_of(t) for t in tensors]
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        import torch

        out_t = [o for o in outs if isinstance(o, torch.Tensor)]
        node = _Node(name, sk_args, sk_kwargs, ins, [_meta(t) for t in tensors],
                     [_meta(t) for t in out_t], self._path(name))
        if self.frames and _base(name) in _SYNC_OPS:
            self._untrust(name)
        out_avals = self.eval_node(node, [self.aval[v] for v in ins])
        written = {}
        for pos, aname in _written_args(func):
            tgt = args[pos] if pos < len(args) else kwargs.get(aname)
            if isinstance(tgt, torch.Tensor):
                written[id(tgt)] = tgt
        if self.frames:
            self.frames[-1].nodes.append(node)
        for t, a in zip(out_t, out_avals):
            vid = self._new_vid(a, node)
            if id(t) in written:
                self._write(t, vid, node)
            else:
                self._bind(t, vid)
        return out

    def eval_node(self, node: _Node, ins: List[AVal]) -> List[AVal]:
        if node.step is not None:
            rec = node.step.rec if isinstance(node.step, _OneShot) else node.step
            env = self.eval_step(node.step, ins)
            return [env[v] for v in rec.out_vids] + [env[p] for _t, _i, p in rec.implicit]
        if node.op == "<alias>":
            return [_convert(join(ins[0], ins[1]), kind_of(node.out_meta[0][1]))]
        if node.op.startswith("custom:"):
            return list(node.args)
        base = _base(node.op)
        sel = _SELECTION_OPS.get(base)
        if sel is not None:
            self._check_selection(node, sel, ins)
        if base == "where":
            outs = [self._eval_where(node, ins)]
        else:
            rule = _RULES.get(base)
            if rule is None:
                self.finding(
                    "unhandled-primitive", node.op, node.path,
                    f"no transfer rule for aten op '{node.op}'; result widened to TOP",
                )
                return [top(kind_of(m[1])) for m in node.out_meta]
            outs = rule(node, ins)
        return [
            a if a.kind == kind_of(m[1]) else _convert(a, kind_of(m[1]))
            for a, m in zip(outs, node.out_meta)
        ]

    def _check_selection(self, node: _Node, prim: str, ins: List[AVal]) -> None:
        if ins and ins[0].nan:
            self.finding(
                "selection-taint", prim, node.path,
                f"operand 0 of {node.op} may be NaN ({ins[0].describe()}): a "
                "poisoned lane can steal the selection",
            )

    # -- where with the eq/ne refinement ------------------------------------

    def _resolve(self, vid: int) -> int:
        while True:
            d = self.defs.get(vid)
            if d is None or _base(d.op) not in _SHAPE_OPS or not d.ins:
                return vid
            vid = d.ins[0]

    def _is_zero(self, atom) -> bool:
        if isinstance(atom, _Lit):
            return atom.value == 0
        a = self.aval.get(atom)
        d = self.defs.get(atom)
        return (
            a is not None and d is not None and _base(d.op) in _CONST_OPS
            and a.lo == 0 == a.hi and not (a.nan or inf_any(a))
        )

    def _eval_where(self, node: _Node, ins: List[AVal]) -> AVal:
        a = _arg(node, ins, 1)
        b = _arg(node, ins, 2)
        refined = self._refine_where(node)
        if refined == 1:
            a = dataclasses.replace(a, nonzero=True)
        elif refined == 2:
            b = dataclasses.replace(b, nonzero=True)
        return join(a, b)

    def _operand(self, node: _Node, i: int):
        a = node.args[i] if i < len(node.args) else None
        if isinstance(a, _Ref):
            v = node.ins[a.i]
            d = self.defs.get(self._resolve(v))
            if d is not None and _base(d.op) in _CONST_OPS and not d.ins:
                av = self.aval.get(v)
                if av is not None and av.lo == av.hi:
                    return _Lit(av.lo)
            return v
        return _Lit(a)

    def _refine_where(self, node: _Node) -> Optional[int]:
        """`where(d == 0, k, d)`: on the branch taken where the predicate is
        false, d != 0 (symmetrically `where(d != 0, d, k)`). Returns the
        argument position to mark nonzero."""
        pred = self._operand(node, 0)
        if isinstance(pred, _Lit):
            return None
        pdef = self.defs.get(self._resolve(pred))
        if pdef is None or _base(pdef.op) not in ("eq", "ne"):
            return None
        pos = 2 if _base(pdef.op) == "eq" else 1
        branch = self._operand(node, pos)
        if isinstance(branch, _Lit):
            return None
        branch = self._resolve(branch)
        lhs, rhs = self._operand(pdef, 0), self._operand(pdef, 1)
        for var, lit in ((lhs, rhs), (rhs, lhs)):
            if not isinstance(var, _Lit) and self._is_zero(lit) and self._resolve(var) == branch:
                return pos
        return None

    # -- scan steps ---------------------------------------------------------

    def _untrust(self, op: str) -> None:
        fr = self.frames[-1]
        if fr.untrusted is None:
            fr.untrusted = op
            self.finding(
                "scan-body-sync", op, f"scan[{fr.name}]",
                f"scan body {fr.name} issues '{op}' (a host read or a data-dependent "
                "shape): its steps are interpreted one by one, not trusted",
            )

    def step(self, name: str, carry_arg: int, fn, args: tuple, kwargs: dict):
        """The scan marker's handler (ops/scanmark.py)."""
        import torch

        if any(torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in _flat_tensors((args, kwargs))):
            return fn(*args, **kwargs)   # a step inside another step's vmap
        key = (name, id(fn), _signature((args, kwargs)))
        rec = self.records.get(key)
        params = [self.vid_of(t) for t in _flat_tensors((args, kwargs))]
        if rec is None or rec.untrusted:
            rec, out = self._record(name, key, fn, carry_arg, args, kwargs, params)
            if rec.untrusted:
                self.records.pop(key, None)
            else:
                self.records[key] = rec
        else:
            ins = [self.aval[v] for v in params] + [
                self.aval[self.vid_of(t)] for t in rec.ext_objs
            ]
            from torch.utils._python_dispatch import _disable_current_modes

            out_avals = self.eval_step(rec, ins)
            from ..ops import scanmark

            flat_in = _flat_tensors((args, kwargs))
            if rec.template is not None and all(t.device.type == "meta" for t in flat_in):
                # on `meta` a step computes nothing: its result is remade
                out = scanmark.remake(rec.template, flat_in)
            else:
                with _disable_current_modes(), scanmark.active(None):
                    out = fn(*args, **kwargs)
            in_vids = params + [self._vid[id(t)][0] for t in rec.ext_objs]
            node = _Node(f"<scan:{name}>", (), {}, in_vids, [], [], rec.path, step=rec)
            self._register_step(rec, node, out, out_avals)
        return out

    def _record(self, name, key, fn, carry_arg, args, kwargs, params):
        """Run the first step under the mode, recording its graph; then run
        the fixpoint and classify the carry."""
        rec = _ScanRecord(name, len(self._all_records), fn, key)
        self._all_records.append(rec)
        rec.params = list(params)
        rec.param_set = set(params)
        carry_ids = {id(t) for t in _flat_tensors(args[carry_arg])}
        flat_in = _flat_tensors((args, kwargs))
        rec.carry_params = [i for i, t in enumerate(flat_in) if id(t) in carry_ids]
        rec.carry_meta = [_meta(flat_in[i]) for i in rec.carry_params]
        self.frames.append(rec)
        try:
            out = fn(*args, **kwargs)
        finally:
            self.frames.pop()
        from ..ops import scanmark

        rec.template = scanmark.template(out, _flat_tensors((args, kwargs)))
        res_t = _flat_tensors(out)
        rec.out_vids = [self._vid[id(t)][0] if id(t) in self._vid else self.vid_of(t)
                        for t in res_t]
        new_carry = _flat_tensors(out[0]) if isinstance(out, tuple) and out else []
        rec.carry_outs = [self._vid[id(t)][0] for t in new_carry]
        for i, (t, pre) in rec.written.items():
            if i in carry_ids:
                continue
            pos = rec.inputs.index(pre) if pre in rec.inputs else None
            if pos is None:
                rec.ext.append(pre)
                rec.ext_set.add(pre)
                rec.ext_objs.append(t)
                pos = len(rec.inputs) - 1
            rec.implicit.append((t, pos, self._vid[i][0]))
        # the whole call as one node of the enclosing body
        in_vids = rec.inputs
        if self.frames:
            outer = self.frames[-1]
            for v, t in zip(rec.ext, rec.ext_objs):
                if v not in outer.local and v not in outer.param_set and v not in outer.ext_set:
                    outer.ext.append(v)
                    outer.ext_set.add(v)
                    outer.ext_objs.append(t)
        if not rec.untrusted:
            ins = [self.aval[v] for v in in_vids]
            self._fixpoint(rec, ins)
            self._classify(rec)
        node = _Node(f"<scan:{name}>", (), {}, list(in_vids), [], [], rec.path,
                     step=rec if not rec.untrusted else _OneShot(rec))
        # the recorded step's outputs keep the first step's values; the
        # enclosing body sees the step node defining them
        self._register_step(rec, node, out, None)
        return rec, out

    def _register_step(self, rec: _ScanRecord, node: _Node, out, out_avals) -> None:
        """Bind the step's result tensors (and the tensors it wrote) to
        vids defined by `node`."""
        res_t = _flat_tensors(out)
        if out_avals is None:
            vals = [self.aval[v] for v in rec.out_vids]
            impl = [self.aval[post] for _t, _pos, post in rec.implicit]
        else:
            vals = [out_avals[v] for v in rec.out_vids]
            impl = [out_avals[post] for _t, _pos, post in rec.implicit]
        if out_avals is None and not self.frames:
            # top level, first step: its tensors already hold vids
            rec.last_carry_vids = list(rec.carry_outs)
            return
        node.outs = []
        if self.frames:
            self.frames[-1].nodes.append(node)
        for t, a in zip(res_t, vals):
            self._bind(t, self._new_vid(a, node))
        for (t, _pos, _post), a in zip(rec.implicit, impl):
            self._write(t, self._new_vid(a, node), None)
        new_carry = _flat_tensors(out[0]) if isinstance(out, tuple) and out else []
        rec.last_carry_vids = [self._vid[id(t)][0] for t in new_carry]

    # -- the fixpoint -------------------------------------------------------

    def _run_graph(self, rec: _ScanRecord, ins: List[AVal]) -> Dict[int, AVal]:
        env: Dict[int, AVal] = dict(zip(rec.inputs, ins))
        for node in rec.nodes:
            vals = [env[v] if v in env else self.aval[v] for v in node.ins]
            outs = self.eval_node(node, vals)
            for v, a in zip(node.outs, outs):
                env[v] = a
        return env

    def _fixpoint(self, rec: _ScanRecord, ins: List[AVal]) -> Dict[int, AVal]:
        pairs = rec.pairs()
        cur = list(ins)
        for it in range(self.MAX_FIXPOINT_ITERS):
            env = self._run_graph(rec, cur)
            new = list(cur)
            changed = False
            for pos, out_v in pairs:
                j = join(cur[pos], env[out_v])
                if it >= self.WIDEN_AFTER:
                    j = widen(cur[pos], j)
                if j != cur[pos]:
                    changed = True
                new[pos] = j
            if not changed:
                break
            cur = new
        else:
            for pos, _ in pairs:
                c = cur[pos]
                cur[pos] = top(c.kind) if c.kind != "b" else _bool_out()
        env = self._run_graph(rec, cur)
        for pos, out_v in pairs:
            env[out_v] = join(cur[pos], env[out_v])
        rec.cover = cur
        rec.cover_out = env
        return env

    def eval_step(self, rec, ins: List[AVal]) -> Dict[int, AVal]:
        """Out AVals (by the record's vids) of one call of a recorded step
        with input AVals `ins`: the cached fixpoint when it covers them."""
        if isinstance(rec, _OneShot):
            return rec.eval(self, ins)
        if rec.cover is not None and all(leq(a, c) for a, c in zip(ins, rec.cover)):
            env = rec.cover_out
        else:
            start = ins if rec.cover is None else [join(a, c) for a, c in zip(ins, rec.cover)]
            env = self._fixpoint(rec, start)
        return env

    # -- custom kernels -----------------------------------------------------

    def custom_outputs(self, kernel: str, outs) -> None:
        for item in outs:
            t = item[0]
            if len(item) == 2:
                like = self.aval[self.vid_of(item[1])]
                a = _convert(join(like, const(0.0, like.kind)), kind_of(t.dtype))
            else:
                a = AVal(float(item[1]), float(item[2]), kind=kind_of(t.dtype))
            node = _Node(f"custom:{kernel}", (a,), {}, [], [], [_meta(t)],
                         self._path(f"custom:{kernel}"))
            if self.frames:
                self.frames[-1].nodes.append(node)
            vid = self._new_vid(a, node)
            self._write(t, vid, node)

    # -- commit-carry matcher -----------------------------------------------

    def _classify(self, rec: _ScanRecord) -> None:
        env = rec.cover_out
        for slot, (pos, out_v) in enumerate(zip(rec.carry_params, rec.carry_outs)):
            shape, dtype = rec.carry_meta[slot]
            if kind_of(dtype) != "f":
                continue
            cv = rec.inputs[pos]
            verdict, detail = _Matcher(self, rec, env).classify(cv, out_v)
            rec.reports.append((slot, f"{str(dtype).rsplit('.', 1)[-1]}{list(shape)}",
                                verdict, detail))

    def finish(self, outputs) -> None:
        """Settle the carry verdicts once the entry has returned: an
        unguarded slot whose final value nobody read is a virtual replay."""
        out_ids = set()
        for t in _flat_tensors(outputs):
            got = self._vid.get(id(t))
            if got is not None:
                out_ids.add(got[0])
        for rec in self._all_records:
            for slot_i, (slot, shape, verdict, detail) in enumerate(rec.reports):
                last = rec.last_carry_vids[slot] if slot < len(rec.last_carry_vids) else None
                dropped = last is not None and last not in self.read and last not in out_ids
                if verdict == CARRY_UNGUARDED and dropped:
                    verdict = CARRY_VIRTUAL
                    detail = ("unconditional decrement, but the final carry is "
                              "dropped — a virtual replay carry whose rows are "
                              "gated by recorded feasibility masks downstream")
                self.carry_proofs.append(CommitCarryReport(rec.path, slot, shape, verdict, detail))
                if verdict == CARRY_UNGUARDED:
                    self.finding(
                        "commit-carry-nonneg", "scan", f"{rec.path}/carry{slot}",
                        f"carry slot {slot} ({shape}): {detail}",
                    )

    # -- running an entry ---------------------------------------------------

    def run(self, fn, args: tuple, kwargs: dict, abstract: bool = False):
        """fn(*args, **kwargs) under the interpreter. With `abstract`, every
        tensor argument is replaced by a `meta` tensor of its shape holding
        its abstraction: the entry then computes no values, only the
        rules do (and a scan step's later results are remade from its
        first's shapes)."""
        from ..ops import scanmark
        from .entry_audit import tree_map

        interp = self

        class _Mode(_mode_base()):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return interp.dispatch(func, args, kwargs or {})

        if abstract:
            import torch

            seeded = []

            def to_meta(t):
                if not isinstance(t, torch.Tensor):
                    return t
                m = torch.empty_strided(tuple(t.shape), tuple(t.stride()), dtype=t.dtype,
                                        device="meta")
                seeded.append((m, from_concrete(t)))
                return m

            args = tree_map(to_meta, tuple(args))
            kwargs = tree_map(to_meta, dict(kwargs))
            for m, a in seeded:
                self._bind(m, self._new_vid(a, None))
        with scanmark.active(self), _Mode():
            for t in _flat_tensors((args, kwargs)):
                self.vid_of(t)
            out = fn(*args, **kwargs)
        return out

    def avals_of(self, outputs) -> List[AVal]:
        return [self.aval[self._vid[id(t)][0]] if id(t) in self._vid else from_concrete(t)
                for t in _flat_tensors(outputs)]


class _OneShot:
    """An untrusted step: its recorded graph stands for that one call."""

    def __init__(self, rec: _ScanRecord) -> None:
        self.rec = rec

    def eval(self, interp: Interpreter, ins: List[AVal]) -> Dict[int, AVal]:
        return interp._run_graph(self.rec, ins)


#: ops writing rows into their first operand -> the position of the values
_ROW_WRITES = {"index_put": 2, "_index_put_impl": 2, "_unsafe_index_put": 2,
               "index_copy": 3, "scatter": 3}


class _Matcher:
    """The guarded-decrement matcher over one recorded body (the
    reference's `_check_commit_carry` helpers over the op graph)."""

    def __init__(self, interp: Interpreter, rec: _ScanRecord, env: Dict[int, AVal]) -> None:
        self.interp, self.rec, self.env = interp, rec, env
        self.defs = rec.defs

    def operand(self, node: _Node, i: int):
        return self.interp._operand(node, i)

    def chase(self, atom):
        """Resolve an atom through value-preserving shape ops."""
        while not isinstance(atom, _Lit):
            q = self.defs.get(atom)
            if q is None or _base(q.op) not in _SHAPE_OPS or not q.ins:
                return atom
            atom = self.operand(q, 0)
        return atom

    def chase_row(self, atom):
        """chase, also through reads of parts of a value (select, index,
        gather): the row commit reads the chosen row of the slot."""
        while not isinstance(atom, _Lit):
            q = self.defs.get(atom)
            if q is None or not q.ins:
                return atom
            b = _base(q.op)
            if b not in _SHAPE_OPS and b not in _PART_OPS and b not in (
                    "index", "_unsafe_index", "index_select", "gather"):
                return atom
            atom = self.operand(q, 0)
        return atom

    def chase_eps(self, atom):
        """chase, also through add/sub with a literal operand: the filters
        compare against ``free + _EPS``."""
        while True:
            if isinstance(atom, _Lit):
                return atom
            q = self.defs.get(atom)
            if q is None:
                return atom
            b = _base(q.op)
            if b in _SHAPE_OPS and q.ins:
                atom = self.operand(q, 0)
                continue
            if b in ("add", "sub"):
                x, y = self.chase(self.operand(q, 0)), self.chase(self.operand(q, 1))
                if isinstance(y, _Lit):
                    atom = self.operand(q, 0)
                    continue
                if b == "add" and isinstance(x, _Lit):
                    atom = self.operand(q, 1)
                    continue
            return atom

    def mul_factors(self, atom) -> list:
        atom = self.chase(atom)
        q = self.defs.get(atom) if not isinstance(atom, _Lit) else None
        if q is not None and _base(q.op) == "mul":
            return self.mul_factors(self.operand(q, 0)) + self.mul_factors(self.operand(q, 1))
        return [atom]

    def guard_origin(self, factor):
        """If `factor` is a {0,1}-valued guard (a bool, or a bool cast to the
        carry dtype), the underlying bool vid; else None."""
        if isinstance(factor, _Lit):
            return None
        q = self.defs.get(factor)
        if q is not None and _base(q.op) in ("_to_copy", "to") and kind_of(q.in_meta[0][1]) == "b":
            g = self.chase(self.operand(q, 0))
            return None if isinstance(g, _Lit) else g
        a = self.env.get(factor)
        if a is not None and a.kind == "b":
            return factor
        return None

    def comparisons(self, roots: Sequence) -> List[_Node]:
        seen: set = set()
        nodes: Dict[int, _Node] = {}
        stack = [r for r in roots if not isinstance(r, _Lit)]
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            q = self.defs.get(v)
            if q is None:
                continue
            if id(q) not in nodes:
                nodes[id(q)] = q
                stack.extend(u for u in q.ins if u in self.defs)
        return [q for q in nodes.values() if _base(q.op) in _ORDER_COMPARISONS]

    def aval(self, atom) -> AVal:
        if isinstance(atom, _Lit):
            return from_concrete(atom.value)
        got = self.env.get(atom)
        return got if got is not None else self.interp.aval.get(atom, top("f"))

    def classify(self, cv: int, out_v: int) -> Tuple[str, str]:
        out_atom = self.chase(out_v)
        if out_atom == cv:
            return CARRY_UNCHANGED, "carry slot is threaded through unchanged"
        q = self.defs.get(out_atom) if not isinstance(out_atom, _Lit) else None
        if q is None:
            return (CARRY_UNRECOGNIZED,
                    "carry output rebinds a different input; not the commit idiom")
        return self.update(cv, q, [])

    def update(self, cv: int, q: _Node, extra_guards: list) -> Tuple[str, str]:
        b = _base(q.op)
        if b in _ROW_WRITES and self.chase(self.operand(q, 0)) == cv:
            # the chosen row written back into the slot: judge the row
            vals = self.operand(q, _ROW_WRITES[b])
            d = self.defs.get(self.chase(vals)) if not isinstance(vals, _Lit) else None
            if d is not None:
                return self.update(cv, d, extra_guards)
            return (CARRY_UNRECOGNIZED, f"update '{q.op}' writes values the matcher cannot see")
        if b == "where":
            # where(g, new, plane): the one-hot row write-back of the row
            # commit, or a masked update
            g, x, y = self.operand(q, 0), self.operand(q, 1), self.operand(q, 2)
            for upd, other in ((x, y), (y, x)):
                if self.chase(other) == cv and not isinstance(upd, _Lit):
                    d = self.defs.get(self.chase(upd))
                    if d is None:
                        break
                    return self.update(cv, d, extra_guards + [g])
            return (CARRY_UNRECOGNIZED,
                    "update is where() but neither branch is the carry slot")
        if b == "add":
            sides = [self.chase_row(self.operand(q, i)) for i in (0, 1)]
            if cv not in sides:
                return (CARRY_UNRECOGNIZED,
                        "update is add() but neither operand is the carry slot")
            inc = self.operand(q, 1 - sides.index(cv))
            av = self.aval(inc)
            if av.lo >= 0 and not av.neg_inf and not av.nan:
                return (CARRY_NON_DECREASING,
                        f"update adds a provably non-negative increment ({av.describe()})")
            return (CARRY_UNRECOGNIZED,
                    f"update adds an increment the domain cannot bound below 0 "
                    f"({av.describe()})")
        if b != "sub":
            return (CARRY_UNRECOGNIZED,
                    f"update op '{q.op}' is outside the guarded-decrement idiom")
        if self.chase_row(self.operand(q, 0)) != cv:
            return (CARRY_UNRECOGNIZED, "sub() minuend is not the carry slot itself")
        dec = self.operand(q, 1)
        factors = self.mul_factors(dec)
        if len(factors) == 1 and not isinstance(factors[0], _Lit):
            d = self.defs.get(factors[0])
            if d is not None and _base(d.op) == "where":
                # where(guard, amount, 0) as the decrement
                g, amt, zero = self.operand(d, 0), self.operand(d, 1), self.operand(d, 2)
                if self.interp._is_zero(zero) or (isinstance(zero, _Lit) and zero.value == 0):
                    factors = [("guard", g)] + self.mul_factors(amt)
        guards, amounts = [], []
        for f in factors:
            if isinstance(f, tuple):
                guards.append(f[1])
                continue
            gorig = self.guard_origin(f)
            (guards if gorig is not None else amounts).append(gorig if gorig is not None else f)
        guards += [g for g in extra_guards if not isinstance(g, _Lit)]
        if not guards:
            av = self.aval(dec)
            if av.hi <= 0 and not av.pos_inf and not av.nan:
                return (CARRY_NON_DECREASING,
                        f"unconditional sub of a non-positive amount ({av.describe()})")
            return (CARRY_UNGUARDED,
                    "decrement has no {0,1} bool-derived guard factor; the "
                    "slot can go negative whenever the amount exceeds it")
        amounts = [self.chase(a) for a in amounts]
        tied_to_slot = tied_to_amount = False
        for comp in self.comparisons(guards):
            sides = [self.chase_eps(self.operand(comp, i)) for i in (0, 1)]
            for i in (0, 1):
                if sides[i] == cv:
                    tied_to_slot = True
                    other = self.chase(sides[1 - i])
                    if any(other == a for a in amounts if not isinstance(a, _Lit)):
                        tied_to_amount = True
        if tied_to_slot and tied_to_amount:
            return (CARRY_PROVED,
                    "guard ⇒ decrement amount ≤ slot + ε (feasibility "
                    "comparison on this slot vs the amount is in the "
                    "guard's slice): slot ≥ -ε by induction")
        if tied_to_slot:
            return (CARRY_GUARDED,
                    "bool guard's slice compares this slot against a bound, "
                    "but the decrement amount is not syntactically the "
                    "compared quantity; residual discharged by simon prove")
        return (CARRY_GUARDED,
                "decrement is {0,1}-guarded but no comparison on this slot "
                "was found in the guard's slice; non-negativity rests on "
                "the small-scope exhaustive check (simon prove)")


# ---------------------------------------------------------------------------
# Entry-tier audit: every registry entry on its captured call
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EntryInvariantReport:
    entry: str
    bool_outputs: int
    float_outputs: int
    outputs: List[str]
    findings: List[InvariantFinding]
    commit_carry: List[CommitCarryReport] = dataclasses.field(
        default_factory=list
    )

    @property
    def ok(self) -> bool:
        return not self.findings

    def carry_verdict_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for p in self.commit_carry:
            out[p.verdict] = out.get(p.verdict, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "entry": self.entry,
            "ok": self.ok,
            "bool_outputs": self.bool_outputs,
            "float_outputs": self.float_outputs,
            "outputs": self.outputs,
            "commit_carry": [p.to_dict() for p in sorted(self.commit_carry)],
            "findings": [f.to_dict() for f in self.findings],
        }


def check_traceable(entry: str, fn, args, kwargs=None, abstract: bool = False
                    ) -> EntryInvariantReport:
    """Abstractly interpret one call of `fn` on concrete tensor arguments
    (the reference's name: `fn` is any Python callable over torch tensors).
    Numpy arguments are passed as they are. `abstract` runs the call on
    `meta` tensors seeded with the arguments' abstractions
    (Interpreter.run)."""
    kwargs = kwargs or {}
    interp = Interpreter(entry)
    out = interp.run(fn, tuple(args), dict(kwargs), abstract=abstract)
    interp.finish(out)
    bool_outputs = 0
    float_outputs = 0
    rendered = []
    for i, a in enumerate(interp.avals_of(out)):
        rendered.append(a.describe())
        if a.kind == "b":
            bool_outputs += 1
            continue
        if a.kind == "f":
            float_outputs += 1
            if a.nan:
                interp.finding(
                    "nan-output", "output", f"out{i}",
                    f"float output {i} may be NaN ({a.describe()})",
                )
    return EntryInvariantReport(
        entry, bool_outputs, float_outputs, rendered, interp.findings,
        list(interp.carry_proofs),
    )


# ---------------------------------------------------------------------------
# Plugin-tier audit: each score kernel proves [0, 100]
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PluginInvariantReport:
    plugin: str
    lo: float
    hi: float
    flags: List[str]
    findings: List[InvariantFinding]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "plugin": self.plugin,
            "ok": self.ok,
            "range": [self.lo, self.hi],
            "flags": self.flags,
            "findings": [f.to_dict() for f in self.findings],
        }


def check_score_plugin(name: str, fn, args) -> PluginInvariantReport:
    """Prove a score kernel's output is NaN-free, inf-free and in [0,100]."""
    interp = Interpreter(f"plugin:{name}")
    out = interp.run(fn, tuple(args), {})
    interp.finish(out)
    a = interp.avals_of(out)[0]
    findings = list(interp.findings)
    problems = []
    if a.nan:
        problems.append("may be NaN")
    if inf_any(a):
        problems.append("may be infinite")
    if a.lo < 0.0 or a.hi > 100.0:
        problems.append(f"range [{a.lo:g}, {a.hi:g}] escapes [0, 100]")
    if problems:
        findings.append(
            InvariantFinding(
                f"plugin:{name}", "score-range", "output", "out0",
                f"score {'; '.join(problems)} ({a.describe()})",
            )
        )
    return PluginInvariantReport(name, a.lo, a.hi, a.flags(), sorted(set(findings)))


def _plugin_specs():
    from ..ops import kernels as k

    return {
        "balanced_allocation": lambda ns, carry, pod: k.score_balanced(ns, carry, pod),
        "least_allocated": lambda ns, carry, pod: k.score_least_allocated(ns, carry, pod),
        "node_affinity": lambda ns, carry, pod: k.score_node_affinity(ns, pod),
        "taint_toleration": lambda ns, carry, pod: k.score_taint_toleration(ns, pod),
        "topology_spread": lambda ns, carry, pod: k.score_topology_spread(ns, carry, pod),
        "inter_pod_affinity": lambda ns, carry, pod: k.score_inter_pod_affinity(ns, carry, pod),
        "prefer_avoid_pods": lambda ns, carry, pod: k.score_prefer_avoid(ns, pod),
        "simon": lambda ns, carry, pod: k.score_simon(ns, pod),
        "gpu_share": lambda ns, carry, pod: k.score_gpu_share(ns, carry, pod),
        "open_local": lambda ns, carry, pod: k.score_open_local(ns, carry, pod),
    }


# ---------------------------------------------------------------------------
# Top-level driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InvariantAudit:
    entries: List[EntryInvariantReport]
    plugins: List[PluginInvariantReport]

    @property
    def ok(self) -> bool:
        return all(e.ok for e in self.entries) and all(
            p.ok for p in self.plugins
        )

    @property
    def findings(self) -> List[InvariantFinding]:
        out: List[InvariantFinding] = []
        for e in self.entries:
            out.extend(e.findings)
        for p in self.plugins:
            out.extend(p.findings)
        return sorted(out)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "entries": [e.to_dict() for e in sorted(
                self.entries, key=lambda e: e.entry
            )],
            "plugins": [p.to_dict() for p in sorted(
                self.plugins, key=lambda p: p.plugin
            )],
        }

    def render_text(self) -> str:
        lines = [
            f"invariants: {'ok' if self.ok else 'FAILED'} — "
            f"{len(self.entries)} entries, {len(self.plugins)} score "
            f"plugins, {len(self.findings)} finding(s)"
        ]
        for e in sorted(self.entries, key=lambda e: e.entry):
            mark = "ok " if e.ok else "FAIL"
            lines.append(
                f"  [{mark}] {e.entry}: {e.bool_outputs} mask output(s) "
                f"proved {{0,1}}, {e.float_outputs} float output(s) NaN-free"
                if e.ok
                else f"  [{mark}] {e.entry}"
            )
            if e.commit_carry:
                counts = e.carry_verdict_counts()
                summary = ", ".join(
                    f"{counts[v]} {v}" for v in (
                        CARRY_PROVED, CARRY_GUARDED, CARRY_NON_DECREASING,
                        CARRY_UNCHANGED, CARRY_VIRTUAL, CARRY_UNRECOGNIZED,
                        CARRY_UNGUARDED,
                    ) if v in counts
                )
                lines.append(
                    f"        commit-carry: {len(e.commit_carry)} float "
                    f"slot(s) — {summary}"
                )
            for f in e.findings:
                lines.append(f"        {f.kind} @ {f.path}: {f.message}")
        for p in sorted(self.plugins, key=lambda p: p.plugin):
            mark = "ok " if p.ok else "FAIL"
            lines.append(
                f"  [{mark}] plugin {p.plugin}: score in "
                f"[{p.lo:g}, {p.hi:g}]"
            )
            for f in p.findings:
                lines.append(f"        {f.kind} @ {f.path}: {f.message}")
        return "\n".join(lines)


def run_invariants(device=None, captures: Optional[Sequence] = None) -> InvariantAudit:
    """Interpret every REQUIRED_COVERAGE entry once on the registry
    capture's arguments (analysis/entry_audit.py, canonical state) and the
    10 score plugins on `probe_step`'s captured (ns, carry, pod), on
    `device` (default: the card). Deterministic given the canonical state.
    `captures` skips the capture pass (tests share one)."""
    from ..device import DEFAULT_DEVICE, resolve_device
    from ..utils.profiling import _fresh_args
    from . import entry_audit

    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    if captures is None:
        captures = entry_audit._capture_calls(dev)
    seen: Dict[str, Any] = {}
    for cap in captures:
        seen.setdefault(cap.name, cap)
    from .preflight import ON_DEVICE

    entries = []
    for name, cap in sorted(seen.items()):
        if name not in entry_audit.REQUIRED_COVERAGE:
            continue
        # on `meta`, seeded with the captured arguments' abstractions; an
        # entry that reads values or launches the hand kernel runs for real
        entries.append(check_traceable(name, cap.fn, _fresh_args(cap), cap.kwargs,
                                       abstract=name not in ON_DEVICE))
    plugins: List[PluginInvariantReport] = []
    probe = seen.get("ops.kernels:probe_step")
    if probe is not None:
        ns, carry, pod = probe.args[0], probe.args[1], probe.args[2]
        for pname, pfn in sorted(_plugin_specs().items()):
            plugins.append(check_score_plugin(pname, pfn, (ns, carry, pod)))
    return InvariantAudit(entries, plugins)
