"""Runtime sanitizer mode for the registry entries (OSIM_SANITIZE=1).

The port of the JAX package's ops/sanitize.py. `@sanitizable(name)` wraps
each of the 23 entries of the registry (analysis/entry_audit.py). With the
variable unset the wrapper is one environment lookup and a call. With
`OSIM_SANITIZE=1` the entry runs under a `TorchDispatchMode` that checks
every aten op it issues, the counterpart of checkify's `nan_checks |
index_checks | div_checks`:

  * NaN: an arithmetic op (the aten counterparts of checkify's
    `nan_primitives`: add, mul, div, sum, exp, log, matmul...) produced a
    floating output holding a NaN. Copies, selects and comparisons are not
    checked, as in the reference, so NaN data that only moves (a label value
    with no numeric reading) passes; infinities pass too.
  * index: an index outside its dimension, checked BEFORE the op runs (an
    out-of-range index on a card is a device-side assert that poisons the
    context). Only what the op itself would reject is flagged: `index`,
    `index_put_`, `index_fill` and `take` wrap a negative index, so for them
    [-size, size) is in range; `index_select`, `gather`, `scatter*`,
    `index_add` and `index_copy` take [0, size).
  * div: an integer division, floor division or remainder by zero, also
    checked before the op.

The first failure increments `osim_sanitizer_violations_total{entry=}` and
raises SanitizerViolation. The checks sync the device once per checked op:
a sanitized run is slower, never different.

A sanitized entry called inside another one runs unchecked under the outer
entry's mode (a thread-local flag; the reference's `_has_tracer`). A call
for which `skip` says True (domain_select when it launches the domain_pop
CUDA kernel, the reference's `skip_kwargs=("use_pallas",)`; light_scan when
it launches its own) runs as it would unsanitized: the hand kernel is never
swapped for its plain version.

`donate_argnums` lists the positional arguments the entry writes in place
(`__osim_donate_argnums__`): the profiler and the warmup copy them afresh
for every call (utils/profiling._fresh_args).

`call_hook()` installs a function called as hook(name, args, kwargs) before
every entry call, whatever name the caller imported the entry under: the
recompile guard (analysis/op_audit.py) records each call's signature
through it. With no hook installed the wrapper checks one empty tuple.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import threading
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils import metrics

SANITIZE_ENV = "OSIM_SANITIZE"

# aten ops (overload packets, a trailing in-place "_" dropped) whose floating
# outputs are checked for NaN: checkify's nan_primitives over aten
_NAN_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "true_divide", "reciprocal", "pow", "square",
    "sqrt", "rsqrt", "exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "sigmoid", "erf", "erfc", "erfinv", "lgamma", "digamma",
    "sum", "nansum", "prod", "mean", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "remainder", "fmod", "mm", "bmm", "mv", "dot", "addmm", "addmv",
    "baddbmm", "addcmul", "addcdiv", "lerp", "constant_pad_nd", "convolution",
    "_softmax", "_log_softmax", "logsumexp",
})
# index ops whose index may be negative (wraps, as numpy indexing does)
_WRAP_INDEX_OPS = frozenset({"index", "index_put", "_index_put_impl", "index_fill", "take"})
# index ops (self, dim, index, ...) that take [0, size) only
_DIM_INDEX_OPS = frozenset({
    "index_select", "gather", "scatter", "scatter_add", "scatter_reduce", "index_add",
    "index_copy", "index_reduce",
})
_DIV_OPS = frozenset({"div", "floor_divide", "remainder", "fmod"})

_state = threading.local()
#: functions called before every entry call (`call_hook`)
_hooks: tuple = ()
_hooks_lock = threading.Lock()


class SanitizerViolation(RuntimeError):
    """A NaN, out-of-range index or integer division by zero inside a
    sanitized entry."""

    def __init__(self, entry: str, message: str) -> None:
        super().__init__(f"{entry}: {message}")
        self.entry = entry
        self.check_message = message


def sanitize_enabled() -> bool:
    """True when OSIM_SANITIZE is set to anything but ''/'0'/'false'/'no'.
    Read per call."""
    # the switch only adds checks: a sanitized run is slower, never different
    return os.environ.get(SANITIZE_ENV, "").strip().lower() not in ("", "0", "false", "no")  # osim: lint-ok[impure-read]


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, (int, bool))


def _first_out_of_range(idx: torch.Tensor, lo: int, hi: int) -> Optional[int]:
    """The first index of `idx` outside [lo, hi), or None."""
    if idx.numel() == 0:
        return None
    # widened so a negative or huge index compares exactly against the bounds
    flat = idx.reshape(-1).to(torch.int64)  # osim: lint-ok[f64-literal]
    bad = (flat < lo) | (flat >= hi)
    if not bool(bad.any()):
        return None
    return int(flat[bad][0])


class _Checks(TorchDispatchMode):
    """The checks of one sanitized call; `failure` holds the first message."""

    def __init__(self, entry: str) -> None:
        super().__init__()
        self.entry = entry
        self.failure: Optional[str] = None

    def _fail(self, msg: str) -> None:
        self.failure = msg
        raise SanitizerViolation(self.entry, msg)

    def _check_index(self, op: str, args) -> None:
        if op in _WRAP_INDEX_OPS:
            self_t = args[0]
            if op == "take":
                n = self_t.numel()
                bad = _first_out_of_range(args[1], -n, n)
                if bad is not None:
                    self._fail(f"out-of-bounds index {bad} in take over {n} elements")
                return
            if op == "index_fill":
                dim = args[1] % max(self_t.dim(), 1)
                size = self_t.shape[dim] if self_t.dim() else 1
                bad = _first_out_of_range(args[2], -size, size)
                if bad is not None:
                    self._fail(f"out-of-bounds index {bad} in index_fill on axis {dim} "
                               f"of size {size}")
                return
            d = 0
            for idx in args[1]:
                if idx is None:
                    d += 1
                    continue
                if idx.dtype in (torch.bool, torch.uint8):
                    d += idx.dim()
                    continue
                size = self_t.shape[d]
                bad = _first_out_of_range(idx, -size, size)
                if bad is not None:
                    self._fail(f"out-of-bounds index {bad} in {op} on axis {d} of size {size}")
                d += 1
            return
        self_t, dim, idx = args[0], args[1], args[2]
        dim = dim % max(self_t.dim(), 1)
        size = self_t.shape[dim] if self_t.dim() else 1
        bad = _first_out_of_range(idx, 0, size)
        if bad is not None:
            self._fail(f"out-of-bounds index {bad} in {op} on axis {dim} of size {size}")

    def _check_div(self, op: str, args, kwargs) -> None:
        if len(args) < 2 or not (_is_int(args[0]) and _is_int(args[1])):
            return
        if op == "div" and kwargs.get("rounding_mode", args[2] if len(args) > 2 else None) is None:
            return      # true division of integers gives floats
        d = args[1]
        zero = bool((d == 0).any()) if isinstance(d, torch.Tensor) else d == 0
        if zero:
            self._fail(f"division by zero in integer {op}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _op_name(func)
        if op in _WRAP_INDEX_OPS or op in _DIM_INDEX_OPS:
            self._check_index(op, args)
        elif op in _DIV_OPS:
            self._check_div(op, args, kwargs)
        out = func(*args, **kwargs)
        if op in _NAN_OPS:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(
                    torch.isnan(t).any()
                ):
                    self._fail(f"nan generated by primitive: {op}")
        return out


def sanitizable(
    name: str,
    skip: Optional[Callable[[dict], bool]] = None,
    donate_argnums: Sequence[int] = (),
) -> Callable:
    """Wrap a registry entry with the opt-in sanitizer.

    `name` keys osim_sanitizer_violations_total{entry=} and matches the
    registry's naming ("ops.fast:light_scan"). `skip`, given the call's
    bound arguments by parameter name (defaults applied), returns True for
    a call that must run unsanitized (the hand-kernel route).
    `donate_argnums` lists the positional arguments the entry writes in
    place."""
    donated = tuple(donate_argnums)

    def deco(fn: Callable) -> Callable:
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            for hook in _hooks:
                hook(name, args, kwargs)
            if not sanitize_enabled() or getattr(_state, "active", False):
                return fn(*args, **kwargs)
            if skip is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                if skip(bound.arguments):
                    return fn(*args, **kwargs)
            checks = _Checks(name)
            _state.active = True
            try:
                with checks:
                    out = fn(*args, **kwargs)
            finally:
                _state.active = False
                if checks.failure is not None:
                    metrics.SANITIZER_VIOLATIONS.inc(entry=name)
            if checks.failure is not None:  # raised inside, and caught there
                raise SanitizerViolation(name, checks.failure)
            return out

        wrapper.__osim_sanitizable__ = name  # type: ignore[attr-defined]
        wrapper.__osim_donate_argnums__ = donated  # type: ignore[attr-defined]
        return wrapper

    return deco


@contextlib.contextmanager
def call_hook(hook: Callable[[str, tuple, dict], None]):
    """Call `hook(name, args, kwargs)` before every entry call inside the
    block (module docstring)."""
    global _hooks
    with _hooks_lock:
        _hooks = _hooks + (hook,)
    try:
        yield hook
    finally:
        with _hooks_lock:
            _hooks = tuple(h for h in _hooks if h is not hook)


def sanitized_entries(*modules) -> dict:
    """name -> wrapper for every @sanitizable attribute of `modules`."""
    out = {}
    for mod in modules:
        for attr in dir(mod):
            tag = getattr(getattr(mod, attr), "__osim_sanitizable__", None)
            if tag is not None:
                out[tag] = getattr(mod, attr)
    return out
