"""The scan-body marker: where a device loop calls its step.

The port's scans are Python loops over a step function (the per-pod commit
scan, the scenario and universe scans, the light and micro scans, the
affinity pop, the grouped step, the trajectory replay, the extender wave's
commit loop, the storage slot loops). Each loop calls its step through
`step(name, carry_arg, fn, *args, **kwargs)`, where `fn(*args, **kwargs)`
returns `(new_carry, out)` and `args[carry_arg]` is the carry that goes in
(a tensor or a NamedTuple of tensors; `new_carry` has its structure).

With no analysis active the marker is one thread-local lookup and the call.
An analysis installs a handler on its thread (`active(handler)`) and then
sees every step: the invariant prover (analysis/invariants.py) records the
body's op graph once, runs its join/widen fixpoint over the recorded graph
and lets the remaining steps run unobserved; the preflight's live-bytes
tracker (analysis/preflight.py) reads each step's memory growth.

`custom_outputs(kernel, outs)` is the same kind of hook for a hand kernel
the dispatcher cannot see: its wrapper states the value range of what the
launch wrote, and an active handler takes that as the outputs' contract.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Sequence, Tuple

_tls = threading.local()


def step(name: str, carry_arg: int, fn: Callable, *args: Any, **kwargs: Any):
    """fn(*args, **kwargs) -> (new_carry, out), seen by the active handler."""
    handler = getattr(_tls, "handler", None)
    if handler is None:
        return fn(*args, **kwargs)
    return handler.step(name, carry_arg, fn, args, kwargs)


def custom_outputs(kernel: str, outs: Sequence[Tuple[Any, float, float]]) -> None:
    """A hand kernel's outputs and their contracts: (tensor, lo, hi) each,
    every element of the tensor in [lo, hi]."""
    handler = getattr(_tls, "handler", None)
    if handler is not None:
        handler.custom_outputs(kernel, outs)


def current():
    """The handler active on this thread, or None."""
    return getattr(_tls, "handler", None)


@contextlib.contextmanager
def active(handler):
    """Install `handler` (its `step` and `custom_outputs` methods) on this
    thread for the block."""
    prev = getattr(_tls, "handler", None)
    _tls.handler = handler
    try:
        yield handler
    finally:
        _tls.handler = prev


# ---------------------------------------------------------------------------
# remaking a step's outputs (for an analysis that runs on `meta` tensors)
# ---------------------------------------------------------------------------

_HOLE = object()


def _walk(tree, fn):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    return fn(tree)


def template(out, flat_in: Sequence[Any]):
    """How to remake a step's result `out` from its flat input tensors:
    per tensor leaf, the input it is (by position), or the size, stride and
    dtype of a new storage it fills whole; None when a leaf is a view into
    anything else. On `meta`, where a step computes no values, a shape-static
    step's later results are `remake(template, inputs)`."""
    import torch

    by_id = {id(t): i for i, t in enumerate(flat_in)}
    leaves = []

    def hole(x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) in by_id:
            leaves.append(("in", by_id[id(x)]))
        else:
            span = (1 + sum((d - 1) * st for d, st in zip(x.shape, x.stride()))) if x.numel() else 0
            if x.storage_offset() != 0 or x.untyped_storage().nbytes() != span * x.element_size():
                leaves.append(None)
            else:
                leaves.append(("new", (tuple(x.shape), tuple(x.stride()), x.dtype)))
        return _HOLE

    tree = _walk(out, hole)
    if any(leaf is None for leaf in leaves):
        return None
    return tree, leaves


def remake(tmpl, flat_in: Sequence[Any]):
    """A step's result from its `template` and this call's flat inputs: new
    storages are empty `meta` tensors."""
    import torch

    tree, leaves = tmpl
    made = iter([
        flat_in[a] if kind == "in"
        else torch.empty_strided(a[0], a[1], dtype=a[2], device="meta")
        for kind, a in leaves
    ])
    return _walk(tree, lambda x: next(made) if x is _HOLE else x)
