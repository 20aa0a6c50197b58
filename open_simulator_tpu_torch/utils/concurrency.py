"""Concurrency annotations shared by runtime code and `simon audit`.

`@guarded_by("lockname")` documents that every call of the decorated
function happens with the named module-level lock (or semaphore) already
held by the caller — the guard exists but is non-local, so the race
detector (analysis/races.py) cannot see it from the function body alone.
The decorator is a no-op at runtime beyond recording the lock name on the
function object; the audit pass trusts the annotation and treats the
function body as dominated by `with <lockname>`.

Keep this module dependency-free: runtime modules (server, resilience)
import it, and they must never import analysis/.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

#: Attribute the annotation stores the lock name under; analysis/races.py
#: reads the decorator syntactically, so the attribute only matters for
#: runtime introspection and tests.
GUARDED_BY_ATTR = "__osim_guarded_by__"


def guarded_by(lockname: str) -> Callable[[F], F]:
    """Assert that callers hold the module-level lock `lockname`.

    The name is the lock's module-level binding (e.g. ``"_busy"``), not an
    object reference — the audit pass matches it against the `with` /
    `acquire()` discipline it reconstructs from the AST.
    """
    if not lockname or not isinstance(lockname, str):
        raise ValueError("guarded_by() needs a non-empty lock name")

    def deco(fn: F) -> F:
        setattr(fn, GUARDED_BY_ATTR, lockname)
        return fn

    return deco
