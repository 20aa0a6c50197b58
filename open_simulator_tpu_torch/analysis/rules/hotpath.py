"""Hot-path concurrency rule: lock identity must outlive the race.

A ``threading.Lock()`` constructed *inside* a function that runs on a
request-handler or scheduler thread is almost always a bug: each call
builds a fresh lock object, so two threads "synchronizing" through it
each lock their own private lock and exclude nobody (the interleave
checker can only catch this when a scenario happens to cover the call
site; this rule catches it at the AST). Correct lock identity is
module-lifetime (``_lock = threading.Lock()`` at module scope) or
instance-lifetime (``self._lock = threading.Lock()`` — the construction
races nothing because the instance is not yet published).

The hot set is the strict thread-reachability closure the race detector
computes (handler methods, ``Thread``/``Timer`` targets, executor tasks,
signal handlers, watchdog-guarded callables, subprocess wrappers, and
everything they call) — ``module_hosts=False``, so main-thread code that
merely shares a module with a root is not in scope.

Escape: the standard ``osim: lint-ok[lock-in-hot-path]`` comment on the
flagged line, for deliberately-scoped locks (e.g. a closure-lifetime
lock built once at decoration time).
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ..lint import Finding, LintContext, ModuleInfo, rule

_LOCK_CTORS = {"Lock", "RLock"}


def _is_lock_call(n: ast.AST, mod: ModuleInfo,
                  threading_alias: Set[str]) -> bool:
    if not isinstance(n, ast.Call):
        return False
    f = n.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr in _LOCK_CTORS
        and isinstance(f.value, ast.Name)
        and f.value.id in threading_alias
    ):
        return True
    if isinstance(f, ast.Name):
        imp = mod.imports.get(f.id)
        return (
            imp is not None
            and imp[0] == "threading"
            and imp[1] in _LOCK_CTORS
        )
    return False


@rule(
    "lock-in-hot-path",
    "threading.Lock()/RLock() constructed inside handler- or scheduler-"
    "reachable code builds a fresh lock per call and synchronizes nothing; "
    "lock identity must be module- or instance-lifetime",
)
def lock_in_hot_path(ctx: LintContext) -> Iterator[Finding]:
    from .. import races

    roots = races.thread_roots(ctx)
    hot = races.audited_functions(ctx, roots, module_hosts=False)
    for (mod_name, qual), reason in sorted(hot.items()):
        mod = ctx.modules.get(mod_name)
        if mod is None:
            continue
        info = next(
            (i for i in mod.functions.values() if i.qualname == qual), None
        )
        if info is None:
            continue
        alias = mod.alias_for("threading")
        # instance-lifetime publishes are fine: every Lock() whose Assign
        # binds only attribute targets (self._lock = Lock(), including
        # Condition(Lock()) wrappers) constructs before the instance is
        # shared
        exempt: Set[int] = set()
        for n in races._own_body(info):
            if isinstance(n, ast.Assign) and all(
                isinstance(t, ast.Attribute) for t in n.targets
            ):
                exempt.update(
                    id(c)
                    for c in ast.walk(n.value)
                    if _is_lock_call(c, mod, alias)
                )
        for n in races._own_body(info):
            if not _is_lock_call(n, mod, alias) or id(n) in exempt:
                continue
            yield Finding(
                rule="lock-in-hot-path",
                path=mod.path,
                line=n.lineno,
                col=n.col_offset,
                message=(
                    f"lock constructed inside {qual} (audited via "
                    f"{reason}); a per-call lock excludes nobody — hoist "
                    f"it to module scope or publish it on the instance"
                ),
            )
