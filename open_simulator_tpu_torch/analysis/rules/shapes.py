"""Shape-discipline rule: an entry's shape arguments must come from the
bucket family.

Eager PyTorch recompiles nothing, but the contract is the reference's bits,
and the reference pads every dynamic size through `ops/encode.py`'s
`round_up` / `node_bucket` and the `_bucket*` / `scenario_bucket` helpers:
a padded scan or table breaks its ties, chunks its groups and reports its
routes at the padded size. A call site that feeds a raw `len(...)` or
request count straight into an entry's shape-determining argument pads
differently from the reference, so its results stop being the
reference's. The helpers keep the names the port already has.

An entry's shape-determining parameters are its parameters whose names look
like sizes (`SHAPE_PARAM_RE`): the port has no `static_argnames`, and these
are the names the reference declares static (`group_size`, `j_steps`,
`out_size`, `l_cap`).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, Optional, Set, Tuple

from ..lint import Finding, FunctionInfo, LintContext, ModuleInfo, rule

#: parameter names that determine tensor shapes
SHAPE_PARAM_RE = re.compile(r"(size|steps|cap|chunk|pad|bucket)", re.IGNORECASE)
#: the blessed quantisation helpers
BUCKET_HELPERS = {
    "round_up", "node_bucket", "scenario_bucket", "_bucket", "_bucket_j", "_bucket_light",
}


def _params(node: ast.AST) -> Tuple[str, ...]:
    args = node.args  # type: ignore[attr-defined]
    return tuple(a.arg for a in args.posonlyargs + args.args + args.kwonlyargs)


def _positional_params(node: ast.AST) -> Tuple[str, ...]:
    args = node.args  # type: ignore[attr-defined]
    return tuple(a.arg for a in args.posonlyargs + args.args)


def _shape_entries(ctx: LintContext) -> Dict[Tuple[str, str], Set[str]]:
    """(module, qualname) -> shape-determining param names to check.

    Seeds: entries whose parameters look shape-like. Then a fixpoint adds
    thin wrappers: if ``wrapper(.., n, ..)`` forwards its own parameter
    verbatim into an entry's shape param, the wrapper's parameter becomes
    checked at *its* call sites."""
    entries: Dict[Tuple[str, str], Set[str]] = {}
    for mod in ctx.modules.values():
        for info in mod.functions.values():
            if info.is_jit_root:
                shaped = {n for n in _params(info.node) if SHAPE_PARAM_RE.search(n)}
                if shaped:
                    entries.setdefault((mod.name, info.qualname), set()).update(shaped)
    changed = True
    while changed:
        changed = False
        for mod in ctx.modules.values():
            for info in mod.functions.values():
                own = set(_params(info.node))
                for call, _scope in _calls_in(info.node):
                    target = _resolve_entry(ctx, mod, call, entries)
                    if target is None:
                        continue
                    tkey, tinfo, shaped = target
                    for pname, expr in _bind_args(tinfo, call):
                        if (
                            pname in shaped
                            and isinstance(expr, ast.Name)
                            and expr.id in own
                        ):
                            key = (mod.name, info.qualname)
                            cur = entries.setdefault(key, set())
                            if expr.id not in cur:
                                cur.add(expr.id)
                                changed = True
    return entries


def _calls_in(scope: ast.AST) -> Iterator[Tuple[ast.Call, ast.AST]]:
    for node in ast.walk(scope):
        if isinstance(node, ast.Call):
            yield node, scope


def _resolve_entry(
    ctx: LintContext,
    mod: ModuleInfo,
    call: ast.Call,
    entries: Dict[Tuple[str, str], Set[str]],
) -> Optional[Tuple[Tuple[str, str], FunctionInfo, Set[str]]]:
    resolved = ctx.resolve_call(mod, call.func)
    if resolved is None or resolved not in entries:
        return None
    tmod, tqual = resolved
    info = None
    for cand in ctx.modules[tmod].functions.values():
        if cand.qualname == tqual:
            info = cand
            break
    if info is None:
        return None
    return resolved, info, entries[resolved]


def _bind_args(info: FunctionInfo, call: ast.Call) -> Iterator[Tuple[str, ast.expr]]:
    """Map call-site expressions onto the callee's parameter names; gives up
    on *args/**kwargs splats (can't map statically)."""
    if any(isinstance(a, ast.Starred) for a in call.args) or any(
        kw.arg is None for kw in call.keywords
    ):
        return
    pos = _positional_params(info.node)
    for i, a in enumerate(call.args):
        if i < len(pos):
            yield pos[i], a
    for kw in call.keywords:
        if kw.arg is not None:
            yield kw.arg, kw.value


def _is_bucket_call(mod: ModuleInfo, func: ast.expr) -> bool:
    if isinstance(func, ast.Name):
        if func.id in BUCKET_HELPERS:
            return True
        imp = mod.imports.get(func.id)
        return imp is not None and imp[1] in BUCKET_HELPERS
    if isinstance(func, ast.Attribute):
        return func.attr in BUCKET_HELPERS
    return False


def _is_bucketed(
    expr: ast.expr, scope: ast.AST, mod: ModuleInfo, checked_params: Set[str]
) -> bool:
    """Conservative provenance check: True only when the expression's value
    provably comes from the bucket family (constant, bucket-helper call,
    shape access (`.shape`, `.size()`, `.numel()`), or compositions
    thereof)."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, (int, bool)) or expr.value is None
    if isinstance(expr, ast.Name):
        if expr.id.isupper():  # module constants like J_CAP
            return True
        if expr.id in checked_params:
            # a parameter this rule already checks at the enclosing
            # function's own call sites (wrapper propagation)
            return True
        return _assignments_bucketed(expr.id, scope, mod, checked_params)
    if isinstance(expr, ast.Call):
        if _is_bucket_call(mod, expr.func):
            return True
        if isinstance(expr.func, ast.Name) and expr.func.id in ("min", "max", "int"):
            return all(
                _is_bucketed(a, scope, mod, checked_params) for a in expr.args
            )
        # t.size(0) / t.numel(): a shape read, like .shape
        return isinstance(expr.func, ast.Attribute) and expr.func.attr in ("size", "numel")
    if isinstance(expr, ast.Attribute):
        return expr.attr == "shape"
    if isinstance(expr, ast.Subscript):
        return _is_bucketed(expr.value, scope, mod, checked_params)
    if isinstance(expr, ast.BinOp):
        return _is_bucketed(expr.left, scope, mod, checked_params) and _is_bucketed(
            expr.right, scope, mod, checked_params
        )
    if isinstance(expr, ast.UnaryOp):
        return _is_bucketed(expr.operand, scope, mod, checked_params)
    if isinstance(expr, ast.IfExp):
        return _is_bucketed(expr.body, scope, mod, checked_params) and _is_bucketed(
            expr.orelse, scope, mod, checked_params
        )
    return False


def _assignments_bucketed(
    name: str, scope: ast.AST, mod: ModuleInfo, checked_params: Set[str]
) -> bool:
    """True when every assignment to ``name`` in the enclosing scope is
    bucketed. No assignment found -> unknown -> False (conservative)."""
    found = False
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    found = True
                    if not _is_bucketed(node.value, scope, mod, checked_params):
                        return False
        elif isinstance(node, ast.AnnAssign):
            if (
                isinstance(node.target, ast.Name)
                and node.target.id == name
                and node.value is not None
            ):
                found = True
                if not _is_bucketed(node.value, scope, mod, checked_params):
                    return False
        elif isinstance(node, ast.AugAssign):
            if isinstance(node.target, ast.Name) and node.target.id == name:
                return False
    return found


def _scopes(mod: ModuleInfo) -> Iterator[Tuple[ast.AST, Set[str]]]:
    """Every function scope in the module (module level excluded: entries
    are not called at import time) with its parameter-name set."""
    seen: Set[int] = set()
    for info in mod.functions.values():
        if id(info.node) in seen:
            continue
        seen.add(id(info.node))
        yield info.node, set(_params(info.node))
        for node in ast.walk(info.node):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node is not info.node
                and id(node) not in seen
            ):
                seen.add(id(node))
                yield node, set(_params(node))


@rule(
    "unbucketed-jit-shape",
    "an entry's shape-determining argument bypasses the round_up/node_bucket/"
    "_bucket helpers, so it pads differently from the reference",
)
def unbucketed_jit_shape(ctx: LintContext) -> Iterator[Finding]:
    entries = _shape_entries(ctx)
    if not entries:
        return
    for mod in ctx.modules.values():
        for scope, own_params in _scopes(mod):
            scope_key = None
            for info in mod.functions.values():
                if info.node is scope:
                    scope_key = (mod.name, info.qualname)
                    break
            checked = entries.get(scope_key, set()) if scope_key else set()
            for node in ast.walk(scope):
                if not isinstance(node, ast.Call):
                    continue
                target = _resolve_entry(ctx, mod, node, entries)
                if target is None:
                    continue
                tkey, tinfo, shaped = target
                if scope_key == tkey:
                    continue  # recursion / self-forwarding already covered
                for pname, expr in _bind_args(tinfo, node):
                    if pname not in shaped:
                        continue
                    if not _is_bucketed(expr, scope, mod, checked):
                        yield Finding(
                            "unbucketed-jit-shape", mod.path,
                            expr.lineno, expr.col_offset,
                            f"shape arg {pname!r} of {tinfo.qualname} does "
                            "not come from round_up/node_bucket/_bucket*; a "
                            "raw size pads differently from the reference",
                        )
