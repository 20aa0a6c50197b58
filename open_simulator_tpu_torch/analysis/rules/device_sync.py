"""device-sync-in-loop: host loops that feed device entries stay async.

The dispatch side of the simulator is pipelined: host loops (the extender
wave chains, the resident-delta folds, the scheduler pack loop) enqueue
device work and let the card run ahead. One synchronous read inside such a
loop (`.item()`, `.cpu()`, `.numpy()`, `torch.cuda.synchronize()`,
`.tolist()` / `np.asarray` / `float()` of an entry's result) stalls the
pipeline every iteration: the host blocks on step N before it can even
launch step N+1, turning async dispatch into lock-step round trips.

This rule flags those syncs when they sit inside a host `for`/`while` loop
whose body also calls a device entry. `.tolist()`, `np.asarray` / `float`
/ `int` only fire on values traced back (by local assignment) to an entry's
result: the same calls on numpy state in the loop are host arithmetic, not
a sync. `.item()`, `.cpu()`, `.numpy()` and `torch.cuda.synchronize()` fire
wherever they appear in such a loop. One batched read after the loop (one
`.cpu()` of a stacked tensor, or one `tuple(t.cpu() ...)`) is the idiom this
rule pushes toward and is not flagged. Syncs outside such loops are fine;
entry-reachable code is the purity rules' business and is excluded here. A
deliberate per-iteration sync (a small mask the host algorithm needs before
the next dispatch) takes the `osim: lint-ok[device-sync-in-loop]` comment
with a one-line reason.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..lint import Finding, LintContext, ModuleInfo, _find_function, rule
from .purity import _is_static_expr

RULE = "device-sync-in-loop"

#: tensor methods that sync wherever they appear (no-argument calls)
_SYNC_ATTRS = {"item", "cpu", "numpy"}
#: tensor methods that sync only on an entry's result (numpy has them too)
_RESULT_SYNC_ATTRS = {"tolist"}
#: numpy calls that pull a device tensor to the host
_NP_PULLS = {"asarray", "array"}
_COERCERS = {"float", "int", "bool"}
#: tensor methods that fetch to the host: a wrapper calling one is
#: host-returning, not an entry-like dispatcher
_FETCHES = {"cpu", "numpy", "tolist"}


def _is_jitish(
    ctx: LintContext, mod: ModuleInfo, func: ast.expr,
    cache: Dict[Tuple[str, str], bool],
) -> bool:
    """True when ``func`` resolves to a device entry, or to a thin wrapper
    whose body calls one directly (such dispatchers return device tensors
    just like the entry itself). A wrapper that itself fetches
    (``.cpu()``/``.numpy()``/``.tolist()``) is host-returning
    (``schedule_scenarios_host``-style drivers do the one batched read
    internally) and is NOT entry-like."""
    resolved = ctx.resolve_call(mod, func)
    if resolved is None:
        return False
    if resolved in cache:
        return cache[resolved]
    cache[resolved] = False  # cut recursion; one hop only below anyway
    tmod = ctx.modules.get(resolved[0])
    info = _find_function(tmod, resolved[1]) if tmod is not None else None
    result = False
    if info is not None:
        if info.is_jit_root:
            result = True
        else:
            calls_jit = fetches = False
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                if _is_fetch(node):
                    fetches = True
                    break
                inner = ctx.resolve_call(tmod, node.func)
                if inner is not None:
                    iinfo = _find_function(ctx.modules[inner[0]], inner[1])
                    if iinfo is not None and iinfo.is_jit_root:
                        calls_jit = True
                    elif iinfo is not None and any(
                        isinstance(n, ast.Call) and _is_fetch(n) for n in ast.walk(iinfo.node)
                    ):
                        # a helper that does the batched read (fast._host)
                        fetches = True
                        break
            result = calls_jit and not fetches
    cache[resolved] = result
    return result


def _is_fetch(node: ast.Call) -> bool:
    f = node.func
    return isinstance(f, ast.Attribute) and f.attr in _FETCHES and not node.args


def _consolidated(node: ast.Call, parents: Dict[int, ast.AST]) -> bool:
    """`t.cpu()` applied to the target of a comprehension over a literal
    tuple or list of several tensors, `(t.cpu() for t in (a, b, c))`: one
    batched read of many results, the counterpart of the reference's
    consolidated jax.device_get, and not flagged."""
    recv = node.func.value if isinstance(node.func, ast.Attribute) else None
    while isinstance(recv, ast.Call) and isinstance(recv.func, ast.Attribute):
        recv = recv.func.value      # t.cpu().numpy(): down to t
    if not isinstance(recv, ast.Name):
        return False
    cur = parents.get(id(node))
    while cur is not None and not isinstance(
        cur, (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.FunctionDef, ast.Lambda)
    ):
        cur = parents.get(id(cur))
    if not isinstance(cur, (ast.GeneratorExp, ast.ListComp)) or len(cur.generators) != 1:
        return False
    gen = cur.generators[0]
    return (
        isinstance(gen.target, ast.Name) and gen.target.id == recv.id
        and isinstance(gen.iter, (ast.Tuple, ast.List)) and len(gen.iter.elts) > 1
    )


def _device_names(
    ctx: LintContext, mod: ModuleInfo, fn_node: ast.AST,
    jitish_cache: Dict[Tuple[str, str], bool],
) -> Set[str]:
    """Names assigned (anywhere in the function) from an entry's result:
    the values whose coercion inside a loop is a device sync."""
    out: Set[str] = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Assign):
            continue
        produces_device = any(
            isinstance(sub, ast.Call)
            and _is_jitish(ctx, mod, sub.func, jitish_cache)
            for sub in ast.walk(node.value)
        )
        if not produces_device:
            continue
        for target in node.targets:
            elts = target.elts if isinstance(target, ast.Tuple) else [target]
            for elt in elts:
                inner = (
                    elt.elts
                    if isinstance(elt, (ast.Tuple, ast.List))
                    else [elt]
                )
                for e in inner:
                    if isinstance(e, ast.Starred):
                        e = e.value
                    if isinstance(e, ast.Name):
                        out.add(e.id)
    return out


def _root_name(node: ast.expr) -> Optional[str]:
    while isinstance(node, (ast.Subscript, ast.Attribute, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _walk_skipping(root: ast.AST, skip: Set[int]) -> Iterator[ast.AST]:
    """ast.walk, but do not descend into function defs whose id is in
    ``skip`` (entry-reachable nested defs are entry code, not host loops)."""
    stack: List[ast.AST] = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if (
                isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                and id(child) in skip
            ):
                continue
            stack.append(child)


def _feeds_jit(ctx: LintContext, mod: ModuleInfo, loop: ast.AST,
               skip: Set[int],
               jitish_cache: Dict[Tuple[str, str], bool]) -> str:
    """The entry a loop body calls, or '' when the loop calls none."""
    for node in _walk_skipping(loop, skip):
        if not isinstance(node, ast.Call):
            continue
        resolved = ctx.resolve_call(mod, node.func)
        if resolved is None:
            continue
        if _is_jitish(ctx, mod, node.func, jitish_cache):
            return f"{resolved[0]}:{resolved[1]}"
    return ""


def _device_arg(args: List[ast.expr], device_names: Set[str]) -> bool:
    for a in args:
        if _is_static_expr(a):
            continue
        root = _root_name(a)
        if root is not None and root in device_names:
            return True
    return False


def _is_cuda_sync(mod: ModuleInfo, fn: ast.expr) -> bool:
    """torch.cuda.synchronize (or a name imported as it)."""
    if isinstance(fn, ast.Attribute) and fn.attr == "synchronize":
        base = fn.value
        return (
            isinstance(base, ast.Attribute) and base.attr == "cuda"
            and isinstance(base.value, ast.Name) and base.value.id in mod.alias_for("torch")
        )
    if isinstance(fn, ast.Name):
        return mod.imports.get(fn.id) == ("torch.cuda", "synchronize")
    return False


def _sync_findings(
    mod: ModuleInfo, loop: ast.AST, skip: Set[int], jit_entry: str,
    device_names: Set[str],
) -> Iterator[Tuple[int, int, str]]:
    np_alias = mod.alias_for("numpy")
    parents: Dict[int, ast.AST] = {}
    for n in ast.walk(loop):
        for child in ast.iter_child_nodes(n):
            parents[id(child)] = n
    for node in _walk_skipping(loop, skip):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_ATTRS and _consolidated(
            node, parents
        ):
            continue
        if _is_cuda_sync(mod, fn):
            yield (
                node.lineno, node.col_offset,
                f"torch.cuda.synchronize() inside a host loop feeding entry "
                f"{jit_entry} blocks the dispatch pipeline every iteration; "
                "synchronize once after the loop",
            )
        elif isinstance(fn, ast.Attribute) and not node.args and (
            fn.attr in _SYNC_ATTRS
            or fn.attr in _RESULT_SYNC_ATTRS and _device_arg([fn.value], device_names)
        ):
            yield (
                node.lineno, node.col_offset,
                f".{fn.attr}() inside a host loop feeding entry "
                f"{jit_entry} blocks the dispatch pipeline every iteration;"
                " hoist the read out of the loop or batch the reads into"
                " one .cpu() of a stacked tensor",
            )
        elif (
            isinstance(fn, ast.Attribute)
            and fn.attr in _NP_PULLS
            and isinstance(fn.value, ast.Name)
            and fn.value.id in np_alias
            and _device_arg(node.args, device_names)
        ):
            yield (
                node.lineno, node.col_offset,
                f"np.{fn.attr}() on an entry result inside a host loop feeding "
                f"{jit_entry} is a per-iteration device->host sync; batch "
                "the reads into one .cpu() after the loop",
            )
        elif (
            isinstance(fn, ast.Name)
            and fn.id in _COERCERS
            and fn.id not in mod.functions
            and _device_arg(node.args, device_names)
        ):
            yield (
                node.lineno, node.col_offset,
                f"{fn.id}() on an entry result inside a host loop feeding "
                f"{jit_entry} is a per-iteration device->host sync; keep "
                "the loop async and read once at the end",
            )


@rule(
    RULE,
    ".item()/.cpu()/.numpy()/torch.cuda.synchronize() (and .tolist()/"
    "np.asarray/float() of entry results) inside host for/while loops that "
    "call device entries stall the dispatch pipeline every iteration",
)
def device_sync_in_loop(ctx: LintContext) -> Iterator[Finding]:
    jitish_cache: Dict[Tuple[str, str], bool] = {}
    for mod in ctx.modules.values():
        # entry-reachable defs in this module: the purity rules' business
        reachable_ids = {
            id(i.node)
            for i in mod.functions.values()
            if (mod.name, i.qualname) in ctx.reachable
        }
        flagged: Set[Tuple[int, int]] = set()
        for info in {id(i.node): i for i in mod.functions.values()}.values():
            if (mod.name, info.qualname) in ctx.reachable:
                continue
            device_names = _device_names(ctx, mod, info.node, jitish_cache)
            for node in ast.walk(info.node):
                if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                    continue
                jit_entry = _feeds_jit(ctx, mod, node, reachable_ids,
                                       jitish_cache)
                if not jit_entry:
                    continue
                for line, col, msg in _sync_findings(
                    mod, node, reachable_ids, jit_entry, device_names
                ):
                    if (line, col) in flagged:
                        continue  # nested loops / nested defs double-walk
                    flagged.add((line, col))
                    yield Finding(RULE, mod.path, line, col, msg)
