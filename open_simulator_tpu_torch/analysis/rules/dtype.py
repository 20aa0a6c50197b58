"""Dtype regime rule: `ops/` stays f32/i32.

The kernels keep every count and score exact in float32 below 2**24 (the
fold-order contract of ops/fast.py), and the contract is the reference's
bits, which are f32/i32 (x64 is off there). A float64 or int64 tensor either
doubles the device traffic or computes in a precision the reference never
saw. The torch spellings are `torch.float64`, `torch.double`,
`torch.int64`, `torch.long` (and their unsigned and complex kin),
`.double()` and `.long()`; the numpy spellings and a bare `float` / `int`
as a dtype carry over from the reference.

PyTorch wants int64 for the indices of `gather`, `scatter*`, `index_*`,
`take` and advanced indexing, so an int64 value is exempt where it only
feeds an index: used as a subscript, as the index argument of one of those
calls, or bound to a name whose every use in the function is such an
index. float64 is never exempt. Any other int64 use takes an
`osim: lint-ok[f64-literal]` comment with its reason.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional

from ..lint import Finding, LintContext, rule

_WIDE = {
    "float64", "int64", "uint64", "complex128", "double", "longdouble", "long", "cdouble",
}
_WIDE_INT = {"int64", "uint64", "long"}
_WIDE_METHODS = {"double": "float64", "long": "int64"}
#: calls that take an int64 index (positionally or as index=)
_INDEX_CALLS = {
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_select", "index_add", "index_add_", "index_copy",
    "index_copy_", "index_fill", "index_fill_", "index_put", "index_put_", "take",
    "take_along_dim", "index_reduce", "index_reduce_", "local_index",
}


def _parents(tree: ast.AST) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _feeds_index(node: ast.AST, parents: Dict[int, ast.AST]) -> bool:
    """True when `node`'s value is used directly as an index."""
    parent = parents.get(id(node))
    if isinstance(parent, ast.Tuple):
        grand = parents.get(id(parent))
        if isinstance(grand, ast.Subscript) and grand.slice is parent:
            return True
        if isinstance(grand, (ast.List, ast.Tuple)):
            # index_put_((a, b), v): a tuple of indices
            return _feeds_index(parent, parents)
        if isinstance(grand, ast.Call):
            parent = grand
    if isinstance(parent, ast.Subscript):
        return parent.slice is node
    if isinstance(parent, ast.keyword) and parent.arg == "index":
        return True
    if isinstance(parent, ast.Call):
        fn = parent.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        if name in _INDEX_CALLS and node is not fn:
            return not (isinstance(fn, ast.Attribute) and fn.value is node)
    return False


def _enclosing_function(node: ast.AST, parents: Dict[int, ast.AST]) -> Optional[ast.AST]:
    cur = parents.get(id(node))
    while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
        cur = parents.get(id(cur))
    return cur


#: calls that keep their receiver's (or first argument's) integer values
_VALUE_KEEPING_METHODS = {
    "to", "type", "astype", "contiguous", "clamp", "reshape", "view", "flatten", "expand",
    "unsqueeze", "cuda",
}
_VALUE_KEEPING_CALLS = {"from_numpy", "as_tensor", "tensor"}


def _value_node(node: ast.AST, parents: Dict[int, ast.AST]) -> ast.AST:
    """The expression whose value is wide: the `.long()` call itself, the
    `.to(torch.int64)` / `.astype(np.int64)` call, or the constructor taking
    `dtype=torch.int64`, followed out through calls that keep the values
    (`torch.from_numpy(...)`, `.to(device)`, `.clamp(...)`...)."""
    parent = parents.get(id(node))
    if isinstance(parent, ast.keyword) and parent.arg == "dtype":
        node = parents.get(id(parent), node)
    elif isinstance(parent, ast.Call) and isinstance(parent.func, ast.Attribute) and (
        parent.func.attr in ("to", "type", "astype") and node in parent.args
    ):
        node = parent
    while True:
        parent = parents.get(id(node))
        if isinstance(parent, ast.Attribute) and parent.value is node:
            call = parents.get(id(parent))
            if (
                isinstance(call, ast.Call) and call.func is parent
                and parent.attr in _VALUE_KEEPING_METHODS
            ):
                node = call
                continue
        if isinstance(parent, ast.Call) and parent.args and parent.args[0] is node:
            fn = parent.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in _VALUE_KEEPING_CALLS:
                node = parent
                continue
        return node


def _index_only(node: ast.AST, parents: Dict[int, ast.AST]) -> bool:
    """The wide value `node` only feeds indices: directly, or through one
    name bound to it whose every load in the function is an index."""
    value = _value_node(node, parents)
    if _feeds_index(value, parents):
        return True
    parent = parents.get(id(value))
    target = None
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        if parent.value is value:
            target = parent.targets[0]
        elif isinstance(parent.targets[0], ast.Tuple) and isinstance(parent.value, ast.Tuple):
            pass  # handled below through the value tuple
    elif isinstance(parent, ast.Tuple):
        # a, b = x.long(), y.long(): the element's own target
        assign = parents.get(id(parent))
        if (
            isinstance(assign, ast.Assign) and len(assign.targets) == 1
            and assign.value is parent and isinstance(assign.targets[0], ast.Tuple)
            and len(assign.targets[0].elts) == len(parent.elts)
        ):
            target = assign.targets[0].elts[parent.elts.index(value)]
            parent = assign
    if not isinstance(target, ast.Name):
        return False
    name = target.id
    scope = _enclosing_function(parent, parents)
    if scope is None:
        return False
    own = {id(n) for n in ast.walk(value)}
    loads = [
        n for n in ast.walk(scope)
        if isinstance(n, ast.Name) and n.id == name and isinstance(n.ctx, ast.Load)
        and id(n) not in own
    ]
    return bool(loads) and all(_feeds_index(n, parents) for n in loads)


@rule(
    "f64-literal",
    "float64/int64 dtypes (torch.float64/double/int64/long, .double()/.long(), "
    "or bare float/int as dtype=) in ops/ break the f32/i32 exactness regime; "
    "int64 that only feeds an index is exempt",
)
def f64_literal(ctx: LintContext) -> Iterator[Finding]:
    for mod in ctx.modules.values():
        if ".ops." not in f".{mod.name}.":
            continue
        np_like = mod.alias_for("numpy") | mod.alias_for("torch")
        parents = _parents(mod.tree)
        for node in ast.walk(mod.tree):
            # torch.float64 / np.int64 / torch.long attribute access
            if (
                isinstance(node, ast.Attribute)
                and node.attr in _WIDE
                and isinstance(node.value, ast.Name)
                and node.value.id in np_like
            ):
                if node.attr in _WIDE_INT and _index_only(node, parents):
                    continue
                yield Finding(
                    "f64-literal", mod.path, node.lineno, node.col_offset,
                    f"{node.value.id}.{node.attr} in ops/ leaves the f32/i32 "
                    "regime; use float32/int32",
                )
            elif isinstance(node, ast.Call):
                fn = node.func
                # x.double() / x.long()
                if isinstance(fn, ast.Attribute) and fn.attr in _WIDE_METHODS and not node.args:
                    if fn.attr == "long" and _index_only(node, parents):
                        continue
                    yield Finding(
                        "f64-literal", mod.path, node.lineno, node.col_offset,
                        f".{fn.attr}() in ops/ widens to {_WIDE_METHODS[fn.attr]}; "
                        "spell the 32-bit dtype",
                    )
                    continue
                # dtype=float / dtype=int keywords, and astype(float)
                for kw in node.keywords:
                    if (
                        kw.arg == "dtype"
                        and isinstance(kw.value, ast.Name)
                        and kw.value.id in ("float", "int")
                    ):
                        yield Finding(
                            "f64-literal", mod.path, kw.value.lineno, kw.value.col_offset,
                            f"dtype={kw.value.id} means {kw.value.id}64 by numpy "
                            "convention; spell the 32-bit dtype explicitly",
                        )
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "astype"
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in ("float", "int")
                ):
                    yield Finding(
                        "f64-literal", mod.path, node.lineno, node.col_offset,
                        f"astype({node.args[0].id}) widens to 64-bit; spell the "
                        "32-bit dtype explicitly",
                    )
