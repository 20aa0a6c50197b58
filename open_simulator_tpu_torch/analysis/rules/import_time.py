"""Import-time rule: no CUDA work when a module is imported.

The counterpart of the reference's `import-time-jnp`, restated. A tensor
built on a device, or any `torch.cuda.*` call, at module level initialises
CUDA in the importing process, and a CUDA context does not survive `fork`:
every child forked after the import dies on its first launch. The port
forks (chip_smoke.py's phase children, `chaos --capacity`'s killed sweep,
the deadline worker), so device state is built inside functions, on the
device the caller names.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..lint import Finding, LintContext, ModuleInfo, rule


def _walk_module_level(node: ast.AST) -> Iterator[ast.AST]:
    """Nodes executed at import: the module body, class bodies, and
    if/try/with blocks at those levels, but not function bodies."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield child
        yield from _walk_module_level(child)


def _dotted(node: ast.expr) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_cpu_const(node: ast.expr) -> bool:
    """A device argument that is the CPU or None for sure."""
    if isinstance(node, ast.Constant):
        return node.value is None or (isinstance(node.value, str) and node.value.startswith("cpu"))
    if isinstance(node, ast.Call) and _dotted(node.func).endswith("device") and node.args:
        return _is_cpu_const(node.args[0])
    return False


def _cuda_call(mod: ModuleInfo, node: ast.Call) -> str:
    """What makes `node` CUDA work at import, or ''."""
    fn = node.func
    torch_alias = mod.alias_for("torch")
    name = _dotted(fn)
    head = name.split(".", 1)[0]
    if head in torch_alias and name.split(".")[1:2] == ["cuda"]:
        return f"{name}()"
    imp = mod.imports.get(head)
    if imp is not None and imp[0].startswith("torch.cuda"):
        return f"{name}()"
    if isinstance(fn, ast.Attribute) and fn.attr == "cuda":
        return ".cuda()"
    if (
        isinstance(fn, ast.Attribute) and fn.attr == "to" and node.args
        and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
        and not _is_cpu_const(node.args[0])
    ):
        return f".to({node.args[0].value!r})"
    for kw in node.keywords:
        if kw.arg == "device" and not _is_cpu_const(kw.value):
            return f"{name or 'call'}(device=...)"
    return ""


@rule(
    "import-time-cuda",
    "a module-level tensor built on a device or torch.cuda.* call initialises "
    "CUDA at import, which breaks every later fork",
)
def import_time_cuda(ctx: LintContext) -> Iterator[Finding]:
    for mod in ctx.modules.values():
        if not mod.alias_for("torch") and not any(
            imp[0].startswith("torch") for imp in mod.imports.values()
        ):
            continue
        for node in _walk_module_level(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            what = _cuda_call(mod, node)
            if what:
                yield Finding(
                    "import-time-cuda", mod.path, node.lineno, node.col_offset,
                    f"{what} at module import time initialises CUDA in every "
                    "importing process (a forked child then dies on its first "
                    "launch); build device state inside a function",
                )
