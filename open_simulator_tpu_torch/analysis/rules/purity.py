"""Purity rules, restated for eager PyTorch: entry code keeps its values on
the device and its results deterministic.

The reference's rules guard jit tracing. Eager code has no tracer, but the
same spellings still do harm inside an entry (a function reachable from a
`@sanitizable` device entry, analysis/lint.py):

  * `float()` / `int()` / `bool()` on a tensor, `.item()`, `.tolist()`,
    `.cpu()`, `.numpy()` and `np.asarray(tensor)` are a device->host sync on
    every call, and under `torch.func.vmap` (the scenario and universe
    engines) the same call raises, exactly as a tracer coercion does;
  * unseeded randomness (`random.*`, `np.random.*`, `torch.rand*` or
    `torch.randperm` without `generator=`) breaks the port's contract of
    bit-identical results to the reference. Eager code re-reads `time.*`
    and `os.environ` on every call, so nothing is frozen and `time.*` is
    not flagged; `os.environ` / `os.getenv` reads stay flagged, because
    entry code does read the environment (the kernel build directory, the
    sanitizer switch) and each such read must say why it cannot change the
    entry's result.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ..lint import Finding, LintContext, ModuleInfo, rule

_COERCERS = {"float", "int", "bool", "complex"}
#: numpy calls that materialise their argument on the host
_NP_MATERIALIZERS = {"asarray", "array", "copy", "frombuffer", "ascontiguousarray"}
#: tensor methods that copy to the host (each a device->host sync)
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
#: attribute names whose access yields host values even on tensors
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "nbytes", "itemsize", "device", "is_cuda"}
#: tensor methods returning host values without a sync
_STATIC_METHODS = {"numel", "dim", "size", "element_size", "ndimension", "nelement"}
#: torch random constructors that need an explicit generator= to be seeded
_TORCH_RANDOM = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like", "randint_like",
    "bernoulli", "multinomial", "normal", "poisson",
}


def _is_static_expr(node: ast.expr) -> bool:
    """True when the expression is host-level for sure (safe to coerce)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        # module-level ALL_CAPS constants (J_CAP, DM_CAP, ...) are ints
        return node.id.isupper() or node.id == "__debug__"
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS or _is_static_expr(node.value)
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            return True  # a host int read from the shape, never a sync
        if isinstance(node.func, ast.Name) and node.func.id in ("min", "max"):
            return all(_is_static_expr(a) for a in node.args)
        if isinstance(node.func, ast.Attribute) and node.func.attr in _STATIC_METHODS:
            return True
        return False
    if isinstance(node, ast.BinOp):
        return _is_static_expr(node.left) and _is_static_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_static_expr(node.operand)
    if isinstance(node, ast.IfExp):
        return _is_static_expr(node.body) and _is_static_expr(node.orelse)
    return False


def _np_aliases(mod: ModuleInfo) -> Set[str]:
    return mod.alias_for("numpy")


@rule(
    "tracer-coercion",
    "float()/int()/bool()/.item()/.tolist()/.cpu()/.numpy()/np.asarray on a "
    "tensor inside entry-reachable code is a device->host sync per call and "
    "raises under torch.func.vmap",
)
def tracer_coercion(ctx: LintContext) -> Iterator[Finding]:
    for mod, body, root in ctx.jit_regions():
        np_alias = _np_aliases(mod)
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            # float(x) / int(x) / bool(x) / complex(x)
            if (
                isinstance(fn, ast.Name)
                and fn.id in _COERCERS
                and fn.id not in mod.functions
                and node.args
                and not all(_is_static_expr(a) for a in node.args)
            ):
                yield Finding(
                    "tracer-coercion", mod.path, node.lineno, node.col_offset,
                    f"{fn.id}() on a potentially device value inside an entry "
                    "syncs the host (and raises under vmap); keep it a tensor "
                    "or hoist it to host code",
                    jit_root=root,
                )
            # x.item() / x.tolist() / x.cpu() / x.numpy()
            elif isinstance(fn, ast.Attribute) and fn.attr in _HOST_READS and not node.args:
                yield Finding(
                    "tracer-coercion", mod.path, node.lineno, node.col_offset,
                    f".{fn.attr}() inside an entry is a device->host transfer; "
                    "keep the value on the device",
                    jit_root=root,
                )
            # np.asarray(x) and friends
            elif (
                isinstance(fn, ast.Attribute)
                and fn.attr in _NP_MATERIALIZERS
                and isinstance(fn.value, ast.Name)
                and fn.value.id in np_alias
                and node.args
                and not all(_is_static_expr(a) for a in node.args)
            ):
                yield Finding(
                    "tracer-coercion", mod.path, node.lineno, node.col_offset,
                    f"np.{fn.attr}() inside an entry materializes its argument "
                    "on the host; use torch equivalents",
                    jit_root=root,
                )


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


@rule(
    "impure-read",
    "random.*/np.random.*/torch.rand* without generator= inside "
    "entry-reachable code is unseeded randomness, and an os.environ read "
    "there makes the result depend on the environment; both break "
    "bit-identical results",
)
def impure_read(ctx: LintContext) -> Iterator[Finding]:
    for mod, body, root in ctx.jit_regions():
        os_alias = mod.alias_for("os")
        random_alias = mod.alias_for("random")
        np_alias = _np_aliases(mod)
        torch_alias = mod.alias_for("torch")
        for node in ast.walk(body):
            if (
                isinstance(node, ast.Attribute)
                and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id in os_alias
            ):
                yield Finding(
                    "impure-read", mod.path, node.lineno, node.col_offset,
                    "os.environ read inside an entry makes its result depend on "
                    "the environment, not its arguments; read it on the host "
                    "and pass a value",
                    jit_root=root,
                )
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
                base_id = fn.value.id
                if base_id in os_alias and fn.attr == "getenv":
                    yield Finding(
                        "impure-read", mod.path, node.lineno, node.col_offset,
                        "os.getenv() inside an entry makes its result depend on "
                        "the environment, not its arguments",
                        jit_root=root,
                    )
                elif base_id in random_alias:
                    yield Finding(
                        "impure-read", mod.path, node.lineno, node.col_offset,
                        f"random.{fn.attr}() inside an entry is unseeded host "
                        "randomness; pass a seeded torch.Generator",
                        jit_root=root,
                    )
                elif (
                    base_id in torch_alias
                    and fn.attr in _TORCH_RANDOM
                    and not _has_generator(node)
                ):
                    yield Finding(
                        "impure-read", mod.path, node.lineno, node.col_offset,
                        f"torch.{fn.attr}() without generator= inside an entry "
                        "draws from the global RNG; pass a seeded torch.Generator",
                        jit_root=root,
                    )
            # np.random.*(): stateful host RNG
            if (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Attribute)
                and fn.value.attr == "random"
                and isinstance(fn.value.value, ast.Name)
                and fn.value.value.id in np_alias
            ):
                yield Finding(
                    "impure-read", mod.path, node.lineno, node.col_offset,
                    f"np.random.{fn.attr}() inside an entry is unseeded host "
                    "randomness; pass a seeded torch.Generator",
                    jit_root=root,
                )
