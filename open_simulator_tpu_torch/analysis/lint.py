"""AST lint engine: package walker, entry reachability, rule driver.

The port of the JAX package's analysis/lint.py. Pure stdlib (`ast` only:
importing torch just to lint would pay its start-up on every pre-commit
run). The engine builds a package-wide model once, computes which functions
are reachable from a device entry, then hands a `LintContext` to every
registered rule.

What a root is changes with the port. The reference roots its reachability
at `jax.jit` spellings; the port has no jit. Its device entries are the
functions decorated `@sanitizable("<audit name>")` (ops/sanitize.py), the 23
callables of the entry registry (analysis/entry_audit.py), so a root is a
function with that decorator, and the `jit_root` label of a finding under it
is the decorator's audit name ("ops.fast:light_scan"). The key keeps the
reference's name so the JSON schema carries over.

Reachability is a worklist over the call graph: any function called by name
from an entry-reachable body is itself entry-reachable, and so are the
function-valued arguments of the torch higher-order calls that run their
function inside the caller (`torch.vmap`, `torch.func.vmap`,
`functorch.vmap`, `torch.utils.checkpoint.checkpoint`). `from .sibling
import helper` imports are resolved within the package, so a helper in
ops/encode.py called from an entry in ops/fast.py is covered.

`FunctionInfo` has no `static_argnames` (no cache is keyed by static
arguments in eager PyTorch) and no `jit_alias` (no `alias = jax.jit(f)`
form); the shapes rule reads an entry's parameter list instead.

Suppressions: append an `osim: lint-ok[rule-id]` comment to the flagged
line, with a one-line reason on the same or the preceding line. A
suppression that no longer matches a finding is reported as
`unused-suppression`, so it cannot rot into cover for a future finding.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*osim:\s*lint-ok\[([a-z0-9-]+(?:\s*,\s*[a-z0-9-]+)*)\]")

#: the decorator that marks a device entry (ops/sanitize.py)
ENTRY_DECORATOR = "sanitizable"

#: torch higher-order calls whose function-valued arguments run inside the
#: calling entry
_TRACED_HOFS = {"vmap", "checkpoint"}
#: modules a bare `vmap` / `checkpoint` name may be imported from
_HOF_MODULES = {"torch", "torch.func", "functorch", "torch.utils.checkpoint"}


@dataclasses.dataclass
class Finding:
    """One lint violation. `jit_root` names the device entry (its audit
    name) that makes the enclosing function entry-reachable; empty for rules
    that apply anywhere."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    jit_root: str = ""
    suppressed: bool = False

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }
        if self.jit_root:
            d["jit_root"] = self.jit_root
        if self.suppressed:
            d["suppressed"] = True
        return d

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        ctx = f" [via {self.jit_root}]" if self.jit_root else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}{ctx}{tag}"


@dataclasses.dataclass
class FunctionInfo:
    """A function def somewhere in a module (module-level or nested)."""

    module: "ModuleInfo"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    qualname: str
    is_jit_root: bool = False
    #: the audit name of `@sanitizable("<name>")` when the def is an entry
    entry_name: str = ""

    @property
    def name(self) -> str:
        return self.node.name  # type: ignore[attr-defined]


@dataclasses.dataclass
class ModuleInfo:
    """Parsed module plus the name-resolution tables rules need."""

    name: str  # dotted module name, e.g. open_simulator_tpu_torch.ops.fast
    path: str  # path as reported in findings (relative to the repo root)
    tree: ast.Module
    lines: List[str]
    # module-level defs by local name
    functions: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    # local alias -> (dotted module, attr-or-None) for import/from-import
    imports: Dict[str, Tuple[str, Optional[str]]] = dataclasses.field(default_factory=dict)
    suppressions: Dict[int, Set[str]] = dataclasses.field(default_factory=dict)

    def alias_for(self, dotted: str) -> Set[str]:
        """Local names that refer to module `dotted` (e.g. {'np'} for
        numpy)."""
        return {
            local
            for local, (mod, attr) in self.imports.items()
            if attr is None and mod == dotted
        }


@dataclasses.dataclass
class LintContext:
    """Everything a rule gets: the package model + reachability results."""

    modules: Dict[str, ModuleInfo]
    # (module name, function qualname) -> audit name of a root reaching it
    reachable: Dict[Tuple[str, str], str]
    package: str

    def jit_regions(self) -> Iterator[Tuple[ModuleInfo, ast.AST, str]]:
        """Yield (module, function node, root audit name) for every
        entry-reachable function body, nested defs excluded (they are part
        of their parent's subtree and would double-report)."""
        seen: Set[int] = set()
        for (mod_name, qual), root in sorted(self.reachable.items()):
            mod = self.modules[mod_name]
            info = _find_function(mod, qual)
            if info is None or id(info.node) in seen:
                continue
            if any((mod_name, anc) in self.reachable for anc in _ancestor_quals(qual)):
                continue
            seen.add(id(info.node))
            yield mod, info.node, root

    def roots(self) -> Dict[str, Tuple[str, str]]:
        """audit name -> (module, qualname) of every entry in the package."""
        out: Dict[str, Tuple[str, str]] = {}
        for mod in self.modules.values():
            for info in mod.functions.values():
                if info.is_jit_root:
                    out[info.entry_name] = (mod.name, info.qualname)
        return out

    def resolve_call(
        self, mod: ModuleInfo, func: ast.expr
    ) -> Optional[Tuple[str, str]]:
        """Resolve a Call.func expression to (module name, function qualname)
        within the package, or None."""
        if isinstance(func, ast.Name):
            target = mod.functions.get(func.id)
            if target is not None:
                return mod.name, target.qualname
            imp = mod.imports.get(func.id)
            if imp is not None:
                tmod, attr = imp
                if attr is not None and tmod in self.modules:
                    t = self.modules[tmod].functions.get(attr)
                    if t is not None:
                        return tmod, t.qualname
        elif isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            imp = mod.imports.get(func.value.id)
            if imp is not None:
                target = imp[0] if imp[1] is None else f"{imp[0]}.{imp[1]}"
                if target in self.modules:
                    t = self.modules[target].functions.get(func.attr)
                    if t is not None:
                        return target, t.qualname
        return None


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]
    files_scanned: int
    rules: List[str]

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": 1,
                "files_scanned": self.files_scanned,
                "rules": self.rules,
                "findings": [f.to_dict() for f in self.findings if not f.suppressed],
                "suppressed": [f.to_dict() for f in self.findings if f.suppressed],
            },
            indent=2,
            sort_keys=True,
        )

    def render_text(self) -> str:
        out = [f.render() for f in self.active]
        n_sup = sum(1 for f in self.findings if f.suppressed)
        out.append(
            f"simon lint: {len(self.active)} finding(s), {n_sup} suppressed, "
            f"{self.files_scanned} file(s) scanned"
        )
        return "\n".join(out)


# --------------------------------------------------------------------------
# rule registry

RuleFunc = Callable[[LintContext], Iterable[Finding]]
_RULES: Dict[str, Tuple[str, RuleFunc]] = {}


def rule(rule_id: str, doc: str) -> Callable[[RuleFunc], RuleFunc]:
    """Register a rule. `doc` is the one-line catalogue entry."""

    def deco(fn: RuleFunc) -> RuleFunc:
        _RULES[rule_id] = (doc, fn)
        return fn

    return deco


def iter_rules() -> List[Tuple[str, str]]:
    """(rule-id, doc) pairs, sorted: the rule catalogue."""
    _load_rules()
    return sorted((rid, doc) for rid, (doc, _) in _RULES.items())


_rules_loaded = False


def _load_rules() -> None:
    global _rules_loaded
    if not _rules_loaded:
        from . import rules as _rules_pkg  # noqa: F401  (registers via decorator)

        _rules_loaded = True


# --------------------------------------------------------------------------
# package model construction


def _module_name(pkg_root: str, py_path: str) -> str:
    rel = os.path.relpath(py_path, os.path.dirname(pkg_root))
    parts = rel[:-3].split(os.sep)  # strip .py
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _parse_suppressions(lines: List[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(line)
        if m:
            out[i] = {p.strip() for p in m.group(1).split(",")}
    return out


def _entry_name(dec: ast.expr, mod: ModuleInfo) -> str:
    """The audit name of `@sanitizable("<name>", ...)` (through an import,
    a local def or a module attribute), else ''."""
    if not isinstance(dec, ast.Call) or not dec.args:
        return ""
    fn = dec.func
    is_entry = (
        isinstance(fn, ast.Attribute) and fn.attr == ENTRY_DECORATOR
        or isinstance(fn, ast.Name) and (
            fn.id == ENTRY_DECORATOR
            or (mod.imports.get(fn.id) or ("", None))[1] == ENTRY_DECORATOR
        )
    )
    first = dec.args[0]
    if is_entry and isinstance(first, ast.Constant) and isinstance(first.value, str):
        return first.value
    return ""


def _is_traced_hof(mod: ModuleInfo, fn: ast.expr) -> bool:
    """torch.vmap / torch.func.vmap / functorch.vmap / checkpoint, by
    attribute or by a name imported from those modules."""
    if isinstance(fn, ast.Attribute):
        return fn.attr in _TRACED_HOFS
    if isinstance(fn, ast.Name):
        imp = mod.imports.get(fn.id)
        return imp is not None and imp[0] in _HOF_MODULES and imp[1] in _TRACED_HOFS
    return False


def _scan_imports(tree: ast.Module, mod_name: str,
                  is_package: bool = False) -> Dict[str, Tuple[str, Optional[str]]]:
    out: Dict[str, Tuple[str, Optional[str]]] = {}
    pkg_parts = mod_name.split(".")
    if is_package:
        # an __init__'s relative imports resolve against the package itself
        pkg_parts = pkg_parts + [""]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                # `import torch.nn.functional as F` binds F -> torch.nn.functional;
                # plain `import torch.cuda` binds torch (the root) only.
                out[local] = (a.name if a.asname else a.name.split(".")[0], None)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - node.level]
                target = ".".join(base + ([node.module] if node.module else []))
            else:
                target = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = (target, a.name)
    return out


def _collect_functions(mod: ModuleInfo) -> None:
    """Fill mod.functions (module-level defs, nested ones under their
    qualnames) and mark the device entries anywhere in the module."""

    def visit(node: ast.AST, prefix: str, module_level: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                info = FunctionInfo(module=mod, node=child, qualname=qual)
                for dec in child.decorator_list:
                    name = _entry_name(dec, mod)
                    if name:
                        info.is_jit_root = True
                        info.entry_name = name
                if module_level:
                    mod.functions[child.name] = info
                else:
                    mod.functions.setdefault(qual, info)
                visit(child, f"{qual}.", False)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", False)
            elif not isinstance(child, (ast.Lambda, ast.expr)):
                # descend through if/for/while/try/with blocks so defs nested
                # under control flow are still discovered
                visit(child, prefix, module_level)

    visit(mod.tree, "", True)


def _find_function(mod: ModuleInfo, qualname: str) -> Optional[FunctionInfo]:
    for info in mod.functions.values():
        if info.qualname == qualname:
            return info
    return None


def _ancestor_quals(qual: str) -> Iterator[str]:
    parts = qual.split(".")
    for i in range(1, len(parts)):
        yield ".".join(parts[:i])


def _called_functions(
    ctx: LintContext, mod: ModuleInfo, body: ast.AST
) -> Iterator[Tuple[str, str]]:
    """(module, qualname) pairs for package functions called from `body`,
    including function-valued arguments of torch.vmap and checkpoint."""
    for node in ast.walk(body):
        if not isinstance(node, ast.Call):
            continue
        resolved = ctx.resolve_call(mod, node.func)
        if resolved is not None:
            yield resolved
        if _is_traced_hof(mod, node.func):
            for arg in node.args:
                if isinstance(arg, (ast.Name, ast.Attribute)):
                    r = ctx.resolve_call(mod, arg)
                    if r is not None:
                        yield r


def _compute_reachability(ctx: LintContext) -> None:
    work: List[Tuple[str, str, str]] = []  # (module, qualname, root)
    for mod in ctx.modules.values():
        seen_ids: Set[int] = set()
        for info in mod.functions.values():
            if info.is_jit_root and id(info.node) not in seen_ids:
                seen_ids.add(id(info.node))
                work.append((mod.name, info.qualname, info.entry_name))
    while work:
        mod_name, qual, root = work.pop()
        key = (mod_name, qual)
        if key in ctx.reachable:
            continue
        ctx.reachable[key] = root
        mod = ctx.modules[mod_name]
        info = _find_function(mod, qual)
        if info is None:
            continue
        for tmod, tqual in _called_functions(ctx, mod, info.node):
            if (tmod, tqual) not in ctx.reachable:
                work.append((tmod, tqual, root))


# --------------------------------------------------------------------------
# driver


def build_context(
    package_root: Optional[str] = None, report_root: Optional[str] = None
) -> LintContext:
    """Parse the package and compute entry reachability.

    `package_root` is the directory of the top-level package (defaults to
    the installed `open_simulator_tpu_torch`); `report_root` is what finding
    paths are made relative to (defaults to the package's parent, the repo
    root)."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    package_root = os.path.abspath(package_root)
    if report_root is None:
        report_root = os.path.dirname(package_root)
    pkg_name = os.path.basename(package_root)

    modules: Dict[str, ModuleInfo] = {}
    for dirpath, dirnames, filenames in os.walk(package_root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            full = os.path.join(dirpath, fname)
            with open(full, "r", encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=full)
            name = _module_name(package_root, full)
            mod = ModuleInfo(
                name=name,
                path=os.path.relpath(full, report_root),
                tree=tree,
                lines=src.splitlines(),
            )
            mod.imports = _scan_imports(tree, name, fname == "__init__.py")
            mod.suppressions = _parse_suppressions(mod.lines)
            modules[name] = mod
    for mod in modules.values():
        _collect_functions(mod)
    ctx = LintContext(modules=modules, reachable={}, package=pkg_name)
    _compute_reachability(ctx)
    return ctx


def run_lint(
    package_root: Optional[str] = None,
    report_root: Optional[str] = None,
    only_rules: Optional[Iterable[str]] = None,
) -> LintReport:
    """Run every registered rule; suppression comments are honoured here so
    rules stay oblivious to them."""
    _load_rules()
    ctx = build_context(package_root, report_root)
    wanted = set(only_rules) if only_rules else None
    by_path = {m.path: m for m in ctx.modules.values()}
    findings: List[Finding] = []
    for rid, (_doc, fn) in sorted(_RULES.items()):
        if wanted is not None and rid not in wanted:
            continue
        for f in fn(ctx):
            mod = by_path.get(f.path)
            if mod is not None and f.rule in mod.suppressions.get(f.line, set()):
                f.suppressed = True
            findings.append(f)
    if wanted is None:
        # Every rule ran, so a suppression comment that matched nothing is
        # stale: report it. (Skipped under --rules: a filtered run can't tell.)
        used = {(f.path, f.line, f.rule) for f in findings if f.suppressed}
        for mod in ctx.modules.values():
            for line, rules in sorted(mod.suppressions.items()):
                for rid in sorted(rules):
                    if (mod.path, line, rid) not in used:
                        findings.append(
                            Finding(
                                rule="unused-suppression",
                                path=mod.path,
                                line=line,
                                col=0,
                                message=(
                                    f"suppression lint-ok[{rid}] matches no "
                                    f"finding on this line"
                                    + ("" if rid in _RULES else f" (unknown rule id {rid!r})")
                                ),
                            )
                        )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintReport(
        findings=findings,
        files_scanned=len(ctx.modules),
        rules=[rid for rid in sorted(_RULES) if wanted is None or rid in wanted],
    )
