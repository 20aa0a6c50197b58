"""Lock-discipline race detector over the lint engine's package model.

The port of the JAX package's analysis/races.py, nearly a copy: it reads
Python, not device code. Its thread roots were checked against the port's
real ones (the server's handler and worker threads, the admission worker,
the deadline watchdog, the extender wave's executor tasks, the mesh slots'
per-slot threads and the interleave checker's shim threads).
`tools/stubs.py` (local stub servers for tests and chip checks) is audited
like every other module: its handler classes are roots.

The threaded surface of the simulator is small but real: the metrics
server handles every request on its own thread (ThreadingHTTPServer), the
chaos/apply paths run in the main thread, and SIGTERM lands in a signal
handler. This pass reconstructs, purely from the AST model lint.py already
builds:

  1. **shared mutable state** — module-level dict/list/set bindings plus
     module-level scalars that some function rebinds through ``global``;
  2. **locks** — module-level ``threading.Lock()``/``RLock()``/
     ``Semaphore()``-style bindings;
  3. **thread roots** — methods of ``BaseHTTPRequestHandler`` subclasses,
     ``threading.Thread(target=...)`` targets (including
     ``target=self._method`` inside classes and nested-function targets),
     ``executor.submit(fn, ...)`` work items (the extender wave engine's
     HTTP fan-out) and ``signal.signal`` handlers, then everything
     reachable from them through the call graph — ``self.method`` inside a
     class, plus ``self.<attr>.<method>()`` hops across classes when the
     method name is unique package-wide (the admission worker thread's
     ``self._loop.run_forever()`` pulls ``SchedulerLoop`` into the audit).

Any read-modify-write of a shared scalar (AugAssign, ``x = f(x)``, or a
read + rebind pair in one function) and any container mutation
(``.append``/``.pop``/``x[k] = v``/``del x[k]`` …) performed in an
audited function without a dominating ``with <lock>:`` block is reported.
A *plain single rebind* of a scalar with no read in the same function is
an atomic publish under the GIL and is deliberately not flagged.

Escapes:

  * ``@guarded_by("lockname")`` (utils/concurrency.py) asserts every
    caller already holds the named module-level lock; the body is then
    treated as dominated by it. The annotation is trusted — it exists for
    guards the detector cannot see (e.g. a ``Semaphore.acquire`` in the
    caller).
  * an ``osim: audit-ok[race]`` comment on the flagged line suppresses
    it; unused suppressions are themselves reported so they cannot rot.

Functions living in a module that *defines* a thread root are audited
even when not reachable from one: once handler threads exist in the
process, main-thread writes to the same state race against them.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .lint import FunctionInfo, LintContext, ModuleInfo, build_context

AUDIT_SUPPRESS_RE = re.compile(
    r"#\s*osim:\s*audit-ok\[([a-z0-9-]+(?:\s*,\s*[a-z0-9-]+)*)\]"
)

RULE_RACE = "race"
RULE_DEADLOCK = "deadlock"

#: every rule this auditor can emit; an `audit-ok[...]` naming anything
#: else is reported stale immediately (it can never match a finding)
KNOWN_RULES = frozenset({RULE_RACE, RULE_DEADLOCK})

_LOCK_FACTORIES = {
    "Lock", "RLock", "Semaphore", "BoundedSemaphore", "Condition", "Event",
}
_CONTAINER_FACTORIES = {
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict", "Counter",
}
_MUTATING_METHODS = {
    "append", "add", "update", "pop", "popitem", "clear", "remove",
    "discard", "extend", "insert", "setdefault", "appendleft", "popleft",
    "sort", "reverse",
}
_HANDLER_BASES = ("BaseHTTPRequestHandler", "SimpleHTTPRequestHandler")


# ---------------------------------------------------------------------------
# findings / report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RaceFinding:
    path: str
    line: int
    col: int
    state: str        # dotted shared object, e.g. server.server._snapshot
    function: str     # module:qualname performing the access
    access: str       # rmw | mutate | check-then-act
    thread_root: str  # why this function is audited
    message: str
    suppressed: bool = False
    rule: str = RULE_RACE

    def sort_key(self):
        return (self.path, self.line, self.col, self.state)

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "state": self.state,
            "function": self.function,
            "access": self.access,
            "thread_root": self.thread_root,
            "message": self.message,
        }
        if self.suppressed:
            d["suppressed"] = True
        return d

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule}: "
            f"{self.message} [via {self.thread_root}]{tag}"
        )


@dataclasses.dataclass
class UnusedSuppression:
    path: str
    line: int
    rule: str

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule}


@dataclasses.dataclass
class RaceAuditReport:
    findings: List[RaceFinding]
    unused_suppressions: List[UnusedSuppression]
    shared_objects: List[str]
    locks: List[str]
    thread_roots: List[str]
    audited_functions: int
    #: rendered acquisition-order edges "outer -> inner" (deadlock pass)
    lock_edges: List[str] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> List[RaceFinding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def ok(self) -> bool:
        return not self.active and not self.unused_suppressions

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.active],
            "suppressed": [f.to_dict() for f in self.findings if f.suppressed],
            "unused_suppressions": [
                u.to_dict() for u in self.unused_suppressions
            ],
            "shared_objects": self.shared_objects,
            "locks": self.locks,
            "lock_edges": self.lock_edges,
            "thread_roots": self.thread_roots,
            "audited_functions": self.audited_functions,
        }

    def render_text(self) -> str:
        out = [f.render() for f in self.active]
        for u in self.unused_suppressions:
            out.append(
                f"{u.path}:{u.line}: unused audit suppression "
                f"[audit-ok[{u.rule}]] — no finding on this line"
            )
        n_sup = sum(1 for f in self.findings if f.suppressed)
        out.append(
            f"races: {len(self.active)} finding(s), {n_sup} suppressed, "
            f"{len(self.unused_suppressions)} stale suppression(s) — "
            f"{len(self.shared_objects)} shared object(s), "
            f"{len(self.locks)} lock(s), {len(self.lock_edges)} lock-order "
            f"edge(s), {len(self.thread_roots)} thread root(s), "
            f"{self.audited_functions} audited function(s)"
        )
        return "\n".join(out)


# ---------------------------------------------------------------------------
# shared-state / lock collection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModuleShared:
    containers: Set[str] = dataclasses.field(default_factory=set)
    scalars: Set[str] = dataclasses.field(default_factory=set)
    locks: Set[str] = dataclasses.field(default_factory=set)
    #: lock/instance-lock name -> factory ("Lock", "RLock", ...); instance
    #: locks (`self.x = threading.Lock()` in a method) key as "Class.x"
    lock_kinds: Dict[str, str] = dataclasses.field(default_factory=dict)


def _module_level_assigns(tree: ast.Module) -> Iterator[ast.Assign]:
    """Module-level Assign statements, descending through top-level
    if/try blocks (e.g. `if TYPE_CHECKING` or platform guards)."""
    stack: List[ast.AST] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Assign):
            yield node
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            # `_breakers: Dict[str, Breaker] = {}` — same binding, typed
            if isinstance(node.target, ast.Name):
                synth = ast.Assign(targets=[node.target], value=node.value)
                yield synth
        elif isinstance(node, (ast.If, ast.Try)):
            for fld in ("body", "orelse", "finalbody", "handlers"):
                for child in getattr(node, fld, []):
                    if isinstance(child, ast.ExceptHandler):
                        stack.extend(child.body)
                    else:
                        stack.append(child)


def _callee_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def collect_shared(mod: ModuleInfo) -> ModuleShared:
    out = ModuleShared()
    candidates_scalar: Set[str] = set()
    for node in _module_level_assigns(mod.tree):
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        # tuple targets: `_breakers, _lock = {}, Lock()` style
        for t in node.targets:
            if isinstance(t, ast.Tuple):
                names.extend(
                    e.id for e in t.elts if isinstance(e, ast.Name)
                )
        if not names:
            continue
        v = node.value
        if isinstance(v, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
            out.containers.update(names)
        elif isinstance(v, ast.Call):
            callee = _callee_name(v)
            if callee in _LOCK_FACTORIES:
                out.locks.update(names)
                for n in names:
                    out.lock_kinds[n] = callee
            elif callee in _CONTAINER_FACTORIES:
                out.containers.update(names)
        elif isinstance(v, ast.Constant):
            candidates_scalar.update(names)
        elif isinstance(v, ast.Tuple) and isinstance(node.targets[0], ast.Tuple):
            # `a, b = 1, {}` — classify element-wise
            tgt = node.targets[0]
            for te, ve in zip(tgt.elts, v.elts):
                if not isinstance(te, ast.Name):
                    continue
                if isinstance(ve, (ast.Dict, ast.List, ast.Set)):
                    out.containers.add(te.id)
                elif isinstance(ve, ast.Constant):
                    candidates_scalar.add(te.id)

    # a scalar is shared-mutable only if some function rebinds it via global
    globally_written: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            declared: Set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Global):
                    declared.update(sub.names)
            if declared:
                for sub in ast.walk(node):
                    if (
                        isinstance(sub, ast.Name)
                        and isinstance(sub.ctx, ast.Store)
                        and sub.id in declared
                    ):
                        globally_written.add(sub.id)
    out.scalars = candidates_scalar & globally_written

    # instance locks: `self.x = threading.Lock()` anywhere in a class body
    # registers "Class.x" — `with self.x:` in that class's methods resolves
    # to it (the AdmissionQueue/SchedulerLoop/session-pool pattern)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Assign) or not isinstance(
                sub.value, ast.Call
            ):
                continue
            callee = _callee_name(sub.value)
            if callee not in _LOCK_FACTORIES:
                continue
            for t in sub.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    out.lock_kinds[f"{node.name}.{t.attr}"] = callee
    return out


# ---------------------------------------------------------------------------
# thread roots + reachability
# ---------------------------------------------------------------------------

def _class_of(qual: str) -> str:
    return qual.rsplit(".", 1)[0] if "." in qual else ""

def _is_handler_class(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = base.attr if isinstance(base, ast.Attribute) else getattr(
            base, "id", ""
        )
        if any(h in name for h in _HANDLER_BASES):
            return True
    return False


def _context_run_target(node: ast.Call, target: ast.expr) -> ast.expr:
    """`Thread(target=contextvars.copy_context().run, args=(fn, ...))` runs
    fn on the thread (the mesh slots' per-slot threads): the root is fn."""
    if (
        isinstance(target, ast.Attribute)
        and target.attr == "run"
        and isinstance(target.value, ast.Call)
        and _callee_name(target.value) == "copy_context"
    ):
        for kw in node.keywords:
            if kw.arg == "args" and isinstance(kw.value, ast.Tuple) and kw.value.elts:
                return kw.value.elts[0]
    return target


def _thread_target_exprs(node: ast.Call) -> Tuple[List[ast.expr], str]:
    """The callable expressions a Call hands to another thread, if any."""
    callee = _callee_name(node)
    if callee == "Thread":
        return (
            [
                _context_run_target(node, kw.value)
                for kw in node.keywords if kw.arg == "target"
            ],
            "thread target",
        )
    if callee == "submit" and node.args:
        # executor.submit(fn, ...) — ThreadPoolExecutor work items run on
        # pool threads (the extender wave engine's HTTP fan-out); audit
        # the submitted callable like a Thread target
        return [node.args[0]], "executor task"
    if callee == "signal" and len(node.args) >= 2:
        return [node.args[1]], "signal handler"
    if callee == "Timer" and len(node.args) >= 2:
        return [node.args[1]], "timer thread"
    if callee == "guarded_call" and len(node.args) >= 2:
        # guarded_call(stage, fn, deadline) runs fn on a daemon watchdog
        # worker thread (durable/watchdog.py) whenever a deadline is armed
        # — every checkpoint/resume driver's device call routes through it
        return [node.args[1]], "watchdog-guarded call"
    return [], ""


#: subprocess entry points that put a child process to work while the
#: parent keeps running (the `simon chaos --capacity` kill/resume driver):
#: the wrapper coordinates with the child through the run journal and
#: environment, so it is audited like a thread root.
_SUBPROCESS_LAUNCHES = {"run", "Popen", "call", "check_call", "check_output"}


def _is_subprocess_launch(mod: ModuleInfo, node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if f.attr not in _SUBPROCESS_LAUNCHES:
            return False
        imp = mod.imports.get(f.value.id)
        return imp is not None and imp[0] == "subprocess" and imp[1] is None
    if isinstance(f, ast.Name):
        imp = mod.imports.get(f.id)
        return (
            imp is not None
            and imp[0] == "subprocess"
            and imp[1] in _SUBPROCESS_LAUNCHES
        )
    return False


def _own_body(info: FunctionInfo) -> Iterator[ast.AST]:
    """A function's own statements, nested defs excluded (those carry
    their own FunctionInfo and attribute their own calls)."""
    stack = list(ast.iter_child_nodes(info.node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _qualnames(mod: ModuleInfo) -> Dict[str, FunctionInfo]:
    return {i.qualname: i for i in mod.functions.values()}


def _class_prefixes(tree: ast.Module) -> Iterator[Tuple[ast.ClassDef, str]]:
    """Every class of a module with the qualname prefix of its methods
    (a handler class defined inside a method nests under its qualname, as
    the stub servers' do)."""
    stack: List[Tuple[ast.AST, str]] = [(tree, "")]
    while stack:
        node, prefix = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield child, f"{prefix}{child.name}"
                stack.append((child, f"{prefix}{child.name}."))
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.append((child, f"{prefix}{child.name}."))
            else:
                stack.append((child, prefix))


def thread_roots(ctx: LintContext) -> Dict[Tuple[str, str], str]:
    """(module, qualname) -> human-readable root reason."""
    roots: Dict[Tuple[str, str], str] = {}
    for mod in ctx.modules.values():
        quals = _qualnames(mod)
        # 1. request-handler methods run on server threads
        for node, cls_qual in _class_prefixes(mod.tree):
            if _is_handler_class(node):
                for info in quals.values():
                    if _class_of(info.qualname) == cls_qual:
                        roots[(mod.name, info.qualname)] = (
                            f"handler thread {mod.name}:{info.qualname}"
                        )
        # 2. module-scope resolution: plain names and module.attr targets
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            target_exprs, reason = _thread_target_exprs(node)
            for expr in target_exprs:
                resolved = ctx.resolve_call(mod, expr)
                if resolved is not None:
                    roots[resolved] = (
                        f"{reason} {resolved[0]}:{resolved[1]}"
                    )
        # 3. enclosing-scope resolution: `Thread(target=self._worker_main)`
        # inside a method roots the sibling method; `Thread(target=_worker)`
        # inside a function roots the nested def (stored under its
        # qualname, invisible to module-scope lookup)
        for info in quals.values():
            cls = _class_of(info.qualname)
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                target_exprs, reason = _thread_target_exprs(node)
                for expr in target_exprs:
                    qual = None
                    if (
                        cls
                        and isinstance(expr, ast.Attribute)
                        and isinstance(expr.value, ast.Name)
                        and expr.value.id == "self"
                        and f"{cls}.{expr.attr}" in quals
                    ):
                        qual = f"{cls}.{expr.attr}"
                    elif (
                        isinstance(expr, ast.Name)
                        and f"{info.qualname}.{expr.id}" in quals
                    ):
                        qual = f"{info.qualname}.{expr.id}"
                    if qual is not None:
                        roots[(mod.name, qual)] = (
                            f"{reason} {mod.name}:{qual}"
                        )
        # 4. subprocess wrappers: a function that launches a child process
        # keeps running concurrently with it, coordinating through the
        # journal/run-dir/env (`simon chaos --capacity` SIGKILLs the child
        # mid-chunk and resumes from its on-disk state) — audit the
        # wrapper itself like a thread root
        for info in quals.values():
            if any(
                isinstance(n, ast.Call) and _is_subprocess_launch(mod, n)
                for n in _own_body(info)
            ):
                roots[(mod.name, info.qualname)] = (
                    f"subprocess wrapper {mod.name}:{info.qualname}"
                )
    return roots


def _method_index(ctx: LintContext) -> Dict[str, List[Tuple[str, str]]]:
    """method name -> every (module, Class.method) in the package. Used to
    chase ``self.<attr>.<method>()`` hops across classes (the scheduler
    worker thread calling ``self._loop.run_forever()``): with no type
    information, a hop is followed only when the method name is unique
    package-wide — ambiguity means no resolution, never a guess."""
    index: Dict[str, List[Tuple[str, str]]] = {}
    for mod in ctx.modules.values():
        for info in _qualnames(mod).values():
            qual = info.qualname
            if "." not in qual:
                continue
            index.setdefault(qual.rsplit(".", 1)[1], []).append(
                (mod.name, qual)
            )
    return index


def _call_targets(
    ctx: LintContext, mod: ModuleInfo, cls: str, node: ast.Call,
    method_index: Optional[Dict[str, List[Tuple[str, str]]]] = None,
) -> Iterator[Tuple[str, str]]:
    """Every (module, qualname) a single Call node may enter."""
    resolved = ctx.resolve_call(mod, node.func)
    if resolved is not None:
        yield resolved
    f = node.func
    if not isinstance(f, ast.Attribute):
        return
    if isinstance(f.value, ast.Name) and f.value.id == "self":
        if cls:
            sibling = f"{cls}.{f.attr}"
            if any(i.qualname == sibling for i in mod.functions.values()):
                yield (mod.name, sibling)
    elif (
        method_index is not None
        and isinstance(f.value, ast.Attribute)
        and isinstance(f.value.value, ast.Name)
        and f.value.value.id == "self"
    ):
        # self.<attr>.<method>() — cross-class hop, unique-name only
        candidates = method_index.get(f.attr, [])
        if len(candidates) == 1:
            yield candidates[0]


def _calls_from(
    ctx: LintContext, mod: ModuleInfo, info: FunctionInfo,
    method_index: Optional[Dict[str, List[Tuple[str, str]]]] = None,
) -> Iterator[Tuple[str, str]]:
    cls = _class_of(info.qualname)
    for node in ast.walk(info.node):
        if not isinstance(node, ast.Call):
            continue
        yield from _call_targets(ctx, mod, cls, node, method_index)


def audited_functions(
    ctx: LintContext, roots: Dict[Tuple[str, str], str],
    module_hosts: bool = True,
) -> Dict[Tuple[str, str], str]:
    """Thread-reachable closure of the roots, plus (when ``module_hosts``)
    every function in a module that defines a root (main-thread code
    racing the handlers). ``module_hosts=False`` gives the strict
    reachability closure — what the ``lock-in-hot-path`` lint rule wants:
    only code that actually runs on a hot thread."""
    audited: Dict[Tuple[str, str], str] = {}
    index = _method_index(ctx)
    work = [(key, reason) for key, reason in sorted(roots.items())]
    while work:
        key, reason = work.pop()
        if key in audited:
            continue
        audited[key] = reason
        mod = ctx.modules.get(key[0])
        if mod is None:
            continue
        info = next(
            (i for i in mod.functions.values() if i.qualname == key[1]), None
        )
        if info is None:
            continue
        for tgt in _calls_from(ctx, mod, info, index):
            if tgt not in audited:
                work.append((tgt, reason))

    if not module_hosts:
        return audited
    root_modules = {m for (m, _q) in roots}
    for mod_name in root_modules:
        mod = ctx.modules[mod_name]
        for info in mod.functions.values():
            key = (mod_name, info.qualname)
            if key not in audited:
                audited[key] = f"module hosts thread roots ({mod_name})"
    return audited


# ---------------------------------------------------------------------------
# per-function access scan
# ---------------------------------------------------------------------------

def _guarded_by_decorator(info: FunctionInfo) -> Optional[str]:
    node = info.node
    for dec in getattr(node, "decorator_list", []):
        if isinstance(dec, ast.Call):
            name = _callee_name(dec)
            if name == "guarded_by" and dec.args:
                a = dec.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    return a.value
    return None


def _with_locks(node: ast.With, locks: Set[str],
                mod: ModuleInfo, ctx: LintContext) -> Set[str]:
    held: Set[str] = set()
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Name) and e.id in locks:
            held.add(e.id)
        elif isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            target = _imported_module(mod, e.value.id, ctx)
            if target is not None:
                # with othermod.lock: — trust the name, shape checked there
                held.add(f"{target}:{e.attr}")
    return held


def _imported_module(mod: ModuleInfo, local: str,
                     ctx: LintContext) -> Optional[str]:
    """Dotted module name a local name refers to: `import pkg.sub as m`
    gives (pkg.sub, None); `from pkg import sub` gives (pkg, sub) with
    pkg.sub itself a module."""
    imp = mod.imports.get(local)
    if imp is None:
        return None
    target = imp[0] if imp[1] is None else f"{imp[0]}.{imp[1]}"
    return target if target in ctx.modules else None


def _shared_ref(
    expr: ast.expr, mod: ModuleInfo, ctx: LintContext,
    shared: Dict[str, ModuleShared],
) -> Optional[Tuple[str, str]]:
    """Resolve an expression to (module, name) of a shared container."""
    if isinstance(expr, ast.Name):
        if expr.id in shared[mod.name].containers:
            return (mod.name, expr.id)
        imp = mod.imports.get(expr.id)
        if (
            imp is not None
            and imp[1] is not None
            and imp[0] in shared
            and imp[1] in shared[imp[0]].containers
        ):
            return (imp[0], imp[1])
    elif isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        target = _imported_module(mod, expr.value.id, ctx)
        if (
            target is not None
            and target in shared
            and expr.attr in shared[target].containers
        ):
            return (target, expr.attr)
    return None


def _scan_function(
    ctx: LintContext,
    mod: ModuleInfo,
    info: FunctionInfo,
    shared: Dict[str, ModuleShared],
    root_reason: str,
    findings: List[RaceFinding],
) -> None:
    my_shared = shared[mod.name]
    anno = _guarded_by_decorator(info)
    base_held: Set[str] = {anno} if anno else set()

    declared_global: Set[str] = set()
    for sub in ast.walk(info.node):
        if isinstance(sub, ast.Global):
            declared_global.update(sub.names)
    watched_scalars = declared_global & my_shared.scalars

    # (name -> [(node, kind 'r'/'w', held?)]) for scalar RMW analysis
    scalar_events: Dict[str, List[Tuple[ast.AST, str, bool]]] = {}

    def emit(node: ast.AST, state: Tuple[str, str], access: str, msg: str):
        findings.append(
            RaceFinding(
                path=mod.path,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0),
                state=f"{state[0]}.{state[1]}",
                function=f"{mod.name}:{info.qualname}",
                access=access,
                thread_root=root_reason,
                message=msg,
            )
        )

    def container_mutation(node: ast.AST, held: bool):
        # x.append(...) / x[k] = v / del x[k] / x[k] += v
        target: Optional[ast.expr] = None
        verb = ""
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATING_METHODS:
                target, verb = f.value, f".{f.attr}()"
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in tgts:
                if isinstance(t, ast.Subscript):
                    target, verb = t.value, "[...] ="
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    target, verb = t.value, "del [...]"
        if target is None:
            return
        ref = _shared_ref(target, mod, ctx, shared)
        if ref is not None and not held:
            emit(
                node, ref, "mutate",
                f"unguarded mutation `{ref[1]}{verb}` of shared "
                f"module state {ref[0]}.{ref[1]} — wrap in `with <lock>:` "
                f"or annotate the function @guarded_by(...)",
            )

    def visit(node: ast.AST, held: Set[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node is not info.node
        ):
            return  # nested def runs later, on its own audit entry
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = held | _with_locks(node, my_shared.locks, mod, ctx)
            for item in node.items:
                visit(item.context_expr, held)
            for child in node.body:
                visit(child, new)
            return
        guarded = bool(held)
        container_mutation(node, guarded)
        if isinstance(node, ast.Name) and node.id in watched_scalars:
            kind = "w" if isinstance(node.ctx, ast.Store) else "r"
            scalar_events.setdefault(node.id, []).append(
                (node, kind, guarded)
            )
        if isinstance(node, ast.AugAssign) and isinstance(
            node.target, ast.Name
        ) and node.target.id in watched_scalars:
            # AugAssign's target Name has Store ctx; record the read half too
            scalar_events.setdefault(node.target.id, []).append(
                (node, "r", guarded)
            )
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in info.node.body:  # type: ignore[attr-defined]
        visit(stmt, set(base_held))

    for name, events in sorted(scalar_events.items()):
        reads = [e for e in events if e[1] == "r"]
        writes = [e for e in events if e[1] == "w"]
        if not writes or not reads:
            continue  # pure publish or pure read: atomic under the GIL
        unguarded = [e for e in events if not e[2]]
        if not unguarded:
            continue
        node = writes[0][0]
        access = (
            "rmw"
            if any(isinstance(e[0], ast.AugAssign) for e in events)
            else "check-then-act"
        )
        emit(
            node, (mod.name, name), access,
            f"read-modify-write of shared scalar {mod.name}.{name} with "
            f"{len(unguarded)} unguarded access(es) — a concurrent thread "
            f"can interleave between the read and the write",
        )


# ---------------------------------------------------------------------------
# lock-order deadlock pass
# ---------------------------------------------------------------------------
#
# Two thread roots acquiring the same locks in opposite orders deadlock the
# process; so does blocking forever (join()/Queue.get() with no timeout)
# while holding a lock another thread needs. Both are order properties the
# race pass above cannot see. This pass:
#
#   1. resolves every `with <lock>:` in the audited (thread-reachable)
#      functions to a canonical lock identity — module-level locks
#      ("mod:name", including `with othermod.lock:`) and instance locks
#      ("mod:Class.attr" from `self.x = threading.Lock()`);
#   2. computes each function's may-acquire set (direct + transitive
#      callees, interprocedural fixpoint over the same call graph the race
#      pass walks);
#   3. builds the lock-acquisition graph: edge L1 -> L2 when L2 is acquired
#      (directly or via a callee) while L1 is held;
#   4. reports every cycle (Tarjan SCC; self-edges only for non-reentrant
#      plain Locks) and every no-timeout blocking call made under a lock.
#
# An ``osim: audit-ok[deadlock]`` comment on the flagged line suppresses a
# finding, with the same staleness cross-check as the race rule.

@dataclasses.dataclass
class _LockUse:
    """One audited function's lock behavior."""
    acquires: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    orders: List[Tuple[str, str, ast.AST]] = dataclasses.field(
        default_factory=list
    )
    calls_holding: List[Tuple[Tuple[str, ...], Tuple[str, str], ast.AST]] = (
        dataclasses.field(default_factory=list)
    )
    blocking: List[Tuple[Tuple[str, ...], str, ast.AST]] = dataclasses.field(
        default_factory=list
    )
    calls: Set[Tuple[str, str]] = dataclasses.field(default_factory=set)


def _resolve_lock(
    expr: ast.expr, mod: ModuleInfo, cls: str, ctx: LintContext,
    shared: Dict[str, ModuleShared],
) -> Optional[str]:
    """Canonical lock id for a `with` context expression, if it is one."""
    my = shared[mod.name]
    if isinstance(expr, ast.Name) and expr.id in my.locks:
        return f"{mod.name}:{expr.id}"
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        if expr.value.id == "self" and cls:
            if f"{cls}.{expr.attr}" in my.lock_kinds:
                return f"{mod.name}:{cls}.{expr.attr}"
            return None
        target = _imported_module(mod, expr.value.id, ctx)
        if (
            target is not None
            and target in shared
            and expr.attr in shared[target].locks
        ):
            return f"{target}:{expr.attr}"
    return None


def _blocking_verb(node: ast.Call) -> Optional[str]:
    """'.join()' / '.get()' when the call can block forever.

    Zero-positional-arg is the discriminator: `thread.join()` and
    `queue.get()` block indefinitely, while `",".join(parts)` and
    `d.get(key)` always carry a positional argument. A timeout= (or
    block=False) keyword makes either bounded.
    """
    f = node.func
    if not isinstance(f, ast.Attribute) or f.attr not in ("join", "get"):
        return None
    if node.args:
        return None
    kwargs = {kw.arg for kw in node.keywords}
    if "timeout" in kwargs or "block" in kwargs:
        return None
    return f".{f.attr}()"


def _lock_use(
    ctx: LintContext, mod: ModuleInfo, info: FunctionInfo,
    shared: Dict[str, ModuleShared],
    method_index: Dict[str, List[Tuple[str, str]]],
) -> _LockUse:
    use = _LockUse()
    cls = _class_of(info.qualname)
    anno = _guarded_by_decorator(info)
    base_held: Tuple[str, ...] = (
        (f"{mod.name}:{anno}",) if anno else ()
    )

    def visit(node: ast.AST, held: Tuple[str, ...]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node is not info.node
        ):
            return  # nested defs are separate audit entries
        if isinstance(node, (ast.With, ast.AsyncWith)):
            taken: List[str] = []
            for item in node.items:
                visit(item.context_expr, held)
                lock = _resolve_lock(
                    item.context_expr, mod, cls, ctx, shared
                )
                if lock is not None:
                    use.acquires.setdefault(lock, node)
                    for h in held + tuple(taken):
                        use.orders.append((h, lock, node))
                    taken.append(lock)
            new = held + tuple(t for t in taken if t not in held)
            for child in node.body:
                visit(child, new)
            return
        if isinstance(node, ast.Call):
            if held:
                verb = _blocking_verb(node)
                if verb is not None:
                    use.blocking.append((held, verb, node))
            for tgt in _call_targets(ctx, mod, cls, node, method_index):
                use.calls.add(tgt)
                if held:
                    use.calls_holding.append((held, tgt, node))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in info.node.body:  # type: ignore[attr-defined]
        visit(stmt, base_held)
    return use


def _lock_kind(lock: str, shared: Dict[str, ModuleShared]) -> str:
    mod_name, _, name = lock.partition(":")
    s = shared.get(mod_name)
    return s.lock_kinds.get(name, "") if s else ""


def deadlock_pass(
    ctx: LintContext,
    shared: Dict[str, ModuleShared],
    audited: Dict[Tuple[str, str], str],
) -> Tuple[List[RaceFinding], List[str]]:
    """-> (findings, rendered lock-graph edges)."""
    method_index = _method_index(ctx)
    uses: Dict[Tuple[str, str], _LockUse] = {}
    infos: Dict[Tuple[str, str], Tuple[ModuleInfo, FunctionInfo]] = {}
    for key in audited:
        mod = ctx.modules.get(key[0])
        if mod is None:
            continue
        info = next(
            (i for i in mod.functions.values() if i.qualname == key[1]), None
        )
        if info is None:
            continue
        infos[key] = (mod, info)
        uses[key] = _lock_use(ctx, mod, info, shared, method_index)

    # interprocedural may-acquire fixpoint (call graph is small; iterate)
    may_acquire: Dict[Tuple[str, str], Set[str]] = {
        k: set(u.acquires) for k, u in uses.items()
    }
    changed = True
    while changed:
        changed = False
        for k, u in uses.items():
            for tgt in u.calls:
                extra = may_acquire.get(tgt, set()) - may_acquire[k]
                if extra:
                    may_acquire[k].update(extra)
                    changed = True

    # acquisition edges: (outer, inner) -> (mod, site node, function key)
    edges: Dict[Tuple[str, str], Tuple[ModuleInfo, ast.AST, Tuple[str, str]]]
    edges = {}
    for k, u in uses.items():
        mod = infos[k][0]
        for outer, inner, site in u.orders:
            edges.setdefault((outer, inner), (mod, site, k))
        for held, tgt, site in u.calls_holding:
            for inner in may_acquire.get(tgt, ()):
                for outer in held:
                    edges.setdefault((outer, inner), (mod, site, k))

    findings: List[RaceFinding] = []

    def emit(key: Tuple[str, str], site: ast.AST, mod: ModuleInfo,
             state: str, access: str, msg: str):
        findings.append(
            RaceFinding(
                path=mod.path,
                line=getattr(site, "lineno", 0),
                col=getattr(site, "col_offset", 0),
                state=state,
                function=f"{key[0]}:{key[1]}",
                access=access,
                thread_root=audited.get(key, "?"),
                message=msg,
                rule=RULE_DEADLOCK,
            )
        )

    # self-edges: re-acquiring a non-reentrant Lock you already hold
    # deadlocks immediately; RLock/Semaphore/Condition re-entry does not
    for (outer, inner), (mod, site, key) in sorted(
        edges.items(), key=lambda e: (e[0], e[1][0].path)
    ):
        if outer == inner and _lock_kind(outer, shared) == "Lock":
            emit(
                key, site, mod, outer, "lock-order",
                f"non-reentrant lock {outer} re-acquired while already "
                f"held — self-deadlock",
            )

    # cycles across distinct locks: Tarjan SCC over the acquisition graph
    adj: Dict[str, List[str]] = {}
    for outer, inner in edges:
        if outer != inner:
            adj.setdefault(outer, []).append(inner)
            adj.setdefault(inner, [])
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str):
        # iterative Tarjan (the lock graph is tiny, but no recursion limits)
        work = [(v, iter(adj.get(v, ())))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if on_stack.get(w):
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    for comp in sccs:
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        cycle_edges = sorted(
            (o, i) for (o, i) in edges
            if o in comp_set and i in comp_set and o != i
        )
        mod, site, key = edges[cycle_edges[0]]
        order = " -> ".join(sorted(comp_set) + [sorted(comp_set)[0]])
        emit(
            key, site, mod, ",".join(sorted(comp_set)), "lock-order",
            f"lock-order cycle {order}: threads acquiring these locks in "
            f"different orders can deadlock; establish one global order "
            f"(edges: "
            + "; ".join(f"{o} then {i}" for o, i in cycle_edges)
            + ")",
        )

    # blocking calls under a lock
    for k, u in uses.items():
        mod = infos[k][0]
        for held, verb, site in u.blocking:
            emit(
                k, site, mod, ",".join(sorted(held)), "blocking",
                f"unbounded blocking call `{verb}` while holding "
                f"{', '.join(sorted(held))} — any thread needing the lock "
                f"waits forever if the peer never finishes; pass a timeout "
                f"or move the wait outside the lock",
            )

    rendered = sorted(f"{o} -> {i}" for (o, i) in edges if o != i)
    return findings, rendered


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _audit_suppressions(mod: ModuleInfo) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(mod.lines, start=1):
        m = AUDIT_SUPPRESS_RE.search(line)
        if m:
            out[i] = {p.strip() for p in m.group(1).split(",")}
    return out


def run_races(
    package_root: Optional[str] = None,
    report_root: Optional[str] = None,
    ctx: Optional[LintContext] = None,
) -> RaceAuditReport:
    if ctx is None:
        ctx = build_context(package_root, report_root)

    shared = {m.name: collect_shared(m) for m in ctx.modules.values()}
    roots = thread_roots(ctx)
    audited = audited_functions(ctx, roots)

    findings: List[RaceFinding] = []
    for (mod_name, qual), reason in sorted(audited.items()):
        mod = ctx.modules[mod_name]
        info = next(
            (i for i in mod.functions.values() if i.qualname == qual), None
        )
        if info is not None:
            _scan_function(ctx, mod, info, shared, reason, findings)

    deadlock_findings, lock_edges = deadlock_pass(ctx, shared, audited)
    findings.extend(deadlock_findings)

    # dedupe (a function reachable from several roots scans once per (line,
    # state) anyway; reachability map already collapses roots)
    uniq: Dict[Tuple, RaceFinding] = {}
    for f in findings:
        uniq.setdefault((f.path, f.line, f.col, f.state, f.access), f)
    findings = sorted(uniq.values(), key=RaceFinding.sort_key)

    # apply + cross-check audit-ok suppressions (per rule: an audit-ok for
    # one rule never silences the other)
    used: Set[Tuple[str, int, str]] = set()
    sup_by_mod = {m.name: _audit_suppressions(m) for m in ctx.modules.values()}
    path_to_mod = {m.path: m.name for m in ctx.modules.values()}
    for f in findings:
        mod_name = path_to_mod.get(f.path)
        if mod_name is None:
            continue
        sup = sup_by_mod[mod_name].get(f.line, set())
        if f.rule in sup:
            f.suppressed = True
            used.add((f.path, f.line, f.rule))

    unused: List[UnusedSuppression] = []
    for mod in ctx.modules.values():
        for line, rules in sorted(sup_by_mod[mod.name].items()):
            for r in sorted(rules):
                if r not in KNOWN_RULES or (mod.path, line, r) not in used:
                    unused.append(UnusedSuppression(mod.path, line, r))

    shared_objects = sorted(
        f"{name}.{obj}"
        for name, s in shared.items()
        for obj in (s.containers | s.scalars)
    )
    locks = sorted(
        f"{name}.{lk}" for name, s in shared.items() for lk in s.locks
    )
    return RaceAuditReport(
        findings=findings,
        unused_suppressions=unused,
        shared_objects=shared_objects,
        locks=locks,
        thread_roots=sorted(set(roots.values())),
        audited_functions=len(audited),
        lock_edges=lock_edges,
    )


def report_json(report: RaceAuditReport) -> str:
    return json.dumps(report.to_dict(), indent=2, sort_keys=True)
