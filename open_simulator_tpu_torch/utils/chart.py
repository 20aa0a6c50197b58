"""Built-in Helm chart rendering.

Parity target: upstream `pkg/chart/chart.go` (ProcessChart →
load → installable check → render values {Chart, Release{Name=chart name,
Namespace=default, Revision=1, Service=Helm}, Values} → engine.Render → strip
NOTES.txt → SortManifests by InstallOrder). The reference links Helm v3 as a
library (`vendor/helm.sh/helm/v3/pkg/engine`); this is a from-scratch
renderer for the Go-template language as Kubernetes application charts use
it:

  - {{ .path.to.value }} / {{ $.rooted.path }} lookups with `-` trim markers
  - variables: {{ $x := expr }}, {{ $x = expr }}, {{ range $i, $v := ... }}
  - named templates: define / include / template / block — the full
    `helm create` scaffold (`_helpers.tpl`) renders natively
  - pipelines with parenthesized sub-expressions and the sprig/helm helpers
    charts actually call (printf, required, ternary, toJson, b64enc, hasKey,
    contains, trunc, trimSuffix, replace, index, dict/list, tpl, ...)
  - block actions: if / else if / else / end, range (lists, dicts in sorted
    key order, ints), with / end — nested arbitrarily
  - literals: "str", 'str', `str`, ints, floats, true/false/nil

Charts may be directories or .tgz archives; dependency charts under charts/
render recursively with subchart-scoped values (values.<name> overlaid onto
the subchart's own values, plus shared .Values.global). Named templates share
one namespace across the chart tree, parent definitions overriding subchart
ones (Helm override semantics). Nondeterministic helpers (randAlphaNum,
uuidv4, now) are intentionally unsupported — rendering is a pure function.
Templates using constructs outside this subset raise ChartError with the
offending action — the apply layer degrades that app to a render failure.
"""

from __future__ import annotations

import base64
import hashlib
import json
import math
import os
import posixpath
import re
import tarfile
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml

NOTES_SUFFIX = "NOTES.txt"

INSTALL_ORDER = [
    "Namespace", "NetworkPolicy", "ResourceQuota", "LimitRange",
    "PodSecurityPolicy", "PodDisruptionBudget", "ServiceAccount", "Secret",
    "SecretList", "ConfigMap", "StorageClass", "PersistentVolume",
    "PersistentVolumeClaim", "CustomResourceDefinition", "ClusterRole",
    "ClusterRoleList", "ClusterRoleBinding", "ClusterRoleBindingList",
    "Role", "RoleList", "RoleBinding", "RoleBindingList", "Service",
    "DaemonSet", "Pod", "ReplicationController", "ReplicaSet", "Deployment",
    "HorizontalPodAutoscaler", "StatefulSet", "Job", "CronJob",
    "IngressClass", "Ingress", "APIService",
]
_ORDER_INDEX = {k: i for i, k in enumerate(INSTALL_ORDER)}


class ChartError(Exception):
    pass


@dataclass
class Chart:
    name: str
    metadata: Dict[str, Any]
    values: Dict[str, Any]
    templates: Dict[str, str]            # relative path -> text
    dependencies: List["Chart"] = field(default_factory=list)
    # non-template chart files (.Files): relative path -> bytes. Helm
    # excludes templates/, charts/, Chart.yaml and values.yaml.
    files: Dict[str, bytes] = field(default_factory=dict)


def load_chart(path: str) -> Chart:
    """Load a chart from a directory or a .tgz archive. Everything is read
    into memory; extracted archives are removed before returning."""
    if os.path.isfile(path) and (path.endswith(".tgz") or path.endswith(".tar.gz")):
        tmp = tempfile.mkdtemp(prefix="osim-chart-")
        try:
            with tarfile.open(path, "r:gz") as tf:
                # "data" filter rejects traversal, link escapes, devices
                tf.extractall(tmp, filter="data")
            entries = [
                e for e in os.listdir(tmp) if os.path.isdir(os.path.join(tmp, e))
            ]
            if len(entries) != 1:
                raise ChartError(
                    f"chart archive must contain one root dir, got {entries}"
                )
            return _load_chart_dir(os.path.join(tmp, entries[0]))
        except (tarfile.TarError, OSError, UnicodeDecodeError, yaml.YAMLError) as e:
            raise ChartError(f"unreadable chart archive {path}: {e}")
        except TypeError as e:
            # tarfile's filter= kwarg is missing on old Python patch releases
            if "filter" in str(e):
                raise ChartError(f"tarfile filter unsupported: {e}")
            raise
        finally:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    try:
        return _load_chart_dir(path)
    except (OSError, UnicodeDecodeError, yaml.YAMLError) as e:
        # surface as ChartError so the apply layer records a per-app failure
        raise ChartError(f"unreadable chart {path}: {e}")


def _load_helmignore(path: str):
    """Parse .helmignore (gitignore-like: comments, blank lines, trailing
    '/' for directories, '!' negation; patterns without '/' match basenames
    at any depth). Returns [(regex, negate, dir_only)]."""
    rules = []
    p = os.path.join(path, ".helmignore")
    if not os.path.exists(p):
        return rules
    with open(p) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            negate = line.startswith("!")
            if negate:
                line = line[1:]
            dir_only = line.endswith("/")
            line = line.rstrip("/")
            if not line:
                continue
            if "/" in line:
                rx = _glob_regex(line.lstrip("/"))
            else:
                # basename pattern: match at any depth
                rx = re.compile(
                    "^(?:.*/)?" + _glob_regex(line).pattern[1:]
                )
            rules.append((rx, negate, dir_only))
    return rules


def _helmignored(rel: str, rules, is_dir: bool) -> bool:
    ignored = False
    for rx, negate, dir_only in rules:
        if dir_only and not is_dir:
            continue
        if rx.match(rel):
            ignored = not negate
    return ignored


def _load_chart_dir(path: str) -> Chart:
    if not os.path.isdir(path):
        raise ChartError(f"chart path not found: {path}")

    meta_path = os.path.join(path, "Chart.yaml")
    if not os.path.exists(meta_path):
        raise ChartError(f"{path}: Chart.yaml not found")
    with open(meta_path) as fh:
        metadata = yaml.safe_load(fh) or {}
    ctype = metadata.get("type", "")
    if ctype not in ("", "application", None):
        # checkIfInstallable parity (chart.go:45-51)
        raise ChartError(f"{ctype} charts are not installable")

    values: Dict[str, Any] = {}
    vals_path = os.path.join(path, "values.yaml")
    if os.path.exists(vals_path):
        with open(vals_path) as fh:
            values = yaml.safe_load(fh) or {}

    templates: Dict[str, str] = {}
    tdir = os.path.join(path, "templates")
    if os.path.isdir(tdir):
        for root, _, files in os.walk(tdir):
            for f in sorted(files):
                full = os.path.join(root, f)
                rel = os.path.relpath(full, path)
                with open(full) as fh:
                    templates[rel] = fh.read()

    deps: List[Chart] = []
    cdir = os.path.join(path, "charts")
    if os.path.isdir(cdir):
        for entry in sorted(os.listdir(cdir)):
            sub = os.path.join(cdir, entry)
            if os.path.isdir(sub) or entry.endswith(".tgz"):
                deps.append(load_chart(sub))

    # .Files: everything but templates/, charts/, the chart metadata, and
    # whatever .helmignore excludes (Helm's loader filters those before the
    # engine ever sees them)
    ignore = _load_helmignore(path)
    files: Dict[str, bytes] = {}
    for root, dirs, names in os.walk(path):
        rel_root = os.path.relpath(root, path)
        if rel_root == ".":
            dirs[:] = [d for d in dirs if d not in ("templates", "charts")]
        dirs[:] = [
            d
            for d in dirs
            if not _helmignored(
                os.path.normpath(os.path.join(rel_root, d)).replace(os.sep, "/"),
                ignore, is_dir=True,
            )
        ]
        for f in sorted(names):
            rel = os.path.normpath(os.path.join(rel_root, f)).replace(os.sep, "/")
            if rel in ("Chart.yaml", "values.yaml", "Chart.lock",
                       ".helmignore"):
                continue
            if _helmignored(rel, ignore, is_dir=False):
                continue
            with open(os.path.join(root, f), "rb") as fh:
                files[rel] = fh.read()

    name = metadata.get("name") or os.path.basename(path.rstrip("/"))
    return Chart(
        name=name, metadata=metadata, values=values, templates=templates,
        dependencies=deps, files=files,
    )


# ---------------------------------------------------------------------------
# The template engine (Go text/template + the sprig subset Helm charts use)
# ---------------------------------------------------------------------------

# Quote-aware action lexer: a `}}` inside a string literal does not end the
# action (Go's lexer behaves the same), so {{ tpl "{{ .x }}" . }} parses.
# Comments are matched as an unparsed unit first — an apostrophe inside
# {{/* don't */}} is not an open quote.
_ACTION_RE = re.compile(
    r"\{\{(-?)\s*("
    r"/\*.*?\*/"
    r"|(?:[^\"'`}]|\"(?:[^\"\\]|\\.)*\"|'(?:[^'\\]|\\.)*'|`[^`]*`|\}(?!\}))*?"
    r")\s*(-?)\}\}",
    re.DOTALL,
)


@dataclass
class _Node:
    kind: str                 # text | action | if | range | with | define | block
    text: str = ""
    expr: str = ""
    body: list = field(default_factory=list)
    elifs: list = field(default_factory=list)   # [(expr, body), ...]
    else_body: Optional[list] = None


def _tokenize_with_positions(src: str):
    """[(kind, payload)]: kind 'text' or 'action'. Trim markers apply to
    adjacent text the way Go templates do ('{{-' eats preceding whitespace,
    '-}}' eats following whitespace)."""
    tokens: List[Tuple[str, str]] = []
    pos = 0
    pending_trim = False
    for m in _ACTION_RE.finditer(src):
        text = src[pos : m.start()]
        if pending_trim:
            text = text.lstrip(" \t\n\r")
        if m.group(1) == "-":
            text = text.rstrip(" \t\n\r")
        tokens.append(("text", text))
        tokens.append(("action", m.group(2)))
        pending_trim = m.group(3) == "-"
        pos = m.end()
    tail = src[pos:]
    if pending_trim:
        tail = tail.lstrip(" \t\n\r")
    tokens.append(("text", tail))
    return tokens


def _stop_word(payload: str) -> str:
    parts = payload.split(None, 1)
    return parts[0] if parts else ""


def _parse(tokens, i=0, stop=()):
    """Recursive-descent parse into a node list; returns (nodes, next_index,
    stop_payload). A block body that runs out of tokens before its terminator
    raises ChartError; a stray end/else at the top level does too."""
    nodes: List[_Node] = []
    while i < len(tokens):
        kind, payload = tokens[i]
        if kind == "text":
            if payload:
                nodes.append(_Node("text", text=payload))
            i += 1
            continue
        word = _stop_word(payload)
        if word in stop:
            return nodes, i, payload

        def block_body(j, allow_else=True):
            terms = ("end", "else") if allow_else else ("end",)
            body, j2, stop_payload = _parse(tokens, j, stop=terms)
            if not stop_payload:
                raise ChartError("unterminated block action (missing {{ end }})")
            return body, j2, stop_payload

        if word == "if":
            expr = payload[2:].strip()
            body, i, stop_payload = block_body(i + 1)
            node = _Node("if", expr=expr, body=body)
            while _stop_word(stop_payload) == "else":
                rest = stop_payload[4:].strip()
                if rest.startswith("if "):
                    sub_body, i, stop_payload = block_body(i + 1)
                    node.elifs.append((rest[3:].strip(), sub_body))
                else:
                    node.else_body, i, stop_payload = block_body(
                        i + 1, allow_else=False
                    )
                    break
            nodes.append(node)
            i += 1  # past 'end'
        elif word in ("range", "with"):
            expr = payload[len(word):].strip()
            body, i, stop_payload = block_body(i + 1)
            node = _Node(word, expr=expr, body=body)
            if _stop_word(stop_payload) == "else":
                node.else_body, i, _ = block_body(i + 1, allow_else=False)
            nodes.append(node)
            i += 1
        elif word in ("define", "block"):
            expr = payload[len(word):].strip()
            body, i, _ = block_body(i + 1, allow_else=False)
            nodes.append(_Node(word, expr=expr, body=body))
            i += 1
        elif word in ("end", "else"):
            raise ChartError(f"unexpected {{{{ {word} }}}} outside a block")
        else:
            nodes.append(_Node("action", expr=payload))
            i += 1
    return nodes, i, ""


_STR_LIT = re.compile(r'^"((?:[^"\\]|\\.)*)"$|' r"^'((?:[^'\\]|\\.)*)'$|^`([^`]*)`$")

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "'": "'", "\\": "\\", "0": "\0"}


def _unescape(s: str) -> str:
    """Go string-literal escapes, unicode-safe (a bytes/unicode_escape round
    trip would mangle non-ASCII source characters)."""
    return re.sub(r"\\(.)", lambda m: _ESCAPES.get(m.group(1), m.group(1)), s)


def _literal_string(tok: str) -> str:
    m = _STR_LIT.match(tok.strip())
    if not m:
        raise ChartError(f"expected a string literal, got {tok!r}")
    s = next(g for g in m.groups() if g is not None)
    return s if tok.strip().startswith("`") else _unescape(s)


_EXPR_TOK = re.compile(
    r'"(?:[^"\\]|\\.)*"'      # double-quoted string
    r"|'(?:[^'\\]|\\.)*'"     # single-quoted string
    r"|`[^`]*`"               # raw string
    r"|[()|]"                 # parens, pipe
    r"|[^\s()|]+"             # atom (path, variable, number, ident)
)


def _tokenize_expr(expr: str) -> List[str]:
    return _EXPR_TOK.findall(expr)


class _Scope:
    """Template variable scope chain. `dollar` is Go's `$`: the dot the
    current template execution started with (not the innermost block's)."""

    __slots__ = ("vars", "parent", "dollar")

    def __init__(self, parent: Optional["_Scope"] = None, dollar: Any = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent
        self.dollar = parent.dollar if (parent is not None and dollar is None) else dollar

    def lookup(self, name: str) -> Any:
        s: Optional[_Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise ChartError(f"undefined variable ${name}")

    def declare(self, name: str, val: Any) -> None:
        self.vars[name] = val

    def assign(self, name: str, val: Any) -> None:
        s: Optional[_Scope] = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = val
                return
            s = s.parent
        raise ChartError(f"assignment to undeclared variable ${name}")


_NOPIPE = object()       # sentinel: no piped-in value yet
_MAX_TEMPLATE_DEPTH = 60    # nested include/template invocations; far past any
                            # real chart, and low enough that the guard fires
                            # before Python's own interpreter recursion limit


_VAR_DECL_RE = re.compile(r"^\$([A-Za-z_]\w*)\s*(:=|=)\s*(.+)$", re.DOTALL)
_RANGE_DECL_RE = re.compile(
    r"^(\$[A-Za-z_]\w*)\s*(?:,\s*(\$[A-Za-z_]\w*)\s*)?:=\s*(.+)$", re.DOTALL
)


class _Renderer:
    def __init__(self, templates: Optional[Dict[str, List[_Node]]] = None):
        self.templates: Dict[str, List[_Node]] = templates if templates is not None else {}
        self.depth = 0

    # -- value lookup -------------------------------------------------------
    def _navigate(self, cur: Any, parts: List[str]) -> Any:
        for part in parts:
            if not part:
                continue
            if isinstance(cur, dict):
                cur = cur.get(part)
            else:
                # Attribute access is restricted to the template-safe method
                # surface (e.g. APIVersions.Has) — field access on a scalar is
                # an error in Go templates, and an open getattr would leak
                # Python internals ({{ .Values.x.__class__ }}) into manifests.
                safe = getattr(type(cur), "__template_safe__", ())
                if part in safe:
                    cur = getattr(cur, part)
                else:
                    raise ChartError(
                        f"cannot access field {part!r} on "
                        f"{_go_kind(cur)} value"
                    )
            if cur is None:
                return None
        return cur

    def _lookup(self, path: str, dot: Any, scope: _Scope) -> Any:
        if path.startswith("$"):
            rest = path[1:]
            if rest == "" or rest == ".":
                return scope.dollar
            if rest.startswith("."):
                return self._navigate(scope.dollar, rest.strip(".").split("."))
            # $name or $name.a.b
            name, _, tail = rest.partition(".")
            base = scope.lookup(name)
            return self._navigate(base, tail.split(".")) if tail else base
        if path in (".",):
            return dot
        return self._navigate(dot, path.strip(".").split("."))

    def _atom(self, tok: str, dot: Any, scope: _Scope) -> Any:
        m = _STR_LIT.match(tok)
        if m:
            s = next(g for g in m.groups() if g is not None)
            if tok.startswith("`"):
                return s  # raw string: no escapes
            return _unescape(s)
        if tok == "true":
            return True
        if tok == "false":
            return False
        if tok in ("nil", "null"):
            return None
        if re.fullmatch(r"[+-]?\d+", tok):
            return int(tok)
        if re.fullmatch(r"[+-]?\d*\.\d+", tok):
            return float(tok)
        if tok.startswith(".") or tok.startswith("$"):
            return self._lookup(tok, dot, scope)
        raise ChartError(f"unsupported template expression: {tok!r}")

    # -- pipeline evaluation ------------------------------------------------
    def _eval(self, expr: str, dot: Any, scope: _Scope) -> Any:
        toks = _tokenize_expr(expr)
        val, pos = self._pipeline(toks, 0, dot, scope)
        if pos != len(toks):
            raise ChartError(f"trailing tokens in expression: {expr!r}")
        return val

    def _pipeline(self, toks: List[str], i: int, dot: Any, scope: _Scope):
        value: Any = _NOPIPE
        while True:
            value, i = self._command(toks, i, dot, scope, piped=value)
            if i < len(toks) and toks[i] == "|":
                i += 1
                continue
            break
        return value, i

    def _command(self, toks: List[str], i: int, dot: Any, scope: _Scope, piped: Any):
        parts: List[Tuple[str, Any]] = []   # ("tok", str) | ("val", value)
        while i < len(toks) and toks[i] not in ("|", ")"):
            if toks[i] == "(":
                v, i = self._pipeline(toks, i + 1, dot, scope)
                if i >= len(toks) or toks[i] != ")":
                    raise ChartError("unbalanced parentheses in expression")
                i += 1
                parts.append(("val", v))
            else:
                parts.append(("tok", toks[i]))
                i += 1
        if not parts:
            if piped is not _NOPIPE:
                return piped, i
            raise ChartError("empty command in pipeline")

        def resolve(part: Tuple[str, Any]) -> Any:
            return part[1] if part[0] == "val" else self._atom(part[1], dot, scope)

        kind, head = parts[0]
        is_fn = (
            kind == "tok"
            and not head.startswith((".", "$"))
            and not _STR_LIT.match(head)
            and head not in ("true", "false", "nil", "null")
            and not re.fullmatch(r"[+-]?\d+(\.\d+)?", head)
        )
        if is_fn:
            args = [resolve(p) for p in parts[1:]]
            if piped is not _NOPIPE:
                args.append(piped)
            return self._call(head, args, dot, scope), i
        def finish(value: Any) -> Any:
            """Resolve a terminal command value: Go auto-invokes niladic
            methods, and a piped-in value becomes the method's argument
            (`"f.txt" | .Files.Get`). Piping into a non-callable errors."""
            if callable(value):
                try:
                    return value(piped) if piped is not _NOPIPE else value()
                except TypeError as e:
                    raise ChartError(f"template method call failed: {e}")
            if piped is not _NOPIPE:
                raise ChartError(f"cannot pipe into non-function {head!r}")
            return value

        if len(parts) > 1:
            # method invocation: .Capabilities.APIVersions.Has "apps/v1"
            target = resolve(parts[0])
            if callable(target):
                args = [resolve(p) for p in parts[1:]]
                if piped is not _NOPIPE:
                    args.append(piped)
                return target(*args), i
            if (
                parts[0][0] == "val"   # ONLY a parenthesized result — a
                                       # plain `.a .b` stays an error like Go
                and len(parts) == 2
                and parts[1][0] == "tok"
                and parts[1][1].startswith(".")
            ):
                # field/method access on a parenthesized result:
                # (.Files.Glob "x").AsConfig
                return finish(
                    self._navigate(target, parts[1][1].strip(".").split("."))
                ), i
            raise ChartError(
                f"unsupported template expression: {' '.join(str(p[1]) for p in parts)!r}"
            )
        return finish(resolve(parts[0])), i

    # -- named templates ----------------------------------------------------
    def exec_template(self, name: str, dot: Any) -> str:
        nodes = self.templates.get(name)
        if nodes is None:
            raise ChartError(f"template {name!r} not defined")
        if self.depth >= _MAX_TEMPLATE_DEPTH:
            raise ChartError(f"template recursion too deep at {name!r}")
        self.depth += 1
        try:
            # fresh scope: `$` inside a template is the dot it was called with
            return self.render_nodes(nodes, dot, _Scope(dollar=dot))
        finally:
            self.depth -= 1

    # -- function library ---------------------------------------------------
    def _call(self, fn: str, args: List[Any], dot: Any, scope: _Scope) -> Any:
        if fn == "default":
            # default DEFAULT VALUE: VALUE if truthy else DEFAULT
            if len(args) != 2:
                raise ChartError("default expects 2 arguments")
            return args[1] if _truthy(args[1]) else args[0]
        if fn == "quote":
            return " ".join(
                '"' + _to_string(a).replace("\\", "\\\\").replace('"', '\\"') + '"'
                for a in args
            )
        if fn == "squote":
            return " ".join("'" + _to_string(a) + "'" for a in args)
        if fn == "upper":
            return _to_string(args[0]).upper()
        if fn == "lower":
            return _to_string(args[0]).lower()
        if fn == "title":
            return re.sub(
                r"\b\w", lambda m: m.group(0).upper(), _to_string(args[0])
            )
        if fn == "trim":
            return _to_string(args[0]).strip()
        if fn == "trimAll":
            return _to_string(args[1]).strip(_to_string(args[0]))
        if fn == "int" or fn == "int64":
            try:
                return int(float(args[0]))
            except (TypeError, ValueError):
                return 0
        if fn == "float64":
            try:
                return float(args[0])
            except (TypeError, ValueError):
                return 0.0
        if fn == "toString":
            return _to_string(args[0])
        if fn == "toYaml":
            return yaml.safe_dump(args[0], default_flow_style=False).rstrip("\n")
        if fn == "fromYaml":
            try:
                return yaml.safe_load(_to_string(args[0])) or {}
            except yaml.YAMLError:
                return {}
        if fn == "toJson":
            return json.dumps(args[0], separators=(",", ":"))
        if fn == "fromJson":
            try:
                return json.loads(_to_string(args[0]))
            except (ValueError, TypeError):
                return {}
        if fn == "indent" or fn == "nindent":
            n, s = int(args[0]), _to_string(args[1])
            pad = " " * n
            body = "\n".join(pad + line for line in s.split("\n"))
            return ("\n" + body) if fn == "nindent" else body
        if fn == "not":
            return not _truthy(args[0])
        if fn in ("eq", "ne", "lt", "le", "gt", "ge"):
            # Go text/template basicKind semantics (funcs.go): nil and
            # non-basic values (maps, slices) have no comparison kind —
            # "invalid type for comparison"; mismatched kinds (int vs
            # string, int vs float) are "incompatible types for
            # comparison"; ordering additionally rejects bools. None of
            # these silently compare false the way loose Python would.
            a = args[0]
            k1 = _basic_kind(a)
            if k1 is None:
                raise ChartError(f"{fn}: invalid type for comparison")
            if fn == "eq":
                # Go's eq loop short-circuits: it returns true at the first
                # matching pair WITHOUT inspecting later args' kinds
                # (funcs.go eq) — `eq 1 1 "x"` is true, `eq 1 "x" 1` errors
                for b in args[1:]:
                    k2 = _basic_kind(b)
                    if k2 is None:
                        raise ChartError(
                            f"{fn}: invalid type for comparison"
                        )
                    if k1 != k2:
                        raise ChartError(
                            f"{fn}: incompatible types for comparison"
                        )
                    if a == b:
                        return True
                return False
            b = args[1]
            k2 = _basic_kind(b)
            if k2 is None:
                raise ChartError(f"{fn}: invalid type for comparison")
            if k1 != k2:
                raise ChartError(f"{fn}: incompatible types for comparison")
            if fn == "ne":
                return a != b
            if k1 == "bool":
                raise ChartError(f"{fn}: invalid type for comparison")
            return {"lt": a < b, "le": a <= b, "gt": a > b, "ge": a >= b}[fn]
        if fn == "and":
            out = args[0]
            for a in args:
                if not _truthy(a):
                    return a
                out = a
            return out
        if fn == "or":
            for a in args:
                if _truthy(a):
                    return a
            return args[-1]
        # -- sprig string helpers ------------------------------------------
        if fn == "printf":
            return _go_sprintf(_to_string(args[0]), args[1:])
        if fn in ("print", "println"):
            out = []
            prev_str = True
            for a in args:
                is_str = isinstance(a, str)
                if out and not (prev_str or is_str):
                    out.append(" ")   # Go fmt.Sprint: space between non-strings
                out.append(_to_string(a))
                prev_str = is_str
            return "".join(out) + ("\n" if fn == "println" else "")
        if fn == "contains":
            return _to_string(args[0]) in _to_string(args[1])
        if fn == "hasPrefix":
            return _to_string(args[1]).startswith(_to_string(args[0]))
        if fn == "hasSuffix":
            return _to_string(args[1]).endswith(_to_string(args[0]))
        if fn == "trunc":
            n, s = int(args[0]), _to_string(args[1])
            return s[n:] if n < 0 else s[:n]
        if fn == "trimSuffix":
            suf, s = _to_string(args[0]), _to_string(args[1])
            return s[: -len(suf)] if suf and s.endswith(suf) else s
        if fn == "trimPrefix":
            pre, s = _to_string(args[0]), _to_string(args[1])
            return s[len(pre):] if pre and s.startswith(pre) else s
        if fn == "replace":
            old, new, s = _to_string(args[0]), _to_string(args[1]), _to_string(args[2])
            return s.replace(old, new)
        if fn == "repeat":
            return _to_string(args[1]) * int(args[0])
        if fn == "join":
            sep = _to_string(args[0])
            coll = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
            return sep.join(_to_string(x) for x in coll)
        if fn == "splitList":
            return _to_string(args[1]).split(_to_string(args[0]))
        if fn == "split":
            parts = _to_string(args[1]).split(_to_string(args[0]))
            return {f"_{i}": p for i, p in enumerate(parts)}
        if fn == "base":
            return _go_path_base(_to_string(args[0]))
        if fn == "dir":
            return _go_path_dir(_to_string(args[0]))
        if fn == "ext":
            return _go_path_ext(_to_string(args[0]))
        if fn == "clean":
            return posixpath.normpath(_to_string(args[0])) if args[0] else "."
        if fn == "sha256sum":
            return hashlib.sha256(_to_string(args[0]).encode()).hexdigest()
        if fn == "b64enc":
            return base64.b64encode(_to_string(args[0]).encode()).decode()
        if fn == "b64dec":
            try:
                return base64.b64decode(_to_string(args[0]).encode()).decode()
            except Exception:
                return ""
        if fn == "kebabcase":
            s = re.sub(r"([a-z0-9])([A-Z])", r"\1-\2", _to_string(args[0]))
            return re.sub(r"[\s_]+", "-", s).lower()
        if fn == "snakecase":
            s = re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", _to_string(args[0]))
            return re.sub(r"[\s-]+", "_", s).lower()
        if fn == "camelcase":
            return "".join(
                w[:1].upper() + w[1:]
                for w in re.split(r"[\s_-]+", _to_string(args[0]))
            )
        # -- control / validation ------------------------------------------
        if fn == "required":
            # required "message" VALUE (helm: error out when value is unset)
            if len(args) != 2:
                raise ChartError("required expects 2 arguments")
            if args[1] is None or args[1] == "":
                raise ChartError(f"required value missing: {_to_string(args[0])}")
            return args[1]
        if fn == "fail":
            raise ChartError(f"template fail: {_to_string(args[0])}")
        if fn == "ternary":
            # TRUE_VAL FALSE_VAL | ternary ... or ternary TRUE FALSE TEST
            if len(args) != 3:
                raise ChartError("ternary expects 3 arguments")
            return args[0] if _truthy(args[2]) else args[1]
        if fn == "empty":
            return not _truthy(args[0])
        if fn == "coalesce":
            for a in args:
                if _truthy(a):
                    return a
            return None
        if fn == "kindOf":
            return _go_kind(args[0])
        if fn == "kindIs":
            return _go_kind(args[1]) == _to_string(args[0])
        # -- collections ----------------------------------------------------
        if fn == "list":
            return list(args)
        if fn == "dict":
            if len(args) % 2:
                raise ChartError("dict expects an even number of arguments")
            return {
                _to_string(args[i]): args[i + 1] for i in range(0, len(args), 2)
            }
        if fn == "get":
            d = args[0] if isinstance(args[0], dict) else {}
            return d.get(_to_string(args[1]), "")
        if fn == "set":
            if not isinstance(args[0], dict):
                raise ChartError("set expects a dict")
            args[0][_to_string(args[1])] = args[2]
            return args[0]
        if fn == "unset":
            if isinstance(args[0], dict):
                args[0].pop(_to_string(args[1]), None)
            return args[0]
        if fn == "hasKey":
            return isinstance(args[0], dict) and _to_string(args[1]) in args[0]
        if fn == "keys":
            out: List[str] = []
            for a in args:
                if isinstance(a, dict):
                    out.extend(a.keys())
            return sorted(out)
        if fn == "values":
            out = []
            for a in args:
                if isinstance(a, dict):
                    out.extend(a[k] for k in sorted(a))
            return out
        if fn == "merge":
            # sprig merge MUTATES the destination in place (dest keys win,
            # sources only fill gaps) and returns it — charts rely on the
            # `{{ $_ := merge .Values.a .Values.b }}` idiom observing the
            # merge through .Values.a afterwards
            dest = args[0]
            if not isinstance(dest, dict):
                raise ChartError("merge expects a dict destination")

            def fill(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
                for k, v in src.items():
                    if k not in dst:
                        dst[k] = v
                    elif isinstance(dst[k], dict) and isinstance(v, dict):
                        fill(dst[k], v)

            for a in args[1:]:
                if isinstance(a, dict):
                    fill(dest, a)
            return dest
        if fn == "index":
            cur = args[0]
            for key in args[1:]:
                if isinstance(cur, dict):
                    cur = cur.get(_to_string(key) if not isinstance(key, (int, float, bool)) else key)
                elif isinstance(cur, (list, tuple, str)):
                    try:
                        cur = cur[int(key)]
                    except (IndexError, ValueError, TypeError):
                        return None
                else:
                    return None
                if cur is None:
                    return None
            return cur
        if fn == "first":
            c = args[0]
            return c[0] if isinstance(c, (list, tuple)) and c else None
        if fn == "last":
            c = args[0]
            return c[-1] if isinstance(c, (list, tuple)) and c else None
        if fn == "rest":
            c = args[0]
            return list(c[1:]) if isinstance(c, (list, tuple)) else []
        if fn == "append":
            return (list(args[0]) if isinstance(args[0], (list, tuple)) else []) + [args[1]]
        if fn == "prepend":
            return [args[1]] + (list(args[0]) if isinstance(args[0], (list, tuple)) else [])
        if fn == "has":
            coll = args[1]
            return isinstance(coll, (list, tuple)) and args[0] in coll
        if fn == "len":
            try:
                return len(args[0])
            except TypeError:
                return 0
        if fn == "until":
            return list(range(int(args[0])))
        # -- arithmetic -----------------------------------------------------
        if fn in ("add", "sub", "mul", "div", "mod", "max", "min", "add1"):
            try:
                nums = [int(a) if float(a) == int(float(a)) else float(a) for a in args]
            except (TypeError, ValueError):
                raise ChartError(f"{fn}: non-numeric argument")
            if fn == "add":
                return sum(nums)
            if fn == "add1":
                return nums[0] + 1
            if fn == "sub":
                return nums[0] - nums[1]
            if fn == "mul":
                out3 = 1
                for n in nums:
                    out3 *= n
                return out3
            if fn == "div":
                if all(isinstance(n, int) for n in nums[:2]):
                    # Go int64 division truncates toward zero (-7/2 = -3),
                    # Python's // floors (-4) — correct the sign case
                    q = nums[0] // nums[1]
                    if q < 0 and q * nums[1] != nums[0]:
                        q += 1
                    return q
                return nums[0] / nums[1]
            if fn == "mod":
                if all(isinstance(n, int) for n in nums[:2]):
                    # Go % takes the dividend's sign (-7%2 = -1); derive from
                    # the truncated quotient (exact for big ints, no floats)
                    q = nums[0] // nums[1]
                    if q < 0 and q * nums[1] != nums[0]:
                        q += 1
                    return nums[0] - nums[1] * q
                return math.fmod(nums[0], nums[1])
            if fn == "max":
                return max(nums)
            return min(nums)
        if fn == "floor":
            return float(math.floor(float(args[0])))
        if fn == "ceil":
            return float(math.ceil(float(args[0])))
        if fn == "round":
            places = int(args[1]) if len(args) > 1 else 0
            return round(float(args[0]), places)
        # -- helm-specific --------------------------------------------------
        if fn == "include":
            name = _to_string(args[0])
            data = args[1] if len(args) > 1 else None
            return self.exec_template(name, data)
        if fn == "tpl":
            src = _to_string(args[0])
            ctx = args[1] if len(args) > 1 else dot
            toks = _tokenize_with_positions(src)
            nodes, _, _ = _parse(toks)
            if self.depth >= _MAX_TEMPLATE_DEPTH:
                raise ChartError("tpl recursion too deep")
            # Helm runs tpl against a per-invocation clone of the template
            # set: defines inside the rendered string must not leak into
            # (or override) the chart's own helpers.
            sub = _Renderer(dict(self.templates))
            _collect_defines(nodes, sub.templates)
            sub.depth = self.depth + 1
            return sub.render_nodes(nodes, ctx, _Scope(dollar=ctx))
        if fn == "lookup":
            return {}   # helm: empty when not connected to a cluster
        if fn in ("randAlphaNum", "randAlpha", "randNumeric", "randAscii",
                  "uuidv4", "now", "date", "genPrivateKey", "genCA",
                  "genSelfSignedCert", "genSignedCert", "derivePassword",
                  "htpasswd", "shuffle"):
            raise ChartError(
                f"nondeterministic template function {fn!r} is unsupported "
                "(rendering is a pure function of chart + values)"
            )
        raise ChartError(f"unsupported template function: {fn!r}")

    # -- rendering ----------------------------------------------------------
    def render_nodes(self, nodes: List[_Node], dot: Any, scope: _Scope) -> str:
        out: List[str] = []
        for node in nodes:
            if node.kind == "text":
                out.append(node.text)
            elif node.kind == "define":
                continue   # collected at parse time (_collect_defines)
            elif node.kind == "block":
                toks = _tokenize_expr(node.expr)
                if not toks:
                    raise ChartError("block action missing a template name")
                name = _literal_string(toks[0])
                rest = node.expr[node.expr.index(toks[0]) + len(toks[0]):].strip()
                arg = self._eval(rest, dot, scope) if rest else None
                out.append(self.exec_template(name, arg))
            elif node.kind == "action":
                expr = node.expr
                if expr.startswith("/*") or not expr:
                    continue  # comment
                m = _VAR_DECL_RE.match(expr)
                if m:
                    name, op, rhs = m.group(1), m.group(2), m.group(3)
                    val = self._eval(rhs, dot, scope)
                    if op == ":=":
                        scope.declare(name, val)
                    else:
                        scope.assign(name, val)
                    continue
                word = expr.split(None, 1)[0]
                if word == "template":
                    rest = expr[len("template"):].strip()
                    toks = _tokenize_expr(rest)
                    if not toks:
                        raise ChartError("template action missing a name")
                    name = _literal_string(toks[0])
                    tail = rest[rest.index(toks[0]) + len(toks[0]):].strip()
                    arg = self._eval(tail, dot, scope) if tail else None
                    out.append(self.exec_template(name, arg))
                    continue
                val = self._eval(expr, dot, scope)
                out.append(_to_string(val))
            elif node.kind == "if":
                child = _Scope(parent=scope)
                if _truthy(self._eval_cond(node.expr, dot, child)):
                    out.append(self.render_nodes(node.body, dot, child))
                else:
                    done = False
                    for cond, body in node.elifs:
                        if _truthy(self._eval_cond(cond, dot, child)):
                            out.append(self.render_nodes(body, dot, child))
                            done = True
                            break
                    if not done and node.else_body is not None:
                        out.append(self.render_nodes(node.else_body, dot, child))
            elif node.kind == "range":
                out.append(self._render_range(node, dot, scope))
            elif node.kind == "with":
                expr = node.expr
                var_name = None
                m = _RANGE_DECL_RE.match(expr)
                if m and m.group(2) is None:
                    var_name, expr = m.group(1)[1:], m.group(3)
                val = self._eval(expr, dot, scope)
                if _truthy(val):
                    child = _Scope(parent=scope)
                    if var_name is not None:
                        child.declare(var_name, val)
                    out.append(self.render_nodes(node.body, val, child))
                elif node.else_body is not None:
                    out.append(self.render_nodes(node.else_body, dot, _Scope(parent=scope)))
        return "".join(out)

    def _eval_cond(self, expr: str, dot: Any, scope: _Scope) -> Any:
        """An if/else-if condition may declare a variable visible in the
        block: {{ if $x := .Values.y }} (Go text/template semantics)."""
        m = _RANGE_DECL_RE.match(expr)
        if m and m.group(2) is None:
            val = self._eval(m.group(3), dot, scope)
            scope.declare(m.group(1)[1:], val)
            return val
        return self._eval(expr, dot, scope)

    def _render_range(self, node: _Node, dot: Any, scope: _Scope) -> str:
        expr = node.expr
        v1 = v2 = None
        m = _RANGE_DECL_RE.match(expr)
        if m:
            v1 = m.group(1)[1:]
            v2 = m.group(2)[1:] if m.group(2) else None
            expr = m.group(3)
        coll = self._eval(expr, dot, scope)
        pairs: List[Tuple[Any, Any]]   # (key-or-index, element)
        if isinstance(coll, _Files):
            # range over .Files / .Files.Glob yields (path, content)
            pairs = [
                (k, coll._files[k].decode(errors="replace"))
                for k in sorted(coll._files)
            ]
        elif isinstance(coll, dict):
            # Go templates visit maps in sorted key order
            pairs = [(k, coll[k]) for k in sorted(coll, key=_to_string)]
        elif isinstance(coll, (list, tuple)):
            pairs = list(enumerate(coll))
        elif isinstance(coll, int) and not isinstance(coll, bool):
            pairs = [(i, i) for i in range(coll)]
        else:
            pairs = []
        out: List[str] = []
        if pairs:
            for key, item in pairs:
                child = _Scope(parent=scope)
                if v1 is not None and v2 is not None:
                    child.declare(v1, key)
                    child.declare(v2, item)
                elif v1 is not None:
                    child.declare(v1, item)
                out.append(self.render_nodes(node.body, item, child))
        elif node.else_body is not None:
            out.append(self.render_nodes(node.else_body, dot, _Scope(parent=scope)))
        return "".join(out)


def _collect_defines(nodes: List[_Node], registry: Dict[str, List[_Node]]) -> None:
    """Hoist {{ define }} (and block) bodies into the shared template
    registry; later definitions override earlier ones, which — with subcharts
    collected before their parent — gives Helm's parent-overrides semantics."""
    for n in nodes:
        if n.kind in ("define", "block"):
            toks = _tokenize_expr(n.expr)
            if not toks:
                raise ChartError(f"{n.kind} action missing a template name")
            registry[_literal_string(toks[0])] = n.body
        _collect_defines(n.body, registry)
        for _, body in n.elifs:
            _collect_defines(body, registry)
        if n.else_body:
            _collect_defines(n.else_body, registry)


# Go `path` package semantics (sprig's base/dir/ext delegate to it), which
# differ from posixpath on edge inputs: Base("")=".", Base("a/")="a",
# Dir("a")=".", Ext(".bashrc")=".bashrc".

def _go_path_base(s: str) -> str:
    if not s:
        return "."
    s = s.rstrip("/")
    if not s:
        return "/"
    return s.rsplit("/", 1)[-1]


def _go_path_dir(s: str) -> str:
    if not s:
        return "."
    d = posixpath.dirname(s)
    if not d:
        return "/" if s.startswith("/") else "."
    return posixpath.normpath(d)


def _go_path_ext(s: str) -> str:
    dot = s.rfind(".")
    return s[dot:] if dot > s.rfind("/") else ""


def _glob_regex(pat: str):
    """Helm's Files.Glob semantics (gobwas/glob compiled with '/' as the
    separator): `*`/`?` do not cross path segments, `**` does."""
    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "*":
            if pat[i : i + 2] == "**":
                out.append(".*")
                i += 2
            else:
                out.append("[^/]*")
                i += 1
        elif c == "?":
            out.append("[^/]")
            i += 1
        elif c == "[":
            j = pat.find("]", i + 1)
            if j == -1:
                out.append(re.escape(c))
                i += 1
            else:
                out.append(pat[i : j + 1])
                i = j + 1
        else:
            out.append(re.escape(c))
            i += 1
    return re.compile("^" + "".join(out) + "$")


def _basic_kind(v: Any) -> Optional[str]:
    """text/template funcs.go basicKind: the comparison kind of a value, or
    None for nil and non-basic values (maps, slices) — bool checked before
    int because isinstance(True, int) holds in Python."""
    for t, k in ((bool, "bool"), (int, "int"), (float, "float"), (str, "string")):
        if isinstance(v, t):
            return k
    return None


def _go_kind(v: Any) -> str:
    if v is None:
        return "invalid"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float64"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (list, tuple)):
        return "slice"
    if isinstance(v, dict):
        return "map"
    return type(v).__name__


_FMT_RE = re.compile(r"%([-+ #0]*)(\d+)?(?:\.(\d+))?([a-zA-Z%])")


def _go_sprintf(fmt: str, args: List[Any]) -> str:
    """Go fmt.Sprintf for the verbs charts use: %s %v %q %d %f %g %e %x %X
    %o %b %t %c %%, with flags/width/precision."""
    out: List[str] = []
    pos = 0
    ai = 0

    def next_arg() -> Any:
        nonlocal ai
        if ai >= len(args):
            raise ChartError(f"printf: not enough arguments for format {fmt!r}")
        a = args[ai]
        ai += 1
        return a

    for m in _FMT_RE.finditer(fmt):
        out.append(fmt[pos : m.start()])
        pos = m.end()
        flags, width, prec, verb = m.groups()
        if verb == "%":
            out.append("%")
            continue
        spec = "%" + (flags or "") + (width or "") + (("." + prec) if prec else "")
        a = next_arg()
        if verb == "d":
            out.append((spec + "d") % int(a))
        elif verb in "oxX":
            out.append((spec + verb) % int(a))
        elif verb == "b":
            out.append(format(int(a), "b"))
        elif verb in "feEgG":
            out.append((spec + verb) % float(a))
        elif verb == "s":
            out.append((spec + "s") % _to_string(a))
        elif verb == "v":
            out.append((spec + "s") % _to_string(a))
        elif verb == "q":
            out.append(
                (spec + "s")
                % ('"' + _to_string(a).replace("\\", "\\\\").replace('"', '\\"') + '"')
            )
        elif verb == "t":
            out.append("true" if bool(a) else "false")
        elif verb == "c":
            out.append(chr(int(a)))
        else:
            raise ChartError(f"printf: unsupported verb %{verb}")
    out.append(fmt[pos:])
    return "".join(out)


def _truthy(v: Any) -> bool:
    """Go template truthiness: false, 0, empty string/collection, nil."""
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (str, list, dict, tuple)) and len(v) == 0:
        return False
    return True


def _to_string(v: Any) -> str:
    if v is None:
        return ""
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        # Go prints whole floats from template arithmetic as "1e+06"-style
        # only at %e; default %v gives "1" for 1.0 via strconv shortest form
        return str(int(v))
    return str(v)


# Helper misuse (wrong arg types/counts, div-by-zero) surfaces as ChartError
# so one bad chart degrades per-app instead of aborting the run with a
# Python traceback.
_RENDER_RUNTIME_ERRORS = (
    ValueError, TypeError, ZeroDivisionError, IndexError, KeyError,
    AttributeError, OverflowError,
)


def render_template(src: str, context: Dict[str, Any]) -> str:
    """Render a standalone template string (defines inside `src` are
    available to include/template within it)."""
    tokens = _tokenize_with_positions(src)
    nodes, _, _ = _parse(tokens)
    registry: Dict[str, List[_Node]] = {}
    _collect_defines(nodes, registry)
    r = _Renderer(registry)
    try:
        return r.render_nodes(nodes, context, _Scope(dollar=context))
    except _RENDER_RUNTIME_ERRORS as e:
        raise ChartError(f"template runtime error: {e!r}")


# ---------------------------------------------------------------------------
# ProcessChart
# ---------------------------------------------------------------------------

def _coalesce(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _coalesce(out[k], v)
        else:
            out[k] = v
    return out


class _Files:
    """`.Files` (helm.sh/helm/v3/pkg/engine files.go): access to the chart's
    non-template files from templates. Method surface matches Helm's —
    Get/GetBytes/Glob/Lines/AsConfig/AsSecrets."""

    __template_safe__ = (
        "Get", "GetBytes", "Glob", "Lines", "AsConfig", "AsSecrets",
    )

    def __init__(self, files: Dict[str, bytes]):
        self._files = dict(files)

    def Get(self, name: Any) -> str:                 # noqa: N802
        data = self._files.get(_to_string(name))
        return data.decode(errors="replace") if data is not None else ""

    def GetBytes(self, name: Any) -> bytes:          # noqa: N802
        return self._files.get(_to_string(name), b"")

    def Glob(self, pattern: Any) -> "_Files":        # noqa: N802
        rx = _glob_regex(_to_string(pattern))
        return _Files(
            {k: v for k, v in self._files.items() if rx.match(k)}
        )

    def Lines(self, name: Any) -> List[str]:         # noqa: N802
        text = self.Get(name)
        return text.splitlines() if text else []

    def AsConfig(self) -> str:                       # noqa: N802
        """Basename -> file content, as YAML (for `data:` of a ConfigMap)."""
        out = {
            posixpath.basename(k): v.decode(errors="replace")
            for k, v in sorted(self._files.items())
        }
        return yaml.safe_dump(out, default_flow_style=False).rstrip("\n") if out else ""

    def AsSecrets(self) -> str:                      # noqa: N802
        out = {
            posixpath.basename(k): base64.b64encode(v).decode()
            for k, v in sorted(self._files.items())
        }
        return yaml.safe_dump(out, default_flow_style=False).rstrip("\n") if out else ""


class _APIVersions(list):
    """`.Capabilities.APIVersions` with the `.Has` method templates call."""

    __template_safe__ = ("Has",)

    def Has(self, v: Any) -> bool:   # noqa: N802 — Go method name
        return _to_string(v) in self


# The API surface of the vendored scheduler's Kubernetes (v1.20.5) — what the
# reference's Helm engine would report when rendering offline.
_CAPABILITIES: Dict[str, Any] = {
    "KubeVersion": {
        "Version": "v1.20.5", "GitVersion": "v1.20.5",
        "Major": "1", "Minor": "20",
    },
    "APIVersions": _APIVersions([
        "v1", "apps/v1", "batch/v1", "batch/v1beta1", "autoscaling/v1",
        "autoscaling/v2beta2", "networking.k8s.io/v1",
        "networking.k8s.io/v1beta1", "policy/v1beta1",
        "rbac.authorization.k8s.io/v1", "storage.k8s.io/v1",
        "scheduling.k8s.io/v1", "apiextensions.k8s.io/v1",
    ]),
    "HelmVersion": {"Version": "v3.9.4"},
}


def _chart_meta_ctx(metadata: Dict[str, Any]) -> Dict[str, Any]:
    """Helm exposes Chart.yaml fields capitalized (.Chart.Name, .Chart.Version,
    .Chart.AppVersion); keep the raw keys too for backward compatibility."""
    ctx = dict(metadata)
    for k, v in metadata.items():
        if isinstance(k, str) and k:
            ctx[k[0].upper() + k[1:]] = v
    return ctx


def _parse_chart_tree(
    chart: Chart,
    registry: Dict[str, List[_Node]],
    parsed: List[Tuple[Chart, str, List[_Node]]],
) -> None:
    """Parse every template file in the chart tree, hoisting defines into the
    shared registry. Subcharts first so parent definitions override (Helm's
    template-override semantics), and each file also registers under its
    chart-relative path (`mychart/templates/deployment.yaml`) so
    `include (print $.Template.BasePath "/x.yaml") .` works."""
    for dep in chart.dependencies:
        _parse_chart_tree(dep, registry, parsed)
    for rel, src in chart.templates.items():
        tokens = _tokenize_with_positions(src)
        nodes, _, _ = _parse(tokens)
        _collect_defines(nodes, registry)
        registry[posixpath.join(chart.name, rel.replace(os.sep, "/"))] = nodes
        parsed.append((chart, rel, nodes))


def _render_parsed(
    chart: Chart,
    values: Dict[str, Any],
    release_name: str,
    renderer: _Renderer,
    parsed_by_chart: Dict[int, List[Tuple[str, List[_Node]]]],
) -> Dict[str, str]:
    ctx_base = {
        "Chart": _chart_meta_ctx(chart.metadata),
        "Release": {
            # chart.go:27-61: the app name overwrites Chart.Metadata.Name
            # before rendering, so Release.Name is the APP name (also what
            # `helm template <name> <path>` does); ns/revision hardcoded
            "Name": release_name,
            "Namespace": "default",
            "Revision": 1,
            "Service": "Helm",
        },
        "Values": values,
        "Capabilities": _CAPABILITIES,
        "Files": _Files(chart.files),
    }
    files: Dict[str, str] = {}
    for rel, nodes in parsed_by_chart.get(id(chart), []):
        if os.path.basename(rel).startswith("_"):
            continue  # partials: defines only, never rendered as manifests
        tpl_name = posixpath.join(chart.name, rel.replace(os.sep, "/"))
        ctx = dict(ctx_base)
        ctx["Template"] = {
            "Name": tpl_name,
            "BasePath": posixpath.join(chart.name, "templates"),
        }
        try:
            files[os.path.join(chart.name, rel)] = renderer.render_nodes(
                nodes, ctx, _Scope(dollar=ctx)
            )
        except _RENDER_RUNTIME_ERRORS as e:
            raise ChartError(f"{tpl_name}: template runtime error: {e!r}")
    # dependencies: subchart values live under values.<subchart name>,
    # sharing .Values.global and the parent's release name
    for dep in chart.dependencies:
        sub_vals = _coalesce(dep.values, values.get(dep.name) or {})
        if "global" in values:
            sub_vals = _coalesce(sub_vals, {"global": values["global"]})
        files.update(
            _render_parsed(dep, sub_vals, release_name, renderer, parsed_by_chart)
        )
    return files


def process_chart(path: str, release_name: Optional[str] = None) -> List[dict]:
    """Render a chart into decoded manifest objects in Helm install order
    (parity: chart.ProcessChart, pkg/chart/chart.go:27-118). release_name is
    the app name from the Simon config; defaults to the chart's own name."""
    from ..resilience import faults

    rule = faults.maybe_inject("chart", release_name or path)
    if rule is not None:
        faults.apply_chart_fault(rule, release_name or path)
    chart = load_chart(path)
    if release_name:
        # chart.go:23: `chartRequested.Metadata.Name = name` — the app name
        # overwrites the top-level chart's own name BEFORE rendering, so
        # .Chart.Name (and the scaffold helpers built on it) see the app name.
        chart.name = release_name
        chart.metadata = dict(chart.metadata)
        chart.metadata["name"] = release_name

    registry: Dict[str, List[_Node]] = {}
    parsed: List[Tuple[Chart, str, List[_Node]]] = []
    _parse_chart_tree(chart, registry, parsed)
    parsed_by_chart: Dict[int, List[Tuple[str, List[_Node]]]] = {}
    for ch, rel, nodes in parsed:
        parsed_by_chart.setdefault(id(ch), []).append((rel, nodes))

    renderer = _Renderer(registry)
    files = _render_parsed(
        chart, chart.values, release_name or chart.name, renderer, parsed_by_chart
    )

    docs: List[Tuple[int, int, dict]] = []  # (order, seq, object)
    seq = 0
    for rel in sorted(files):
        if rel.endswith(NOTES_SUFFIX):
            continue
        content = files[rel]
        for doc in re.split(r"(?m)^---\s*$", content):
            if not doc.strip():
                continue
            try:
                obj = yaml.safe_load(doc)
            except yaml.YAMLError as e:
                raise ChartError(f"{rel}: rendered template is not YAML: {e}")
            if not isinstance(obj, dict) or not obj:
                continue
            kind = obj.get("kind", "")
            order = _ORDER_INDEX.get(kind, len(INSTALL_ORDER))
            docs.append((order, seq, obj))
            seq += 1
    docs.sort(key=lambda t: (t[0], t[1]))
    return [d for _, _, d in docs]
