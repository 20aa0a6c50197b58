"""The port's AST lint engine and rules (open_simulator_tpu_torch/analysis/
lint.py, analysis/rules/): the counterparts of tests/test_lint.py over torch
fixtures. Each kept or restated rule gets one snippet that MUST be flagged
and one near miss that MUST NOT be. Fixture packages are written to
tmp_path and only parsed, never imported; an entry is a function decorated
`@sanitizable("<audit name>")`, as in the port. Then the rule decisions
against the reference's catalogue, the port's own tree (lint-clean, every
suppression with a reason, roots == the registry's 23 entries), and the
torch-free CLI verbs in a subprocess.
"""

import json
import subprocess
import sys
import textwrap

import pytest

from open_simulator_tpu_torch.analysis import iter_rules, run_lint
from open_simulator_tpu_torch.analysis.lint import build_context
from open_simulator_tpu_torch.analysis.rules import RULE_DECISIONS

_SANITIZE = """
def sanitizable(name, skip=None, donate_argnums=()):
    def deco(fn):
        return fn
    return deco
"""


def _lint(tmp_path, source, extra_modules=None, only_rules=None):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "sanitize.py").write_text(_SANITIZE)
    (pkg / "mod.py").write_text(textwrap.dedent(source))
    for name, src in (extra_modules or {}).items():
        (pkg / f"{name}.py").write_text(textwrap.dedent(src))
    return run_lint(package_root=str(pkg), report_root=str(tmp_path), only_rules=only_rules)


def _rule_ids(report):
    return {f.rule for f in report.active}


def _ops_pkg(tmp_path, files):
    pkg = tmp_path / "pkg"
    ops = pkg / "ops"
    ops.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (ops / "__init__.py").write_text("")
    for rel, src in files.items():
        (pkg / rel).write_text(textwrap.dedent(src))
    return run_lint(package_root=str(pkg), report_root=str(tmp_path))


# ---------------------------------------------------------------------------
# tracer-coercion (restated: host syncs in entry code)


def test_tracer_coercion_true_positive(tmp_path):
    r = _lint(
        tmp_path,
        """
        import torch
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            v = float(x)
            w = x.item()
            u = x.cpu()
            l = x.tolist()
            n = x.numpy()
            return v + w
        """,
    )
    assert sum(f.rule == "tracer-coercion" for f in r.active) == 5


def test_tracer_coercion_near_miss_static_and_host(tmp_path):
    """float() of a shape, int() of .numel()/.size()/len(), and float() in
    host-only code are fine."""
    r = _lint(
        tmp_path,
        """
        import torch
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            return x * float(x.shape[0]) + int(x.numel()) + int(x.size(0)) + int(len(x))

        def host(x):
            return float(x), x.item(), x.cpu()
        """,
    )
    assert "tracer-coercion" not in _rule_ids(r)


def test_tracer_coercion_np_asarray(tmp_path):
    r = _lint(
        tmp_path,
        """
        import numpy as np
        import torch
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            return np.asarray(x)

        @sanitizable("pkg:kern_ok")
        def kern_ok(x):
            return x + np.zeros(4)[0]
        """,
    )
    hits = [f for f in r.active if f.rule == "tracer-coercion"]
    assert len(hits) == 1 and "asarray" in hits[0].message


# ---------------------------------------------------------------------------
# impure-read (restated: unseeded randomness and environment reads)


def test_impure_read_true_positive(tmp_path):
    r = _lint(
        tmp_path,
        """
        import os
        import random
        import numpy as np
        import torch
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            z = random.random()
            e = os.environ.get("K")
            p = torch.randperm(4)
            q = torch.rand(4)
            s = np.random.rand(4)
            return x + z
        """,
    )
    assert sum(f.rule == "impure-read" for f in r.active) == 5


def test_impure_read_near_miss_seeded_and_host(tmp_path):
    """A torch RNG call with generator=, time.* in an entry (eager code
    re-reads it every call, nothing is frozen) and every read in host-only
    code are fine."""
    r = _lint(
        tmp_path,
        """
        import os
        import random
        import time
        import torch
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x, gen):
            t0 = time.perf_counter()
            return x + torch.rand(4, generator=gen) + torch.randperm(4, generator=gen), t0

        def configure():
            return float(os.environ.get("K", "1")) + random.random() + torch.rand(1)
        """,
    )
    assert "impure-read" not in _rule_ids(r)


# ---------------------------------------------------------------------------
# import-time-cuda (restated from import-time-jnp)


def test_import_time_cuda_true_positive(tmp_path):
    r = _lint(
        tmp_path,
        """
        import torch

        TABLE = torch.arange(16, device="cuda")
        ONES = torch.ones(4).cuda()
        TO = torch.zeros(2).to("cuda:0")
        N = torch.cuda.device_count()
        """,
    )
    assert sum(f.rule == "import-time-cuda" for f in r.active) == 4


def test_import_time_cuda_near_miss(tmp_path):
    """Device work inside functions, CPU tensors at module level and torch
    settings (attribute assignments, not calls) are fine."""
    r = _lint(
        tmp_path,
        """
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        TABLE = torch.arange(16)
        CPU = torch.zeros(2, device="cpu")

        def build(device="cuda"):
            torch.cuda.synchronize()
            return torch.arange(16, device=device)
        """,
    )
    assert "import-time-cuda" not in _rule_ids(r)


# ---------------------------------------------------------------------------
# f64-literal (torch spellings; scoped to ops/)


def test_f64_literal_true_positive(tmp_path):
    r = _ops_pkg(tmp_path, {"ops/k.py": """
        import numpy as np
        import torch

        def f(x):
            a = torch.zeros(4, dtype=torch.float64)
            b = x.double()
            c = x.long() + 1
            return a, b, c, np.zeros(4, np.float64), x.astype(float)
        """})
    assert sum(f.rule == "f64-literal" for f in r.active) == 5


def test_f64_literal_index_int64_exempt(tmp_path):
    """int64 that only feeds an index (a subscript, an index argument, or a
    name used only as one) is PyTorch's index dtype and not flagged."""
    r = _ops_pkg(tmp_path, {"ops/k.py": """
        import numpy as np
        import torch

        def f(x, idx, rows):
            sel = idx.long()
            a = x[sel] + x[:, sel]
            b = x.gather(0, idx.long())
            c = x.index_select(0, idx.to(torch.int64))
            t = torch.from_numpy(rows.astype(np.int64)).to(x.device)
            x.index_put_((t,), a)
            return a, b, c
        """})
    assert "f64-literal" not in _rule_ids(r), [f.render() for f in r.active]


def test_f64_literal_near_miss_outside_ops(tmp_path):
    """float64 outside ops/ is out of scope; float32 inside ops/ is the
    blessed dtype."""
    r = _ops_pkg(tmp_path, {
        "report.py": "import torch\nX = torch.zeros(1, dtype=torch.float64)\n",
        "ops/k.py": "import torch\nY = torch.zeros(4, dtype=torch.float32)\n",
    })
    assert "f64-literal" not in _rule_ids(r)


def test_f64_literal_float64_never_exempt(tmp_path):
    r = _ops_pkg(tmp_path, {"ops/k.py": """
        import torch

        def f(x, i):
            return x[i.double()]
        """})
    assert "f64-literal" in _rule_ids(r)


# ---------------------------------------------------------------------------
# unbucketed-jit-shape


_SHAPE_PKG = {
    "encode": """
        def round_up(n, minimum=8):
            m = minimum
            while m < n:
                m *= 2
            return m
        """,
}


def test_unbucketed_shape_true_positive(tmp_path):
    r = _lint(
        tmp_path,
        """
        from .sanitize import sanitizable

        @sanitizable("pkg:sized")
        def sized(x, out_size):
            return x[:out_size]

        def host(xs):
            n = len(xs)
            return sized(xs, n)
        """,
        extra_modules=_SHAPE_PKG,
    )
    assert "unbucketed-jit-shape" in _rule_ids(r)


def test_unbucketed_shape_near_miss_bucketed(tmp_path):
    """Sizes that provably flow through round_up (directly, via a local,
    via min/max), or are read from a shape (.shape, .size(), .numel()),
    are the blessed pattern."""
    r = _lint(
        tmp_path,
        """
        from .encode import round_up
        from .sanitize import sanitizable

        @sanitizable("pkg:sized")
        def sized(x, out_size):
            return x[:out_size]

        def host(xs):
            g = round_up(len(xs))
            return sized(xs, g), sized(xs, min(round_up(4), 64)), sized(xs, xs.size(0))
        """,
        extra_modules=_SHAPE_PKG,
    )
    assert "unbucketed-jit-shape" not in _rule_ids(r)


def test_unbucketed_shape_wrapper_propagation(tmp_path):
    """A thin wrapper forwarding its own param into an entry's shape
    argument moves the obligation to the wrapper's call sites."""
    r = _lint(
        tmp_path,
        """
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x, group_size):
            return x[:group_size]

        def wrapper(x, group_size):
            return kern(x, group_size=group_size)

        def host_bad(xs):
            return wrapper(xs, len(xs))
        """,
        extra_modules=_SHAPE_PKG,
    )
    hits = [f for f in r.active if f.rule == "unbucketed-jit-shape"]
    assert len(hits) == 1  # the wrapper call site, not the wrapper body


# ---------------------------------------------------------------------------
# device-sync-in-loop


def test_device_sync_in_loop_true_positive(tmp_path):
    r = _lint(
        tmp_path,
        """
        import numpy as np
        import torch
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            return x * 2

        def drive(xs):
            acc = []
            for x in xs:
                y = kern(x)
                acc.append(np.asarray(y))
                acc.append(y.item())
                acc.append(y.cpu())
                acc.append(y.tolist())
                torch.cuda.synchronize()
            return acc
        """,
    )
    hits = [f for f in r.active if f.rule == "device-sync-in-loop"]
    assert len(hits) == 5
    assert any("np.asarray" in f.message for f in hits)
    assert any("synchronize" in f.message for f in hits)


def test_device_sync_near_miss_host_numpy_and_epilogue(tmp_path):
    """Coercing numpy state in the loop (its .tolist() included) is host
    arithmetic, and a one-shot read after the loop is the blessed shape."""
    r = _lint(
        tmp_path,
        """
        import numpy as np
        import torch
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            return x * 2

        def drive(xs, hosts):
            outs = []
            for x, h in zip(xs, hosts):
                outs.append(kern(x))
                total = float(np.sum(h)) + len(h.tolist())
            return torch.stack(outs).cpu(), total
        """,
    )
    assert "device-sync-in-loop" not in _rule_ids(r)


def test_device_sync_near_miss_batched_read(tmp_path):
    """One batched read of several results, `(t.cpu() for t in (a, b))`,
    is the counterpart of the reference's consolidated jax.device_get; a
    host-returning wrapper that reads internally (itself or through a
    helper) is not entry-like, so loops around it may coerce its results."""
    r = _lint(
        tmp_path,
        """
        import numpy as np
        import torch
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            return x * 2, x + 1

        def _host(*ts):
            return tuple(t.cpu().numpy() for t in ts)

        def kern_host(x):
            return _host(*kern(x))

        def drive(xs):
            fetched = []
            for x in xs:
                a, b = kern(x)
                a_np, b_np = (t.cpu().numpy() for t in (a, b))
                y = kern_host(x)
                fetched.append(float(np.sum(y[0])))
            return fetched
        """,
    )
    assert "device-sync-in-loop" not in _rule_ids(r), [f.render() for f in r.active]


def test_device_sync_suppression_escape(tmp_path):
    r = _lint(
        tmp_path,
        """
        import numpy as np
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            return x * 2

        def drive(xs):
            for x in xs:
                y = kern(x)
                # the mask gates the next dispatch; the read is the point
                m = y.cpu().numpy()  # osim: lint-ok[device-sync-in-loop]
                if not m.any():
                    break
        """,
    )
    assert "device-sync-in-loop" not in _rule_ids(r)
    assert sum(f.suppressed for f in r.findings) == 1


# ---------------------------------------------------------------------------
# engine machinery


def test_reachability_through_helpers_and_vmap(tmp_path):
    """Violations in helpers are attributed to the entry that reaches them,
    including functions passed to torch.vmap / torch.func.vmap and helpers
    imported from a sibling module."""
    r = _lint(
        tmp_path,
        """
        import random
        import torch
        from torch.func import vmap
        from .helpers import remote
        from .sanitize import sanitizable

        def step(x):
            return x + random.random()

        def lane(x):
            return x.item()

        def helper(x):
            return float(x)

        @sanitizable("pkg:kern")
        def kern(xs):
            out = torch.func.vmap(step)(xs) + vmap(lane)(xs)
            return helper(out) + remote(out)

        def unreached(x):
            return float(x)
        """,
        extra_modules={"helpers": """
            def remote(x):
                return x.tolist()
            """},
    )
    assert {"impure-read", "tracer-coercion"} <= _rule_ids(r)
    roots = {f.jit_root for f in r.active if f.jit_root}
    assert roots == {"pkg:kern"}
    assert any(f.path.endswith("helpers.py") for f in r.active)
    assert not any(f.line > 22 and f.path.endswith("mod.py") for f in r.active)


def test_suppression_comment(tmp_path):
    r = _lint(
        tmp_path,
        """
        import random
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            # a fixture: the draw is deliberate
            t = random.random()  # osim: lint-ok[impure-read]
            return x + t
        """,
    )
    assert not r.active
    assert sum(f.suppressed for f in r.findings) == 1


def test_suppression_is_rule_specific(tmp_path):
    r = _lint(
        tmp_path,
        """
        import random
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            t = float(random.random())  # osim: lint-ok[impure-read]
            return x + t
        """,
    )
    assert _rule_ids(r) == {"tracer-coercion"}


def test_stale_suppression_reported(tmp_path):
    """A suppression that matches no finding is itself a finding, and one
    naming an unknown rule says so."""
    r = _lint(
        tmp_path,
        """
        def host(x):
            return x + 1  # osim: lint-ok[impure-read]

        def other(x):
            return x  # osim: lint-ok[no-such-rule]
        """,
    )
    stale = [f for f in r.active if f.rule == "unused-suppression"]
    assert len(stale) == 2
    assert any("unknown rule id 'no-such-rule'" in f.message for f in stale)


def test_json_output_schema(tmp_path):
    r = _lint(
        tmp_path,
        """
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            return float(x)
        """,
    )
    doc = json.loads(r.to_json())
    assert doc["version"] == 1
    assert doc["files_scanned"] >= 3
    assert doc["rules"] == sorted(rid for rid, _ in iter_rules())
    (finding,) = doc["findings"]
    assert finding["rule"] == "tracer-coercion"
    assert finding["path"].endswith("mod.py")
    assert finding["jit_root"] == "pkg:kern"
    assert finding["line"] > 0 and "message" in finding
    assert doc["suppressed"] == []


def test_rule_filter(tmp_path):
    r = _lint(
        tmp_path,
        """
        import random
        from .sanitize import sanitizable

        @sanitizable("pkg:kern")
        def kern(x):
            return float(x) + random.random()  # osim: lint-ok[f64-literal]
        """,
        only_rules=["impure-read"],
    )
    # a filtered run reports no stale suppression: it cannot tell
    assert _rule_ids(r) == {"impure-read"}


# ---------------------------------------------------------------------------
# lock-in-hot-path (kept as it is)


HOT_PREAMBLE = """
    import threading
"""


def test_lock_in_hot_path_true_positive(tmp_path):
    r = _lint(
        tmp_path,
        HOT_PREAMBLE + """
    def helper():
        guard = threading.RLock()
        return guard

    def worker():
        lock = threading.Lock()
        with lock:
            helper()

    threading.Thread(target=worker).start()
    """,
        only_rules=["lock-in-hot-path"],
    )
    assert sum(f.rule == "lock-in-hot-path" for f in r.active) == 2


def test_lock_in_hot_path_instance_and_module_lifetime_ok(tmp_path):
    r = _lint(
        tmp_path,
        HOT_PREAMBLE + """
    _lock = threading.Lock()

    class Pool:
        def worker(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition(threading.Lock())
            with _lock:
                pass

    threading.Thread(target=Pool().worker).start()
    """,
        only_rules=["lock-in-hot-path"],
    )
    assert not r.active, [f.render() for f in r.active]


def test_lock_in_hot_path_cold_code_not_flagged(tmp_path):
    r = _lint(
        tmp_path,
        HOT_PREAMBLE + """
    def setup_once():
        lock = threading.Lock()
        return lock

    def worker():
        pass

    threading.Thread(target=worker).start()
    """,
        only_rules=["lock-in-hot-path"],
    )
    assert not r.active, [f.render() for f in r.active]


def test_lock_in_hot_path_suppression(tmp_path):
    r = _lint(
        tmp_path,
        HOT_PREAMBLE + """
    def worker():
        lock = threading.Lock()  # osim: lint-ok[lock-in-hot-path]
        with lock:
            pass

    threading.Thread(target=worker).start()
    """,
        only_rules=["lock-in-hot-path"],
    )
    assert not r.active
    assert sum(f.suppressed for f in r.findings) == 1


# ---------------------------------------------------------------------------
# the rule decisions against the reference's catalogue


def test_rule_decisions_cover_the_reference_catalogue():
    """Every reference rule has exactly one decision; the port's catalogue
    is the kept and restated ids, nothing else."""
    from open_simulator_tpu.analysis import iter_rules as ref_rules

    ref_ids = {rid for rid, _ in ref_rules()}
    assert set(RULE_DECISIONS) == ref_ids
    kept = {new for new, _why in RULE_DECISIONS.values() if new is not None}
    assert {rid for rid, _ in iter_rules()} == kept
    assert [r for r, (new, _why) in RULE_DECISIONS.items() if new is None] == [
        "unhashable-static-default"
    ]
    assert RULE_DECISIONS["import-time-jnp"][0] == "import-time-cuda"
    assert all(why for _new, why in RULE_DECISIONS.values())


def test_suppress_regex_and_decorator_match_the_reference():
    from open_simulator_tpu.analysis import lint as ref_lint
    from open_simulator_tpu_torch.analysis import lint as port_lint

    assert port_lint.SUPPRESS_RE.pattern == ref_lint.SUPPRESS_RE.pattern


# ---------------------------------------------------------------------------
# the port's own tree


def test_repo_package_is_lint_clean():
    """`simon lint` exits 0 on the port, and every suppression carries a
    reason (a comment on its line beyond the marker, or on the lines just
    above)."""
    report = run_lint()
    assert not report.active, report.render_text()
    ctx = build_context()
    n = 0
    for mod in ctx.modules.values():
        for line_no in mod.suppressions:
            n += 1
            own = mod.lines[line_no - 1].split("# osim:")[0]
            window = mod.lines[max(0, line_no - 3): line_no - 1] + [own]
            assert any("#" in line for line in window), (
                f"{mod.path}:{line_no}: suppression lacks a reason"
            )
    assert n > 0


def test_repo_roots_are_the_registry_entries():
    """The lint roots are exactly the 23 registry entries, each at the
    callable entry_audit names for it (ENTRY_ATTRS included)."""
    from open_simulator_tpu_torch.analysis.entry_audit import AUDIT_TARGETS, entry_locations

    ctx = build_context()
    roots = ctx.roots()
    assert len(roots) == sum(len(v) for v in AUDIT_TARGETS.values()) == 23
    assert roots == {name: loc for name, loc in entry_locations().items()}
    assert all(loc in ctx.reachable for loc in roots.values())


def test_repo_reaches_helpers_through_imports_and_vmap():
    ctx = build_context()
    p = "open_simulator_tpu_torch"
    for key in (
        (f"{p}.ops.kernels", "schedule_step"),          # the oracle's scan step
        (f"{p}.ops.domain_pop", "domain_pop"),          # from fast via `_dp.`
        (f"{p}.parallel.slots", "node_sum"),            # `from ..parallel import slots as nx`
        (f"{p}.ops.domain_pop", "_spread_norm"),        # `from .domain_pop import ...`
    ):
        assert key in ctx.reachable, key


def test_repo_clean_against_lock_in_hot_path():
    r = run_lint(only_rules=["lock-in-hot-path"])
    assert not r.active, [f.render() for f in r.active]


def test_port_imports_neither_jax_nor_the_reference():
    ctx = build_context()
    for mod in ctx.modules.values():
        for local, (target, _attr) in mod.imports.items():
            assert not target.startswith("jax"), (mod.path, local)
            assert target.split(".")[0] != "open_simulator_tpu", (mod.path, local)


# ---------------------------------------------------------------------------
# the CLI verbs


@pytest.mark.parametrize("argv", [
    ["lint", "--no-jaxpr", "--format", "json"],
    ["audit", "--no-invariants", "--format", "json"],
    ["lint", "--no-jaxpr", "--list-rules"],
])
def test_ast_verbs_import_no_torch(argv):
    code = (
        "import sys\n"
        "from open_simulator_tpu_torch import cli\n"
        f"rc = cli.main({argv!r})\n"
        "sys.stdout.flush()\n"
        "assert 'torch' not in sys.modules, 'torch was imported'\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "sys.exit(rc)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    if argv[-1] == "json":
        doc = json.loads(out.stdout)
        assert doc["ok"] is True


def test_cli_lint_unknown_rule_exits_1(capsys):
    from open_simulator_tpu_torch import cli

    assert cli.main(["lint", "--no-jaxpr", "--rules", "no-such-rule"]) == 1
    assert "unknown rule" in capsys.readouterr().err


def test_cli_lint_rules_filter_and_list(capsys):
    from open_simulator_tpu_torch import cli

    assert cli.main(["lint", "--no-jaxpr", "--list-rules"]) == 0
    listed = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == [rid for rid, _ in iter_rules()]
    assert cli.main(["lint", "--no-jaxpr", "--rules", "f64-literal", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["rules"] == ["f64-literal"]
    assert doc["jaxpr_audit"] is None and doc["recompile_guard"] is None


@pytest.fixture(autouse=True, scope="module")
def _untraced_allocations():
    """Pause tracemalloc for this file: an earlier file in the same worker
    may have left it tracing (a heap-profile test does), which slows
    Python-heavy tests tens of times."""
    import tracemalloc

    tracing = tracemalloc.is_tracing()
    tracemalloc.stop()
    yield
    if tracing:
        tracemalloc.start()
