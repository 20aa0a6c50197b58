"""The port's race and deadlock detector (open_simulator_tpu_torch/
analysis/races.py): the counterparts of tests/test_races.py. The fixture
packages are the reference's (the detector reads Python, so its fixtures
carry over as they are), parsed from tmp_path and never imported; then the
port's own thread roots (the server, the admission worker, the watchdog,
the extender wave's executor tasks, the mesh slots' threads started through
contextvars, the stub servers' nested handler classes), its fixed races
and its package-level gate.
"""

import json
import textwrap
import threading

import pytest

from open_simulator_tpu_torch.analysis.lint import build_context
from open_simulator_tpu_torch.analysis.races import run_races


def _races(tmp_path, source, extra_modules=None):
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text(textwrap.dedent(source))
    for name, src in (extra_modules or {}).items():
        (pkg / f"{name}.py").write_text(textwrap.dedent(src))
    return run_races(package_root=str(pkg), report_root=str(tmp_path))


HANDLER_PREAMBLE = """
    import threading
    from http.server import BaseHTTPRequestHandler

    _lock = threading.Lock()
    _cache = {}
    _hits = 0
"""


# ---------------------------------------------------------------------------
# true positives
# ---------------------------------------------------------------------------

def test_unguarded_container_mutation_in_handler_flagged(tmp_path):
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            _cache[self.path] = 1
    """,
    )
    assert [f.access for f in rep.active] == ["mutate"]
    assert rep.active[0].state == "pkg.mod._cache"
    assert not rep.ok


def test_unguarded_scalar_rmw_flagged(tmp_path):
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            global _hits
            _hits += 1
    """,
    )
    assert [f.access for f in rep.active] == ["rmw"]
    assert rep.active[0].state == "pkg.mod._hits"


def test_check_then_act_flagged(tmp_path):
    """A read and a separate rebind in one function is the TOCTOU shape
    (the _tracemalloc_on bug) even without an AugAssign."""
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    _started = False

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            global _started
            if not _started:
                _started = True
    """,
    )
    assert [f.access for f in rep.active] == ["check-then-act"]
    assert rep.active[0].state == "pkg.mod._started"


def test_thread_target_and_helper_reachability(tmp_path):
    """Mutations in a helper function called from a Thread target are
    reachable and flagged."""
    rep = _races(
        tmp_path,
        """
    import threading

    _jobs = []

    def _push(x):
        _jobs.append(x)

    def worker():
        _push(1)

    def start():
        threading.Thread(target=worker).start()
    """,
    )
    assert [(f.access, f.state) for f in rep.active] == [
        ("mutate", "pkg.mod._jobs")
    ]
    assert "thread target" in rep.active[0].thread_root


def test_signal_handler_is_a_root(tmp_path):
    rep = _races(
        tmp_path,
        """
    import signal

    _seen = []

    def on_term(signum, frame):
        _seen.append(signum)

    def install():
        signal.signal(signal.SIGTERM, on_term)
    """,
    )
    assert [f.state for f in rep.active] == ["pkg.mod._seen"]
    assert "signal handler" in rep.active[0].thread_root


def test_cross_module_shared_state(tmp_path):
    """A handler mutating another module's shared dict through a module
    import is resolved to the owning module."""
    rep = _races(
        tmp_path,
        """
    from http.server import BaseHTTPRequestHandler
    from . import store

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            store.table["k"] = 1
    """,
        extra_modules={"store": "table = {}\n"},
    )
    assert [f.state for f in rep.active] == ["pkg.store.table"]


def test_self_method_thread_target_is_rooted(tmp_path):
    """Thread(target=self._method) inside a class resolves the sibling
    method as a root (the AdmissionQueue._worker_main shape)."""
    rep = _races(
        tmp_path,
        """
    import threading

    _pending = []

    class Q:
        def start(self):
            threading.Thread(target=self._worker_main).start()

        def _worker_main(self):
            _pending.append(1)
    """,
    )
    assert [f.state for f in rep.active] == ["pkg.mod._pending"]
    assert "Q._worker_main" in rep.active[0].thread_root


def test_nested_function_thread_target_is_rooted(tmp_path):
    """A def nested inside the spawning function (the guarded_call._worker
    shape) is resolved via its enclosing scope."""
    rep = _races(
        tmp_path,
        """
    import threading

    _done = []

    def guarded_call(fn):
        def _worker():
            _done.append(fn())

        threading.Thread(target=_worker).start()
    """,
    )
    assert [f.state for f in rep.active] == ["pkg.mod._done"]
    assert "guarded_call._worker" in rep.active[0].thread_root


def test_executor_submit_target_is_rooted(tmp_path):
    rep = _races(
        tmp_path,
        """
    from concurrent.futures import ThreadPoolExecutor

    _results = []

    def job(x):
        _results.append(x)

    def run(pool: ThreadPoolExecutor):
        pool.submit(job, 1)
    """,
    )
    assert [f.state for f in rep.active] == ["pkg.mod._results"]
    assert "executor task" in rep.active[0].thread_root


def test_cross_class_attribute_call_is_audited(tmp_path):
    """self.<attr>.<method>() hops into the attribute's class when the
    method name is unique package-wide (the SchedulerLoop.run_forever ->
    session.take_pack shape). The callee lives in another module, so only
    the hop — not the root-module blanket audit — can reach it."""
    rep = _races(
        tmp_path,
        """
    import threading
    from .sess import Session

    class Loop:
        def __init__(self):
            self.session = Session()

        def run_forever(self):
            self.session.take_pack_unique()

        def start(self):
            threading.Thread(target=self.run_forever).start()
    """,
        extra_modules={
            "sess": """
    _packs = []

    class Session:
        def take_pack_unique(self):
            _packs.append(1)
    """,
        },
    )
    assert [f.state for f in rep.active] == ["pkg.sess._packs"]


def test_ambiguous_method_name_not_resolved(tmp_path):
    """Two classes defining the same method name => the self.<attr>.m()
    hop stays unresolved (no guessing), so the other-module mutation is
    unreachable."""
    rep = _races(
        tmp_path,
        """
    import threading
    from .sess import A

    class Loop:
        def __init__(self):
            self.session = A()

        def run_forever(self):
            self.session.step()

        def start(self):
            threading.Thread(target=self.run_forever).start()
    """,
        extra_modules={
            "sess": """
    _packs = []

    class A:
        def step(self):
            _packs.append(1)

    class B:
        def step(self):
            pass
    """,
        },
    )
    assert rep.ok, rep.render_text()


# ---------------------------------------------------------------------------
# near-miss negatives
# ---------------------------------------------------------------------------

def test_with_lock_dominated_mutation_ok(tmp_path):
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            with _lock:
                _cache[self.path] = 1
    """,
    )
    assert rep.ok, rep.render_text()


def test_guarded_by_annotation_trusted(tmp_path):
    """@guarded_by asserts the caller holds the lock (e.g. a non-with
    acquire like server.py's do_POST) — the body is treated as dominated."""
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    from pkg.conc import guarded_by

    @guarded_by("_lock")
    def refresh(k):
        global _hits
        _hits = _hits + 1
        _cache[k] = _hits

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            with _lock:
                refresh(self.path)
    """,
        extra_modules={
            "conc": "def guarded_by(name):\n    return lambda fn: fn\n"
        },
    )
    assert rep.ok, rep.render_text()


def test_plain_publish_not_flagged(tmp_path):
    """A single rebind with no read in the same function is an atomic
    publish under the GIL — the serve()-resets-the-snapshot shape."""
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    _snapshot = None

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            global _snapshot
            _snapshot = None
    """,
    )
    assert rep.ok, rep.render_text()


def test_pure_reads_not_flagged(tmp_path):
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            x = _cache.get(self.path)
            y = _hits
            return (x, y)
    """,
    )
    assert rep.ok, rep.render_text()


def test_unreachable_mutation_not_flagged(tmp_path):
    """No thread roots in the package => nothing is audited."""
    rep = _races(
        tmp_path,
        """
    _cache = {}

    def mutate():
        _cache["k"] = 1
    """,
    )
    assert rep.ok
    assert rep.audited_functions == 0


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def test_audit_ok_suppression_and_staleness(tmp_path):
    src = HANDLER_PREAMBLE + """
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            _cache[self.path] = 1  # osim: audit-ok[race]
            x = 1  # osim: audit-ok[race]
    """
    rep = _races(tmp_path, src)
    assert rep.active == []
    assert [f.suppressed for f in rep.findings] == [True]
    # the second comment suppresses nothing -> stale, and ok stays False
    assert [(u.line, u.rule) for u in rep.unused_suppressions] == [
        (rep.findings[0].line + 1, "race")
    ]
    assert not rep.ok


def test_report_json_is_deterministic(tmp_path):
    src = HANDLER_PREAMBLE + """
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            global _hits
            _hits += 1
            _cache[self.path] = 1
    """
    a = json.dumps(_races(tmp_path, src).to_dict(), sort_keys=True)
    b = json.dumps(_races(tmp_path, src).to_dict(), sort_keys=True)
    assert a == b
    doc = json.loads(a)
    assert [f["access"] for f in doc["findings"]] == ["rmw", "mutate"]


# ---------------------------------------------------------------------------
# package-level regression gate + the fixed server.py bugs
# ---------------------------------------------------------------------------

def test_installed_package_has_no_unguarded_races():
    rep = run_races()
    assert rep.ok, rep.render_text()
    # the audit actually looked at the threaded surface
    assert rep.audited_functions > 0
    assert any("do_POST" in r or "do_GET" in r for r in rep.thread_roots)


def test_package_thread_roots_cover_workers_and_watchdog():
    """The enclosing-scope pass must root the admission worker (a
    Thread(target=self._worker_main) sibling) and the watchdog's nested
    _worker def — the two shapes the module-scope pass used to miss."""
    rep = run_races()
    roots = "\n".join(rep.thread_roots)
    assert "AdmissionQueue._worker_main" in roots, roots
    assert "guarded_call._worker" in roots, roots


def test_known_good_guarded_modules_not_flagged():
    """policy.py's _breakers and tracing's history are with-lock guarded;
    they must appear as shared state yet produce no findings."""
    rep = run_races()
    assert any("policy._breakers" in s for s in rep.shared_objects)
    assert not [f for f in rep.findings if "policy" in f.state]


def test_heap_profile_check_then_act_is_serialized():
    """Regression for the _tracemalloc_on race: concurrent heap profiles
    must agree that exactly one of them started tracing."""
    from open_simulator_tpu_torch.server import server

    server._tracemalloc_on = False
    results = []
    barrier = threading.Barrier(4)

    def go():
        barrier.wait()
        results.append(server._heap_profile()["note"] != "")

    threads = [threading.Thread(target=go) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        # tracing every allocation would slow the rest of the file ~40x
        import tracemalloc

        tracemalloc.stop()
        server._tracemalloc_on = False
    assert sum(results) == 1, results


def test_live_snapshot_declares_its_lock():
    from open_simulator_tpu_torch.server import server
    from open_simulator_tpu_torch.utils.concurrency import GUARDED_BY_ATTR

    assert (
        getattr(server._refresh_snapshot_locked, GUARDED_BY_ATTR)
        == "_snapshot_lock"
    )


def test_build_context_reuse_matches_fresh_run():
    """run_races accepts a prebuilt context (the audit driver path)."""
    ctx = build_context()
    a = run_races(ctx=ctx).to_dict()
    b = run_races().to_dict()
    assert a == b


# ---------------------------------------------------------------------------
# lock-order deadlock pass
# ---------------------------------------------------------------------------

DEADLOCK_PREAMBLE = """
    import threading
    import queue

    lock_a = threading.Lock()
    lock_b = threading.Lock()
    _q = queue.Queue()
"""


def test_lock_order_cycle_flagged(tmp_path):
    rep = _races(
        tmp_path,
        DEADLOCK_PREAMBLE + """
    def worker():
        with lock_a:
            with lock_b:
                pass

    def other():
        with lock_b:
            with lock_a:
                pass

    threading.Thread(target=worker).start()
    threading.Thread(target=other).start()
    """,
    )
    cyc = [f for f in rep.active if f.rule == "deadlock"]
    assert len(cyc) == 1 and "lock-order cycle" in cyc[0].message
    assert sorted(rep.lock_edges) == [
        "pkg.mod:lock_a -> pkg.mod:lock_b",
        "pkg.mod:lock_b -> pkg.mod:lock_a",
    ]
    assert not rep.ok


def test_lock_order_cycle_through_callee_flagged(tmp_path):
    """The interprocedural half: B is acquired via a helper call made
    while A is held."""
    rep = _races(
        tmp_path,
        DEADLOCK_PREAMBLE + """
    def worker():
        with lock_a:
            helper()

    def helper():
        with lock_b:
            pass

    def other():
        with lock_b:
            with lock_a:
                pass

    threading.Thread(target=worker).start()
    threading.Thread(target=other).start()
    """,
    )
    assert any("lock-order cycle" in f.message for f in rep.active)


def test_consistent_lock_order_not_flagged(tmp_path):
    rep = _races(
        tmp_path,
        DEADLOCK_PREAMBLE + """
    def worker():
        with lock_a:
            with lock_b:
                pass

    def other():
        with lock_a:
            with lock_b:
                pass

    threading.Thread(target=worker).start()
    threading.Thread(target=other).start()
    """,
    )
    assert rep.ok, rep.render_text()
    assert rep.lock_edges == ["pkg.mod:lock_a -> pkg.mod:lock_b"]


def test_self_deadlock_on_plain_lock_flagged(tmp_path):
    rep = _races(
        tmp_path,
        DEADLOCK_PREAMBLE + """
    def worker():
        with lock_a:
            with lock_a:
                pass

    threading.Thread(target=worker).start()
    """,
    )
    assert any("self-deadlock" in f.message for f in rep.active)


def test_rlock_reentry_not_flagged(tmp_path):
    rep = _races(
        tmp_path,
        """
    import threading

    rl = threading.RLock()

    def worker():
        with rl:
            with rl:
                pass

    threading.Thread(target=worker).start()
    """,
    )
    assert rep.ok, rep.render_text()


def test_blocking_get_and_join_under_lock_flagged(tmp_path):
    rep = _races(
        tmp_path,
        DEADLOCK_PREAMBLE + """
    class Pool:
        def __init__(self):
            self._mu = threading.Lock()
            self._t = threading.Thread(target=self._run)

        def _run(self):
            with self._mu:
                item = _q.get()
            with self._mu:
                self._t.join()
    """,
    )
    verbs = sorted(
        f.message.split("`")[1] for f in rep.active if f.access == "blocking"
    )
    assert verbs == [".get()", ".join()"]
    # instance lock resolved to its class-qualified identity
    assert all("Pool._mu" in f.state for f in rep.active)


def test_bounded_waits_and_dict_get_not_flagged(tmp_path):
    rep = _races(
        tmp_path,
        DEADLOCK_PREAMBLE + """
    _d = {}

    def worker():
        with lock_a:
            item = _q.get(timeout=1.0)
            v = _d.get("k")
            "x".join(["a"])

    threading.Thread(target=worker).start()
    """,
    )
    assert rep.ok, rep.render_text()


def test_deadlock_suppression_and_staleness(tmp_path):
    rep = _races(
        tmp_path,
        DEADLOCK_PREAMBLE + """
    def worker():
        with lock_a:
            item = _q.get()  # osim: audit-ok[deadlock]
            x = 1  # osim: audit-ok[deadlock]

    threading.Thread(target=worker).start()
    """,
    )
    assert not rep.active
    assert [f.rule for f in rep.findings if f.suppressed] == ["deadlock"]
    assert len(rep.unused_suppressions) == 1
    assert not rep.ok  # the stale suppression keeps the audit red


def test_race_suppression_does_not_silence_deadlock(tmp_path):
    rep = _races(
        tmp_path,
        DEADLOCK_PREAMBLE + """
    def worker():
        with lock_a:
            item = _q.get()  # osim: audit-ok[race]

    threading.Thread(target=worker).start()
    """,
    )
    assert any(f.rule == "deadlock" for f in rep.active)
    # and the race escape is stale: it matched no race finding
    assert len(rep.unused_suppressions) == 1


# ---------------------------------------------------------------------------
# thread-root surfaces: watchdog-guarded callables + subprocess
# wrappers
# ---------------------------------------------------------------------------

def test_guarded_call_target_is_a_thread_root(tmp_path):
    """guarded_call(stage, fn, deadline) runs fn on a watchdog worker
    thread; an unguarded mutation inside fn must be flagged."""
    rep = _races(
        tmp_path,
        """
    import threading

    _lock = threading.Lock()
    _progress = {}

    def _sweep():
        _progress["chunk"] = 1

    def drive(guarded_call):
        guarded_call("sweep", _sweep, 30.0)
    """,
    )
    assert any("watchdog-guarded call" in r for r in rep.thread_roots)
    assert [f.access for f in rep.active] == ["mutate"]
    assert rep.active[0].state == "pkg.mod._progress"


def test_subprocess_wrapper_is_a_thread_root(tmp_path):
    """A function that launches a child process keeps running concurrently
    with it; its own shared-state writes are audited like a thread's."""
    rep = _races(
        tmp_path,
        """
    import subprocess as _sp
    import sys

    _runs = {}

    def kill_and_resume(cfg):
        _runs[cfg] = "started"
        _sp.run([sys.executable, "-m", "child", cfg])
    """,
    )
    assert any("subprocess wrapper" in r for r in rep.thread_roots)
    assert any(f.state == "pkg.mod._runs" for f in rep.active)


def test_subprocess_helper_alias_not_misrooted(tmp_path):
    """A same-named method on a non-subprocess object must not root its
    caller (the alias has to resolve to the subprocess module)."""
    rep = _races(
        tmp_path,
        """
    class Runner:
        def run(self, argv):
            return argv

    _state = {}

    def drive(cfg):
        _state[cfg] = 1
        Runner().run([cfg])
    """,
    )
    assert not any("subprocess wrapper" in r for r in rep.thread_roots)
    assert rep.ok, rep.render_text()


def test_package_roots_cover_chaos_capacity_and_checkpoint_drivers():
    """The chaos --capacity subprocess wrapper and the watchdog-guarded
    capacity-sweep callable."""
    rep = run_races()
    roots = "\n".join(rep.thread_roots)
    assert "subprocess wrapper" in roots, roots
    assert "_run_chaos_capacity" in roots, roots
    assert "watchdog-guarded call" in roots, roots


# ---------------------------------------------------------------------------
# the port's own thread roots and repaired races
# ---------------------------------------------------------------------------

def test_context_run_thread_target_is_rooted(tmp_path):
    """`Thread(target=contextvars.copy_context().run, args=(fn, ...))` runs
    fn on the new thread (the mesh slots' pattern): fn is the root."""
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    import contextvars

    def spmd():
        def work(k):
            _cache[k] = 1

        threading.Thread(target=contextvars.copy_context().run, args=(work, 0)).start()
    """,
    )
    assert any("spmd.work" in r for r in rep.thread_roots), rep.thread_roots
    assert [f.access for f in rep.active] == ["mutate"]


def test_nested_handler_class_is_rooted(tmp_path):
    """A handler class defined inside a method (the stub servers') has its
    methods rooted under their nested qualnames."""
    rep = _races(
        tmp_path,
        HANDLER_PREAMBLE + """
    class Stub:
        def __init__(self):
            class Handler(BaseHTTPRequestHandler):
                def do_POST(self):
                    _cache["k"] = 1
            self.handler = Handler
    """,
    )
    assert any("Stub.__init__.Handler.do_POST" in r for r in rep.thread_roots)
    assert [f.access for f in rep.active] == ["mutate"]


def test_package_roots_cover_the_ports_threads():
    rep = run_races()
    roots = "\n".join(rep.thread_roots)
    for want in (
        "handler thread open_simulator_tpu_torch.server.server:_Handler.do_POST",
        "thread target open_simulator_tpu_torch.server.server:_run_job",
        "signal handler open_simulator_tpu_torch.server.server:_graceful_shutdown",
        "thread target open_simulator_tpu_torch.server.admission:AdmissionQueue._worker_main",
        "thread target open_simulator_tpu_torch.durable.watchdog:guarded_call._worker",
        "executor task open_simulator_tpu_torch.engine.extender_wave:_chain_task",
        "thread target open_simulator_tpu_torch.parallel.slots:spmd.work",
        "thread target open_simulator_tpu_torch.analysis.interleave:Shim._actor_main",
        "open_simulator_tpu_torch.tools.stubs:StubExtender.__init__.Handler.do_POST",
    ):
        assert want in roots, (want, roots)


def test_kernel_build_declares_its_lock():
    from open_simulator_tpu_torch.ops import kernel_lib
    from open_simulator_tpu_torch.utils import platform
    from open_simulator_tpu_torch.utils.concurrency import GUARDED_BY_ATTR

    assert getattr(platform._build_missing, GUARDED_BY_ATTR) == "_build_lock"
    assert getattr(kernel_lib._load, GUARDED_BY_ATTR) == "_lock"


def test_profiler_prime_is_serialized(monkeypatch):
    """Regression for the _primed check-then-act: concurrent first CUDA
    captures from handler threads prime the profiler exactly once."""
    import contextlib

    from open_simulator_tpu_torch.utils import profiling

    calls = []

    @contextlib.contextmanager
    def fake_profile(torch, activities):
        calls.append(1)
        yield

    class Dev:
        type = "cuda"

    import torch

    monkeypatch.setattr(profiling, "_primed", False)
    monkeypatch.setattr(profiling, "_profile", fake_profile)
    monkeypatch.setattr(profiling, "_activities", lambda torch, device: [])
    monkeypatch.setattr(torch, "device", lambda d: Dev())
    barrier = threading.Barrier(4)

    def go():
        barrier.wait()
        profiling.prime("cuda")

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [1] and profiling.primed()


def test_cli_audit_json(capsys):
    from open_simulator_tpu_torch import cli

    assert cli.main(["audit", "--format", "json", "--no-invariants"]) == 0
    captured = capsys.readouterr()
    doc = json.loads(captured.out)
    assert doc["ok"] is True and doc["invariants"] is None and doc["memory"] is None
    assert doc["races"]["findings"] == [] and doc["races"]["audited_functions"] > 0
    assert "not in the port yet" not in captured.err
    assert cli.main(["audit", "--no-invariants"]) == 0
    assert "not in the port yet" not in capsys.readouterr().err


def test_audit_report_matches_the_reference_shape():
    """The port's audit report has the reference's keys, with invariants
    null under --no-invariants in both."""
    from open_simulator_tpu.analysis.audit import run_semantic_audit as ref_audit
    from open_simulator_tpu_torch.analysis.audit import run_semantic_audit

    ref = ref_audit(invariants=False).to_dict()
    port = run_semantic_audit(invariants=False).to_dict()
    assert set(port) == set(ref)
    assert set(port["races"]) == set(ref["races"])
    assert port["invariants"] is None and ref["invariants"] is None


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


def test_kernel_launch_counts_are_exact_across_threads(monkeypatch):
    """ops/kernel_lib.py's launch counters under contention: more threads
    than cores launching a stand-in library, with a short switch interval;
    the process count rises by every launch, each thread's by its own."""
    import sys
    import types

    from open_simulator_tpu_torch.ops import kernel_lib

    source = kernel_lib.KERNELS["domain_pop"].source
    monkeypatch.setattr(kernel_lib, "_libs", {
        source: types.SimpleNamespace(domain_pop_launch=lambda *args: 0)})
    n_threads, per_thread = 16, 500
    before = kernel_lib.launches("domain_pop")
    seen = []

    def work():
        mine = kernel_lib.thread_launches("domain_pop")
        for _ in range(per_thread):
            kernel_lib.launch("domain_pop", "domain_pop_launch")
        seen.append(kernel_lib.thread_launches("domain_pop") - mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert seen == [per_thread] * n_threads
    assert kernel_lib.launches("domain_pop") == before + n_threads * per_thread
