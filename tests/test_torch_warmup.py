"""The port's entry registry and warmup (analysis/entry_audit.py,
engine/warmup.py, utils/platform.py) against the JAX package's, on the CPU.

- The copied constants (the 23 audit names, the required coverage) equal
  the reference's, and the registry captures all of them.
- Per audit name: the arguments the port's capture recorded equal the JAX
  capture's, leaf by leaf in numpy (parameters matched by name; the few
  parameters only one side has, such as the port's wave `parts` or the
  reference's unpacked domain plan, are left out); the port entry's output
  on its arguments equals the JAX entry's output on the JAX arguments,
  exactly; two calls on `_fresh_args` give equal outputs and leave every
  argument the entry does not write in place unchanged. The per-pod grouped
  scan (`ops.grouped:_group_jit`, the port's `schedule_group`) is compared
  through its dispatcher, schedule_batch_grouped, because the reference
  pads its group to a bucket the port does not; the universes-axis wave
  round is compared directly and through schedule_universes_wave_host.
- run_warmup() is ok; warm_start_check() is ok with the JAX _run_sweeps'
  answer; CompileCounter counts a (stand-in) nvcc build and a load, in the
  directory OSIM_COMPILE_CACHE names at build time.

Both captures pin the scenario driver to its one-scan route
(OSIM_WAVE_COMMIT=0 for the reference; the port pins it itself), so that
`schedule_scenarios` is captured on an 8-core host too. Tolerance: exact.
"""

import ast
import inspect
import os
import stat
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from open_simulator_tpu.analysis import jaxpr_audit as jaudit
from open_simulator_tpu.ops import grouped as jgrouped
from open_simulator_tpu_torch import native as tnative
from open_simulator_tpu_torch import sim_configs
from open_simulator_tpu_torch.analysis import entry_audit as taudit
from open_simulator_tpu_torch.engine import warmup as twarmup
from open_simulator_tpu_torch.ops import grouped as tgrouped
from open_simulator_tpu_torch.ops import kernel_lib
from open_simulator_tpu_torch.utils import metrics as tmetrics
from open_simulator_tpu_torch.utils import platform as tplatform
from open_simulator_tpu_torch.utils.profiling import _fresh_args

torch.set_num_threads(1)  # tiny tensors: threads only add contention

# entries compared through the dispatcher that calls them
VIA_DISPATCHER = {"ops.grouped:_group_jit"}


@pytest.fixture(scope="module")
def captures():
    """(JAX captures, port captures), each by audit name."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OSIM_WAVE_COMMIT", "0")
    mp.delenv("OSIM_COMMIT_CHUNK", raising=False)
    try:
        jcaps = {c.name: c for c in jaudit._capture_calls()}
        tcaps = {c.name: c for c in taudit._capture_calls("cpu")}
    finally:
        mp.undo()
    return jcaps, tcaps


def _leaf(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (bool, int, float, np.generic)) or hasattr(x, "dtype"):
        return np.asarray(x)
    return None


def _flatten(x, path, out):
    """{path: numpy leaf} of nested NamedTuples, tuples, lists and dicts;
    leaves that are not arrays or numbers are skipped."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for f, v in zip(x._fields, x):
            _flatten(v, f"{path}.{f}", out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _flatten(v, f"{path}[{i}]", out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _flatten(x[k], f"{path}[{k!r}]", out)
    elif x is not None:
        leaf = _leaf(x)
        if leaf is not None:
            out[path] = leaf
    return out


def _bound(fn, args, kwargs) -> dict:
    sig = inspect.signature(inspect.unwrap(fn))
    bound = sig.bind(*args, **kwargs)
    return dict(bound.arguments)


def _assert_leaves_equal(want: dict, got: dict, what: str, check_dtype=True):
    assert want.keys() == got.keys(), (what, sorted(want.keys() ^ got.keys()))
    for k in want:
        a, b = want[k], got[k]
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if check_dtype and a.ndim:
            assert a.dtype == b.dtype, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


def _outputs(fn, args, kwargs):
    return _flatten(fn(*args, **kwargs), "out", {})


def test_constants_equal_reference():
    short = {m.split(".", 1)[1]: a for m, a in jaudit.AUDIT_TARGETS.items()}
    assert {m.split(".", 1)[1]: a for m, a in taudit.AUDIT_TARGETS.items()} == short
    assert taudit.REQUIRED_COVERAGE == jaudit.REQUIRED_COVERAGE
    assert len(taudit.REQUIRED_COVERAGE) == 23
    assert set(taudit.entry_locations()) == set(taudit.REQUIRED_COVERAGE)


def test_registry_covers_required(captures):
    jcaps, tcaps = captures
    assert set(tcaps) == set(taudit.REQUIRED_COVERAGE)
    assert set(jcaps) == set(jaudit.REQUIRED_COVERAGE)
    donated = {n: tuple(getattr(c.fn, "__osim_donate_argnums__", ())) for n, c in tcaps.items()}
    assert donated["ops.delta:apply_rows"] == donated["ops.delta:apply_flags"] == (0,)
    assert all(v == () for n, v in donated.items() if not n.startswith("ops.delta:apply"))


@pytest.mark.parametrize("name", sorted(jaudit.REQUIRED_COVERAGE))
def test_entry_matches_jax(captures, name):
    jcaps, tcaps = captures
    jcap, tcap = jcaps[name], tcaps[name]
    # the same arguments, leaf by leaf
    jb = _bound(jcap.fn, jcap.args, jcap.kwargs)
    tb = _bound(tcap.fn, tcap.args, tcap.kwargs)
    common = sorted(set(jb) & set(tb))
    assert {"ns", "ns_s"} & set(common) or name.startswith(("ops.delta", "ops.fast:cur_at",
                                                              "ops.fast:gather_takes")), common
    if name not in VIA_DISPATCHER:
        for p in common:
            _assert_leaves_equal(_flatten(jb[p], p, {}), _flatten(tb[p], p, {}), name,
                                 check_dtype=False)
    # two calls on fresh arguments: equal outputs, untouched arguments
    before = _flatten(tcap.args, "args", {})
    first = _outputs(tcap.fn, _fresh_args(tcap), tcap.kwargs)
    second = _outputs(tcap.fn, _fresh_args(tcap), tcap.kwargs)
    _assert_leaves_equal(first, second, f"{name} (second call)")
    _assert_leaves_equal(before, _flatten(tcap.args, "args", {}), f"{name} (arguments)")
    if name in VIA_DISPATCHER:
        return
    # the port's output equals the JAX entry's, exactly
    jargs = jax.tree.map(lambda a: a.copy() if hasattr(a, "copy") else a, jcap.args)
    want = _outputs(jcap.fn, jargs, jcap.kwargs)
    _assert_leaves_equal(want, first, name)


def test_group_scan_matches_jax_through_dispatcher():
    """ops.grouped:_group_jit through schedule_batch_grouped on the
    canonical state: every output and carry leaf equal."""
    from open_simulator_tpu.ops import kernels as jkern

    jns, jcarry, jbatch = jaudit.canonical_state()
    tns, tcarry, tbatch = taudit.canonical_state("cpu")
    want = jgrouped.schedule_batch_grouped(jns, jcarry, jbatch, jkern.weights_array())
    got = tgrouped.schedule_batch_grouped(
        tns, tcarry, tbatch, torch.as_tensor(np.asarray(jkern.weights_array())), device="cpu",
    )
    _assert_leaves_equal(_flatten(want, "out", {}), _flatten(got, "out", {}), "grouped")


def test_universes_wave_matches_jax_through_dispatcher(captures):
    """ops.fast:schedule_universes_wave (the port's wave.universe_round)
    driven to its fixpoint by both packages' schedule_universes_wave_host,
    on the captured universe stack cut to its first 6 pods: every output
    and carry leaf equal."""
    from open_simulator_tpu.ops import fast as jfast
    from open_simulator_tpu_torch.ops import fast as tfast

    jcaps, tcaps = captures
    jns, jcarry, jpods, jw = jcaps["ops.fast:schedule_universes"].args[:4]
    tns, tcarry, tpods, tw = tcaps["ops.fast:schedule_universes"].args[:4]
    want = jfast.schedule_universes_wave_host(
        jns, jax.tree.map(lambda a: a.copy(), jcarry), jax.tree.map(lambda a: a[:, :6], jpods), jw,
    )
    got = tfast.schedule_universes_wave_host(
        tns, tcarry, type(tpods)(*(a[:, :6] for a in tpods)), tw,
    )
    _assert_leaves_equal(_flatten(want, "out", {}), _flatten(got, "out", {}), "universes wave")


def test_run_warmup_ok(captures, monkeypatch):
    _, tcaps = captures
    monkeypatch.setattr(twarmup, "warmup_registry", lambda device="cpu": list(tcaps.values()))
    report = twarmup.run_warmup(include_sweep=True, device="cpu")
    assert report.ok, report.missing
    assert {e.name for e in report.entries} == set(taudit.REQUIRED_COVERAGE)
    assert report.backend_compiles == 0  # the CPU builds no kernel
    assert report.native  # the native host runtime loads on every device
    assert 0 <= report.build_seconds < report.seconds
    assert report.ladder_rungs and all(n % 64 == 0 for n in report.ladder_rungs)
    assert {e.name: e.seconds for e in report.entries} == {
        n: c.first_seconds for n, c in tcaps.items()}
    d = report.to_dict()
    assert d["ok"] and d["swept"] and len(d["entries"]) == 23
    assert "warmup: ok" in report.render_text()


def test_warm_start_check_matches_jax_sweeps():
    got = taudit.warm_start_check(device="cpu")
    plan, plan_b = jaudit._run_sweeps()
    assert got.ok, got.to_dict()
    assert got.cold_compiles == 0
    assert got.nodes_added == got.batched_nodes_added == plan.nodes_added == plan_b.nodes_added
    assert sim_configs.WARM_START_NODES_ADDED == plan.nodes_added
    assert "warm-start check: ok" in got.render_text()


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc: prints a version, or writes the -o file."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        "if [ \"$1\" = --version ]; then echo 'fake nvcc 0'; exit 0; fi\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then echo so > \"$2\"; fi; shift; done\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script


def test_compile_counter_counts_build_and_load(tmp_path, monkeypatch):
    monkeypatch.setenv("NVCC", str(_fake_nvcc(tmp_path)))
    # set after import: the directory is read at build time
    monkeypatch.setenv("OSIM_COMPILE_CACHE", str(tmp_path / "cache"))
    tplatform.install_compile_listener()
    builds0 = tmetrics.COMPILE_CACHE.value(event="backend_compile")
    hits0 = tmetrics.COMPILE_CACHE.value(event="persistent_hit")
    source = kernel_lib.KERNELS["domain_pop"].source
    with tplatform.CompileCounter() as cold:
        (so,) = tplatform.build_kernels(source)
    assert (cold.backend_compiles, cold.persistent_hits, cold.cold_compiles) == (1, 0, 1)
    assert so.is_file() and so.parent.parent == tmp_path / "cache"
    assert so.parent == tplatform.build_dir() == Path(tplatform.enable_compilation_cache())
    with tplatform.CompileCounter() as warm:
        assert tplatform.build_kernels(source) == [so]
    assert (warm.backend_compiles, warm.persistent_hits, warm.cold_compiles) == (0, 1, 0)
    assert tmetrics.COMPILE_CACHE.value(event="backend_compile") == builds0 + 1
    assert tmetrics.COMPILE_CACHE.value(event="persistent_hit") == hits0 + 1


def test_compile_cache_unset_is_build_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("OSIM_COMPILE_CACHE", raising=False)
    assert tplatform.build_dir() == tplatform.BUILD_DIR
    monkeypatch.setattr(tplatform, "BUILD_DIR", tmp_path)
    assert tplatform.build_dir() == tmp_path
    assert tplatform.enable_compilation_cache() == str(tmp_path)
    assert not os.listdir(tmp_path)


def test_warmup_builds_exactly_the_registry(monkeypatch):
    """On a card, warmup and the warm-start check build the sources of
    ops/kernel_lib.py's registry in one nvcc step, and nothing else; on the
    CPU they build no kernel."""
    built = []
    monkeypatch.setattr(tplatform, "build_kernels", lambda *src: built.append(src) or [])
    monkeypatch.setattr(tnative, "available", lambda: True)
    assert twarmup.build_libraries(torch.device("cuda")) is True
    assert built == [tuple(k.source for k in kernel_lib.KERNELS.values())]
    assert twarmup.build_libraries(torch.device("cpu")) is True
    assert len(built) == 1


def _imported_modules(path: Path, root: Path):
    """(line, absolute module name) of every import in `path`, a module of
    the package at `root`."""
    package = [root.name, *path.relative_to(root).parent.parts]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield from ((node.lineno, f"{mod}.{a.name}") for a in node.names)


@pytest.mark.parametrize("package", ["utils", "native"])
def test_build_layer_imports_nothing_from_ops(package):
    """The build step (utils/platform.py) and the native runtime sit below
    ops/: no module of utils/ or native/ imports from it."""
    root = Path(tplatform.__file__).resolve().parents[1]
    bad = [f"{path.relative_to(root)}:{line} {name}"
           for path in sorted((root / package).rglob("*.py"))
           for line, name in _imported_modules(path, root)
           if name.startswith(f"{root.name}.ops.")]
    assert bad == []


def test_acquire_backend_runs_the_warm_phase(tmp_path, monkeypatch):
    """OSIM_WARMUP=1: the warmup phase runs after the first contact and is
    journaled; a failing warmup is journaled and the run goes on cold, on
    the same device."""
    from open_simulator_tpu_torch.durable import watchdog
    from open_simulator_tpu_torch.durable.journal import RunJournal

    report = twarmup.WarmupReport(entries=[], missing=[], seconds=0.5, backend_compiles=0,
                                  persistent_hits=0, cache_dir="build")
    monkeypatch.setattr(twarmup, "run_warmup", lambda device="cpu": report)
    monkeypatch.setenv("OSIM_WARMUP", "1")
    j = RunJournal.open(str(tmp_path / "a"))
    info = watchdog.acquire_backend(journal=j, device="cpu")
    assert info["device"] == "cpu" and info["warmup"]["ok"]
    assert [e["event"] for e in j.events()][-2:] == ["backend", "warmup"]

    def boom(device="cpu"):
        raise RuntimeError("warmup exploded")

    monkeypatch.setattr(twarmup, "run_warmup", boom)
    j2 = RunJournal.open(str(tmp_path / "b"))
    info = watchdog.acquire_backend(journal=j2, device="cpu")
    assert info["device"] == "cpu" and info["warmup"] == {"ok": False, "error": "warmup exploded"}
    assert [e["event"] for e in j2.events()][-1] == "warmup_error"
    monkeypatch.delenv("OSIM_WARMUP")
    assert "warmup" not in watchdog.acquire_backend(device="cpu")


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
