"""The port's sanitizer (ops/sanitize.py, OSIM_SANITIZE=1) on the CPU: the
cases of tests/test_sanitize.py (environment parsing, the passthrough when
off, a violation raising and counting, a clean call's value, arguments
bound by name for `skip`, a nested entry, the registry's coverage) plus the
three checks the TorchDispatchMode makes (a NaN output, an out-of-range
index caught before the op, an integer division by zero) and the kernel
route's passthrough. The quickstart's simulate() (example/simon-config.yaml)
gives the JAX package's result digest plain and sanitized. Tolerance:
digests equal exactly.
"""

import types

import pytest
import torch

from open_simulator_tpu_torch import sim_configs
from open_simulator_tpu_torch.analysis.entry_audit import REQUIRED_COVERAGE
from open_simulator_tpu_torch.ops import delta, fast, grouped, kernels, wave
from open_simulator_tpu_torch.ops.sanitize import (
    SANITIZE_ENV,
    SanitizerViolation,
    sanitizable,
    sanitize_enabled,
    sanitized_entries,
)
from open_simulator_tpu_torch.utils import metrics

torch.set_num_threads(1)  # tiny tensors: threads only add contention


@sanitizable("test:log_entry")
def _log_entry(x):
    return torch.log(x)


@sanitizable("test:skip_entry", skip=lambda a: a["n"] > 2)
def _skip_entry(x, n, scale=1.0):
    return torch.log(x) * scale + n


@sanitizable("test:outer_entry")
def _outer_entry(x):
    return _log_entry(x) + 1


@sanitizable("test:index_entry")
def _index_entry(dst, idx):
    return dst.index_add_(0, idx, torch.ones(idx.shape[0]))


@sanitizable("test:div_entry")
def _div_entry(a, b):
    return a // b


def test_env_parsing(monkeypatch):
    for off in ("", "0", "false", "no", " NO "):
        monkeypatch.setenv(SANITIZE_ENV, off)
        assert not sanitize_enabled()
    for on in ("1", "true", "yes", "on"):
        monkeypatch.setenv(SANITIZE_ENV, on)
        assert sanitize_enabled()
    monkeypatch.delenv(SANITIZE_ENV)
    assert not sanitize_enabled()


def test_disabled_passthrough_keeps_nan_silent(monkeypatch):
    monkeypatch.delenv(SANITIZE_ENV, raising=False)
    assert torch.isnan(_log_entry(torch.tensor(-1.0)))


def test_violation_raises_and_increments_metric(monkeypatch):
    monkeypatch.setenv(SANITIZE_ENV, "1")
    before = metrics.SANITIZER_VIOLATIONS.value(entry="test:log_entry")
    with pytest.raises(SanitizerViolation) as ei:
        _log_entry(torch.tensor(-1.0))
    assert ei.value.entry == "test:log_entry"
    assert "nan" in ei.value.check_message.lower()
    assert metrics.SANITIZER_VIOLATIONS.value(entry="test:log_entry") == before + 1


def test_clean_call_returns_plain_value(monkeypatch):
    monkeypatch.setenv(SANITIZE_ENV, "1")
    assert float(_log_entry(torch.tensor(1.0))) == 0.0


def test_positional_args_reach_skip_by_name(monkeypatch):
    """`skip` sees the call's arguments by parameter name whether they came
    by position or keyword (the reference binds its static args the same
    way): n > 2 runs unchecked, so the NaN passes; n <= 2 is checked."""
    monkeypatch.setenv(SANITIZE_ENV, "1")
    assert torch.isnan(_skip_entry(torch.tensor(-1.0), 3))
    assert torch.isnan(_skip_entry(torch.tensor(-1.0), n=5, scale=2.0))
    with pytest.raises(SanitizerViolation):
        _skip_entry(torch.tensor(-1.0), 1)


def test_nested_entry_runs_under_the_outer_check(monkeypatch):
    """An entry called inside another one runs under the outer entry's
    checks (the reference's _has_tracer passthrough): the violation is the
    outer entry's and is counted once."""
    monkeypatch.setenv(SANITIZE_ENV, "1")
    inner0 = metrics.SANITIZER_VIOLATIONS.value(entry="test:log_entry")
    outer0 = metrics.SANITIZER_VIOLATIONS.value(entry="test:outer_entry")
    with pytest.raises(SanitizerViolation) as ei:
        _outer_entry(torch.tensor(-1.0))
    assert ei.value.entry == "test:outer_entry"
    assert metrics.SANITIZER_VIOLATIONS.value(entry="test:log_entry") == inner0
    assert metrics.SANITIZER_VIOLATIONS.value(entry="test:outer_entry") == outer0 + 1
    assert float(_outer_entry(torch.tensor(1.0))) == 1.0


def test_all_registry_entries_are_sanitizable():
    entries = sanitized_entries(delta, fast, grouped, kernels, wave)
    assert set(entries) == set(REQUIRED_COVERAGE)
    for name, fn in entries.items():
        assert fn.__wrapped__ is not None and isinstance(fn.__osim_donate_argnums__, tuple), name


def test_nan_output_raises(monkeypatch):
    monkeypatch.setenv(SANITIZE_ENV, "1")

    @sanitizable("test:inf_times_zero")
    def inf_times_zero(x):
        return x * torch.zeros_like(x)

    with pytest.raises(SanitizerViolation, match="nan generated by primitive: mul"):
        inf_times_zero(torch.tensor([1.0, float("-inf")]))
    # infinities alone pass, as checkify's nan_checks let them
    assert torch.isinf(_log_entry(torch.tensor(0.0)))


def test_out_of_range_index_raises_before_the_op(monkeypatch):
    monkeypatch.setenv(SANITIZE_ENV, "1")
    dst = torch.zeros(4)
    with pytest.raises(SanitizerViolation, match="out-of-bounds index 4 in index_add"):
        _index_entry(dst, torch.tensor([1, 4]))
    assert float(dst.sum()) == 0.0  # the op never ran
    with pytest.raises(SanitizerViolation, match="out-of-bounds index -1 in index_add"):
        _index_entry(dst, torch.tensor([-1]))

    # wrap-around negative indices that torch accepts pass; past -size fails
    @sanitizable("test:getitem")
    def getitem(x, i):
        return x[i]

    assert float(getitem(torch.arange(4.0), torch.tensor([-1]))) == 3.0
    with pytest.raises(SanitizerViolation, match="out-of-bounds index -5 in index"):
        getitem(torch.arange(4.0), torch.tensor([-5]))
    assert float(_index_entry(torch.zeros(4), torch.tensor([3])).sum()) == 1.0


def test_integer_division_by_zero_raises(monkeypatch):
    monkeypatch.setenv(SANITIZE_ENV, "1")
    with pytest.raises(SanitizerViolation, match="division by zero in integer floor_divide"):
        _div_entry(torch.tensor([4, 2]), torch.tensor([2, 0]))
    assert _div_entry(torch.tensor([4]), torch.tensor([2])).tolist() == [2]
    # a float division by zero is an infinity, not a violation
    assert torch.isinf(_div_entry(torch.tensor([1.0]), torch.tensor([0.0]))).all()


def test_kernel_route_passes_through_unsanitized():
    """domain_select runs unchecked exactly when it launches the domain_pop
    kernel: tensors on a card and a spread-only group."""
    spread_only = fast.ALL_DYNAMIC._replace(
        **{f: False for f in fast.GroupFlags._fields if "aff" in f or "anti" in f}
    )
    on = types.SimpleNamespace(packed=types.SimpleNamespace(device=torch.device("cuda")))
    off = types.SimpleNamespace(packed=torch.zeros(1))
    assert not fast._any_affinity(spread_only)
    assert fast._takes_kernel({"traj": on, "flags": spread_only})
    assert not fast._takes_kernel({"traj": off, "flags": spread_only})
    assert not fast._takes_kernel({"traj": on, "flags": fast.ALL_DYNAMIC})


def _quickstart_digest(pkg):
    import importlib

    config = importlib.import_module(f"{pkg}.api.config")
    apply = importlib.import_module(f"{pkg}.engine.apply")
    sim = importlib.import_module(f"{pkg}.engine.simulator")
    workloads = importlib.import_module(f"{pkg}.core.workloads")
    from open_simulator_tpu_torch.sim_configs import result_digest

    workloads.reset_name_rng()
    cfg = config.SimonConfig.load("example/simon-config.yaml")
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    return result_digest(sim.simulate(apply.build_cluster(cfg), apply.build_apps(cfg), **kw))


def test_simulation_parity_plain_vs_sanitized(monkeypatch):
    monkeypatch.delenv(SANITIZE_ENV, raising=False)
    want = _quickstart_digest("open_simulator_tpu")
    assert want == sim_configs.QUICKSTART_SIM_DIGEST[0]
    violations0 = sum(s["value"] for s in metrics.SANITIZER_VIOLATIONS.snapshot()["samples"])
    assert _quickstart_digest("open_simulator_tpu_torch") == want
    monkeypatch.setenv(SANITIZE_ENV, "1")
    assert _quickstart_digest("open_simulator_tpu_torch") == want
    assert sum(s["value"] for s in metrics.SANITIZER_VIOLATIONS.snapshot()["samples"]) == violations0


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
