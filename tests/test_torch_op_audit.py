"""The port's op census and recompile guard (open_simulator_tpu_torch/
analysis/op_audit.py) on the CPU: the counterparts of
tests/test_jaxpr_audit.py. Seeded bad entries (a host read, a hidden host
read inside a loop body and under torch.func.vmap, a float64 value, an
int64 result, an aliased donation) must fail the census and their clean
near misses pass; the real short entries (the delta entries, commit_step,
cur_at and domain_select) pass it, domain_select within its listed scalar
reads; the guard gives the JAX package's `nodes_added`, `attempts`,
`scenario_programs` and `ladder_rungs` on the same sweep; the reference's
constants are tripwired. The full 23 entries run on the card
(chip_smoke.py's tooling child).
"""

import json

import numpy as np
import pytest
import torch

from open_simulator_tpu_torch.analysis import entry_audit, op_audit
from open_simulator_tpu_torch.analysis.entry_audit import _Captured
from open_simulator_tpu_torch.ops.sanitize import sanitizable

torch.set_num_threads(1)  # tiny tensors: threads only add contention

SHORT = ("ops.delta:apply_rows", "ops.delta:apply_flags", "ops.delta:digest_fold",
         "ops.kernels:commit_step", "ops.fast:cur_at", "ops.fast:domain_select")


@sanitizable("test:host_read")
def _host_read(x):
    scale = float(x.sum())          # a sync per call
    return x * scale


@sanitizable("test:loop_read")
def _loop_read(xs):
    out = torch.zeros(())
    for i in range(xs.shape[0]):
        out = out + xs[i]
        if out.item() > 100:        # hidden in the loop body
            break
    return out


@sanitizable("test:vmap_clean")
def _vmap_clean(xs):
    return torch.func.vmap(lambda r: (r * 2).sum())(xs)


@sanitizable("test:wide_float")
def _wide_float(x):
    return (x.double() * 2.0).float()


@sanitizable("test:wide_int")
def _wide_int(x):
    return (x > 0).sum()            # an integer sum: int64 out of the entry


@sanitizable("test:index_int")
def _index_int(x, idx):
    # int64 that only indexes, and an argmin narrowed straight to int32
    return x[idx.long()] + x.argmin().to(torch.int32)


@sanitizable("test:donating", donate_argnums=(0,))
def _donating(plane, rows):
    plane[: rows.shape[0]] = rows
    return plane


@sanitizable("test:clean")
def _clean(x):
    return torch.cumsum(x * 2.0, 0).to(torch.int32)


def _cap(name, fn, *args, **kwargs):
    return _Captured(name, fn, args, kwargs, storages=entry_audit.storages_of(args, kwargs))


def _audit(cap):
    return op_audit.audit_one(cap, "cpu")


# ---------------------------------------------------------------------------
# seeded bad entries and their near misses


def test_forbidden_op_set_nonempty():
    assert op_audit.FORBIDDEN_OPS, "an empty forbidden set passes vacuously"
    assert "_local_scalar_dense" in op_audit.FORBIDDEN_OPS


def test_census_flags_a_host_read():
    rep = _audit(_cap("test:host_read", _host_read, torch.ones(4)))
    assert rep.traced and rep.n_ops > 0
    assert rep.forbidden == ["_local_scalar_dense x1"]
    assert not rep.ok


def test_census_flags_a_read_inside_a_loop_body():
    rep = _audit(_cap("test:loop_read", _loop_read, torch.ones(6)))
    assert rep.forbidden == ["_local_scalar_dense x6"]
    assert not rep.ok


def test_census_sees_through_vmap_and_passes_it():
    rep = _audit(_cap("test:vmap_clean", _vmap_clean, torch.ones(3, 4)))
    assert rep.ok, rep.to_dict()
    assert rep.n_ops > 0


def test_census_flags_float64():
    rep = _audit(_cap("test:wide_float", _wide_float, torch.ones(4)))
    assert any(w.endswith(":float64") for w in rep.wide_avals) and not rep.ok


def test_census_flags_float64_arguments():
    rep = _audit(_cap("test:clean", _clean, torch.ones(4, dtype=torch.float64)))
    assert "arg:float64" in rep.wide_avals and not rep.ok


def test_census_flags_int64_leaving_the_entry():
    rep = _audit(_cap("test:wide_int", _wide_int, torch.ones(4)))
    assert rep.wide_avals == ["sum:int64"] and not rep.ok


def test_census_passes_index_and_narrowed_int64():
    rep = _audit(_cap("test:index_int", _index_int, torch.arange(6.0),
                      torch.tensor([0, 2], dtype=torch.int32)))
    assert rep.ok, rep.to_dict()


def test_census_flags_an_aliased_donation():
    plane = torch.zeros(8)
    rep = _audit(_cap("test:donating", _donating, plane, plane[2:4]))
    assert rep.donated == [0]
    assert rep.donation_aliased == ["arg 0 aliased by arg 1"] and not rep.ok
    # a view of one storage aliases like the tensor itself; a copy does not
    ok = _audit(_cap("test:donating", _donating, plane, plane[2:4].clone()))
    assert ok.donation_aliased == [] and ok.ok


def test_census_clean_entry_passes():
    rep = _audit(_cap("test:clean", _clean, torch.ones(4)))
    assert rep.ok and rep.n_ops > 0 and rep.primitives


def test_census_reports_a_failing_call():
    rep = _audit(_cap("test:clean", _clean, "not a tensor"))
    assert not rep.traced and rep.error.startswith("call failed") and not rep.ok


def test_listed_transfer_is_bounded():
    """A listed transfer passes up to its count, and no further."""
    name = "ops.fast:domain_select"
    most, why = op_audit.LISTED_TRANSFERS[name]["_local_scalar_dense"]
    assert most == 2 and why

    @sanitizable(name)
    def reads(x, n):
        return [float(x[i]) for i in range(n)]

    assert _audit(_cap(name, reads, torch.ones(4), 2)).ok
    over = _audit(_cap(name, reads, torch.ones(4), 3))
    assert over.forbidden == ["_local_scalar_dense x3"] and not over.ok


# ---------------------------------------------------------------------------
# the real entries


@pytest.fixture(scope="module")
def captures():
    return entry_audit._capture_calls("cpu")


def test_real_short_entries_pass(captures):
    report = op_audit.run_audit(names=SHORT, device="cpu", captures=captures)
    assert report.ok, report.render_text()
    assert sorted(t.name for t in report.targets) == sorted(SHORT)
    assert report.uncovered == [] and report.required_missing == []
    by = {t.name: t for t in report.targets}
    # the kernel's two by-value scalars, listed; its plain twin reads nothing
    assert by["ops.fast:domain_select"].listed == ["_local_scalar_dense x2"]
    assert by["ops.delta:apply_rows"].donated == [0]
    assert by["ops.delta:apply_rows"].donation_aliased == []
    assert all(t.custom == {} for t in report.targets)  # no hand kernel on the CPU
    doc = json.loads(op_audit.report_json(report, None))
    assert doc["jaxpr_audit"]["ok"] and doc["recompile_guard"] is None


def test_census_at_capture_equals_the_rerun(captures):
    """The census observed during the capture and the census of a re-run
    on the stored copies agree, op for op."""
    names = ["ops.fast:domain_select", "ops.delta:apply_rows", "ops.fast:light_reasons"]
    seen = {}

    def around(name, fn, args, kwargs, storages):
        if name not in names:
            import contextlib

            return contextlib.nullcontext()
        seen[name] = op_audit.CensusRun(name, fn, args, kwargs, torch.device("cpu"), storages)
        return seen[name]

    entry_audit._capture_calls("cpu", around=around)
    rerun = {t.name: t for t in op_audit.run_audit(names=names, device="cpu",
                                                      captures=captures).targets}
    for name in names:
        a, b = seen[name].report.to_dict(), rerun[name].to_dict()
        a.pop("seconds"), b.pop("seconds")
        assert a == b, name


def test_capture_records_the_storages_before_copying(captures):
    by = {c.name: c for c in captures}
    cap = by["ops.delta:apply_rows"]
    assert cap.storages is not None and len(cap.storages["args"]) == len(cap.args)
    # the stored copies are fresh storages, not the captured call's
    assert cap.args[0].untyped_storage().data_ptr() not in cap.storages["args"][0]


def test_run_audit_unknown_entry_raises():
    with pytest.raises(KeyError):
        op_audit.run_audit(names=["ops.fast:no_such_entry"], device="cpu")


# ---------------------------------------------------------------------------
# the recompile guard


def test_recompile_guard_matches_the_reference():
    """The port's guard on the canonical sweep: within budget, kernel builds
    equal to the metric's delta, and the JAX package's answer, probes,
    scenario programs and ladder rungs on the same sweep."""
    from open_simulator_tpu.analysis.jaxpr_audit import run_recompile_guard as ref_guard

    port = op_audit.run_recompile_guard(device="cpu")
    assert port.ok, port.render_text()
    assert 0 < port.compiles <= op_audit.RECOMPILE_BUDGET
    assert port.kernel_builds == port.metric_compiles == 0  # no kernel on the CPU
    ref = ref_guard()
    assert port.nodes_added == ref.nodes_added > 0
    assert port.attempts == ref.attempts
    assert port.batched_nodes_added == ref.batched_nodes_added
    assert port.scenario_programs == ref.scenario_programs
    assert port.ladder_rungs == ref.ladder_rungs
    assert sum(port.programs.values()) == port.compiles


def test_guard_fails_over_budget_and_off_ladder():
    g = op_audit.GuardResult(compiles=5, budget=4, metric_compiles=0, nodes_added=1,
                             attempts=1, batched_nodes_added=1, ladder_rungs=[256])
    assert not g.ok
    g.budget = 48
    assert g.ok
    g.ladder_rungs = [200]
    assert not g.ladder_ok and not g.ok
    g.ladder_rungs, g.kernel_builds = [256], 1
    assert not g.ok     # builds the metric did not see
    g.scenario_programs = {"256x64": [8, 16, 32]}
    assert not g.scenario_ok


def test_signature_keys_tensors_by_shape_and_scalars_by_value():
    sig = op_audit._signature
    assert sig((torch.zeros(2, 3), 4)) == sig((torch.ones(2, 3), 4))
    assert sig((torch.zeros(2, 3), 4)) != sig((torch.zeros(2, 4), 4))
    assert sig((torch.zeros(2), 4)) != sig((torch.zeros(2), 5))
    assert sig(np.zeros(3, np.int32)) != sig(np.zeros(3, np.int64))


# ---------------------------------------------------------------------------
# tripwires against the reference's constants


def test_constants_match_the_reference():
    from open_simulator_tpu.analysis import jaxpr_audit as ref

    assert op_audit.FORBIDDEN_PRIMITIVES == ref.FORBIDDEN_PRIMITIVES
    assert op_audit.WIDE_DTYPES == ref.WIDE_DTYPES
    assert op_audit.RECOMPILE_BUDGET == ref.RECOMPILE_BUDGET == 48
    assert op_audit.SCENARIO_PROGRAMS_PER_BUCKET == ref.SCENARIO_PROGRAMS_PER_BUCKET == 2
    assert set(op_audit.TargetReport.__dataclass_fields__) >= (
        set(ref.TargetReport.__dataclass_fields__) - {"n_eqns"}
    ) | {"n_ops"}
    assert set(op_audit.GuardResult.__dataclass_fields__) >= set(
        ref.GuardResult.__dataclass_fields__)


# ---------------------------------------------------------------------------
# the CLI


def test_cli_lint_census_json(capsys):
    """The CLI's census runs while the registry is captured: each entry's
    census is the capture's own first call."""
    from open_simulator_tpu_torch import cli

    rc = cli.main(["lint", "--format", "json", "--device", "cpu", "--no-recompile-guard",
                   "--entries", "ops.fast:cur_at,ops.kernels:commit_step"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"] is True
    assert doc["findings"] == [] and doc["suppressed"]
    targets = {t["name"]: t for t in doc["jaxpr_audit"]["targets"]}
    assert sorted(targets) == ["ops.fast:cur_at", "ops.kernels:commit_step"]
    assert all(t["ok"] and t["n_ops"] > 0 for t in targets.values())
    assert doc["jaxpr_audit"]["required_missing"] == []
    assert doc["recompile_guard"] is None


def test_cli_lint_unknown_entry_exits_1(capsys):
    from open_simulator_tpu_torch import cli

    assert cli.main(["lint", "--device", "cpu", "--entries", "ops.fast:nope"]) == 1
    assert "unknown audit entry" in capsys.readouterr().err


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
