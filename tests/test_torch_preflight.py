"""The port's preflight (open_simulator_tpu_torch/analysis/preflight.py and
budget.py) on the CPU: the counterpart of tests/test_hlo_audit.py.

The budget book and its diff are held to the reference's BudgetBook on the
same dicts (byte-equal JSON, equal violations). The exchange census, the
replication detector, the live-bytes tracker (against
parallel.mesh.bytes_per_device of materialized placements), the transfer
guard, the scenario-only and fixed-shape skips, the write-and-diff flow,
the plan_1m_100k verdict and the linear pod pricing (to the byte against a
full `meta` run at the canonical 512 pods) run on seeded fixtures and on a
few registry captures. The registry capture (~20 s) is module-scoped.
"""

import dataclasses
import threading
import types

import pytest
import torch

from open_simulator_tpu.analysis import budget as jbudget
from open_simulator_tpu_torch.analysis import budget as tbudget
from open_simulator_tpu_torch.analysis import preflight as pf
from open_simulator_tpu_torch.parallel import mesh as tmesh
from open_simulator_tpu_torch.parallel import slots

torch.set_num_threads(1)  # tiny tensors: threads only add contention


@pytest.fixture(scope="module")
def caps():
    from open_simulator_tpu_torch.analysis import entry_audit

    return entry_audit._capture_calls("cpu")


def _only(caps, *names):
    wanted = set(names)
    return [c for c in caps if c.name in wanted]


def _cap(name, fn, *args):
    return types.SimpleNamespace(name=name, fn=fn, args=args, kwargs={})


# ---------------------------------------------------------------------------
# budget book: round trip + diff semantics, held to the reference's
# ---------------------------------------------------------------------------

def _budget(mod, **over):
    base = dict(
        peak_bytes=1_000_000, argument_bytes=600_000, output_bytes=300_000,
        temp_bytes=100_000, alias_bytes=0,
        collectives={"all-reduce:sum": 2}, collective_bytes=4096,
    )
    base.update(over)
    return mod.ProgramBudget(**base)


def test_budget_book_round_trip_equals_the_reference(tmp_path):
    key = tbudget.program_key("ops.fast:schedule_scenarios", 128, "2x2")
    assert key == jbudget.program_key("ops.fast:schedule_scenarios", 128, "2x2")
    books = {}
    for name, mod in (("port", tbudget), ("ref", jbudget)):
        book = mod.BudgetBook(
            programs={key: _budget(mod)},
            verdicts={"plan_1m_100k": {"ok": True, "peak_gib": 1.7}},
        )
        path = tmp_path / name / "preflight.json"
        book.save(str(path))
        assert mod.BudgetBook.load(str(path)).to_dict() == book.to_dict()
        books[name] = path.read_text()
    assert books["port"] == books["ref"]
    assert (tbudget.DEFAULT_TOLERANCE, tbudget.DEFAULT_SLACK_BYTES) == (
        jbudget.DEFAULT_TOLERANCE, jbudget.DEFAULT_SLACK_BYTES)


DIFF_CASES = {
    "within-tolerance": lambda m: {"e@r64@m1": _budget(m, peak_bytes=1_040_000)},
    "shrinking": lambda m: {"e@r64@m1": _budget(m, peak_bytes=10, argument_bytes=10,
                                                 output_bytes=10, temp_bytes=10)},
    "memory": lambda m: {"e@r64@m1": _budget(m, peak_bytes=1_100_000)},
    "new-collective": lambda m: {"e@r64@m1": _budget(
        m, collectives={"all-reduce:sum": 2, "all-gather:on_root": 1})},
    "collective-bytes": lambda m: {"e@r64@m1": _budget(m, collective_bytes=1 << 20)},
    "unbudgeted": lambda m: {"e@r128@m1": _budget(m)},
    "partial": lambda m: {},
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_budget_diff_violation_kinds_equal_the_reference(case):
    got = {}
    for name, mod in (("port", tbudget), ("ref", jbudget)):
        book = mod.BudgetBook(programs={"e@r64@m1": _budget(mod)}, slack_bytes=0,
                              tolerance=0.05)
        got[name] = [v.to_dict() for v in book.diff(DIFF_CASES[case](mod))]
    assert got["port"] == got["ref"]
    want = {"within-tolerance": [], "shrinking": [], "partial": []}.get(case)
    if want is not None:
        assert got["port"] == want
    else:
        assert [v["kind"] for v in got["port"]] == [case]


# ---------------------------------------------------------------------------
# exchange census + replication detector
# ---------------------------------------------------------------------------

def _exchanges(x):
    s = slots.node_sum(x, 0)
    m = slots.node_amax(x)
    return s, m


def _replicate(x):
    # the whole node table gathered onto the first slot and handed back
    return slots.on_root(lambda t: t + 1.0, x)


def test_exchange_census_counts_combines_and_gathers():
    pa = pf.audit_program(_cap("fixture:exchanges", _exchanges, torch.zeros((64, 4))), 128,
                          "1x2")
    assert not pa.error, pa.error
    assert pa.collectives == {"all-reduce:max": 1, "all-reduce:sum": 1}
    # slot 0's operands: a [4] f32 partial sum and one f32 max
    assert pa.collective_bytes == 4 * 4 + 4
    assert pa.node_gathers == [] and pa.ok


def test_seeded_replication_fixture_is_flagged():
    pa = pf.audit_program(_cap("fixture:replicate", _replicate, torch.zeros((64, 4))), 128,
                          "1x2")
    assert not pa.error, pa.error
    assert pa.collectives.get("all-gather:on_root", 0) >= 1
    assert pa.node_gathers == ["all-gather:on_root[128, 4]"], pa.to_dict()
    assert not pa.ok


def test_clean_sharded_fixture_passes():
    pa = pf.audit_program(_cap("fixture:scale", lambda x: x * 2.0, torch.zeros((64, 4))), 128,
                          "1x2")
    assert not pa.error, pa.error
    assert pa.collectives == {} and pa.node_gathers == []
    assert pa.estimate_ok and pa.ok


def test_replication_detector_mute_at_canonical_rung():
    pa = pf.audit_program(_cap("fixture:replicate64", _replicate, torch.zeros((64, 4))),
                          pf.N_CANON, "1x2")
    assert pa.node_gathers == []


def test_lane_parallel_entry_with_an_exchange_fails(monkeypatch):
    monkeypatch.setattr(pf, "LANE_PARALLEL", frozenset({"fixture:lanes"}))
    pa = pf.audit_program(_cap("fixture:lanes", _exchanges, torch.zeros((64, 4))), 64, "2x1")
    assert pa.collectives == {} and pa.ok   # one node slot per lane row: no exchange
    pa = pf.audit_program(_cap("fixture:lanes", _exchanges, torch.zeros((64, 4))), 64, "1x2")
    assert pa.collectives and pa.ok          # node-sharded: the exchanges are the design
    monkeypatch.setattr(pf, "_layout", lambda tag, dev: slots.Layout(((dev, dev),)))
    pa = pf.audit_program(_cap("fixture:lanes", _exchanges, torch.zeros((64, 4))), 64, "2x1")
    assert pa.lane_parallel_violation and not pa.ok


# ---------------------------------------------------------------------------
# the tracker vs materialized placements
# ---------------------------------------------------------------------------

def test_tracker_matches_materialized_placement():
    """Per slot, the tracker's argument bytes of a node-sharded tree equal
    parallel.mesh.bytes_per_device of the same tree laid out for real (and
    the static estimator's)."""
    x = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    placed = tmesh.put(tmesh.make_mesh(["cpu", "cpu"]), x, 0)
    real = tmesh.hbm_bytes_per_device(placed)
    assert sorted(real.values()) == [1024, 1024]
    pa = pf.audit_program(_cap("fixture:add", lambda t: t + 1.0, x), 64, "1x2")
    assert pa.argument_bytes == max(real.values()) == pa.est_argument_bytes
    assert pa.output_bytes == 1024 and pa.peak_bytes == 2048
    assert tbudget.estimate_bytes_by_device(placed) == real


def test_estimator_mismatch_fails_the_audit(monkeypatch):
    monkeypatch.setattr(tbudget, "estimate_max_bytes_per_device", lambda *a, **k: 0)
    pa = pf.audit_program(_cap("fixture:big", lambda t: t + 1.0, torch.zeros((256, 256))),
                          64, "1")
    assert not pa.estimate_ok and not pa.ok


def test_tracker_entered_on_every_slot_thread():
    """spmd runs a node group's slots on threads of their own; the tracker's
    mode is entered on each, so every slot's allocations count."""
    tracker = pf._Tracker(set())
    threads = {}

    def work(block):
        threads[slots._tls.slot] = threading.current_thread().name
        return torch.ones(256) + block.sum()

    layout = slots.Layout(((torch.device("cpu"), torch.device("cpu")),))
    sharded = slots.lay_out(layout, torch.zeros((64, 4)), None, 0)
    with slots.slot_hook(tracker.on_thread):
        slots.spmd(work, sharded)
    assert threads == {0: "mesh-slot-0", 1: "mesh-slot-1"}
    assert sorted(tracker.peak) == [0, 1]
    assert all(v >= 1024 for v in tracker.peak.values())


# ---------------------------------------------------------------------------
# transfer guard
# ---------------------------------------------------------------------------

def test_transfer_guard_fixture_violation():
    def leaky(x):
        return x * float(x.sum())     # a scalar read every call

    chk = pf.guarded_steady_state_check(leaky, (torch.ones(8),), {}, name="fixture:leaky")
    assert not chk.ok and "_local_scalar_dense" in chk.error


def test_transfer_guard_clean_entry_passes(caps):
    chk = pf.guarded_steady_state_check(lambda x: x * 2.0, (torch.ones(8),), {})
    assert chk.ok, chk.error
    # domain_select's two scalar reads are listed (op_audit.LISTED_TRANSFERS)
    (cap,) = _only(caps, "ops.fast:domain_select")
    (chk,) = pf.transfer_audit([cap], "cpu")
    assert chk.ok and chk.listed == ["_local_scalar_dense x2"], chk


# ---------------------------------------------------------------------------
# the matrix + verdict on real captured entries
# ---------------------------------------------------------------------------

def test_matrix_on_ladder_and_meshes(caps):
    subset = _only(caps, "ops.fast:commit_choices", "ops.kernels:probe_step")
    report = pf.run_preflight(rungs=(64, 128), meshes=("1", "2x1", "2x2"), caps=subset,
                              transfers=False, verdict=False, device="cpu")
    assert len(report.programs) == 12
    assert all(p.ok for p in report.programs), report.render_text()
    for p in report.programs:
        if p.mesh in ("1", "2x1"):
            assert p.collectives == {}, p.to_dict()    # one node slot: no exchange
        else:
            assert p.collectives, p.to_dict()
    assert {p.rung for p in report.programs} == {64, 128}
    by = {p.key: p for p in report.programs}
    # a bigger rung costs more; a node split costs each slot less
    assert by["ops.kernels:probe_step@r128@m1"].argument_bytes > \
        by["ops.kernels:probe_step@r64@m1"].argument_bytes > \
        by["ops.kernels:probe_step@r64@m2x2"].argument_bytes


def test_committed_book_covers_the_cpu_matrix(caps):
    """The meta numbers do not depend on the device: the CPU diffs clean
    against the checked-in book."""
    book = tbudget.BudgetBook.load("budgets/preflight_torch.json")
    subset = _only(caps, "ops.kernels:commit_step", "ops.fast:cur_at", "ops.delta:apply_rows")
    report = pf.run_preflight(caps=subset, book=book, transfers=False, verdict=False,
                              device="cpu")
    assert report.violations == [] and report.ok, report.render_text()
    assert report.measured().keys() <= book.programs.keys()


def test_scenario_only_entry_skips_node_sharded_meshes(caps):
    report = pf.run_preflight(rungs=(64,), meshes=("1", "2x2"),
                              caps=_only(caps, "ops.fast:light_scan"),
                              transfers=False, verdict=False, device="cpu")
    assert [p.mesh for p in report.programs] == ["1"]
    assert report.programs_skipped == [tbudget.program_key("ops.fast:light_scan", 64, "2x2")]
    assert report.ok, report.render_text()


def test_fixed_shape_entry_is_never_rung_resized(caps):
    assert "ops.fast:schedule_universes_wave" in pf.FIXED_SHAPE
    (cap,) = _only(caps, "ops.fast:schedule_universes_wave")
    args, kwargs, _roles = pf.abstract_args(cap, 128, resize=False)
    from open_simulator_tpu_torch.analysis.invariants import _flat_tensors

    got = [tuple(t.shape) for t in _flat_tensors((args, kwargs))]
    want = [tuple(t.shape) for t in _flat_tensors((cap.args, cap.kwargs))]
    assert got == want
    assert all(t.device.type == "meta" for t in _flat_tensors(args))
    report = pf.run_preflight(caps=[cap], transfers=False, verdict=False, device="cpu")
    assert [(p.rung, p.mesh) for p in report.programs] == [(64, "1")]
    assert len(report.programs_skipped) == 5 and report.ok


def test_budget_write_and_diff_flow(caps, tmp_path):
    report = pf.run_preflight(rungs=(64,), meshes=("1",), caps=_only(caps, "ops.kernels:probe_step"),
                              transfers=False, verdict=False, device="cpu")
    assert report.ok
    path = str(tmp_path / "preflight_torch.json")
    report.to_book().save(path)
    book = tbudget.BudgetBook.load(path)
    assert book.diff(report.measured()) == []
    key = report.programs[0].key
    fat = dataclasses.replace(report.measured()[key],
                              peak_bytes=report.measured()[key].peak_bytes * 10 + (64 << 20))
    assert [x.kind for x in book.diff({key: fat})] == ["memory"]
    assert [x.kind for x in book.diff(
        {tbudget.program_key("ops.kernels:probe_step", 256, "1"): report.measured()[key]}
    )] == ["unbudgeted"]


def test_plan_verdict_fits(caps):
    v = pf.plan_verdict(caps, device="cpu")
    assert v["config"] == "plan_1m_100k" and v["mesh"] == "1x4"
    assert v["rung"] == 102400 and v["pod_bucket"] == 1003520
    assert not v.get("error"), v
    assert v["hbm_gib"] == 80.0
    assert v["fits"] is True and v["node_table_sharded"] is True
    assert 0 < v["peak_gib"] < 80.0
    assert v["collectives"] and not any(k.startswith("all-gather") for k in v["collectives"])
    assert v["ok"] is True


def test_plan_verdict_without_entry_reports_error():
    v = pf.plan_verdict([], hbm_gib=80.0)
    assert v["ok"] is False
    assert "schedule_scenarios" in v["error"]


def test_linear_pod_pricing_equals_a_full_meta_run(caps):
    """The scan entries run at 16 and 32 pods and are priced at the
    canonical 512: every byte field equals one full `meta` run at 512."""
    (cap,) = _only(caps, "ops.kernels:schedule_batch")
    assert pf._captured_pods(cap) == 512
    pa = pf.audit_program(cap, 64, "1")
    assert pa.pricing["pods_run"] == [16, 32] and pa.pricing["pods"] == 512
    assert pa.pricing["step_growth"] is not None
    args, kwargs, roles = pf.abstract_args(cap, 64, pods=512)
    full = pf._run_program(cap, args, kwargs, roles, "1", 64, torch.device("meta"))
    for f in ("argument_bytes", "output_bytes", "alias_bytes", "temp_bytes", "peak_bytes"):
        assert getattr(pa, f) == full[f], (f, getattr(pa, f), full[f])
