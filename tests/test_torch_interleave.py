"""The port's interleave model checker (analysis/interleave.py) over the
port's admission, loop, session, journal and breaker code, against the JAX
package's checker over the reference's: the cases of tests/test_interleave.py
(clean protocols within the quick bounds, the mutation catalog, every
seeded bug caught, minimized and replayable, ddmin's minimization, same
seed byte-identical, DPOR against no DPOR, input validation, the CLI's exit
codes, schedule-out and replay). The reference's two SARIF cases wait for
`check`. Beside each case, the verdicts of every scenario and mutation, the
run and state counts and the minimized schedules equal the JAX report's:
the port's protocol objects make the same sync calls. Tolerance: exact.
"""

import json

import pytest

from open_simulator_tpu.analysis import interleave as jinterleave
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.analysis import interleave
from tests.fixture_bad_protocols import BAD_PROTOCOLS


def _report_bytes(report):
    return json.dumps(report.to_dict(), indent=2, sort_keys=True).encode()


def _verdicts(report):
    """Everything a report decides, without its digest and module names."""
    return [
        (s.name, s.completed, s.runs, s.states,
         [(v.invariant, [list(p) for p in v.interventions]) for v in s.violations])
        for s in report.scenarios
    ]


def _same_as_jax(report, *args, **kw):
    want = jinterleave.run_interleave(*args, **kw)
    assert _verdicts(report) == _verdicts(want)
    assert report.ok == want.ok


def test_real_protocols_clean_under_quick_bounds():
    report = interleave.run_interleave(quick=True)
    assert report.ok
    assert sorted(s.name for s in report.scenarios) == sorted(interleave.SCENARIOS)
    for s in report.scenarios:
        assert s.completed, f"{s.name} exhausted its run budget"
        assert not s.violations
        assert s.runs >= 1 and s.states > s.runs
    _same_as_jax(report, quick=True)


def test_fixture_catalog_matches_shipped_mutations():
    assert {b.mutation for b in BAD_PROTOCOLS} == set(interleave.MUTATIONS)
    for b in BAD_PROTOCOLS:
        assert interleave.MUTATIONS[b.mutation][0] == b.scenario
    assert interleave.MUTATIONS == jinterleave.MUTATIONS
    assert set(interleave.SCENARIOS) == set(jinterleave.SCENARIOS)


@pytest.mark.parametrize("bad", BAD_PROTOCOLS, ids=[b.mutation for b in BAD_PROTOCOLS])
def test_seeded_bug_caught_minimized_and_replayable(bad):
    report = interleave.run_interleave(mutate=bad.mutation)
    assert not report.ok
    assert len(report.scenarios) == 1
    sc = report.scenarios[0]
    assert sc.name == bad.scenario
    assert sc.violations, f"{bad.mutation} was not caught"
    v = sc.violations[0]
    assert v.invariant in bad.invariants, (bad.mutation, v.invariant, v.message)
    sched = interleave._schedule_dict(v, report.seed, report.mutate)
    assert sched["scenario"] == bad.scenario
    assert sched["mutate"] == bad.mutation
    assert all(isinstance(step, int) and isinstance(actor, int)
               for step, actor in sched["interventions"])
    replay_report = interleave.run_interleave(replay=sched)
    assert not replay_report.ok
    replay_v = replay_report.scenarios[0].violations
    assert replay_v and replay_v[0].invariant in bad.invariants
    assert replay_report.replayed == {
        "scenario": bad.scenario,
        "interventions": [list(p) for p in v.interventions],
    }
    _same_as_jax(report, mutate=bad.mutation)
    _same_as_jax(replay_report, replay=sched)


def test_minimization_drops_redundant_interventions():
    report = interleave.run_interleave(mutate="torn-checkpoint")
    (sc,) = report.scenarios
    v = sc.violations[0]
    assert len(v.interventions) <= 2
    assert any(actor == interleave.CRASH for _, actor in v.interventions)
    _same_as_jax(report, mutate="torn-checkpoint")


def test_same_seed_byte_identical_report():
    a = interleave.run_interleave(["breaker", "journal"], seed=7, quick=True)
    b = interleave.run_interleave(["breaker", "journal"], seed=7, quick=True)
    assert _report_bytes(a) == _report_bytes(b)
    assert a.to_dict()["digest"] == b.to_dict()["digest"]
    _same_as_jax(a, ["breaker", "journal"], seed=7, quick=True)


def test_same_seed_byte_identical_violation_schedule():
    a = interleave.run_interleave(mutate="double-probe", seed=3)
    b = interleave.run_interleave(mutate="double-probe", seed=3)
    assert _report_bytes(a) == _report_bytes(b)
    va, vb = a.scenarios[0].violations[0], b.scenarios[0].violations[0]
    assert va.interventions == vb.interventions
    assert va.trace == vb.trace
    _same_as_jax(a, mutate="double-probe", seed=3)


def test_dpor_cross_check_same_verdict_fewer_runs():
    with_dpor = interleave.run_interleave(["breaker"], quick=True)
    without = interleave.run_interleave(["breaker"], quick=True, use_dpor=False)
    assert with_dpor.ok and without.ok
    assert with_dpor.scenarios[0].completed and without.scenarios[0].completed
    assert with_dpor.scenarios[0].runs <= without.scenarios[0].runs
    _same_as_jax(without, ["breaker"], quick=True, use_dpor=False)


def test_dpor_still_catches_seeded_bug_when_disabled():
    report = interleave.run_interleave(mutate="double-probe", use_dpor=False)
    assert not report.ok
    _same_as_jax(report, mutate="double-probe", use_dpor=False)


def test_unknown_scenario_and_mutation_raise():
    with pytest.raises(ValueError, match="unknown scenario"):
        interleave.run_interleave(["no-such-scenario"])
    with pytest.raises(ValueError, match="unknown mutation"):
        interleave.run_interleave(mutate="no-such-mutation")
    with pytest.raises(ValueError, match="unknown scenario"):
        interleave.run_interleave(replay={"scenario": "nope", "interventions": []})


def test_cli_interleave_mutate_schedule_out_and_replay(tmp_path, capsys):
    sched_path = tmp_path / "sched.json"
    rc = cli.main(["interleave", "--mutate", "double-probe",
                   "--schedule-out", str(sched_path), "--format", "json"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"]
    sched = json.loads(sched_path.read_text())
    assert sched["scenario"] == "breaker"
    assert sched["mutate"] == "double-probe"

    rc = cli.main(["interleave", "--replay", str(sched_path), "--format", "json"])
    assert rc == 1
    replayed = json.loads(capsys.readouterr().out)
    assert not replayed["ok"]
    assert replayed["replayed"]["scenario"] == "breaker"
    assert sched == jinterleave._schedule_dict(
        jinterleave.run_interleave(mutate="double-probe").scenarios[0].violations[0], 0,
        "double-probe",
    )


def test_cli_interleave_clean_scenario_exits_zero(capsys):
    rc = cli.main(["interleave", "breaker", "--quick", "--format", "json"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["bounds"]["preemptions"] == 1


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
