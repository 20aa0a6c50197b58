"""`simon prove` on the port (`analysis/oracle.py`, `analysis/semantics.py`,
`ops/fast.py` schedule_universes and the wave engine's universe round)
against the JAX package and the banked commit-order contract.

Tolerance: exact everywhere. The port's oracle must equal the JAX package's
oracle on every leaf; the port's engines must agree with the port's oracle
on every universe (0 divergences) and fold the same sha256 digests the JAX
package folds (the constants below were computed with the JAX package's
`check_universes` / `run_prove` on the same universes, and the slow tests
recompute them). On the card `chip_smoke.py` runs the whole corpus with
both engines and verifies the unchanged `budgets/commit_contract.json`.
"""

import json

import numpy as np
import pytest
import torch

from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.analysis import oracle, semantics
from open_simulator_tpu_torch.analysis.semantics import SmallScope, Universe
from open_simulator_tpu_torch.ops import fast, kernels
from open_simulator_tpu_torch.ops import wave as twave
from open_simulator_tpu_torch.utils import metrics

torch.set_num_threads(1)

# tests/test_oracle.py's pinned universes
PINNED = [
    Universe("B---", "ppppp"),
    Universe("AA--", "ppppp"),
    Universe("D---", "ppppp"),
    Universe("B---", "qqqqq"),
    Universe("A---", "rrrrr"),
    Universe("A---", "ppppq"),
    Universe("C---", "rrrrr"),
]
# digests of the JAX package's check_universes / run_prove on the same
# universes (recomputed by test_digests_equal_jax)
PINNED_DIGEST = "sha256:ce3dfdf0e8c5d741c0cc9d2c2c177428e50c8dd37e6d4d8d22d143a0b33dd951"
SMOKE_DIGESTS = {
    2000: "sha256:214f1fd1fd7362900831d399c7c5c1a9395c893d9b376c5e096f7ea4ac74afd8",
    300: "sha256:afbd540590d4dfa74841a8e82c3311e0e2f177af5b9c55f126bd71c3daf72d4b",
}
BANKED_DIGEST = "sha256:091e84bad41b712a40290b75a2d093dc0d28637d0a8b66f6e977574bc51c672e"
ENGINES = ("serial", "wave")


@pytest.fixture(scope="module")
def scope():
    return SmallScope()


def test_oracle_constants_match_port_kernels():
    """oracle.py redeclares the shared contract constants; they must equal
    the port kernels' (the JAX package's own tripwire is
    tests/test_oracle.py)."""
    names = ("F_UNSCHEDULABLE", "F_NODE_NAME", "F_TAINT", "F_NODE_AFFINITY",
             "F_NODE_PORTS", "F_RESOURCES", "F_SPREAD", "F_POD_AFFINITY",
             "F_STORAGE", "F_GPU", "F_EXTRA", "NUM_FILTERS")
    for name in names:
        assert getattr(oracle, name) == getattr(kernels, name), name
    assert oracle.DEFAULT_WEIGHTS == kernels.DEFAULT_WEIGHTS
    assert oracle.WEIGHT_ORDER == kernels.WEIGHT_ORDER
    assert oracle.EPS == np.float32(kernels._EPS)


def test_port_oracle_equals_jax_oracle(scope):
    """The port's oracle copy against the JAX package's on a strided sample
    of the corpus: every output leaf bitwise."""
    from open_simulator_tpu.analysis import oracle as joracle
    from open_simulator_tpu.analysis.semantics import SmallScope as JScope

    jscope = JScope()
    corpus = scope.universes()
    sample = corpus[::len(corpus) // 240]
    for u in sample:
        got = oracle.schedule(scope.oracle_table(u), scope.oracle_batch(u))
        want = joracle.schedule(jscope.oracle_table(u), jscope.oracle_batch(u))
        for f in ("nodes", "reasons", "gpu_take"):
            assert np.asarray(getattr(got, f)).tobytes() == np.asarray(getattr(want, f)).tobytes(), (u, f)
        gp, wp = got.carry.planes(), want.carry.planes()
        assert list(gp) == list(wp)
        for plane in gp:
            assert gp[plane].tobytes() == wp[plane].tobytes(), (u, plane)


@pytest.mark.parametrize("engine", ENGINES)
def test_pinned_universes_match_oracle(scope, engine):
    report = semantics.check_universes(scope, PINNED, engine=engine, device="cpu")
    assert report.ok, report.render_text()
    assert report.universes_checked == len(PINNED) and report.device_calls == 1
    assert report.digest == PINNED_DIGEST


def test_smoke_2000_both_engines_match_oracle():
    """run_prove(smoke=2000) with each engine: 0 divergences against the
    port's oracle and the JAX package's digest of the same sample."""
    for engine in ENGINES:
        report = semantics.run_prove(smoke=2000, engine=engine, device="cpu")
        assert report.ok and report.divergence_total == 0, report.render_text()
        assert report.universes_checked == 2000
        assert report.contract_ok is None   # smoke runs give no contract verdict
        assert report.digest == SMOKE_DIGESTS[2000]


def test_mutated_tiebreak_is_caught_and_minimized(scope):
    """The highest-index tie-break flips the AA tie; the minimized universe
    still diverges and is no larger than the one that diverged."""
    report = semantics.check_universes(scope, PINNED, mutate="tiebreak", device="cpu")
    assert report.divergence_total > 0 and not report.ok
    bad = Universe(*report.divergences[0].universe.split("/"))
    small = semantics.minimize(scope, bad, "tiebreak", device="cpu")
    assert len(small.nodes.replace("-", "")) <= len(bad.nodes.replace("-", ""))
    assert len(small.pods) <= len(bad.pods)
    assert semantics._diverges(scope, small, "tiebreak", device="cpu")


def test_mutated_nocommit_is_caught(scope):
    report = semantics.check_universes(scope, PINNED, mutate="nocommit", device="cpu")
    assert report.divergence_total > 0 and not report.ok
    bad = Universe(*report.divergences[0].universe.split("/"))
    assert semantics._diverges(scope, semantics.minimize(scope, bad, "nocommit", device="cpu"),
                               "nocommit", device="cpu")


def test_wave_parts_cover_every_lane(scope):
    """A two-lane chunk in which only lane 1's pods take GPU shares: the
    wave round's commit parts are the union over lanes, so lane 1's
    gpu_free moves, and the engines agree with each other and the oracle.
    Parts taken from lane 0's pods alone would skip lane 1's GPU plane."""
    chunk = [Universe("A---", "ppppp"), Universe("C---", "rrrrr")]
    ns_s, carry_s, pods_s, w_s = semantics._pack_chunk(scope, chunk, 2, torch.device("cpu"))
    parts = fast.universe_parts(pods_s)
    lane0_parts = fast.universe_parts(kernels.PodRow(*(a[:1] for a in pods_s)))
    assert "gpu" in parts[0]
    assert "gpu" not in lane0_parts[0]

    serial = fast.schedule_universes(ns_s, carry_s, pods_s, w_s)
    wave = fast.schedule_universes_wave_host(ns_s, carry_s, pods_s, w_s)
    for a, b in zip(serial[1:], wave[1:]):
        assert torch.equal(a, b)
    for f in kernels.Carry._fields:
        assert torch.equal(getattr(serial[0], f), getattr(wave[0], f)), f
    want = oracle.schedule(scope.oracle_table(chunk[1]), scope.oracle_batch(chunk[1]))
    assert wave[0].gpu_free[1].numpy().tobytes() == want.carry.planes()["gpu_free"].tobytes()
    assert not torch.equal(wave[0].gpu_free[1], carry_s.gpu_free[1])

    # the hazard: lane 0's parts replay lane 1's placements without their
    # GPU takes, so the fixpoint round's exit carry keeps lane 1's GPUs free
    wrong = twave.universe_round(ns_s, w_s, carry_s, pods_s, wave[1], lane0_parts)
    assert torch.equal(wrong[0].gpu_free[1], carry_s.gpu_free[1])
    assert not torch.equal(wrong[0].gpu_free[1], wave[0].gpu_free[1])


def test_wave_rounds_and_fallback_counted(scope, monkeypatch):
    """The universe wave driver records its rounds per chunk; a chunk still
    moving past P + 1 rounds falls back to the serial scan and is counted."""
    ns_s, carry_s, pods_s, w_s = semantics._pack_chunk(scope, PINNED, 8, torch.device("cpu"))
    _, _, n0 = metrics.COMMIT_ROUNDS.child_state()
    fast.schedule_universes_wave_host(ns_s, carry_s, pods_s, w_s)
    _, _, n1 = metrics.COMMIT_ROUNDS.child_state()
    assert n1 == n0 + 1

    real = twave.universe_round
    calls = []

    def flip(*args, **kw):   # a round whose choices never settle
        out = real(*args, **kw)
        calls.append(1)
        return (out[0], out[1] - (len(calls) % 2)) + tuple(out[2:])

    monkeypatch.setattr(twave, "universe_round", flip)
    before = metrics.WAVE_FALLBACKS.value(reason="universes_max_rounds")
    got = fast.schedule_universes_wave_host(ns_s, carry_s, pods_s, w_s)
    assert metrics.WAVE_FALLBACKS.value(reason="universes_max_rounds") == before + 1
    assert len(calls) == pods_s.req.shape[1] + 2
    want = fast.schedule_universes(ns_s, carry_s, pods_s, w_s)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def test_verify_contract_reads_banked_file(tmp_path):
    """verify_contract holds a report to the banked artifact field by field;
    write_contract goes to a temporary path, never to budgets/."""
    scope = SmallScope()
    report = semantics.ProveReport(universes_checked=scope.corpus_size(), digest=BANKED_DIGEST)
    ok, msgs = semantics.verify_contract(semantics.CONTRACT_PATH, scope, report)
    assert ok, msgs
    banked = json.load(open(semantics.CONTRACT_PATH))
    assert banked == semantics.contract_payload(scope, report)
    bad = semantics.ProveReport(universes_checked=scope.corpus_size(), digest="sha256:0")
    ok, msgs = semantics.verify_contract(semantics.CONTRACT_PATH, scope, bad)
    assert not ok and "placement digest mismatch" in msgs[0]
    out = tmp_path / "contract.json"
    assert semantics.write_contract(str(out), scope, report) == banked
    assert json.load(open(out)) == banked


def _fake_report(diverged):
    rep = semantics.ProveReport(universes_checked=7, digest="sha256:x")
    if diverged:
        rep.divergence_total = 2
        rep.divergences = [semantics.Divergence("AA--/ppppp", "nodes", "[1]", "[0]")]
        rep.minimized = "--AA/ppppp"
    return rep


def test_cli_prove_exit_codes(monkeypatch, capsys):
    """The reference's test_cli_prove_exit_codes on the port's CLI."""
    monkeypatch.setattr(semantics, "run_prove", lambda **kw: _fake_report(False))
    assert cli.main(["prove", "--format=json", "--smoke", "7"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["universes_checked"] == 7

    monkeypatch.setattr(semantics, "run_prove", lambda **kw: _fake_report(True))
    assert cli.main(["prove", "--format=json", "--smoke", "7"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is False
    assert doc["minimized_counterexample"] == "--AA/ppppp"


@pytest.mark.parametrize("engine", ENGINES)
def test_cli_prove_smoke(engine, capsys):
    assert cli.main(["prove", "--device", "cpu", "--smoke", "300", "--engine", engine]) == 0
    out = capsys.readouterr().out
    assert "divergences       : 0" in out and "verdict           : PROVED" in out
    assert f"placement digest  : {SMOKE_DIGESTS[300]}" in out


def test_cli_prove_mutation_exits_1(capsys):
    assert cli.main(["prove", "--device", "cpu", "--smoke", "300", "--mutate", "tiebreak"]) == 1
    out = capsys.readouterr().out
    assert "minimized counterexample: --AA/p" in out and "verdict           : FAILED" in out


def test_prove_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        semantics.check_universes(SmallScope(), PINNED[:1])


@pytest.mark.slow
def test_digests_equal_jax(scope):
    """The JAX package recomputes PINNED_DIGEST and SMOKE_DIGESTS[300]."""
    from open_simulator_tpu.analysis import semantics as jsem

    jpinned = [jsem.Universe(u.nodes, u.pods) for u in PINNED]
    assert jsem.check_universes(jsem.SmallScope(), jpinned).digest == PINNED_DIGEST
    assert jsem.run_prove(smoke=300).digest == SMOKE_DIGESTS[300]


@pytest.mark.slow
def test_universe_engines_equal_jax_bitwise(scope):
    """The port's schedule_universes and schedule_universes_wave_host against
    the JAX package's on the PINNED chunk: every output and carry leaf."""
    from open_simulator_tpu.analysis import semantics as jsem
    from open_simulator_tpu.ops import fast as jfast

    jscope = jsem.SmallScope()
    jpinned = [jsem.Universe(u.nodes, u.pods) for u in PINNED]
    for tfn, jfn in ((fast.schedule_universes, jfast.schedule_universes),
                     (fast.schedule_universes_wave_host, jfast.schedule_universes_wave_host)):
        got = tfn(*semantics._pack_chunk(scope, PINNED, 8, torch.device("cpu")))
        want = jfn(*jsem._pack_chunk(jscope, jpinned, 8))
        for a, b in zip(got[1:], want[1:]):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        for f in kernels.Carry._fields:
            assert getattr(got[0], f).numpy().tobytes() == np.asarray(getattr(want[0], f)).tobytes(), f


@pytest.mark.slow
@pytest.mark.parametrize("engine", ENGINES)
def test_whole_corpus_verifies_banked_contract(engine, tmp_path):
    """All 151,875 universes, 0 divergences, the banked digest; banking to
    a temporary path writes the same payload as budgets/."""
    report = semantics.run_prove(engine=engine, device="cpu")
    assert report.ok and report.contract_ok, report.render_text()
    assert report.universes_checked == 151875 and report.device_calls == 6
    assert report.digest == BANKED_DIGEST
    out = tmp_path / "c.json"
    semantics.write_contract(str(out), SmallScope(), report)
    assert json.load(open(out)) == json.load(open(semantics.CONTRACT_PATH))
