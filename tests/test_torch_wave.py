"""The port's wave commit engine (ops/wave.py, `kernels.commit_choice`, the
wave route of `fast.schedule_scenarios_host`) against the JAX package, on
the CPU. Tolerance: exact.

  - `commit_choice` bitwise equal to the port's dense `commit_onehot` and to
    the JAX `commit_choice`, for every fixture pod at a -1 choice and at
    every node, from seeded carries; `probe_step` and `commit_step` equal to
    the JAX ones;
  - the cases of tests/test_wave_commit.py: the wave driver equal to the
    JAX serial scan (carry and every output) across seeds, non-divisor wave
    sizes, one wave for the whole plan, a warm carry, the max-rounds
    fallback, and the `wave_enabled` routing policy.

The plan is bench.py's build_state(8 nodes, 24 pods) on 3 live lanes of 8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.ops import state as jstate
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.ops import kernels as tk
from open_simulator_tpu_torch.ops import state as tstate
from open_simulator_tpu_torch.ops import wave as twave
from open_simulator_tpu_torch.utils import metrics as tmetrics
from tests.test_torch_kernels import FIXTURES, _eq, _row, build

torch.set_num_threads(1)  # tiny tensors: threads only add contention

S_REAL = 3
N_PODS = 24
WAVE = 4
WAVE_ENV = ("OSIM_WAVE_COMMIT", "OSIM_WAVE_SIZE", "OSIM_WAVE_ROUNDS", "OSIM_COMMIT_CHUNK")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_commit_choice_matches_onehot_and_jax(name):
    (jns, jc, jrows), (tns, tc, trows), n = build(name, seed=7)
    jit_commit = jax.jit(jk.commit_choice)
    N = int(jns.valid.shape[0])
    for i in range(n):
        jp, tp = _row(jrows, i, jk), _row(trows, i, tk)
        for ch in [-1] + list(range(N)):
            what = f"{name} pod {i} choice {ch}"
            got = tk.commit_choice(tns, tc, tp, torch.tensor(ch, dtype=torch.int32))
            want = jit_commit(jns, jc, jp, jnp.int32(ch))
            _eq(tuple(want[0]), tuple(got[0]), what + " carry")
            _eq(tuple(want[1:]), tuple(got[1:]), what + " takes")
            onehot = (torch.arange(N) == ch) & tp.valid
            dense = tk.commit_onehot(tns, tc, tp, onehot)
            for f in tk.Carry._fields:
                a, b = getattr(dense[0], f), getattr(got[0], f)
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (what, f)
            for a, b in zip(dense[1:], got[1:]):
                assert torch.equal(a, b), what
            if ch == -1:  # a -1 choice leaves the carry bitwise
                for f in tk.Carry._fields:
                    assert torch.equal(getattr(got[0], f), getattr(tc, f))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_probe_step_and_commit_step_match_jax(name):
    """The per-pod split of schedule_step: probe (mask, score, first
    failure) without a commit, then the commit of a given node."""
    (jns, jc, jrows), (tns, tc, trows), n = build(name, seed=11)
    jw, tw = jk.weights_array(), tk.weights_array(device="cpu")
    for i in range(n):
        jp, tp = _row(jrows, i, jk), _row(trows, i, tk)
        want = jk.probe_step(jns, jc, jp, jw)
        got = tk.probe_step(tns, tc, tp, tw)
        _eq(tuple(want), tuple(got), f"{name} pod {i} probe")
        for node in (-1, 0, 3):
            want = jk.commit_step(jns, jc, jp, jnp.int32(node))
            got = tk.commit_step(tns, tc, tp, torch.tensor(node, dtype=torch.int32))
            _eq(tuple(want[0]), tuple(got[0]), f"{name} pod {i} node {node} carry")
            _eq(tuple(want[1:]), tuple(got[1:]), f"{name} pod {i} node {node} takes")


def test_commit_choices_lanes_mixes_lanes():
    """Lanes with different choices (one of them -1) each equal the
    one-lane commit, and the skipped parts (commit_parts) change nothing."""
    (jns, jc, jrows), (tns, tc, trows), n = build("coupled", seed=3)
    carry_s = tstate.stack_carry(tc, 4)
    rows_np = {f: np.asarray(getattr(jrows, f)) for f in tk.PodRow._fields}
    for i in range(n):
        tp = _row(trows, i, tk)
        choices = torch.tensor([2, -1, 5, 0], dtype=torch.int32)
        full = tk.commit_choices_lanes(tns, carry_s, tp, choices)
        part = tk.commit_choices_lanes(tns, carry_s, tp, choices, tk.commit_parts(rows_np, i))
        for a, b in zip(full[0], part[0]):
            assert torch.equal(a, b)
        for a, b in zip(full[1:], part[1:]):
            assert torch.equal(a, b)
        for s, ch in enumerate(choices.tolist()):
            one = tk.commit_choice(tns, tc, tp, torch.tensor(ch, dtype=torch.int32))
            for f in tk.Carry._fields:
                assert torch.equal(getattr(full[0], f)[s], getattr(one[0], f))


# ---------------------------------------------------------------------------
# The wave driver on bench.py's build_state(8, 24)
# ---------------------------------------------------------------------------

def _valid_lanes(valid, s_pad, seed):
    """[s_pad, N] validity: lane 0 the real cluster, lanes 1..S_REAL-1 knock
    out a seeded quarter of the nodes, pad lanes copy lane 0."""
    v = np.stack([valid.copy() for _ in range(s_pad)])
    rng = np.random.RandomState(seed)
    for lane in range(1, S_REAL):
        v[lane] = valid & ~(rng.rand(valid.shape[0]) < 0.25)
    return v


class _Env:
    """Set the wave knobs for a JAX reference run outside monkeypatch."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in WAVE_ENV}
        for k in WAVE_ENV:
            os.environ.pop(k, None)
        os.environ.update(self.kw)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def plan():
    """(JAX ns, carry, batch), (port ns, carry), s_pad, weights, and the
    JAX serial scan's results per seed and from a warm carry."""
    from bench import build_state

    jns, jc, batch = build_state(8, N_PODS)
    s_pad = jfast.scenario_bucket(S_REAL)
    weights = np.stack([np.asarray(jk.weights_array())] * s_pad)
    host = [{f: np.asarray(v) for f, v in t._asdict().items()} for t in (jns, jc)]
    tns = tk.NodeStatic(**{f: torch.from_numpy(np.array(v)) for f, v in host[0].items()})
    tc = tk.Carry(**{f: torch.from_numpy(np.array(v)) for f, v in host[1].items()})
    valid = np.asarray(jns.valid)

    def jax_run(v, carry=None):
        carry_s = jstate.stack_carry(jc, s_pad)
        if carry is not None:
            carry_s = jfast.carry_from_host(carry_s, carry)
        out = jfast.schedule_scenarios_host(
            jns, carry_s, batch, jnp.asarray(weights), jnp.asarray(v), S_REAL
        )
        return (jfast.carry_to_host(out[0]),) + tuple(np.asarray(a) for a in out[1:])

    refs = {}
    with _Env(OSIM_WAVE_COMMIT="0"):
        for seed in (0, 1, 2):
            refs[seed] = jax_run(_valid_lanes(valid, s_pad, seed))
        refs["warm"] = jax_run(_valid_lanes(valid, s_pad, 0), carry=refs[0][0])
    return batch, tns, tc, s_pad, weights, valid, refs


def _port_run(plan, v, carry=None):
    batch, tns, tc, s_pad, weights, _, _ = plan
    carry_s = tstate.stack_carry(tc, s_pad)
    if carry is not None:
        carry_s = tk.Carry(**{f: torch.from_numpy(np.array(carry[f])) for f in tk.Carry._fields})
    out = tfast.schedule_scenarios_host(
        tns, carry_s, batch, torch.from_numpy(weights), torch.from_numpy(v), S_REAL
    )
    return (tfast.carry_to_host(out[0]),) + tuple(out[1:])


def _assert_identical(got, want):
    for f in tk.Carry._fields:
        np.testing.assert_array_equal(got[0][f], want[0][f], err_msg=f"carry.{f}")
    for k, (a, b) in enumerate(zip(got[1:], want[1:])):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=f"output {k}")


def _wave_on(monkeypatch, wave=WAVE, rounds=None):
    for k in WAVE_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OSIM_WAVE_COMMIT", "1")
    monkeypatch.setenv("OSIM_WAVE_SIZE", str(wave))
    if rounds is not None:
        monkeypatch.setenv("OSIM_WAVE_ROUNDS", str(rounds))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wave_matches_serial_across_seeds(plan, monkeypatch, seed):
    batch, *_, s_pad, _, valid, refs = plan
    _wave_on(monkeypatch)
    rounds0 = tmetrics.COMMIT_ROUNDS.child_state()[2]
    fb0 = tmetrics.WAVE_FALLBACKS.value(reason="max_rounds")
    got = _port_run(plan, _valid_lanes(valid, s_pad, seed))
    _assert_identical(got, refs[seed])
    # every wave reached its fixpoint and was adopted: the outputs are the
    # probe's and the replay's, not a fallback scan's
    assert tmetrics.WAVE_FALLBACKS.value(reason="max_rounds") == fb0
    assert tfast.scenario_carry_digest_host(got[0]) == jfast.scenario_carry_digest_host(refs[seed][0])
    # one osim_commit_rounds observation per wave (build_state buckets the
    # 24 pods to batch.p = 32 rows, the trailing ones invalid)
    assert tmetrics.COMMIT_ROUNDS.child_state()[2] == rounds0 + -(-int(batch.p) // WAVE)
    # and the port's own serial scan agrees
    monkeypatch.setenv("OSIM_WAVE_COMMIT", "0")
    _assert_identical(_port_run(plan, _valid_lanes(valid, s_pad, seed)), refs[seed])


@pytest.mark.parametrize("wave", [5, 7])
def test_wave_matches_serial_non_divisor_wave_sizes(plan, monkeypatch, wave):
    *_, s_pad, _, valid, refs = plan
    _wave_on(monkeypatch, wave=wave)
    fb0 = tmetrics.WAVE_FALLBACKS.value(reason="max_rounds")
    _assert_identical(_port_run(plan, _valid_lanes(valid, s_pad, 0)), refs[0])
    assert tmetrics.WAVE_FALLBACKS.value(reason="max_rounds") == fb0


def test_wave_whole_plan_as_one_wave(plan, monkeypatch):
    batch, *_, s_pad, _, valid, refs = plan
    _wave_on(monkeypatch, wave=int(batch.p) + 8)
    _assert_identical(_port_run(plan, _valid_lanes(valid, s_pad, 1)), refs[1])


def test_wave_matches_serial_on_warm_carry(plan, monkeypatch):
    """A second sweep of the same pods on the loaded carry: some pods now
    fail, and the wave fixpoint still equals the serial scan."""
    *_, s_pad, _, valid, refs = plan
    _wave_on(monkeypatch)
    got = _port_run(plan, _valid_lanes(valid, s_pad, 0), carry=refs[0][0])
    _assert_identical(got, refs["warm"])
    assert not np.array_equal(got[1], refs[0][1])


def test_wave_max_rounds_fallback_stays_identical(plan, monkeypatch):
    *_, s_pad, _, valid, refs = plan
    # a live wave cannot confirm in 1 round; all-invalid waves probe
    # straight to -1 choices and converge at once
    _wave_on(monkeypatch, rounds=1)
    fb0 = tmetrics.WAVE_FALLBACKS.value(reason="max_rounds")
    _assert_identical(_port_run(plan, _valid_lanes(valid, s_pad, 0)), refs[0])
    assert tmetrics.WAVE_FALLBACKS.value(reason="max_rounds") == fb0 + N_PODS // WAVE


def test_wave_enabled_policy(monkeypatch):
    big = 10 * twave.WAVE_AUTO_MIN_PODS
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for k in WAVE_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OSIM_WAVE_COMMIT", "0")
    assert not twave.wave_enabled(big, cuda)
    monkeypatch.setenv("OSIM_WAVE_COMMIT", "1")
    assert twave.wave_enabled(1, cpu)
    # auto: a parallel device and a plan big enough to amortize the rounds
    monkeypatch.delenv("OSIM_WAVE_COMMIT")
    assert twave.wave_enabled(big, cuda)
    assert not twave.wave_enabled(twave.WAVE_AUTO_MIN_PODS - 1, cuda)
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    assert not twave.wave_enabled(big, cpu)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert twave.wave_enabled(big, cpu)
    # the knobs read as the reference's do
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", "300")
    assert twave.wave_size() == 300
    assert not twave.wave_enabled(599, cuda)
    monkeypatch.setenv("OSIM_WAVE_SIZE", "16")
    assert twave.wave_size() == 16
    monkeypatch.setenv("OSIM_WAVE_ROUNDS", "junk")
    assert twave.wave_max_rounds() == twave.DEFAULT_MAX_ROUNDS
