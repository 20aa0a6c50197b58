"""The port's chunked commit checkpoints (durable/checkpoint.py and the
chunked and wave drivers of ops/fast.py) against the JAX package, on the
CPU. Tolerance: exact, every Carry leaf and all five outputs.

On a small plan (N = 8, 24 pods bucketed to 32, 3 live lanes of 8, as
tests/test_checkpoint.py builds it):
  - the chunked scan (OSIM_COMMIT_CHUNK) equals the single scan and the JAX
    package's, across seeds and for a chunk that does not divide the pods;
  - a plan killed mid-chunk resumes bit-identically from its journal and
    newest verified snapshot; a torn or corrupt snapshot is skipped for the
    previous one (or a replay from scratch); a re-executed chunk whose
    digest contradicts the journal refuses to continue;
  - `device_lost` rolls back to the last good carry and replays in place,
    with a flight-recorder artifact naming the last good chunk; a third
    strike raises; the wave driver does the same per wave;
  - the device carry digest equals its host twin on every leaf dtype, and
    carry_from_host refuses a snapshot of another shape.
The reference's elastic resume onto a smaller mesh waits for the port's
meshes (ROADMAP.md item 13b). The true-SIGKILL subprocess case is `slow`.
"""

import glob
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu.ops import state as jstate
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.durable import RunJournal, replay
from open_simulator_tpu_torch.durable.checkpoint import (
    OUTPUT_NAMES,
    CheckpointError,
    PlanCheckpointer,
    checkpoint_every,
    installed,
)
from open_simulator_tpu_torch.ops import delta
from open_simulator_tpu_torch.ops import fast
from open_simulator_tpu_torch.ops import state as state_mod
from open_simulator_tpu_torch.ops.kernels import Carry, weights_array
from open_simulator_tpu_torch.resilience import faults
from open_simulator_tpu_torch.utils import metrics

torch.set_num_threads(1)  # tiny tensors: threads only add contention

S_REAL = 3
CHUNK = 4  # 24 pods bucket to 32 -> 8 chunks


@pytest.fixture(scope="module")
def plan_state():
    from open_simulator_tpu_torch.headline import build_state

    ns, carry, batch = build_state(8, 24, device="cpu")
    s_pad = fast.scenario_bucket(S_REAL)
    weights = np.stack([weights_array(device="cpu").numpy()] * s_pad)
    return ns, carry, batch, weights, s_pad


@pytest.fixture(scope="module")
def jax_state():
    from bench import build_state

    return build_state(8, 24)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    monkeypatch.setenv("OSIM_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("OSIM_WAVE_COMMIT", "0")
    monkeypatch.delenv("OSIM_COMMIT_CHUNK", raising=False)
    yield
    faults.uninstall_plan()


def _valid_lanes(ns, s_pad, seed):
    """[s_pad, N] validity: lane 0 the real cluster, lanes 1..S_REAL-1 knock
    out a seeded fraction of nodes, pad lanes copy lane 0."""
    base = ns.valid.numpy()
    v = np.stack([base.copy() for _ in range(s_pad)])
    rng = np.random.RandomState(seed)
    for lane in range(1, S_REAL):
        v[lane] = base & ~(rng.rand(base.shape[0]) < 0.25)
    return v


def _to_host(out):
    return (fast.carry_to_host(out[0]),) + tuple(np.asarray(a) for a in out[1:])


def _dispatch(plan_state, valid):
    """One schedule_scenarios_host call on a fresh stacked carry."""
    ns, carry, batch, weights, s_pad = plan_state
    carry_s = state_mod.stack_carry(carry, s_pad)
    return _to_host(fast.schedule_scenarios_host(
        ns, carry_s, batch, torch.from_numpy(weights), torch.from_numpy(valid), S_REAL))


def _jax_dispatch(jax_state, plan_state, valid):
    ns, carry, batch = jax_state
    s_pad = plan_state[4]
    out = jfast.schedule_scenarios_host(
        ns, jstate.stack_carry(carry, s_pad), batch, jnp.asarray(plan_state[3]),
        jnp.asarray(valid), S_REAL)
    return (jfast.carry_to_host(out[0]),) + tuple(np.asarray(a) for a in out[1:])


def _assert_identical(got, want):
    for f in Carry._fields:
        np.testing.assert_array_equal(got[0][f], want[0][f], err_msg=f"carry.{f}")
        assert got[0][f].dtype == want[0][f].dtype, f
    for k, name in enumerate(OUTPUT_NAMES):
        np.testing.assert_array_equal(got[1 + k], want[1 + k], err_msg=name)


def _mono_ref(plan_state, valid, monkeypatch):
    monkeypatch.delenv("OSIM_COMMIT_CHUNK", raising=False)
    return _dispatch(plan_state, valid)


def _device_lost_plan(chunk, times):
    faults.install_plan(faults.FaultPlan(rules=[faults.FaultRule(
        target="device", kind="device_lost", op=f"commit-chunk:{chunk}", times=times)]))


def _crash_run(plan_state, valid, run_dir, kill_chunk=4):
    """Chunked under a checkpointer and a 3-strike device_lost rule: two
    in-place recoveries, then the third strike aborts the plan with chunks
    0..kill_chunk-1 journaled and a snapshot on disk."""
    journal = RunJournal.open(run_dir)
    cp = PlanCheckpointer(journal, every=2)
    _device_lost_plan(kill_chunk, times=3)
    try:
        with installed(cp):
            with pytest.raises(faults.DeviceLostError):
                _dispatch(plan_state, valid)
    finally:
        faults.uninstall_plan()
        journal.close()


def _resume_run(plan_state, valid, run_dir):
    journal = RunJournal.open(run_dir)
    cp = PlanCheckpointer(journal, resume=True, every=2)
    try:
        with installed(cp):
            return _dispatch(plan_state, valid)
    finally:
        journal.close()


def _snapshot_paths(run_dir):
    return sorted(glob.glob(os.path.join(run_dir, "ckpt", "plan-*.npz")))


# ---------------------------------------------------------------------------
# Bit identity: chunked == monolithic == JAX
# ---------------------------------------------------------------------------

def test_chunked_matches_monolithic_across_seeds(plan_state, jax_state, monkeypatch):
    ns, _, _, _, s_pad = plan_state
    for seed in (0, 1, 2):
        valid = _valid_lanes(ns, s_pad, seed)
        ref = _mono_ref(plan_state, valid, monkeypatch)
        _assert_identical(ref, _jax_dispatch(jax_state, plan_state, valid))
        monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
        got = _dispatch(plan_state, valid)
        _assert_identical(got, ref)
        assert fast.scenario_carry_digest_host(got[0]) == \
            fast.scenario_carry_digest_host(ref[0]) == jfast.scenario_carry_digest_host(ref[0])


def test_chunked_matches_monolithic_non_divisor_chunk(plan_state, jax_state, monkeypatch):
    """C = 5 does not divide the 32 pods: the last chunk runs with
    trailing pad rows the count gate keeps out of the carry."""
    ns, _, _, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 0)
    ref = _mono_ref(plan_state, valid, monkeypatch)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", "5")
    got = _dispatch(plan_state, valid)
    _assert_identical(got, ref)
    _assert_identical(got, _jax_dispatch(jax_state, plan_state, valid))


def test_chunk_at_least_plan_size_stays_monolithic(plan_state, monkeypatch):
    ns, _, batch, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 0)
    ref = _mono_ref(plan_state, valid, monkeypatch)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(int(batch.p)))
    before = metrics.PLAN_CHUNKS.value()
    _assert_identical(_dispatch(plan_state, valid), ref)
    assert metrics.PLAN_CHUNKS.value() == before  # single-scan path taken


def test_carry_digest_device_host_twins_agree(plan_state):
    _, carry, _, _, s_pad = plan_state
    carry_s = state_mod.stack_carry(carry, s_pad)
    assert fast.scenario_carry_digest(carry_s) == \
        fast.scenario_carry_digest_host(fast.carry_to_host(carry_s))


@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "uint8", "int8", "int64"])
def test_digest_fold_every_dtype(dtype):
    """The device fold (int64 on 16-bit halves) equals the numpy u32 fold
    bit for bit on every leaf dtype, negative ints, NaN payloads, signed
    zeros and infinities included, and on a tensor long enough to wrap."""
    rng = np.random.default_rng(len(dtype))
    if dtype == "float32":
        x = rng.standard_normal(70_007).astype(np.float32) * 1e30
        x[:5] = [np.nan, -0.0, np.inf, -np.inf, 0.0]
        x.view(np.uint32)[5] = 0x7FC0DEAD  # a NaN payload
    elif dtype == "bool":
        x = rng.random(70_007) < 0.5
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, 70_007, dtype=dtype, endpoint=True)
    x = x.reshape(7, -1)
    assert int(delta.digest_fold(torch.from_numpy(x)).item()) == delta.digest_fold_host(x)


def test_carry_from_host_checks_shapes(plan_state):
    _, carry, _, _, s_pad = plan_state
    carry_s = state_mod.stack_carry(carry, s_pad)
    host = fast.carry_to_host(carry_s)
    back = fast.carry_from_host(carry_s, host)
    for f in Carry._fields:
        assert torch.equal(getattr(back, f), getattr(carry_s, f))
        assert getattr(back, f).data_ptr() != getattr(carry_s, f).data_ptr()
    host["free"] = host["free"][:, :-1]
    with pytest.raises(ValueError, match="different plan shape"):
        fast.carry_from_host(carry_s, host)


# ---------------------------------------------------------------------------
# Device-loss rollback (no checkpointer: the in-memory last good carry)
# ---------------------------------------------------------------------------

def test_device_lost_recovers_in_place(plan_state, monkeypatch, tmp_path):
    ns, _, _, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 0)
    ref = _mono_ref(plan_state, valid, monkeypatch)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    yes0 = metrics.DEVICE_LOST.value(handled="yes")
    _device_lost_plan(chunk=2, times=1)
    try:
        got = _dispatch(plan_state, valid)
    finally:
        faults.uninstall_plan()
    _assert_identical(got, ref)
    assert metrics.DEVICE_LOST.value(handled="yes") == yes0 + 1
    arts = sorted(glob.glob(str(tmp_path / "flight" / "flightrec-device-lost-*.json")))
    assert arts
    with open(arts[-1]) as fh:
        events = json.load(fh)["events"]
    lost = [e for e in events if e.get("kind") == "device-lost"]
    assert lost and lost[-1]["chunk"] == 2
    assert lost[-1]["restored_to"] == 0  # no checkpointer: the plan's start
    int(lost[-1]["digest"], 16)


def test_device_lost_strikes_out_after_three(plan_state, monkeypatch):
    ns, _, _, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 0)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    no0 = metrics.DEVICE_LOST.value(handled="no")
    yes0 = metrics.DEVICE_LOST.value(handled="yes")
    _device_lost_plan(chunk=1, times=3)
    try:
        with pytest.raises(faults.DeviceLostError):
            _dispatch(plan_state, valid)
    finally:
        faults.uninstall_plan()
    assert metrics.DEVICE_LOST.value(handled="yes") == yes0 + 2
    assert metrics.DEVICE_LOST.value(handled="no") == no0 + 1


def test_wave_driver_checkpoints_and_recovers(plan_state, jax_state, monkeypatch, tmp_path):
    """The wave driver (waves of 4) under a checkpointer with a device_lost
    at wave 3: every wave journals a plan_chunk record with the digest
    chain the chunked driver (C = 4) journals, and the result equals the
    scan and the JAX package's."""
    ns, _, batch, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 1)
    ref = _mono_ref(plan_state, valid, monkeypatch)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    chunked_dir = str(tmp_path / "chunked")
    journal = RunJournal.open(chunked_dir)
    with installed(PlanCheckpointer(journal, every=2)):
        _assert_identical(_dispatch(plan_state, valid), ref)
    journal.close()
    monkeypatch.setenv("OSIM_WAVE_COMMIT", "1")
    monkeypatch.setenv("OSIM_WAVE_SIZE", str(CHUNK))
    wave_dir = str(tmp_path / "wave")
    journal = RunJournal.open(wave_dir)
    yes0 = metrics.DEVICE_LOST.value(handled="yes")
    _device_lost_plan(chunk=3, times=1)
    waves0 = metrics.COMMIT_ROUNDS.child_state()[2]
    with installed(PlanCheckpointer(journal, every=2)):
        got = _dispatch(plan_state, valid)
    faults.uninstall_plan()
    journal.close()
    _assert_identical(got, ref)
    _assert_identical(got, _jax_dispatch(jax_state, plan_state, valid))
    assert metrics.DEVICE_LOST.value(handled="yes") == yes0 + 1
    # eight waves, and wave 2 once more: the loss at wave 3 restores the
    # snapshot taken after wave 1
    assert metrics.COMMIT_ROUNDS.child_state()[2] - waves0 == -(-int(batch.p) // CHUNK) + 1

    def chunks(d):
        return [(e["chunk"], e["digest"]) for e in replay(d) if e["event"] == "plan_chunk"]

    # the re-executed wave 2 journals its record again, with the same digest
    assert chunks(wave_dir) == chunks(chunked_dir)[:3] + chunks(chunked_dir)[2:]
    assert [e["digest"] for e in replay(wave_dir) if e["event"] == "plan_done"] == \
        [e["digest"] for e in replay(chunked_dir) if e["event"] == "plan_done"]


# ---------------------------------------------------------------------------
# Crash -> resume bit identity (journal + snapshot)
# ---------------------------------------------------------------------------

def test_crash_then_resume_byte_identical(plan_state, monkeypatch, tmp_path):
    ns, _, batch, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 1)
    ref = _mono_ref(plan_state, valid, monkeypatch)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    run_dir = str(tmp_path / "run")

    _crash_run(plan_state, valid, run_dir, kill_chunk=4)
    chunks = [e for e in replay(run_dir) if e["event"] == "plan_chunk"]
    assert [e["chunk"] for e in chunks] == [0, 1, 2, 3]
    assert _snapshot_paths(run_dir)

    skipped0 = metrics.RESUME_CHUNKS_SKIPPED.value()
    got = _resume_run(plan_state, valid, run_dir)
    _assert_identical(got, ref)
    assert metrics.RESUME_CHUNKS_SKIPPED.value() == skipped0 + 4

    events = replay(run_dir)
    n_chunks = -(-int(batch.p) // CHUNK)
    assert [e["chunk"] for e in events if e["event"] == "plan_chunk"] == list(range(n_chunks))
    done = [e for e in events if e["event"] == "plan_done"]
    assert len(done) == 1 and done[0]["chunks"] == n_chunks


def test_crash_then_resume_matches_jax_journal(plan_state, jax_state, monkeypatch, tmp_path):
    """The same crash in the JAX package journals the same plan key and
    chunk digests, and the port resumes the JAX package's run directory
    (its journal and its snapshots) to the JAX package's result."""
    from open_simulator_tpu.durable import RunJournal as JJournal
    from open_simulator_tpu.durable import checkpoint as jcp
    from open_simulator_tpu.resilience import faults as jfaults

    ns, _, _, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 2)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _crash_run(plan_state, valid, port_dir, kill_chunk=5)
    journal = JJournal.open(jax_dir)
    jfaults.install_plan(jfaults.FaultPlan(rules=[jfaults.FaultRule(
        target="device", kind="device_lost", op="commit-chunk:5", times=3)]))
    try:
        with jcp.installed(jcp.PlanCheckpointer(journal, every=2)):
            with pytest.raises(jfaults.DeviceLostError):
                _jax_dispatch(jax_state, plan_state, valid)
    finally:
        jfaults.uninstall_plan()
        journal.close()

    def strip(d):
        return [{k: v for k, v in e.items() if k not in ("ts", "seq")} for e in replay(d)]

    assert strip(port_dir) == strip(jax_dir)
    assert [os.path.basename(p) for p in _snapshot_paths(port_dir)] == \
        [os.path.basename(p) for p in _snapshot_paths(jax_dir)]
    monkeypatch.delenv("OSIM_COMMIT_CHUNK")
    want = _jax_dispatch(jax_state, plan_state, valid)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    _assert_identical(_resume_run(plan_state, valid, jax_dir), want)


# ---------------------------------------------------------------------------
# Snapshot corruption: torn files and digest mismatches are never trusted
# ---------------------------------------------------------------------------

def test_torn_snapshot_falls_back_to_previous(plan_state, monkeypatch, tmp_path):
    ns, _, _, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 1)
    ref = _mono_ref(plan_state, valid, monkeypatch)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    run_dir = str(tmp_path / "run")
    _crash_run(plan_state, valid, run_dir, kill_chunk=4)

    snaps = _snapshot_paths(run_dir)
    assert len(snaps) == 2  # every=2 -> snapshots after chunks 1 and 3
    with open(snaps[-1], "rb+") as fh:
        fh.truncate(os.path.getsize(snaps[-1]) // 2)

    skipped0 = metrics.RESUME_CHUNKS_SKIPPED.value()
    _assert_identical(_resume_run(plan_state, valid, run_dir), ref)
    assert metrics.RESUME_CHUNKS_SKIPPED.value() == skipped0 + 2


def test_corrupt_snapshot_digest_detected(plan_state, monkeypatch, tmp_path):
    """A snapshot with flipped carry bytes is a valid .npz whose embedded
    digest no longer matches its leaves: resume skips it."""
    ns, _, batch, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 1)
    ref = _mono_ref(plan_state, valid, monkeypatch)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    run_dir = str(tmp_path / "run")
    _crash_run(plan_state, valid, run_dir, kill_chunk=4)

    for path in _snapshot_paths(run_dir):
        with np.load(path) as z:
            arrays = {k: z[k].copy() for k in z.files}
        flat = arrays[f"carry_{Carry._fields[0]}"].reshape(-1)
        flat[0] = flat[0] + 1
        with open(path, "wb") as fh:
            np.savez(fh, **arrays)

    skipped0 = metrics.RESUME_CHUNKS_SKIPPED.value()
    _assert_identical(_resume_run(plan_state, valid, run_dir), ref)
    assert metrics.RESUME_CHUNKS_SKIPPED.value() == skipped0
    chunks = [e["chunk"] for e in replay(run_dir) if e["event"] == "plan_chunk"]
    assert chunks == list(range(-(-int(batch.p) // CHUNK)))


def test_resume_refuses_divergent_replay(plan_state, monkeypatch, tmp_path):
    ns, _, batch, _, s_pad = plan_state
    valid = _valid_lanes(ns, s_pad, 0)
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", str(CHUNK))
    run_dir = str(tmp_path / "run")
    journal = RunJournal.open(run_dir)
    key = f"0:{int(ns.valid.shape[0])}x{int(batch.p)}x{s_pad}c{CHUNK}"
    journal.append("plan_chunk", plan=key, chunk=0, pods=CHUNK, digest="deadbeef")
    journal.close()

    journal = RunJournal.open(run_dir)
    try:
        with installed(PlanCheckpointer(journal, resume=True, every=2)):
            with pytest.raises(CheckpointError, match="not .*byte-identical|refusing"):
                _dispatch(plan_state, valid)
    finally:
        journal.close()


# ---------------------------------------------------------------------------
# Knob parsing
# ---------------------------------------------------------------------------

def test_knob_parsing(monkeypatch):
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", "garbage")
    assert fast.commit_chunk_size() == 0
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", "-3")
    assert fast.commit_chunk_size() == 0
    monkeypatch.setenv("OSIM_COMMIT_CHUNK", "256")
    assert fast.commit_chunk_size() == 256
    monkeypatch.setenv("OSIM_CKPT_EVERY", "0")
    assert checkpoint_every() == 1
    monkeypatch.setenv("OSIM_CKPT_EVERY", "nope")
    assert checkpoint_every() == 4
    monkeypatch.delenv("OSIM_CKPT_EVERY")
    assert checkpoint_every() == 4


# ---------------------------------------------------------------------------
# True SIGKILL: a sweep subprocess killed mid-chunk, resumed by the CLI
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sigkill_mid_chunk_then_cli_resume(tmp_path):
    import random

    cfg = os.path.join(os.path.dirname(__file__), "fixtures", "sweep", "simon-config.yaml")
    kill_chunk = random.Random(0xC0FFEE).randrange(1, 4)
    env = dict(os.environ, OSIM_COMMIT_CHUNK="8", OSIM_CKPT_EVERY="2")
    env.pop("OSIM_FAULT_PLAN", None)

    def sweep(run_dir, fault_plan=None):
        e = dict(env)
        if fault_plan:
            e["OSIM_FAULT_PLAN"] = fault_plan
        return subprocess.run(
            [sys.executable, "-m", "open_simulator_tpu_torch.cli", "sweep", "--capacity",
             "-f", cfg, "--run-dir", run_dir, "--device", "cpu"],
            env=e, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        ).returncode

    ref_dir = str(tmp_path / "ref")
    assert sweep(ref_dir) == 0
    run_dir = str(tmp_path / "run")
    plan = ("rules:\n  - target: device\n"
            f"    op: \"commit-chunk:{kill_chunk}\"\n    kind: chunk_kill\n    times: 1\n")
    rc = sweep(run_dir, fault_plan=plan)
    assert rc in (137, -9), f"expected SIGKILL, got rc={rc}"
    assert any(e["event"] == "plan_chunk" for e in replay(run_dir))
    rc = subprocess.run(
        [sys.executable, "-m", "open_simulator_tpu_torch.cli", "runs", "resume", run_dir,
         "--device", "cpu"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    ).returncode
    assert rc == 0
    for d in (ref_dir, run_dir):
        with open(os.path.join(d, "outcome.json")) as fh:
            assert json.load(fh)["placement_digest"] == sc.RUN_DIR_DIGESTS["sweep"]
    shutil.rmtree(run_dir)


@pytest.mark.slow
def test_full_width_scan_digest_matches_jax(monkeypatch):
    """sim_configs.CHUNK_SCAN_DIGEST recomputed with the JAX package:
    plan_full's first ladder sweep (6 lanes padded to 8, 20,480 node rows)
    over the first CHUNK_SCAN_PODS pods, scanned whole (chip_smoke.py's
    durable phase holds the port's chunked runs on the card to it)."""
    from open_simulator_tpu.core import objects as jobj
    from open_simulator_tpu.core import workloads as jwl
    from open_simulator_tpu.engine import simulator as jsim
    from open_simulator_tpu.engine.capacity import LADDER_LANES, _TrialReuse, lower_bound_nodes
    from open_simulator_tpu.ops.encode import encode_pods, node_bucket

    monkeypatch.setenv("OSIM_WAVE_COMMIT", "0")
    spec = sc.plan_spec()
    jwl.reset_name_rng()
    cluster, apps = sc.build(spec, jobj.Node, jsim.ClusterResource, jsim.AppResource)
    template = jobj.Node.from_dict(sc.template_spec())
    n_base = len(cluster.nodes)
    k = lower_bound_nodes(jsim.simulate(cluster, apps), template)
    ladder = [k << i for i in range(LADDER_LANES) if k << i <= 1 << 14]
    n_pad = node_bucket(n_base + ladder[-1])
    jwl.reset_name_rng()
    cluster, apps = sc.build(spec, jobj.Node, jsim.ClusterResource, jsim.AppResource)
    trial = jsim.ClusterResource(
        nodes=list(cluster.nodes) + _TrialReuse(template, n_base).fakes(ladder[-1]))
    sim = jsim.Simulator(trial, n_pad=n_pad)
    app_pods = sim._expand_apps(apps)
    sim._build_device_state([p for pods in app_pods for p in pods])
    valid = []
    for c in ladder:
        v = np.asarray(sim._table.valid).copy()
        v[n_base + c:] = False
        valid.append(v)
    s_pad = jfast.scenario_bucket(len(ladder))
    valid += [valid[0]] * (s_pad - len(ladder))
    out = jfast.schedule_scenarios_host(
        sim._ns, jstate.stack_carry(sim._carry, s_pad),
        encode_pods(sim.enc, app_pods[0][:sc.CHUNK_SCAN_PODS]),
        jnp.stack([sim.weights] * s_pad), jnp.asarray(np.stack(valid)), len(ladder))
    assert (n_pad, s_pad, len(ladder)) == (20_480, 8, 6)
    assert jfast.scenario_carry_digest(out[0]) == sc.CHUNK_SCAN_DIGEST
