"""The port's durable runs against the JAX package, on the CPU. Tolerance:
exact.

  - durable/journal.py: WAL semantics (append, replay, torn-tail truncation,
    the newline as the commit point), atomic_write, summaries; a journal the
    port writes replays through the reference's `replay` and the other way
    round, and the port resumes a capacity search from a journal the JAX
    package wrote;
  - durable/watchdog.py: guarded_call with fake clocks, and the acquisition
    ladder, which raises and journals `backend_error` after its retry where
    the reference degrades to the CPU;
  - engine/capacity.py: journaled serial and batched searches and their
    resume (only the missing trials or sweeps re-run), each with the JAX
    run's trial records, attempts and placement digest;
  - the `sweep --capacity` CLI's crash-then-resume outcome.json, byte-equal
    to an uninterrupted one and to the JAX CLI's; run_apply's journal and
    outcome.json;
  - utils/flightrec.py: the cases of tests/test_flightrec.py on the port.

The cases of tests/test_durable.py keep their names here.
"""

import io
import json
import os
import threading
import types

import pytest
import torch

from open_simulator_tpu.api.config import SimonConfig as JConfig
from open_simulator_tpu.cli.main import main as jcli_main
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.durable import journal as jjournal
from open_simulator_tpu.engine import apply as japply
from open_simulator_tpu.engine import capacity as jcap
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.api.config import SimonConfig as TConfig
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.durable import (
    DeadlineExceeded,
    RunJournal,
    acquire_backend,
    atomic_write,
    completed_segments,
    guarded_call,
    list_runs,
    replay,
    summarize_run,
)
from open_simulator_tpu_torch.durable.journal import JOURNAL_NAME
from open_simulator_tpu_torch.durable.watchdog import BackendUnavailable
from open_simulator_tpu_torch.engine import apply as tapply
from open_simulator_tpu_torch.engine import capacity as tcap
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.resilience import faults
from open_simulator_tpu_torch.utils import flightrec, metrics
from open_simulator_tpu_torch.utils.tracing import span

torch.set_num_threads(1)  # tiny tensors: threads only add contention

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CONFIG = os.path.join(FIXTURES, "simon-config.yaml")
SWEEP_CONFIG = os.path.join(FIXTURES, "sweep", "simon-config.yaml")


@pytest.fixture(autouse=True)
def _flight_dir(monkeypatch, tmp_path):
    """Flight-recorder dumps of these tests land in their tmp dir."""
    monkeypatch.setenv("OSIM_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.delenv("OSIM_FLIGHT_EVENTS", raising=False)
    monkeypatch.delenv("OSIM_FAULT_PLAN", raising=False)
    flightrec.reset()
    yield
    flightrec.reset()


def _counter_total(counter) -> int:
    return int(sum(s["value"] for s in counter.snapshot()["samples"]))


# ---------------------------------------------------------------------------
# Journal WAL semantics.
# ---------------------------------------------------------------------------

def test_journal_append_replay_roundtrip(tmp_path):
    d = str(tmp_path / "run")
    with RunJournal.open(d) as j:
        j.append("run_start", kind="test")
        j.append("trial", node_count=0, good=False)
        j.append("trial", node_count=4, good=True)
    events = replay(d)
    assert [e["event"] for e in events] == ["run_start", "trial", "trial"]
    assert [e["seq"] for e in events] == [0, 1, 2]
    assert all(isinstance(e["ts"], float) for e in events)
    with RunJournal.open(d) as j:
        assert [e["node_count"] for e in j.events("trial")] == [0, 4]
        assert j.has("run_start") and not j.has("run_end")
        j.append("run_end", outcome="ok")
    assert replay(d)[-1]["seq"] == 3


def test_journal_direct_construction_rejected(tmp_path):
    with pytest.raises(TypeError):
        RunJournal(str(tmp_path))


def test_journal_torn_tail_truncated_on_open(tmp_path):
    d = str(tmp_path / "run")
    with RunJournal.open(d) as j:
        j.append("run_start", kind="test")
        j.append("trial", node_count=1, good=True)
    path = os.path.join(d, JOURNAL_NAME)
    good_size = os.path.getsize(path)
    with open(path, "ab") as fh:
        fh.write(b'{"seq": 2, "event": "tri')
    with RunJournal.open(d) as j:
        assert [e["event"] for e in j.events()] == ["run_start", "trial"]
        j.append("trial", node_count=2, good=True)
        assert j.events()[-1]["seq"] == 2
    raw = open(path, "rb").read()
    lines = raw.decode().splitlines()
    assert len(lines) == 3 and all(json.loads(ln) for ln in lines)
    assert json.loads(raw[good_size:])["node_count"] == 2
    assert len(replay(d)) == 3


def test_journal_record_without_newline_not_committed(tmp_path):
    d = str(tmp_path / "run")
    os.makedirs(d)
    path = os.path.join(d, JOURNAL_NAME)
    with open(path, "wb") as fh:
        fh.write(b'{"seq": 0, "ts": 1.0, "event": "run_start"}\n')
        fh.write(b'{"seq": 1, "ts": 2.0, "event": "trial", "good": true}')
    assert [e["event"] for e in replay(d)] == ["run_start"]
    assert jjournal.replay(d) == replay(d)
    with RunJournal.open(d) as j:
        j.append("resumed")
        assert [e["seq"] for e in j.events()] == [0, 1]


def test_journal_replay_is_deterministic(tmp_path):
    d = str(tmp_path / "run")
    with RunJournal.open(d) as j:
        for i in range(20):
            j.append("trial", node_count=i, good=i % 2 == 0)
    assert replay(d) == replay(d)
    assert replay(d) == RunJournal.open(d).events()


def test_atomic_write_replaces_without_litter(tmp_path):
    path = str(tmp_path / "out.json")
    atomic_write(path, '{"v": 1}\n')
    atomic_write(path, '{"v": 2}\n')
    assert open(path).read() == '{"v": 2}\n'
    assert os.listdir(str(tmp_path)) == ["out.json"]


def test_completed_segments_last_write_wins():
    events = [
        {"event": "segment", "segment": "canary", "result": {"v": 1}},
        {"event": "segment", "segment": "headline", "result": {"v": 2}},
        {"event": "segment", "segment": "canary", "result": {"v": 3}},
        {"event": "trial", "node_count": 0},
    ]
    assert completed_segments(events) == {"canary": {"v": 3}, "headline": {"v": 2}}
    assert completed_segments(events) == jjournal.completed_segments(events)


def test_summarize_and_list_runs(tmp_path):
    a = str(tmp_path / "a")
    with RunJournal.open(a) as j:
        j.append("run_start", kind="apply", simon_config="x.yaml")
        j.append("backend", device="NVIDIA H100 80GB HBM3")
        j.append("trial", node_count=0, good=True)
        j.append("run_end", outcome="ok")
    # a run the reference degraded: its journal still lists the same
    b = str(tmp_path / "b")
    with jjournal.RunJournal.open(b) as j:
        j.append("run_start", kind="bench")
        j.append("backend_fallback", fallback="cpu", fallback_reason="timed out")
    sa = summarize_run(a)
    assert sa["kind"] == "apply" and sa["status"] == "completed"
    assert sa["outcome"] == "ok" and sa["trials"] == 1
    assert sa["device"] == "NVIDIA H100 80GB HBM3" and sa["fallback"] == ""
    sb = summarize_run(b)
    assert sb["status"] == "in-flight/crashed"
    assert sb["device"] == "cpu" and sb["fallback"] == "cpu"
    rows = list_runs(str(tmp_path))
    assert [r["name"] for r in rows] == ["b", "a"]  # newest first
    strip = [{k: v for k, v in r.items()} for r in jjournal.list_runs(str(tmp_path))]
    assert rows == strip


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_interop_with_reference(tmp_path, writer):
    """A journal written by one package replays identically through the
    other's replay, including after a torn tail, and appends continue the
    other's sequence."""
    d = str(tmp_path / "run")
    first, second = (RunJournal, jjournal.RunJournal) if writer == "port" else \
        (jjournal.RunJournal, RunJournal)
    with first.open(d) as j:
        j.append("run_start", kind="sweep", simon_config="c.yaml", use_greed=False)
        j.append("trial", node_count=0, good=False, attempt=1, retries=0, seed_hi=3)
        j.append("sweep", phase="ladder", counts=[3, 6], good=[False, True], n_pad=64)
    with open(os.path.join(d, JOURNAL_NAME), "ab") as fh:
        fh.write(b'{"seq": 3, "event": "plan_ch')
    assert replay(d) == jjournal.replay(d)
    assert [e["event"] for e in replay(d)] == ["run_start", "trial", "sweep"]
    with second.open(d) as j:
        j.append("run_resume")
    assert replay(d) == jjournal.replay(d)
    assert [e["seq"] for e in replay(d)] == [0, 1, 2, 3]
    assert summarize_run(d) == jjournal.summarize_run(d)


# ---------------------------------------------------------------------------
# Watchdog (sleep-free: fake clocks, tiny poll intervals).
# ---------------------------------------------------------------------------

def test_guarded_call_inline_when_deadline_zero():
    calls = []

    def fn():
        calls.append(threading.current_thread())
        return 42

    assert guarded_call("t", fn, 0) == 42
    assert calls == [threading.current_thread()]  # no worker thread spawned


def test_guarded_call_returns_result_within_deadline():
    assert guarded_call("t", lambda: "ok", 60, poll_s=0.001) == "ok"


def test_guarded_call_propagates_worker_error():
    def boom():
        raise ValueError("from worker")

    with pytest.raises(ValueError, match="from worker"):
        guarded_call("t", boom, 60, poll_s=0.001)


def test_watchdog_fires_on_deadline_with_fake_clock(tmp_path):
    before = _counter_total(metrics.WATCHDOG_FIRED)
    release = threading.Event()
    ticks = iter([0.0] + [1000.0] * 100)
    journal = RunJournal.open(str(tmp_path / "run"))
    try:
        with pytest.raises(DeadlineExceeded) as exc:
            guarded_call(
                "hung-stage", release.wait, 5.0,
                clock=lambda: next(ticks), poll_s=0.001, journal=journal,
            )
    finally:
        release.set()
    assert exc.value.stage == "hung-stage"
    assert _counter_total(metrics.WATCHDOG_FIRED) == before + 1
    wd = journal.events("watchdog")
    assert len(wd) == 1 and wd[0]["stage"] == "hung-stage"
    journal.close()


def test_acquire_backend_happy_path(tmp_path):
    journal = RunJournal.open(str(tmp_path / "run"))
    info = acquire_backend(deadline_s=60, journal=journal, probe=lambda: "FAKE_DEV_0",
                           poll_s=0.001)
    assert info == {"device": "FAKE_DEV_0"}
    assert [e["event"] for e in journal.events()] == ["backend"]
    journal.close()
    # the default probe on the CPU names the device
    assert acquire_backend(deadline_s=60, device="cpu", poll_s=0.001) == {"device": "cpu"}


def test_acquire_backend_degrades_to_cpu(tmp_path):
    """The reference's case, inverted: the port never switches devices, so
    two failed probes raise BackendUnavailable after journaling the retry
    and `backend_error` (no `backend_fallback`)."""
    calls = []

    def bad_probe():
        calls.append(1)
        raise RuntimeError("tunnel wedged")

    journal = RunJournal.open(str(tmp_path / "run"))
    with pytest.raises(BackendUnavailable, match="tunnel wedged") as exc:
        acquire_backend(deadline_s=60, journal=journal, probe=bad_probe, poll_s=0.001)
    assert len(calls) == 2  # first try + one retry
    assert [e["event"] for e in journal.events()] == ["backend_retry", "backend_error"]
    assert "tunnel wedged" in journal.events("backend_error")[0]["error"]
    assert str(exc.value) == journal.events("backend_error")[0]["error"]
    journal.close()
    summary = summarize_run(str(tmp_path / "run"))
    assert summary["fallback"] == "" and summary["device"] == ""


def test_backend_fault_injection_trips_ladder(tmp_path):
    plan = faults.FaultPlan.from_dict({
        "rules": [{"target": "backend", "op": "acquire", "kind": "error"}],
    })
    journal = RunJournal.open(str(tmp_path / "run"))
    with faults.injected(plan):
        with pytest.raises(BackendUnavailable, match="injected by fault plan"):
            acquire_backend(deadline_s=60, journal=journal, poll_s=0.001, device="cpu")
    assert [e["event"] for e in journal.events()] == ["backend_retry", "backend_error"]
    journal.close()
    # a one-shot fault is absorbed by the retry
    plan = faults.FaultPlan.from_dict({
        "rules": [{"target": "backend", "op": "acquire", "kind": "error", "times": 1}],
    })
    journal = RunJournal.open(str(tmp_path / "run2"))
    with faults.injected(plan):
        info = acquire_backend(deadline_s=60, journal=journal, poll_s=0.001, device="cpu")
    assert info == {"device": "cpu"}
    assert [e["event"] for e in journal.events()] == ["backend_retry", "backend"]
    journal.close()


def test_acquire_backend_cuda_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    journal = RunJournal.open(str(tmp_path / "run"))
    with pytest.raises(BackendUnavailable, match="CUDA"):
        acquire_backend(deadline_s=60, journal=journal, poll_s=0.001)
    assert journal.has("backend_error")
    journal.close()


# ---------------------------------------------------------------------------
# Checkpoint/resume of the capacity bisection, against the JAX package.
# ---------------------------------------------------------------------------

def _overloaded(pkg):
    cfg_cls, apply_mod = (JConfig, japply) if pkg == "jax" else (TConfig, tapply)
    cfg = cfg_cls.load(CONFIG)
    cluster = apply_mod.build_cluster(cfg)
    apps = apply_mod.build_apps(cfg)
    for app in apps:
        for obj in app.objects:
            if obj.get("kind") == "Deployment":
                obj["spec"]["replicas"] = 20
    return cluster, apps, apply_mod.load_new_node(cfg)


def _plan_counting(monkeypatch, pkg, journal, resume, inputs=None, sweep_mode="auto"):
    """plan_capacity with its live work counted: (plan, serial simulate()
    calls, batched run_scenarios calls)."""
    cap = jcap if pkg == "jax" else tcap
    (jwl if pkg == "jax" else twl).reset_name_rng()
    cluster, apps, new_node = inputs or _overloaded(pkg)
    real_simulate, real_sim_cls = cap.simulate, cap.Simulator
    serial, batched = [], []

    def counting(*a, **kw):
        serial.append(1)
        return real_simulate(*a, **kw)

    class CountingSimulator(real_sim_cls):
        def run_scenarios(self, *a, **kw):
            batched.append(1)
            return super().run_scenarios(*a, **kw)

    monkeypatch.setattr(cap, "simulate", counting)
    monkeypatch.setattr(cap, "Simulator", CountingSimulator)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    plan = cap.plan_capacity(cluster, apps, new_node, journal=journal, resume=resume,
                             sweep_mode=sweep_mode, **kw)
    monkeypatch.setattr(cap, "simulate", real_simulate)
    monkeypatch.setattr(cap, "Simulator", real_sim_cls)
    return plan, len(serial), len(batched)


def _seed_journal_with_events(dst_dir, events):
    """A crash: the run dir holds exactly `events`, nothing after them."""
    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(dst_dir, JOURNAL_NAME), "w") as fh:
        for e in events:
            fh.write(json.dumps(e, sort_keys=True) + "\n")


def _strip(events, kinds):
    """The records of `kinds`, without their timestamps."""
    return [{k: v for k, v in e.items() if k != "ts"} for e in events if e["event"] in kinds]


@pytest.fixture(scope="module")
def serial_fresh(tmp_path_factory):
    """A fresh journaled serial search in both packages: {pkg: (plan,
    run dir)}."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for pkg, journal_cls in (("jax", jjournal.RunJournal), ("port", RunJournal)):
            d = str(tmp_path_factory.mktemp(f"fresh-{pkg}"))
            j = journal_cls.open(d)
            plan, _, _ = _plan_counting(mp, pkg, j, resume=False, sweep_mode="serial")
            j.close()
            out[pkg] = (plan, d)
    finally:
        mp.undo()
    return out


def test_capacity_resume_skips_all_journaled_trials(tmp_path, monkeypatch, serial_fresh):
    fresh_plan, d1 = serial_fresh["port"]
    jplan, jd = serial_fresh["jax"]
    assert fresh_plan is not None and fresh_plan.nodes_added >= 1
    assert _strip(replay(d1), ("trial", "final")) == _strip(jjournal.replay(jd), ("trial", "final"))
    assert (fresh_plan.nodes_added, fresh_plan.attempts) == (jplan.nodes_added, jplan.attempts)
    trials = [e for e in replay(d1) if e["event"] == "trial"]
    assert len(trials) >= 2  # the search actually bisected

    # crash after ALL trials committed, before the outcome: the resume
    # re-runs ZERO trials, only the materializing final
    d2 = str(tmp_path / "resumed")
    _seed_journal_with_events(d2, trials)
    j2 = RunJournal.open(d2)
    resumed_plan, resumed_calls, _ = _plan_counting(monkeypatch, "port", j2, resume=True)
    j2.close()
    assert resumed_calls == 1
    assert resumed_plan.nodes_added == fresh_plan.nodes_added
    assert resumed_plan.attempts == fresh_plan.attempts
    assert resumed_plan.retries == fresh_plan.retries
    ev2 = replay(d2)
    assert len([e for e in ev2 if e["event"] == "trial"]) == len(trials)
    assert [e["event"] for e in ev2][-1] == "final"
    assert tapply.placement_digest(resumed_plan.result) == \
        tapply.placement_digest(fresh_plan.result) == japply.placement_digest(jplan.result)


def test_capacity_resume_reruns_only_missing_trials(tmp_path, monkeypatch, serial_fresh):
    """Crash one trial earlier: exactly that trial re-runs (plus the final
    unless it was the winner), in both packages alike, and the port resumes
    from the journal the JAX package wrote too."""
    fresh_plan, d1 = serial_fresh["port"]
    _, jd = serial_fresh["jax"]
    counts = {}
    for src, events in (("port", replay(d1)), ("jax", jjournal.replay(jd))):
        trials = [e for e in events if e["event"] == "trial"]
        d2 = str(tmp_path / f"resumed-{src}")
        _seed_journal_with_events(d2, trials[:-1])
        j2 = RunJournal.open(d2)
        resumed_plan, resumed_calls, _ = _plan_counting(monkeypatch, "port", j2, resume=True)
        j2.close()
        assert resumed_calls <= 2
        assert resumed_plan.nodes_added == fresh_plan.nodes_added
        assert resumed_plan.attempts == fresh_plan.attempts
        counts[src] = resumed_calls
    jd2 = str(tmp_path / "resumed-by-jax")
    _seed_journal_with_events(jd2, [e for e in replay(d1) if e["event"] == "trial"][:-1])
    j2 = jjournal.RunJournal.open(jd2)
    _, jcalls, _ = _plan_counting(monkeypatch, "jax", j2, resume=True)
    j2.close()
    assert counts == {"port": jcalls, "jax": jcalls}


# ---------------------------------------------------------------------------
# Batched capacity sweep: journaled `sweep` records + resume.
# ---------------------------------------------------------------------------

HOSTNAME_ANTI = {
    "podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [
            {
                "labelSelector": {"matchLabels": {"app": "lonely"}},
                "topologyKey": "kubernetes.io/hostname",
            }
        ]
    }
}


def _batch_overloaded(pkg):
    """Batch-eligible (no DaemonSets, priorities or greed), with hostname
    anti-affinity that defeats the demand estimate, so the batched search
    journals several `sweep` records."""
    from tests.factories import make_deployment, make_node

    sim = jsim if pkg == "jax" else tsim

    def node(name):
        n = make_node(name, cpu="32", memory="64Gi")
        return n if pkg == "jax" else tobj.Node.from_dict(n.raw)

    cluster = sim.ClusterResource(nodes=[node(f"base-{i}") for i in range(2)])
    apps = [sim.AppResource(name="app", objects=[make_deployment(
        "lonely", replicas=24, cpu="500m", memory="1Gi", with_affinity=HOSTNAME_ANTI)])]
    return cluster, apps, node("clone")


@pytest.fixture(scope="module")
def batched_fresh(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for pkg, journal_cls in (("jax", jjournal.RunJournal), ("port", RunJournal)):
            d = str(tmp_path_factory.mktemp(f"batched-{pkg}"))
            j = journal_cls.open(d)
            out[pkg] = _plan_counting(mp, pkg, j, resume=False,
                                      inputs=_batch_overloaded(pkg)) + (d,)
            j.close()
    finally:
        mp.undo()
    return out


def test_batched_sweep_journals_all_lane_verdicts(batched_fresh):
    plan, serial_calls, batched_live, d = batched_fresh["port"]
    jplan, _, jbatched, jd = batched_fresh["jax"]
    assert plan is not None and plan.nodes_added >= 1
    sweeps = [e for e in replay(d) if e["event"] == "sweep"]
    assert len(sweeps) == plan.batched_calls == batched_live >= 2
    for e in sweeps:
        assert e["phase"] in ("ladder", "refine")
        assert len(e["counts"]) == len(e["good"]) >= 1
        assert e["n_pad"] >= 2
    assert plan.attempts == 1 + sum(len(e["counts"]) for e in sweeps)
    assert serial_calls == 2  # base trial + final materialize
    kinds = ("trial", "sweep", "final")
    assert _strip(replay(d), kinds) == _strip(jjournal.replay(jd), kinds)
    assert (plan.nodes_added, plan.attempts, plan.batched_calls, batched_live) == \
        (jplan.nodes_added, jplan.attempts, jplan.batched_calls, jbatched)


def test_batched_sweep_resume_reruns_zero_scenarios(tmp_path, monkeypatch, batched_fresh):
    fresh_plan, _, fresh_batched, d1 = batched_fresh["port"]
    d2 = str(tmp_path / "resumed")
    _seed_journal_with_events(d2, [e for e in replay(d1) if e["event"] in ("trial", "sweep")])
    j2 = RunJournal.open(d2)
    resumed_plan, resumed_serial, resumed_batched = _plan_counting(
        monkeypatch, "port", j2, resume=True, inputs=_batch_overloaded("port"))
    j2.close()
    assert resumed_batched == 0  # zero re-run scenarios
    assert resumed_serial == 1  # only the final materialize
    assert resumed_plan.nodes_added == fresh_plan.nodes_added
    assert resumed_plan.attempts == fresh_plan.attempts
    assert resumed_plan.batched_calls == fresh_plan.batched_calls
    assert resumed_plan.retries == fresh_plan.retries
    assert tapply.placement_digest(resumed_plan.result) == \
        tapply.placement_digest(fresh_plan.result)
    ev2 = replay(d2)
    assert len([e for e in ev2 if e["event"] == "sweep"]) == fresh_batched
    assert [e["event"] for e in ev2][-1] == "final"


def test_batched_sweep_resume_reruns_only_missing_sweeps(tmp_path, monkeypatch, batched_fresh):
    fresh_plan, _, _, d1 = batched_fresh["port"]
    _, _, _, jd = batched_fresh["jax"]
    # the crashed run's journal is the JAX package's: the port resumes it
    events = [e for e in jjournal.replay(jd) if e["event"] in ("trial", "sweep")]
    sweep_idx = [i for i, e in enumerate(events) if e["event"] == "sweep"]
    d2 = str(tmp_path / "resumed")
    _seed_journal_with_events(d2, events[: sweep_idx[-1]])
    j2 = RunJournal.open(d2)
    resumed_plan, resumed_serial, resumed_batched = _plan_counting(
        monkeypatch, "port", j2, resume=True, inputs=_batch_overloaded("port"))
    j2.close()
    assert resumed_batched == 1
    assert resumed_serial == 1
    assert resumed_plan.nodes_added == fresh_plan.nodes_added
    assert resumed_plan.attempts == fresh_plan.attempts
    assert resumed_plan.batched_calls == fresh_plan.batched_calls


def test_sweep_cli_resume_outcome_byte_identical(tmp_path, capsys):
    """`sweep --capacity` end to end: a crashed-then-resumed run's
    outcome.json is byte-identical to an uninterrupted one, and to the JAX
    CLI's, and its digest is sim_configs.RUN_DIR_DIGESTS["sweep"]."""
    ref = str(tmp_path / "ref")
    twl.reset_name_rng()
    assert cli.main(["sweep", "-f", SWEEP_CONFIG, "--capacity", "--run-dir", ref,
                     "--device", "cpu"]) == 0
    ref_bytes = open(os.path.join(ref, "outcome.json"), "rb").read()
    doc = json.loads(ref_bytes)
    assert doc["kind"] == "sweep" and doc["batched_calls"] >= 1
    assert doc["placement_digest"] == sc.RUN_DIR_DIGESTS["sweep"]
    jref = str(tmp_path / "jref")
    jwl.reset_name_rng()
    assert jcli_main(["sweep", "-f", SWEEP_CONFIG, "--capacity", "--run-dir", jref]) == 0
    assert open(os.path.join(jref, "outcome.json"), "rb").read() == ref_bytes
    out = capsys.readouterr().out.splitlines()
    assert out[0].split("(")[0] == out[-1].split("(")[0]  # the same report line

    crash = str(tmp_path / "crash")
    _seed_journal_with_events(
        crash, [e for e in replay(ref) if e["event"] in ("run_start", "trial", "sweep")])
    assert not os.path.exists(os.path.join(crash, "outcome.json"))
    twl.reset_name_rng()
    assert cli.main(["sweep", "-f", SWEEP_CONFIG, "--capacity", "--run-dir", crash, "--resume",
                     "--device", "cpu"]) == 0
    assert open(os.path.join(crash, "outcome.json"), "rb").read() == ref_bytes
    ev = replay(crash)
    assert "run_resume" in [e["event"] for e in ev]
    assert [e["event"] for e in ev][-1] == "run_end"


# ---------------------------------------------------------------------------
# run_apply end to end: journaled outcome, resume identity, provenance.
# ---------------------------------------------------------------------------

def test_run_apply_journals_and_resumes_identically(tmp_path):
    cfg = TConfig.load(CONFIG)
    d = str(tmp_path / "run")
    twl.reset_name_rng()
    outcome = tapply.run_apply(cfg, out=io.StringIO(), run_dir=d, config_path=CONFIG,
                               device="cpu")
    assert outcome.device == "cpu"
    assert outcome.fallback == "" and outcome.fallback_reason == ""
    first = open(os.path.join(d, "outcome.json"), "rb").read()
    doc = json.loads(first)
    for key in ("device", "fallback", "fallback_reason", "placement_digest"):
        assert key in doc
    assert doc["fallback"] == doc["fallback_reason"] == ""
    events = [e["event"] for e in replay(d)]
    assert events[0] == "run_start" and events[1] == "backend" and "run_end" in events

    jd = str(tmp_path / "jrun")
    jwl.reset_name_rng()
    jout = japply.run_apply(JConfig.load(CONFIG), out=io.StringIO(), run_dir=jd,
                            config_path=CONFIG)
    jdoc = json.load(open(os.path.join(jd, "outcome.json")))
    assert {k: v for k, v in doc.items() if k != "device"} == \
        {k: v for k, v in jdoc.items() if k != "device"}
    kinds = ("trial", "final", "run_end")
    strip = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
             for e in replay(d) if e["event"] in kinds]
    jstrip = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
              for e in jjournal.replay(jd) if e["event"] in kinds]
    assert strip == jstrip

    before = _counter_total(metrics.RUN_RESUMED)
    twl.reset_name_rng()
    outcome2 = tapply.run_apply(cfg, out=io.StringIO(), run_dir=d, resume=True,
                                config_path=CONFIG, device="cpu")
    assert _counter_total(metrics.RUN_RESUMED) == before + 1
    assert open(os.path.join(d, "outcome.json"), "rb").read() == first
    assert [u.pod.key for u in outcome2.result.unscheduled] == \
        [u.pod.key for u in outcome.result.unscheduled]
    assert "run_resume" in [e["event"] for e in replay(d)]


def test_run_apply_output_reports_device():
    out = io.StringIO()
    twl.reset_name_rng()
    tapply.run_apply(TConfig.load(CONFIG), out=out, device="cpu")
    assert "device: cpu" in out.getvalue().splitlines()


def test_run_apply_deadline_journals_watchdog_and_resumes(tmp_path, monkeypatch, capsys):
    """The second capacity probe outlives its deadline (the watchdog's fire
    is stood in for: guarded_call's own firing is tested above): the CLI
    exits 3 with the fire journaled and no CPU retry, and `runs resume`
    finishes the run with the uninterrupted run's placement digest."""
    d = str(tmp_path / "run")
    probes = []
    real = tcap.guarded_call

    def fire_on_second_probe(stage, fn, deadline_s, **kw):
        if stage == "capacity-probe":
            probes.append(1)
            if len(probes) == 2:
                raise DeadlineExceeded(stage, 0.2)
        return real(stage, fn, deadline_s, **kw)

    monkeypatch.setattr(tcap, "guarded_call", fire_on_second_probe)
    twl.reset_name_rng()
    rc = cli.main(["apply", "-f", sc_path("example/simon-config.yaml"), "--device", "cpu",
                   "--run-dir", d])
    assert rc == 3
    assert "capacity-probe exceeded 0.2s deadline; abandoned" in capsys.readouterr().err
    events = replay(d)
    assert [e["stage"] for e in events if e["event"] == "watchdog"] == ["capacity-probe"]
    assert not any(e["event"] in ("backend_fallback", "run_end") for e in events)
    assert [e["node_count"] for e in events if e["event"] == "trial"] == [0]
    monkeypatch.setattr(tcap, "guarded_call", real)
    twl.reset_name_rng()
    assert cli.main(["runs", "resume", d, "--device", "cpu"]) == 0
    doc = json.load(open(os.path.join(d, "outcome.json")))
    assert doc["placement_digest"] == sc.RUN_DIR_DIGESTS["apply"] == sc.QUICKSTART_DIGEST[1]
    assert (doc["nodes_added"], doc["attempts"]) == sc.QUICKSTART_DIGEST[2:]


def sc_path(rel):
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), rel)


@pytest.mark.parametrize("abandon", [False, True], ids=["clean", "abandoned"])
def test_cli_exit_skips_finalisation_with_abandoned_worker(abandon):
    """A worker left running by a fired deadline may sit in the device
    runtime's native code, where interpreter shutdown aborts the process
    (SIGABRT): the CLI's exit then ends the process without finalisation
    (no atexit handler runs), and exits normally otherwise."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import atexit, threading
        from open_simulator_tpu_torch import cli
        from open_simulator_tpu_torch.durable.watchdog import DeadlineExceeded, guarded_call
        atexit.register(print, "finalised", flush=True)
        if {abandon}:
            try:
                guarded_call("hold", threading.Event().wait, 0.01, poll_s=0.001)
            except DeadlineExceeded:
                print("fired", flush=True)
        cli._exit(3)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=sc_path(""), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 3, proc.stderr
    assert proc.stdout.split() == (["fired"] if abandon else ["finalised"])


def test_runs_cli_list_show_and_errors(tmp_path, capsys):
    root = str(tmp_path)
    assert cli.main(["runs", "list", "--root", root]) == 0
    assert capsys.readouterr().out.strip() == f"no journaled runs under {root}"
    d = str(tmp_path / "a")
    with RunJournal.open(d) as j:
        j.append("run_start", kind="apply", simon_config="x.yaml")
        j.append("backend", device="cpu")
    assert cli.main(["runs", "list", "--root", root]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["RUN", "KIND", "STATUS", "TRIALS", "SEGS", "DEVICE", "PATH"]
    assert lines[1].split()[:6] == ["a", "apply", "in-flight/crashed", "0", "0", "cpu"]
    assert cli.main(["runs", "show", d]) == 0
    out = capsys.readouterr().out
    assert "    status: in-flight/crashed" in out and "[   1] backend" in out
    assert cli.main(["runs", "show"]) == 1
    assert "`runs show` needs a run directory" in capsys.readouterr().err
    assert cli.main(["runs", "resume", str(tmp_path / "none")]) == 1
    assert "no journal found" in capsys.readouterr().err
    b = str(tmp_path / "b")
    with RunJournal.open(b) as j:
        j.append("run_start", kind="bench")
    assert cli.main(["runs", "resume", b]) == 1
    assert "is kind=bench" in capsys.readouterr().err
    assert cli.main(["runs", "list", "--root", root, "--format", "json"]) == 0
    assert [r["name"] for r in json.loads(capsys.readouterr().out)] == ["b", "a"]


# ---------------------------------------------------------------------------
# The crash flight recorder (tests/test_flightrec.py's cases on the port).
# ---------------------------------------------------------------------------

def _dump_files(tmp_path):
    d = tmp_path / "flight"
    return sorted(d.glob("flightrec-*.json")) if d.is_dir() else []


def test_root_span_close_feeds_the_ring():
    with span("flight-probe", pods=3):
        with span("inner"):
            pass
    evs = [e for e in flightrec.events() if e["kind"] == "span"]
    assert evs, "root close did not reach the flight ring"
    ev = evs[-1]
    assert ev["name"] == "flight-probe"
    assert ev["meta"]["pods"] == 3
    assert len(ev["trace_id"]) == 32 and len(ev["span_id"]) == 16
    assert "children" not in ev


def test_journal_append_records_correlated_breadcrumb(tmp_path):
    j = RunJournal.open(str(tmp_path / "run"))
    try:
        with span("journaled-work") as s:
            rec = j.append("probe-event", x=1)
            trace_id = s.trace_id
    finally:
        j.close()
    notes = [e for e in flightrec.events() if e["kind"] == "journal"]
    assert notes, "journal append did not leave a breadcrumb"
    note = notes[-1]
    assert note["event"] == "probe-event"
    assert note["seq"] == rec["seq"]
    assert note["run_dir"] == j.run_dir
    assert note["trace_id"] == trace_id


def test_ring_rotates_at_configured_size(monkeypatch):
    monkeypatch.setenv("OSIM_FLIGHT_EVENTS", "4")
    for i in range(9):
        flightrec.note("probe", i=i)
    evs = flightrec.events()
    assert len(evs) == 4
    assert [e["i"] for e in evs] == [5, 6, 7, 8]


def test_dump_artifact_structure(tmp_path):
    metrics.JOURNAL_EVENTS.inc(event="flight-dump-probe")  # pre-baseline
    flightrec.note("marker", detail="before")  # first record -> baseline
    metrics.JOURNAL_EVENTS.inc(event="flight-dump-probe")
    with span("dumped-span"):
        pass
    path = flightrec.dump("unit-test", error="synthetic")
    assert path is not None
    doc = json.loads(open(path).read())
    assert doc["kind"] == "flight-recorder"
    assert doc["reason"] == "unit-test"
    assert doc["error"] == "synthetic"
    assert doc["pid"]
    assert {"marker", "span"} <= {e["kind"] for e in doc["events"]}
    assert "untraced" in doc["traces"]
    span_ev = [e for e in doc["events"] if e["kind"] == "span"][-1]
    assert span_ev["trace_id"] in doc["traces"]
    fam = doc["metrics_delta"]["osim_journal_events_total"]
    probe = [s for s in fam if s["labels"] == {"event": "flight-dump-probe"}]
    assert probe and probe[0]["value"] == 1


def test_dump_filename_and_sequence(tmp_path):
    p1 = flightrec.dump("unit-test")
    p2 = flightrec.dump("unit-test")
    assert p1 != p2
    assert p1.endswith("-1.json") and p2.endswith("-2.json")
    names = [p.name for p in _dump_files(tmp_path)]
    assert all(n.startswith("flightrec-unit-test-") for n in names)


def test_watchdog_fire_writes_flight_dump(tmp_path):
    release = threading.Event()
    try:
        with pytest.raises(DeadlineExceeded):
            guarded_call("flight-stage", lambda: release.wait(5.0), 0.05, poll_s=0.01)
    finally:
        release.set()
    dumps = [p for p in _dump_files(tmp_path) if "watchdog" in p.name]
    assert dumps, "watchdog fire did not dump the flight recorder"
    doc = json.loads(dumps[-1].read_text())
    assert doc["reason"] == "watchdog"
    assert "flight-stage" in doc["error"]


def test_crash_hooks_dump_once_and_chain(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(flightrec, "_prev_sys_hook", lambda *a: seen.append(a))
    flightrec._sys_hook(RuntimeError, RuntimeError("boom"), None)
    assert len(seen) == 1
    dumps = [p for p in _dump_files(tmp_path) if "crash" in p.name]
    assert len(dumps) == 1
    assert "RuntimeError: boom" in json.loads(dumps[0].read_text())["error"]
    flightrec._sys_hook(KeyboardInterrupt, KeyboardInterrupt(), None)
    assert len([p for p in _dump_files(tmp_path) if "crash" in p.name]) == 1
    assert len(seen) == 2


def test_threading_hook_dumps(tmp_path, monkeypatch):
    monkeypatch.setattr(flightrec, "_prev_threading_hook", None)
    args = types.SimpleNamespace(exc_type=ValueError, exc_value=ValueError("worker died"),
                                 exc_traceback=None, thread=None)
    flightrec._threading_hook(args)
    dumps = [p for p in _dump_files(tmp_path) if "crash" in p.name]
    assert dumps
    assert "worker died" in json.loads(dumps[-1].read_text())["error"]


def test_dump_never_raises(monkeypatch):
    monkeypatch.setenv("OSIM_FLIGHT_DIR", "/proc/nonexistent/flight")
    assert flightrec.dump("unit-test") is None


def test_install_crash_hook_idempotent(monkeypatch):
    import sys

    monkeypatch.setattr(flightrec, "_hooks_installed", False)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(threading, "excepthook", threading.excepthook)
    flightrec.install_crash_hook()
    first = sys.excepthook
    flightrec.install_crash_hook()
    assert sys.excepthook is first is flightrec._sys_hook
    assert threading.excepthook is flightrec._threading_hook


def test_metrics_registry_snapshot_and_reset():
    """The registry the flight recorder and chaos read: snapshot() in the
    reference's JSON form, reset() zeroes every sample."""
    metrics.DEVICE_LOST.inc(handled="yes")
    metrics.CHECKPOINT_BYTES.inc(10)
    snap = metrics.REGISTRY.snapshot()
    assert snap["osim_checkpoint_bytes"]["type"] == "counter"
    assert {"labels": {"handled": "yes"}, "value": metrics.DEVICE_LOST.value(handled="yes")} in \
        snap["osim_device_lost_total"]["samples"]
    metrics.COMMIT_ROUNDS.observe(3)
    hist = metrics.REGISTRY.snapshot()["osim_commit_rounds"]["samples"][0]
    assert set(hist) == {"labels", "buckets", "sum", "count"} and hist["buckets"]["+Inf"] >= 1
    metrics.REGISTRY.reset()
    assert metrics.REGISTRY.snapshot() == {}
    assert metrics.DEVICE_LOST.value(handled="yes") == 0
    assert metrics.CHECKPOINT_BYTES.snapshot()["samples"] == [{"labels": {}, "value": 0.0}]


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
