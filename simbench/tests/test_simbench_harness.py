"""The harness: the result line's keys, the no-JAX check, cells found by
name from new files alone, the control, and runs driven on the CPU with
the timed path broken underneath, each of which must come out not
correct."""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from simbench import control, gen, program, run
from simbench.reference import compare
from simbench.tests import small

REPO = Path(__file__).resolve().parents[2]
CELLS = {"zonal_5k.bulk": ("zonal_5k", "bulk", 90, 0.004),
         "pai_gpu.share": ("pai_gpu", "share", 60, 0.25)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cell(name):
    """A cell and its per-layer metrics, whether or not BENCHMARK.json
    lists it (`pai_gpu.share` is kept as data for a later cell, §7)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg, tr = CELLS[name][:2]
    cell = {"name": name, "config": cfg, "traffic": tr, "chips": 1}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name]) or m["name"] != "domain_pop_roofline_pct"]
    return cell, layer


def _small_run(name, trace=False, seconds=0.5, root=run.ROOT, seed=2**31 + 7):
    cell, layer = _cell(name)
    cfg, tr, nodes, scale = CELLS[name]
    return run.run_cell(cell, small.config(cfg, nodes), small.traffic(tr, scale), layer, seed,
                        seconds, trace, time.perf_counter(), device="cpu", root=root)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_result_line_has_every_key(name):
    result, lines = _small_run(name, trace=True)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for k, v in result["checks"].items():
        assert set(v) == {"value", "limit"} and v["value"] == 0 == v["limit"]
    assert lines[-len(result["checks"]):] == [
        f"check {k} {v['value']} limit {v['limit']}" for k, v in result["checks"].items()]
    # the span readers find their spans on the CPU; the trace readers, no
    # capture, so they are left out rather than reported as 0
    assert set(result["metrics"]) == {"host_ms_per_kpod", "schedule_ms_per_kpod"}
    json.dumps(result)


def test_untraced_run_reports_the_end_to_end_metrics():
    result, _ = _small_run("pai_gpu.share")
    assert set(result["metrics"]) == {"sim_pods_per_s", "setup_s"}
    assert result["metrics"]["sim_pods_per_s"]["unit"] == "pods/s"
    assert result["metrics"]["sim_pods_per_s"]["value"] > 0


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "zonal_5k.bulk", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "simbench", tmp_path / "simbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "simbench", "--workload", "zonal_5k.bulk",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_jax_check_compares_top_level_names_whole(monkeypatch):
    for name in ("open_simulator_tpu_torch", "open_simulator_tpu_torch.ops", "jaxtyping",
                 "flaxen", "simbench"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in ("jax", "jaxlib", "flax", "open_simulator_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.jax_modules() == []
    monkeypatch.setitem(sys.modules, "open_simulator_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.jax_modules() == ["jax", "open_simulator_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys; from simbench import run, program, control; "
            "program.port('engine.simulator'); program.port('ops.fast'); "
            "import simbench.trace; print(run.jax_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr[-2000:]


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "simbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("open_simulator_tpu_torch", "open_simulator_tpu",
                                               "jax", "torch", "simbench"), (path, n)
    code = ("import sys; import simbench.reference.sched, simbench.reference.compare; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'open_simulator_tpu_torch', 'jax')))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.stdout.strip() == "[]", p.stderr[-2000:]


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    sb = tmp_path / "simbench"
    for sub in ("configs", "traffic", "metrics"):
        (sb / sub).mkdir(parents=True)
    cfg = small.config("zonal_5k", 40)
    cfg["name"] = "tiny_zones"
    (sb / "configs" / "tiny_zones.json").write_text(json.dumps(cfg))
    tr = small.traffic("bulk", 0.002)
    tr["name"] = "trickle"
    (sb / "traffic" / "trickle.json").write_text(json.dumps(tr))
    (sb / "metrics" / "calls_read.py").write_text(
        "def read(r):\n    return float(len(r.calls)) if r.calls else None\n")
    bench["configs"].append({"name": "tiny_zones", "source": "a test",
                             "file": "simbench/configs/tiny_zones.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny_zones.trickle", "config": "tiny_zones",
                               "traffic": "trickle", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_read", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "harness",
                               "moves": "sim_pods_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, config, traffic, layer = run.load_cell("tiny_zones.trickle", root=tmp_path)
    assert config["nodes"]["count"] == 40 and traffic["name"] == "trickle"
    assert [m["name"] for m in layer] == ["calls_read"]
    result, _ = run.run_cell(cell, config, traffic, layer, 5, 0.2, True, time.perf_counter(),
                             device="cpu", root=sb)
    assert result["correct"] and result["metrics"]["calls_read"]["value"] >= 1


class _Broken:
    """The simulator's schedule engine with one fault underneath."""

    def __init__(self, kind):
        self.kind = kind
        self.sim = program.port("engine.simulator")
        self.real = self.sim.schedule_batch_fast

    def __call__(self, ns, carry, batch, *a, **kw):
        out = list(self.real(ns, carry, batch, *a, **kw))
        nodes, reasons = out[1], out[2]
        if self.kind == "state_unchanged":
            out[0] = carry
        elif self.kind == "half_left_out":
            nodes[len(nodes) // 2:] = -1
            reasons[len(nodes) // 2:] = 0
        elif self.kind == "answer_altered":
            placed = np.nonzero(nodes >= 0)[0]
            if placed.size:
                i = placed[0]
                nodes[i] = (nodes[i] + 1) % int(ns.valid.sum())
        return tuple(out)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, kind, name):
    monkeypatch.setattr(program.port("engine.simulator"), "schedule_batch_fast", _Broken(kind))
    result, _ = _small_run(name)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checks"].values())
    if kind == "state_unchanged":
        assert result["checks"]["overcommit"]["value"] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_answers_that_never_come_are_not_correct(monkeypatch, name):
    """Pods the program neither binds nor reports: `undecided`."""
    sim = program.port("engine.simulator").Simulator
    real, seen = sim._bind_placed, []

    def bind_most(self, pod, *a):
        seen.append(pod)
        if len(seen) % 10:
            real(self, pod, *a)

    monkeypatch.setattr(sim, "_bind_placed", bind_most)
    result, _ = _small_run(name)
    assert result["correct"] is False and result["checks"]["undecided"]["value"] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_is_not_correct(name):
    cfg, tr, nodes, scale = CELLS[name]
    for seed in (1, 2, 3):
        r = control.readings(small.config(cfg, nodes), small.traffic(tr, scale), seed)
        assert r["calls_compared"] >= 1
        assert any(r[k] > v for k, v in compare.LIMITS.items()), r


def test_control_answer_round_trips_through_the_comparison():
    cfg, tr, nodes, scale = CELLS["zonal_5k.bulk"]
    config, traffic = small.config(cfg, nodes), small.traffic(tr, scale)
    node_list = gen.cluster(config, 4)
    apps = gen.call_apps(traffic, 4, 0)
    from simbench.reference import sched
    ref = sched.schedule(node_list, apps)
    assert compare.judge(control.answer_of(ref), ref) == dict.fromkeys(compare.LIMITS, 0)
