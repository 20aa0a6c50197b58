"""`simon chaos` on the port against the JAX CLI, on the CPU. Tolerance: the
reports are byte-equal.

  - the two chaos cases of tests/test_resilience.py: the same fault-plan
    seed gives byte-identical reports across runs, equal to the JAX CLI's,
    and an injected chart fault degrades (exit 0); no plan exits 1;
  - a plan naming the `admission` target (ported with the server) runs,
    with the report and exit code of the JAX CLI;
  - `chaos --capacity` (a journaled chunked capacity sweep in a subprocess
    under a device_lost plan, held against a clean run): the report equals
    the JAX CLI's and says the placements match.
"""

import os

import pytest
import torch
import yaml

from open_simulator_tpu.cli.main import main as jmain
from open_simulator_tpu_torch import cli

torch.set_num_threads(1)  # tiny tensors: threads only add contention

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

_NODE = {
    "kind": "Node",
    "metadata": {"name": "n0", "labels": {"kubernetes.io/hostname": "n0"}},
    "status": {"allocatable": {"cpu": "16", "memory": "32Gi", "pods": "110"}},
}


def _deploy(replicas=1, cpu="1", name="d"):
    return {
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": "x"},
        "spec": {"replicas": replicas, "template": {
            "metadata": {"labels": {"app": name}},
            "spec": {"containers": [{"name": "c", "image": "img",
                                     "resources": {"requests": {"cpu": cpu}}}]},
        }},
    }


def _chaos_fixture(tmp_path):
    cluster_dir = tmp_path / "cluster"
    cluster_dir.mkdir()
    (cluster_dir / "node.yaml").write_text(yaml.safe_dump(_NODE))
    app_dir = tmp_path / "app"
    app_dir.mkdir()
    (app_dir / "deploy.yaml").write_text(yaml.safe_dump(_deploy(replicas=2)))
    chart_dir = tmp_path / "chart"
    (chart_dir / "templates").mkdir(parents=True)
    (chart_dir / "Chart.yaml").write_text("apiVersion: v2\nname: web\nversion: 0.1.0\n")
    (chart_dir / "values.yaml").write_text("")
    (chart_dir / "templates" / "deploy.yaml").write_text(
        yaml.safe_dump(_deploy(replicas=1, name="web")))
    cfg = {
        "apiVersion": "simon/v1alpha1",
        "kind": "Config",
        "metadata": {"name": "chaos-e2e"},
        "spec": {
            "cluster": {"customConfig": str(cluster_dir)},
            "appList": [
                {"name": "ok", "path": str(app_dir)},
                {"name": "web", "path": str(chart_dir), "chart": True},
            ],
        },
    }
    cfg_path = tmp_path / "simon.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    plan_path = tmp_path / "plan.yaml"
    plan_path.write_text(
        "seed: 7\nrules:\n  - target: chart\n    op: web\n    kind: error\n    times: 1\n")
    return cfg_path, plan_path


@pytest.fixture(autouse=True)
def _flight_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("OSIM_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.delenv("OSIM_FAULT_PLAN", raising=False)


def test_chaos_report_deterministic_and_degraded(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OSIM_COMPILE_CACHE", "")
    cfg_path, plan_path = _chaos_fixture(tmp_path)
    argv = ["chaos", "-f", str(cfg_path), "--fault-plan", str(plan_path)]

    rc1 = cli.main(argv + ["--device", "cpu"])
    out1 = capsys.readouterr().out
    rc2 = cli.main(argv + ["--device", "cpu"])
    out2 = capsys.readouterr().out
    rc3 = jmain(argv)
    out3 = capsys.readouterr().out

    assert rc1 == rc2 == rc3 == 0
    assert out1 == out2 == out3
    assert "simon chaos report" in out1
    assert "target=chart" in out1 and "injected 1 of 1" in out1
    assert "apps failed to render: 1 (web)" in out1
    assert "unscheduled pods: 0" in out1
    assert "resident drift repairs: 0" in out1
    assert "outcome: degraded" in out1


def test_chaos_requires_a_plan(capsys):
    rc = cli.main(["chaos", "-f", "/nonexistent.yaml", "--device", "cpu"])
    assert rc == 1
    assert "no fault plan" in capsys.readouterr().err


def test_chaos_refuses_unported_target(tmp_path, capsys):
    """The `admission` target was the last one the port refused; with the
    server ported, a plan naming it runs (an apply never reaches the
    admission queue, so nothing is injected) and reports what the JAX CLI
    reports."""
    cfg_path, _ = _chaos_fixture(tmp_path)
    plan_path = tmp_path / "admission.yaml"
    plan_path.write_text("rules:\n  - target: admission\n    kind: queue_full\n")
    argv = ["chaos", "-f", str(cfg_path), "--fault-plan", str(plan_path)]
    rc = cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr()
    assert rc == jmain(argv)
    assert out.out == capsys.readouterr().out
    assert "target=admission" in out.out and "ROADMAP" not in out.err


def test_chaos_capacity_device_lost_matches_jax(tmp_path, capsys, monkeypatch):
    """chaos --capacity on the sweep fixture under a device_lost at chunk 1:
    the faulted subprocess recovers in place, its placements match the
    clean run, and the report equals the JAX CLI's."""
    plan_path = tmp_path / "plan.yaml"
    plan_path.write_text(
        "seed: 3\nrules:\n  - target: device\n    op: \"commit-chunk:1\"\n"
        "    kind: device_lost\n    times: 1\n")
    cfg = os.path.join(FIXTURES, "sweep", "simon-config.yaml")
    monkeypatch.setenv("OSIM_WAVE_COMMIT", "0")
    argv = ["chaos", "--capacity", "-f", cfg, "--fault-plan", str(plan_path)]
    assert cli.main(argv + ["--device", "cpu", "--run-dir", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    (tmp_path / "jax").mkdir()  # the reference writes its plan there first
    assert jmain(argv + ["--run-dir", str(tmp_path / "jax")]) == 0
    assert out == capsys.readouterr().out
    assert "faulted run: completed — device faults recovered in place" in out
    assert "placement digest vs clean reference: match" in out
    assert "engine=serial" in out
