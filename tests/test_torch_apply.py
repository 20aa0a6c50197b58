"""`simon apply` on the port (`engine/apply.py`, `cli.py`) against the JAX
package's `run_apply(auto_plan=False)` on the repo's example configs.
Tolerance: exact — the same report text (the `device:` line apart, which
names the backend), the same placement digest and the same result digest;
the JAX run must also reproduce the constants in `sim_configs.APPLY_DIGESTS`
that `chip_smoke.py` checks on the card."""

import io
import json
from pathlib import Path

import pytest
import torch

from open_simulator_tpu.api.config import SimonConfig as JConfig
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.engine import apply as japply
from open_simulator_tpu_torch import cli, sim_configs as sc
from open_simulator_tpu_torch.api.config import SimonConfig as TConfig
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.engine import apply as tapply

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = list(sc.APPLY_DIGESTS)


def load(cls, path):
    return cls.load(str(ROOT / path))


@pytest.fixture(scope="module")
def jax_outcomes():
    out = {}
    for path in CONFIGS:
        jwl.reset_name_rng()
        buf = io.StringIO()
        out[path] = (japply.run_apply(load(JConfig, path), auto_plan=False, out=buf), buf.getvalue())
    return out


def port_apply(path, **kw):
    twl.reset_name_rng()
    buf = io.StringIO()
    outcome = tapply.run_apply(load(TConfig, path), auto_plan=False, out=buf, device="cpu", **kw)
    return outcome, buf.getvalue()


def _without_device_line(text):
    return [line for line in text.splitlines() if not line.startswith("device:")]


@pytest.mark.parametrize("path", CONFIGS)
def test_run_apply_matches_jax(jax_outcomes, path):
    jout, jtext = jax_outcomes[path]
    tout, ttext = port_apply(path)
    assert tout.report == jout.report
    assert _without_device_line(ttext) == _without_device_line(jtext)
    assert ttext.splitlines()[-1] == "device: cpu" == f"device: {tout.device}"
    assert tapply.placement_digest(tout.result) == japply.placement_digest(jout.result)
    assert sc.result_digest(tout.result) == sc.result_digest(jout.result)
    assert [fa.name for fa in tout.failed_apps] == [fa.name for fa in jout.failed_apps]
    report_d, placement_d, unscheduled = sc.APPLY_DIGESTS[path]
    assert sc.report_digest(jout.report) == sc.report_digest(jtext) == report_d
    assert japply.placement_digest(jout.result) == placement_d
    assert len(tout.result.unscheduled) == unscheduled


def test_cli_apply_writes_report(jax_outcomes, tmp_path):
    path = CONFIGS[0]
    report = tmp_path / "report.txt"
    twl.reset_name_rng()
    rc = cli.main(["apply", "-f", str(ROOT / path), "--device", "cpu", "--no-auto-plan",
                   "--output-file", str(report)])
    assert rc == 2   # the config leaves pods unscheduled
    assert sc.report_digest(report.read_text()) == sc.APPLY_DIGESTS[path][0]
    assert report.read_text().splitlines()[-1] == "device: cpu"


def test_cli_apply_deadline_exits(monkeypatch, capsys):
    """A simulation that outlives OSIM_CALL_DEADLINE_S ends the CLI with exit
    code 3 and the watchdog's message; nothing degrades to another device.
    (The abandoned worker thread is joined here so that it does not draw
    names from the shared RNG during later tests.)"""
    import threading

    monkeypatch.setenv("OSIM_CALL_DEADLINE_S", "1e-6")
    twl.reset_name_rng()
    rc = cli.main(["apply", "-f", str(ROOT / CONFIGS[0]), "--device", "cpu"])
    for t in threading.enumerate():
        if t.name.startswith("osim-guarded-"):
            t.join()
    assert rc == 3
    err = capsys.readouterr().err
    assert "error: apply-simulate exceeded 1e-06s deadline; abandoned" in err


def _search_runs(path, **kw):
    """The same run_apply call through both packages: (outcome, printed
    text) each, name RNG reset first."""
    runs = {}
    for pkg, mod, cfg_cls, extra in (("jax", japply, JConfig, {}),
                                     ("torch", tapply, TConfig, {"device": "cpu"})):
        (jwl if pkg == "jax" else twl).reset_name_rng()
        buf = io.StringIO()
        runs[pkg] = (mod.run_apply(load(cfg_cls, path), out=buf, **kw, **extra), buf.getvalue())
    return runs


def test_apply_capacity_search_matches_jax(tmp_path):
    """run_apply(auto_plan=True) on the quickstart config: the search lines,
    the planned cluster's report, placement digest, nodes_added and
    attempts equal the JAX run's and sim_configs.QUICKSTART_DIGEST; the CLI
    without --no-auto-plan prints the same."""
    runs = _search_runs(CONFIGS[0])
    (jout, jtext), (tout, ttext) = runs["jax"], runs["torch"]
    strip = [ln for ln in ttext.splitlines() if not ln.startswith("device:")]
    assert strip == [ln for ln in jtext.splitlines() if not ln.startswith("device:")]
    assert strip[0].endswith("pod(s) unschedulable; searching for minimum copies of node bigworker...")
    assert strip[1].startswith("capacity plan: add 1 x bigworker (")
    want = sc.QUICKSTART_DIGEST
    got = (sc.report_digest(ttext), tapply.placement_digest(tout.result),
           tout.plan.nodes_added, tout.plan.attempts)
    assert got == want
    assert (tout.plan.nodes_added, tout.plan.attempts) == (jout.plan.nodes_added, jout.plan.attempts)
    assert not tout.result.unscheduled
    report = tmp_path / "report.txt"
    twl.reset_name_rng()
    rc = cli.main(["apply", "-f", str(ROOT / CONFIGS[0]), "--device", "cpu",
                   "--output-file", str(report)])
    assert rc == 0
    assert sc.report_digest(report.read_text()) == sc.report_digest(jtext)


def test_apply_interactive_loop_matches_jax(capsys):
    """The reference's interactive loop with a scripted input: deploy every
    app, show the reasons, add nodes, quit; the report, the loop's own lines
    (on stderr while the report goes to a stream) and the final result
    equal the JAX loop's."""
    def scripted():
        answers = iter(["", "r", "a", "a", "q"])
        return lambda _prompt: next(answers)

    runs = {}
    for pkg, mod, cfg_cls, extra in (("jax", japply, JConfig, {}),
                                     ("torch", tapply, TConfig, {"device": "cpu"})):
        (jwl if pkg == "jax" else twl).reset_name_rng()
        buf = io.StringIO()
        capsys.readouterr()
        out = mod.run_apply(load(cfg_cls, CONFIGS[0]), interactive=True, out=buf,
                            input_fn=scripted(), **extra)
        runs[pkg] = (out, buf.getvalue(), capsys.readouterr().err)
    (jout, jtext, jerr), (tout, ttext, terr) = runs["jax"], runs["torch"]
    assert sc.report_digest(ttext) == sc.report_digest(jtext)
    def loop_lines(err):
        return [ln for ln in err.splitlines()
                if ln.startswith(("applications", "  [", "2 pod")) or "nodes are available" in ln]

    loop = loop_lines(terr)
    assert loop == loop_lines(jerr)
    assert "2 pod(s) failed to schedule." in loop and any("nodes are available" in ln for ln in loop)
    assert sc.result_digest(tout.result) == sc.result_digest(jout.result)
    assert tout.plan is None


def test_apply_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapply.run_apply(load(TConfig, CONFIGS[1]), auto_plan=False, out=io.StringIO())


def test_scheduler_config_with_extenders_is_refused(tmp_path):
    """A scheduler config naming an extender that refuses every node: the
    engine now calls it, so every pod is refused with the extender's
    FailedNodes message, as in the JAX package."""
    from open_simulator_tpu_torch.tools.stubs import StubExtender

    stub = StubExtender({"allow": set(), "failed": {}})
    try:
        sched = tmp_path / "sched.yaml"
        sched.write_text(
            "kind: KubeSchedulerConfiguration\n"
            f"extenders:\n  - urlPrefix: {stub.url}\n    filterVerb: filter\n"
        )
        tout, _ = port_apply(CONFIGS[1], scheduler_config=str(sched))
        jwl.reset_name_rng()
        jout = japply.run_apply(load(JConfig, CONFIGS[1]), auto_plan=False, out=io.StringIO(),
                                scheduler_config=str(sched))
    finally:
        stub.close()
    assert tout.report == jout.report
    assert tout.result.unscheduled and stub.calls
    assert all("didn't pass extender filter" in u.reason for u in tout.result.unscheduled)


SCHED_CFG = """
kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
    plugins:
      score:
        disabled:
          - name: NodeResourcesLeastAllocated
        enabled:
          - name: NodeResourcesBalancedAllocation
            weight: 5
"""


@pytest.mark.parametrize("path, ext, plan", [
    (CONFIGS[0], "gpu", []), (CONFIGS[1], "gpu", ["--no-auto-plan"]),
    (CONFIGS[1], "open-local", ["--no-auto-plan"]), (CONFIGS[1], "gpu,open-local", ["--no-auto-plan"]),
])
def test_cli_reference_flags_match_jax_cli(tmp_path, path, ext, plan):
    """The reference's own command line: --default-scheduler-config and
    --extended-resources give the JAX CLI's report byte for byte (the
    device line apart), with the capacity search or without; the port's
    --scheduler-config stays an alias."""
    from open_simulator_tpu.cli import main as jcli

    sched = tmp_path / "sched.yaml"
    sched.write_text(SCHED_CFG)
    reports = {}
    for name, mod, wl, flags in (("jax", jcli, jwl, []), ("torch", cli, twl, ["--device", "cpu"]),
                                 ("alias", cli, twl, ["--device", "cpu"])):
        out = tmp_path / f"{name}.txt"
        flag = "--scheduler-config" if name == "alias" else "--default-scheduler-config"
        wl.reset_name_rng()
        rc = mod.main(["apply", "-f", str(ROOT / path), flag, str(sched),
                       "--extended-resources", ext, "--output-file", str(out)] + plan + flags)
        reports[name] = (rc, _without_device_line(out.read_text()))
    assert reports["torch"] == reports["jax"] == reports["alias"]
    text = "\n".join(reports["torch"][1])
    assert "gpu" in ext or "=== GPU Share ===" not in text
    assert "open-local" in ext or "=== Local Storage ===" not in text


def test_full_report_extended_views():
    """full_report's extended / extended_resources parameters select the
    views as the JAX package's do."""
    from open_simulator_tpu.engine import report as jreport
    from open_simulator_tpu_torch.engine import report as treport

    tout, _ = port_apply(CONFIGS[1])
    jwl.reset_name_rng()
    jout = japply.run_apply(load(JConfig, CONFIGS[1]), auto_plan=False, out=io.StringIO())
    for kw in ({}, {"extended": False}, {"extended_resources": []},
               {"extended_resources": ["gpu"]}, {"extended_resources": ["open-local"]}):
        assert treport.full_report(tout.result, **kw) == jreport.full_report(jout.result, **kw)


def test_cli_rejects_unknown_extended_resource(capsys):
    rc = cli.main(["apply", "-f", str(ROOT / CONFIGS[1]), "--device", "cpu",
                   "--extended-resources", "gpu,tpu"])
    assert rc == 1
    assert "--extended-resources: unknown resource(s) ['tpu']; expected gpu, open-local" in \
        capsys.readouterr().err


@pytest.fixture(scope="module")
def jax_devices_report(tmp_path_factory):
    """The JAX CLI's `apply --devices 2` report of CONFIGS[1] (its mesh on
    two of the virtual CPU devices), with its exit code."""
    from open_simulator_tpu.cli import main as jcli

    out = tmp_path_factory.mktemp("jdev") / "report.txt"
    jwl.reset_name_rng()
    rc = jcli.main(["apply", "-f", str(ROOT / CONFIGS[1]), "--devices", "2",
                    "--output-file", str(out)])
    return rc, _without_device_line(out.read_text())


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--devices", "0"], ["--run-dir", "runs/x", "--devices", "2"],
    ["--resume", "runs/x", "--devices", "2"], ["--run-dir", "runs/x", "--resume", "--devices", "0"],
])
def test_cli_devices_match_single_device_and_jax_cli(jax_devices_report, tmp_path, flags):
    """`--devices 2` (and 0: every device, one CPU slot) with `--device cpu`
    shards every simulation of the apply, the capacity search's included,
    over CPU mesh slots, also beside `--run-dir` / `--resume`: the report
    equals `--devices 1`'s and the JAX CLI's `--devices 2` byte for byte
    (the device line apart)."""
    flags = [str(tmp_path / f) if f == "runs/x" else f for f in flags]
    reports = {}
    for name, extra in (("mesh", flags), ("single", ["--devices", "1"])):
        out = tmp_path / f"{name}.txt"
        twl.reset_name_rng()
        rc = cli.main(["apply", "-f", str(ROOT / CONFIGS[1]), "--device", "cpu",
                       "--output-file", str(out)] + extra)
        reports[name] = (rc, _without_device_line(out.read_text()))
    assert reports["mesh"] == reports["single"] == jax_devices_report
    assert not (ROOT / "runs").exists()


def test_cli_devices_beyond_the_cards_exit_1(monkeypatch, capsys):
    """Asking for more CUDA devices than are visible exits 1 with the
    reference's wording, before anything simulates."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(tapply, "simulate", lambda *a, **k: pytest.fail("simulated"))
    rc = cli.main(["apply", "-f", str(ROOT / CONFIGS[1]), "--devices", "2"])
    assert rc == 1
    assert "error: --devices 2 requested but only 1 CUDA devices are visible" in \
        capsys.readouterr().err


def test_cli_metrics_file_beside_run_dir(capsys, tmp_path):
    """`--metrics-file` beside `--run-dir` / `--resume`: the apply runs and
    writes the registry's snapshot and the run's outcome."""
    flags = ["--run-dir", str(tmp_path / "runs" / "x"), "--resume",
             "--metrics-file", str(tmp_path / "m.json")]
    rc = cli.main(["apply", "-f", str(ROOT / CONFIGS[1]), "--device", "cpu"] + flags)
    err = capsys.readouterr().err
    assert not (ROOT / "runs").exists()
    assert rc == 0 and "is not ported" not in err
    assert "osim_apply_total" in json.loads((tmp_path / "m.json").read_text())
    assert (tmp_path / "runs" / "x" / "outcome.json").is_file()


def test_simulate_result_pods_on():
    tout, _ = port_apply(CONFIGS[1])
    jwl.reset_name_rng()
    jout = japply.run_apply(load(JConfig, CONFIGS[1]), auto_plan=False, out=io.StringIO())
    for st in jout.result.node_status:
        assert ([p.key for p in tout.result.pods_on(st.node.name)]
                == [p.key for p in jout.result.pods_on(st.node.name)])
    assert tout.result.pods_on("no-such-node") == []


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
