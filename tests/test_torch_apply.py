"""`simon apply` on the port (`engine/apply.py`, `cli.py`) against the JAX
package's `run_apply(auto_plan=False)` on the repo's example configs.
Tolerance: exact — the same report text (the `device:` line apart, which
names the backend), the same placement digest and the same result digest;
the JAX run must also reproduce the constants in `sim_configs.APPLY_DIGESTS`
that `chip_smoke.py` checks on the card."""

import io
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


def test_apply_capacity_search_not_ported():
    """With auto_plan (the default) and unscheduled pods, the reference
    searches for a node count; the port refuses instead of answering less."""
    twl.reset_name_rng()
    with pytest.raises(NotImplementedError, match="item 8"):
        tapply.run_apply(load(TConfig, CONFIGS[0]), out=io.StringIO(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        tapply.run_apply(load(TConfig, CONFIGS[0]), interactive=True, device="cpu")


def test_apply_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapply.run_apply(load(TConfig, CONFIGS[1]), auto_plan=False, out=io.StringIO())


def test_scheduler_config_with_extenders_is_refused(tmp_path):
    """Extenders parse (as the reference's config does) and are then refused
    by the engine, which does not call them yet."""
    sched = tmp_path / "sched.yaml"
    sched.write_text(
        "kind: KubeSchedulerConfiguration\n"
        "extenders:\n  - urlPrefix: http://localhost:8888/\n    filterVerb: filter\n"
    )
    with pytest.raises(NotImplementedError, match="item 11"):
        port_apply(CONFIGS[1], scheduler_config=str(sched))
