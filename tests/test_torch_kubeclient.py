"""The port's Kubernetes REST client and cluster snapshot
(`utils/kubeclient.py`) and `simon apply` on a `kubeConfig`, against the
JAX package on the same local stub apiserver (`tools/stubs.py`, 127.0.0.1).

Tolerance: exact. The snapshot's objects, the simulation of the snapshot
(placements and reasons) and the apply report must equal the JAX
package's; the error and retry paths raise the same messages. The cases
follow tests/test_kubeclient.py one by one.
"""

import base64
import io

import pytest
import torch
import yaml

import open_simulator_tpu.core.workloads as jwl
import open_simulator_tpu.engine.simulator as jsim
import open_simulator_tpu.utils.kubeclient as jkube
import open_simulator_tpu_torch.core.workloads as twl
import open_simulator_tpu_torch.engine.simulator as tsim
import open_simulator_tpu_torch.utils.kubeclient as tkube
from open_simulator_tpu.api.config import SimonConfig as JConfig
from open_simulator_tpu.engine import apply as japply
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.api.config import SimonConfig as TConfig
from open_simulator_tpu_torch.engine import apply as tapply
from open_simulator_tpu_torch.resilience import faults, policy
from open_simulator_tpu_torch.tools import stubs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_state():
    policy.reset_breakers()
    faults.uninstall_plan()
    yield
    faults.uninstall_plan()


@pytest.fixture()
def stub_api():
    s = stubs.StubApiServer(stubs.KUBE_APIS)
    yield s
    s.close()


def _write_kubeconfig(tmp_path, server, token="sekrit"):
    p = tmp_path / "kubeconfig"
    p.write_text(yaml.safe_dump(stubs.kubeconfig_doc(server, token)))
    return str(p)


def test_load_kubeconfig(tmp_path):
    cfg = tkube.load_kubeconfig(_write_kubeconfig(tmp_path, "https://example:6443"))
    assert cfg.server == "https://example:6443" and cfg.token == "sekrit"


def test_load_kubeconfig_inline_ca(tmp_path):
    doc = stubs.kubeconfig_doc("https://example", "t")
    doc["clusters"][0]["cluster"]["certificate-authority-data"] = base64.b64encode(b"CERT").decode()
    p = tmp_path / "kc"
    p.write_text(yaml.safe_dump(doc))
    cfg = tkube.load_kubeconfig(str(p))
    assert cfg.ca_file and open(cfg.ca_file, "rb").read() == b"CERT"


def test_load_kubeconfig_errors(tmp_path):
    with pytest.raises(tkube.KubeClientError):
        tkube.load_kubeconfig(str(tmp_path / "missing"))
    p = tmp_path / "empty"
    p.write_text("{}")
    with pytest.raises(tkube.KubeClientError):
        tkube.load_kubeconfig(str(p))
    doc = stubs.kubeconfig_doc("https://x", "t")
    doc["users"][0]["user"] = {"exec": {"command": "aws"}}
    p2 = tmp_path / "exec"
    p2.write_text(yaml.safe_dump(doc))
    with pytest.raises(tkube.KubeClientError, match="exec"):
        tkube.load_kubeconfig(str(p2))


def _snapshot_key(cluster):
    return (
        [n.name for n in cluster.nodes],
        [p.meta.name for p in cluster.pods],
        len(cluster.daemonsets),
        {k: [o["metadata"]["name"] for o in v] for k, v in sorted(cluster.others.items())},
    )


def test_snapshot_cluster_matches_jax(stub_api):
    got = tkube.snapshot_cluster(tkube.KubeClient(tkube.KubeConfig(server=stub_api.url, token="tok")))
    want = jkube.snapshot_cluster(jkube.KubeClient(jkube.KubeConfig(server=stub_api.url, token="tok")))
    assert _snapshot_key(got) == _snapshot_key(want)
    assert [p.meta.name for p in got.pods] == ["run-1", "pend-1"]
    assert "Bearer tok" in stub_api.auth_seen


def test_snapshot_via_kubeconfig_simulates_as_jax(stub_api, tmp_path):
    path = _write_kubeconfig(tmp_path, stub_api.url)
    out = {}
    for name, kube, sim, wl, kw in (("jax", jkube, jsim, jwl, {}),
                                    ("torch", tkube, tsim, twl, {"device": "cpu"})):
        wl.reset_name_rng()
        res = sim.simulate(kube.create_cluster_resource_from_kubeconfig(path), [], **kw)
        out[name] = sc.result_digest(res)
    assert out["torch"] == out["jax"]


def test_http_error_surfaces(stub_api):
    client = tkube.KubeClient(tkube.KubeConfig(server=stub_api.url))
    with pytest.raises(tkube.KubeClientError, match="404"):
        client.get("/api/v1/nope")


def test_transient_errors_retry_through_policy(stub_api, monkeypatch):
    """Two injected connection errors on the node list are retried by
    resilience.policy (3 attempts); three exhaust it."""
    monkeypatch.setenv("OSIM_RETRY_BASE_S", "0")
    client = tkube.KubeClient(tkube.KubeConfig(server=stub_api.url))
    rule = {"target": "kubeclient", "op": "/api/v1/nodes", "kind": "connection_error"}
    with faults.injected(faults.FaultPlan.from_dict({"rules": [dict(rule, times=2)]})):
        assert len(client.list("/api/v1/nodes", "Node")) == 2
    with faults.injected(faults.FaultPlan.from_dict({"rules": [dict(rule, times=3)]})):
        with pytest.raises(tkube.KubeClientError, match="after 3 attempt"):
            client.list("/api/v1/nodes", "Node")


def test_master_overrides_kubeconfig_server(tmp_path):
    path = _write_kubeconfig(tmp_path, "https://example:6443")
    client = tkube.KubeClient.from_kubeconfig(path, master="https://override:8443/")
    assert client.cfg.server == "https://override:8443" and client.cfg.token == "sekrit"
    assert tkube.KubeClient.from_kubeconfig(path).cfg.server == "https://example:6443"


def test_master_alone_snapshots(stub_api):
    assert tkube.create_cluster_resource_from_kubeconfig("", master=stub_api.url).nodes
    with pytest.raises(tkube.KubeClientError, match="neither kubeconfig nor master"):
        tkube.create_cluster_resource_from_kubeconfig("")


def test_apply_on_kubeconfig_matches_jax(stub_api, tmp_path):
    """run_apply on a config whose cluster is a kubeConfig: the report and
    placements equal the JAX package's, and the JAX run reproduces
    sim_configs.KUBE_APPLY_DIGEST that chip_smoke.py checks on the card."""
    cfg_path = stubs.write_kube_apply_config(str(tmp_path), stub_api.url)
    runs = {}
    for name, cls, mod, wl, kw in (("jax", JConfig, japply, jwl, {}),
                                   ("torch", TConfig, tapply, twl, {"device": "cpu"})):
        wl.reset_name_rng()
        buf = io.StringIO()
        runs[name] = mod.run_apply(cls.load(cfg_path), auto_plan=False, out=buf, **kw)
    assert runs["torch"].report == runs["jax"].report
    digest = (sc.report_digest(runs["jax"].report), japply.placement_digest(runs["jax"].result),
              len(runs["jax"].result.unscheduled))
    assert digest == sc.KUBE_APPLY_DIGEST
    assert (sc.report_digest(runs["torch"].report), tapply.placement_digest(runs["torch"].result),
            len(runs["torch"].result.unscheduled)) == digest


def test_apply_kubeconfig_error_is_apply_error(tmp_path):
    cfg_path = stubs.write_kube_apply_config(str(tmp_path), "http://127.0.0.1:9")
    with pytest.raises(tapply.ApplyError, match="spec.cluster.kubeConfig"):
        tapply.run_apply(TConfig.load(cfg_path), auto_plan=False, out=io.StringIO(), device="cpu")
