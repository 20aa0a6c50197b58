"""The port's encoder, state constructors, interop and constants against the JAX
package, plus build_trajectory on a pod with every node-local dynamic (GPU
share, open-local storage, host ports). Tolerance: exact."""

import json

import numpy as np
import pytest

from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.ops import encode as jenc
from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu.ops import kernels as jkern
from open_simulator_tpu.ops import state as jstate
from open_simulator_tpu_torch import interop
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.ops import encode as tenc
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.ops import kernels as tkern
from open_simulator_tpu_torch.ops import state as tstate

GIB = 1 << 30


def rich_dicts():
    """Nodes with GPUs, local storage, taints and zones; pods with GPU
    share, storage volumes, host ports, tolerations, selectors and spread."""
    nodes = []
    for i in range(7):
        res = {
            "cpu": str(8 + 8 * (i % 3)), "memory": f"{32 + 16 * (i % 2)}Gi", "pods": "40",
            "alibabacloud.com/gpu-count": "4", "alibabacloud.com/gpu-mem": "64Gi",
        }
        nodes.append({
            "metadata": {
                "name": f"n-{i}",
                "labels": {"topology.kubernetes.io/zone": f"z-{i % 3}", "tier": "a" if i % 2 else "b"},
                "annotations": {"simon/node-local-storage": json.dumps({
                    "vgs": [{"name": "pool", "capacity": str((40 + 10 * i) * GIB), "requested": "0"}],
                    "devices": [
                        {"device": "/dev/sdb", "capacity": str(100 * GIB), "mediaType": "ssd",
                         "isAllocated": "false"},
                        {"device": "/dev/sdc", "capacity": str(200 * GIB), "mediaType": "hdd",
                         "isAllocated": "false"},
                    ],
                })},
            },
            "spec": {"taints": [{"key": "k", "value": "v", "effect": "PreferNoSchedule"}] if i == 3 else []},
            "status": {"allocatable": dict(res), "capacity": dict(res)},
        })
    rich = {
        "metadata": {
            "name": "rich", "namespace": "s", "labels": {"app": "rich"},
            "annotations": {
                "alibabacloud.com/gpu-mem": "6Gi", "alibabacloud.com/gpu-count": "2",
                "simon/pod-local-storage": json.dumps({"volumes": [
                    {"kind": "LVM", "size": str(5 * GIB), "scName": "open-local-lvm"},
                    {"kind": "SSD", "size": str(50 * GIB), "scName": "open-local-device-ssd"},
                ]}),
            },
        },
        "spec": {
            "containers": [{
                "name": "c", "resources": {"requests": {"cpu": "1", "memory": "2Gi"}},
                "ports": [{"containerPort": 80, "hostPort": 8080}],
            }],
            "tolerations": [{"key": "k", "operator": "Exists"}],
            "affinity": {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 3, "preference": {"matchExpressions": [
                    {"key": "tier", "operator": "In", "values": ["a"]}]}}]}},
            "topologySpreadConstraints": [{
                "maxSkew": 2, "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": "rich"}},
            }],
        },
    }
    plain = {
        "metadata": {"name": "plain", "namespace": "s", "labels": {"app": "plain"}},
        "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "250m"}}}],
                 "nodeSelector": {"tier": "b"}},
    }
    return nodes, [rich, plain]


def encode(objs, enc_mod, node_dicts, pod_dicts):
    templates = [objs.Pod.from_dict(d) for d in pod_dicts]
    enc = enc_mod.Encoder()
    enc.register_pods(templates)
    table = enc_mod.encode_nodes(enc, [objs.Node.from_dict(d) for d in node_dicts])
    return enc, table, enc_mod.encode_pods(enc, templates)


@pytest.fixture(scope="module")
def both():
    nodes, pods = rich_dicts()
    jenc_, jtable, jbatch = encode(jobj, jenc, nodes, pods)
    tenc_, ttable, tbatch = encode(tobj, tenc, nodes, pods)
    return (jenc_, jtable, jbatch), (tenc_, ttable, tbatch)


def leaves_equal(want, got, names):
    for f in names:
        a, b = np.asarray(want[f]), np.asarray(got[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_encoded_tables_match(both):
    (_, jtable, jbatch), (_, ttable, tbatch) = both
    for want, got in ((jtable, ttable), (jbatch, tbatch)):
        names = [f for f in want.__dataclass_fields__ if f not in ("names", "keys")]
        leaves_equal(vars(want), vars(got), names)
    assert jtable.names == ttable.names and jbatch.keys == tbatch.keys


def test_state_leaves_match(both):
    (jenc_, jtable, jbatch), (tenc_, ttable, tbatch) = both
    sel = jenc.initial_selector_counts(jenc_, jtable, [])
    jns = jstate.node_static_from_table(jenc_, jtable)
    jcarry = jstate.carry_from_table(jtable, sel)
    jrows = jstate.pod_rows_from_batch(jbatch)
    tns = tstate.node_static_from_table(tenc_, ttable, device="cpu")
    tcarry = tstate.carry_from_table(
        ttable, tenc.initial_selector_counts(tenc_, ttable, []), device="cpu"
    )
    trows = tstate.pod_rows_from_batch(tbatch, device="cpu")
    for want, got in ((jns, tns), (jcarry, tcarry), (jrows, trows)):
        assert want._fields == got._fields
        leaves_equal(want._asdict(), interop.to_host_leaves(got), want._fields)


def test_interop_round_trip(both):
    (jenc_, jtable, jbatch), _ = both
    jns = jstate.node_static_from_table(jenc_, jtable)
    jcarry = jstate.carry_from_table(jtable, jenc.initial_selector_counts(jenc_, jtable, []))
    jrows = jstate.pod_rows_from_batch(jbatch)
    host = [{f: np.asarray(v) for f, v in t._asdict().items()} for t in (jns, jcarry, jrows)]
    port = interop.from_jax_leaves(*host, device="cpu")
    for want, got in zip(host, port):
        leaves_equal(want, interop.to_host_leaves(got), want)
    with pytest.raises(KeyError, match="missing"):
        interop.from_jax_leaves({}, host[1], host[2], device="cpu")


@pytest.mark.parametrize("pruned", [False, True], ids=["all-dynamic", "flags"])
@pytest.mark.parametrize("template", [0, 1], ids=["gpu-storage-ports", "plain"])
def test_build_trajectory_matches(both, template, pruned):
    """Every Trajectory leaf, the static masks/scores and na_ok, for a pod
    whose GPU, storage and port state evolve and for a plain one; with every
    dynamic evaluated per step and with the flag-driven hoisting."""
    (jenc_, jtable, jbatch), _ = both
    jns = jstate.node_static_from_table(jenc_, jtable)
    jcarry = jstate.carry_from_table(jtable, jenc.initial_selector_counts(jenc_, jtable, []))
    jrows = jstate.pod_rows_from_batch(jbatch)
    host = [{f: np.asarray(v) for f, v in t._asdict().items()} for t in (jns, jcarry, jrows)]
    tns, tcarry, trows = interop.from_jax_leaves(*host, device="cpu")
    jrow = jkern.PodRow(*(a[template] for a in jrows))
    trow = tkern.PodRow(*(a[template] for a in trows))
    flags = tfast.ALL_DYNAMIC
    if pruned:
        flags = tfast.group_flags(
            {f: getattr(jbatch, f)[template] for f in (
                "hp_pid", "has_local", "gpu_mem", "spread_topo", "spread_hard",
                "aff_topo", "aff_required", "match_anti")},
            np.asarray(jns.anti_topo),
        )
        assert flags.dyn_gpu == flags.dyn_storage == flags.dyn_ports == (template == 0)
    want = jfast.build_trajectory(jns, jcarry, jrow, jkern.weights_array(), 8)
    got = tfast.build_trajectory(
        tns, tcarry, trow, tkern.weights_array(device="cpu"), 8, None, flags
    )
    for f in want[0]._fields:
        a, b = np.asarray(getattr(want[0], f)), getattr(got[0], f).numpy()
        np.testing.assert_array_equal(a, b, err_msg=f"trajectory {f}")
    for i in (1, 2, 4):
        np.testing.assert_array_equal(np.asarray(want[i]), got[i].numpy())
    for k, v in want[3].items():
        np.testing.assert_array_equal(np.asarray(v), got[3][k].numpy(), err_msg=k)
    if template == 0:
        assert np.asarray(want[0].gpu_take).any() and np.asarray(want[0].vg_take).any()


@pytest.mark.parametrize("name", [
    "F_UNSCHEDULABLE", "F_NODE_NAME", "F_TAINT", "F_NODE_AFFINITY", "F_NODE_PORTS",
    "F_RESOURCES", "F_SPREAD", "F_POD_AFFINITY", "F_STORAGE", "F_GPU", "F_EXTRA",
    "NUM_FILTERS", "FILTER_MESSAGES", "DEFAULT_WEIGHTS", "WEIGHT_ORDER", "_EPS",
    "HOSTNAME_KEY_IDX", "FILTER_PLUGIN_MAP",
])
def test_kernel_constants_tripwire(name):
    assert getattr(tkern, name) == getattr(jkern, name)


@pytest.mark.parametrize("name", [
    "J_CAP", "DM_CAP", "CH_CPU", "CH_MEM", "CH_RES_FAIL", "CH_PORT_OK", "CH_STO_OK",
    "CH_GPU_OK", "CH_STO_RAW", "CH_GPU_RAW", "N_CH", "SP_IDX", "IPA_IDX",
])
def test_fast_constants_tripwire(name):
    assert getattr(tfast, name) == getattr(jfast, name)


def test_weights_array_matches():
    np.testing.assert_array_equal(
        np.asarray(jkern.weights_array()), tkern.weights_array(device="cpu").numpy()
    )


@pytest.mark.parametrize("name", [
    "ANNO_WORKLOAD_KIND", "ANNO_WORKLOAD_NAME", "ANNO_WORKLOAD_NAMESPACE", "ANNO_GPU_INDEX",
    "ANNO_NODE_LOCAL_STORAGE", "ANNO_POD_LOCAL_STORAGE", "LABEL_NEW_NODE", "DEFAULT_SCHEDULER",
])
def test_object_constants_tripwire(name):
    assert getattr(tobj, name) == getattr(jobj, name)


def test_name_rng_tripwire():
    """Generated pod names (and every simulator digest) depend on the name
    RNG drawing the reference's sequence."""
    from open_simulator_tpu.core import workloads as jwl
    from open_simulator_tpu_torch.core import workloads as twl

    assert twl.NAME_RNG_SEED == jwl.reset_name_rng.__defaults__[0] == 0x51B0
    jwl.reset_name_rng()
    twl.reset_name_rng()
    assert [twl._rand_suffix() for _ in range(50)] == [jwl._rand_suffix() for _ in range(50)]
    assert twl.WORKLOAD_KINDS == jwl.WORKLOAD_KINDS


def test_align_carry_matches_jax():
    """align_carry grows the row axes in place, refreshes anti_topo on a
    content change, and keeps identity when nothing changed."""
    nodes, pods = rich_dicts()
    anti = {
        "metadata": {"name": "anti", "namespace": "s", "labels": {"app": "anti"}},
        "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "1"}}}],
                 "affinity": {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                     {"labelSelector": {"matchLabels": {"app": "anti"}},
                      "topologyKey": "topology.kubernetes.io/zone"}]}}},
    }
    out = []
    for objs, enc_mod, st, kw in ((jobj, jenc, jstate, {}), (tobj, tenc, tstate, {"device": "cpu"})):
        enc, table, _ = encode(objs, enc_mod, nodes, pods)
        ns = st.node_static_from_table(enc, table, **kw)
        carry = st.carry_from_table(table, enc_mod.initial_selector_counts(enc, table, []), **kw)
        same = st.align_carry(carry, enc, ns)
        assert same[0] is carry and same[1] is ns
        enc.register_pods([objs.Pod.from_dict(anti)] + [objs.Pod.from_dict(
            {"metadata": {"name": f"p{i}", "namespace": "s", "labels": {f"k{i}": "v"}},
             "spec": {"containers": [{"name": "c"}], "topologySpreadConstraints": [{
                 "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
                 "whenUnsatisfiable": "DoNotSchedule",
                 "labelSelector": {"matchLabels": {f"k{i}": "v"}}}]}}) for i in range(12)])
        out.append(st.align_carry(carry, enc, ns))
    (jc, jns), (tc, tns) = out
    assert tc.sel_counts.shape[0] > 8 and tc.anti_counts.shape[0] >= 2
    leaves_equal(jc._asdict(), interop.to_host_leaves(tc), jc._fields)
    np.testing.assert_array_equal(np.asarray(jns.anti_topo), tns.anti_topo.numpy())
    assert (tns.anti_topo.numpy() >= 0).any()


@pytest.mark.parametrize("mod, names", [
    ("durable.journal", ("JOURNAL_NAME",)),
    ("durable.checkpoint", ("CKPT_DIR", "OUTPUT_NAMES", "DEFAULT_CKPT_EVERY")),
    ("resilience.faults", ("TARGETS", "KINDS")),
    ("engine.resident", ("DEVICE_PLANES", "_DIGEST_FIELDS")),
    ("durable.watchdog", ("DEFAULT_BACKEND_DEADLINE_S",)),
])
def test_durable_constants_tripwire(mod, names):
    """The journal's file name, the snapshot layout, the fault schema and
    the resident digest order: run directories and fault plans move
    between the packages."""
    import importlib

    theirs = importlib.import_module(f"open_simulator_tpu.{mod}")
    ours = importlib.import_module(f"open_simulator_tpu_torch.{mod}")
    for name in names:
        assert getattr(ours, name) == getattr(theirs, name), name


def _journal_events(pkg, files):
    """Every event name a package's modules append to a run journal."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / pkg
    names = set()
    for f in files:
        src = (root / f).read_text()
        names |= set(re.findall(r'(?:journal|self\.journal|j)\.append\(\s*"([a-z_]+)"', src))
    return names


def test_journal_event_names_tripwire():
    """The port journals the reference's event names, but `backend_fallback`
    and the warmup records (the CPU degrade and the warmup phase are not
    ported) and with `backend_error` (where the port's ladder stops)."""
    common = ["durable/watchdog.py", "durable/checkpoint.py", "engine/apply.py",
              "engine/capacity.py", "engine/resident.py"]
    theirs = _journal_events("open_simulator_tpu", common + ["cli/main.py"])
    ours = _journal_events("open_simulator_tpu_torch", common + ["cli.py"])
    assert ours == theirs - {"backend_fallback", "warmup", "warmup_error"} | {"backend_error"}
    assert {"run_start", "run_resume", "run_end", "trial", "sweep", "final", "plan_chunk",
            "plan_done", "watchdog", "backend", "backend_retry", "resident_repair"} <= ours


@pytest.mark.parametrize("name", [
    "CHECKPOINT_BYTES", "RESUME_CHUNKS_SKIPPED", "DEVICE_LOST", "JOURNAL_EVENTS",
    "WATCHDOG_FIRED", "SNAPSHOT_STALE", "RUN_RESUMED", "REQUESTS_SHED", "REQUESTS_DROPPED",
    "RESIDENT_DRIFT_REPAIRS", "RESIDENT_DELTAS", "RESIDENT_FALLBACKS",
    "RESIDENT_VERIFICATIONS", "RESIDENT_EPOCH", "PLAN_CHUNKS", "RETRY_ATTEMPTS",
    "EXTENDER_SKIPPED",
])
def test_durable_metrics_tripwire(name):
    """The metrics chaos and the flight recorder read: the same names,
    kinds and labels as the reference's."""
    from open_simulator_tpu.utils import metrics as jm
    from open_simulator_tpu_torch.utils import metrics as tm

    ours, theirs = getattr(tm, name), getattr(jm, name)
    assert (ours.name, ours.kind, ours.labelnames) == (theirs.name, theirs.kind, theirs.labelnames)
    assert tm.REGISTRY._metrics[ours.name] is ours
