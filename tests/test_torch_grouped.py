"""The port's grouped route (ops/grouped.py) against the JAX package's, on the CPU.

`schedule_group` on one pod spec (more steps than pods, so the frozen tail
rows count too), and `schedule_batch_grouped` over mixed batches: chunks
smaller than a group, a filter disabled through `filter_on`, and a pair of
out-of-tree plugins (a filter and a weighted score) written once for each
package. Exact equality of nodes, reason rows, takes and every carry leaf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_simulator_tpu.ops import grouped as jgrouped
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.ops.state import pod_rows_from_batch as jax_rows
from open_simulator_tpu_torch.ops import grouped as tgrouped
from open_simulator_tpu_torch.ops import kernels as tk
from open_simulator_tpu_torch.ops.state import pod_rows_from_batch as torch_rows
from tests.test_torch_fast import (
    HOST,
    ZONE,
    encode_both,
    host_port,
    node_dict,
    pod_affinity,
    pod_dict,
    spread,
)


def _eq(want, got, what):
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}[{i}]")


def _batch():
    nodes = [
        node_dict(f"n-{i}", cpu="4", pods="4",
                  labels={ZONE: f"z-{i % 3}", "tier": "gold" if i % 2 else "silver"})
        for i in range(7)
    ]
    pods = [
        pod_dict(labels={"app": "w"}, spec_extra={"topologySpreadConstraints": [
            spread(ZONE, 1, True, "w"), spread(HOST, 2, False, "w")]}),
        pod_dict(cpu="250m", labels={"app": "s"}, name="s", spec_extra={
            **host_port("250m"), **pod_affinity("podAntiAffinity", "w", required=False)}),
        pod_dict(cpu="1", labels={"app": "p"}, name="p", spec_extra={
            "nodeSelector": {"tier": "gold"}, **pod_affinity("podAffinity", "p")}),
    ]
    return encode_both(nodes, pods, [30, 12, 20])


@pytest.mark.parametrize("group_size,valid_count", [(32, 30), (8, 8)])
def test_schedule_group_matches_jax(group_size, valid_count):
    """One group's scan: group_size steps of which valid_count commit."""
    (jns, jc, jb), (tns, tc, tb) = _batch()
    jrow = jk.PodRow(*(a[0] for a in jax_rows(jb)))
    trow = tk.PodRow(*(a[0] for a in torch_rows(tb, "cpu")))
    jcar, want = jgrouped._group_call(jns, jc, jrow, group_size, jnp.int32(valid_count), jk.weights_array())
    tcar, got = tgrouped.schedule_group(
        tns, tc, trow, group_size, valid_count, tk.weights_array(device="cpu")
    )
    _eq(want, got, "outputs")
    _eq(tuple(jcar), tuple(tcar), "carry")
    nodes = np.asarray(want[0])
    assert (nodes >= 0).any() and (nodes[valid_count:] == -1).all()
    assert (np.asarray(want[1])[nodes < 0] > 0).any() or (nodes >= 0).all()


def _grouped_both(jax_state, port_state, **kw):
    want = jgrouped.schedule_batch_grouped(*jax_state, jk.weights_array(), **kw.get("jax", {}))
    got = tgrouped.schedule_batch_grouped(
        *port_state, tk.weights_array(device="cpu"), device="cpu", **kw.get("port", {})
    )
    _eq(want[1:], got[1:], "outputs")
    _eq(tuple(want[0]), tuple(got[0]), "carry")
    return got


@pytest.mark.parametrize("chunk", [7, 16384])
def test_schedule_batch_grouped_chunks(chunk):
    """Groups longer than max_group_chunk run in chunks threading the carry."""
    got = _grouped_both(*_batch(), jax={"max_group_chunk": chunk}, port={"max_group_chunk": chunk})
    assert (got[1] >= 0).any() and (got[2] > 0).any()


@pytest.mark.parametrize("off", [tk.F_SPREAD, tk.F_NODE_PORTS])
def test_schedule_batch_grouped_filter_off(off):
    fo = np.ones(tk.NUM_FILTERS, bool)
    fo[off] = False
    _grouped_both(*_batch(), jax={"filter_on": jnp.asarray(fo)}, port={"filter_on": fo})


def test_schedule_batch_grouped_plugins():
    """A filter plugin rejecting every third node and a weighted score plugin
    preferring memory headroom, written once per package."""
    def j_filter(ns, c, p):
        return jnp.arange(ns.valid.shape[0]) % 3 != 2

    def t_filter(ns, c, p):
        return torch.arange(ns.valid.shape[0]) % 3 != 2

    def score(ns, c, p):
        return c.free[:, 1] * 0.25

    got = _grouped_both(
        *_batch(),
        jax={"extra_filters": (j_filter,), "extra_scores": ((score, 1.5),)},
        port={"extra_filters": (t_filter,), "extra_scores": ((score, 1.5),)},
    )
    assert (got[2][:, tk.F_EXTRA] > 0).any()


def test_fetch_round_trip():
    """The one-transfer fetch returns every dtype and shape unchanged."""
    a = torch.tensor([[1.5, -0.0], [float("inf"), 2.0]])
    b = torch.tensor([3, -1], dtype=torch.int32)
    c = torch.tensor(True)
    got = tgrouped.fetch(a, b, c)
    np.testing.assert_array_equal(got[0], a.numpy())
    assert np.signbit(got[0][0, 1]) and got[1].dtype == np.int32 and got[2].dtype == bool
    np.testing.assert_array_equal(got[1], b.numpy())
    assert got[2].shape == () and bool(got[2])
    with pytest.raises(ValueError, match="32-bit"):
        tgrouped.fetch(torch.zeros(2, dtype=torch.int64))


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
