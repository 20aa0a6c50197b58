"""Randomized parity fuzz between the packages (bounded, fixed seeds).

The JAX package's fuzz generator (tests/test_fuzz_parity.py: spread soft and
hard over zones and racks, required and preferred pod (anti-)affinity, node
selectors, taints, tolerations, host ports, heterogeneous nodes), the same
seeds and rounds: each batch goes through both packages' schedule_batch_fast
(exact equality of every output, carry leaf and route count) and through
the port's own sequential oracle, which the port's fast path must equal.
"""

import random

import numpy as np
import pytest

from open_simulator_tpu.ops.state import pod_rows_from_batch as jax_rows
from open_simulator_tpu_torch import interop
from open_simulator_tpu_torch.ops import kernels as tk
from open_simulator_tpu_torch.ops.state import pod_rows_from_batch as torch_rows
from tests.test_fast import _encode
from tests.test_fuzz_parity import _rand_nodes, _rand_tmpl
from tests.test_torch_fast import assert_same_schedule


def _port_state(ns, carry, batch):
    """The port's state from the JAX package's encoded one (numpy leaves)."""
    host = [{f: np.asarray(v) for f, v in t._asdict().items()} for t in (ns, carry, jax_rows(batch))]
    tns, tcarry, _ = interop.from_jax_leaves(*host, device="cpu")
    return tns, tcarry, batch


@pytest.mark.parametrize("seed", [3, 17, 29])
def test_fuzz_parity_with_jax_and_oracle(seed):
    rng = random.Random(seed)
    for _ in range(3):
        nodes = _rand_nodes(rng, rng.choice([5, 9, 16]))
        tmpls = [_rand_tmpl(rng, t) for t in range(rng.randrange(1, 3))]
        counts = [rng.choice([3, 17, 40]) for _ in tmpls]
        jax_state = _encode(nodes, tmpls, counts)
        port_state = _port_state(*jax_state)
        _, got = assert_same_schedule(jax_state, port_state)
        tns, tcarry, batch = port_state
        oracle = tk.schedule_batch(
            tns, tcarry, torch_rows(batch, "cpu"), tk.weights_array(device="cpu")
        )
        total = int(batch.valid.sum())
        for a, b in zip(oracle[1:], got[1:]):
            np.testing.assert_array_equal(a.numpy()[:total], b[:total])
        for f in tcarry._fields:
            np.testing.assert_array_equal(
                getattr(oracle[0], f).numpy(), getattr(got[0], f).numpy(), err_msg=f
            )


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
