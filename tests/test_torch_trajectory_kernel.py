"""The trajectory CUDA kernel (csrc/trajectory.cu) on the card: bit-equal to
build_trajectory's J-step loop, tensor by tensor and end to end.

Every test needs a card (`-m cuda`) and skips without one; the CPU side of
the kernel (its routing rule, its wrapper's refusals, a NumPy model of its
chain) is in tests/test_torch_trajectory_route.py.
"""

import numpy as np
import pytest
import torch

from open_simulator_tpu_torch import headline
from open_simulator_tpu_torch.ops import encode, fast, kernel_lib, state
from open_simulator_tpu_torch.ops.kernels import weights_array
from open_simulator_tpu_torch.ops.tile import tile_pod_batch
from open_simulator_tpu_torch.tools import scan_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", scan_cases.TRAJ_CASES)
def test_kernel_matches_plain_loop_on_card(card, name):
    """Kernel and loop on the card: every Trajectory tensor and the static
    parts bit-equal (as int32 views, so -0.0 and NaN patterns count), in
    one launch."""
    r = scan_cases.compare_trajectory(name, card)
    assert r["differ"] == [] and r["launches"] == 1, r


def _pai_state(card):
    """pai-shaped: the `pai` case's 1,800 nodes (500 of 8 GPUs, 1,300 of 2)
    and three GPU-share templates of 4, 8 and 16 GiB, 200 replicas each."""
    case = scan_cases.CASES["pai"]
    rng = np.random.default_rng(case.seed)
    nodes = [scan_cases.Node.from_dict(scan_cases._node(i, rng, case))
             for i in range(case.nodes)]
    pods = [scan_cases.Pod.from_dict(scan_cases._pod(case._replace(gpu_mem=m), f"p{k}"))
            for k, m in enumerate(("4Gi", "8Gi", "16Gi"))]
    enc = encode.Encoder()
    enc.register_pods(pods)
    table = encode.encode_nodes(enc, nodes)
    ns = state.node_static_from_table(enc, table, card)
    carry = state.carry_from_table(table, encode.initial_selector_counts(enc, table, []),
                                   device=card)
    return ns, carry, tile_pod_batch(encode.encode_pods(enc, pods), [200, 200, 200])


@pytest.mark.parametrize("shape", ["pai", "zonal"])
def test_schedule_batch_fast_kernel_equals_loop_on_card(card, shape):
    """One schedule_batch_fast with the kernel equals the same run with the
    routing rule patched to the loop: placements, reasons, takes and the
    exit carry, bit for bit; one launch per trajectory on the kernel side,
    none on the loop's."""
    ns, carry, batch = (_pai_state(card) if shape == "pai"
                        else headline.build_state(1000, 20000, device=card))
    w = weights_array(device=card)
    before = kernel_lib.launches("trajectory"), fast.PATH_COUNTS["traj_kernel"]
    got = fast.schedule_batch_fast(ns, carry, batch, w, device=card)
    launched = kernel_lib.launches("trajectory") - before[0]
    assert launched >= 1 and fast.PATH_COUNTS["traj_kernel"] - before[1] == launched
    with scan_cases.loop_route():
        want = fast.schedule_batch_fast(ns, carry, batch, w, device=card)
    assert kernel_lib.launches("trajectory") - before[0] == launched
    for g, wt in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        g, wt = torch.as_tensor(g), torch.as_tensor(wt)
        assert torch.equal(scan_cases._bits(g).cpu(), scan_cases._bits(wt).cpu())
