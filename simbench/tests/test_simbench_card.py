"""On the card only (marked `cuda`; skipped without one): a small cell's
traced run reads kernels, the domain_pop launches and the idle share from
the profiler, and agrees with the reference.

    python3 -m pytest -m cuda simbench/tests -q
"""

import time

import pytest
import torch

from simbench import run
from simbench.tests import small


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
def test_traced_small_zonal_run_on_the_card(card):
    run.environment()
    cell, _, _, layer = run.load_cell("zonal_5k.bulk")
    result, _ = run.run_cell(cell, small.config("zonal_5k", 600), small.traffic("bulk", 0.2),
                             layer, 17, 1.0, True, time.perf_counter(), device=card)
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < m["domain_pop_roofline_pct"] < 100
    assert 0 < m["device_idle_pct"] < 100 and m["kernels_per_pod"] > 0
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] < dev["window_s"]
    assert result["breakdown"]["device_ops"] and result["breakdown"]["idle_gaps"]
