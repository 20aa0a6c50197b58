"""Device rules of the port: entry points default to CUDA and never run on
the CPU unless asked; the kernel wrapper launches or raises, never falls
back; the package imports neither jax nor the JAX package. The `cuda` test
holds the kernel against its plain version and runs only on a card."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import open_simulator_tpu_torch  # noqa: F401  (sets the TF32 switches)
from open_simulator_tpu_torch import headline
from open_simulator_tpu_torch.ops import domain_pop as dp
from open_simulator_tpu_torch.ops import encode, fast, kernels, state

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "build_state", "node_static_from_table", "carry_from_table",
    "pod_rows_from_batch", "weights_array",
])
def test_entry_points_default_to_cuda(no_cuda, entry):
    enc = encode.Encoder()
    table = encode.encode_nodes(enc, [])
    calls = {
        "build_state": lambda: headline.build_state(3, 8),
        "node_static_from_table": lambda: state.node_static_from_table(enc, table),
        "carry_from_table": lambda: state.carry_from_table(table),
        "pod_rows_from_batch": lambda: state.pod_rows_from_batch(encode.encode_pods(enc, [])),
        "weights_array": lambda: kernels.weights_array(),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_schedule_batch_fast_defaults_to_cuda(no_cuda):
    ns, carry, batch = headline.build_state(6, 40, device="cpu")
    w = kernels.weights_array(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fast.schedule_batch_fast(ns, carry, batch, w)
    # and with device="cpu" it runs
    _, nodes, *_ = fast.schedule_batch_fast(ns, carry, batch, w, force_fast=True, device="cpu")
    assert (nodes[:40] >= 0).all()


def test_tf32_is_off():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _meta_args():
    dc, lanes, c, d = 4, 8, 2, 4
    f32, i32 = torch.float32, torch.int32
    shapes = [
        ((dc, lanes), f32), ((dc, lanes), i32), ((dc, lanes), i32), ((dc,), i32),
        ((dc,), f32), ((dc,), f32), ((c, d), f32), ((c, d), f32), ((c, d, dc), f32),
        ((c,), f32), ((c,), f32), ((c,), f32), ((c,), f32), ((c, dc), f32),
    ]
    return [torch.empty(s, dtype=t, device="meta") for s, t in shapes] + [
        2.0, True, 8, 8, False, 100,
    ]


def _no_plain(*_args, **_kw):
    raise AssertionError("the plain version ran for a non-CPU tensor")


def test_kernel_wrapper_raises_without_library(monkeypatch, tmp_path):
    monkeypatch.setattr(dp, "_lib", None)
    monkeypatch.setattr(dp, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(dp, "domain_pop_reference", _no_plain)
    before = dp.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dp.domain_pop(*_meta_args())
    assert dp.launches == before


def test_kernel_wrapper_rejects_non_cuda_tensors(monkeypatch):
    monkeypatch.setattr(dp, "_library", lambda: object())
    monkeypatch.setattr(dp, "domain_pop_reference", _no_plain)
    with pytest.raises(ValueError, match="needs CUDA"):
        dp.domain_pop(*_meta_args())


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|open_simulator_tpu)\b", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list((ROOT / "open_simulator_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
))
def test_port_imports_neither_jax_nor_reference(path):
    assert not _FORBIDDEN.search((ROOT / path).read_text()), path


def test_port_import_loads_no_jax():
    code = (
        "import sys, open_simulator_tpu_torch.headline, open_simulator_tpu_torch.interop, "
        "open_simulator_tpu_torch.ops.fast\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'open_simulator_tpu' or m.startswith('open_simulator_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# name: (seed, Dc, L, D, G, cap); each runs soft and hard
_CARD_VARIANTS = {
    "base": (5, 8, 512, 4, 512, None),
    "dc33": (33, 33, 512, 4, 1024, None),
    "dc64": (12, 64, 256, 4, 1024, None),
    "dc1": (1, 1, 1024, 4, 1024, None),
    "lanes1": (5, 8, 1, 4, 200, None),
    "g-odd": (9, 4, 701, 4, 701, None),
    "all-exhausted": (21, 8, 512, 4, 1500, 100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("variant", list(_CARD_VARIANTS))
def test_kernel_matches_plain_on_card(card, variant, hard):
    """The CUDA kernel and its plain version, bit-equal on the card."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    seed, dc, lanes, d, g, cap = _CARD_VARIANTS[variant]
    arrays, scalars = chip_smoke.pop_inputs(seed, dc, lanes, 2, d, g, hard, cap=cap)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in arrays] + scalars
    before = dp.launches
    nodes, jidx = dp.domain_pop(*args)
    assert dp.launches == before + 1
    ref_nodes, ref_jidx = dp.domain_pop_reference(*args)
    assert torch.equal(nodes, ref_nodes) and torch.equal(jidx, ref_jidx)
    if variant == "all-exhausted":
        assert (nodes[: scalars[2]] == -1).any()  # every class ran out before valid_count


@pytest.mark.cuda
def test_split_divide_matches_fdiv_rn_on_card(card):
    """The kernel's split divide gives __fdiv_rn's bits on the spread's
    operands (a smaller sweep than chip_smoke.py's)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    n, d = chip_smoke.divide_domain(torch, exhaustive=2048, n_random=1 << 20, seed=1)
    assert dp.check_divide(n, d) == 0


def test_chain_probe_rejects_bad_pop_counts():
    from open_simulator_tpu_torch.tools import pop_chain

    for g in (0, pop_chain.MAX_POPS + 1):
        with pytest.raises(ValueError, match="pops"):
            pop_chain.run(g)


def test_kernel_wrapper_checks_exactness_limits(monkeypatch):
    monkeypatch.setattr(dp, "_library", lambda: object())
    args = _meta_args()
    args[-3] = dp.EXACT  # group_size: C * G counts past 2^24
    with pytest.raises(ValueError, match="2\\^24"):
        dp.domain_pop(*args)
