"""The port's domain-merge pop loop against the JAX package's Pallas kernel.

The same seeded numpy inputs go through
open_simulator_tpu.ops.fast._domain_pop_pallas (interpret mode on the CPU)
and open_simulator_tpu_torch.ops.domain_pop.domain_pop on CPU tensors, which
runs the kernel's plain version. Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu_torch.ops import domain_pop as dp


def make_inputs(seed, dc, lanes, c, d, g, hard):
    """Pop-loop inputs shaped like a domain plan: per-class lane tables
    sorted by score (quantized, so totals tie across classes), each class
    drawing its nodes from its own residue class, some classes exhausted
    early or empty, rows mapped to domains (or missing the key)."""
    rng = np.random.default_rng(seed)
    n = 4096
    hscore = -np.sort(-(rng.integers(0, 12, (dc, lanes)) * 0.5)).astype(np.float32)
    cut = rng.integers(0, lanes + 1, dc)
    for m in range(dc):
        if rng.random() < 0.3:
            hscore[m, cut[m]:] = -np.inf
    hnode = (rng.integers(0, n // dc, (dc, lanes)) * dc + np.arange(dc)[:, None]).astype(np.int32)
    hj = rng.integers(0, 16, (dc, lanes)).astype(np.int32)
    cap_eff = rng.integers(0, lanes + 1, dc).astype(np.int32)
    cap_eff[rng.random(dc) < 0.2] = 0
    elig = (rng.random(dc) < 0.8).astype(np.float32)
    combo_valid = (rng.random(dc) < 0.9).astype(np.float32)
    dom_of = rng.integers(-1, d, (c, dc))          # -1: class lacks the key
    t_onehot = (dom_of[:, None, :] == np.arange(d)[None, :, None]).astype(np.float32)
    has_key = (dom_of >= 0).astype(np.float32)
    base_dom = rng.integers(0, 30, (c, d)).astype(np.float32)
    in_key = (rng.random((c, d)) < 0.8).astype(np.float32)
    match = np.ones(c, np.float32)
    match[1:] = rng.integers(0, 2, c - 1)
    hard_c = np.zeros(c, np.float32)
    if hard:
        hard_c[0] = 1.0
    soft_c = 1.0 - hard_c
    skew = rng.integers(1, 4, c).astype(np.float32)
    return dict(
        hscore=hscore, hnode=hnode, hj=hj, cap_eff=cap_eff, elig=elig,
        combo_valid=combo_valid, base_dom=base_dom, in_key=in_key,
        t_onehot=t_onehot, match=match, soft=soft_c, hard=hard_c, skew=skew,
        has_key=has_key, w_sp=2.0, fo_spread=True, valid_count=g - 7,
        group_size=g, any_hard=hard, big_n=n,
    )


def run_jax(a):
    st = jfast.SpreadTables(
        k_c=None, to_c=None, elig_f=None,
        match_c=jnp.asarray(a["match"]), base_dom=jnp.asarray(a["base_dom"]),
        active_c=jnp.asarray(a["soft"] > 0), hard_c=jnp.asarray(a["hard"] > 0),
        in_key_cd=jnp.asarray(a["in_key"] > 0) if a["any_hard"] else None,
    )
    nodes, jidx = jfast._domain_pop_pallas(
        jnp.asarray(a["hscore"]), jnp.asarray(a["hnode"]), jnp.asarray(a["hj"]),
        jnp.asarray(a["cap_eff"]), jnp.asarray(a["elig"]),
        jnp.asarray(a["combo_valid"] > 0), st, jnp.asarray(a["t_onehot"]),
        jnp.asarray(a["has_key"] > 0), jnp.asarray(a["skew"]),
        jnp.float32(a["w_sp"]), jnp.bool_(a["fo_spread"]),
        jnp.int32(a["valid_count"]), a["group_size"], a["any_hard"], a["big_n"],
    )
    return np.asarray(nodes), np.asarray(jidx)


def port_args(a):
    tensors = [
        torch.from_numpy(np.ascontiguousarray(a[k])) for k in (
            "hscore", "hnode", "hj", "cap_eff", "elig", "combo_valid",
            "base_dom", "in_key", "t_onehot", "match", "soft", "hard", "skew",
            "has_key",
        )
    ]
    return tensors + [
        a["w_sp"], a["fo_spread"], a["valid_count"], a["group_size"],
        a["any_hard"], a["big_n"],
    ]


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("dc,lanes,d", [(4, 96, 4), (8, 64, 8), (64, 24, 12)])
def test_domain_pop_matches_pallas_kernel(dc, lanes, d, hard):
    a = make_inputs(seed=dc * 10 + int(hard), dc=dc, lanes=lanes, c=2, d=d, g=160, hard=hard)
    want_nodes, want_jidx = run_jax(a)
    before = dp.launches
    nodes, jidx = dp.domain_pop(*port_args(a))
    np.testing.assert_array_equal(nodes.numpy(), want_nodes)
    np.testing.assert_array_equal(jidx.numpy(), want_jidx)
    assert dp.launches == before  # the CPU takes the plain version
    # the inputs exercise what they claim: padding pops past valid_count,
    # feasible pops, and (for the short tables) exhaustion into -1s
    assert (nodes[a["valid_count"]:] == -1).all()
    assert (nodes >= 0).any()


def test_domain_pop_reference_is_the_cpu_path():
    a = make_inputs(seed=3, dc=4, lanes=32, c=2, d=4, g=64, hard=True)
    args = port_args(a)
    got = dp.domain_pop(*args)
    ref = dp.domain_pop_reference(*args)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_smem_budget_formula():
    # headline tables (C=2, D=4, Dc=4) are tiny; the budget check trips
    # only on very wide tables
    assert dp.smem_bytes(2, 4, 4) < 1024
    assert dp.smem_bytes(2, 1024, 64) > dp.SMEM_BUDGET
