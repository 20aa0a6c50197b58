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


_NONE = np.uint32(0xFFFFFFFF)
_NEG_INF_ORD = np.uint32(0x007FFFFF)


def _ordered(x):
    """The kernel's order-preserving u32 image of f32 totals, after adding
    0.0 so that -0.0 and +0.0 share one image."""
    u = (x + np.float32(0.0)).astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _spread(mx, raw):
    with np.errstate(divide="ignore", invalid="ignore"):
        q = (mx - raw) * np.float32(100.0) / np.maximum(mx, np.float32(1e-9))
    return np.clip(np.where(mx > 0, q, np.float32(100.0)), 0, 100).astype(np.float32)


def emulate_kernel(a):
    """csrc/domain_pop.cu's recurrence in numpy: prologue tables derived
    from t_onehot, raw / cnt / per-row domain counts kept incrementally,
    u32 reductions (the raw max on the integer count, the total max on the
    ordered image, the argmin on key << 6 | class), and the loop cut at the
    first pop that places nothing. numpy's f32 divide is the correctly
    rounded quotient that the kernel's split divide reproduces (held against
    __fdiv_rn on the card by chip_smoke.py)."""
    f32 = np.float32
    t, base = a["t_onehot"], a["base_dom"]
    match, elig = a["match"], a["elig"]
    soft, hard = a["soft"] > 0, a["hard"] > 0
    dc, lanes = a["hscore"].shape
    g, w_sp, big_n = a["group_size"], f32(a["w_sp"]), a["big_n"]
    same = np.einsum("cdm,cdw->cwm", t, t)                       # [C,w,m]
    inc = (match[:, None, None] * same * elig[None, :, None]).astype(f32)
    R = inc[soft].sum(axis=0).astype(np.uint32)                  # [w,m]
    cnt = np.einsum("cd,cdm->cm", base, t).astype(f32)           # [C,Dc]
    raw = cnt[soft].sum(axis=0).astype(np.uint32)
    hard_on = a["any_hard"] and a["fo_spread"]
    rows = np.nonzero(hard)[0] if hard_on else np.zeros(0, int)
    key_d = a["in_key"][rows] > 0                                # [nh,D]
    dom = np.where(key_d, base[rows], 0).astype(np.uint32)
    dom[~key_d] = _NONE
    dom_inc = np.where(
        key_d[:, :, None], match[rows, None, None] * t[rows] * elig[None, None, :], 0
    ).astype(np.uint32)                                          # [nh,D,w]
    hcnt, h_inc = cnt[rows].copy(), inc[rows]
    lim = (a["skew"][rows] + f32(1e-3)).astype(f32)
    never = (a["has_key"][rows] <= 0).any(axis=0)
    valid = a["combo_valid"] > 0
    classes = np.arange(dc, dtype=np.uint32)
    h = np.zeros(dc, np.int64)
    nodes = np.full(g, -1, np.int32)
    jidx = np.zeros(g, np.int32)
    for i in range(min(a["valid_count"], g)):
        mx = f32(np.where(valid, raw, 0).max())
        sp = _spread(mx, raw.astype(f32))
        hc = np.minimum(h, lanes - 1)
        hs = np.where(h < a["cap_eff"], a["hscore"][np.arange(dc), hc], -np.inf).astype(f32)
        total = (hs + w_sp * sp).astype(f32)
        if hard_on:
            mn = dom.min(axis=1)
            min_c = np.where(mn == _NONE, 0, mn).astype(f32)
            ok_c = ((hcnt + f32(1.0)) - min_c[:, None]) <= lim[:, None]
            total = np.where(ok_c.all(axis=0) & ~never, total, -np.inf).astype(f32)
        img = _ordered(total)
        mt = img.max()
        if mt <= _NEG_INF_ORD:
            break
        nd = a["hnode"][np.arange(dc), hc]
        key = np.where(img == mt, nd, big_n).astype(np.uint32)
        w = int((key << np.uint32(6) | classes).min() & 63)
        nodes[i], jidx[i] = nd[w], a["hj"][w, hc[w]]
        h[w] += 1
        raw = raw + R[w]
        dom = dom + dom_inc[:, :, w]
        hcnt = (hcnt + h_inc[:, w, :]).astype(f32)
    return nodes, jidx


def check_all(a):
    """Pallas kernel (interpret mode), the port's CPU path (the plain
    version) and the kernel's emulation: all three bit-equal."""
    want_nodes, want_jidx = run_jax(a)
    before = dp.launches
    nodes, jidx = dp.domain_pop(*port_args(a))
    np.testing.assert_array_equal(nodes.numpy(), want_nodes)
    np.testing.assert_array_equal(jidx.numpy(), want_jidx)
    assert dp.launches == before  # the CPU takes the plain version
    em_nodes, em_jidx = emulate_kernel(a)
    np.testing.assert_array_equal(em_nodes, want_nodes)
    np.testing.assert_array_equal(em_jidx, want_jidx)
    return nodes, jidx


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("dc,lanes,d", [
    (4, 96, 4), (8, 64, 8), (64, 24, 12),
])
def test_domain_pop_matches_pallas_kernel(dc, lanes, d, hard):
    a = make_inputs(seed=dc * 10 + int(hard), dc=dc, lanes=lanes, c=2, d=d, g=160, hard=hard)
    nodes, _ = check_all(a)
    # the inputs exercise what they claim: padding pops past valid_count,
    # feasible pops, and (for the short tables) exhaustion into -1s
    assert (nodes[a["valid_count"]:] == -1).all()
    assert (nodes >= 0).any()


def _edge_inputs(case, hard):
    """Inputs for one branch of the kernel's design. Entry counts are 0 and
    skews 8, so DoNotSchedule rows leave room to place pods."""
    dc, lanes, d, g = {"dc1": (1, 200, 3), "dc33": (33, 24, 6), "lanes1": (4, 1, 4)}.get(
        case, (4, 40, 4)
    ) + (160,)
    a = make_inputs(seed=len(case) * 7 + int(hard), dc=dc, lanes=lanes, c=2, d=d, g=g, hard=hard)
    a["base_dom"][:] = 0.0
    a["skew"][:] = 8.0
    a["combo_valid"][:] = 1.0
    a["has_key"][:] = 1.0
    a["t_onehot"][:, :, :] = (np.arange(d)[:, None] == np.arange(dc)[None, :] % d)
    a["in_key"][:] = 1.0
    a["cap_eff"][:] = lanes
    a["hscore"][:] = np.arange(lanes, 0, -1, dtype=np.float32)
    if case == "cap0":
        a["cap_eff"][:] = 0
    elif case == "valid_short":
        a["valid_count"] = 5
    elif case == "exhausted":
        a["cap_eff"][:] = [3, 0, 5, 2]
    elif case == "neg_zero":
        # w_sp = -0.0 makes each total its head score; -0.0 and +0.0 heads
        # tie and the lowest head node takes the pop
        a["w_sp"] = -0.0
        a["hscore"][:] = np.where(np.arange(lanes) % 3 == 0, -0.0, 0.0).astype(np.float32)
        a["hscore"][1::2] *= -1.0
    return a


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("case", [
    "dc1", "dc33", "lanes1", "cap0", "valid_short", "exhausted", "neg_zero",
])
def test_domain_pop_edge_cases(case, hard):
    a = _edge_inputs(case, hard)
    nodes, jidx = check_all(a)
    nodes = nodes.numpy()
    placed = int((nodes >= 0).sum())
    claims = {
        "dc1": placed > 8,
        "dc33": (nodes[nodes >= 0] % 33 == 32).any(),           # lane 0's second class won
        "lanes1": placed == 4 and (nodes[4:] == -1).all(),      # G > L: one pop per class
        "cap0": placed == 0 and (jidx.numpy() == 0).all(),
        "valid_short": placed == 5 and (nodes[5:] == -1).all(),
        "exhausted": placed == 10 and (nodes[10:] == -1).all(),  # before valid_count
        "neg_zero": placed > 8 and ((a["hscore"][:, 0] == 0) & np.signbit(a["hscore"][:, 0])).any(),
    }
    assert claims[case], (case, placed, nodes[:20])


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
    assert dp.smem_bytes(2, 4, 4) < 4096
    assert dp.smem_bytes(2, 4, 4, hard=False) == 0
    assert dp.smem_bytes(2, 1024, 64) > dp.SMEM_BUDGET
