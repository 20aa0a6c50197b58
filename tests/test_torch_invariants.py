"""The port's invariant prover (open_simulator_tpu_torch/analysis/
invariants.py) on the CPU: the counterpart of tests/test_audit_invariants.py.

The abstract domain and its transfer rules are the reference's, held equal
to `open_simulator_tpu.analysis.invariants` (whose module top imports only
numpy) over a seeded grid of intervals with ±inf and NaN flags. The
reference's fixtures are restated in torch (the bad sentinel select, the
bad and the guarded normalize, the guarded and unguarded commit scans, the
dropped replay carry) and must be classified as there. The registry run
interprets every REQUIRED_COVERAGE entry and the 10 score plugins on the
canonical state once (module fixture), with the reference test's
assertions. Tolerance: exact (the rules are plain float arithmetic).
"""

import dataclasses
import itertools
import json
import math
import os
import random
import re

import numpy as np
import pytest
import torch

from open_simulator_tpu.analysis import invariants as ref
from open_simulator_tpu_torch.analysis import invariants as inv
from open_simulator_tpu_torch.ops import scanmark

torch.set_num_threads(1)  # tiny tensors: threads only add contention

F = "f"
INF = float("inf")


def _av(lo, hi, **kw):
    return inv.AVal(float(lo), float(hi), kind=kw.pop("kind", F), **kw)


def _grid(seed: int, n: int):
    """Seeded AVals: finite and unbounded bounds, every flag."""
    rng = random.Random(seed)
    bounds = [-INF, -7.5, -1.0, 0.0, 0.5, 1.0, 3.0, 100.0, INF]
    out = []
    for _ in range(n):
        lo, hi = sorted(rng.sample(bounds, 2))
        out.append((lo, hi, rng.random() < 0.3, rng.random() < 0.3, rng.random() < 0.2,
                    rng.random() < 0.3 and not (lo <= 0 <= hi), rng.choice("ffib")))
    return out


def _pair(t):
    return inv.AVal(*t), ref.AVal(*t)


def _same(a, b):
    ta, tb = dataclasses.astuple(a), dataclasses.astuple(b)
    return all((x == y) or (isinstance(x, float) and math.isnan(x) and math.isnan(y))
               for x, y in zip(ta, tb))


BINARY = ("_r_add", "_r_sub", "_r_mul", "_r_div", "_r_rem", "_r_max", "_r_min")
UNARY = ("_r_neg", "_r_abs", "_r_sign", "_r_floor")


@pytest.mark.parametrize("rule", BINARY)
def test_binary_rules_equal_the_reference(rule):
    grid = _grid(hash(rule) % 1000, 40)
    for x, y in itertools.product(grid, grid[:20]):
        (px, rx), (py, ry) = _pair(x), _pair(y)
        assert _same(getattr(inv, rule)(px, py), getattr(ref, rule)(rx, ry)), (rule, x, y)


@pytest.mark.parametrize("rule", UNARY)
def test_unary_rules_equal_the_reference(rule):
    for x in _grid(7, 200):
        px, rx = _pair(x)
        assert _same(getattr(inv, rule)(px), getattr(ref, rule)(rx)), (rule, x)


@pytest.mark.parametrize("name", ["join", "widen"])
def test_join_and_widen_equal_the_reference(name):
    grid = _grid(11, 60)
    for x, y in itertools.product(grid, grid):
        (px, rx), (py, ry) = _pair(x), _pair(y)
        assert _same(getattr(inv, name)(px, py), getattr(ref, name)(rx, ry)), (name, x, y)


def test_sum_convert_and_predicates_equal_the_reference():
    for x in _grid(13, 120):
        px, rx = _pair(x)
        for n in (0, 1, 5, 64):
            assert _same(inv._sum_of(px, n), ref._sum_of(rx, n))
        for k in "fib":
            assert _same(inv._convert(px, k), ref._convert(rx, k))
        for p in ("may_pos", "may_neg", "may_zero", "inf_any"):
            assert getattr(inv, p)(px) == getattr(ref, p)(rx)
        assert _same(inv.top(px.kind), ref.top(rx.kind))
    assert _same(inv.const(7), ref.const(7))
    assert inv.SELECTION_PRIMITIVES == ref.SELECTION_PRIMITIVES
    for v in ("PROVED", "GUARDED", "NON_DECREASING", "UNCHANGED", "UNRECOGNIZED", "VIRTUAL",
              "UNGUARDED"):
        assert getattr(inv, f"CARRY_{v}") == getattr(ref, f"CARRY_{v}")


@pytest.mark.parametrize("values", [
    [1.0, -INF, 3.0], [0.0, 2.0, float("nan")], [INF, INF], [-5.0, 0.0, 5.0], [],
])
def test_from_concrete_torch_equals_the_reference_numpy(values):
    arr = np.array(values, dtype=np.float32)
    assert _same(inv.from_concrete(torch.from_numpy(arr)), ref.from_concrete(arr))
    ints = np.array([3, -2, 0], dtype=np.int32)
    assert _same(inv.from_concrete(torch.from_numpy(ints)), ref.from_concrete(ints))
    bools = np.array([True, False])
    assert _same(inv.from_concrete(torch.from_numpy(bools)), ref.from_concrete(bools))


def test_where_guard_refines_divisor_nonzero():
    """`where(d == 0, 1, d)` proves the division NaN-free."""
    def guarded(x):
        d = torch.where(x == 0.0, 1.0, x)
        return 100.0 / d

    rep = inv.check_traceable("fixture:guarded-div", guarded,
                              (torch.tensor([0.0, 2.0]),))
    assert rep.ok, [f.to_dict() for f in rep.findings]


# ---------------------------------------------------------------------------
# known-violation fixtures, restated in torch: the prover MUST flag these
# ---------------------------------------------------------------------------

def bad_sentinel_select(score, valid):
    """The -inf * 0.0 poisoning pattern: invalid lanes hold -inf, the
    one-hot zeroes them by multiplication, 0 * -inf is NaN, and it feeds
    argmax."""
    masked = torch.where(valid, score, -INF)
    onehot = (masked == masked.amax()).to(torch.float32)
    contrib = masked * onehot
    return contrib.argmax(), contrib.sum()


def bad_normalize(score):
    """Min-max normalization without the range guard or the clip."""
    lo, hi = score.amin(), score.amax()
    return (score - lo) * 100.0 / (hi - lo)


def good_guarded_normalize(score):
    """The production shape: guarded divisor + clip."""
    lo, hi = score.amin(), score.amax()
    rng = hi - lo
    out = torch.where(rng > 0, (score - lo) * 100.0 / torch.maximum(rng, torch.tensor(1e-9)),
                      0.0)
    return out.clamp(0.0, 100.0)


ARGS_SENTINEL = (torch.tensor([5.0, 1.0, 3.0]), torch.tensor([True, False, True]))


def test_bad_sentinel_select_is_flagged():
    rep = inv.check_traceable("fixture:bad_sentinel_select", bad_sentinel_select, ARGS_SENTINEL)
    kinds = sorted({f.kind for f in rep.findings})
    assert kinds == ["nan-output", "selection-taint"], [f.to_dict() for f in rep.findings]
    taint = next(f for f in rep.findings if f.kind == "selection-taint")
    assert taint.primitive in ("argmax", "argmin")


def test_bad_normalize_escapes_score_range():
    rep = inv.check_score_plugin("fixture:bad_normalize", bad_normalize,
                                 (torch.tensor([1.0, 2.0, 3.0]),))
    assert not rep.ok
    msg = next(f for f in rep.findings if f.kind == "score-range").message
    assert "NaN" in msg or "escapes" in msg


def test_good_guarded_normalize_proves_clean():
    rep = inv.check_score_plugin("fixture:good_guarded_normalize", good_guarded_normalize,
                                 (torch.tensor([1.0, 2.0, 3.0]),))
    assert rep.ok, [f.to_dict() for f in rep.findings]
    assert rep.lo >= 0.0 and rep.hi <= 100.0


def test_fixture_findings_are_deterministic_json():
    def once():
        rep = inv.check_traceable("fixture:bad_sentinel_select", bad_sentinel_select,
                                  ARGS_SENTINEL)
        return json.dumps(rep.to_dict(), sort_keys=True)

    assert once() == once()


def _scan(step, keep_carry=True):
    """A scan over 5 pods on a [4,2] free plane through the scan marker."""
    def run(free, reqs):
        rows = []
        for i in range(reqs.shape[0]):
            free, row = scanmark.step("fixture:step", 0, step, free, reqs[i])
            rows.append(row)
        out = torch.stack(rows)
        return (free, out) if keep_carry else out

    return run, (torch.full((4, 2), 8.0), torch.ones((5, 2)))


def test_commit_carry_guarded_decrement_proved():
    def step(free, req):
        fits = (req[None, :] <= free + 1e-6).all(dim=1)
        score = torch.where(fits, -free.sum(dim=1), -INF)
        choice = score.argmax()
        onehot = (torch.arange(free.shape[0]) == choice) & fits.any()
        return free - onehot[:, None].to(free.dtype) * req[None, :], choice

    fn, args = _scan(step)
    rep = inv.check_traceable("fixture:guarded_commit", fn, args)
    assert rep.ok, [f.to_dict() for f in rep.findings]
    assert inv.CARRY_PROVED in {p.verdict for p in rep.commit_carry}


def test_commit_carry_where_spelling_proved():
    """The port's own spellings: where(guard, amount, 0) as the decrement."""
    def step(free, req):
        fits = (req[None, :] <= free + 1e-6).all(dim=1)
        choice = torch.where(fits, -free.sum(dim=1), -INF).argmax()
        onehot = (torch.arange(free.shape[0]) == choice) & fits.any()
        return free - torch.where(onehot[:, None], req[None, :], 0.0), choice

    fn, args = _scan(step)
    rep = inv.check_traceable("fixture:where_commit", fn, args)
    assert rep.ok and inv.CARRY_PROVED in {p.verdict for p in rep.commit_carry}


def test_commit_carry_row_write_proved():
    """An index_put of the chosen row, decremented under the bool guard."""
    def step(free, req):
        fits = (req[None, :] <= free + 1e-6).all(dim=1)
        choice = torch.where(fits, -free.sum(dim=1), -INF).argmax()
        at = choice.view(1)      # a gather index: no host read
        row = free.index_select(0, at) - req[None, :] * fits.any().to(free.dtype)
        return free.index_put((at,), row), choice

    fn, args = _scan(step)
    rep = inv.check_traceable("fixture:row_commit", fn, args)
    assert rep.ok and inv.CARRY_PROVED in {p.verdict for p in rep.commit_carry}, [
        p.to_dict() for p in rep.commit_carry]


def test_commit_carry_unguarded_decrement_is_a_finding():
    def step(free, req):
        # the commit with its feasibility guard deleted
        return free - req[None, :], free.sum()

    fn, args = _scan(step)
    rep = inv.check_traceable("fixture:unguarded_commit", fn, args)
    assert not rep.ok
    assert any(f.kind == "commit-carry-nonneg" for f in rep.findings)
    assert any(p.verdict == inv.CARRY_UNGUARDED for p in rep.commit_carry)


def test_commit_carry_dropped_carry_is_virtual_not_flagged():
    def step(free, req):
        return free - req[None, :], free   # record-then-decrement replay

    fn, args = _scan(step, keep_carry=False)
    rep = inv.check_traceable("fixture:virtual_replay", fn, args)
    assert rep.ok, [f.to_dict() for f in rep.findings]
    assert any(p.verdict == inv.CARRY_VIRTUAL for p in rep.commit_carry)


def test_scan_body_with_a_host_read_is_reported():
    def step(free, req):
        k = int(req.sum())    # a host read inside the body
        return free - req[None, :] * 0.0, free[:k]

    fn, args = _scan(step)
    rep = inv.check_traceable("fixture:sync_body", fn, args)
    assert any(f.kind == "scan-body-sync" for f in rep.findings)


def test_in_place_write_through_a_view_reaches_the_base():
    def write(x):
        x[:, 0] = float("nan")
        return x * 1.0

    rep = inv.check_traceable("fixture:view_write", write, (torch.zeros((3, 2)),))
    assert any(f.kind == "nan-output" for f in rep.findings)


def test_the_new_modules_import_neither_jax_nor_the_reference():
    root = os.path.join(os.path.dirname(__file__), "..", "open_simulator_tpu_torch")
    for rel in ("analysis/invariants.py", "analysis/preflight.py", "analysis/budget.py",
                "ops/scanmark.py"):
        src = open(os.path.join(root, rel)).read()
        assert not re.search(r"^\s*(import|from)\s+(jax|open_simulator_tpu)\b", src, re.M), rel


# ---------------------------------------------------------------------------
# the registry: every REQUIRED_COVERAGE entry and score plugin proves clean
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def audit():
    return inv.run_invariants("cpu")


def test_all_registered_entries_prove_clean(audit):
    from open_simulator_tpu_torch.analysis.entry_audit import REQUIRED_COVERAGE

    assert audit.ok, audit.render_text()
    assert {e.entry for e in audit.entries} == set(REQUIRED_COVERAGE)


def test_mask_outputs_proved_binary(audit):
    by_name = {e.entry: e for e in audit.entries}
    assert by_name["ops.fast:domain_select"].bool_outputs >= 1
    assert by_name["ops.kernels:probe_step"].bool_outputs >= 1
    assert by_name["ops.delta:apply_flags"].bool_outputs >= 1


def test_all_score_plugins_prove_range(audit):
    assert len(audit.plugins) == 10
    for p in audit.plugins:
        assert p.ok, p.to_dict()
        assert p.lo >= 0.0 and p.hi <= 100.0
        assert "nan" not in p.flags


def test_audit_json_shape(audit):
    doc = audit.to_dict()
    assert doc["ok"] is True
    assert [e["entry"] for e in doc["entries"]] == sorted(e["entry"] for e in doc["entries"])
    ref_keys = {"entry", "ok", "bool_outputs", "float_outputs", "outputs", "commit_carry",
                "findings"}
    assert all(set(e) == ref_keys for e in doc["entries"])
    assert json.loads(json.dumps(doc, sort_keys=True)) == doc


def test_real_commit_entries_prove_carry_nonneg(audit):
    by_name = {e.entry: e for e in audit.entries}
    for entry in (
        "ops.kernels:schedule_batch",
        "ops.fast:schedule_scenarios",
        "ops.fast:schedule_universes",
        "ops.kernels:commit_step",
        "ops.kernels:commit_wave",
    ):
        counts = by_name[entry].carry_verdict_counts()
        assert counts.get(inv.CARRY_PROVED, 0) >= 1, (entry, counts)
        assert inv.CARRY_UNGUARDED not in counts, (entry, counts)
        assert not any(f.kind == "commit-carry-nonneg" for f in by_name[entry].findings)
    traj = by_name["ops.fast:build_trajectory"]
    assert traj.carry_verdict_counts().get(inv.CARRY_VIRTUAL, 0) >= 1
