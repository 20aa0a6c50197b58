"""The port's native host runtime (open_simulator_tpu_torch/native/) against
the JAX package, on the CPU.

The counterpart of tests/test_native.py's seven tests:
- the compiled quantity parser's quad equals the JAX package's exact
  `parse_quantity` quad on the reference's corpus and on seeded random
  values of its grammar (a punt to the exact path is always legal); invalid
  values are rejected; a large negative exponent punts rather than wraps;
  whatever the JAX grammar rejects, the parser rejects;
- `hash_rows`: identical rows hash alike, a flipped byte changes the hash,
  1,000 random rows do not collide, and the bits equal a Python restatement
  of the C++ mixer and the JAX package's own library on the same blob;
- `group_runs` and `_row_signature` on the same pods, encoded by each
  package, equal the JAX package's, on the native path and on the blake2b
  path;
- without a compiler (a PATH with no g++, a fresh cache, in a subprocess)
  the loader reports unavailable and the Python paths give the same
  answers; with one, a fresh cache gets one build and a second process
  none; importing the port's `native` loads neither jax nor the reference
  and builds nothing.

Inputs are made from numpy seeds. Tolerance: exact.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from open_simulator_tpu import native as jnative
from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.ops import encode as jenc
from open_simulator_tpu.ops import grouped as jgrouped
from open_simulator_tpu.utils.quantity import parse_quantity as jparse_quantity
from open_simulator_tpu_torch import native
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.ops import encode as tenc
from open_simulator_tpu_torch.ops import grouped as tgrouped
from open_simulator_tpu_torch.utils import quantity as tquantity

ROOT = Path(__file__).resolve().parents[1]

CORPUS = [
    "0", "1", "250m", "1500m", "2", "512Mi", "4Gi", "1Ki", "3Ti", "2Pi",
    "107374182400", "1.5Ti", "100k", "2M", "3G", "4T", "5P",
    "0.1", "  3  ", "+2.5Gi", "-1500m", "-2", "1e3", "2E-2", "1e0", "5e6",
    "3n", "7u", ".5", "5.", "0.000001", "999999999", "12.345Mi", "1.000000001",
]

INVALID = ["", "bogus", "1.2.3", "Ki", "--1", "1..", "e3", "1ee3", "1 Gi", "1KiB"]

SUFFIXES = ["", "m", "k", "M", "G", "Ki", "Mi", "Gi", "Ti", "n", "u"]


def jax_exact_quad(s):
    """The JAX package's exact Fraction answer."""
    q = jparse_quantity(s)
    m, b = q * 1000, q
    return math.ceil(m), math.floor(m), math.ceil(b), math.floor(b)


def random_corpus(seed, n):
    """tests/test_native.py's randomized grammar, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        form = int(rng.integers(0, 3))
        if form == 0:
            num = str(int(rng.integers(0, 10**12 + 1)))
        elif form == 1:
            num = f"{int(rng.integers(0, 10**6 + 1))}.{int(rng.integers(0, 10**6))}"
        else:
            num = f".{int(rng.integers(1, 1000))}"
        sign = "-" if rng.random() < 0.2 else ""
        out.append(sign + num + SUFFIXES[int(rng.integers(0, len(SUFFIXES)))])
    return out


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the native library cannot be built here (no g++)")
    return native


@pytest.fixture(scope="module")
def jax_lib():
    if not jnative.available():
        pytest.skip("the JAX package's native library cannot be built here")
    return jnative


# ---------------------------------------------------------------------------
# the quantity parser


@pytest.mark.parametrize("s", CORPUS)
def test_scalar_parity_with_jax_exact(lib, s):
    got = lib.parse_quantity_one(s)
    want = jax_exact_quad(s)
    assert got is None or got == want, s
    tquantity.parse_quad.cache_clear()
    assert tquantity.parse_quad(s) == want == tquantity.exact_quad(s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_parity_with_jax_exact(lib, seed):
    corpus = random_corpus(seed, 2000)
    got = [lib.parse_quantity_one(s) for s in corpus]
    bad = [s for s, g in zip(corpus, got) if g is not None and g != jax_exact_quad(s)]
    assert not bad, bad[:5]
    # most values take the compiled path (the rest overflow int64 in milli)
    assert sum(g is not None for g in got) > len(corpus) // 2


@pytest.mark.parametrize("s", INVALID)
def test_invalid_values_rejected(lib, s):
    assert lib.parse_quantity_one(s) is None
    with pytest.raises(ValueError):
        jparse_quantity(s)
    tquantity.parse_quad.cache_clear()
    with pytest.raises(ValueError):
        tquantity.parse_quad(s)


def test_large_negative_exponent_punts_not_wraps(lib):
    # 10^40 would wrap u128; the parser must punt (None) so the exact
    # Fraction path answers, never return a silently-wrapped value.
    s = "3" + "0" * 35 + "e-40"
    got = lib.parse_quantity_one(s)
    assert got is None or got == jax_exact_quad(s)
    tquantity.parse_quad.cache_clear()
    assert tquantity.parse_quad(s) == jax_exact_quad(s) == (1, 0, 1, 0)


@pytest.mark.parametrize("s", CORPUS + INVALID)
def test_acceptance_matches_jax_grammar(lib, s):
    try:
        jparse_quantity(s)
        jax_ok = True
    except ValueError:
        jax_ok = False
    if not jax_ok:
        assert lib.parse_quantity_one(s) is None, s


# ---------------------------------------------------------------------------
# the row hasher

_M64 = (1 << 64) - 1


def _mix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def plain_hash_rows(data):
    """osim_hash_rows restated in Python: the plain version of the hasher."""
    out = np.zeros((data.shape[0], 2), np.uint64)
    for i, row in enumerate(data):
        raw = row.tobytes()
        h1, h2 = 0x243F6A8885A308D3, 0x13198A2E03707344
        for j in range(0, len(raw), 8):
            chunk = int.from_bytes(raw[j:j + 8], "little")
            h1 = _mix64(h1 ^ chunk)
            h2 = _mix64((h2 + chunk * 0x9E3779B97F4A7C15) & _M64)
        out[i] = (_mix64(h1 ^ len(raw)), _mix64(h2 ^ len(raw)))
    return out


def test_hash_rows_identity_and_difference(lib):
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 255, (1000, 137), dtype=np.uint8)
    calls = lib.calls
    h = lib.hash_rows(rows)
    assert lib.calls == calls + 1
    assert h.shape == (1000, 2) and h.dtype == np.uint64
    rows2 = rows.copy()
    rows2[5] = rows2[4]
    h2 = lib.hash_rows(rows2)
    assert (h2[4] == h2[5]).all()
    rows3 = rows.copy()
    rows3[7, 100] ^= 1
    h3 = lib.hash_rows(rows3)
    assert (h3[7] != h[7]).any()
    assert len(np.unique(h.view([("a", np.uint64), ("b", np.uint64)]))) == 1000


@pytest.mark.parametrize("width", [1, 8, 137, 676])
def test_hash_rows_bits_equal_plain_and_jax(lib, jax_lib, width):
    rng = np.random.default_rng(width)
    rows = rng.integers(0, 256, (64, width), dtype=np.uint8)
    rows[1] = rows[0]
    got = lib.hash_rows(rows)
    np.testing.assert_array_equal(got, plain_hash_rows(rows))
    np.testing.assert_array_equal(got, jax_lib.hash_rows(rows))


# ---------------------------------------------------------------------------
# group_runs on the same pods in both packages


def _pod(i, cpu, mem, app):
    return {
        "metadata": {"name": f"p-{i}", "namespace": "d", "labels": {"app": app}},
        "spec": {"containers": [
            {"name": "c", "resources": {"requests": {"cpu": cpu, "memory": mem}}}]},
    }


TEMPLATES = [("1", "1Gi", "a"), ("2", "1Gi", "a"), ("1", "2Gi", "b"), ("250m", "512Mi", "c")]


def pattern_pods(seed, n):
    """n pod dicts whose templates come in seeded runs (a template may
    follow itself, so runs of the pattern merge)."""
    rng = np.random.default_rng(seed)
    ids = []
    while len(ids) < n:
        ids += [int(rng.integers(0, len(TEMPLATES)))] * int(rng.integers(1, 9))
    ids = ids[:n]
    return [_pod(i, *TEMPLATES[t]) for i, t in enumerate(ids)], ids


def encode_both(pod_dicts):
    out = []
    for objs, enc_mod in ((jobj, jenc), (tobj, tenc)):
        pods = [objs.Pod.from_dict(d) for d in pod_dicts]
        enc = enc_mod.Encoder()
        enc.register_pods(pods)
        out.append(enc_mod.encode_pods(enc, pods))
    return out


def expected_runs(ids):
    runs, start = [], 0
    for i in range(1, len(ids) + 1):
        if i == len(ids) or ids[i] != ids[start]:
            runs.append((start, i - start))
            start = i
    return runs


@pytest.mark.parametrize("seed,n", [(0, 8), (1, 40), (2, 300)])
def test_group_runs_equal_jax(lib, jax_lib, seed, n):
    pod_dicts, ids = pattern_pods(seed, n)
    jb, tb = encode_both(pod_dicts)
    calls = lib.calls
    got = tgrouped.group_runs(tb)
    assert lib.calls == calls + 1  # the native hasher ran
    assert got == jgrouped.group_runs(jb) == expected_runs(ids)
    tsig, jsig = tgrouped._row_signature(tb), jgrouped._row_signature(jb)
    assert tsig.dtype == jsig.dtype and tsig.tobytes() == jsig.tobytes()


def test_group_runs_blake2b_path_equals_native(lib, monkeypatch):
    pod_dicts, ids = pattern_pods(3, 200)
    _, tb = encode_both(pod_dicts)
    want = tgrouped.group_runs(tb)
    monkeypatch.setattr(native, "hash_rows", lambda data: None)
    assert tgrouped._row_signature(tb).dtype == np.dtype("S8")
    assert tgrouped.group_runs(tb) == want == expected_runs(ids)


def test_group_runs_reference_example(lib):
    """tests/test_native.py's end-to-end case on the port."""
    pods = [_pod(f"a{i}", "1", "1Gi", "x") for i in range(5)]
    pods += [_pod(f"b{i}", "2", "1Gi", "x") for i in range(3)]
    _, tb = encode_both(pods)
    assert tgrouped.group_runs(tb) == [(0, 5), (5, 3)]


# ---------------------------------------------------------------------------
# the loader: build at first use into the compile cache, never at import

_CHILD = """
import json, os, sys
from pathlib import Path
cache = Path(os.environ["OSIM_COMPILE_CACHE"])
from open_simulator_tpu_torch import native
from open_simulator_tpu_torch.utils import quantity
from open_simulator_tpu_torch.ops import grouped
after_import = sorted(str(p.relative_to(cache)) for p in cache.rglob("*.so"))
out = {"after_import": after_import, "tried_at_import": native._tried}
out["available"] = native.available()
out["builds"] = native.builds
out["libs"] = sorted(str(p.relative_to(cache)) for p in cache.rglob("*.so"))
out["parse_one"] = native.parse_quantity_one("1500m")
out["hash"] = native.hash_rows(__import__("numpy").zeros((2, 3), "uint8")) is not None
out["quads"] = {s: list(quantity.parse_quad(s)) for s in json.loads(sys.argv[1])}
out["bad"] = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or m == "open_simulator_tpu" or m.startswith("open_simulator_tpu."))
print(json.dumps(out))
"""


def _child(tmp_path, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "CXX"}
    env.update(OSIM_COMPILE_CACHE=str(tmp_path / "cache"), **env_extra)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(CORPUS)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_compiler_degrades_to_python(tmp_path):
    """A PATH with no g++ and a fresh cache: unavailable, nothing built, and
    the exact path gives the JAX package's quads."""
    empty = tmp_path / "bin"
    empty.mkdir()
    out = _child(tmp_path, {"PATH": str(empty)})
    assert out["available"] is False and out["builds"] == 0 and out["libs"] == []
    assert out["parse_one"] is None and out["hash"] is False
    assert out["quads"] == {s: list(jax_exact_quad(s)) for s in CORPUS}
    assert out["bad"] == []


def test_missing_cxx_degrades_to_python(tmp_path):
    out = _child(tmp_path, {"CXX": str(tmp_path / "no-such-compiler")})
    assert out["available"] is False and out["builds"] == 0 and out["libs"] == []
    assert out["quads"] == {s: list(jax_exact_quad(s)) for s in CORPUS}


def test_fresh_cache_builds_once_then_loads(lib, tmp_path):
    """First use builds one library, tagged by source and flags, into
    build_dir(); importing builds nothing; a second process sharing the
    cache builds none; neither loads jax or the reference."""
    first = _child(tmp_path, {})
    assert first["after_import"] == [] and first["tried_at_import"] is False
    assert first["available"] is True and first["builds"] == 1
    (so,) = first["libs"]
    assert Path(so).name == native.library_path(Path(".")).name
    assert first["parse_one"] == [1500, 1500, 2, 1] and first["hash"] is True
    assert first["quads"] == {s: list(jax_exact_quad(s)) for s in CORPUS}
    assert first["bad"] == []
    second = _child(tmp_path, {})
    assert second["available"] is True and second["builds"] == 0
    assert second["libs"] == first["libs"]


def test_library_name_tracks_source_and_flags(monkeypatch, tmp_path):
    name = native.library_path(tmp_path).name
    assert name.startswith("libosim_native-") and name.endswith(".so")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DX",))
    assert native.library_path(tmp_path).name != name


def test_source_computes_the_reference_source():
    """The port's C++ differs from the JAX package's only in its header
    comment."""
    jsrc = (ROOT / "open_simulator_tpu" / "native" / "osim_native.cpp").read_text()
    tsrc = native.SOURCE.read_text()
    cut = "#include <cstdint>"
    assert tsrc[tsrc.index(cut):] == jsrc[jsrc.index(cut):]
