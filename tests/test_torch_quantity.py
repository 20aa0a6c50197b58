"""The port's quantity parsing and formatting (utils/quantity.py) against the
JAX package's, on the cases of tests/test_quantity.py and the reference's
native corpus, with the parse cache cleared so each case takes the native
parser (or its exact fallback) afresh. Tolerance: exact."""

from fractions import Fraction

import pytest

from open_simulator_tpu.utils import quantity as jq
from open_simulator_tpu_torch.utils import quantity as tq

PARSE_CASES = [
    ("1", 1),
    ("100m", Fraction(1, 10)),
    ("1500m", Fraction(3, 2)),
    ("2", 2),
    ("1Gi", 1024**3),
    ("16Gi", 16 * 1024**3),
    ("512Mi", 512 * 1024**2),
    ("61255492Ki", 61255492 * 1024),
    ("1k", 1000),
    ("1M", 10**6),
    ("1e3", 1000),
    ("1.5e2", 150),
    ("0.5", Fraction(1, 2)),
    (".5", Fraction(1, 2)),
    ("-1", -1),
    ("107374182400", 107374182400),
]

# every value tests/test_quantity.py and tests/test_native.py parse, and
# non-string inputs
VALUES = [t for t, _ in PARSE_CASES] + [
    "0.1", "110", "250m", "  3  ", "+2.5Gi", "-1500m", "2E-2", "3n", "7u", "5.",
    "0.000001", "12.345Mi", "1.000000001", "3" + "0" * 35 + "e-40", "2Pi", "5P",
    110, 0, -3, 1.5, 0.1,
]

INVALID = ["abc", "1Qi", "", "bogus", "1.2.3", "Ki", "--1", "1..", "e3", "1ee3", "1 Gi",
           "1KiB", True, None, [1]]


@pytest.mark.parametrize("text,expected", PARSE_CASES)
def test_parse_quantity_matches_jax(text, expected):
    assert tq.parse_quantity(text) == jq.parse_quantity(text) == expected


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_parse_helpers_match_jax(value):
    tq.parse_quad.cache_clear()
    assert tq.parse_milli(value) == jq.parse_milli(value)
    assert tq.parse_int(value) == jq.parse_int(value)
    if isinstance(value, str):
        assert tq.parse_quad(value) == jq.parse_quad(value) == tq.exact_quad(value)


def test_parse_helpers_cases():
    assert tq.parse_milli("1500m") == 1500
    assert tq.parse_milli("2") == 2000
    assert tq.parse_milli("0.1") == 100
    assert tq.parse_int("1Gi") == 1024**3
    assert tq.parse_int(110) == 110
    assert tq.parse_int("110") == 110


@pytest.mark.parametrize("value", INVALID, ids=repr)
def test_parse_invalid_matches_jax(value):
    with pytest.raises(ValueError):
        jq.parse_quantity(value)
    with pytest.raises(ValueError):
        tq.parse_quantity(value)
    if isinstance(value, str):
        tq.parse_quad.cache_clear()
        with pytest.raises(ValueError):
            tq.parse_quad(value)


@pytest.mark.parametrize("milli", [0, 1, 999, 1000, 1500, 2000, 123456, -1500, -2000])
def test_format_milli_matches_jax(milli):
    assert tq.format_milli(milli) == jq.format_milli(milli)


@pytest.mark.parametrize("n", [0, 1000, 1024, 1536, 1024**3, 512 * 1024**2, 3 * 1024**6,
                               61255492 * 1024, -1024])
def test_format_bytes_matches_jax(n):
    assert tq.format_bytes(n) == jq.format_bytes(n)


def test_format_cases():
    assert tq.format_milli(1500) == "1500m"
    assert tq.format_milli(2000) == "2"
    assert tq.format_bytes(1024**3) == "1Gi"
    assert tq.format_bytes(512 * 1024**2) == "512Mi"
    assert tq.format_bytes(1000) == "1000"
