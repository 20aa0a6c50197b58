"""Kubernetes resource.Quantity parsing and formatting.

Quantities are kept as exact integers in a canonical base unit:
  - cpu-like quantities: millivalue (1 cpu == 1000)
  - everything else: the plain value in its base unit (bytes for memory).
Parsing supports suffixes m, k/M/G/T/P/E, Ki/Mi/Gi/Ti/Pi/Ei and e/E exponents,
mirroring the accepted forms of the upstream Quantity grammar.
"""

from __future__ import annotations

import functools
import math
import re
from fractions import Fraction

_BINARY = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 1000),
    "": 1,
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}

_QTY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE])|[eE](?P<exp>[+-]?\d+))?$"
)


def parse_quantity(value) -> Fraction:
    """Parse a Kubernetes quantity (str/int/float) into an exact Fraction."""
    if isinstance(value, bool):
        raise ValueError(f"invalid quantity: {value!r}")
    if isinstance(value, int):
        return Fraction(value)
    if isinstance(value, float):
        return Fraction(value).limit_denominator(10**9)
    if not isinstance(value, str):
        raise ValueError(f"invalid quantity: {value!r}")
    s = value.strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    num = Fraction(m.group("num"))
    if m.group("exp") is not None:
        num *= Fraction(10) ** int(m.group("exp"))
    else:
        suffix = m.group("suffix") or ""
        if suffix in _BINARY:
            num *= _BINARY[suffix]
        else:
            num *= _DECIMAL[suffix]
    if m.group("sign") == "-":
        num = -num
    return num


def exact_quad(s: str) -> tuple:
    """(milli_ceil, milli_floor, base_ceil, base_floor) through the exact
    Fraction path: the plain version of the compiled parser, and the answer
    for every value it punts on."""
    q = parse_quantity(s)
    m, b = q * 1000, q
    return (
        int(math.ceil(m)),
        int(math.floor(m)),
        int(math.ceil(b)),
        int(math.floor(b)),
    )


def _native_parse_one(s: str):
    """(milli_ceil, milli_floor, base_ceil, base_floor) via the compiled
    parser (native/osim_native.cpp), or None when the library is unavailable
    or the value needs the exact path."""
    from ..native import parse_quantity_one

    return parse_quantity_one(s)


@functools.lru_cache(maxsize=131072)
def parse_quad(s: str) -> tuple:
    """(milli_ceil, milli_floor, base_ceil, base_floor) for a quantity string.
    Quantity strings repeat massively across pod templates, hence the cache;
    a miss takes the compiled parser first and the exact path when it
    punts."""
    native = _native_parse_one(s)
    if native is not None:
        return native
    return exact_quad(s)


def parse_milli(value) -> int:
    """Parse a quantity and return it in milli-units, rounding up (cpu)."""
    if isinstance(value, str):
        return parse_quad(value)[0]
    return int(math.ceil(parse_quantity(value) * 1000))


def parse_int(value) -> int:
    """Parse a quantity and return the integer base value, rounding up."""
    if isinstance(value, str):
        return parse_quad(value)[2]
    return int(math.ceil(parse_quantity(value)))


def format_milli(milli: int) -> str:
    """Render a milli-quantity the way kubectl does (e.g. 1500m, 2)."""
    if milli % 1000 == 0:
        return str(milli // 1000)
    return f"{milli}m"


def format_bytes(n: int) -> str:
    """Render bytes with the largest clean binary suffix (parity with kubectl)."""
    for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
        unit = _BINARY[suffix]
        if n != 0 and n % unit == 0:
            return f"{n // unit}{suffix}"
    return str(n)
