"""Kubernetes resource quantities ("500m", "16Gi", "2") as exact integers:
cpu in millicores, everything else in base units (bytes for memory),
rounded up as resource.Quantity's MilliValue and Value are."""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {"n": Fraction(1, 10**9), "u": Fraction(1, 10**6), "m": Fraction(1, 1000),
            "": Fraction(1), "k": Fraction(10**3), "M": Fraction(10**6),
            "G": Fraction(10**9), "T": Fraction(10**12), "P": Fraction(10**15),
            "E": Fraction(10**18)}


def value(s) -> Fraction:
    """The exact value of a quantity string."""
    s = str(s).strip()
    for suf, mul in _BINARY.items():
        if s.endswith(suf):
            return Fraction(s[: -len(suf)]) * mul
    if s and s[-1] in _DECIMAL and not s[-1].isdigit():
        return Fraction(s[:-1]) * _DECIMAL[s[-1]]
    if "e" in s.lower():
        mant, exp = s.lower().split("e")
        return Fraction(mant) * Fraction(10) ** int(exp)
    return Fraction(s)


@lru_cache(maxsize=4096)
def canonical(resource: str, s) -> int:
    """cpu in millicores, any other resource in its base unit, rounded up."""
    v = value(s) * (1000 if resource == "cpu" else 1)
    return -((-v.numerator) // v.denominator)
