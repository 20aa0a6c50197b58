"""Minimal text-table rendering (replaces the reference's pterm tables)."""

from __future__ import annotations

from typing import List, Sequence


def render_table(headers: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    cols = len(headers)
    widths = [len(str(h)) for h in headers]
    str_rows: List[List[str]] = []
    for row in rows:
        cells = [str(c) for c in row] + [""] * (cols - len(row))
        str_rows.append(cells)
        for i in range(cols):
            widths[i] = max(widths[i], len(cells[i]))

    def line(cells: Sequence[str]) -> str:
        return "| " + " | ".join(c.ljust(widths[i]) for i, c in enumerate(cells)) + " |"

    sep = "|" + "|".join("-" * (w + 2) for w in widths) + "|"
    out = [line([str(h) for h in headers]), sep]
    out.extend(line(r) for r in str_rows)
    return "\n".join(out)


# --- terminal coloring (the pterm-colored-tables analog) --------------------

import re as _re

_PCT_RE = _re.compile(r"\b(\d+(?:\.\d+)?)%")


def colorize_report(text: str) -> str:
    """ANSI-color a rendered report for terminal display (parity: the
    reference's pterm color tables; its DisablePTerm-when-writing-to-file
    maps to the caller only colorizing tty output). Utilization percentages
    go green < 50%, yellow < 80%, red >= 80%; section headers are bold."""

    def pct(m: "_re.Match[str]") -> str:
        v = float(m.group(1))
        code = "32" if v < 50.0 else ("33" if v < 80.0 else "31")
        return f"\x1b[{code}m{m.group(0)}\x1b[0m"

    out = []
    for line in text.split("\n"):
        if line.startswith("=== "):
            out.append(f"\x1b[1m{line}\x1b[0m")
        else:
            out.append(_PCT_RE.sub(pct, line))
    return "\n".join(out)
