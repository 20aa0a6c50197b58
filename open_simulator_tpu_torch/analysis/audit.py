"""`simon audit` driver: the semantic verification passes of the port.

The port of the JAX package's analysis/audit.py. Where `simon lint` checks
syntactic contracts and the op census what an entry issues, `simon audit`
proves semantic properties:

* **races** (`analysis.races`): every mutation of module-level shared state
  reachable from server handler threads, thread targets, executor tasks,
  the watchdog and signal handlers is dominated by a `with <lock>:` block
  or an explicit `@guarded_by` annotation, and no two locks are taken in
  opposite orders;
* **invariants** (`analysis.invariants`): an abstract interpretation of the
  aten op graphs of every registry entry, proving mask outputs stay in
  {0, 1}, score plugins stay in [0, 100], no NaN (e.g. the ``-inf * 0.0``
  sentinel pattern) can reach a selection op, and the commit scans' resource
  counters stay non-negative;
* **memory** (`analysis.preflight`, opt-in via ``--memory``): a compact
  slice of the preflight matrix: every entry at the canonical rung on every
  mesh, with the exchange census and, on a card, the tracker held against
  the card's measured peak. The full rung x mesh x budget-diff matrix (plus
  the transfer pass and the plan_1m_100k verdict) lives under
  ``simon preflight``.

The race pass is pure AST and imports no torch; the invariant and memory
passes run the registry capture on `device` (one capture serves both).
Every pass's findings are deterministic (stable sort keys, no wall clock),
so the JSON report is byte-identical across runs and diffable in CI.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

from .races import RaceAuditReport, run_races


@dataclasses.dataclass
class SemanticAuditReport:
    races: Optional[RaceAuditReport]
    invariants: Optional[object] = None  # invariants.InvariantAudit
    memory: Optional[object] = None      # preflight.PreflightReport

    @property
    def ok(self) -> bool:
        return (
            (self.races is None or self.races.ok)
            and (self.invariants is None or self.invariants.ok)
            and (self.memory is None or self.memory.ok)
        )

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "races": self.races.to_dict() if self.races is not None else None,
            "invariants": (
                self.invariants.to_dict() if self.invariants is not None else None
            ),
            "memory": self.memory.to_dict() if self.memory is not None else None,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def render_text(self) -> str:
        parts = []
        if self.races is not None:
            parts.append(self.races.render_text())
        if self.invariants is not None:
            parts.append(self.invariants.render_text())
        if self.memory is not None:
            parts.append(self.memory.render_text())
        parts.append(f"audit: {'ok' if self.ok else 'FAILED'}")
        return "\n".join(parts)


def run_semantic_audit(
    races: bool = True,
    invariants: bool = True,
    memory: bool = False,
    device=None,
    package_root: Optional[str] = None,
    report_root: Optional[str] = None,
    captures: Optional[Sequence] = None,
) -> SemanticAuditReport:
    """Run the requested passes. The race pass is pure AST; the invariant
    and memory passes capture the registry once on `device` (default: the
    card), or use `captures`."""
    race_report = (
        run_races(package_root=package_root, report_root=report_root) if races else None
    )
    inv_report = mem_report = None
    if invariants or memory:
        from ..device import DEFAULT_DEVICE, resolve_device

        dev = resolve_device(DEFAULT_DEVICE if device is None else device)
        if captures is None:
            from . import entry_audit

            captures = entry_audit._capture_calls(dev)
        if invariants:
            from .invariants import run_invariants

            inv_report = run_invariants(dev, captures=captures)
        if memory:
            from .preflight import N_CANON, run_preflight

            # compact slice: the canonical rung, every mesh; no transfer pass,
            # no verdict, no budget diff — those are `simon preflight` business
            mem_report = run_preflight(
                rungs=(N_CANON,), caps=captures, transfers=False, verdict=False, device=dev,
            )
    return SemanticAuditReport(races=race_report, invariants=inv_report, memory=mem_report)
