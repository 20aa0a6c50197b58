"""`simon audit` driver: the semantic verification passes of the port.

The port of the JAX package's analysis/audit.py. Of the reference's passes
the port runs one so far:

* **races** (`analysis.races`): every mutation of module-level shared state
  reachable from server handler threads, thread targets, executor tasks,
  the watchdog and signal handlers is dominated by a `with <lock>:` block
  or an explicit `@guarded_by` annotation, and no two locks are taken in
  opposite orders.

The invariant pass (an interval domain over each entry's aten op trace, in
place of the reference's jaxpr walk) and `--memory` (measured CUDA peaks in
place of `memory_analysis()`) wait for the next slice (ROADMAP item
14b-ii). Until then the report carries `"invariants": null`, the shape of
the reference's `--no-invariants` report, and the CLI says so on stderr.

The race pass is pure AST: this module imports no torch. Its report is
deterministic (stable sort keys, no wall clock), so the JSON is
byte-identical across runs and diffable in CI.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from .races import RaceAuditReport, run_races

#: said on stderr by `simon audit` / `simon check` while the pass is missing
INVARIANTS_PENDING = (
    "audit: the invariant pass is not in the port yet (ROADMAP item 14b-ii); "
    "reporting invariants as null"
)


@dataclasses.dataclass
class SemanticAuditReport:
    races: Optional[RaceAuditReport]

    @property
    def ok(self) -> bool:
        return self.races is None or self.races.ok

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "races": self.races.to_dict() if self.races is not None else None,
            "invariants": None,
            "memory": None,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def render_text(self) -> str:
        parts = []
        if self.races is not None:
            parts.append(self.races.render_text())
        parts.append(f"audit: {'ok' if self.ok else 'FAILED'}")
        return "\n".join(parts)


def run_semantic_audit(
    races: bool = True,
    package_root: Optional[str] = None,
    report_root: Optional[str] = None,
) -> SemanticAuditReport:
    """Run the race pass (pure AST) unless `races` is False."""
    race_report = (
        run_races(package_root=package_root, report_root=report_root) if races else None
    )
    return SemanticAuditReport(races=race_report)
