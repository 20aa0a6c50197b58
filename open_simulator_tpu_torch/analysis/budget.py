"""Device-memory budgets: the per-device byte estimator and the checked-in
budget book.

The port of the JAX package's analysis/budget.py. Two halves:

* **estimator**: per-device bytes of trees of anything that carries
  `.shape`/`.dtype`: torch tensors (counted on their device), `meta`
  tensors standing for tensors not made yet and numpy arrays (counted on a
  default device), and `parallel.slots.Sharded` trees (each block on its
  slot). It is `parallel.mesh.bytes_per_device`, the pure half of
  `hbm_bytes_per_device`, so the planned and the materialized count are one
  function; the preflight (analysis/preflight.py) prices its argument trees
  with it.

* **budget book**: the checked-in per-(entry, rung, mesh) record of what
  each program may cost: argument/output/temp/alias/peak bytes from the
  preflight's live-bytes tracker plus the collective census (kind -> count,
  operand bytes). `diff()` compares a fresh measurement against the book
  and reports violations; `simon preflight --write-budgets` is the only way
  to raise a budget. The JSON schema is the reference's, byte for byte; the
  port's book is budgets/preflight_torch.json (budgets/preflight.json stays
  the reference's).

The book half imports no torch: book round trips and diffs run on the
standard library alone.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

BOOK_VERSION = 1

#: Relative headroom a measurement may exceed its budget by before it is
#: a violation. Absorbs allocator-rounding drift, not regressions.
DEFAULT_TOLERANCE = 0.05
#: Absolute slack added on top of the relative tolerance (bytes). Small
#: programs live entirely inside block rounding; 1 MiB keeps them from
#: flapping while staying far below any real node-table leak.
DEFAULT_SLACK_BYTES = 1 << 20


# ---------------------------------------------------------------------------
# estimator
# ---------------------------------------------------------------------------

def estimate_bytes_by_device(*trees: Any, default_device: Optional[Any] = None) -> Dict[str, int]:
    """Sum the per-device bytes of whole trees: NamedTuples, tuples, lists
    and dicts of leaves, Sharded trees per slot (parallel.mesh.bytes_per_device
    over every leaf and Sharded subtree)."""
    from ..parallel import mesh
    from ..parallel.slots import Sharded

    flat: List[Any] = []

    def walk(x):
        if isinstance(x, Sharded) or hasattr(x, "shape") and hasattr(x, "dtype"):
            flat.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    for tree in trees:
        walk(tree)
    return mesh.bytes_per_device(*flat, default_device=default_device)


def estimate_max_bytes_per_device(*trees: Any, default_device: Optional[Any] = None) -> int:
    """The headline scalar: the worst per-device byte load of the trees."""
    per = estimate_bytes_by_device(*trees, default_device=default_device)
    return max(per.values(), default=0)


# ---------------------------------------------------------------------------
# budget book
# ---------------------------------------------------------------------------

def program_key(entry: str, rung: int, mesh: str) -> str:
    """Canonical budget key, e.g. ``ops.fast:schedule_scenarios@r128@m2x2``."""
    return f"{entry}@r{int(rung)}@m{mesh}"


@dataclasses.dataclass
class ProgramBudget:
    """Per-device byte + collective envelope of one program."""

    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int = 0
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_bytes: int = 0

    def to_dict(self) -> dict:
        return {
            "peak_bytes": int(self.peak_bytes),
            "argument_bytes": int(self.argument_bytes),
            "output_bytes": int(self.output_bytes),
            "temp_bytes": int(self.temp_bytes),
            "alias_bytes": int(self.alias_bytes),
            "collectives": {k: int(v) for k, v in sorted(self.collectives.items())},
            "collective_bytes": int(self.collective_bytes),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProgramBudget":
        return cls(
            peak_bytes=int(d["peak_bytes"]),
            argument_bytes=int(d["argument_bytes"]),
            output_bytes=int(d["output_bytes"]),
            temp_bytes=int(d["temp_bytes"]),
            alias_bytes=int(d.get("alias_bytes", 0)),
            collectives=dict(d.get("collectives", {})),
            collective_bytes=int(d.get("collective_bytes", 0)),
        )


@dataclasses.dataclass
class BudgetViolation:
    key: str
    kind: str      # unbudgeted | memory | new-collective | collective-bytes
    field: str     # which quantity tripped
    measured: int
    budget: int
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.key}: {self.kind}: {self.message}"


@dataclasses.dataclass
class BudgetBook:
    """The checked-in budget file (``budgets/preflight_torch.json``)."""

    programs: Dict[str, ProgramBudget] = dataclasses.field(default_factory=dict)
    #: machine-checked verdicts (e.g. plan_1m_100k fits in device memory)
    #: written by --write-budgets so CI can surface them without a rerun
    verdicts: Dict[str, dict] = dataclasses.field(default_factory=dict)
    tolerance: float = DEFAULT_TOLERANCE
    slack_bytes: int = DEFAULT_SLACK_BYTES
    version: int = BOOK_VERSION

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "tolerance": self.tolerance,
            "slack_bytes": self.slack_bytes,
            "programs": {k: self.programs[k].to_dict() for k in sorted(self.programs)},
            "verdicts": {k: self.verdicts[k] for k in sorted(self.verdicts)},
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "BudgetBook":
        with open(path, "r", encoding="utf-8") as fh:
            d = json.load(fh)
        return cls(
            programs={k: ProgramBudget.from_dict(v) for k, v in d.get("programs", {}).items()},
            verdicts=dict(d.get("verdicts", {})),
            tolerance=float(d.get("tolerance", DEFAULT_TOLERANCE)),
            slack_bytes=int(d.get("slack_bytes", DEFAULT_SLACK_BYTES)),
            version=int(d.get("version", BOOK_VERSION)),
        )

    # -- diff ---------------------------------------------------------------

    def _cap(self, budget: int) -> int:
        return int(budget * (1.0 + self.tolerance)) + self.slack_bytes

    def diff(self, measured: Dict[str, ProgramBudget]) -> List[BudgetViolation]:
        """Violations of ``measured`` against this book.

        * a measured program with no budget is ``unbudgeted`` (a new entry
          / rung / mesh must be admitted via --write-budgets, consciously);
        * any byte field above ``budget * (1 + tolerance) + slack`` is a
          ``memory`` violation — shrinking is always fine;
        * a collective kind with more instances than budgeted (absent kind
          = 0) is ``new-collective``: a program that was collective-free
          must stay collective-free;
        * collective operand bytes above the byte cap is
          ``collective-bytes`` (same count, fatter exchanges).

        Book entries absent from ``measured`` are NOT violations — partial
        matrices (test subsets, --entries filters) diff only what they ran.
        """
        out: List[BudgetViolation] = []
        for key in sorted(measured):
            m = measured[key]
            b = self.programs.get(key)
            if b is None:
                out.append(BudgetViolation(
                    key=key, kind="unbudgeted", field="", measured=0, budget=0,
                    message="no checked-in budget for this (entry, rung, mesh)"
                            " — run `simon preflight --write-budgets` to"
                            " admit it",
                ))
                continue
            for field in ("peak_bytes", "argument_bytes", "output_bytes", "temp_bytes"):
                mv = int(getattr(m, field))
                bv = int(getattr(b, field))
                if mv > self._cap(bv):
                    out.append(BudgetViolation(
                        key=key, kind="memory", field=field, measured=mv, budget=bv,
                        message=f"{field} {mv} exceeds budget {bv} (cap {self._cap(bv)})",
                    ))
            for kind in sorted(set(m.collectives) | set(b.collectives)):
                mc = int(m.collectives.get(kind, 0))
                bc = int(b.collectives.get(kind, 0))
                if mc > bc:
                    out.append(BudgetViolation(
                        key=key, kind="new-collective", field=kind, measured=mc, budget=bc,
                        message=f"{mc} {kind} op(s) vs {bc} budgeted — new "
                                f"cross-device communication in this program",
                    ))
            if int(m.collective_bytes) > self._cap(int(b.collective_bytes)):
                out.append(BudgetViolation(
                    key=key, kind="collective-bytes", field="collective_bytes",
                    measured=int(m.collective_bytes), budget=int(b.collective_bytes),
                    message=f"collective operand bytes {int(m.collective_bytes)} exceed "
                            f"budget {int(b.collective_bytes)}",
                ))
        return out
