"""SARIF 2.1.0 emission for the `simon check` umbrella verb.

The port of the JAX package's analysis/sarif.py. Every static pass emits a
deterministic JSON report of its own shape (`simon lint`, `simon audit`,
`simon preflight`, `simon interleave`); CI annotation UIs speak SARIF.
This module converts each pass's report into a SARIF *run* (one
`tool.driver` per producer, so annotations are attributed to the pass that
found them) and `sarif_document` stitches the runs into one 2.1.0
document.

Shape conventions:

* one SARIF `run` per producer (`simon-lint`, `simon-audit`,
  `simon-preflight`, `simon-interleave`), even when a producer has zero
  results: the empty run is the machine-readable "this pass ran and was
  clean" statement;
* the lint run's rule metadata (id and one-line description) comes from
  the port's rule registry (`analysis.lint.iter_rules`);
* findings with a source position (lint, races) carry a
  `physicalLocation`; interleaving violations anchor to the module whose
  protocol the scenario drives, and preflight results to the budget book,
  so annotation UIs have somewhere to pin them;
* all output is plain dicts ordered for `json.dumps(sort_keys=True)`
  byte-stability: no wall clock, no randomness.

The converters take the pass report objects (duck-typed), so `simon check`
runs the passes in-process and hands the results straight over. This
module imports no torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"
_INFO_URI = "https://github.com/open-simulator/open-simulator"

#: where a location-less interleave violation is pinned: the module whose
#: protocol the scenario exercises (see analysis/interleave.py SCENARIOS).
SCENARIO_SUBJECTS = {
    "admission": "open_simulator_tpu_torch/server/admission.py",
    "fence": "open_simulator_tpu_torch/server/loop.py",
    "session": "open_simulator_tpu_torch/server/server.py",
    "journal": "open_simulator_tpu_torch/durable/journal.py",
    "breaker": "open_simulator_tpu_torch/resilience/policy.py",
}


def _location(path: str, line: int = 0, col: int = 0) -> dict:
    region: dict = {}
    if line:
        region["startLine"] = int(line)
    if col:
        # SARIF columns are 1-based; the AST passes report 0-based cols.
        region["startColumn"] = int(col) + 1
    loc: dict = {
        "physicalLocation": {
            "artifactLocation": {"uri": path, "uriBaseId": "SRCROOT"}
        }
    }
    if region:
        loc["physicalLocation"]["region"] = region
    return loc


def _result(
    rule_id: str,
    message: str,
    *,
    level: str = "error",
    path: str = "",
    line: int = 0,
    col: int = 0,
    properties: Optional[dict] = None,
) -> dict:
    res: dict = {
        "ruleId": rule_id,
        "level": level,
        "message": {"text": message},
    }
    if path:
        res["locations"] = [_location(path, line, col)]
    if properties:
        res["properties"] = properties
    return res


def _run(
    name: str,
    rule_ids: List[str],
    results: List[dict],
    properties: Optional[dict] = None,
    docs: Optional[Dict[str, str]] = None,
) -> dict:
    rules = []
    for r in sorted(set(rule_ids)):
        meta: dict = {"id": r}
        if docs and r in docs:
            meta["shortDescription"] = {"text": docs[r]}
        rules.append(meta)
    run: dict = {
        "tool": {
            "driver": {
                "name": name,
                "informationUri": _INFO_URI,
                "rules": rules,
            }
        },
        "columnKind": "utf16CodeUnits",
        "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
        "results": results,
    }
    if properties:
        run["properties"] = properties
    return run


# ---------------------------------------------------------------------------
# per-pass converters
# ---------------------------------------------------------------------------

def lint_run(report) -> dict:
    """`simon lint` LintReport -> SARIF run. Suppressed findings are
    omitted (they are the accepted-and-annotated set, not annotations)."""
    results = [
        _result(
            f.rule,
            f.message + (f" [via {f.jit_root}]" if f.jit_root else ""),
            path=f.path,
            line=f.line,
            col=f.col,
        )
        for f in report.active
    ]
    from .lint import iter_rules

    return _run("simon-lint", list(report.rules), results, docs=dict(iter_rules()))


def audit_run(report) -> dict:
    """`simon audit` SemanticAuditReport -> SARIF run. Unused suppressions
    are findings too: a stale ``audit-ok`` hides future regressions;
    invariant findings ride along with their op path."""
    results: List[dict] = []
    rule_ids: List[str] = []
    races = getattr(report, "races", None)
    if races is not None:
        for f in races.active:
            rule_ids.append(f.rule)
            results.append(
                _result(
                    f.rule,
                    f"{f.message} [via {f.thread_root}]",
                    path=f.path,
                    line=f.line,
                    col=f.col,
                    properties={"state": f.state, "function": f.function},
                )
            )
        for u in races.unused_suppressions:
            rule_ids.append("unused-suppression")
            results.append(
                _result(
                    "unused-suppression",
                    f"unused audit suppression audit-ok[{u.rule}]",
                    level="warning",
                    path=u.path,
                    line=u.line,
                )
            )
    inv = getattr(report, "invariants", None)
    if inv is not None and not inv.ok:
        for f in inv.findings:
            rule_ids.append(f.kind)
            results.append(
                _result(
                    f.kind,
                    f"{f.entry} at {f.path}: {f.message}",
                    properties={"primitive": f.primitive},
                )
            )
    return _run("simon-audit", rule_ids, results)


def preflight_run(report) -> dict:
    """`simon preflight` PreflightReport -> SARIF run. Everything is
    report-level (budgets live in budgets/preflight_torch.json), so results
    anchor to the budget book."""
    results: List[dict] = []
    rule_ids: List[str] = []
    anchor = report.budgets_path or "budgets/preflight_torch.json"
    for v in report.violations:
        d = v.to_dict() if hasattr(v, "to_dict") else dict(v)
        rule = str(d.get("kind", "budget"))
        rule_ids.append(rule)
        results.append(
            _result(
                rule,
                f"{d.get('key', '?')}: {d.get('message', '')}",
                path=anchor,
                properties={k: d[k] for k in sorted(d)},
            )
        )
    for p in report.programs:
        if p.error:
            rule_ids.append("lowering-error")
            results.append(_result("lowering-error", f"{p.key}: {p.error}", path=anchor))
        elif not p.estimate_ok:
            rule_ids.append("estimator-mismatch")
            results.append(
                _result(
                    "estimator-mismatch",
                    f"{p.key}: the tracker does not cover the measured bytes (arguments "
                    f"{p.argument_bytes} vs estimate {p.est_argument_bytes}; peak "
                    f"{p.tracker_peak_bytes} vs card {p.cuda_peak_bytes})",
                    path=anchor,
                )
            )
        if p.node_gathers:
            rule_ids.append("node-table-replication")
            results.append(_result("node-table-replication",
                                   f"{p.key}: gathers {p.node_gathers}", path=anchor))
        if p.lane_parallel_violation:
            rule_ids.append("lane-parallel-exchange")
            results.append(_result("lane-parallel-exchange",
                                   f"{p.key}: exchanges {p.collectives} on a scenario-only mesh",
                                   path=anchor))
    for t in report.transfers:
        if not t.ok:
            rule_ids.append("steady-state-transfer")
            results.append(
                _result(
                    "steady-state-transfer",
                    f"{t.entry}: host transfer in steady state"
                    + (f" ({t.error})" if t.error else ""),
                    path=anchor,
                )
            )
    verdict = report.verdict
    if verdict is not None and not verdict.get("ok", False):
        rule_ids.append("plan-verdict")
        results.append(
            _result(
                "plan-verdict",
                f"plan verdict {verdict.get('config', '?')} failed: "
                f"{verdict.get('error') or 'does not fit'}",
                path=anchor,
            )
        )
    # the audited inventory rides in the run's property bag: a clean run
    # then still NAMES every covered program, so a regression that drops an
    # entry from the budget book is visible as an inventory diff
    covered = sorted({p.key for p in report.programs})
    return _run("simon-preflight", rule_ids, results, properties={"programs": covered})


def interleave_run(report) -> dict:
    """`simon interleave` InterleaveReport -> SARIF run. Violations anchor
    to the module whose protocol the scenario drives; the minimized
    schedule rides in the result's property bag so the annotation is
    replayable (`simon interleave --replay`)."""
    results: List[dict] = []
    rule_ids: List[str] = []
    for sc in sorted(report.scenarios, key=lambda s: s.name):
        for v in sc.violations:
            rule_ids.append(v.invariant)
            results.append(
                _result(
                    v.invariant,
                    f"scenario '{v.scenario}': {v.message}",
                    path=SCENARIO_SUBJECTS.get(v.scenario, ""),
                    line=1,
                    properties={
                        "scenario": v.scenario,
                        "interventions": [list(i) for i in v.interventions],
                        "seed": report.seed,
                        "mutate": report.mutate or "",
                    },
                )
            )
        if not sc.completed and not sc.violations:
            rule_ids.append("exploration-incomplete")
            results.append(
                _result(
                    "exploration-incomplete",
                    f"scenario '{sc.name}': exploration hit the run budget "
                    f"before exhausting the interleaving space "
                    f"({sc.runs} runs, {sc.states} states)",
                    level="warning",
                    path=SCENARIO_SUBJECTS.get(sc.name, ""),
                    line=1,
                )
            )
    return _run("simon-interleave", rule_ids, results)


def sarif_document(runs: List[dict]) -> dict:
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": runs,
    }
