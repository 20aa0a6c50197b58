"""`simon check` on the port (open_simulator_tpu_torch/analysis/sarif.py and
the CLI verb) on the CPU: a SARIF 2.1.0 document with one run per tool
(simon-lint, simon-audit, simon-preflight, simon-interleave), the lint run's
rule metadata from the port's registry, findings located in the source, the
json and text formats, --output, the --no-* flags and the exit codes; the
`preflight` verb's exit codes against the budget book and `audit --memory`'s
report. The device passes run on a few registry captures (one capture for
the file) at the canonical rung.
"""

import json

import pytest

from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.analysis import iter_rules, run_lint, sarif
from open_simulator_tpu_torch.analysis.races import run_races


def _check(capsys, *argv):
    rc = cli.main(["check", *argv])
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


#: the captures the device passes run on here: the verdict's entry and two
#: short ones
SUBSET = ("ops.fast:schedule_scenarios", "ops.kernels:probe_step", "ops.kernels:commit_step")


@pytest.fixture(scope="module")
def _captures():
    from open_simulator_tpu_torch.analysis import entry_audit

    return [c for c in entry_audit._capture_calls("cpu") if c.name in SUBSET]


@pytest.fixture
def subset(_captures, monkeypatch):
    """The device passes on SUBSET at the canonical rung and mesh."""
    from open_simulator_tpu_torch.analysis import entry_audit, preflight

    monkeypatch.setattr(entry_audit, "_capture_calls", lambda *a, **k: list(_captures))
    monkeypatch.setattr(preflight, "DEFAULT_RUNGS", (64,))
    monkeypatch.setattr(preflight, "DEFAULT_MESHES", ("1",))
    return _captures


def test_check_sarif_one_run_per_tool(capsys, subset):
    rc, out, err = _check(capsys, "--format", "sarif", "--quick", "--device", "cpu")
    assert rc == 0, err
    doc = json.loads(out)
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-2.1.0.json")
    names = [r["tool"]["driver"]["name"] for r in doc["runs"]]
    assert names == ["simon-lint", "simon-audit", "simon-preflight", "simon-interleave"]
    for run in doc["runs"]:
        assert run["results"] == []          # a clean tree: empty runs
        assert run["columnKind"] == "utf16CodeUnits"
        assert "SRCROOT" in run["originalUriBaseIds"]
    lint_rules = doc["runs"][0]["tool"]["driver"]["rules"]
    assert [r["id"] for r in lint_rules] == [rid for rid, _ in iter_rules()]
    assert all(r["shortDescription"]["text"] == doc_ for r, (_id, doc_) in
               zip(lint_rules, iter_rules()))
    assert doc["runs"][2]["properties"]["programs"] == sorted(
        f"{name}@r64@m1" for name in SUBSET)
    assert "not in the port yet" not in err


def test_check_json_and_text_formats(capsys):
    rc, out, _ = _check(capsys, "--format", "json", "--no-interleave", "--no-invariants",
                        "--no-preflight")
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] is True
    assert set(doc["passes"]) == {"lint", "audit"}
    assert doc["passes"]["audit"]["invariants"] is None
    rc, out, _ = _check(capsys, "--format", "text", "--no-interleave", "--no-races",
                        "--no-invariants", "--no-preflight")
    assert rc == 0 and out.strip().endswith("check: ok")
    assert "simon lint: 0 finding(s)" in out


def test_check_output_file_and_skips(capsys, tmp_path):
    path = tmp_path / "check.sarif"
    rc, out, err = _check(capsys, "--output", str(path), "--no-lint", "--no-interleave",
                          "--no-invariants", "--no-preflight")
    assert rc == 0 and out == ""
    assert f"wrote {path}" in err and "not in the port yet" not in err
    doc = json.loads(path.read_text())
    assert [r["tool"]["driver"]["name"] for r in doc["runs"]] == ["simon-audit"]


def _bad_pkg(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "sanitize.py").write_text("def sanitizable(name):\n    return lambda f: f\n")
    (pkg / "mod.py").write_text(
        "import threading\n"
        "from http.server import BaseHTTPRequestHandler\n"
        "from .sanitize import sanitizable\n"
        "_cache = {}\n"
        "\n"
        "@sanitizable('pkg:kern')\n"
        "def kern(x):\n"
        "    return x.item()\n"
        "\n"
        "class H(BaseHTTPRequestHandler):\n"
        "    def do_GET(self):\n"
        "        _cache[self.path] = 1  # osim: audit-ok[deadlock]\n"
    )
    return pkg


def test_sarif_runs_locate_findings(tmp_path):
    pkg = _bad_pkg(tmp_path)
    lint = run_lint(package_root=str(pkg), report_root=str(tmp_path))
    run = sarif.lint_run(lint)
    (res,) = [r for r in run["results"] if r["ruleId"] == "tracer-coercion"]
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "pkg/mod.py"
    assert loc["region"]["startLine"] == 8 and loc["region"]["startColumn"] == 12
    assert "[via pkg:kern]" in res["message"]["text"]

    from open_simulator_tpu_torch.analysis.audit import SemanticAuditReport

    races = run_races(package_root=str(pkg), report_root=str(tmp_path))
    run = sarif.audit_run(SemanticAuditReport(races=races))
    ids = sorted(r["ruleId"] for r in run["results"])
    assert ids == ["race", "unused-suppression"]
    stale = [r for r in run["results"] if r["ruleId"] == "unused-suppression"][0]
    assert stale["level"] == "warning"
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == {"race", "unused-suppression"}
    doc = sarif.sarif_document([run])
    assert json.loads(json.dumps(doc, sort_keys=True)) == doc


def test_interleave_run_anchors_violations_to_the_ports_modules():
    from open_simulator_tpu_torch.analysis import interleave

    report = interleave.run_interleave(["admission"], quick=True, mutate="lost-ticket")
    run = sarif.interleave_run(report)
    assert run["results"], "the seeded protocol bug must be reported"
    uris = {r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"]
            for r in run["results"]}
    assert uris == {"open_simulator_tpu_torch/server/admission.py"}
    assert set(sarif.SCENARIO_SUBJECTS) == set(interleave.SCENARIOS)


def test_scenario_subjects_mirror_the_reference():
    from open_simulator_tpu.analysis import sarif as ref

    assert set(ref.SCENARIO_SUBJECTS) == set(sarif.SCENARIO_SUBJECTS)
    for name, path in ref.SCENARIO_SUBJECTS.items():
        assert sarif.SCENARIO_SUBJECTS[name] == path.replace(
            "open_simulator_tpu/", "open_simulator_tpu_torch/")
    assert sarif.SARIF_VERSION == ref.SARIF_VERSION == "2.1.0"


@pytest.mark.parametrize("flag", ["--no-lint", "--no-races"])
def test_check_exit_1_on_a_failing_pass(capsys, monkeypatch, flag):
    """A failing pass fails the gate; skipping it clears the failure."""
    from open_simulator_tpu_torch.analysis import audit, lint

    class Bad:
        active = [object()]
        ok = False

    if flag == "--no-lint":
        monkeypatch.setattr(audit, "run_semantic_audit",
                            lambda **kw: type("R", (), {"ok": False, "races": None,
                                                        "to_dict": lambda s: {},
                                                        "render_text": lambda s: ""})())
        skip = "--no-races"
    else:
        real = lint.run_lint
        monkeypatch.setattr(lint, "run_lint", lambda **kw: _failing_lint(real))
        skip = "--no-lint"
    quiet = ("--no-interleave", "--no-invariants", "--no-preflight")
    rc, _, _ = _check(capsys, "--format", "json", *quiet, flag)
    assert rc == 1
    rc, _, _ = _check(capsys, "--format", "json", *quiet, flag, skip)
    assert rc == 0


def _failing_lint(real):
    from open_simulator_tpu_torch.analysis.lint import Finding

    report = real()
    report.findings.append(Finding("tracer-coercion", "x.py", 1, 0, "seeded"))
    return report


@pytest.fixture(autouse=True, scope="module")
def _untraced_allocations():
    """Pause tracemalloc for this file: an earlier file in the same worker
    may have left it tracing (a heap-profile test does), which slows
    Python-heavy tests tens of times."""
    import tracemalloc

    tracing = tracemalloc.is_tracing()
    tracemalloc.stop()
    yield
    if tracing:
        tracemalloc.start()


def test_preflight_cli_exits_0_on_the_book_and_1_on_a_shrunken_one(capsys, subset, tmp_path):
    from open_simulator_tpu_torch.analysis.budget import BudgetBook

    path = str(tmp_path / "preflight_torch.json")
    BudgetBook.load("budgets/preflight_torch.json").save(path)
    argv = ["preflight", "--device", "cpu", "--entries", "ops.kernels:probe_step",
            "--no-transfers", "--no-verdict", "--budgets", path, "--format", "json"]
    assert cli.main(argv) == 0
    captured = capsys.readouterr()
    doc = json.loads(captured.out)
    assert doc["ok"] is True and doc["violations"] == []
    assert [p["key"] for p in doc["programs"]] == ["ops.kernels:probe_step@r64@m1"]
    assert "not in the port yet" not in captured.err
    book = BudgetBook.load(path)
    book.programs["ops.kernels:probe_step@r64@m1"].peak_bytes = 1
    book.slack_bytes = 0
    book.save(path)
    assert cli.main(argv) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [(v["kind"], v["field"]) for v in doc["violations"]] == [("memory", "peak_bytes")]


def test_audit_memory_report_shape(capsys, subset):
    from open_simulator_tpu.analysis.audit import SemanticAuditReport as RefReport

    assert cli.main(["audit", "--memory", "--device", "cpu", "--format", "json"]) == 0
    captured = capsys.readouterr()
    doc = json.loads(captured.out)
    assert set(doc) == set(RefReport(races=None, invariants=None).to_dict())
    assert doc["ok"] is True
    assert doc["invariants"] is not None and doc["invariants"]["ok"] is True
    assert {e["entry"] for e in doc["invariants"]["entries"]} == set(SUBSET)
    assert len(doc["invariants"]["plugins"]) == 10
    mem = doc["memory"]
    assert mem["verdict"] is None and mem["transfers"] == []
    assert {p["key"] for p in mem["programs"]} == {f"{n}@r64@m1" for n in SUBSET}
    assert all(p["ok"] and p["peak_bytes"] > 0 for p in mem["programs"])
    assert "not in the port yet" not in captured.err
