"""Static analysis of the port: the AST lint pass (analysis/lint.py and
analysis/rules/), the race and deadlock detector (races.py), the op census
and recompile guard (op_audit.py), the entry registry (entry_audit.py) and
the concurrency model checker (interleave.py). The AST passes import no
torch."""

from .lint import Finding, LintReport, iter_rules, run_lint

__all__ = ["Finding", "LintReport", "iter_rules", "run_lint"]
