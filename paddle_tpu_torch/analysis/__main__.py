"""``python -m paddle_tpu_torch.analysis`` — the analysis plane's CLI.

Default: lint the port and print the report (exit 1 on error-severity
findings — the contract tests/test_torch_lint_clean.py holds
in-process).

Options:
  --self-check    seed one bug per analyzer, check each rule fires;
                  exit 1 on failure
  --rules         print the rule table (ids, analyzers, severities)
  --capture-plan  static capture plan over the port's own step
                  functions (hapi train/eval step, the serving engine's
                  step methods and programs, TrainStep, GradScaler) —
                  the capture work list; exit 1 on unaccounted breaks or
                  error-severity findings
  --json          emit the report/plan as JSON instead of text
"""
from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--rules" in argv:
        from .report import rules_table
        print(rules_table())
        return 0
    if "--self-check" in argv:
        from .report import self_check
        return 0 if self_check(verbose=True)["ok"] else 1
    if "--capture-plan" in argv:
        from .planner import plan_repo_steps
        plan = plan_repo_steps()
        if "--json" in argv:
            print(json.dumps(plan.to_dict(), indent=2, default=str))
        else:
            print(plan.render())
        bad = not plan.consistent() or any(
            d.severity == "error" for d in plan.diagnostics)
        return 1 if bad else 0
    from .report import report
    rep = report()
    if "--json" in argv:
        print(json.dumps(rep.to_dict(), indent=2, default=str))
    else:
        print(rep.render())
    return 1 if rep.errors else 0


if __name__ == "__main__":
    sys.exit(main())
