"""One reporting surface over the analyzers.

The port of ``paddle_tpu/analysis/report.py``. ``report()`` composes a
capture audit (when given a callable) and a full source-lint pass into
one :class:`AnalysisReport` with a single ``diagnostics`` list and a
text / dict rendering. ``self_check()`` seeds one bug per analyzer
(lint, audit, the capture scan, the shape specs) and checks that each
is detected by its rule id.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .diagnostics import Diagnostic, RULES, sort_diagnostics

__all__ = ["AnalysisReport", "report", "self_check", "rules_table"]


class AnalysisReport:
    def __init__(self, capture=None, lint_result=None):
        self.capture = capture
        self.lint = lint_result

    @property
    def diagnostics(self) -> List[Diagnostic]:
        out: List[Diagnostic] = []
        if self.capture is not None:
            out.extend(self.capture.diagnostics)
        if self.lint is not None:
            out.extend(self.lint.diagnostics)
        return sort_diagnostics(out)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "diagnostics": [x.to_dict() for x in self.diagnostics]}
        if self.capture is not None:
            d["capture"] = self.capture.to_dict()
        if self.lint is not None:
            d["lint"] = {
                "files_scanned": self.lint.files_scanned,
                "findings": len(self.lint.diagnostics),
                "allowlisted": len(self.lint.suppressed),
            }
        return d

    def render(self) -> str:
        parts = ["paddle_tpu_torch.analysis report", "=" * 32]
        if self.capture is not None:
            parts.append(self.capture.render())
        if self.lint is not None:
            parts.append(self.lint.render())
        parts.append(f"total: {len(self.diagnostics)} diagnostic(s), "
                     f"{len(self.errors)} error(s)")
        return "\n".join(parts)


def report(fn: Optional[Callable] = None, *args, lint: bool = True,
           warmup: int = 2, **kwargs) -> AnalysisReport:
    """With ``fn``, a capture audit of ``fn(*args, **kwargs)``; with
    ``lint=True`` (default) also the source linter over
    ``paddle_tpu_torch/``."""
    capture = None
    if fn is not None:
        from .auditor import audit
        capture = audit(fn, *args, warmup=warmup, **kwargs)
    lint_result = None
    if lint:
        from .lint import lint as _lint
        lint_result = _lint()
    return AnalysisReport(capture, lint_result)


def rules_table() -> str:
    lines = ["rule    analyzer  severity  title", "-" * 64]
    for rid, info in sorted(RULES.items()):
        lines.append(f"{rid:<7} {info.analyzer:<9} {info.severity:<9} "
                     f"{info.title}")
    return "\n".join(lines)


def self_check(verbose: bool = False) -> Dict[str, Any]:
    """Seed one bug per analyzer and check that its rule fires. Returns
    ``{"ok": bool, "checks": {name: bool}, "detail": str}`` (about a
    second on the CPU)."""
    checks: Dict[str, bool] = {}
    details: List[str] = []

    # 1) lint: a bare except and an unguarded registry sweep
    try:
        from .lint import lint_source
        rules = {d.rule for d in lint_source(
            "REG = {}\n"
            "def evict():\n"
            "    REG.clear()\n"
            "    try:\n"
            "        pass\n"
            "    except:\n"
            "        pass\n")}
        checks["lint"] = {"PTL003", "PTL004"} <= rules
        if not checks["lint"]:
            details.append(f"lint fired {sorted(rules)}, wanted "
                           f"PTL003+PTL004")
    except Exception as e:  # noqa: BLE001 — a crash IS the failure
        checks["lint"] = False
        details.append(f"lint self-check crashed: {e!r}")

    # 2) auditor: a host read in a step is a PTA001 at its call site
    try:
        import numpy as np
        from .auditor import audit
        from ..core.tensor import to_tensor

        def step():
            x = to_tensor(np.ones((4, 4), np.float32), place="cpu")
            y = (x * 2.0 + 1.0).sum()
            return float(y.item())  # lint-allow: PTL001 seeded bug

        rep = audit(step, warmup=1)
        checks["audit"] = (
            any(d.rule == "PTA001" for d in rep.diagnostics)
            and all(s["origin"].startswith("analysis/report.py:")
                    for s in rep.syncs))
        if not checks["audit"]:
            details.append(f"audit: syncs {rep.sync_sites()}")
    except Exception as e:  # noqa: BLE001
        checks["audit"] = False
        details.append(f"audit self-check crashed: {e!r}")

    # 3) capture scan: one seeded break per PTC rule
    try:
        from .capture import scan_source
        rules = {d.rule for d in scan_source(
            "def step(x):\n"
            "    import paddle_tpu_torch as paddle\n"
            "    t = paddle.multiply(x, 2.0)\n"
            "    if t.sum().item() > 0:\n"          # PTC001
            "        t = paddle.add(t, 1.0)\n"
            "    t[0] = 0.0\n"                      # PTC002
            "    mask = t > 0.5\n"
            "    sel = t[mask]\n"                   # PTC004
            "    return sel.cpu()\n")}              # PTC003
        want = {"PTC001", "PTC002", "PTC003", "PTC004"}
        checks["capture"] = want <= rules
        if not checks["capture"]:
            details.append(f"capture fired {sorted(rules)}, wanted "
                           f"{sorted(want)}")
    except Exception as e:  # noqa: BLE001
        checks["capture"] = False
        details.append(f"capture self-check crashed: {e!r}")

    # 4) shape specs: sum graded as elementwise must fail as PTC005,
    #    the declared spec must pass
    try:
        from .shapes import validate_op
        seeded = validate_op("sum", "elementwise")
        clean = validate_op("sum")
        checks["shapes"] = (
            any(d.rule == "PTC005" for d in seeded) and not clean)
        if not checks["shapes"]:
            details.append(f"shapes: seeded={[d.rule for d in seeded]}, "
                           f"clean={[d.rule for d in clean]}")
    except Exception as e:  # noqa: BLE001
        checks["shapes"] = False
        details.append(f"shapes self-check crashed: {e!r}")

    ok = all(checks.values())
    out = {"ok": ok, "checks": checks, "detail": "; ".join(details)}
    if verbose:
        print(f"analysis self-check: {'OK' if ok else 'FAIL'} "
              + " ".join(f"{k}={'ok' if v else 'FAIL'}"
                         for k, v in checks.items())
              + (f" ({out['detail']})" if details else ""))
    return out
