"""paddle_tpu_torch.analysis — static analysis and program auditing.

The port of ``paddle_tpu.analysis``, over one diagnostics currency
(:mod:`.diagnostics`):

- :mod:`.auditor` — run a callable in recording mode; a capture report
  of its breaks (fallbacks to eager by reason, SOT guard misses), host
  syncs by call site and captures in the measured window (PTA00x);
- :mod:`.lint` — the AST source linter (PTL001–004) with the port's
  checked-in, justified allowlist (:mod:`.allowlist`);
- :mod:`.capture` + :mod:`.shapes` + :mod:`.planner` — the static
  capture planner: graph-break AST analysis (PTC00x), the ``ops.yaml``
  shape specs graded against the live ops on meta tensors, and
  :func:`capture_plan` merging both with the dynamic audit and
  ``SOTFunction.capture_metadata``;
- :mod:`.locks` — the lock factory (the lock-order auditor is not
  ported).

One reporting surface: :func:`report`, or ``python -m
paddle_tpu_torch.analysis``. This ``__init__`` is light by contract:
subsystems import ``analysis.locks.make_lock`` at module load.
"""
from __future__ import annotations

__all__ = ["audit", "lint", "report", "AnalysisReport", "RULES",
           "capture_plan", "CapturePlan"]

# bound eagerly after their submodules (a submodule import would
# otherwise shadow a lazy name); both are stdlib-only
from .lint import lint            # noqa: E402,F401
from .report import report        # noqa: E402,F401

_LAZY = {
    "audit": (".auditor", "audit"),
    "Auditor": (".auditor", "Auditor"),
    "CaptureReport": (".auditor", "CaptureReport"),
    "RULES": (".diagnostics", "RULES"),
    "Diagnostic": (".diagnostics", "Diagnostic"),
    "AnalysisReport": (".report", "AnalysisReport"),
    "self_check": (".report", "self_check"),
    "capture_plan": (".planner", "capture_plan"),
    "CapturePlan": (".planner", "CapturePlan"),
    "plan_repo_steps": (".planner", "plan_repo_steps"),
    "capture_scan": (".capture", "capture_scan"),
    "scan_repo_steps": (".capture", "scan_repo_steps"),
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    val = getattr(importlib.import_module(entry[0], __name__), entry[1])
    globals()[name] = val
    return val


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
