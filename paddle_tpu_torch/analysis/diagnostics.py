"""Structured diagnostics: the one currency every analyzer trades in.

The port of ``paddle_tpu/analysis/diagnostics.py``. The program auditor
(``analysis/auditor.py``), the source linter (``analysis/lint.py``) and
the capture planner (``analysis/capture.py``, ``shapes.py``,
``planner.py``) all emit :class:`Diagnostic` records — rule id, severity, a location
(``file.py:line`` for source rules, a DAG/lock description for runtime
rules), a message and a fix hint — so one reporting surface
(``analysis.report()`` / ``python -m paddle_tpu_torch.analysis``) can
render, count and gate on all of them. Rule metadata lives in
:data:`RULES`, with the JAX package's ids and meanings as the port reads
them; the lock-order rules (PTK) wait for the lock auditor, which the
port does not have (``locks.make_lock`` returns plain locks).

Severity contract: ``error`` = a defect that will corrupt results
(use-after-donate); ``warning`` = a hazard or perf cliff (host sync in a
hot path, capture churn, unguarded registry mutation); ``info`` =
attribution the capture report enumerates without judgement.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["Diagnostic", "RuleInfo", "RULES", "severity_rank"]

_SEVERITIES = ("error", "warning", "info")


def severity_rank(severity: str) -> int:
    """error < warning < info (sortable: most severe first)."""
    try:
        return _SEVERITIES.index(severity)
    except ValueError:
        return len(_SEVERITIES)


@dataclass(frozen=True)
class RuleInfo:
    id: str
    analyzer: str       # "audit" | "lint" | "capture"
    severity: str       # default severity of findings
    title: str
    description: str


# The closed rule universe. PTA* = program auditor (runtime capture),
# PTL* = source linter (AST), PTC* = static capture planner (graph-break
# analysis + shape/dtype abstract interpretation).
# tests/test_torch_analysis.py seeds one bug per detection rule and
# asserts the exact id.
RULES: Dict[str, RuleInfo] = {r.id: r for r in [
    RuleInfo(
        "PTA001", "audit", "warning", "implicit host sync",
        "A device→host read inside the audited region: a Tensor's "
        ".numpy()/.item()/.tolist()/__array__ (core.tensor._sync_hook) "
        "and, on the card, any synchronizing torch call "
        "(torch.cuda.set_sync_debug_mode: .cpu(), .item(), nonzero ...). "
        "Each one stalls the host on the card, and none can live inside "
        "a CUDA graph. The capture report attributes every sync to its "
        "call site."),
    RuleInfo(
        "PTA002", "audit", "error", "use-after-donate",
        "A live Tensor handle still references a buffer that was donated "
        "to a jitted executable. The port never donates a buffer (CUDA "
        "graphs read and write their static buffers in place), so the "
        "rule has nothing to check there and never fires; it stays in "
        "the table for the JAX ids."),
    RuleInfo(
        "PTA003", "audit", "warning", "recompile churn",
        "A CUDA graph was captured during the measured (post-warmup) "
        "run (CapturedStep, an SOT segment, capture_jit): shape-"
        "polymorphic call sites or churning signatures. Steady-state "
        "steps replay; every capture here is a slow eager-plus-capture "
        "step."),
    RuleInfo(
        "PTL001", "lint", "warning", "implicit host sync in library code",
        "A .numpy()/.item()/.tolist()/.cpu() call inside "
        "paddle_tpu_torch/ library code (on a Tensor or a raw torch "
        "tensor): a hidden device→host sync on what may be a hot path. "
        "Deliberate syncs (host-static structure, user-facing host APIs, "
        "the one read a decode step makes) belong in the allowlist with "
        "a justification."),
    RuleInfo(
        "PTL002", "lint", "warning", "registered flag never read",
        "A FLAGS_* registered in core/flags.py (or a late define_flag) "
        "with no read anywhere in the package: either dead surface or a "
        "flag that silently does nothing the docs claim it does."),
    RuleInfo(
        "PTL003", "lint", "warning", "unguarded global registry mutation",
        "A structural mutation (del/pop/clear/eviction loop) of a "
        "module-level registry outside any lock: concurrent dispatch "
        "threads can corrupt iteration or drop entries mid-sweep. "
        "Single-assignment memo inserts are GIL-atomic and not flagged."),
    RuleInfo(
        "PTL004", "lint", "error", "bare except",
        "A bare `except:` swallows KeyboardInterrupt/SystemExit AND the "
        "fault-injection harness's BaseException kill-points — device "
        "code wrapped in one can absorb the very crash a test injects."),
    RuleInfo(
        "PTL005", "lint", "error", "ops.yaml fusable marker inconsistent",
        "An op marked `fusable:` in ops.yaml with no matching "
        "register_impl/register_param_impl registration (or a "
        "registration for an op ops.yaml doesn't mark): the fusion "
        "plane would silently never fuse it. Waits for core/fusion.py, "
        "which the port does not have (CUDA graphs do its job): the "
        "rule does not run in the port."),
    RuleInfo(
        "PTC001", "capture", "warning", "data-dependent control flow",
        "An `if`/`while` whose test reads a tensor VALUE (`if t:`, "
        "`while t.item()`, a comparison on a tensor feeding the "
        "branch): every taken branch becomes a guard + graph break in "
        "whole-step capture — the trace tree grows one compiled path "
        "per branch outcome. Shape/ndim/dtype reads are static "
        "metadata and are not flagged."),
    RuleInfo(
        "PTC002", "capture", "warning", "capture-poisoning side effect",
        "A side effect inside the candidate capture region that replay "
        "cannot reproduce: in-place tensor mutation, RNG consumption "
        "(dropout and friends), mutation of module/global/self state, "
        "or host I/O. jit/sot.py marks such recordings non-replayable "
        "at runtime (the call stays eager forever); this flags them "
        "before tracing is even attempted."),
    RuleInfo(
        "PTC003", "capture", "warning", "host read inside the step",
        "A device->host fetch (.item()/.numpy()/.tolist()/float()) "
        "inside the candidate region. When it postdominates all device "
        "work it is HOISTABLE (fix hint: move it after the step / "
        "batch the fetch); mid-step reads serialize dispatch and must "
        "become capture guards or move."),
    RuleInfo(
        "PTC004", "capture", "warning", "shape-polymorphic call site",
        "A call site whose tensor shapes vary run-to-run (boolean-mask "
        "indexing, nonzero/unique/masked_select, or PTA003 churn rows "
        "from the dynamic audit): each distinct shape compiles a new "
        "executable. Needs a BucketPolicy so varlen inputs share a "
        "bounded set of compiled entries."),
    RuleInfo(
        "PTC005", "capture", "error", "ops.yaml shape spec inconsistent",
        "An op's declared `shape:` spec disagrees with the port's live "
        "op on sample inputs (run on meta tensors), or a fusable op "
        "carries no spec / a spec decorates a non-fusable op — the "
        "abstract interpreter would plan capture regions from wrong "
        "shape/dtype arithmetic (the PTL005 pattern, for shapes)."),
]}


@dataclass
class Diagnostic:
    """One finding. ``location`` is ``path:line`` for source rules, a
    runtime description (``capture: CapturedStep train``) otherwise."""

    rule: str
    location: str
    message: str
    severity: Optional[str] = None   # default: the rule's severity
    hint: str = ""
    data: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.severity is None:
            info = RULES.get(self.rule)
            self.severity = info.severity if info else "warning"

    def to_dict(self) -> Dict[str, Any]:
        d = {"rule": self.rule, "severity": self.severity,
             "location": self.location, "message": self.message}
        if self.hint:
            d["hint"] = self.hint
        if self.data:
            d["data"] = self.data
        return d

    def render(self) -> str:
        hint = f"\n      hint: {self.hint}" if self.hint else ""
        return (f"  [{self.rule}/{self.severity}] {self.location}: "
                f"{self.message}{hint}")


def sort_diagnostics(diags: List[Diagnostic]) -> List[Diagnostic]:
    return sorted(diags, key=lambda d: (severity_rank(d.severity),
                                        d.rule, d.location))
