"""The capture planner: one ranked plan from the static PTC pass + the
dynamic capture audit.

The port of ``paddle_tpu/analysis/planner.py``. In the port a captured
program is a CUDA graph (``CapturedStep``, an SOT segment,
``capture_jit``), and the dynamic breaks are the auditor's: fallbacks
to eager by reason, SOT guard misses and host syncs.

``capture_plan(fn)`` composes three inputs:

1. **Static graph-break scan** (:mod:`.capture`) of ``fn``'s source —
   sees every branch, including paths a recording never executed.
2. **Dynamic capture audit** (:mod:`.auditor`) — one measured run's
   breaks (reason + origin), host syncs and captures in the measured
   window. Every dynamic event origin is then *closed over
   statically*: the planner locates the enclosing function of each
   origin and scans it too, so a sync attributed to
   ``serving.py:1390`` is covered by a PTC diagnostic at that line.
3. **SOT segment metadata** (:meth:`SOTFunction.capture_metadata`) when
   ``fn`` is already a traced function — recorded segments and guards
   are the ground-truth segmentation the plan refines.

The product is a **break table** ranked by measured cost (how often
the site broke in the measured step) where every row is classified:

- ``compatible`` — not a break of the step's source: a gate of the
  engine (``"device"``: the CPU has no CUDA graphs; a per-parameter
  optimizer; a hook) that the card or a configuration decides, or a
  checked-in CAPTURE_ALLOWLIST entry explains it;
- ``hoist`` — a host read that postdominates device work, with the
  "move after step" fix (PTC003);
- ``guard`` — a data-dependent branch / mid-step read the SOT trace
  must guard (PTC001/PTC003);
- ``bucket`` — a site that captured in the measured window, needing a
  BucketPolicy (PTC004, synthesized from PTA003 churn rows with the
  bounded-programs count from :mod:`.shapes`);
- ``side_effect`` — a PTC002 hazard that forces a region cut;
- ``unaccounted`` — a dynamic break no static finding covers: the plan
  is not trustworthy until it is (the consistency contract
  ``CapturePlan.consistent()`` that tests pin).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

from .diagnostics import Diagnostic, sort_diagnostics
from .capture import (REPO_STEPS, apply_allowlist, capture_scan,
                      enclosing_function_scan, scan_file_function)
from .lint import REPO_ROOT

__all__ = ["CapturePlan", "capture_plan", "plan_repo_steps"]

# fallback reasons that are gates of the engine, not breaks in the
# step's source: the capture is decided by the device or configuration
_ABSORBED = {
    "device": "engine gate: the CPU has no CUDA graphs; the card "
              "captures this step",
    "optimizer": "engine gate: a per-parameter optimizer (or "
                 "FLAGS_fused_optimizer=0) runs eager by design",
    "hooks": "engine gate: gradient hooks run eager by design",
    "param_set": "engine gate: the parameter set changed; the next "
                 "signature captures again",
    "param_static": "engine gate: a parameter moved; the next sighting "
                    "captures again",
    "pending_grads": "engine gate: gradients left from an earlier "
                     "backward run eager by design",
    "guard_budget": "engine gate: the guard bytes exceed the budget",
    "backward": "SOT records no inner backward: the whole step "
                "(CapturedStep) owns it",
}
# fallback reasons a static finding must explain
_SOURCE_REASONS = ("rng", "mutation", "unrecorded", "guard")


def _file_match(a: str, b: str) -> bool:
    """Do two (possibly differently-shortened) file paths name the same
    file? Dynamic origins carry the last two components; static
    locations are repo-relative."""
    a, b = a.split(":")[0], b.split(":")[0]
    return a == b or a.endswith("/" + b) or b.endswith("/" + a)


def _origin_to_path(origin: str) -> Optional[str]:
    """Resolve a dynamic origin ('serving.py:1390') to a real file."""
    rel = origin.rsplit(":", 1)[0]
    for cand in (os.path.join(REPO_ROOT, "paddle_tpu_torch", rel),
                 os.path.join(REPO_ROOT, rel),
                 os.path.join(REPO_ROOT, os.path.basename(rel))):
        if os.path.exists(cand):
            return cand
    return None


def _origin_line(origin: str) -> int:
    tail = origin.rsplit(":", 1)[-1]
    return int(tail) if tail.isdigit() else -1


class CapturePlan:
    """The segmentation proposal. ``breaks`` is the ranked work list;
    ``regions`` the per-function capture segments between breaks;
    ``diagnostics`` every static + synthesized finding."""

    def __init__(self):
        self.static_diags: List[Diagnostic] = []
        self.suppressed: List[Tuple[Diagnostic, str]] = []
        self.synthesized: List[Diagnostic] = []   # PTC004 from PTA003
        self.capture = None                       # dynamic CaptureReport
        self.functions: List[Dict[str, Any]] = []
        self.breaks: List[Dict[str, Any]] = []
        self.regions: List[Dict[str, Any]] = []
        self.sot: Optional[Dict[str, Any]] = None

    @property
    def diagnostics(self) -> List[Diagnostic]:
        return sort_diagnostics(self.static_diags + self.synthesized)

    def unaccounted(self) -> List[Dict[str, Any]]:
        return [b for b in self.breaks
                if b["classification"] == "unaccounted"]

    def consistent(self) -> bool:
        """The acceptance contract: every dynamic host sync and flush
        boundary is either covered by a PTC diagnostic with a fix hint
        or explicitly classified capture-compatible."""
        return not self.unaccounted()

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "breaks": self.breaks,
            "regions": self.regions,
            "diagnostics": [x.to_dict() for x in self.diagnostics],
            "suppressed": [{"rule": x.rule, "location": x.location,
                            "reason": why}
                           for x, why in self.suppressed],
            "consistent": self.consistent(),
        }
        if self.capture is not None:
            d["dynamic"] = {"break_sites": self.capture.flush_sites(),
                            "syncs": len(self.capture.syncs),
                            "captures": len(self.capture.captures)}
        if self.sot is not None:
            d["sot"] = self.sot
        return d

    def render(self) -> str:
        lines = ["capture plan", "=" * 12]
        if self.breaks:
            lines.append(
                "  breaks (ranked by measured cost; each row is a "
                "capture work item):")
            for b in self.breaks:
                cnt = b["count"]
                lines.append(
                    f"  #{b['rank']:<3}{b['site']:<44} "
                    f"{b['reason']:<16} x{cnt:<5} {b['classification']}")
                if b.get("fix"):
                    lines.append(f"        fix: {b['fix']}")
        else:
            lines.append("  breaks: none — the step captures whole")
        for r in self.regions:
            lines.append(
                f"  region {r['index']}: {r['function']} "
                f"[{r['file']}:{r['from_line']}-{r['to_line']}] "
                f"guards={len(r['guards'])} hoists={len(r['hoists'])}")
        if self.sot is not None:
            n_paths = len(self.sot.get("paths", []))
            lines.append(f"  sot: {n_paths} recorded path(s), "
                         f"fallback reasons "
                         f"{self.sot.get('fallback_reasons', {})}")
        if self.suppressed:
            lines.append("  capture-compatible by allowlist:")
            for d, why in self.suppressed:
                lines.append(f"    {d.rule} @ {d.location} — {why}")
        lines.append(f"  consistent: {self.consistent()}   "
                     f"diagnostics: {len(self.diagnostics)}   "
                     f"unaccounted: {len(self.unaccounted())}")
        return "\n".join(lines)


def _classify(d: Diagnostic) -> str:
    """Break classification for a static PTC finding — the ONE mapping
    both the dynamic-match path and the static-only rows use."""
    if d.rule == "PTC002":
        return "side_effect"
    if d.rule == "PTC004":
        return "bucket"
    if d.rule == "PTC003" and d.data.get("hoistable"):
        return "hoist"
    return "guard"  # PTC001, or a mid-step PTC003 read


def _match_static(plan: CapturePlan, origin: str):
    """Find the static finding covering a dynamic origin: exact
    file:line first, then any PTC diag inside the enclosing scanned
    function span. Searches suppressed (allowlisted) findings too —
    they classify the row as compatible."""
    line = _origin_line(origin)

    def hit(d: Diagnostic) -> bool:
        if not _file_match(d.location, origin):
            return False
        dline = _origin_line(d.location)
        if dline == line:
            return True
        for meta in plan.functions:
            lo, hi = meta["span"]
            if _file_match(meta["file"], origin) and lo <= line <= hi \
                    and lo <= dline <= hi:
                return True
        return False

    for d in plan.static_diags:
        if hit(d):
            return d, None
    for d, why in plan.suppressed:
        if hit(d):
            return d, why
    return None, None


def _scan_into(plan: CapturePlan, diags, meta, use_allowlist: bool):
    kept, supp = apply_allowlist(
        diags, (meta or {}).get("pragmas"), use_allowlist)
    plan.static_diags.extend(kept)
    plan.suppressed.extend(supp)
    if meta is not None:
        plan.functions.append(meta)


def capture_plan(fn: Optional[Callable] = None, *args,
                 warmup: int = 2, dynamic: bool = True,
                 use_allowlist: bool = True, **kwargs) -> CapturePlan:
    """Plan whole-step capture for ``fn`` (a train/decode step
    callable). ``dynamic=False`` skips running the function (static
    scan only — the CLI's mode). See module docstring for the merge
    semantics."""
    plan = CapturePlan()
    # dedupe scans by (file, span): the two scan paths name functions
    # differently (__qualname__ vs bare def name), but a source span
    # is unambiguous
    scanned_spans = set()
    if fn is not None:
        try:
            diags, meta = capture_scan(fn)
            _scan_into(plan, diags, meta, use_allowlist)
            scanned_spans.add((meta["file"], tuple(meta["span"])))
        except ValueError:
            pass  # no source (builtin/C callable): dynamic-only plan
    if fn is not None and dynamic:
        from .auditor import audit
        plan.capture = audit(fn, *args, warmup=warmup, **kwargs)
        # close dynamic origins over statically: scan every enclosing
        # function the audit attributed an event to
        origins = [ev["origin"] for ev in plan.capture.syncs]
        origins += [ev["origin"] for ev in plan.capture.breaks
                    if ev["reason"] in _SOURCE_REASONS]
        for origin in dict.fromkeys(origins):
            path = _origin_to_path(origin)
            line = _origin_line(origin)
            if path is None or line < 0:
                continue
            diags, meta = enclosing_function_scan(path, line)
            if meta is None:
                continue
            key = (meta["file"], tuple(meta["span"]))
            if key in scanned_spans:
                continue
            scanned_spans.add(key)
            _scan_into(plan, diags, meta, use_allowlist)
        _merge_dynamic(plan)
    # SOT segment/guard metadata, when fn is a traced function
    md = getattr(fn, "capture_metadata", None)
    if callable(md):
        try:
            plan.sot = md()
        except Exception:  # noqa: BLE001 — metadata is best-effort
            plan.sot = None
    _build_static_breaks(plan)
    _rank(plan)
    _build_regions(plan)
    _count_metrics(plan)
    return plan


def _merge_dynamic(plan: CapturePlan) -> None:
    rep = plan.capture
    for row in rep.flush_sites(top_n=10 ** 9):
        site, reason, count = row["site"], row["reason"], row["count"]
        entry = {"site": site, "reason": reason, "count": count,
                 "rule": None, "fix": None}
        if reason in _ABSORBED:
            entry["classification"] = "compatible"
            entry["fix"] = _ABSORBED[reason]
        elif reason in _SOURCE_REASONS:
            d, why = _match_static(plan, site)
            if d is None:
                entry["classification"] = "unaccounted"
                entry["fix"] = ("no static finding covers this break — "
                                "scan the enclosing code or extend the "
                                "PTC detectors")
            else:
                entry["rule"] = d.rule
                if why is not None:
                    entry["classification"] = "compatible"
                    entry["fix"] = f"allowlisted: {why}"
                else:
                    entry["classification"] = _classify(d)
                    entry["fix"] = d.hint
        else:
            entry["classification"] = "unaccounted"
            entry["fix"] = f"an eager fallback ({reason}) the planner " \
                           f"does not know"
        plan.breaks.append(entry)
    for site, count in sorted(rep.sync_sites().items()):
        d, why = _match_static(plan, site)
        entry = {"site": site, "reason": "host_sync", "count": count,
                 "rule": d.rule if d else None}
        if d is None:
            entry["classification"] = "unaccounted"
            entry["fix"] = "no static finding covers this sync"
        elif why is not None:
            entry["classification"] = "compatible"
            entry["fix"] = f"allowlisted: {why}"
        else:
            entry["classification"] = _classify(d)
            entry["fix"] = d.hint
        plan.breaks.append(entry)
    # PTA003 churn -> PTC004 bucket rows (the dynamic cross-check)
    from .shapes import bucketed_leaf_signatures
    pow2_bound = len(bucketed_leaf_signatures((1,), {0: "pow2"}, 4096))
    for d in rep.diagnostics:
        if d.rule != "PTA003":
            continue
        syn = Diagnostic(
            "PTC004", d.location,
            f"a capture in the measured window (dynamic audit: "
            f"{d.message})",
            hint=f"declare a BucketPolicy on the varying axis — e.g. "
                 f"pow2 buckets cap the captured programs at "
                 f"{pow2_bound} for sizes <= 4096, against one per "
                 f"distinct size",
            data={"from": "PTA003"})
        plan.synthesized.append(syn)
        plan.breaks.append({
            "site": d.location, "reason": "capture_churn",
            "count": 0, "rule": "PTC004",
            "classification": "bucket", "fix": syn.hint})


def _build_static_breaks(plan: CapturePlan) -> None:
    """Static findings with no dynamic row (paths the measured run
    never took) still enter the break table — that is the static
    pass's whole value — at count 0."""
    for d in plan.static_diags:
        line = _origin_line(d.location)
        if any(_file_match(d.location, b["site"])
               and _origin_line(b["site"]) == line
               for b in plan.breaks):
            continue
        plan.breaks.append({
            "site": d.location, "reason": "static", "count": 0,
            "rule": d.rule, "classification": _classify(d),
            "fix": d.hint})


def _rank(plan: CapturePlan) -> None:
    plan.breaks.sort(
        key=lambda b: (-b["count"],
                       b["classification"] == "compatible",
                       b["site"]))
    for i, b in enumerate(plan.breaks):
        b["rank"] = i + 1


def _build_regions(plan: CapturePlan) -> None:
    """Per scanned function: the capture segments between its
    non-compatible breaks, with the guards/hoists each needs."""
    for idx, meta in enumerate(plan.functions):
        lo, hi = meta["span"]
        inside = [b for b in plan.breaks
                  if _file_match(b["site"], meta["file"])
                  and lo <= _origin_line(b["site"]) <= hi
                  and b["classification"] not in ("compatible",)]
        guards = [b for b in inside
                  if b["classification"] in ("guard", "bucket")]
        hoists = [b for b in inside if b["classification"] == "hoist"]
        cuts = [b for b in inside
                if b["classification"] == "side_effect"]
        plan.regions.append({
            "index": idx, "file": meta["file"],
            "function": meta["function"],
            "from_line": lo, "to_line": hi,
            "segments": len(cuts) + len(guards) + 1,
            "guards": [b["site"] for b in guards],
            "hoists": [b["site"] for b in hoists],
            "cuts": [b["site"] for b in cuts]})


def _count_metrics(plan: CapturePlan) -> None:
    try:
        from ..observability import metrics as _om
        _om.counter("analysis.capture_plans_total",
                    "Capture plans produced by the analysis plane").inc()
        cd = _om.counter(
            "analysis.diagnostics_total",
            "Diagnostics emitted by the analysis plane, by rule")
        for d in plan.diagnostics:
            cd.inc(rule=d.rule)
    except Exception:  # noqa: BLE001 — planning must work standalone
        pass


def plan_repo_steps(use_allowlist: bool = True) -> CapturePlan:
    """Static-only plan over the port's own step functions (the
    ``--capture-plan`` CLI default: no model run, just the source
    truth)."""
    plan = CapturePlan()
    for rel, qual, params in REPO_STEPS:
        path = os.path.join(REPO_ROOT, rel)
        if not os.path.exists(path):
            continue
        diags, meta = scan_file_function(path, qual, params)
        _scan_into(plan, diags, meta, use_allowlist)
    _build_static_breaks(plan)
    _rank(plan)
    _build_regions(plan)
    _count_metrics(plan)
    return plan
