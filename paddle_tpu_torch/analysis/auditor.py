"""Program auditor: run a callable in recording mode and produce a
*capture report* — where and why a step leaves its captured program.

The port of ``paddle_tpu/analysis/auditor.py``. The JAX auditor reads
the lazy-fusion engine's flush boundaries; the port has no fusion
engine, and its breaks are its own (``jit/sot.py``'s ``_break_observer``):

- **Host syncs** — every Tensor read to the host (``numpy``, ``item``,
  ``tolist``, ``__array__``) through ``core.tensor._sync_hook``, and on
  the card every synchronizing torch call too: the measured run goes
  under ``torch.cuda.set_sync_debug_mode("warn")`` (armed outside any
  capture), whose warnings name the call site. Reads of a Tensor that
  the hook already saw are not counted twice. → **PTA001**.
- **Breaks** — a ``CapturedStep`` / ``StaticFunction`` / ``capture_jit``
  step that fell back to eager, by reason (``"device"``, ``"rng"``,
  ``"optimizer"`` ...), an SOT recording that stayed eager, an SOT
  guard miss, each with its call site: the port's flush boundaries.
- **Captures** — a CUDA graph captured inside the measured window
  (a step, an SOT segment, a ``capture_jit`` program): a steady-state
  step replays, so each one is churn → **PTA003**.

The JAX auditor's donations have no counterpart: the port never
donates a buffer, so PTA002 has nothing to check (it stays in the rule
table).

Protocol: ``audit(fn)`` runs ``fn`` ``warmup`` times (default 2: a
signature's first sighting runs eager and its second captures), then
records ONE measured run.
"""
from __future__ import annotations

import gc
import warnings
from typing import Any, Callable, Dict, List

from .diagnostics import Diagnostic, sort_diagnostics
from .locks import caller_site

__all__ = ["Auditor", "CaptureReport", "audit"]

_SKIP_SUFFIXES = ("analysis/auditor.py", "analysis/locks.py",
                  "core/tensor.py", "core/autograd.py", "jit/sot.py",
                  "jit/api.py", "contextlib.py", "warnings.py")
_SYNC_WARNING = "synchronizing"


def _origin() -> str:
    """``pkg/file.py:line`` of the nearest frame outside the recording
    machinery."""
    return caller_site(_SKIP_SUFFIXES)


def _short(path: str, line: int) -> str:
    parts = path.replace("\\", "/").split("/")
    return f"{'/'.join(parts[-2:])}:{line}"


class CaptureReport:
    """Everything one measured run revealed. ``diagnostics`` carry the
    judgement; the event lists carry the attribution."""

    def __init__(self):
        self.breaks: List[Dict[str, Any]] = []
        self.syncs: List[Dict[str, Any]] = []
        self.captures: List[Dict[str, Any]] = []
        self.diagnostics: List[Diagnostic] = []
        self.warmup_runs = 0
        self.result: Any = None

    def flush_sites(self, top_n: int = 10) -> List[Dict[str, Any]]:
        """Top-N (origin, reason) break sites by count."""
        agg: Dict[tuple, int] = {}
        for ev in self.breaks:
            key = (ev["origin"], ev["reason"])
            agg[key] = agg.get(key, 0) + 1
        rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top_n]
        return [{"site": k[0], "reason": k[1], "count": v}
                for k, v in rows]

    def sync_sites(self) -> Dict[str, int]:
        """Host syncs by call site."""
        out: Dict[str, int] = {}
        for ev in self.syncs:
            out[ev["origin"]] = out.get(ev["origin"], 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "breaks": self.breaks,
            "flush_sites": self.flush_sites(),
            "syncs": self.syncs,
            "sync_sites": self.sync_sites(),
            "captures": self.captures,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def render(self) -> str:
        lines = ["capture report",
                 f"  breaks: {len(self.breaks)}   host syncs: "
                 f"{len(self.syncs)}   captures in the measured window: "
                 f"{len(self.captures)}"]
        if self.breaks:
            lines.append("  top break sites (site, reason, count):")
            for row in self.flush_sites():
                lines.append(f"    {row['site']:<46} {row['reason']:<18} "
                             f"x{row['count']}")
        if self.syncs:
            lines.append("  host syncs:")
            agg: Dict[tuple, int] = {}
            for ev in self.syncs:
                agg[(ev["origin"], ev["kind"])] = \
                    agg.get((ev["origin"], ev["kind"]), 0) + 1
            for (site, kind), n in sorted(agg.items(),
                                          key=lambda kv: -kv[1]):
                lines.append(f"    {site:<46} {kind:<12} x{n}")
        if self.diagnostics:
            lines.append("  diagnostics:")
            for d in self.diagnostics:
                lines.append(d.render())
        else:
            lines.append("  diagnostics: none")
        return "\n".join(lines)


class Auditor:
    """Context manager that installs the recording hooks (chaining any
    hook already installed) and collects events into a
    :class:`CaptureReport`."""

    def __init__(self):
        self.report = CaptureReport()
        self._recording = False
        self._saved: Dict[str, Any] = {}

    # -- event handlers --------------------------------------------------
    def _on_sync(self, t, kind):
        if not self._recording:
            return
        self.report.syncs.append({
            "kind": kind, "origin": _origin(), "source": "tensor",
            "shape": list(t.shape), "dtype": str(t.dtype)})

    def _on_break(self, event, reason, name):
        if not self._recording:
            return
        ev = {"reason": reason, "event": event, "name": name,
              "origin": _origin()}
        if event == "capture":
            self.report.captures.append(ev)
        else:
            self.report.breaks.append(ev)

    def _on_torch_sync(self, w) -> None:
        """A ``set_sync_debug_mode`` warning: a torch call that
        synchronized. One inside ``core/tensor.py`` is a Tensor read
        the hook already counted."""
        fn = str(w.filename).replace("\\", "/")
        if fn.endswith("core/tensor.py"):
            return
        self.report.syncs.append({
            "kind": "torch", "origin": _short(fn, w.lineno),
            "source": "sync_debug_mode", "detail": str(w.message)[:120]})

    # -- hook install/remove ---------------------------------------------
    def __enter__(self):
        from ..core import tensor
        from ..jit import sot
        self._mods = (tensor, sot)
        self._saved["sync"] = tensor._sync_hook
        self._saved["break"] = sot._break_observer

        def chain(mine, prev):
            if prev is None:
                return mine

            def both(*a, **kw):
                mine(*a, **kw)
                prev(*a, **kw)
            return both

        tensor._sync_hook = chain(self._on_sync, self._saved["sync"])
        sot._break_observer = chain(self._on_break, self._saved["break"])
        return self

    def __exit__(self, *exc):
        tensor, sot = self._mods
        tensor._sync_hook = self._saved["sync"]
        sot._break_observer = self._saved["break"]
        return False

    def measure(self, fn, *args, **kwargs):
        """One measured run of ``fn``: the hooks record, and on the card
        ``set_sync_debug_mode("warn")`` reports raw torch syncs. The
        cyclic collector runs before it and is paused during it: a
        finalizer's sync (a freed graph, an event) would otherwise be
        charged to whatever line the step was on."""
        import torch
        card = torch.cuda.is_available() and \
            not torch.cuda.is_current_stream_capturing()
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        self._recording = True
        prev_mode = torch.cuda.get_sync_debug_mode() if card else None
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if card:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kwargs)
                finally:
                    if card:
                        torch.cuda.set_sync_debug_mode(prev_mode)
        finally:
            self._recording = False
            if gc_was_on:
                gc.enable()
            for w in caught:
                if _SYNC_WARNING in str(w.message):
                    self._on_torch_sync(w)
                else:
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno)

    # -- analysis ---------------------------------------------------------
    def finalize(self) -> CaptureReport:
        rep = self.report
        diags: List[Diagnostic] = []
        sites: Dict[tuple, int] = {}
        for ev in rep.syncs:
            sites[(ev["origin"], ev["kind"])] = \
                sites.get((ev["origin"], ev["kind"]), 0) + 1
        for (site, kind), n in sorted(sites.items()):
            how = "a synchronizing torch call" if kind == "torch" \
                else f".{kind}"
            diags.append(Diagnostic(
                "PTA001", site,
                f"device->host sync via {how} x{n} in the measured step",
                hint="keep the value on the card (device counters, "
                     "masked updates), or move the fetch after the "
                     "step"))
        by_kind: Dict[tuple, int] = {}
        for ev in rep.captures:
            key = (ev["reason"], ev["name"] or "?")
            by_kind[key] = by_kind.get(key, 0) + 1
        for (kind, name), n in sorted(by_kind.items()):
            diags.append(Diagnostic(
                "PTA003", f"capture: {kind} {name}",
                f"CUDA graph captured {n}x in the measured window",
                hint="a steady-state step replays its graph; bucket the "
                     "varying shapes (BucketPolicy) or keep the "
                     "signature's statics fixed"))
        rep.diagnostics = sort_diagnostics(diags)
        from ..observability import metrics as _om
        _om.counter("analysis.audits_total",
                    "Capture audits run by the analysis plane").inc()
        cd = _om.counter(
            "analysis.diagnostics_total",
            "Diagnostics emitted by the analysis plane, by rule")
        for d in rep.diagnostics:
            cd.inc(rule=d.rule)
        return rep


def audit(fn: Callable, *args, warmup: int = 2,
          **kwargs) -> CaptureReport:
    """Run ``fn(*args, **kwargs)`` ``warmup`` times, then once more in
    recording mode, and return its :class:`CaptureReport`."""
    with Auditor() as a:
        for _ in range(max(int(warmup), 0)):
            fn(*args, **kwargs)
            a.report.warmup_runs += 1
        try:
            a.report.result = a.measure(fn, *args, **kwargs)
        except BaseException as e:
            e.capture_report = a.finalize()
            raise
        return a.finalize()
