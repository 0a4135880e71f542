"""Step timeline: per-step phase durations as chrome-trace counter
events.

The port of ``paddle_tpu/observability/timeline.py``. ``StepTimer``
times named phases of a training step (data / forward / backward /
optimizer ..., names are free) and, at each ``step()`` boundary,
freezes them as one chrome-trace counter event (``"ph": "C"``) kept in
memory (:meth:`StepTimer.chrome_events`, :func:`chrome_events`). Phase
durations also feed the process registry (``step.phase_seconds
{phase=...}``, ``step.step_seconds``, ``step.steps_total``).

``profiler.export_chrome_tracing`` merges them into its trace file
beside the host spans. The clock is ``time.perf_counter`` (monotonic
µs, the native tracer's clock; host time: a phase around a launch
measures its issue, not the device's work).
"""
from __future__ import annotations

import os
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from . import metrics as _metrics

__all__ = ["StepTimer", "chrome_events", "active_timers"]

# ring cap per timer: a counter event is ~100 bytes; 20k steps ~ 2 MB
_EVENT_CAP = 20000


def _now_us() -> float:
    return time.perf_counter() * 1e6


_timers: "weakref.WeakSet" = weakref.WeakSet()


class StepTimer:
    """Accumulates named phase durations within a step; ``step()``
    closes the step, keeps its chrome counter event and observes the
    registry histograms.

        timer = StepTimer("train")
        for batch in loader:
            with timer.phase("forward"):   loss = model(x, y)
            with timer.phase("backward"):  loss.backward()
            timer.step()
    """

    def __init__(self, name: str = "train",
                 registry: Optional["_metrics.Registry"] = None):
        self.name = name
        reg = registry or _metrics.default_registry()
        self._hist = reg.histogram(
            "step.phase_seconds",
            "Per-step phase durations recorded by StepTimer")
        self._step_hist = reg.histogram(
            "step.step_seconds", "Whole-step wall time (StepTimer)")
        self._steps = reg.counter(
            "step.steps_total", "Steps closed by StepTimer.step()")
        self._events: List[Dict[str, Any]] = []
        self._current: Dict[str, float] = {}
        self.step_index = 0
        self._step_t0 = _now_us()
        _timers.add(self)

    @contextmanager
    def phase(self, name: str):
        t0 = _now_us()
        try:
            yield
        finally:
            dt = (_now_us() - t0) / 1e6
            self._current[name] = self._current.get(name, 0.0) + dt
            self._hist.observe(dt, phase=name)

    def step(self) -> Dict[str, float]:
        """Close the current step: returns its {phase: seconds}."""
        now = _now_us()
        wall = (now - self._step_t0) / 1e6
        phases, self._current = self._current, {}
        self._steps.inc()
        self._step_hist.observe(wall)
        args = {k: round(v * 1e3, 6) for k, v in phases.items()}  # ms
        other = wall - sum(phases.values())
        if phases and other > 0:
            args["other"] = round(other * 1e3, 6)
        self._events.append({
            "name": f"{self.name}.step_phases_ms",
            "ph": "C", "pid": os.getpid(), "tid": 0,
            "ts": now, "args": args,
        })
        if len(self._events) > _EVENT_CAP:
            del self._events[: len(self._events) - _EVENT_CAP]
        self.step_index += 1
        self._step_t0 = now
        return phases

    def chrome_events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._current.clear()


def active_timers() -> List[StepTimer]:
    return list(_timers)


def chrome_events() -> List[Dict[str, Any]]:
    """Counter events of every live StepTimer, in time order."""
    out: List[Dict[str, Any]] = []
    for t in active_timers():
        out.extend(t.chrome_events())
    out.sort(key=lambda e: e.get("ts", 0))
    return out
