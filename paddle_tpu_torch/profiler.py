"""``paddle.profiler`` of the port: a host plane and a device plane.

The port of ``paddle_tpu/profiler.py`` (``Profiler``, ``RecordEvent``,
``ProfilerTarget``, ``export_chrome_tracing``, ``summary``). The host
plane is the native tracer (``_native``: ``RecordEvent`` spans and the
``ProfileStep#n`` span of each ``Profiler.step``, monotonic µs). The
device plane is ``torch.profiler`` with CUDA activity alone (CUPTI:
each kernel, copy and set launched on the card in the window, inside
CUDA graph replays too) where the targets name the accelerator. CUPTI
can drop a record: late in a long process, a window has lost one
kernel record of twelve, so a caller that counts rows compares them
with its launch counters.
``ProfilerTarget`` keeps the JAX names, and in the port ``TPU`` and
``GPUTrace`` both mean the card. Without a card such a target raises;
the host plane never runs without its native library (its build
raises with the compiler's tail).

:func:`export_chrome_tracing` writes one chrome trace: the host spans
(``"ph": "X"``, pid 0), the device kernels of the last profiler that
stopped (``"ph": "X"``, pid 1, placed on the host clock at the
profiler's start), every live ``observability.timeline.StepTimer``'s
counters (``"ph": "C"``) and the flight ring's instants (``"ph":
"i"``). The flight recorder's dumps write it beside themselves.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from . import _native

__all__ = ["Profiler", "RecordEvent", "ProfilerTarget",
           "export_chrome_tracing"]

# the device plane of the last profiler that stopped (chrome events)
_last_device: List[Dict[str, Any]] = []


class ProfilerTarget:
    CPU = "cpu"
    TPU = "tpu"          # the card, in the port
    GPUTrace = "gpu"     # the card


class RecordEvent:
    """A host span, as a context manager or a ``begin()`` / ``end()``
    pair. Reentrant: a second ``begin()`` before ``end()`` nests, and
    each ``end()`` closes the latest open ``begin()`` (LIFO). Outside a
    running profiler it records nothing and builds nothing."""

    def __init__(self, name: str):
        self.name = name
        self._starts: list = []

    def begin(self):
        lib = _native.loaded()
        if lib is not None and lib.tracer_enabled():
            self._starts.append(lib.tracer_now())

    def end(self):
        lib = _native.loaded()
        if lib is not None and self._starts:
            lib.tracer_record(self.name, self._starts.pop(),
                              lib.tracer_now())

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def _wants_device(targets) -> bool:
    return ProfilerTarget.TPU in targets or \
        ProfilerTarget.GPUTrace in targets


class Profiler:
    """``start`` / ``step`` / ``stop`` (or a ``with`` block), then
    ``export`` and ``summary``. ``targets`` default to the host plane
    alone; ``timer_only`` keeps the step spans and skips the device
    plane. ``profile_memory`` and ``scheduler`` are accepted for the
    JAX signature and unused, as there."""

    def __init__(self, targets=None, on_trace_ready=None, timer_only=False,
                 profile_memory=False, scheduler=None):
        self.targets = list(targets or [ProfilerTarget.CPU])
        self.on_trace_ready = on_trace_ready
        self.timer_only = bool(timer_only)
        self._prof = None
        self._dev_t0_us: Optional[float] = None
        self._device: List[Dict[str, Any]] = []
        self._running = False
        self._step_count = 0
        self._step_t0: Optional[float] = None

    def start(self):
        lib = _native.lib()
        if not self.timer_only and _wants_device(self.targets):
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "paddle.profiler: the targets name the accelerator "
                    "but torch sees no CUDA device")
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._dev_t0_us = time.perf_counter() * 1e6
        lib.tracer_start()
        self._step_t0 = lib.tracer_now()
        self._running = True
        return self

    def stop(self):
        if not self._running:
            return
        lib = _native.lib()
        lib.tracer_stop()
        if self._prof is not None:
            import torch
            torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._device = _kernel_events(self._prof, self._dev_t0_us)
            self._prof = None
            _last_device[:] = self._device
        self._running = False
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step(self):
        """Close the window since ``start`` or the previous ``step`` as a
        ``ProfileStep#N`` host span."""
        self._step_count += 1
        lib = _native.loaded()
        if lib is not None and lib.tracer_enabled() \
                and self._step_t0 is not None:
            now = lib.tracer_now()
            lib.tracer_record(f"ProfileStep#{self._step_count}",
                              self._step_t0, now)
            self._step_t0 = now

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def device_events(self) -> List[Dict[str, Any]]:
        """This profiler's device plane as chrome events (empty without
        one)."""
        return list(self._device)

    def export(self, path: str, format: str = "json"):
        return export_chrome_tracing(path)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """The host spans (and the device kernels, when profiled) by
        name: calls, total, average, largest, smallest and share."""
        units = {"ms": 1e3, "us": 1.0, "s": 1e6}
        if time_unit not in units:
            raise ValueError(f"time_unit must be one of {sorted(units)}, "
                             f"got {time_unit!r}")
        lib = _native.loaded()
        host = json.loads(lib.tracer_dump())["traceEvents"] if lib else []
        parts = [_table("host spans", host, units[time_unit], time_unit)]
        if self._device:
            parts.append(_table("device kernels", self._device,
                                units[time_unit], time_unit))
        return "\n".join(p for p in parts if p) or (
            "no events recorded (was the profiler started, and did any "
            "RecordEvent / step() run inside it?)")


def _table(title, events, unit, u) -> str:
    agg: Dict[str, list] = {}
    grand = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        dur = float(e.get("dur", 0.0))
        rec = agg.setdefault(e["name"], [0, 0.0, 0.0, float("inf")])
        rec[0] += 1
        rec[1] += dur
        rec[2] = max(rec[2], dur)
        rec[3] = min(rec[3], dur)
        grand += dur
    if not agg:
        return ""
    lines = [title,
             f"{'name':<36} {'calls':>7} {f'total_{u}':>11} "
             f"{f'avg_{u}':>10} {f'max_{u}':>10} {f'min_{u}':>10} "
             f"{'ratio':>7}"]
    for name, (calls, total, mx, mn) in sorted(
            agg.items(), key=lambda kv: -kv[1][1]):
        lines.append(
            f"{name[:36]:<36} {calls:>7} {total / unit:>11.3f} "
            f"{total / calls / unit:>10.3f} {mx / unit:>10.3f} "
            f"{mn / unit:>10.3f} "
            f"{(total / grand if grand else 0.0):>6.1%}")
    return "\n".join(lines)


def _kernel_events(prof, t0_us: float) -> List[Dict[str, Any]]:
    """The CUDA records of a finished ``torch.profiler`` window as
    chrome complete events on the host clock (offset by the window's
    start)."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue      # the runtime calls on the host
        tr = ev.time_range
        out.append({"name": ev.name, "ph": "X", "pid": 1,
                    "tid": int(getattr(ev, "device_index", 0) or 0),
                    "ts": t0_us + tr.start, "dur": tr.end - tr.start,
                    "cat": "device"})
    return out


def trace_events(build: bool = True) -> List[Dict[str, Any]]:
    """Every plane as chrome events: host spans (the native tracer; with
    ``build=False`` only when some caller already loaded it), device
    kernels, timeline counters, flight instants."""
    lib = _native.lib() if build else _native.loaded()
    events = json.loads(lib.tracer_dump())["traceEvents"] if lib else []
    events.extend(_last_device)
    from .observability import flight as _flight
    from .observability import timeline as _timeline
    events.extend(_timeline.chrome_events())
    events.extend(_flight.chrome_events())
    return events


def export_chrome_tracing(path: str, worker_name=None, build: bool = True):
    """Write the merged chrome trace (see the module docstring) to
    ``path`` and return it."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": worker_name or "host"}},
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "device"}}]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + trace_events(build),
                   "displayTimeUnit": "ms"}, f)
    return path
