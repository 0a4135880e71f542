"""Process-wide metrics runtime: Counter / Gauge / Histogram + Registry.

The port's copy of the instruments, scopes and registry of
``paddle_tpu.observability.metrics``, which the serving modules count
into, with its views: *collectors* (callbacks polled only at
``snapshot()`` / ``render_prometheus()`` time), ``snapshot()`` (one
nested JSON-able dict) and ``render_prometheus()`` (Prometheus text
exposition v0.0.4). For the same instruments and increments both views
equal the JAX package's. ``FLAGS_metrics`` (default on) is the kill
switch: with it off every instrument mutation is one cached flag read
and a return. ``Gauge.set_function`` installs a pull gauge, read only
at ``snapshot()`` / ``render_prometheus()`` time. Stdlib only.
"""
from __future__ import annotations

import bisect
import math
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock
from ..core.flags import _registry as _flag_registry
from ..core.flags import define_flag

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Scope",
    "default_registry", "enabled", "flag_info", "counter", "gauge",
    "histogram", "scope",
    "register_collector", "snapshot", "render_prometheus",
    "DEFAULT_BUCKETS",
]

# Fixed log-spaced buckets: half-decade steps over 1us .. 100s.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 2.0), 12) for e in range(-12, 5))

define_flag("metrics", True,
            "Process-wide telemetry registry (observability.metrics): "
            "counters, gauges and histograms of the serving, capture, "
            "checkpoint and optimizer planes. Default on. FLAGS_metrics=0 "
            "is the kill switch: every instrument mutation becomes one "
            "cached flag read and a return")
_metrics_flag = _flag_registry["metrics"]


def enabled() -> bool:
    """The value of ``FLAGS_metrics``."""
    return bool(_metrics_flag.value)


def flag_info():
    """The live ``FLAGS_metrics`` registry entry (its identity is
    stable): a hot path keeps it and branches on ``.value``."""
    return _metrics_flag


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    if len(labels) == 1:
        return tuple(labels.items())
    return tuple(sorted(labels.items()))


class _Instrument:
    """Shared cell bookkeeping: () is the unlabeled cell, labeled cells
    key on sorted (name, value) tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = make_lock(f"metrics.instrument:{name}")
        self._cells: Dict[Tuple, Any] = {}

    def series(self) -> Dict[Tuple, Any]:
        """{label-key tuple: cell snapshot} — () = unlabeled."""
        with self._lock:
            return dict(self._cells)

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class Counter(_Instrument):
    """Monotonic counter. ``inc(n)`` unlabeled, ``inc(op="add")``
    labeled. The unlabeled cell is the plain attribute ``_v`` (a
    lock-free add; telemetry tolerates a lost increment across racing
    threads)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._v = 0

    def inc(self, n: float = 1, **labels) -> None:
        if not _metrics_flag.value:
            return
        if not labels:
            self._v += n
            return
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + n

    def value(self, **labels):
        if not labels:
            return self._v
        key = _label_key(labels)
        with self._lock:
            return self._cells.get(key, 0)

    def total(self):
        """The unlabeled cell plus every labeled one."""
        with self._lock:
            return self._v + sum(self._cells.values())

    def series(self) -> Dict[Tuple, Any]:
        with self._lock:
            out = dict(self._cells)
        if self._v or not out:
            out[()] = self._v
        return out

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
            self._v = 0


class Gauge(_Instrument):
    """Point-in-time value; ``set_function`` installs a pull callback
    read only at snapshot and exposition time (queue depths, cache
    sizes: no hot-path cost). A pull callback that raises reads 0, as in
    the JAX package, and is counted: ``pull_errors`` and
    ``last_pull_error`` say how often and why."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._fn: Optional[Callable[[], float]] = None
        self.pull_errors = 0
        self.last_pull_error: Optional[BaseException] = None

    def set(self, v: float, **labels) -> None:
        if not _metrics_flag.value:
            return
        key = _label_key(labels) if labels else ()
        with self._lock:
            self._cells[key] = v

    def inc(self, n: float = 1, **labels) -> None:
        if not _metrics_flag.value:
            return
        key = _label_key(labels) if labels else ()
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def value(self, **labels):
        if self._fn is not None and not labels:
            try:
                return self._fn()
            except Exception as e:  # noqa: BLE001 — counted, reads 0
                self.pull_errors += 1
                self.last_pull_error = e
                return 0
        key = _label_key(labels) if labels else ()
        with self._lock:
            return self._cells.get(key, 0)

    def series(self) -> Dict[Tuple, Any]:
        out = super().series()
        if self._fn is not None and () not in out:
            out[()] = self.value()
        return out


class _HistCell:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)  # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Instrument):
    """Fixed-bucket histogram (log-spaced by default)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=None):
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets)) if buckets else DEFAULT_BUCKETS

    def observe(self, v: float, **labels) -> None:
        if not _metrics_flag.value:
            return
        v = float(v)
        key = _label_key(labels) if labels else ()
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(len(self.buckets))
            cell.counts[i] += 1
            cell.sum += v
            cell.count += 1
            cell.min = min(cell.min, v)
            cell.max = max(cell.max, v)

    def _cell_dict(self, cell: _HistCell) -> Dict[str, Any]:
        nonzero = {_fmt_num(le): c
                   for le, c in zip(self.buckets, cell.counts) if c}
        if cell.counts[-1]:
            nonzero["+Inf"] = cell.counts[-1]
        return {
            "count": cell.count,
            "sum": round(cell.sum, 9),
            "avg": round(cell.sum / cell.count, 9) if cell.count else 0.0,
            "min": cell.min if cell.count else 0.0,
            "max": cell.max if cell.count else 0.0,
            "buckets": nonzero,  # per-bucket (not cumulative) counts
        }

    def value(self, **labels) -> Dict[str, Any]:
        """count, sum, avg, min, max and the per-bucket (not
        cumulative) counts of the non-empty buckets, keyed by upper
        bound."""
        key = _label_key(labels) if labels else ()
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                return {"count": 0, "sum": 0.0, "avg": 0.0,
                        "min": 0.0, "max": 0.0, "buckets": {}}
            return self._cell_dict(cell)


def _fmt_num(v) -> str:
    """Compact numeric literal valid in both exposition values and
    JSON-ish snapshots (1e-06, 0.25, 3)."""
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if not isinstance(v, float) else format(v, "g")


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _sanitize(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() and (i > 0 or not ch.isdigit()) or ch in "_:":
            out.append(ch)
        else:
            out.append("_")
    return "".join(out)


def _labels_str(key: Tuple[Tuple[str, Any], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(
        f'{_sanitize(k)}="{_escape_label(str(v))}"' for k, v in key)
    return "{" + inner + "}"


class Scope:
    """Named-scope instrument factory: ``scope("serving").counter("x")``
    creates/fetches ``serving.x`` in the parent registry."""

    def __init__(self, registry: "Registry", prefix: str):
        self._registry = registry
        self._prefix = prefix.rstrip(".")

    def _full(self, name: str) -> str:
        return f"{self._prefix}.{name}"

    def counter(self, name: str, help: str = "") -> Counter:
        return self._registry.counter(self._full(name), help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._registry.gauge(self._full(name), help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._registry.histogram(self._full(name), help, buckets)

    def scope(self, prefix: str) -> "Scope":
        return Scope(self._registry, self._full(prefix))


class Registry:
    """Central instrument table + snapshot-time collectors. Instrument
    creation is get-or-create by dotted name; asking for an existing
    name with a different type raises."""

    def __init__(self):
        self._lock = make_lock("metrics.registry", rlock=True)
        self._instruments: "OrderedDict[str, _Instrument]" = OrderedDict()
        self._collectors: "OrderedDict[str, Callable]" = OrderedDict()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(inst).__name__}, requested {cls.__name__}")
                return inst
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def scope(self, prefix: str) -> Scope:
        return Scope(self, prefix)

    def register_collector(self, name: str, fn: Callable) -> None:
        """``fn() -> {dotted_name: number | {label_value: number}}``,
        polled only at snapshot/exposition time. Re-registering a name
        replaces the callback."""
        with self._lock:
            self._collectors[name] = fn

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def reset(self) -> None:
        """Zero every instrument cell (collectors keep their own
        state)."""
        for inst in self.instruments():
            inst.reset()

    def _collected(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._collectors.items())
        for _name, fn in items:
            try:
                part = fn() or {}
            except Exception:  # noqa: BLE001 — one bad view can't kill all
                continue
            out.update(part)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """One nested dict over every instrument + collector: dotted
        names split into sub-dicts (``serving.admitted_total`` lands at
        ``snap["serving"]["admitted_total"]``)."""
        flat: Dict[str, Any] = {}
        for inst in self.instruments():
            series = inst.series()
            if isinstance(inst, Histogram):
                if not series or tuple(series) == ((),):
                    flat[inst.name] = inst.value()
                else:
                    flat[inst.name] = {
                        (key[0][1] if len(key) == 1 else
                         ",".join(f"{k}={v}" for k, v in key)):
                        inst._cell_dict(cell)
                        for key, cell in series.items()}
            elif not series:
                flat[inst.name] = (inst.value()
                                   if isinstance(inst, Gauge) else 0)
            elif tuple(series) == ((),):
                flat[inst.name] = series[()]
            else:
                out = {}
                for key, v in series.items():
                    if key == ():
                        out["_total"] = v
                    elif len(key) == 1:
                        out[key[0][1]] = v
                    else:
                        out[",".join(f"{k}={lv}" for k, lv in key)] = v
                flat[inst.name] = out
        flat.update(self._collected())
        nested: Dict[str, Any] = {}
        for name, v in flat.items():
            parts = name.split(".")
            d = nested
            for p in parts[:-1]:
                nxt = d.get(p)
                if not isinstance(nxt, dict):
                    nxt = d[p] = {}
                d = nxt
            d[parts[-1]] = v
        return nested

    def render_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines: List[str] = []
        for inst in self.instruments():
            mname = _sanitize(inst.name.replace(".", "_"))
            if inst.help:
                lines.append(f"# HELP {mname} {_escape_help(inst.help)}")
            lines.append(f"# TYPE {mname} {inst.kind}")
            series = inst.series()
            if isinstance(inst, Histogram):
                if not series:
                    series = {(): _HistCell(len(inst.buckets))}
                for key, cell in series.items():
                    cum = 0
                    for le, c in zip(inst.buckets, cell.counts):
                        cum += c
                        lk = key + (("le", _fmt_num(le)),)
                        lines.append(
                            f"{mname}_bucket{_labels_str(lk)} {cum}")
                    cum += cell.counts[-1]
                    lk = key + (("le", "+Inf"),)
                    lines.append(f"{mname}_bucket{_labels_str(lk)} {cum}")
                    lines.append(
                        f"{mname}_sum{_labels_str(key)} "
                        f"{_fmt_num(float(cell.sum))}")
                    lines.append(
                        f"{mname}_count{_labels_str(key)} {cell.count}")
            else:
                if not series:
                    series = {(): inst.value()
                              if isinstance(inst, Gauge) else 0}
                for key, v in series.items():
                    lines.append(
                        f"{mname}{_labels_str(key)} "
                        f"{_fmt_num(float(v))}")
        # collectors render as untyped counters, one implicit label
        # ("key") for a dict of values
        for name, v in sorted(self._collected().items()):
            mname = _sanitize(name.replace(".", "_"))
            lines.append(f"# TYPE {mname} counter")
            if isinstance(v, dict):
                for lv, n in sorted(v.items(), key=lambda kv: str(kv[0])):
                    lines.append(
                        f'{mname}{{key="{_escape_label(str(lv))}"}} '
                        f"{_fmt_num(float(n))}")
            else:
                lines.append(f"{mname} {_fmt_num(float(v))}")
        return "\n".join(lines) + "\n"


_default = Registry()


def default_registry() -> Registry:
    return _default


def counter(name: str, help: str = "") -> Counter:
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _default.gauge(name, help)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    return _default.histogram(name, help, buckets)


def scope(prefix: str) -> Scope:
    return _default.scope(prefix)


def register_collector(name: str, fn: Callable) -> None:
    _default.register_collector(name, fn)


def snapshot() -> Dict[str, Any]:
    return _default.snapshot()


def render_prometheus() -> str:
    return _default.render_prometheus()
