"""Process-wide metrics runtime: Counter / Gauge / Histogram + Registry.

The port's copy of the instruments, scopes and registry of
``paddle_tpu.observability.metrics``, which the serving modules count
into. Not ported: the ``FLAGS_metrics`` kill switch (instruments always
record), pull gauges, collectors, ``snapshot()`` and the Prometheus
exposition, which come with the metrics endpoint. Stdlib only.
"""
from __future__ import annotations

import bisect
import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Scope",
    "default_registry", "counter", "gauge", "histogram", "scope",
    "DEFAULT_BUCKETS",
]

# Fixed log-spaced buckets: half-decade steps over 1us .. 100s.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 2.0), 12) for e in range(-12, 5))


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    if len(labels) == 1:
        return tuple(labels.items())
    return tuple(sorted(labels.items()))


class _Instrument:
    """Shared cell bookkeeping: () is the unlabeled cell, labeled cells
    key on sorted (name, value) tuples."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = make_lock(f"metrics.instrument:{name}")
        self._cells: Dict[Tuple, Any] = {}

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

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._v = 0

    def inc(self, n: float = 1, **labels) -> None:
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

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
            self._v = 0


class Gauge(_Instrument):
    """Point-in-time value."""

    def set(self, v: float, **labels) -> None:
        key = _label_key(labels) if labels else ()
        with self._lock:
            self._cells[key] = v

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels) if labels else ()
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels):
        key = _label_key(labels) if labels else ()
        with self._lock:
            return self._cells.get(key, 0)


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

    def __init__(self, name: str, help: str = "", buckets=None):
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets)) if buckets else DEFAULT_BUCKETS

    def observe(self, v: float, **labels) -> None:
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
            nonzero = {format(le, "g"): c
                       for le, c in zip(self.buckets, cell.counts) if c}
            if cell.counts[-1]:
                nonzero["+Inf"] = cell.counts[-1]
            return {"count": cell.count,
                    "sum": round(cell.sum, 9),
                    "avg": round(cell.sum / cell.count, 9),
                    "min": cell.min, "max": cell.max,
                    "buckets": nonzero}


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
    """Central instrument table. Instrument creation is get-or-create by
    dotted name; asking for an existing name with a different type
    raises."""

    def __init__(self):
        self._lock = make_lock("metrics.registry", rlock=True)
        self._instruments: "OrderedDict[str, _Instrument]" = OrderedDict()

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

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def reset(self) -> None:
        for inst in self.instruments():
            inst.reset()


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
