"""Observability plane of the port: metrics registry (kill-switchable by
``FLAGS_metrics``, default on), its HTTP exposition and the flight
ring.

Quick tour::

    from paddle_tpu_torch import observability as obs

    obs.snapshot()             # nested dict of every instrument
    obs.render_prometheus()    # text exposition for a scraper
    srv = obs.start_metrics_server(port=9464)   # GET /metrics
"""
from __future__ import annotations

from . import metrics  # noqa: F401
from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry, Scope, counter,
    default_registry, enabled, flag_info, gauge, histogram,
    register_collector, render_prometheus, scope, snapshot,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Scope",
    "DEFAULT_BUCKETS", "counter", "gauge", "histogram", "scope",
    "default_registry", "enabled", "flag_info", "register_collector",
    "snapshot", "render_prometheus", "metrics", "start_metrics_server",
]


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         registry=None):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` on a
    stdlib HTTP daemon thread; returns a handle with ``.url`` and
    ``.close()``. The import is lazy: ``http.server`` stays off the
    package's import path."""
    from .http import start_metrics_server as _start
    return _start(port=port, host=host, registry=registry)
