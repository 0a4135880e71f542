"""Stdlib HTTP exposition: serve the default registry at ``/metrics``.

The port's copy of ``paddle_tpu.observability.http``. One daemonized
``ThreadingHTTPServer`` per ``start_metrics_server`` call — the scrape
path a Prometheus instance (or ``curl``) hits. No
third-party dependency; the handler renders on demand so a scrape
always sees current values.

Routes:
    /metrics        Prometheus text exposition format (v0.0.4)
    /metrics.json   the nested ``snapshot()`` dict as JSON
    /healthz        readiness JSON from the installed ``health_cb``
                    (200 when ``ok``, 503 otherwise; 404 with no
                    callback). The fleet router's replica probe and an
                    operator's load-balancer check read the SAME
                    snapshot — one source of truth for "can this
                    process take traffic".
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from . import metrics as _metrics

__all__ = ["MetricsServer", "start_metrics_server"]


class MetricsServer:
    """Handle for a running exposition endpoint; ``close()`` stops it.

    ``health_cb`` (optional) returns the readiness dict served at
    ``/healthz`` — it must contain a boolean ``"ok"`` (→ 200/503) and
    may carry anything else (pressure level, free KV blocks, backlog).
    A callback that raises reports not-ready instead of 500ing the
    probe: a health check must never be flakier than the thing it
    checks.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Optional["_metrics.Registry"] = None,
                 health_cb: Optional[Callable[[], dict]] = None):
        reg = registry or _metrics.default_registry()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler contract
                status = 200
                if self.path in ("/metrics", "/"):
                    body = reg.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/metrics.json":
                    body = json.dumps(reg.snapshot(), default=str,
                                      indent=None).encode()
                    ctype = "application/json"
                elif self.path == "/healthz" and srv.health_cb is not None:
                    try:
                        snap = dict(srv.health_cb())
                    except Exception as e:
                        snap = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
                    status = 200 if snap.get("ok") else 503
                    body = json.dumps(snap, default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-scrape stderr spam
                pass

        self.health_cb = health_cb
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"metrics-http-{self.port}")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         registry=None, health_cb=None) -> MetricsServer:
    """Start the scrape endpoint; ``port=0`` picks an ephemeral port
    (read it back from ``server.port`` / ``server.url``)."""
    return MetricsServer(host=host, port=port, registry=registry,
                         health_cb=health_cb)
