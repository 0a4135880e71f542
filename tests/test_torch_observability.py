"""Metrics exposition: the port's ``snapshot()`` and
``render_prometheus()`` against the JAX package's for the same
instruments, labels and increments in fresh registries, the
module-level views over the default registry, ``health_snapshot``, and
``GenerationServer.metrics_endpoint`` serving ``/metrics``,
``/metrics.json`` and ``/healthz`` on 127.0.0.1. Every server is closed
in ``finally`` and every HTTP call has a timeout."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import serving_fleet as jfleet
from paddle_tpu.observability import metrics as jm
from paddle_tpu_torch import serving_fleet as tfleet
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import metrics as tm
from paddle_tpu_torch.observability.http import start_metrics_server
from paddle_tpu_torch.serving import GenerationServer, PagedLlamaDecodeEngine


def _fill(mod):
    """The same instruments and increments in a fresh registry of
    ``mod``: plain, labeled and mixed counters, gauges, histograms with
    the default and custom buckets, labeled ones, a collector of numbers
    and one of a dict, a help text and label values that need escaping,
    names that need sanitizing."""
    reg = mod.Registry()
    c = reg.counter("serving.admitted_total", "Requests admitted")
    c.inc()
    c.inc(4)
    lab = reg.scope("ops").counter("calls_total", 'Calls by "op"\nper op')
    lab.inc(op="add")
    lab.inc(3, op="matmul")
    lab.inc(op='we"ird\\name')
    mixed = reg.counter("mixed_total")
    mixed.inc(2)
    mixed.inc(op="x", dev=1)
    reg.counter("never_total", "never incremented")
    g = reg.gauge("serving.queue_depth", "Queued")
    g.set(7)
    g.inc(2)
    g.dec(1)
    gl = reg.gauge("pool.blocks")
    gl.set(3, kind="free")
    gl.set(5.5, kind="used")
    reg.gauge("idle_gauge")
    h = reg.histogram("serving.request_seconds", "Wall time")
    for v in (1e-7, 3e-4, 0.02, 0.02, 1.5, 250.0):
        h.observe(v)
    hc = reg.histogram("9lives.odd-name", buckets=[0.1, 1, 10])
    hc.observe(0.5, route="a")
    hc.observe(5, route="a")
    hc.observe(50, route="b")
    reg.histogram("empty_seconds")
    reg.register_collector("views", lambda: {
        "ops.dispatch_total": 12, "mem.peak": {"cpu": 3.0, 0: 1}})
    reg.register_collector("broken", lambda: 1 / 0)
    return reg


def test_snapshot_and_prometheus_equal_the_jax_package():
    want, got = _fill(jm), _fill(tm)
    assert got.snapshot() == want.snapshot()
    text = got.render_prometheus()
    assert text == want.render_prometheus()
    assert "# TYPE serving_admitted_total counter" in text
    assert 'ops_calls_total{op="we\\"ird\\\\name"} 1' in text
    assert '_lives_odd_name_bucket{route="a",le="+Inf"} 2' in text
    assert text.endswith("\n")


def test_module_views_cover_the_default_registry():
    reg = tm.default_registry()
    name = "test_torch_observability"
    tm.register_collector(name, lambda: {"probe.value": 42})
    try:
        assert tm.snapshot()["probe"]["value"] == 42
        assert "probe_value 42" in tm.render_prometheus()
        assert "serving" in tm.snapshot()
    finally:
        with reg._lock:
            reg._collectors.pop(name, None)


class _Stub:
    """A server as health_snapshot reads it."""

    class _Q:
        def qsize(self):
            return 2

    def __init__(self, stopping):
        self._thread = None
        self.policy = type("P", (), {"level": 1})()
        self._paged = False
        self._q = self._Q()
        self._waiting = [1]
        self._slots = {0: None}
        self._stopping = threading.Event()
        if stopping:
            self._stopping.set()


@pytest.mark.parametrize("stopping", [False, True])
def test_health_snapshot_equals_the_jax_package(stopping):
    got = tfleet.health_snapshot(_Stub(stopping))
    assert got == jfleet.health_snapshot(_Stub(stopping))
    assert got["ok"] is False and got["backlog"] == 3


# no proxy from the environment: every request stays on 127.0.0.1
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(url, timeout=10):
    try:
        with _OPENER.open(url, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, e.read()


def test_metrics_server_routes():
    srv = start_metrics_server(port=0, health_cb=lambda: {"ok": False,
                                                          "why": "test"})
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert srv.url == base + "/metrics"
        code, ctype, body = _get(srv.url)
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        code, _, body = _get(base + "/healthz")
        assert code == 503 and json.loads(body)["why"] == "test"
        assert _get(base + "/nope")[0] == 404
    finally:
        srv.close()


def test_generation_server_metrics_endpoint():
    cfg = LlamaConfig.tiny(vocab_size=64, hidden_size=32,
                           intermediate_size=64, num_hidden_layers=1,
                           num_attention_heads=4, num_key_value_heads=2,
                           use_flash_attention=False)
    eng = PagedLlamaDecodeEngine(LlamaForCausalLM(cfg, device="cpu"),
                                 max_slots=2, max_seq=32, block_size=8,
                                 prefill_chunk=8, device="cpu")
    srv = GenerationServer(eng)
    try:
        ep = srv.metrics_endpoint()
        assert srv.metrics_endpoint() is ep          # idempotent
        out = srv.generate(np.arange(1, 6), 4, timeout=60)
        assert len(out) == 4
        code, _, body = _get(ep.url)
        text = body.decode()
        assert code == 200
        assert "# TYPE serving_tokens_total counter" in text
        assert "serving_weight_swaps_total" in text
        code, ctype, body = _get(f"http://127.0.0.1:{ep.port}/metrics.json")
        assert code == 200 and ctype == "application/json"
        assert json.loads(body)["serving"]["admitted_total"] >= 1
        code, _, body = _get(f"http://127.0.0.1:{ep.port}/healthz")
        health = json.loads(body)
        assert code == 200 and health["ok"] and health["loop_alive"]
        assert health["blocks_total"] == eng._kv.num_blocks
    finally:
        assert srv.shutdown(timeout=60)
    assert srv._metrics_server is None
    with pytest.raises(OSError):
        _OPENER.open(ep.url, timeout=5)
