"""The port's metrics against the JAX package's where this slice adds
to them: pull gauges (``Gauge.set_function``, read at snapshot and
scrape; a failing one reads 0 and is counted), the ``FLAGS_metrics`` kill switch (``enabled`` / ``flag_info``;
every instrument stops while it is off), and ``start_metrics_server``
exported from ``observability``."""
import urllib.request

import pytest

import paddle_tpu.observability as jobs
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.observability as tobs
from paddle_tpu.core.flags import set_flags as jset_flags


def _pull(mod):
    reg = mod.Registry()
    depth = [3]
    g = reg.gauge("serving.queue_depth", "Queued (pulled)")
    g.set_function(lambda: depth[0])
    dead = reg.gauge("dead")
    dead.set_function(lambda: 1 / 0)
    depth[0] = 11
    return reg, g, dead


def test_pull_gauge_is_read_at_scrape_as_in_jax():
    (treg, tg, tdead), (jreg, jg, jdead) = _pull(tobs), _pull(jobs)
    assert tg.value() == jg.value() == 11
    assert tdead.value() == jdead.value() == 0
    # the port counts the failing pull instead of hiding it
    assert tdead.pull_errors == 1 and tg.pull_errors == 0
    assert isinstance(tdead.last_pull_error, ZeroDivisionError)
    assert treg.snapshot() == jreg.snapshot()
    text = treg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert "serving_queue_depth 11" in text


@pytest.fixture
def metrics_off():
    tpaddle.set_flags({"FLAGS_metrics": False})
    jset_flags({"FLAGS_metrics": False})
    yield
    tpaddle.set_flags({"FLAGS_metrics": True})
    jset_flags({"FLAGS_metrics": True})


def _count(mod):
    reg = mod.Registry()
    c = reg.counter("c_total")
    g = reg.gauge("g")
    h = reg.histogram("h_seconds")
    c.inc()
    c.inc(2, op="x")
    g.set(5)
    g.inc(2)
    h.observe(0.5)
    return reg.snapshot()


def test_flags_metrics_off_stops_every_instrument(metrics_off):
    assert not tobs.enabled() and tobs.flag_info().value is False
    got, want = _count(tobs), _count(jobs)
    assert got == want
    assert got["c_total"] == 0 and got["g"] == 0
    assert got["h_seconds"]["count"] == 0


def test_flags_metrics_on_by_default():
    assert tobs.enabled() and tobs.flag_info() is tobs.metrics.flag_info()
    snap = _count(tobs)
    assert snap == _count(jobs)
    assert snap["g"] == 7 and snap["h_seconds"]["count"] == 1


def test_start_metrics_server_from_observability():
    reg = tobs.Registry()
    reg.gauge("pulled").set_function(lambda: 42)
    srv = tobs.start_metrics_server(port=0, registry=reg)
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            body = r.read().decode()
        assert r.status == 200 and "pulled 42" in body
    finally:
        srv.close()
    assert "start_metrics_server" in tobs.__all__
