"""The serving fleet: the port's ``serving_fleet`` against the JAX
package's.

The router's scenarios run on both packages (``pkg``): failover after an
abrupt ``kill()`` bit-equal to the uninterrupted stream, the zombie
epoch's late answer dropped, a poison request quarantined, pressure
placement against round-robin, shedding only when every replica is at
level 3, ``/healthz``, and the framing under ``FlakyTransport``. The
replicas serve the causal engine fakes of test_torch_serving_supervisor
(neither JAX nor torch) through each package's ``GenerationServer``
behind real sockets. Across the packages a port router drives JAX
replicas and a JAX router port replicas over the same wire, with the
same streams, ``fleet`` events and counters. Two in-process port
replicas over f32 CPU paged engines (weights copied from a JAX tiny
Llama) fail over bit-equal to the JAX engine's streams; a bf16
``prepare_swap`` crosses the wire bit-exact; ``kill()`` ends the accept
thread; one subprocess test boots replicas from a JAX-saved ``.pdmodel``
on the CPU and resurrects a SIGKILLed one.

After each test no thread the port's fleet module started is alive.
Every wait has its own timeout.
"""
import io
import json
import os
import signal
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import serving as jserving
from paddle_tpu import serving_cache as jcache
from paddle_tpu import serving_fleet as jfleet
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import flight as jflight
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import serving_cache as tcache
from paddle_tpu_torch import serving_fleet as tfleet
from paddle_tpu_torch.convert import load_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.utils import fault_injection as tfi

from test_torch_serving_supervisor import (CFG, FakeCausalEngine,
                                           FakePagedEngine)

PKGS = {
    "jax": SimpleNamespace(name="jax", fleet=jfleet,
                           server=jserving.GenerationServer,
                           cache=jcache.PagedKVCache, flight=jflight,
                           fi=jfi),
    "port": SimpleNamespace(name="port", fleet=tfleet,
                            server=tserving.GenerationServer,
                            cache=tcache.PagedKVCache, flight=tflight,
                            fi=tfi),
}
FLEET_TERMINAL = {"finished", "failed", "shed"}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _port_fleet_threads():
    """Live threads whose target is in the port's fleet module."""
    out = []
    for t in threading.enumerate():
        target = getattr(t, "_target", None)
        if t.is_alive() and getattr(target, "__module__", None) \
                == tfleet.__name__:
            out.append(t)
    return out


@pytest.fixture(autouse=True)
def fleet_threads_end():
    """Every fault site disarmed afterwards, and no thread the port's
    fleet module started outlives the test (bounded wait)."""
    try:
        yield
    finally:
        jfi.clear()
        tfi.clear()
    t_end = time.monotonic() + 5.0
    while _port_fleet_threads() and time.monotonic() < t_end:
        time.sleep(0.01)
    left = [t.name for t in _port_fleet_threads()]
    assert not left, f"fleet threads still alive: {left}"


def _oracle(prompt, n_new):
    """The uninterrupted greedy stream of the causal fakes."""
    seq = [int(t) for t in prompt]
    out = []
    for _ in range(n_new):
        tok = FakeCausalEngine._next(seq)
        seq.append(tok)
        out.append(tok)
    return out


class StubLevelPolicy:
    """Admission policy double with a hand-set pressure level: admits
    everything replica-side, so placement and shedding are the
    router's."""

    name = "stub"

    def __init__(self, level=0):
        self.level = level

    def admit_verdict(self, server, prompt_len, max_new, deadline):
        return None

    def on_step(self, server):
        return None


def _wait_for(cond, timeout=10.0):
    t_end = time.monotonic() + timeout
    while not cond() and time.monotonic() < t_end:
        time.sleep(0.005)
    return cond()


class Fleet:
    """In-process replicas of one package (each a ``GenerationServer``
    behind a ``ReplicaServer``) and a router, possibly of the other
    package; ``close()`` tears everything down with bounded waits."""

    def __init__(self, replica_pkg, router_pkg=None):
        self.rp = replica_pkg
        self.fp = router_pkg or replica_pkg
        self.servers, self.replicas, self.handles = [], [], []
        self.router = None

    def add(self, engine, policy=None, **handle_kwargs):
        srv = self.rp.server(engine, policy=policy)
        rs = self.rp.fleet.ReplicaServer(srv)
        h = self.fp.fleet.ReplicaHandle(len(self.handles), rs.host, rs.port,
                                        kill_cb=rs.kill, **handle_kwargs)
        self.servers.append(srv)
        self.replicas.append(rs)
        self.handles.append(h)
        return srv, rs, h

    def spawn(self, engine_fn):
        def spawn(idx):
            srv = self.rp.server(engine_fn())
            rs = self.rp.fleet.ReplicaServer(srv)
            self.servers.append(srv)
            self.replicas.append(rs)
            return self.fp.fleet.ReplicaHandle(idx, rs.host, rs.port,
                                               kill_cb=rs.kill)
        return spawn

    def route(self, **kw):
        self.router = self.fp.fleet.FleetRouter(self.handles, **kw)
        return self.router

    def close(self):
        r = self.router
        if r is not None:
            if self.fp is PKGS["port"]:
                r._stop.set()
                for t in list(r._threads):
                    t.join(5)
            else:
                r._stop.set()
            for h in r.replicas:
                h.drop_conn()
        for rs in self.replicas:
            rs.kill()
        for srv in self.servers:
            srv.shutdown(drain=False, timeout=5)


@pytest.fixture()
def fleets():
    made = []

    def make(replica_pkg, router_pkg=None):
        f = Fleet(replica_pkg, router_pkg)
        made.append(f)
        return f

    try:
        yield make
    finally:
        for f in made:
            f.close()


def _terminal_counts(flight, trace_ids):
    evs = flight.events(category="fleet")
    return {tid: sum(1 for e in evs if e.get("trace_id") == tid
                     and e["name"] in FLEET_TERMINAL) for tid in trace_ids}


# ---------------------------------------------------------------------------
# failover and fencing
# ---------------------------------------------------------------------------

def test_kill_one_of_three_mid_stream_bit_equal(pkg, fleets):
    """One of 3 replicas dies abruptly mid-stream (its sockets shut): every
    request finishes bit-equal to the oracle with one terminal fleet
    event, and the dead replica resurrects through its spawn factory."""
    pkg.flight.clear()
    f = fleets(pkg)

    def engine():
        return FakeCausalEngine(slots=4, max_seq=64, step_sleep=0.01)

    spawn = f.spawn(engine)
    for _ in range(3):
        f.add(engine(), spawn=spawn)
    router = f.route(policy="rr", heartbeat_seconds=0.05,
                     heartbeat_misses=2, quarantine_after=3,
                     restart_backoff=0.01, restart_backoff_cap=0.05,
                     max_restarts=5)
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    reqs = [router.submit(p, 40) for p in prompts]
    assert _wait_for(lambda: all(len(r["out"]) >= 2 for r in reqs), 10)
    assert not all(r["done"].is_set() for r in reqs)
    with router._lock:
        owners = {r["owner"][0] for r in router._inflight.values()
                  if r["owner"]}
    victim = next(h for h in f.handles if h.idx in owners)
    victim.kill_cb()
    for req, prompt in zip(reqs, prompts):
        assert req["done"].wait(30)
        assert req["error"] is None
        assert req["out"] == _oracle(prompt, 40)
    assert router.failovers >= 1
    counts = _terminal_counts(pkg.flight, [r["trace_id"] for r in reqs])
    assert set(counts.values()) == {1}, counts
    names = {e["name"] for e in pkg.flight.events(category="fleet")}
    assert {"replica_dead", "failover", "dispatch"} <= names
    assert _wait_for(lambda: router.stats()["live"] == 3, 10)
    assert victim.restarts >= 1
    assert router.generate([9, 9, 7], 6, timeout=30) == _oracle([9, 9, 7], 6)


def test_zombie_epoch_late_response_discarded(pkg, fleets):
    """A fenced replica's late poll answer is dropped by the epoch stamp
    and journaled; the failed-over stream stays bit-equal."""
    pkg.flight.clear()
    f = fleets(pkg)
    for _ in range(2):
        f.add(FakeCausalEngine(slots=2, max_seq=64, step_sleep=0.02))
    router = f.route(heartbeat_seconds=5.0, quarantine_after=5)
    req = router.submit([4, 2], 40)
    assert _wait_for(lambda: req["owner"] is not None
                     and len(req["out"]) >= 2, 10)
    stale_owner = req["owner"]
    zombie = f.handles[stale_owner[0]]
    router._replica_down(zombie, reason="test_fence")
    assert req["owner"][0] != zombie.idx, "failover did not move"
    router._apply(req, stale_owner, zombie, [123456], False, None)
    assert router.stale_drops >= 1
    assert 123456 not in req["out"]
    assert req["done"].wait(30)
    assert req["error"] is None
    assert req["out"] == _oracle([4, 2], 40)
    evs = pkg.flight.events(category="fleet")
    assert any(e["name"] == "stale_drop"
               and e.get("trace_id") == req["trace_id"] for e in evs)
    assert _terminal_counts(pkg.flight, [req["trace_id"]]) \
        == {req["trace_id"]: 1}


def test_poison_quarantined_after_two_replica_deaths(pkg, fleets):
    """A request active at quarantine_after replica deaths is failed as
    poison: one terminal event, counted, never dispatched again."""
    pkg.flight.clear()
    f = fleets(pkg)
    for _ in range(2):
        f.add(FakeCausalEngine(slots=2, max_seq=80, step_sleep=0.02))
    router = f.route(heartbeat_seconds=5.0, quarantine_after=2)
    req = router.submit([7, 7, 7], 60)
    assert _wait_for(lambda: req["owner"] is not None, 10)
    first = f.handles[req["owner"][0]]
    router._replica_down(first, reason="death_one")
    assert not req["done"].is_set()
    assert req["strikes"] == 1
    second = f.handles[req["owner"][0]]
    assert second.idx != first.idx
    router._replica_down(second, reason="death_two")
    assert req["done"].wait(5)
    assert isinstance(req["error"], RuntimeError)
    assert "poison" in str(req["error"])
    assert router.quarantined == 1
    assert any(e["name"] == "quarantined"
               and e.get("trace_id") == req["trace_id"]
               for e in pkg.flight.events(category="fleet"))
    assert _terminal_counts(pkg.flight, [req["trace_id"]]) \
        == {req["trace_id"]: 1}


# ---------------------------------------------------------------------------
# placement and shedding
# ---------------------------------------------------------------------------

def _placement_run(pkg, fleets, policy):
    """Replica 0 KV-starved by a hog holding its whole pool; returns
    (admitted without deferral, placed on the starved replica) for 6
    short requests."""
    f = fleets(pkg)
    for i in range(3):
        eng = FakePagedEngine(pkg.cache, slots=2, max_seq=64, block_size=8,
                              num_blocks=(6 if i == 0 else 32))
        eng.step_sleep = 0.01
        f.add(eng, policy=StubLevelPolicy(0))
    router = f.route(policy=policy, heartbeat_seconds=5.0)
    hog = f.servers[0].submit([3] * 8, 40)
    assert _wait_for(
        lambda: f.servers[0].engine._kv.available_blocks() == 0, 5)
    for h in f.handles:
        h.health = h.probe_health(1.0)
    assert f.handles[0].health["blocks_free"] == 0
    assert f.handles[1].health["blocks_free"] == 32
    prompts = [[i + 1, i + 2, 5] for i in range(6)]
    reqs = [router.submit(p, 4) for p in prompts]
    for req, prompt in zip(reqs, prompts):
        assert req["done"].wait(30)
        assert req["error"] is None
        assert req["out"] == _oracle(prompt, 4)
    assert hog["done"].wait(30)
    deferred = f.handles[0].dispatched
    return 6 - deferred, deferred


def test_pressure_placement_beats_round_robin(pkg, fleets):
    """Under a KV-starved replica the pressure policy admits strictly
    more requests without deferral than round-robin and sends the
    starved replica nothing."""
    pressure_score, pressure_deferred = _placement_run(pkg, fleets,
                                                       "pressure")
    rr_score, rr_deferred = _placement_run(pkg, fleets, "rr")
    assert pressure_deferred == 0
    assert rr_deferred >= 1
    assert pressure_score > rr_score


def test_shed_only_when_every_replica_at_level3(pkg, fleets):
    pkg.flight.clear()
    f = fleets(pkg)
    for _ in range(3):
        f.add(FakeCausalEngine(slots=2, max_seq=64),
              policy=StubLevelPolicy(3))
    router = f.route(heartbeat_seconds=5.0, retry_after=0.25)
    for h in f.handles:
        h.health = h.probe_health(1.0)
    with pytest.raises(pkg.fleet.FleetSaturated) as exc:
        router.submit([1, 2], 4)
    assert exc.value.retry_after == 0.25
    assert router.shed == 1
    assert any(e["name"] == "fleet_shed"
               and e["attrs"].get("retry_after") == 0.25
               for e in pkg.flight.events(category="fleet"))
    # one replica below hard shed reopens the fleet, and takes the work
    f.servers[1].policy.level = 0
    f.handles[1].health = f.handles[1].probe_health(1.0)
    assert router.generate([2, 4, 6], 5, timeout=30) == _oracle([2, 4, 6], 5)
    assert f.handles[1].dispatched == 1
    assert f.handles[0].dispatched == f.handles[2].dispatched == 0


# ---------------------------------------------------------------------------
# /healthz — one source of truth with the router probe
# ---------------------------------------------------------------------------

def test_health_snapshot_and_healthz(pkg):
    srv = pkg.server(FakeCausalEngine(slots=2, max_seq=64))
    paged = pkg.server(FakePagedEngine(pkg.cache, slots=2, max_seq=64,
                                       num_blocks=8))
    bad = pkg.server(FakeCausalEngine(slots=2, max_seq=64),
                     policy=StubLevelPolicy(3))
    try:
        snap = pkg.fleet.health_snapshot(srv)
        assert snap["ok"] and snap["loop_alive"]
        assert snap["blocks_total"] == -1
        psnap = pkg.fleet.health_snapshot(paged)
        assert (psnap["blocks_total"], psnap["blocks_free"]) == (8, 8)
        ep = srv.metrics_endpoint(port=0)
        with urllib.request.urlopen(f"http://127.0.0.1:{ep.port}/healthz",
                                    timeout=5) as resp:
            body = json.loads(resp.read())
        assert resp.status == 200 and body["ok"] and body["level"] == 0
        ep2 = bad.metrics_endpoint(port=0)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{ep2.port}/healthz",
                                   timeout=5)
        assert exc.value.code == 503
        body = json.loads(exc.value.read())
        assert not body["ok"] and body["level"] == 3
    finally:
        for s in (srv, paged, bad):
            s.shutdown(drain=False, timeout=5)


# ---------------------------------------------------------------------------
# framing under the chaos transport
# ---------------------------------------------------------------------------

def test_framing_and_flaky_transport(pkg, fleets):
    """Frames survive the wire whole (unicode, many in a row); a
    truncated or oversized frame is a ConnectionError; a heartbeat
    through FlakyTransport takes its armed delay and a dropped answer
    times out as a miss, while the data connection is untouched."""
    a, b = socket.socketpair()
    try:
        ca, cb = pkg.fleet.FrameConn(a), pkg.fleet.FrameConn(b)
        for i in range(3):
            ca.send({"op": "x", "i": i, "s": "ünïcode"})
        assert [cb.recv()["i"] for _ in range(3)] == [0, 1, 2]
        a.sendall(struct.pack(">I", 10) + b"{}")
        a.shutdown(socket.SHUT_WR)
        with pytest.raises(ConnectionError):
            cb.recv()
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", (1 << 30) + 1))
        with pytest.raises(ConnectionError):
            pkg.fleet.FrameConn(b).recv()
    finally:
        a.close()
        b.close()
    f = fleets(pkg)
    f.add(FakeCausalEngine(slots=2, max_seq=64))
    h = f.handles[0]
    pkg.fi.inject_transport("fleet.hb.r0.recv", delay=0.05, times=1)
    t0 = time.monotonic()
    assert h.probe_health(2.0)["ok"]
    assert time.monotonic() - t0 >= 0.05
    pkg.fi.inject_transport("fleet.hb.r0.recv", drop=True, times=1)
    with pytest.raises((OSError, socket.timeout, ConnectionError)):
        h.probe_health(0.2)
    assert h.call({"op": "health"})["health"]["ok"]
    h.drop_conn()


# ---------------------------------------------------------------------------
# across the packages, over the same wire
# ---------------------------------------------------------------------------

def _cross_run(replica_pkg, router_pkg, fleets):
    """3 requests over 2 replicas (round-robin); replica 0 is fenced
    once every request streams. -> (streams, fleet event names per
    request, counters)."""
    router_pkg.flight.clear()
    f = fleets(replica_pkg, router_pkg)
    for _ in range(2):
        f.add(FakeCausalEngine(slots=2, max_seq=64, step_sleep=0.01))
    router = f.route(policy="rr", heartbeat_seconds=5.0,
                     quarantine_after=3)
    prompts = [[3, 1, 4], [1, 5, 9], [2, 6, 5]]
    reqs = [router.submit(p, 50) for p in prompts]
    assert _wait_for(lambda: all(len(r["out"]) >= 2 for r in reqs), 10)
    router._replica_down(f.handles[0], reason="test_fence")
    for r in reqs:
        assert r["done"].wait(30)
        assert r["error"] is None
    evs = router_pkg.flight.events(category="fleet")
    keep = {"submit", "dispatch", "failover", "finished", "failed"}
    trail = [[e["name"] for e in evs if e.get("trace_id") == r["trace_id"]
              and e["name"] in keep] for r in reqs]
    st = router.stats()
    counters = {k: st[k] for k in ("replicas", "live", "finished",
                                   "failed", "shed", "failovers",
                                   "quarantined")}
    return [list(r["out"]) for r in reqs], trail, counters


def test_routers_drive_the_other_package_replicas(fleets):
    """A port router over JAX ReplicaServers and a JAX router over port
    ReplicaServers, on real sockets: the same streams (the oracle's),
    the same fleet events per request and the same counters, in both
    directions and as each package over its own replicas."""
    runs = {(r, f): _cross_run(PKGS[r], PKGS[f], fleets)
            for r, f in (("jax", "port"), ("port", "jax"),
                         ("port", "port"))}
    want = [_oracle(p, 50) for p in ([3, 1, 4], [1, 5, 9], [2, 6, 5])]
    for key, (streams, trail, counters) in runs.items():
        assert streams == want, key
    assert len({json.dumps(v[1:]) for v in runs.values()}) == 1, runs
    trail, counters = runs[("port", "port")][1:]
    assert trail[0] == ["submit", "dispatch", "failover", "dispatch",
                        "finished"]
    assert trail[1] == ["submit", "dispatch", "finished"]
    assert counters["failovers"] == 2 and counters["finished"] == 3


# ---------------------------------------------------------------------------
# real engines: the JAX engine's streams through a port fleet
# ---------------------------------------------------------------------------

GEO = dict(max_slots=2, max_seq=64, block_size=8, prefill_chunk=8)
REQUESTS = (([5, 9, 11, 3, 4, 5, 6, 7, 8, 10], 12), ([2, 4], 10),
            ([7, 1, 3, 8], 14), ([6, 6, 2, 1, 9], 9))


@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(31)
    jm = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm.named_parameters()})
    return jm, tm


def test_port_replicas_fail_over_bit_equal_to_the_jax_engine(
        llama_pair, fleets):
    """Two in-process port replicas over f32 CPU paged engines with the
    JAX tiny Llama's weights; one dies mid-stream; every stream equals
    the JAX engine's greedy stream of the same request."""
    jm, tm = llama_pair
    jeng = jserving.PagedLlamaDecodeEngine(jm, **GEO)
    want = [jeng.generate(np.asarray(p), n) for p, n in REQUESTS]
    port = PKGS["port"]
    port.flight.clear()
    f = fleets(port)
    for _ in range(2):
        eng = tserving.PagedLlamaDecodeEngine(tm, device="cpu", **GEO)
        step = eng.step

        def slow_step(step=step):   # streams last long enough to kill
            time.sleep(0.02)
            return step()

        eng.step = slow_step
        f.add(eng)
    router = f.route(policy="rr", heartbeat_seconds=5.0)
    reqs = [router.submit(p, n) for p, n in REQUESTS]
    assert _wait_for(lambda: len(reqs[0]["out"]) >= 2, 30)
    f.handles[reqs[0]["owner"][0]].kill_cb()
    for r, w in zip(reqs, want):
        assert r["done"].wait(60)
        assert r["error"] is None
        assert list(r["out"]) == w
    assert router.failovers >= 1
    counts = _terminal_counts(port.flight, [r["trace_id"] for r in reqs])
    assert set(counts.values()) == {1}


def test_kill_ends_the_accept_thread_within_2s():
    """``kill()`` shuts the listener down before closing it: the accept
    thread (and a connection's thread) end at once."""
    srv = tserving.GenerationServer(FakeCausalEngine(slots=2, max_seq=64))
    rs = tfleet.ReplicaServer(srv)
    try:
        c = tfleet._connect(rs.host, rs.port)
        c.send({"op": "health"})
        assert c.recv()["ok"]
        assert len(rs._threads) == 1
        t0 = time.monotonic()
        rs.kill()
        rs._accept_thread.join(2.0)
        assert not rs._accept_thread.is_alive()
        assert time.monotonic() - t0 < 2.0
        assert not any(t.is_alive() for t in rs._threads)
        c.close()
    finally:
        srv.shutdown(drain=False, timeout=5)


def test_bf16_prepare_swap_round_trip_is_bit_exact():
    """A bf16 state dict through ``prepare_swap`` reaches the replica's
    prepared tree bit for bit (NaN payloads, -0.0, inf, subnormals
    included); the JAX package's bf16 npy decodes to the same bits."""
    import ml_dtypes
    bits = torch.tensor([0x7FC1, 0xFFC0, 0x8000, 0x0000, 0x7F80, 0xFF80,
                         0x0001, 0x8001, 0x3F80, 0x1234],
                        dtype=torch.int32).to(torch.int16)
    special = bits.view(torch.bfloat16)
    dec = tfleet._decode_array(tfleet._encode_array(special))
    assert dec.dtype == torch.bfloat16
    assert torch.equal(dec.view(torch.int16), bits)
    jax_rec = jfleet._encode_array(
        bits.numpy().view(ml_dtypes.bfloat16))
    assert torch.equal(tfleet._decode_array(jax_rec).view(torch.int16),
                       bits)
    f32 = np.linspace(-2, 2, 7, dtype=np.float32)
    assert tfleet._encode_array(f32) == jfleet._encode_array(f32)

    cfg = LlamaConfig.tiny(**{**CFG, "dtype": "bfloat16"})
    model = LlamaForCausalLM(cfg, device="cpu")
    srv = tserving.GenerationServer(tserving.PagedLlamaDecodeEngine(
        model, device="cpu", **GEO))
    rs = tfleet.ReplicaServer(srv)
    cli = tfleet.ReplicaClient(rs.host, rs.port, timeout=30)
    try:
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        sd["llama.norm.weight"][:bits.numel()] = special
        prep = cli.engine.prepare_swap(sd)
        assert prep.nonfinite == 4
        tree = rs._prepared[prep.token]
        assert torch.equal(tree["norm"].view(torch.int16),
                           sd["llama.norm.weight"].view(torch.int16))
        assert torch.equal(tree["layers"][1]["q_proj"].view(torch.int16),
                           sd["llama.layers.1.self_attn.q_proj.weight"]
                           .view(torch.int16))
    finally:
        cli.close()
        rs.close(drain=False, timeout=5)


def test_subprocess_replicas_from_a_jax_pdmodel(llama_pair, tmp_path):
    """A replica process on the CPU boots a ``.pdmodel`` the JAX package
    saved and answers the JAX engine's greedy stream; in a fleet of two
    a SIGKILLed replica is resurrected and serves it again. Bounded at
    60 s."""
    t_start = time.monotonic()
    jm, _ = llama_pair
    path = str(tmp_path / "llama")
    jinference.save_inference_model(path, jm)
    jeng = jserving.PagedLlamaDecodeEngine(jm, **GEO)
    prompt, n = REQUESTS[0]
    want = jeng.generate(np.asarray(prompt), n)
    cfg = {"model": {"kind": "inference_model", "path": path},
           "device": "cpu", **GEO}
    env = {"FLAGS_executable_cache_dir": str(tmp_path / "cache")}
    proc, port, boot = tfleet.launch_replica(cfg, env=env, timeout=40)
    try:
        assert boot["device"] == "cpu" and boot["pid"] == proc.pid
        assert boot["cache"] == {"hits": 0, "misses": 0, "writes": 0}
        cli = tfleet.ReplicaClient("127.0.0.1", port, timeout=30)
        try:
            assert cli.generate(prompt, n, timeout=30) == want
            cli._call({"op": "shutdown", "drain": True})
        finally:
            cli.close()
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr_log.close()
    router = tfleet.spawn_fleet(
        2, cfg, env=env, timeout=40,
        router_kwargs=dict(policy="rr", heartbeat_seconds=0.2,
                           heartbeat_misses=2, restart_backoff=0.05,
                           max_restarts=4))
    try:
        victim = router.replicas[1]
        old_pid = victim.pid
        os.kill(old_pid, signal.SIGKILL)
        reqs = [router.submit(prompt, n) for _ in range(2)]
        for r in reqs:
            assert r["done"].wait(30)
            assert r["error"] is None and r["out"] == want
        assert _wait_for(lambda: router.stats()["live"] == 2, 30)
        assert victim.restarts >= 1 and victim.pid != old_pid
        assert victim.boot["pid"] == victim.pid
        with router._lock:
            router._rr_next = 1   # the next request goes to replica 1
        assert router.generate(prompt, n, timeout=30) == want
        assert victim.dispatched >= 1
    finally:
        router.shutdown(drain=False, timeout=20)
    assert all(h.proc.poll() is not None for h in router.replicas)
    assert time.monotonic() - t_start < 60
