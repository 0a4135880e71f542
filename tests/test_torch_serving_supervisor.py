"""The supervised decode loop and canary rollout: the port's
``serving_supervisor`` and ``GenerationServer`` seams against the JAX
package's, on the tiny f32 Llama of test_torch_serving.py (weights
carried across with ``convert.load_from_jax``) and on engine fakes that
import neither JAX nor torch.

The JAX contract holds in both packages: a ``KillPoint`` that crashes
the decode loop mid-stream is recovered by the supervisor, and each
recovered greedy stream equals an uninterrupted run bit for bit (its
committed tokens re-prefill as the prompt); every request ends with
exactly one terminal flight event. The fakes drive the mechanics —
quarantine, backoff and give-up, double recovery, the stall watchdog's
fence, the gauges after an unsupervised crash — through both packages'
servers, and the two packages' ``supervisor`` events and ``rollout``
reports must agree.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jserving
from paddle_tpu import serving_cache as jcache
from paddle_tpu import serving_supervisor as jsup
from paddle_tpu.framework import checkpoint as jckpt
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import metrics as jom
from paddle_tpu.utils import backoff as jbackoff
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import serving_cache as tcache
from paddle_tpu_torch import serving_supervisor as tsup
from paddle_tpu_torch.convert import load_from_jax
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import checkpoint as tckpt
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import metrics as tom
from paddle_tpu_torch.utils import backoff as tbackoff
from paddle_tpu_torch.utils import fault_injection as tfi

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, use_flash_attention=False)
GEO = dict(max_slots=2, max_seq=64, block_size=8, prefill_chunk=8)
REQUESTS = (([5, 9, 11], 7), ([2, 4], 6), ([7, 1, 3, 8], 5))
TERMINAL = {"finished", "expired", "failed"}

PKGS = {
    "jax": SimpleNamespace(
        name="jax", server=jserving.GenerationServer,
        supervise=jsup.supervise, rollout=jsup.rollout,
        policy=jsup.RolloutPolicy, fi=jfi, flight=jflight,
        backoff=jbackoff, registry=jom.default_registry,
        cache=jcache.PagedKVCache, set_flags=paddle.set_flags,
        get_flags=paddle.get_flags, save=jckpt.atomic_save),
    "port": SimpleNamespace(
        name="port", server=tserving.GenerationServer,
        supervise=tsup.supervise, rollout=tsup.rollout,
        policy=tsup.RolloutPolicy, fi=tfi, flight=tflight,
        backoff=tbackoff, registry=tom.default_registry,
        cache=tcache.PagedKVCache, set_flags=tflags.set_flags,
        get_flags=tflags.get_flags, save=tckpt.atomic_save),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def quiet_threads():
    """The seeded KillPoints die through threading.excepthook: keep the
    tracebacks out of the log, and disarm every site afterwards."""
    prev = threading.excepthook
    threading.excepthook = lambda args: None
    try:
        yield
    finally:
        threading.excepthook = prev
        jfi.clear()
        tfi.clear()


@pytest.fixture()
def dump_dir(tmp_path):
    """Both packages' flight dumps under the test's directory."""
    prev = [p.get_flags("FLAGS_flight_dump_dir") for p in PKGS.values()]
    for p in PKGS.values():
        p.set_flags({"FLAGS_flight_dump_dir": str(tmp_path)})
    try:
        yield str(tmp_path)
    finally:
        for p, flags in zip(PKGS.values(), prev):
            p.set_flags(flags)


def _pair(seed):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_from_jax(tm, {k: np.asarray(v._data)
                       for k, v in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """Weight sets A and B: (jax model, port model) each."""
    return _pair(11), _pair(23)


def _engine(name, models, draft=False, **kw):
    jm, tm = models[0]
    geo = {**GEO, **kw}
    if name == "jax":
        eng = jserving.PagedLlamaDecodeEngine(jm, **geo)
        if draft:
            eng.attach_draft(eng.make_draft(jm, num_layers=1),
                             spec_tokens=3)
        return eng
    eng = tserving.PagedLlamaDecodeEngine(tm, device="cpu", **geo)
    if draft:
        eng.attach_draft(eng.make_draft(num_layers=1), spec_tokens=3)
    return eng


@pytest.fixture(scope="module")
def oracle(models):
    """The port's uninterrupted streams of REQUESTS (a plain engine)."""
    srv = tserving.GenerationServer(_engine("port", models))
    try:
        reqs = [srv.submit(p, n) for p, n in REQUESTS]
        for r in reqs:
            assert r["done"].wait(60) and r["error"] is None
        return [list(r["out"]) for r in reqs]
    finally:
        assert srv.shutdown(timeout=60)


def _terminal_counts(flight, trace_ids):
    evs = flight.events(category="serving")
    return {tid: sum(1 for e in evs if e.get("trace_id") == tid
                     and e["name"] in TERMINAL) for tid in trace_ids}


def _kill_in_verify(p, eng):
    """Arm-able site inside spec_step: after the draft proposed, before
    the target verifies."""
    verify = eng._spec_verify

    def wrapped(*a, **k):
        p.fi.fire("test.spec_verify")
        return verify(*a, **k)

    eng._spec_verify = wrapped


# ---------------------------------------------------------------------------
# the chaos kill on real paged engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
def test_chaos_kill_streams_bit_equal(models, oracle, dump_dir, draft):
    """Both packages' supervised servers take the same kill: mid-decode
    (the third decode passage), or with a draft attached inside a
    spec_step (the second verify). Every stream of both equals the
    port's uninterrupted run; one restart, no quarantine, one terminal
    event a request, the loop death journaled and dumped, and the pool
    clean after a fresh request."""
    streams = {}
    for name in sorted(PKGS):
        p = PKGS[name]
        p.flight.clear()
        eng = _engine(name, models, draft=draft)
        if draft:
            _kill_in_verify(p, eng)
            p.fi.inject("test.spec_verify", kill=True, skip=1)
        else:
            p.fi.inject("serving.decode", kill=True, skip=2)
        srv = p.server(eng)
        sup = p.supervise(srv, backoff=0.01)
        try:
            reqs = [srv.submit(pr, n) for pr, n in REQUESTS]
            for r in reqs:
                assert r["done"].wait(60), srv.stats()
                assert r["error"] is None, r["error"]
            streams[name] = [list(r["out"]) for r in reqs]
            assert sup.restarts == 1 and sup.quarantined == 0
            assert sup.recovered >= 1
            assert srv.stats()["loop_restarts"] == 1
            assert srv.stats()["recovered"] == sup.recovered
            counts = _terminal_counts(p.flight,
                                      [r["trace_id"] for r in reqs])
            assert set(counts.values()) == {1}, counts
            names = [e["name"]
                     for e in p.flight.events(category="supervisor")]
            assert {"loop_death", "recover", "restart"} <= set(names)
            assert p.flight.find_dumps(dump_dir)
            assert len(srv.generate([6, 2], 4, timeout=60)) == 4
        finally:
            sup.stop()
            assert srv.shutdown(timeout=60)
        st = eng._kv.stats()
        assert st["blocks_reserved"] == 0
        eng._kv.check_invariants()
    assert streams["port"] == oracle
    assert streams["jax"] == oracle


# ---------------------------------------------------------------------------
# mechanics on engine fakes, through both packages' servers
# ---------------------------------------------------------------------------

class FakeCausalEngine:
    """Duck-typed engine whose next token is a pure function of the
    WHOLE sequence so far, so prefill(prompt + committed) resumes as the
    real causal engines do."""

    def __init__(self, slots=2, max_seq=64, step_sleep=0.0):
        self.max_slots, self.max_seq, self.eos_id = slots, max_seq, None
        self.step_sleep = step_sleep
        self.active = np.zeros(slots, bool)
        self.pos = np.zeros(slots, np.int64)
        self._seq = {}

    @staticmethod
    def _next(seq):
        return (sum(seq) * 7 + len(seq)) % 997

    def prefill(self, slot, prompt):
        seq = [int(t) for t in np.asarray(prompt).reshape(-1)]
        tok = self._next(seq)
        self._seq[slot] = seq + [tok]
        self.pos[slot] = len(self._seq[slot])
        self.active[slot] = True
        return tok

    def step(self):
        if self.step_sleep:
            time.sleep(self.step_sleep)
        out = np.zeros(self.max_slots, np.int64)
        for s in range(self.max_slots):
            if self.active[s]:
                tok = self._next(self._seq[s])
                self._seq[s].append(tok)
                self.pos[s] += 1
                out[s] = tok
        return out

    def release(self, slot, evicted=False):
        self.active[slot] = False
        self.pos[slot] = 0
        self._seq.pop(slot, None)

    def reset_state(self):
        self.active[:] = False
        self.pos[:] = 0
        self._seq.clear()


class FakePagedEngine(FakeCausalEngine):
    """The causal fake over a real PagedKVCache (host bookkeeping of
    the package under test), so the paged server path and its block
    gauges are genuine."""

    paged = True

    def __init__(self, cache_cls, slots=2, max_seq=64, block_size=8,
                 num_blocks=8):
        super().__init__(slots=slots, max_seq=max_seq)
        self._kv = cache_cls(max_slots=slots, max_seq=max_seq,
                             block_size=block_size, num_blocks=num_blocks)
        self._prefill_state = {}
        self._spec_suppressed = False
        self._chunk_cap = None

    def spec_ready(self):
        return False

    def begin_request(self, slot, prompt, budget):
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        total = min(len(prompt) + max(int(budget), 1), self.max_seq)
        if not self._kv.admit(slot, len(prompt), total):
            return False
        self._prefill_state[slot] = prompt
        self.active[slot] = False
        return True

    def prefill_chunk(self, slot):
        seq = self._prefill_state.pop(slot)
        tok = self._next(seq)
        self._seq[slot] = seq + [tok]
        self.pos[slot] = len(seq)
        self.active[slot] = True
        return tok

    def step(self):
        for s in range(self.max_slots):
            if self.active[s]:
                self._kv.ensure_token(s, int(self.pos[s]))
        return super().step()

    def release(self, slot, evicted=False):
        super().release(slot, evicted=evicted)
        self._prefill_state.pop(slot, None)
        self._kv.release(slot, evicted=evicted)

    def reset_state(self):
        for s in range(self.max_slots):
            self._kv.release(s, evicted=True)
        self._prefill_state.clear()
        super().reset_state()


def _uninterrupted(pkg, prompt, n):
    srv = pkg.server(FakeCausalEngine())
    try:
        return srv.generate(prompt, n, timeout=30)
    finally:
        assert srv.shutdown(timeout=10)


def _wait_for(cond, timeout=10.0):
    t_end = time.monotonic() + timeout
    while not cond() and time.monotonic() < t_end:
        time.sleep(0.005)
    return cond()


def test_quarantine_repeat_offender(pkg, dump_dir):
    """A request active at two consecutive deaths is failed with
    reason=poison instead of re-admitted; the loop serves on."""
    pkg.flight.clear()
    srv = pkg.server(FakeCausalEngine())
    sup = pkg.supervise(srv, backoff=0.01, quarantine_after=2)
    try:
        pkg.fi.inject("serving.decode", kill=True, times=2, skip=1)
        req = srv.submit([5, 6], max_new_tokens=20)
        assert req["done"].wait(30)
        assert isinstance(req["error"], RuntimeError)
        assert "poison" in str(req["error"])
        assert _wait_for(lambda: sup.restarts >= 2)
        assert sup.quarantined == 1 and sup.restarts == 2
        quar = [e for e in pkg.flight.events(category="supervisor")
                if e["name"] == "quarantine"]
        assert quar[-1]["attrs"]["reason"] == "poison"
        assert quar[-1]["trace_id"] == req["trace_id"]
        assert _terminal_counts(pkg.flight, [req["trace_id"]]) \
            == {req["trace_id"]: 1}
        assert srv.stats()["quarantined"] == 1
        assert len(srv.generate([7], 3, timeout=30)) == 3
    finally:
        sup.stop()
        srv.shutdown(timeout=10)


def test_backoff_schedule_and_give_up(pkg, dump_dir):
    """Every decode passage dies: the restarts back off on the bounded
    exponential schedule (deterministic with the jitter off), and the
    supervisor gives up after max_restarts, failing what is pending and
    closing the intake."""
    pkg.flight.clear()
    prev = pkg.get_flags("FLAGS_backoff_full_jitter")
    pkg.set_flags({"FLAGS_backoff_full_jitter": False})
    srv = pkg.server(FakeCausalEngine())
    sup = pkg.supervise(srv, backoff=0.005, backoff_cap=0.012,
                        max_restarts=3, quarantine_after=99)
    try:
        pkg.fi.inject("serving.decode", kill=True, times=100)
        req = srv.submit([3], max_new_tokens=5)
        assert req["done"].wait(30)
        assert "gave up" in str(req["error"])
        assert sup.gave_up and sup.restarts == 3
        evs = pkg.flight.events(category="supervisor")
        assert [e["attrs"]["backoff"] for e in evs
                if e["name"] == "restart"] == [0.005, 0.01, 0.012]
        assert [e["attrs"]["streak"] for e in evs
                if e["name"] == "loop_death"] == [1, 2, 3, 4]
        assert evs[-1]["name"] == "give_up"
        with pytest.raises(RuntimeError, match="shutting down"):
            srv.submit([1], max_new_tokens=2)
        assert srv.shutdown(timeout=5)
    finally:
        pkg.set_flags(prev)
        sup.stop()


def test_double_recovery_stays_bit_equal(pkg, dump_dir):
    """A request recovered twice resumes bit-equal: each recovery folds
    only the tokens committed since the last one into the prompt."""
    srv = pkg.server(FakeCausalEngine())
    sup = pkg.supervise(srv, backoff=0.01, quarantine_after=3)
    try:
        pkg.fi.inject("serving.decode", kill=True, times=2, skip=2)
        req = srv.submit([8, 3], max_new_tokens=10)
        assert req["done"].wait(30)
        assert req["error"] is None
        assert list(req["out"]) == _uninterrupted(pkg, [8, 3], 10)
        assert sup.restarts == 2 and sup.quarantined == 0
        assert sup.recovered == 2
    finally:
        sup.stop()
        srv.shutdown(timeout=10)


def test_stall_watchdog_fences_and_recovers(pkg, dump_dir):
    """A loop that is alive but wedged (heartbeat stale while holding
    work) is fenced and replaced; the zombie exits through the fence when
    it wakes, committing nothing, and the stream resumes bit-equal."""
    pkg.flight.clear()

    class StallEngine(FakeCausalEngine):
        def __init__(self):
            super().__init__()
            self.gate = threading.Event()
            self.calls = 0

        def step(self):
            self.calls += 1
            if self.calls == 3:
                self.gate.wait(30)  # the zombie parks here
            return super().step()

    eng = StallEngine()
    srv = pkg.server(eng)
    # the zombie-to-be is this server's first loop thread (other files'
    # servers may leave idle loop threads of their own in this process)
    zombie = srv._thread
    sup = pkg.supervise(srv, backoff=0.01, stall_seconds=0.5, poll=0.02)
    try:
        req = srv.submit([4, 2], max_new_tokens=8)
        assert req["done"].wait(30)
        assert req["error"] is None
        steps = srv.steps_run
        assert zombie is not srv._thread and zombie.is_alive()
        eng.gate.set()  # wake the zombie: the fence retires it
        zombie.join(10)
        assert not zombie.is_alive()
        assert srv.steps_run == steps
        assert list(req["out"]) == _uninterrupted(pkg, [4, 2], 8)
        assert sup.stalls == 1 and sup.restarts == 1
        assert srv.stats()["loop_restarts"] == 1
        assert _terminal_counts(pkg.flight, [req["trace_id"]]) \
            == {req["trace_id"]: 1}
    finally:
        eng.gate.set()
        sup.stop()
        srv.shutdown(timeout=10)


def test_gauges_true_after_unsupervised_crash(pkg):
    """With no supervisor, a KillPoint kills the loop; the gauges read
    the wreckage (the victim still holds its slot and blocks), not what
    the last step boundary wrote."""
    pkg.flight.clear()
    eng = FakePagedEngine(pkg.cache)
    srv = pkg.server(eng)
    try:
        pkg.fi.inject("serving.decode", kill=True)
        req = srv.submit([9, 8, 7], max_new_tokens=6)
        assert _wait_for(lambda: not srv._thread.is_alive(), 30)
        assert srv.stats()["crashed"] == 1
        assert not req["done"].is_set()
        reg = pkg.registry()
        assert reg.get("serving.in_flight").value() == 1.0
        assert reg.get("serving.queue_depth").value() == 0.0
        assert reg.get("serving.blocks_used").value() > 0
        crashes = [e for e in pkg.flight.events(category="serving")
                   if e["name"] == "loop_crashed"]
        assert crashes[-1]["attrs"]["error"] == "KillPoint"
    finally:
        srv.shutdown(drain=False, timeout=0.5)


def test_supervisor_events_equal_between_packages(dump_dir):
    """The same deaths on both packages (a kill, a recovery, a second
    kill that quarantines, then a healthy request) journal the same
    supervisor events: names and attributes, timestamps aside, with the
    seeded jitter drawing the same backoffs."""
    trails = {}
    for name in sorted(PKGS):
        p = PKGS[name]
        p.flight.clear()
        p.backoff.seed(5)
        srv = p.server(FakeCausalEngine())
        sup = p.supervise(srv, backoff=0.01, quarantine_after=2)
        try:
            p.fi.inject("serving.decode", kill=True, times=2, skip=1)
            req = srv.submit([5, 6], max_new_tokens=20)
            assert req["done"].wait(30)
            assert _wait_for(lambda: sup.restarts >= 2)
            assert len(srv.generate([7], 3, timeout=30)) == 3
        finally:
            sup.stop()
            srv.shutdown(timeout=10)
        evs = p.flight.events(category="supervisor")
        tid = {req["trace_id"]: "victim"}
        trails[name] = [(e["name"], e.get("attrs"),
                         tid.get(e.get("trace_id"), e.get("trace_id")))
                        for e in evs]
    assert [t[0] for t in trails["port"]] == [
        "attached", "loop_death", "recover", "restart", "loop_death",
        "quarantine", "restart"]
    assert trails["port"] == trails["jax"]


# ---------------------------------------------------------------------------
# canary rollout
# ---------------------------------------------------------------------------

def _fleet(name, models):
    return [PKGS[name].server(_engine(name, models, max_slots=1))
            for _ in range(2)]


def _state_dicts(name, models):
    """Deploys: A (the fleet's own), B (another seed), A with NaN."""
    if name == "jax":
        sd = [dict(m[0].named_parameters()) for m in models]
        nan = {k: (v * float("nan") if k == "llama.norm.weight" else v)
               for k, v in sd[0].items()}
    else:
        sd = [dict(m[1].state_dict()) for m in models]
        nan = {k: (v * float("nan") if k == "llama.norm.weight" else v)
               for k, v in sd[0].items()}
    return sd[0], sd[1], nan


def _report_view(rep):
    out = dict(rep)
    out["stages"] = [{k: v for k, v in st.items() if k != "swap_seconds"}
                     for st in rep["stages"]]
    return out


def _rollouts(name, models, sources):
    """Run the three deploys on a fresh fleet of ``name``; each report,
    with the gates the JAX package's own test holds them to."""
    p = PKGS[name]
    servers = _fleet(name, models)
    pol = p.policy(probe_prompt=[1, 2, 3], probe_tokens=5,
                   max_divergence=0.0)
    reps = []
    try:
        baseline = servers[0].generate([1, 2, 3], 5, timeout=60)
        rep = p.rollout(sources[0], servers, pol)
        assert rep["swapped"] == 2 and not rep["halted"]
        assert rep["stages"][0]["divergence"] == 0.0
        reps.append(rep)
        before_1 = servers[1].engine.params
        rolled = p.registry().get("serving.rollout_rollbacks_total")
        rolled0 = rolled.value()
        rep = p.rollout(sources[1], servers, pol)
        assert rep["halted"] and rep["rolled_back"] == 1
        assert rep["reason"] == "probe_divergence"
        assert servers[1].engine.params is before_1
        assert rolled.value() == rolled0 + 1
        assert servers[0].generate([1, 2, 3], 5, timeout=60) == baseline
        reps.append(rep)
        nf = p.registry().get("serving.rollout_nonfinite_weights_total")
        nf0 = nf.value() if nf is not None else 0
        rep = p.rollout(sources[2], servers, pol)
        assert rep["halted"] and rep["swapped"] == 0
        assert rep["reason"] == "nonfinite_weights"
        nf = p.registry().get("serving.rollout_nonfinite_weights_total")
        assert nf.value() == nf0 + rep["stages"][0]["nonfinite"]
        assert servers[0].generate([1, 2, 3], 5, timeout=60) == baseline
        reps.append(rep)
        assert [s.stats()["weight_swaps"] for s in servers] == [3, 1]
    finally:
        for srv in servers:
            assert srv.shutdown(timeout=60)
    return baseline, [_report_view(r) for r in reps]


def test_rollout_reports_equal_between_packages(models):
    """The identical, other-seed and NaN state dicts: the same verdicts,
    probes, divergences and NaN counts in both packages; the canary's
    rollback is bit-equal and replica 2 is never swapped to B."""
    got = {name: _rollouts(name, models, _state_dicts(name, models))
           for name in sorted(PKGS)}
    assert got["port"] == got["jax"]
    assert got["port"][1][2]["stages"][0]["nonfinite"] == CFG["hidden_size"]


def test_rollout_from_checkpoint_paths(models, tmp_path):
    """The same three deploys from checkpoint files (each package's own
    layout, written by its own atomic_save) give the same reports as the
    state dicts did, seconds aside."""
    got = {}
    for name in sorted(PKGS):
        paths = []
        for i, sd in enumerate(_state_dicts(name, models)):
            path = str(tmp_path / f"{name}-{i}.pdckpt")
            PKGS[name].save({"model": sd, "step": i}, path)
            paths.append(path)
        got[name] = _rollouts(name, models, paths)
    assert got["port"] == got["jax"]
    assert got["port"] == _rollouts("port", models,
                                    _state_dicts("port", models))
