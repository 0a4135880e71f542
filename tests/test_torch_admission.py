"""Adaptive admission: the port's ``AdaptiveAdmissionPolicy`` against the
JAX package's on the same evidence.

Both policies read only what a server exports (free KV blocks, the
backlog, steps run and tokens delivered, ``_shed()``) and the host's
monotonic clock, so duck-typed stub servers and a patched
``time.monotonic`` (patched as the two policy modules see it, so that
no other code of the process runs on the fake clock) drive them step
by step with no thread and no engine. Every step boundary and every submit-side verdict must agree:
the pressure level, the brownout knobs installed on the server, the
journal (events, evidence and timestamps, in order) and the verdicts
(shed at level 3, the static floor, deadline rejection)."""
from types import SimpleNamespace

import pytest

from paddle_tpu import serving_supervisor as jsup
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch import serving_supervisor as tsup
from paddle_tpu_torch.core import flags as tflags


class _KV:
    def __init__(self, total):
        self.num_blocks = total
        self.avail = total

    def available_blocks(self):
        return self.avail


class _Q:
    def __init__(self):
        self.n = 0

    def qsize(self):
        return self.n


class _Engine:
    def __init__(self, total):
        self._kv = _KV(total)


class StubServer:
    """What the policies read of a GenerationServer, set by hand."""

    def __init__(self, total=32, paged=True):
        self._paged = paged
        self.engine = _Engine(total)
        self._q = _Q()
        self._waiting = []
        self._slots = {}
        self._prefilling = {}
        self.steps_run = 0
        self.tokens_delivered = 0
        self.static_shed = False
        self.brownouts = []

    def _shed(self):
        return self.static_shed

    def _apply_brownout(self, spec_off, chunk_cap):
        self.brownouts.append((spec_off, chunk_cap))

    def set(self, avail=None, queued=None, waiting=None, slots=None,
            steps=0, tokens=0, static_shed=None):
        if avail is not None:
            self.engine._kv.avail = avail
        if queued is not None:
            self._q.n = queued
        if waiting is not None:
            self._waiting = [object()] * waiting
        if slots is not None:
            self._slots = {s: None for s in range(slots)}
        if static_shed is not None:
            self.static_shed = static_shed
        self.steps_run += steps
        self.tokens_delivered += tokens


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _patch_clock(monkeypatch, clock):
    for mod in (jsup, tsup):
        monkeypatch.setattr(mod, "time", SimpleNamespace(monotonic=clock))


# one scenario: (dt seconds, evidence, submits [(prompt, max_new,
# deadline)]) per step boundary — normal load, starvation with a
# growing backlog (the staircase up to shed), the drain (the staircase
# down), an idle gap longer than the rate window, the static floor,
# deadline rejection at the measured rate and the submit-side release
SCENARIO = [
    (0.05, dict(avail=30, queued=0, slots=4, steps=1, tokens=4), []),
    (0.05, dict(avail=28, steps=1, tokens=4), [(16, 8, None)]),
    (0.05, dict(avail=20, steps=1, tokens=4), [(16, 8, 10.0)]),
    (0.05, dict(avail=3, queued=1, steps=1, tokens=4), [(16, 8, None)]),
    (0.05, dict(avail=2, queued=2, waiting=1, steps=1, tokens=8),
     [(16, 8, None), (16, 64, 0.5)]),
    (0.05, dict(avail=0, queued=4, waiting=1, steps=1, tokens=8), []),
    (0.05, dict(avail=0, queued=6, waiting=1, steps=1, tokens=4),
     [(16, 8, None), (4, 4, 60.0)]),
    (0.05, dict(avail=0, queued=6, waiting=1, steps=1, tokens=4),
     [(16, 8, None)]),
    (0.05, dict(avail=1, queued=3, waiting=1, steps=1, tokens=4), []),
    (0.05, dict(avail=6, queued=0, waiting=0, steps=1, tokens=8), []),
    (0.05, dict(avail=20, steps=1, tokens=8), []),
    (0.05, dict(avail=28, steps=1, tokens=8), []),
    (0.05, dict(avail=30, steps=1, tokens=8), [(16, 8, 1.0)]),
    (0.05, dict(avail=30, steps=1, tokens=8), []),
    (45.0, dict(avail=30, steps=1, tokens=8), [(16, 40, 0.2)]),
    (0.05, dict(avail=30, steps=0, tokens=0), [(16, 40, 0.2)]),
    (0.05, dict(avail=30, static_shed=True, steps=1, tokens=4),
     [(16, 8, None)]),
    (0.05, dict(avail=30, static_shed=False, steps=1, tokens=4),
     [(8, 2, 5.0), (8, 400, 5.0)]),
    (0.05, dict(avail=1, queued=2, waiting=1, steps=1, tokens=4), []),
    (0.05, dict(avail=0, queued=3, waiting=1, steps=1, tokens=4), []),
    (0.05, dict(avail=30, queued=0, waiting=0, steps=0, tokens=0),
     [(16, 8, None)]),
]


def _run(mod, clock, monkeypatch, **kw):
    _patch_clock(monkeypatch, clock)
    clock.t = 1000.0
    pol = mod.AdaptiveAdmissionPolicy(**kw)
    srv = StubServer()
    trace = []
    for dt, evidence, submits in SCENARIO:
        clock.t += dt
        srv.set(**evidence)
        pol.on_step(srv)
        verdicts = []
        for prompt, max_new, deadline in submits:
            clock.t += 0.001
            verdicts.append(pol.admit_verdict(srv, prompt, max_new,
                                              deadline))
        trace.append((pol.level, list(srv.brownouts), verdicts,
                      pol._ewma_rps))
    return trace, pol.journal()


@pytest.mark.parametrize("kw", [
    {}, dict(alpha=0.9, starve_frac=0.25, queue_bound=2),
    dict(alpha=0.3, brownout_chunk=16, deadline_margin=2.0, min_steps=1,
         rate_window=10.0, journal_cap=8)],
    ids=["defaults", "eager", "smoothed"])
def test_levels_journal_and_verdicts_match_jax(kw, monkeypatch):
    clock = Clock()
    want, want_journal = _run(jsup, clock, monkeypatch, **kw)
    got, got_journal = _run(tsup, clock, monkeypatch, **kw)
    assert got == want
    assert got_journal == want_journal
    events = [e["event"] for e in got_journal]
    if not kw:
        # the whole staircase, in order, both ways, and every verdict
        assert [e for e in events if e.startswith("engage_")][:3] == [
            "engage_brownout_spec", "engage_brownout_prefill",
            "engage_shed"]
        assert "release_shed" in events and "release_clear" in events
        assert "deadline_reject" in events
        assert "shed" in events and "shed_static" in events
        verdicts = {v for _, _, vs, _ in got for v in vs}
        assert verdicts == {None, "shed", "deadline"}
        assert max(level for level, *_ in got) == 3


def test_submit_side_release_and_dense_servers(monkeypatch):
    """An idle replica whose evidence cleared drops to normal on the
    submit thread (release_clear) in both packages; a dense server (no
    pool) never starves."""
    clock = Clock()
    _patch_clock(monkeypatch, clock)
    out = []
    for mod in (jsup, tsup):
        pol = mod.AdaptiveAdmissionPolicy(alpha=1.0)
        srv = StubServer(total=8)
        srv.set(avail=0, queued=3, waiting=1, steps=1, tokens=2)
        for _ in range(3):
            clock.t += 0.1
            pol.on_step(srv)
        level_before = pol.level
        srv.set(avail=8, queued=0, waiting=0)
        verdict = pol.admit_verdict(srv, 4, 4, None)
        dense = StubServer(paged=False)
        dpol = mod.AdaptiveAdmissionPolicy(alpha=1.0)
        dense.set(queued=5, waiting=2, steps=1, tokens=1)
        dpol.on_step(dense)
        out.append((level_before, pol.level, verdict, srv.brownouts,
                    pol.journal(), dpol.level))
        clock.t = 1000.0
    assert out[0] == out[1]
    assert out[1][0] == 3 and out[1][1] == 0
    assert out[1][4][-1]["event"] == "release_clear"


def test_default_policy_follows_the_flag():
    try:
        for mod, fl in ((jsup, jflags), (tsup, tflags)):
            assert mod.default_policy().name == "static"
            fl.set_flags({"FLAGS_serving_admission_policy": "adaptive"})
            pol = mod.default_policy()
            assert isinstance(pol, mod.AdaptiveAdmissionPolicy)
            assert pol.name == "adaptive" and pol.level == 0
    finally:
        for fl in (jflags, tflags):
            fl.set_flags({"FLAGS_serving_admission_policy": "static"})
