"""Admission policies for the GenerationServer.

The port of the policy half of ``paddle_tpu.serving_supervisor``:

- :class:`StaticShedPolicy` — shed when ``GenerationServer._shed()``
  says so (``FLAGS_serving_shed_queue``); the default.
- :class:`AdaptiveAdmissionPolicy` — step-boundary EWMAs of the free
  KV blocks, the backlog and the delivered-token rate move a pressure
  level one step at a time: brownout first (suppress the speculative
  window, then cap the prefill chunk), hard shedding only above both;
  deadline-aware rejection at submit; the static rule as its floor;
  every decision journaled.
- :func:`default_policy` — ``FLAGS_serving_admission_policy``.

The loop supervisor (``ServingSupervisor``, ``supervise``) and canary
``rollout`` come with a later slice. Everything here is host control
flow between engine steps.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List, Optional, Tuple

from .core.flags import flag_value
from .observability import flight as _flight
from .observability import metrics as _om

__all__ = ["StaticShedPolicy", "AdaptiveAdmissionPolicy",
           "default_policy"]

_M_brownouts = _om.scope("serving").counter(
    "admission_brownouts_total",
    "Adaptive-admission brownout engagements by knob (spec = "
    "speculative window suppressed, prefill = chunk capped) — the "
    "graceful degradations that precede any hard shed")


class StaticShedPolicy:
    """Shed exactly when ``GenerationServer._shed()`` says so
    (block-starved AND the backlog over ``FLAGS_serving_shed_queue``;
    0 disables). No brownout, no deadline awareness."""

    name = "static"

    def on_step(self, server) -> None:  # no step-boundary state
        return None

    def admit_verdict(self, server, prompt_len: int, max_new: int,
                      deadline: Optional[float]) -> Optional[str]:
        return "shed" if server._shed() else None

    def journal(self) -> List[dict]:
        return []


class AdaptiveAdmissionPolicy:
    """Step-boundary adaptive admission over EWMAs of the evidence the
    serving plane already exports.

    ``on_step`` (called by the decode loop at every step boundary)
    folds ``blocks_free``, the backlog (queued + block-deferred) and
    the committed-token throughput into EWMAs and moves a pressure
    LEVEL one step per boundary — so the journal always shows the
    graceful path engage in order, and release the same way:

    ====== =================== =======================================
    level  name                effect
    ====== =================== =======================================
    0      normal              —
    1      brownout_spec       speculative window suppressed (plain
                               steps; the +spec_k block pre-extension
                               is the first draw to shed)
    2      brownout_prefill    prefill chunk capped (long prompts draw
                               smaller slices of each step)
    3      shed                submit() rejects (reason=shed)
    ====== =================== =======================================

    Pressure RISES while the pool is starved (available blocks at or
    below ``starve_frac`` of the pool) with a backlog behind it, and
    FALLS as the evidence clears (hysteresis: release needs the
    backlog EWMA to drain, not one lucky step). ``admit_verdict``
    additionally re-checks on the submit thread so a cleared replica
    whose loop is parked idle releases immediately, applies
    deadline-aware rejection — a request whose deadline cannot be met
    at the observed steps/sec is rejected at submit instead of
    expiring after burning blocks — and keeps the static
    ``FLAGS_serving_shed_queue`` rule as a floor. Every transition
    and rejection decision is journaled (bounded ``journal()``, flight
    ``admission`` events, counters)."""

    name = "adaptive"
    LEVEL_NAMES = ("normal", "brownout_spec", "brownout_prefill",
                   "shed")

    def __init__(self, alpha: float = 0.5,
                 starve_frac: float = 0.125,
                 queue_bound: Optional[int] = None,
                 brownout_chunk: int = 8,
                 deadline_margin: float = 1.25,
                 min_steps: int = 3,
                 rate_window: float = 30.0,
                 journal_cap: int = 256):
        self.alpha = float(alpha)
        self.starve_frac = float(starve_frac)
        # hard-shed backlog bound: explicit, else the static flag,
        # else 1 deferred request
        self.queue_bound = queue_bound
        self.brownout_chunk = int(brownout_chunk)
        self.deadline_margin = float(deadline_margin)
        self.min_steps = int(min_steps)
        self.rate_window = float(rate_window)
        self.level = 0
        self._journal: deque = deque(maxlen=int(journal_cap))
        self._ewma_avail: Optional[float] = None
        self._ewma_backlog = 0.0
        # PER-REQUEST tokens/sec: the deadline estimator's rate.
        # Steps/sec alone under-counts speculative decoding (a spec
        # step commits up to k tokens per request) and would reject
        # meetable requests; delivered tokens normalized by the batch
        # width measure what one request actually experiences
        self._ewma_rps: Optional[float] = None
        self._steps_seen = 0
        # (t, steps, tokens) at the last rate measurement
        self._last: Optional[Tuple[float, int, int]] = None

    # -- evidence -----------------------------------------------------------
    def _bound(self) -> int:
        if self.queue_bound is not None:
            return int(self.queue_bound)
        return int(flag_value("serving_shed_queue")) or 1

    def _mix(self, prev: Optional[float], x: float) -> float:
        if prev is None:
            return float(x)
        return self.alpha * float(x) + (1.0 - self.alpha) * prev

    def on_step(self, server) -> None:
        """Fold the step boundary's evidence into the EWMAs, move the
        pressure level at most ONE step, and install the brownout
        knobs on the engine. Runs on the decode-loop thread."""
        now = time.monotonic()
        paged = getattr(server, "_paged", False)
        total = server.engine._kv.num_blocks if paged else 0
        avail = server.engine._kv.available_blocks() if paged else total
        backlog = server._q.qsize() + len(server._waiting)
        self._ewma_avail = self._mix(self._ewma_avail, avail)
        self._ewma_backlog = self._mix(self._ewma_backlog, backlog)
        if self._last is None:
            self._last = (now, server.steps_run,
                          server.tokens_delivered)
        else:
            dt = now - self._last[0]
            steps = server.steps_run - self._last[1]
            tokens = server.tokens_delivered - self._last[2]
            # rate over REAL decode progress only: the loop also calls
            # on_step from its prefill/waiting cycling branch, and
            # mixing those zero-step intervals in would decay the rate
            # toward 0 and spuriously deadline-reject everything (a
            # truly wedged loop is a supervisor's job, not this
            # estimator's). An interval longer than rate_window is an
            # IDLE GAP, not a measurement: the first step after an
            # hour of silence must not average over the hour and
            # crater the rate — skip the sample, restart the window
            if steps > 0 and dt > 1e-6:
                if dt <= self.rate_window and tokens > 0:
                    width = max(len(server._slots)
                                + len(server._prefilling), 1)
                    self._ewma_rps = self._mix(self._ewma_rps,
                                               tokens / dt / width)
                self._last = (now, server.steps_run,
                              server.tokens_delivered)
        self._steps_seen += 1

        starved = (paged and total > 0
                   and self._ewma_avail <= self.starve_frac * total)
        if starved and self._ewma_backlog > self._bound():
            target = 3
        elif starved and self._ewma_backlog >= 1.0:
            target = 2
        elif starved and backlog > 0:
            target = 1
        elif not starved and self._ewma_backlog < 0.5:
            target = 0
        else:
            target = self.level  # hysteresis band: hold
        self._move_level(server, target, avail=avail, backlog=backlog)

    def _move_level(self, server, target: int, **evidence) -> None:
        if target == self.level:
            return
        # one step per boundary: brownout ALWAYS precedes shed on the
        # way up, and shedding releases through brownout on the way
        # down — the journal reads as the staircase it is
        new = self.level + (1 if target > self.level else -1)
        old, self.level = self.level, new
        event = ("engage_" if new > old else "release_") \
            + self.LEVEL_NAMES[max(new, old)]
        self._note(event, level=new, **evidence)
        if new > old and new in (1, 2):
            _M_brownouts.inc(knob="spec" if new == 1 else "prefill")
        server._apply_brownout(
            spec_off=new >= 1,
            chunk_cap=self.brownout_chunk if new >= 2 else None)

    def _note(self, event: str, **attrs) -> None:
        entry = {"t": time.monotonic(), "event": event}
        entry.update(attrs)
        self._journal.append(entry)
        _flight.record("admission", event, **attrs)

    def journal(self) -> List[dict]:
        """The bounded decision journal (oldest → newest): every
        level transition, shed and deadline rejection with the
        evidence it was decided on."""
        return list(self._journal)

    # -- submit-side --------------------------------------------------------
    def _maybe_release(self, server) -> None:
        """Submit-thread release path: an idle loop runs no step
        boundaries, so a cleared replica must not stay wedged at its
        last pressure level. Evidence-clear here drops straight to
        normal (journaled)."""
        if self.level == 0:
            return
        paged = getattr(server, "_paged", False)
        total = server.engine._kv.num_blocks if paged else 0
        avail = server.engine._kv.available_blocks() if paged else 0
        backlog = server._q.qsize() + len(server._waiting)
        if backlog == 0 and (not paged or total == 0
                             or avail > self.starve_frac * total):
            self._ewma_backlog = 0.0
            self._ewma_avail = float(avail)
            old, self.level = self.level, 0
            self._note("release_clear", from_level=old, available=avail)
            server._apply_brownout(spec_off=False, chunk_cap=None)

    def admit_verdict(self, server, prompt_len: int, max_new: int,
                      deadline: Optional[float]) -> Optional[str]:
        self._maybe_release(server)
        if self.level >= 3:
            self._note("shed", backlog=server._q.qsize()
                       + len(server._waiting))
            return "shed"
        if server._shed():  # the static flag stays the policy FLOOR
            self._note("shed_static")
            return "shed"
        if deadline is not None and self._ewma_rps \
                and self._steps_seen >= self.min_steps:
            est = self.deadline_margin * max_new / self._ewma_rps
            if est > deadline:
                self._note("deadline_reject", estimate=round(est, 3),
                           deadline=deadline, max_new=max_new)
                return "deadline"
        return None


def default_policy():
    """The policy ``GenerationServer`` installs when none is passed:
    ``FLAGS_serving_admission_policy`` — 'adaptive' builds
    :class:`AdaptiveAdmissionPolicy` with defaults, anything else the
    static fallback."""
    if str(flag_value("serving_admission_policy")).strip() == "adaptive":
        return AdaptiveAdmissionPolicy()
    return StaticShedPolicy()
