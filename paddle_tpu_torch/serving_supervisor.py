"""Self-healing serving plane: the supervised decode loop, admission
policies and canary weight rollout.

The port of ``paddle_tpu.serving_supervisor``:

- :class:`ServingSupervisor` (:func:`supervise`) — watches a
  ``GenerationServer``'s loop thread for death (an exception, a
  ``KillPoint`` among them) or a stall (alive, heartbeat stale, work
  pending); dumps the flight ring, fences the old loop, resets the
  engine (its KV pools zeroed in place) and restarts the loop after a
  bounded exponential backoff. The restarted loop replays the engine's
  CUDA graphs: they hold the pools' addresses, which a reset keeps, and
  a capture that a fault cut is never stored (``jit.sot.capture_jit``),
  so no graph of a cut capture can replay. In-flight requests are
  recovered: their
  committed tokens are host state, so each re-admits through the normal
  prefill with ``prompt + committed`` as its prompt, and a greedy stream
  resumes as it would have gone on. A request active at
  ``quarantine_after`` consecutive deaths is failed (reason=poison).
- :class:`StaticShedPolicy` — shed when ``GenerationServer._shed()``
  says so (``FLAGS_serving_shed_queue``); the default.
- :class:`AdaptiveAdmissionPolicy` — step-boundary EWMAs of the free
  KV blocks, the backlog and the delivered-token rate move a pressure
  level one step at a time: brownout first (suppress the speculative
  window, then cap the prefill chunk), hard shedding only above both;
  deadline-aware rejection at submit; the static rule as its floor;
  every decision journaled.
- :func:`default_policy` — ``FLAGS_serving_admission_policy``.
- :func:`rollout` — swaps a checkpoint onto replicas in stages: the
  canary first, probed before and after; a non-finite weight halts it
  before any swap, and a diverging probe or a slow swap rolls the
  canary back to its retained weights and halts it.

Everything here is host control flow between engine steps.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.flags import flag_value
from .observability import flight as _flight
from .observability import metrics as _om
from .utils import backoff as _backoff

__all__ = ["ServingSupervisor", "supervise", "StaticShedPolicy",
           "AdaptiveAdmissionPolicy", "default_policy", "RolloutPolicy",
           "rollout"]

_M = _om.scope("serving")
_M_restarts = _M.counter(
    "supervisor_restarts_total",
    "Decode-loop restarts by the supervisor (crash or stall), each "
    "after a bounded-exponential backoff")
_M_recovered = _M.counter(
    "supervisor_recovered_total",
    "In-flight requests re-admitted after a decode-loop death with "
    "prompt + committed tokens as the prompt (greedy streams resume "
    "bit-equal)")
_M_quarantined = _M.counter(
    "supervisor_quarantined_total",
    "Requests failed as poison (reason=poison) after being active at "
    "quarantine_after consecutive decode-loop deaths — never "
    "re-admitted, so one pathological input cannot crash-loop the "
    "replica")
_M_stalls = _M.counter(
    "supervisor_stalls_total",
    "Decode-loop stalls detected by the supervisor watchdog (thread "
    "alive, heartbeat stale, work pending) — the stalled thread is "
    "fenced and a fresh loop started")
_M_brownouts = _M.counter(
    "admission_brownouts_total",
    "Adaptive-admission brownout engagements by knob (spec = "
    "speculative window suppressed, prefill = chunk capped) — the "
    "graceful degradations that precede any hard shed")
_M_rollouts = _M.counter(
    "rollouts_total", "Canary weight rollouts started")
_M_rollbacks = _M.counter(
    "rollout_rollbacks_total",
    "Canary replicas auto-rolled back to their retained pre-swap "
    "weights (probe divergence / slow swap beyond policy)")
_M_halts = _M.counter(
    "rollout_halted_total",
    "Rollouts halted before reaching every replica (canary rollback, "
    "non-finite checkpoint weights, or a swap rejection)")
_M_nonfinite = _M.counter(
    "rollout_nonfinite_weights_total",
    "Non-finite values found scanning a rollout checkpoint's prepared "
    "weights — the checkpoint never reaches any replica")


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
            # truly wedged loop is the stall watchdog's job, not this
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


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class ServingSupervisor:
    """Crash/stall supervisor for one ``GenerationServer``.

    A monitor thread polls the decode-loop thread. On death (the loop
    thread died — ``KillPoint`` and friends re-raise through
    ``GenerationServer._run``'s BaseException boundary) or stall
    (alive, heartbeat older than ``stall_seconds`` while holding
    work), it:

    1. auto-dumps the flight ring (``trigger=supervisor``),
    2. FENCES the old loop (epoch bump — a zombie that wakes later
       exits without touching state),
    3. strikes every request that was active (in a slot or
       prefilling); a request at ``quarantine_after`` strikes is
       quarantined — terminal ``failed`` with reason=poison — the
       rest are queued for recovery with ``prompt + committed
       tokens`` as their prompt (greedy streams resume bit-equal),
    4. resets the engine (fresh zero pools, rebound rather than zeroed
       in place, so a fenced zombie still inside a step writes only
       into the orphaned ones; the loop threads share the default
       stream, so the new loop's kernels queue behind the dead one's)
       and clears the slot tables,
    5. sleeps the bounded exponential backoff and restarts the loop.

    ``max_restarts`` consecutive deaths (the streak resets after
    ``healthy_seconds`` without one) give up: everything pending is
    failed so no caller hangs, and the monitor exits. All of it is
    counted (``serving.supervisor_*``) and journaled (flight
    ``supervisor`` events)."""

    def __init__(self, server, *, backoff: Optional[float] = None,
                 backoff_cap: float = 2.0, max_restarts: int = 8,
                 stall_seconds: Optional[float] = None,
                 quarantine_after: int = 2, healthy_seconds: float = 5.0,
                 poll: float = 0.01, dump_on_death: bool = True):
        self.server = server
        self.backoff = float(flag_value("serving_supervisor_backoff")
                             if backoff is None else backoff)
        self.backoff_cap = float(backoff_cap)
        self.max_restarts = int(max_restarts)
        self.stall_seconds = float(
            flag_value("serving_supervisor_stall_seconds")
            if stall_seconds is None else stall_seconds)
        self.quarantine_after = max(int(quarantine_after), 1)
        self.healthy_seconds = float(healthy_seconds)
        self.poll = float(poll)
        self.dump_on_death = bool(dump_on_death)
        self.restarts = 0
        self.recovered = 0
        self.quarantined = 0
        self.stalls = 0
        self.gave_up = False
        self._streak = 0
        self._deaths = 0  # death index, for consecutive-strike checks
        self._last_death = 0.0
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._monitor,
                                        daemon=True,
                                        name="serving-supervisor")
        self._thread.start()
        _flight.record("supervisor", "attached",
                       stall_seconds=self.stall_seconds,
                       max_restarts=self.max_restarts)

    # -- lifecycle ----------------------------------------------------------
    def stop(self, timeout: float = 5.0) -> None:
        """Detach: stop monitoring (the server keeps running
        unsupervised)."""
        self._stop_evt.set()
        self._thread.join(timeout)

    def stats(self) -> Dict[str, int]:
        return {"restarts": self.restarts, "recovered": self.recovered,
                "quarantined": self.quarantined, "stalls": self.stalls,
                "gave_up": int(self.gave_up)}

    # -- monitor ------------------------------------------------------------
    def _monitor(self) -> None:
        srv = self.server
        while not self._stop_evt.wait(self.poll):
            if srv._drained.is_set():
                return  # clean shutdown: nothing left to supervise
            thread = srv._thread
            if not thread.is_alive():
                if srv._stopping.is_set():
                    # died mid-drain: restarting would serve nobody —
                    # unblock shutdown() by failing what's left
                    self._abort_drain()
                    return
                if not self._handle_death("crash",
                                          error=srv._crash_error):
                    return
                continue
            if self.stall_seconds > 0 and not srv._idle \
                    and not srv._stopping.is_set() \
                    and (time.monotonic() - srv._beat
                         > self.stall_seconds) \
                    and self._has_work():
                self.stalls += 1
                _M_stalls.inc()
                if not self._handle_death("stall", error=None):
                    return

    def _has_work(self) -> bool:
        srv = self.server
        return bool(srv._slots or srv._prefilling or srv._waiting
                    or not srv._q.empty())

    # -- death handling -----------------------------------------------------
    def _handle_death(self, kind: str,
                      error: Optional[BaseException]) -> bool:
        """Recover from one decode-loop death. Returns False when the
        supervisor gives up (monitor should exit)."""
        srv = self.server
        now = time.monotonic()
        if now - self._last_death > self.healthy_seconds:
            self._streak = 0  # the last incarnation lived long enough
        self._last_death = now
        self._streak += 1
        self._deaths += 1
        err = type(error).__name__ if error is not None else kind
        _flight.record("supervisor", "loop_death", kind=kind,
                       error=err, streak=self._streak,
                       in_flight=len(srv._slots) + len(srv._prefilling))
        if self.dump_on_death:
            try:
                _flight.dump(trigger="supervisor",
                             note=f"decode loop {kind}: {err}")
            except Exception:  # noqa: BLE001 — forensics best-effort
                pass
        # fence FIRST: a stalled zombie that wakes mid-recovery must
        # see the new epoch before it can commit tokens or fail the
        # requests this recovery is about to re-admit
        srv._epoch += 1
        if self._streak > self.max_restarts:
            self._give_up(kind, err)
            return False
        recovered, poisoned = self._collect_victims()
        try:
            reset = getattr(srv.engine, "reset_state", None)
            if reset is not None:
                reset()
        except Exception as e:  # noqa: BLE001 — recovery must continue
            _flight.record("supervisor", "reset_error",
                           error=type(e).__name__)
        for req in poisoned:
            self.quarantined += 1
            srv.quarantined += 1
            _M_quarantined.inc()
            _flight.record("supervisor", "quarantine",
                           trace_id=req.get("trace_id"),
                           reason="poison", crashes=req["crashes"])
            srv._fail(req, RuntimeError(
                f"request quarantined (reason=poison): it was active "
                f"at {req['crashes']} consecutive decode-loop "
                f"deaths — re-admitting it again would crash-loop "
                f"the replica"))
        now2 = time.monotonic()
        for req in recovered:
            # fold ONLY the not-yet-folded committed tokens into the
            # prompt: a request recovered a second time (quarantine
            # threshold > 2) already carries its first recovery's
            # tokens in the prompt — re-folding them would duplicate
            # the stream and break the bit-equal resume contract
            folded = req.get("folded", 0)
            fresh = np.asarray(req["out"][folded:], np.int32)
            if fresh.size:
                req["prompt"] = np.concatenate([req["prompt"], fresh])
            req["folded"] = len(req["out"])
            req.pop("t_admit", None)
            # rebase the queue-latency origin: queue_seconds is the
            # documented submit->admission wait — pre-crash DECODE
            # time must not masquerade as admission starvation
            req["t_queue0"] = now2
            self.recovered += 1
            srv.recovered += 1
            _M_recovered.inc()
            _flight.record("supervisor", "recover",
                           trace_id=req.get("trace_id"),
                           tokens=len(req["out"]),
                           crashes=req["crashes"])
        # recovered requests head the deferred list IN their original
        # submit order: _admit drains _waiting before the queue (and
        # holds the line), so nothing newer overtakes a resumed stream
        srv._waiting = recovered + srv._waiting
        delay = _backoff.full_jitter(
            min(self.backoff * (2 ** (self._streak - 1)),
                self.backoff_cap))
        if delay > 0:
            time.sleep(delay)
        self.restarts += 1
        srv.loop_restarts += 1
        _M_restarts.inc()
        srv._start_loop()
        _flight.record("supervisor", "restart", kind=kind,
                       backoff=round(delay, 4), streak=self._streak,
                       recovered=len(recovered),
                       quarantined=len(poisoned))
        return True

    def _collect_victims(self) -> Tuple[List[dict], List[dict]]:
        """Strike every request that was ACTIVE at the death (holding
        a slot or prefilling) and split them into (recovered,
        poisoned) by strike count; clears the slot tables. Requests
        merely queued or block-deferred were untouched by the crash
        and stay where they are."""
        srv = self.server
        active = list(srv._slots.values()) \
            + list(srv._prefilling.values())
        srv._slots.clear()
        srv._prefilling.clear()
        recovered: List[dict] = []
        poisoned: List[dict] = []
        for req in sorted(active, key=lambda r: r["t0"]):
            if req["done"].is_set():
                continue
            # strikes count CONSECUTIVE deaths only (the documented
            # quarantine contract): a request that sat out a death —
            # recovered, decoded healthily, and was merely a
            # bystander at a much later unrelated crash — starts its
            # count over instead of inheriting old strikes
            if req.get("strike_death") is not None \
                    and req["strike_death"] != self._deaths - 1:
                req["crashes"] = 0
            req["strike_death"] = self._deaths
            req["crashes"] = req.get("crashes", 0) + 1
            if req["crashes"] >= self.quarantine_after:
                poisoned.append(req)
            else:
                recovered.append(req)
        return recovered, poisoned

    def _give_up(self, kind: str, err: str) -> None:
        """Restart budget exhausted: fail everything pending so no
        caller blocks forever, journal, and stop supervising."""
        srv = self.server
        self.gave_up = True
        reason = RuntimeError(
            f"serving supervisor gave up after {self.max_restarts} "
            f"consecutive decode-loop deaths (last: {kind}/{err})")
        # stop the intake FIRST (under the submit lock, so nothing
        # slips past the check into the queue after the drain below)
        # and mark drained: the loop is dead for good — later
        # submit() calls reject fast and shutdown() returns instead
        # of timing out against a drain that can never happen
        with srv._submit_lock:
            srv._stopping.set()
        recovered, poisoned = self._collect_victims()
        for req in recovered + poisoned + srv._waiting:
            if not req["done"].is_set():
                srv._fail(req, reason)
        srv._waiting = []
        while True:
            try:
                req = srv._q.get_nowait()
            except Exception:  # noqa: BLE001 — Empty only
                break
            if req is not srv._STOP and not req["done"].is_set():
                srv._fail(req, reason)
        srv._set_gauges()
        srv._drained.set()
        _flight.record("supervisor", "give_up", kind=kind, error=err,
                       restarts=self.restarts)

    def _abort_drain(self) -> None:
        """The loop died while shutdown() was draining: fail the
        leftovers and mark the server drained so shutdown's wait
        returns instead of timing out."""
        srv = self.server
        reason = RuntimeError(
            "decode loop died during shutdown drain")
        for table in (srv._slots, srv._prefilling):
            for slot, req in list(table.items()):
                srv._fail(req, reason)
                srv._release_slot(slot, evicted=True)
            table.clear()
        for req in srv._waiting:
            if not req["done"].is_set():
                srv._fail(req, reason)
        srv._waiting = []
        srv._set_gauges()
        _flight.record("supervisor", "abort_drain")
        srv._drained.set()


def supervise(server, **kwargs) -> ServingSupervisor:
    """Attach a :class:`ServingSupervisor` to ``server`` (kwargs
    forwarded to the constructor). Returns the supervisor."""
    return ServingSupervisor(server, **kwargs)


# ---------------------------------------------------------------------------
# canary rollout
# ---------------------------------------------------------------------------

class RolloutPolicy:
    """What :func:`rollout` watches on the canary, and the probe it
    decodes. ``max_divergence`` is the tolerated fraction of probe
    tokens that may change across the swap — 0.0 demands bit-equal
    probes (right for a hotfix re-deploy of identical weights), a
    real fine-tune sets it to taste. ``max_swap_seconds`` (None =
    off) additionally bounds the step-boundary stall a swap may
    cost."""

    def __init__(self, probe_prompt=(1, 2, 3, 4), probe_tokens: int = 8,
                 max_divergence: float = 0.25,
                 require_finite: bool = True,
                 max_swap_seconds: Optional[float] = None,
                 probe_timeout: float = 120.0):
        self.probe_prompt = list(probe_prompt)
        self.probe_tokens = int(probe_tokens)
        self.max_divergence = float(max_divergence)
        self.require_finite = bool(require_finite)
        self.max_swap_seconds = max_swap_seconds
        self.probe_timeout = float(probe_timeout)


def _try_rollback(srv, retained, stage, replica: int) -> bool:
    """Best-effort canary rollback. A rollback swap that itself fails
    (loop dead, concurrent swap, timeout) must not escape rollout()
    with the fleet state unrecorded — it is journaled and reported
    instead. Returns True when the retained weights are back in."""
    try:
        srv.swap_weights(prepared=retained)
        return True
    except Exception as e:  # noqa: BLE001 — journaled, not raised
        stage["rollback_error"] = type(e).__name__
        _flight.record("rollout", "rollback_failed", replica=replica,
                       error=type(e).__name__)
        return False


def _divergence(a: List[int], b: List[int]) -> float:
    """Fraction of probe positions that changed (length differences
    count as divergent positions)."""
    n = max(len(a), len(b))
    if n == 0:
        return 0.0
    same = sum(1 for x, y in zip(a, b) if x == y)
    return 1.0 - same / n


def _count_nonfinite(prepared) -> int:
    """Non-finite values across a prepared weight tree: ``isfinite``
    summed on the tensors' device, one host read. Integer leaves (int8
    codes) are skipped: only their float scales can hold a NaN. A fleet
    ``RemotePrepared`` handle carries its replica's count as
    ``.nonfinite``."""
    if hasattr(prepared, "nonfinite"):
        return int(prepared.nonfinite)
    leaves: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor) and node.is_floating_point():
            leaves.append(node)

    walk(prepared)
    if not leaves:
        return 0
    bad = torch.stack([(~torch.isfinite(t)).sum() for t in leaves]).sum()
    return int(bad)


def rollout(checkpoint_or_state, servers, policy: Optional[RolloutPolicy]
            = None) -> dict:
    """Staged canary rollout of one checkpoint across ``servers``
    (a list of ``GenerationServer``; the first is the CANARY).

    Per the fleet contract: the checkpoint is loaded/verified once,
    scanned for non-finite weights (trip ⇒ halt before ANY replica
    swaps, counted ``serving.rollout_nonfinite_weights_total``), then
    swapped onto the canary — whose pre-swap prepared weights are
    RETAINED — and probed: the fixed probe prompt is decoded before
    and after the swap, and divergence beyond
    ``policy.max_divergence`` (or a swap slower than
    ``policy.max_swap_seconds``) auto-rolls the canary back to the
    retained weights (streams restored bit-equal, counted
    ``rollout_rollbacks_total``) and HALTS the rollout. A healthy
    canary lets the remaining replicas swap without probing. Every
    stage is journaled as flight ``rollout`` events; the returned
    report carries per-stage verdicts."""
    from .serving import GenerationServer
    policy = policy or RolloutPolicy()
    servers = list(servers)
    if not servers:
        raise ValueError("rollout needs at least one server")
    _M_rollouts.inc()
    report = {"replicas": len(servers), "swapped": 0,
              "rolled_back": 0, "halted": False, "reason": None,
              "stages": []}
    _flight.record("rollout", "begin", replicas=len(servers))
    sd = GenerationServer._swap_state(
        checkpoint_or_state, getattr(servers[0].engine, "device", None))
    scanned = False
    for i, srv in enumerate(servers):
        canary = i == 0
        stage = {"replica": i, "canary": canary, "ok": False}
        report["stages"].append(stage)
        try:
            prepared = srv.engine.prepare_swap(sd)
        except Exception as e:  # noqa: BLE001 — a deploy gate verdict
            stage["error"] = type(e).__name__
            report["halted"], report["reason"] = True, "prepare"
            _M_halts.inc()
            _flight.record("rollout", "halted", reason="prepare",
                           replica=i, error=type(e).__name__)
            break
        if policy.require_finite and not scanned:
            scanned = True
            bad = _count_nonfinite(prepared)
            if bad:
                _M_nonfinite.inc(bad)
                report["halted"] = True
                report["reason"] = "nonfinite_weights"
                stage["nonfinite"] = bad
                _flight.record("rollout", "halted",
                               reason="nonfinite_weights", count=bad)
                break
        retained = srv.engine.params  # the rollback tree
        pre = None
        if canary:
            try:
                pre = srv.generate(policy.probe_prompt,
                                   policy.probe_tokens,
                                   timeout=policy.probe_timeout)
            except Exception as e:  # noqa: BLE001 — deploy-gate verdict
                # can't even probe the PRE-swap replica: nothing was
                # swapped, halt without touching any weights
                stage["error"] = type(e).__name__
                report["halted"], report["reason"] = True, \
                    "probe_failed"
                _M_halts.inc()
                _flight.record("rollout", "halted",
                               reason="probe_failed", replica=i,
                               error=type(e).__name__)
                break
            stage["probe_pre"] = pre
        try:
            res = srv.swap_weights(prepared=prepared)
        except Exception as e:  # noqa: BLE001 — rejection verdict
            stage["error"] = type(e).__name__
            report["halted"], report["reason"] = True, "swap_rejected"
            _M_halts.inc()
            _flight.record("rollout", "halted", reason="swap_rejected",
                           replica=i, error=type(e).__name__)
            break
        stage["swap_seconds"] = res["seconds"]
        if canary:
            try:
                post = srv.generate(policy.probe_prompt,
                                    policy.probe_tokens,
                                    timeout=policy.probe_timeout)
            except Exception as e:  # noqa: BLE001 — verdict, not crash
                # the new weights are INSTALLED and unprobeable
                # (timeout / shed under the very overload a bad
                # checkpoint causes): roll back, halt, journal — a
                # raw escape here would strand the canary on the bad
                # weights with no rollback and no report
                _try_rollback(srv, retained, stage, i)
                stage["error"] = type(e).__name__
                report["rolled_back"] += 1
                report["halted"], report["reason"] = True, \
                    "probe_failed"
                _M_rollbacks.inc()
                _M_halts.inc()
                _flight.record("rollout", "rollback", replica=i,
                               reason="probe_failed",
                               error=type(e).__name__)
                break
            div = _divergence(pre, post)
            stage["probe_post"] = post
            stage["divergence"] = div
            slow = (policy.max_swap_seconds is not None
                    and res["seconds"] > policy.max_swap_seconds)
            _flight.record("rollout", "canary_probe", replica=i,
                           divergence=round(div, 4),
                           swap_seconds=round(res["seconds"], 4))
            if div > policy.max_divergence or slow:
                _try_rollback(srv, retained, stage, i)
                report["rolled_back"] += 1
                report["halted"] = True
                report["reason"] = ("slow_swap" if slow
                                    else "probe_divergence")
                _M_rollbacks.inc()
                _M_halts.inc()
                _flight.record("rollout", "rollback", replica=i,
                               reason=report["reason"],
                               divergence=round(div, 4))
                break
        stage["ok"] = True
        report["swapped"] += 1
        _flight.record("rollout", "stage_ok", replica=i,
                       canary=canary)
    _flight.record("rollout", "end", swapped=report["swapped"],
                   halted=report["halted"],
                   reason=str(report["reason"]))
    return report
