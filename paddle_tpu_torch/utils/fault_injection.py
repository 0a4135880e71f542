"""Site-based fault injection for robustness tests.

The port's copy of ``paddle_tpu.utils.fault_injection``, whole.
Production code threads named *sites* through its failure-prone
operations (``fire("serving.decode")`` before a decode step,
``write_bytes("checkpoint.write", ...)`` for a checkpoint's bytes).
Tests arm a site with :func:`inject` (or the :func:`injected` context
manager) and the next ``times`` passages through it raise the armed
exception, truncate the write, or simulate a process kill. An unarmed
site costs one dict lookup on a module-level table.

Kill-points raise :class:`KillPoint`, a ``BaseException`` subclass, so
``except Exception`` recovery code cannot "survive" a simulated
preemption; only the test harness catches it. Transport perturbation
(:class:`FlakyTransport`), :class:`FlakyStore` and :func:`kill_pid`
are here for the fleet and distributed slices to come.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

__all__ = ["KillPoint", "InjectedFault", "inject", "clear", "fire",
           "write_bytes", "injected", "stats", "armed",
           "inject_transport", "FlakyTransport", "kill_pid"]


class KillPoint(BaseException):
    """Simulated process death (SIGKILL / preemption) at a named site.

    BaseException on purpose: recovery paths that swallow ``Exception``
    must not treat a kill as a survivable I/O error.
    """


class InjectedFault(OSError):
    """Default exception raised by an armed site."""


class _Fault:
    __slots__ = ("exc", "times", "truncate_at", "kill", "skip", "fired")

    def __init__(self, exc, times, truncate_at, kill, skip):
        self.exc = exc
        self.times = times
        self.truncate_at = truncate_at
        self.kill = kill
        self.skip = skip
        self.fired = 0


class _TransportFault:
    __slots__ = ("drop", "duplicate", "delay", "times", "skip", "fired")

    def __init__(self, drop, duplicate, delay, times, skip):
        self.drop = drop
        self.duplicate = duplicate
        self.delay = delay
        self.times = times
        self.skip = skip
        self.fired = 0


_lock = threading.Lock()
_sites: Dict[str, _Fault] = {}
_transport_sites: Dict[str, _TransportFault] = {}
_fired_total: Dict[str, int] = {}


def _register_telemetry() -> None:
    """Expose the injected-fault tally in the port's metrics registry
    (``snapshot()['faults']['injected_total']``) as a snapshot-time
    view, so the unarmed-site fast path stays one dict lookup.
    ``stats()`` below is the direct surface."""
    from ..observability import metrics as _om

    def collect():
        with _lock:
            tally = dict(_fired_total)
        return {"faults.injected_total": tally} if tally else {}

    _om.register_collector("fault_injection", collect)


_register_telemetry()


def inject(site: str, exc: Optional[BaseException] = None, times: int = 1,
           truncate_at: Optional[int] = None, kill: bool = False,
           skip: int = 0) -> None:
    """Arm ``site`` to fail its next ``times`` passages (after ``skip``
    clean ones).

    exc:         exception instance to raise (default InjectedFault).
    truncate_at: for write sites — persist only the first N bytes
                 (combine with ``kill=True`` for a mid-write preemption).
    kill:        raise KillPoint instead of ``exc``.
    skip:        let this many passages through unharmed first (fail the
                 Nth save, not the first).
    """
    with _lock:
        _sites[site] = _Fault(exc, int(times), truncate_at, kill, int(skip))


def clear(site: Optional[str] = None) -> None:
    """Disarm one site, or every site when called with no argument
    (transport perturbations included)."""
    with _lock:
        if site is None:
            _sites.clear()
            _transport_sites.clear()
        else:
            _sites.pop(site, None)
            _transport_sites.pop(site, None)


def armed(site: str) -> bool:
    return site in _sites


def stats() -> Dict[str, int]:
    """site -> total faults fired (survives clear(); for test asserts)."""
    with _lock:
        return dict(_fired_total)


def _consume(site: str) -> Optional[_Fault]:
    """Take one shot from an armed site, or None for a clean passage."""
    with _lock:
        f = _sites.get(site)
        if f is None:
            return None
        if f.skip > 0:
            f.skip -= 1
            return None
        if f.times <= 0:
            return None
        f.times -= 1
        f.fired += 1
        _fired_total[site] = _fired_total.get(site, 0) + 1
        if f.times <= 0:
            del _sites[site]
        return f


def fire(site: str) -> None:
    """Checkpoint a failure-prone operation: raises if ``site`` is armed
    with an exception or kill-point; no-op otherwise (truncation-only
    arms are left for :func:`write_bytes` to consume)."""
    if site not in _sites:  # unlocked fast path; arming is test-side
        return
    f = _consume(site)
    if f is None:
        return
    if f.kill and f.truncate_at is None:
        raise KillPoint(site)
    if f.truncate_at is not None:
        # a truncation arm belongs to write_bytes; re-arm the shot
        with _lock:
            f.times += 1
            f.fired -= 1
            _fired_total[site] -= 1
            _sites[site] = f
        return
    raise f.exc if f.exc is not None else InjectedFault(
        f"injected fault at {site!r}")


def write_bytes(site: str, fileobj, blob: bytes) -> int:
    """Write ``blob`` through an injectable site. An armed truncation
    writes only ``truncate_at`` bytes then raises (KillPoint when
    ``kill=True``, else the armed/default exception) — the on-disk state
    a real preemption mid-write leaves behind."""
    f = _consume(site) if site in _sites else None
    if f is None:
        fileobj.write(blob)
        return len(blob)
    if f.truncate_at is None:
        if f.kill:
            raise KillPoint(site)
        raise f.exc if f.exc is not None else InjectedFault(
            f"injected fault at {site!r}")
    n = max(0, min(int(f.truncate_at), len(blob)))
    fileobj.write(blob[:n])
    fileobj.flush()
    if f.kill:
        raise KillPoint(site)
    raise f.exc if f.exc is not None else InjectedFault(
        f"injected truncation at {site!r} after {n} bytes")


@contextmanager
def injected(site: str, **kwargs):
    """``with injected("store.add", times=2): ...`` — arm for the block,
    disarm on exit even if the block dies."""
    inject(site, **kwargs)
    try:
        yield
    finally:
        clear(site)


class FlakyStore:
    """Store wrapper failing the first ``fail_times`` calls of each
    wrapped op with ConnectionResetError — a transport-level flake for
    components (elastic membership) tested against a pure-python store
    double, where the in-store injection sites don't exist."""

    _OPS = ("set", "get", "get_nowait", "add", "take", "delete", "wait")

    def __init__(self, store, fail_times: int = 1, ops=None):
        self._store = store
        self._remaining = {op: int(fail_times)
                           for op in (ops or self._OPS)}
        self.faults_fired = 0

    def __getattr__(self, name):
        target = getattr(self._store, name)
        if name not in self._remaining or not callable(target):
            return target

        def flaky(*a, **kw):
            if self._remaining[name] > 0:
                self._remaining[name] -= 1
                self.faults_fired += 1
                raise ConnectionResetError(
                    f"injected flaky store op {name!r}")
            return target(*a, **kw)

        return flaky


# ---------------------------------------------------------------------------
# transport-level perturbation (fleet RPC chaos)
# ---------------------------------------------------------------------------
def inject_transport(site: str, drop: bool = False, duplicate: bool = False,
                     delay: float = 0.0, times: int = 1,
                     skip: int = 0) -> None:
    """Arm ``site`` to perturb its next ``times`` frames (after ``skip``
    clean ones) as they pass through a :class:`FlakyTransport`.

    drop:      the frame vanishes — a send is never written, a received
               frame is discarded and the NEXT one delivered instead.
    duplicate: the frame arrives twice (at-least-once delivery the
               receiver's dedup path must absorb).
    delay:     sleep this many seconds before the frame moves (reorder /
               heartbeat-stall pressure without wall-clock test sleeps
               elsewhere).
    """
    with _lock:
        _transport_sites[site] = _TransportFault(
            bool(drop), bool(duplicate), float(delay), int(times),
            int(skip))


def _consume_transport(site: str) -> Optional[_TransportFault]:
    with _lock:
        f = _transport_sites.get(site)
        if f is None:
            return None
        if f.skip > 0:
            f.skip -= 1
            return None
        if f.times <= 0:
            return None
        f.times -= 1
        f.fired += 1
        _fired_total[site] = _fired_total.get(site, 0) + 1
        if f.times <= 0:
            del _transport_sites[site]
        return f


class FlakyTransport:
    """Wraps a frame transport — any object with ``send(obj)`` and
    ``recv()`` (the fleet RPC connection) — and perturbs whole frames at
    armed transport sites. Sends consult ``<site>.send``, receives
    ``<site>.recv``; arm them with :func:`inject_transport`. Unarmed
    frames cost one dict lookup; everything else (close, fileno, ...)
    passes straight through, so production code can thread every
    connection through this wrapper unconditionally.
    """

    def __init__(self, transport, site: str):
        self._t = transport
        self.site = site
        self._replay = []  # frames queued by a recv-side duplicate

    def send(self, obj):
        f = (_consume_transport(self.site + ".send")
             if _transport_sites else None)
        if f is not None:
            if f.delay > 0:
                time.sleep(f.delay)
            if f.drop:
                return None  # the peer never sees this frame
            if f.duplicate:
                self._t.send(obj)
        return self._t.send(obj)

    def recv(self):
        if self._replay:
            return self._replay.pop(0)
        f = (_consume_transport(self.site + ".recv")
             if _transport_sites else None)
        if f is not None and f.delay > 0:
            time.sleep(f.delay)
        obj = self._t.recv()
        if f is not None:
            if f.drop:
                return self._t.recv()  # discard; deliver the next frame
            if f.duplicate:
                self._replay.append(obj)
        return obj

    def __getattr__(self, name):
        return getattr(self._t, name)


def kill_pid(site: str, pid: int) -> bool:
    """SIGKILL ``pid`` when ``site`` is armed; no-op (False) otherwise.

    The deterministic chaos trigger for fleet tests: production code
    calls this at a well-defined point (the router just applied the
    k-th streamed token, a replica just acked admission) and an armed
    test turns exactly that point into a real child-process death — no
    sleep-and-hope timing. The unarmed fast path is one dict lookup.
    Refuses to signal the calling process itself.
    """
    if site not in _sites:
        return False
    f = _consume(site)
    if f is None:
        return False
    pid = int(pid)
    if pid == os.getpid() or pid <= 0:
        return False
    os.kill(pid, signal.SIGKILL)
    return True
