"""Flight recorder: the always-on black-box event journal.

The port's copy of ``paddle_tpu.observability.flight``. It keeps a
fixed-capacity ring of structured events — a host monotonic-us
timestamp, category, name, recording thread, an optional ``trace_id``
and a small attrs dict — that the serving modules append to: the
request lifecycle (submit -> queued -> admitted -> [prefilled] ->
decode -> finished/expired/failed, keyed by ``trace_id``), the paged KV
block allocator and its radix prefix cache, weight hot-swaps, the
``supervisor`` events of a decode-loop death and its recovery
(attached / loop_death / recover / quarantine / restart / give_up /
abort_drain), the ``admission`` decisions, the canary ``rollout``
stages and the ``checkpoint`` saves, restores and fallbacks.

Recording is on by default (``FLAGS_flight_recorder``): an append is
one cached flag read, one clock read, one tuple and one GIL-atomic
``deque.append``. ``FLAGS_flight_recorder_capacity`` sizes the ring;
a change is picked up by the next append, which rebuilds the ring
keeping its newest events.

Crash forensics: :func:`dump` freezes the ring as a JSONL file (a
header line, then one event per line) in ``FLAGS_flight_dump_dir``.
Triggers: an explicit ``dump()``, the supervisor's loop deaths, and
the unhandled-exception hooks and optional signal handlers of
:func:`install_crash_hooks`. Every dump counts into
``observability.dumps_total{trigger=...}``. Beside a dump, best
effort, goes the merged chrome trace ``<dump>.trace.json``
(``profiler.export_chrome_tracing``: the host spans when the native
tracer is loaded — a dump never builds it —, the last device profile,
the timeline's counters and these events as instants), named in the
header's ``chrome_trace``.

Reading a dump: ``python -m paddle_tpu_torch.observability --flight
[path]``.
"""
from __future__ import annotations

import json
import os
import signal as _signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock
from ..core.flags import _registry as _flag_registry
from . import metrics as _metrics

__all__ = [
    "record", "enabled", "events", "clear", "dropped", "appended",
    "dump", "last_dump_path", "find_dumps", "load_dump",
    "render_events", "chrome_events", "install_crash_hooks",
    "uninstall_crash_hooks", "dump_dir",
]

_flag = _flag_registry["flight_recorder"]
_cap_flag = _flag_registry["flight_recorder_capacity"]
_dir_flag = _flag_registry["flight_dump_dir"]

_lock = make_lock("observability.flight")

_M_dumps = _metrics.counter(
    "observability.dumps_total",
    "Flight-recorder dumps written, by trigger "
    "(explicit/exception/signal/watchdog)")


def _now_us() -> float:
    return time.perf_counter() * 1e6


def _capacity() -> int:
    try:
        return max(int(_cap_flag.value), 16)
    except (TypeError, ValueError):
        return 4096


# event tuples: (ts_us, category, name, thread_ident, trace_id, attrs)
_ring: deque = deque(maxlen=_capacity())
_appended_n = 0
_dump_seq = 0
_last_dump: Optional[str] = None


def enabled() -> bool:
    """``FLAGS_flight_recorder``, read off the cached flag record."""
    return bool(_flag.value)


def _rebuild_ring() -> deque:
    """The capacity flag changed: rebuild the ring keeping its newest
    events (only on a flag change)."""
    global _ring
    cap = _capacity()
    with _lock:
        if _ring.maxlen != cap:
            _ring = deque(_ring, maxlen=cap)
        return _ring


def record(category: str, name: str, trace_id: Optional[str] = None,
           **attrs) -> None:
    """Append one event to the ring: one cached flag read, one clock
    read, one tuple, one GIL-atomic deque append, no lock (an event lost
    to a racing capacity rebuild is acceptable in a black box)."""
    if not _flag.value:
        return
    global _appended_n
    ring = _ring
    if ring.maxlen != _cap_flag.value and ring.maxlen != _capacity():
        ring = _rebuild_ring()
    ring.append((_now_us(), category, name, threading.get_ident(),
                 trace_id, attrs or None))
    _appended_n += 1


def appended() -> int:
    """Events recorded since process start (evicted ones included)."""
    return _appended_n


def dropped() -> int:
    """Events evicted from the ring so far."""
    return max(0, _appended_n - len(_ring))


def clear() -> None:
    """Empty the ring and reset the appended tally (test hook)."""
    global _appended_n
    with _lock:
        _ring.clear()
        _appended_n = 0


def _thread_names() -> Dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate()
            if t.ident is not None}


def _to_dict(ev: Tuple, names: Optional[Dict[int, str]] = None
             ) -> Dict[str, Any]:
    ts, cat, name, tid, trace_id, attrs = ev
    d: Dict[str, Any] = {"ts_us": round(float(ts), 1), "cat": cat,
                         "name": name, "tid": tid}
    if names:
        thread = names.get(tid)
        if thread is not None:
            d["thread"] = thread
    if trace_id is not None:
        d["trace_id"] = trace_id
    if attrs:
        d["attrs"] = attrs
    return d


def events(n: Optional[int] = None, category: Optional[str] = None,
           trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Snapshot of the ring (oldest -> newest) as dicts, optionally
    filtered by category and/or trace_id, truncated to the last ``n``."""
    with _lock:
        items = list(_ring)
    names = _thread_names()
    out = [_to_dict(ev, names) for ev in items
           if (category is None or ev[1] == category)
           and (trace_id is None or ev[4] == trace_id)]
    if n is not None:
        out = out[-int(n):]
    return out


def chrome_events() -> List[Dict[str, Any]]:
    """The ring as chrome-trace instant events (``"ph": "i"``), ready to
    merge into a trace file beside host spans."""
    with _lock:
        items = list(_ring)
    pid = os.getpid()
    out = []
    for ts, cat, name, tid, trace_id, attrs in items:
        args = dict(attrs) if attrs else {}
        if trace_id is not None:
            args["trace_id"] = trace_id
        out.append({"name": f"{cat}.{name}", "ph": "i", "s": "t",
                    "cat": cat, "pid": pid, "tid": tid, "ts": ts,
                    "args": args})
    return out


# ---------------------------------------------------------------------------
# dumps
# ---------------------------------------------------------------------------

def dump_dir() -> str:
    """Directory dumps land in: ``FLAGS_flight_dump_dir``, or the system
    temp dir when unset."""
    d = str(_dir_flag.value or "").strip()
    return d or tempfile.gettempdir()


def dump(path: Optional[str] = None, trigger: str = "explicit",
         note: str = "") -> str:
    """Freeze the ring as a JSONL dump (a header line, then one event a
    line), fsynced. Works whatever ``FLAGS_flight_recorder`` says: an
    operator asking for forensics gets what the ring holds. Returns the
    dump's path."""
    global _dump_seq, _last_dump
    with _lock:
        items = list(_ring)
        _dump_seq += 1
        seq = _dump_seq
    names = _thread_names()
    if path is None:
        d = dump_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"flight-{os.getpid()}-{seq:03d}-{trigger}.jsonl")
    header = {
        "kind": "flight_header", "version": 1, "pid": os.getpid(),
        "trigger": trigger, "note": note,
        "time_unix": round(time.time(), 3), "host_now_us": _now_us(),
        "events": len(items), "dropped": dropped(),
        "capacity": _ring.maxlen, "thread_names":
            {str(k): v for k, v in names.items()},
    }
    try:
        from ..profiler import export_chrome_tracing
        header["chrome_trace"] = os.path.basename(
            export_chrome_tracing(path + ".trace.json", build=False))
    except Exception:  # noqa: BLE001 — best effort: the dump comes first
        pass
    with open(path, "w") as f:
        f.write(json.dumps(header, default=str) + "\n")
        for ev in items:
            f.write(json.dumps(_to_dict(ev, names), default=str) + "\n")
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:
            pass
    _M_dumps.inc(trigger=trigger)
    _last_dump = path
    return path


def last_dump_path() -> Optional[str]:
    return _last_dump


def find_dumps(directory: Optional[str] = None) -> List[str]:
    """Flight dumps in ``directory`` (default: :func:`dump_dir`),
    newest first."""
    d = directory or dump_dir()
    try:
        names = [n for n in os.listdir(d)
                 if n.startswith("flight-") and n.endswith(".jsonl")]
    except OSError:
        return []
    paths = [os.path.join(d, n) for n in names]
    paths.sort(key=lambda p: (os.path.getmtime(p), p), reverse=True)
    return paths


def load_dump(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """(header, events) from a JSONL dump written by :func:`dump`."""
    header: Dict[str, Any] = {}
    evs: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if i == 0 and obj.get("kind") == "flight_header":
                header = obj
            else:
                evs.append(obj)
    return header, evs


def render_events(evs: List[Dict[str, Any]],
                  header: Optional[Dict[str, Any]] = None) -> str:
    """Human-readable trail: relative-ms timestamps, category.name,
    thread, trace id, attrs."""
    lines: List[str] = []
    if header:
        lines.append(
            f"flight dump: trigger={header.get('trigger', '?')} "
            f"pid={header.get('pid', '?')} "
            f"events={header.get('events', len(evs))} "
            f"dropped={header.get('dropped', 0)} "
            f"capacity={header.get('capacity', '?')}"
            + (f" note={header['note']}" if header.get("note") else ""))
    if not evs:
        lines.append("<no events>")
        return "\n".join(lines)
    t0 = evs[0].get("ts_us", 0.0)
    for e in evs:
        rel_ms = (e.get("ts_us", t0) - t0) / 1e3
        who = e.get("thread") or e.get("tid", "?")
        tr = f" [{e['trace_id']}]" if "trace_id" in e else ""
        attrs = e.get("attrs") or {}
        astr = " ".join(f"{k}={v}" for k, v in attrs.items())
        lines.append(f"{rel_ms:+12.3f}ms  "
                     f"{e.get('cat', '?')}.{e.get('name', '?'):<24}"
                     f" ({who}){tr}{('  ' + astr) if astr else ''}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# crash-dump triggers: unhandled exceptions + signals
# ---------------------------------------------------------------------------

_prev_sys_hook = None
_prev_thread_hook = None
_prev_signals: Dict[int, Any] = {}
_hooks_installed = False


def _safe_dump(trigger: str, note: str = "") -> Optional[str]:
    try:
        return dump(trigger=trigger, note=note)
    except Exception:  # noqa: BLE001 — forensics must never re-crash
        return None


def install_crash_hooks(signals: Tuple[int, ...] = ()) -> None:
    """Wrap ``sys.excepthook`` and ``threading.excepthook`` so that an
    unhandled exception records a ``crash`` event and writes a dump
    before the previous hook runs, and (optionally) bind the given
    signal numbers (e.g. ``signal.SIGUSR1``) to a live dump. Both hooks
    are process-wide. Idempotent; :func:`uninstall_crash_hooks` puts
    everything back."""
    global _prev_sys_hook, _prev_thread_hook, _hooks_installed
    if not _hooks_installed:
        _prev_sys_hook = sys.excepthook
        _prev_thread_hook = threading.excepthook

        def sys_hook(tp, val, tb):
            record("crash", "exception", error=tp.__name__,
                   message=str(val)[:200])
            _safe_dump("exception", f"{tp.__name__}: {val}"[:200])
            _prev_sys_hook(tp, val, tb)

        def thread_hook(args):
            tname = getattr(args.thread, "name", "?")
            record("crash", "thread_exception",
                   error=args.exc_type.__name__,
                   message=str(args.exc_value)[:200], thread=tname)
            _safe_dump("exception",
                       f"{args.exc_type.__name__} in thread {tname}: "
                       f"{args.exc_value}"[:200])
            _prev_thread_hook(args)

        sys.excepthook = sys_hook
        threading.excepthook = thread_hook
        _hooks_installed = True
    for signum in signals:
        if signum in _prev_signals:
            continue

        def handler(sig, frame, _n=signum):
            record("crash", "signal", signum=int(_n))
            _safe_dump("signal", f"signal {_n}")
            prev = _prev_signals.get(_n)
            if callable(prev):
                prev(sig, frame)

        try:
            _prev_signals[signum] = _signal.signal(signum, handler)
        except (ValueError, OSError):  # not the main thread / unsupported
            pass


def uninstall_crash_hooks() -> None:
    """Restore the hooks and handlers :func:`install_crash_hooks`
    replaced."""
    global _hooks_installed
    with _lock:
        if _hooks_installed:
            sys.excepthook = _prev_sys_hook
            threading.excepthook = _prev_thread_hook
            _hooks_installed = False
        for signum in list(_prev_signals):
            prev = _prev_signals.pop(signum)
            try:
                _signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
