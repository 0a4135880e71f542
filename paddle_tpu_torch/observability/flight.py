"""Flight recorder: the always-on black-box event ring.

The port's copy of the event ring of ``paddle_tpu.observability.flight``
(``record``, ``events``, ``clear``): a fixed-capacity ring of structured
events — host monotonic-us timestamp, category, name, recording thread,
an optional ``trace_id`` and a small attrs dict. The serving modules
journal the request lifecycle and the KV block allocator into it.
Dumps to disk and the crash hooks come with a later slice, and so does
the ``FLAGS_flight_recorder`` kill switch: the ring always records.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock

__all__ = ["record", "events", "clear", "CAPACITY"]

CAPACITY = 4096

_lock = make_lock("observability.flight")
# event tuples: (ts_us, category, name, thread_ident, trace_id, attrs)
_ring: deque = deque(maxlen=CAPACITY)


def record(category: str, name: str, trace_id: Optional[str] = None,
           **attrs) -> None:
    """Append one event to the ring: one clock read, one tuple, one
    GIL-atomic ``deque.append`` — no lock (a black box is best-effort
    by definition)."""
    _ring.append((time.perf_counter() * 1e6, category, name,
                  threading.get_ident(), trace_id, attrs or None))


def clear() -> None:
    """Empty the ring (test hook)."""
    with _lock:
        _ring.clear()


def _to_dict(ev: Tuple, names: Dict[int, str]) -> Dict[str, Any]:
    ts, cat, name, tid, trace_id, attrs = ev
    d: Dict[str, Any] = {"ts_us": round(float(ts), 1), "cat": cat,
                         "name": name, "tid": tid}
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
    names = {t.ident: t.name for t in threading.enumerate()
             if t.ident is not None}
    out = [_to_dict(ev, names) for ev in items
           if (category is None or ev[1] == category)
           and (trace_id is None or ev[4] == trace_id)]
    if n is not None:
        out = out[-int(n):]
    return out
