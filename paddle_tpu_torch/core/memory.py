"""Live device-memory accounting: what ``paddle.device``'s memory API
reads.

The port of ``paddle_tpu.core.memory``. On the card the counters are
``torch.cuda``'s caching allocator's own (``torch.cuda.memory_stats``:
``allocated_bytes.all.current`` / ``.peak``, ``reserved_bytes.all.*``),
exact at allocation granularity: the counting the reference's GPU
allocator gives, which the JAX package could only approximate. On the
CPU, which has no allocator counters, the JAX semantics stay: an
op-boundary tracker. Every eager op output and ``to_tensor`` result on
the CPU registers its storage once, and a ``weakref.finalize`` on the
storage (whose Python object torch keeps as long as the storage lives)
takes it off again when its last tensor or view dies. Current and peak
live in one Python table: the JAX package's MemStats counters have no
caller here that a table does not serve.

Where the JAX package differs: a JAX slice or reshape is a new buffer,
counted again; a torch view shares its base's storage, counted once,
and keeps it counted while the view lives. The JAX package snaps
current to a live-array scan at each read; torch has no such scan, so
storages made outside the op funnel (raw torch calls) are not seen.

:func:`pool_bytes` measures a CUDA graph memory pool: the temporaries
of a captured program, which ``program_memory_analysis`` reports.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict

import torch

__all__ = ["track", "stats_for", "reset_peak", "pool_bytes"]

_KEY = "allocated.cpu:0"

_tracked: set = set()
_lock = threading.Lock()
# {key: [current, peak]}
_stats: Dict[str, list] = {}
_registered = False


def _update(key: str, delta: int) -> None:
    global _registered
    if not _registered:
        _registered = True
        from ..observability import metrics as _om
        _om.register_collector("memory", _collect_memory)
    with _lock:
        e = _stats.setdefault(key, [0, 0])
        e[0] += delta
        if e[0] > e[1]:
            e[1] = e[0]


def _get(key: str):
    with _lock:
        e = _stats.get(key, [0, 0])
        return e[0], e[1]


def _on_free(ptr: int, nbytes: int) -> None:
    with _lock:
        _tracked.discard(ptr)
    try:
        _update(_KEY, -nbytes)
    except Exception:  # noqa: BLE001 — interpreter shutdown
        pass


def track(t: torch.Tensor) -> None:
    """Count a CPU tensor's storage until the storage dies (once per
    storage; tensors on the card are the allocator's)."""
    if not t.is_cpu or t.is_meta:
        return
    try:
        st = t.untyped_storage()
        ptr, nbytes = st.data_ptr(), st.nbytes()
    except (RuntimeError, NotImplementedError):
        return
    if not ptr:
        return
    with _lock:
        if ptr in _tracked:
            return
        _tracked.add(ptr)
    _update(_KEY, nbytes)
    weakref.finalize(st, _on_free, ptr, nbytes)


def stats_for(device: torch.device) -> Dict[str, int]:
    """``allocated`` and ``reserved`` current / peak bytes of one
    device: the allocator's counters on the card, the tracker's on the
    CPU (where reserved is allocated)."""
    if device.type == "cuda":
        s = torch.cuda.memory_stats(device)
        return {
            "allocated.current": int(s.get("allocated_bytes.all.current", 0)),
            "allocated.peak": int(s.get("allocated_bytes.all.peak", 0)),
            "reserved.current": int(s.get("reserved_bytes.all.current", 0)),
            "reserved.peak": int(s.get("reserved_bytes.all.peak", 0)),
        }
    cur, peak = _get(_KEY)
    return {"allocated.current": int(cur), "allocated.peak": int(peak),
            "reserved.current": int(cur), "reserved.peak": int(peak)}


def reset_peak(device: torch.device) -> None:
    """Peak := current (the reference's ``ResetPeakValue``)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        return
    with _lock:
        e = _stats.get(_KEY)
        if e is not None:
            e[1] = e[0]


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the graph pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()``)."""
    if pool is None or not torch.cuda.is_available():
        return 0
    want = tuple(pool)
    return sum(seg.get("total_size", 0)
               for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) == want)


def _collect_memory():
    cur, peak = _get(_KEY)
    return {"memory.tracked_bytes": {"cpu:0": int(cur)},
            "memory.tracked_peak_bytes": {"cpu:0": int(peak)}} \
        if (cur or peak) else {}
