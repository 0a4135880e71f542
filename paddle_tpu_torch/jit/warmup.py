"""Hot start: the executable cache and the warm-bundle boot pre-warm.

The port of ``paddle_tpu.jit.warmup``. What a warm process skips on the
card is ``nvcc``, not an XLA compile, so the two layers are:

- **Executable cache** (``FLAGS_executable_cache_dir``): the directory
  of the built kernel libraries (``ops/kernels/build.py``). A process
  whose libraries are already there loads them from disk and builds
  nothing. The counters ``executable_cache.{hits,misses,writes}_total``
  keep the JAX names: a library loaded from disk is a hit, an ``nvcc``
  run a miss, a library written a write. They count only while the
  flag is set. Unset, the libraries go where they always did
  (``$PADDLE_TPU_TORCH_KERNEL_DIR`` or ``_build/``).
- **Warm bundle** (``FLAGS_warmup_bundle``): the serving engines
  :func:`note_program` every program they run for the first time (the
  JAX engines' ``serving`` entries, with the same names and geometry
  meta); :func:`export_bundle` writes them as the JAX package's
  versioned JSON manifest, and :func:`prewarm` replays a bundle at boot
  through ``engine._prewarm_entry``: each entry's kernel libraries are
  loaded and its program runs once at the entry's shapes, so cuBLAS and
  the caching allocator are set up before the first admission. A
  missing, truncated, corrupt or newer bundle, a stale entry and an
  entry that fails are counted in ``warmup.failures_total{reason}``;
  pre-warm never fails a boot. ``captured_step`` entries are skipped:
  the port has no ``CapturedStep`` yet.

Fault-injection site: ``warmup.write`` (the bundle writer, the same
truncated-write contract as ``checkpoint.write``).
"""
from __future__ import annotations

import json
import os
import stat as _stat
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from ..analysis.locks import make_lock
from ..core.flags import _registry as _flag_registry
from ..core.flags import define_flag, flag_value
from ..observability import flight as _flight
from ..observability import metrics as _om
from ..utils import fault_injection as _fi

__all__ = ["ensure_executable_cache", "cache_stats", "cache_dir",
           "count_cache", "note_program", "recorded", "clear_recorded",
           "export_bundle", "load_bundle", "prewarm", "gc_cache_dir",
           "BUNDLE_VERSION"]

define_flag(
    "executable_cache_dir", "",
    "Directory of the built kernel libraries (ops/kernels/build.py): "
    "a process whose libraries are already there loads them and runs "
    "no nvcc. Empty (default) = $PADDLE_TPU_TORCH_KERNEL_DIR or "
    "_build/. Counters executable_cache.{hits,misses,writes}_total "
    "are live only while set")
define_flag(
    "warmup_bundle", "",
    "Default warm-bundle manifest path for boot pre-warm: consumers "
    "that take warm_bundle= (inference.serve, warmup.prewarm) fall "
    "back to this path when none is passed. Empty (default) = no "
    "automatic pre-warm")
define_flag(
    "executable_cache_gc_days", 0,
    "Age-based GC of the executable cache dir: entries "
    "whose last hit (atime, falling back to mtime) is older than "
    "this many days are evicted — counted "
    "executable_cache.evicted_total — opportunistically whenever "
    "ensure_executable_cache (re)configures the cache, or explicitly "
    "via warmup.gc_cache_dir(). 0 (default) = never evict")

_dir_flag = _flag_registry["executable_cache_dir"]
_bundle_flag = _flag_registry["warmup_bundle"]

BUNDLE_VERSION = 1
_BUNDLE_KEY = "__paddle_tpu_warm_bundle__"
_MAX_RECORDED = 512

_M = _om.scope("executable_cache")
_M_counts = {
    "hits": _M.counter(
        "hits_total",
        "Kernel libraries loaded from the executable cache directory "
        "(no nvcc ran)"),
    "misses": _M.counter(
        "misses_total",
        "nvcc runs: kernel libraries missing from the executable cache "
        "directory"),
    "writes": _M.counter(
        "writes_total",
        "Kernel libraries written into the executable cache directory"),
}
_M_evicted = _M.counter(
    "evicted_total",
    "Executable-cache entries evicted by last-hit age "
    "(FLAGS_executable_cache_gc_days / warmup.gc_cache_dir)")
_W = _om.scope("warmup")
_M_programs = _W.counter(
    "programs_total",
    "Programs successfully pre-warmed from a warm bundle at boot")
_M_failures = _W.counter(
    "failures_total",
    "Warm-bundle failures by reason (missing/corrupt/version/program/"
    "stale) — every one degrades to a cold start, never a boot failure")

# the directory ensure_executable_cache last configured (None = off)
_state: Dict[str, Any] = {"dir": None}


def cache_dir() -> Optional[str]:
    """``FLAGS_executable_cache_dir``, or None when it is unset."""
    return str(_dir_flag.value or "").strip() or None


def count_cache(kind: str, n: int = 1) -> None:
    """Count ``n`` executable-cache ``hits``, ``misses`` or ``writes``
    (``ops/kernels/build.py`` calls this); a no-op while the flag is
    unset."""
    if n and cache_dir() is not None:
        _M_counts[kind].inc(n)


def ensure_executable_cache() -> bool:
    """Make the ``FLAGS_executable_cache_dir`` directory and, when the
    flag names a new one, journal it and run the age GC over it.
    Returns True while the cache is on. The kernel build reads the flag
    on every load, so flipping it at run time takes effect at the next
    library load."""
    d = cache_dir()
    if _state["dir"] == d:
        return d is not None
    if d is not None:
        os.makedirs(d, exist_ok=True)
    _state["dir"] = d
    _flight.record("warmup", "cache_configured", dir=d or "<off>")
    if d is not None:
        try:
            gc_cache_dir(directory=d)
        except OSError:  # GC must never block boot
            pass
    return d is not None


def gc_cache_dir(max_age_days: Optional[float] = None,
                 directory: Optional[str] = None) -> int:
    """Evict executable-cache entries by LAST-HIT age: a regular file in
    the cache dir whose newest of (atime, mtime) is older than
    ``max_age_days`` (default ``FLAGS_executable_cache_gc_days``; <= 0
    disables) is removed and counted into
    ``executable_cache.evicted_total``. Warm-bundle manifests
    (``*.json``) and subdirectories are never touched. Returns the
    evicted count; I/O errors keep the entry."""
    if max_age_days is None:
        max_age_days = flag_value("executable_cache_gc_days")
    try:
        age = float(max_age_days)
    except (TypeError, ValueError):
        return 0
    d = directory or cache_dir()
    if not d or age <= 0:
        return 0
    cutoff = time.time() - age * 86400.0
    try:
        names = os.listdir(d)
    except OSError:
        return 0
    removed = 0
    for name in names:
        if name.endswith(".json"):
            continue  # warm bundles are manifests, not cache entries
        path = os.path.join(d, name)
        try:
            st = os.stat(path)
            if not _stat.S_ISREG(st.st_mode):
                continue
            if max(st.st_atime, st.st_mtime) < cutoff:
                os.remove(path)
                removed += 1
        except OSError:
            continue  # raced/unreadable: keep it, try next boot
    if removed:
        _M_evicted.inc(removed)
        _flight.record("warmup", "cache_gc", dir=os.path.basename(d),
                       evicted=removed, max_age_days=age)
    return removed


def cache_stats() -> Dict[str, int]:
    """{hits, misses, writes} of the executable cache."""
    return {k: int(c.value()) for k, c in _M_counts.items()}


# ---------------------------------------------------------------------------
# recording: which programs did this run build?
# ---------------------------------------------------------------------------

# insertion-ordered, key = canonical JSON of the entry (dedup), bounded;
# serving loops on worker threads record concurrently
_recorded: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
_rec_lock = make_lock("jit.warmup.recorded")


def note_program(kind: str, name: str, entry: Dict[str, Any]) -> None:
    """Record one program's replayable signature (the serving engines
    call this the first time they run each program). An entry that is
    not JSON-serializable drops its ``sig`` first, then is skipped."""
    entry = dict(entry)
    entry["kind"] = kind
    entry["name"] = name
    try:
        key = json.dumps(entry, sort_keys=True)
    except (TypeError, ValueError):
        entry.pop("sig", None)
        try:
            key = json.dumps(entry, sort_keys=True)
        except (TypeError, ValueError):
            return
    with _rec_lock:
        if key in _recorded:
            return
        _recorded[key] = entry
        while len(_recorded) > _MAX_RECORDED:
            _recorded.popitem(last=False)


def recorded() -> List[Dict[str, Any]]:
    with _rec_lock:
        return [dict(e) for e in _recorded.values()]


def clear_recorded() -> None:
    with _rec_lock:
        _recorded.clear()


# ---------------------------------------------------------------------------
# bundle export / load
# ---------------------------------------------------------------------------

def _default_bundle_path() -> Optional[str]:
    p = str(_bundle_flag.value or "").strip()
    if p:
        return p
    d = cache_dir()
    if d:
        return os.path.join(d, "warm_bundle.json")
    return None


def export_bundle(path: Optional[str] = None) -> str:
    """Write the recorded program signatures as a versioned JSON
    manifest (default: ``<FLAGS_executable_cache_dir>/warm_bundle.json``,
    beside the libraries it indexes). Atomic write-then-rename through
    the ``warmup.write`` fault-injection site; a kill or truncation
    mid-write leaves no partial bundle behind."""
    import torch
    path = path or _default_bundle_path()
    if not path:
        raise ValueError(
            "export_bundle needs a path (or FLAGS_executable_cache_dir/"
            "FLAGS_warmup_bundle to derive one)")
    bundle = {_BUNDLE_KEY: BUNDLE_VERSION,
              "torch": torch.__version__,
              "entries": recorded()}
    blob = json.dumps(bundle, sort_keys=True, indent=1).encode()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            _fi.write_bytes("warmup.write", f, blob)
            f.flush()
        os.replace(tmp, path)
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _flight.record("warmup", "bundle_exported", path=os.path.basename(path),
                   entries=len(bundle["entries"]))
    return path


def _fail(reason: str, **attrs) -> None:
    _M_failures.inc(reason=reason)
    _flight.record("warmup", "bundle_failed", reason=reason, **attrs)


def load_bundle(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Load a warm-bundle manifest; ``None`` (with a counted
    ``warmup.failures_total{reason}``) for anything unusable — missing,
    truncated, corrupt, or a version this build does not understand."""
    path = path or _default_bundle_path()
    if not path:
        return None
    base = os.path.basename(path)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        _fail("missing", path=base)
        return None
    try:
        bundle = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        _fail("corrupt", path=base)
        return None
    if not isinstance(bundle, dict) or \
            not isinstance(bundle.get("entries"), list):
        _fail("corrupt", path=base)
        return None
    version = bundle.get(_BUNDLE_KEY)
    if not isinstance(version, int) or version > BUNDLE_VERSION:
        _fail("version", path=base, version=str(version))
        return None
    return bundle


# ---------------------------------------------------------------------------
# boot pre-warm
# ---------------------------------------------------------------------------

def prewarm(bundle=None, engine=None) -> Dict[str, int]:
    """Replay a warm bundle's ``serving`` entries into ``engine`` at
    boot (``engine._prewarm_entry``), before its first request.

    ``bundle``: a loaded bundle dict, a manifest path, or None (the
    ``FLAGS_warmup_bundle`` / cache-dir default). Entries without a
    target (``captured_step``; ``serving`` without an engine; programs
    the engine does not run) are skipped; a stale entry (recorded
    against another geometry) and an entry whose program raises are
    counted and pre-warm goes on — this function never raises for
    bundle content."""
    if bundle is None or isinstance(bundle, str):
        bundle = load_bundle(bundle)
    out = {"programs": 0, "failures": 0, "skipped": 0}
    if not bundle:
        return out
    ensure_executable_cache()
    for entry in bundle.get("entries", []):
        if not isinstance(entry, dict):
            out["skipped"] += 1
            continue
        if entry.get("kind") != "serving" or engine is None:
            out["skipped"] += 1
            continue
        try:
            res = engine._prewarm_entry(entry)
        except Exception as e:  # noqa: BLE001 — degrade to a cold start
            out["failures"] += 1
            _M_failures.inc(reason="program")
            _flight.record("warmup", "program_failed",
                           fn=str(entry.get("name", "")),
                           error=type(e).__name__)
            continue
        if res == "stale":
            # written by a differently configured replica: replaying it
            # would set up shapes this engine never runs
            out["failures"] += 1
            _M_failures.inc(reason="stale")
            _flight.record("warmup", "bundle_failed", reason="stale",
                           fn=str(entry.get("name", "")))
        elif res:
            out["programs"] += 1
        else:
            out["skipped"] += 1
    if out["programs"]:
        _M_programs.inc(out["programs"])
    _flight.record("warmup", "prewarm", **out)
    return out
