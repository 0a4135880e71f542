"""Crash-safe persistence: atomic checkpoint writes, per-tensor CRC32
manifests, retention with corruption fallback, async persistence.

The port's copy of ``paddle_tpu.framework.checkpoint``, in the same
on-disk format (``framework/io.py`` says how each package reads the
other's files):

- **Atomic saves** (:func:`atomic_save`): serialize to
  ``path.tmp.<pid>``, flush + fsync, then ``os.replace`` onto the final
  name, so a reader sees the old complete file or the new one, never a
  partial. The record holds a format version and a manifest mapping each
  tensor's tree path to the CRC32 of its bytes, so silent corruption is
  found at load, not only truncation.
- **Legacy files**: a bare pickle of the packed tree (the format before
  the manifest) still loads, as version 1.
- **:class:`CheckpointManager`**: ``save(obj, step)`` with ``keep_n``
  retention and ``latest()``, which verifies manifests and walks back
  past truncated or corrupt files to the newest good one.
- **Async mode**: ``save`` copies every tensor's bytes to the host on
  the caller's thread (the only part the caller waits for, and a copy:
  a CPU tensor's ``.cpu()`` is the tensor itself, so an optimizer step
  that follows must not reach the file), then a background thread
  serializes, fsyncs and renames. The next ``save`` / ``wait`` /
  ``close`` waits for it and re-raises its failure.

Fault-injection sites (``utils.fault_injection``):
``checkpoint.snapshot``, ``checkpoint.write``, ``checkpoint.rename``.
"""
from __future__ import annotations

import os
import re
import threading
import time as _time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock
from ..core.flags import flag_value
from ..observability import flight as _flight
from ..observability import metrics as _om
from ..utils import fault_injection as _fi
from .io import _TensorPayload, _dumps, _load_pickle, _pack, _unpack

__all__ = ["atomic_save", "load_checkpoint", "verify_checkpoint",
           "extract_state_dict", "CheckpointManager",
           "CheckpointCorruptError", "FORMAT_VERSION"]

FORMAT_KEY = "__paddle_tpu_ckpt__"
FORMAT_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed CRC/structure verification at load."""


# process-wide durability telemetry (aggregates across every manager and
# bare save(); per-instance CheckpointManager.stats() stays the
# legacy per-directory view)
_M = _om.scope("checkpoint")
_M_saves = _M.counter("saves_total", "Durable checkpoint persists")
_M_bytes = _M.counter("bytes_written_total", "Serialized checkpoint bytes")
_M_save_s = _M.histogram(
    "save_seconds", "Wall seconds per durable persist "
    "(serialize + write + fsync + rename)")
_M_loads = _M.counter("loads_total", "Checkpoints loaded successfully")
_M_corrupt = _M.counter(
    "corrupt_skipped_total",
    "Damaged checkpoints skipped by latest()/restore() fallback")
_M_async = _M.counter("async_saves_total", "Async save submissions")
_M_retired = _M.counter("retired_total", "Checkpoints pruned by retention")


# -- manifest -------------------------------------------------------------

def _build_manifest(packed) -> Dict[str, Dict[str, Any]]:
    """Tree-path -> {crc32, nbytes, shape, dtype} for every tensor
    payload in the packed tree."""
    entries: Dict[str, Dict[str, Any]] = {}

    def walk(obj, path):
        if isinstance(obj, _TensorPayload):
            entries[path] = {
                "crc32": zlib.crc32(obj.bytes) & 0xFFFFFFFF,
                "nbytes": len(obj.bytes),
                "shape": list(obj.shape),
                "dtype": obj.dtype_str,
            }
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}/{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")

    walk(packed, "")
    return entries


def _verify_manifest(manifest, packed) -> List[str]:
    """Recompute CRCs against the manifest; returns mismatch reasons."""
    actual = _build_manifest(packed)
    bad = []
    for path, want in manifest.items():
        got = actual.get(path)
        if got is None:
            bad.append(f"{path or '/'}: tensor missing from payload")
        elif (got["crc32"] != want["crc32"]
              or got["nbytes"] != want["nbytes"]):
            bad.append(
                f"{path or '/'}: crc32 {got['crc32']:#010x} != manifest "
                f"{want['crc32']:#010x} ({got['nbytes']} bytes)")
    extra = set(actual) - set(manifest)
    if extra:
        bad.append(f"{len(extra)} tensor(s) not in manifest")
    return bad


# -- save / load ----------------------------------------------------------

def _fsync_dir(dirname: str) -> None:
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return  # fs without directory fds (or vanished dir)
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_save(obj, path: str, protocol: int = 4) -> int:
    """Snapshot ``obj`` and atomically persist it at ``path``; returns
    bytes written. Any failure (including a kill mid-write) leaves the
    previous contents of ``path`` untouched."""
    _fi.fire("checkpoint.snapshot")
    packed = _pack(obj)
    return _persist_packed(packed, path, protocol)


def _persist_packed(packed, path: str, protocol: int = 4) -> int:
    """The durable half of a save (async mode runs this off-thread):
    serialize the already-host-resident tree, write-fsync-rename."""
    t0 = _time.perf_counter()
    record = {FORMAT_KEY: FORMAT_VERSION,
              "manifest": _build_manifest(packed),
              "payload": packed}
    blob = _dumps(record, protocol=protocol)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            _fi.write_bytes("checkpoint.write", f, blob)
            f.flush()
            if flag_value("checkpoint_fsync"):
                os.fsync(f.fileno())
        _fi.fire("checkpoint.rename")
        os.replace(tmp, path)
    except Exception:
        # a REAL error is reported after best-effort cleanup; a
        # KillPoint (BaseException) skips this and leaves the partial
        # tmp file behind, exactly like a preemption would
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    if flag_value("checkpoint_fsync"):
        _fsync_dir(d)
    _M_saves.inc()
    _M_bytes.inc(len(blob))
    dt = _time.perf_counter() - t0
    _M_save_s.observe(dt)
    _flight.record("checkpoint", "save", path=os.path.basename(path),
                   bytes=len(blob), dur_ms=round(dt * 1e3, 1))
    return len(blob)


def _read_record(path: str):
    """-> (version, manifest, packed_payload). Legacy bare-pickle files
    report version 1 with an empty manifest."""
    with open(path, "rb") as f:
        record = _load_pickle(f)
    if isinstance(record, dict) and FORMAT_KEY in record \
            and "payload" in record:
        version = record[FORMAT_KEY]
        if not isinstance(version, int) or version > FORMAT_VERSION:
            raise CheckpointCorruptError(
                f"{path}: checkpoint format version {version!r} is newer "
                f"than this build understands (<= {FORMAT_VERSION})")
        return version, record.get("manifest", {}), record["payload"]
    return 1, {}, record


def load_checkpoint(path: str, return_numpy: bool = False,
                    verify: bool = True, device=None):
    """Load a checkpoint written by this module (or the JAX package's),
    or a legacy bare pickle. v2 files are CRC-verified before a single
    tensor is handed back; a mismatch raises
    :class:`CheckpointCorruptError` instead of returning garbage.
    Tensors land on ``device`` (default: the card)."""
    version, manifest, packed = _read_record(path)
    if verify and version >= 2:
        bad = _verify_manifest(manifest, packed)
        if bad:
            raise CheckpointCorruptError(
                f"{path}: {len(bad)} corrupt tensor(s): "
                + "; ".join(bad[:4]))
    _M_loads.inc()
    _flight.record("checkpoint", "restore",
                   path=os.path.basename(path), version=version)
    return _unpack(packed, return_numpy=return_numpy,
                   device=device)


def extract_state_dict(obj) -> Dict[str, Any]:
    """The model state dict inside a checkpoint payload: a sub-tree
    under the conventional ``model`` / ``state_dict`` / ``params``
    keys when the payload is a composite (model + optimizer + step
    bookkeeping, the trainer convention), else the payload itself
    when it already is a flat name -> tensor mapping. The serving
    weight hot-swap (``GenerationServer.swap_weights``) normalizes
    every checkpoint shape through this one seam."""
    if isinstance(obj, dict):
        for key in ("model", "state_dict", "params"):
            sub = obj.get(key)
            if isinstance(sub, dict) and sub and \
                    all(isinstance(k, str) for k in sub) and \
                    all(hasattr(v, "shape") or hasattr(v, "_data")
                        for v in sub.values()):
                return sub
        if obj and all(isinstance(k, str) for k in obj) and \
                all(hasattr(v, "shape") or hasattr(v, "_data")
                    for v in obj.values()):
            return obj
    raise ValueError(
        "cannot find a model state dict in the checkpoint payload — "
        "expected a flat {name: tensor} mapping or one nested under a "
        "'model'/'state_dict'/'params' key")


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """Full integrity check without materializing tensors on device:
    (True, "") for a loadable checkpoint, else (False, reason). Never
    raises for on-disk damage — truncation, unpicklable bytes and CRC
    mismatches all come back as reasons."""
    try:
        version, manifest, packed = _read_record(path)
    except CheckpointCorruptError as e:
        return False, str(e)
    except Exception as e:  # noqa: BLE001 — any decode failure = damage
        return False, f"unreadable ({type(e).__name__}: {e})"
    if version >= 2:
        bad = _verify_manifest(manifest, packed)
        if bad:
            return False, "; ".join(bad)
    return True, ""


# -- manager --------------------------------------------------------------

class CheckpointManager:
    """Step-indexed checkpoints under one directory with retention,
    corruption fallback and optional async persistence.

    ``save(obj, step)`` writes ``<root>/<prefix>-<step>.pdckpt``
    atomically and prunes to the newest ``keep_n``. ``latest()`` walks
    steps newest-first, verifying each manifest, and silently falls
    back past truncated/corrupt files to the newest good one — the
    elastic-restart contract: whatever a preemption did to the last
    save, resume finds a consistent state.
    """

    _SUFFIX = ".pdckpt"

    def __init__(self, root: str, keep_n: int = 3,
                 async_save: bool = False, prefix: str = "ckpt"):
        if keep_n < 1:
            raise ValueError(f"keep_n must be >= 1, got {keep_n}")
        self.root = str(root)
        self.keep_n = int(keep_n)
        self.async_save = bool(async_save)
        self.prefix = prefix
        os.makedirs(self.root, exist_ok=True)
        self._lock = make_lock("checkpoint.manager")
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._stats = {"saves": 0, "async_saves": 0, "bytes_written": 0,
                       "corrupt_skipped": 0, "retired": 0}
        steps = self.steps()
        self._next_step = (steps[-1] + 1) if steps else 0

    # -- paths ----------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.root,
                            f"{self.prefix}-{step:08d}{self._SUFFIX}")

    def steps(self) -> List[int]:
        """Steps with a (possibly damaged) checkpoint file, ascending.
        In-flight ``.tmp.*`` files are never counted."""
        pat = re.compile(
            rf"^{re.escape(self.prefix)}-(\d+){re.escape(self._SUFFIX)}$")
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            m = pat.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # -- save ------------------------------------------------------------
    def save(self, obj, step: Optional[int] = None) -> str:
        """Checkpoint ``obj``; returns the final path. Sync mode blocks
        until the file is durable; async mode returns once the host
        snapshot exists and persists on the background thread (the
        previous in-flight persist is barriered first, and its failure
        re-raised here)."""
        self.wait()
        if step is None:
            step = self._next_step
        step = int(step)
        self._next_step = max(self._next_step, step + 1)
        path = self._path(step)
        _fi.fire("checkpoint.snapshot")
        packed = _pack(obj)  # host copy of every tensor's bytes
        if not self.async_save:
            self._persist(packed, path)
            return path

        def run():
            try:
                self._persist(packed, path)
            except BaseException as e:  # noqa: BLE001 — incl. KillPoint
                with self._lock:
                    self._pending_error = e

        t = threading.Thread(target=run, daemon=True,
                             name=f"ckpt-persist-{step}")
        # start BEFORE publishing: joining an unstarted thread raises,
        # and a concurrent reader may _join_pending() the moment the
        # slot is visible
        t.start()
        with self._lock:
            self._pending = t
            self._stats["async_saves"] += 1
        _M_async.inc()
        return path

    def _persist(self, packed, path: str) -> None:
        n = _persist_packed(packed, path)
        with self._lock:
            self._stats["saves"] += 1
            self._stats["bytes_written"] += n
        self._retire()

    def _retire(self) -> None:
        for step in self.steps()[:-self.keep_n]:
            try:
                os.remove(self._path(step))
                with self._lock:
                    self._stats["retired"] += 1
                _M_retired.inc()
            except OSError:
                pass  # already gone / transient: retry next save

    # -- async barrier ---------------------------------------------------
    def _join_pending(self) -> None:
        """Join the in-flight persist thread (if any) and clear the
        slot ONLY if it still holds that same thread — a reader joining
        concurrently with a trainer's save() must never null out a
        freshly started persist."""
        t = self._pending
        if t is not None:
            t.join()
            with self._lock:
                if self._pending is t:
                    self._pending = None

    def wait(self) -> None:
        """Barrier on the in-flight async persist; re-raises its
        failure (KillPoint included) exactly once."""
        self._join_pending()
        with self._lock:
            err, self._pending_error = self._pending_error, None
        if err is not None:
            raise err

    def _drain_quietly(self) -> None:
        """Read-side barrier: the reader wants the newest durable state,
        not the background writer's exception — that stays parked for
        the next save()/wait()/close()."""
        self._join_pending()

    # -- restore ---------------------------------------------------------
    def latest(self) -> Optional[str]:
        """Path of the newest checkpoint whose manifest verifies, or
        None. Damaged files are skipped silently (counted in
        ``stats()['corrupt_skipped']``) — fallback IS the recovery
        path, not an error."""
        self._drain_quietly()
        for step in reversed(self.steps()):
            path = self._path(step)
            ok, _reason = verify_checkpoint(path)
            if ok:
                return path
            with self._lock:
                self._stats["corrupt_skipped"] += 1
            _M_corrupt.inc()
            _flight.record("checkpoint", "corrupt_fallback",
                           path=os.path.basename(path), where="latest")
        return None

    def _step_of(self, path: str) -> int:
        return int(os.path.basename(path)[len(self.prefix) + 1:
                                          -len(self._SUFFIX)])

    def latest_step(self) -> Optional[int]:
        path = self.latest()
        return None if path is None else self._step_of(path)

    def restore(self, return_numpy: bool = False, device=None):
        """(step, obj) from the newest good checkpoint, or None when no
        loadable checkpoint exists. One read+verify pass per candidate
        (latest()-then-load would decode and CRC the winner twice)."""
        self._drain_quietly()
        for step in reversed(self.steps()):
            try:
                obj = load_checkpoint(self._path(step),
                                      return_numpy=return_numpy,
                                      device=device)
            except Exception:  # noqa: BLE001 — damaged: fall back
                with self._lock:
                    self._stats["corrupt_skipped"] += 1
                _M_corrupt.inc()
                _flight.record(
                    "checkpoint", "corrupt_fallback",
                    path=os.path.basename(self._path(step)),
                    where="restore")
                continue
            return step, obj
        return None

    # -- lifecycle / observability ---------------------------------------
    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._stats)
        t = self._pending
        out["async_queue_depth"] = int(t is not None and t.is_alive())
        return out
