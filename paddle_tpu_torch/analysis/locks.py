"""Subsystem lock factory.

The port's copy of ``paddle_tpu.analysis.locks.make_lock``. The JAX
package can swap in instrumented locks for lock-order auditing; that
auditor is not ported, so the factory returns the plain threading
primitive. The name is kept at every call site so the auditor can come
back without touching them.
"""
from __future__ import annotations

import threading

__all__ = ["make_lock"]


def make_lock(name: str, rlock: bool = False):
    """A plain ``threading.Lock`` (``RLock`` with ``rlock=True``);
    ``name`` is the lock's stable identity for diagnostics."""
    del name
    return threading.RLock() if rlock else threading.Lock()
