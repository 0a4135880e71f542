"""Subsystem lock factory.

The port's copy of ``paddle_tpu.analysis.locks.make_lock``. The JAX
package can swap in instrumented locks for lock-order auditing; that
auditor is not ported, so the factory returns the plain threading
primitive. The name is kept at every call site so the auditor can come
back without touching them. :func:`caller_site` is the analysis plane's
shared call-site attribution (the JAX module's).
"""
from __future__ import annotations

import threading

__all__ = ["make_lock", "caller_site"]


def make_lock(name: str, rlock: bool = False):
    """A plain ``threading.Lock`` (``RLock`` with ``rlock=True``);
    ``name`` is the lock's stable identity for diagnostics."""
    del name
    return threading.RLock() if rlock else threading.Lock()


def caller_site(skip_suffixes) -> str:
    """``pkg/file.py:line`` of the nearest stack frame whose file name
    ends with none of ``skip_suffixes``."""
    import sys
    f = sys._getframe(1)
    skip = tuple(skip_suffixes)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if not fn.endswith(skip):
            parts = fn.split("/")
            short = "/".join(parts[-2:]) if len(parts) > 1 else fn
            return f"{short}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"
