"""Full jitter for bounded-exponential backoffs.

The port's copy of ``paddle_tpu.utils.backoff``. A retry loop (the
``ServingSupervisor``'s restarts) backs off as ``base * 2^(attempt-1)``
capped at a bound; full jitter sleeps ``uniform(0, bound)`` instead, so
retriers of one shared failure do not wake in step. The expected extra
wait is half a bound and the worst case never exceeds the plain one.

``FLAGS_backoff_full_jitter=0`` restores the deterministic schedule,
and :func:`seed` makes the draws reproducible: the same seed gives the
same draws as the JAX module's (both draw from ``random.Random``).
"""
from __future__ import annotations

import random
import threading

from ..core.flags import flag_value

__all__ = ["full_jitter", "seed"]

_lock = threading.Lock()
_rng = random.Random()


def seed(n: int) -> None:
    """Re-seed the jitter generator (tests that pin the jittered
    schedule)."""
    with _lock:
        _rng.seed(n)


def full_jitter(bound: float) -> float:
    """The sleep for one backoff step whose plain value is ``bound``:
    ``uniform(0, bound)`` under the flag (the default), else ``bound``
    itself. Never negative."""
    bound = max(float(bound), 0.0)
    if bound == 0.0 or not flag_value("backoff_full_jitter"):
        return bound
    with _lock:
        return _rng.uniform(0.0, bound)
