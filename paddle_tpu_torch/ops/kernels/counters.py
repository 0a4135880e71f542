"""The port's kernel launch counters, read and advanced together.

Each kernel wrapper adds to its own counters where it launches
(``.launches`` and its design's ``.tma_launches``, ``.split_launches``
...). A CUDA graph replay runs no Python, so the whole-step capture
(``jit/sot.py``: ``CapturedStep`` and ``SOTFunction``'s segment
graphs; ``jit/api.py`` ``StaticFunction``) takes :func:`snapshot`
before and after a capture,
puts the counters back (:func:`restore`: capturing launches nothing)
and adds the difference (:func:`delta`) on every replay
(:func:`advance`): the counts then read as if each step had launched
its kernels from Python.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

__all__ = ["snapshot", "delta", "restore", "advance"]

# module of ops.kernels -> its counted wrappers
_WRAPPERS = {
    "flash_attention": ("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"),
    "grouped_matmul": ("grouped_matmul_fwd", "grouped_matmul_dlhs",
                       "grouped_matmul_drhs"),
    "multi_tensor": ("multi_tensor_unscale_norm", "multi_tensor_adam"),
    "paged_attention": ("paged_attention_kernel",),
}

Key = Tuple[object, str]


def _counted():
    for mod, names in _WRAPPERS.items():
        m = importlib.import_module(f"{__package__}.{mod}")
        for name in names:
            fn = getattr(m, name, None)
            if fn is None:
                continue
            for attr, v in vars(fn).items():
                if attr.endswith("launches") and isinstance(v, int):
                    yield fn, attr


def snapshot() -> Dict[Key, int]:
    """Every counter's value, keyed by (wrapper, attribute)."""
    return {(fn, attr): getattr(fn, attr) for fn, attr in _counted()}


def delta(before: Dict[Key, int], after: Dict[Key, int]) -> Dict[Key, int]:
    """The counters that moved between two snapshots, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def restore(snap: Dict[Key, int]) -> None:
    for (fn, attr), v in snap.items():
        setattr(fn, attr, v)


def advance(d: Dict[Key, int]) -> None:
    for (fn, attr), n in d.items():
        setattr(fn, attr, getattr(fn, attr) + n)
