"""``paddle.device.cuda`` of the port: the card's memory counters,
streams and properties.

The port of ``paddle_tpu/device/cuda.py``. The JAX package has no CUDA
backend and forwards the memory functions to its accelerator's; here
they are the card's own (``torch.cuda``'s caching allocator), and the
device queries answer for the card where the JAX shim raises.
"""
from __future__ import annotations

import torch

from . import (  # noqa: F401
    Event, Stream, current_stream, empty_cache, max_memory_allocated,
    max_memory_reserved, memory_allocated, memory_reserved, memory_stats,
    reset_max_memory_allocated, reset_peak_memory_stats, stream_guard,
    synchronize)

__all__ = [
    "Stream", "Event", "current_stream", "synchronize", "device_count",
    "empty_cache", "max_memory_allocated", "max_memory_reserved",
    "memory_allocated", "memory_reserved", "reset_max_memory_allocated",
    "reset_peak_memory_stats", "stream_guard", "get_device_properties",
    "get_device_name", "get_device_capability",
]


def device_count() -> int:
    return torch.cuda.device_count()


def _index(device):
    if device is None:
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    return torch.device(str(device).replace("gpu", "cuda")).index or 0


def get_device_properties(device=None):
    return torch.cuda.get_device_properties(_index(device))


def get_device_name(device=None) -> str:
    return torch.cuda.get_device_name(_index(device))


def get_device_capability(device=None):
    return torch.cuda.get_device_capability(_index(device))
