"""``paddle.device`` of the port: the device queries, streams, events,
``synchronize`` and the memory counters.

The port of ``paddle_tpu/device/__init__.py``. Where the JAX package's
streams and events are thin wrappers over XLA's dispatch queue, here
they are CUDA's: :class:`Stream` and :class:`Event` hold a
``torch.cuda.Stream`` / ``torch.cuda.Event`` on the card (on the CPU
they keep the JAX wrappers' identity-only behaviour), and
``synchronize`` waits for the card. The memory API reads
``core.memory``: the caching allocator's exact counters on the card,
the op-boundary tracker on the CPU; ``program_memory_analysis`` reports
a captured program's CUDA graph pool.
"""
from __future__ import annotations

import contextlib
import gc

import torch

from ..core.device import (  # noqa: F401
    CPUPlace, CUDAPlace, Place, TPUPlace, current_device, device_count,
    get_device, is_compiled_with_cuda, is_compiled_with_tpu, set_device)

__all__ = [
    "get_cudnn_version", "set_device", "get_device", "XPUPlace",
    "IPUPlace", "is_compiled_with_xpu", "is_compiled_with_ipu",
    "is_compiled_with_cinn", "is_compiled_with_cuda",
    "is_compiled_with_rocm", "is_compiled_with_distribute",
    "is_compiled_with_custom_device", "get_all_device_type",
    "get_all_custom_device_type", "get_available_device",
    "get_available_custom_device", "Stream", "Event", "current_stream",
    "set_stream", "stream_guard", "synchronize",
    "memory_stats", "memory_allocated", "max_memory_allocated",
    "memory_reserved", "max_memory_reserved",
    "reset_max_memory_allocated", "reset_peak_memory_stats",
    "empty_cache", "program_memory_analysis",
]


def get_cudnn_version():
    """cuDNN's version as an int when torch has it, else None."""
    try:
        return torch.backends.cudnn.version()
    except Exception:  # noqa: BLE001 — a build without cuDNN
        return None


def XPUPlace(dev_id: int = 0):
    raise RuntimeError("this build has no XPU backend (CUDA)")


def IPUPlace():
    raise RuntimeError("this build has no IPU backend (CUDA)")


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return bool(getattr(torch.version, "hip", None))


def is_compiled_with_distribute() -> bool:
    return torch.distributed.is_available()


def is_compiled_with_custom_device(device_type: str) -> bool:
    return False


def get_all_device_type():
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())] \
        or ["cpu"]


def get_available_custom_device():
    return []


def _torch_device(device=None) -> torch.device:
    """A paddle device spec (None: the current device; ``"gpu:1"``, an
    int, a ``Place``, a torch device) as a torch device."""
    if device is None:
        return current_device()
    if isinstance(device, torch.device):
        return device
    if isinstance(device, int):
        return torch.device("cuda", device)
    if isinstance(device, Place):
        return torch.device("cpu") if device.device_type == "cpu" else \
            torch.device("cuda", device.device_id)
    spec = str(device).replace("gpu", "cuda")
    dev = torch.device(spec)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Stream:
    """An execution stream: a ``torch.cuda.Stream`` on the card
    (``priority`` 1 is high, 2 normal, as paddle's), identity only on
    the CPU."""

    def __init__(self, device=None, priority=2, stream=None):
        self.device = _torch_device(device)
        self.priority = priority
        self._s = stream
        if self._s is None and self.device.type == "cuda":
            self._s = torch.cuda.Stream(self.device,
                                        priority=-1 if priority == 1 else 0)

    def synchronize(self):
        if self._s is not None:
            self._s.synchronize()

    def wait_event(self, event):
        if self._s is not None and event._e is not None:
            self._s.wait_event(event._e)

    def wait_stream(self, stream):
        if self._s is not None and stream._s is not None:
            self._s.wait_stream(stream._s)

    def record_event(self, event=None):
        event = event or Event(self.device)
        event.record(self)
        return event


class Event:
    """A sync point: a ``torch.cuda.Event`` on the card."""

    def __init__(self, device=None, enable_timing=False, blocking=False,
                 interprocess=False):
        self.device = _torch_device(device)
        self._e = torch.cuda.Event(enable_timing=enable_timing,
                                   blocking=blocking,
                                   interprocess=interprocess) \
            if self.device.type == "cuda" else None

    def record(self, stream=None):
        if self._e is not None:
            s = (stream or current_stream(self.device))._s
            self._e.record(s)

    def query(self) -> bool:
        return True if self._e is None else self._e.query()

    def synchronize(self):
        if self._e is not None:
            self._e.synchronize()


_current_streams: dict = {}


def current_stream(device=None) -> Stream:
    dev = _torch_device(device)
    s = _current_streams.get(dev)
    if s is None:
        s = Stream(dev, stream=torch.cuda.current_stream(dev)
                   if dev.type == "cuda" else None)
    return s


def set_stream(stream: Stream) -> Stream:
    prev = current_stream(stream.device)
    _current_streams[stream.device] = stream
    if stream._s is not None:
        torch.cuda.set_stream(stream._s)
    return prev


@contextlib.contextmanager
def stream_guard(stream: Stream):
    prev = set_stream(stream)
    try:
        yield
    finally:
        set_stream(prev)


def synchronize(device=None):
    """Wait for the card's queued work (nothing to wait for on the
    CPU)."""
    dev = _torch_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- memory -------------------------------------------------------------------

def memory_stats(device=None):
    """``allocated`` / ``reserved`` current and peak bytes of one
    device (``core.memory.stats_for``)."""
    from ..core import memory as _memory
    return _memory.stats_for(_torch_device(device))


def memory_allocated(device=None) -> int:
    return memory_stats(device)["allocated.current"]


def max_memory_allocated(device=None) -> int:
    return memory_stats(device)["allocated.peak"]


def memory_reserved(device=None) -> int:
    return memory_stats(device)["reserved.current"]


def max_memory_reserved(device=None) -> int:
    return memory_stats(device)["reserved.peak"]


def reset_max_memory_allocated(device=None) -> None:
    from ..core import memory as _memory
    _memory.reset_peak(_torch_device(device))


def reset_peak_memory_stats(device=None) -> None:
    reset_max_memory_allocated(device)


def empty_cache() -> None:
    """Drop dead Python references, then give the caching allocator's
    free blocks back to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program_memory_analysis(program, *example_args):
    """The memory of a captured program: the bytes its CUDA graph pool
    holds (the temporaries and outputs its graphs keep between
    replays) and its graphs. ``program`` is a ``jit.sot.CaptureGroup``
    or ``CapturedStep``, or what holds one: a ``jit.TrainStep``, a
    ``hapi.Model``, a paged decode engine. The JAX package's XLA fields
    have no counterpart; ``peak_hbm`` is the pool."""
    if example_args:
        raise TypeError("program_memory_analysis: the port reads a "
                        "captured program, not a function and inputs")
    from ..core import memory as _memory
    obj = program
    for attr in ("_step", "_captured", "_graphs"):
        if getattr(obj, attr, None) is not None:
            obj = getattr(obj, attr)
            break
    if hasattr(obj, "pool_bytes"):
        nbytes = int(obj.pool_bytes())
    else:
        nbytes = _memory.pool_bytes(getattr(obj, "_pool", None))
    graphs = obj.graphs() if hasattr(obj, "graphs") else None
    if isinstance(graphs, dict):
        graphs = sum(graphs.values())
    return {"pool_bytes": nbytes, "graphs": graphs, "peak_hbm": nbytes}


from . import cuda  # noqa: E402,F401  (paddle.device.cuda)
