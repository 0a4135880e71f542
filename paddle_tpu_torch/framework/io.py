"""save / load: single-process checkpointing in the JAX package's format.

The port's counterpart of ``paddle_tpu.framework.io``. A tensor is
stored as a ``_TensorPayload`` record — its raw bytes, shape and numpy
dtype name — so that either package reads the other's files. The
record is pickled under the JAX package's class path,
``paddle_tpu.framework.io._TensorPayload``, and never under this
module's:

- **writing** — :class:`_Pickler` (the pure-Python pickler) emits that
  global itself; the stock picklers would import the named module to
  check it, and that module imports JAX;
- **reading** — :class:`_Unpickler` maps the path to the port's own
  class and refuses any other class of the JAX package, so a load never
  imports it. The plain-data configs listed in :data:`JAX_RECORDS` (the
  ``init_config`` of a JAX ``.pdmodel``) come back as
  :class:`JaxRecord` objects — their attributes, never their class —
  for ``convert`` to map.

bf16 bytes are encoded through an ``int16`` view and decoded with
``torch.frombuffer``; with ``return_numpy=True`` a bf16 tensor comes
back as f32 (an exact widening: numpy has no bf16 of its own).
Durability — the atomic write, the CRC32 manifest, retention — lives in
``framework/checkpoint.py``.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

# the class path a payload is pickled under (the JAX package's)
PAYLOAD_MODULE = "paddle_tpu.framework.io"
PAYLOAD_NAME = "_TensorPayload"
_FOREIGN = ("paddle_tpu", "jax", "jaxlib", "ml_dtypes")

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8,
           "uint16": torch.uint16, "uint32": torch.uint32,
           "uint64": torch.uint64, "bool": torch.bool,
           "complex64": torch.complex64, "complex128": torch.complex128}
_NAMES = {v: k for k, v in _DTYPES.items()}

# JAX-package classes of plain data that a file may hold and the port
# reads as records (their instance dicts)
JAX_RECORDS = ("paddle_tpu.models.llama.LlamaConfig",)


class JaxRecord:
    """A plain-data object of the JAX package (one of
    :data:`JAX_RECORDS`) read from a file: the instance attributes it
    was pickled with, never its class."""

    def __repr__(self):
        return f"JaxRecord({vars(self)})"


class _TensorPayload:
    """One tensor's bytes (C order), shape and numpy dtype name: the
    JAX package's record, attribute for attribute."""

    __slots__ = ("bytes", "shape", "dtype_str")

    def __init__(self, t: torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        self.shape = tuple(int(s) for s in t.shape)
        if t.dtype == torch.bfloat16:
            self.dtype_str = "bfloat16"
            self.bytes = t.view(torch.int16).numpy().tobytes()
        else:
            if t.dtype not in _NAMES:
                raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
            self.dtype_str = _NAMES[t.dtype]
            self.bytes = t.numpy().tobytes()

    def tensor(self, device) -> torch.Tensor:
        dt = _DTYPES[self.dtype_str]
        if not self.bytes:
            return torch.empty(self.shape, dtype=dt, device=device)
        t = torch.frombuffer(bytearray(self.bytes), dtype=dt)
        return t.reshape(self.shape).to(device)

    def numpy(self) -> np.ndarray:
        if self.dtype_str == "bfloat16":
            return self.tensor("cpu").float().numpy()
        return np.frombuffer(
            self.bytes, np.dtype(self.dtype_str)).reshape(self.shape)


class _Pickler(pickle._Pickler):
    """Writes ``_TensorPayload`` under the JAX package's class path,
    without importing it."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(PAYLOAD_MODULE)
            self.save(PAYLOAD_NAME)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{PAYLOAD_MODULE}\n"
                       f"{PAYLOAD_NAME}\n".encode("ascii"))
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Maps the payload's class path to the port's class; refuses every
    other class of the JAX package (loading one would import JAX)."""

    def find_class(self, module, name):
        if name == PAYLOAD_NAME and module in (PAYLOAD_MODULE, __name__):
            return _TensorPayload
        if f"{module}.{name}" in JAX_RECORDS:
            return JaxRecord
        if module.split(".")[0] in _FOREIGN:
            raise pickle.UnpicklingError(
                f"checkpoint references {module}.{name}, which the port "
                f"does not load")
        return super().find_class(module, name)


def _dumps(obj, protocol: int = 4) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(obj)
    return buf.getvalue()


def _load_pickle(f):
    return _Unpickler(f).load()


def _pack(obj):
    """Tensors -> payloads through dicts, lists and tuples. Each
    payload copies its tensor's bytes now, so a later in-place update
    of the tensor does not reach the packed tree."""
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy: bool = False, device=None):
    """Payloads -> numpy arrays (``return_numpy``) or tensors on
    ``device`` (resolved once, on the first payload)."""
    dev = []

    def walk(o):
        if isinstance(o, _TensorPayload):
            if return_numpy:
                return o.numpy()
            if not dev:
                from ..core.device import resolve_device
                dev.append(resolve_device(device))
            return o.tensor(dev[0])
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(walk(v) for v in o)
        return o

    return walk(obj)


def save(obj, path, protocol=4, **configs):
    """Write ``obj`` (tensors nested in dicts, lists and tuples) to
    ``path`` atomically, with a CRC32 manifest."""
    from .checkpoint import atomic_save  # lazy: checkpoint imports io
    atomic_save(obj, path, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """Read a file ``save`` (of either package) wrote, verifying its
    manifest. Tensors come back on the card, or where
    ``device=`` says (``device="cpu"``); numpy arrays with
    ``return_numpy=True``."""
    from .checkpoint import load_checkpoint
    return load_checkpoint(path, return_numpy=return_numpy,
                           device=configs.get("device"))
