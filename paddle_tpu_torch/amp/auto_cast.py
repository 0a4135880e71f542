"""AMP autocast of the port: ``auto_cast`` and ``decorate``.

The port of ``paddle_tpu/amp/auto_cast.py``. The autocast context sets
a thread-local regime that ``core.autograd.apply_op`` reads: every op
dispatched there by name has its f32 inputs cast per paddle's lists
(:func:`maybe_cast_inputs`), so the same ops run in the same dtypes as
in the JAX package. ``torch.autocast`` is not used: its op lists are
not paddle's.

- O1: an op on the white list (matmul-like) runs its f32 inputs in the
  low dtype (bf16 by default); an op on the black list (softmax, norms,
  exp/log, reductions) runs its low-dtype inputs in f32; every other op
  runs its inputs as they come.
- O2: every op but the black list runs its f32 inputs in the low dtype.

The casts are ``Tensor.to`` calls, so autograd carries the gradient of
an f32 master weight through its low-precision copy.
:func:`amp_signature` is the regime as a hashable tuple: the
whole-step capture (``jit/sot.py``) keys its graphs on it.
"""
from __future__ import annotations

import threading

import torch

from ..core.dtype import convert_dtype

__all__ = ["WHITE_LIST", "BLACK_LIST", "white_list", "black_list",
           "auto_cast", "autocast", "amp_guard", "amp_state",
           "amp_signature", "maybe_cast_inputs", "decorate"]

# O1 white list: matmul-like ops where low precision is safe and fast
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "mm", "bmm",
    "einsum", "flash_attention", "sdpa",
}
# ops kept in f32 (softmax, norms, exp-like numerics and reductions)
BLACK_LIST = {
    "softmax", "log_softmax", "cross_entropy", "layer_norm", "batch_norm",
    "group_norm", "rms_norm", "exp", "log", "mean", "sum", "logsumexp",
    "cumsum",
}


def white_list():
    return WHITE_LIST


def black_list():
    return BLACK_LIST


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = None
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


def amp_signature() -> tuple:
    """The autocast regime as a hashable tuple (enabled, dtype, level,
    custom lists): a graph captured under one regime never serves a
    call made under another."""
    return (bool(_state.enabled), str(getattr(_state, "dtype", None)),
            getattr(_state, "level", None),
            tuple(sorted(_state.custom_white or ())),
            tuple(sorted(_state.custom_black or ())))


class auto_cast:
    """Context manager. ``level`` O1: the per-op white list runs low;
    O2: everything but the black list runs low."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        self.enable = enable
        self.level = level
        self.dtype = dtype
        self.custom_white = set(custom_white_list or ())
        self.custom_black = set(custom_black_list or ())

    def __enter__(self):
        self._prev = (_state.enabled, _state.dtype, _state.level,
                      _state.custom_white, _state.custom_black)
        _state.enabled = bool(self.enable)
        _state.dtype = convert_dtype(self.dtype)
        _state.level = self.level
        _state.custom_white = self.custom_white
        _state.custom_black = self.custom_black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = self._prev
        return False


autocast = auto_cast
amp_guard = auto_cast


def _cast(a, src, dst):
    if isinstance(a, torch.Tensor) and a.dtype == src:
        return a.to(dst)
    return a


def maybe_cast_inputs(op_name: str, datas):
    """``datas`` (torch tensors and other arguments) cast per the AMP
    regime for op ``op_name``; returned unchanged when autocast is
    off."""
    if not _state.enabled:
        return datas
    name = op_name or ""
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    black = (BLACK_LIST | _state.custom_black) - _state.custom_white
    low = _state.dtype
    f32 = torch.float32
    if _state.level == "O2":
        if name in black:
            return [_cast(a, f32, f32) for a in datas]
        return [_cast(a, f32, low) for a in datas]
    if name in white:
        return [_cast(a, f32, low) for a in datas]
    if name in black:
        return [_cast(a, low, f32) for a in datas]
    return datas


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 casts the models' parameters to the low dtype (the optimizer
    keeps its moments in f32 with ``multi_precision``); O1 leaves them.
    Returns ``models``, or ``(models, optimizers)`` when optimizers are
    given."""
    if level == "O2":
        items = models if isinstance(models, (list, tuple)) else [models]
        for m in items:
            m.to(dtype=dtype)
    if optimizers is None:
        return models
    return models, optimizers
