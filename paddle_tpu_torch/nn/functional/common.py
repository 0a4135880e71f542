"""Common functionals of the port: ``linear``, ``embedding`` and
``dropout``.

The port of ``paddle_tpu/nn/functional/common.py`` (``linear``,
``embedding``, ``dropout``). Plain PyTorch code: the JAX package has no
Pallas kernel for any of them. Each takes Tensors or torch tensors
(``core.autograd.apply_op``) and returns the same kind.

``dropout`` in its main mode (``upscale_in_train`` over the whole
tensor) draws the JAX package's hash mask: a murmur3 finalizer over
``index * 0x9E3779B1 + seed`` in uint32 arithmetic, kept iff the hash is
at least ``min(floor(p·2³²), 2³²−1)`` — from the same uint32 seed it is
the JAX mask bit for bit. The seed is a 0-dim tensor on the tensor's
device, ``core.random.derive_seed`` of a fresh key of the port's key
stream (as the JAX function derives it from a JAX key): the mask is
computed from device data, so a CUDA graph that holds the call draws a
fresh mask on every replay. The ``axis`` and ``downscale_in_infer``
modes draw a Bernoulli mask on the tensor's device from a generator
seeded by a host draw (``core.random.device_generator``).
"""
from __future__ import annotations

import math

import torch

from ...core import random as _random
from ...core.autograd import apply_op

__all__ = ["linear", "embedding", "dropout", "hash_keep_mask", "one_hot",
           "label_smooth"]

_M32 = 0xFFFFFFFF


def _linear(x, weight, bias):
    # the [in, out] weight read transposed: one GEMM with the bias in
    # its epilogue, and the weight's gradient comes out [in, out]
    return torch.nn.functional.linear(x, weight.t(), bias)


def linear(x, weight, bias=None, name=None):
    """``y = x W + b`` with paddle's ``[in, out]`` weight layout."""
    return apply_op(_linear, x, weight, bias, op_name="linear")


def _embedding(idx, weight, padding_idx):
    out = torch.nn.functional.embedding(idx, weight)
    if padding_idx is not None:
        out = torch.where((idx == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; ids equal to ``padding_idx``
    give zeros (and no gradient), as in the JAX function."""
    return apply_op(_embedding, x, weight, padding_idx=padding_idx,
                    op_name="embedding")


def one_hot(x, num_classes, name=None):
    """f32 one-hot rows of the ids ``x``; an id outside
    ``[0, num_classes)`` gives a row of zeros, as in the JAX function."""
    return apply_op(lambda idx: (idx[..., None].long() == torch.arange(
        num_classes, device=idx.device)).float(), x, op_name="one_hot")


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon * prior`` (a uniform prior when
    ``prior_dist`` is None)."""
    from ...core.tensor import unwrap
    pd = unwrap(prior_dist)   # a constant, as the JAX function's closure

    def f(lbl):
        if pd is None:
            return (1 - epsilon) * lbl + epsilon / lbl.shape[-1]
        return (1 - epsilon) * lbl + epsilon * pd.detach()
    return apply_op(f, label, op_name="label_smooth")


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2³²`` for int64 ``a`` in [0, 2³²): the int64 product
    wraps, its low 32 bits are exact."""
    return (a * c) & _M32


def hash_keep_mask(shape, p: float, seed, device=None) -> torch.Tensor:
    """The JAX package's hash dropout mask (``common.py:66-79``) as a
    bool tensor of ``shape``: element ``i`` (row-major) is kept iff
    ``murmur3_fmix32(i * 0x9E3779B1 + seed) >= thresh``. ``seed`` is the
    uint32 seed as a 0-dim int64 tensor (``derive_seed(key, "uint32")``,
    on ``device``; its device by default) or an int."""
    n = math.prod(shape)
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        seed = seed.to(device=device, dtype=torch.int64)
    h = torch.arange(n, dtype=torch.int64, device=device)
    h = (_mul32(h, 0x9E3779B1) + (seed & _M32)) & _M32
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    thresh = min(int(p * (2 ** 32)), 2 ** 32 - 1)
    return (h >= thresh).view(tuple(shape))


def _scale_value(p: float, dtype: torch.dtype) -> float:
    """``1 - p`` as the JAX package divides by it: a weak Python scalar
    takes the tensor's dtype, so in bf16 it is rounded to bf16 first."""
    return torch.tensor(1.0 - p, dtype=dtype).item()


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None):
    """Paddle's dropout. ``upscale_in_train``: kept elements are divided
    by ``1 - p`` in training, eval passes ``x`` through;
    ``downscale_in_infer``: training applies the raw mask, eval scales
    by ``1 - p``. ``axis`` shares one mask along the other axes."""
    return apply_op(_dropout, x, p=p, axis=axis, training=training,
                    mode=mode, op_name="dropout")


def _dropout(x: torch.Tensor, p: float, axis, training: bool,
             mode: str) -> torch.Tensor:
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        if training or mode == "upscale_in_train" or p == 0.0:
            return x
        return (x * (1.0 - p)).to(x.dtype)
    if p == 1.0:
        # zeros with zero (not NaN) gradients
        return torch.where(torch.zeros_like(x, dtype=torch.bool), x, 0.0)
    if axis is None and mode == "upscale_in_train" and x.numel() > 1:
        seed = _random.derive_seed(_random.next_key(x.device), "uint32")
        keep = hash_keep_mask(x.shape, p, seed, x.device)
        return torch.where(keep, x / _scale_value(p, x.dtype),
                           0.0).to(x.dtype)
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    g = _random.device_generator(x.device)
    keep = torch.rand(shape, generator=g, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / _scale_value(p, x.dtype),
                           0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)
