"""Common functionals of the port: ``linear``, ``embedding``, the
dropouts, the vision rows (``interpolate`` / ``upsample``,
``pixel_shuffle`` / ``pixel_unshuffle``, ``channel_shuffle``, ``fold``,
``zeropad2d``) and the distances (``cosine_similarity``,
``normalize``, ``pairwise_distance``) with ``bilinear``.

The port of ``paddle_tpu/nn/functional/common.py``. Plain PyTorch
code: the JAX package has no Pallas kernel for any of them. Each takes Tensors or torch tensors
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
seeded by a host draw (``core.random.device_generator``), and so do
``dropout2d`` / ``dropout3d`` (axis dropout over batch and channel),
``alpha_dropout`` and ``feature_alpha_dropout`` (one mask a channel).

``interpolate`` is ``jax.image.resize``, which the JAX function calls:
nearest takes the source pixel ``floor((i + ½)·in/out)``; linear
(``linear``, ``bilinear``, ``trilinear``, ``area``) and ``bicubic``
(Keys' cubic, a = −½) contract each resized axis with the weight
matrix JAX builds (half-pixel centres, the kernel widened by the
downscale factor — antialiasing —, each column normalised, samples
outside the input zeroed), computed here in f32 on the host and cast
to the input's dtype. ``align_corners`` and ``align_mode`` are
accepted and unused, as in the JAX function.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import random as _random
from ...core.autograd import apply_op

__all__ = ["linear", "embedding", "dropout", "hash_keep_mask", "one_hot",
           "label_smooth", "dropout2d", "dropout3d", "alpha_dropout",
           "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "fold", "zeropad2d", "cosine_similarity",
           "normalize", "bilinear", "pairwise_distance",
           "feature_alpha_dropout"]

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


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: one mask over batch and channel."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _alpha_dropout(a, p):
    g = _random.device_generator(a.device)
    keep = torch.rand(a.shape, generator=g, device=a.device) < 1.0 - p
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    return (a_coef * torch.where(keep, a, alpha_p) + b_coef).to(a.dtype)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take ``−αλ``, then the
    affine map that keeps mean and variance."""
    if not training or p == 0.0:
        return x
    return apply_op(_alpha_dropout, x, p=p, op_name="alpha_dropout")


def _feature_alpha_dropout(a, p):
    g = _random.device_generator(a.device)
    shape = tuple(a.shape[:2]) + (1,) * (a.dim() - 2)
    keep = torch.rand(shape, generator=g, device=a.device) < 1.0 - p
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * (1 - q)) ** -0.5
    b_coef = -a_coef * alpha_p * (1 - q)
    return (a_coef * torch.where(keep, a, alpha_p) + b_coef).to(a.dtype)


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """``alpha_dropout`` with one mask a feature map (batch × channel,
    broadcast over the spatial axes)."""
    if not training or p == 0.0:
        return x
    if not 0 <= p < 1:
        raise ValueError(f"p must be in [0, 1), got {p}")
    return apply_op(_feature_alpha_dropout, x, p=p,
                    op_name="feature_alpha_dropout")


# -- distances and bilinear ---------------------------------------------------

def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``Σ x1·x2 / max(|x1|·|x2|, eps)`` along ``axis``."""
    def f(a, b):
        dot = (a * b).sum(axis)
        na = (a * a).sum(axis).sqrt()
        nb = (b * b).sum(axis).sqrt()
        return dot / torch.clamp(na * nb, min=eps)
    return apply_op(f, x1, x2, op_name="cosine_similarity")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(‖x‖_p, epsilon)`` along ``axis``."""
    def f(a):
        n = (a.abs() ** p).sum(axis, keepdim=True) ** (1.0 / p)
        return a / torch.clamp(n, min=epsilon)
    return apply_op(f, x, op_name="normalize")


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = Σ x1[b, i] W[o, i, j] x2[b, j] + bias[o]``."""
    def f(a, b, w, bias=None):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out if bias is None else out + bias
    return apply_op(f, x1, x2, weight, bias, op_name="bilinear")


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of ``x - y + epsilon`` along the last axis."""
    def f(a, b):
        d = (a - b + epsilon).abs()
        if p == float("inf"):
            return d.amax(-1, keepdim=keepdim)
        if p == float("-inf"):
            return d.amin(-1, keepdim=keepdim)
        return (d ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)
    return apply_op(f, x, y, op_name="pairwise_distance")


# -- resizing (jax.image.resize) ----------------------------------------------

def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def _resize_weights(n_in: int, n_out: int, kernel) -> np.ndarray:
    """``jax.image``'s ``compute_weight_mat`` (antialiased, no
    translation) in f32: ``[n_in, n_out]``."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / \
        kernel_scale
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000. * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


_RESIZE = {"bilinear": _triangle, "trilinear": _triangle,
           "linear": _triangle, "area": _triangle, "bicubic": _keys_cubic}


def _resize(a, *, out_sizes, mode, channel_last):
    off = 1 if channel_last else 2
    out = a if a.is_floating_point() else a.float()
    for d, n_out in enumerate(out_sizes):
        axis = off + d
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        if mode == "nearest":
            src = np.floor(((np.arange(n_out, dtype=np.float32) + 0.5)
                            * np.float32(n_in) / np.float32(n_out))
                           .astype(np.float32)).astype(np.int64)
            out = out.index_select(axis, torch.as_tensor(src,
                                                         device=a.device))
            continue
        w = torch.as_tensor(_resize_weights(n_in, n_out, _RESIZE[mode]),
                            device=a.device).to(out.dtype)
        out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1, axis)
    return out.to(a.dtype)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    from ...core.tensor import unwrap
    if mode not in ("nearest",) + tuple(_RESIZE):
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    channel_last = data_format in ("NHWC", "NDHWC", "NLC")
    shape = list(x.shape)
    nd = len(shape) - 2
    spatial = shape[1:-1] if channel_last else shape[2:]
    size, scale_factor = unwrap(size), unwrap(scale_factor)
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        out_sizes = [int(s) for s in (size if isinstance(size, (list, tuple))
                                      else [size])]
    else:
        sf = scale_factor
        if isinstance(sf, torch.Tensor):
            sf = [float(v) for v in sf.reshape(-1).tolist()]
        if not isinstance(sf, (list, tuple)):
            sf = [sf] * nd
        out_sizes = [int(s * f) for s, f in zip(spatial, sf)]
    return apply_op(_resize, x, out_sizes=out_sizes, mode=mode,
                    channel_last=channel_last, op_name="interpolate")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pixel_shuffle(a, *, r, nchw):
    if nchw:
        n, c, h, w = a.shape
        oc = c // (r * r)
        return a.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3) \
            .reshape(n, oc, h * r, w * r)
    n, h, w, c = a.shape
    oc = c // (r * r)
    return a.reshape(n, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, h * r, w * r, oc)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return apply_op(_pixel_shuffle, x, r=upscale_factor,
                    nchw=data_format == "NCHW", op_name="pixel_shuffle")


def _pixel_unshuffle(a, *, r, nchw):
    if nchw:
        n, c, h, w = a.shape
        return a.reshape(n, c, h // r, r, w // r, r) \
            .permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = a.shape
    return a.reshape(n, h // r, r, w // r, r, c) \
        .permute(0, 2, 4, 5, 1, 3).reshape(n, h // r, w // r, c * r * r)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return apply_op(_pixel_unshuffle, x, r=downscale_factor,
                    nchw=data_format == "NCHW", op_name="pixel_unshuffle")


def _channel_shuffle(a, *, groups, nchw):
    if nchw:
        n, c, h, w = a.shape
        return a.reshape(n, groups, c // groups, h, w) \
            .transpose(1, 2).reshape(n, c, h, w)
    n, h, w, c = a.shape
    return a.reshape(n, h, w, groups, c // groups) \
        .transpose(3, 4).reshape(n, h, w, c)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return apply_op(_channel_shuffle, x, groups=groups,
                    nchw=data_format == "NCHW", op_name="channel_shuffle")


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def _fold(a, *, os, ks, st, pd, dl):
    n, ckk, _ = a.shape
    c = ckk // (ks[0] * ks[1])
    ph, pw = os[0] + pd[0] + pd[2], os[1] + pd[1] + pd[3]
    oh = (ph - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (pw - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    a = a.reshape(n, c, ks[0], ks[1], oh, ow)
    out = torch.zeros((n, c, ph, pw), dtype=a.dtype, device=a.device)
    for i in range(ks[0]):
        for j in range(ks[1]):
            hi, wj = i * dl[0], j * dl[1]
            out[:, :, hi:hi + oh * st[0]:st[0],
                wj:wj + ow * st[1]:st[1]] += a[:, :, i, j]
    return out[:, :, pd[0]:ph - pd[2], pd[1]:pw - pd[3]]


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of ``unfold``: ``[N, C·kh·kw, L]`` blocks
    summed into ``[N, C, *output_sizes]``."""
    pd = _pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    return apply_op(_fold, x, os=_pair(output_sizes), ks=_pair(kernel_sizes),
                    st=_pair(strides), pd=pd, dl=_pair(dilations),
                    op_name="fold")


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero padding ``[left, right, top, bottom]`` of the two spatial
    axes."""
    from ...core.tensor import unwrap
    padding = unwrap(padding)
    if isinstance(padding, torch.Tensor):
        padding = padding.tolist()
    l_, r_, t_, b_ = [int(v) for v in padding]
    pads = [l_, r_, t_, b_] if data_format == "NCHW" else \
        [0, 0, l_, r_, t_, b_]
    return apply_op(lambda a: torch.nn.functional.pad(a, pads), x,
                    op_name="zeropad2d")
