"""Convolution functionals of the port: ``conv1d/2d/3d`` and
``conv{1,2,3}d_transpose``.

The port of ``paddle_tpu/nn/functional/conv.py``. The JAX package hands
every convolution to XLA (``lax.conv_general_dilated``, no Pallas
kernel); here it is cuDNN's, through ``torch.nn.functional.conv*``.
Weights keep the Paddle layout: ``[O, I/g, *k]``, and ``[I, O/g, *k]``
for the transposes, which is also torch's. Padding takes every form the
JAX ``_padding`` takes — an int, n ints, 2n ints (``lo, hi`` per
spatial axis), n pairs, ``'SAME'`` (XLA's: the odd pad at the end) or
``'VALID'`` (not for the transposes, which take numbers only, as in
the JAX package) — and what torch cannot take as a symmetric pad (a
pair that differs, ``'SAME'`` at a stride above one) is an explicit
``F.pad``. Mixed dtypes compute in the promoted one (f32 × bf16 → f32),
and a bias is added after the product in the output's dtype, as the
JAX function does.

Channel-last layouts (``NLC``, ``NHWC``, ``NDHWC``): the caller's
``[N, *spatial, C]`` tensor goes to cuDNN as a ``permute`` view, NCHW
in shape with channels-last strides, and the output comes back
permuted as a view, so the NHWC path makes no NCHW copy of an
activation. A 2-d weight that is not channels-last in memory is made so
(the conv layers built for NHWC keep their weights channels-last, so on
their path this copies nothing).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.autograd import apply_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CHANNEL_LAST = ("NHWC", "NWC", "NLC", "NDHWC")


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _padding(padding, n):
    """Paddle padding: int, list of n ints, list of 2n ints, list of n
    pairs, or 'SAME'/'VALID' (returned upper-cased)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding]


def same_pads(sizes, kernel, strides, dilation):
    """XLA's ``'SAME'`` padding: the output is ``ceil(size / stride)``,
    the total pad split with the odd element at the end."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, strides, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_spatial(a, pads, value=0.0):
    """``a`` (channel-first) padded by ``pads`` [(lo, hi)] on its
    spatial axes; negative entries crop."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return tF.pad(a, flat, value=value)


def _channel_first(a, nd):
    """A channel-last ``[N, *sp, C]`` tensor as a ``[N, C, *sp]`` view."""
    return a.permute(0, nd + 1, *range(1, nd + 1))


def _channel_last(a, nd):
    return a.permute(0, *range(2, nd + 2), 1)


def _weight_memory(w, nd):
    if nd == 2 and not w.is_contiguous(memory_format=torch.channels_last):
        return w.contiguous(memory_format=torch.channels_last)
    return w


def _promote(a, w):
    if a.dtype != w.dtype:
        common = torch.promote_types(a.dtype, w.dtype)
        return a.to(common), w.to(common)
    return a, w


def _add_bias(out, b, channel_last):
    shape = [1] * out.dim()
    shape[-1 if channel_last else 1] = b.shape[0]
    return out + b.reshape(shape)


_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


def _conv_fn(a, w, b=None, *, strides, pad, dil, groups, nd, channel_last):
    a, w = _promote(a, w)
    if channel_last:
        a = _channel_first(a, nd)
        w = _weight_memory(w, nd)
    if pad == "VALID":
        pad = [(0, 0)] * nd
    elif pad == "SAME":
        pad = same_pads(a.shape[2:], w.shape[2:], strides, dil)
    if all(lo == hi and lo >= 0 for lo, hi in pad):
        torch_pad = tuple(lo for lo, _ in pad)
    else:
        a = _pad_spatial(a, pad)
        torch_pad = 0
    out = _CONV[nd](a, w, None, strides, torch_pad, dil, groups)
    if channel_last:
        out = _channel_last(out, nd)
    return out if b is None else _add_bias(out, b, channel_last)


def _conv(x, weight, bias, stride, padding, dilation, groups, nd,
          data_format, op_name):
    return apply_op(_conv_fn, x, weight, bias, strides=_tuple(stride, nd),
                    pad=_padding(padding, nd), dil=_tuple(dilation, nd),
                    groups=groups, nd=nd,
                    channel_last=data_format in _CHANNEL_LAST,
                    op_name=op_name)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format, "conv3d")


def _conv_t_fn(a, w, b=None, *, strides, pad, opad, dil, groups, nd,
               channel_last):
    """The JAX function's gradient-of-conv formulation: a convolution of
    the stride-dilated input padded by ``(d·(k−1) − lo, d·(k−1) − hi +
    opad)``. torch's transposed convolution without padding is that with
    the full pad ``d·(k−1)`` on both sides, so the JAX output is the
    full one cropped by ``(lo, hi − opad)`` (zero-extended where that is
    negative). torch's ``padding=p, output_padding=q`` crops ``(p, p −
    q)``, so a crop of that form goes straight through; any other is
    cropped after."""
    a, w = _promote(a, w)
    if channel_last:
        a = _channel_first(a, nd)
        w = _weight_memory(w, nd)
    if isinstance(pad, str):
        raise ValueError("string padding is not supported by the transposed "
                         "convolutions (as in the JAX package): give the "
                         "pads")
    crop = [(lo, hi - o) for (lo, hi), o in zip(pad, opad)]
    q = [lo - hi for lo, hi in crop]
    if all(lo >= 0 and 0 <= qq < max(s, d)
           for (lo, _), qq, s, d in zip(crop, q, strides, dil)):
        out = _CONV_T[nd](a, w, None, strides, tuple(lo for lo, _ in crop),
                          tuple(q), groups, dil)
    else:
        out = _CONV_T[nd](a, w, None, strides, 0, 0, groups, dil)
        out = _pad_spatial(out, [(-lo, -hi) for lo, hi in crop])
    if channel_last:
        out = _channel_last(out, nd)
    return out if b is None else _add_bias(out, b, channel_last)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, nd, data_format, op_name):
    opad = _tuple(output_padding, nd) if output_padding is not None \
        else (0,) * nd
    return apply_op(_conv_t_fn, x, weight, bias, strides=_tuple(stride, nd),
                    pad=_padding(padding, nd), opad=opad,
                    dil=_tuple(dilation, nd), groups=groups, nd=nd,
                    channel_last=data_format in _CHANNEL_LAST,
                    op_name=op_name)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format,
                           "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format,
                           "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format,
                           "conv3d_transpose")
