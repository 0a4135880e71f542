"""Normalization functionals of the port: ``layer_norm`` and
``rms_norm``.

The port of ``paddle_tpu/nn/functional/norm.py`` ``layer_norm``: mean
and (biased) variance over the trailing ``normalized_shape`` axes in
f32, ``(x - mean) * rsqrt(var + eps) * weight + bias`` in f32, cast
back to the input dtype. ``torch.nn.functional.layer_norm`` computes
exactly that when input and parameters share a dtype (it accumulates
bf16 inputs in f32 and rounds the output once); with mixed dtypes
everything is taken to f32 first. ``rms_norm`` (the Llama-family
norm): ``x * rsqrt(mean(x²) + eps) * weight`` over the last axis in
f32, cast back. Both take Tensors or torch tensors
(``core.autograd.apply_op``) and return the same kind.
"""
from __future__ import annotations

import torch

from ...core.autograd import apply_op

__all__ = ["layer_norm", "rms_norm"]


def _layer_norm(x, weight, bias, shape, epsilon):
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        return torch.nn.functional.layer_norm(x, shape, weight, bias,
                                              epsilon)
    f32 = [t.float() if t is not None else None for t in (weight, bias)]
    return torch.nn.functional.layer_norm(x.float(), shape, *f32,
                                          epsilon).to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-05, name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return apply_op(_layer_norm, x, weight, bias,
                    shape=list(normalized_shape), epsilon=epsilon,
                    op_name="layer_norm")


def _rms_norm(x, weight, epsilon):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon: float = 1e-6, name=None):
    return apply_op(_rms_norm, x, weight, epsilon=epsilon,
                    op_name="rms_norm")
