"""Normalization functionals of the port: ``layer_norm``.

The port of ``paddle_tpu/nn/functional/norm.py`` ``layer_norm``: mean
and (biased) variance over the trailing ``normalized_shape`` axes in
f32, ``(x - mean) * rsqrt(var + eps) * weight + bias`` in f32, cast
back to the input dtype. ``torch.nn.functional.layer_norm`` computes
exactly that when input and parameters share a dtype (it accumulates
bf16 inputs in f32 and rounds the output once); with mixed dtypes
everything is taken to f32 first.
"""
from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-05, name=None) -> torch.Tensor:
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = list(normalized_shape)
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        return torch.nn.functional.layer_norm(x, shape, weight, bias,
                                              epsilon)
    f32 = [t.float() if t is not None else None for t in (weight, bias)]
    return torch.nn.functional.layer_norm(x.float(), shape, *f32,
                                          epsilon).to(x.dtype)
