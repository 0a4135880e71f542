"""Normalization layers of the port: ``LayerNorm``.

The port of ``paddle_tpu/nn/layers_conv_norm.py`` ``LayerNorm``, as a
``torch.nn.Module`` with the JAX parameter names (``weight`` ones,
``bias`` zeros) over :func:`~paddle_tpu_torch.nn.functional.layer_norm`
(f32 statistics, cast back).
"""
from __future__ import annotations

import torch
from torch import nn

from .functional import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon: float = 1e-05,
                 device=None, dtype=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape, **kw))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape, **kw))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self.normalized_shape}"
