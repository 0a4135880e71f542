"""Normalization layers of the port: ``LayerNorm`` and ``RMSNorm``
(``paddle_tpu/nn/layers_conv_norm.py``), as Layers (:class:`~.layer.Layer`)
with the JAX parameter names (``weight`` ones, ``bias`` zeros) over
:func:`~paddle_tpu_torch.nn.functional.layer_norm` (f32 statistics,
cast back) and :func:`~paddle_tpu_torch.nn.functional.rms_norm`.
``device`` and ``dtype`` place the parameters when a torch parent
builds the layer.
"""
from __future__ import annotations

from . import functional as F
from . import initializer as I
from .layer import Layer
from .layers_common import _place

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon: float = 1e-05,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        _place(self, device, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self.normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon: float = 1e-6,
                 weight_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        _place(self, device, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            list(normalized_shape), attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
