"""Common layers of the port: ``Linear``, ``Embedding``, ``Dropout`` and
``Flatten``
(``paddle_tpu/nn/layers_common.py``), as Layers (:class:`~.layer.Layer`).

``Linear`` keeps paddle's ``[in, out]`` weight (XavierNormal, zero
bias), so a JAX ``state_dict`` loads without transposes; ``Embedding``
draws N(0, 1) and zeroes its ``padding_idx`` row. ``device`` and
``dtype`` place the parameters when a torch parent builds the layer
(else the current device and the default dtype). ``Dropout`` drops in
training mode and passes through in eval mode.
"""
from __future__ import annotations

import torch

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Flatten"]


def _place(layer: Layer, device, dtype) -> None:
    from ..core.device import resolve_device
    from ..core.dtype import convert_dtype
    if device is not None:
        layer._device = resolve_device(device)
    if dtype is not None:
        layer._dtype = convert_dtype(dtype)


class Linear(Layer):
    """``y = x W + b``, weight ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        _place(self, device, dtype)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        _place(self, device, dtype)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self._parameters["weight"][padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class Flatten(Layer):
    """Axes ``start_axis`` .. ``stop_axis`` merged into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)
