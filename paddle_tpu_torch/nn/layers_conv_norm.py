"""Convolution, normalization and pooling layers of the port
(``paddle_tpu/nn/layers_conv_norm.py``), as Layers
(:class:`~.layer.Layer`) with the JAX parameter and buffer names, so
state dicts correspond:

- ``Conv1D/2D/3D`` and their transposes: ``weight`` ``[O, I/g, *k]``
  (``[I, O/g, *k]`` transposed), KaimingUniform over ``fan_in =
  I/g · Πk``, ``bias`` Uniform(±1/√fan_in). A ``Conv2D`` built for NHWC
  keeps its weight channels-last in memory (the shape is unchanged), so
  cuDNN takes it as it is;
- ``BatchNorm``, ``BatchNorm1D/2D/3D``: ``weight`` ones, ``bias``
  zeros, the buffers ``_mean`` (zeros) and ``_variance`` (ones) in f32,
  updated in place by :func:`~paddle_tpu_torch.nn.functional.batch_norm`
  in training; ``bfloat16()`` casts them with the parameters, as the
  JAX ``Layer.to`` does. ``SyncBatchNorm`` is ``BatchNorm`` on one
  device;
- ``LayerNorm``, ``RMSNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
  ``SpectralNorm``, ``LocalResponseNorm``;
- the max, average and adaptive pooling layers.

``device`` and ``dtype`` place ``LayerNorm``'s and ``RMSNorm``'s
parameters when a torch parent builds the layer.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.autograd import apply_op
from . import functional as F
from . import initializer as I
from .layer import Layer
from .layers_common import _place

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm", "LayerNorm",
           "RMSNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "SpectralNorm", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "LocalResponseNorm"]


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, nd, transpose=False,
                 output_padding=0, weight_attr=None, bias_attr=None,
                 data_format="NCHW"):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, nd)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.nd = nd
        self.output_padding = output_padding
        self.data_format = data_format
        self._transpose = transpose
        if transpose:
            w_shape = [in_channels, out_channels // groups,
                       *self.kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups,
                       *self.kernel_size]
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        if nd == 2 and data_format == "NHWC":
            w = self._parameters["weight"]
            w.data = w.data.contiguous(memory_format=torch.channels_last)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class _Conv(_ConvNd):
    _nd, _fn, _layout = 2, "conv2d", "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, self._nd,
                         weight_attr=weight_attr, bias_attr=bias_attr,
                         data_format=data_format or self._layout)

    def forward(self, x):
        return getattr(F, self._fn)(x, self.weight, self.bias, self.stride,
                                    self.padding, self.dilation, self.groups,
                                    self.data_format)


class Conv1D(_Conv):
    _nd, _fn, _layout = 1, "conv1d", "NCL"


class Conv2D(_Conv):
    _nd, _fn, _layout = 2, "conv2d", "NCHW"


class Conv3D(_Conv):
    _nd, _fn, _layout = 3, "conv3d", "NCDHW"


class _ConvTranspose(_ConvNd):
    _nd, _fn, _layout = 2, "conv2d_transpose", "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, self._nd, transpose=True,
                         output_padding=output_padding,
                         weight_attr=weight_attr, bias_attr=bias_attr,
                         data_format=data_format or self._layout)

    def forward(self, x, output_size=None):
        return getattr(F, self._fn)(x, self.weight, self.bias, self.stride,
                                    self.padding, self.output_padding,
                                    self.groups, self.dilation, output_size,
                                    self.data_format)


class Conv1DTranspose(_ConvTranspose):
    _nd, _fn, _layout = 1, "conv1d_transpose", "NCL"


class Conv2DTranspose(_ConvTranspose):
    _nd, _fn, _layout = 2, "conv2d_transpose", "NCHW"


class Conv3DTranspose(_ConvTranspose):
    _nd, _fn, _layout = 3, "conv3d_transpose", "NCDHW"


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        dev = self._param_device()
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCDHW"
                         else data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm; on one device it is ``BatchNorm``."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with each batch norm under it (itself included)
        replaced by a ``SyncBatchNorm`` holding the same parameters and
        buffers."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon,
                                data_format=layer.data_format)
            out.weight, out.bias = layer.weight, layer.bias
            for name in ("_mean", "_variance"):
                out.register_buffer(name, layer._buffers[name])
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


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


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


def _spectral(w, u, v, *, dim, iters, eps):
    wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    for _ in range(iters):
        v = wm.t() @ u
        v = v / (torch.linalg.norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.norm(u) + eps)
    return w / (u @ wm @ v)


class SpectralNorm(Layer):
    """``weight / σ``, σ from ``power_iters`` power iterations started at
    the ``weight_u`` / ``weight_v`` parameters (which stay as they
    are, as in the JAX layer)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0, 1))
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0, 1))

    def forward(self, weight):
        return apply_op(_spectral, weight, self.weight_u, self.weight_v,
                        dim=self.dim, iters=self.power_iters, eps=self.eps,
                        op_name="spectral_norm")


class _PoolNd(Layer):
    def __init__(self, fn, kernel_size, stride, padding, **kw):
        super().__init__()
        self._fn = fn
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self._kw = kw

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        **self._kw)


class MaxPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(F.max_pool1d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode)


class MaxPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(F.max_pool2d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, data_format=data_format)


class MaxPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(F.max_pool3d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool1D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(F.avg_pool1d, kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=data_format)


class AvgPool3D(_PoolNd):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(F.avg_pool3d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=data_format)


class _AdaptivePool(Layer):
    _fn = "adaptive_max_pool2d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return getattr(F, self._fn)(x, self.output_size)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = "adaptive_avg_pool1d"

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(_AdaptivePool):
    """The layout is accepted and unused, as in the JAX layer."""
    _fn = "adaptive_avg_pool3d"

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size)


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = "adaptive_max_pool1d"


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = "adaptive_max_pool2d"


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = "adaptive_max_pool3d"


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)
