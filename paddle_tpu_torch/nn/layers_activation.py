"""Activation layers of the port (``paddle_tpu/nn/layers_activation.py``):
each a :class:`~.layer.Layer` over its functional in
:mod:`~paddle_tpu_torch.nn.functional.activation` — Tensors in, a Tensor
out; torch tensors in, a torch tensor out."""
from __future__ import annotations

from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "PReLU", "GELU", "Sigmoid", "Tanh",
           "Softmax", "LogSoftmax", "ELU", "SELU", "CELU", "Silu", "Swish",
           "Mish", "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink",
           "Softshrink", "Tanhshrink", "ThresholdedReLU", "Softplus",
           "Softsign", "LogSigmoid", "Maxout", "GLU", "RReLU"]


def _make(fn_name, cls_name):
    class _Act(Layer):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            self._args = args
            self._kwargs = kwargs

        def forward(self, x):
            return getattr(F, fn_name)(x, *self._args, **self._kwargs)
    _Act.__name__ = _Act.__qualname__ = cls_name
    return _Act


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


ELU = _make("elu", "ELU")
SELU = _make("selu", "SELU")
CELU = _make("celu", "CELU")
Silu = _make("silu", "Silu")
Swish = _make("swish", "Swish")
Mish = _make("mish", "Mish")
Hardswish = _make("hardswish", "Hardswish")
Hardsigmoid = _make("hardsigmoid", "Hardsigmoid")
Hardtanh = _make("hardtanh", "Hardtanh")
Hardshrink = _make("hardshrink", "Hardshrink")
Softshrink = _make("softshrink", "Softshrink")
Tanhshrink = _make("tanhshrink", "Tanhshrink")
ThresholdedReLU = _make("thresholded_relu", "ThresholdedReLU")
Softplus = _make("softplus", "Softplus")
Softsign = _make("softsign", "Softsign")
LogSigmoid = _make("log_sigmoid", "LogSigmoid")
Maxout = _make("maxout", "Maxout")
GLU = _make("glu", "GLU")
RReLU = _make("rrelu", "RReLU")
