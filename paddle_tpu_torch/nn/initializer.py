"""Weight initializers of the port (``paddle_tpu.nn.initializer``).

The same distributions as the JAX package's, drawn in f32 from the
port's key stream on the target device (``core.random``: one key a
parameter, device ops, no host draw) and cast to the parameter
dtype. An initializer is called as
``init(shape, dtype, device=None)``; ``device`` defaults to the current
device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import random as random_mod
from ..core.device import current_device
from ..core.dtype import convert_dtype

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "calculate_gain"]


def _dev(device):
    return current_device() if device is None else torch.device(device)


class Initializer:
    def __call__(self, shape, dtype, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        dev = current_device() if device is None else device
        return torch.full(tuple(shape), self.value,
                          dtype=convert_dtype(dtype), device=dev)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device=None):
        return random_mod.normal(tuple(shape), self.mean, self.std,
                                 device=_dev(device)).to(
            convert_dtype(dtype))


class TruncatedNormal(Initializer):
    """Normal draws cut to ``[a, b]`` standard deviations, by inverse
    CDF sampling of a uniform over the kept mass."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype, device=None):
        lo, hi = (0.5 * (1 + math.erf(v / math.sqrt(2)))
                  for v in (self.a, self.b))
        u = random_mod.uniform(tuple(shape), lo, hi, device=_dev(device))
        t = torch.special.ndtri(u).clamp_(self.a, self.b)
        return (t * self.std + self.mean).to(convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device=None):
        return random_mod.uniform(tuple(shape), self.low, self.high,
                                  device=_dev(device)).to(
            convert_dtype(dtype))


def _fan_in_out(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # paddle Linear weight is [in, out]
        return shape[0], shape[1]
    # conv weight [out_c, in_c, *k]
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device=None):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device=None):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, device=None):
        from ..core.tensor import as_torch
        dev = current_device() if device is None else device
        return as_torch(self.value, device=dev,
                        dtype=convert_dtype(dtype)).reshape(tuple(shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device=None):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        n = max(rows, cols)
        a = Normal()((n, n), torch.float32, device)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(
            convert_dtype(dtype))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a * a))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    return 1.0
