"""Activation functionals of the port.

The port of ``paddle_tpu/nn/functional/activation.py``: every row, each
through ``core.autograd.apply_op`` under the JAX package's op name, so
that ``amp.auto_cast``'s lists reach it (``softmax`` and
``log_softmax`` are on the black list). Each takes Tensors or torch
tensors and returns the same kind. ``gelu`` is the erf form by default
(JAX ``approximate=False``) and the tanh form with
``approximate=True``.

``gumbel_softmax`` and ``rrelu`` (in training) draw their noise on the
tensor's device from a key of the port's key stream
(``core.random.gumbel`` / ``uniform``), not from a JAX key: their
values differ from the JAX package's, their laws do not, and a CUDA
graph that holds them draws afresh on every replay. The in-place forms
(``relu_`` ...) write the result into the Tensor they are given, as
``ops.inplace`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core import random as _random
from ...core.autograd import apply_op

__all__ = ["relu", "relu6", "leaky_relu", "prelu", "elu", "selu", "celu",
           "gelu", "silu", "swish", "mish", "hardswish", "hardsigmoid",
           "hardtanh", "hardshrink", "softshrink", "tanhshrink",
           "thresholded_relu", "softplus", "softsign", "sigmoid",
           "log_sigmoid", "tanh", "softmax", "log_softmax",
           "gumbel_softmax", "maxout", "glu", "rrelu", "relu_", "tanh_",
           "elu_", "hardtanh_", "leaky_relu_", "softmax_",
           "thresholded_relu_"]


def relu(x, name=None):
    return apply_op(torch.relu, x, op_name="relu")


def relu6(x, name=None):
    return apply_op(lambda a: torch.clamp(a, 0.0, 6.0), x, op_name="relu6")


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op(lambda a: torch.where(a >= 0, a, negative_slope * a),
                    x, op_name="leaky_relu")


def prelu(x, weight, data_format="NCHW", name=None):
    def f(a, w):
        if w.numel() == 1:
            return torch.where(a >= 0, a, w.reshape(()) * a)
        shape = [1] * a.dim()
        ch_axis = 1 if data_format == "NCHW" else a.dim() - 1
        shape[ch_axis] = w.numel()
        return torch.where(a >= 0, a, w.reshape(shape) * a)
    return apply_op(f, x, weight, op_name="prelu")


def elu(x, alpha=1.0, name=None):
    return apply_op(lambda a: torch.where(a > 0, a, alpha * torch.expm1(a)),
                    x, op_name="elu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op(
        lambda a: scale * torch.where(a > 0, a, alpha * torch.expm1(a)), x,
        op_name="selu")


def celu(x, alpha=1.0, name=None):
    return apply_op(
        lambda a: torch.where(a > 0, a, alpha * torch.expm1(a / alpha)), x,
        op_name="celu")


def gelu(x, approximate: bool = False, name=None):
    return apply_op(TF.gelu, x, approximate="tanh" if approximate else "none",
                    op_name="gelu")


def silu(x, name=None):
    return apply_op(TF.silu, x, op_name="silu")


swish = silu


def mish(x, name=None):
    return apply_op(lambda a: a * torch.tanh(TF.softplus(a)), x,
                    op_name="mish")


def hardswish(x, name=None):
    return apply_op(lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0, x,
                    op_name="hardswish")


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_op(lambda a: torch.clamp(slope * a + offset, 0.0, 1.0), x,
                    op_name="hardsigmoid")


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_op(lambda a: torch.clamp(a, min, max), x,
                    op_name="hardtanh")


def hardshrink(x, threshold=0.5, name=None):
    return apply_op(lambda a: torch.where(a.abs() > threshold, a, 0.0)
                    .to(a.dtype), x, op_name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    return apply_op(
        lambda a: torch.where(a > threshold, a - threshold,
                              torch.where(a < -threshold, a + threshold,
                                          0.0)).to(a.dtype),
        x, op_name="softshrink")


def tanhshrink(x, name=None):
    return apply_op(lambda a: a - torch.tanh(a), x, op_name="tanhshrink")


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_op(lambda a: torch.where(a > threshold, a, value)
                    .to(a.dtype), x, op_name="thresholded_relu")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    # the JAX form: x where beta * x passes the threshold, else
    # log(1 + exp(beta * x)) / beta
    return apply_op(
        lambda a: torch.where(beta * a > threshold, a,
                              TF.softplus(beta * a) / beta), x,
        op_name="softplus")


def softsign(x, name=None):
    return apply_op(lambda a: a / (1 + a.abs()), x, op_name="softsign")


def sigmoid(x, name=None):
    return apply_op(torch.sigmoid, x, op_name="sigmoid")


def log_sigmoid(x, name=None):
    return apply_op(TF.logsigmoid, x, op_name="log_sigmoid")


def tanh(x, name=None):
    return apply_op(torch.tanh, x, op_name="tanh")


def _softmax_fn(log: bool, axis, dtype):
    from ...core.dtype import convert_dtype
    d = convert_dtype(dtype)

    def f(a):
        if d is not None:
            a = a.to(d)
        return torch.log_softmax(a, axis) if log else torch.softmax(a, axis)
    return f


def softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(_softmax_fn(False, axis, dtype), x, op_name="softmax")


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(_softmax_fn(True, axis, dtype), x,
                    op_name="log_softmax")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    def f(a):
        noise = _random.gumbel(a.shape, device=a.device)
        y = torch.softmax((a + noise.to(a.dtype)) / temperature, axis)
        if hard:
            idx = y.argmax(axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            # straight through: the hard value forward, the soft gradient
            y = y_hard - y.detach() + y
        return y
    return apply_op(f, x, op_name="gumbel_softmax")


def maxout(x, groups, axis=1, name=None):
    def f(a):
        shape = list(a.shape)
        ax = axis % a.dim()
        shape[ax:ax + 1] = [shape[ax] // groups, groups]
        return a.reshape(shape).amax(ax + 1)
    return apply_op(f, x, op_name="maxout")


def glu(x, axis=-1, name=None):
    return apply_op(lambda a: TF.glu(a, axis), x, op_name="glu")


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)

    def f(a):
        slope = _random.uniform(a.shape, lower, upper,
                                device=a.device).to(a.dtype)
        return torch.where(a >= 0, a, slope * a)
    return apply_op(f, x, op_name="rrelu")


def _inplace(fn):
    import functools

    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        from ...core import tensor as tensor_mod
        from ...core.tensor import Tensor
        if isinstance(x, Tensor) and tensor_mod._mutation_hook is not None:
            tensor_mod._mutation_hook(x)
        out = fn(x, *args, **kwargs)
        if isinstance(x, Tensor):
            x._t = out._t
            x._sg = out._sg
            return x
        with torch.no_grad():
            x.copy_(out)
        return x
    wrapper.__name__ = fn.__name__ + "_"
    wrapper.__qualname__ = fn.__qualname__ + "_"
    return wrapper


relu_ = _inplace(relu)
tanh_ = _inplace(tanh)
elu_ = _inplace(elu)
hardtanh_ = _inplace(hardtanh)
leaky_relu_ = _inplace(leaky_relu)
softmax_ = _inplace(softmax)
thresholded_relu_ = _inplace(thresholded_relu)
