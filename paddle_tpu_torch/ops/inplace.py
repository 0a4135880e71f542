"""In-place op variants (``op_``) of the port (``paddle_tpu.ops.inplace``).

``x.op_(...)`` computes ``op(x, ...)`` and puts the result in ``x``: a
leaf (a parameter, a buffer, a tensor made by ``to_tensor``) is
written in place under ``no_grad`` when the result keeps its shape and
dtype and records no gradient; otherwise the Tensor is rebound to the
result (a non-leaf keeps its gradient history through it). The
top-level ``paddle.op_(x, ...)`` forms call the method. The random
fills (``normal_``, ``uniform_``, ...) draw from the port's generator.
"""
from __future__ import annotations

import contextlib
import math
from typing import List

import torch

from ..core import random as random_mod
from ..core import tensor as tensor_mod
from ..core.tensor import Tensor

__all__: List[str] = []  # populated by _install()

_INPLACE_UNARY = [
    "abs", "acos", "asin", "atan", "atanh", "ceil", "cos", "cosh", "erf",
    "exp", "expm1", "floor", "lgamma", "log", "log10", "log1p", "log2",
    "neg", "reciprocal", "round", "rsqrt", "sigmoid", "sin", "sinh",
    "sqrt", "square", "tan", "tanh", "trunc", "digamma", "frac", "i0",
    "sinc", "logit",
]
_INPLACE_BINARY = [
    "add", "subtract", "multiply", "divide", "remainder", "mod",
    "floor_divide", "floor_mod", "pow", "maximum", "minimum",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "hypot", "copysign", "ldexp", "gcd", "lcm",
    "bitwise_left_shift", "bitwise_right_shift",
]
_INPLACE_OTHER = [
    "clip", "scale", "cumsum", "cumprod", "flatten", "squeeze",
    "unsqueeze", "transpose", "tril", "triu", "cast", "lerp",
    "index_add", "index_put", "index_fill", "masked_fill",
    "masked_scatter", "scatter", "nan_to_num", "renorm", "polygamma",
    "gammainc", "gammaincc", "gammaln", "multigammaln", "t",
]


# in-place forms the JAX package has as Tensor methods only
_METHOD_ONLY = {"add", "subtract", "scale"}


def _functional(name):
    from .. import ops as _ops
    return getattr(_ops, name, None)


def _put(x: Tensor, out: torch.Tensor) -> Tensor:
    if tensor_mod._mutation_hook is not None:
        tensor_mod._mutation_hook(x)
    t = x._t
    if t.is_leaf and not out.requires_grad and out.shape == t.shape \
            and out.dtype == t.dtype:
        with torch.no_grad():
            t.copy_(out)
    else:
        x._t = out
    return x


def _make_inplace(fname):
    fn = _functional(fname)
    if fn is None:
        return None

    def inplace(self, *args, **kwargs):
        t = self._t
        guard = torch.no_grad() if t.is_leaf and t.requires_grad \
            else contextlib.nullcontext()
        with guard:
            out = fn(self, *args, **kwargs)
        return _put(self, out._t if isinstance(out, Tensor) else out)

    inplace.__name__ = fname + "_"
    inplace.__doc__ = f"In-place variant of paddle.{fname}."
    return inplace


def _random_fill(name, draw):
    def fill(self, *args, **kwargs):
        t = self._t
        g = random_mod.generator_for(t.device)
        with torch.no_grad():
            val = draw(torch.empty(t.shape, dtype=torch.float32,
                                   device=t.device), g, *args, **kwargs)
        return _put(self, val.to(t.dtype))
    fill.__name__ = name
    return fill


def _geometric(z, g, probs):
    # the continuous form: log(u) / log1p(-probs)
    return torch.log(z.uniform_(1e-7, 1.0, generator=g)) / math.log1p(-probs)


# draw(z, generator, *args): z is an f32 scratch tensor of the shape
_RANDOM_FILLS = {
    "normal_": lambda z, g, mean=0.0, std=1.0: z.normal_(mean, std,
                                                         generator=g),
    "bernoulli_": lambda z, g, p=0.5: z.bernoulli_(p, generator=g),
    "cauchy_": lambda z, g, loc=0, scale=1: z.cauchy_(loc, scale,
                                                      generator=g),
    "geometric_": _geometric,
    "log_normal_": lambda z, g, mean=1.0, std=2.0: torch.exp(
        z.normal_(mean, std, generator=g)),
    "uniform_": lambda z, g, min=-1.0, max=1.0, seed=0: z.uniform_(
        min, max, generator=g),
    "exponential_": lambda z, g, lam=1.0: z.exponential_(
        1.0, generator=g) / lam,
}


def _install():
    installed = []
    module = globals()
    for fname in _INPLACE_UNARY + _INPLACE_BINARY + _INPLACE_OTHER:
        method = _make_inplace(fname)
        if method is None:
            continue
        setattr(Tensor, fname + "_", method)
        if fname in _METHOD_ONLY:
            continue

        def _toplevel(x, *args, _m=fname + "_", **kwargs):
            return getattr(x, _m)(*args, **kwargs)
        _toplevel.__name__ = fname + "_"
        module[fname + "_"] = _toplevel
        installed.append(fname + "_")
    for name, draw in _RANDOM_FILLS.items():
        setattr(Tensor, name, _random_fill(name, draw))
    __all__.extend(installed)


_install()
