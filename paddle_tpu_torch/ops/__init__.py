"""Operators of the port: the paddle op surface and Tensor patching.

The counterpart of ``paddle_tpu.ops``: the creation, math,
manipulation, linear-algebra and long-tail (``extra_math``) ops
(Tensors in and out, through ``core.autograd.apply_op``), attached to
:class:`~..core.tensor.Tensor` as methods and operators as the JAX
package attaches them, the
in-place ``op_`` variants, and the op table (``op_registry``). The
hand-written Hopper kernels and their wrappers live in ``ops.kernels``;
the chunked fused cross-entropy in ``ops.fused_ce``.
"""
from __future__ import annotations

from ..core.tensor import Tensor, as_torch

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .extra_math import *  # noqa: F401,F403

from . import creation, extra_math, linalg, manipulation, math as math_ops


def increment(x, value=1.0, name=None):
    x._assign(as_torch(x) + value)
    return x


_METHOD_SOURCES = [math_ops, manipulation, linalg]

_METHODS = [
    # math
    "abs", "sqrt", "rsqrt", "exp", "log", "log2", "log10", "log1p", "sin",
    "cos", "tan", "tanh", "sigmoid", "floor", "ceil", "round", "trunc",
    "sign", "square", "reciprocal", "erf", "neg",
    "add", "subtract", "multiply", "divide", "mod", "remainder", "pow",
    "maximum", "minimum", "floor_divide", "scale", "clip", "lerp",
    "sum", "mean", "prod", "max", "min", "std", "var", "median",
    "logsumexp", "cumsum", "cumprod", "argmax", "argmin", "argsort", "sort",
    "topk", "kthvalue", "unique", "nonzero", "bincount",
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "isnan", "isinf", "isfinite", "allclose", "isclose", "equal_all",
    "all", "any", "nanmean", "nansum", "count_nonzero", "index_sample",
    # manipulation
    "reshape", "reshape_", "transpose", "concat", "split", "chunk", "unbind",
    "squeeze", "unsqueeze", "flatten", "expand", "broadcast_to", "expand_as",
    "tile", "repeat_interleave", "flip", "roll", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add",
    "index_select", "index_add", "index_put", "masked_select", "masked_fill",
    "where", "pad", "numel", "moveaxis", "diff", "tensordot", "unfold",
    "strided_slice", "swapaxes",
    # linalg
    "matmul", "mm", "bmm", "dot", "inner", "outer", "cross", "t", "norm",
    "dist", "cholesky", "inverse", "solve", "qr", "svd", "eigh", "det",
    "matrix_power", "trace", "diagonal", "kron", "mv",
]


def _patch_methods():
    for name in _METHODS:
        for src in _METHOD_SOURCES:
            fn = getattr(src, name, None)
            if fn is not None:
                if not hasattr(Tensor, name):
                    setattr(Tensor, name, fn)
                break


def _binary_op(fn, reverse=False):
    if reverse:
        return lambda self, other: fn(other, self)
    return lambda self, other: fn(self, other)


def _patch_operators():
    m = math_ops
    for dunder, fn in (("add", m.add), ("sub", m.subtract),
                       ("mul", m.multiply), ("truediv", m.divide),
                       ("floordiv", m.floor_divide), ("mod", m.mod),
                       ("pow", m.pow), ("matmul", linalg.matmul)):
        setattr(Tensor, f"__{dunder}__", _binary_op(fn))
        setattr(Tensor, f"__r{dunder}__", _binary_op(fn, reverse=True))
    for dunder, fn in (("eq", m.equal), ("ne", m.not_equal),
                       ("lt", m.less_than), ("le", m.less_equal),
                       ("gt", m.greater_than), ("ge", m.greater_equal),
                       ("and", m.logical_and), ("or", m.logical_or),
                       ("xor", m.logical_xor)):
        setattr(Tensor, f"__{dunder}__", _binary_op(fn))
    Tensor.__neg__ = lambda self: m.neg(self)
    Tensor.__abs__ = lambda self: m.abs(self)
    Tensor.__invert__ = lambda self: m.logical_not(self)


_patch_methods()
_patch_operators()

from . import inplace  # noqa: F401,E402  (installs the op_ methods)
from .inplace import *  # noqa: F401,F403,E402
from . import op_registry  # noqa: F401,E402
from .op_registry import get_op_info, list_ops, num_ops  # noqa: F401,E402
