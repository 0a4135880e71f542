"""Math ops of the port: elementwise, reductions, comparison, logic,
search and sort (``paddle_tpu.ops.math``).

Each op runs the torch function through ``apply_op`` (Tensors in and
out, torch's autograd records it). The semantics are the JAX
package's where torch's differ: ``mod`` takes the divisor's sign,
``floor_divide`` floors, ``median`` averages the two middle values,
``argsort``/``sort`` with ``descending`` reverse a stable ascending
order, ``topk`` and ``kthvalue`` break ties by the lower index, and
``mean`` of integers is a float. Unlike the JAX package (x64 off),
integer sums and index outputs are int64.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.autograd import apply_op
from ..core.device import current_device
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.tensor import Tensor, as_torch

_UNARY = {
    "abs": torch.abs, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "trunc": torch.trunc, "frac": torch.frac, "sign": torch.sign,
    "neg": torch.neg, "reciprocal": torch.reciprocal,
    "square": torch.square, "sigmoid": torch.sigmoid, "erf": torch.erf,
    "erfinv": torch.erfinv, "lgamma": torch.lgamma,
    "digamma": torch.digamma, "angle": torch.angle,
    "conj": torch.conj_physical,
    "real": lambda a: a.real if a.is_complex() else a.clone(),
    "imag": lambda a: a.imag if a.is_complex() else torch.zeros_like(a),
    "logical_not": torch.logical_not, "bitwise_not": torch.bitwise_not,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
}


def _float_in(fn):
    """``fn`` on floats: integer inputs are promoted to the default
    float dtype first (the JAX functions promote them)."""
    def f(*xs):
        return fn(*(x if x.is_floating_point() or x.is_complex()
                    else x.to(get_default_dtype()) for x in xs))
    return f


_BINARY = {
    "add": torch.add, "subtract": torch.subtract,
    "multiply": torch.multiply, "divide": torch.true_divide,
    "mod": torch.remainder, "pow": torch.pow, "maximum": torch.maximum,
    "minimum": torch.minimum, "fmax": torch.fmax, "fmin": torch.fmin,
    "atan2": _float_in(torch.atan2), "hypot": _float_in(torch.hypot),
    "logaddexp": _float_in(torch.logaddexp),
    # no gradient (the JAX function's is zero)
    "floor_divide": lambda a, b: torch.floor_divide(
        a.detach(), b.detach() if isinstance(b, torch.Tensor) else b),
    "equal": torch.eq, "not_equal": torch.ne, "greater_than": torch.gt,
    "greater_equal": torch.ge, "less_than": torch.lt, "less_equal": torch.le,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or, "bitwise_xor": torch.bitwise_xor,
}
_FLOAT_UNARY = {"sqrt", "rsqrt", "exp", "expm1", "log", "log2", "log10",
                "log1p", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
                "cosh", "tanh", "asinh", "acosh", "atanh", "sigmoid", "erf",
                "erfinv", "lgamma", "digamma", "reciprocal"}


def _operand(v, like: torch.Tensor):
    """A non-tensor operand of a binary op: Python scalars pass (torch
    promotes them weakly, as JAX does); numpy values become tensors on
    the other operand's device."""
    if isinstance(v, torch.Tensor) or isinstance(v, (bool, int, float)):
        return v
    return as_torch(v, device=like.device)


def _binary_fn(tfn):
    def f(a, b):
        if not isinstance(a, torch.Tensor):
            if not isinstance(b, torch.Tensor):
                b = as_torch(b, device=current_device())
            a = as_torch(a, device=b.device)
            if a.dim() == 0 and a.dtype == torch.int64 and \
                    b.is_floating_point():
                a = a.to(b.dtype)
        b = _operand(b, a)
        return tfn(a, b)
    return f


def _make_unary(name, tfn):
    op_name = name
    if name in _FLOAT_UNARY:
        tfn = _float_in(tfn)

    def op(x, name=None):
        return apply_op(tfn, x, op_name=op_name)
    op.__name__ = name
    return op


def _make_binary(name, tfn):
    f = _binary_fn(tfn)
    op_name = name

    def op(x, y, name=None):
        return apply_op(f, x, y, op_name=op_name)
    op.__name__ = name
    return op


for _n, _f in _UNARY.items():
    globals()[_n] = _make_unary(_n, _f)
for _n, _f in _BINARY.items():
    globals()[_n] = _make_binary(_n, _f)

remainder = mod          # noqa: F821
floor_mod = mod          # noqa: F821


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    if bias_after_scale:
        return apply_op(lambda a: a * scale + bias, x)
    return apply_op(lambda a: (a + bias) * scale, x)


def clip(x, min=None, max=None, name=None):
    mn = min.item() if isinstance(min, Tensor) else min
    mx = max.item() if isinstance(max, Tensor) else max
    if mn is None and mx is None:
        return apply_op(torch.clone, x)
    return apply_op(lambda a: torch.clamp(a, mn, mx), x)


def lerp(x, y, weight, name=None):
    def f(a, b, w):
        b, w = _operand(b, a), _operand(w, a)
        return a + w * (b - a)
    return apply_op(f, x, y, weight)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op(lambda a: scale_b * torch.tanh(scale_a * a), x)


def multiply_(x, y):
    x._assign(as_torch(multiply(x, y)))  # noqa: F821
    return x


# -- reductions --------------------------------------------------------------
def _norm_axis(axis):
    if isinstance(axis, (Tensor, torch.Tensor)):
        axis = [int(a) for a in as_torch(axis).reshape(-1).tolist()]
    if isinstance(axis, np.ndarray):
        axis = [int(a) for a in axis.reshape(-1)]
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if isinstance(axis, np.integer):
        return int(axis)
    return axis


def _dims(a, axis):
    """``axis`` (None, an int or a tuple) as a tuple of dims."""
    if axis is None:
        return tuple(range(a.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _to_float(a):
    return a if a.is_floating_point() or a.is_complex() else \
        a.to(get_default_dtype())


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    d, ax = convert_dtype(dtype), _norm_axis(axis)
    return apply_op(lambda a: torch.sum(a, dim=_dims(a, ax), keepdim=keepdim,
                                        dtype=d), x, op_name="sum")


def mean(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda a: torch.mean(_to_float(a), dim=_dims(a, ax),
                                         keepdim=keepdim), x, op_name="mean")


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    d, ax = convert_dtype(dtype), _norm_axis(axis)

    def f(a):
        if d is not None:
            a = a.to(d)
        if ax is None and not keepdim:
            return torch.prod(a)
        for dim in sorted((i % builtins.max(a.dim(), 1) for i in
                           _dims(a, ax)), reverse=True):
            a = torch.prod(a, dim=dim, keepdim=keepdim)
        return a
    return apply_op(f, x)


def _chooser(tfn):
    def op(x, axis=None, keepdim=False, name=None):
        ax = _norm_axis(axis)
        return apply_op(lambda a: tfn(a, dim=_dims(a, ax), keepdim=keepdim),
                        x)
    return op


max = _chooser(torch.amax)
min = _chooser(torch.amin)
amax = _chooser(torch.amax)
amin = _chooser(torch.amin)
max.__name__, min.__name__, amax.__name__, amin.__name__ = (
    "max", "min", "amax", "amin")


def squared_l2_norm(x, name=None):
    return apply_op(lambda a: torch.sum(a * a), x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda a: torch.std(_to_float(a), dim=_dims(a, ax),
                                        correction=1 if unbiased else 0,
                                        keepdim=keepdim), x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda a: torch.var(_to_float(a), dim=_dims(a, ax),
                                        correction=1 if unbiased else 0,
                                        keepdim=keepdim), x)


def _moved_last(a, ax):
    """``a`` with the dims ``ax`` moved to the end and flattened."""
    dims = [i % builtins.max(a.dim(), 1) for i in _dims(a, ax)]
    rest = [i for i in range(a.dim()) if i not in dims]
    moved = a.permute(*rest, *dims)
    return moved.reshape(*moved.shape[:len(rest)], -1), dims


def median(x, axis=None, keepdim=False, name=None):
    """The middle value, or the mean of the two middle values of an
    even count (numpy's rule)."""
    ax = _norm_axis(axis)

    def f(a):
        a = _to_float(a)
        flat, dims = _moved_last(a, ax)
        s = torch.sort(flat, dim=-1).values
        n = s.shape[-1]
        m = s[..., n // 2] if n % 2 else (s[..., n // 2 - 1]
                                          + s[..., n // 2]) / 2
        if keepdim:
            shape = [1 if i in dims else a.shape[i] for i in range(a.dim())]
            m = m.reshape(shape)
        return m
    return apply_op(f, x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda a: torch.logsumexp(_to_float(a), dim=_dims(a, ax),
                                              keepdim=keepdim), x,
                    op_name="logsumexp")


def cumsum(x, axis=None, dtype=None, name=None):
    d = convert_dtype(dtype)

    def f(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=d)
        return torch.cumsum(a, axis, dtype=d)
    return apply_op(f, x, op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    d = convert_dtype(dtype)

    def f(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0, dtype=d)
        return torch.cumprod(a, dim, dtype=d)
    return apply_op(f, x)


def _cum_chooser(tfn):
    def op(x, axis=None, dtype="int64", name=None):
        d = convert_dtype(dtype)

        def f(a):
            if axis is None:
                a, ax = a.reshape(-1), 0
            else:
                ax = axis
            vals, idx = tfn(a, ax)
            return vals, idx.to(d)
        return apply_op(f, x)
    return op


# ties keep the later index, as the JAX scan does
cummax = _cum_chooser(torch.cummax)
cummin = _cum_chooser(torch.cummin)
cummax.__name__, cummin.__name__ = "cummax", "cummin"


def equal_all(x, y, name=None):
    def f(a, b):
        b = _operand(b, a)
        same = isinstance(b, torch.Tensor) and a.shape == b.shape and \
            bool(torch.equal(a, b.to(a.dtype)))
        return torch.tensor(same, device=a.device)
    return apply_op(f, x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.tensor(
        torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan),
        device=a.device), x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.isclose(a, b, rtol=rtol, atol=atol,
                                               equal_nan=equal_nan), x, y)


def all(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda a: torch.all(a.bool(), dim=_dims(a, ax),
                                        keepdim=keepdim), x)


def any(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda a: torch.any(a.bool(), dim=_dims(a, ax),
                                        keepdim=keepdim), x)


# -- search / sort -----------------------------------------------------------
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = convert_dtype(dtype)
    return apply_op(lambda a: torch.argmax(
        a, dim=axis, keepdim=keepdim and axis is not None).to(d), x)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = convert_dtype(dtype)
    return apply_op(lambda a: torch.argmin(
        a, dim=axis, keepdim=keepdim and axis is not None).to(d), x)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    def f(a):
        r = torch.argsort(a, dim=axis, stable=True)
        return r.flip(axis) if descending else r
    return apply_op(f, x)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    def f(a):
        r = torch.sort(a, dim=axis, stable=True).values
        return r.flip(axis) if descending else r
    return apply_op(f, x)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """Ties go to the lower index (a stable sort, as ``lax.top_k``)."""
    if isinstance(k, (Tensor, torch.Tensor)):
        k = int(k.item())

    def f(a):
        idx = torch.sort(a, dim=axis, descending=largest,
                         stable=True).indices.narrow(axis, 0, k)
        return torch.gather(a, axis, idx), idx
    return apply_op(f, x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(a):
        i = torch.sort(a, dim=axis, stable=True).indices.narrow(
            axis, k - 1, 1)
        v = torch.gather(a, axis, i)
        if not keepdim:
            v, i = v.squeeze(axis), i.squeeze(axis)
        return v, i
    return apply_op(f, x)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value (the smallest of a tie) and the index of
    its last occurrence."""
    def f(xd):
        ax = axis % xd.dim()
        moved = xd.movedim(ax, -1)
        batch, n = moved.shape[:-1], moved.shape[-1]
        flat = moved.reshape(-1, n)
        s = torch.sort(flat, dim=-1).values
        s_c = s.detach().contiguous()
        cnt = torch.searchsorted(s_c, s_c, right=True) - \
            torch.searchsorted(s_c, s_c, right=False)
        best = torch.argmax(cnt, dim=-1, keepdim=True)
        sel = torch.gather(s_c, -1, best)
        occ = (flat.detach() == sel).to(torch.int8)
        idx = (n - 1) - torch.argmax(occ.flip(-1), dim=-1, keepdim=True)
        vals = torch.gather(flat, -1, idx)
        vals = vals.reshape(*batch, 1).movedim(-1, ax)
        idx = idx.reshape(*batch, 1).movedim(-1, ax)
        if not keepdim:
            vals, idx = vals.squeeze(ax), idx.squeeze(ax)
        return vals, idx
    return apply_op(f, x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    t = as_torch(x)
    res = np.unique(Tensor(t).numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return Tensor(torch.from_numpy(res).to(t.device))
    return tuple(Tensor(torch.from_numpy(np.asarray(r)).to(t.device))
                 for r in res)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply_op(lambda s, v: torch.searchsorted(
        s.contiguous(), v.contiguous(), right=right, out_int32=out_int32),
        sorted_sequence, values)


def index_sample(x, index):
    return apply_op(lambda a, i: torch.gather(a, 1, i.long()), x, index)


def bincount(x, weights=None, minlength=0, name=None):
    def f(a, w):
        out = torch.bincount(a, w, minlength=minlength)
        return out.to(w.dtype) if w is not None else out
    return apply_op(f, x, weights)


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda a: torch.nanmean(_to_float(a), dim=_dims(a, ax),
                                            keepdim=keepdim), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    d, ax = convert_dtype(dtype), _norm_axis(axis)
    return apply_op(lambda a: torch.nansum(a, dim=_dims(a, ax),
                                           keepdim=keepdim, dtype=d), x)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _norm_axis(axis)
    return apply_op(lambda a: (a != 0).sum(dim=_dims(a, ax),
                                           keepdim=keepdim), x)


def nonzero(x, as_tuple=False):
    def f(a):
        idx = torch.nonzero(a)
        if as_tuple:
            return tuple(idx[:, i:i + 1] for i in range(idx.shape[1]))
        return idx
    return apply_op(f, x if isinstance(x, (Tensor, torch.Tensor))
                    else Tensor(as_torch(x)))


__all__ = sorted(set(_UNARY) | set(_BINARY) | {
    "remainder", "floor_mod", "scale", "clip", "lerp", "stanh", "multiply_",
    "sum", "mean", "prod", "max", "min", "amax", "amin", "squared_l2_norm",
    "std", "var", "median", "logsumexp", "cumsum", "cumprod", "cummax",
    "cummin", "equal_all", "allclose", "isclose", "all", "any", "argmax",
    "argmin", "argsort", "sort", "topk", "kthvalue", "mode", "unique",
    "searchsorted", "index_sample", "bincount", "nanmean", "nansum",
    "count_nonzero", "nonzero"})
