"""The long-tail tensor ops of the port (``paddle_tpu/ops/extra_math.py``):
every name of its ``__all__``, exported at the package root as the JAX
package exports them.

Each differentiable op runs through ``core.autograd.apply_op`` under the
JAX package's op name with the JAX arithmetic (its clamps and epsilons:
``renorm``'s 1e-7, ``cdist`` / ``pdist``'s 1e-30 under the square root,
``take``'s clipped indices, ``nanmedian`` as the mean of the two middle
values). The ops the JAX package runs on the host with numpy
(``histogram``, ``histogram_bin_edges``, ``histogramdd``, the index
tables) read the tensor to the host here too; the random ops
(``standard_normal``, ``standard_gamma``, ``poisson``, ``log_normal``,
``randint_like``) draw from a ``torch.Generator`` seeded by a host draw
of the port's generator (``core.random.generator_for``, counted), on the
current device.
"""
from __future__ import annotations

import itertools
import math as _pymath

import numpy as np
import torch

from ..core import random as random_mod
from ..core.autograd import apply_op
from ..core.device import current_device
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor

__all__ = [
    "addmm", "add_n", "as_complex", "as_real", "block_diag",
    "broadcast_shape", "bucketize", "cartesian_prod", "cdist",
    "column_stack", "combinations", "complex", "copysign",
    "cumulative_trapezoid", "deg2rad", "diag_embed", "diagflat",
    "diagonal_scatter", "dsplit", "dstack", "frexp", "gammainc",
    "gammaincc", "gammaln", "gcd", "heaviside", "histogram",
    "histogram_bin_edges", "histogramdd", "hsplit", "hstack", "i0", "i0e",
    "i1", "i1e", "index_fill", "is_complex", "is_empty",
    "is_floating_point", "is_integer", "is_tensor", "isin", "isneginf",
    "isposinf", "isreal", "lcm", "ldexp", "log_normal", "logcumsumexp",
    "logit", "logspace", "masked_scatter", "multigammaln", "multiplex",
    "nan_to_num", "nanmedian", "nanquantile", "nextafter", "pdist",
    "poisson", "polar", "polygamma", "quantile", "rad2deg", "randint_like",
    "reduce_as", "renorm", "reverse", "row_stack", "select_scatter",
    "sgn", "signbit", "sinc", "slice_scatter", "standard_gamma",
    "standard_normal", "take", "tensor_split", "trapezoid",
    "tril_indices", "triu_indices", "unflatten", "unique_consecutive",
    "unstack", "vander", "view_as", "vsplit", "vstack",
    "bitwise_left_shift", "bitwise_right_shift",
]


def _d(x) -> torch.Tensor:
    return x._t if isinstance(x, Tensor) else torch.as_tensor(x)


def _op(f, *args, name):
    return apply_op(f, *args, op_name=name)


def _host(x) -> np.ndarray:
    return _d(x).detach().cpu().numpy()


def _on_device(a: np.ndarray) -> Tensor:
    return Tensor(torch.as_tensor(a, device=current_device()))


# --------------------------- predicates / info ------------------------------

def is_tensor(x):
    return isinstance(x, Tensor)


def is_complex(x):
    return _d(x).is_complex()


def is_integer(x):
    d = _d(x).dtype
    return not d.is_floating_point and not d.is_complex and d != torch.bool


def is_floating_point(x):
    return _d(x).is_floating_point()


def is_empty(x, name=None):
    a = _d(x)
    return Tensor(torch.tensor(a.numel() == 0, device=a.device))


def isreal(x, name=None):
    return _op(torch.isreal, x, name="isreal")


def isposinf(x, name=None):
    return _op(torch.isposinf, x, name="isposinf")


def isneginf(x, name=None):
    return _op(torch.isneginf, x, name="isneginf")


def signbit(x, name=None):
    return _op(torch.signbit, x, name="signbit")


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return _op(lambda a, b: torch.isin(a, b, invert=invert), x, test_x,
               name="isin")


# ------------------------------- math ---------------------------------------

def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return _op(lambda i, a, b: beta * i + alpha * (a @ b), input, x, y,
               name="addmm")


def add_n(inputs, name=None):
    if isinstance(inputs, (Tensor, torch.Tensor)):
        inputs = [inputs]
    return _op(lambda *xs: sum(xs[1:], xs[0]), *inputs, name="add_n")


def logit(x, eps=None, name=None):
    def f(a):
        if eps is not None:
            a = a.clamp(eps, 1 - eps)
        return torch.log(a) - torch.log1p(-a)
    return _op(f, x, name="logit")


def logcumsumexp(x, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.logcumsumexp(a.reshape(-1), 0)
        return torch.logcumsumexp(a, axis)
    return _op(f, x, name="logcumsumexp")


def sinc(x, name=None):
    return _op(torch.sinc, x, name="sinc")


def heaviside(x, y, name=None):
    return _op(torch.heaviside, x, y, name="heaviside")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return _op(lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf,
                                          neginf=neginf), x,
               name="nan_to_num")


def sgn(x, name=None):
    return _op(torch.sgn, x, name="sgn")


def copysign(x, y, name=None):
    return _op(torch.copysign, x, y, name="copysign")


def nextafter(x, y, name=None):
    return _op(torch.nextafter, x, y, name="nextafter")


def frexp(x, name=None):
    return _op(lambda a: tuple(torch.frexp(a)), x, name="frexp")


def ldexp(x, y, name=None):
    return _op(lambda a, b: (a * torch.pow(2.0, b.to(torch.int32).to(
        a.dtype))).to(a.dtype), x, y, name="ldexp")


def rad2deg(x, name=None):
    return _op(torch.rad2deg, x, name="rad2deg")


def deg2rad(x, name=None):
    return _op(torch.deg2rad, x, name="deg2rad")


def gcd(x, y, name=None):
    return _op(torch.gcd, x, y, name="gcd")


def lcm(x, y, name=None):
    return _op(torch.lcm, x, y, name="lcm")


def gammaln(x, name=None):
    return _op(torch.special.gammaln, x, name="gammaln")


def gammainc(x, y, name=None):
    return _op(torch.special.gammainc, x, y, name="gammainc")


def gammaincc(x, y, name=None):
    return _op(torch.special.gammaincc, x, y, name="gammaincc")


def multigammaln(x, p, name=None):
    def f(a):
        c = 0.25 * p * (p - 1) * _pymath.log(_pymath.pi)
        j = torch.arange(p, dtype=torch.float32, device=a.device)
        return c + torch.special.gammaln(a[..., None] - 0.5 * j).sum(-1)
    return _op(f, x, name="multigammaln")


def polygamma(x, n, name=None):
    if n == 0:
        return _op(torch.special.digamma, x, name="polygamma")
    return _op(lambda a: torch.special.polygamma(n, a), x, name="polygamma")


def i0(x, name=None):
    return _op(torch.special.i0, x, name="i0")


def i0e(x, name=None):
    return _op(torch.special.i0e, x, name="i0e")


def i1(x, name=None):
    return _op(torch.special.i1, x, name="i1")


def i1e(x, name=None):
    return _op(torch.special.i1e, x, name="i1e")


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return _op(lambda a, b: torch.trapezoid(a, b, dim=axis), y, x,
                   name="trapezoid")
    return _op(lambda a: torch.trapezoid(a, dx=dx or 1.0, dim=axis), y,
               name="trapezoid")


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def f(a, *maybe_x):
        a = a.movedim(axis, -1)
        widths = maybe_x[0].movedim(axis, -1).diff() if maybe_x \
            else (dx or 1.0)
        areas = (a[..., 1:] + a[..., :-1]) / 2 * widths
        return areas.cumsum(-1).movedim(-1, axis)
    args = [y] + ([x] if x is not None else [])
    return _op(f, *args, name="cumulative_trapezoid")


def _quantile(fn, x, q, axis, keepdim, interpolation, name):
    def f(a):
        qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
        if axis is None:
            out = fn(a.reshape(-1), qt, dim=0, interpolation=interpolation)
            if keepdim:
                out = out.reshape(out.shape + (1,) * a.dim())
            return out
        return fn(a, qt, dim=axis, keepdim=keepdim,
                  interpolation=interpolation)
    return _op(f, x, name=name)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation,
                     "quantile")


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation,
                     "nanquantile")


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    """The mean of the two middle values of an even count (the JAX
    function's; torch's ``nanmedian`` takes the lower one)."""
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim, "linear",
                     "nanmedian")


def renorm(x, p, axis, max_norm, name=None):
    def f(a):
        dims = tuple(i for i in range(a.dim()) if i != axis % a.dim())
        norms = (a.abs() ** p).sum(dim=dims, keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return a * factor
    return _op(f, x, name="renorm")


def reduce_as(x, target, name=None):
    def f(a, t):
        extra = a.dim() - t.dim()
        axes = tuple(range(extra)) + tuple(
            i + extra for i in range(t.dim())
            if t.shape[i] == 1 and a.shape[i + extra] != 1)
        out = a.sum(dim=axes) if axes else a
        return out.reshape(t.shape)
    return _op(f, x, target, name="reduce_as")


# ----------------------- complex-number helpers ------------------------------

def complex(real, imag, name=None):
    return _op(torch.complex, real, imag, name="complex")


def as_complex(x, name=None):
    return _op(lambda a: torch.complex(a[..., 0], a[..., 1]), x,
               name="as_complex")


def as_real(x, name=None):
    return _op(lambda a: torch.stack([a.real, a.imag], -1), x,
               name="as_real")


def polar(abs, angle, name=None):
    return _op(lambda r, t: torch.complex(r * torch.cos(t),
                                          r * torch.sin(t)),
               abs, angle, name="polar")


# --------------------------- random ------------------------------------------

def standard_normal(shape, dtype="float32", name=None):
    dev = current_device()
    return Tensor(torch.randn(tuple(shape), dtype=convert_dtype(dtype),
                              device=dev,
                              generator=random_mod.generator_for(dev)))


def standard_gamma(x, name=None):
    a = _d(x)
    g = random_mod.generator_for(a.device)
    return _op(lambda t: torch._standard_gamma(t, generator=g), x,
               name="standard_gamma")


def poisson(x, name=None):
    a = _d(x)
    g = random_mod.generator_for(a.device)
    return _op(lambda t: torch.poisson(t, generator=g).to(t.dtype), x,
               name="poisson")


def log_normal(mean=1.0, std=2.0, shape=None, dtype="float32", name=None):
    dev = current_device()
    z = torch.randn(tuple(shape or ()), dtype=convert_dtype(dtype),
                    device=dev, generator=random_mod.generator_for(dev))
    return Tensor(torch.exp(mean + std * z))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    a = _d(x)
    out = torch.randint(low, high, a.shape, device=a.device,
                        generator=random_mod.generator_for(a.device))
    return Tensor(out.to(convert_dtype(dtype) if dtype else a.dtype))


# ------------------------- shape / stacking ----------------------------------

def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def hstack(x, name=None):
    return _op(lambda *xs: torch.hstack(xs), *x, name="hstack")


def vstack(x, name=None):
    return _op(lambda *xs: torch.vstack(xs), *x, name="vstack")


def dstack(x, name=None):
    return _op(lambda *xs: torch.dstack(xs), *x, name="dstack")


def column_stack(x, name=None):
    return _op(lambda *xs: torch.column_stack(xs), *x, name="column_stack")


row_stack = vstack


def tensor_split(x, num_or_indices, axis=0, name=None):
    arg = num_or_indices if isinstance(num_or_indices, int) \
        else list(num_or_indices)
    return list(_op(lambda a: tuple(torch.tensor_split(a, arg, dim=axis)),
                    x, name="tensor_split"))


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1 if _d(x).dim() > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def unstack(x, axis=0, num=None, name=None):
    return list(_op(lambda a: tuple(torch.unbind(a, dim=axis)), x,
                    name="unstack"))


def unflatten(x, axis, shape, name=None):
    def f(a):
        ax = axis % a.dim()
        return a.reshape(list(a.shape[:ax]) + list(shape) +
                         list(a.shape[ax + 1:]))
    return _op(f, x, name="unflatten")


def view_as(x, other, name=None):
    return _op(lambda a, b: a.reshape(b.shape), x, other, name="view_as")


def reverse(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return _op(lambda a: torch.flip(a, dims=tuple(axes)), x, name="reverse")


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    a = _d(x)
    out = torch.unique_consecutive(a.reshape(-1) if axis is None else a,
                                   return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not isinstance(out, tuple):
        return Tensor(out)
    return tuple(Tensor(t if i == 0 else t.long())
                 for i, t in enumerate(out))


# ----------------------- construction helpers --------------------------------

def block_diag(inputs, name=None):
    return _op(lambda *xs: torch.block_diag(*xs), *inputs, name="block_diag")


def diagflat(x, offset=0, name=None):
    return _op(lambda a: torch.diagflat(a, offset), x, name="diagflat")


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return _op(lambda a: torch.diag_embed(a, offset, dim1, dim2), input,
               name="diag_embed")


def logspace(start, stop, num, base=10.0, dtype="float32", name=None):
    return Tensor(torch.logspace(start, stop, int(num), base=base,
                                 dtype=convert_dtype(dtype),
                                 device=current_device()))


def vander(x, n=None, increasing=False, name=None):
    return _op(lambda a: torch.vander(a, N=n, increasing=increasing), x,
               name="vander")


def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = col if col is not None else row
    return Tensor(torch.tril_indices(row, col, offset,
                                     device=current_device()))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = col if col is not None else row
    return Tensor(torch.triu_indices(row, col, offset,
                                     device=current_device()))


def cartesian_prod(x, name=None):
    if len(x) == 1:
        return x[0] if isinstance(x[0], Tensor) else Tensor(_d(x[0]))

    def f(*xs):
        grids = torch.meshgrid(*xs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], -1)
    return _op(f, *x, name="cartesian_prod")


def combinations(x, r=2, with_replacement=False, name=None):
    n = _d(x).shape[0]
    combo = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = np.asarray(list(combo(range(n), r)), np.int64).reshape(-1, r)
    return _op(lambda a: a[torch.as_tensor(idx, device=a.device)], x,
               name="combinations")


# ------------------------- scatter-style updates -----------------------------

def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def f(a, v):
        idx = [slice(None)] * a.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            idx[ax] = slice(s, e, st)
        out = a.clone()
        out[tuple(idx)] = v
        return out
    return _op(f, x, value, name="slice_scatter")


def select_scatter(x, values, axis, index, name=None):
    return _op(lambda a, v: torch.select_scatter(a, v.to(a.dtype), axis,
                                                 index),
               x, values, name="select_scatter")


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return _op(lambda a, v: torch.diagonal_scatter(a, v.to(a.dtype), offset,
                                                   axis1, axis2),
               x, y, name="diagonal_scatter")


def index_fill(x, index, axis, value, name=None):
    return _op(lambda a, i: torch.index_fill(a, axis, i.long().reshape(-1),
                                             value),
               x, index, name="index_fill")


def masked_scatter(x, mask, value, name=None):
    def f(a, m, v):
        return a.masked_scatter(m.to(torch.bool).expand(a.shape),
                                v.to(a.dtype))
    return _op(f, x, mask, value, name="masked_scatter")


def multiplex(inputs, index, name=None):
    def f(i, *xs):
        stacked = torch.stack(xs)                    # [K, B, ...]
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[i.reshape(-1).long(), rows]
    return _op(f, index, *inputs, name="multiplex")


def take(x, index, mode="raise", name=None):
    """Elements of the flattened ``x``; ``raise`` checks the indices on
    the host and then clips them, as the JAX function does (a negative
    index reads element 0 there); ``wrap`` takes them modulo the size."""
    n = _d(x).numel()
    if mode == "raise":
        iv = _host(index)
        if iv.size and (iv.min() < -n or iv.max() >= n):
            raise ValueError(
                f"take index out of range for tensor of {n} elements")
        mode = "clip"
    if mode not in ("clip", "wrap"):
        raise ValueError(f"take mode must be raise, clip or wrap, got "
                         f"{mode!r}")

    def f(a, i):
        i = i.long()
        i = i.clamp(0, n - 1) if mode == "clip" else torch.remainder(i, n)
        return a.reshape(-1)[i.reshape(-1)].reshape(i.shape)
    return _op(f, x, index, name="take")


# ----------------------------- histograms ------------------------------------

def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    xv = _host(input).reshape(-1)
    lo, hi = (min, max) if (min != 0 or max != 0) else \
        (float(xv.min()) if xv.size else 0.0,
         float(xv.max()) if xv.size else 1.0)
    wv = _host(weight).reshape(-1) if weight is not None else None
    h, _ = np.histogram(xv, bins=bins, range=(lo, hi), weights=wv,
                        density=density)
    return _on_device(h if density or weight is not None
                      else h.astype(np.int64))


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    xv = _host(input).reshape(-1)
    rng = (min, max) if (min != 0 or max != 0) else None
    return _on_device(np.histogram_bin_edges(xv, bins=bins, range=rng)
                      .astype(np.float32))


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    wv = _host(weights) if weights is not None else None
    h, edges = np.histogramdd(_host(x), bins=bins, range=ranges,
                              density=density, weights=wv)
    return (_on_device(h.astype(np.float32)),
            [_on_device(e.astype(np.float32)) for e in edges])


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return _op(lambda a, s: torch.searchsorted(s, a, right=right,
                                               out_int32=out_int32),
               x, sorted_sequence, name="bucketize")


# ------------------------------ distances ------------------------------------

def _pnorm(diff, p):
    if p == 2.0:
        return torch.sqrt((diff * diff).sum(-1) + 1e-30)
    return (diff.abs() ** p).sum(-1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    return _op(lambda a, b: _pnorm(a[..., :, None, :] - b[..., None, :, :],
                                   p), x, y, name="cdist")


def pdist(x, p=2.0, name=None):
    n = _d(x).shape[0]
    r, c = np.triu_indices(n, 1)

    def f(a):
        ri = torch.as_tensor(r, device=a.device)
        ci = torch.as_tensor(c, device=a.device)
        return _pnorm(a[ri] - a[ci], p)
    return _op(f, x, name="pdist")


# ------------------------------ bit ops --------------------------------------

def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return _op(torch.bitwise_left_shift, x, y, name="bitwise_left_shift")


def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    if is_arithmetic:
        return _op(torch.bitwise_right_shift, x, y,
                   name="bitwise_right_shift")

    def f(a, b):
        # logical: the arithmetic shift with the sign bits cleared, in
        # the input's own width
        bits = a.element_size() * 8
        b = b.to(torch.int64)
        shifted = torch.bitwise_right_shift(a.to(torch.int64), b)
        if bits < 64:
            shifted = shifted & ((1 << bits) - 1)
            keep = (torch.ones_like(b) << (bits - b).clamp(min=0)) - 1
        else:
            keep = torch.where(
                b > 0, (torch.ones_like(b) << (64 - b).clamp(max=63)) - 1,
                torch.full_like(b, -1))
        return (shifted & keep).to(a.dtype)
    return _op(f, x, y, name="bitwise_right_shift")
