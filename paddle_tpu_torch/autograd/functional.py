"""Functional higher-order autograd: ``jacobian`` / ``hessian`` / ``vjp``
/ ``jvp``.

The port of ``paddle_tpu.autograd.functional``: the JAX functions map
onto ``jax.jacobian`` / ``jax.hessian`` / ``jax.vjp`` / ``jax.jvp`` of the
pure function of arrays, these onto ``torch.func.jacrev`` /
``torch.func.hessian`` / ``torch.func.vjp`` / ``torch.func.jvp`` of the
pure function of torch tensors, with the same nesting: one Jacobian
(``hessian``: one block) per input, per output; a single non-tuple
input unwraps the first level (``jac[0]``, ``hes[0][0]``); ``v=None``
means ones. ``is_batched`` is accepted and ignored, as in JAX.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, as_torch

__all__ = ["jacobian", "hessian", "vjp", "jvp"]


def _unwrap(xs):
    if isinstance(xs, Tensor):
        return xs._t
    if isinstance(xs, (tuple, list)):
        return type(xs)(_unwrap(x) for x in xs)
    return xs


def _wrap(xs):
    if isinstance(xs, (tuple, list)):
        return type(xs)(_wrap(x) for x in xs)
    return xs if isinstance(xs, Tensor) else Tensor(xs)


def _pure(func):
    def f(*args):
        return _unwrap(func(*[Tensor(a) for a in args]))
    return f


def _raw_args(xs):
    args = xs if isinstance(xs, (tuple, list)) else (xs,)
    return [a._t.detach() if isinstance(a, Tensor) else as_torch(a)
            for a in args]


def _single(xs) -> bool:
    return not isinstance(xs, (tuple, list))


def _ones(t):
    if isinstance(t, (tuple, list)):
        return type(t)(_ones(x) for x in t)
    return torch.ones_like(t)


def jacobian(func, xs, is_batched=False):
    raw = _raw_args(xs)
    jac = torch.func.jacrev(_pure(func),
                            argnums=tuple(range(len(raw))))(*raw)
    if len(raw) == 1 and _single(xs):
        jac = jac[0]
    return _wrap(jac)


def hessian(func, xs, is_batched=False):
    raw = _raw_args(xs)
    hes = torch.func.hessian(_pure(func),
                             argnums=tuple(range(len(raw))))(*raw)
    if len(raw) == 1 and _single(xs):
        hes = hes[0][0]
    return _wrap(hes)


def vjp(func, xs, v=None):
    raw = _raw_args(xs)
    out, vjp_fn = torch.func.vjp(_pure(func), *raw)
    grads = vjp_fn(_ones(out) if v is None else _unwrap(v))
    if len(raw) == 1 and _single(xs):
        grads = grads[0]
    return _wrap(out), _wrap(grads)


def jvp(func, xs, v=None):
    raw = _raw_args(xs)
    if v is None:
        tangents = tuple(torch.ones_like(a) for a in raw)
    else:
        vv = v if isinstance(v, (tuple, list)) else (v,)
        tangents = tuple(_unwrap(t) for t in vv)
    out, tangent_out = torch.func.jvp(_pure(func), tuple(raw), tangents)
    return _wrap(out), _wrap(tangent_out)
