"""Tensor creation ops of the port (``paddle_tpu.ops.creation``).

New tensors are made on the current device (``core.device``); the
``*_like`` ops on their argument's. Random ops draw from the port's
generator (``core.random.generator_for``): the values differ from the
JAX package's threefry streams, the shapes, dtypes, ranges and the
determinism under ``seed`` do not.
"""
from __future__ import annotations

import torch

from ..core import random as random_mod
from ..core.autograd import apply_op
from ..core.device import current_device
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.tensor import Tensor, as_torch, to_tensor

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "eye", "diag",
           "tril", "triu", "meshgrid", "assign", "clone", "rand", "uniform",
           "randn", "normal", "randint", "randperm", "multinomial",
           "bernoulli", "to_tensor", "get_default_dtype"]


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    return d if d is not None else (default or get_default_dtype())


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, int):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _v(a):
    return a.item() if isinstance(a, (Tensor, torch.Tensor)) else a


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_shape(shape), dtype=_dt(dtype),
                              device=current_device()))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_shape(shape), dtype=_dt(dtype),
                             device=current_device()))


def full(shape, fill_value, dtype=None, name=None):
    return Tensor(torch.full(_shape(shape), _v(fill_value), dtype=_dt(dtype),
                             device=current_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(x, fn, dtype):
    t = as_torch(x)
    return Tensor(fn(t, dtype=convert_dtype(dtype)))


def zeros_like(x, dtype=None, name=None):
    return _like(x, torch.zeros_like, dtype)


def ones_like(x, dtype=None, name=None):
    return _like(x, torch.ones_like, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return _like(x, lambda t, dtype: torch.full_like(t, _v(fill_value),
                                                     dtype=dtype), dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """int64 when start, end and step are all ints, else the default
    float dtype."""
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    d = convert_dtype(dtype)
    if d is None:
        d = torch.int64 if all(isinstance(v, int) for v in
                               (start, end, step)) else get_default_dtype()
    return Tensor(torch.arange(start, end, step, dtype=d,
                               device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor(torch.linspace(_v(start), _v(stop), int(_v(num)),
                                 dtype=_dt(dtype), device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return Tensor(torch.eye(num_rows, num_rows if num_columns is None
                            else num_columns, dtype=_dt(dtype),
                            device=current_device()))


def diag(x, offset=0, padding_value=0, name=None):
    """A vector -> the matrix with it on diagonal ``offset`` (the rest
    ``padding_value``); a matrix -> that diagonal."""
    def f(a):
        out = torch.diag(a, offset)
        if a.dim() == 1 and padding_value != 0:
            on = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
            out = torch.where(on, out, padding_value)
        return out
    return apply_op(f, x if isinstance(x, Tensor) else to_tensor(x))


def tril(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return apply_op(lambda a: torch.triu(a, diagonal), x)


def meshgrid(*args, **kwargs):
    tens = [a if isinstance(a, Tensor) else to_tensor(a) for a in args]
    outs = apply_op(lambda *xs: tuple(torch.meshgrid(*xs, indexing="ij")),
                    *tens)
    return list(outs)


def assign(x, output=None):
    if output is not None:
        output.set_value(x)
        return output
    if isinstance(x, Tensor):
        return apply_op(lambda a: a.clone(), x)
    return to_tensor(x)


def clone(x, name=None):
    return x.clone()


# -- random creation ---------------------------------------------------------

def _gen(dev, seed=0):
    if seed:
        return torch.Generator(device=dev).manual_seed(int(seed))
    return random_mod.generator_for(dev)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, min=0.0, max=1.0)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    t = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return Tensor(t.uniform_(min, max, generator=_gen(dev, seed)))


def randn(shape, dtype=None, name=None):
    dev = current_device()
    return Tensor(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                              generator=_gen(dev)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = as_torch(mean), as_torch(std)
        dev = (m if isinstance(mean, Tensor) else s).device
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, device=dev, generator=_gen(dev))
        return Tensor(z * s + m)
    dev = current_device()
    z = torch.randn(_shape(shape), dtype=get_default_dtype(), device=dev,
                    generator=_gen(dev))
    return Tensor(z * std + mean)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return Tensor(torch.randint(low, high, _shape(shape),
                                dtype=convert_dtype(dtype) or torch.int64,
                                device=dev, generator=_gen(dev)))


def randperm(n, dtype=None, name=None):
    dev = current_device()
    return Tensor(torch.randperm(n, dtype=convert_dtype(dtype) or torch.int64,
                                 device=dev, generator=_gen(dev)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    t = as_torch(x)
    return Tensor(torch.multinomial(t.float(), num_samples, replacement,
                                    generator=_gen(t.device)))


def bernoulli(x, name=None):
    t = as_torch(x)
    u = torch.rand(t.shape, device=t.device, generator=_gen(t.device))
    return Tensor((u < t).to(t.dtype))
