"""Shape and layout ops of the port (``paddle_tpu.ops.manipulation``).

The paddle signatures over torch: ``axis`` for ``dim``, ``perm`` for
``transpose``, a ``-1`` section in ``split``, ``gather`` as an index
select on one axis, ``expand`` keeping a ``-1`` dim, and ``scatter``
replacing rows (``overwrite=True``) or adding the updates to them
(``overwrite=False``, the JAX package's rule). Reshapes, transposes,
splits and squeezes are views of their input where torch makes views.
"""
from __future__ import annotations

import builtins as _builtins

import numpy as np
import torch

from ..core.autograd import apply_op
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, as_torch

__all__ = ["cast", "reshape", "reshape_", "transpose", "moveaxis", "swapaxes",
           "concat", "stack", "split", "chunk", "unbind", "squeeze",
           "unsqueeze", "flatten", "expand", "broadcast_to", "expand_as",
           "broadcast_tensors", "tile", "repeat_interleave", "flip", "roll",
           "rot90", "gather", "gather_nd", "take_along_axis",
           "put_along_axis", "scatter", "scatter_nd_add", "scatter_nd",
           "index_select", "index_add", "index_put", "masked_select",
           "masked_fill", "where", "pad", "slice", "strided_slice", "crop",
           "as_strided", "view", "numel", "shard_index", "diff",
           "atleast_1d", "atleast_2d", "atleast_3d", "tensordot", "unfold"]



def cast(x, dtype):
    """``x`` in ``dtype`` (``Tensor.astype``)."""
    return x.astype(dtype)

def _shape_arg(shape):
    if isinstance(shape, (Tensor, torch.Tensor)):
        return tuple(int(s) for s in as_torch(shape).tolist())
    return tuple(int(s.item()) if isinstance(s, (Tensor, torch.Tensor))
                 else int(s) for s in shape)


def _int(v):
    return int(v.item()) if isinstance(v, (Tensor, torch.Tensor)) else v


def reshape(x, shape, name=None):
    s = _shape_arg(shape)
    return apply_op(lambda a: torch.reshape(a, s), x)


def reshape_(x, shape, name=None):
    from ..core import tensor as tensor_mod
    if tensor_mod._mutation_hook is not None:
        tensor_mod._mutation_hook(x)
    x._t = torch.reshape(x._t, _shape_arg(shape))
    return x


def transpose(x, perm, name=None):
    return apply_op(lambda a: a.permute(*perm), x)


def moveaxis(x, source, destination, name=None):
    return apply_op(lambda a: torch.movedim(a, source, destination), x)


def swapaxes(x, axis0, axis1, name=None):
    return apply_op(lambda a: torch.swapaxes(a, axis0, axis1), x)


def concat(x, axis=0, name=None):
    axis = _int(axis)
    return apply_op(lambda *arrs: torch.cat(arrs, dim=axis), *list(x))


def stack(x, axis=0, name=None):
    return apply_op(lambda *arrs: torch.stack(arrs, dim=axis), *list(x))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` an int (equal parts, which must divide the
    axis) or a list of sizes, one of which may be -1 (the rest)."""
    axis = _int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} is not divisible into "
                             f"{num_or_sections} equal sections")
        secs = [total // num_or_sections] * num_or_sections
    else:
        secs = [_int(s) for s in num_or_sections]
        if -1 in secs:
            secs[secs.index(-1)] = total - int(
                np.sum([s for s in secs if s != -1]))
    return list(apply_op(lambda a: tuple(torch.split(a, secs, dim=axis)), x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(apply_op(lambda a: tuple(torch.unbind(a, dim=axis)), x))


def squeeze(x, axis=None, name=None):
    """Drops the given axes of size 1 (others stay), or every size-1
    axis."""
    def f(a):
        if axis is None:
            return torch.squeeze(a)
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        return torch.squeeze(a, ax)
    return apply_op(f, x)


def unsqueeze(x, axis, name=None):
    axis = _int(axis)
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]

    def f(a):
        nd = a.dim() + len(ax)
        for i in sorted(_int(i) % nd for i in ax):
            a = a.unsqueeze(i)
        return a
    return apply_op(f, x)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return apply_op(lambda a: torch.flatten(a, start_axis, stop_axis), x)


def expand(x, shape, name=None):
    """Broadcast to ``shape``; a -1 keeps the input's size on a dim that
    exists in the input (trailing alignment)."""
    s = _shape_arg(shape)

    def f(a):
        tgt = list(s)
        off = len(tgt) - a.dim()
        for i in range(len(tgt)):
            if tgt[i] == -1:
                if i < off:
                    raise ValueError(
                        f"expand: -1 at position {i} refers to a new leading "
                        f"dim; sizes of added dims must be given explicitly")
                tgt[i] = a.shape[i - off]
        return a.expand(*tgt)
    return apply_op(f, x)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(as_torch(t).shape)
                                     for t in inputs])
    return [expand(t, shape) for t in inputs]


def tile(x, repeat_times, name=None):
    r = _shape_arg(repeat_times)
    return apply_op(lambda a: torch.tile(a, r), x)


def repeat_interleave(x, repeats, axis=None, name=None):
    return apply_op(lambda a, r: torch.repeat_interleave(a, r, dim=axis),
                    x, repeats)


def flip(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return apply_op(lambda a: torch.flip(a, ax), x)


def roll(x, shifts, axis=None, name=None):
    return apply_op(lambda a: torch.roll(a, shifts, axis), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(lambda a: torch.rot90(a, k, list(axes)), x)


def gather(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at ``index`` (flattened when it has
    more than one axis; a 0-d index drops the axis)."""
    axis = _int(axis)

    def f(a, idx):
        idx = as_torch(idx, device=a.device).long()
        if idx.dim() == 0:
            return a.index_select(axis, idx.reshape(1)).squeeze(axis)
        return a.index_select(axis, idx.reshape(-1))
    return apply_op(f, x, index)


def gather_nd(x, index, name=None):
    return apply_op(lambda a, idx: a[tuple(idx.long().movedim(-1, 0))],
                    x, index)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    def f(a, idx):
        idx = idx.long()
        if broadcast:
            tgt = list(a.shape)
            tgt[axis] = idx.shape[axis]
            idx = idx.expand(*tgt)
        return torch.gather(a, axis, idx)
    return apply_op(f, arr, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    def f(a, idx, v):
        idx = idx.long()
        v = as_torch(v, device=a.device).to(a.dtype)
        if v.shape != idx.shape:
            v = v.expand(idx.shape)
        if reduce == "assign":
            return a.scatter(axis, idx, v)
        if reduce in ("add", "sum"):
            return a.scatter_add(axis, idx, v)
        red = {"mul": "prod", "multiply": "prod", "amax": "amax",
               "amin": "amin"}.get(reduce)
        if red is None:
            raise ValueError(f"unknown reduce {reduce}")
        return a.scatter_reduce(axis, idx, v, red, include_self=True)
    return apply_op(f, arr, indices, values)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` replaced by ``updates``
    (``overwrite=True``), or with ``updates`` added to them."""
    def f(a, idx, upd):
        idx = idx.long().reshape(-1)
        upd = upd.to(a.dtype)
        if overwrite:
            return a.index_copy(0, idx, upd)
        return a.index_add(0, idx, upd)
    return apply_op(f, x, index, updates)


def scatter_nd_add(x, index, updates, name=None):
    return apply_op(lambda a, idx, upd: a.index_put(
        tuple(idx.long().movedim(-1, 0)), upd.to(a.dtype), accumulate=True),
        x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    s = _shape_arg(shape)
    return apply_op(lambda idx, upd: torch.zeros(
        s, dtype=upd.dtype, device=upd.device).index_put(
        tuple(idx.long().movedim(-1, 0)), upd, accumulate=True),
        index, updates)


def index_select(x, index, axis=0, name=None):
    return apply_op(lambda a, idx: torch.index_select(a, axis, idx.long()),
                    x, index)


def index_add(x, index, axis, value, name=None):
    return apply_op(lambda a, idx, v: a.index_add(axis, idx.long(),
                                                  v.to(a.dtype)),
                    x, index, value)


def index_put(x, indices, value, accumulate=False, name=None):
    idxs = tuple(as_torch(i) for i in indices)

    def f(a, v):
        ix = tuple(i.to(a.device) for i in idxs)
        return a.index_put(ix, as_torch(v, device=a.device).to(a.dtype),
                           accumulate=accumulate)
    return apply_op(f, x, value)


def masked_select(x, mask, name=None):
    return apply_op(lambda a, m: torch.masked_select(a, m.bool()), x, mask)


def masked_fill(x, mask, value, name=None):
    v = as_torch(value)

    def f(a, m):
        return torch.where(m.bool(), v.to(device=a.device, dtype=a.dtype), a)
    return apply_op(f, x, mask)


def where(condition, x=None, y=None, name=None):
    """``where(c, x, y)`` elementwise; ``where(c)`` is
    ``nonzero(c, as_tuple=True)``."""
    if x is None and y is None:
        from .math import nonzero
        return nonzero(condition, as_tuple=True)

    def f(c, a, b):
        like = a if isinstance(a, torch.Tensor) else b
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, dtype=like.dtype, device=like.device)
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(b, dtype=like.dtype, device=like.device)
        return torch.where(c.bool(), a, b)
    return apply_op(f, condition, x, y)


def _pad_index(n: int, before: int, after: int, mode: str) -> torch.Tensor:
    """The source index of each padded position along one axis, as
    ``jnp.pad``'s ``reflect`` (mirror without the edge, repeated past
    one period), ``edge`` and ``wrap`` modes pick it."""
    i = torch.arange(-before, n + after)
    if mode == "replicate" or n == 1:
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad`` is [before, after] per dim for every dim, or paddle's
    [left, right, top, bottom, ...] over the trailing spatial dims.
    ``reflect``, ``replicate`` and ``circular`` pad any axis by any
    width, as ``jnp.pad``'s ``reflect``, ``edge`` and ``wrap`` do."""
    pd = [_int(p) for p in (pad.tolist() if isinstance(
        pad, (Tensor, torch.Tensor)) else pad)]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")

    def f(a):
        nd = a.dim()
        if len(pd) == 2 * nd:
            width = [(pd[2 * i], pd[2 * i + 1]) for i in range(nd)]
        else:
            n_spatial = len(pd) // 2
            spatial = [(pd[2 * i], pd[2 * i + 1]) for i in range(n_spatial)]
            if data_format in ("NHWC", "NLC", "NDHWC"):
                width = [(0, 0)] + spatial[::-1] + [(0, 0)]
            else:
                width = [(0, 0)] * (nd - n_spatial) + spatial[::-1]
        if mode == "constant":
            flat = [w for pair in reversed(width) for w in pair]
            return torch.nn.functional.pad(a, flat, value=value)
        for axis, (lo, hi) in enumerate(width):
            if lo or hi:
                idx = _pad_index(a.shape[axis], lo, hi, mode)
                a = a.index_select(axis, idx.to(a.device))
        return a
    return apply_op(f, x, op_name="pad")


def slice(input, axes, starts, ends, name=None):
    axes, starts, ends = list(axes), [_int(v) for v in starts], \
        [_int(v) for v in ends]

    def f(a):
        idx = [_builtins.slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            idx[ax] = _builtins.slice(s, e)
        return a[tuple(idx)]
    return apply_op(f, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis; a negative stride walks backwards."""
    def f(a):
        for ax, s, e, st in zip(axes, starts, ends, strides):
            if st > 0:
                idx = [_builtins.slice(None)] * a.dim()
                idx[ax] = _builtins.slice(s, e, st)
                a = a[tuple(idx)]
            else:
                rows = range(*_builtins.slice(s, e, st).indices(a.shape[ax]))
                a = a.index_select(ax, torch.tensor(list(rows),
                                                    dtype=torch.long,
                                                    device=a.device))
        return a
    return apply_op(f, x)


def crop(x, shape=None, offsets=None, name=None):
    s = _shape_arg(shape)
    off = _shape_arg(offsets) if offsets is not None else (0,) * len(s)
    return apply_op(lambda a: a[tuple(_builtins.slice(o, o + d)
                                      for o, d in zip(off, s))], x)


def as_strided(x, shape, stride, offset=0, name=None):
    return apply_op(lambda a: torch.as_strided(
        a.contiguous().reshape(-1), tuple(shape), tuple(stride), offset), x)


def view(x, shape_or_dtype, name=None):
    """A shape reshapes; a dtype casts (the values, as the JAX package
    does, not the bits)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.astype(convert_dtype(shape_or_dtype))


def numel(x, name=None):
    t = as_torch(x)
    return Tensor(torch.tensor(t.numel(), dtype=torch.int64,
                               device=t.device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(idx):
        per = (index_num + nshards - 1) // nshards
        lo, hi = shard_id * per, (shard_id + 1) * per
        ok = (idx >= lo) & (idx < hi)
        return torch.where(ok, idx - lo, ignore_value)
    return apply_op(f, input)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    def edge(v, a):
        if v is None:
            return None
        v = as_torch(v, device=a.device).to(a.dtype)
        if v.dim() == 0:
            shape = list(a.shape)
            shape[axis] = 1
            v = v.expand(shape)
        return v
    return apply_op(lambda a, p, q: torch.diff(a, n, axis, edge(p, a),
                                               edge(q, a)),
                    x, prepend, append)


def atleast_1d(*inputs):
    out = [apply_op(torch.atleast_1d, t) for t in inputs]
    return out[0] if len(out) == 1 else out


def atleast_2d(*inputs):
    out = [apply_op(torch.atleast_2d, t) for t in inputs]
    return out[0] if len(out) == 1 else out


def atleast_3d(*inputs):
    out = [apply_op(torch.atleast_3d, t) for t in inputs]
    return out[0] if len(out) == 1 else out


def tensordot(x, y, axes=2, name=None):
    return apply_op(lambda a, b: torch.tensordot(a, b, dims=axes), x, y)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W] -> [N, C * kh * kw, L]``; ``paddings`` is
    one value, [pad_h, pad_w] or [top, left, bottom, right]."""
    def pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * 2
    ks, st, dl = pair(kernel_sizes), pair(strides), pair(dilations)
    pd = pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]

    def f(a):
        a = torch.nn.functional.pad(a, [pd[1], pd[3], pd[0], pd[2]])
        return torch.nn.functional.unfold(a, ks, dilation=dl, stride=st)
    return apply_op(f, x)
