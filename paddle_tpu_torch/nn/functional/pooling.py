"""Pooling functionals of the port: max, average, power-average,
adaptive, mask-returning and fractional pooling, and max unpooling.

The port of ``paddle_tpu/nn/functional/pooling.py``. The JAX package
pools through ``lax.reduce_window`` (no Pallas kernel); here max and
average pooling are torch's (``torch.nn.functional.max_pool*`` /
``avg_pool*``), on a ``permute`` view for the channel-last layouts, so
NHWC makes no NCHW copy. Semantics kept from the JAX functions:

- padding takes the conv forms (``nn.functional.conv``); ``'SAME'`` is
  XLA's, and with a string padding ``ceil_mode`` does nothing and an
  average divides by the whole window;
- ``ceil_mode`` grows the end pad until the last partial window fits
  (no rule about where that window starts);
- averages sum in f32 and cast once; ``exclusive`` divides by the
  window's elements inside the input;
- max pooling's gradient goes to the first maximum of a window in
  row-major order, the rule of the JAX custom VJP (NCHW) and of XLA's
  ``SelectAndScatter`` (NHWC): torch's pooling keeps the first maximum
  too. ResNet's stem feeds the pool ReLU zeros, so ties are common;
- adaptive pooling reduces one spatial axis at a time over the buckets
  ``[floor(i·n/m), ceil((i+1)·n/m))``, averages in f32 cast back after
  each axis;
- ``return_mask`` gives each maximum's flat spatial index (channel-first
  layouts only, as in the JAX package), ``max_unpool`` scatters by it;
- fractional max pooling with ``random_u=None`` draws ``u`` from a host
  key of the port's key stream (``core.random.host_key``, a counted
  host draw: the windows are host-static).

Where torch's own padding cannot express a configuration (an
asymmetric pad, a pad over half the window, ``ceil_mode``), the input
is padded explicitly (−inf for max, zeros for sums) and torch pools
without padding; averages then divide f32 window sums by the counts.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from ...core import random as _random
from ...core.autograd import apply_op
from .conv import (_CHANNEL_LAST, _channel_first, _channel_last,
                   _pad_spatial, _padding, same_pads)

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d", "lp_pool1d", "lp_pool2d",
           "fractional_max_pool2d", "fractional_max_pool3d"]

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == n else list(v) * n))[:n]
    return (int(v),) * n


def _lowest(dtype):
    return -math.inf if dtype.is_floating_point else torch.iinfo(dtype).min


def _window_pads(sizes, k, s, pad, ceil_mode):
    """The (lo, hi) pads of each spatial axis, and whether the padding
    was a string (then ``ceil_mode`` is ignored)."""
    nd = len(k)
    if isinstance(pad, str):
        return ([(0, 0)] * nd if pad == "VALID"
                else same_pads(sizes, k, s, (1,) * nd)), True
    pads = [tuple(p) for p in pad]
    if ceil_mode:
        for i in range(nd):
            lo, hi = pads[i]
            rem = (sizes[i] + lo + hi - k[i]) % s[i]
            if rem:
                pads[i] = (lo, hi + s[i] - rem)
    return pads, False


def _torch_pads(pads, k):
    """The symmetric pads torch's pooling takes itself (at most half the
    window), or None."""
    if all(lo == hi and 0 <= lo <= kk // 2 for (lo, hi), kk in zip(pads, k)):
        return tuple(lo for lo, _ in pads)
    return None


def _window_sums(a, k, s, nd):
    """f32 window sums of the padded channel-first ``a``."""
    if nd == 1:
        return tF.avg_pool2d(a.unsqueeze(-2), (1, k[0]), (1, s[0]),
                             divisor_override=1).squeeze(-2)
    pool = tF.avg_pool2d if nd == 2 else tF.avg_pool3d
    return pool(a, k, s, divisor_override=1)


def _pool_fn(a, *, k, s, pad, nd, channel_last, reducer, ceil_mode,
             exclusive):
    if channel_last:
        a = _channel_first(a, nd)
    pads, string = _window_pads(a.shape[2:], k, s, pad, ceil_mode)
    direct = _torch_pads(pads, k)
    if reducer == "max":
        if direct is not None:
            out = _MAX[nd](a, k, s, direct)
        else:
            out = _MAX[nd](_pad_spatial(a, pads, _lowest(a.dtype)), k, s)
    else:
        by_count = exclusive and not string
        if direct is not None:
            pool = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}[nd]
            out = pool(a, k, s, direct, count_include_pad=not by_count)
        else:
            sums = _window_sums(_pad_spatial(a.float(), pads), k, s, nd)
            if by_count:
                ones = torch.ones((1, 1) + tuple(a.shape[2:]),
                                  dtype=torch.float32, device=a.device)
                div = _window_sums(_pad_spatial(ones, pads), k, s, nd)
            else:
                div = float(np.prod(k))
            out = (sums / div).to(a.dtype)
    return _channel_last(out, nd) if channel_last else out


def _pool(x, kernel, stride, padding, nd, data_format, reducer, op_name,
          ceil_mode=False, exclusive=True):
    return apply_op(_pool_fn, x, k=_tuple(kernel, nd),
                    s=_tuple(stride if stride is not None else kernel, nd),
                    pad=_padding(padding, nd), nd=nd,
                    channel_last=data_format in _CHANNEL_LAST,
                    reducer=reducer, ceil_mode=ceil_mode,
                    exclusive=exclusive, op_name=op_name)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 1,
                                   "max_pool1d", ceil_mode,
                                   channel_last=data_format == "NLC")
    return _pool(x, kernel_size, stride, padding, 1, data_format, "max",
                 "max_pool1d", ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 2,
                                   "max_pool2d", ceil_mode,
                                   channel_last=data_format == "NHWC")
    return _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                 "max_pool2d", ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 3,
                                   "max_pool3d", ceil_mode,
                                   channel_last=data_format == "NDHWC")
    return _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                 "max_pool3d", ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, data_format, "mean",
                 "avg_pool1d", ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "mean",
                 "avg_pool2d", ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "mean",
                 "avg_pool3d", ceil_mode, exclusive)


def _bucket_reduce(seg, axis, mode, dtype, keepdim):
    if mode == "max":
        return seg.amax(axis, keepdim=keepdim)
    return seg.float().mean(axis, keepdim=keepdim).to(dtype)


def _adaptive_fn(a, *, os, nd, channel_last, mode):
    off = 1 if channel_last else 2
    out = a
    for d in range(nd):
        axis = off + d
        n_in, n_out = a.shape[axis], os[d]
        if n_out is None:
            continue
        if n_in % n_out == 0:
            r = out.reshape(out.shape[:axis] + (n_out, n_in // n_out)
                            + out.shape[axis + 1:])
            out = _bucket_reduce(r, axis + 1, mode, a.dtype, False)
        else:
            pieces = []
            for i in range(n_out):
                st = int(np.floor(i * n_in / n_out))
                en = int(np.ceil((i + 1) * n_in / n_out))
                pieces.append(_bucket_reduce(out.narrow(axis, st, en - st),
                                             axis, mode, a.dtype, True))
            out = torch.cat(pieces, dim=axis)
    return out


def _adaptive_pool(x, output_size, nd, data_format, mode, op_name):
    os = output_size if isinstance(output_size, (list, tuple)) \
        else (output_size,) * nd
    os = tuple(None if v is None else int(v) for v in os)
    return apply_op(_adaptive_fn, x, os=os, nd=nd,
                    channel_last=data_format in _CHANNEL_LAST, mode=mode,
                    op_name=op_name)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "NCW", "avg",
                          "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format, "avg",
                          "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format, "avg",
                          "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, "NCW", "max",
                          "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, "NCHW", "max",
                          "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 3, "NCDHW", "max",
                          "adaptive_max_pool3d")


# -- mask-returning max pooling + unpooling ----------------------------------

def _window_tables(spatial, k, s, pads):
    """Host gather tables for strided windows over channel-first input:
    ``gidx [P, K]`` flat input index per (output position, window
    offset), ``valid [P, K]`` in-bounds mask, and the output's spatial
    dims."""
    nd = len(spatial)
    out_sp = [(spatial[i] + pads[i][0] + pads[i][1] - k[i]) // s[i] + 1
              for i in range(nd)]
    coord = np.meshgrid(*[np.arange(out_sp[i]) * s[i] - pads[i][0]
                          for i in range(nd)], indexing="ij")
    offs = np.meshgrid(*[np.arange(k[i]) for i in range(nd)],
                       indexing="ij")
    flat_strides = [int(np.prod(spatial[i + 1:])) for i in range(nd)]
    gidx = np.zeros((int(np.prod(out_sp)), int(np.prod(k))), np.int64)
    valid = np.ones_like(gidx, bool)
    for i in range(nd):
        ci = coord[i].reshape(-1, 1) + offs[i].reshape(1, -1)
        valid &= (ci >= 0) & (ci < spatial[i])
        gidx += np.clip(ci, 0, spatial[i] - 1) * flat_strides[i]
    return np.where(valid, gidx, 0), valid, out_sp


def _max_pool_with_mask(x, kernel, stride, padding, nd, op_name,
                        ceil_mode=False, channel_last=False):
    """Channel-first layouts only, as the reference's unpool contract."""
    if channel_last:
        raise ValueError(
            f"{op_name}(return_mask=True) only supports channel-first "
            f"layouts (NCL/NCHW/NCDHW), matching the reference unpool "
            f"contract")
    k = _tuple(kernel, nd)
    s = _tuple(stride if stride is not None else kernel, nd)
    pad = _padding(padding, nd)
    if isinstance(pad, str):
        raise ValueError(f"{op_name}(return_mask=True) needs numeric padding")

    def f(a):
        spatial = tuple(a.shape[2:])
        pads, _ = _window_pads(spatial, k, s, pad, ceil_mode)
        gidx, valid, out_sp = _window_tables(spatial, k, s, pads)
        n, c = a.shape[:2]
        g = torch.as_tensor(gidx, device=a.device)
        wins = a.reshape(n, c, -1)[:, :, g]            # [N, C, P, K]
        wins = torch.where(torch.as_tensor(valid, device=a.device), wins,
                           _lowest(a.dtype))
        arg = wins.argmax(-1)                          # the first maximum
        vals = wins.gather(-1, arg.unsqueeze(-1)).squeeze(-1)
        mask = g[torch.arange(g.shape[0], device=a.device), arg]
        return (vals.reshape(n, c, *out_sp),
                mask.reshape(n, c, *out_sp).to(torch.int32))

    return apply_op(f, x, op_name=op_name)


def _max_unpool(x, indices, kernel, stride, padding, output_size, nd,
                op_name):
    k = _tuple(kernel, nd)
    s = _tuple(stride if stride is not None else kernel, nd)
    p = _tuple(padding, nd)

    def f(a, idx):
        n, c, *in_sp = a.shape
        if output_size is not None:
            out_sp = list(_tuple(output_size, nd))
        else:
            out_sp = [(in_sp[i] - 1) * s[i] - 2 * p[i] + k[i]
                      for i in range(nd)]
        ii = idx.reshape(n, c, -1).long()
        # one update wins each position, as in JAX's scatter: only the
        # winner of duplicate indices (overlapping windows) is written
        # and takes the gradient
        ids = torch.arange(1, ii.shape[-1] + 1,
                           device=a.device).expand_as(ii)
        size = (n, c, int(np.prod(out_sp)))
        win = torch.zeros(size, dtype=torch.long, device=a.device) \
            .scatter_reduce(2, ii, ids, "amax")
        vals = torch.where(win.gather(2, ii) == ids, a.reshape(n, c, -1),
                           0)
        flat = torch.zeros(size, dtype=a.dtype, device=a.device) \
            .scatter_add(2, ii, vals)
        return flat.reshape(n, c, *out_sp)

    return apply_op(f, x, indices, op_name=op_name)


def _trim_output_size(output_size, nd):
    """Both the spatial form [*spatial] and the full form [N, C,
    *spatial] the reference allows."""
    if output_size is not None and len(output_size) == nd + 2:
        return list(output_size)[2:]
    return output_size


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       _trim_output_size(output_size, 1), 1, "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       _trim_output_size(output_size, 2), 2, "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       _trim_output_size(output_size, 3), 3, "max_unpool3d")


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """Power-average pooling: ``(Σ x^p)^(1/p)``."""
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 1,
                    data_format, ceil_mode, "lp_pool1d")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 2,
                    data_format, ceil_mode, "lp_pool2d")


def _lp_pool(x, p, kernel, stride, padding, nd, data_format, ceil_mode,
             op_name):
    p = float(p)
    if p == float("inf"):
        return _pool(x, kernel, stride, padding, nd, data_format, "max",
                     op_name, ceil_mode)
    n_k = float(np.prod(_tuple(kernel, nd)))
    # (Σ_w x^p)^(1/p) = (mean · count)^(1/p): the sum path
    xp = apply_op(lambda a: torch.pow(a, p), x, op_name=f"{op_name}_pow")
    pooled = _pool(xp, kernel, stride, padding, nd, data_format, "mean",
                   op_name, ceil_mode, exclusive=False)
    return apply_op(lambda a: torch.pow(a * n_k, 1.0 / p), pooled,
                    op_name=f"{op_name}_root")


def _fractional_starts(n_in, n_out, u):
    alpha = n_in / n_out
    starts = np.ceil(alpha * (np.arange(n_out) + u)).astype(np.int64) - 1
    ends = np.ceil(alpha * (np.arange(n_out) + 1 + u)).astype(np.int64) - 1
    return np.clip(starts, 0, n_in - 1), np.clip(ends, 1, n_in)


def _fractional_draw() -> float:
    """``u`` in (0, 1) from a host key of the port's key stream: the
    windows are host-static, so the draw is a counted host draw."""
    u = float(_random.uniform((), dtype=torch.float64,
                              key=_random.host_key()))
    return float(np.clip(u, 1e-6, 1.0 - 1e-6))


def _fractional_max_pool(x, output_size, kernel_size, random_u, return_mask,
                         nd, op_name):
    """Graham (2015): windows ``[ceil(α(i+u))−1, ceil(α(i+1+u))−1)`` per
    axis; ``kernel_size`` overrides the window length when given."""
    if random_u is None:
        u = _fractional_draw()
    else:
        u = float(random_u)
        if not 0.0 < u < 1.0:
            raise ValueError(f"random_u must be in (0, 1), got {u}")
    os = _tuple(output_size, nd)
    ks = _tuple(kernel_size, nd) if kernel_size is not None else None

    def gathered(cur, axis, st, en):
        """``cur``'s windows on ``axis`` as a new axis after it, entries
        past a window's end at the lowest value."""
        maxw = int((en - st).max())
        rng = st[:, None] + np.arange(maxw)[None, :]
        gidx = np.minimum(rng, cur.shape[axis] - 1)
        valid = rng < en[:, None]
        g = cur.index_select(axis, torch.as_tensor(
            gidx.reshape(-1), device=cur.device))
        g = g.reshape(cur.shape[:axis] + (len(st), maxw)
                      + cur.shape[axis + 1:])
        vshape = [1] * g.dim()
        vshape[axis], vshape[axis + 1] = valid.shape
        return g, torch.as_tensor(valid, device=cur.device).reshape(vshape)

    def f(a):
        spatial = a.shape[2:]
        tables = []
        for d in range(nd):
            n_in, n_out = spatial[d], os[d] if os[d] else spatial[d]
            st, en = _fractional_starts(n_in, n_out, u)
            if ks is not None:
                en = np.minimum(st + ks[d], n_in)
            tables.append((st, en))
        low = _lowest(a.dtype)
        cur = a
        for d in range(nd):
            g, valid = gathered(cur, 2 + d, *tables[d])
            cur = torch.where(valid, g, low).amax(3 + d)
        if not return_mask:
            return cur
        # the flat argmax indices, carried through the same per-axis chain
        vals = a
        idx = torch.arange(int(np.prod(spatial)), device=a.device).reshape(
            spatial).expand(a.shape)
        for d in range(nd):
            gv, valid = gathered(vals, 2 + d, *tables[d])
            gi, _ = gathered(idx, 2 + d, *tables[d])
            gv = torch.where(valid, gv, low)
            arg = gv.argmax(3 + d, keepdim=True)
            vals = gv.gather(3 + d, arg).squeeze(3 + d)
            idx = gi.gather(3 + d, arg).squeeze(3 + d)
        return cur, idx.to(torch.int32)

    return apply_op(f, x, op_name=op_name)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_max_pool(x, output_size, kernel_size, random_u,
                                return_mask, 2, "fractional_max_pool2d")


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_max_pool(x, output_size, kernel_size, random_u,
                                return_mask, 3, "fractional_max_pool3d")
