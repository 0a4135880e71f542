"""Vision functionals of the port: ``affine_grid``, ``grid_sample`` and
``temporal_shift``.

The port of ``paddle_tpu/nn/functional/vision.py``. Plain PyTorch: the
JAX functions are index arithmetic and gathers (no Pallas kernel), and
so are these. ``grid_sample`` is the JAX math, not
``torch.nn.functional.grid_sample``: each coordinate is unnormalised
(``align_corners`` both ways), folded by the padding mode (``border``
clips; ``reflection`` folds into ``[0, size - 1]`` with corners aligned,
else into ``[-½, size - ½]`` and then clips; ``zeros`` keeps it and
zeroes every corner that falls outside), then read at the rounded
point (``nearest``, half to even) or at the 2ᵈ corners weighted by
their fractions (``bilinear``, trilinear for a 5-D input) through one
flat gather a corner.
"""
from __future__ import annotations

import torch

from ...core.autograd import apply_op

__all__ = ["affine_grid", "grid_sample", "temporal_shift"]


def _axis_coords(n: int, align_corners: bool, dtype, device):
    if align_corners:
        return torch.linspace(-1.0, 1.0, n, dtype=dtype, device=device)
    step = 2.0 / n
    return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n, dtype=dtype,
                          device=device)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``theta [N, 2, 3]`` and ``out_shape [N, C, H, W]`` -> the sampling
    grid ``[N, H, W, 2]`` (``[N, 3, 4]`` and ``[N, C, D, H, W]`` ->
    ``[N, D, H, W, 3]``), last axis ``(x, y[, z])``."""
    if hasattr(out_shape, "tolist"):
        out_shape = out_shape.tolist()
    sizes = [int(v) for v in out_shape][2:]

    def f(th):
        axes = [_axis_coords(s, align_corners, torch.float32, th.device)
                for s in sizes]
        mesh = torch.meshgrid(*axes, indexing="ij")
        coords = torch.stack(list(reversed(mesh)) + [torch.ones_like(
            mesh[0])], dim=-1)
        return torch.einsum("...k,njk->n...j", coords,
                            th.float()).to(th.dtype)
    return apply_op(f, theta, op_name="affine_grid")


def _reflect(coord, lo: float, hi: float):
    """Fold ``coord`` into ``[lo, hi]`` by reflection at both ends."""
    rng = hi - lo
    if rng <= 0:
        return torch.zeros_like(coord)
    double = 2 * rng
    coord = torch.remainder(coord - lo, double).abs()
    return torch.where(coord > rng, double - coord, coord) + lo


def _fold(c, size: int, padding_mode: str, align_corners: bool):
    if padding_mode == "border":
        return c.clamp(0, size - 1)
    if padding_mode == "reflection":
        if align_corners:
            return _reflect(c, 0.0, float(size - 1))
        return _reflect(c, -0.5, size - 0.5).clamp(0, size - 1)
    return c


def _gather(a, idxs, spatial, zeros: bool):
    """``a [N, C, *spatial]`` at the integer points ``idxs`` (one
    ``[N, *out]`` tensor an axis) -> ``[N, C, *out]``; with ``zeros``
    the points outside read 0."""
    n, c = a.shape[:2]
    flat, valid, stride = None, None, 1
    for idx, size in reversed(list(zip(idxs, spatial))):
        if zeros:
            v = (idx >= 0) & (idx < size)
            valid = v if valid is None else valid & v
        term = idx.clamp(0, size - 1) * stride
        flat = term if flat is None else flat + term
        stride *= size
    out_shape = flat.shape[1:]
    vals = a.reshape(n, c, -1).gather(
        2, flat.reshape(n, 1, -1).expand(n, c, -1))
    vals = vals.reshape(n, c, *out_shape)
    if zeros:
        vals = torch.where(valid[:, None], vals, 0.0)
    return vals


def _grid_sample(a, g, *, mode, padding_mode, align_corners):
    nd = g.shape[-1]
    spatial = list(a.shape[2:])
    if len(spatial) != nd:
        raise ValueError(
            f"grid last dim {nd} does not match input rank {a.dim()}")
    g = g.float()
    coords = []
    for i in range(nd):
        size = spatial[nd - 1 - i]
        c = g[..., i]
        if align_corners:
            c = (c + 1) / 2 * (size - 1)
        else:
            c = ((c + 1) * size - 1) / 2
        coords.append(c)
    coords = coords[::-1]
    folded = [_fold(c, size, padding_mode, align_corners)
              for c, size in zip(coords, spatial)]
    zeros = padding_mode == "zeros"
    if mode == "nearest":
        idxs = [torch.round(c).long() for c in folded]
        return _gather(a, idxs, spatial, zeros).to(a.dtype)
    lows = [torch.floor(c) for c in folded]
    fracs = [c - lo for c, lo in zip(folded, lows)]
    lows = [lo.long() for lo in lows]
    out = None
    for corner in range(2 ** nd):
        idxs, w = [], None
        for d in range(nd):
            hi = (corner >> d) & 1
            idxs.append(lows[d] + hi)
            wd = fracs[d] if hi else 1.0 - fracs[d]
            w = wd if w is None else w * wd
        contrib = _gather(a, idxs, spatial, zeros) * w[:, None]
        out = contrib if out is None else out + contrib
    return out.to(a.dtype)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """``x [N, C, H, W]`` sampled at ``grid [N, Ho, Wo, 2]`` (``(x, y)``
    in ``[-1, 1]``); ``[N, C, D, H, W]`` with ``grid [..., 3]`` too."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode must be bilinear|nearest, "
                         f"got {mode}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"bad padding_mode {padding_mode}")
    return apply_op(_grid_sample, x, grid, mode=mode,
                    padding_mode=padding_mode, align_corners=align_corners,
                    op_name="grid_sample")


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM: of each clip's ``seg_num`` frames, the first
    ``shift_ratio`` of the channels take the previous frame's values, the
    next ``shift_ratio`` the following frame's (zeros past either end),
    the rest stay."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"bad data_format {data_format}")

    def f(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        nt, c, h, w = a.shape
        r = a.reshape(nt // seg_num, seg_num, c, h, w)
        c1 = int(c * shift_ratio)
        c2 = int(c * 2 * shift_ratio)
        padded = torch.nn.functional.pad(r, (0, 0, 0, 0, 0, 0, 1, 1))
        out = torch.cat([padded[:, :seg_num, :c1],
                         padded[:, 2:, c1:c2],
                         padded[:, 1:seg_num + 1, c2:]], dim=2)
        out = out.reshape(nt, c, h, w)
        if data_format == "NHWC":
            out = out.permute(0, 2, 3, 1)
        return out
    return apply_op(f, x, op_name="temporal_shift")

