"""Gradient clipping strategies.

The port of ``paddle_tpu/utils/clip_grad.py``. A clip strategy is
described by a static, hashable *spec* (:func:`clip_spec`), and
:func:`clip_by_spec` is the one numeric definition of each strategy
over raw gradient tensors: the classes' ``__call__`` and the optimizer
loop run it, and the fused optimizer step's kernels
(``ops/kernels/multi_tensor.py``) do the same arithmetic on the card.

Numerics, as the JAX package's: norms are f32 sums of squares of the
f32 gradients, the global norm the sum of the per-tensor ones in
parameter order; a scale multiplies the f32 gradient and the product is
rounded back to the gradient's dtype (``(g * s).astype(g.dtype)``); a
value clip clamps (NaN stays NaN). Every division is a true f32
division of two tensors (a Python float divided by a tensor would be a
reciprocal times the float in PyTorch, which rounds differently).
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_spec",
           "clip_by_spec", "global_norm_scale", "global_scale",
           "tensor_scale", "sum_of_squares", "scale_grad", "clamp_grad"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


# -- pure functional core ---------------------------------------------------

def clip_spec(clip, exact=True):
    """Static description of a known clip strategy: ``()`` for None,
    a hashable tuple for the three in-tree strategies, ``None`` for an
    unrecognized clip object (callers fall back to calling it).

    ``exact=True`` (the fused optimizer's gate) matches only the exact
    in-tree classes — a subclass may override ``__call__`` and must go
    through it. ``exact=False`` (the classes' own ``__call__``) matches
    subclasses too."""
    if clip is None:
        return ()
    match = ((lambda c: type(clip) is c) if exact
             else (lambda c: isinstance(clip, c)))
    if match(ClipGradByGlobalNorm):
        return ("global_norm", float(clip.clip_norm))
    if match(ClipGradByNorm):
        return ("norm", float(clip.clip_norm))
    if match(ClipGradByValue):
        return ("value", float(clip.min), float(clip.max))
    return None


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device, filled on the device (no
    host-to-device copy, so no sync)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """``sum(square(g.f32))``, 0-d f32."""
    return torch.sum(torch.square(g.float()))


def global_scale(global_norm: torch.Tensor, clip_norm) -> torch.Tensor:
    """The ClipGradByGlobalNorm scale ``cn / max(norm, cn)``."""
    cn = _full(global_norm, clip_norm)
    return torch.div(cn, torch.maximum(global_norm, cn))


def global_norm_scale(grads, clip_norm):
    """:func:`global_scale` of the global norm: the square root of the
    per-tensor sums of squares added in parameter order (a Python
    ``sum``, as the JAX package's)."""
    return global_scale(torch.sqrt(sum(sum_of_squares(g) for g in grads)),
                        clip_norm)


def tensor_scale(sumsq: torch.Tensor, clip_norm) -> torch.Tensor:
    """The ClipGradByNorm scale of one tensor from its sum of squares,
    ``min(cn / max(norm, 1e-12), 1)``."""
    norm = torch.sqrt(sumsq)
    return torch.clamp(torch.div(_full(norm, clip_norm),
                                 torch.clamp(norm, min=1e-12)), max=1.0)


def scale_grad(g: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``(g.f32 * s)`` rounded back to g's dtype."""
    return (g.float() * s).to(g.dtype)


def clamp_grad(g: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``clip(g, lo, hi)`` with f32 bounds, rounded back to g's dtype."""
    return torch.clamp(g.float(), lo, hi).to(g.dtype)


def clip_by_spec(spec, grads):
    """Apply a ``clip_spec`` to a list of raw gradient tensors."""
    if not spec or not grads:
        return grads
    kind = spec[0]
    if kind == "value":
        _, lo, hi = spec
        return [clamp_grad(g, lo, hi) for g in grads]
    if kind == "norm":
        _, cn = spec
        return [scale_grad(g, tensor_scale(sum_of_squares(g), cn))
                for g in grads]
    _, cn = spec  # global_norm
    s = global_norm_scale(grads, cn)
    return [scale_grad(g, s) for g in grads]


def _apply_class_clip(clip, params_grads):
    """Eager class -> pure core plumbing, preserving None-grad slots."""
    spec = clip_spec(clip, exact=False)
    idx = [i for i, (_, g) in enumerate(params_grads) if g is not None]
    clipped = clip_by_spec(spec, [params_grads[i][1] for i in idx])
    out = list(params_grads)
    for i, c in zip(idx, clipped):
        out[i] = (params_grads[i][0], c)
    return out


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return _apply_class_clip(self, params_grads)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        return _apply_class_clip(self, params_grads)


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        if all(g is None for _, g in params_grads):
            return params_grads
        return _apply_class_clip(self, params_grads)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """torch-style helper (paddle.nn.utils): scales every ``p.grad`` by
    ``min(max_norm / max(total, 1e-6), 1)`` and returns the total norm.
    ``norm_type=inf`` takes the largest ``|g|`` in the gradients' dtype,
    as the JAX package does."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([torch.max(torch.abs(p.grad))
                             for p in params]).max()
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(p.grad.float()) ** norm_type)
             for p in params])) ** (1.0 / norm_type)
    scale = torch.clamp(torch.div(torch.full_like(total, max_norm),
                                  torch.clamp(total, min=1e-6)), max=1.0)
    for p in params:
        p.grad = scale_grad(p.grad, scale)
    return total
