"""Normalization functionals of the port: ``layer_norm``, ``rms_norm``,
``batch_norm``, ``group_norm``, ``instance_norm`` and
``local_response_norm``.

The port of ``paddle_tpu/nn/functional/norm.py`` ``layer_norm``: mean
and (biased) variance over the trailing ``normalized_shape`` axes in
f32, ``(x - mean) * rsqrt(var + eps) * weight + bias`` in f32, cast
back to the input dtype. ``torch.nn.functional.layer_norm`` computes
exactly that when input and parameters share a dtype (it accumulates
bf16 inputs in f32 and rounds the output once); with mixed dtypes
everything is taken to f32 first. ``rms_norm`` (the Llama-family
norm): ``x * rsqrt(mean(x²) + eps) * weight`` over the last axis in
f32, cast back. Each takes Tensors or torch tensors
(``core.autograd.apply_op``) and returns the same kind.

``batch_norm`` ports the JAX package's math, not cuDNN's (the JAX
package runs it in ``jnp`` under a custom VJP; there is no Pallas
kernel). Training (:class:`BatchNormTrain`):

- the forward takes the statistics in one pass anchored on the running
  mean (``d = x − anchor``: mean of ``d`` and of ``d²``), the variance
  ``E[d²] − E[d]²``; when that cancels badly for some channel
  (``any(s1² > 1e4·v + 1e-6)``) an exact-centred variance over the
  batch rows ``x[::max(1, N // 8)]`` replaces it. The JAX package
  branches with ``lax.cond``; here both values are computed and
  ``torch.where`` on the device picks one: no host read, no Python
  branch on a device value, so a CUDA graph can hold the step;
- the affine folds into one f32 ``[C]`` scale and shift applied in the
  input dtype;
- the backward is the closed form: one pass for ``Σg`` and ``Σg·x``,
  then ``dx = A·g + B·x + C`` with per-channel A, B, C (the cotangents
  of the mean and unbiased variance outputs included), zero for the
  anchor.

The running statistics follow Paddle's momentum, ``new = m·old + (1 −
m)·batch`` with the unbiased variance, in the buffers' dtype (a
``bfloat16()`` model's bf16 buffers round each step, the scalars taken
to that dtype first as JAX's weak scalars are), written in place into
the caller's tensors: a CUDA graph replays its writes into the
addresses it captured. ``training=False`` and ``use_global_stats`` use
the running statistics through the same folded scale and shift; a
running mean that is not a tensor anchors at zero and is not updated.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.autograd import apply_op
from ...core.tensor import unwrap

__all__ = ["layer_norm", "rms_norm", "batch_norm", "group_norm",
           "instance_norm", "local_response_norm", "BatchNormTrain"]


def _layer_norm(x, weight, bias, shape, epsilon):
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        return torch.nn.functional.layer_norm(x, shape, weight, bias,
                                              epsilon)
    f32 = [t.float() if t is not None else None for t in (weight, bias)]
    return torch.nn.functional.layer_norm(x.float(), shape, *f32,
                                          epsilon).to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-05, name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return apply_op(_layer_norm, x, weight, bias,
                    shape=list(normalized_shape), epsilon=epsilon,
                    op_name="layer_norm")


def _rms_norm(x, weight, epsilon):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def rms_norm(x, weight=None, epsilon: float = 1e-6, name=None):
    return apply_op(_rms_norm, x, weight, epsilon=epsilon,
                    op_name="rms_norm")


def _channel_shape(ndim, ch, c):
    shape = [1] * ndim
    shape[ch] = c
    return shape


class BatchNormTrain(torch.autograd.Function):
    """``(y, mean, unbiased var) = f(x, w, b, anchor)`` over ``axes``
    (every axis but the channel's), the port of the JAX ``_bn_train``
    with its custom VJP (``paddle_tpu/nn/functional/norm.py``)."""

    @staticmethod
    def forward(ctx, x, w, b, anchor, ch: int, eps: float):
        axes = tuple(i for i in range(x.dim()) if i != ch)
        n = x.numel() // x.shape[ch]
        shape = _channel_shape(x.dim(), ch, x.shape[ch])
        a32 = anchor.detach().float().reshape(shape)
        d = x.float() - a32
        s1 = d.mean(axes)
        s2 = d.square().mean(axes)
        m = a32.reshape(-1) + s1
        v_fast = torch.clamp_min(s2 - s1 * s1, 0.0)
        # the cold-anchor repair, selected on the device
        xs = x[::max(1, x.shape[0] // 8)].float()
        v_exact = (xs - m.reshape(shape)).square().mean(axes)
        bad = torch.any(s1 * s1 > 1e4 * v_fast + 1e-6)
        v = torch.where(bad, v_exact, v_fast)
        scale = torch.rsqrt(v + eps) * w.float()
        shift = b.float() - m * scale
        y = x * scale.to(x.dtype).reshape(shape) + \
            shift.to(x.dtype).reshape(shape)
        v_unb = v * (n / max(n - 1, 1))
        ctx.save_for_backward(x, w, m, v_unb)
        ctx.ch, ctx.eps = ch, eps
        ctx.set_materialize_grads(False)
        return y, m, v_unb

    @staticmethod
    def backward(ctx, g, g_m, g_v):
        x, w, m, v_unb = ctx.saved_tensors
        ch = ctx.ch
        axes = tuple(i for i in range(x.dim()) if i != ch)
        n = x.numel() // x.shape[ch]
        nf = float(n)
        shape = _channel_shape(x.dim(), ch, x.shape[ch])
        v = v_unb * (max(n - 1, 1) / n)
        inv = torch.rsqrt(v + ctx.eps)
        if g is None:
            g = torch.zeros_like(x)
        g32 = g.float()
        dbeta = g32.sum(axes)
        sum_gx = (g32 * x.float()).sum(axes)
        dgamma = inv * (sum_gx - m * dbeta)
        w32 = w.float()
        a_ = w32 * inv
        b_ = -w32 * inv * inv * dgamma / nf
        c_ = -a_ * dbeta / nf - b_ * m
        if g_m is not None:
            c_ = c_ + g_m / nf
        if g_v is not None:
            coef = 2.0 / max(n - 1, 1)
            b_ = b_ + g_v * coef
            c_ = c_ - g_v * coef * m
        dx = (g * a_.to(g.dtype).reshape(shape)
              + x * b_.to(x.dtype).reshape(shape)
              + c_.to(x.dtype).reshape(shape))
        return (dx, dgamma.to(w.dtype), dbeta.to(w.dtype), None, None,
                None)


def _weak(value: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX takes it beside an array of ``dtype``: a
    weak scalar, rounded to that dtype (to nearest even, through f32)
    on the host, without a tensor."""
    v = np.float32(value)
    if dtype == torch.bfloat16:
        bits = int(v.view(np.uint32))
        bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
        return float(np.uint32(bits & 0xFFFFFFFF).view(np.float32))
    if dtype == torch.float16:
        return float(np.float16(v))
    return float(v)


@torch.no_grad()
def _update_running(buf, batch, momentum):
    """``buf = m·buf + (1 − m)·batch`` in ``buf``'s dtype, in place."""
    buf.mul_(_weak(momentum, buf.dtype)).add_(
        batch.to(buf.dtype) * _weak(1 - momentum, buf.dtype))


def _bn_train(x, weight, bias, *, running_mean, running_var, ch, momentum,
              epsilon):
    c = x.shape[ch]
    w = weight if weight is not None else torch.ones(
        c, dtype=torch.float32, device=x.device)
    b = bias if bias is not None else torch.zeros(
        c, dtype=torch.float32, device=x.device)
    anchor = running_mean if isinstance(running_mean, torch.Tensor) else \
        torch.zeros(c, dtype=torch.float32, device=x.device)
    y, m, v_unb = BatchNormTrain.apply(x, w, b, anchor, ch, epsilon)
    if isinstance(running_mean, torch.Tensor):
        _update_running(running_mean, m.detach(), momentum)
    if isinstance(running_var, torch.Tensor):
        _update_running(running_var, v_unb.detach(), momentum)
    return y


def _bn_apply(a, m, v, weight, bias, *, ch, epsilon):
    """The eval path: ``a · scale + shift`` with the affine and the
    statistics folded into f32 ``[C]`` vectors, applied in ``a``'s
    dtype."""
    shape = _channel_shape(a.dim(), ch, a.shape[ch])
    scale = torch.rsqrt(v.float() + epsilon)
    if weight is not None:
        scale = scale * weight.float()
    shift = -m.float() * scale
    if bias is not None:
        shift = shift + bias.float()
    return a * scale.to(a.dtype).reshape(shape) + \
        shift.to(a.dtype).reshape(shape)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-05, data_format: str = "NCHW",
               use_global_stats=None, name=None):
    """Batch norm over every axis but the channel's (axis 1 for ``NC*``
    layouts, the last otherwise); in training with batch statistics the
    running statistics (Tensors or torch tensors) are updated in
    place."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    if training and not use_global_stats:
        return apply_op(_bn_train, x, weight, bias,
                        running_mean=unwrap(running_mean),
                        running_var=unwrap(running_var), ch=ch,
                        momentum=momentum, epsilon=epsilon,
                        op_name="batch_norm")
    return apply_op(lambda a, m, v, w, b: _bn_apply(
        a, m, v, w, b, ch=ch, epsilon=epsilon), x, running_mean,
        running_var, weight, bias, op_name="batch_norm")


def _group_norm(a, weight, bias, *, groups, epsilon, channel_last):
    if channel_last:
        a_m = a.movedim(-1, 1)
    else:
        a_m = a
    n, c = a_m.shape[:2]
    spatial = a_m.shape[2:]
    g = a_m.reshape(n, groups, c // groups, *spatial).float()
    axes = tuple(range(2, g.dim()))
    mean = g.mean(axes, keepdim=True)
    var = g.var(axes, unbiased=False, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(n, c, *spatial)
    shape = [1, c] + [1] * len(spatial)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    out = out.to(a.dtype)
    return out.movedim(1, -1) if channel_last else out


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-05,
               data_format="NCHW", name=None):
    return apply_op(_group_norm, x, weight, bias, groups=num_groups,
                    epsilon=epsilon,
                    channel_last=not data_format.startswith("NC"),
                    op_name="group_norm")


def _instance_norm(a, weight, bias, *, eps):
    axes = tuple(range(2, a.dim()))
    af = a.float()
    mean = af.mean(axes, keepdim=True)
    var = af.var(axes, unbiased=False, keepdim=True)
    out = (af - mean) * torch.rsqrt(var + eps)
    shape = [1, a.shape[1]] + [1] * (a.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(a.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Per-sample, per-channel statistics over the spatial axes (the
    running statistics are accepted and unused, as in the JAX
    function)."""
    return apply_op(_instance_norm, x, weight, bias, eps=eps,
                    op_name="instance_norm")


def _lrn(a, *, size, alpha, beta, k, ch):
    sq = a.float().square().movedim(ch, -1)
    c = sq.shape[-1]
    padded = torch.nn.functional.pad(sq, (size // 2, (size - 1) // 2))
    acc = torch.stack([padded[..., i:i + c] for i in range(size)]).sum(0)
    acc = acc.movedim(-1, ch)
    # the window is averaged, as the reference's avg_pool over squares
    return (a / torch.pow(k + alpha * acc / size, beta)).to(a.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    return apply_op(_lrn, x, size=size, alpha=alpha, beta=beta, k=k, ch=ch,
                    op_name="local_response_norm")
