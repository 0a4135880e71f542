"""The fused functionals of the port (``paddle_tpu/incubate/nn/
functional.py``): ``fused_linear``, ``fused_dropout_add``,
``fused_rms_norm``, ``fused_layer_norm``, ``fused_bias_act``, ``swiglu``,
``fused_rotary_position_embedding`` and
``fused_layernorm_residual_dropout``, each through
``core.autograd.apply_op`` under the JAX package's op name and with its
arithmetic. As there, "fused" names the API: each is a composition of
plain torch ops (the JAX package leaves the fusion to XLA). Dropout is
the port's hash dropout (``nn.functional.dropout``), so its bits are not
the JAX package's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.autograd import apply_op
from ...core.tensor import Tensor
from ...nn.functional.common import dropout
from ...nn.functional.norm import layer_norm, rms_norm

__all__ = [
    "fused_linear", "fused_dropout_add", "fused_rms_norm",
    "fused_layer_norm", "fused_bias_act", "swiglu",
    "fused_rotary_position_embedding",
    "fused_layernorm_residual_dropout",
]


def _d(x) -> torch.Tensor:
    return x._t if isinstance(x, Tensor) else torch.as_tensor(x)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x W + b`` (``W`` ``[in, out]``, or ``[out, in]`` with
    ``transpose_weight``)."""
    def f(a, w, *b):
        out = a @ (w.t() if transpose_weight else w)
        return out + b[0] if b else out
    args = [x, weight] + ([bias] if bias is not None else [])
    return apply_op(f, *args, op_name="fused_linear")


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """``dropout(x) + y`` (paddle's modes; ``p >= 1`` drops all of x)."""
    if training and p >= 1.0:
        return apply_op(lambda a, b: (a * 0 + b).to(b.dtype), x, y,
                        op_name="fused_dropout_add")
    dx = dropout(x, p, training=training, mode=mode)
    return apply_op(lambda a, b: (a + b).to(b.dtype), dx, y,
                    op_name="fused_dropout_add")


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, name=None):
    out = rms_norm(x, norm_weight, epsilon)
    if norm_bias is not None:
        out = apply_op(lambda a, b: a + b, out, norm_bias, op_name="add")
    return out


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=1, name=None):
    shape = list(_d(x).shape[begin_norm_axis:])
    return layer_norm(x, shape, norm_weight, norm_bias, epsilon)


# gelu is the tanh form, as jax.nn.gelu's default
_ACTS = {"gelu": lambda a: TF.gelu(a, approximate="tanh"), "relu": torch.relu,
         "silu": TF.silu, "swiglu": None}


def fused_bias_act(x, bias=None, act_method="gelu", name=None):
    """``act(x + bias)``; ``swiglu`` is ``silu(u) · v`` of the two
    halves."""
    if act_method not in _ACTS:
        raise ValueError(f"unsupported act_method {act_method!r}")

    def f(a, *b):
        if b:
            a = a + b[0]
        if act_method == "swiglu":
            u, v = a.chunk(2, dim=-1)
            return TF.silu(u) * v
        return _ACTS[act_method](a)
    args = [x] + ([bias] if bias is not None else [])
    return apply_op(f, *args, op_name="fused_bias_act")


def swiglu(x, y=None, name=None):
    """``silu(x) · y``; without ``y`` the two halves of x."""
    if y is None:
        return apply_op(lambda a: TF.silu(a.chunk(2, -1)[0])
                        * a.chunk(2, -1)[1], x, op_name="swiglu")
    return apply_op(lambda a, b: TF.silu(a) * b, x, y, op_name="swiglu")


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """Rotary embedding of q (and k, v), ``[B, L, H, D]``: from the
    ``sin`` / ``cos`` tables (rows picked by ``position_ids``) or from
    the angles of positions 0 .. L - 1 (or ``position_ids``) at base
    10000; halves rotated (neox) or interleaved pairs."""
    qd = _d(q)
    _, l, _, d = qd.shape
    dev = qd.device
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=dev) / d))
    if sin is None or cos is None:
        if position_ids is not None:
            freqs = _d(position_ids).to(dev).float()[..., None] * inv
        else:
            freqs = torch.arange(l, dtype=torch.float32,
                                 device=dev)[None, :, None] * inv
        emb = torch.cat([freqs, freqs], -1) if use_neox_rotary_style \
            else freqs.repeat_interleave(2, dim=-1)
        s_bc, c_bc = emb.sin()[:, :, None, :], emb.cos()[:, :, None, :]
    else:
        sin_v = _d(sin).to(dev).reshape(-1, d)
        cos_v = _d(cos).to(dev).reshape(-1, d)
        if position_ids is not None:
            pid = _d(position_ids).to(dev).long()
            s_bc, c_bc = sin_v[pid][:, :, None, :], cos_v[pid][:, :, None, :]
        else:
            s_bc, c_bc = sin_v[None, :l, None, :], cos_v[None, :l, None, :]

    def rot(a):
        if use_neox_rotary_style:
            half = a.shape[-1] // 2
            return torch.cat([-a[..., half:], a[..., :half]], -1)
        x = a.reshape(a.shape[:-1] + (a.shape[-1] // 2, 2))
        return torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(a.shape)

    def f(a):
        a32 = a.float()
        return (a32 * c_bc.float() + rot(a32) * s_bc.float()).to(a.dtype)

    return tuple(apply_op(f, t, op_name="fused_rope") if t is not None
                 else None for t in (q, k, v))


def fused_layernorm_residual_dropout(x, residual, norm_weight=None,
                                     norm_bias=None, p=0.0, epsilon=1e-5,
                                     training=True, name=None):
    """``dropout(x) + residual``, then a layer norm over the last axis
    with f32 statistics. -> ``(out, dropout(x) + residual)``."""
    drop = p if training else 0.0
    if drop >= 1.0:
        x = apply_op(torch.zeros_like, x, op_name="zeros_like")
    elif drop > 0.0:
        x = dropout(x, drop, training=True)
    extras = [t for t in (norm_weight, norm_bias) if t is not None]

    def f(a, res, *rest):
        w = rest[0] if norm_weight is not None else None
        b = rest[-1] if norm_bias is not None else None
        summed = (a + res).to(res.dtype)
        s32 = summed.float()
        mu = s32.mean(-1, keepdim=True)
        var = s32.var(-1, keepdim=True, unbiased=False)
        out = (s32 - mu) / torch.sqrt(var + epsilon)
        if w is not None:
            out = out * w
        if b is not None:
            out = out + b
        return out.to(summed.dtype), summed

    return apply_op(f, x, residual, *extras,
                    op_name="fused_layernorm_residual_dropout")
