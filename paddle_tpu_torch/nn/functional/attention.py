"""Attention functions of the port.

:func:`sdpa_reference` is the PyTorch port of the JAX package's numeric
oracle ``_sdpa_xla`` (``paddle_tpu/ops/pallas/flash_attention.py``),
without dropout; the Llama model's masked and cached paths use it.
:func:`scaled_dot_product_attention` and :func:`flash_attention` are the
paddle entries (``paddle_tpu/nn/functional/attention.py``): a call
without a mask goes to the flash-attention kernels
(``ops.kernels.flash_attention``, their plain versions on the CPU), a
call with a mask to :func:`sdpa_reference`, as the JAX code routes
them. Attention dropout is kernel K5 of the roadmap and raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.kernels.flash_attention import flash_attention as _flash

__all__ = ["sdpa_reference", "scaled_dot_product_attention",
           "flash_attention"]

_NEG_INF = -1e30


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention in the ``[B, L, H, D]`` layout. ``mask`` is
    additive, broadcast against ``[B, H, Lq, Lk]`` logits. ``Lq < Lk``
    (KV-cache decode) offsets the causal diagonal. Logits and softmax
    run in f32; the probabilities are cast back to q's dtype before the
    PV product, as in the JAX oracle."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt).float() * s
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((ql, kl), dtype=torch.bool,
                        device=q.device).tril(kl - ql)
        logits = torch.where(cm, logits, _NEG_INF)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None):
    """Layout ``[batch, seq, heads, head_dim]``, the paddle API. Dropout
    applies only in training (``training=False`` turns it off)."""
    drop = dropout_p if training else 0.0
    if attn_mask is None:
        return _flash(query, key, value, causal=is_causal, dropout_p=drop)
    if drop > 0.0:
        raise NotImplementedError(
            "attention dropout (kernel K5 and the masked sdpa's dropout) "
            "is not ported yet; call with dropout_p=0")
    return sdpa_reference(query, key, value, causal=is_causal,
                          mask=attn_mask.float())


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    training: bool = True, name=None):
    """The paddle ``flash_attention``: ``(out, None)``."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None
