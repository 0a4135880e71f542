"""Attention functions of the port.

:func:`sdpa_reference` is the PyTorch port of the JAX package's numeric
oracle ``_sdpa_xla`` (``paddle_tpu/ops/pallas/flash_attention.py``),
without dropout. The Llama model's cache-free forward uses it; the
flash-attention kernels come with the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["sdpa_reference"]

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
