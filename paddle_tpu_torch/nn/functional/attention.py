"""Attention functions of the port.

:func:`sdpa_reference` is the PyTorch port of the JAX package's numeric
oracle ``_sdpa_xla`` (``paddle_tpu/ops/pallas/flash_attention.py``);
its dropout draws the flash kernels' Philox keep mask from the same
seed, so a masked call and a kernel call with one seed drop the same
pairs. :func:`scaled_dot_product_attention`, :func:`flash_attention`,
:func:`flash_attn_qkvpacked`, :func:`flash_attn_varlen_qkvpacked` and
:func:`flashmask_attention` are the paddle entries
(``paddle_tpu/nn/functional/attention.py``): a call without a mask goes
to the flash-attention kernels whatever the query and key lengths
(``ops.kernels.flash_attention``, their plain versions on the CPU) with
a key drawn on the inputs' device from the port's key stream
(``core.random.next_key``: no host read, so a CUDA graph that holds the
call drops afresh on every replay) when it drops; a call with a mask
goes to :func:`sdpa_reference`, as the JAX code routes them (FlashMask's
column encoding becomes such a mask, as in JAX); packed qkv is read as
strided views; packed varlen sequences go to the segment-masked
kernels. The entries take Tensors or torch tensors
(``core.autograd.apply_op``) and return the same kind.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core import random as _random
from ...core.autograd import apply_op
from ...ops.kernels.flash_attention import flash_attention as _flash
from ...ops.kernels.flash_attention import (flash_attention_segmented,
                                            flash_dropout_keep_mask)

__all__ = ["sdpa_reference", "scaled_dot_product_attention",
           "flash_attention", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "flashmask_attention"]

_NEG_INF = -1e30


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   mask: Optional[torch.Tensor] = None,
                   dropout_p: float = 0.0,
                   seed: Optional[int] = None) -> torch.Tensor:
    """Plain attention in the ``[B, L, H, D]`` layout. ``mask`` is
    additive, broadcast against ``[B, H, Lq, Lk]`` logits. ``Lq < Lk``
    (KV-cache decode) offsets the causal diagonal. Logits and softmax
    run in f32; the probabilities are cast back to q's dtype before the
    PV product, as in the JAX oracle. ``dropout_p > 0`` keeps the pairs
    of :func:`flash_dropout_keep_mask` for ``seed`` and divides them by
    ``1 - p`` in q's dtype; ``dropout_p >= 1`` returns zeros."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    if dropout_p >= 1.0:
        # everything dropped: zeros with zero (not NaN) gradients
        return torch.where(torch.zeros_like(q, dtype=torch.bool), q, 0.0)
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
    if dropout_p > 0.0:
        if seed is None:
            raise ValueError("sdpa_reference dropout needs a seed")
        B, H, Lq, Lk = probs.shape
        keep = flash_dropout_keep_mask(seed, B, H, Lq, dropout_p, q.device,
                                       Lk)
        inv = torch.tensor(1.0 - dropout_p, dtype=q.dtype).item()
        probs = torch.where(keep, probs / inv, 0.0).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None):
    """Layout ``[batch, seq, heads, head_dim]``, the paddle API. Dropout
    applies only in training (``training=False`` turns it off)."""
    # the JAX entry's names: its flash path is "flash_attention"
    flash = attn_mask is None and (dropout_p if training else 0.0) < 1.0
    return apply_op(_sdpa, query, key, value, attn_mask,
                    dropout_p=dropout_p, is_causal=is_causal,
                    training=training,
                    op_name="flash_attention" if flash else "sdpa")


def _sdpa(query, key, value, attn_mask, dropout_p, is_causal, training):
    drop = dropout_p if training else 0.0
    seed = _random.next_key(query.device) if 0.0 < drop < 1.0 else None
    if attn_mask is None and drop < 1.0:
        return _flash(query, key, value, causal=is_causal, dropout_p=drop,
                      seed=seed)
    mask = attn_mask.float() if attn_mask is not None else None
    return sdpa_reference(query, key, value, causal=is_causal, mask=mask,
                          dropout_p=drop, seed=seed)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    training: bool = True, name=None):
    """The paddle ``flash_attention``: ``(out, None)``."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    return out, None


def flash_attn_qkvpacked(qkv, dropout: float = 0.0, causal: bool = False,
                         return_softmax: bool = False,
                         fixed_seed_offset=None, rng_name: str = "",
                         training: bool = True, name=None):
    """Packed ``qkv [B, L, 3, H, D]``: q, k and v are its strided views,
    read in place by the flash kernels. Returns ``(out, None)``."""
    q, k, v = apply_op(lambda p: (p[:, :, 0], p[:, :, 1], p[:, :, 2]), qkv,
                       op_name="qkv_unpack")
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout: float = 0.0,
                                causal: bool = False,
                                return_softmax: bool = False,
                                fixed_seed_offset=None, rng_name: str = "",
                                varlen_padded: bool = True,
                                training: bool = True, name=None):
    """Varlen packed attention: ``qkv [total, 3, H, D]``, sequences packed
    along dim 0 and delimited by ``cu_seqlens`` (``[n + 1]``, from 0 to
    total); attention never crosses a sequence boundary. Returns
    ``([total, H, D], None)``.

    ``cu_seqlens`` become per-token segment ids (the number of
    boundaries at or before each token) for the segment-masked flash
    kernels; q, k and v are strided views of ``qkv``, read in place.
    ``max_seqlen_*`` and ``varlen_padded`` are accepted for signature
    parity and unused. ``dropout`` is accepted and unused, as the JAX
    entry does. A ``cu_seqlens_k`` that differs from ``cu_seqlens_q``
    raises: packed qkv has one set of boundaries."""
    return apply_op(_varlen_qkvpacked, qkv, cu_seqlens_q, cu_seqlens_k,
                    scale=scale, causal=causal), None


def _varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, scale, causal):
    if cu_seqlens_k is not None and cu_seqlens_k is not cu_seqlens_q:
        cq, ck = torch.as_tensor(cu_seqlens_q), torch.as_tensor(cu_seqlens_k)
        if cq.shape != ck.shape or not torch.equal(cq.to(ck.device), ck):
            raise ValueError(
                "flash_attn_varlen_qkvpacked: cu_seqlens_k differs from "
                "cu_seqlens_q, but packed qkv shares one set of sequence "
                "boundaries — masking would be wrong. Use the unpacked "
                "varlen API for cross-attention layouts.")
    total = qkv.shape[0]
    cu = torch.as_tensor(cu_seqlens_q, device=qkv.device).long()
    seg = torch.searchsorted(
        cu[1:], torch.arange(total, device=qkv.device), right=True)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]           # [total, H, D]
    out = flash_attention_segmented(q[None], k[None], v[None],
                                    seg[None].to(torch.int32), causal, scale)
    return out[0]


def _flashmask(rows, cols, se, causal: bool, window_size):
    """The pairs FlashMask's column encoding ``se [B, H|1, Lk, C]`` masks
    (True = masked), ``[B, H|1, Lq, Lk]``: causal C = 1 masks rows >=
    LTS, C = 2 rows in [LTS, LTE); bidirectional C = 2 rows >= LTS or <
    UTE, C = 4 rows in [LTS, LTE) or [UTS, UTE); a sliding window
    (left, right) masks keys outside [i - left, i + right]."""
    c = se.shape[-1]
    col = [se[..., i][:, :, None, :] for i in range(c)]
    if causal:
        if c == 1:
            masked = rows >= col[0]
        elif c == 2:
            masked = (rows >= col[0]) & (rows < col[1])
        else:
            raise ValueError(
                f"causal flashmask expects 1 or 2 columns, got {c}")
    elif c == 2:
        masked = (rows >= col[0]) | (rows < col[1])
    elif c == 4:
        masked = ((rows >= col[0]) & (rows < col[1])) | \
            ((rows >= col[2]) & (rows < col[3]))
    else:
        raise ValueError(
            f"non-causal flashmask expects 2 or 4 columns, got {c}")
    if window_size is not None:
        left, right = (window_size if isinstance(window_size, (tuple, list))
                       else (window_size, window_size))
        masked = masked | (cols < rows - int(left)) | \
            (cols > rows + int(right))
    return masked


def flashmask_attention(query, key, value, startend_row_indices,
                        dropout: float = 0.0, causal: bool = False,
                        window_size=None, return_softmax_lse: bool = False,
                        return_seed_offset: bool = False,
                        fixed_seed_offset=None, rng_name: str = "",
                        training: bool = True, name=None):
    """FlashMask: attention under a column-wise sparse mask,
    ``startend_row_indices [B, H|1, Lk, C]`` (:func:`_flashmask`),
    expanded to an additive mask (-1e30 where masked) for
    :func:`sdpa_reference`, as the JAX entry does. ``dropout`` is
    accepted and unused, as there; the lse and seed extras are
    ``None``."""
    def f(q, k, v, se):
        lq, lk = q.shape[1], k.shape[1]
        rows = torch.arange(lq, device=q.device).reshape(1, 1, lq, 1)
        cols = torch.arange(lk, device=q.device).reshape(1, 1, 1, lk)
        masked = _flashmask(rows, cols, se.to(torch.int32), causal,
                            window_size)
        mask = torch.where(masked, _NEG_INF, 0.0).to(torch.float32)
        return sdpa_reference(q, k, v, causal=causal, mask=mask)

    out = apply_op(f, query, key, value, startend_row_indices,
                   op_name="flashmask_attention")
    if return_softmax_lse or return_seed_offset:
        return (out, *([None] * (int(return_softmax_lse) +
                                 int(return_seed_offset))))
    return out
