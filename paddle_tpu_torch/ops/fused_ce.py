"""Memory-lean softmax cross-entropy for big-vocab LM heads.

The port of ``paddle_tpu/ops/fused_ce.py``, as a
``torch.autograd.Function``:

  forward  per sequence chunk (the largest divisor of L up to 256
           rows), the f32 logsumexp and the target logit — nothing
           ``[B, L, V]``-sized in f32; saves the logits the caller
           already holds, the labels and the ``[B, L]`` lse;
  backward per chunk, ``(softmax - onehot) * g / N`` written into the
           gradient in the logits' dtype, zero where the label is
           ``ignore_index``.

It is plain PyTorch (a loop of chunked reductions), as the JAX version
is a ``jnp`` loop and not a Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fused_softmax_ce_mean"]


def _chunks(seq_len: int, target: int = 256) -> int:
    """Largest chunk size <= target dividing seq_len."""
    for c in range(min(target, seq_len), 0, -1):
        if seq_len % c == 0:
            return c
    return seq_len


def _target_index(labels: torch.Tensor, vocab: int,
                  ignore_index: Optional[int]) -> torch.Tensor:
    idx = labels.long()
    if ignore_index is not None:
        idx = idx.clamp(0, vocab - 1)  # ignored labels may be -100
    return idx[..., None]


class _FusedSoftmaxCEMean(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, ignore_index):
        b, l, v = logits.shape
        c = _chunks(l)
        total = torch.zeros((), dtype=torch.float32, device=logits.device)
        lse = torch.empty((b, l), dtype=torch.float32, device=logits.device)
        for i in range(0, l, c):
            f = logits[:, i:i + c].float()
            lb = labels[:, i:i + c]
            lse_c = torch.logsumexp(f, dim=-1)
            tgt = f.gather(-1, _target_index(lb, v, ignore_index))[..., 0]
            per = lse_c - tgt
            if ignore_index is not None:
                per = torch.where(lb == ignore_index, 0.0, per)
            total = total + per.sum()
            lse[:, i:i + c] = lse_c
        if ignore_index is None:
            n_valid = torch.full((), float(b * l), device=logits.device)
        else:
            n_valid = (labels != ignore_index).sum().float().clamp(min=1.0)
        ctx.save_for_backward(logits, labels, lse, n_valid)
        ctx.ignore_index = ignore_index
        return total / n_valid

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, n_valid = ctx.saved_tensors
        ignore_index = ctx.ignore_index
        b, l, v = logits.shape
        c = _chunks(l)
        scale = g / n_valid
        grad = torch.empty_like(logits)
        for i in range(0, l, c):
            lb = labels[:, i:i + c]
            d = torch.exp(logits[:, i:i + c].float()
                          - lse[:, i:i + c, None])
            d.scatter_add_(-1, _target_index(lb, v, ignore_index),
                           torch.full(lb.shape + (1,), -1.0,
                                      device=d.device))
            d = d * scale
            if ignore_index is not None:
                d = torch.where((lb == ignore_index)[..., None], 0.0, d)
            grad[:, i:i + c] = d.to(logits.dtype)
        return grad, None, None


def fused_softmax_ce_mean(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: Optional[int] = None
                          ) -> torch.Tensor:
    """Mean over positions of ``-log softmax(logits)[labels]``, f32.
    ``logits [B, L, V]`` (any float dtype), ``labels [B, L]`` int.
    Positions labelled ``ignore_index`` contribute nothing and leave the
    mean's denominator."""
    return _FusedSoftmaxCEMean.apply(logits, labels, ignore_index)
