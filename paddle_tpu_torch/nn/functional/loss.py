"""Loss functionals of the port: ``cross_entropy``.

The port of ``paddle_tpu/nn/functional/loss.py`` ``cross_entropy``,
routed as the JAX version routes it: a hard-label mean over 2-D or 3-D
logits with a vocabulary of at least 4096, no class weights and no
label smoothing goes to the chunked fused cross-entropy
(``ops.fused_ce``), which never holds ``[N, V]`` in f32; everything
else is the plain f32 log-softmax. It takes Tensors or torch tensors
(``core.autograd.apply_op``) and returns the same kind.
"""
from __future__ import annotations

import torch

from ...core.autograd import apply_op
from ...ops.fused_ce import fused_softmax_ce_mean

__all__ = ["cross_entropy"]

_FUSED_MIN_VOCAB = 4096


def _reduce(v, reduction, weight_sum=None):
    if reduction == "mean":
        return v.sum() / weight_sum if weight_sum is not None else v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _is_soft(logits, label, axis) -> bool:
    return (label.dim() == logits.dim()
            and label.shape[axis] == logits.shape[axis]
            and label.is_floating_point())


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """Softmax + NLL (paddle semantics); the loss is f32."""
    return apply_op(_cross_entropy, input, label, weight,
                    ignore_index=ignore_index, reduction=reduction,
                    soft_label=soft_label, axis=axis,
                    use_softmax=use_softmax,
                    label_smoothing=label_smoothing)


def _cross_entropy(input: torch.Tensor, label: torch.Tensor, weight,
                   ignore_index: int, reduction: str, soft_label: bool,
                   axis: int, use_softmax: bool,
                   label_smoothing: float) -> torch.Tensor:
    logits = input
    hard = not _is_soft(logits, label, axis)
    if (use_softmax and not soft_label and hard and weight is None
            and label_smoothing == 0.0 and reduction == "mean"
            and axis in (-1, logits.dim() - 1) and logits.dim() in (2, 3)
            and logits.shape[-1] >= _FUSED_MIN_VOCAB):
        idx = label
        if idx.dim() == logits.dim() and idx.shape[-1] == 1:
            idx = idx.squeeze(-1)
        if idx.dim() == logits.dim() - 1:
            lg3 = logits if logits.dim() == 3 else logits[None]
            lb3 = idx if idx.dim() == 2 else idx[None]
            return fused_softmax_ce_mean(lg3, lb3, ignore_index)
    if use_softmax:
        logp = torch.log_softmax(logits.float(), dim=axis)
    else:
        logp = torch.log(logits.float().clamp(min=1e-30))
    k = logits.shape[axis]
    if soft_label or not hard:
        tgt = label.float()
        if label_smoothing > 0.0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / k
        per = -(tgt * logp).sum(dim=axis)
        if weight is not None:
            per = per * (tgt * weight.float()).sum(dim=axis)
        return _reduce(per, reduction)
    idx = label.long()
    if idx.dim() == logits.dim() and idx.shape[axis] == 1:
        idx = idx.squeeze(axis)
    moved = logp.movedim(axis, -1)
    valid = idx != ignore_index
    safe = idx.clamp(0, k - 1)
    if label_smoothing > 0.0:
        oh = torch.nn.functional.one_hot(safe, k).float()
        tgt = (1 - label_smoothing) * oh + label_smoothing / k
        per = -(tgt * moved).sum(dim=-1)
    else:
        per = -moved.gather(-1, safe[..., None])[..., 0]
    per = torch.where(valid, per, 0.0)
    if weight is not None:
        w_per = weight.float()[safe] * valid
        per = per * w_per
        return _reduce(per, reduction, w_per.sum()
                       if reduction == "mean" else None)
    if reduction == "mean":
        return per.sum() / valid.sum().clamp(min=1)
    return _reduce(per, reduction)
