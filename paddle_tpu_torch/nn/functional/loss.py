"""Loss functionals of the port.

The port of ``paddle_tpu/nn/functional/loss.py``: every loss there,
each through ``core.autograd.apply_op`` under the JAX package's op
name, with the JAX package's arithmetic (its clamps, its ``mean`` /
``sum`` / ``batchmean`` reductions). ``ctc_loss`` is the JAX package's
forward algorithm in log space, a loop over the time steps;
``rnnt_loss`` its transducer forward variables, a loop over the frames
with a running log-sum-exp along the labels (``torch.logcumsumexp`` in
place of the JAX associative scan); ``hsigmoid_loss`` its bit coding of
the default tree (or a custom ``path_table`` / ``path_code``);
``margin_cross_entropy`` its one-rank form (class-sharded logits across
a group of ranks wait for the port's collectives);
``adaptive_log_softmax_with_loss`` its masked head-and-tails form.

``cross_entropy`` is routed as the JAX version routes it: a hard-label mean over 2-D or 3-D
logits with a vocabulary of at least 4096, no class weights and no
label smoothing goes to the chunked fused cross-entropy
(``ops.fused_ce``), which never holds ``[N, V]`` in f32; everything
else is the plain f32 log-softmax. It takes Tensors or torch tensors
(``core.autograd.apply_op``) and returns the same kind.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.autograd import apply_op
from ...ops.fused_ce import fused_softmax_ce_mean

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "l1_loss", "smooth_l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "hinge_embedding_loss", "margin_ranking_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "ctc_loss",
           "soft_margin_loss", "multi_label_soft_margin_loss",
           "multi_margin_loss", "poisson_nll_loss", "gaussian_nll_loss",
           "square_error_cost", "log_loss", "dice_loss", "npair_loss",
           "sigmoid_focal_loss", "triplet_margin_with_distance_loss",
           "hsigmoid_loss", "rnnt_loss", "margin_cross_entropy",
           "adaptive_log_softmax_with_loss"]

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
                    label_smoothing=label_smoothing,
                    op_name="cross_entropy")


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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-position cross-entropy with a size-1 class axis kept (and the
    softmax with ``return_softmax``)."""
    from .activation import softmax
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = apply_op(lambda a: a.unsqueeze(axis), loss, op_name="unsqueeze")
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda a, b: _reduce(torch.square(a - b), reduction),
                    input, label, op_name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda a, b: _reduce(torch.abs(a - b), reduction),
                    input, label, op_name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def f(a, b):
        d = torch.abs(a - b)
        v = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        return _reduce(v * delta, reduction)     # paddle scales by delta
    return apply_op(f, input, label, op_name="smooth_l1_loss")


def _take_class(x, idx, axis):
    """``x`` with its ``axis`` moved last, read at ``idx`` (clamped to
    the classes)."""
    moved = x.movedim(axis, -1)
    safe = idx.long().clamp(0, moved.shape[-1] - 1)
    return moved.gather(-1, safe[..., None])[..., 0]


def _const(t):
    """A class weight the JAX package closes over: no gradient."""
    from ...core.tensor import unwrap
    t = unwrap(t)
    return t.detach() if isinstance(t, torch.Tensor) else t


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    wd = _const(weight)

    def f(logp, lbl):
        per = -_take_class(logp, lbl, 1)
        valid = lbl != ignore_index
        per = torch.where(valid, per, 0.0)
        if wd is not None:
            w_per = wd.to(logp.device)[
                lbl.long().clamp(0, logp.shape[1] - 1)] * valid
            per = per * w_per
            if reduction == "mean":
                return per.sum() / w_per.sum()
        if reduction == "mean":
            return per.sum() / valid.sum().clamp(min=1)
        return _reduce(per, reduction)
    return apply_op(f, input, label, op_name="nll_loss")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def f(p, y, w):
        eps = 1e-12
        v = -(y * torch.log(torch.clamp(p, min=eps))
              + (1 - y) * torch.log(torch.clamp(1 - p, min=eps)))
        if w is not None:
            v = v * w
        return _reduce(v, reduction)
    return apply_op(f, input, label, weight, op_name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    pw = _const(pos_weight)

    def f(z, y, w):
        if pw is not None:
            base = -(pw * y * TF.logsigmoid(z)
                     + (1 - y) * TF.logsigmoid(-z))
        else:
            base = torch.clamp(z, min=0) - z * y \
                + torch.log1p(torch.exp(-torch.abs(z)))
        if w is not None:
            base = base * w
        return _reduce(base, reduction)
    return apply_op(f, logit, label, weight, op_name="bce_with_logits")


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def f(logp, tgt):
        if log_target:
            v = torch.exp(tgt) * (tgt - logp)
        else:
            v = tgt * (torch.log(torch.clamp(tgt, min=1e-12)) - logp)
        if reduction == "batchmean":
            return v.sum() / logp.shape[0]
        return _reduce(v, reduction)
    return apply_op(f, input, label, op_name="kl_div")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    def f(a, y):
        v = torch.where(y == 1, a, torch.clamp(margin - a, min=0.0))
        return _reduce(v, reduction)
    return apply_op(f, input, label, op_name="hinge_embedding_loss")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply_op(
        lambda a, b, y: _reduce(torch.clamp(-y * (a - b) + margin, min=0.0),
                                reduction),
        input, other, label, op_name="margin_ranking_loss")


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def f(a, b, y):
        cos = (a * b).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        v = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin, min=0.0))
        return _reduce(v, reduction)
    return apply_op(f, input1, input2, label,
                    op_name="cosine_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def f(a, pos, neg):
        dp = torch.linalg.vector_norm(a - pos + epsilon, ord=p, dim=-1)
        dn = torch.linalg.vector_norm(a - neg + epsilon, ord=p, dim=-1)
        if swap:
            dn = torch.minimum(dn, torch.linalg.vector_norm(
                pos - neg + epsilon, ord=p, dim=-1))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)
    return apply_op(f, input, positive, negative,
                    op_name="triplet_margin_loss")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward algorithm in log space. ``log_probs [T, B, C]``
    are logits (log-softmaxed here), ``labels [B, S]``."""
    def f(lp, lbl, in_len, lbl_len):
        logp = torch.log_softmax(lp.float(), -1)
        T, B, _ = logp.shape
        S = lbl.shape[1]
        dev = logp.device
        ext = torch.full((B, 2 * S + 1), blank, dtype=torch.long,
                         device=dev)
        ext[:, 1::2] = lbl.long()
        neg_inf = -1e30
        first = logp[0].gather(1, ext)
        alpha = torch.where(torch.arange(2 * S + 1, device=dev) < 2, first,
                            neg_inf)
        same = torch.cat([torch.ones((B, 2), dtype=torch.bool, device=dev),
                          ext[:, 2:] == ext[:, :-2]], 1)
        pad1 = torch.full((B, 1), neg_inf, device=dev)
        pad2 = torch.full((B, 2), neg_inf, device=dev)
        alphas = [alpha]
        for t in range(1, T):
            a0 = alpha
            a1 = torch.cat([pad1, alpha[:, :-1]], 1)
            a2 = torch.where(same, neg_inf,
                             torch.cat([pad2, alpha[:, :-2]], 1))
            m = torch.maximum(torch.maximum(a0, a1), a2)
            alpha = m + torch.log(torch.exp(a0 - m) + torch.exp(a1 - m)
                                  + torch.exp(a2 - m)) \
                + logp[t].gather(1, ext)
            alphas.append(alpha)
        alphas = torch.stack(alphas)
        t_idx = (in_len.long() - 1).clamp(0, T - 1)
        final = alphas[t_idx, torch.arange(B, device=dev)]
        ll_len = lbl_len.long()
        f1 = final.gather(1, (2 * ll_len)[:, None])[:, 0]
        f2 = final.gather(1, (2 * ll_len - 1).clamp(min=0)[:, None])[:, 0]
        m = torch.maximum(f1, f2)
        loss = -(m + torch.log(torch.exp(f1 - m) + torch.exp(f2 - m)))
        if reduction == "mean":
            return (loss / lbl_len.clamp(min=1)).mean()
        return _reduce(loss, reduction)
    return apply_op(f, log_probs, labels, input_lengths, label_lengths,
                    op_name="ctc_loss")


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda a, b: _reduce(TF.softplus(-b * a), reduction),
                    input, label, op_name="soft_margin_loss")


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    def f(a, b, w):
        term = b * TF.logsigmoid(a) + (1 - b) * TF.logsigmoid(-a)
        if w is not None:
            term = term * w
        return _reduce(-term.mean(-1), reduction)
    return apply_op(f, input, label, weight,
                    op_name="multi_label_soft_margin_loss")


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    def f(a, lbl, w):
        c = a.shape[1]
        idx = lbl.long()
        m = torch.clamp(margin - a.gather(1, idx[:, None]) + a, min=0.0)
        if p != 1:
            m = m ** p
        if w is not None:
            m = m * w[idx][:, None]
        mask = 1.0 - TF.one_hot(idx, c).to(a.dtype)
        return _reduce((m * mask).sum(-1) / c, reduction)
    return apply_op(f, input, label, weight, op_name="multi_margin_loss")


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    def f(a, b):
        if log_input:
            v = torch.exp(a) - b * a
        else:
            v = a - b * torch.log(a + epsilon)
        if full:
            stirling = b * torch.log(b) - b + 0.5 * torch.log(2 * math.pi
                                                              * b)
            v = v + torch.where(b > 1, stirling, 0.0)
        return _reduce(v, reduction)
    return apply_op(f, input, label, op_name="poisson_nll_loss")


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def f(a, b, var):
        var = torch.clamp(var, min=epsilon)
        v = 0.5 * (torch.log(var) + (a - b) ** 2 / var)
        if full:
            v = v + 0.5 * math.log(2 * math.pi)
        return _reduce(v, reduction)
    return apply_op(f, input, label, variance, op_name="gaussian_nll_loss")


def square_error_cost(input, label):
    return apply_op(lambda a, b: (a - b) ** 2, input, label,
                    op_name="square_error_cost")


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply_op(lambda a, b: -b * torch.log(a + epsilon)
                    - (1.0 - b) * torch.log(1.0 - a + epsilon),
                    input, label, op_name="log_loss")


def dice_loss(input, label, epsilon=1e-5, name=None):
    def f(a, b):
        lbl = TF.one_hot(b.squeeze(-1).long(), a.shape[-1]).to(a.dtype)
        dims = tuple(range(1, a.dim()))
        inse = (a * lbl).sum(dims)
        denom = a.sum(dims) + lbl.sum(dims)
        return (1.0 - 2.0 * inse / (denom + epsilon)).mean()
    return apply_op(f, input, label, op_name="dice_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def f(a, p, lb):
        n = lb.shape[0]
        lm = (lb.reshape(n, 1) == lb.reshape(1, n)).to(a.dtype)
        lm = lm / lm.sum(1, keepdim=True)
        l2 = ((a * a).sum(1).mean() + (p * p).sum(1).mean()) * 0.25 * l2_reg
        ce = -(lm * torch.log_softmax(a @ p.T, -1)).sum(-1)
        return l2 + (lm * ce[:, None]).sum(0).mean()
    return apply_op(f, anchor, positive, labels, op_name="npair_loss")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def f(x, y, norm):
        p = torch.sigmoid(x)
        ce = torch.clamp(x, min=0) - x * y \
            + torch.log1p(torch.exp(-torch.abs(x)))
        p_t = p * y + (1 - p) * (1 - y)
        loss = ce * ((1 - p_t) ** gamma)
        if alpha >= 0:
            loss = (alpha * y + (1 - alpha) * (1 - y)) * loss
        if norm is not None:
            loss = loss / norm
        return _reduce(loss, reduction)
    return apply_op(f, logit, label, normalizer,
                    op_name="sigmoid_focal_loss")


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function
    if dist is None:
        def dist(x, y):
            return apply_op(
                lambda a, b: torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12),
                x, y, op_name="pdist")
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = apply_op(torch.minimum, dn, dist(positive, negative),
                      op_name="min")
    return apply_op(
        lambda a, b: _reduce(torch.clamp(a - b + margin, min=0.0),
                             reduction),
        dp, dn, op_name="triplet_margin_with_distance_loss")


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss ``[N, 1]`` over the complete binary tree
    (class c's path: nodes ``((c + num_classes) >> (j + 1)) - 1``, bits
    ``((c + num_classes) >> j) & 1``) or a custom tree
    (``path_table`` / ``path_code``, negative entries ending a path)."""
    if num_classes < 2:
        raise ValueError(f"Expected num_classes >= 2 (got {num_classes})")
    if (path_table is None) != (path_code is None):
        raise ValueError(
            "path_table and path_code must be given together (custom tree)")

    def f(x, lbl, w, *rest):
        b = rest[0] if bias is not None else None
        if path_table is None:
            c = lbl.reshape(-1).long() + num_classes
            max_len = int(math.floor(math.log2(2 * num_classes - 1)))
            js = torch.arange(max_len, device=x.device)
            nodes = (c[:, None] >> (js[None, :] + 1)) - 1
            bits = (c[:, None] >> js[None, :]) & 1
        else:
            nodes, bits = rest[-2].long(), rest[-1].long()
        valid = nodes >= 0
        nodes = nodes.clamp(min=0)
        pre = torch.einsum("nld,nd->nl", w[nodes], x)
        if b is not None:
            pre = pre + b.reshape(-1)[nodes]
        pre = pre.clamp(-40.0, 40.0)
        per = torch.logaddexp(torch.zeros_like(pre), pre) - \
            bits.to(pre.dtype) * pre
        per = torch.where(valid, per, torch.zeros_like(per))
        return per.sum(dim=1, keepdim=True)

    args = [a for a in (bias, path_table, path_code) if a is not None]
    return apply_op(f, input, label, weight, *args, op_name="hsigmoid_loss")


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss of logits ``[B, T, U + 1, V]`` (log-softmaxed
    here) against labels ``[B, U]``, FastEmit's ``log(1 + lambda)`` on
    every label emission: the forward variables row by row over the
    frames."""
    def f(acts, lbl, tlen, ulen):
        logp = torch.log_softmax(acts.float(), dim=-1)
        B, T, U1, V = logp.shape
        U = U1 - 1
        blank_lp = logp[..., blank]                          # [B, T, U+1]
        emit_lp = torch.gather(
            logp[:, :, :U, :], -1,
            lbl.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
        if fastemit_lambda:
            emit_lp = emit_lp + math.log1p(fastemit_lambda)
        zero = logp.new_zeros((B, 1))
        alpha = torch.cat([zero, emit_lp[:, 0].cumsum(dim=1)], dim=1)
        alphas = [alpha]
        for t in range(1, T):
            # alpha[t, u] = logsumexp over k <= u of
            #   alpha[t-1, k] + blank[t-1, k] + sum emit[t, k..u-1]
            csum = torch.cat([zero, emit_lp[:, t].cumsum(dim=1)], dim=1)
            alpha = torch.logcumsumexp(
                alpha + blank_lp[:, t - 1] - csum, dim=1) + csum
            alphas.append(alpha)
        alphas = torch.stack(alphas, dim=1)                 # [B, T, U+1]
        t_idx = (tlen.long() - 1)[:, None, None].expand(B, 1, U1)
        u_idx = ulen.long()[:, None]
        a_fin = torch.gather(torch.gather(alphas, 1, t_idx)[:, 0], 1,
                             u_idx)[:, 0]
        b_fin = torch.gather(torch.gather(blank_lp, 1, t_idx)[:, 0], 1,
                             u_idx)[:, 0]
        nll = -(a_fin + b_fin)
        if reduction == "mean":
            return nll.sum() / B
        if reduction == "sum":
            return nll.sum()
        return nll

    return apply_op(f, input, label, input_lengths, label_lengths,
                    op_name="rnnt_loss")


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax cross-entropy: the true class's
    logit becomes ``cos(m1 θ + m2) - m3``, every logit is scaled by
    ``scale``. One rank: logits sharded by class over a group of more
    than one rank raise (the cross-rank softmax waits for the port's
    collectives, ROADMAP queue 1, distributed)."""
    nranks = getattr(group, "nranks", 1) if group not in (None, True,
                                                          False) else 1
    if nranks > 1:
        raise NotImplementedError(
            "margin_cross_entropy over class-sharded logits (a group of "
            f"{nranks} ranks) needs the port's collectives, which are not "
            "ported yet (ROADMAP queue 1, distributed)")

    def f(lg, lb):
        lb = lb.reshape(lb.shape[0]) if lb.dim() > 1 else lb
        onehot = TF.one_hot(lb.long(), lg.shape[-1]).to(lg.dtype)
        cos_t = lg.clamp(-1.0, 1.0)
        modified = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - \
            margin3
        out = torch.where(onehot > 0, modified, cos_t) * scale
        lsm = torch.log_softmax(out, dim=-1)
        loss = -(onehot * lsm).sum(dim=-1, keepdim=True)
        if reduction == "mean":
            loss = loss.mean()
        elif reduction == "sum":
            loss = loss.sum()
        return loss, torch.exp(lsm)

    loss, sm = apply_op(f, logits, label, op_name="margin_ce")
    return (loss, sm) if return_softmax else loss


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax (Grave et al. 2017): the head covers the classes
    below ``cutoffs[0]`` and one slot per tail cluster; a tail's classes
    take their cluster's head log-probability plus the tail's. ->
    ``(per-sample log-probability of the label, mean NLL)``."""
    def f(x, y, hw, *rest):
        if x.dim() == 1:
            x, y = x[None], y.reshape(1)
        hb = rest[0] if head_bias is not None else None
        tails = rest[1:] if head_bias is not None else rest
        shortlist = cutoffs[0]
        head_logits = x @ hw
        if hb is not None:
            head_logits = head_logits + hb
        head_lp = torch.log_softmax(head_logits, dim=-1)
        y = y.long()
        out = torch.gather(head_lp, 1, y.clamp(max=shortlist - 1)[:, None]
                           )[:, 0]
        bounds = [0] + list(cutoffs)
        for i in range(len(tails) // 2):
            w1, w2 = tails[2 * i], tails[2 * i + 1]
            lo = bounds[i + 1]
            hi = bounds[i + 2] if i + 2 < len(bounds) else lo + w2.shape[-1]
            mask = (y >= lo) & (y < hi)
            rel = (y - lo).clamp(0, w2.shape[-1] - 1)
            tail_lp = torch.log_softmax((x @ w1) @ w2, dim=-1)
            cluster_lp = head_lp[:, shortlist + i] + torch.gather(
                tail_lp, 1, rel[:, None])[:, 0]
            out = torch.where(mask, cluster_lp, out)
        return out, -out.mean()

    args = [head_weight]
    if head_bias is not None:
        args.append(head_bias)
    args += [w for pair in tail_weights for w in pair]
    return apply_op(f, input, label, *args,
                    op_name="adaptive_log_softmax_with_loss")
