"""Extension functionals of the port: ``sequence_mask``, ``gather_tree``,
``sparse_attention`` and ``class_center_sample``.

The port of ``paddle_tpu/nn/functional/extension.py``, plain PyTorch.
``gather_tree`` walks the beams back in time with a loop of device
gathers (the JAX function's ``lax.scan``). ``sparse_attention`` is the
JAX design: the per-(batch, head) CSR pattern becomes a dense boolean
mask, the scores outside it take −1e30, and a row with no entry in the
pattern comes out zero (scaled-dot-product attention would treat such a
row otherwise, so it is not used). ``class_center_sample`` runs on the
host (its output size depends on the labels) on one rank, its negatives
drawn from a numpy generator seeded by a host draw of the port's
default generator.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import random as _random
from ...core.autograd import apply_op
from ...core.tensor import Tensor, as_torch

__all__ = ["sequence_mask", "gather_tree", "sparse_attention",
           "class_center_sample"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[i, ..., j] = j < x[i, ...]`` for ``j < maxlen`` (the
    largest length when ``maxlen`` is None, read on the host)."""
    from ...core.dtype import convert_dtype
    if maxlen is None:
        maxlen = int(as_torch(x).max())
    td = convert_dtype(dtype)

    def f(lens):
        ar = torch.arange(maxlen, device=lens.device)
        return (ar < lens[..., None]).to(td)
    return apply_op(f, x, op_name="sequence_mask")


def gather_tree(ids, parents):
    """The beam-search ancestry walked back from the last step:
    ``ids`` and ``parents`` are ``[max_time, batch, beam]``."""
    def f(idv, par):
        beams = torch.arange(idv.shape[2], device=idv.device).expand(
            idv.shape[1:])
        out = []
        for t in range(idv.shape[0] - 1, -1, -1):
            out.append(idv[t].gather(1, beams))
            beams = par[t].long().gather(1, beams)
        return torch.stack(out[::-1])
    return apply_op(f, ids, parents, op_name="gather_tree")


def _sparse_attention(q, k, v, off, cols, kpm=None, am=None):
    b, h, m, d = q.shape
    nnz = cols.shape[-1]
    pos = torch.arange(nnz, device=q.device).expand(b, h, nnz)
    rows = torch.searchsorted(off.contiguous(), pos.contiguous(),
                              right=True) - 1
    mask = torch.zeros((b, h, m, m), dtype=torch.bool, device=q.device)
    bidx = torch.arange(b, device=q.device)[:, None, None].expand_as(rows)
    hidx = torch.arange(h, device=q.device)[None, :, None].expand_as(rows)
    mask[bidx, hidx, rows, cols.long()] = True
    scores = torch.einsum("bhmd,bhnd->bhmn", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    neg = torch.tensor(-1e30, dtype=scores.dtype, device=q.device)
    scores = torch.where(mask, scores, neg)
    if kpm is not None:
        scores = torch.where(kpm[:, None, None, :] != 0, scores, neg)
    if am is not None:
        scores = torch.where(am != 0, scores, neg)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhmn,bhnd->bhmd", probs, v)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention restricted to a per-(batch, head) CSR pattern:
    ``q``/``k``/``v`` ``[B, H, M, D]``, offsets ``[B, H, M + 1]``,
    columns ``[B, H, nnz]``."""
    return apply_op(_sparse_attention, query, key, value,
                    sparse_csr_offset, sparse_csr_columns, key_padding_mask,
                    attn_mask, op_name="sparse_attention")


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC class-center sampling (arXiv:2010.05222): every
    positive class of ``label`` plus uniformly drawn negatives up to
    ``num_samples``, sorted; the labels remapped to their place among
    them. Returns ``(remapped_label, sampled_class_center)``."""
    if group not in (None, False, True) and getattr(group, "nranks", 1) > 1:
        raise NotImplementedError(
            "class_center_sample across a model-parallel group needs the "
            "distributed package, which the port does not have yet "
            "(ROADMAP queue 1 item 13)")
    lab_t = as_torch(label)
    lab = lab_t.detach().cpu().numpy()
    local_pos = np.unique(lab)
    local_pos = local_pos[(local_pos >= 0) & (local_pos < num_classes)]
    if len(local_pos) >= num_samples:
        sampled = np.sort(local_pos)
    else:
        # the negatives: a prefix of a permutation of the pool drawn
        # from a host key of the port's key stream (a counted host draw:
        # the sampled set is host data)
        neg_pool = np.setdiff1d(np.arange(num_classes), local_pos)
        order = _random.permutation(len(neg_pool),
                                    key=_random.host_key()).numpy()
        extra = neg_pool[order[:num_samples - len(local_pos)]]
        sampled = np.sort(np.concatenate([local_pos, extra]))
    lut = {int(c): i for i, c in enumerate(sampled)}
    remapped = np.asarray([lut.get(int(v), -1) for v in lab.reshape(-1)],
                          dtype=lab.dtype).reshape(lab.shape)
    out = (torch.from_numpy(remapped).to(lab_t.device),
           torch.from_numpy(sampled.astype(lab.dtype)).to(lab_t.device))
    if isinstance(label, Tensor):
        return Tensor(out[0]), Tensor(out[1])
    return out
