"""``paddle.geometric`` of the port: graph message passing primitives.

The port of ``paddle_tpu.geometric``. The segment reductions and the
message passing (``send_u_recv``, ``send_ue_recv``, ``send_uv``) are
device ops through ``core.autograd.apply_op`` (``index_add_`` and
``scatter_reduce_`` over the segment ids), differentiable like the JAX
``jax.ops.segment_*``; an empty segment reads 0 (paddle's rule, not
±inf). The number of segments, when not given, is ``max(ids) + 1``: a
host read, as in JAX. Reindexing and neighbour sampling are host-side
(ragged, data-dependent sizes), their results Tensors on the eager
core's device; the samplers draw their host RNG's seed from the port's
generator (``core.random``), so ``paddle.seed`` makes them
reproducible.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.autograd import apply_op
from ..core.tensor import Tensor, as_torch

__all__ = [
    "segment_sum", "segment_mean", "segment_max", "segment_min",
    "send_u_recv", "send_ue_recv", "send_uv", "reindex_graph",
    "reindex_heter_graph", "sample_neighbors", "weighted_sample_neighbors",
]


def _num_segments(segment_ids, n):
    if n is not None:
        return int(n)
    ids = as_torch(segment_ids)
    return int(ids.max()) + 1 if ids.numel() else 0


def _counts(i, n, like):
    return torch.zeros(n, dtype=like.dtype, device=like.device).index_add_(
        0, i.long(), torch.ones(i.shape[0], dtype=like.dtype,
                                device=like.device))


def _bcast(c, d):
    return c.reshape((-1,) + (1,) * (d.dim() - 1))


def _sum(d, i, n):
    return torch.zeros((n,) + tuple(d.shape[1:]), dtype=d.dtype,
                       device=d.device).index_add(0, i.long(), d)


def segment_sum(data, segment_ids, name=None, num_segments=None):
    n = _num_segments(segment_ids, num_segments)
    return apply_op(lambda d, i: _sum(d, i, n), data, segment_ids,
                    op_name="segment_sum")


def segment_mean(data, segment_ids, name=None, num_segments=None):
    n = _num_segments(segment_ids, num_segments)

    def f(d, i):
        cnt = _counts(i, n, d)
        return _sum(d, i, n) / _bcast(cnt.clamp(min=1), d)
    return apply_op(f, data, segment_ids, op_name="segment_mean")


def _extreme(d, i, n, reduce):
    idx = i.long().reshape((-1,) + (1,) * (d.dim() - 1)).expand_as(d)
    out = torch.zeros((n,) + tuple(d.shape[1:]), dtype=d.dtype,
                      device=d.device).scatter_reduce(
        0, idx, d, reduce=reduce, include_self=False)
    # paddle reads 0 for an empty segment
    cnt = _counts(i, n, d)
    return torch.where(_bcast(cnt, d) > 0, out, torch.zeros_like(out))


def segment_max(data, segment_ids, name=None, num_segments=None):
    n = _num_segments(segment_ids, num_segments)
    return apply_op(lambda d, i: _extreme(d, i, n, "amax"), data,
                    segment_ids, op_name="segment_max")


def segment_min(data, segment_ids, name=None, num_segments=None):
    n = _num_segments(segment_ids, num_segments)
    return apply_op(lambda d, i: _extreme(d, i, n, "amin"), data,
                    segment_ids, op_name="segment_min")


_REDUCERS = {"sum": segment_sum, "mean": segment_mean, "max": segment_max,
             "min": segment_min, "add": segment_sum}
_MESSAGE = {"add": torch.add, "sub": torch.subtract, "mul": torch.multiply,
            "div": torch.divide}


def _gather(a, idx):
    return torch.index_select(a, 0, idx.long().reshape(-1))


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather ``x[src]``, then segment-reduce onto ``dst``."""
    if reduce_op not in _REDUCERS:
        raise ValueError(f"unsupported reduce_op {reduce_op!r}")
    n = int(out_size) if out_size is not None else as_torch(x).shape[0]
    gathered = apply_op(_gather, x, src_index, op_name="gather_src")
    return _REDUCERS[reduce_op](gathered, dst_index, num_segments=n)


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Combine ``x[src]`` with the edge features ``y``, then reduce onto
    ``dst``."""
    if message_op not in _MESSAGE:
        raise ValueError(f"unsupported message_op {message_op!r}")
    if reduce_op not in _REDUCERS:
        raise ValueError(f"unsupported reduce_op {reduce_op!r}")
    n = int(out_size) if out_size is not None else as_torch(x).shape[0]
    op = _MESSAGE[message_op]
    msg = apply_op(lambda a, e, s: op(_gather(a, s), e), x, y, src_index,
                   op_name="message")
    return _REDUCERS[reduce_op](msg, dst_index, num_segments=n)


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Edge features from gathered node pairs: ``x[src] op y[dst]``."""
    if message_op not in _MESSAGE:
        raise ValueError(f"unsupported message_op {message_op!r}")
    op = _MESSAGE[message_op]
    return apply_op(lambda a, b, s, d: op(_gather(a, s), _gather(b, d)),
                    x, y, src_index, dst_index, op_name="send_uv")


# -- host-side graph ops --------------------------------------------------------

def _np_of(t):
    return np.asarray(t.numpy() if isinstance(t, Tensor) else
                      t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t)


def _out(a: np.ndarray) -> Tensor:
    from ..core.device import current_device
    return Tensor(as_torch(a, device=current_device()))


def _renumber(xv, neighbor_lists):
    """One id space over ``xv`` then each neighbour list in order:
    ``(per-list local src ids, node ids in order of first sight)``."""
    order = {int(v): i for i, v in enumerate(xv)}
    nodes = list(xv)
    srcs = []
    for nv in neighbor_lists:
        for v in nv:
            if int(v) not in order:
                order[int(v)] = len(nodes)
                nodes.append(v)
        srcs.append(np.array([order[int(v)] for v in nv], np.int64))
    return srcs, np.asarray(nodes, dtype=xv.dtype)


def reindex_graph(x, neighbors, count, name=None):
    """Compact global node ids to local ids: ``(reindex_src,
    reindex_dst, out_nodes)``."""
    xv = _np_of(x)
    cv = _np_of(count)
    (src,), nodes = _renumber(xv, [_np_of(neighbors)])
    dst = np.repeat(np.arange(len(cv), dtype=np.int64), cv)
    return _out(src), _out(dst), _out(nodes)


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """:func:`reindex_graph` over several edge types sharing one id
    space; the edges of the types are concatenated."""
    xv = _np_of(x).reshape(-1)
    nvs = [_np_of(nb).reshape(-1) for nb in neighbors]
    srcs, nodes = _renumber(xv, nvs)
    dsts = [np.repeat(np.arange(len(cv), dtype=np.int64), cv)
            for cv in (_np_of(ct).reshape(-1) for ct in count)]
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    return _out(src), _out(dst), _out(nodes)


def _host_rng():
    """A numpy generator seeded by a host draw of the port's default
    generator (``paddle.seed`` makes sampling reproducible)."""
    from ..core import random as random_mod
    return np.random.default_rng(random_mod._host_seed() & 0x7FFFFFFF)


def _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
            weights=None):
    if return_eids and eids is None:
        raise ValueError("return_eids=True needs eids")
    rowv, colv = _np_of(row).reshape(-1), _np_of(colptr).reshape(-1)
    nodes = _np_of(input_nodes).reshape(-1)
    eidv = _np_of(eids).reshape(-1) if eids is not None else None
    rng = _host_rng()
    out_n, out_c, out_e = [], [], []
    for n in nodes:
        lo, hi = int(colv[n]), int(colv[n + 1])
        deg = hi - lo
        if weights is not None and deg == 0:
            out_c.append(0)
            continue
        if sample_size < 0 or deg <= sample_size:
            sel = np.arange(lo, hi)
        else:
            p = None
            if weights is not None:
                w = weights[lo:hi]
                p = w / w.sum() if w.sum() > 0 else None
            sel = lo + rng.choice(deg, size=sample_size, replace=False, p=p)
        out_n.append(rowv[sel])
        out_c.append(len(sel))
        if return_eids:
            out_e.append(eidv[sel])
    neigh = np.concatenate(out_n) if out_n else np.empty(0, rowv.dtype)
    res = (_out(neigh), _out(np.asarray(out_c, dtype=rowv.dtype)))
    if return_eids:
        ev = np.concatenate(out_e) if out_e else np.empty(0, rowv.dtype)
        return res + (_out(ev),)
    return res


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbour sampling without replacement over a CSC graph:
    ``(neighbors, count[, eids])``."""
    return _sample(row, colptr, input_nodes, sample_size, eids, return_eids)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None,
                              return_eids=False, name=None):
    """Weight-proportional neighbour sampling without replacement."""
    w = _np_of(edge_weight).reshape(-1).astype(np.float64)
    return _sample(row, colptr, input_nodes, sample_size, eids, return_eids,
                   weights=w)
