"""The long tail of ``paddle.incubate``: the ``LookAhead`` and
``ModelAverage`` optimizer wrappers, the fused masked softmax,
``identity_loss``, and the ``graph_*`` / ``segment_*`` names over
``geometric``.

The port of ``paddle_tpu.incubate.extras``. The wrappers keep their
slow weights and sums as device tensors of their own (never aliases of
a parameter) and write parameters in place. The ``graph_*`` functions
keep the reference's incubate signatures (argument order and names),
which differ from the ``geometric`` ones they call.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.autograd import apply_op
from ..core.tensor import Tensor, as_torch
from ..geometric import (  # noqa: F401
    segment_max, segment_mean, segment_min, segment_sum,
)

__all__ = [
    "LookAhead", "ModelAverage", "softmax_mask_fuse",
    "softmax_mask_fuse_upper_triangle", "identity_loss",
    "graph_send_recv", "graph_khop_sampler", "graph_sample_neighbors",
    "graph_reindex", "segment_sum", "segment_mean", "segment_max",
    "segment_min",
]


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    """``geometric.send_u_recv`` with the reference's ``pool_type``."""
    from ..geometric import send_u_recv
    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_reindex(x, neighbors, count, value_buffer=None,
                  index_buffer=None, flag_buffer_hashtable=False,
                  name=None):
    """``geometric.reindex_graph`` (the buffers are accepted and
    unused)."""
    from ..geometric import reindex_graph
    return reindex_graph(x, neighbors, count)


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None):
    """``geometric.sample_neighbors`` with the reference's positional
    order (``eids``, ``perm_buffer`` before ``sample_size``)."""
    from ..geometric import sample_neighbors
    return sample_neighbors(row, colptr, input_nodes,
                            sample_size=sample_size, eids=eids,
                            return_eids=return_eids)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop neighbour sampling: ``sample_neighbors`` chained over
    ``sample_sizes`` hops in one id space (a revisited node keeps its
    id). Returns ``(src, dst, nodes, counts)``; host-side."""
    from ..geometric import _np_of, _out, sample_neighbors
    base = _np_of(input_nodes).reshape(-1)
    order = {int(v): i for i, v in enumerate(base)}
    nodes = list(base)
    srcs, dsts, cnts = [], [], []
    frontier = base
    for size in sample_sizes:
        neigh, cnt = sample_neighbors(row, colptr, frontier,
                                      sample_size=size)
        nv = neigh.numpy().reshape(-1)
        cv = cnt.numpy().reshape(-1)
        dsts.append(np.repeat(
            np.array([order[int(v)] for v in frontier], np.int64), cv))
        for v in nv:
            if int(v) not in order:
                order[int(v)] = len(nodes)
                nodes.append(v)
        srcs.append(np.array([order[int(v)] for v in nv], np.int64))
        cnts.append(cv)
        frontier = nv
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    cnt_all = np.concatenate(cnts) if cnts else np.empty(0, np.int64)
    return (_out(src), _out(dst), _out(np.asarray(nodes, dtype=base.dtype)),
            _out(cnt_all))


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last dim, in f32, cast back."""
    def f(a, m):
        return torch.softmax(a.float() + m.float(), dim=-1).to(a.dtype)
    return apply_op(f, x, mask, op_name="softmax_mask_fuse")


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax over the last two dims (the upper triangle
    masked)."""
    def f(a):
        q, k = a.shape[-2], a.shape[-1]
        keep = torch.ones((q, k), dtype=torch.bool,
                          device=a.device).tril(k - q)
        logits = torch.where(keep, a.float(), -1e30)
        return torch.softmax(logits, dim=-1).to(a.dtype)
    return apply_op(f, x, op_name="softmax_mask_fuse_upper_triangle")


def identity_loss(x, reduction="none"):
    """The final loss, reduced by ``reduction`` ("sum", "mean", "none"
    or the codes 0 / 1 / 2)."""
    red = {0: "sum", 1: "mean", 2: "none"}.get(reduction, reduction)
    if red == "none":
        return x if isinstance(x, Tensor) else Tensor(as_torch(x))
    if red == "mean":
        return apply_op(torch.mean, x, op_name="identity_loss")
    if red == "sum":
        return apply_op(torch.sum, x, op_name="identity_loss")
    raise ValueError(f"unknown reduction {reduction!r}")


class LookAhead:
    """Lookahead (Zhang et al. 2019): the inner optimizer moves the fast
    weights every step; every ``k`` steps the slow weights move
    ``alpha`` of the way to them and the fast weights are reset onto
    the slow ones."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        if not (isinstance(k, int) and k > 0):
            raise ValueError("k must be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step_count = 0
        self._slow = {}

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def _params(self):
        return self.inner_optimizer._parameter_list

    @torch.no_grad()
    def step(self):
        if not self._slow:
            for p in self._params():
                self._slow[id(p)] = p.detach().clone()
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for p in self._params():
                slow = self._slow[id(p)].float()
                new_slow = (slow + self.alpha * (p.float() - slow)).to(
                    p.dtype)
                self._slow[id(p)] = new_slow
                p.copy_(new_slow)

    def minimize(self, loss, *args, **kwargs):
        loss.backward()
        self.step()
        self.inner_optimizer.clear_grad()

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def state_dict(self):
        return {"inner": self.inner_optimizer.state_dict(),
                "step_count": self._step_count}


class ModelAverage:
    """A running average of the parameters over a growing window:
    ``apply()`` puts the averages in (restorable), ``restore()`` the
    trained weights back. The window restarts when the accumulated count
    reaches ``min(max_average_window, num_updates *
    average_window_rate)`` (and at least ``min_average_window``)."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.average_window_rate = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._params = [p._t if isinstance(p, Tensor) else p
                        for p in (parameters or [])]
        self._sum = {id(p): torch.zeros_like(p, dtype=torch.float32)
                     for p in self._params}
        self._num_accumulates = 0
        self._num_updates = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._num_updates += 1
        self._num_accumulates += 1
        window = min(self.max_average_window,
                     self._num_updates * self.average_window_rate)
        if (self._num_accumulates >= self.min_average_window
                and self._num_accumulates >= window):
            # restart the window from the latest values
            for p in self._params:
                self._sum[id(p)] = p.detach().float().clone()
            self._num_accumulates = 1
        else:
            for p in self._params:
                self._sum[id(p)] += p.detach().float()

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {id(p): p.detach().clone() for p in self._params}
        n = max(self._num_accumulates, 1)
        for p in self._params:
            p.copy_((self._sum[id(p)] / n).to(p.dtype))
        if not need_restore:
            self._backup = None
        return _RestoreCtx(self)

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._params:
            p.copy_(self._backup[id(p)])
        self._backup = None


class _RestoreCtx:
    """``with ma.apply(): ...`` restores on exit."""

    def __init__(self, ma):
        self._ma = ma

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._ma.restore()
        return False
