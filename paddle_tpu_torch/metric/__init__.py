"""The port's ``paddle.metric``: ``Metric``, ``Accuracy``, ``Precision``,
``Recall``, ``Auc`` and ``accuracy``.

The port of ``paddle_tpu/metric/__init__.py``. ``Accuracy.compute``
(and ``accuracy``) take the top k on the predictions' device
(``torch.topk``) and return the 0/1 ``correct`` table there as a
Tensor, so ``Model.eval_batch`` moves ``[N, k]`` values to the host, not
the logits; ``update`` and the other metrics accumulate on the host in
numpy, as in the JAX package.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

from ..core.tensor import Tensor, as_torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor(x).numpy()
    return np.asarray(x)


def _correct(pred, label, k) -> torch.Tensor:
    """``[..., k]`` f32: whether each of the top ``k`` classes of
    ``pred`` is the label."""
    p = as_torch(pred)
    lab = as_torch(label, device=p.device)
    idx = torch.topk(p, k, dim=-1).indices
    if lab.dim() == p.dim():
        lab = lab.squeeze(-1)
    return (idx == lab[..., None].to(idx.dtype)).float()


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy, accumulated over updates."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        return Tensor(_correct(pred, label, self.maxk))

    def update(self, correct, *args):
        c = _np(correct)
        num_samples = int(np.prod(c.shape[:-1]))
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = c[..., :k].sum()
            self.total[i] += num_corrects
            self.count[i] += num_samples
            accs.append(float(num_corrects) / max(num_samples, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision of predictions thresholded at 0.5."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of predictions thresholded at 0.5."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC by the trapezoid rule over ``num_thresholds`` bins."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        lab = _np(labels).reshape(-1)
        bins = np.clip((p.reshape(-1) * self.num_thresholds).astype(np.int64),
                       0, self.num_thresholds)
        np.add.at(self._stat_pos, bins[lab != 0], 1)
        np.add.at(self._stat_neg, bins[lab == 0], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    def accumulate(self):
        tot_pos = tot_neg = auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (new_pos + tot_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg) if tot_pos * tot_neg > 0 else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Top-k accuracy of a batch as a 0-d f32 Tensor."""
    return Tensor(_correct(input, label, k).amax(-1).mean())
