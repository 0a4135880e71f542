"""Weight-decay regularizers: ``L1Decay`` and ``L2Decay``.

The port of ``paddle_tpu/regularizer.py``. Passed as an optimizer's
``weight_decay``: ``L2Decay(c)`` is folded into the optimizer's decay
coefficient ``c`` (the optimizer never calls it), ``L1Decay(c)`` adds
``c * sign(param)`` to each gradient before the update. The fused
optimizer step has no L1 term in its kernels, so an optimizer with an
``L1Decay`` runs the per-parameter loop, counted under the reason
``regularizer`` (``optimizer/fused_step.py``).
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    def __call__(self, param, grad):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """grad += coeff * sign(param)."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param, grad):
        return grad + self._coeff * torch.sign(param)


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param, grad):
        return grad + self._coeff * param
