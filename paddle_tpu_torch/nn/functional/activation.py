"""Activation functionals of the port: ``gelu`` and ``tanh``.

The port of ``paddle_tpu/nn/functional/activation.py`` for the BERT
path. ``gelu`` is the erf form by default (JAX ``approximate=False``,
torch's ``approximate="none"``) and the tanh form with
``approximate=True``. Each takes Tensors or torch tensors
(``core.autograd.apply_op``) and returns the same kind.
"""
from __future__ import annotations

import torch

from ...core.autograd import apply_op

__all__ = ["gelu", "tanh"]


def gelu(x, approximate: bool = False, name=None):
    return apply_op(torch.nn.functional.gelu, x,
                    approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return apply_op(torch.tanh, x)
