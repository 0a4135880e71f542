"""Activation functionals of the port: ``gelu`` and ``tanh``.

The port of ``paddle_tpu/nn/functional/activation.py`` for the BERT
path. ``gelu`` is the erf form by default (JAX ``approximate=False``,
torch's ``approximate="none"``) and the tanh form with
``approximate=True``.
"""
from __future__ import annotations

import torch

__all__ = ["gelu", "tanh"]


def gelu(x: torch.Tensor, approximate: bool = False, name=None):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x: torch.Tensor, name=None):
    return torch.tanh(x)
