"""Common layers of the port: ``Dropout``.

The port of ``paddle_tpu/nn/layers_common.py`` ``Dropout``, as a
``torch.nn.Module``: it drops in training mode and passes through in
eval mode (``module.train()`` / ``.eval()``). ``Linear`` and
``Embedding`` are ``torch.nn.Linear`` and ``torch.nn.Embedding`` in the
port (``convert`` transposes the JAX ``[in, out]`` weights).
"""
from __future__ import annotations

from torch import nn

from .functional import dropout

__all__ = ["Dropout"]


class Dropout(nn.Module):
    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"
