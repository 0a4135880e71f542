"""``TrainStep``: forward, loss, backward and update as one call.

The port of ``paddle_tpu.jit.api.TrainStep``. The JAX package compiles
the whole step into one XLA executable; here it runs eagerly (the
flash-attention kernels inside it are the card's own), and a CUDA-graph
capture of the step is a later item of the port.

Usage::

    step = TrainStep(model, loss_fn, optimizer)
    loss = step(ids, labels)     # 0-dim f32 tensor on the model's device

``loss_fn(outputs, *labels)`` returns a scalar. With more than one
argument the last is the labels, as in the JAX ``TrainStep``. The step
runs the model in training mode (dropout on), as the JAX step traces
it, and, as the JAX step differentiates the whole trainable tree, a
parameter the loss does not reach gets a zero gradient (AdamW still
decays it).
"""
from __future__ import annotations

import torch

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    @staticmethod
    def _split(batch):
        if len(batch) > 1:
            return list(batch[:-1]), [batch[-1]]
        return list(batch), []

    def __call__(self, *batch) -> torch.Tensor:
        """One step: the loss (cast to f32, as the JAX step's
        ``cast_loss_f32``), its backward, the optimizer update and the
        gradients cleared. Returns the loss without a host sync."""
        ins, lbls = self._split(batch)
        if not self.model.training:
            self.model.train()
        loss = self.loss_fn(self.model(*ins), *lbls).float()
        loss.backward()
        for p in self.optimizer._parameter_list:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()
