"""``TrainStep``: forward, loss, backward and update as one call.

The port of ``paddle_tpu.jit.api.TrainStep``: as there, a thin wrapper
over the whole-step capture engine, ``jit.sot.CapturedStep`` in
non-strict mode with ``cast_loss_f32``. On the card the step runs as one
CUDA graph a signature (forward, loss, backward and the fused optimizer
update, dropout's keys drawn on the device inside it); the first call of
a signature runs eager once (it builds the kernels, the optimizer state
and cuBLAS's workspaces), and a step the card cannot capture runs eager
with the reason counted in ``stats["fallbacks"]`` (``"device"`` for a
model on the CPU, ``"optimizer"`` for a per-parameter optimizer such as
SGD or ``FLAGS_fused_optimizer=0``, ``"hooks"``, ``"rng"`` for a host
draw). The eager step computes the same thing with the same kernels,
on the stream the engine captures on (``CapturedStep.eager_stream``).

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
        from .sot import CapturedStep
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._step = CapturedStep(model, loss_fn, optimizer,
                                  cast_loss_f32=True, strict=False,
                                  name="train_step")

    @property
    def stats(self):
        """The engine's counts: ``captured_steps``, ``compiles``,
        ``eager_steps``, ``fallbacks`` by reason."""
        return self._step.stats

    @staticmethod
    def _split(batch):
        if len(batch) > 1:
            return list(batch[:-1]), [batch[-1]]
        return list(batch), []

    def __call__(self, *batch):
        """One step: the loss (cast to f32), its backward, the optimizer
        update and the gradients cleared. Returns the loss without a
        host sync."""
        ins, lbls = self._split(batch)
        if not self.model.training:
            self.model.train()
        loss = self._step.step(ins, lbls)
        if loss is None:
            with self._step.eager_stream():
                loss = self._eager(ins, lbls)
            self._step.eager_done()
        return loss

    def _eager(self, ins, lbls):
        loss = self.loss_fn(self.model(*ins), *lbls)
        loss = loss.float() if isinstance(loss, torch.Tensor) \
            else loss.astype("float32")
        loss.backward()
        for p in self.optimizer._parameter_list:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.optimizer.clear_grad()
        # detached: a loss that kept its graph would keep the leaves'
        # gradient accumulators alive into the next capture
        return loss.detach()
