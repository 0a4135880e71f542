"""Loss layers of the port: ``CrossEntropyLoss``.

The port of ``paddle_tpu/nn/layers_loss.py`` ``CrossEntropyLoss`` over
:func:`~paddle_tpu_torch.nn.functional.cross_entropy` (a big-vocab
hard-label mean takes the chunked fused cross-entropy), as a
:class:`~.layer.Layer`: Tensors in, a Tensor out; torch tensors in, a
torch tensor out.
"""
from __future__ import annotations

from .functional import cross_entropy
from .layer import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", soft_label: bool = False,
                 axis: int = -1, use_softmax: bool = True,
                 label_smoothing: float = 0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return cross_entropy(
            input, label, weight=self.weight,
            ignore_index=self.ignore_index, reduction=self.reduction,
            soft_label=self.soft_label, axis=self.axis,
            use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)
