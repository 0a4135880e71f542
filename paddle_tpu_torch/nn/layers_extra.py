"""The long-tail layers of the port (``paddle_tpu/nn/layers_extra.py``):
thin Layers over the port's functionals, with the JAX package's
constructors, parameter names and initializers (``HSigmoidLoss``'s node
table and bias, ``AdaptiveLogSoftmaxWithLoss``'s head and
``_tail_{i}_{0,1}`` projections). ``FeatureAlphaDropout`` and
``FractionalMaxPool2D`` / ``3D`` draw on the host through their
functionals, which count those draws.
"""
from __future__ import annotations

import math

import torch

from . import functional as F
from .initializer import Uniform
from .layer import Layer

__all__ = [
    "PairwiseDistance", "Softmax2D", "Unflatten", "FeatureAlphaDropout",
    "ZeroPad1D", "ZeroPad3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "LPPool1D", "LPPool2D", "FractionalMaxPool2D", "FractionalMaxPool3D",
    "RNNTLoss", "HSigmoidLoss", "TripletMarginWithDistanceLoss",
    "AdaptiveLogSoftmaxWithLoss",
]


class PairwiseDistance(Layer):
    """ref: nn/layer/distance.py PairwiseDistance."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Softmax2D(Layer):
    """ref: nn/layer/activation.py Softmax2D — softmax over the channel
    dim of NCHW input."""

    def forward(self, x):
        if len(x.shape) not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3D/4D input, got {len(x.shape)}D")
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    """ref: nn/layer/common.py Unflatten."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, list(shape)

    def forward(self, x):
        from ..ops.manipulation import reshape
        s = list(x.shape)
        ax = self.axis if self.axis >= 0 else self.axis + len(s)
        new = s[:ax] + self.shape + s[ax + 1:]
        return reshape(x, new)


class FeatureAlphaDropout(Layer):
    """ref: nn/layer/common.py FeatureAlphaDropout."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, self.training)


class ZeroPad1D(Layer):
    """ref: nn/layer/common.py ZeroPad1D — pad [left, right] on NCL."""

    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding = [padding, padding] if isinstance(padding, int) \
            else list(padding)
        self.data_format = data_format

    def forward(self, x):
        from ..ops.manipulation import pad
        return pad(x, self.padding, mode="constant", value=0.0,
                   data_format=self.data_format)


class ZeroPad3D(Layer):
    """ref: nn/layer/common.py ZeroPad3D — [l, r, t, b, front, back]."""

    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self.padding = [padding] * 6 if isinstance(padding, int) \
            else list(padding)
        self.data_format = data_format

    def forward(self, x):
        from ..ops.manipulation import pad
        return pad(x, self.padding, mode="constant", value=0.0,
                   data_format=self.data_format)


class _UnpoolNd(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format
        self.output_size = output_size


class MaxUnPool1D(_UnpoolNd):
    """ref: nn/layer/pooling.py MaxUnPool1D."""

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format or "NCL",
                              self.output_size)


class MaxUnPool2D(_UnpoolNd):
    """ref: nn/layer/pooling.py MaxUnPool2D."""

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format or "NCHW",
                              self.output_size)


class MaxUnPool3D(_UnpoolNd):
    """ref: nn/layer/pooling.py MaxUnPool3D."""

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format or "NCDHW",
                              self.output_size)


class LPPool1D(Layer):
    """ref: nn/layer/pooling.py LPPool1D."""

    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.norm_type = norm_type
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.lp_pool1d(x, self.norm_type, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode, self.data_format)


class LPPool2D(Layer):
    """ref: nn/layer/pooling.py LPPool2D."""

    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.norm_type = norm_type
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.lp_pool2d(x, self.norm_type, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode, self.data_format)


class FractionalMaxPool2D(Layer):
    """ref: nn/layer/pooling.py FractionalMaxPool2D."""

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size, self.kernel_size = output_size, kernel_size
        self.random_u, self.return_mask = random_u, return_mask

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size,
                                       self.kernel_size, self.random_u,
                                       self.return_mask)


class FractionalMaxPool3D(Layer):
    """ref: nn/layer/pooling.py FractionalMaxPool3D."""

    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size, self.kernel_size = output_size, kernel_size
        self.random_u, self.return_mask = random_u, return_mask

    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size,
                                       self.kernel_size, self.random_u,
                                       self.return_mask)


class RNNTLoss(Layer):
    """ref: nn/layer/loss.py RNNTLoss."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           self.blank, self.fastemit_lambda, self.reduction)


class HSigmoidLoss(Layer):
    """ref: nn/layer/loss.py HSigmoidLoss — holds the internal-node
    weight table [num_classes-1, feature_size] (+bias)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if (num_classes < 2) and (not is_custom):
            raise ValueError(
                "num_classes must not be less than 2 with default tree")
        self.num_classes = num_classes
        self.is_custom = is_custom
        n_nodes = num_classes if is_custom else num_classes - 1
        std = math.sqrt(1.0 / (feature_size + 1))
        self.weight = self.create_parameter(
            [n_nodes, feature_size], attr=weight_attr,
            default_initializer=Uniform(-std, std))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [n_nodes, 1], attr=bias_attr, is_bias=True,
                default_initializer=Uniform(-std, std))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)


class TripletMarginWithDistanceLoss(Layer):
    """ref: nn/layer/loss.py TripletMarginWithDistanceLoss."""

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """ref: nn/layer/loss.py AdaptiveLogSoftmaxWithLoss (Grave et al.).
    Owns head + per-cluster tail projections (div_value decay)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if any(int(c) <= 0 for c in cutoffs) or \
                sorted(set(cutoffs)) != sorted(cutoffs) or \
                max(cutoffs) > n_classes - 1:
            raise ValueError(
                "cutoffs must be unique, positive, increasing ints "
                "below n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.shortlist_size = cutoffs[0]
        self.n_clusters = len(cutoffs)
        self.head_size = self.shortlist_size + self.n_clusters
        self.head_weight = self.create_parameter(
            [in_features, self.head_size], attr=weight_attr)
        self.head_bias = (self.create_parameter(
            [self.head_size], attr=bias_attr, is_bias=True)
            if head_bias else None)
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features // (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = self.create_parameter([in_features, hsz],
                                       attr=weight_attr)
            w2 = self.create_parameter([hsz, osz], attr=weight_attr)
            setattr(self, f"_tail_{i}_0", w1)
            setattr(self, f"_tail_{i}_1", w2)
            self.tail_weights.append([w1, w2])  # the creation-time wrappers

    def forward(self, input, label):
        tails = [[getattr(self, f"_tail_{i}_0"), getattr(self, f"_tail_{i}_1")]
                 for i in range(self.n_clusters)]
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, tails, self.cutoffs[:-1],
            self.head_bias)

    def log_prob(self, input):
        """Full ``[N, n_classes]`` log-probabilities."""
        from ..core.autograd import apply_op

        def f(x, hw, *rest):
            hb = rest[0] if self.head_bias is not None else None
            tails = rest[1:] if self.head_bias is not None else rest
            head_logits = x @ hw
            if hb is not None:
                head_logits = head_logits + hb
            z = head_logits - head_logits.amax(-1, keepdim=True)
            head_lp = torch.log(torch.clamp(
                torch.exp(z) / torch.exp(z).sum(-1, keepdim=True), 1e-38))
            outs = [head_lp[:, :self.shortlist_size]]
            for i in range(self.n_clusters):
                w1, w2 = tails[2 * i], tails[2 * i + 1]
                t = (x @ w1) @ w2
                t = t - t.amax(-1, keepdim=True)
                t_lp = t - torch.log(torch.exp(t).sum(-1, keepdim=True))
                outs.append(head_lp[:, self.shortlist_size + i:
                                    self.shortlist_size + i + 1] + t_lp)
            return torch.cat(outs, dim=-1)

        args = [self.head_weight]
        if self.head_bias is not None:
            args.append(self.head_bias)
        for i in range(self.n_clusters):
            args += [getattr(self, f"_tail_{i}_0"),
                     getattr(self, f"_tail_{i}_1")]
        return apply_op(f, input, *args, op_name="adaptive_log_prob")

    def predict(self, input):
        from ..ops.math import argmax
        return argmax(self.log_prob(input), axis=-1)
