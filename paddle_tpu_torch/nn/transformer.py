"""Transformer encoder layers of the port.

The port of ``paddle_tpu/nn/transformer.py`` ``MultiHeadAttention``,
``TransformerEncoderLayer`` and ``TransformerEncoder`` as
``torch.nn.Module`` trees with the JAX parameter names (``q_proj``,
``k_proj``, ``v_proj``, ``out_proj``, ``linear1``, ``linear2``,
``norm1``, ``norm2``). Projections are ``torch.nn.Linear`` with biases.
Attention goes through
:func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`:
without a mask the flash kernels, with attention dropout inside them in
training; with a mask the plain sdpa. The three classes are
Layers (:class:`~.layer.Layer`) whose ``forward`` is written against torch
tensors (``_torch_forward``): paddle code calls them with Tensors and
gets Tensors back, torch parents (BERT) with torch tensors. Their
projections stay ``torch.nn.Linear`` (``[out, in]`` weights; the JAX
layers' are ``[in, out]``). The decoder is not ported yet.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from . import functional as F
from .layer import Layer
from .layers_common import Dropout
from .layers_conv_norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


def _convert_attention_mask(attn_mask):
    """A bool mask (True = keep, the paddle convention) becomes an
    additive one; a float mask is already additive."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        return (1.0 - attn_mask.float()) * -1e9
    return attn_mask


class MultiHeadAttention(Layer):
    _torch_forward = True

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim=None, vdim=None, need_weights: bool = False,
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(bias=bias, device=device, dtype=dtype)
        self.q_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.k_proj = nn.Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = nn.Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        b = query.shape[0]
        q = self.q_proj(query).view(b, -1, self.num_heads, self.head_dim)
        k = self.k_proj(key).view(b, -1, self.num_heads, self.head_dim)
        v = self.v_proj(value).view(b, -1, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask),
            dropout_p=self.dropout, training=self.training)
        return self.out_proj(out.reshape(b, -1, self.embed_dim))


class TransformerEncoderLayer(Layer):
    _torch_forward = True

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout=None, act_dropout=None,
                 normalize_before: bool = False,
                 layer_norm_eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = nn.Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (deep copies, as the
    JAX class makes them), then ``norm`` if given."""
    _torch_forward = True

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
