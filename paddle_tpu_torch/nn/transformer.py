"""Transformer layers of the port (``paddle_tpu/nn/transformer.py``).

``MultiHeadAttention``, ``TransformerEncoderLayer``,
``TransformerEncoder``, ``TransformerDecoderLayer``,
``TransformerDecoder`` and ``Transformer`` as ``torch.nn.Module`` trees
with the JAX parameter names (``q_proj``, ``k_proj``, ``v_proj``,
``out_proj``, ``self_attn``, ``cross_attn``, ``linear1``, ``linear2``,
``norm1`` .. ``norm3``, ``encoder``, ``decoder``), and the JAX
constructors (``weight_attr`` / ``bias_attr``: an initializer or a
``ParamAttr`` for the weights and biases, ``bias_attr=False`` for no
biases). Attention goes through
:func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`:
without a mask the flash kernels, with attention dropout inside them in
training, whatever the query and key lengths (cross-attention runs the
target's queries against the source's keys; ``cache=`` appends the new
keys to the cached ones); with a mask (the decoder's
``generate_square_subsequent_mask``) the plain sdpa, as the JAX entry
routes it. The classes are Layers (:class:`~.layer.Layer`) whose
``forward`` is written against torch tensors (``_torch_forward``): paddle
code calls them with Tensors and gets Tensors back, torch parents (BERT)
with torch tensors. Their projections are ``torch.nn.Linear`` (``[out,
in]`` weights; the JAX layers' are ``[in, out]``:
``convert.state_dict_from_jax(..., model=)`` transposes them).
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from . import functional as F
from . import initializer as I
from .layer import Layer, ParamAttr
from .layers_common import Dropout
from .layers_conv_norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _linear(in_features: int, out_features: int, weight_attr, bias_attr,
            kw) -> nn.Linear:
    """``torch.nn.Linear`` under paddle's attributes: ``bias_attr=False``
    drops the bias; an initializer (bare or in a ``ParamAttr``) draws the
    ``[in, out]`` weight (or the bias) as the JAX ``Linear`` does;
    ``trainable=False`` freezes it."""
    lin = nn.Linear(in_features, out_features, bias=bias_attr is not False,
                    **kw)
    for attr, param, shape in ((weight_attr, lin.weight,
                                (in_features, out_features)),
                               (bias_attr, lin.bias, (out_features,))):
        if param is None:
            continue
        init = attr.initializer if isinstance(attr, ParamAttr) else \
            attr if isinstance(attr, I.Initializer) else None
        if init is not None:
            with torch.no_grad():
                val = init(shape, param.dtype, param.device)
                param.copy_(val.t() if val.dim() == 2 else val)
        if isinstance(attr, ParamAttr) and not attr.trainable:
            param.requires_grad_(False)
    return lin


def _convert_attention_mask(attn_mask):
    """A bool mask (True = keep, the paddle convention) becomes an
    additive one; a float mask is already additive."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        return (1.0 - attn_mask.float()) * -1e9
    return attn_mask


class MultiHeadAttention(Layer):
    """Attention over ``num_heads`` heads of ``embed_dim // num_heads``.
    ``forward(query, key=None, value=None, attn_mask=None, cache=None)``:
    keys default to the queries, values to the keys; with ``cache`` (a
    pair ``(k, v)`` of ``[B, L, heads, head_dim]`` or ``None``) the new
    keys and values are appended to the cached ones and ``(out, (k,
    v))`` is returned."""
    _torch_forward = True

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim=None, vdim=None, need_weights: bool = False,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, dtype=dtype)
        self.q_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr,
                              kw)
        self.k_proj = _linear(kdim or embed_dim, embed_dim, weight_attr,
                              bias_attr, kw)
        self.v_proj = _linear(vdim or embed_dim, embed_dim, weight_attr,
                              bias_attr, kw)
        self.out_proj = _linear(embed_dim, embed_dim, weight_attr,
                                bias_attr, kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        b = query.shape[0]
        q = self.q_proj(query).view(b, -1, self.num_heads, self.head_dim)
        k = self.k_proj(key).view(b, -1, self.num_heads, self.head_dim)
        v = self.v_proj(value).view(b, -1, self.num_heads, self.head_dim)
        if cache is not None:
            if cache[0] is not None:
                k = torch.cat([cache[0], k], dim=1)
            if cache[1] is not None:
                v = torch.cat([cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask),
            dropout_p=self.dropout, training=self.training)
        out = self.out_proj(out.reshape(b, -1, self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out


class TransformerEncoderLayer(Layer):
    _torch_forward = True

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout=None, act_dropout=None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, layer_norm_eps: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr, kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr, kw)
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


class TransformerDecoderLayer(Layer):
    """Self-attention over the target (``tgt_mask``), cross-attention of
    the target's queries over ``memory`` (``memory_mask``), then the
    feed-forward block, each with its residual and norm (before or after,
    ``normalize_before``)."""
    _torch_forward = True

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout=None, act_dropout=None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, layer_norm_eps: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        attn = dict(weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attn)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **attn)
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr, kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr, kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer`` (deep copies, as the
    JAX class makes them), then ``norm`` if given."""
    _torch_forward = True

    def __init__(self, decoder_layer: TransformerDecoderLayer,
                 num_layers: int, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    """The encoder-decoder of "Attention Is All You Need": ``forward(src,
    tgt, src_mask=None, tgt_mask=None, memory_mask=None)`` encodes
    ``src`` and decodes ``tgt`` against it (``[B, L, d_model]`` each; no
    embeddings or output projection, as in paddle). ``custom_encoder`` /
    ``custom_decoder`` replace the stacks; with ``normalize_before`` each
    stack ends in a LayerNorm."""
    _torch_forward = True

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", attn_dropout=None,
                 act_dropout=None, normalize_before: bool = False,
                 weight_attr=None, bias_attr=None, custom_encoder=None,
                 custom_decoder=None, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length: int):
        """The bool ``[length, length]`` mask that lets position i see
        positions <= i (True = keep), a Tensor on the current device."""
        from ..core.device import current_device
        from ..core.tensor import Tensor
        return Tensor(torch.ones((length, length), dtype=torch.bool,
                                 device=current_device()).tril())
