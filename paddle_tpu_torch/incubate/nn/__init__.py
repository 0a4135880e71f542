"""``incubate.nn`` of the port: the fused transformer building blocks
and their functionals (``incubate.nn.functional``).

The port of ``paddle_tpu/incubate/nn/__init__.py``, with its signatures
(the arguments the JAX layers accept and ignore included) and its
parameter names (``qkv``, ``out_proj``, ``ln``, ``linear1``,
``linear2``), so a JAX ``state_dict()`` loads key for key: the layers
are the port's paddle ``Linear`` / ``LayerNorm`` / ``Dropout``, whose
weights keep the JAX ``[in, out]`` layout. "Fused" names the API, as in
JAX: :class:`FusedMultiHeadAttention` runs one ``qkv`` product and
calls ``scaled_dot_product_attention`` on its ``[B, L, H, D]`` views —
without a mask the flash kernels (K1a/K1b forward, K2a/K2b backward;
K5's in-kernel dropout with ``attn_dropout_rate`` in training), with
one the plain ``sdpa_reference``, as the JAX entry routes them.
"""
from ... import nn as _nn
from ...nn.functional.attention import scaled_dot_product_attention
from . import functional  # noqa: F401
from .functional import fused_dropout_add

__all__ = [
    "FusedLinear", "FusedDropoutAdd", "FusedMultiHeadAttention",
    "FusedFeedForward", "FusedTransformerEncoderLayer", "functional",
]


class FusedLinear(_nn.Linear):
    """``x W + b``: the port's ``Linear``."""


class FusedDropoutAdd(_nn.Layer):
    """``dropout(x) + y``."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return fused_dropout_add(x, y, self.p, self.training, self.mode)


class FusedMultiHeadAttention(_nn.Layer):
    """Pre- or post-LN self-attention with its residual; one ``qkv``
    product, the attention through the flash entry."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(
                f"num_heads ({num_heads}) must divide embed_dim "
                f"({embed_dim})")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.qkv = _nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = _nn.Linear(embed_dim, embed_dim)
        self.ln = _nn.LayerNorm(embed_dim, epsilon=epsilon)
        self.dropout = _nn.Dropout(dropout_rate)
        self.attn_dropout_rate = attn_dropout_rate

    def forward(self, x, attn_mask=None, cache=None):
        residual = x
        if self.normalize_before:
            x = self.ln(x)
        b, l, _ = x.shape
        qkv = self.qkv(x).reshape([b, l, 3, self.num_heads, self.head_dim])
        q = qkv[:, :, 0]
        k = qkv[:, :, 1]
        v = qkv[:, :, 2]
        attn = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate if self.training else 0.0)
        out = self.out_proj(attn.reshape([b, l, self.embed_dim]))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedFeedForward(_nn.Layer):
    """The position-wise FFN with its residual; one ``ln`` serves the
    pre- and the post-norm position, as in JAX."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.linear1 = _nn.Linear(d_model, dim_feedforward)
        self.linear2 = _nn.Linear(dim_feedforward, d_model)
        self.ln = _nn.LayerNorm(d_model, epsilon=epsilon)
        self.dropout = _nn.Dropout(dropout_rate)
        self.act_dropout = _nn.Dropout(
            dropout_rate if act_dropout_rate is None else act_dropout_rate)
        self.activation = getattr(_nn.functional, activation)

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = self.ln(x)
        x = self.act_dropout(self.activation(self.linear1(x)))
        x = residual + self.dropout(self.linear2(x))
        if not self.normalize_before:
            x = self.ln(x)
        return x


class FusedTransformerEncoderLayer(_nn.Layer):
    """:class:`FusedMultiHeadAttention` then :class:`FusedFeedForward`;
    ``cache`` is accepted and ignored, as in JAX."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
