"""GPT (GPT-2/3-style decoder) of the port: ``GPTConfig``,
``GPTAttention``, ``GPTBlock`` and ``GPTForCausalLM``.

The port of ``paddle_tpu.models.gpt``, written on the paddle-API core
as the JAX model is: Layers (:class:`~paddle_tpu_torch.nn.Layer`) with paddle
``Linear`` (``[in, out]`` weights, so a JAX state dict loads without
transposes), ``Embedding``, ``LayerNorm``, ``Dropout``, ``F.gelu`` and
``apply_op``. Pre-LN blocks with learned positions.

``GPTAttention`` projects with one ``qkv_proj``, splits q, k and v
(strided views of it, read in place by the kernels) into heads of
``hidden / heads`` and attends causally: through the flash-attention
entry (``ops.kernels.flash_attention``: at bf16 and head dim 64 or 128
the TMA kernels K1/K2 on the card, the plain versions on the CPU) when
``use_flash_attention`` is set, through the plain
:func:`~paddle_tpu_torch.nn.functional.sdpa_reference` otherwise.
ERNIE-MoE builds its attention from it, called with torch tensors.
``shard_gpt`` waits for the distributed plane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.autograd import apply_op
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.container import LayerList
from ..nn.functional.attention import sdpa_reference
from ..nn.layer import Layer
from ..nn.layers_common import Dropout, Embedding, Linear, _place
from ..nn.layers_conv_norm import LayerNorm
from ..ops.kernels.flash_attention import flash_attention

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTForCausalLM"]


@dataclass
class GPTConfig:
    """The JAX package's defaults (GPT-style widths, 12 layers); the
    13B geometry is ``GPTConfig(hidden_size=5120, num_hidden_layers=40,
    num_attention_heads=40, intermediate_size=20480)``."""
    vocab_size: int = 50304
    hidden_size: int = 768
    intermediate_size: Optional[int] = None    # default 4 * hidden
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    dropout: float = 0.0
    use_flash_attention: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
        base.update(kw)
        return GPTConfig(**base)


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.hidden_size = config.hidden_size
        self.use_flash = config.use_flash_attention
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = Linear(config.hidden_size, 3 * config.hidden_size,
                               **kw)
        self.out_proj = Linear(config.hidden_size, config.hidden_size, **kw)

    def _attend(self, qkv: torch.Tensor) -> torch.Tensor:
        b, l, _ = qkv.shape
        q, k, v = (x.view(b, l, self.num_heads, self.head_dim)
                   for x in qkv.split(self.hidden_size, dim=-1))
        if self.use_flash:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = sdpa_reference(q, k, v, causal=True)
        return out.reshape(b, l, self.hidden_size)

    def forward(self, h):
        qkv = self.qkv_proj(h)
        return self.out_proj(apply_op(self._attend, qkv,
                                      op_name="gpt_attention"))


class GPTBlock(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, config.layer_norm_eps,
                              **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, config.layer_norm_eps,
                              **kw)
        self.fc_in = Linear(config.hidden_size, config.intermediate_size,
                            **kw)
        self.fc_out = Linear(config.intermediate_size, config.hidden_size,
                             **kw)
        self.drop = Dropout(config.dropout)

    def forward(self, h):
        h = h + self.attn(self.ln_1(h))
        return h + self.drop(self.fc_out(F.gelu(self.fc_in(self.ln_2(h)))))


def _positions(ids: torch.Tensor) -> torch.Tensor:
    return torch.arange(ids.shape[1], device=ids.device)[None, :]


class GPTForCausalLM(Layer):
    """``input_ids [B, L] -> logits [B, L, V]``. The parameters are made
    on ``device`` (else the current device: the card unless
    ``set_device("cpu")``) in ``dtype`` (else the default dtype)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        _place(self, device, dtype)
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.wte = Embedding(config.vocab_size, config.hidden_size,
                             weight_attr=I.Normal(0.0, 0.02), **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size,
                             weight_attr=I.Normal(0.0, 0.02), **kw)
        self.blocks = LayerList([GPTBlock(config, **kw)
                                 for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps,
                              **kw)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias_attr=False, **kw)

    def forward(self, input_ids):
        h = self.wte(input_ids) + self.wpe(apply_op(_positions, input_ids))
        for blk in self.blocks:
            h = blk(h)
        return self.lm_head(self.ln_f(h))
