"""GPT parts that ERNIE-MoE builds on: ``GPTConfig`` and ``GPTAttention``.

The port of the ``paddle_tpu.models.gpt`` pieces that
``models/ernie_moe.py`` imports. ``GPTAttention`` projects with one
``qkv_proj`` Linear, splits q, k and v (strided views, read in place by
the flash kernels) into heads of ``hidden / heads`` and attends
causally: through the flash-attention entry
(``ops.kernels.flash_attention``, the Hopper kernels on the card, their
plain versions on the CPU) when ``use_flash_attention`` is set, through
the plain :func:`~paddle_tpu_torch.nn.functional.sdpa_reference`
otherwise. ``GPTBlock``, ``GPTForCausalLM`` and ``shard_gpt`` are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from torch import nn

from ..nn.functional.attention import sdpa_reference
from ..ops.kernels.flash_attention import flash_attention

__all__ = ["GPTConfig", "GPTAttention"]


@dataclass
class GPTConfig:
    """The JAX package's defaults (GPT-style widths, 12 layers)."""
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


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.hidden_size = config.hidden_size
        self.use_flash = config.use_flash_attention
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = nn.Linear(config.hidden_size, 3 * config.hidden_size,
                                  **kw)
        self.out_proj = nn.Linear(config.hidden_size, config.hidden_size,
                                  **kw)

    def forward(self, h):
        b, l, _ = h.shape
        q, k, v = (x.view(b, l, self.num_heads, self.head_dim)
                   for x in self.qkv_proj(h).split(self.hidden_size, dim=-1))
        if self.use_flash:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = sdpa_reference(q, k, v, causal=True)
        return self.out_proj(out.reshape(b, l, self.hidden_size))
