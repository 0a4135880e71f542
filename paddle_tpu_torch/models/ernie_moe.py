"""ERNIE-MoE: a pre-LN causal transformer LM with MoE FFNs.

The port of ``paddle_tpu.models.ernie_moe`` (the JAX package's BASELINE
workload 5). The parameter names are the JAX model's
``named_parameters()`` names (``wte.weight``,
``blocks.0.attn.qkv_proj.weight``, ``blocks.1.moe.w_in``,
``blocks.1.moe.gate.weight``, ..., ``lm_head.weight``), so
``convert.load_from_jax`` carries a JAX checkpoint across by name: the
``torch.nn.Linear`` weights (embeddings aside: the FFN and ``lm_head``)
transposed; the attention's paddle ``Linear`` weights (``[in, out]``),
the expert stacks and the gate weight copied as they are. Layer i is an MoE layer
(``incubate.moe.MoELayer``, GShard top-2 with capacity, index dispatch,
tanh-GELU experts) when ``i % moe_every == moe_every - 1``, else a
Linear–erf GELU–Linear FFN; attention is ``GPTAttention`` (causal flash
attention). :meth:`ErnieMoEForCausalLM.total_aux_loss` is the weighted
sum of the MoE layers' load-balance losses of the last forward, to be
added to the LM loss.

``device`` defaults to ``cuda`` (see ``core.device.resolve_device``);
parameters are created in ``dtype`` and drawn from ``generator``
(default: a fresh generator seeded 0 on ``device``) at the JAX
initializers' scales: N(0, 0.02) embeddings, Xavier-normal Linear
weights with zero biases, unit LayerNorm weights with zero biases, the
gate Xavier-uniform and the experts U(±1/√hidden).

Not ported yet: ``shard_experts`` (expert parallelism).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from ..core.device import resolve_device
from ..incubate.moe import MoELayer
from ..nn import functional as F
from ..nn.layers_common import Linear as PaddleLinear
from ..nn.layers_conv_norm import LayerNorm
from .gpt import GPTAttention, GPTConfig

__all__ = ["ErnieMoEConfig", "ErnieMoEBlock", "ErnieMoEForCausalLM"]


@dataclass
class ErnieMoEConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2          # every Nth layer is MoE
    aux_loss_weight: float = 0.01
    layer_norm_eps: float = 1e-5
    use_flash_attention: bool = True

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=128, num_experts=4)
        base.update(kw)
        return ErnieMoEConfig(**base)

    def _attn_cfg(self) -> GPTConfig:
        return GPTConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            max_position_embeddings=self.max_position_embeddings,
            use_flash_attention=self.use_flash_attention)


class ErnieMoEBlock(nn.Module):
    def __init__(self, config: ErnieMoEConfig, use_moe: bool, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, config.layer_norm_eps, **kw)
        self.attn = GPTAttention(config._attn_cfg(), **kw)
        self.ln_2 = LayerNorm(config.hidden_size, config.layer_norm_eps, **kw)
        self.use_moe = use_moe
        if use_moe:
            self.moe = MoELayer(config.hidden_size, config.intermediate_size,
                                config.num_experts, gate="gshard",
                                top_k=config.top_k,
                                capacity_factor=config.capacity_factor,
                                generator=generator, **kw)
        else:
            self.fc_in = nn.Linear(config.hidden_size,
                                   config.intermediate_size, **kw)
            self.fc_out = nn.Linear(config.intermediate_size,
                                    config.hidden_size, **kw)

    def forward(self, h):
        h = h + self.attn(self.ln_1(h))
        if self.use_moe:
            return h + self.moe(self.ln_2(h))
        return h + self.fc_out(F.gelu(self.fc_in(self.ln_2(h))))


class ErnieMoEForCausalLM(nn.Module):
    """``input_ids [B, L] -> logits [B, L, V]``."""

    def __init__(self, config: ErnieMoEConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(device=dev, dtype=dtype)
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, **kw)
        self.blocks = nn.ModuleList([
            ErnieMoEBlock(config, i % config.moe_every ==
                          config.moe_every - 1, generator=generator, **kw)
            for i in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_eps, **kw)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, **kw)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        """The Linear and Embedding draws (the MoE layers drew their own
        gate and experts when they were built). A paddle ``Linear``
        (the attention's, ``[in, out]``) takes the draw a
        ``torch.nn.Linear`` of its shape would, transposed."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                fan_out, fan_in = m.weight.shape
                m.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                                 generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, PaddleLinear):
                w, b = m._parameters["weight"], m._parameters["bias"]
                fan_in, fan_out = w.shape
                w.copy_(torch.empty(fan_out, fan_in, dtype=w.dtype,
                                    device=w.device).normal_(
                    0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                    generator=g).t())
                if b is not None:
                    b.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=g)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        h = self.wte(input_ids) + self.wpe(pos)[None]
        for blk in self.blocks:
            h = blk(h)
        return self.lm_head(self.ln_f(h))

    def moe_layers(self):
        return [blk.moe for blk in self.blocks if blk.use_moe]

    def total_aux_loss(self) -> Optional[torch.Tensor]:
        """The MoE layers' load-balance losses of the last forward,
        summed and scaled by ``aux_loss_weight``; None without any."""
        losses = [m.aux_loss for m in self.moe_layers()
                  if m.aux_loss is not None]
        if not losses:
            return None
        return sum(losses[1:], losses[0]) * self.config.aux_loss_weight
