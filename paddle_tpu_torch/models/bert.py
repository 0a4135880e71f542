"""BERT family (encoder + MLM head), as a PyTorch module tree.

The port of ``paddle_tpu.models.bert`` (the JAX package's BASELINE
workload 2, BERT-base MLM). The parameter names are the JAX model's
``named_parameters()`` names (``bert.embeddings.word_embeddings.weight``,
``bert.encoder.layers.0.self_attn.q_proj.weight``, ...,
``decoder.bias``), so ``convert.load_from_jax`` carries a JAX checkpoint
across by name. The encoder is the port's ``nn.TransformerEncoder``:
post-norm layers, erf GELU, dropout after the embeddings, on the
attention output, inside the FFN and on its output, and attention
dropout inside the flash kernels (with the model in training mode; the
port's ``TrainStep`` puts it there).

``device`` defaults to ``cuda`` (see ``core.device.resolve_device``);
parameters are created in ``dtype`` and drawn from ``generator``
(default: a fresh generator seeded 0 on ``device``) at the JAX
initializers' scales: N(0, 0.02) embeddings, Xavier-normal Linear
weights with zero biases, unit LayerNorm weights with zero biases.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layers_common import Dropout
from ..nn.layers_conv_norm import LayerNorm
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertForMaskedLM"]


@dataclass
class BertConfig:
    """Defaults = BERT-base."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=128)
        base.update(kw)
        return BertConfig(**base)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size,
                                                  config.hidden_size, **kw)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        h = self.word_embeddings(input_ids) + self.position_embeddings(
            pos)[None]
        if token_type_ids is not None:
            h = h + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(h))


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device, dtype)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.dropout,
            activation="gelu", layer_norm_eps=config.layer_norm_eps,
            device=device, dtype=dtype)
        self.encoder = TransformerEncoder(enc_layer,
                                          config.num_hidden_layers)
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size,
                                device=device, dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids)
        h = self.encoder(h, attention_mask)
        pooled = F.tanh(self.pooler(h[:, 0]))
        return h, pooled


class BertForMaskedLM(nn.Module):
    """BERT with the MLM head: ``input_ids [B, L] -> logits [B, L, V]``."""

    def __init__(self, config: BertConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.bert = BertModel(config, dev, dtype)
        kw = dict(device=dev, dtype=dtype)
        self.transform = nn.Linear(config.hidden_size, config.hidden_size,
                                   **kw)
        self.transform_norm = LayerNorm(config.hidden_size,
                                        config.layer_norm_eps, **kw)
        self.decoder = nn.Linear(config.hidden_size, config.vocab_size,
                                 **kw)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                fan_out, fan_in = m.weight.shape
                m.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                                 generator=g)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=g)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(F.gelu(self.transform(h)))
        return self.decoder(h)
