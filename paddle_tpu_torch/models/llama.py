"""Llama family: the flagship causal LM, as a PyTorch module tree.

The port of ``paddle_tpu.models.llama``. The parameter names are the
JAX model's ``named_parameters()`` names (``llama.embed_tokens.weight``,
``llama.layers.0.self_attn.q_proj.weight``, ..., ``lm_head.weight``),
so ``convert.load_from_jax`` carries a JAX checkpoint across by name.
Projections are ``torch.nn.Linear`` and keep its ``[out, in]`` weight
layout (the JAX ``Linear`` is ``[in, out]``; ``convert`` transposes).

The cache-free forward here is the model's own path (training, tests,
scoring); serving rebuilds the same math from the state dict in
``serving.LlamaDecodeEngine``. Attention without a mask goes through
the flash-attention entry (``ops.kernels.flash_attention``) when
``use_flash_attention`` is set: the Hopper kernels on the card, their
plain versions on the CPU. A mask, or the flag off, takes the plain
:func:`~paddle_tpu_torch.nn.functional.sdpa_reference`, as the JAX
model routes them. :class:`LlamaPretrainingCriterion` is the causal-LM
loss over the chunked fused cross-entropy (``ops.fused_ce``).

``LlamaConfig.recompute`` runs each decoder block under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` when no
caches are passed: the counterpart of the JAX model's ``_remat_layer``
(``jax.checkpoint``), so the backward runs each block's forward again
(the flash forward included) instead of keeping its activations. The
RNG stash is off (``preserve_rng_state=False``): torch's stash reads
the host generator, which does not belong in a CUDA graph capture, and
Llama's blocks draw no random numbers. A recomputed block that held one
of the port's random ops would need its key stream put back to the
position of the first run before the recompute.

The cache path is the JAX model's: ``forward(ids, caches=[(k, v), ...],
position_offset=n)`` returns ``(logits, new_caches)``, each layer's
keys and values concatenated after its cache (kept before the GQA
repeat); RoPE starts at ``position_offset``. A call with empty caches
and no mask takes the flash entry (the prefill); a call with a cache,
or with a mask, takes :func:`sdpa_reference` with the causal diagonal
offset by the cached length, as the JAX model's ``_sdpa_xla``.
:meth:`LlamaForCausalLM.generate` is greedy decoding over those caches
(a parity check of the model, not the serving path).

Not ported yet (ROADMAP item 13): sequence parallel and the
ring-attention context-parallel path; a config that sets
``sequence_parallel`` or ``cp_mesh`` raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..nn.functional.attention import sdpa_reference
from ..ops.fused_ce import fused_softmax_ce_mean
from ..ops.kernels.flash_attention import flash_attention

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "RMSNorm"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class LlamaConfig:
    """Defaults are Llama-2 7B (the JAX package's defaults)."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32          # < heads => GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    use_flash_attention: bool = True
    sequence_parallel: bool = False
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    # recompute each decoder block in backward (torch.utils.checkpoint)
    recompute: bool = False
    cp_mesh: object = None

    def __post_init__(self):
        on = [k for k in ("sequence_parallel", "cp_mesh")
              if getattr(self, k)]
        if on:
            raise NotImplementedError(
                f"LlamaConfig: {', '.join(on)} (sequence parallelism and "
                f"the ring-attention context-parallel path) wait for "
                f"ROADMAP queue 1 item 13")

    @staticmethod
    def tiny(**kw):
        """Small config for tests / dry runs."""
        base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128)
        base.update(kw)
        return LlamaConfig(**base)

    @property
    def torch_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[str(self.dtype)]
        except KeyError:
            raise ValueError(
                f"dtype must be one of {sorted(_DTYPES)}, got "
                f"{self.dtype!r}") from None


def _rope_cos_sin(seq_len, head_dim, theta, device, position_offset=0):
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    pos = torch.arange(position_offset, position_offset + seq_len,
                       dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)             # [L, D/2]
    return torch.cos(freqs), torch.sin(freqs)


def _apply_rope(x, cos, sin):
    """x: [B, L, H, D] rotated in the 'rotate_half' convention: the
    pairs (x1, x2) are the two halves of the head dim."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm with the JAX package's numerics: normalize and scale in
    f32, cast back to the input dtype."""

    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        a = x.float()
        var = a.square().mean(-1, keepdim=True)
        return (a * torch.rsqrt(var + self.eps)
                * self.weight.float()).to(x.dtype)


class LlamaAttention(nn.Module):
    """GQA attention with RoPE: flash attention without a mask or a
    cache (when the config asks for it), the plain sdpa otherwise. K/V
    heads are repeated before the call, as in the JAX model, so the
    kernels see as many K/V heads as query heads; a cache holds them
    before the repeat."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        kv_out = self.num_kv_heads * self.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(self.hidden_size, self.hidden_size, **kw)
        self.k_proj = nn.Linear(self.hidden_size, kv_out, **kw)
        self.v_proj = nn.Linear(self.hidden_size, kv_out, **kw)
        self.o_proj = nn.Linear(self.hidden_size, self.hidden_size, **kw)

    def forward(self, h, attention_mask=None, cache=None, position_offset=0):
        """``cache``: None, or ``(k, v)`` of the positions before these
        (``(None, None)`` for none yet): then the result is ``(out,
        (new_k, new_v))``."""
        b, l, _ = h.shape
        q = self.q_proj(h).view(b, l, self.num_heads, self.head_dim)
        k = self.k_proj(h).view(b, l, self.num_kv_heads, self.head_dim)
        v = self.v_proj(h).view(b, l, self.num_kv_heads, self.head_dim)
        cos, sin = _rope_cos_sin(l, self.head_dim, self.config.rope_theta,
                                 h.device, position_offset)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        cached = cache is not None and cache[0] is not None
        if cached:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        new_k, new_v = k, v
        rep = self.num_heads // self.num_kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if not cached and attention_mask is None and \
                self.config.use_flash_attention:
            out = flash_attention(q, k, v, causal=True)
        else:
            # decode (Lq < Lk) and the masked path: the JAX _sdpa_xla
            out = sdpa_reference(q, k, v, causal=True, mask=attention_mask)
        out = self.o_proj(out.reshape(b, l, self.hidden_size))
        if cache is not None:
            return out, (new_k, new_v)
        return out


class LlamaMLP(nn.Module):
    """SwiGLU FFN."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(config.hidden_size,
                                   config.intermediate_size, **kw)
        self.up_proj = nn.Linear(config.hidden_size,
                                 config.intermediate_size, **kw)
        self.down_proj = nn.Linear(config.intermediate_size,
                                   config.hidden_size, **kw)

    def forward(self, x):
        return self.down_proj(
            nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, device, dtype)

    def forward(self, h, attention_mask=None, cache=None, position_offset=0):
        a = self.self_attn(self.input_layernorm(h), attention_mask, cache,
                           position_offset)
        if cache is not None:
            a, new_cache = a
        h = h + a
        h = h + self.mlp(self.post_attention_layernorm(h))
        if cache is not None:
            return h, new_cache
        return h


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device, dtype)

    def forward(self, input_ids, attention_mask=None, caches=None,
                position_offset=0):
        """``caches``: None, or one ``(k, v)`` a layer (``(None, None)``
        for an empty one): then the result is ``(h, new_caches)``."""
        h = self.embed_tokens(input_ids)
        new_caches = [] if caches is not None else None
        remat = self.config.recompute and caches is None and \
            torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if caches is not None:
                h, c = layer(h, attention_mask, caches[i], position_offset)
                new_caches.append(c)
            elif remat:
                h = checkpoint(layer, h, attention_mask, None,
                               position_offset, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = layer(h, attention_mask, None, position_offset)
        h = self.norm(h)
        if caches is not None:
            return h, new_caches
        return h


class LlamaForCausalLM(nn.Module):
    """Causal LM over :class:`LlamaModel`.

    ``device`` defaults to ``cuda`` (see ``core.device.resolve_device``);
    parameters are created in ``config.dtype`` and drawn from
    ``generator`` (default: a fresh generator seeded 0 on ``device``) at
    the JAX initializers' scales: Xavier-normal projections,
    N(0, 0.02) embeddings, unit norm weights."""

    def __init__(self, config: LlamaConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dt = config.torch_dtype
        self.llama = LlamaModel(config, dev, dt)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, device=dev, dtype=dt)
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
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=g)

    def _logits(self, h):
        if self.config.tie_word_embeddings:
            return h @ self.llama.embed_tokens.weight.t()
        return self.lm_head(h)

    def forward(self, input_ids, attention_mask=None, caches=None,
                position_offset=0):
        """input_ids [B, L] -> logits [B, L, V]; with ``caches``,
        ``(logits, new_caches)``."""
        out = self.llama(input_ids, attention_mask, caches, position_offset)
        if caches is not None:
            h, new_caches = out
            return self._logits(h), new_caches
        return self._logits(out)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32):
        """Greedy decoding with per-layer KV caches: a prefill over
        ``input_ids [B, L]``, then one token a step. Returns the ids
        ``[B, L + max_new_tokens]`` (the model's parity check, not the
        serving path)."""
        ids = input_ids
        caches = [(None, None)] * self.config.num_hidden_layers
        logits, caches = self.forward(ids, caches=caches)
        for _ in range(max_new_tokens):
            next_id = logits[:, -1, :].argmax(dim=-1)[:, None]
            offset = caches[0][0].shape[1]
            ids = torch.cat([ids, next_id.to(ids.dtype)], dim=1)
            logits, caches = self.forward(next_id, caches=caches,
                                          position_offset=offset)
        return ids


class LlamaPretrainingCriterion(nn.Module):
    """Causal-LM loss: next-token cross entropy. The labels (not the
    logits) are shifted, with -100 in the last column, and the mean runs
    over the positions whose label is not -100, as in the JAX model."""

    def __init__(self, config: Optional[LlamaConfig] = None):
        super().__init__()

    def forward(self, logits, labels):
        pad = torch.full((labels.shape[0], 1), -100, dtype=labels.dtype,
                         device=labels.device)
        shifted = torch.cat([labels[:, 1:], pad], dim=1)
        return fused_softmax_ce_mean(logits, shifted, ignore_index=-100)
