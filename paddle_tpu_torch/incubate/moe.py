"""Mixture-of-Experts layer and its gates.

The port of ``paddle_tpu/incubate/moe.py``: ``NaiveGate`` (top-k),
``SwitchGate`` (top-1) and ``GShardGate`` (top-2), each holding a
``[d_model, E]`` Xavier-uniform weight, and ``MoELayer`` with stacked
expert weights ``w_in [E, H, F]`` and ``w_out [E, F, H]`` (raw
parameters drawn U(±1/√d_model), stored as the JAX package stores them,
so ``convert`` copies them untransposed). Three dispatch modes, as in
the JAX layer: ``"index"`` (gather/scatter tables,
``moe_dispatch.moe_forward_indices``), ``"dense"`` (the one-hot GShard
algebra of :func:`_gshard_dispatch`, the numeric oracle) and ``"auto"``
(dense below ``_AUTO_DENSE_TOKENS`` tokens a forward, index above). The
experts' activation is the tanh GELU (``jax.nn.gelu``'s default), not
paddle's erf GELU. Every forward sets ``aux_loss`` (the load-balance
loss, to be added to the training loss) and ``drop_share`` (the share
of token choices that capacity dropped, a detached 0-dim tensor).

Expert parallelism (``shard_experts``) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .moe_dispatch import experts_forward, routed_forward

__all__ = ["NaiveGate", "SwitchGate", "GShardGate", "MoELayer"]

_ACTIVATIONS = {
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "silu": torch.nn.functional.silu,
}

# dispatch_mode="auto" crossover, tokens per forward (the JAX package's
# constant; it was chosen on another device and is kept only so that
# "auto" picks the same mode as the JAX layer)
_AUTO_DENSE_TOKENS = 24576


class _BaseGate(nn.Module):
    def __init__(self, d_model: int, num_experts: int, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_experts = num_experts
        self.weight = nn.Parameter(torch.empty((d_model, num_experts),
                                               device=device, dtype=dtype))
        limit = math.sqrt(6.0 / (d_model + num_experts))
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)


class NaiveGate(_BaseGate):
    """Top-k softmax gate."""

    def __init__(self, d_model, num_experts, top_k=2, **kw):
        super().__init__(d_model, num_experts, **kw)
        self.top_k = top_k


class SwitchGate(_BaseGate):
    """Top-1 gate with the load-balancing aux loss."""

    def __init__(self, d_model, num_experts, **kw):
        super().__init__(d_model, num_experts, **kw)
        self.top_k = 1


class GShardGate(_BaseGate):
    """Top-2 gate with capacity and the aux loss."""

    def __init__(self, d_model, num_experts, **kw):
        super().__init__(d_model, num_experts, **kw)
        self.top_k = 2


def _gshard_dispatch(gate_logits: torch.Tensor, top_k: int, capacity: int):
    """The dense dispatch algebra: logits ``[T, E]`` -> (combine
    ``[T, E, C]`` f32, dispatch ``[T, E, C]`` bool, aux_loss). Per-expert
    positions by a cumsum over tokens that continues across rounds;
    tokens past capacity dropped."""
    t, e = gate_logits.shape
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)
    top1 = probs.argmax(dim=-1)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(top1, e).float().mean(dim=0)
    aux_loss = e * (me * ce).sum()

    combine = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.bool, device=dev)
    used = torch.zeros((t, e), dtype=torch.bool, device=dev)
    counts = torch.zeros((e,), dtype=torch.float32, device=dev)
    slots = torch.arange(capacity, device=dev)
    for _ in range(min(top_k, e)):
        choice = torch.where(used, -torch.inf, probs).argmax(dim=-1)
        oh = torch.nn.functional.one_hot(choice, e).float()       # [T, E]
        pos = (torch.cumsum(oh, dim=0) - 1.0 + counts[None, :]) * oh
        in_cap = pos < capacity
        # a position past capacity is an all-zero one-hot row, as in JAX
        pos_oh = (pos.long()[..., None] == slots).float()        # [T, E, C]
        w = (probs * oh * in_cap)[..., None] * pos_oh
        combine = combine + w
        dispatch = dispatch | (w > 0)
        used = used | (oh > 0)
        counts = counts + oh.sum(dim=0)
    return combine, dispatch, aux_loss


class MoELayer(nn.Module):
    """Stacked-expert FFN behind a gate: ``[B, L, H] -> [B, L, H]``.
    ``device``/``dtype`` place the parameters; ``generator`` draws them
    (the gate's Xavier-uniform weight, then ``w_in`` and ``w_out``)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate: str = "gshard", top_k: int = 2,
                 capacity_factor: float = 1.25, activation: str = "gelu",
                 dispatch_mode: str = "index", device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        if dispatch_mode not in ("index", "dense", "auto"):
            raise ValueError(
                f"dispatch_mode must be 'index', 'dense' or 'auto', got "
                f"{dispatch_mode!r}")
        self.dispatch_mode = dispatch_mode
        kw = dict(device=device, dtype=dtype, generator=generator)
        if gate == "naive":
            self.gate = NaiveGate(d_model, num_experts, top_k, **kw)
        elif gate == "switch":
            self.gate = SwitchGate(d_model, num_experts, **kw)
        elif gate == "gshard":
            self.gate = GShardGate(d_model, num_experts, **kw)
        else:
            raise ValueError(f"unknown gate {gate!r}")
        self.top_k = self.gate.top_k
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        scale = 1.0 / math.sqrt(d_model)
        self.w_in = nn.Parameter(torch.empty(
            (num_experts, d_model, d_hidden), device=device, dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(
            (num_experts, d_hidden, d_model), device=device, dtype=dtype))
        with torch.no_grad():
            self.w_in.uniform_(-scale, scale, generator=generator)
            self.w_out.uniform_(-scale, scale, generator=generator)
        self.aux_loss: Optional[torch.Tensor] = None
        self.drop_share: Optional[torch.Tensor] = None

    def forward(self, x):
        """``x [B, L, H]`` -> ``[B, L, H]``; sets ``aux_loss`` and
        ``drop_share``."""
        b, l, h = x.shape
        t = b * l
        capacity = max(1, int(self.capacity_factor * t * self.top_k /
                              self.num_experts))
        act = _ACTIVATIONS[self.activation]
        mode = self.dispatch_mode
        if mode == "auto":
            mode = "dense" if t < _AUTO_DENSE_TOKENS else "index"
        tokens = x.reshape(t, h)
        logits = tokens.float() @ self.gate.weight.float()
        if mode == "index":
            out, aux, slot_used = routed_forward(
                tokens, logits, self.w_in, self.w_out, self.top_k, capacity,
                act)
            kept = slot_used.sum()
        else:
            combine, dispatch, aux = _gshard_dispatch(logits, self.top_k,
                                                      capacity)
            # dispatch: [T, E, C] x [T, H] -> [E, C, H]
            xs = torch.einsum("tec,th->ech", dispatch.to(x.dtype), tokens)
            ys = experts_forward(xs, self.w_in, self.w_out, act)
            out = torch.einsum("tec,ech->th", combine.to(ys.dtype), ys)
            kept = dispatch.sum()
        self.aux_loss = aux
        self.drop_share = (1.0 - kept.float()
                           / (t * min(self.top_k, self.num_experts))
                           ).detach()
        return out.reshape(b, l, h).to(x.dtype)

