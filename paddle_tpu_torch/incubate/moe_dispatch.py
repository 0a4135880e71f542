"""Index-based MoE dispatch and combine.

The port of ``paddle_tpu/incubate/moe_dispatch.py``: capacity-bounded
GShard dispatch as index tables (a gather of tokens into ``[E, C, H]``
expert buffers, and a per-token top-k gather to combine), O(E·C·H)
instead of the one-hot algebra's O(T·E·C·H). The experts run as a
batched product over the fixed-capacity layout (``torch.bmm`` in the
tokens' dtype), as the JAX package runs them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["capacity_dispatch_indices", "moe_forward_indices",
           "routed_forward", "experts_forward"]


def capacity_dispatch_indices(gate_logits: torch.Tensor, top_k: int,
                              capacity: int):
    """GShard capacity dispatch as index tables.

    gate_logits: ``[T, E]`` float. Returns
    ``(token_idx, slot_used, expert_k, slot_k, weight_k, aux_loss)``:
    ``token_idx [E, C]`` int32 (the token filling each slot, 0 if
    empty), ``slot_used [E, C]`` bool, ``expert_k [T, K]`` int32 (k-th
    choice), ``slot_k [T, K]`` int32 (the slot it landed in, clamped if
    dropped), ``weight_k [T, K]`` f32 (gate probability, 0 if dropped)
    and the scalar Switch/GShard load-balance loss ``E · Σ me·ce`` over
    the top-1 choices. Each round takes the argmax over the experts not
    chosen yet; positions come from a cumsum over tokens that continues
    where the earlier rounds stopped; tokens past capacity are dropped.
    """
    t, e = gate_logits.shape
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)

    top1 = probs.argmax(dim=-1)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(top1, e).float().mean(dim=0)
    aux_loss = e * (me * ce).sum()

    used = torch.zeros((t, e), dtype=torch.bool, device=dev)
    counts = torch.zeros((e,), dtype=torch.float32, device=dev)
    expert_k, slot_k, weight_k = [], [], []
    for _ in range(min(top_k, e)):
        choice = torch.where(used, -torch.inf, probs).argmax(dim=-1)
        oh = torch.nn.functional.one_hot(choice, e).float()     # [T, E]
        # the running count per expert, scanned along a contiguous row
        # per expert ([E, T]): a scan down the T axis of [T, E] runs on
        # E threads
        pos_table = torch.cumsum(oh.t().contiguous(), dim=1) - 1.0 + \
            counts[:, None]                                     # [E, T]
        pos = pos_table.gather(0, choice[None, :])[0]           # [T]
        in_cap = pos < capacity
        w = probs.gather(1, choice[:, None])[:, 0]
        expert_k.append(choice.to(torch.int32))
        slot_k.append(pos.clamp(0, capacity - 1).to(torch.int32))
        weight_k.append(torch.where(in_cap, w, 0.0))
        used = used | (oh > 0)
        counts = counts + oh.sum(dim=0)

    expert_k = torch.stack(expert_k, dim=1)
    slot_k = torch.stack(slot_k, dim=1)
    weight_k = torch.stack(weight_k, dim=1)

    # slot tables: scatter the valid (expert, slot) -> token edges; the
    # invalid ones are parked at E·C and cut off
    flat = expert_k.long() * capacity + slot_k.long()           # [T, K]
    valid = weight_k > 0
    safe_flat = torch.where(valid, flat, e * capacity).reshape(-1)
    tokens = torch.arange(t, dtype=torch.int32, device=dev)[:, None]
    token_idx = torch.zeros((e * capacity + 1,), dtype=torch.int32,
                            device=dev).scatter_(
        0, safe_flat, tokens.expand(flat.shape).reshape(-1))
    slot_used = torch.zeros((e * capacity + 1,), dtype=torch.bool,
                            device=dev).scatter_(0, safe_flat,
                                                 valid.reshape(-1))
    return (token_idx[:-1].reshape(e, capacity),
            slot_used[:-1].reshape(e, capacity),
            expert_k, slot_k, weight_k, aux_loss)


def experts_forward(xs: torch.Tensor, w_in: torch.Tensor,
                    w_out: torch.Tensor, act: Callable) -> torch.Tensor:
    """The stacked expert FFN over the fixed-capacity layout: ``[E, C, H]``
    -> ``[E, C, H]`` as two batched products (in the promoted dtype of
    the tokens and the weights) around ``act``."""
    dtype = torch.promote_types(xs.dtype, w_in.dtype)
    hdn = act(torch.bmm(xs.to(dtype), w_in.to(dtype)))
    return torch.bmm(hdn, w_out.to(hdn.dtype))


def moe_forward_indices(tokens: torch.Tensor, gate_w: torch.Tensor,
                        w_in: torch.Tensor, w_out: torch.Tensor, top_k: int,
                        capacity: int, act: Callable
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole MoE forward on the index dispatch: tokens ``[T, H]`` ->
    ``([T, H], aux_loss)``. Gate logits in f32; the dispatch gather
    masked by ``slot_used``; the experts as ``torch.bmm`` over
    ``[E, C, H]`` in the tokens' dtype; the combine a per-token gather
    of its k slots weighted by ``weight_k``."""
    out, aux, _ = routed_forward(tokens, tokens.float() @ gate_w.float(),
                                 w_in, w_out, top_k, capacity, act)
    return out, aux


def routed_forward(tokens: torch.Tensor, gate_logits: torch.Tensor,
                   w_in: torch.Tensor, w_out: torch.Tensor, top_k: int,
                   capacity: int, act: Callable):
    """:func:`moe_forward_indices` from the f32 gate logits; also returns
    ``slot_used`` ``[E, C]`` (the kept token choices)."""
    t, h = tokens.shape
    e = w_in.shape[0]
    (token_idx, slot_used, expert_k, slot_k, weight_k,
     aux) = capacity_dispatch_indices(gate_logits, top_k, capacity)
    c = token_idx.shape[1]

    # dispatch and combine gather with index_select, whose backward is an
    # index_add (advanced indexing's is a sort-based scatter)
    xs = tokens.index_select(0, token_idx.reshape(-1).long()).reshape(
        e, c, h)
    xs = torch.where(slot_used[..., None], xs, 0).to(tokens.dtype)
    ys = experts_forward(xs, w_in, w_out, act)

    # combine: per-token weighted gather of its k slots
    flat_idx = (expert_k.long() * c + slot_k.long()).reshape(-1)   # [T*K]
    picked = ys.reshape(e * c, -1).index_select(0, flat_idx).reshape(t, -1,
                                                                     h)
    out = (picked * weight_k[..., None].to(picked.dtype)).sum(dim=1)
    return out.to(tokens.dtype), aux, slot_used
