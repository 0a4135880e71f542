"""Carry weights and optimizer state from the JAX package into the port.

The JAX model's ``named_parameters()`` and the port's ``state_dict()``
share names; the one layout difference is the projections: the JAX
``Linear`` stores ``[in, out]`` and ``torch.nn.Linear`` ``[out, in]``.
:func:`state_dict_from_jax` does that one transpose, so nothing
downstream (the serving engines included) ever transposes again. Which
leaves are Linear weights is read off the port model's own
``torch.nn.Linear`` modules when the caller passes the model (Llama,
BERT, ERNIE-MoE, any tree); without one, the Llama projection names
(:data:`LINEAR_WEIGHTS`) decide. Raw parameters that are not a
Linear's weight — ERNIE-MoE's expert stacks ``w_in [E, H, F]`` and
``w_out [E, F, H]`` and its gate weight ``[H, E]`` — keep the JAX
layout and are copied as they are, their optimizer moments too.
:func:`optimizer_state_from_jax` carries the optimizer's per-parameter
slots (Adam/AdamW moments and beta powers) by parameter name, the
moments of Linear weights transposed like their weights, so a port run
resumes from a JAX optimizer state. bf16 arrays (numpy's ``bfloat16``
extension dtype) come across as ``torch.bfloat16``, exactly.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "load_from_jax",
           "optimizer_state_from_jax", "linear_weight_names",
           "LINEAR_WEIGHTS"]

# the Linear layers of the Llama module tree (their ``.weight`` leaves):
# the default when no port model is given
LINEAR_WEIGHTS = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "gate_proj", "up_proj", "down_proj", "lm_head")


def linear_weight_names(model: torch.nn.Module) -> set:
    """The ``.weight`` names of ``model``'s ``torch.nn.Linear`` modules."""
    return {f"{name}.weight" if name else "weight"
            for name, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)}


def _linear_test(model: Optional[torch.nn.Module]):
    if model is not None:
        return linear_weight_names(model).__contains__

    def by_name(name: str) -> bool:
        parts = name.split(".")
        return (len(parts) >= 2 and parts[-1] == "weight"
                and parts[-2] in LINEAR_WEIGHTS)
    return by_name


def _tensor(name: str, a, transpose: bool) -> torch.Tensor:
    a = np.asarray(a)
    if transpose:
        if a.ndim != 2:
            raise ValueError(f"{name}: Linear weight must be 2-D, got "
                             f"shape {a.shape}")
        a = a.T
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a,
                                  copy=True, order="C"))
    return t.to(torch.bfloat16) if bf16 else t


def state_dict_from_jax(arrays: Mapping[str, np.ndarray],
                        model: Optional[torch.nn.Module] = None
                        ) -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` of the JAX model's parameters -> a torch
    state dict in the port's layout: Linear weights (those of ``model``'s
    ``torch.nn.Linear`` modules, or :data:`LINEAR_WEIGHTS` by name)
    transposed to ``[out, in]``, everything else copied."""
    is_linear = _linear_test(model)
    return {name: _tensor(name, a, is_linear(name))
            for name, a in arrays.items()}


def optimizer_state_from_jax(
        states: Mapping[str, Mapping[str, np.ndarray]],
        model: Optional[torch.nn.Module] = None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{parameter name: {slot: numpy array}}`` — the JAX optimizer's
    per-parameter slots (``moment1``, ``moment2``, ``beta1_pow``,
    ``beta2_pow``) keyed by the JAX model's parameter names -> the same
    in the port's layout, for ``Optimizer.set_named_states``: the
    moments of Linear weights transposed like the weights, the 0-d beta
    powers copied."""
    is_linear = _linear_test(model)
    return {name: {k: _tensor(f"{name}:{k}", a,
                              is_linear(name) and np.ndim(a) == 2)
                   for k, a in slots.items()}
            for name, slots in states.items()}


def load_from_jax(model: torch.nn.Module,
                  arrays: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy the JAX parameters into ``model`` in place (strict: every
    name must match), casting to the model's dtype and device."""
    model.load_state_dict(state_dict_from_jax(arrays, model), strict=True)
    return model
