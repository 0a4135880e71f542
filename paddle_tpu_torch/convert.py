"""Carry weights from the JAX package into the port.

The JAX model's ``named_parameters()`` and the port's ``state_dict()``
share names; the one layout difference is the projections: the JAX
``Linear`` stores ``[in, out]`` and ``torch.nn.Linear`` ``[out, in]``.
:func:`state_dict_from_jax` does that one transpose, so nothing
downstream (the serving engines included) ever transposes again.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "load_from_jax", "LINEAR_WEIGHTS"]

# the Linear layers of the Llama module tree (their ``.weight`` leaves)
LINEAR_WEIGHTS = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "gate_proj", "up_proj", "down_proj", "lm_head")


def _is_linear_weight(name: str) -> bool:
    parts = name.split(".")
    return (len(parts) >= 2 and parts[-1] == "weight"
            and parts[-2] in LINEAR_WEIGHTS)


def state_dict_from_jax(arrays: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` of the JAX model's parameters -> a torch
    state dict in the port's layout: Linear weights transposed to
    ``[out, in]``, everything else copied."""
    out: Dict[str, torch.Tensor] = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if _is_linear_weight(name):
            if a.ndim != 2:
                raise ValueError(f"{name}: Linear weight must be 2-D, "
                                 f"got shape {a.shape}")
            a = a.T
        out[name] = torch.from_numpy(np.array(a, copy=True, order="C"))
    return out


def load_from_jax(model: torch.nn.Module,
                  arrays: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy the JAX parameters into ``model`` in place (strict: every
    name must match), casting to the model's dtype and device."""
    model.load_state_dict(state_dict_from_jax(arrays), strict=True)
    return model
