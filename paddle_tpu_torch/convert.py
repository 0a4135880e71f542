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
:func:`optimizer_state_from_jax` carries any optimizer's per-parameter
slots by parameter name, the slots of Linear weights transposed like
their weights (the last two axes, so ASGD's ``[n, in, out]`` gradient
history too), so a port run resumes from a JAX optimizer state.
:func:`optimizer_state_dict_from_jax` takes a whole JAX
``optimizer.state_dict()`` (``global_step``, ``LR_Scheduler``,
``param_{i}_{slot}``) as numpy into the port's ``set_state_dict`` keys,
re-indexed by parameter name where the two optimizers list their
parameters in another order; :func:`lr_state_from_jax` and
:func:`grad_scaler_state_from_jax` carry an LR scheduler's and a
``GradScaler``'s state dicts (numpy scalars become Python numbers).
bf16 arrays (numpy's ``bfloat16`` extension dtype) come across as
``torch.bfloat16``, exactly; the arrays may also be torch tensors (a JAX
file read by ``framework.io``), which keep their dtype.
:func:`llama_config_from_jax` maps a JAX ``LlamaConfig`` (an object, a
``framework.io.JaxRecord`` read from a file, or a dict) to the port's,
refusing the features the port lacks.

A model built on the eager core (``nn.Layer`` with paddle ``Linear``,
``[in, out]``) keeps the JAX layouts: :func:`load_layer_from_jax`
copies a JAX state dict into any Layer by name through
``Layer.set_state_dict``, transposing nothing, and
:func:`gpt_from_jax` builds the port's ``GPTForCausalLM`` from a JAX
``GPTConfig`` and loads the JAX GPT's weights into it;
:func:`vision_from_jax` builds any model of ``vision.models`` and
loads a JAX zoo model's ``state_dict()`` (the batch norms' ``_mean`` /
``_variance`` buffers included; conv weights are ``[O, I/g, kh, kw]``
and Linear weights ``[in, out]`` in both packages, so nothing is
transposed); :func:`resnet_from_jax` is that call for a ResNet.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "load_from_jax",
           "optimizer_state_from_jax", "optimizer_state_dict_from_jax",
           "lr_state_from_jax", "grad_scaler_state_from_jax",
           "llama_config_from_jax", "linear_weight_names",
           "load_layer_from_jax", "gpt_config_from_jax", "gpt_from_jax",
           "resnet_from_jax", "vision_from_jax", "LINEAR_WEIGHTS"]

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
    """``a`` as a torch tensor; ``transpose`` swaps its last two axes
    (a Linear weight ``[in, out]``, or a slot ending in that shape)."""
    if isinstance(a, torch.Tensor):
        if transpose:
            if a.dim() < 2:
                raise ValueError(f"{name}: Linear weight must be 2-D, got "
                                 f"shape {tuple(a.shape)}")
            a = a.transpose(-1, -2)
        return a.contiguous()
    a = np.asarray(a)
    if transpose:
        if a.ndim < 2:
            raise ValueError(f"{name}: Linear weight must be 2-D, got "
                             f"shape {a.shape}")
        a = np.swapaxes(a, -1, -2)
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
    """``{parameter name: {slot: numpy array}}`` — any JAX optimizer's
    per-parameter slots (Adam's ``moment1``, ``moment2``, ``beta1_pow``,
    ``beta2_pow``, Momentum's ``velocity``, ASGD's ``ys`` ...) keyed by
    the JAX model's parameter names -> the same in the port's layout,
    for ``Optimizer.set_named_states``: the slots of Linear weights with
    two or more axes transposed in their last two, the rest copied."""
    is_linear = _linear_test(model)
    return {name: {k: _tensor(f"{name}:{k}", a,
                              is_linear(name) and np.ndim(a) >= 2)
                   for k, a in slots.items()}
            for name, slots in states.items()}


def _py(v):
    """numpy scalars and arrays -> Python numbers and lists."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return type(v)(_py(x) for x in v)
    if isinstance(v, dict):
        return {k: _py(x) for k, x in v.items()}
    return v


def lr_state_from_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX ``LRScheduler.state_dict()`` -> the port's (the same keys;
    numpy scalars become Python numbers)."""
    return {k: _py(v) for k, v in state.items()}


def grad_scaler_state_from_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX ``GradScaler.state_dict()`` (scale, ratios, good and bad
    step counts) -> the port's ``GradScaler.load_state_dict`` input."""
    out = {k: _py(v) for k, v in state.items()}
    for k in ("good_steps", "bad_steps"):
        if k in out:
            out[k] = int(out[k])
    return out


_SLOT_KEY = re.compile(r"param_(\d+)_(.+)")


def optimizer_state_dict_from_jax(
        state_dict: Mapping[str, Any],
        names: Optional[Sequence[str]] = None,
        port_names: Optional[Sequence[str]] = None,
        model: Optional[torch.nn.Module] = None) -> Dict[str, Any]:
    """A JAX ``optimizer.state_dict()`` (values as numpy) -> a dict for
    the port's ``Optimizer.set_state_dict``, with the same keys.

    ``names`` are the JAX optimizer's parameter names in its order
    (``[n for n, _ in model.named_parameters()]``); with them the slots
    of Linear weights are transposed like their weights (``model``, the
    port model, decides which are Linear weights, else
    :data:`LINEAR_WEIGHTS`), and with ``port_names`` (the port
    optimizer's ``_param_names``) each ``param_{i}`` is re-indexed to
    the port optimizer's position of the same name."""
    is_linear = _linear_test(model)
    out: Dict[str, Any] = {}
    for key, v in state_dict.items():
        m = _SLOT_KEY.fullmatch(key) if isinstance(key, str) else None
        if key == "LR_Scheduler":
            out[key] = lr_state_from_jax(v)
        elif m is None:
            out[key] = _py(v)
        else:
            i, slot = int(m.group(1)), m.group(2)
            name = names[i] if names is not None else None
            j = port_names.index(name) if port_names is not None \
                and name is not None else i
            a = np.asarray(getattr(v, "_data", v))
            out[f"param_{j}_{slot}"] = _tensor(
                f"{key}", a, name is not None and is_linear(name)
                and a.ndim >= 2)
    return out


# the port LlamaConfig's fields, and the JAX features it has no path for
# (each must be off in a config the port takes)
_LLAMA_FIELDS = ("vocab_size", "hidden_size", "intermediate_size",
                 "num_hidden_layers", "num_attention_heads",
                 "num_key_value_heads", "max_position_embeddings",
                 "rms_norm_eps", "rope_theta", "use_flash_attention",
                 "tie_word_embeddings", "dtype", "recompute")
_LLAMA_UNPORTED = ("sequence_parallel", "cp_mesh")


def llama_config_from_jax(cfg):
    """A JAX ``LlamaConfig`` -> the port's ``LlamaConfig``: the fields
    the port has are kept (``recompute`` among them); a config that turns
    on sequence parallelism or a context-parallel mesh raises
    ``ValueError`` (the port has neither yet)."""
    from .models.llama import LlamaConfig
    d = dict(cfg) if isinstance(cfg, Mapping) else dict(vars(cfg))
    on = [k for k in _LLAMA_UNPORTED if d.get(k)]
    if on:
        raise ValueError(f"the JAX LlamaConfig turns on {on}, which the "
                         f"port does not have")
    return LlamaConfig(**{k: d[k] for k in _LLAMA_FIELDS if k in d})


def load_from_jax(model: torch.nn.Module,
                  arrays: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy the JAX parameters into ``model`` in place (strict: every
    name must match), casting to the model's dtype and device."""
    model.load_state_dict(state_dict_from_jax(arrays, model), strict=True)
    return model


def load_layer_from_jax(layer, arrays: Mapping[str, np.ndarray],
                        strict: bool = True):
    """Copy the JAX parameters (``{name: array}``) into an eager-core
    ``Layer`` in place, by name and without transposes, cast to the
    layer's dtypes and device; ``strict`` raises on a missing or an
    unexpected name."""
    missing, unexpected = layer.set_state_dict(
        {name: _tensor(name, a, False) for name, a in arrays.items()})
    if strict and (missing or unexpected):
        raise KeyError(f"load_layer_from_jax: missing {missing}, "
                       f"unexpected {unexpected}")
    return layer


def gpt_config_from_jax(cfg):
    """A JAX ``GPTConfig`` (an object or a dict) -> the port's."""
    import dataclasses
    from .models.gpt import GPTConfig
    d = dict(cfg) if isinstance(cfg, Mapping) else dict(vars(cfg))
    return GPTConfig(**{f.name: d[f.name] for f in dataclasses.fields(
        GPTConfig) if f.name in d})


def gpt_from_jax(cfg, arrays: Mapping[str, np.ndarray], device=None,
                 dtype=None):
    """The port's ``GPTForCausalLM`` for the JAX ``cfg``, on ``device``
    (else the current device), holding the JAX GPT's weights."""
    from .models.gpt import GPTForCausalLM
    model = GPTForCausalLM(gpt_config_from_jax(cfg), device=device,
                           dtype=dtype)
    return load_layer_from_jax(model, arrays)


def vision_from_jax(arch: str, arrays: Mapping[str, np.ndarray],
                    device=None, **kwargs):
    """The port's ``vision.models.<arch>(**kwargs)`` (any model of the
    zoo: ``resnet50``, ``mobilenet_v2``, ``densenet121``, ``LeNet`` ...,
    e.g. ``num_classes=1000``), on ``device`` (else the current device),
    holding the JAX model's ``state_dict()`` arrays. Arrays that are all
    bf16 (or all f16) — a JAX model after ``bfloat16()`` — make the
    model that dtype first, buffers included, so they load exactly."""
    from .vision import models
    model = getattr(models, arch)(**kwargs)
    if device is not None:
        model.to(device)
    tensors = {name: _tensor(name, a, False) for name, a in arrays.items()}
    floats = {t.dtype for t in tensors.values() if t.is_floating_point()}
    if len(floats) == 1 and floats <= {torch.bfloat16, torch.float16}:
        model.to(dtype=floats.pop())
    return load_layer_from_jax(model, tensors)


def resnet_from_jax(arch: str, arrays: Mapping[str, np.ndarray],
                    device=None, **kwargs):
    """:func:`vision_from_jax` for a ResNet (e.g. ``resnet50``,
    ``num_classes=1000, data_format="NHWC"``)."""
    return vision_from_jax(arch, arrays, device=device, **kwargs)
