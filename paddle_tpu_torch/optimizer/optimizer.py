"""Optimizer base, Adam and AdamW.

The port of ``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``,
``Adam``, ``AdamW``). Each optimizer defines a pure per-parameter
update ``_update(p, g, state, lr, index) -> (new_p, new_state)`` with
the JAX package's formula, operation for operation: f32 math, decoupled
decay added to the update (``upd = m̂ / (√v̂ + ε) + wd·p``, then
``p − lr·upd``), the result cast back to the parameter's dtype, moments
stored in f32 (``multi_precision=True``) or in the parameter's dtype.
``step()`` writes the new values into the parameters in place (the JAX
package replaces its immutable arrays; here the copy saves memory).
``torch.optim.AdamW`` is not used: it decays ``p`` before the step and
updates bf16 parameters in bf16, which rounds differently.

``parameters`` may be tensors or ``(name, tensor)`` pairs
(``model.named_parameters()``); unnamed parameters are
``param_{i}``, the JAX package's names. ``apply_decay_param_fun``
is called with those names, and ``named_states`` /
``set_named_states`` carry the slots by them (e.g. from
``convert.optimizer_state_from_jax``). The learning rate is a float
(schedulers and gradient clipping are later items of the port).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate: float = 0.001, parameters=None,
                 weight_decay: Optional[float] = None, grad_clip=None):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (pass model.parameters())")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (utils/clip_grad.py)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "the learning rate must be a float (lr schedulers are not "
                "ported yet)")
        params: List = list(parameters)
        if params and isinstance(params[0], tuple):
            self._param_names = [n for n, _ in params]
            params = [p for _, p in params]
        else:
            self._param_names = [f"param_{i}" for i in range(len(params))]
        self._parameter_list: List[torch.Tensor] = params
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        # per-parameter slot states, by index into _parameter_list
        self._states: Dict[int, Dict[str, torch.Tensor]] = {}

    # -- states --------------------------------------------------------------
    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _state_for(self, i: int) -> Dict[str, torch.Tensor]:
        s = self._states.get(i)
        if s is None:
            s = self._states[i] = self._init_state(self._parameter_list[i])
        return s

    def _update(self, p, g, state, lr, index=None):
        raise NotImplementedError

    def _use_wd(self, index) -> float:
        return self._weight_decay

    # -- step ----------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        for i, p in enumerate(self._parameter_list):
            if p.grad is None:
                continue
            new_p, new_state = self._update(p, p.grad, self._state_for(i),
                                            self._learning_rate, i)
            p.copy_(new_p)
            self._states[i] = new_state

    def clear_grad(self) -> None:
        for p in self._parameter_list:
            p.grad = None

    # -- state by parameter name ---------------------------------------------
    def named_states(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{parameter name: {slot: tensor}}`` (the live tensors)."""
        return {self._param_names[i]: dict(s)
                for i, s in sorted(self._states.items())}

    def set_named_states(self, states: Mapping[str, Mapping[str,
                                                            torch.Tensor]]
                         ) -> None:
        """Install per-parameter slots by parameter name (strict: every
        parameter needs its slots, e.g. from
        ``convert.optimizer_state_from_jax``), on each parameter's
        device, moments in this optimizer's moment dtype."""
        missing = [n for n in self._param_names if n not in states]
        if missing:
            raise KeyError(f"no optimizer state for {missing[:5]}")
        for i, (name, p) in enumerate(zip(self._param_names,
                                          self._parameter_list)):
            fresh = self._init_state(p)
            self._states[i] = {
                k: torch.as_tensor(states[name][k]).to(
                    device=p.device, dtype=fresh[k].dtype).clone()
                for k in fresh}


class Adam(Optimizer):
    """L2 regularization folded into the gradient (unlike AdamW)."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: Optional[float] = None,
                 grad_clip=None, multi_precision: bool = True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._decoupled_wd = False
        # True: f32 moments whatever the parameter dtype; False: moments
        # in the parameter's dtype (half the state bytes for bf16 models)
        self._multi_precision = multi_precision

    def _moment_dtype(self, p: torch.Tensor) -> torch.dtype:
        return torch.float32 if self._multi_precision else p.dtype

    def _init_state(self, p):
        d = self._moment_dtype(p)
        return {
            "moment1": torch.zeros_like(p, dtype=d),
            "moment2": torch.zeros_like(p, dtype=d),
            "beta1_pow": torch.ones((), dtype=torch.float32, device=p.device),
            "beta2_pow": torch.ones((), dtype=torch.float32, device=p.device),
        }

    def _update(self, p, g, state, lr, index=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g = g.float()
        p32 = p.float()
        wd = self._use_wd(index)
        if wd and not self._decoupled_wd:
            g = g + wd * p32
        m1 = b1 * state["moment1"].float() + (1 - b1) * g
        m2 = b2 * state["moment2"].float() + (1 - b2) * g * g
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        upd = m1_hat / (torch.sqrt(m2_hat) + eps)
        if wd and self._decoupled_wd:
            upd = upd + wd * p32
        new_p = (p32 - lr * upd).to(p.dtype)
        md = self._moment_dtype(p)
        return new_p, {"moment1": m1.to(md), "moment2": m2.to(md),
                       "beta1_pow": b1p, "beta2_pow": b2p}


class AdamW(Adam):
    """Decoupled weight decay; ``apply_decay_param_fun(name)`` False
    exempts a parameter from it."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: float = 0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision: bool = True):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _use_wd(self, index) -> float:
        if self._apply_decay_param_fun is not None and index is not None:
            if not self._apply_decay_param_fun(self._param_names[index]):
                return 0.0
        return self._weight_decay
