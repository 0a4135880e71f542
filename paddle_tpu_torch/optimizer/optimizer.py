"""Optimizer base and SGD, Momentum, Adagrad, Adam, AdamW, Adamax,
RMSProp, Lamb, Adadelta.

The port of ``paddle_tpu/optimizer/optimizer.py``. Each optimizer
defines a pure per-parameter update ``_update(p, g, state, lr, index)
-> (new_p, new_state)`` with the JAX package's formula, operation for
operation: f32 math, the result cast back to the parameter's dtype.
Adam and AdamW keep their moments in f32 (``multi_precision=True``) or
in the parameter's dtype; AdamW adds the decoupled decay to the update
(``upd = m̂ / (√v̂ + ε) + wd·p``, then ``p − lr·upd``).
``torch.optim.AdamW`` and ``torch._fused_adamw_`` are not used: they
decay ``p`` before the step and update bf16 parameters in bf16, which
rounds differently.

``step()`` first offers the step to the fused plane
(``fused_step.try_step``): Adam and AdamW run as two multi-tensor
kernels on the card, with the clip inside, lr in device memory and no
host sync. Everything else — the other optimizers, an ``L1Decay``, a
clip subclass, the kill switch ``FLAGS_fused_optimizer=0`` — runs the
per-parameter loop :meth:`Optimizer._eager_step`, which writes the new
values into the parameters in place (the JAX package replaces its
immutable arrays; here the copy saves memory).

``parameters`` may be tensors or ``(name, tensor)`` pairs
(``model.named_parameters()``), torch tensors or the eager core's
Parameters (a ``Layer``'s ``parameters()``: the optimizer keeps the
``torch.nn.Parameter`` each wraps); unnamed parameters are the
Parameter's ``name`` or ``param_{i}``, the JAX package's names. ``apply_decay_param_fun`` is called with those
names. ``state_dict`` / ``set_state_dict`` use the JAX package's keys
(``global_step``, ``LR_Scheduler``, ``param_{i}_{slot}``);
``named_states`` / ``set_named_states`` carry the slots by parameter
name (e.g. from ``convert.optimizer_state_from_jax``). The learning
rate is a float or an ``lr.LRScheduler``; ``weight_decay`` a float, an
``L2Decay`` (its coefficient, as a float) or an ``L1Decay`` (applied to
the gradient). Static-graph mode (``minimize`` attaching to a program)
is not ported: ``minimize`` is the dygraph backward, step, clear.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch

from ..core.tensor import Tensor
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Lamb", "Adadelta"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (pass model.parameters())")
        params: List = list(parameters)
        if params and isinstance(params[0], tuple):
            self._param_names = [n for n, _ in params]
            params = [p for _, p in params]
        else:
            # a paddle Parameter's name, else the JAX package's param_{i}
            self._param_names = [getattr(p, "name", "") or f"param_{i}"
                                 if isinstance(p, Tensor) else
                                 f"param_{i}" for i, p in enumerate(params)]
        params = [p._t if isinstance(p, Tensor) else p for p in params]
        self._parameter_list: List[torch.Tensor] = params
        self._index = {id(p): i for i, p in enumerate(params)}
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._regularizer = None  # non-L2 penalty applied to grads
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:
            from ..regularizer import L1Decay
            if isinstance(weight_decay, L1Decay):
                # L1 is not a coefficient-foldable decay: its grad
                # penalty is applied explicitly
                self._regularizer = weight_decay
                self._weight_decay = 0.0
            else:  # L2Decay-like object with a coeff
                self._weight_decay = float(getattr(
                    weight_decay, "_coeff",
                    getattr(weight_decay, "coeff", 0.0)))
        # per-parameter slot states, by index into _parameter_list
        self._states: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = value

    # -- states --------------------------------------------------------------
    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _state_for(self, i: int) -> Dict[str, torch.Tensor]:
        s = self._states.get(i)
        if s is None:
            s = self._states[i] = self._init_state(self._parameter_list[i])
        return s

    # -- the pure update (override per optimizer) ---------------------------
    def _update(self, p, g, state, lr, index=None):
        raise NotImplementedError

    def _apply_regularizer(self, p, g):
        """Non-L2 grad penalty (e.g. L1Decay), before ``_update``."""
        if self._regularizer is None:
            return g
        return self._regularizer(p, g)

    def _use_wd(self, index) -> float:
        return self._weight_decay

    # -- step ----------------------------------------------------------------
    def _params_grads(self):
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        self._global_step += 1
        params_grads = self._params_grads()
        if not params_grads:
            return
        from . import fused_step
        if fused_step.try_step(self, params_grads):
            return
        self._eager_step(params_grads)

    @torch.no_grad()
    def _step_masked(self, found_inf, try_fused=True):
        """AMP path (GradScaler.step): ``step()`` with every parameter and
        state write masked by the 0-d device bool ``found_inf``, so a
        non-finite gradient keeps the old values without a host sync.
        ``try_fused=False`` when the caller already ran (and failed) the
        fused gate this step."""
        self._global_step += 1
        params_grads = self._params_grads()
        if not params_grads:
            return
        if try_fused:
            from . import fused_step
            if fused_step.try_step(self, params_grads, found_inf=found_inf):
                return
        self._eager_step(params_grads, found_inf=found_inf)

    def _eager_step(self, params_grads, found_inf=None):
        """The per-parameter update loop: the ``FLAGS_fused_optimizer=0``
        kill switch and the path of everything the fused kernels do not
        take (counted by reason in ``optimizer.fallbacks_total``)."""
        from .fused_step import apply_update_tail
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        params = [p for p, _ in params_grads]
        grads = [g for _, g in params_grads]
        new_ps, new_ss = apply_update_tail(self, params, grads, self.get_lr())
        for p, new_p, new_s in zip(params, new_ps, new_ss):
            i = self._index[id(p)]
            if found_inf is not None:
                old = self._states[i]
                new_p = torch.where(found_inf, p, new_p)
                new_s = {k: torch.where(found_inf, old[k], v)
                         for k, v in new_s.items()}
            p.copy_(new_p)
            self._states[i] = new_s

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Dygraph ``minimize``: backward, step, clear."""
        loss.backward()
        self.step()
        self.clear_grad()

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The JAX package's layout: ``global_step``, ``LR_Scheduler``
        (the scheduler's dict) and ``param_{i}_{slot}`` snapshot copies."""
        out: Dict[str, Any] = {"global_step": self._global_step}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        for i in range(len(self._parameter_list)):
            for k, v in (self._states.get(i) or {}).items():
                out[f"param_{i}_{k}"] = v.detach().clone()
        return out

    def set_state_dict(self, state_dict: Mapping[str, Any]) -> None:
        """Install a ``state_dict()`` (this package's or the JAX
        package's, numpy'd through ``convert``): slots are copied to each
        parameter's device, in the dtype this optimizer keeps them in."""
        self._global_step = int(state_dict.get("global_step", 0))
        if isinstance(self._learning_rate, LRScheduler) and \
                "LR_Scheduler" in state_dict:
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            prefix = f"param_{i}_"
            slots = {k[len(prefix):]: v for k, v in state_dict.items()
                     if isinstance(k, str) and k.startswith(prefix)}
            if slots:
                fresh = self._init_state(p)
                self._states[i] = {
                    k: torch.as_tensor(v).to(
                        device=p.device,
                        dtype=fresh[k].dtype if k in fresh else None
                    ).clone()
                    for k, v in slots.items()}

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
        device, in this optimizer's slot dtypes."""
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


def _div(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as one true f32 division (``float / tensor`` in PyTorch
    is a reciprocal times the float)."""
    return torch.div(torch.full_like(t, a), t)


class SGD(Optimizer):
    def _update(self, p, g, state, lr, index=None):
        g = g.float()
        wd = self._weight_decay
        if wd:
            g = g + wd * p.float()
        return (p - lr * g.to(p.dtype)).to(p.dtype), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, state, lr, index=None):
        g = g.float()
        if self._weight_decay:
            g = g + self._weight_decay * p.float()
        v = self._momentum * state["velocity"] + g
        upd = g + self._momentum * v if self._nesterov else v
        return (p.float() - lr * upd).to(p.dtype), {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def _update(self, p, g, state, lr, index=None):
        g = g.float()
        if self._weight_decay:
            g = g + self._weight_decay * p.float()
        m = state["moment"] + g * g
        new_p = p.float() - lr * g / (torch.sqrt(m) + self._epsilon)
        return new_p.to(p.dtype), {"moment": m}


class Adam(Optimizer):
    """L2 regularization folded into the gradient (unlike AdamW)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 use_multi_tensor=False, name=None, amsgrad=False):
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

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None,
                 amsgrad=False):
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32),
                "inf_norm": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update(self, p, g, state, lr, index=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g = g.float()
        if self._weight_decay:
            g = g + self._weight_decay * p.float()
        m = b1 * state["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(g))
        b1p = state["beta1_pow"] * b1
        new_p = (p.float() - _div(lr, 1 - b1p) * m / (u + eps)).to(p.dtype)
        return new_p, {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        s = {"mean_square": torch.zeros_like(p, dtype=torch.float32),
             "momentum": torch.zeros_like(p, dtype=torch.float32)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    def _update(self, p, g, state, lr, index=None):
        rho, eps = self._rho, self._epsilon
        g = g.float()
        if self._weight_decay:
            g = g + self._weight_decay * p.float()
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        new_state = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + eps)
            new_state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + eps)
        mom = self._momentum * state["momentum"] + lr * g / denom
        new_state["momentum"] = mom
        return (p.float() - mom).to(p.dtype), new_state


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device),
                "beta2_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update(self, p, g, state, lr, index=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g = g.float()
        p32 = p.float()
        m1 = b1 * state["moment1"] + (1 - b1) * g
        m2 = b2 * state["moment2"] + (1 - b2) * g * g
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        r = (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p)) + eps)
        wd = self._weight_decay
        if self._exclude_fn is not None and \
                self._exclude_fn(getattr(self, "_cur_param", None)):
            wd = 0.0
        r = r + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new_p = (p32 - lr * trust * r).to(p.dtype)
        return new_p, {"moment1": m1, "moment2": m2, "beta1_pow": b1p,
                       "beta2_pow": b2p}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p, dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(p,
                                                       dtype=torch.float32)}

    def _update(self, p, g, state, lr, index=None):
        rho, eps = self._rho, self._epsilon
        g = g.float()
        if self._weight_decay:
            g = g + self._weight_decay * p.float()
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        upd = g * torch.sqrt(state["avg_squared_update"] + eps) / \
            torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        return (p.float() - lr * upd).to(p.dtype), \
            {"avg_squared_grad": asg, "avg_squared_update": asu}
