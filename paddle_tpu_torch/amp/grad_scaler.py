"""GradScaler with dynamic loss scaling, kept on the device.

The port of ``paddle_tpu/amp/grad_scaler.py``. The loss scale and the
good/bad step counters are 0-d tensors on the card (``device``, the
card unless the caller names the CPU); ``unscale_`` runs the fused
step's O1 kernel over every gradient (f32 unscale in place, the global
finite check, ``fused_step.unscale_and_check``); the skip decision is a
0-d device bool that masks the optimizer update, and
:func:`_scale_update` is branch-free tensor math on the device. So
``step()`` and ``update()`` never sync with the host, fused or not:
when ``FLAGS_fused_optimizer`` is on, ``step()`` goes through
``fused_step.try_step_scaled``, where unscale, the finite check, the
clip, every update and the skip are the two kernels. An optimizer with
its own ``step`` (LBFGS) takes the one host-decision path: unscale,
read the flag, call its step. Host transfers happen only at explicit
host boundaries (``state_dict()``, a caller reading the scale).

Gradients must be f32, bf16 or f16 (the kernels' dtypes).

``update()`` writes the new scale and counters into the scaler's own
0-d tensors (the JAX package rebinds its arrays), so that a CUDA graph
that read and updated them keeps reading the live values. The
whole-step capture hooks (``jit/sot.py`` ``CapturedStep``):
:meth:`capture_statics` is the static part of the scaler for a graph's
signature (None when the pairing must run eagerly),
:meth:`capture_carry` the device state a captured step reads and
updates in place, and :meth:`absorb_captured` ends the iteration after
a replay, as ``update()`` ends an eager one.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device

__all__ = ["GradScaler"]


def _scale_update(found, scale, good, bad, incr_ratio, decr_ratio,
                  incr_every, decr_every):
    """Dynamic-loss-scaling bookkeeping, branch-free on the device."""
    bad2 = torch.where(found, bad + 1, 0)
    good2 = torch.where(found, 0, good + 1)
    dec = bad2 >= decr_every
    inc = good2 >= incr_every
    new_scale = torch.where(
        found,
        torch.where(dec, torch.clamp(scale * decr_ratio, min=1.0), scale),
        torch.where(inc, scale * incr_ratio, scale))
    return new_scale, torch.where(inc, 0, good2), torch.where(dec, 0, bad2)


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True,
                 device=None):
        self._device = resolve_device(device)
        self._enable = enable
        self._scale = self._full(init_loss_scaling, torch.float32)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every = int(incr_every_n_steps)
        self._decr_every = int(decr_every_n_nan_or_inf)
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = self._full(0, torch.int32)
        self._bad_steps = self._full(0, torch.int32)
        # False until an unscale runs, then a 0-d device bool
        self._found_inf = False
        self._unscaled_opts = set()

    def _full(self, value, dtype) -> torch.Tensor:
        # filled on the device: no host-to-device copy, so no sync
        return torch.full((), value, dtype=dtype, device=self._device)

    def _found_tensor(self) -> torch.Tensor:
        if isinstance(self._found_inf, torch.Tensor):
            return self._found_inf
        return self._full(False, torch.bool)

    def scale(self, var):
        if not self._enable:
            return var
        # the first scale() of an iteration (no unscale pending) clears
        # the OR-accumulated found flag, even when update() was skipped
        if not self._unscaled_opts:
            self._found_inf = False
        return var * self._scale.to(var.dtype)

    def _accumulate_found(self, found):
        if self._found_inf is False:
            self._found_inf = found
        else:
            self._found_inf = torch.logical_or(self._found_inf, found)

    def unscale_(self, optimizer):
        if not self._enable or id(optimizer) in self._unscaled_opts:
            return
        self._unscaled_opts.add(id(optimizer))
        from ..optimizer import fused_step
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        if not grads:
            return
        _, found = fused_step.unscale_and_check(
            grads, torch.reciprocal(self._scale))
        self._accumulate_found(found)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        from ..optimizer import fused_step
        from ..optimizer.optimizer import Optimizer
        cls = type(optimizer)
        if (getattr(cls, "step", None) is not Optimizer.step
                or getattr(cls, "_step_masked", None)
                is not Optimizer._step_masked
                or "step" in optimizer.__dict__):
            # a custom step() (LBFGS's closure loop) runs as written: the
            # one AMP path that reads the flag on the host
            self.unscale_(optimizer)
            if not bool(self._found_inf):
                optimizer.step()
            self._unscaled_opts.discard(id(optimizer))
            return
        retry_fused = True
        plain_unscale = ("unscale_" not in self.__dict__
                         and type(self).unscale_ is GradScaler.unscale_)
        if plain_unscale and id(optimizer) not in self._unscaled_opts:
            found = fused_step.try_step_scaled(
                optimizer, self._scale, prior_found=self._found_inf)
            if found is not None:
                self._accumulate_found(found)
                return
            # the gate just refused this configuration: do not run it
            # (and count its fallback) again below
            retry_fused = not fused_step.enabled()
        self.unscale_(optimizer)
        optimizer._step_masked(self._found_tensor(), try_fused=retry_fused)
        self._unscaled_opts.discard(id(optimizer))

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        # the found flag is per iteration, whatever the scaling mode
        found, self._found_inf = self._found_inf, False
        self._unscaled_opts.clear()
        if not (self._enable and self._dynamic):
            return
        f = found if isinstance(found, torch.Tensor) \
            else self._full(False, torch.bool)
        new = _scale_update(
            f, self._scale, self._good_steps, self._bad_steps,
            self._incr_ratio, self._decr_ratio, self._incr_every,
            self._decr_every)
        for t, v in zip(self.capture_carry(), new):
            t.copy_(v)

    # -- whole-step capture (jit/sot.py CapturedStep) ---------------------
    def capture_statics(self, optimizer):
        """The scaler's static configuration for a captured step's
        signature, or None when this scaler/optimizer pairing must run
        eagerly: an overridden ``step`` / ``unscale_`` / ``update``, an
        optimizer with its own ``step()`` (LBFGS), or a pending manual
        ``unscale_`` (the iteration already started eagerly)."""
        for name in ("step", "unscale_", "update"):
            if getattr(type(self), name) is not getattr(GradScaler, name) \
                    or name in self.__dict__:
                return None
        if self._unscaled_opts:
            return None
        from ..optimizer.optimizer import Optimizer
        cls = type(optimizer)
        if (getattr(cls, "step", None) is not Optimizer.step
                or getattr(cls, "_step_masked", None)
                is not Optimizer._step_masked
                or "step" in optimizer.__dict__):
            return None
        return (bool(self._dynamic), self._incr_ratio, self._decr_ratio,
                self._incr_every, self._decr_every)

    def capture_carry(self):
        """The device state a step reads and updates: the 0-d (scale
        f32, good_steps i32, bad_steps i32) tensors, updated in place,
        so a captured graph holds their addresses."""
        return (self._scale, self._good_steps, self._bad_steps)

    def absorb_captured(self, carry, found) -> None:
        """End the iteration of a replayed step: its graph updated
        ``carry`` in place (the tensors of :meth:`capture_carry`);
        ``found`` is the step's 0-d device non-finite flag (reading it
        is the caller's sync). Unscale marks clear, as ``update()``
        clears them."""
        if any(a is not b for a, b in zip(carry, self.capture_carry())):
            raise RuntimeError("absorb_captured: the carry is not this "
                               "scaler's state")
        self._found_inf = found
        self._unscaled_opts.clear()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale.clone()

    def set_init_loss_scaling(self, v):
        self._scale.fill_(float(v))

    def state_dict(self):
        return {"scale": float(self._scale), "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": int(self._good_steps),
                "bad_steps": int(self._bad_steps)}

    def load_state_dict(self, state):
        self._scale.fill_(float(state.get("scale", float(self._scale))))
        self._good_steps.fill_(int(state.get("good_steps", 0)))
        self._bad_steps.fill_(int(state.get("bad_steps", 0)))
