"""One fused optimizer step: Adam and AdamW as two multi-tensor kernels,
SGD and Momentum as multi-tensor ops on the device lr.

The port of ``paddle_tpu/optimizer/fused_step.py``. The JAX package
flattens the whole parameter tree and compiles one donated XLA program a
step: grad unscale and finite check (AMP), clipping, every update and
the skip of a non-finite step, with lr and the loss scale as 0-d device
arguments. Here the same step is two hand-written kernels
(``ops/kernels/multi_tensor.py``), launched over a table of the
parameters, gradients and states:

- O1 (``multi_tensor_unscale_norm``) when the step unscales
  (``GradScaler``) or clips by a norm: unscale in place, finite check,
  sums of squares, the clip scale;
- O2 (``multi_tensor_adam``): clip, decay, moments, bias corrections,
  parameters and beta powers in place, masked by the found flags.

SGD and Momentum (the JAX bench's ResNet-50 step) take no kernel: their
``_update`` runs over every parameter as ``torch._foreach_*`` ops with
lr read from the same device tensor, parameters and velocities written
in place (:func:`_sgd_momentum_step`), bit-equal on CPU tensors to the
per-parameter loop; the JAX package runs that update inside its one XLA
program too. The clip is ``clip_by_spec`` and, under a ``GradScaler``,
O1 unscales and checks first.

lr lives in a 0-d f32 tensor on the parameters' device, refilled on the
device only when the host value changes; the loss scale, the clip scale
and the found flags never leave the device. So a step issues its
launches and returns without a host sync. On CPU tensors the wrappers
run the kernels' plain versions, bit-equal to the per-parameter loop.

The gate :func:`_prepare` sends everything the kernels do not take to
the per-parameter loop (``Optimizer._eager_step``), counted by reason
in ``optimizer.fallbacks_total`` and journaled in the flight ring:
``optimizer`` (a step that is not one update, LBFGS), ``optimizer_type``
(every optimizer but Adam, AdamW, SGD and Momentum, subclasses
included: their update may differ), ``grad_clip`` (a clip object that
is not one of the three in-tree classes), ``regularizer``
(``L1Decay``), ``duplicate_param``,
``param_static`` (an ``apply_decay_param_fun`` that fails) and
``frozen_param_grads``: the JAX gate's reasons that have a meaning here,
and the three configurations the kernels do not compute.
``FLAGS_fused_optimizer=0`` is the user's choice of the loop, not a
fallback, and is not counted. Tensors are not a reason: the kernels take
f32, bf16 and f16 in any layout (``AdamTable``), and raise on what they
cannot take (another dtype, tensors on several devices), as a kernel
that fails to build or launch raises; none gives way to the loop.

The optimizer keeps its ``AdamTable``: the parameters, moments, powers
and decays are laid out and checked once, and again only when one of
their tensors moved (``p.data`` replaced, states replaced by the loop or
``set_state_dict``) or a decay changed; a step checks its gradients.

Counters (``observability/metrics.py``): ``optimizer.fused_steps_total``
and ``optimizer.fallbacks_total{reason}``. The JAX package's program cache,
its compile-on-second-sighting policy, buffer donation and the alias
copies it needs have no counterpart: the kernels are built once and
update in place.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.flags import _registry as _flag_registry
from ..observability import flight as _flight
from ..observability import metrics as _om
from ..ops.kernels import multi_tensor as _mt
from ..utils.clip_grad import clip_by_spec, clip_spec

__all__ = ["try_step", "try_step_scaled", "unscale_and_check", "enabled",
           "apply_update_tail"]

_flag = _flag_registry["fused_optimizer"]

_M = _om.scope("optimizer")
_M_steps = _M.counter(
    "fused_steps_total",
    "Optimizer steps executed as the fused multi-tensor kernels")
_M_fallbacks = _M.counter(
    "fallbacks_total",
    "Steps that fell back to the per-parameter loop, by reason")


def enabled() -> bool:
    return bool(_flag.value)


def _fallback(reason: str):
    _M_fallbacks.inc(reason=reason)
    _flight.record("optimizer", "fallback", reason=reason)
    return None


def apply_update_tail(opt, params, grads, lr, cspec=()):
    """The optimizer's tail: clip (a ``clip_spec``) -> regularizer ->
    each parameter's pure ``_update``, returning ``(new_params,
    new_states)`` without writing anything. The per-parameter loop runs
    it (its class clip already applied)."""
    gs = list(grads)
    if cspec:
        gs = clip_by_spec(cspec, gs)
    new_ps: List[torch.Tensor] = []
    new_ss = []
    for p, g in zip(params, gs):
        i = opt._index[id(p)]
        opt._cur_param = p  # lets _update consult the parameter (Lamb)
        g = opt._apply_regularizer(p, g)
        new_p, new_s = opt._update(p, g, opt._state_for(i), lr, i)
        new_ps.append(new_p)
        new_ss.append(new_s)
    return new_ps, new_ss


class _Prep:
    __slots__ = ("kind", "params", "states", "grads", "table", "cspec",
                 "device")


def _kind(opt):
    """``"adam"`` (O1/O2), ``"sgd"`` or ``"momentum"`` (multi-tensor ops)
    for the exact classes, else None."""
    from .optimizer import SGD, Adam, AdamW, Momentum
    return {Adam: "adam", AdamW: "adam", SGD: "sgd",
            Momentum: "momentum"}.get(type(opt))


_SLOTS = ("moment1", "moment2", "beta1_pow", "beta2_pow")


def _table(opt, params, states, wds) -> _mt.AdamTable:
    """The optimizer's kept ``AdamTable``, built anew when a parameter or
    state tensor is not where it was (its pointer) or a decay changed."""
    cols = [params] + [[st[k] for st in states] for k in _SLOTS]
    key = [t.data_ptr() for col in cols for t in col] + wds
    kept = getattr(opt, "_fused_table", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    table = _mt.AdamTable(*cols, wds)
    opt._fused_table = (key, table)
    return table


def _prepare(opt, params_grads) -> Optional[_Prep]:
    """Gate + table. Returns None (fallback, reason counted) or the
    tensors the kernels take."""
    if getattr(opt, "_fusable_step", True) is False:
        return _fallback("optimizer")
    kind = _kind(opt)
    if kind is None:
        return _fallback("optimizer_type")
    cspec = clip_spec(opt._grad_clip)
    if cspec is None:
        return _fallback("grad_clip")
    if opt._regularizer is not None:
        return _fallback("regularizer")
    params = [p for p, _ in params_grads]
    if len({id(p) for p in params}) != len(params):
        return _fallback("duplicate_param")
    states, wds = [], []
    for p in params:
        i = opt._index[id(p)]
        states.append(opt._state_for(i))
        try:
            wds.append(float(opt._use_wd(i)))
        except (TypeError, ValueError):
            return _fallback("param_static")
    prep = _Prep()
    prep.kind = kind
    prep.params, prep.states = params, states
    prep.grads = [g for _, g in params_grads]
    prep.table = _table(opt, params, states, wds) if kind == "adam" \
        else None
    prep.cspec = cspec
    prep.device = params[0].device
    return prep


def _lr_device(opt, device) -> torch.Tensor:
    """The step's lr as a 0-d f32 tensor on ``device``, refilled (on the
    device: no copy, no sync) only when the host value changed."""
    lr_now = float(opt.get_lr())
    t = getattr(opt, "_fused_lr_dev", None)
    if t is None or t.device != device:
        t = opt._fused_lr_dev = torch.empty((), dtype=torch.float32,
                                            device=device)
        opt._fused_lr_host = None
    if opt._fused_lr_host != lr_now:
        t.fill_(lr_now)
        opt._fused_lr_host = lr_now
    return t


def _write(dst, src, found):
    """``dst = src`` in place (cast to ``dst``'s dtypes), each element
    kept where the 0-d device bool ``found`` is set."""
    if found is not None:
        src = [torch.where(found, d, s) for d, s in zip(dst, src)]
    torch._foreach_copy_(dst, src)


@torch.no_grad()
def _sgd_momentum_step(opt, prep, lr, found):
    """SGD's or Momentum's ``_update`` (``optimizer.py``) for every
    parameter at once, operation for operation: the gradient in f32
    with the L2 decay added, Momentum's f32 velocity ``μ·v + g`` and
    ``p − lr·upd`` in f32 (Nesterov: ``upd = g + μ·v``); SGD's
    ``p − lr·g`` in the parameter's dtype, the product rounded to it
    as the loop's is. ``lr`` is the 0-d f32 device tensor, so a graph
    that holds the step reads the current lr. Parameters and velocities
    are written in place, masked by ``found``."""
    params = prep.params
    g32 = [g.float() for g in prep.grads]
    wd = opt._weight_decay
    if wd:
        g32 = torch._foreach_add(
            g32, torch._foreach_mul([p.float() for p in params], wd))
    if prep.kind == "sgd":
        gd = [g.to(p.dtype).float() for g, p in zip(g32, params)]
        steps = [s.to(p.dtype) for s, p in
                 zip(torch._foreach_mul(gd, lr), params)]
        _write(params, torch._foreach_sub(params, steps), found)
        return
    mu = opt._momentum
    vel = [st["velocity"] for st in prep.states]
    v_new = torch._foreach_mul(vel, mu)
    torch._foreach_add_(v_new, g32)
    upd = torch._foreach_add(g32, torch._foreach_mul(v_new, mu)) \
        if opt._nesterov else v_new
    p_new = torch._foreach_sub([p.float() for p in params],
                               torch._foreach_mul(upd, lr))
    _write(params, p_new, found)
    _write(vel, v_new, found)


def _execute(opt, prep, mode, found=(), inv_scale=None):
    """O1 where the step unscales or clips by a norm, then O2 (Adam and
    AdamW); O1 where it unscales, then the clip and the multi-tensor
    update (SGD, Momentum). Returns O1's found flag of this check in the
    ``scaled`` mode."""
    lr = _lr_device(opt, prep.device)
    if prep.kind != "adam":
        return _execute_sgd_momentum(opt, prep, mode, lr, found, inv_scale)
    kind = prep.cspec[0] if prep.cspec else None
    res = None
    table = prep.table
    table.set_grads(prep.grads)
    if mode == "scaled" or kind in ("global_norm", "norm"):
        res = table.unscale_norm(
            inv_scale if mode == "scaled" else None, prep.cspec)
    flags = [f for f in found if f is not None]
    if mode == "scaled":
        flags.insert(0, res.found)
    table.adam(
        lr=lr, beta1=opt._beta1, beta2=opt._beta2,
        epsilon=opt._epsilon, decoupled=opt._decoupled_wd, clip=prep.cspec,
        scale=None if res is None else res.scale, found=flags)
    _M_steps.inc()
    _flight.record("optimizer", "fused_step", mode=mode,
                   params=len(prep.grads))
    return res.found if mode == "scaled" else None


def _execute_sgd_momentum(opt, prep, mode, lr, found, inv_scale):
    flags = [f for f in found if f is not None]
    res_found = None
    if mode == "scaled":
        _, res_found = unscale_and_check(prep.grads, inv_scale)
        flags.insert(0, res_found)
    mask = None
    for f in flags:
        mask = f if mask is None else torch.logical_or(mask, f)
    prep.grads = clip_by_spec(prep.cspec, prep.grads)
    _sgd_momentum_step(opt, prep, lr, mask)
    _M_steps.inc()
    _flight.record("optimizer", "fused_step", mode=mode,
                   params=len(prep.grads))
    return res_found


def try_step(opt, params_grads, found_inf=None) -> bool:
    """Run the optimizer step as the fused kernels. Returns False when
    the caller should run the per-parameter loop instead (kill switch,
    a configuration the kernels do not take). ``found_inf`` (a 0-d bool
    on the parameters' device, from ``GradScaler.unscale_``) masks every
    update on the device."""
    if not _flag.value:
        return False
    prep = _prepare(opt, params_grads)
    if prep is None:
        return False
    _execute(opt, prep, "plain" if found_inf is None else "found",
             found=(found_inf,))
    return True


def try_step_scaled(opt, scale, prior_found=False):
    """GradScaler.step's fast path: unscale, finite check, clip, every
    update and the skip in the two kernels. ``prior_found`` (the
    scaler's OR-accumulated flag from earlier ``unscale_`` calls this
    iteration, a 0-d bool tensor, or False) joins the mask. Returns the
    0-d device found flag of this check, or None when the caller must
    fall back (then: ``unscale_`` and the masked step)."""
    if not _flag.value:
        return None
    params_grads = opt._params_grads()
    if not params_grads:
        return None
    if any(not p.requires_grad and p.grad is not None
           for p in opt._parameter_list):
        # the fallback unscales and checks every gradient, frozen ones
        # too; the kernels only see trainable ones
        return _fallback("frozen_param_grads")
    prep = _prepare(opt, params_grads)
    if prep is None:
        return None
    prior = prior_found if isinstance(prior_found, torch.Tensor) else None
    found = _execute(opt, prep, "scaled", found=(prior,),
                     inv_scale=torch.reciprocal(scale))
    opt._global_step += 1
    return found


def unscale_and_check(grads, inv_scale):
    """O1 over every gradient: unscale in place (f32 math, dtype
    restored) and the global finite check. Returns ``(grads, found)``,
    ``found`` a 0-d device bool: the decision never syncs to the
    host."""
    grads = list(grads)
    return grads, _mt.multi_tensor_unscale_norm(grads, inv_scale).found
