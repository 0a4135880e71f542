"""Eager autograd of the port: grad modes, ``apply_op``, ``backward``
and ``grad``.

The counterpart of ``paddle_tpu.core.autograd``. The JAX package keeps
its own tape (a ``GradNode`` per op holding a ``jax.vjp`` closure);
the port has none: every op runs on the wrapped ``torch.Tensor``s, so
``torch.autograd`` records it, and ``backward`` / ``grad`` are torch's
with paddle's rules on top (a gradient to an input that does not
require one is "unused"; ``allow_unused`` turns the error into None).
Tensor hooks, ``retain_grads`` and ``create_graph`` are torch's too.
:class:`GradNode` keeps the JAX class's constructor and fields for what
records a node of its own (``autograd.PyLayer``: a
``torch.autograd.Function`` whose backward calls the node's
``vjp_fn``); its name joins the dispatch counts.

Per-op checks after ``fn``, all behind one module-level bool that
``set_flags`` keeps up to date (the JAX module's flags): ``FLAGS_check_nan_inf`` computes ``any(~isfinite)`` of each
float output on the device and raises ``FloatingPointError`` naming the
op and output — at once with ``FLAGS_check_nan_inf_stride`` 1, else the
flags queue and :func:`flush_nan_checks` fetches them in one transfer
when the queue holds ``stride`` of them (and before each
:func:`backward` / :func:`grad`). ``FLAGS_benchmark`` synchronizes the
device after each op; ``FLAGS_retain_grad_for_all_tensor`` makes each
differentiable output ``retain_grad()``. A host fetch or a synchronize
is illegal inside a CUDA graph capture, so the NaN scan and the
synchronize skip ops that run while the current stream captures (the
JAX module skips tracers), and :func:`flush_nan_checks` keeps its
queue for the first call after the capture; the NaN scan also skips
ops a SOT recorder sees.

:func:`apply_op` dispatches each op as it comes (no lazy fusion): it
unwraps Tensor arguments, casts them per the AMP regime when
``amp.auto_cast`` is on (by op name, as the JAX package's dispatcher
does), calls ``fn`` on torch tensors and wraps what comes back —
unless it was given no Tensor at all, when it returns torch tensors,
so one function serves paddle user code and the port's torch modules.

The recorder seams of the JAX module, for ``jit/sot.py``:
``_op_recorder(fn, args, kwargs, outs, name)`` is called after each op
that ``apply_op`` runs outside another op, with ``fn`` wrapped so that
it repeats the AMP cast (the recorder replays it), and
``_backward_observer()`` before each :func:`backward` / :func:`grad`.
``_op_depth`` is how many ``apply_op`` calls are running (the recorder
tells an op's own torch calls from the user's by it). With no recorder
installed an op pays one test of ``_op_recorder``.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .flags import _registry as _flag_registry
from .flags import _watch as _watch_flags

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "GradNode", "apply_op", "backward", "grad", "flush_nan_checks"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class _GradModeGuard:
    """A context manager and decorator that sets torch's grad mode."""

    def __init__(self, mode: bool):
        self._mode = bool(mode)

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with type(self)(self._mode):
                return fn(*args, **kwargs)
        return wrapper


def no_grad(func=None):
    """Context manager or decorator: ops record no gradient."""
    guard = _GradModeGuard(False)
    return guard(func) if func is not None else guard


def enable_grad(func=None):
    guard = _GradModeGuard(True)
    return guard(func) if func is not None else guard


def set_grad_enabled(mode):
    """A guard (context manager) that sets the grad mode to ``mode``."""
    return _GradModeGuard(mode)


_Tensor = None
_amp_state = _maybe_cast_inputs = None


def _tensor_cls():
    global _Tensor, _amp_state, _maybe_cast_inputs
    if _Tensor is None:
        from .tensor import Tensor
        from ..amp.auto_cast import _state, maybe_cast_inputs
        _Tensor, _amp_state, _maybe_cast_inputs = \
            Tensor, _state, maybe_cast_inputs
    return _Tensor


class GradNode:
    """One recorded node: its vjp closure, its differentiable input
    Tensors, the ``(shape, dtype)`` of its outputs and its name — the
    JAX class's fields. (The JAX node's ``fn`` / ``datas`` / ``kwargs``
    / ``diff_idx`` serve its own tape's grad-of-grad; torch's autograd
    does that here.)"""

    __slots__ = ("vjp_fn", "inputs", "out_avals", "name", "__weakref__")

    def __init__(self, vjp_fn, inputs, out_avals, name):
        self.vjp_fn = vjp_fn
        self.inputs = inputs
        self.out_avals = out_avals
        self.name = name

    def __repr__(self):
        return f"GradNode({self.name})"


def count_dispatch(name: str) -> None:
    """One more dispatch of ``name`` in the op table's counts."""
    _dispatches[name] = _dispatches.get(name, 0) + 1


# -- per-op checks ------------------------------------------------------------

_nan_flag = _flag_registry["check_nan_inf"]
_stride_flag = _flag_registry["check_nan_inf_stride"]
_bench_flag = _flag_registry["benchmark"]
_retain_all_flag = _flag_registry["retain_grad_for_all_tensor"]
# any of the three on: the one test an op pays for the per-op checks
_checks_on = False


def _update_checks_on() -> None:
    global _checks_on
    _checks_on = bool(_nan_flag.value or _bench_flag.value
                      or _retain_all_flag.value)


_watch_flags(("check_nan_inf", "benchmark", "retain_grad_for_all_tensor"),
             _update_checks_on)

# queued device flags: (op name, output index, 0-d bool tensor); the
# host reads them in one transfer (flush_nan_checks)
_nan_pending: list = []
# host fetches the NaN check has made (one a flush, one an op at stride 1)
_nan_fetches = 0


def _nan_error(name: str, i: int) -> FloatingPointError:
    return FloatingPointError(
        f"Operator {name} output {i} contains NaN or Inf "
        f"(FLAGS_check_nan_inf is set)")


def flush_nan_checks() -> None:
    """Fetch every queued NaN flag in one transfer and raise naming the
    first offending op; the queue is empty after. While a CUDA stream
    captures (or torch.compile traces) it fetches nothing and keeps the
    queue: a host fetch would invalidate the capture."""
    global _nan_pending, _nan_fetches
    if not _nan_pending or _capturing(_nan_pending[0][2]):
        return
    pending, _nan_pending = _nan_pending, []
    dev = pending[0][2].device
    flags = torch.stack([f.to(dev) for _, _, f in pending]).cpu()
    _nan_fetches += 1
    if bool(flags.any()):
        name, i, _ = pending[int(flags.to(torch.uint8).argmax())]
        raise _nan_error(name, i)


def _capturing(t: torch.Tensor) -> bool:
    return ((t.is_cuda or torch.cuda.is_initialized())
            and torch.cuda.is_current_stream_capturing()) or \
        torch.compiler.is_compiling()


def _post_op(name: str, out) -> None:
    """The flagged per-op checks on ``fn``'s result (see the module
    docstring)."""
    global _nan_fetches
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(o, torch.Tensor)]
    if not outs or _capturing(outs[0]):
        return
    if _retain_all_flag.value:
        for o in outs:
            if o.requires_grad and not o.is_leaf:
                o.retain_grad()
    if _nan_flag.value and _op_recorder is None:
        stride = max(int(_stride_flag.value or 1), 1)
        for i, o in enumerate(outs):
            if not (o.is_floating_point() or o.is_complex()):
                continue
            flag = torch.isfinite(o.detach()).logical_not().any()
            if stride <= 1:
                _nan_fetches += 1
                if bool(flag):
                    raise _nan_error(name, i)
            else:
                _nan_pending.append((name, i, flag))
        if len(_nan_pending) >= stride:
            flush_nan_checks()
    if _bench_flag.value:
        for o in outs:
            if o.is_cuda:
                torch.cuda.synchronize(o.device)
                break


def _wrap(out, Tensor):
    if isinstance(out, torch.Tensor):
        return Tensor(out)
    if isinstance(out, (tuple, list)):
        return tuple(Tensor(o) if isinstance(o, torch.Tensor) else o
                     for o in out)
    return out


_op_recorder = None
_backward_observer = None
_op_depth = 0
# eager dispatches per op name since process start (ops.op_registry's
# dispatch_counts)
_dispatches: dict = {}


def apply_op(fn: Callable, *args, op_name: Optional[str] = None, **kwargs):
    """Run ``fn`` (a function of torch tensors) on ``args``, where
    Tensors are unwrapped; the result (a tensor or a tuple of them) is
    wrapped when any argument was a Tensor and returned as it is
    otherwise. ``kwargs`` are passed through unchanged. Under
    ``amp.auto_cast`` the positional tensors are cast per the regime
    for ``op_name`` (else ``fn.__name__``)."""
    Tensor = _Tensor or _tensor_cls()
    name = op_name or getattr(fn, "__name__", "op")
    _dispatches[name] = _dispatches.get(name, 0) + 1
    wrapped = False
    raw = []
    for a in args:
        if isinstance(a, Tensor):
            raw.append(a._t)
            wrapped = True
        else:
            raw.append(a)
    if _amp_state.enabled:
        raw = _maybe_cast_inputs(name, raw)
    if _op_recorder is not None:
        return _apply_recorded(fn, args, raw, kwargs, op_name, wrapped,
                               Tensor)
    out = fn(*raw, **kwargs)
    if _checks_on:
        _post_op(name, out)
    return _wrap(out, Tensor) if wrapped else out


def _apply_recorded(fn, args, raw, kwargs, op_name, wrapped, Tensor):
    """``apply_op`` under a recorder: the op runs as usual, then the
    recorder gets it with the arguments as given (before the AMP cast,
    which ``record_fn`` repeats); an op inside another op's ``fn`` is
    the outer op's. An op on torch tensors (a Layer called with them)
    is given with those tensors in and out."""
    global _op_depth
    _op_depth += 1
    try:
        out = fn(*raw, **kwargs)
    finally:
        _op_depth -= 1
    if _checks_on:
        _post_op(op_name or getattr(fn, "__name__", "op"), out)
    rec = _op_recorder
    if _op_depth or rec is None:
        return _wrap(out, Tensor) if wrapped else out
    name = op_name or getattr(fn, "__name__", "op")
    record_fn = fn
    if _amp_state.enabled:
        def record_fn(*a, _fn=fn, _name=name, **kw):
            return _fn(*_maybe_cast_inputs(_name, list(a)), **kw)
    res = _wrap(out, Tensor) if wrapped else out
    multi = isinstance(res, (tuple, list))
    rec(record_fn, args, kwargs, tuple(res) if multi else (res,), name)
    return res


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``: accumulate the gradients of
    ``tensors`` into the ``.grad`` of the leaves; a root that is not a
    single element needs its gradient."""
    from .tensor import as_torch
    flush_nan_checks()  # the forward's queued flags first
    if _backward_observer is not None:
        _backward_observer()
    roots = [t._t for t in _as_list(tensors)]
    if grad_tensors is None:
        grads = [None] * len(roots)
    else:
        grads = [None if g is None else as_torch(g, device=r.device)
                 for g, r in zip(_as_list(grad_tensors), roots)]
    for r, g in zip(roots, grads):
        if g is None and r.numel() != 1:
            raise RuntimeError(
                "grad must be provided for non-scalar backward root")
    # a root that records no gradient (stop_gradient) contributes none
    live = [(r, g) for r, g in zip(roots, grads) if r.requires_grad]
    if live:
        torch.autograd.backward(
            [r for r, _ in live],
            [torch.ones_like(r) if g is None else g.to(r.dtype)
             for r, g in live], retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, without touching ``.grad``. With ``create_graph`` the
    backward pass is recorded, so the results compose for grad-of-grad.
    An input the outputs do not depend on (or that does not require a
    gradient) raises unless ``allow_unused``, which gives None."""
    from .tensor import Tensor, as_torch
    flush_nan_checks()
    if _backward_observer is not None:
        _backward_observer()
    outs = [t._t for t in _as_list(outputs)]
    ins = _as_list(inputs)
    gos = [None] * len(outs) if grad_outputs is None else \
        _as_list(grad_outputs)
    seeds, roots = [], []
    for o, g in zip(outs, gos):
        if not o.requires_grad:
            continue
        roots.append(o)
        seeds.append(torch.ones_like(o) if g is None
                     else as_torch(g, device=o.device).to(o.dtype))
    live = [i for i, t in enumerate(ins) if t._t.requires_grad]
    got = [None] * len(ins)
    if roots and live:
        res = torch.autograd.grad(
            roots, [ins[i]._t for i in live], seeds,
            retain_graph=retain_graph if retain_graph is not None
            else create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, res):
            got[i] = g
    if not allow_unused and any(g is None for g in got):
        raise RuntimeError(
            "One of the differentiated tensors appears unused; pass "
            "allow_unused=True to return None for it")
    return [None if g is None else Tensor(g) for g in got]
