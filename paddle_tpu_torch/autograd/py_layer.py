"""PyLayer: a user-defined forward and backward pair.

The port of ``paddle_tpu.autograd.py_layer``. ``PyLayer.apply`` runs
the user's ``forward`` under ``no_grad`` and records one
``torch.autograd.Function`` node over the differentiable (float,
gradient-requiring) Tensor inputs; the node's backward calls the
user's ``backward`` through a :class:`GradNode`'s ``vjp_fn``, on
Tensors (on torch tensors when the layer was applied to torch tensors
only, as the port's torch modules call it). The JAX contract holds: ``backward`` returns one gradient
per tensor argument, in order; a None gradient becomes zeros, and a
gradient for an input that takes none (a non-float one) is dropped;
with no input needing a gradient the outputs come back as ``forward``
returned them. Output gradients reach ``backward`` materialized (zeros
for an output that received none) whatever ``set_materialize_grads``
says, and ``mark_not_inplace`` / ``mark_non_differentiable`` record
nothing, as in the JAX package.

:class:`saved_tensors_hooks` reaches the tensors of
``PyLayerContext.save_for_backward`` only (pack at save, unpack once at
the first ``saved_tensor()``), as the JAX class does — not the tensors
every torch op saves, which ``torch.autograd.graph.saved_tensors_hooks``
would reach.
"""
from __future__ import annotations

import torch

from ..core.autograd import GradNode, count_dispatch, is_grad_enabled, \
    no_grad
from ..core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "saved_tensors_hooks"]

# (pack, unpack) pairs installed by saved_tensors_hooks, innermost last
_saved_tensor_hooks: list = []


class saved_tensors_hooks:
    """Context manager: ``pack_hook`` maps each tensor a PyLayer saves
    for backward to what is stored; ``unpack_hook`` rebuilds the tensor
    when backward first reads it."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def __enter__(self):
        _saved_tensor_hooks.append((self.pack_hook, self.unpack_hook))
        return self

    def __exit__(self, *exc):
        _saved_tensor_hooks.pop()
        return False


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self._saved_packed = False
        self._unpack_hook = None
        self._materialize_grads = True

    def save_for_backward(self, *tensors):
        if _saved_tensor_hooks:
            pack, unpack = _saved_tensor_hooks[-1]
            self._saved = tuple(pack(t) for t in tensors)
            self._saved_packed = True
            self._unpack_hook = unpack
        else:
            self._saved = tensors

    def saved_tensor(self):
        if self._saved_packed:
            # unpack once: later reads must not run the hook again
            self._saved = tuple(self._unpack_hook(p) for p in self._saved)
            self._saved_packed = False
        return self._saved

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        pass

    def set_materialize_grads(self, value: bool):
        self._materialize_grads = bool(value)


def _raw(t):
    return t._t if isinstance(t, Tensor) else t


def _is_diff(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class _Node(torch.autograd.Function):
    """The node ``PyLayer.apply`` records: its forward hands back the
    outputs the user's forward made (``box[0]``; a view is copied, as a
    node's output may not alias what it did not make), its backward runs
    ``node.vjp_fn`` on the output gradients."""

    @staticmethod
    def forward(fctx, node, box, *diff_inputs):
        fctx.node = node
        outs = tuple(o.clone() if o._is_view() else o for o in box.pop())
        fctx.mark_non_differentiable(*[o for o in outs if not _is_diff(o)])
        return outs

    @staticmethod
    def backward(fctx, *cts):
        return (None, None) + fctx.node.vjp_fn(cts)


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        tensor_args = [a for a in args
                       if isinstance(a, (Tensor, torch.Tensor))]
        requires = is_grad_enabled() and any(
            _raw(t).requires_grad for t in tensor_args)
        with no_grad():
            outs = cls.forward(ctx, *args, **kwargs)
        if not requires:
            return outs
        multi = isinstance(outs, (tuple, list))
        outs_t = tuple(outs) if multi else (outs,)
        wrap = any(isinstance(a, Tensor) for a in tensor_args) or \
            any(isinstance(o, Tensor) for o in outs_t)
        diff_inputs = tuple(t for t in tensor_args
                            if _raw(t).requires_grad and _is_diff(_raw(t)))
        raw_outs = tuple(_raw(o) if isinstance(o, (Tensor, torch.Tensor))
                         else torch.as_tensor(o) for o in outs_t)

        def vjp_fn(cts):
            grads = cls.backward(ctx, *[Tensor(c) if wrap else c
                                        for c in cts])
            if not isinstance(grads, (tuple, list)):
                grads = (grads,)
            # positional: one gradient per Tensor argument
            by_tensor = {id(t): g for t, g in zip(tensor_args, grads)}
            out = []
            for t in diff_inputs:
                g, r = by_tensor.get(id(t)), _raw(t)
                if g is None:
                    out.append(torch.zeros_like(r))
                else:
                    out.append(torch.as_tensor(_raw(g), device=r.device)
                               .to(r.dtype))
            return tuple(out)

        node = GradNode(vjp_fn, diff_inputs,
                        tuple((tuple(o.shape), o.dtype) for o in raw_outs),
                        cls.__name__)
        count_dispatch(cls.__name__)
        got = _Node.apply(node, [raw_outs], *[_raw(t) for t in diff_inputs])
        got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
        res = tuple(Tensor(o) if wrap else o for o in got)
        return res if multi else res[0]
