"""Tensor: the paddle-API eager array of the port.

The counterpart of ``paddle_tpu.core.tensor``. A :class:`Tensor` wraps
one ``torch.Tensor`` (``_t``); it is not a ``torch.Tensor`` subclass,
because paddle gives ``size`` (a property), ``shape`` (a list),
``split(num_or_sections, axis)``, ``reshape(list)``,
``transpose(perm)`` and ``view`` other meanings than torch does.
Gradients are torch's: ``stop_gradient`` is the inverse of the wrapped
tensor's ``requires_grad`` (integer and bool tensors, which torch never
lets require grad, keep the flag on the wrapper), ``.grad`` is the
wrapped tensor's ``.grad`` as a Tensor, and ``backward`` is
``torch.autograd.backward``.

Mutation (``set_value``, ``fill_``, ``zero_``, ``copy_``,
``__setitem__`` and the ``op_`` methods) writes a leaf in place under
``no_grad`` — a parameter's wrapper writes into the
``torch.nn.Parameter`` its layer holds — and rebinds a non-leaf to the
new value, as the JAX package rebinds its immutable arrays.

Torch functions accept a Tensor (``__torch_function__``): they run on
the wrapped tensors and return Tensors.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from . import dtype as dtype_mod
from . import device as device_mod

__all__ = ["Tensor", "Parameter", "to_tensor", "unwrap", "wrap",
           "wrap_leaf", "as_torch", "unwrap_tree", "wrap_tree"]

# recorder seams (jit/sot.py), as in the JAX module: _materialize_hook(
# tensor, kind) before a value leaves for the host (``numpy``, ``item``,
# ``tolist``, ``__array__`` and the Python number conversions through
# them), _mutation_hook(tensor) before a Tensor is written in place or
# rebound
_materialize_hook = None
_mutation_hook = None

# the host-sync auditor's seam (analysis.auditor), as in the JAX module:
# _sync_hook(tensor, kind) on every read of a value to the host —
# ``numpy``, ``item``, ``tolist``, ``__array__`` — apart from the
# recorder's, so a SOT recording and an audit can watch one step. None
# outside an audit: one module-global test a read.
_sync_hook = None


def unwrap_tree(x):
    if isinstance(x, Tensor):
        return x._t
    if isinstance(x, (list, tuple)):
        return type(x)(unwrap_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: unwrap_tree(v) for k, v in x.items()}
    return x


def wrap_tree(x):
    """torch tensors -> Tensors through lists and tuples (a torch named
    tuple of results comes back as a plain tuple)."""
    if isinstance(x, torch.Tensor):
        return Tensor(x)
    if isinstance(x, list):
        return [wrap_tree(v) for v in x]
    if isinstance(x, tuple):
        return tuple(wrap_tree(v) for v in x)
    return x


def _numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a.astype(np.float32), copy=True)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def as_torch(value, device=None, dtype=None) -> torch.Tensor:
    """A Tensor, torch tensor, numpy array or Python value as a torch
    tensor (numpy float64 and Python floats take the default dtype, as
    ``to_tensor`` makes them)."""
    if isinstance(value, Tensor):
        t = value._t
    elif isinstance(value, torch.Tensor):
        t = value
    else:
        a = np.asarray(value)
        t = _numpy_to_torch(a)
        if dtype is None and a.dtype == np.float64:
            dtype = dtype_mod.get_default_dtype()
        if t.dim() == 0 and device is not None and \
                torch.device(device).type == "cuda":
            # a Python scalar goes to the card as a fill, not as a copy
            # from pageable memory (which a CUDA graph capture refuses)
            return torch.full((), t.item(), dtype=dtype or t.dtype,
                              device=device)
    if device is not None or dtype is not None:
        t = t.to(device=device, dtype=dtype)
    return t


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _is_diff(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class Tensor:
    __slots__ = ("_t", "name", "_sg", "__weakref__")

    def __init__(self, data, stop_gradient: bool = True,
                 name: Optional[str] = None):
        t = data if isinstance(data, torch.Tensor) else as_torch(data)
        self._t = t
        self.name = name or ""
        self._sg = True
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        out = func(*unwrap_tree(args), **unwrap_tree(kwargs or {}))
        return wrap_tree(out)

    # -- basic properties ---------------------------------------------------
    @property
    def data(self):
        return self

    @property
    def shape(self):
        return list(self._t.shape)

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def size(self):
        return self._t.numel()

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def place(self):
        return device_mod.place_of(self._t.device)

    @property
    def is_leaf(self):
        return self._t.is_leaf

    @property
    def stop_gradient(self) -> bool:
        return self._sg and not self._t.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        t = self._t
        if value:
            self._sg = True
            if t.requires_grad:
                if t.is_leaf:
                    t.requires_grad_(False)
                else:
                    self._t = t.detach()
        elif _is_diff(t):
            if not t.requires_grad:
                t.requires_grad_(True)
        else:
            self._sg = False

    @property
    def grad(self):
        t = self._t
        if not (t.is_leaf or t.retains_grad) or t.grad is None:
            return None
        return Tensor(t.grad)

    @grad.setter
    def grad(self, value):
        self._t.grad = None if value is None else as_torch(value)

    def numel(self):
        return self.size

    def dim(self):
        return self.ndim

    # -- host interop -------------------------------------------------------
    def numpy(self):
        """The values as numpy (bf16 comes back as float32: numpy has no
        bfloat16 of its own)."""
        if _sync_hook is not None:
            _sync_hook(self, "numpy")
        return self._numpy()

    def _numpy(self):
        if _materialize_hook is not None:
            _materialize_hook(self, "numpy")
            # the hook's recorder has seen the read: the conversion is
            # not the user's
            with torch._C.DisableTorchFunction():
                return _to_numpy(self._t)
        return _to_numpy(self._t)

    def item(self, *args):
        if _sync_hook is not None:
            _sync_hook(self, "item")
        if args:
            return self._numpy().item(*args)
        if _materialize_hook is not None:
            _materialize_hook(self, "item")
            with torch._C.DisableTorchFunction():
                return self._t.item()
        return self._t.item()

    def tolist(self):
        if _sync_hook is not None:
            _sync_hook(self, "tolist")
        return self._numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        if _sync_hook is not None:
            _sync_hook(self, "__array__")
        a = self._numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self.shape[0]

    def __repr__(self):
        grad_str = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place}{grad_str},\n       "
                f"{self.numpy()!r})")

    def __hash__(self):
        return id(self)

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        from .autograd import backward
        backward([self], None if grad_tensor is None else [grad_tensor],
                 retain_graph=retain_graph)

    def clear_grad(self):
        self._t.grad = None

    def clear_gradient(self, set_to_zero: bool = False):
        if set_to_zero and self._t.grad is not None:
            self._t.grad.zero_()
        else:
            self._t.grad = None

    def retain_grads(self):
        if not self._t.is_leaf:
            self._t.retain_grad()

    def register_hook(self, hook):
        """``hook(grad)`` gets the gradient flowing into this tensor as a
        Tensor and may return a replacement; returns a handle with
        ``remove()``."""
        def torch_hook(g):
            r = hook(Tensor(g))
            return None if r is None else as_torch(r)
        return self._t.register_hook(torch_hook)

    def detach(self):
        return Tensor(self._t.detach())

    def detach_(self):
        self._t = self._t.detach()
        self._sg = True
        return self

    def clone(self):
        return _apply(torch.clone, self)

    # -- mutation -----------------------------------------------------------
    def _assign(self, value: torch.Tensor):
        """Write ``value`` (same shape) into a leaf in place, or rebind a
        non-leaf to it."""
        if _mutation_hook is not None:
            _mutation_hook(self)
        t = self._t
        if t.is_leaf:
            with torch.no_grad():
                t.copy_(value)
        else:
            self._t = value.detach().to(t.dtype)

    def set_value(self, value):
        t = self._t
        v = as_torch(value, device=t.device)
        self._assign(v.reshape(t.shape))
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def fill_(self, value):
        if isinstance(value, (Tensor, torch.Tensor)):
            value = value.item()
        self._assign(torch.full_like(self._t, value))
        return self

    def zero_(self):
        self._assign(torch.zeros_like(self._t))
        return self

    # -- conversion ---------------------------------------------------------
    def astype(self, dtype):
        d = dtype_mod.convert_dtype(dtype)
        return _apply(lambda a: a.to(d), self)

    def cast(self, dtype):
        return self.astype(dtype)

    def to(self, *args, **kwargs):
        dev = dt = None
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, torch.dtype) or (
                    isinstance(a, str) and a in dtype_mod._NAME_TO_DTYPE):
                dt = dtype_mod.convert_dtype(a)
            elif isinstance(a, (str, torch.device, device_mod.Place)):
                dev = device_mod._parse(a)
        return _apply(lambda t: t.to(device=dev, dtype=dt), self)

    def cpu(self):
        return _apply(lambda a: a.cpu(), self)

    def pin_memory(self):
        return self

    def contiguous(self):
        return _apply(lambda a: a.contiguous(), self)

    def is_contiguous(self):
        return self._t.is_contiguous()

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx):
        idx = unwrap_tree(idx)
        if isinstance(idx, list):
            idx = torch.as_tensor(idx, device=self._t.device)
        return _apply(lambda a: a[idx], self)

    def __setitem__(self, idx, value):
        if _mutation_hook is not None:
            _mutation_hook(self)
        idx = unwrap_tree(idx)
        t = self._t
        v = value._t if isinstance(value, Tensor) else (
            value if isinstance(value, (int, float, bool, torch.Tensor))
            else as_torch(value, device=t.device, dtype=t.dtype))
        if t.is_leaf and t.requires_grad:
            with torch.no_grad():
                t[idx] = v
        else:
            t[idx] = v

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # value methods (reshape, matmul, ...) and operators are attached by
    # paddle_tpu_torch.ops at import time, as the JAX package does


def _apply(fn, x):
    from .autograd import apply_op
    return apply_op(fn, x)


# a weak cache of the Tensor that wraps each parameter or buffer, keyed
# by the wrapped tensor's id (checked against it): a layer's attribute
# and its named_parameters() give the same Parameter object while
# anyone holds it
_LEAVES: "weakref.WeakValueDictionary[int, Tensor]" = \
    weakref.WeakValueDictionary()


def _remember(w: Tensor) -> None:
    _LEAVES[id(w._t)] = w


def wrap_leaf(raw: torch.Tensor) -> Tensor:
    """The Tensor (a :class:`Parameter` for a ``torch.nn.Parameter``)
    that wraps a layer's parameter or buffer."""
    w = _LEAVES.get(id(raw))
    if w is None or w._t is not raw:
        w = Parameter(raw) if isinstance(raw, torch.nn.Parameter) \
            else Tensor(raw)
        _remember(w)
    return w


class Parameter(Tensor):
    """A trainable leaf: wraps the ``torch.nn.Parameter`` that a layer
    registers (``stop_gradient`` defaults to False; ``trainable`` is its
    inverse)."""

    def __init__(self, data, stop_gradient: bool = False, name=None):
        if isinstance(data, torch.nn.Parameter):
            raw = data
        else:
            t = as_torch(data).detach()
            raw = torch.nn.Parameter(t, requires_grad=False)
        Tensor.__init__(self, raw, stop_gradient=True, name=name)
        if not stop_gradient and not (isinstance(data, torch.nn.Parameter)
                                      and not data.requires_grad):
            self.stop_gradient = False
        _remember(self)

    @property
    def trainable(self) -> bool:
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, value):
        self.stop_gradient = not value

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True):
    """``paddle.to_tensor``: a new Tensor on ``place`` (else the current
    device) holding a copy of ``data``. Python floats and numpy float64
    take the default dtype; Python ints stay int64."""
    d = dtype_mod.convert_dtype(dtype)
    dev = device_mod._parse(place) if place is not None \
        else device_mod.current_device()
    if isinstance(data, (Tensor, torch.Tensor)):
        t = as_torch(data).detach().to(device=dev, dtype=d, copy=True)
    else:
        a = np.asarray(data)
        if d is None and a.dtype == np.float64:
            d = dtype_mod.get_default_dtype()
        t = _numpy_to_torch(a).to(device=dev, dtype=d)
    if t.is_cpu:
        from . import memory
        memory.track(t)
    return Tensor(t, stop_gradient=stop_gradient)


def unwrap(x):
    """Tensor -> torch tensor (identity on anything else)."""
    return x._t if isinstance(x, Tensor) else x


def wrap(x, stop_gradient=True):
    return x if isinstance(x, Tensor) else Tensor(x,
                                                   stop_gradient=stop_gradient)
