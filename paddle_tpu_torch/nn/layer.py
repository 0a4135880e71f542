"""Layer: the paddle module base class of the port.

The counterpart of ``paddle_tpu.nn.layer``. A :class:`Layer` is a
``torch.nn.Module``: its parameters are ``torch.nn.Parameter``s in
torch's registry, so device moves, ``train()`` / ``eval()``, torch's
``state_dict`` recursion and torch parents holding a Layer work as for
any module. On top of that it speaks paddle:

- ``self.w = self.create_parameter(...)`` (or any :class:`Parameter`)
  registers the wrapped ``torch.nn.Parameter``; reading ``self.w``
  gives the :class:`Parameter` (the same object while anyone holds
  it), and a plain :class:`Tensor` attribute becomes a non-persistable
  buffer;
- where paddle and torch give one method name different meanings, the
  paddle meaning wins on a Layer: ``parameters()`` and
  ``named_parameters()`` give lists / pairs of Parameters,
  ``state_dict()`` maps names to Parameters and Tensors (called with
  torch's keywords ``prefix`` / ``keep_vars``, as a torch parent's
  ``state_dict`` calls its children, it is torch's), ``to(device,
  dtype)`` takes paddle's arguments, ``apply`` visits the layer before
  its sublayers;
- a Layer called with torch tensors (by a torch parent such as BERT or
  ERNIE-MoE) runs with its attributes read as the raw torch tensors,
  so the ops it calls (``core.autograd.apply_op``) return torch
  tensors; called with Tensors it returns Tensors. A Layer whose
  ``forward`` is written against torch tensors sets ``_torch_forward``:
  Tensor arguments are unwrapped before it runs and its results
  wrapped after.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterator, List, Tuple

import torch
from torch import nn

from ..core import device as device_mod
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.tensor import (Parameter, Tensor, unwrap_tree, wrap_leaf,
                           wrap_tree)
from . import initializer as I

__all__ = ["Layer", "ParamAttr", "raw_mode"]

_mode = threading.local()


def raw_mode() -> bool:
    """True inside a Layer that was called with torch tensors."""
    return getattr(_mode, "raw", False)


def _scan(values, found):
    for v in values:
        if isinstance(v, Tensor):
            found[1] = True
        elif isinstance(v, torch.Tensor):
            found[0] = True
        elif isinstance(v, (list, tuple)):
            _scan(v, found)


class Layer(nn.Module):
    _torch_forward = False

    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        self._device = None
        self._wrappers = {}
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- call ----------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        found = [False, False]          # [torch tensor seen, Tensor seen]
        _scan(args, found)
        if kwargs:
            _scan(kwargs.values(), found)
        prev = raw_mode()
        wrapped = found[1]
        if self._torch_forward:
            if wrapped:
                args, kwargs = unwrap_tree(args), unwrap_tree(kwargs)
            _mode.raw = True
        elif wrapped:
            _mode.raw = False
        elif found[0]:
            _mode.raw = True
        try:
            out = super().__call__(*args, **kwargs)
        finally:
            _mode.raw = prev
        return wrap_tree(out) if self._torch_forward and wrapped else out

    # -- registration --------------------------------------------------------
    def _drop_name(self, name):
        for reg in (self._parameters, self._buffers, self._modules):
            reg.pop(name, None)
        self.__dict__.pop(name, None)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._drop_name(name)
            self.register_parameter(name, value._t)
            self._wrappers[name] = value
        elif isinstance(value, Tensor) and not name.startswith("_"):
            self._drop_name(name)
            nn.Module.register_buffer(self, name, value._t, persistent=False)
            self._wrappers[name] = value
        else:
            if "_wrappers" in self.__dict__:
                self._wrappers.pop(name, None)
            super().__setattr__(name, value)

    def __getattr__(self, name):
        v = super().__getattr__(name)
        if isinstance(v, torch.Tensor) and not raw_mode():
            w = self.__dict__.get("_wrappers", {}).get(name)
            return w if w is not None and w._t is v else wrap_leaf(v)
        return v

    def add_parameter(self, name: str, parameter):
        if parameter is None:
            self.register_parameter(name, None)
        else:
            setattr(self, name, parameter if isinstance(parameter, Parameter)
                    else Parameter(parameter))
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        raw = tensor._t if isinstance(tensor, Tensor) else tensor
        self._drop_name(name)
        nn.Module.register_buffer(self, name, raw, persistent=persistable)
        if isinstance(tensor, Tensor):
            self._wrappers[name] = tensor
        return tensor

    def _param_device(self):
        return self._device if self._device is not None \
            else device_mod.current_device()

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new Parameter of ``shape`` on the layer's device; ``attr``
        may be a ParamAttr, an Initializer, False (no parameter) or None
        (the default: zeros for a bias, XavierNormal otherwise)."""
        if attr is False:
            return None
        d = convert_dtype(dtype) or self._dtype
        init, trainable, pname = default_initializer, True, None
        if isinstance(attr, I.Initializer):
            init = attr
        elif isinstance(attr, ParamAttr):
            init = attr.initializer or init
            trainable, pname = attr.trainable, attr.name
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        data = init(tuple(shape), d, self._param_device())
        return Parameter(data, stop_gradient=not trainable, name=pname)

    # -- iteration -----------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=None, recurse=None
                         ) -> Iterator[Tuple[str, Parameter]]:
        """Names and Parameters; called with torch's ``recurse`` or
        ``remove_duplicate`` (as ``torch.func.functional_call`` and
        torch's ``parameters()`` do) it is torch's."""
        if remove_duplicate is not None or recurse is not None:
            yield from super().named_parameters(
                prefix=prefix, recurse=include_sublayers if recurse is None
                else recurse, remove_duplicate=remove_duplicate is not False)
            return
        for name, p in super().named_parameters(prefix=prefix,
                                                recurse=include_sublayers):
            yield name, wrap_leaf(p)

    def parameters(self, include_sublayers=True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=None, recurse=None):
        if remove_duplicate is not None or recurse is not None:
            yield from super().named_buffers(
                prefix=prefix, recurse=include_sublayers if recurse is None
                else recurse, remove_duplicate=remove_duplicate is not False)
            return
        for name, b in super().named_buffers(prefix=prefix,
                                             recurse=include_sublayers):
            yield name, wrap_leaf(b)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, layer in self._modules.items():
            if layer is None:
                continue
            sub = f"{prefix}.{name}" if prefix else name
            yield sub, layer
            if isinstance(layer, Layer):
                yield from layer.named_sublayers(sub)
            else:
                for n, m in layer.named_modules(prefix=sub):
                    if m is not layer:
                        yield n, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    # -- hooks ---------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)``; a non-None return replaces
        the output. Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    # -- state ---------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=None):
        """Names -> Parameters and persistable buffers (as Tensors).
        With torch's ``prefix`` / ``keep_vars`` it is torch's
        ``state_dict`` (a torch parent recursing into this layer)."""
        if prefix is not None or keep_vars is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        raw = OrderedDict()
        if include_sublayers:
            super().state_dict(destination=raw,
                               prefix=structured_name_prefix,
                               keep_vars=True)
        else:
            self._save_to_state_dict(raw, structured_name_prefix, True)
        dest = destination if destination is not None else OrderedDict()
        for k, v in raw.items():
            dest[k] = wrap_leaf(v) if isinstance(v, torch.Tensor) else v
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True,
                       cast_dtype=True):
        """Copy ``state_dict`` (Tensors, torch tensors or numpy arrays)
        into this layer's parameters and buffers by name. Returns
        ``(missing_keys, unexpected_keys)``; a shape mismatch raises.
        ``cast_dtype=False`` installs the values in their own dtype."""
        from ..core.tensor import as_torch
        own = super().state_dict(keep_vars=True)
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            target = own[k]
            data = as_torch(v, device=target.device)
            if tuple(data.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {k}: checkpoint "
                    f"{tuple(data.shape)} vs model {tuple(target.shape)}")
            if cast_dtype or data.dtype == target.dtype:
                target.copy_(data)
            else:
                target.data = data.clone()
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    # -- dtype / device ------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """``to(device=None, dtype=None)``; a dtype as the first argument
        is taken as ``dtype``. Floating parameters and buffers are
        cast."""
        if isinstance(device, torch.dtype) or (
                isinstance(device, str) and device in (
                    "float16", "bfloat16", "float32", "float64")):
            device, dtype = None, device
        dev = None if device is None else device_mod._parse(device)
        d = convert_dtype(dtype)
        super().to(device=dev, dtype=d)
        for layer in self.sublayers(include_self=True):
            if isinstance(layer, Layer):
                if d is not None:
                    layer._dtype = d
                if dev is not None and layer._device is not None:
                    layer._device = dev
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def half(self):
        return self.to(dtype="float16")

    def full_name(self):
        return self._name_scope


class HookRemoveHelper:
    """A handle that removes hook ``hook_id`` from the ``hooks`` dict
    (the JAX package's handle; the port's own hooks return torch's
    ``RemovableHandle``, which has the same ``remove()``)."""

    def __init__(self, hooks: dict, hook_id: int):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class ParamAttr:
    """A parameter's name, initializer and trainability (the paddle
    ``ParamAttr``); ``learning_rate``, ``regularizer`` and
    ``need_clip`` are kept for the optimizer."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip
