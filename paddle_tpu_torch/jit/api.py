"""``paddle.jit`` of the port: ``to_static``, ``StaticFunction``,
``functionalize``, ``InputSpec``, ``TrainStep`` and the inference
artifact's ``save`` / ``load`` / ``TranslatedLayer``.

The port of ``paddle_tpu.jit.api``. ``to_static`` is SOT by default
(``jit.sot.SOTFunction``: record eagerly, guard host reads, replay the
recorded ops, as CUDA graphs on the card); with ``full_graph=True`` it
returns a :class:`StaticFunction`.

``StaticFunction`` runs the forward under no-grad, as the JAX
``functionalize`` runs it, as one CUDA graph per signature (the argument
shapes, dtypes and devices, the other arguments' values, the layers'
modes and the AMP regime): the first call of a signature runs eager (it
builds the kernels and warms cuBLAS), the second captures the graph and
replays it, later calls replay. The forward draws its random keys from a
key stream over a key drawn from the device generator for each call
(``core.random.next_key``, the JAX function's ``next_key()`` passed into
its program): in a graph, that key is copied into the graph's static key
buffer before each replay. A signature whose first call made a host draw
(``core.random.draws``: the rejection samplers, fractional pooling,
``class_center_sample``) runs eager, counted ``"rng"``; on the CPU every
call runs eager, counted ``"device"``. A graph's outputs are cloned out
(the next replay overwrites them); parameters and buffers are read where
they live (an in-place update is seen; a moved tensor captures again).

``TrainStep`` — forward, loss, backward and update as one call: as in
the JAX package, a thin wrapper over the whole-step capture engine,
``jit.sot.CapturedStep`` in non-strict mode with ``cast_loss_f32``. On
the card the step runs as one CUDA graph a signature (forward, loss,
backward and the fused optimizer update, dropout's keys drawn on the
device inside it); the first call of a signature runs eager once (it
builds the kernels, the optimizer state and cuBLAS's workspaces), and a
step the card cannot capture runs eager with the reason counted in
``stats["fallbacks"]`` (``"device"`` for a model on the CPU,
``"optimizer"`` for a per-parameter optimizer such as SGD or
``FLAGS_fused_optimizer=0``, ``"hooks"``, ``"rng"`` for a host draw).
The eager step computes the same thing with the same kernels, on the
stream the engine captures on (``CapturedStep.eager_stream``)::

    step = TrainStep(model, loss_fn, optimizer)
    loss = step(ids, labels)     # 0-dim f32 tensor on the model's device

``loss_fn(outputs, *labels)`` returns a scalar. With more than one
argument the last is the labels, as in the JAX ``TrainStep``. The step
runs the model in training mode (dropout on), as the JAX step traces
it, and, as the JAX step differentiates the whole trainable tree, a
parameter the loss does not reach gets a zero gradient (AdamW still
decays it).

``save`` writes the ``save_inference_model`` artifact; ``load`` rebuilds
the Layer, or, when its class cannot be imported here and the artifact
carries an AOT export (``save_inference_model(aot=True)``: a
``torch.export`` program), returns a :class:`TranslatedLayer` that runs
that program.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import random as random_mod
from ..core.tensor import Tensor, unwrap_tree, wrap_tree

__all__ = ["to_static", "functionalize", "StaticFunction", "InputSpec",
           "TrainStep", "save", "load", "not_to_static", "ignore_module",
           "TranslatedLayer", "enable_to_static", "set_code_level",
           "set_verbosity"]


class InputSpec:
    """ref: python/paddle/static/input.py InputSpec"""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = shape
        self.dtype = dtype
        self.name = name


class _Call(torch.nn.Module):
    """Calls ``fn`` (a method of ``layer``) with ``layer`` registered
    under ``m``, so that ``torch.func.functional_call`` swaps its
    parameters and buffers."""

    def __init__(self, layer, fn):
        super().__init__()
        self.m = layer
        self._fn = fn

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def functionalize(layer, fn: Optional[Callable] = None):
    """Returns ``(apply, params, buffers)``: ``apply(params, buffers,
    *args, **kwargs) -> (out, new_buffers)`` runs ``fn`` (default:
    ``layer.__call__``) under no-grad with the layer's parameters and
    buffers taken from the two dicts of torch tensors
    (``torch.func.functional_call``); ``params`` / ``buffers`` are the
    layer's own, by name. Arguments are passed as given (a paddle Layer
    called with torch tensors returns torch tensors); ``new_buffers``
    holds the buffers after the call (a batch norm in training mode
    writes its running statistics into them in place)."""
    params0 = dict(torch.nn.Module.named_parameters(layer))
    buffers0 = dict(torch.nn.Module.named_buffers(layer))
    mod = layer if fn is None else _Call(layer, fn)
    pre = "" if fn is None else "m."

    def apply(params, buffers, *args, **kwargs):
        values = {pre + k: v for k, v in params.items()}
        values.update({pre + k: v for k, v in buffers.items()})
        with torch.no_grad():
            out = torch.func.functional_call(mod, values, args, kwargs)
        return out, dict(buffers)

    return apply, params0, buffers0


def _raw_leaves(layer) -> list:
    return [p for _, p in torch.nn.Module.named_parameters(layer)] + \
        [b for _, b in torch.nn.Module.named_buffers(layer)]


class _StaticGraph:
    __slots__ = ("graph", "inputs", "key", "out", "ptrs", "counts")


_SEEN = object()     # first call of a signature: ran eager
_RNG = object()      # ... and made a host draw


class StaticFunction:
    """``to_static(..., full_graph=True)``: the forward under no-grad as
    one CUDA graph per signature (see the module docstring). ``stats``:
    ``eager_calls``, ``captures``, ``replays``, ``capture_seconds`` and
    ``fallbacks`` by reason."""

    def __init__(self, layer_or_fn, input_spec=None, **kwargs):
        if isinstance(layer_or_fn, torch.nn.Module):
            self._layer = layer_or_fn
            self._fn = layer_or_fn.__call__
        else:
            self._layer = getattr(layer_or_fn, "__self__", None)
            if not isinstance(self._layer, torch.nn.Module):
                self._layer = None
            self._fn = layer_or_fn
        self.input_spec = input_spec
        self._cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self.stats: Dict[str, Any] = {
            "eager_calls": 0, "captures": 0, "replays": 0,
            "capture_seconds": 0.0, "fallbacks": {}}

    def _fallback(self, reason: str) -> None:
        from .sot import _count_fallback
        fb = self.stats["fallbacks"]
        fb[reason] = fb.get(reason, 0) + 1
        _count_fallback(reason, "static_function")

    def _signature(self, args, kwargs):
        from ..amp.auto_cast import amp_signature

        def key(a):
            if isinstance(a, (Tensor, torch.Tensor)):
                t = a._t if isinstance(a, Tensor) else a
                return (isinstance(a, Tensor), tuple(t.shape), str(t.dtype),
                        str(t.device))
            if isinstance(a, np.ndarray):
                from .sot import _content_digest
                return ("A",) + _content_digest(a)
            return ("L", repr(a))
        parts = [key(a) for a in args]
        parts += [(k, key(kwargs[k])) for k in sorted(kwargs)]
        modes = () if self._layer is None else tuple(
            m.training for m in self._layer.modules())
        return tuple(parts) + (modes, amp_signature())

    def _device(self, args, kwargs) -> Optional[torch.device]:
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (Tensor, torch.Tensor)):
                return (a._t if isinstance(a, Tensor) else a).device
        if self._layer is not None:
            leaves = _raw_leaves(self._layer)
            if leaves:
                return leaves[0].device
        return None

    def _eager(self, dev, args, kwargs):
        from ..core.autograd import no_grad
        self.stats["eager_calls"] += 1
        key = random_mod.next_key(dev)
        with no_grad(), random_mod.key_stream(key):
            return self._fn(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        dev = self._device(args, kwargs)
        sig = self._signature(args, kwargs)
        entry = self._cache.get(sig)
        if entry is None:
            from .sot import _capture_cache_flag
            self._cache[sig] = _SEEN
            while len(self._cache) > max(int(
                    _capture_cache_flag.value or 8), 1):
                self._cache.popitem(last=False)
            d0 = random_mod.draws()
            out = self._eager(dev, args, kwargs)
            if random_mod.draws() != d0:
                self._cache[sig] = _RNG
            return out
        self._cache.move_to_end(sig)
        if entry is _RNG:
            self._fallback("rng")
            return self._eager(dev, args, kwargs)
        if dev is None or dev.type != "cuda":
            self._fallback("device")
            return self._eager(dev, args, kwargs)
        ptrs = self._ptrs()
        if entry is _SEEN or entry.ptrs != ptrs:
            entry = self._cache[sig] = self._capture(dev, args, kwargs)
        return self._replay(entry, dev, args, kwargs)

    def _ptrs(self) -> tuple:
        if self._layer is None:
            return ()
        return tuple(t.data_ptr() for t in _raw_leaves(self._layer))

    def _capture(self, dev, args, kwargs) -> _StaticGraph:
        """Record the call into a new graph over static copies of the
        tensor arguments and a static key (nothing runs: the caller
        replays)."""
        from ..core.autograd import no_grad
        from ..ops.kernels import counters as counters_mod
        from .sot import _side_stream
        e = _StaticGraph()
        e.inputs = []

        def static(a):
            if isinstance(a, (Tensor, torch.Tensor)):
                t = a._t if isinstance(a, Tensor) else a
                buf = torch.empty_like(t).copy_(t)
                e.inputs.append(buf)
                return Tensor(buf) if isinstance(a, Tensor) else buf
            return a
        s_args = [static(a) for a in args]
        s_kwargs = {k: static(kwargs[k]) for k in sorted(kwargs)}
        e.key = torch.zeros(2, dtype=torch.int64, device=dev)
        random_mod.default_generator().prepare(dev)
        e.graph = torch.cuda.CUDAGraph()
        before = counters_mod.snapshot()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(e.graph, stream=_side_stream(dev)), \
                    no_grad(), random_mod.key_stream(e.key):
                e.out = unwrap_tree(self._fn(*s_args, **s_kwargs))
        finally:
            e.counts = counters_mod.delta(before, counters_mod.snapshot())
            counters_mod.restore(before)
        self.stats["capture_seconds"] += time.perf_counter() - t0
        self.stats["captures"] += 1
        from .sot import _note_break
        _note_break("capture", "static", "static_function")
        e.ptrs = self._ptrs()
        return e

    def _replay(self, e: _StaticGraph, dev, args, kwargs):
        from ..ops.kernels import counters as counters_mod
        from .sot import _clone_tree
        vals = [a for a in list(args) + [kwargs[k] for k in sorted(kwargs)]
                if isinstance(a, (Tensor, torch.Tensor))]
        for buf, a in zip(e.inputs, vals):
            buf.copy_(a._t if isinstance(a, Tensor) else a,
                      non_blocking=True)
        e.key.copy_(random_mod.next_key(dev))
        e.graph.replay()
        counters_mod.advance(e.counts)
        self.stats["replays"] += 1
        out = _clone_tree(e.out)
        wrapped = any(isinstance(a, Tensor) for a in vals) or not vals
        return wrap_tree(out) if wrapped else out


_to_static_enabled = True


def enable_to_static(flag: bool):
    """Global switch: with False, ``to_static`` returns the function or
    layer untouched (pure eager), the reference's debugging workflow."""
    global _to_static_enabled
    _to_static_enabled = bool(flag)


_D2S_LOGGER_NAME = "paddle_tpu.jit.dy2static"


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    """Verbosity of the dy2static / SOT logs (0 silences, higher is
    chattier); the JAX package's logger name."""
    import logging
    logger = logging.getLogger(_D2S_LOGGER_NAME)
    logger.setLevel(logging.WARNING if level <= 0 else
                    logging.INFO if level == 1 else logging.DEBUG)
    if also_to_stdout and not logger.handlers:
        import sys
        logger.addHandler(logging.StreamHandler(sys.stdout))


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    """How much transformed code to log: the SOT tracer has no source
    transform to print; at level > 0 its logger is on at DEBUG."""
    import logging
    logger = logging.getLogger(_D2S_LOGGER_NAME + ".code")
    logger.setLevel(logging.DEBUG if level > 0 else logging.WARNING)
    if also_to_stdout and not logger.handlers:
        import sys
        logger.addHandler(logging.StreamHandler(sys.stdout))


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=False, bucket_policy=None, **kwargs):
    """``full_graph=False`` (default, SOT): data-dependent Python control
    flow works; host reads become guards, paths replay, and recordings
    that cannot replay (RNG, in-place mutation, an inner backward, an
    unrecorded computation) stay eager (``jit.sot``). A Layer keeps its
    API: its ``forward`` is patched in place.

    ``full_graph=True``: a :class:`StaticFunction` (one CUDA graph per
    signature on the card)."""
    def decorate(fn):
        if not _to_static_enabled:
            return fn
        if full_graph:
            return StaticFunction(fn, input_spec, **kwargs)
        from .sot import SOTFunction
        if isinstance(fn, torch.nn.Module):
            fn.forward = SOTFunction(fn.forward, bucket_policy=bucket_policy,
                                     input_spec=input_spec)
            return fn
        return SOTFunction(fn, bucket_policy=bucket_policy,
                           input_spec=input_spec)
    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn=None):
    return fn


def ignore_module(modules):
    return None


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn, optimizer,
                 warm_bundle=None):
        """``warm_bundle`` (a manifest path or a loaded bundle dict):
        its ``captured_step`` entries are pre-warmed now
        (``jit.warmup.prewarm``), so the first call of a recorded
        signature replays a graph."""
        from .sot import CapturedStep
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._step = CapturedStep(model, loss_fn, optimizer,
                                  cast_loss_f32=True, strict=False,
                                  name="train_step")
        self._step.step_runner = self._drive
        if warm_bundle is not None:
            from . import warmup
            warmup.prewarm(warm_bundle, captured=self)

    @property
    def stats(self):
        """The engine's counts: ``captured_steps``, ``compiles``,
        ``eager_steps``, ``fallbacks`` by reason."""
        return self._step.stats

    @staticmethod
    def _split(batch):
        if len(batch) > 1:
            return list(batch[:-1]), [batch[-1]]
        return list(batch), []

    def __call__(self, *batch):
        """One step: the loss (cast to f32), its backward, the optimizer
        update and the gradients cleared. Returns the loss without a
        host sync."""
        ins, lbls = self._split(batch)
        if not self.model.training:
            self.model.train()
        loss = self._step.step(ins, lbls)
        if loss is None:
            with self._step.eager_stream():
                loss = self._eager(ins, lbls)
            self._step.eager_done()
        return loss

    def _drive(self, kind, ins, lbls):
        """A prewarm's step (``CapturedStep.step_runner``): this step's own
        call."""
        if kind != "train":
            raise ValueError(f"TrainStep runs train steps, not {kind!r}")
        self(*ins, *lbls)

    def _eager(self, ins, lbls):
        loss = self.loss_fn(self.model(*ins), *lbls)
        loss = loss.float() if isinstance(loss, torch.Tensor) \
            else loss.astype("float32")
        loss.backward()
        for p in self.optimizer._parameter_list:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.optimizer.clear_grad()
        # detached: a loss that kept its graph would keep the leaves'
        # gradient accumulators alive into the next capture
        return loss.detach()


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: the parameters and the importable factory
    (``inference.save_inference_model``'s ``.pdmodel``)."""
    from ..inference import save_inference_model
    save_inference_model(path, layer, input_spec=input_spec)


class TranslatedLayer:
    """ref: jit/translated_layer.py TranslatedLayer — what ``jit.load``
    returns when the saved model's class cannot be imported here: its
    forward runs the artifact's exported program (``torch.export``) with
    the saved parameters and buffers, on the card (``Config`` decides
    otherwise), and returns Tensors on that device. Made by
    ``TranslatedLayer.load`` (or ``jit.load``), not by its
    constructor."""

    def __init__(self, predictor):
        self._predictor = predictor
        self.training = False

    @staticmethod
    def load(path, device=None):
        """Serve ``path``'s exported program on ``device`` (default: the
        eager core's device, ``paddle.set_device``)."""
        from ..core.device import current_device
        from ..inference import Config, Predictor
        return TranslatedLayer(Predictor(
            Config(path), device=device or current_device()))

    def forward(self, *inputs):
        outs = [Tensor(o) for o in self._predictor.run_tensors(*inputs)]
        return outs[0] if len(outs) == 1 else outs

    def __call__(self, *inputs):
        return self.forward(*inputs)

    def eval(self):
        self.training = False
        return self

    def train(self):
        raise RuntimeError(
            "TranslatedLayer wraps a compiled inference program; it "
            "cannot be put in train mode (re-train from the original "
            "Layer class)")


def load(path, **configs):
    """A rebuilt Layer in eval mode, on ``configs["device"]`` (default:
    the eager core's device, ``paddle.set_device``); where the class
    cannot be imported here and the artifact carries an AOT export, a
    :class:`TranslatedLayer` instead. A legacy ``.pdparams`` (a bare
    state dict) raises, naming the tool that loads it."""
    import os

    from ..core.device import current_device
    from ..inference import load_inference_model
    device = configs.get("device") or current_device()
    if not os.path.exists(path + ".pdmodel") and \
            os.path.exists(path + ".pdparams"):
        raise ValueError(
            f"{path}.pdparams is a legacy weights-only artifact and "
            "cannot be reconstructed into a Layer; load it with "
            "paddle_tpu.load() and apply set_state_dict on your model")
    try:
        return load_inference_model(path, device=device)
    except (ImportError, AttributeError, ModuleNotFoundError,
            TypeError) as e:
        # TypeError: a class that its saved config cannot rebuild (an
        # AOT artifact need not be rebuildable)
        from ..framework.checkpoint import load_checkpoint
        payload = load_checkpoint(path + ".pdmodel", device="cpu")
        if payload.get("aot"):
            return TranslatedLayer.load(path, device=device)
        raise ValueError(
            f"cannot reconstruct {payload.get('class_name')} ({e}) and "
            f"the artifact has no AOT export — re-save with "
            f"save_inference_model(aot=True) to serve without the "
            f"class") from e
