"""Whole-step capture of the port: ``CapturedStep`` as CUDA graphs.

The port of ``paddle_tpu/jit/sot.py`` ``CapturedStep`` (with
``BucketPolicy`` and ``_count_fallback``), the engine behind
``hapi.Model.train_batch`` / ``eval_batch`` (strict) and
``jit.TrainStep`` (non-strict). Where the JAX package
compiles a train step (forward, loss, backward, clip, optimizer update)
into one donated XLA executable, the port records it into one
``torch.cuda.CUDAGraph``: the flash-attention kernels K1b/K2b, the
GEMMs and the fused optimizer's O1/O2 launches (or SGD's and
Momentum's multi-tensor update) of the step, replayed by one call.

- **Signature** — batch shapes, dtypes and devices, the layers'
  train/eval modes, the trainable set, the optimizer type with its
  static hyperparameters and per-parameter decays, the clip spec, the
  GradScaler's statics and ``amp.amp_signature()``. A new signature is
  a guard miss: the old graph stays in an LRU of
  ``FLAGS_sot_capture_cache`` entries (their graphs share one memory
  pool) and the new one starts over.
- **Network** — a paddle ``Layer`` or a plain ``torch.nn.Module`` (the
  port's Llama, BERT and ERNIE-MoE): the graph calls it with the kind of
  tensors the caller passed (paddle Tensors or torch tensors) and
  returns its loss in the kind the loss function gave.
- **Strict policy** — the first sighting of a signature returns None
  and the caller runs the eager step (which also builds the kernels,
  warms cuBLAS and autograd and creates the optimizer state). The
  second records forward, loss, backward, the clip and
  ``optimizer.step()`` into a graph and replays it once, so it too is
  one captured step; no warm-up iterations run, so every step applies
  one update, as the eager loop does. Later calls copy the batch into
  the signature's static input buffers and replay.
- **Non-strict** (``strict=False``, ``jit.TrainStep``'s) — the JAX
  class's explicit whole-step mode: the kill switch does not apply. The
  first sighting still runs eager once (the JAX step compiles on its
  first call instead), and where the card cannot honour a capture the
  caller runs its eager step with the reason counted, as in strict mode.
  As the JAX step differentiates the whole trainable tree, a trainable
  parameter the loss does not reach gets a zero gradient (AdamW still
  decays it), written inside the graph into a buffer the graph keeps.
  ``cast_loss_f32`` casts the loss to f32 before the backward.
- **State in place** — parameters, optimizer moments, velocities and
  beta powers, batch norms' running statistics (written in place by
  ``nn.functional.batch_norm``),
  the lr tensor (``fused_step._lr_device``, refreshed on the host side
  before every capture and replay, never filled inside a graph) and
  the GradScaler's scale and counters (updated in place) keep their
  addresses, which the graph holds; a replay checks them and captures
  anew when one moved (a ``set_state_dict``, a ``p.data`` swap).
  Gradients are allocated inside the capture, from the graph's pool;
  the entry keeps them alive while ``.grad`` reads None between steps
  (``step() + clear_grad()``, the hapi semantics).
- **Host state** — a replay advances ``optimizer._global_step`` and the
  kernel launch counters (``ops.kernels.counters``) by what the
  capture recorded, so launch counts read as layers x steps.
- **Random keys** — dropout draws its keys from the port's key streams
  (``core.random``), whose state lives on the device: the graph holds
  each draw's in-place advance of the generator's state tensor, so
  every replay draws fresh keys, the same keys the eager step would.
  The capture records how many keys it drew from which generator; each
  replay first brings those states up to the host counter (outside the
  graph) and then advances the host mirror by the recorded draws. The
  state tensors' addresses join the ones a replay checks.
- **Lazy loss** — ``step()`` returns a device copy of the graph's loss
  (the next replay overwrites the graph's own), with no host sync;
  ``forward()`` copies its outputs likewise.
- **Fallbacks** are counted (``sot.fallbacks_total{reason}`` and a
  flight event) and return None: the caller runs the eager step. The
  gate keeps the JAX reasons that have a meaning here (``scaler``,
  ``hooks``, ``network_changed``, ``no_optimizer``, ``optimizer`` — a
  step the fused kernels would not take, whose per-parameter loop
  would freeze the lr into the graph —, ``grad_clip``, ``hyper``,
  ``param_set``, ``pending_grads``, ``param_static``) and adds two:
  ``"device"`` — CUDA graphs exist only on the card, so a network on
  the CPU is never captured (decided where the card would capture: the
  first sighting runs eager as on the card, later ones fall back) — and
  ``"rng"`` — a signature whose first sighting made a host draw
  (``core.random.draws``: the generators of Bernoulli and axis
  dropout, ``rrelu``, the initializers) is never captured, because its
  seed is a Python int a graph would freeze. Draws from the key streams
  (hash dropout, the flash kernels' dropout) are legal inside a graph.
  A capture that fails raises; it never runs eager quietly.

``FLAGS_sot_capture=0`` is the kill switch of strict mode (every step
eager, nothing counted).
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from ..core import random as random_mod
from ..core.flags import _registry as _flag_registry
from ..core.tensor import Tensor, unwrap_tree, wrap_tree
from ..observability import flight as _flight
from ..observability import metrics as _om
from ..ops.kernels import counters as _counters

__all__ = ["BucketPolicy", "CapturedStep"]

_capture_flag = _flag_registry["sot_capture"]
_capture_cache_flag = _flag_registry["sot_capture_cache"]

_M = _om.scope("sot")
_M_captured = _M.counter(
    "captured_steps_total",
    "Steps served by a CapturedStep CUDA graph (the capture's own "
    "replay included)")
_M_fallbacks = _M.counter(
    "fallbacks_total",
    "Steps that ran eager by a gate reason of CapturedStep, by reason")
_M_step_compiles = _M.counter(
    "captured_compiles_total", "Whole-step CUDA graphs captured")
_M_hits = _M.counter(
    "cache_hits_total",
    "CapturedStep executions served by an already captured graph")


def _count_fallback(reason: str, name: str = "") -> None:
    _M_fallbacks.inc(reason=reason)
    _flight.record("sot", "fallback", reason=reason, fn=name)


class BucketPolicy:
    """Pad dynamic axes up to bucket sizes so varlen inputs share
    graphs. ``axes`` maps an argument index to ``{axis: buckets}``;
    ``buckets`` is a sorted list of sizes, or "pow2" for powers of two.
    Padding uses ``pad_value``: choose it so the padded region is inert
    for the model (the loss's ignore_index for token ids)."""

    def __init__(self, axes: Dict[int, Dict[int, Any]], pad_value=0):
        self.axes = axes
        self.pad_value = pad_value

    def bucket_of(self, size: int, buckets) -> int:
        if buckets == "pow2":
            b = 1
            while b < size:
                b *= 2
            return b
        for b in buckets:
            if b >= size:
                return int(b)
        return int(buckets[-1])  # larger than every bucket: use the max

    def apply(self, args: tuple):
        out = list(args)
        for idx, ax_map in self.axes.items():
            if idx >= len(out) or not isinstance(out[idx], Tensor):
                continue
            t = out[idx]._t
            pads = [0] * (2 * t.dim())
            for axis, buckets in ax_map.items():
                size = t.shape[axis]
                tgt = self.bucket_of(size, buckets)
                if tgt > size:
                    # F.pad lists the last axis first: (left, right) pairs
                    pads[2 * (t.dim() - 1 - axis % t.dim()) + 1] = \
                        tgt - size
            if any(pads):
                out[idx] = Tensor(torch.nn.functional.pad(
                    t, pads, value=self.pad_value),
                    stop_gradient=out[idx].stop_gradient)
        return tuple(out)


_SEEN_STEP = object()  # first-sighting marker: signature noted, ran eager
_RNG_STEP = object()   # the first sighting made a host draw

_NOT_HYPER = {"_learning_rate", "_global_step", "_param_names", "_index",
              "_parameter_list", "_states", "_grad_clip", "_regularizer",
              "_apply_decay_param_fun", "_cur_param"}


def _hyper_key(opt) -> Optional[tuple]:
    """The optimizer's static hyperparameters (a graph bakes the floats
    the kernels are launched with), or None when one is not a plain
    value."""
    out = []
    for k, v in sorted(vars(opt).items()):
        if k in _NOT_HYPER or k.startswith("_fused"):
            continue
        if isinstance(v, torch.Tensor):
            return None
        if v is None or isinstance(v, (bool, int, float, str)):
            out.append((k, v))
    return tuple(out)


def _param_statics(opt, params) -> Optional[tuple]:
    """Each trainable parameter's weight decay (``apply_decay_param_fun``
    decides it by name), or None when one cannot be computed."""
    try:
        return tuple(float(opt._use_wd(opt._index[id(p)])) for p in params)
    except (TypeError, ValueError, KeyError):
        return None


def _fusable(opt) -> bool:
    """Whether ``optimizer.step()`` runs as the fused kernels (lr read
    from device memory), the only update a graph may replay."""
    from ..optimizer import fused_step
    return (getattr(opt, "_fusable_step", True) is not False
            and fused_step.enabled() and fused_step._kind(opt) is not None
            and opt._regularizer is None)


class _Graph:
    """One captured signature: its graph, static buffers and what a
    replay must do on the host."""
    __slots__ = ("kind", "graph", "inputs", "wrapped", "out", "loss",
                 "loss_wrapped", "found", "keep", "counts", "gsteps", "ptrs",
                 "draws")


class CapturedStep:
    """A train (``step``) or eval (``forward``) step as one cached CUDA
    graph per signature; see the module docstring."""

    def __init__(self, network, loss_fn=None, optimizer=None,
                 mean_reduce: bool = False, cast_loss_f32: bool = False,
                 strict: bool = True,
                 bucket_policy: Optional[BucketPolicy] = None,
                 name: str = "step"):
        self.network = network
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._mean_reduce = mean_reduce
        self._cast_f32 = cast_loss_f32
        self._strict = strict
        self._bucket = bucket_policy
        self._name = name
        self._sublayers = list(network.sublayers(include_self=True)) \
            if hasattr(network, "sublayers") else list(network.modules())
        self._params = OrderedDict((k, _raw(p)) for k, p in
                                   network.named_parameters())
        self._buffers = OrderedDict((k, _raw(b)) for k, b in
                                    network.named_buffers())
        self._cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self._pool = None
        self._stream = None
        # (signature, draws at its start) of the first sighting the
        # caller is running eagerly, and the draws at its end
        self._sighting = None
        self._sighting_end = None
        self.stats: Dict[str, Any] = {
            "captured_steps": 0, "compiles": 0, "cache_hits": 0,
            "eager_steps": 0, "fallbacks": {}, "capture_seconds": 0.0}

    # -- gating ------------------------------------------------------------
    def _gate(self, train: bool, scaler=None) -> Optional[str]:
        """The JAX package's capture preconditions that have a meaning
        here. None = capturable so far; otherwise the fallback reason.
        AMP is not a gate: the regime joins the signature."""
        if scaler is not None and \
                scaler.capture_statics(self.optimizer) is None:
            return "scaler"
        for lyr in self._sublayers:
            if (lyr._forward_pre_hooks or lyr._forward_hooks
                    or lyr._backward_hooks
                    or getattr(lyr, "_backward_pre_hooks", None)):
                return "hooks"
        for p in self._params.values():
            if getattr(p, "_backward_hooks", None) or \
                    getattr(p, "_post_accumulate_grad_hooks", None):
                return "hooks"
        if sum(1 for _ in self.network.named_parameters()) != \
                len(self._params):
            return "network_changed"
        if train:
            opt = self.optimizer
            if opt is None:
                return "no_optimizer"
            from ..utils.clip_grad import clip_spec
            if not _fusable(opt):
                return "optimizer"
            if clip_spec(opt._grad_clip, exact=True) is None:
                return "grad_clip"
            if _hyper_key(opt) is None:
                return "hyper"
            if {id(p) for p in opt._parameter_list if p.requires_grad} != \
                    {id(p) for p in self._params.values()
                     if p.requires_grad}:
                return "param_set"
            if any(p.requires_grad and p.grad is not None
                   for p in self._params.values()):
                return "pending_grads"
        return None

    def _fallback(self, reason: str) -> None:
        self.stats["fallbacks"][reason] = \
            self.stats["fallbacks"].get(reason, 0) + 1
        _count_fallback(reason, self._name)

    def _on_card(self) -> bool:
        leaves = list(self._params.values()) + list(self._buffers.values())
        return bool(leaves) and all(t.device.type == "cuda" for t in leaves)

    # -- signature ---------------------------------------------------------
    def _tkeys(self):
        return sorted(k for k, p in self._params.items() if p.requires_grad)

    def _signature(self, kind: str, arrays, n_ins: int, tkeys,
                   scaler_statics=None, wrapped=None) -> Optional[tuple]:
        from ..amp.auto_cast import amp_signature
        modes = tuple(lyr.training for lyr in self._sublayers)
        if wrapped is None:
            wrapped = (True,) * len(arrays)
        parts: List[Any] = [kind, n_ins, modes, tuple(tkeys),
                            amp_signature()]
        for a, w in zip(arrays, wrapped):
            parts.append((tuple(a.shape), str(a.dtype), str(a.device), w))
        if kind in ("train", "train_scaled"):
            from ..utils.clip_grad import clip_spec
            opt = self.optimizer
            statics = _param_statics(opt, [self._params[k] for k in tkeys])
            if statics is None:
                return None
            parts.append((type(opt).__qualname__, _hyper_key(opt), statics,
                          clip_spec(opt._grad_clip, exact=True)))
        if scaler_statics is not None:
            parts.append(("scaler",) + tuple(scaler_statics))
        return tuple(parts)

    def _arrays(self, values) -> List[torch.Tensor]:
        out = []
        for v in values:
            if isinstance(v, Tensor):
                out.append(v._t)
            elif isinstance(v, torch.Tensor):
                out.append(v)
            else:
                from ..core.tensor import as_torch
                out.append(as_torch(v))
        return out

    # -- first sightings ---------------------------------------------------
    def eager_done(self) -> None:
        """The caller finished the eager step of a first sighting (this
        closes the window in which a draw from the port's generator
        marks the signature ``"rng"``)."""
        if self._sighting is not None and self._sighting_end is None:
            self._sighting_end = random_mod.draws()

    def _resolve_sighting(self) -> None:
        if self._sighting is None:
            return
        sig, d0 = self._sighting
        d1 = self._sighting_end if self._sighting_end is not None \
            else random_mod.draws()
        self._sighting = self._sighting_end = None
        if d1 != d0 and self._cache.get(sig) is _SEEN_STEP:
            self._cache[sig] = _RNG_STEP

    def _trim(self):
        cap = max(int(_capture_cache_flag.value or 8), 1)
        while len(self._cache) > cap:
            self._cache.popitem(last=False)

    # -- capture -----------------------------------------------------------
    def _leaf_ptrs(self, kind: str, tkeys, scaler=None, gens=()) -> tuple:
        """The addresses a graph holds beyond its own pool: parameters,
        buffers, the state tensors of the default generator and of
        ``gens`` on the network's device (each brought up to its host
        counter first) and, for a train graph, the optimizer states, the
        lr tensor and the scaler's carry."""
        ptrs = [t.data_ptr() for t in self._params.values()]
        ptrs += [t.data_ptr() for t in self._buffers.values()]
        dev = self._device()
        ptrs += [g.prepare(dev).data_ptr()
                 for g in (random_mod.default_generator(),) + tuple(gens)]
        if kind != "eval":
            opt = self.optimizer
            for k in tkeys:
                st = opt._state_for(opt._index[id(self._params[k])])
                ptrs += [v.data_ptr() for v in st.values()]
            lr = getattr(opt, "_fused_lr_dev", None)
            ptrs.append(None if lr is None else lr.data_ptr())
            if scaler is not None:
                ptrs += [t.data_ptr() for t in scaler.capture_carry()]
        return tuple(ptrs)

    def _device(self) -> torch.device:
        return next(iter(self._params.values())).device

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device())
        return self._stream

    @contextlib.contextmanager
    def eager_stream(self):
        """Where a caller runs its eager step on the card: the stream this
        engine captures on, joined to the current stream before and after.
        The autograd leaves an eager step makes (AccumulateGrad nodes,
        which a tensor the step leaves behind keeps alive, as a model's
        stored auxiliary loss does) then belong to the capture's stream,
        and a later capture that meets them does not wait on the legacy
        stream (``cudaErrorStreamCaptureImplicit``). A no-op on the
        CPU."""
        if not self._on_card():
            yield
            return
        cur = torch.cuda.current_stream(self._device())
        side = self._capture_stream()
        side.wait_stream(cur)
        try:
            with torch.cuda.stream(side):
                yield
        finally:
            cur.wait_stream(side)

    def _pool_handle(self):
        """The memory pool this engine's graphs share: a new one when no
        graph of the old is alive (a pool whose last graph went is
        freed and cannot take a capture again)."""
        self._capture_stream()
        if self._pool is None or not self.graphs():
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _loss_value(self, out, lbls):
        loss = self.loss_fn(out, *lbls) if self.loss_fn is not None else out
        if self._mean_reduce and loss.ndim > 0:
            loss = loss.mean()
        return loss

    def _capture(self, kind: str, arrays, n_ins: int, tkeys, scaler,
                 wrapped):
        """Record one step of ``kind`` into a new graph over static
        copies of ``arrays`` (nothing runs: the caller replays)."""
        from ..optimizer.fused_step import _lr_device
        opt = self.optimizer
        dev = self._device()
        pool = self._pool_handle()
        e = _Graph()
        e.kind = kind
        e.inputs = [torch.empty_like(a, device=dev).copy_(a)
                    for a in arrays]
        e.wrapped = wrapped
        e.keep, e.found, e.out, e.loss = [], None, None, None
        e.loss_wrapped = False
        if kind != "eval":
            # persistent state outside the graph's pool, before capture:
            # the moments and powers, and the lr, refreshed here and
            # never filled inside the graph
            for k in tkeys:
                opt._state_for(opt._index[id(self._params[k])])
            _lr_device(opt, dev)
            table_before = getattr(opt, "_fused_table", None)
            gstep0 = opt._global_step
        random_mod.default_generator().prepare(dev)
        draws0 = random_mod.draws()
        drawn: Dict[Any, int] = {}

        def observe(gen, where):
            if where == dev:
                drawn[gen] = drawn.get(gen, 0) + 1
        before = _counters.snapshot()
        e.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        observer0, random_mod._draw_observer = \
            random_mod._draw_observer, observe
        try:
            with torch.cuda.graph(e.graph, pool=pool, stream=self._stream):
                vals = [Tensor(t) if w else t
                        for t, w in zip(e.inputs, wrapped)]
                ins, lbls = vals[:n_ins], vals[n_ins:]
                if kind == "eval":
                    with torch.no_grad():
                        out = self.network(*ins)
                        loss = self._loss_value(out, lbls) \
                            if (self.loss_fn is not None and lbls) else None
                    e.out = unwrap_tree(out)
                else:
                    loss = self._loss_value(self.network(*ins), lbls)
                    if self._cast_f32:
                        loss = loss.astype("float32") \
                            if isinstance(loss, Tensor) else loss.float()
                    if scaler is not None:
                        scaler.scale(loss).backward()
                        scaler.step(opt)
                        e.found = scaler._found_tensor()
                        scaler.update()
                    else:
                        loss.backward()
                        if not self._strict:
                            self._zero_unreached(tkeys)
                        opt.step()
                e.loss_wrapped = isinstance(loss, Tensor)
                e.loss = None if loss is None else _raw(loss).detach()
        finally:
            random_mod._draw_observer = observer0
        self.stats["capture_seconds"] += time.perf_counter() - t0
        e.counts = _counters.delta(before, _counters.snapshot())
        _counters.restore(before)
        # recording drew nothing on the device: the mirrors go back, and
        # each replay advances them by what the graph draws
        e.draws = tuple(drawn.items())
        for gen, n in e.draws:
            gen._rewind(dev, n)
        if random_mod.draws() != draws0:
            raise RuntimeError(
                f"CapturedStep({self._name}): the step made a host draw "
                f"from the port's generator while it was captured; the "
                f"graph would replay the same seed")
        e.gsteps = 0
        if kind != "eval":
            e.gsteps = opt._global_step - gstep0
            opt._global_step = gstep0
            # the graph's gradients: kept alive (the graph writes them
            # every replay), out of .grad between steps
            for k in tkeys:
                p = self._params[k]
                if p.grad is not None:
                    e.keep.append(p.grad)
                    p.grad = None
            table = getattr(opt, "_fused_table", None)
            if table is not table_before:
                # built inside the capture: its tickets live in the pool
                e.keep.append(table)
                opt._fused_table = table_before
        e.ptrs = self._leaf_ptrs(kind, tkeys, scaler, self._gens(e))
        self.stats["compiles"] += 1
        _M_step_compiles.inc()
        _flight.record("sot", "capture_compile", fn=self._name, kind=kind)
        return e

    def _zero_unreached(self, tkeys) -> None:
        """A zero gradient for each trainable parameter the loss did not
        reach (the JAX step differentiates the whole trainable tree)."""
        for k in tkeys:
            p = self._params[k]
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    @staticmethod
    def _gens(e: _Graph) -> tuple:
        return tuple(g for g, _ in e.draws)

    def _replay(self, e: _Graph, arrays, scaler=None):
        if e.kind != "eval":
            from ..optimizer.fused_step import _lr_device
            _lr_device(self.optimizer, self._device())
        for buf, a in zip(e.inputs, arrays):
            buf.copy_(a, non_blocking=True)
        e.graph.replay()
        dev = self._device()
        for gen, n in e.draws:
            gen._advance(dev, n)
        _counters.advance(e.counts)
        if e.kind != "eval":
            self.optimizer._global_step += e.gsteps
        if scaler is not None:
            scaler.absorb_captured(scaler.capture_carry(), e.found.clone())
        self.stats["captured_steps"] += 1
        _M_captured.inc()

    def _run(self, kind: str, sig, arrays, wrapped, tkeys, n_ins: int,
             scaler=None):
        """Replay ``sig``'s graph, capturing it first when it is new or
        one of the addresses it holds moved."""
        entry = self._cache.get(sig)
        if isinstance(entry, _Graph):
            if entry.ptrs == self._leaf_ptrs(kind, tkeys, scaler,
                                             self._gens(entry)):
                self.stats["cache_hits"] += 1
                _M_hits.inc()
                self._replay(entry, arrays, scaler)
                return entry
            self._cache[sig] = entry = None      # stale: capture anew
        entry = self._capture(kind, arrays, n_ins, tkeys, scaler, wrapped)
        self._cache[sig] = entry
        self._replay(entry, arrays, scaler)
        return entry

    # -- entry points ------------------------------------------------------
    def _admit(self, kind: str, inputs, labels, scaler=None):
        """Kill switch, gate, signature and sighting for one call:
        ``(sig, arrays, wrapped, tkeys)`` to run captured, or None when
        the caller runs its eager step (a first sighting — then the
        caller calls :meth:`eager_done` —, or a counted fallback). The
        kill switch applies in strict mode only."""
        if self._strict and not _capture_flag.value:
            return None
        self._resolve_sighting()
        reason = self._gate(train=kind != "eval", scaler=scaler)
        if reason is None:
            if self._bucket is not None:
                inputs = list(self._bucket.apply(tuple(inputs)))
            values = list(inputs) + list(labels)
            arrays = self._arrays(values)
            wrapped = tuple(not isinstance(v, torch.Tensor) for v in values)
            tkeys = self._tkeys()
            statics = None if scaler is None else \
                scaler.capture_statics(self.optimizer)
            sig = self._signature(kind, arrays, len(inputs), tkeys, statics,
                                  wrapped)
            if sig is None:
                reason = "param_static"
        if reason is None:
            entry = self._cache.get(sig)
            if entry is None:
                self._cache[sig] = _SEEN_STEP
                self._trim()
                self._sighting = (sig, random_mod.draws())
                self.stats["eager_steps"] += 1
                return None
            self._cache.move_to_end(sig)
            if entry is _RNG_STEP:
                reason = "rng"
            elif not self._on_card():
                reason = "device"
        if reason is not None:
            self._fallback(reason)
            return None
        return sig, arrays, wrapped, tkeys

    def step(self, inputs, labels=(), scaler=None):
        """One train step over ``inputs`` / ``labels`` (Tensors, torch
        tensors or arrays). Returns the lazy device loss (a Tensor, or a
        torch tensor where the loss function gave one), or None when the
        caller must run its eager step (kill switch, a fallback, a first
        sighting: then call :meth:`eager_done` after it). With ``scaler`` (an enabled ``amp.GradScaler``) the graph
        is the whole AMP iteration: scale, backward, unscale and finite
        check, the masked update and the scale bookkeeping."""
        if scaler is not None and not scaler.is_enable():
            scaler = None
        kind = "train" if scaler is None else "train_scaled"
        got = self._admit(kind, inputs, labels, scaler)
        if got is None:
            return None
        e = self._run(kind, *got, len(inputs), scaler)
        loss = e.loss.clone()
        return Tensor(loss) if e.loss_wrapped else loss

    def forward(self, inputs, labels=()):
        """One eval forward (and loss, with labels and a loss function).
        Returns ``(out, loss)`` — device copies of the graph's outputs
        (as Tensors when the inputs were), ``loss`` None without labels
        — or None for the eager path."""
        got = self._admit("eval", inputs, labels)
        if got is None:
            return None
        e = self._run("eval", *got, len(inputs))
        out = _clone_tree(e.out)
        if any(e.wrapped):
            out = wrap_tree(out)
        return out, (None if e.loss is None else Tensor(e.loss.clone()))

    def graphs(self) -> Dict[str, int]:
        """Live captured graphs by kind."""
        out: Dict[str, int] = {}
        for e in self._cache.values():
            if isinstance(e, _Graph):
                out[e.kind] = out.get(e.kind, 0) + 1
        return out


def _raw(t):
    return t._t if isinstance(t, Tensor) else t


def _clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    return x
