"""SOT dy2static and whole-step capture of the port, on CUDA graphs.

The port of ``paddle_tpu/jit/sot.py``: ``SOTFunction`` (``sot_compile``,
``capture``, ``to_static``'s default) and ``CapturedStep``.

**SOTFunction** works at the op-dispatch level, as the JAX one does:

- **Record**: the function runs eagerly while every op of
  ``core.autograd.apply_op`` is logged into the current segment. A
  value read into Python (``Tensor.numpy`` / ``item`` / ``bool`` ...)
  closes the segment and becomes a guard. Everything else that makes a
  tensor during the call — a torch call outside ``apply_op``, as a plain
  ``torch.nn.Module`` makes — is seen by a ``TorchFunctionMode``: its
  outputs are constants when its inputs were (``to_tensor`` of a numpy
  argument, keyed by its content in the signature), else *tainted*. A
  tainted tensor reaching an op, a guard or the result makes the
  recording unreplayable (``"unrecorded"``), as RNG, an in-place
  mutation or an inner backward do (``"rng"``, ``"mutation"``,
  ``"backward"``): those calls stay eager, with a counted reason and
  one warning.
- **Replay** runs the recorded ops without the user's Python. The
  first replay of a path runs them op by op; from the second on, a
  segment that runs without gradients on the card is captured once as
  a ``torch.cuda.CUDAGraph`` (its inputs copied into static buffers,
  the parameters read where they live: an in-place update is seen, a
  moved tensor — ``set_state_dict`` into new storage, a ``.data`` swap —
  captures it again) and replayed. A replay that needs gradients (grad
  mode on and an input or parameter that requires one) runs op by op,
  so that torch.autograd records it: one policy for training through a
  replay. On the CPU every replay runs op by op. ``stats`` counts each
  kind: ``op_replays``, ``graph_replays``, ``segment_captures``.
- **Guards are speculative**: every segment of the path is dispatched,
  the guard values (and the external tensors a recording read) are
  packed into one uint8 tensor and read with one device-to-host copy;
  a miss discards the outputs (segments are pure) and the next
  candidate path or a new recording serves the call. Graph outputs that
  the call returns are cloned (the next replay overwrites them); the
  kernels' launch counters advance through graph replays.
- The signature covers tensor shapes, dtypes, devices and
  ``stop_gradient``, numpy arguments' content, the train/eval modes of
  the modules the function reaches (its ``self``, closure and globals)
  and ``amp.amp_signature()``; ``FLAGS_sot_cache_size`` bounds the
  cache (LRU), ``FLAGS_sot_guard_budget`` a path's guard bytes.
  ``FLAGS_sot_capture=0`` calls the plain function.

**CapturedStep** (with ``BucketPolicy`` and ``_count_fallback``) is the engine behind
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
  (``core.random.draws``: the rejection samplers ``standard_gamma``,
  ``poisson`` and ``binomial``, fractional pooling's windows,
  ``class_center_sample``) is never captured, because its seed is a
  Python int a graph would freeze. Draws from the key streams (every
  dropout, the random creation and in-place ops, ``rrelu``,
  ``gumbel_softmax``, the initializers, the flash kernels' dropout) are
  legal inside a graph.
  A capture that fails raises; it never runs eager quietly.

- **Warm bundles** — the second sighting of a signature (where the
  JAX step compiles) records a ``captured_step`` entry through
  ``jit.warmup.note_program``: its build (``train``, ``eval`` or
  ``train_scaled``), ``n_ins``, the batch's shapes and dtypes, the
  scaler's statics and the signature (``warmup.sig_to_json``). A CUDA
  graph cannot be written to a file, so :meth:`CapturedStep.prewarm`
  runs the entry's first sighting and its capture at boot, through the
  owner's own step (``step_runner``, which ``hapi.Model`` and ``jit.TrainStep``
  set), on a zero batch of the recorded shapes, and then puts back, in
  place and bit for bit, everything those two steps moved: parameters
  and buffers, optimizer states (a state the prewarm created goes back
  to its initial values), step counts, the device lr and the LR
  scheduler, the owner's GradScaler, the key streams and the layers'
  modes. The first real step is then a replay of a model that never
  moved. On the CPU the two steps run eager (the second counted
  ``"device"``), and are put back all the same.
- **Wrapped optimizers** — an optimizer whose class sets
  ``_capture_inner`` (``incubate.asp``'s ``decorate``: its step is the
  inner step plus in-place mask products, device ops) is captured with
  the inner optimizer's state and its own ``step()``.

``FLAGS_sot_capture=0`` is the kill switch of strict mode (every step
eager, nothing counted) and of ``SOTFunction``.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import inspect
import time
import warnings
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import autograd as autograd_mod
from ..core import random as random_mod
from ..core import tensor as tensor_mod
from ..core.flags import _registry as _flag_registry
from ..core.tensor import Tensor, unwrap_tree, wrap_tree
from ..observability import flight as _flight
from ..observability import metrics as _om
from ..ops.kernels import counters as _counters

__all__ = ["sot_compile", "SOTFunction", "BucketPolicy", "capture",
           "CapturedStep", "capture_jit", "CapturedProgram",
           "CaptureGroup"]

_capture_flag = _flag_registry["sot_capture"]
_capture_cache_flag = _flag_registry["sot_capture_cache"]

_M = _om.scope("sot")
_M_captured = _M.counter(
    "captured_steps_total",
    "Steps served by a CapturedStep CUDA graph (the capture's own "
    "replay included) or by an SOTFunction path replay")
_M_fallbacks = _M.counter(
    "fallbacks_total",
    "Steps that ran eager by a gate reason of CapturedStep, and SOT "
    "recordings that stayed eager, by reason")
_M_step_compiles = _M.counter(
    "captured_compiles_total", "Whole-step CUDA graphs captured")
_M_hits = _M.counter(
    "cache_hits_total",
    "CapturedStep executions served by an already captured graph")


# the capture auditor's seam (analysis.auditor), as the JAX package's
# fusion flush observer: _break_observer(event, reason, name) on a step
# or recording that falls back to eager ("fallback", by reason), an SOT
# guard miss ("guard_miss") and a CUDA graph captured ("capture", by
# kind: "train" / "eval" steps, "segment", "program", "static"). None
# outside an audit.
_break_observer = None


def _note_break(event: str, reason: str, name: str = "") -> None:
    if _break_observer is not None:
        _break_observer(event, reason, name)


def _count_fallback(reason: str, name: str = "") -> None:
    _M_fallbacks.inc(reason=reason)
    _flight.record("sot", "fallback", reason=reason, fn=name)
    _note_break("fallback", reason, name)


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


# ---------------------------------------------------------------------------
# SOTFunction: record eagerly, guard host reads, replay segments
# ---------------------------------------------------------------------------

_cache_size_flag = _flag_registry["sot_cache_size"]
_guard_budget_flag = _flag_registry["sot_guard_budget"]

_M_guard_miss = _M.counter(
    "guard_misses_total",
    "SOT replays whose guards missed: the speculated outputs were "
    "discarded and the next candidate path or a re-record served the "
    "call")
_M_retraces = _M.counter(
    "retraces_total",
    "SOT calls where every cached path of the signature missed its "
    "guards and the branch was recorded again")
_M_seg_compiles = _M.counter(
    "segment_compiles_total",
    "SOT path segments captured as CUDA graphs (on a path's second "
    "replay)")

_MAX_GUARD_BYTES = 256


def _fallback_category(why: str) -> str:
    """Bounded-cardinality label of a fallback reason (the JAX
    categories and ``"unrecorded"``)."""
    if "RNG" in why:
        return "rng"
    if "mutation" in why:
        return "mutation"
    if "backward" in why:
        return "backward"
    if "unrecorded" in why:
        return "unrecorded"
    if "guard budget" in why:
        return "guard_budget"
    if "guard limit" in why or "materialized" in why:
        return "oversized_guard"
    return "other"


def _content_digest(a) -> tuple:
    """Shape, dtype and SHA-1 of a numpy argument's bytes, hashed on
    every call (a numpy array is mutable: a stale digest would replay
    old constants)."""
    import hashlib
    arr = np.ascontiguousarray(a)
    return (arr.shape, str(arr.dtype), hashlib.sha1(arr.tobytes()).hexdigest())


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A tensor's element bytes in order, as numpy's ``tobytes`` gives
    them (one device-to-host copy; unseen by a recorder's mode)."""
    with torch._C.DisableTorchFunction():
        # a guard's read, or a constant's content hash at recording
        return _as_bytes(t).cpu().numpy().tobytes()  # lint-allow: PTL001


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    flat = t.detach().reshape(-1).contiguous()
    return flat.view(torch.uint8) if flat.numel() else \
        flat.new_empty(0, dtype=torch.uint8)


def _tensors_in(v, out, depth=0):
    """Torch tensors (and Tensors' wrapped ones) inside ``v``: lists,
    tuples, dicts, a function's closure, defaults and a partial's
    arguments, a few levels deep."""
    if depth > 3:
        return out
    if isinstance(v, Tensor):
        out.append(v._t)
    elif isinstance(v, torch.Tensor):
        out.append(v)
    elif isinstance(v, (list, tuple)):
        for x in v:
            _tensors_in(x, out, depth + 1)
    elif isinstance(v, dict):
        for x in v.values():
            _tensors_in(x, out, depth + 1)
    elif isinstance(v, functools.partial):
        _tensors_in(v.func, out, depth + 1)
        _tensors_in(v.args, out, depth + 1)
        _tensors_in(v.keywords, out, depth + 1)
    elif callable(v) and hasattr(v, "__code__"):
        for cell in getattr(v, "__closure__", None) or ():
            try:
                _tensors_in(cell.cell_contents, out, depth + 1)
            except ValueError:
                continue
        _tensors_in(getattr(v, "__defaults__", None) or (), out, depth + 1)
        _tensors_in(getattr(v, "__kwdefaults__", None) or {}, out,
                    depth + 1)
    return out


class _Op:
    __slots__ = ("fn", "arg_refs", "kwargs", "out_ids", "name")

    def __init__(self, fn, arg_refs, kwargs, out_ids, name=""):
        self.fn = fn              # the op's function of torch tensors
        self.arg_refs = arg_refs  # ("id", sid) | ("ext", Tensor) | ("lit", v)
        self.kwargs = kwargs
        self.out_ids = out_ids    # sid per output (None: not a tensor)
        self.name = name


class _Segment:
    __slots__ = ("ops", "input_ids", "ext_tensors", "output_ids", "graph")

    def __init__(self):
        self.ops: List[_Op] = []
        self.input_ids: List[int] = []
        self.ext_tensors: List[Tensor] = []
        self.output_ids: List[int] = []
        self.graph = None   # _SegmentGraph on the card, from replay 2


class _Guard:
    __slots__ = ("tensor_id", "kind", "value")

    def __init__(self, tensor_id, kind, value):
        self.tensor_id = tensor_id
        self.kind = kind          # "item" | "numpy"
        self.value = value        # the tensor's bytes


class _Recording:
    """One straight-line trace: segments alternating with guards, plus
    the provenance of the return value."""

    __slots__ = ("segments", "guards", "ext_guards", "result_spec",
                 "replayable", "why_not")

    def __init__(self):
        self.segments: List[_Segment] = []
        self.guards: List[_Guard] = []
        # (Tensor, bytes): tensors from outside the trace whose value
        # steered Python, checked again at every replay
        self.ext_guards: List[Tuple[Tensor, bytes]] = []
        self.result_spec = None
        self.replayable = True
        self.why_not = ""


# torch functions that draw from torch's own generators, and those that
# read a tensor's value into Python
_RANDOM_FUNCS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
    "uniform_", "normal_", "bernoulli_", "exponential_", "cauchy_",
    "geometric_", "log_normal_", "random_"}
_HOST_READS = {"item", "tolist", "numpy", "__bool__", "__int__", "__float__",
               "__index__", "__array__"}
_NOT_MUTATIONS = {"requires_grad_", "retain_grad", "share_memory_",
                  "record_stream"}


class _Recorder:
    """The hooks of one eagerly executed call: ops through ``apply_op``
    are logged, host reads become guards, and everything else that makes
    a tensor (a torch call outside ``apply_op``, seen through a
    ``TorchFunctionMode``) is marked: its outputs are *tainted* when one
    of its tensor inputs came from the trace, *constants* when all came
    from Python values. A recording that hands a tainted tensor to an op,
    a guard or its result cannot replay (``"unrecorded"``): the replay
    would return a stale tensor."""

    def __init__(self):
        self.rec = _Recording()
        self.cur = _Segment()
        self.next_id = 0
        self.tensor_ids: Dict[int, int] = {}   # id(Tensor) -> sid
        self.raw_ids: Dict[int, int] = {}      # id(torch tensor) -> sid
        self.keepalive: List[Any] = []         # ids stay valid
        self.produced_in_cur: set = set()
        self.tainted: set = set()              # ids of torch tensors
        self.consts: set = set()

    # -- ids ----------------------------------------------------------------
    def tag(self, t) -> int:
        sid = self.next_id
        self.next_id += 1
        raw = t._t if isinstance(t, Tensor) else t
        if isinstance(t, Tensor):
            self.tensor_ids[id(t)] = sid
        self.raw_ids[id(raw)] = sid
        self.keepalive.append(t)
        self.keepalive.append(raw)
        return sid

    def _sid(self, t: Tensor):
        sid = self.tensor_ids.get(id(t))
        return self.raw_ids.get(id(t._t)) if sid is None else sid

    def fail(self, why: str) -> None:
        # the JAX recorder keeps the last reason; an unrecorded
        # computation never hides another one
        if "unrecorded" in why and not self.rec.replayable:
            return
        self.rec.replayable = False
        self.rec.why_not = why

    def _unrecorded(self, what: str) -> None:
        self.fail(f"unrecorded computation: {what} came from a torch call "
                  f"outside the recorded ops")

    def ref_of(self, a):
        if isinstance(a, Tensor):
            sid = self._sid(a)
            if sid is not None:
                return ("id", sid)
            if id(a._t) in self.tainted:
                self._unrecorded("an op's input")
            return ("ext", a)          # a parameter or captured tensor
        if isinstance(a, torch.Tensor):
            sid = self.raw_ids.get(id(a))
            if sid is not None:
                return ("id", sid)
            if id(a) in self.tainted:
                self._unrecorded("an op's input")
        return ("lit", a)

    def _check_closure(self, fn, kwargs) -> None:
        for t in _tensors_in(fn, []) + _tensors_in(kwargs, []):
            if id(t) in self.raw_ids or id(t) in self.tainted:
                self._unrecorded("a tensor an op's function holds")
                return

    # -- hooks --------------------------------------------------------------
    def on_op(self, fn, args, kwargs, outs, name):
        arg_refs = [self.ref_of(a) for a in args]
        self._check_closure(fn, kwargs)
        out_ids = []
        for o in outs:
            if isinstance(o, (Tensor, torch.Tensor)):
                sid = self.tag(o)
                self.produced_in_cur.add(sid)
                out_ids.append(sid)
            else:
                out_ids.append(None)
        self.cur.ops.append(_Op(fn, arg_refs, dict(kwargs), out_ids, name))

    def on_torch_call(self, func, args, kwargs, out) -> None:
        name = getattr(func, "__name__", "")
        if name == "backward":
            self.on_backward()
        if name in _RANDOM_FUNCS:
            self.on_rng()
        ins = _tensors_in(args, []) + _tensors_in(kwargs, [])
        if name in _HOST_READS and ins:
            self._host_read(ins[0], name)
        known = [t for t in ins if id(t) not in self.consts]
        inplace = name not in _NOT_MUTATIONS and (
            (name.endswith("_") and not name.startswith("__"))
            or name == "__setitem__" or "out" in kwargs)
        if inplace and ins and id(ins[0]) not in self.consts and \
                id(ins[0]) not in self.tainted:
            self.on_mutation(ins[0])
        outs = _tensors_in(out, [])
        mark = self.tainted if known else self.consts
        for o in outs:
            if id(o) in self.raw_ids:
                continue        # an op's output handed back as it is
            mark.add(id(o))
            self.keepalive.append(o)

    def _host_read(self, raw: torch.Tensor, name: str) -> None:
        """A torch tensor's value read into Python by a torch call: a
        guard when the trace made it, unrecorded when it is tainted."""
        if id(raw) in self.raw_ids:
            self.on_materialize(raw, "item" if name == "item" else "numpy")
        elif id(raw) in self.tainted:
            self._unrecorded("a host read")

    def on_materialize(self, t, kind: str):
        raw = t._t if isinstance(t, Tensor) else t
        nbytes = raw.numel() * raw.element_size()
        if nbytes > _MAX_GUARD_BYTES:
            self.fail(f"materialized a {nbytes}-byte tensor into Python "
                      f"(> {_MAX_GUARD_BYTES}B guard limit)")
            return
        value = _raw_bytes(raw)
        sid = self._sid(t) if isinstance(t, Tensor) else \
            self.raw_ids.get(id(raw))
        if sid is None:
            if id(raw) in self.tainted:
                self._unrecorded("a host read")
                return
            # a tensor from outside the trace steered Python: guard on it
            self.rec.ext_guards.append((t, value))
            return
        extra = [sid] if sid in self.produced_in_cur else []
        self._close_segment(extra_outputs=extra)
        self.rec.guards.append(_Guard(sid, kind, value))

    def on_mutation(self, t):
        self.fail("in-place tensor mutation during trace")

    def on_rng(self):
        self.fail("RNG consumed during trace (e.g. dropout)")

    def on_backward(self):
        self.fail("autograd backward ran during trace")

    def _close_segment(self, extra_outputs=()):
        seg = self.cur
        for sid in extra_outputs:
            if sid not in seg.output_ids:
                seg.output_ids.append(sid)
        self.rec.segments.append(seg)
        self.cur = _Segment()
        self.produced_in_cur = set()

    # -- finish -------------------------------------------------------------
    def finish(self, result) -> _Recording:
        def result_refs(r):
            if isinstance(r, Tensor):
                return self.ref_of(r)
            if isinstance(r, torch.Tensor):
                sid = self.raw_ids.get(id(r))
                if sid is not None:
                    return ("raw", sid)
                if id(r) in self.tainted:
                    self._unrecorded("the result")
                return ("lit", r)
            if isinstance(r, (list, tuple)):
                return (type(r).__name__, [result_refs(v) for v in r])
            if isinstance(r, dict):
                return ("dict", {k: result_refs(v) for k, v in r.items()})
            return ("lit", r)

        self._close_segment()
        self.rec.result_spec = result_refs(result)
        produced_by = {}
        for si, seg in enumerate(self.rec.segments):
            for op in seg.ops:
                for oid in op.out_ids:
                    if oid is not None:
                        produced_by[oid] = si
        needed_after: Dict[int, set] = {}

        def note_need(sid, at_seg):
            src = produced_by.get(sid)
            if src is not None and src != at_seg:
                needed_after.setdefault(src, set()).add(sid)

        for si, seg in enumerate(self.rec.segments):
            for op in seg.ops:
                for kind, v in op.arg_refs:
                    if kind == "id":
                        note_need(v, si)

        def walk_result(spec):
            kind = spec[0]
            if kind in ("id", "raw"):
                note_need(spec[1], -1)
            elif kind in ("list", "tuple"):
                for v in spec[1]:
                    walk_result(v)
            elif kind == "dict":
                for v in spec[1].values():
                    walk_result(v)

        walk_result(self.rec.result_spec)
        for g in self.rec.guards:
            note_need(g.tensor_id, -1)
        for si, seg in enumerate(self.rec.segments):
            seg.output_ids = sorted(set(seg.output_ids)
                                    | needed_after.get(si, set()))
            ins, exts, seen_ext = [], [], set()
            local = {oid for op in seg.ops for oid in op.out_ids}
            for op in seg.ops:
                for kind, v in op.arg_refs:
                    if kind == "id" and v not in local and v not in ins:
                        ins.append(v)
                    elif kind == "ext" and id(v) not in seen_ext:
                        seen_ext.add(id(v))
                        exts.append(v)
            seg.input_ids = ins
            seg.ext_tensors = exts
        return self.rec


class _TaintMode(torch.overrides.TorchFunctionMode):
    """Shows the recorder every torch call made outside ``apply_op``."""

    def __init__(self, recorder: _Recorder):
        super().__init__()
        self.recorder = recorder

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if autograd_mod._op_depth == 0:
            self.recorder.on_torch_call(func, args, kwargs, out)
        return out


class _RecorderSession:
    def __init__(self, recorder: _Recorder):
        self.recorder = recorder
        self.mode = _TaintMode(recorder)

    def __enter__(self):
        r = self.recorder
        if autograd_mod._op_recorder is not None:
            raise RuntimeError("SOT recording cannot nest")
        autograd_mod._op_recorder = r.on_op
        tensor_mod._materialize_hook = r.on_materialize
        tensor_mod._mutation_hook = r.on_mutation
        random_mod._key_observer = r.on_rng
        autograd_mod._backward_observer = r.on_backward
        self.mode.__enter__()
        return r

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        autograd_mod._op_recorder = None
        tensor_mod._materialize_hook = None
        tensor_mod._mutation_hook = None
        random_mod._key_observer = None
        autograd_mod._backward_observer = None
        return False


def _unwrap(t):
    return t._t if isinstance(t, Tensor) else t


def _fetch_bytes(vals: List[torch.Tensor]) -> bytes:
    """The bytes of ``vals`` in order, packed on each device into one
    uint8 tensor and read with one device-to-host copy a device."""
    parts = [_as_bytes(v) for v in vals]
    by_dev: Dict[torch.device, List[int]] = {}
    for i, p in enumerate(parts):
        by_dev.setdefault(p.device, []).append(i)
    out: List[bytes] = [b""] * len(parts)
    for idx in by_dev.values():
        sel = [parts[i] for i in idx]
        packed = torch.cat(sel) if len(sel) > 1 else sel[0]
        # the guard's one packed fetch a replay: the host read the
        # recording saw
        host = packed.cpu().numpy().tobytes()  # lint-allow: PTL001
        off = 0
        for i in idx:
            n = parts[i].numel()
            out[i] = host[off:off + n]
            off += n
    return b"".join(out)


def _run_ops(ops: List[_Op], env: Dict[int, torch.Tensor]) -> None:
    """Run recorded ops on torch tensors, writing their outputs into
    ``env`` (autograd records them as it records any op)."""
    for op in ops:
        call = []
        for kind, v in op.arg_refs:
            if kind == "id":
                call.append(env[v])
            elif kind == "ext":
                call.append(v._t)
            else:
                call.append(v)
        res = op.fn(*call, **op.kwargs)
        res = tuple(res) if isinstance(res, (tuple, list)) else (res,)
        for oid, r in zip(op.out_ids, res):
            if oid is not None:
                env[oid] = r


_side_streams: Dict[torch.device, Any] = {}


def _side_stream(dev: torch.device):
    s = _side_streams.get(dev)
    if s is None:
        s = _side_streams[dev] = torch.cuda.Stream(dev)
    return s


@contextlib.contextmanager
def _on_side_stream(dev: torch.device):
    """Run on ``dev``'s SOT stream, joined to the current stream before
    and after: a segment's op-by-op replay warms the stream its graph is
    captured on (cuBLAS workspaces, cuDNN plans)."""
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    side.wait_stream(cur)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        cur.wait_stream(side)


class _SegmentGraph:
    """A segment captured as one CUDA graph: static copies of its inputs,
    its outputs (which the next replay overwrites), the addresses of the
    external tensors it reads and the launch counts it replays."""
    __slots__ = ("graph", "inputs", "outputs", "ptrs", "counts")


def _ext_ptrs(seg: _Segment) -> tuple:
    return tuple((t._t.data_ptr(), t._t.dtype, tuple(t._t.shape))
                 for t in seg.ext_tensors)


class _CompiledPath:
    """One guard path of one signature. The first replay runs its
    segments op by op; from the second on, a segment that runs without
    gradients on the card replays as a CUDA graph, captured once (again
    when an external tensor it reads moved). Guards are speculative:
    every segment is dispatched, then the guard values (and those of the
    external guards) are packed into one uint8 tensor and read with one
    device-to-host copy; a miss discards the outputs (segments are pure:
    nothing to undo)."""

    def __init__(self, rec: _Recording, input_ids: List[int],
                 name: str = ""):
        self.rec = rec
        self.input_ids = input_ids
        self.name = name
        self.replays = 0
        self._guard_bytes = b"".join(v for _, v in rec.ext_guards) + \
            b"".join(g.value for g in rec.guards)

    def _graphable(self, seg: _Segment, env, dev) -> bool:
        if dev is None or dev.type != "cuda" or self.replays < 1 \
                or seg.graph is False:
            return False
        if torch.is_grad_enabled():
            ins = [env[i] for i in seg.input_ids] + \
                [t._t for t in seg.ext_tensors]
            if any(t.requires_grad for t in ins):
                return False
        return True

    def _capture(self, seg: _Segment, env, dev, stats) -> _SegmentGraph:
        from ..ops.kernels import counters as counters_mod
        g = _SegmentGraph()
        g.inputs = [torch.empty_like(env[i]).copy_(env[i])
                    for i in seg.input_ids]
        local = dict(zip(seg.input_ids, g.inputs))
        g.graph = torch.cuda.CUDAGraph()
        before = counters_mod.snapshot()
        t0 = time.perf_counter()
        try:
            with torch.no_grad(), torch.cuda.graph(
                    g.graph, stream=_side_stream(dev)):
                _run_ops(seg.ops, local)
        finally:
            g.counts = counters_mod.delta(before, counters_mod.snapshot())
            counters_mod.restore(before)
        stats["capture_seconds"] += time.perf_counter() - t0
        g.outputs = [local[o] for o in seg.output_ids]
        g.ptrs = _ext_ptrs(seg)
        stats["segment_captures"] += 1
        _M_seg_compiles.inc()
        _note_break("capture", "segment", self.name)
        _flight.record("sot", "segment_compile", fn=self.name,
                       ops=len(seg.ops))
        return g

    def _run_graph(self, seg: _Segment, env, dev, stats) -> None:
        from ..ops.kernels import counters as counters_mod
        g = seg.graph
        if g is None or g.ptrs != _ext_ptrs(seg):
            try:
                seg.graph = g = self._capture(seg, env, dev, stats)
            except Exception as e:  # noqa: BLE001 - counted and warned
                seg.graph = False
                stats["capture_failures"] += 1
                warnings.warn(
                    f"to_static({self.name}): a segment of {len(seg.ops)} "
                    f"ops could not be captured as a CUDA graph "
                    f"({type(e).__name__}: {e}); it replays op by op",
                    RuntimeWarning)
                with _on_side_stream(dev):
                    _run_ops(seg.ops, env)
                return False
        for buf, i in zip(g.inputs, seg.input_ids):
            buf.copy_(env[i], non_blocking=True)
        g.graph.replay()
        counters_mod.advance(g.counts)
        for o, t in zip(seg.output_ids, g.outputs):
            env[o] = t
        return True

    def replay(self, inputs: List[torch.Tensor], stats, dev):
        """``(ok, result)``; ok is False on a guard miss."""
        rec = self.rec
        env: Dict[int, torch.Tensor] = dict(zip(self.input_ids, inputs))
        owned = set()           # sids a graph will overwrite: cloned out
        graphs = ops = 0
        try:
            for seg in rec.segments:
                if not seg.ops:
                    continue
                if self._graphable(seg, env, dev) and \
                        self._run_graph(seg, env, dev, stats):
                    owned.update(seg.output_ids)
                    graphs += 1
                elif dev is not None and dev.type == "cuda":
                    with _on_side_stream(dev):
                        _run_ops(seg.ops, env)
                    ops += 1
                else:
                    _run_ops(seg.ops, env)
                    ops += 1
            vals = [_unwrap(t) for t, _ in rec.ext_guards] + \
                [env[g.tensor_id] for g in rec.guards]
            if vals:
                stats["guard_fetches"] += 1
                if _fetch_bytes(vals) != self._guard_bytes:
                    stats["guard_misses"] += 1
                    _M_guard_miss.inc()
                    _note_break("guard_miss", "guard", self.name)
                    _flight.record("sot", "guard_miss", fn=self.name)
                    return False, None
        except Exception as e:  # noqa: BLE001 - degrade, but loudly
            if isinstance(e, torch.cuda.OutOfMemoryError):
                raise
            warnings.warn(
                f"SOT replay fell back to recording on an unexpected "
                f"{type(e).__name__}: {e}", RuntimeWarning)
            return False, None
        self.replays += 1
        stats["graph_replays" if graphs and not ops else "op_replays"] += 1
        _M_captured.inc()
        return True, self._build_result(env, owned)

    def _build_result(self, env, owned):
        def build(spec):
            kind = spec[0]
            if kind in ("id", "raw"):
                t = env[spec[1]]
                if spec[1] in owned:
                    t = t.clone()
                return Tensor(t) if kind == "id" else t
            if kind == "ext":
                return spec[1]
            if kind in ("list", "tuple"):
                vals = [build(v) for v in spec[1]]
                return tuple(vals) if kind == "tuple" else vals
            if kind == "dict":
                return {k: build(v) for k, v in spec[1].items()}
            return spec[1]
        return build(self.rec.result_spec)


class SOTFunction:
    """``paddle.jit.to_static`` with graph breaks (see the module
    docstring): record, guard, replay. ``stats`` counts what ran:
    ``records``, ``op_replays`` and ``graph_replays`` (path replays whose
    segments ran op by op / all as CUDA graphs), ``segment_captures``,
    ``guard_fetches`` (one a guarded replay), ``guard_misses``,
    ``retraces``, ``eager_calls`` and ``fallbacks`` by category."""

    def __init__(self, fn: Callable, bucket_policy: Optional[BucketPolicy]
                 = None, name: Optional[str] = None, input_spec=None):
        self._fn = fn
        self._bucket = bucket_policy
        self.input_spec = input_spec
        self._name = name or getattr(fn, "__name__", "fn")
        self._cache: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._warned = set()
        self._fallback_reasons: Dict[str, int] = {}
        self.stats: Dict[str, Any] = {
            "records": 0, "op_replays": 0, "graph_replays": 0,
            "segment_captures": 0, "capture_failures": 0,
            "capture_seconds": 0.0,
            "guard_fetches": 0, "guard_misses": 0, "retraces": 0,
            "eager_calls": 0, "fallbacks": {}}
        # modules whose train/eval modes steer the trace: the bound self,
        # those in the closure and the module globals the code names
        self._layers: List[torch.nn.Module] = []

        def note(v):
            if isinstance(v, torch.nn.Module):
                if all(v is not m for m in self._layers):
                    self._layers.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, torch.nn.Module):
                        note(x)
            elif isinstance(v, dict):
                for x in v.values():
                    if isinstance(x, torch.nn.Module):
                        note(x)

        note(getattr(fn, "__self__", None))
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                note(cell.cell_contents)
            except ValueError:
                continue
        code = getattr(fn, "__code__", None)
        gl = getattr(fn, "__globals__", None)
        if code is not None and gl is not None:
            for nm in code.co_names:
                note(gl.get(nm))

    # -- signature ----------------------------------------------------------
    @staticmethod
    def _arg_key(a):
        if isinstance(a, Tensor):
            return ("T", tuple(a._t.shape), str(a._t.dtype), str(a._t.device),
                    not a.stop_gradient)
        if isinstance(a, torch.Tensor):
            return ("R", tuple(a.shape), str(a.dtype), str(a.device),
                    a.requires_grad)
        if isinstance(a, np.ndarray):
            # a raw array is a constant of the trace: key on its content
            return ("A", *_content_digest(a))
        return ("L", repr(a))

    def _signature(self, args, kwargs):
        from ..amp.auto_cast import amp_signature
        parts = [self._arg_key(a) for a in args]
        for k in sorted(kwargs):
            parts.append((k, self._arg_key(kwargs[k])))
        modes = tuple(m.training for lyr in self._layers
                      for m in lyr.modules())
        parts.append(("mode", modes) + amp_signature())
        return tuple(parts)

    def _cache_put(self, key, value):
        self._cache[key] = value
        self._cache.move_to_end(key)
        limit = max(int(_cache_size_flag.value or 64), 1)
        while len(self._cache) > limit:
            self._cache.popitem(last=False)

    def cache_size(self):
        return len(self._cache)

    def capture_metadata(self):
        """Per recorded path its segments (op names, arity) and guards,
        and the reasons recordings stayed eager."""
        paths = []
        for val in self._cache.values():
            if val == "eager":
                paths.append({"kind": "eager"})
                continue
            rec = val.rec
            paths.append({
                "kind": "compiled",
                "segments": [
                    {"n_ops": len(seg.ops),
                     "ops": [op.name for op in seg.ops],
                     "inputs": len(seg.input_ids),
                     "ext_tensors": len(seg.ext_tensors),
                     "outputs": len(seg.output_ids)}
                    for seg in rec.segments],
                "guards": [{"kind": g.kind, "nbytes": len(g.value)}
                           for g in rec.guards],
                "ext_guards": len(rec.ext_guards),
            })
        return {"name": self._name, "cache_entries": len(self._cache),
                "paths": paths,
                "fallback_reasons": dict(self._fallback_reasons)}

    @staticmethod
    def _tensor_args(args, kwargs):
        vals = list(args) + [kwargs[k] for k in sorted(kwargs)]
        return [a for a in vals if isinstance(a, (Tensor, torch.Tensor))]

    # -- record -------------------------------------------------------------
    def _record(self, sig, args, kwargs):
        rec_obj = _Recorder()
        tensor_args = self._tensor_args(args, kwargs)
        input_ids = [rec_obj.tag(t) for t in tensor_args]
        with _RecorderSession(rec_obj):
            result = self._fn(*args, **kwargs)
        rec = rec_obj.finish(result)
        self.stats["records"] += 1
        if rec.replayable:
            budget = max(int(_guard_budget_flag.value or 0), 0)
            total = sum(len(g.value) for g in rec.guards) + \
                sum(len(v) for _, v in rec.ext_guards)
            if budget and total > budget:
                rec.replayable = False
                rec.why_not = (
                    f"guard budget exceeded ({total}B of guard values > "
                    f"FLAGS_sot_guard_budget={budget}B)")
        guard_path = tuple(g.value for g in rec.guards)
        if rec.replayable:
            self._cache_put((sig, guard_path),
                            _CompiledPath(rec, input_ids, self._name))
            return result
        self._cache_put((sig, "eager"), "eager")
        reason = rec.why_not
        cat = _fallback_category(reason)
        _count_fallback(cat, self._name)
        fb = self.stats["fallbacks"]
        fb[cat] = fb.get(cat, 0) + 1
        if reason not in self._fallback_reasons and \
                len(self._fallback_reasons) >= 16:
            reason = "<other>"
        self._fallback_reasons[reason] = \
            self._fallback_reasons.get(reason, 0) + 1
        if self._name not in self._warned:
            self._warned.add(self._name)
            warnings.warn(
                f"to_static({self._name}): trace is not replayable "
                f"({rec.why_not}); running eagerly (graph-break fallback)",
                stacklevel=3)
        return result

    # -- call ---------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        # under an outer recording: the plain function, so that the outer
        # recorder sees every op; under torch.export's trace likewise
        if autograd_mod._op_recorder is not None or \
                torch.compiler.is_exporting() or \
                torch.compiler.is_compiling():
            return self._fn(*args, **kwargs)
        if not _capture_flag.value:
            return self._fn(*args, **kwargs)
        if self._bucket is not None:
            args = self._bucket.apply(args)
        sig = self._signature(args, kwargs)
        tensor_args = self._tensor_args(args, kwargs)
        raws = [t._t if isinstance(t, Tensor) else t for t in tensor_args]
        dev = raws[0].device if raws else None
        candidates = [(k, v) for k, v in reversed(self._cache.items())
                      if k[0] == sig and v != "eager"]
        for key, path in candidates:
            if dev is None:
                dev = _path_device(path)
            ok, result = path.replay(raws, self.stats, dev)
            if ok:
                self._cache.move_to_end(key)
                return result
        if candidates:
            self.stats["retraces"] += 1
            _M_retraces.inc()
            _flight.record("sot", "retrace", fn=self._name,
                           candidates=len(candidates))
        if self._cache.get((sig, "eager")) == "eager":
            self._cache.move_to_end((sig, "eager"))
            self.stats["eager_calls"] += 1
            return self._fn(*args, **kwargs)
        return self._record(sig, args, kwargs)


def _path_device(path: _CompiledPath) -> Optional[torch.device]:
    """A path without tensor inputs runs where its external tensors
    are."""
    for seg in path.rec.segments:
        for t in seg.ext_tensors:
            return t._t.device
    return None


def sot_compile(fn=None, bucket_policy: Optional[BucketPolicy] = None):
    """Decorator form: ``@sot_compile`` or ``sot_compile(fn,
    bucket_policy=...)``."""
    def deco(f):
        return SOTFunction(f, bucket_policy)
    if fn is not None:
        return deco(fn)
    return deco


def capture(fn=None, bucket_policy: Optional[BucketPolicy] = None,
            name: Optional[str] = None):
    """``@sot.capture``: record once, replay the recorded segments with
    their guards checked in one fetch, fall back to eager with a counted
    reason on what cannot replay (RNG, mutation, an inner backward, an
    unrecorded computation). ``FLAGS_sot_capture=0`` calls the plain
    function."""
    def deco(f):
        return SOTFunction(f, bucket_policy, name=name)
    if fn is not None:
        return deco(fn)
    return deco


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


def _core_optimizer(opt):
    """The optimizer whose state a train graph holds: the inner one of
    a wrapper that declares ``_capture_inner``."""
    while getattr(type(opt), "_capture_inner", False):
        opt = opt._optimizer
    return opt


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
        # the signatures recorded for a warm bundle
        self._noted: set = set()
        # the owner's step runner ``(kind, inputs, labels)`` a prewarm
        # drives (see ``step_runner``), and the owner's GradScaler, which a
        # prewarm puts back
        self._step_runner = None
        self.scaler = None
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
            if self.optimizer is None:
                return "no_optimizer"
            opt = self._opt
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

    @property
    def step_runner(self) -> Optional[Callable]:
        """The owner's step runner a prewarm drives. A bound method is
        held weakly: its owner holds this engine, and a reference cycle
        would leave the engine's graphs to the cyclic collector, which
        may run inside another engine's capture, where freeing a graph
        is illegal."""
        d = self._step_runner
        return d() if isinstance(d, weakref.WeakMethod) else d

    @step_runner.setter
    def step_runner(self, fn: Optional[Callable]) -> None:
        self._step_runner = weakref.WeakMethod(fn) if inspect.ismethod(fn) \
            else fn

    @property
    def _opt(self):
        """The optimizer whose state the graphs hold (see
        :func:`_core_optimizer`)."""
        return _core_optimizer(self.optimizer)

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
            opt = self._opt
            statics = _param_statics(opt, [self._params[k] for k in tkeys])
            if statics is None:
                return None
            parts.append((type(self.optimizer).__qualname__,
                          _hyper_key(opt), statics,
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
            opt = self._opt
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
        opt = self._opt
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
                        scaler.step(self.optimizer)
                        e.found = scaler._found_tensor()
                        scaler.update()
                    else:
                        loss.backward()
                        if not self._strict:
                            self._zero_unreached(tkeys)
                        self.optimizer.step()
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
        _note_break("capture", kind, self._name)
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
            _lr_device(self._opt, self._device())
        for buf, a in zip(e.inputs, arrays):
            buf.copy_(a, non_blocking=True)
        e.graph.replay()
        dev = self._device()
        for gen, n in e.draws:
            gen._advance(dev, n)
        _counters.advance(e.counts)
        if e.kind != "eval":
            self._opt._global_step += e.gsteps
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
            if entry is _SEEN_STEP:
                # the second sighting, where the JAX step compiles
                self._note(kind, sig, arrays, len(inputs), statics)
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

    def _note(self, kind: str, sig, arrays, n_ins: int, statics) -> None:
        """Record ``sig`` once as a warm bundle's ``captured_step``
        entry (the JAX package's fields)."""
        if sig in self._noted:
            return
        self._noted.add(sig)
        from .warmup import note_program, sig_to_json
        note_program("captured_step", self._name, {
            "build": kind, "n_ins": n_ins,
            # the JAX bundle's dtype strings: float32, int64, bfloat16
            "batch": [[list(a.shape), str(a.dtype).replace("torch.", "")]
                      for a in arrays],
            "scaler": list(statics) if statics else None,
            "sig": sig_to_json(sig)})

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

    # -- boot pre-warm -----------------------------------------------------
    def prewarm(self, entry) -> None:
        """Boot pre-warm from one warm bundle ``captured_step`` entry:
        the signature's first sighting and its capture, run now through
        ``step_runner`` on a zero batch of the recorded shapes and dtypes
        (Tensors where the recorded signature had them), then every
        piece of state the two steps moved put back in place (see the
        module docstring), so the first real step of that signature is
        a replay. Raises ``ValueError`` for an unknown build or without
        a ``step_runner``; ``warmup.prewarm`` counts it and goes on."""
        from .warmup import sig_from_json
        kind = entry.get("build")
        if kind not in ("train", "eval", "train_scaled"):
            raise ValueError(f"unknown captured_step build {kind!r}")
        n_ins = int(entry.get("n_ins", 1))
        batch = entry.get("batch", [])
        sig = entry.get("sig")
        wrapped = [False] * len(batch)
        if sig is not None:
            # the signature's parts after the first five are
            # (shape, dtype, device, wrapped) of each batch array
            per = sig_from_json(sig)[5:5 + len(batch)]
            wrapped = [bool(p[3]) for p in per]
        dev = self._device()
        vals = []
        for (shape, dtype), w in zip(batch, wrapped):
            t = torch.zeros(tuple(shape), dtype=getattr(torch, dtype),
                            device=dev)
            vals.append(Tensor(t) if w else t)
        ins, lbls = vals[:n_ins], vals[n_ins:]
        drive = self.step_runner
        if drive is None:
            raise ValueError(f"CapturedStep({self._name}) has no step runner: "
                             f"its owner's step runs a prewarm")
        restore = self._snapshot()
        try:
            for _ in range(2):     # the first sighting, then the capture
                drive(kind, ins, lbls)
        finally:
            restore()
        _flight.record("warmup", "captured_step", fn=self._name, kind=kind)

    def _snapshot(self) -> Callable[[], None]:
        """Copies of the state a step moves; the function returned puts
        them back in place (addresses kept: a graph holds them)."""
        from ..core import random as rnd
        leaves = list(self._params.values()) + list(self._buffers.values())
        saved = [t.detach().clone() for t in leaves]
        modes = [lyr.training for lyr in self._sublayers]
        rng = rnd.get_rng_state()
        draws = rnd._draws
        opt = self._opt if self.optimizer is not None else None
        opt_saved = None
        if opt is not None:
            lr_dev = getattr(opt, "_fused_lr_dev", None)
            sched = opt._learning_rate
            opt_saved = (
                {i: {k: v.detach().clone() for k, v in st.items()}
                 for i, st in opt._states.items()},
                opt._global_step,
                None if lr_dev is None else
                (lr_dev, lr_dev.clone(), opt._fused_lr_host),
                sched.state_dict() if hasattr(sched, "state_dict") else None)
        scaler = self.scaler
        sc_saved = None
        if scaler is not None:
            sc_saved = ([t.clone() for t in scaler.capture_carry()],
                        scaler._found_inf, set(scaler._unscaled_opts))

        @torch.no_grad()
        def restore():
            for t, s0 in zip(leaves, saved):
                t.copy_(s0)
                t.grad = None
            for lyr, m in zip(self._sublayers, modes):
                lyr.training = m
            rnd.set_rng_state(rng)
            rnd._draws = draws
            if opt_saved is not None:
                states, gstep, lr, sched_state = opt_saved
                for i, st in opt._states.items():
                    want = states.get(i)
                    if want is None:   # made by the prewarm: back to init
                        want = opt._init_state(opt._parameter_list[i])
                    for k, v in st.items():
                        v.copy_(want[k])
                opt._global_step = gstep
                if lr is not None:
                    lr[0].copy_(lr[1])
                    opt._fused_lr_host = lr[2]
                if sched_state is not None:
                    opt._learning_rate.set_state_dict(sched_state)
            if sc_saved is not None:
                for t, s0 in zip(scaler.capture_carry(), sc_saved[0]):
                    t.copy_(s0)
                scaler._found_inf = sc_saved[1]
                scaler._unscaled_opts = sc_saved[2]
        return restore

    def graphs(self) -> Dict[str, int]:
        """Live captured graphs by kind."""
        out: Dict[str, int] = {}
        for e in self._cache.values():
            if isinstance(e, _Graph):
                out[e.kind] = out.get(e.kind, 0) + 1
        return out


# ---------------------------------------------------------------------------
# capture_jit: a whole-step function (the serving bodies) as CUDA graphs
# ---------------------------------------------------------------------------

class CaptureGroup:
    """The CUDA graphs of one owner (a serving engine): one capture
    stream, one memory pool their graphs share, and the
    :func:`capture_jit` programs that capture into it. Graphs of one
    group replay one after another on the caller's stream, never at the
    same time, and a program clones the outputs it returns, so a later
    graph reusing an earlier one's freed scratch in the shared pool
    cannot reach what a caller holds."""

    def __init__(self):
        self.programs: List["CapturedProgram"] = []
        self._stream = None
        self._pool = None

    def stream(self, dev: torch.device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        return self._stream

    def pool(self):
        """The shared pool: a new handle when no graph of the old one is
        alive (a pool whose last graph went cannot take a capture)."""
        if self._pool is None or not self.graphs():
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def graphs(self) -> int:
        return sum(len(p._graphs) for p in self.programs)

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in the group's pool (0
        without a live graph)."""
        if self._pool is None or not self.graphs():
            return 0
        want = tuple(self._pool)
        return sum(seg.get("total_size", 0)
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id") or ()) == want)

    def stats(self) -> Dict[str, Any]:
        """Totals (``replayed_launches``: the kernel launches the replays
        made, by the counters' ``.launches``) and, by program name, the
        replays, captures and what the replays added to each counter
        (``replayed``: ``"wrapper.attribute" -> n``)."""
        out: Dict[str, Any] = {"graphs": self.graphs(), "captures": 0,
                               "replays": 0, "eager": 0, "fallbacks": 0,
                               "capture_failures": 0,
                               "capture_seconds": 0.0,
                               "replayed_launches": 0, "by_program": {}}
        for p in self.programs:
            for k in ("captures", "replays", "eager", "fallbacks",
                      "capture_failures", "capture_seconds"):
                out[k] += p.stats[k]
            mine = out["by_program"].setdefault(
                p.name, {"replays": 0, "captures": 0, "replayed": {}})
            mine["replays"] += p.stats["replays"]
            mine["captures"] += p.stats["captures"]
            for k, n in p.stats["replayed"].items():
                mine["replayed"][k] = mine["replayed"].get(k, 0) + n
                if k.endswith(".launches"):
                    out["replayed_launches"] += n
        return out


class _ProgramGraph:
    """One captured signature: the graph, its static input buffers, the
    addresses of the tensors it uses in place, how to rebuild its
    outputs and the launch counts a replay adds (by counter, and by
    ``"wrapper.attribute"``)."""
    __slots__ = ("graph", "static", "ptrs", "outs", "out_tree", "counts",
                 "named")


def _leaf_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class CapturedProgram:
    """The callable :func:`capture_jit` returns; see there."""

    def __init__(self, fn: Callable, donate_argnums=(), name=None,
                 warm=None, group=None):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self._warm = warm
        self._inplace = set(donate_argnums)
        self._group = group if group is not None else CaptureGroup()
        self._group.programs.append(self)
        self._graphs: Dict[tuple, _ProgramGraph] = {}
        self._seen: set = set()     # signatures whose first call ran
        self._noted: set = set()    # ... and whose first call succeeded
        self.stats: Dict[str, Any] = {
            "calls": 0, "replays": 0, "captures": 0, "eager": 0,
            "fallbacks": 0, "capture_failures": 0, "capture_seconds": 0.0,
            "replayed": {}}

    # -- arguments ---------------------------------------------------------
    def _flatten(self, args):
        """Leaves of ``args`` with, for each, whether it is used in
        place (a tensor of a donated argument), and the tree."""
        from torch.utils import _pytree as pytree
        leaves: List[Any] = []
        inplace: List[bool] = []
        specs = []
        for i, a in enumerate(args):
            ls, spec = pytree.tree_flatten(a)
            leaves += ls
            inplace += [i in self._inplace] * len(ls)
            specs.append(spec)
        return leaves, inplace, tuple(specs)

    @staticmethod
    def _device(leaves, inplace) -> torch.device:
        for pick in (True, False):
            for x, ip in zip(leaves, inplace):
                if ip == pick and isinstance(x, torch.Tensor):
                    if pick or x.device.type == "cuda":
                        return x.device
        return torch.device("cpu")

    def _signature(self, leaves, inplace, tree):
        sig: List[Any] = [tree]
        ptrs = []
        for x, ip in zip(leaves, inplace):
            if ip:
                if not isinstance(x, torch.Tensor):
                    raise TypeError(f"capture_jit({self.name}): a donated "
                                    f"argument holds a "
                                    f"{type(x).__name__}, not a tensor")
                sig.append((x.shape, x.dtype, x.device))
                ptrs.append(x.data_ptr())
            else:
                t = _leaf_tensor(x)
                sig.append((t.shape, t.dtype))
        return tuple(sig), tuple(ptrs)

    @staticmethod
    def _unflatten(vals, tree) -> list:
        """The arguments back from their leaves and per-argument trees."""
        from torch.utils import _pytree as pytree
        out, i = [], 0
        for spec in tree:
            out.append(pytree.tree_unflatten(vals[i:i + spec.num_leaves],
                                             spec))
            i += spec.num_leaves
        return out

    def _eager_args(self, leaves, inplace, tree, dev):
        vals = [x if ip else _leaf_tensor(x).to(dev, non_blocking=True)
                for x, ip in zip(leaves, inplace)]
        return self._unflatten(vals, tree)

    # -- accounting --------------------------------------------------------
    def _first_success(self, sig, args, captured: bool) -> None:
        """A signature's first successful call: the ``capture_compile``
        flight event where it captured, and the warm-bundle note
        (``warm`` called on the arguments when it is callable)."""
        if sig in self._noted:
            return
        self._noted.add(sig)
        if captured:
            _flight.record("sot", "capture_compile", fn=self.name)
        if self._warm is not None:
            from .warmup import note_program
            meta = self._warm(*args) if callable(self._warm) \
                else self._warm
            note_program("serving", self.name, {"meta": dict(meta)})

    # -- capture -----------------------------------------------------------
    def _capture(self, leaves, inplace, tree, ptrs, dev) -> _ProgramGraph:
        from torch.utils import _pytree as pytree
        group = self._group
        stream = group.stream(dev)
        pool = group.pool()
        e = _ProgramGraph()
        e.static = [torch.empty_like(_leaf_tensor(x), device=dev)
                    for x, ip in zip(leaves, inplace) if not ip]
        it = iter(e.static)
        vals = [x if ip else next(it) for x, ip in zip(leaves, inplace)]
        targs = self._unflatten(vals, tree)
        donated = {id(x): j for j, (x, ip)
                   in enumerate(zip(leaves, inplace)) if ip}
        e.graph = torch.cuda.CUDAGraph()
        before = _counters.snapshot()
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        # a graph that the collector frees during the capture would
        # release its pool there, which the capture forbids: collect
        # first, and not during it
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.no_grad(), torch.cuda.stream(stream):
                e.graph.capture_begin(pool=pool,
                                      capture_error_mode="thread_local")
                try:
                    out = self._fn(*targs)
                finally:
                    e.graph.capture_end()
        finally:
            if gc_was_on:
                gc.enable()
            e.counts = _counters.delta(before, _counters.snapshot())
            _counters.restore(before)
            cur.wait_stream(stream)
        e.named = tuple((f"{fn.__name__}.{attr}", n)
                        for (fn, attr), n in e.counts.items())
        out_leaves, e.out_tree = pytree.tree_flatten(out)
        # an output that IS an argument used in place (a pool the body
        # returns) is handed back as the caller's tensor; the rest are
        # the graph's buffers, cloned on every return
        e.outs = [("arg", donated[id(o)]) if id(o) in donated
                  else ("own", o) for o in out_leaves]
        e.ptrs = ptrs
        self.stats["capture_seconds"] += time.perf_counter() - t0
        self.stats["captures"] += 1
        _M_step_compiles.inc()
        _note_break("capture", "program", self.name)
        return e

    def _replay(self, e: _ProgramGraph, leaves, inplace):
        from torch.utils import _pytree as pytree
        it = iter(e.static)
        for x, ip in zip(leaves, inplace):
            if not ip:
                next(it).copy_(_leaf_tensor(x), non_blocking=True)
        e.graph.replay()
        _counters.advance(e.counts)
        self.stats["replays"] += 1
        rep = self.stats["replayed"]
        for k, n in e.named:
            rep[k] = rep.get(k, 0) + n
        outs = [leaves[v] if kind == "arg"
                else (v.clone() if isinstance(v, torch.Tensor) else v)
                for kind, v in e.outs]
        return pytree.tree_unflatten(outs, e.out_tree)

    def __call__(self, *args):
        leaves, inplace, tree = self._flatten(args)
        dev = self._device(leaves, inplace)
        if not _capture_flag.value:
            # the kill switch: the body runs op by op, nothing counted
            return self._fn(*self._eager_args(leaves, inplace, tree, dev))
        self.stats["calls"] += 1
        sig, ptrs = self._signature(leaves, inplace, tree)
        if dev.type != "cuda":
            out = self._fn(*self._eager_args(leaves, inplace, tree, dev))
            if sig in self._seen:
                self.stats["fallbacks"] += 1
                _count_fallback("device", self.name)
            else:
                self._seen.add(sig)
                self.stats["eager"] += 1
            self._first_success(sig, args, False)
            return out
        _M_captured.inc()
        e = self._graphs.get(sig)
        if e is not None and e.ptrs == ptrs:
            return self._replay(e, leaves, inplace)
        out = None
        if sig not in self._seen:
            # first sighting: run op by op on the capture stream (kernel
            # libraries, cuBLAS workspaces and the K3 tickets of that
            # stream come up outside the graph), then capture
            self._seen.add(sig)
            self.stats["eager"] += 1
            stream = self._group.stream(dev)
            cur = torch.cuda.current_stream(dev)
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                out = self._fn(*self._eager_args(leaves, inplace, tree,
                                                 dev))
            cur.wait_stream(stream)
        self._graphs.pop(sig, None)     # stale addresses: never replayed
        try:
            e = self._capture(leaves, inplace, tree, ptrs, dev)
        except BaseException:
            # a cut capture is never stored, so never replayed; the
            # next call of the signature captures again
            self.stats["capture_failures"] += 1
            raise
        self._graphs[sig] = e
        self._first_success(sig, args, True)
        if out is None:
            out = self._replay(e, leaves, inplace)
        return out


def capture_jit(fn, donate_argnums=(), name: Optional[str] = None,
                warm=None, *, group: Optional[CaptureGroup] = None):
    """A whole-step function (the serving bodies) as one CUDA graph per
    input signature — the port's counterpart of the JAX package's
    ``capture_jit`` (``jax.jit`` + SOT capture accounting).

    - ``fn`` must be a pure device program over its arguments: shapes
      fixed by the signature, no host read, no host-to-device copy.
    - The tensors of the arguments in ``donate_argnums`` are used in
      place, where they live (the caches and pools a body writes, and
      the weights it reads); their addresses join the signature's
      entry, and a changed storage captures the signature anew (a stale
      graph is never replayed). Every other leaf (a tensor, array or
      scalar: the small per-step inputs) is copied into the graph's
      static buffer before a replay.
    - The signature is the argument tree with each leaf's shape and
      dtype (and device, for the tensors used in place).
    - On the card, a signature's first call runs ``fn`` op by op on the
      group's capture stream and then captures it (thread-local capture
      mode: the server's other threads issue CUDA work beside it); later
      calls copy the small inputs and replay. The kernel launch
      counters advance by what the capture recorded
      (``ops.kernels.counters``). An output that is an argument used in
      place comes back as that argument; every other output is a clone
      of the graph's buffer. A capture that fails raises (counted in
      ``stats["capture_failures"]``); its graph is never stored, so a
      capture a fault cut never replays, and the signature's next call
      captures again. It never runs op by op quietly.
    - Accounting as in the JAX package, where one program stands for
      one signature: every call on the card counts into
      ``sot.captured_steps_total``, each signature's first successful
      capture records the ``sot.capture_compile`` flight event and, with
      ``warm``, ``jit.warmup.note_program("serving", name, {"meta":
      warm})`` (``warm`` a dict, or a function of the call's arguments
      that returns one); each captured graph counts into
      ``sot.captured_compiles_total``. The replays' launches are kept
      by counter in ``stats["replayed"]``.
    - On the CPU ``fn`` runs op by op: the first call of a signature
      counts as eager, later ones as fallbacks of reason ``"device"``
      (as ``CapturedStep`` counts them); the warm-bundle note is kept.
    - ``FLAGS_sot_capture=0`` runs ``fn`` op by op and counts nothing
      (the JAX kill switch mutes only the accounting: its program is
      one executable either way).
    - ``group`` (a :class:`CaptureGroup`) shares one capture stream and
      one memory pool between the programs of one owner."""
    return CapturedProgram(fn, donate_argnums, name, warm, group)


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
