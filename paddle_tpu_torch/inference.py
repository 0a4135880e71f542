"""Inference: saved model -> serving predictor, and the serving front end.

The port of ``paddle_tpu.inference``. A ``.pdmodel`` is the JAX
package's payload — ``state_dict``, ``module``, ``class_name``,
``init_config``, ``input_spec`` — written and read through the port's
``framework.io``, so a server process rebuilds the module without the
training script. A file the JAX package saved for its
``LlamaForCausalLM`` loads into the port's: the class path and the
config are mapped (``convert.llama_config_from_jax``) and the weights
go through ``convert.state_dict_from_jax``. Another JAX class, or a
file whose weights do not match the rebuilt module, raises.

:class:`Predictor` runs the model's forward under ``torch.no_grad()`` in
eval mode (the caller's per-module modes restored after each call) on
the card, or where ``Config.disable_gpu()`` / ``device=`` says; a bf16
output comes back to numpy as f32 (an exact widening). :func:`serve`
answers ``POST /run`` (micro-batched), ``POST /generate`` (the paged
engine behind a ``GenerationServer``, or with ``fleet=N`` a
``serving_fleet.FleetRouter`` over N replica processes) and ``GET
/health``.

``save_inference_model(aot=True)`` also exports the eval forward with
``torch.export`` (the counterpart of the JAX package's ``jax.export``):
a functional wrapper ``(params, buffers, *inputs)`` is exported at the
fully static ``input_spec`` shapes, so the program holds no weight (they
live once, in the payload's state dict), and the flash-attention forward
stays in it as the operator ``paddle_tpu_torch::flash_fwd``. The
payload's ``aot`` entry is ``{"format": "torch.export", "blob",
"param_keys", "buffer_keys", "buffers", "device"}`` (``buffers``: the
non-persistable ones the state dict lacks; ``device``: where it was
exported). A :class:`Predictor` over such an artifact — what
``jit.load`` serves as a ``TranslatedLayer`` when the class cannot be
imported — imports the kernel module (which registers the operator)
before ``torch.export.load`` and runs the program on the card (on the
CPU after ``Config.disable_gpu()``). An AOT payload the JAX package
wrote holds a StableHLO program, which cannot run under torch: it loads
through the class mapping where ``_JAX_MODELS`` maps its class, and
raises ``ValueError`` otherwise.

``serve(int8=True)`` runs the generation engine with per-channel int8
projections (the s8 products of ``serving.LlamaDecodeEngine``), in this
process or in every fleet replica.
"""
from __future__ import annotations

import importlib
import inspect
import io
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from . import convert as _convert
from .core.device import resolve_device
from .core.tensor import Tensor, as_torch
from .framework.checkpoint import load_checkpoint
from .framework.io import save as _save

__all__ = ["Config", "Predictor", "create_predictor", "save_inference_model",
           "load_inference_model", "serve"]

# JAX-package classes a .pdmodel may name -> (port module, class, config
# mapping)
_JAX_MODELS = {
    "paddle_tpu.models.llama.LlamaForCausalLM":
        ("paddle_tpu_torch.models.llama", "LlamaForCausalLM",
         _convert.llama_config_from_jax),
}


def _forced_eval_fwd(model, apply):
    """The forward in eval semantics, the caller's per-module modes
    restored after it."""
    def fwd(params, buffers, *args):
        mods = list(model.modules())
        snapshot = [(m, m.training) for m in mods]
        try:
            for m in mods:
                m.training = False
            out, _ = apply(params, buffers, *args)
        finally:
            for m, t in snapshot:
                m.training = t
        return out
    return fwd


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``(params, buffers, *inputs)
    -> outputs``."""

    def __init__(self, fwd):
        super().__init__()
        self._fwd = fwd

    def forward(self, params, buffers, *inputs):
        return self._fwd(params, buffers, *inputs)


def _export_aot(model, input_spec):
    """The eval forward exported with ``torch.export`` at the static
    shapes of ``input_spec``, serialized without example inputs: the
    program alone."""
    from .core.dtype import convert_dtype
    from .jit.api import functionalize
    from .ops.kernels import flash_attention  # noqa: F401 - its operator
    apply, params, buffers = functionalize(model)
    leaves = list(params.values()) + list(buffers.values())
    dev = leaves[0].device if leaves else torch.device("cpu")
    args = []
    for s in input_spec:
        if any(d is None or int(d) <= 0 for d in s.shape):
            raise ValueError(
                f"AOT export needs fully-static input shapes, got "
                f"{list(s.shape)} (use bucketing for varlen serving)")
        args.append(torch.zeros([int(d) for d in s.shape],
                                dtype=convert_dtype(s.dtype), device=dev))
    p = {k: params[k] for k in sorted(params)}
    b = {k: buffers[k] for k in sorted(buffers)}
    with torch.no_grad():
        ep = torch.export.export(_Program(_forced_eval_fwd(model, apply)),
                                 (p, b, *args))
    ep._example_inputs = None    # the weights stay out of the program
    blob = io.BytesIO()
    torch.export.save(ep, blob)
    persist = set(model.state_dict())
    return {"format": "torch.export", "blob": blob.getvalue(),
            "param_keys": sorted(params), "buffer_keys": sorted(buffers),
            "buffers": {k: v.detach() for k, v in b.items()
                        if k not in persist},
            "device": dev.type}


def save_inference_model(path: str, model, input_spec=None, aot=False):
    """Persist ``model``'s state dict and the importable factory
    (``<path>.pdmodel``) so that a serving process can rebuild it.
    ``input_spec`` (objects with ``shape`` and ``dtype``) is stored for
    consumers that pre-compile; with ``aot=True`` it fixes the exported
    program's signature (see the module docstring).

    Reconstructability is checked at save time: a model whose
    ``__init__`` needs arguments must expose them as ``.config`` —
    unless ``aot=True``, whose program serves the model without its
    class (a ResNet built by ``resnet50(...)`` has no ``.config``)."""
    cls = type(model)
    cfg = getattr(model, "config", None)
    if cfg is None and not aot:
        sig = inspect.signature(cls.__init__)
        P_ = inspect.Parameter
        required = [
            n for n, p in list(sig.parameters.items())[1:]
            if (p.kind in (P_.POSITIONAL_OR_KEYWORD, P_.POSITIONAL_ONLY,
                           P_.KEYWORD_ONLY)
                and p.default is P_.empty)
            or p.kind is P_.VAR_POSITIONAL  # e.g. Sequential(*layers)
        ]
        if required:
            raise ValueError(
                f"cannot save {cls.__qualname__} for inference: __init__ "
                f"takes {required} but the model has no .config "
                "attribute to rebuild from. Store constructor arguments "
                "on `self.config`, or save weights only via save()")
    payload = {
        "state_dict": model.state_dict(),
        "module": cls.__module__,
        "class_name": cls.__qualname__,
        "init_config": _class_free(cfg) if aot else cfg,
        "input_spec": [
            {"shape": list(s.shape), "dtype": str(s.dtype)}
            for s in (input_spec or [])
        ],
    }
    if aot:
        if not input_spec:
            raise ValueError(
                "save_inference_model(aot=True) needs input_spec to fix "
                "the exported program's signature")
        payload["aot"] = _export_aot(model, input_spec)
    _save(payload, path + ".pdmodel")


def _class_free(cfg):
    """A dataclass config as ``{"__dataclass__": class path, "fields":
    {...}}``: an AOT payload unpickles without importing the model's
    module (the config's class lives there)."""
    import dataclasses
    if cfg is None or not dataclasses.is_dataclass(cfg) or \
            isinstance(cfg, type):
        return cfg
    cls = type(cfg)
    return {"__dataclass__": f"{cls.__module__}.{cls.__qualname__}",
            "fields": {f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(cfg)}}


def _config_of(cfg):
    """The config object of a payload's ``init_config``."""
    if isinstance(cfg, dict) and "__dataclass__" in cfg:
        module, _, name = cfg["__dataclass__"].rpartition(".")
        return getattr(importlib.import_module(module), name)(
            **cfg["fields"])
    return cfg


def _model_class(payload):
    """(class, config, state dict) of a payload, the JAX package's
    classes mapped to the port's."""
    path = f"{payload['module']}.{payload['class_name']}"
    cfg, sd = payload["init_config"], payload["state_dict"]
    if path in _JAX_MODELS:
        module, name, map_cfg = _JAX_MODELS[path]
        cfg = map_cfg(cfg) if cfg is not None else None
        sd = _convert.state_dict_from_jax(sd)
        payload = {"module": module, "class_name": name}
    elif payload["module"].split(".")[0] == "paddle_tpu":
        raise ValueError(f"{path} (a JAX-package class) has no port "
                         f"counterpart to load into")
    cls = importlib.import_module(payload["module"])
    for part in payload["class_name"].split("."):
        cls = getattr(cls, part)
    return cls, _config_of(cfg), sd


def _construct(cls, cfg, device: torch.device):
    args = () if cfg is None else (cfg,)
    if "device" in inspect.signature(cls.__init__).parameters:
        return cls(*args, device=device)
    return cls(*args).to(device)


def load_inference_model(path: str, device=None, _payload=None):
    """Rebuild the module from a ``save_inference_model`` artifact of
    either package, on ``device`` (default: the card), in eval mode.
    The weights keep the file's dtype (a bf16-saved model serves in
    bf16). Raises ``ValueError`` when the rebuilt module's parameters do
    not match the file — serving random weights is the worst failure."""
    dev = resolve_device(device)
    payload = _payload if _payload is not None else \
        load_checkpoint(path + ".pdmodel", device="cpu")
    cls, cfg, sd = _model_class(payload)
    floats = {v.dtype for v in sd.values()
              if isinstance(v, torch.Tensor) and v.is_floating_point()}
    if len(floats) == 1 and hasattr(cfg, "dtype"):
        import dataclasses
        name = {torch.float32: "float32",
                torch.bfloat16: "bfloat16"}.get(next(iter(floats)))
        if name is not None and dataclasses.is_dataclass(cfg):
            cfg = dataclasses.replace(cfg, dtype=name)
    model = _construct(cls, cfg, dev)
    if len(floats) == 1:
        model.to(next(iter(floats)))
    try:
        missing, unexpected = model.load_state_dict(sd, strict=False)
    except RuntimeError as e:  # a shape mismatch
        raise ValueError(f"saved model does not match the rebuilt "
                         f"{payload['class_name']}: {e}") from None
    if missing or unexpected:
        raise ValueError(
            f"saved model does not match the rebuilt "
            f"{payload['class_name']}: missing={list(missing)[:5]}, "
            f"unexpected={list(unexpected)[:5]}")
    model.eval()
    return model


class Config:
    """ref: paddle.inference.Config — the model path and run options.
    The predictor runs on the card; ``disable_gpu()`` moves it to the
    CPU. The TensorRT-era knobs are accepted and do nothing."""

    def __init__(self, model_path: Optional[str] = None):
        self.model_path = model_path
        self._bf16 = False
        self._device = None

    def enable_bf16(self):
        self._bf16 = True

    def enable_use_gpu(self, *a, **k):
        self._device = None

    def disable_gpu(self):
        self._device = "cpu"

    def enable_memory_optim(self, *a, **k):
        return None

    def switch_ir_optim(self, *a, **k):
        return None


class Predictor:
    """Serving wrapper (ref: AnalysisPredictor::Run: inputs in, outputs
    out): a saved model through a :class:`Config` — its exported program
    when the artifact carries one (``aot=True``), else the rebuilt module
    — or a live module (which stays where it is)."""

    def __init__(self, model_or_config, device=None):
        self._aot = None
        if isinstance(model_or_config, Config):
            cfg = model_or_config
            if cfg.model_path is None:
                raise ValueError(
                    "Config has no model_path; pass Config(path) pointing "
                    "at a save_inference_model artifact")
            payload = load_checkpoint(cfg.model_path + ".pdmodel",
                                      device="cpu")
            aot = payload.get("aot")
            if aot and aot.get("format") == "torch.export":
                if cfg._bf16:
                    raise ValueError(
                        "enable_bf16() cannot re-cast an AOT artifact "
                        "(its compiled signature is fixed at export); "
                        "save with a bf16 model instead")
                self._init_aot(payload, device or cfg._device)
                return
            if aot and f"{payload['module']}.{payload['class_name']}" \
                    not in _JAX_MODELS:
                raise ValueError(
                    f"{cfg.model_path}.pdmodel carries a StableHLO "
                    f"program (jax.export) for "
                    f"{payload['module']}.{payload['class_name']}, which "
                    f"cannot run under torch, and the class has no port "
                    f"counterpart; re-save it from the port with "
                    f"save_inference_model(aot=True)")
            model = load_inference_model(cfg.model_path,
                                         device=device or cfg._device,
                                         _payload=payload)
            if cfg._bf16:
                model.to(torch.bfloat16)
        else:
            model = model_or_config
        self.model = model
        p = next(iter(model.parameters()), None)
        self.device = p.device if p is not None else torch.device("cpu")

    def _init_aot(self, payload, device):
        from .ops.kernels import flash_attention  # noqa: F401 - its operator
        aot = payload["aot"]
        self.device = resolve_device(device)
        ep = torch.export.load(io.BytesIO(aot["blob"]))
        if torch.device(aot.get("device", "cpu")).type != self.device.type:
            from torch.export.passes import move_to_device_pass
            ep = move_to_device_pass(ep, self.device)
        sd, extra = payload["state_dict"], aot.get("buffers") or {}

        def leaf(v):
            return as_torch(v).to(self.device)

        self._params = {k: leaf(sd[k]) for k in aot["param_keys"]}
        self._buffers = {k: leaf(sd[k] if k in sd else extra[k])
                         for k in aot["buffer_keys"]}
        self._aot = ep.module()
        self.model = None
        self._input_spec = payload.get("input_spec", [])

    def run_tensors(self, *inputs):
        """Tensors, torch tensors or arrays -> the list of output torch
        tensors, on the predictor's device."""
        args = [(i._t if isinstance(i, Tensor) else i if isinstance(
            i, torch.Tensor) else torch.as_tensor(np.asarray(i)))
            .to(self.device) for i in inputs]
        if self._aot is not None:
            with torch.no_grad():
                out = self._aot(self._params, self._buffers, *args)
        else:
            mods = list(self.model.modules())
            modes = [m.training for m in mods]
            try:
                for m in mods:
                    m.training = False
                with torch.no_grad():
                    out = self.model(*args)
            finally:
                for m, t in zip(mods, modes):
                    m.training = t
        outs = out if isinstance(out, (tuple, list)) else [out]
        return [o._t if isinstance(o, Tensor) else o for o in outs]

    def run(self, *inputs):
        """numpy arrays or tensors -> list of numpy outputs."""
        return [(o.float() if o.dtype == torch.bfloat16 else o)
                .detach().cpu().numpy() for o in self.run_tensors(*inputs)]

    def get_input_names(self) -> Sequence[str]:
        """The names of the model forward's required positional
        arguments (``input_i`` for an exported program)."""
        if self._aot is not None:
            return [f"input_{i}" for i in range(len(self._input_spec))]
        sig = inspect.signature(self.model.forward)
        return [n for n, p in sig.parameters.items()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)]

    def predict(self, *inputs):
        return self.run(*inputs)


def create_predictor(config: Config) -> Predictor:
    """ref: paddle.inference.create_predictor."""
    return Predictor(config)


class _MicroBatcher:
    """Request micro-batching for the predictor server: concurrent
    requests arriving within a short window whose inputs share trailing
    shapes and dtypes are concatenated along axis 0, run as ONE forward
    and split back. Requests that cannot batch (another signature,
    outputs not row-aligned) run one by one. (The JAX package pads the
    batch to a power of two to bound its compiled shapes; an eager
    forward needs no padding.) ``close()`` ends its thread."""

    _STOP = object()

    def __init__(self, predictor, max_batch: int = 32,
                 window_ms: float = 2.0):
        self._p = predictor
        self.max_batch = max(int(max_batch), 1)
        self.window_s = max(float(window_ms), 0.0) / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self.batches_run = 0
        self.requests_served = 0
        self._no_batch: set = set()  # signatures whose batched run failed
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="inference-batcher")
        self._thread.start()

    def run(self, inputs):
        done = threading.Event()
        slot: dict = {}
        self._q.put((inputs, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["outs"]

    def close(self, timeout: float = 5.0) -> None:
        self._q.put(self._STOP)
        self._thread.join(timeout)

    @staticmethod
    def _sig(inputs):
        return tuple((np.asarray(a).shape[1:], str(np.asarray(a).dtype))
                     for a in inputs)

    def _loop(self):
        while True:
            first = self._q.get()
            if first is self._STOP:
                return
            batch = [first]
            stop = False
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is self._STOP:
                    stop = True
                    break
                batch.append(item)
            # no exception may kill this thread: a malformed request
            # fails alone, a failing group fails its members
            groups: dict = {}
            for item in batch:
                try:
                    groups.setdefault(self._sig(item[0]), []).append(item)
                except Exception as e:  # noqa: BLE001 — per request
                    self._fail(item, e)
            for sig, members in groups.items():
                try:
                    self._run_group(sig, members)
                except Exception as e:  # noqa: BLE001 — per group
                    for m in members:
                        self._fail(m, e)
            if stop:
                return

    @staticmethod
    def _fail(item, e):
        _, done, slot = item
        if not done.is_set():
            slot.setdefault("error", e)
            done.set()

    def _run_group(self, sig, members):
        if len(members) == 1 or sig in self._no_batch:
            for m in members:
                self._run_single(m)
            return
        try:
            rows = [int(np.asarray(m[0][0]).shape[0]) for m in members]
            total = sum(rows)
            stacked = [np.concatenate([np.asarray(m[0][i])
                                       for m in members], axis=0)
                       for i in range(len(members[0][0]))]
            outs = self._p.run(*stacked)
            if not all(np.asarray(o).shape[:1] == (total,) for o in outs):
                raise ValueError("outputs not row-aligned with inputs")
        except Exception:  # noqa: BLE001 — batching invalid here
            self._no_batch.add(sig)
            for m in members:
                self._run_single(m)
            return
        off = 0
        self.batches_run += 1
        for m, r in zip(members, rows):
            m[2]["outs"] = [np.asarray(o)[off:off + r] for o in outs]
            self.requests_served += 1
            m[1].set()
            off += r

    def _run_single(self, item):
        inputs, done, slot = item
        try:
            slot["outs"] = [np.asarray(o) for o in self._p.run(*inputs)]
            self.batches_run += 1
            self.requests_served += 1
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            slot["error"] = e
        done.set()


class _InferenceServer(ThreadingHTTPServer):
    """The HTTP server :func:`serve` returns: ``batcher``,
    ``gen_server`` and ``fleet_router`` for introspection, and a
    ``shutdown`` that stops all of it with bounded waits."""

    daemon_threads = True

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop serving HTTP, the micro-batcher, the generation server
        (and its supervisor) and the fleet router with its replicas."""
        super().shutdown()
        self.server_close()
        thread = getattr(self, "thread", None)
        if thread is not None:
            thread.join(timeout)
        self.batcher.close()
        if self.gen_server is not None:
            self.gen_server.shutdown(drain=False, timeout=timeout)
            sup = getattr(self.gen_server, "_supervisor", None)
            if sup is not None:
                sup.stop()
        if self.fleet_router is not None:
            self.fleet_router.shutdown(drain=False, timeout=timeout)


def _reply(handler, code: int, body: bytes, ctype: Optional[str] = None):
    handler.send_response(code)
    if ctype:
        handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8866,
          block: bool = True, max_batch: int = 32,
          batch_window_ms: float = 2.0, generate: bool = False,
          max_slots: int = 4, max_seq: int = 256, int8: bool = False,
          eos_id=None, speculative: bool = False,
          spec_tokens: Optional[int] = None,
          spec_draft_layers: Optional[int] = None,
          warm_bundle=None, supervised: bool = False,
          fleet: int = 0, device=None):
    """Predictor server. ``POST /run`` takes an .npz of arrays
    ``input_0..N`` and answers an .npz of ``output_0..M``; concurrent
    requests are micro-batched (``max_batch=1`` disables it). ``GET
    /health`` answers 200. Returns the server (serving on a daemon
    thread; its ``shutdown()`` stops everything) when ``block=False``.

    ``generate=True`` also serves ``POST /generate`` for causal-LM
    artifacts: an .npz with ``input_ids`` [L] and scalar
    ``max_new_tokens`` in, ``output_ids`` out. Requests share a paged
    engine's slots through a ``GenerationServer`` (continuous batching
    over a shared KV block pool). ``speculative=True`` attaches
    ``make_draft``'s truncated-layer draft (``spec_draft_layers``
    layers) proposing ``spec_tokens`` a step. ``warm_bundle`` (a path or
    a loaded bundle; default ``FLAGS_warmup_bundle``) pre-warms the
    engine before its first request. ``supervised=True`` attaches a
    ``ServingSupervisor``.

    ``fleet=N`` (N >= 2, with ``generate=True``) serves ``/generate``
    through a ``serving_fleet.FleetRouter`` over N supervised replica
    processes, which share this process's ``FLAGS_executable_cache_dir``
    and ``warm_bundle`` (so a resurrected replica runs no ``nvcc``).
    ``device`` (default: the card) is where the predictor, the engine
    and the replicas run. ``int8=True`` runs the engine's projections as
    s8 x s8 -> s32 products over per-channel int8 weights."""
    from .core.flags import flag_value
    from .jit import warmup as _warmup
    _warmup.ensure_executable_cache()
    predictor = Predictor(Config(model_path), device=device)
    gen_server = None
    fleet_router = None
    if warm_bundle is None:
        warm_bundle = flag_value("warmup_bundle") or None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/health":
                _reply(self, 200, b"ok")
            else:
                _reply(self, 404, b"")

        def do_POST(self):
            if self.path not in ("/run", "/generate"):
                _reply(self, 404, b"")
                return
            if self.path == "/generate" and gen_server is None \
                    and fleet_router is None:
                _reply(self, 404, b"serve(generate=True) not enabled")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                data = np.load(io.BytesIO(self.rfile.read(n)),
                               allow_pickle=False)
                buf = io.BytesIO()
                if self.path == "/generate":
                    ids = np.asarray(data["input_ids"]).reshape(-1)
                    mnt = int(data["max_new_tokens"]) \
                        if "max_new_tokens" in data else 32
                    toks = (fleet_router or gen_server).generate(ids, mnt)
                    np.savez(buf, output_ids=np.asarray(toks, np.int32))
                else:
                    inputs = [data[f"input_{i}"] for i in range(len(data))]
                    outs = batcher.run(inputs)
                    np.savez(buf, **{f"output_{i}": o
                                     for i, o in enumerate(outs)})
                _reply(self, 200, buf.getvalue(), "application/npz")
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                _reply(self, 500, repr(e).encode())

    # bound first (a busy port fails before anything starts); requests
    # wait in the listen backlog until serve_forever below
    server = _InferenceServer((host, port), Handler)
    batcher = _MicroBatcher(predictor, max_batch=max_batch,
                            window_ms=batch_window_ms)
    try:
        if generate and int(fleet) >= 2:
            from .serving_fleet import spawn_fleet
            fleet_router = spawn_fleet(int(fleet), {
                "model": {"kind": "inference_model",
                          "path": os.path.abspath(model_path)},
                "device": str(predictor.device.type),
                "max_slots": max_slots, "max_seq": max_seq,
                "int8": bool(int8),
                "eos_id": eos_id, "warm_bundle": warm_bundle,
                "supervised": True})
        elif generate:
            from .serving import GenerationServer, PagedLlamaDecodeEngine
            # the predictor's module serves both routes: one weight set
            engine = PagedLlamaDecodeEngine(
                predictor.model, max_slots=max_slots, max_seq=max_seq,
                int8=int8, eos_id=eos_id, device=predictor.device)
            if speculative:
                engine.attach_draft(
                    engine.make_draft(num_layers=spec_draft_layers),
                    spec_tokens=spec_tokens)
            if warm_bundle:
                _warmup.prewarm(warm_bundle, engine=engine)
            gen_server = GenerationServer(engine)
            if supervised:
                from .serving_supervisor import supervise
                gen_server._supervisor = supervise(gen_server)
    except BaseException:
        batcher.close()
        server.server_close()
        raise
    server.batcher = batcher
    server.gen_server = gen_server
    server.fleet_router = fleet_router
    server.thread = None
    if block:
        server.serve_forever()
        return None
    server.thread = threading.Thread(target=server.serve_forever,
                                     daemon=True, name="inference-http")
    server.thread.start()
    return server
