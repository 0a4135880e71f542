"""Fleet serving: N replica processes behind one router.

The port of ``paddle_tpu.serving_fleet``. Each replica process runs a
supervised ``GenerationServer`` over a paged engine on the card; a
:class:`FleetRouter` places continuous-batching traffic across them,
fails over when one dies mid-decode and resurrects it.

Wire protocol — the JAX package's, byte for byte, so a port router
drives JAX replicas and the reverse: a 4-byte big-endian length, then a
UTF-8 JSON object, over a local TCP socket. Ops: ``submit`` / ``poll``
(stream delta) / ``cancel`` / ``health`` / ``stats`` / ``cache_stats`` /
``prepare_swap`` / ``retain_params`` / ``swap_weights`` / ``generate`` /
``shutdown``. :class:`ReplicaServer` serves a ``GenerationServer`` (real
or a test fake) and :func:`replica_main` is the child-process entry
point (``python -m paddle_tpu_torch.serving_fleet``): it boots one from
a model and a warm bundle and prints ONE JSON boot line (port, pid,
executable-cache counters, pre-warm counts) for the parent to read.

The router's contract is the JAX package's:

* **Placement**: ``policy="pressure"`` ranks replicas by their last
  heartbeat's gauges (admission pressure level, free KV blocks, backlog);
  ``"rr"`` is round-robin. When EVERY live replica is at pressure level
  3 the fleet sheds with :class:`FleetSaturated` and a ``retry_after``.
* **Failover**: a heartbeat stall or a data-plane connection death
  FENCES the replica (its epoch moves on; poll answers stamped with the
  old epoch are dropped and counted as ``stale_drops``) and its
  in-flight requests are re-dispatched with ``prompt + committed`` as
  their prompt: greedy streams continue as if nothing happened. A
  request active at ``quarantine_after`` deaths is failed as poison.
* **Resurrection**: the dead replica is relaunched through its
  ``spawn`` callable under bounded full-jitter backoff; after
  ``max_restarts`` failures the fleet degrades to the survivors. A
  relaunched replica shares the executable cache (the kernel library
  directory) and the warm bundle, so it runs no ``nvcc``.

Where the port differs from the JAX package:

* **Shutdown.** ``ReplicaServer.kill`` shuts the listener and every
  connection down (``shutdown(SHUT_RDWR)``) before closing them: a bare
  ``close()`` does not wake a thread blocked in ``accept()`` on Linux.
  Every thread this module starts — accept, per-connection, pollers,
  monitor, resurrection — ends within a bounded join in ``close``,
  ``kill`` or ``shutdown``.
* **Device.** A replica config takes ``device``: ``"cuda"`` unless it
  says ``"cpu"``; :func:`launch_replica` sets nothing that sends the
  child to the CPU.
* **Path and boot.** The child finds the package from any working
  directory (the repo root goes on ``PYTHONPATH``), writes nothing to
  stdout but its boot line, and a child that dies before booting raises
  with the tail of its stderr.
* **Model kinds.** ``tiny_llama`` draws its weights from a seeded
  ``torch.Generator`` (identical across the fleet, not the JAX weights
  of that seed); ``inference_model`` loads a ``.pdmodel``.
* **bf16 over the wire.** A bf16 tensor travels as its int16 bit
  pattern with ``"dtype": "bfloat16"`` beside the npy (numpy has no
  bf16 on the card's machine), and comes back bit-exact; f32 and
  integer arrays keep the JAX npy encoding, and the JAX package's bf16
  npy (an unnamed 2-byte void dtype) is read as bf16.
* **Kernel counters.** The ``stats`` reply carries the replica's K3
  counters and its engine calls under ``k3``.
* **The kill site** ``fleet.apply.r<i>`` counts only polls that brought
  tokens (the JAX poller also counts empty ones, which puts a seeded
  kill before the first token of a long prefill).
* **Boot seconds.** The boot line carries ``seconds``: from the
  parent's launch to the line.

Chaos hooks: every data connection threads through
``fault_injection.FlakyTransport`` (sites ``fleet.rpc.r<i>``,
``fleet.hb.r<i>``) and the poller calls
``fault_injection.kill_pid("fleet.apply.r<i>", pid)`` after each token
application, so a test SIGKILLs a replica at an exact stream position.
"""
from __future__ import annotations

import base64
import io
import itertools
import json
import os
import select
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.flags import flag_value
from .observability import flight as _flight
from .observability import metrics as _om
from .utils import backoff as _backoff
from .utils import fault_injection as _fi

__all__ = ["FleetRouter", "ReplicaServer", "ReplicaClient",
           "ReplicaHandle", "RemotePrepared", "FleetSaturated",
           "health_snapshot", "replica_main", "launch_replica",
           "spawn_fleet"]

_F = _om.scope("fleet")
_M_dispatched = _F.counter("dispatched_total",
                           "Requests placed on a replica by the router")
_M_redispatched = _F.counter(
    "redispatched_total",
    "Failovers: in-flight requests re-dispatched after a replica death")
_M_quarantined = _F.counter(
    "quarantined_total",
    "Poison requests failed fleet-wide after repeated replica deaths")
_M_shed = _F.counter("shed_total",
                     "Submissions shed because every live replica was "
                     "at pressure level 3")
_M_stale = _F.counter("stale_drops_total",
                      "Zombie-epoch replica responses discarded by the "
                      "router's fence")
_M_deaths = _F.counter("replica_deaths_total",
                       "Replica fencings (heartbeat stall or connection "
                       "death)")
_M_resurrected = _F.counter("resurrections_total",
                            "Dead replicas successfully relaunched")
_M_degraded = _F.counter("degraded_total",
                         "Replicas abandoned after max_restarts failed "
                         "relaunches")
_M_healthy = _F.gauge("replicas_healthy",
                      "Live replicas the router will place traffic on")

_FLEET_SEQ = itertools.count(1)
_TOKEN_SEQ = itertools.count(1)
_CONFIG_ENV = "PADDLE_TPU_REPLICA_CONFIG"
_LAUNCH_ENV = "PADDLE_TPU_REPLICA_LAUNCHED"  # the parent's time.time()
_JOIN_SECONDS = 2.0     # the bound on each thread join of a shutdown
_REPO_ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _shutdown_close(sock: socket.socket) -> None:
    """Shut a socket down, then close it: the shutdown wakes a thread
    blocked in its ``accept()`` or ``recv()``, which ``close()`` alone
    does not."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class FrameConn:
    """One length-prefixed-JSON connection: ``send(obj)``/``recv()``
    move whole frames; framing errors surface as ConnectionError so
    every caller handles a half-dead socket the same way."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._rlock = threading.Lock()
        self._wlock = threading.Lock()

    def send(self, obj) -> None:
        blob = json.dumps(obj, default=str).encode()
        with self._wlock:
            self._sock.sendall(struct.pack(">I", len(blob)) + blob)

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            buf += chunk
        return buf

    def recv(self):
        with self._rlock:
            n = struct.unpack(">I", self._read_exact(4))[0]
            if n > (1 << 30):
                raise ConnectionError(f"oversized frame ({n} bytes)")
            return json.loads(self._read_exact(n).decode())

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        _shutdown_close(self._sock)


def _connect(host: str, port: int, timeout: float = 5.0,
             site: Optional[str] = None):
    s = socket.create_connection((host, port), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    # every fleet connection threads through the chaos wrapper: one
    # dict lookup per frame when unarmed
    return _fi.FlakyTransport(FrameConn(s), site or "fleet.rpc")


# ---------------------------------------------------------------------------
# readiness — one source of truth for /healthz and the heartbeat RPC
# ---------------------------------------------------------------------------

def health_snapshot(server) -> dict:
    """Readiness + placement evidence for one ``GenerationServer``
    (duck-typed). ``ok`` means "will productively take traffic": decode
    loop alive, supervisor not given up, not draining, admission below
    hard shed."""
    thread = getattr(server, "_thread", None)
    loop_alive = bool(thread is not None and thread.is_alive()
                      and not getattr(server, "_crashed", False))
    sup = getattr(server, "_supervisor", None)
    gave_up = bool(getattr(sup, "gave_up", False))
    level = int(getattr(server.policy, "level", 0))
    paged = bool(getattr(server, "_paged", False))
    if paged:
        kv = server.engine._kv
        blocks_free, blocks_total = int(kv.available_blocks()), \
            int(kv.num_blocks)
    else:
        blocks_free = blocks_total = -1  # dense engine: no pool gauge
    backlog = int(server._q.qsize() + len(server._waiting))
    draining = bool(server._stopping.is_set())
    ok = loop_alive and not gave_up and not draining and level < 3
    return {"ok": ok, "loop_alive": loop_alive, "gave_up": gave_up,
            "level": level, "blocks_free": blocks_free,
            "blocks_total": blocks_total, "backlog": backlog,
            "in_flight": len(server._slots),
            "draining": draining, "pid": os.getpid()}


# ---------------------------------------------------------------------------
# replica side
# ---------------------------------------------------------------------------

def _npy(a: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _encode_array(a) -> dict:
    """A tensor or array as the wire's npy record; bf16 as its int16 bit
    pattern with ``"dtype": "bfloat16"`` beside it."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return {"npy": _npy(t.view(torch.int16).numpy()),
                    "dtype": "bfloat16"}
        a = t.numpy()
    return {"npy": _npy(np.asarray(a))}


def _decode_array(d) -> torch.Tensor:
    """The wire's npy record as a CPU tensor. A bf16 record — the port's
    (int16 bits + ``dtype``) or the JAX package's (a 2-byte void npy,
    what numpy writes for its bf16 extension dtype) — comes back as the
    same bf16 bits."""
    a = np.load(io.BytesIO(base64.b64decode(d["npy"])), allow_pickle=False)
    if d.get("dtype") == "bfloat16" or (a.dtype.kind == "V"
                                         and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _err_payload(e: BaseException) -> dict:
    return {"type": type(e).__name__, "msg": str(e)}


def _rebuild_error(d: Optional[dict]) -> Optional[BaseException]:
    if not d:
        return None
    kind = {"TimeoutError": TimeoutError,
            "ValueError": ValueError}.get(d.get("type"), RuntimeError)
    return kind(f"[replica {d.get('type')}] {d.get('msg')}")


def _k3_counts(server) -> dict:
    """The replica's K3 counters (launches of both designs, of the split
    design, of its tensor-core path), its engine's layers and the engine
    calls whose attention went through the seam (decode steps, prefill
    chunks, spec steps and pre-warm runs, kernel or plain)."""
    from .ops.kernels.paged_attention import paged_attention_kernel as pak
    from .serving import _M_pa_fallback, _M_pa_kernel
    return {"launches": int(pak.launches),
            "split_launches": int(pak.split_launches),
            "mma_launches": int(pak.mma_launches),
            "layers": int(getattr(server.engine, "n_layers", 0)),
            "engine_calls": int(_M_pa_kernel.value()
                                + _M_pa_fallback.value())}


class ReplicaServer:
    """Serve one ``GenerationServer`` over the fleet RPC. Used by
    :func:`replica_main` inside child processes and in-thread over fakes
    or CPU engines in tests: the framing, request table and op handlers
    are the same in both.

    ``kill()`` shuts the listener and every live connection down without
    draining anything — the in-process simulation of a SIGKILL, leaving
    the wrapped server running as a zombie the router must fence — and
    joins every thread this object started (bounded)."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        self.server = server
        self._reqs: Dict[str, dict] = {}   # rid -> live request dict
        self._prepared: Dict[str, object] = {}  # token -> weight tree
        self._reqs_order: List[str] = []   # FIFO bound on the table
        self._lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                  1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"fleet-replica-{self.port}")
        self._accept_thread.start()

    # -- socket plumbing ----------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener shut down
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._stop.is_set():
                    _shutdown_close(sock)
                    return
                self._conns.append(sock)
                t = threading.Thread(target=self._serve_conn, args=(sock,),
                                     daemon=True,
                                     name=f"fleet-conn-{self.port}")
                self._threads.append(t)
            t.start()

    def _serve_conn(self, sock: socket.socket) -> None:
        conn = FrameConn(sock)
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv()
                except (ConnectionError, OSError, ValueError):
                    return
                try:
                    reply = self._handle(msg)
                except Exception as e:  # noqa: BLE001 — surfaced per op
                    reply = {"ok": False, "error": _err_payload(e)}
                try:
                    conn.send(reply)
                except (ConnectionError, OSError):
                    return
                if msg.get("op") == "shutdown":
                    # after the reply: drain, then drop every socket
                    self.close(drain=bool(msg.get("drain", True)))
                    return
        finally:
            with self._lock:
                if sock in self._conns:
                    self._conns.remove(sock)
                me = threading.current_thread()
                if me in self._threads:
                    self._threads.remove(me)
            _shutdown_close(sock)

    def kill(self) -> None:
        """Simulated process death: every socket dies NOW, nothing
        drains, the wrapped server becomes an unreachable zombie. The
        accept and connection threads are joined (bounded)."""
        with self._lock:
            self._stop.set()
            conns, self._conns = self._conns, []
            threads = [self._accept_thread] + list(self._threads)
        _shutdown_close(self._listener)
        for s in conns:
            _shutdown_close(s)
        me = threading.current_thread()
        for t in threads:
            if t is not me:
                t.join(_JOIN_SECONDS)

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful stop: drain the wrapped server (its supervisor, if
        any, detached after the drain), then drop every socket."""
        try:
            self.server.shutdown(drain=drain, timeout=timeout)
            sup = getattr(self.server, "_supervisor", None)
            if sup is not None:
                sup.stop(timeout=_JOIN_SECONDS)
        finally:
            self.kill()

    # -- ops ----------------------------------------------------------------
    def _remember(self, req: dict) -> None:
        with self._lock:
            rid = req["trace_id"]
            self._reqs[rid] = req
            self._reqs_order.append(rid)
            # bound the table: evict the oldest FINISHED entries only (a
            # live stream must stay pollable)
            while len(self._reqs_order) > 4096:
                old = self._reqs_order[0]
                got = self._reqs.get(old)
                if got is not None and not got["done"].is_set():
                    break
                self._reqs_order.pop(0)
                self._reqs.pop(old, None)

    def _handle(self, msg: dict) -> dict:
        op = msg.get("op")
        srv = self.server
        if op == "submit":
            try:
                req = srv.submit(np.asarray(msg["prompt"], np.int32),
                                 int(msg["max_new"]),
                                 deadline=msg.get("deadline"))
            except RuntimeError as e:
                reason = "shed" if "admission" in str(e) else \
                    "shutting_down"
                return {"ok": False, "reason": reason,
                        "error": _err_payload(e)}
            self._remember(req)
            return {"ok": True, "rid": req["trace_id"]}
        if op == "poll":
            with self._lock:
                req = self._reqs.get(msg["rid"])
            if req is None:
                return {"ok": False, "reason": "unknown_rid"}
            since = int(msg.get("since", 0))
            err = req["error"] if req["done"].is_set() else None
            return {"ok": True,
                    "tokens": [int(t) for t in req["out"][since:]],
                    "done": req["done"].is_set(),
                    "error": _err_payload(err) if err else None}
        if op == "cancel":
            with self._lock:
                req = self._reqs.get(msg["rid"])
            if req is None:
                return {"ok": False, "reason": "unknown_rid"}
            if req["done"].is_set():
                return {"ok": True, "already_done": True}
            # a queued request dies here; an ACTIVE one finishes its
            # stream (a step cannot be abandoned mid-slot)
            active = any(r is req for r in srv._slots.values()) \
                or any(r is req for r in srv._prefilling.values())
            if active:
                return {"ok": False, "reason": "active"}
            srv._fail(req, RuntimeError("cancelled by the fleet router"))
            return {"ok": True}
        if op == "health":
            return {"ok": True, "health": health_snapshot(srv)}
        if op == "stats":
            group = getattr(srv.engine, "_graphs", None)
            return {"ok": True, "stats": srv.stats(),
                    "k3": _k3_counts(srv),
                    "graphs": group.stats() if group is not None else {}}
        if op == "cache_stats":
            from .jit import warmup as _warmup
            return {"ok": True, "cache": _warmup.cache_stats()}
        if op == "generate":
            toks = srv.generate(np.asarray(msg["prompt"], np.int32),
                                int(msg["max_new"]),
                                timeout=float(msg.get("timeout", 300.0)))
            return {"ok": True, "tokens": [int(t) for t in toks]}
        if op == "prepare_swap":
            from .serving_supervisor import _count_nonfinite
            sd = {k: _decode_array(v) for k, v in msg["state"].items()}
            prepared = srv.engine.prepare_swap(sd)
            bad = _count_nonfinite(prepared)
            token = f"prep-{next(_TOKEN_SEQ)}"
            with self._lock:
                self._prepared[token] = prepared
            return {"ok": True, "token": token, "nonfinite": int(bad)}
        if op == "retain_params":
            token = f"prep-{next(_TOKEN_SEQ)}"
            with self._lock:
                self._prepared[token] = srv.engine.params
            return {"ok": True, "token": token}
        if op == "swap_weights":
            with self._lock:
                prepared = self._prepared.get(msg["prepared"])
            if prepared is None:
                return {"ok": False, "reason": "unknown_token"}
            res = srv.swap_weights(prepared=prepared)
            return {"ok": True, "result": res}
        if op == "shutdown":
            return {"ok": True}  # the connection thread closes after it
        return {"ok": False, "reason": f"unknown op {op!r}"}


def _replica_model(spec: dict, device):
    kind = spec.get("kind", "tiny_llama")
    if kind == "tiny_llama":
        from .core.device import resolve_device
        from .models.llama import LlamaConfig, LlamaForCausalLM
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(
            int(spec.get("seed", 0)))
        return LlamaForCausalLM(LlamaConfig.tiny(**spec.get("config", {})),
                                device=dev, generator=gen)
    if kind == "inference_model":
        from .inference import load_inference_model
        return load_inference_model(spec["path"], device=device)
    raise ValueError(f"unknown model kind {kind!r}")


def replica_main(config: dict, boot_out=None) -> None:
    """Child-process entry point: boot a supervised ``GenerationServer``
    from ``config`` and serve the fleet RPC until shutdown.

    config keys: ``model`` ({"kind": "tiny_llama", "config": {...},
    "seed": n} builds a seeded Llama — identical weights fleet-wide
    without a checkpoint; {"kind": "inference_model", "path": p} loads a
    ``.pdmodel``), ``device`` (default ``"cuda"``), engine geometry
    (``max_slots``/``max_seq``/``block_size``/``prefill_chunk``/
    ``eos_id``, ``int8`` for the s8 projections),
    ``warm_bundle`` (pre-warm before the first admission), ``prime`` /
    ``prime_tokens`` (one short generation before serving, e.g. before
    ``export_bundle``), ``export_bundle`` (a path), ``supervised``,
    ``host``/``port`` (0 = ephemeral), ``metrics_port``.

    Writes exactly ONE JSON boot line to ``boot_out`` (default stdout) —
    ``{"ok": true, "port": p, "pid": n, "device": d, "cache": {hits,
    misses, writes}[, "prewarm": {...}][, "seconds": s]}`` — the
    parent's readiness signal and the evidence of a warm boot
    (``cache.misses == 0``); ``seconds`` runs from the parent's launch
    (:func:`launch_replica`) to the line."""
    from .core.flags import flag_value as _flag
    from .jit import warmup as _warmup
    from .serving import GenerationServer, PagedLlamaDecodeEngine

    _warmup.ensure_executable_cache()
    device = config.get("device", "cuda")
    model = _replica_model(config.get("model") or {}, device)
    engine = PagedLlamaDecodeEngine(
        model,
        max_slots=int(config.get("max_slots", 2)),
        max_seq=int(config.get("max_seq", 128)),
        block_size=int(config.get("block_size",
                                  _flag("serving_block_size"))),
        prefill_chunk=int(config.get("prefill_chunk",
                                     _flag("serving_prefill_chunk"))),
        int8=bool(config.get("int8", False)),
        eos_id=config.get("eos_id"), device=device)
    prewarm = None
    bundle = config.get("warm_bundle") or None
    if bundle:
        prewarm = _warmup.prewarm(bundle, engine=engine)
    prime = config.get("prime")
    if prime:
        # run the serving programs before taking traffic (and before an
        # export_bundle snapshot): one short generation
        engine.generate(np.asarray(prime, np.int32),
                        max_new_tokens=int(config.get("prime_tokens", 4)))
        engine.reset_state()
    export = config.get("export_bundle")
    if export:
        _warmup.export_bundle(export)
    server = GenerationServer(engine)
    if config.get("supervised", True):
        from .serving_supervisor import supervise
        server._supervisor = supervise(server)
    if config.get("metrics_port") is not None:
        server.metrics_endpoint(port=int(config["metrics_port"]))
    rs = ReplicaServer(server, host=config.get("host", "127.0.0.1"),
                       port=int(config.get("port", 0)))
    boot = {"ok": True, "port": rs.port, "pid": os.getpid(),
            "device": str(engine.device), "cache": _warmup.cache_stats()}
    launched = os.environ.get(_LAUNCH_ENV)
    if launched:
        boot["seconds"] = time.time() - float(launched)
    if prewarm is not None:
        boot["prewarm"] = prewarm
    out = boot_out or sys.stdout
    out.write(json.dumps(boot) + "\n")
    out.flush()
    # serve until the shutdown op (close() sets _stop) or SIGKILL
    rs._stop.wait()


def _boot_failed(proc, msg: str):
    """Kill a child that did not boot and raise with its stderr tail."""
    if proc.poll() is None:
        proc.kill()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        pass
    log = proc.stderr_log
    log.seek(0, os.SEEK_END)
    log.seek(max(0, log.tell() - 4000))
    tail = log.read().decode("utf-8", "replace")
    log.close()
    proc.stdout.close()
    raise RuntimeError(f"{msg} (rc={proc.returncode}); stderr tail:\n{tail}")


def _start_replica(config: dict, env: Optional[dict]):
    """Spawn a replica child (``python -m paddle_tpu_torch.serving_fleet``,
    config in its environment) with the repo root on its PYTHONPATH and
    its stderr in an unnamed temporary file (``proc.stderr_log``)."""
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    path = [str(_REPO_ROOT)]
    if child_env.get("PYTHONPATH"):
        path.append(child_env["PYTHONPATH"])
    child_env["PYTHONPATH"] = os.pathsep.join(path)
    child_env[_CONFIG_ENV] = json.dumps(config)
    child_env[_LAUNCH_ENV] = repr(time.time())
    log = tempfile.TemporaryFile()
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving_fleet"],
            env=child_env, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=log)
    except BaseException:
        log.close()
        raise
    proc.stderr_log = log
    return proc


def _await_boot(proc, timeout: float) -> Tuple[int, dict]:
    """Read the child's boot line (bounded by ``timeout``)."""
    deadline = time.monotonic() + timeout
    fd = proc.stdout.fileno()
    buf = b""
    while b"\n" not in buf:
        left = deadline - time.monotonic()
        if left <= 0:
            _boot_failed(proc, f"no replica boot line within {timeout}s")
        ready, _, _ = select.select([fd], [], [], min(left, 0.5))
        if ready:
            chunk = os.read(fd, 65536)
            if not chunk:
                _boot_failed(proc, "replica died before boot")
            buf += chunk
        elif proc.poll() is not None:
            _boot_failed(proc, "replica died before boot")
    line = buf.split(b"\n", 1)[0].decode("utf-8", "replace")
    try:
        boot = json.loads(line)
    except ValueError:
        _boot_failed(proc, f"bad replica boot line {line!r}")
    if not isinstance(boot, dict) or not boot.get("ok"):
        _boot_failed(proc, f"bad replica boot line {line!r}")
    proc.stdout.close()
    return int(boot["port"]), boot


def launch_replica(config: dict, env: Optional[dict] = None,
                   timeout: float = 300.0):
    """Spawn one replica subprocess and block (at most ``timeout``) for
    its boot line. Returns ``(proc, port, boot)``; a child that dies or
    stays silent raises with the tail of its stderr."""
    proc = _start_replica(config, env)
    port, boot = _await_boot(proc, timeout)
    return proc, port, boot


def _reap(proc, timeout: float) -> None:
    """Wait for a child (kill it after ``timeout``) and close its log."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=_JOIN_SECONDS)
    log = getattr(proc, "stderr_log", None)
    if log is not None:
        log.close()


# ---------------------------------------------------------------------------
# router side
# ---------------------------------------------------------------------------

class FleetSaturated(RuntimeError):
    """Every live replica is at pressure level 3 (or dead): the fleet
    sheds instead of queueing onto a brownout. ``retry_after`` is the
    client hint in seconds."""

    def __init__(self, msg: str, retry_after: float):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class ReplicaHandle:
    """Router-side view of one replica: address, data connection,
    heartbeat state, and the FENCING EPOCH — every dispatch stamps
    ``(idx, epoch)`` on the request, and responses only apply while the
    stamp still matches. ``boot`` is the child's boot line, when the
    handle came from :func:`launch_replica`."""

    def __init__(self, idx: int, host: str, port: int,
                 pid: Optional[int] = None, proc=None,
                 spawn: Optional[Callable[[int], "ReplicaHandle"]]
                 = None, kill_cb: Optional[Callable[[], None]] = None,
                 boot: Optional[dict] = None):
        self.idx = int(idx)
        self.host, self.port = host, int(port)
        self.pid = pid
        self.proc = proc          # subprocess.Popen, when we own it
        self.spawn = spawn        # resurrection factory
        self.kill_cb = kill_cb    # in-proc kill (tests)
        self.boot = boot
        self.epoch = 0
        self.alive = True
        self.degraded = False     # max_restarts exhausted
        self.health: Optional[dict] = None
        self.misses = 0
        self.restarts = 0
        self.dispatched = 0
        self._conn = None
        self._io_lock = threading.Lock()

    def conn(self):
        if self._conn is None:
            self._conn = _connect(self.host, self.port,
                                  site=f"fleet.rpc.r{self.idx}")
            self._conn.settimeout(10.0)
        return self._conn

    def call(self, msg: dict) -> dict:
        """One request/response over the shared data connection."""
        with self._io_lock:
            conn = self.conn()
            try:
                conn.send(msg)
                return conn.recv()
            except (ConnectionError, OSError, socket.timeout):
                self.drop_conn()
                raise

    def drop_conn(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def probe_health(self, timeout: float) -> dict:
        """Heartbeat on a DEDICATED short-timeout connection: a data
        socket wedged behind a long op must not read as a dead replica,
        and a dead replica must not wedge the monitor."""
        conn = _connect(self.host, self.port, timeout=timeout,
                        site=f"fleet.hb.r{self.idx}")
        try:
            conn.settimeout(timeout)
            conn.send({"op": "health"})
            reply = conn.recv()
        finally:
            conn.close()
        if not reply.get("ok"):
            raise ConnectionError(f"health op rejected: {reply}")
        return reply["health"]


class FleetRouter:
    """Place continuous-batching traffic across N replicas; survive any
    of them dying. See the module docstring for the contract.

    ``replicas``: list of :class:`ReplicaHandle`. ``policy``:
    ``"pressure"`` (default — KV-pressure-aware placement from heartbeat
    gauges) or ``"rr"`` (round-robin)."""

    def __init__(self, replicas: List[ReplicaHandle], *,
                 policy: str = "pressure",
                 heartbeat_seconds: Optional[float] = None,
                 heartbeat_misses: Optional[int] = None,
                 quarantine_after: int = 2,
                 restart_backoff: Optional[float] = None,
                 restart_backoff_cap: float = 2.0,
                 max_restarts: Optional[int] = None,
                 retry_after: Optional[float] = None,
                 poll_interval: float = 0.005):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.replicas = list(replicas)
        self.policy = str(policy)
        self.heartbeat_seconds = float(
            flag_value("serving_fleet_heartbeat_seconds")
            if heartbeat_seconds is None else heartbeat_seconds)
        self.heartbeat_misses = int(
            flag_value("serving_fleet_heartbeat_misses")
            if heartbeat_misses is None else heartbeat_misses)
        self.quarantine_after = max(int(quarantine_after), 1)
        self.restart_backoff = float(
            flag_value("serving_fleet_restart_backoff")
            if restart_backoff is None else restart_backoff)
        self.restart_backoff_cap = float(restart_backoff_cap)
        self.max_restarts = int(
            flag_value("serving_fleet_max_restarts")
            if max_restarts is None else max_restarts)
        self.retry_after = float(
            flag_value("serving_fleet_retry_after")
            if retry_after is None else retry_after)
        self.poll_interval = float(poll_interval)
        self._lock = threading.Lock()
        self._inflight: Dict[str, dict] = {}
        self._parked: List[dict] = []   # awaiting a live replica
        self._rr_next = 0
        self._stop = threading.Event()
        self.shed = 0
        self.failovers = 0
        self.quarantined = 0
        self.stale_drops = 0
        self.finished = 0
        self.failed = 0
        self._threads = [
            threading.Thread(target=self._poll_loop, args=(h,),
                             daemon=True, name=f"fleet-poll-{h.idx}")
            for h in self.replicas]
        self._threads.append(threading.Thread(
            target=self._monitor, daemon=True, name="fleet-monitor"))
        for t in self._threads:
            t.start()
        _M_healthy.set(len(self.replicas))
        _flight.record("fleet", "router_up",
                       replicas=len(self.replicas), policy=self.policy)

    # -- submission ---------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               deadline: Optional[float] = None) -> dict:
        """Fleet submit: returns a request dict with the surface of
        ``GenerationServer.submit`` (``out``/``done``/``error``/
        ``trace_id``, ``t0`` and, once tokens arrive, ``t_first``) plus
        fleet bookkeeping; a failed-over request also records
        ``t_failover`` and ``t_resume`` (its first token after it).
        Raises :class:`FleetSaturated` (with ``retry_after``) when every
        live replica is at pressure level 3."""
        prompt = [int(t) for t in
                  np.asarray(prompt_ids, np.int32).reshape(-1)]
        req = {"prompt": prompt, "max_new": int(max_new_tokens),
               "out": [], "done": threading.Event(), "error": None,
               "trace_id": f"fleet-{os.getpid()}-{next(_FLEET_SEQ)}",
               "t0": time.monotonic(), "deadline": deadline,
               "strikes": 0, "owner": None, "rid": None, "base": 0,
               "terminal": False}
        _flight.record("fleet", "submit", trace_id=req["trace_id"],
                       max_new=req["max_new"])
        self._dispatch(req, exclude=())
        if isinstance(req["error"], FleetSaturated):
            raise req["error"]  # surfaced like GenerationServer's shed
        return req

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 timeout: float = 300.0) -> List[int]:
        req = self.submit(prompt_ids, max_new_tokens)
        if not req["done"].wait(timeout):
            raise TimeoutError("fleet generation timed out")
        if req["error"] is not None:
            raise req["error"]
        return list(req["out"])

    # -- placement ----------------------------------------------------------
    def _live(self) -> List[ReplicaHandle]:
        return [h for h in self.replicas if h.alive and not h.degraded]

    def _pick(self, exclude: Tuple[int, ...]) -> Optional[ReplicaHandle]:
        """Choose the placement target, or None when nothing can take
        the request (=> shed/park)."""
        live = [h for h in self._live() if h.idx not in exclude]
        if not live:
            return None
        candidates = [h for h in live
                      if (h.health or {}).get("level", 0) < 3]
        if not candidates:
            return None  # everyone at hard shed: fleet-level shed
        if self.policy == "rr":
            ordered = sorted(candidates, key=lambda h: h.idx)
            pick = ordered[self._rr_next % len(ordered)]
            self._rr_next += 1
            return pick
        return min(candidates, key=self._pressure_key)

    def _pressure_key(self, h: ReplicaHandle):
        """Lowest admission pressure level first, then the most free KV
        blocks (fractional), then the shortest backlog, then the least
        loaded. A replica that has not heartbeat yet sorts as unknown
        but willing."""
        snap = h.health or {}
        level = int(snap.get("level", 0))
        total = snap.get("blocks_total", -1)
        free = snap.get("blocks_free", -1)
        free_frac = (free / total) if total and total > 0 else 0.5
        backlog = int(snap.get("backlog", 0)) \
            + int(snap.get("in_flight", 0))
        return (level, -free_frac, backlog, h.dispatched)

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, req: dict, exclude: Tuple[int, ...]) -> None:
        """Place ``req`` (fresh or failed-over) on a replica. The wire
        prompt is prompt + committed tokens and the wire budget the
        REMAINING tokens: decoding is causal in the whole sequence, so a
        re-dispatched greedy stream continues as before."""
        tried = list(exclude)
        while True:
            with self._lock:
                h = self._pick(tuple(tried))
            if h is None:
                self._no_replica(req, tried)
                return
            wire_prompt = req["prompt"] + [int(t) for t in req["out"]]
            wire_budget = req["max_new"] - len(req["out"])
            if wire_budget <= 0:   # failover raced completion
                self._finish(req)
                return
            try:
                reply = h.call({"op": "submit", "prompt": wire_prompt,
                                "max_new": wire_budget,
                                "deadline": req["deadline"]})
            except (ConnectionError, OSError, socket.timeout):
                self._replica_down(h, reason="dispatch_conn")
                tried.append(h.idx)
                continue
            if not reply.get("ok"):
                if reply.get("reason") == "shed":
                    # the replica's admission disagreed with our stale
                    # gauge: respect it and try the next-best replica
                    tried.append(h.idx)
                    continue
                self._fail(req, _rebuild_error(reply.get("error"))
                           or RuntimeError(f"replica rejected: {reply}"))
                return
            with self._lock:
                req["owner"] = (h.idx, h.epoch)
                req["rid"] = reply["rid"]
                # the replica's stream counts from ITS admission: polls
                # rebase by what was committed at dispatch
                req["base"] = len(req["out"])
                self._inflight[req["trace_id"]] = req
                h.dispatched += 1
            _M_dispatched.inc()
            _flight.record("fleet", "dispatch",
                           trace_id=req["trace_id"], replica=h.idx,
                           epoch=h.epoch, committed=len(req["out"]))
            return

    def _no_replica(self, req: dict, tried: List[int]) -> None:
        live = self._live()
        if live:
            # live replicas exist but all are at hard shed (or just shed
            # us): fleet-level shed with the retry hint
            with self._lock:
                self.shed += 1
            _M_shed.inc()
            _flight.record("fleet", "fleet_shed",
                           trace_id=req["trace_id"],
                           retry_after=self.retry_after, live=len(live))
            self._fail(req, FleetSaturated(
                f"every live replica is at admission pressure level 3 "
                f"— retry after {self.retry_after}s",
                self.retry_after), count_shed=True)
            return
        if any(not h.degraded for h in self.replicas):
            # dead replicas are being resurrected: park; the monitor
            # re-dispatches when one rejoins
            with self._lock:
                req["owner"] = None
                self._parked.append(req)
            _flight.record("fleet", "parked", trace_id=req["trace_id"])
            return
        self._fail(req, RuntimeError(
            "fleet degraded: every replica exhausted max_restarts"))

    # -- completion ---------------------------------------------------------
    def _finish(self, req: dict) -> None:
        with self._lock:
            if req["terminal"]:
                return
            req["terminal"] = True
            self._inflight.pop(req["trace_id"], None)
            self.finished += 1
        _flight.record("fleet", "finished", trace_id=req["trace_id"],
                       tokens=len(req["out"]))
        req["done"].set()

    def _fail(self, req: dict, error: BaseException,
              count_shed: bool = False) -> None:
        with self._lock:
            if req["terminal"]:
                return
            req["terminal"] = True
            self._inflight.pop(req["trace_id"], None)
            if not count_shed:
                self.failed += 1
        req["error"] = error
        _flight.record("fleet", "shed" if count_shed else "failed",
                       trace_id=req["trace_id"],
                       error=type(error).__name__, tokens=len(req["out"]))
        req["done"].set()

    # -- polling ------------------------------------------------------------
    def _owned_by(self, h: ReplicaHandle) -> List[dict]:
        with self._lock:
            return [r for r in self._inflight.values()
                    if r["owner"] == (h.idx, h.epoch)]

    def _poll_loop(self, h: ReplicaHandle) -> None:
        while not self._stop.is_set():
            if not h.alive or h.degraded:
                self._stop.wait(self.poll_interval * 4)
                continue
            work = self._owned_by(h)
            if not work:
                self._stop.wait(self.poll_interval)
                continue
            for req in work:
                owner = req["owner"]
                since = max(len(req["out"]) - req.get("base", 0), 0)
                try:
                    reply = h.call({"op": "poll", "rid": req["rid"],
                                    "since": since})
                except (ConnectionError, OSError, socket.timeout):
                    self._replica_down(h, reason="poll_conn")
                    break
                if not reply.get("ok"):
                    continue  # unknown rid: a re-dispatch owns it now
                self._apply(req, owner, h, reply.get("tokens") or [],
                            bool(reply.get("done")), reply.get("error"))
            self._stop.wait(self.poll_interval)

    def _apply(self, req: dict, owner, h: ReplicaHandle,
               tokens: List[int], done: bool, error) -> None:
        """Fold one poll response into the fleet stream — IFF the
        dispatch stamp still matches the replica's current epoch. A
        response from a fenced (zombie) epoch is dropped: the request
        has been re-dispatched."""
        with self._lock:
            if req["terminal"]:
                return
            if owner != (h.idx, h.epoch) or req["owner"] != owner:
                self.stale_drops += 1
                _M_stale.inc()
                _flight.record("fleet", "stale_drop",
                               trace_id=req["trace_id"], replica=h.idx,
                               stamped=list(owner) if owner else None,
                               current=h.epoch)
                return
            if tokens:
                req["out"].extend(int(t) for t in tokens)
                now = time.monotonic()
                req.setdefault("t_first", now)
                if "t_failover" in req:
                    req.setdefault("t_resume", now)
        # deterministic chaos trigger: a test arms fleet.apply.r<idx> to
        # SIGKILL the replica at an exact stream position (a poll that
        # brought no token is not an application)
        if h.pid and tokens:
            _fi.kill_pid(f"fleet.apply.r{h.idx}", h.pid)
        if done:
            err = _rebuild_error(error)
            if err is not None:
                self._fail(req, err)
            else:
                self._finish(req)

    # -- monitor / failover -------------------------------------------------
    def _monitor(self) -> None:
        while not self._stop.wait(self.heartbeat_seconds):
            for h in list(self.replicas):
                if h.degraded or not h.alive:
                    continue
                try:
                    snap = h.probe_health(
                        timeout=max(self.heartbeat_seconds, 0.1))
                except (ConnectionError, OSError, socket.timeout,
                        ValueError):
                    h.misses += 1
                    if h.misses >= self.heartbeat_misses:
                        self._replica_down(h, reason="heartbeat")
                    continue
                h.misses = 0
                h.health = snap
                if snap.get("gave_up"):
                    # the supervisor exhausted ITS restarts: the process
                    # is up but refusing work — replace it
                    self._replica_down(h, reason="gave_up")
            self._retry_parked()
            _M_healthy.set(len(self._live()))

    def _retry_parked(self) -> None:
        with self._lock:
            parked, self._parked = self._parked, []
        for req in parked:
            if req["terminal"]:
                continue
            self._dispatch(req, exclude=())

    def _replica_down(self, h: ReplicaHandle, reason: str) -> None:
        """Fence ``h`` and fail its work over. Idempotent per epoch:
        poller and monitor may both notice the same death."""
        with self._lock:
            if not h.alive or self._stop.is_set():
                return  # already fenced, or the router is shutting down
            h.alive = False
            h.epoch += 1   # the fence: in-flight stamps are now stale
            h.health = None
            victims = [r for r in self._inflight.values()
                       if r["owner"] and r["owner"][0] == h.idx]
        h.drop_conn()
        _M_deaths.inc()
        _flight.record("fleet", "replica_dead", replica=h.idx,
                       reason=reason, epoch=h.epoch, victims=len(victims))
        for req in victims:
            req["strikes"] += 1
            if req["strikes"] >= self.quarantine_after:
                with self._lock:
                    self.quarantined += 1
                _M_quarantined.inc()
                _flight.record("fleet", "quarantined",
                               trace_id=req["trace_id"],
                               strikes=req["strikes"])
                self._fail(req, RuntimeError(
                    f"request quarantined as poison: active at "
                    f"{req['strikes']} consecutive replica deaths"))
                continue
            with self._lock:
                self.failovers += 1
                req.setdefault("t_failover", time.monotonic())
            _M_redispatched.inc()
            _flight.record("fleet", "failover",
                           trace_id=req["trace_id"], from_replica=h.idx,
                           committed=len(req["out"]),
                           strikes=req["strikes"])
            self._dispatch(req, exclude=(h.idx,))
        _M_healthy.set(len(self._live()))
        if h.spawn is not None and not self._stop.is_set():
            t = threading.Thread(target=self._resurrect, args=(h,),
                                 daemon=True,
                                 name=f"fleet-resurrect-{h.idx}")
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _resurrect(self, h: ReplicaHandle) -> None:
        """Relaunch a dead replica under bounded full-jitter backoff.
        ``max_restarts`` failures degrade to the surviving fleet —
        journaled, counted, and never an exception out of this thread."""
        if h.proc is not None:
            _reap(h.proc, timeout=10)  # the SIGKILLed child
        attempt = 0
        while not self._stop.is_set():
            attempt += 1
            if attempt > self.max_restarts:
                h.degraded = True
                _M_degraded.inc()
                _flight.record("fleet", "degraded", replica=h.idx,
                               restarts=attempt - 1)
                return
            delay = _backoff.full_jitter(
                min(self.restart_backoff * (2 ** (attempt - 1)),
                    self.restart_backoff_cap))
            if self._stop.wait(delay):
                return
            _flight.record("fleet", "resurrect_attempt", replica=h.idx,
                           attempt=attempt)
            try:
                fresh = h.spawn(h.idx)
            except Exception as e:  # noqa: BLE001 — retried, bounded
                _flight.record("fleet", "resurrect_failed", replica=h.idx,
                               attempt=attempt, error=type(e).__name__)
                continue
            if self._stop.is_set():
                _dispose(fresh)   # the router shut down meanwhile
                return
            with self._lock:
                h.host, h.port = fresh.host, fresh.port
                h.pid, h.proc = fresh.pid, fresh.proc
                h.kill_cb, h.boot = fresh.kill_cb, fresh.boot
                h.misses = 0
                h.health = None
                h.restarts += attempt
                h.alive = True
            _M_resurrected.inc()
            _flight.record("fleet", "resurrected", replica=h.idx,
                           attempt=attempt, pid=h.pid)
            self._retry_parked()
            return

    # -- admin --------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            inflight = len(self._inflight)
            parked = len(self._parked)
        return {"replicas": len(self.replicas),
                "live": len(self._live()),
                "in_flight": inflight, "parked": parked,
                "finished": self.finished, "failed": self.failed,
                "shed": self.shed, "failovers": self.failovers,
                "quarantined": self.quarantined,
                "stale_drops": self.stale_drops,
                "restarts": sum(h.restarts for h in self.replicas),
                "degraded": sum(int(h.degraded)
                                for h in self.replicas)}

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the router and every replica it reaches (the RPC
        shutdown op, then the child process is waited for — killed after
        ``timeout`` — and reaped), join the router's threads (bounded)
        and fail every request still in flight or parked, so that no
        caller waits on a stopped fleet."""
        self._stop.set()
        for h in self.replicas:
            _dispose(h, drain=drain, timeout=timeout)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(_JOIN_SECONDS, self.heartbeat_seconds + 1.0))
        with self._lock:
            left = list(self._inflight.values()) + self._parked
            self._parked = []
        for req in left:
            self._fail(req, RuntimeError("the fleet router shut down"))
        _flight.record("fleet", "router_down", **self.stats())


def _dispose(h: ReplicaHandle, drain: bool = False,
             timeout: float = 30.0) -> None:
    """Send ``h`` the shutdown op, drop its connection and reap its
    child process (killed after ``timeout``)."""
    try:
        h.call({"op": "shutdown", "drain": drain})
    except (ConnectionError, OSError, socket.timeout):
        pass
    h.drop_conn()
    if h.proc is not None:
        _reap(h.proc, timeout)


# ---------------------------------------------------------------------------
# rollout over RPC
# ---------------------------------------------------------------------------

class RemotePrepared:
    """Opaque handle to a prepared weight tree living ON the replica.
    ``nonfinite`` carries the replica-side scan, so the supervisor's
    ``_count_nonfinite`` never walks a token string."""

    __slots__ = ("token", "nonfinite")

    def __init__(self, token: str, nonfinite: int = 0):
        self.token = token
        self.nonfinite = int(nonfinite)


class _RemoteEngine:
    """The ``srv.engine`` duck type ``rollout()`` touches, over RPC."""

    def __init__(self, client: "ReplicaClient"):
        self._c = client

    def prepare_swap(self, state_dict) -> RemotePrepared:
        state = {str(k): _encode_array(v) for k, v in state_dict.items()}
        reply = self._c._call({"op": "prepare_swap", "state": state})
        return RemotePrepared(reply["token"], reply["nonfinite"])

    @property
    def params(self) -> RemotePrepared:
        """The retained rollback tree — kept replica-side, referenced by
        token (finite: it was serving traffic)."""
        reply = self._c._call({"op": "retain_params"})
        return RemotePrepared(reply["token"], 0)


class ReplicaClient:
    """A ``rollout()``-compatible handle for ONE remote replica:
    ``.engine.prepare_swap``/``.engine.params``, ``.generate`` and
    ``.swap_weights(prepared=)`` all run over the fleet RPC."""

    def __init__(self, host: str, port: int, timeout: float = 300.0):
        self.host, self.port = host, int(port)
        self._timeout = float(timeout)
        self._conn = None
        self._io_lock = threading.Lock()
        self.engine = _RemoteEngine(self)

    def _call(self, msg: dict) -> dict:
        with self._io_lock:
            if self._conn is None:
                self._conn = _connect(self.host, self.port,
                                      site="fleet.rollout")
                self._conn.settimeout(self._timeout)
            self._conn.send(msg)
            reply = self._conn.recv()
        if not reply.get("ok"):
            err = _rebuild_error(reply.get("error"))
            raise err if err is not None else RuntimeError(
                f"replica op {msg.get('op')!r} failed: {reply}")
        return reply

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 timeout: float = 300.0) -> List[int]:
        reply = self._call({"op": "generate",
                            "prompt": [int(t) for t in prompt_ids],
                            "max_new": int(max_new_tokens),
                            "timeout": float(timeout)})
        return list(reply["tokens"])

    def swap_weights(self, checkpoint_or_state=None, *,
                     prepared: Optional[RemotePrepared] = None) -> dict:
        if prepared is None:
            raise ValueError(
                "ReplicaClient.swap_weights needs prepared= (a "
                "RemotePrepared from engine.prepare_swap / engine.params)")
        reply = self._call({"op": "swap_weights",
                            "prepared": prepared.token})
        return reply["result"]

    def close(self) -> None:
        with self._io_lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


# ---------------------------------------------------------------------------
# fleet bring-up
# ---------------------------------------------------------------------------

def spawn_fleet(n: int, replica_config: dict,
                env: Optional[dict] = None,
                router_kwargs: Optional[dict] = None,
                timeout: float = 300.0) -> FleetRouter:
    """Launch ``n`` replica subprocesses from one config (sharing the
    executable cache and warm bundle it names) — all started at once,
    then each boot line awaited (``timeout`` each) — and return the
    router over them, with resurrection wired to relaunch from the same
    config. A replica that fails to boot stops the others and raises."""
    def spawn(idx: int) -> ReplicaHandle:
        proc, port, boot = launch_replica(dict(replica_config), env=env,
                                          timeout=timeout)
        return ReplicaHandle(idx, "127.0.0.1", port, pid=proc.pid,
                             proc=proc, spawn=spawn, boot=boot)

    procs = [_start_replica(dict(replica_config), env)
             for _ in range(int(n))]
    handles = []
    try:
        for i, proc in enumerate(procs):
            port, boot = _await_boot(proc, timeout)
            handles.append(ReplicaHandle(i, "127.0.0.1", port,
                                         pid=proc.pid, proc=proc,
                                         spawn=spawn, boot=boot))
    except BaseException:
        for h in handles:
            _dispose(h, timeout=_JOIN_SECONDS)
        for proc in procs[len(handles) + 1:]:
            proc.kill()
            _reap(proc, _JOIN_SECONDS)
            proc.stdout.close()
        raise
    return FleetRouter(handles, **(router_kwargs or {}))


def _main() -> int:
    cfg = os.environ.get(_CONFIG_ENV)
    if not cfg and len(sys.argv) > 1:
        with open(sys.argv[1], "r") as f:
            cfg = f.read()
    if not cfg:
        print("usage: python -m paddle_tpu_torch.serving_fleet "
              "<config.json> (or PADDLE_TPU_REPLICA_CONFIG in the env)",
              file=sys.stderr)
        return 2
    # the boot line is the only thing on stdout: everything else the
    # process writes to fd 1 (prints, libraries) goes to stderr
    boot_out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    replica_main(json.loads(cfg), boot_out=boot_out)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
