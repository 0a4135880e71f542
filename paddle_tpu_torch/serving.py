"""Generation serving: fixed-slot continuous batching over a
single-token decode step, in PyTorch on the card.

The port of ``paddle_tpu.serving``. Two cache layouts ship:

- **Dense** (:class:`LlamaDecodeEngine`): per-layer tensors
  ``[slots, max_seq, KVH, D]``, written IN PLACE each step (where the
  JAX package donates them to a jitted step).
- **Paged** (:class:`PagedLlamaDecodeEngine`, the server default): a
  shared per-layer block pool ``[num_blocks, block_size, KVH, D]`` plus
  per-slot block tables (``serving_cache.PagedKVCache``), so device
  memory scales with active tokens. Prompts prefill in CHUNKS
  interleaved with decode steps, admission matches prompts against the
  radix prefix tree, and ``kv_quant=`` stores blocks as bf16 or int8
  absmax codes. Pool writes land in place.

The engines do not call ``LlamaForCausalLM.forward``: they rebuild the
Llama math from the model's state dict as plain functions (projections
with f32 accumulation, RMSNorm cast before the weight, the per-slot
RoPE, SwiGLU with SiLU in f32). Every engine's attention — decode,
prefill chunk, the dense engine's whole-prompt prefill — goes through
the ONE ``serving_cache.paged_attention`` seam (the dense cache is
viewed as an identity-mapped block pool). On the card that seam
launches the hand-written Hopper kernel; ``attention_impl="reference"``
asks for the plain walk by name (the kernel's oracle), and
``FLAGS_paged_attention_kernel=0`` on a card engine raises rather than
switching silently. On the CPU both take the plain walk.

Each step is the JAX package's pure bodies over persistent device
buffers (``_decode_impl``, ``_prefill_impl`` over power-of-two buckets,
``_decode_collect_impl``, ``_propose_impl``, ``_spec_verify_impl``,
``_cow_impl``), each run through ``jit.sot.capture_jit`` under the JAX
program names: one CUDA graph per signature on the card, replayed with
the small per-step inputs (token ids, positions, block tables, the
active mask) copied into its static buffers; the tile counts and the
K/V write plan are made on the card, and the host reads the tokens
once a step. ``FLAGS_sot_capture=0`` runs the same bodies op by op.

The paged engine also decodes **speculatively** (``attach_draft``): a
cheap draft — typically ``make_draft``'s truncated-layer view, which
shares the target's weight tensors — proposes
``FLAGS_serving_spec_tokens`` tokens a step with its tokens kept on the
card, the target scores the whole window in ONE ``[S, k+1]`` call
(the paged-attention kernel on the tensor cores), the accepted-prefix
length is computed on the card, and ONE host read closes the window.
Rejected suffixes roll their blocks back (``PagedKVCache.truncate``);
the greedy stream equals plain stepping's. ``swap_weights`` replaces
the weights between steps (validated leaf for leaf, a sharing draft
re-pointed in the same swap), and the server applies a pending swap at
its step boundary, takes the adaptive admission policy's brownout
knobs (``_apply_brownout``) and serves its metrics over HTTP
(``metrics_endpoint``).

The server also carries the supervision seams that
``serving_supervisor.ServingSupervisor`` drives: an epoch fence that
retires a replaced loop thread (``_epoch``, ``_fenced``), a heartbeat
(``_beat``, ``_idle``), ``_start_loop`` for a restart, and the fault
site ``serving.decode`` before each decode or speculative step.

Warm bundles (``jit.warmup``): each program records itself the first
time it runs — the JAX engines' ``serving`` entries, under the same
names and with the same geometry meta — and ``_prewarm_entry`` replays
an entry at boot: its program's first call loads the kernel libraries,
runs once at the entry's shapes on an idle engine (writing nothing to
the pools) and captures the graph, so a warm replica serves its first
request from graphs. Graphs cannot be saved to a file: the bundle keeps
its format.

``export_decode`` serializes the decode step as a ``torch.export``
program (weights and caches as inputs, K3 as the operator
``paddle_tpu_torch::paged_attention``), and ``int8=True`` serves with
per-channel int8 projections (s8 x s8 -> s32 products).
"""
from __future__ import annotations

import itertools
import os
import queue as _queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import serving_cache as _sc
from .analysis.locks import make_lock
from .core.device import resolve_device
from .jit import sot as _sot
from .observability import flight as _flight
from .observability import metrics as _om
from .utils import fault_injection as _fi

__all__ = ["LlamaDecodeEngine", "PagedLlamaDecodeEngine",
           "GenerationServer"]

_M = _om.scope("serving")
_M_admitted = _M.counter("admitted_total", "Requests admitted into slots")
_M_rejected = _M.counter("rejected_total",
                         "Submissions rejected (shutting down or shed)")
_M_expired = _M.counter("deadline_expired_total",
                        "Requests failed by their deadline")
_M_failed = _M.counter("failed_total",
                       "Requests completed with an error")
_M_steps = _M.counter("steps_total", "Decode steps run by server loops")
_M_tokens = _M.counter("tokens_total", "Tokens delivered to requests")
_M_req_s = _M.histogram("request_seconds",
                        "Submit-to-completion wall time per request")
_M_token_s = _M.histogram(
    "token_seconds",
    "Per-token latency: request wall time / tokens produced")
_G_queue = _M.gauge("queue_depth",
                    "Requests waiting in the submission queue")
_G_inflight = _M.gauge("in_flight", "Requests currently holding a slot")
_M_queue_s = _M.histogram(
    "queue_seconds", "Submit-to-admission wall time per request")
_M_decode_s = _M.histogram(
    "decode_seconds",
    "Admission-to-completion wall time per request (prefill + decode)")
_M_spec_steps = _M.counter(
    "spec_steps_total", "Speculative decode steps (draft propose + "
    "one batched verify) run by engines")
_M_spec_proposed = _M.counter(
    "spec_proposed_total", "Draft tokens proposed to the target")
_M_spec_accepted = _M.counter(
    "spec_accepted_total",
    "Draft tokens the target verified and committed")
_M_spec_rolled = _M.counter(
    "spec_rolled_back_total",
    "KV blocks rolled back from rejected draft suffixes (re-credited "
    "to the slot's admission reservation)")
_M_shed = _M.counter(
    "shed_total",
    "Submissions rejected by the load-shedding policy (block pool "
    "exhausted AND the deferred list over FLAGS_serving_shed_queue, "
    "or the adaptive policy at its shed level)")
_M_deadline_rej = _M.counter(
    "admission_deadline_rejected_total",
    "Submissions rejected at submit time because the request's "
    "deadline cannot be met at the observed decode rate (adaptive "
    "admission; the request never takes KV blocks)")
_M_swaps = _M.counter(
    "weight_swaps_total",
    "Weight hot-swaps applied by server loops (between decode steps; "
    "no request dropped)")
_M_swap_rejected = _M.counter(
    "weight_swaps_rejected_total",
    "Weight hot-swaps rejected (shape/dtype/name/device mismatch "
    "against the live weights) — the old weights stay installed")
_M_swap_s = _M.histogram(
    "swap_seconds",
    "Wall seconds a weight hot-swap held the decode loop at its step "
    "boundary (validation + install)")
_M_pa_kernel = _M.counter(
    "paged_attention_kernel_steps_total",
    "Engine steps whose attention ran the Hopper paged-attention kernel")
_M_pa_fallback = _M.counter(
    "paged_attention_fallback_steps_total",
    "Engine steps whose attention ran the plain walk (CPU, or asked "
    "for by name on the card)")
_M_prefix_hits = _M.counter(
    "prefix_hits_total",
    "Paged admissions whose prompt matched a cached prefix in the "
    "radix tree (matched blocks aliased, their prefill skipped)")
_M_prefix_reused = _M.counter(
    "prefix_tokens_reused_total",
    "Prompt tokens served from shared prefix blocks instead of being "
    "re-prefilled")

# process-unique request trace ids (the flight-recorder lifecycle key)
_REQ_SEQ = itertools.count(1)

ATTENTION_IMPLS = ("kernel", "reference")


def _quantize_w(w_t):
    """Per-output-channel symmetric int8 of an ``[out, in]`` weight, on
    the weight's device: ``(codes int8 [out, in], step f32 [out])``, the
    JAX package's ``_quantize_w`` (f32 throughout, round half to even,
    so the codes and steps are bit-equal)."""
    w = w_t.float()
    step = torch.clamp(w.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / step[:, None]), -127, 127)
    return q.to(torch.int8), step


# torch._int_mm needs more than 16 rows on CUDA (and row counts that
# cuBLASLt's int8 kernels take): smaller activations are padded
_INT_MM_MIN_ROWS = 24


def _s8_matmul(qh: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``qh [M, K] int8 @ w_q[N, K]^T -> int32 [M, N]``, exact: the s8
    product the JAX package computes with ``dot_general(...,
    preferred_element_type=int32)`` outside any Pallas kernel, here one
    ``torch._int_mm`` (cuBLASLt on the card). Rows are zero-padded to
    ``_INT_MM_MIN_ROWS`` below it and cut off again."""
    M = qh.shape[0]
    if M < _INT_MM_MIN_ROWS:
        qh = F.pad(qh, (0, 0, 0, _INT_MM_MIN_ROWS - M))
    return torch._int_mm(qh, w_q.t())[:M]


class LlamaDecodeEngine:
    """Decode engine for a ``LlamaForCausalLM`` over a dense cache.

    Host-side state per slot: position, active flag, last token.
    Device-side: the weights (views of the model's tensors when dtype
    and device already match — no second copy; with ``int8=True`` the
    projections and the head as per-channel int8 codes and steps) and
    the K/V caches, updated in place.

    The step is the JAX package's pure bodies (``_decode_impl``,
    ``_prefill_impl`` over power-of-two prompt buckets,
    ``_decode_collect_impl``) over persistent device buffers, each run
    through ``jit.sot.capture_jit`` under the JAX program names: one
    CUDA graph per signature on the card, sharing the engine's
    ``CaptureGroup`` (``_graphs``); the host reads the tokens after the
    replay. The positional order is the JAX engine's; ``device``
    defaults to ``cuda`` (raises without it unless ``device="cpu"``);
    ``attention_impl`` is ``"kernel"`` (the seam's default path) or
    ``"reference"`` (the plain walk, by name).

    ``num_layers`` below the model's depth builds the TRUNCATED-LAYER
    view (first N decoder layers + the full norm and head);
    ``share_params`` (another engine's ``params``) re-binds that
    engine's tensors instead of building weights — the draft of
    speculative decoding costs no second weight set (``make_draft``)."""

    paged = False
    # the warm-bundle name of the decode program (the JAX engine's)
    _decode_name = "serving.decode"

    def __init__(self, model, max_slots: int = 4, max_seq: int = 256,
                 int8: bool = False, eos_id: Optional[int] = None,
                 num_layers: Optional[int] = None,
                 share_params: Optional[Dict[str, object]] = None,
                 device=None, attention_impl: str = "kernel"):
        cfg = model.config
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.eos_id = eos_id
        self.int8 = bool(int8)
        self.n_layers = int(num_layers or cfg.num_hidden_layers)
        if not 1 <= self.n_layers <= cfg.num_hidden_layers:
            raise ValueError(
                f"num_layers must be in [1, {cfg.num_hidden_layers}], "
                f"got {num_layers}")
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.n_rep = cfg.num_attention_heads // cfg.num_key_value_heads
        self.dtype = cfg.torch_dtype
        self.device = resolve_device(device)
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {attention_impl!r}")
        if self.device.type == "cuda" and attention_impl == "kernel" \
                and not _sc.use_kernel_default():
            raise ValueError(
                "FLAGS_paged_attention_kernel=0 on a CUDA engine: the "
                "Hopper kernel is the card's only attention path; pass "
                "attention_impl='reference' to run the plain walk by "
                "name")
        self.attention_impl = attention_impl
        self._use_kernel = attention_impl == "kernel"
        # what the per-step path counters report
        self._pa_kernel = self._use_kernel and self.device.type == "cuda"
        if share_params is not None:
            p: Dict[str, object] = dict(share_params)
            p["layers"] = list(share_params["layers"])[:self.n_layers]
            self.params = p
        else:
            self.params = self._build_params(model.state_dict())

        S = self.max_slots
        self.pos = np.zeros(S, np.int32)          # next cache index
        self.active = np.zeros(S, bool)
        self.last_ids = np.zeros((S, 1), np.int32)
        # logits behind the latest greedy tokens: [S, V] after step(),
        # [S, k+1, V] after spec_step(), [V] after a prompt's final
        # prefill
        self.last_logits: Optional[torch.Tensor] = None
        self._attend_tile = next(
            ts for ts in (128, 64, 32, 16, 8, 4, 2, 1)
            if self.max_seq % ts == 0)
        self._draft: Optional["PagedLlamaDecodeEngine"] = None
        self._spec_k = 0
        # adaptive-admission brownout knobs, set by the server at step
        # boundaries: _spec_suppressed drops speculative windows to
        # plain steps, _chunk_cap bounds the prefill chunk length
        self._spec_suppressed = False
        self._chunk_cap: Optional[int] = None
        # the CUDA graphs of this engine's programs: one capture stream,
        # one shared memory pool
        self._graphs = _sot.CaptureGroup()
        self._collect_bufs: Dict[int, torch.Tensor] = {}
        self._init_cache()

    def _program(self, fn, name, warm=None, donate=(0, 1)):
        """``fn`` through ``capture_jit`` in this engine's group, the
        arguments in ``donate`` (the weights and caches: argument 0 and
        1 unless said otherwise) used in place."""
        return _sot.capture_jit(fn, donate_argnums=donate, name=name,
                                warm=warm, group=self._graphs)

    def _build_params(self, sd) -> Dict[str, object]:
        """Device weights from the model's state dict: the port's
        projections are already ``[out, in]`` (``torch.nn.Linear``), the
        layout ``_mm`` contracts, so nothing is transposed here — and a
        tensor already in the engine's dtype and device is shared, not
        copied. With ``int8`` the seven projections of every layer and
        the head are quantized on the card (``_quantize_w``)."""
        cfg = self.cfg

        def get(name):
            try:
                v = sd[name]
            except KeyError:
                raise ValueError(
                    f"weight state dict is missing {name!r} — not a "
                    f"checkpoint of this model") from None
            return v.detach().to(device=self.device, dtype=self.dtype)

        p: Dict[str, object] = {"emb": get("llama.embed_tokens.weight"),
                                "norm": get("llama.norm.weight")}
        p["head"] = p["emb"] if cfg.tie_word_embeddings \
            else get("lm_head.weight")
        layers = []
        for i in range(self.n_layers):
            pre = f"llama.layers.{i}."
            lp = {"in_ln": get(pre + "input_layernorm.weight"),
                  "post_ln": get(pre + "post_attention_layernorm.weight")}
            for nm in ("q_proj", "k_proj", "v_proj", "o_proj"):
                lp[nm] = get(pre + "self_attn." + nm + ".weight")
            for nm in ("gate_proj", "up_proj", "down_proj"):
                lp[nm] = get(pre + "mlp." + nm + ".weight")
            if self.int8:
                for nm in ("q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"):
                    lp[nm] = _quantize_w(lp[nm])
            layers.append(lp)
        p["layers"] = layers
        if self.int8:
            p["head"] = _quantize_w(p["head"])
        return p

    @staticmethod
    def _leaf_specs(p) -> Dict[str, object]:
        """leaf name -> (shape, dtype, device) of a weight tree (int8
        ``(codes, steps)`` pairs spec both halves)."""
        def spec(v):
            if isinstance(v, tuple):
                return tuple(spec(x) for x in v)
            return (tuple(v.shape), str(v.dtype), str(v.device))

        out: Dict[str, object] = {}
        for k, v in p.items():
            if k == "layers":
                for i, lp in enumerate(v):
                    for nm, lv in lp.items():
                        out[f"layers.{i}.{nm}"] = spec(lv)
            else:
                out[k] = spec(v)
        return out

    def prepare_swap(self, state_dict):
        """Build the weight tree for a swap WITHOUT installing it (the
        host-to-device half, runnable off the decode loop's thread);
        pass the result to ``swap_weights(prepared=...)``."""
        return self._build_params(dict(state_dict))

    def swap_weights(self, state_dict=None, *, prepared=None) -> None:
        """Replace this engine's weights between decode steps:
        ``state_dict`` (model parameter names -> tensors) is prepared
        like boot-time weights (or arrives via ``prepared=``, see
        :meth:`prepare_swap`), validated leaf for leaf against the live
        tree — name, shape, dtype and device — and only then installed.
        Any mismatch raises with the old weights intact. Slot state and
        KV blocks are untouched, so in-flight requests continue on the
        new weights. An attached weight-sharing draft (``make_draft``)
        is re-pointed at the new tensors in the same swap; an
        independent draft keeps its own weights.

        The new tree is BOUND, not copied into the live tensors (a
        caller may retain the old tree to swap back: the rollout's
        rollback does): every program's graph holds the old weights'
        addresses, so its next call captures it anew on the new ones
        (``capture_jit`` never replays a graph whose donated tensors
        moved)."""
        new_p = prepared if prepared is not None \
            else self._build_params(dict(state_dict))
        old_spec, new_spec = (self._leaf_specs(self.params),
                              self._leaf_specs(new_p))
        if old_spec != new_spec:
            bad = [k for k in sorted(set(old_spec) | set(new_spec))
                   if old_spec.get(k) != new_spec.get(k)]
            raise ValueError(
                f"weight swap rejected: {len(bad)} leaf(s) with "
                f"incompatible name/shape/dtype/device (first: "
                f"{bad[:4]}) — a swap requires the checkpoint to match "
                f"the serving model's geometry exactly")
        old = self.params
        self.params = new_p
        draft = self._draft
        if draft is not None and draft.params.get("emb") is \
                old.get("emb"):
            view: Dict[str, object] = dict(new_p)
            view["layers"] = list(new_p["layers"])[:draft.n_layers]
            draft.params = view

    # -- warm bundles -------------------------------------------------------
    def _warm_geo(self) -> Dict[str, object]:
        """The serving geometry recorded beside every warm-bundle entry,
        which ``_bundle_stale`` checks a bundle against at pre-warm."""
        return {"layout": "dense", "slots": self.max_slots,
                "max_seq": self.max_seq}

    def _bundle_stale(self, meta, keys=None) -> List[str]:
        """Geometry keys on which a warm-bundle entry disagrees with this
        engine (empty = fresh). ``keys`` restricts the check to the
        geometry the program's shapes depend on; keys absent from
        ``meta`` are not checked."""
        geo = self._warm_geo()
        if keys is not None:
            geo = {k: geo[k] for k in keys if k in geo}
        return sorted(k for k, v in geo.items()
                      if k in meta and meta[k] != v)

    def _check_idle(self) -> None:
        if self.active.any():
            raise ValueError("pre-warm needs an idle engine: its programs "
                             "run on the live pools")

    def _prewarm_entry(self, entry):
        """Replay one recorded ``serving`` entry: its program's first
        call at the entry's shapes (kernel libraries loaded, the body
        run once on the capture stream, its CUDA graph captured), so the
        first request replays the graph. Returns False for an entry this
        engine does not run and ``"stale"`` for one recorded against
        another geometry. The dense engine replays its decode step; the
        rows it writes (row 0 of each slot) are zeroed again."""
        meta = entry.get("meta") or {}
        if meta.get("program") != "decode":
            return False
        if self._bundle_stale(meta):
            return "stale"
        self._check_idle()
        S = self.max_slots
        self._decode(self.params, self.k_cache, self.v_cache,
                     np.zeros((S, 1), np.int32), np.zeros(S, np.int32))
        for kc, vc in zip(self.k_cache, self.v_cache):
            kc[:, 0].zero_()
            vc[:, 0].zero_()
        self.last_logits = None
        self._count_pa_path()
        _flight.record("warmup", "serving_program", program="decode")
        return True

    def reset_state(self) -> None:
        """Discard ALL slot and cache state: the caches are zeroed IN
        PLACE (the port's caches are never donated, so a crash leaves
        them allocated) and the host bookkeeping resets; the captured
        graphs stay valid, as they hold the live caches' addresses."""
        self.pos[:] = 0
        self.active[:] = False
        self.last_ids[:] = 0
        for c in self.k_cache + self.v_cache:
            c.zero_()

    def _alloc_cache(self) -> None:
        """Allocate the dense per-layer cache tensors as zeros."""
        S, L = self.max_slots, self.n_layers
        kvh = self.cfg.num_key_value_heads
        shape = (S, self.max_seq, kvh, self.head_dim)
        self.k_cache = [torch.zeros(shape, dtype=self.dtype,
                                    device=self.device) for _ in range(L)]
        self.v_cache = [torch.zeros_like(self.k_cache[0])
                        for _ in range(L)]

    def _init_cache(self) -> None:
        """Build the DENSE cache layout and its programs (the paged
        engine overrides)."""
        self._alloc_cache()
        self._decode = self._program(
            self._decode_impl, "serving.decode",
            {"program": "decode", **self._warm_geo()}, donate=(0, 1, 2))
        self._decode_collect = None
        # one program for every bucket: a bucket is a signature
        self._prefill = self._program(self._prefill_impl, "serving.prefill",
                                      donate=(0, 1, 2))

    # -- math ---------------------------------------------------------------
    # Weights are [out, in] and contracted against their LAST dim.
    def _mm(self, h, w):
        """h @ w^T, accumulated in f32 and cast to h's dtype (on the
        card a bf16 GEMM accumulates in f32 and rounds its output).
        An int8 weight ``(codes, steps)`` takes the JAX path: dynamic
        per-tensor activation quantization, the s8 x s8 -> s32 product
        (:func:`_s8_matmul`) and the per-channel scale epilogue."""
        if isinstance(w, tuple):
            w_q, w_step = w
            hf = h.float()
            step = torch.clamp(hf.abs().amax(), min=1e-8) / 127.0
            qh = torch.clamp(torch.round(hf / step), -127, 127).to(
                torch.int8)
            acc = _s8_matmul(qh.reshape(-1, qh.shape[-1]), w_q)
            acc = acc.reshape(tuple(h.shape[:-1]) + (w_q.shape[0],))
            return (acc.float() * (w_step * step)).to(h.dtype)
        return F.linear(h, w)

    def _rms(self, h, w):
        h32 = h.float()
        var = h32.square().mean(dim=-1, keepdim=True)
        return (h32 * torch.rsqrt(var + self.cfg.rms_norm_eps)).to(
            h.dtype) * w

    def _rope_cos_sin(self, positions):
        """cos/sin ``[S, T, 1, D/2]`` at per-slot absolute positions
        (positions [S, T]) — computed once per forward and shared by
        every layer's rotation (the JAX ``_rope``'s frequencies, made on
        the card inside the program)."""
        d2 = self.head_dim // 2
        inv = 1.0 / (self.cfg.rope_theta ** (torch.arange(
            0, d2, dtype=torch.float32, device=positions.device) / d2))
        freqs = positions.float()[..., None] * inv
        return torch.cos(freqs)[:, :, None, :], \
            torch.sin(freqs)[:, :, None, :]

    def _rope(self, x, cos, sin):
        """x [S, T, Hd, D] rotated (rotate-half pairs)."""
        d2 = self.head_dim // 2
        x1, x2 = x[..., :d2], x[..., d2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    def _qkv(self, lp, x, cos, sin):
        S, T, _ = x.shape
        kvh, D = self.cfg.num_key_value_heads, self.head_dim
        q = self._mm(x, lp["q_proj"]).view(
            S, T, self.cfg.num_attention_heads, D)
        k = self._mm(x, lp["k_proj"]).view(S, T, kvh, D)
        v = self._mm(x, lp["v_proj"]).view(S, T, kvh, D)
        return self._rope(q, cos, sin), self._rope(k, cos, sin), v

    def _ffn(self, lp, h):
        x = self._rms(h, lp["post_ln"])
        gate = F.silu(self._mm(x, lp["gate_proj"]).float()).to(x.dtype)
        return h + self._mm(gate * self._mm(x, lp["up_proj"]),
                            lp["down_proj"])

    def _head(self, params, h):
        return self._mm(self._rms(h, params["norm"]), params["head"])

    def _dense_tables(self, dev) -> torch.Tensor:
        """The identity block tables of the dense cache viewed as a pool
        ``[S, max_seq / tile]`` (made inside the program, as the JAX
        ``_attend`` makes them)."""
        nb = self.max_seq // self._attend_tile
        return torch.arange(self.max_slots * nb, dtype=torch.int32,
                            device=dev).view(self.max_slots, nb)

    def _attend(self, q, kc_l, vc_l, tables, positions, n_tiles):
        """q [S', T, H, D] against the dense cache viewed as an
        identity-mapped block pool (a free leading-dim reshape): slot
        s's rows are pool blocks ``tables[s]``."""
        S, M = kc_l.shape[0], kc_l.shape[1]
        ts = self._attend_tile
        pool_shape = (S * (M // ts), ts) + tuple(kc_l.shape[2:])
        return _sc.paged_attention(
            q, kc_l.view(pool_shape), vc_l.view(pool_shape), tables,
            positions, block_size=ts, n_rep=self.n_rep, n_tiles=n_tiles,
            use_kernel=self._use_kernel)

    def _forward(self, params, k_cache, v_cache, ids, positions, slots,
                 tables, n_tiles):
        """ids [S', T] at int32 positions [S', T] of cache rows ``slots``
        [S'] -> logits [S', T, V]; each layer writes its K/V rows in
        place (every row, as the JAX ``.at[].set`` does)."""
        wslots = slots.long()[:, None].expand(positions.shape)
        wcols = positions.long()
        cos, sin = self._rope_cos_sin(positions)
        h = F.embedding(ids.long(), params["emb"]).to(self.dtype)
        for li, lp in enumerate(params["layers"]):
            kc, vc = k_cache[li], v_cache[li]
            q, k, v = self._qkv(lp, self._rms(h, lp["in_ln"]), cos, sin)
            kc.index_put_((wslots, wcols), k)
            vc.index_put_((wslots, wcols), v)
            att = self._attend(q, kc, vc, tables, positions, n_tiles)
            h = h + self._mm(att.reshape(h.shape), lp["o_proj"])
            h = self._ffn(lp, h)
        return self._head(params, h)

    # -- the programs (pure device bodies: no host read, fixed shapes) ------
    def _decode_impl(self, params, k_cache, v_cache, last_ids, pos):
        """One token for every slot: ids [S, 1], pos [S] = cache index
        to write (inactive slots write row ``pos`` of their own rows,
        which their next prefill overwrites). The walk is bounded by the
        longest history, a tile count made on the card. Returns ``(next
        int32 [S], logits [S, V], k_cache, v_cache)``."""
        ts = self._attend_tile
        n_tiles = (pos.max() // ts + 1).to(torch.int32).reshape(1)
        slots = torch.arange(pos.shape[0], device=pos.device)
        logits = self._forward(params, k_cache, v_cache, last_ids,
                               pos[:, None], slots,
                               self._dense_tables(pos.device),
                               n_tiles)[:, -1]
        return logits.argmax(dim=-1).to(torch.int32), logits, k_cache, \
            v_cache

    def _prefill_impl(self, params, k_cache, v_cache, ids, slot, true_len):
        """Prompt forward for ONE slot: ids [1, B] (bucket-padded),
        writes cache rows [0, B) of slot ``slot`` (a device scalar) and
        returns the greedy token at the last real token ``true_len - 1``
        with its logits. Rows past ``true_len`` are bucket padding:
        their outputs are never read and their rows are overwritten by
        later decode writes before a position mask lets them in."""
        B = ids.shape[1]
        dev = ids.device
        positions = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
        slots = slot.reshape(1).long()
        tables = self._dense_tables(dev).index_select(0, slots)
        n_tiles = torch.full((1,), (B - 1) // self._attend_tile + 1,
                             dtype=torch.int32, device=dev)
        logits = self._forward(params, k_cache, v_cache, ids, positions,
                               slots, tables, n_tiles)[0]
        last = logits.index_select(
            0, (true_len.long() - 1).reshape(1))[0]
        return last.argmax().to(torch.int32), last, k_cache, v_cache

    def _decode_collect_impl(self, params, k_cache, v_cache, last_ids,
                             pos, buf, i):
        """Decode step + on-device token collection (``buf [S, n]``
        donated; column ``i``, a device scalar, written in place)."""
        nxt, _, k_cache, v_cache = self._decode_impl(
            params, k_cache, v_cache, last_ids, pos)
        buf.index_copy_(1, i.reshape(1).long(), nxt[:, None].to(buf.dtype))
        return nxt, k_cache, v_cache, buf

    # -- host orchestration -------------------------------------------------
    def _count_pa_path(self, n: int = 1) -> None:
        (_M_pa_kernel if self._pa_kernel else _M_pa_fallback).inc(n)

    def _check_prompt(self, prompt_ids) -> np.ndarray:
        prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = int(prompt_ids.shape[0])
        if not 0 < n <= self.max_seq - 1:
            raise ValueError(
                f"prompt length {n} not in [1, {self.max_seq - 1}]")
        return prompt_ids

    def _bucket(self, n: int) -> int:
        """The prefill program bucket of an ``n``-token prompt or chunk:
        the next power of two from 8, at most max_seq (the JAX
        engines')."""
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def prefill(self, slot: int, prompt_ids) -> int:
        """Load a prompt into ``slot``'s cache rows through the prefill
        program at the prompt's bucket (one graph a bucket); returns the
        first generated token (greedy)."""
        prompt_ids = self._check_prompt(prompt_ids)
        n = int(prompt_ids.shape[0])
        b = self._bucket(n)
        padded = np.zeros((1, b), np.int32)
        padded[0, :n] = prompt_ids
        tok, self.last_logits, _, _ = self._prefill(
            self.params, self.k_cache, self.v_cache, padded,
            np.int64(slot), np.int32(n))
        first = int(tok)
        self._count_pa_path()
        self.pos[slot] = n
        self.active[slot] = True
        self.last_ids[slot, 0] = first
        return first

    def _check_step(self) -> None:
        act = self.pos[self.active]
        if act.size and int(act.max()) >= self.max_seq:
            raise ValueError(
                f"a decode step would write past the {self.max_seq}-"
                f"token cache (max pos {int(act.max())})")

    def step(self) -> np.ndarray:
        """One decode iteration for ALL slots; returns next token per
        slot (garbage for inactive slots — callers consult .active)."""
        self._check_step()
        nxt, self.last_logits, _, _ = self._decode(
            self.params, self.k_cache, self.v_cache, self.last_ids,
            self.pos)
        nxt = nxt.cpu().numpy()  # lint-allow: PTL001 the step's one read
        self._count_pa_path()
        for s in range(self.max_slots):
            if self.active[s]:
                self.pos[s] += 1
                self.last_ids[s, 0] = nxt[s]
        return nxt

    def _collect_buf(self, n: int) -> torch.Tensor:
        """The token buffer of an ``n``-step window, kept per ``n`` so
        the window program's graph writes the same tensor every call."""
        buf = self._collect_bufs.get(n)
        if buf is None:
            buf = self._collect_bufs[n] = torch.zeros(
                (self.max_slots, n), dtype=torch.int32, device=self.device)
        return buf

    def decode_steps(self, n: int) -> np.ndarray:
        """``n`` chained decode iterations with the tokens kept on the
        card between steps and ONE host fetch at the end. Every slot
        must be active; returns [S, n] generated tokens."""
        if not self.active.all():
            raise ValueError(
                "decode_steps advances EVERY slot; use step() when some "
                "slots are free (the continuous-batching server path)")
        self._check_window(n)
        if self._decode_collect is None:
            self._decode_collect = self._program(
                self._decode_collect_impl, "serving.decode_window",
                donate=(0, 1, 2, 5))
        buf = self._collect_buf(n)
        ids = torch.as_tensor(self.last_ids).to(self.device)
        pos = torch.as_tensor(self.pos).to(self.device)
        for i in range(n):
            nxt, _, _, _ = self._decode_collect(
                self.params, self.k_cache, self.v_cache, ids, pos, buf,
                np.int32(i))
            ids = nxt[:, None]
            pos = pos + 1
        self._count_pa_path(n)
        toks = buf.cpu().numpy()  # lint-allow: PTL001 the window's one fetch
        self.pos += n
        self.last_ids = toks[:, -1:].copy()
        return toks

    def _check_window(self, n: int) -> None:
        if int(self.pos.max()) + n > self.max_seq - 1:
            raise ValueError(
                f"decode_steps({n}) would write past the {self.max_seq}"
                f"-token cache (max pos {int(self.pos.max())})")

    def release(self, slot: int, evicted: bool = False) -> None:
        """Free ``slot`` for the next admission (``evicted`` matters
        only on the paged engine)."""
        self.active[slot] = False
        self.pos[slot] = 0

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 slot: int = 0) -> List[int]:
        """Single-request convenience path: prefill into ``slot``, then
        greedy single-token steps until eos/budget/capacity."""
        out = [self.prefill(slot, prompt_ids)]
        for _ in range(max_new_tokens - 1):
            if self.eos_id is not None and out[-1] == self.eos_id:
                break
            if self.pos[slot] >= self.max_seq - 1:
                break
            out.append(int(self.step()[slot]))
        self.release(slot)
        return out

    # -- the exported decode step -------------------------------------------
    def _export_args(self) -> tuple:
        dev = self.device
        return (self.params, self.k_cache, self.v_cache,
                torch.as_tensor(self.last_ids).to(dev),
                torch.as_tensor(self.pos).to(dev))

    def export_decode(self) -> bytes:
        """The decode step as a ``torch.export`` program, serialized to
        bytes (``torch.export.save``): the port's counterpart of the JAX
        ``jax.export`` artifact, run by any process that imports
        ``ops.kernels.paged_attention`` (for its operator) and loads the
        bytes with ``torch.export.load``. The signature is the live
        engine's, as in the JAX package: ``(params, k_cache, v_cache,
        last_ids, pos)`` here — weights and caches are INPUTS, not
        constants, so the program carries no weight bytes — and the
        paged engine's ``(params, pools, last_ids, pos, tables,
        active)``. K3 is the operator ``paddle_tpu_torch::paged_attention``
        in the graph; the cache writes are in-place nodes on the cache
        inputs (input mutations, no copy of a cache), so the loaded
        program's module writes the caches passed to it. It returns the
        next tokens ``int32 [S]``."""
        return _export_program(self._decode_impl, self._export_args())


def _export_program(body, args) -> bytes:
    """``body(*args)[0]`` exported with ``torch.export`` at the shapes of
    ``args`` and saved without example inputs: the program alone."""
    import io

    from .ops.kernels import paged_attention  # noqa: F401 - its operator

    class _Program(torch.nn.Module):
        def forward(self, *a):
            return body(*a)[0]

    with torch.no_grad():
        ep = torch.export.export(_Program(), tuple(args))
    ep._example_inputs = None    # the weights stay out of the program
    blob = io.BytesIO()
    torch.export.save(ep, blob)
    return blob.getvalue()


class PagedLlamaDecodeEngine(LlamaDecodeEngine):
    """Paged-KV decode engine: the dense engine's math over a
    **block-pool cache**.

    Layout: one shared pool per layer ``[num_blocks, block_size, KVH,
    D]`` (``serving_cache.PagedKVCache``) addressed through per-slot
    block tables. Each pool is the leading ``num_blocks`` blocks of a
    STORE with one more block, the sink that no table maps: the
    programs plan their K/V writes on the card (``kv_write_rows``) and
    send dropped rows (inactive slots, bucket padding, unmapped blocks)
    there. ``kvs`` holds the pools, ``_kv_store`` the stores the
    programs take. Admission reserves a request's worst-case block
    count (prompt + generation budget), prompt blocks are mapped at
    once, and decode extends one block at a time at step boundaries —
    extension can never fail mid-stream.

    Prefill is CHUNKED: ``begin_request`` allocates, then
    ``prefill_chunk`` runs at most ``FLAGS_serving_prefill_chunk``
    prompt tokens per call, padded to the JAX engine's bucket (the next
    power of two from 8, at most the chunk length) so that a few
    captured programs serve every chunk, writing K/V straight into the
    slot's blocks. The GenerationServer interleaves one chunk with each
    decode step.

    Programs, each through ``capture_jit`` under the JAX names: decode
    (``serving.paged_decode``), prefill (``serving.paged_prefill``: one
    graph a bucket, each noted in the warm bundle with its bucket), the
    decode window
    (``serving.paged_decode_window``), the speculative propose (the
    draft's ``k`` chained steps in one program, ``serving.spec_draft``)
    and verify (``serving.spec_verify``), and the copy-on-write
    (``serving.prefix_cow``). The host block tables reach each program
    as a small input, copied into its graph's static buffer.

    ``kv_quant``: None stores blocks in the model dtype, "bfloat16"
    halves f32 pools, "int8" stores absmax codes + per-(token, head)
    scales, dequantized by the attention as it loads each tile.

    Speculative decoding: ``attach_draft(make_draft())`` and the server
    runs :meth:`spec_step` whenever :meth:`spec_ready`.
    """

    paged = True
    _decode_name = "serving.paged_decode"
    # the process-registry prefix metrics are the target's only: an
    # attached draft mirrors every admission (attach_draft clears this)
    _prefix_metrics = True

    def __init__(self, model, max_slots: int = 4, max_seq: int = 256,
                 int8: bool = False, eos_id: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 num_layers: Optional[int] = None,
                 share_params: Optional[Dict[str, object]] = None,
                 device=None, attention_impl: str = "kernel"):
        from .core.flags import flag_value
        self.block_size = int(block_size or
                              flag_value("serving_block_size"))
        mbs = -(-int(max_seq) // self.block_size)
        auto = int(max_slots) * mbs  # dense capacity parity
        self.num_blocks = int(num_blocks or
                              flag_value("serving_num_blocks") or auto)
        if kv_quant not in (None, "bfloat16", "int8"):
            raise ValueError(
                f"kv_quant must be None, 'bfloat16' or 'int8', got "
                f"{kv_quant!r}")
        self.kv_quant = kv_quant
        self.prefill_chunk_len = int(
            prefill_chunk or flag_value("serving_prefill_chunk"))
        super().__init__(model, max_slots=max_slots, max_seq=max_seq,
                         int8=int8, eos_id=eos_id, num_layers=num_layers,
                         share_params=share_params, device=device,
                         attention_impl=attention_impl)

    def _warm_geo(self) -> Dict[str, object]:
        return {"layout": "paged", "slots": self.max_slots,
                "max_seq": self.max_seq, "block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "chunk": self.prefill_chunk_len}

    def _check_idle(self) -> None:
        if self.active.any() or self._prefill_state \
                or self._kv.occupied_slots():
            raise ValueError("pre-warm needs an idle engine: its programs "
                             "run on the live pools")

    def _prewarm_entry(self, entry):
        """Replay one recorded ``serving`` entry — decode, prefill (per
        recorded bucket) and, with a draft attached, the speculative
        propose and verify — with the JAX engine's stale rule and return
        values: False for an entry this engine does not run (a spec
        entry without a draft), ``"stale"`` for one recorded against
        another pool geometry (slots, max_seq, block size, blocks), a
        prefill bucket over the live chunk or another ``spec_k``. The
        entry's program takes its first call at the entry's shapes on
        this idle engine with every write sent to the sink block (its
        kernel libraries load, cuBLAS comes up, its CUDA graph is
        captured): pools and tables stay as they were, and the first
        request replays the graph."""
        meta = entry.get("meta") or {}
        prog = meta.get("program")
        if prog in ("spec_draft", "spec_verify") and self._draft is None:
            return False
        if prog not in ("decode", "prefill", "spec_draft", "spec_verify"):
            return False
        stale = self._bundle_stale(
            meta, ("layout", "slots", "max_seq", "block_size",
                   "num_blocks"))
        if prog == "prefill" and isinstance(meta.get("bucket"), int) \
                and meta["bucket"] > self.prefill_chunk_len:
            stale.append("bucket")
        if prog in ("spec_draft", "spec_verify") \
                and "k" in meta and meta["k"] != self._spec_k:
            stale.append("k")
        if stale:
            _flight.record("warmup", "stale_entry", program=str(prog),
                           mismatches=",".join(stale))
            return "stale"
        self._check_idle()
        S = self.max_slots
        ids = np.zeros((S, 1), np.int32)
        pos = np.zeros(S, np.int32)
        idle = np.zeros(S, bool)
        if prog == "decode":
            self._decode(self.params, self._kv_store, ids, pos,
                         self._kv.block_tables, idle)
        elif prog == "prefill":
            b = int(meta.get("bucket", 0) or
                    min(self._bucket(1), self.prefill_chunk_len))
            z = np.int32(0)
            self._prefill(
                self.params, self._kv_store, np.zeros((1, b), np.int32),
                self._kv.block_tables[0], z, z, z)
        elif prog == "spec_draft":
            draft = self._draft
            self._spec_propose(draft.params, draft._kv_store, ids, pos,
                               draft._kv.block_tables, idle)
        else:  # the verify window over this engine's idle slots
            self._spec_verify_prog(
                self.params, self._kv_store, ids,
                np.zeros((S, self._spec_k), np.int32), pos,
                self._kv.block_tables, idle)
        self.last_logits = None
        self._count_pa_path()
        _flight.record("warmup", "serving_program", program=str(prog))
        return True

    def _alloc_pools(self) -> Dict[str, list]:
        """Zeroed block-pool STORES (per-layer K/V + int8 scales), each
        ``[num_blocks + 1, ...]``: the pool and its sink block."""
        kvh = self.cfg.num_key_value_heads
        pool_dt = {"int8": torch.int8,
                   "bfloat16": torch.bfloat16}.get(self.kv_quant,
                                                   self.dtype)
        NB, bs, L = self.num_blocks + 1, self.block_size, self.n_layers
        kw = dict(device=self.device)
        kv = {name: [torch.zeros((NB, bs, kvh, self.head_dim),
                                 dtype=pool_dt, **kw) for _ in range(L)]
              for name in ("k", "v")}
        if self.kv_quant == "int8":
            for name in ("ksc", "vsc"):
                kv[name] = [torch.zeros((NB, bs, kvh), dtype=torch.float32,
                                        **kw) for _ in range(L)]
        return kv

    def _init_cache(self) -> None:
        self._kv = _sc.PagedKVCache(
            max_slots=self.max_slots, max_seq=self.max_seq,
            block_size=self.block_size, num_blocks=self.num_blocks)
        self._kv_store = self._alloc_pools()
        NB = self.num_blocks
        self.kvs = {name: [t[:NB] for t in stores]
                    for name, stores in self._kv_store.items()}
        self._decode = self._program(
            self._decode_impl, "serving.paged_decode",
            {"program": "decode", **self._warm_geo()})
        self._decode_collect = None
        # one program for every bucket (a bucket is a signature), its
        # warm meta the bucket of the call
        self._prefill = self._program(
            self._prefill_impl, "serving.paged_prefill",
            lambda params, kv, ids, *rest: {
                "program": "prefill", "bucket": int(ids.shape[1]),
                **self._warm_geo()})
        self._cow = None
        self._prefill_state: Dict[int, dict] = {}
        self.prefix_hit_tokens: Dict[int, int] = {}

    def reset_state(self) -> None:
        """Reset over the block pool: every owned slot is released as a
        counted EVICTION, staged prefills are dropped, the radix tree
        empties (its blocks' content dies with the pools) and the stores
        are zeroed IN PLACE — the captured graphs hold their addresses
        and stay valid, so a restarted loop replays them. An attached
        draft resets with it."""
        for s in range(self.max_slots):
            self._kv.release(s, evicted=True)
        self._kv.reset_prefix_cache()
        self.prefix_hit_tokens.clear()
        self._prefill_state.clear()
        self.pos[:] = 0
        self.active[:] = False
        self.last_ids[:] = 0
        for stores in self._kv_store.values():
            for t in stores:
                t.zero_()
        if self._draft is not None:
            self._draft.reset_state()

    # -- device side --------------------------------------------------------
    def _write_kv(self, kvl, k, v, rows):
        """Scatter K/V rows [S, T, KVH, D] into their planned store rows
        IN PLACE (int8 pools take absmax codes + scales); dropped rows
        land in the sink block."""
        kf = k.reshape((-1,) + tuple(k.shape[2:]))
        vf = v.reshape((-1,) + tuple(v.shape[2:]))
        if self.kv_quant == "int8":
            kq, ks = _sc.absmax_quantize(kf)
            vq, vs = _sc.absmax_quantize(vf)
            for name, vals in (("k", kq), ("v", vq), ("ksc", ks),
                               ("vsc", vs)):
                _sc.write_kv_rows(kvl[name], rows, vals)
        else:
            _sc.write_kv_rows(kvl["k"], rows, kf)
            _sc.write_kv_rows(kvl["v"], rows, vf)
        return kvl

    def _cow_impl(self, kvs, src, dst):
        """Boundary copy-on-write: clone block ``src`` into ``dst`` (one
        -element device tensors) across every store (per-layer K/V +
        int8 scales), in place."""
        for stores in kvs.values():
            for t in stores:
                _sc.copy_block_device(t, src, dst)
        return kvs

    def _forward_paged(self, params, kv, ids, positions, tables, n_tiles,
                       wmask):
        """Shared chunked-prefill/decode body: ids [S, T] at int32
        positions [S, T] with int32 block tables [S, MB] and the write
        mask [S, T] -> ``(logits [S, T, V], kv)``; the write plan is
        made once on the card and serves every layer, the writes land in
        the stores in place."""
        NB = self.num_blocks
        rows = _sc.kv_write_rows(positions, tables, wmask, self.block_size,
                                 NB)
        cos, sin = self._rope_cos_sin(positions)
        h = F.embedding(ids.long(), params["emb"]).to(self.dtype)
        for li, lp in enumerate(params["layers"]):
            kvl = {name: stores[li] for name, stores in kv.items()}
            q, k, v = self._qkv(lp, self._rms(h, lp["in_ln"]), cos, sin)
            self._write_kv(kvl, k, v, rows)
            quant = "ksc" in kvl
            att = _sc.paged_attention(
                q, kvl["k"][:NB], kvl["v"][:NB], tables, positions,
                block_size=self.block_size, n_rep=self.n_rep,
                n_tiles=n_tiles,
                k_scale=kvl["ksc"][:NB] if quant else None,
                v_scale=kvl["vsc"][:NB] if quant else None,
                use_kernel=self._use_kernel)
            h = h + self._mm(att.reshape(h.shape), lp["o_proj"])
            h = self._ffn(lp, h)
        return self._head(params, h), kv

    def _decode_impl(self, params, kv, last_ids, pos, tables, act):
        """One token for every slot: ids [S, 1], pos [S] = write
        position, tables [S, max_blocks], act [S] bool (inactive slots
        neither write nor advance). The block walk is bounded by the
        LONGEST history, a tile count made on the card. Returns ``(next
        int32 [S], logits [S, V], kv)``."""
        n_tiles = (pos.max() // self.block_size + 1).to(
            torch.int32).reshape(1)
        logits, kv = self._forward_paged(params, kv, last_ids,
                                         pos[:, None], tables, n_tiles,
                                         act[:, None])
        last = logits[:, -1]
        return last.argmax(dim=-1).to(torch.int32), last, kv

    def _prefill_impl(self, params, kv, ids, table_row, start, nvalid,
                      true_len):
        """ONE prompt chunk for ONE slot: ids [1, B] (bucket-padded)
        holds prompt tokens [start, start + nvalid); rows write into the
        slot's blocks (the padding to the sink) and attend every earlier
        position. Returns the greedy token at the prompt's LAST position
        with its logits — meaningful only on the final chunk."""
        B = ids.shape[1]
        offs = torch.arange(B, dtype=torch.int32, device=ids.device)
        positions = (start + offs)[None, :]
        wmask = (offs < nvalid)[None, :]
        n_tiles = ((start + nvalid - 1) // self.block_size + 1).to(
            torch.int32).reshape(1)
        logits, kv = self._forward_paged(params, kv, ids, positions,
                                         table_row[None, :], n_tiles, wmask)
        last = torch.clamp(true_len - 1 - start, 0, B - 1).long()
        row = logits[0].index_select(0, last.reshape(1))[0]
        return row.argmax().to(torch.int32), row, kv

    def _decode_collect_impl(self, params, kv, last_ids, pos, buf, i,
                             tables, act):
        """Decode step + on-device token collection (``buf [S, n]``
        donated; column ``i`` written in place)."""
        nxt, _, kv = self._decode_impl(params, kv, last_ids, pos, tables,
                                       act)
        buf.index_copy_(1, i.reshape(1).long(), nxt[:, None].to(buf.dtype))
        return nxt, kv, buf

    def _propose_impl(self, params, kv, last_ids, pos, tables, act):
        """DRAFT side of a speculative step: ``_spec_propose_k`` chained
        greedy decode steps in ONE program (the tokens feed the next
        step on the card), writing the draft's pool at positions [pos,
        pos + k). Returns ``(draft tokens int32 [S, k], kv)``."""
        ids, p = last_ids, pos
        toks = []
        for _ in range(self._spec_propose_k):
            nxt, _, kv = self._decode_impl(params, kv, ids, p, tables, act)
            toks.append(nxt)
            ids = nxt[:, None]
            p = p + 1
        return torch.stack(toks, dim=1), kv

    def _spec_verify_impl(self, params, kv, last_ids, draft_tok, pos,
                          tables, act):
        """TARGET side: score the whole window in ONE call — ids
        [S, k+1] = [last_id, d1..dk] at positions [pos, pos+k] —
        writing the target's K/V for every window position. Returns the
        greedy targets t int32 [S, k+1] (t[:, i] conditions on the prefix
        through d_i), the accepted-prefix length n_acc int32 [S] =
        |leading i with d_{i+1} == t_i|, the window's logits and kv."""
        k = draft_tok.shape[1]
        ids = torch.cat([last_ids.to(draft_tok.dtype), draft_tok], dim=1)
        positions = pos[:, None] + torch.arange(
            k + 1, dtype=torch.int32, device=pos.device)[None, :]
        n_tiles = ((pos.max() + k) // self.block_size + 1).to(
            torch.int32).reshape(1)
        wmask = act[:, None].expand(positions.shape)
        logits, kv = self._forward_paged(params, kv, ids, positions,
                                         tables, n_tiles, wmask)
        t = logits.argmax(dim=-1).to(torch.int32)
        match = (draft_tok == t[:, :k]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        return t, n_acc, logits, kv

    # -- host orchestration -------------------------------------------------
    def make_draft(self, model=None, num_layers: Optional[int] = None
                   ) -> "PagedLlamaDecodeEngine":
        """The cheap draft for speculative decoding as a TRUNCATED-LAYER
        view of this target: the same geometry (slots, max_seq, pool,
        quantization, chunk, device), the first ``num_layers`` decoder
        layers (default ``FLAGS_serving_spec_draft_layers``, 0 = half
        the target's, min 1), and the target's own weight tensors
        re-bound, so the draft costs only its KV pool. ``model`` is
        accepted for the JAX package's signature; only its config is
        read (default: the target's)."""
        from types import SimpleNamespace

        from .core.flags import flag_value
        n = int(num_layers or flag_value("serving_spec_draft_layers")
                or max(1, self.n_layers // 2))
        if not 1 <= n <= self.n_layers:
            raise ValueError(
                f"draft num_layers must be in [1, {self.n_layers}] — "
                f"the TARGET's depth, not the model's — got {n} (a "
                f"draft at least as deep as its target makes "
                f"speculation strictly slower than plain stepping)")
        if model is None:
            model = SimpleNamespace(config=self.cfg)
        return PagedLlamaDecodeEngine(
            model, max_slots=self.max_slots, max_seq=self.max_seq,
            int8=self.int8, eos_id=self.eos_id, block_size=self.block_size,
            num_blocks=self.num_blocks, kv_quant=self.kv_quant,
            prefill_chunk=self.prefill_chunk_len, num_layers=n,
            share_params=self.params, device=self.device,
            attention_impl=self.attention_impl)

    def attach_draft(self, draft: "PagedLlamaDecodeEngine",
                     spec_tokens: Optional[int] = None
                     ) -> "PagedLlamaDecodeEngine":
        """Enable speculative decoding: ``draft`` (a make_draft view or
        ANY second paged engine of the same geometry) proposes
        ``spec_tokens`` (default ``FLAGS_serving_spec_tokens``) tokens a
        step and this target verifies the window in one call. Admission
        then reserves ``spec_tokens`` extra tokens a request, so the
        window's pre-extension never out-draws the reservation.
        Requires an idle engine. Returns self."""
        from .core.flags import flag_value
        k = int(spec_tokens or flag_value("serving_spec_tokens"))
        if k < 1:
            raise ValueError(f"spec_tokens must be >= 1, got {k}")
        if (draft.max_slots != self.max_slots
                or draft.max_seq != self.max_seq
                or draft.block_size != self.block_size):
            raise ValueError(
                "draft engine geometry (max_slots/max_seq/block_size) "
                "must match the target's — the two advance in "
                "lockstep over mirrored slot state")
        if self.active.any() or self._prefill_state \
                or self._kv.occupied_slots():
            raise ValueError(
                "attach_draft requires an IDLE engine: requests "
                "admitted before attachment were reserved without the "
                "spec_k margin and have no mirrored draft slot. Drain "
                "or release every slot first")
        self._draft = draft
        draft._prefix_metrics = False
        self._spec_k = k
        draft._spec_propose_k = k
        self._spec_propose = draft._program(
            draft._propose_impl, "serving.spec_draft",
            {"program": "spec_draft", "k": k,
             "draft_layers": draft.n_layers, **self._warm_geo()})
        self._spec_verify_prog = self._program(
            self._spec_verify_impl, "serving.spec_verify",
            {"program": "spec_verify", "k": k, **self._warm_geo()})
        return self

    def _device_cow(self, slot: int, src: int, dst: int) -> None:
        """Boundary copy-on-write: block ``src`` -> ``dst`` in every
        store, through the ``serving.prefix_cow`` program. Issued in
        order with admission and step bookkeeping, so the clone reads
        the shared content before any later pool write can touch it."""
        if self._cow is None:
            self._cow = self._program(
                self._cow_impl, "serving.prefix_cow",
                {"program": "prefix_cow", **self._warm_geo()}, donate=(0,))
        self._cow(self._kv_store, np.int64(src),
                  np.int64(dst))
        if self._prefix_metrics:
            _flight.record("serving", "prefix_cow", slot=slot,
                           src=src, dst=dst)

    def _apply_cow(self, slot: int) -> None:
        mv = self._kv.take_cow(slot)
        if mv is not None:
            self._device_cow(slot, *mv)

    def _shared_write_guard(self, slot: int) -> None:
        """Decode writes land at ``pos >= len(prompt)``, past every
        shared block by construction, but a write into the shared
        prefix would corrupt every sharer's stream, so the boundary is
        guarded: ``cow_for_write`` detaches the block (and raises on a
        mid-prefix write) before the table ships to the card."""
        mv = self._kv.cow_for_write(slot, int(self.pos[slot]))
        if mv is not None:
            self._device_cow(slot, *mv)

    def begin_request(self, slot: int, prompt_ids,
                      max_new_tokens: int) -> bool:
        """Admit a request into ``slot``: map blocks for the prompt and
        reserve its worst-case generation budget (+ the speculation
        window with a draft attached: verify writes up to ``spec_k``
        positions past the committed stream before rollback). Returns
        False when the pool cannot cover it right now (the caller keeps
        it queued); raises ValueError for a request the pool could NEVER
        hold. An attached draft admits the same request in lockstep:
        both pools or neither."""
        prompt_ids = self._check_prompt(prompt_ids)
        n = int(prompt_ids.shape[0])
        budget = max(int(max_new_tokens), 1) + self._spec_k
        total = min(n + budget, self.max_seq)
        if not self._kv.admit(slot, n, total, token_ids=prompt_ids):
            return False
        if self._draft is not None:
            try:
                ok = self._draft.begin_request(slot, prompt_ids, budget)
            except Exception:
                self._kv.release(slot)
                raise
            if not ok:
                self._kv.release(slot)
                return False
        # prefix hit: matched tokens are already resident in aliased
        # blocks — prefill starts at the first unmatched token (a
        # block-aligned FULL match re-prefills only the last prompt
        # token, into its copy-on-write boundary clone)
        skip = self._kv.matched_tokens(slot)
        self._apply_cow(slot)
        self.prefix_hit_tokens[slot] = skip
        if skip and self._prefix_metrics:
            _M_prefix_hits.inc()
            _M_prefix_reused.inc(skip)
            _flight.record("serving", "prefix_hit", slot=slot,
                           tokens=skip, prompt=n)
        self._prefill_state[slot] = {"ids": prompt_ids, "next": skip}
        self.pos[slot] = 0
        self.active[slot] = False
        return True

    def prefill_chunk(self, slot: int) -> Optional[int]:
        """Run the next prompt chunk for ``slot`` through its bucket's
        program. Returns None while prefill is incomplete; on the final
        chunk, activates the slot and returns the first generated token
        (greedy: the one host read of a prefill)."""
        st = self._prefill_state[slot]
        ids, start = st["ids"], st["next"]
        n = int(ids.shape[0])
        # _chunk_cap is the adaptive-admission brownout knob (floor 8)
        limit = self.prefill_chunk_len if self._chunk_cap is None \
            else max(8, min(self.prefill_chunk_len, self._chunk_cap))
        c = min(limit, n - start)
        b = min(self._bucket(c), self.prefill_chunk_len)
        padded = np.zeros((1, b), np.int32)
        padded[0, :c] = ids[start:start + c]
        tok, logits, _ = self._prefill(
            self.params, self._kv_store, padded,
            self._kv.block_tables[slot], np.int32(start), np.int32(c),
            np.int32(n))
        self._count_pa_path()
        st["next"] = start + c
        # publish every fully-written prompt block into the radix tree
        # as soon as its last token lands
        self._kv.commit_prefix(slot, ids, st["next"])
        draft = self._draft
        if st["next"] < n:
            # one draft chunk per target chunk (a make_draft view
            # finishes in lockstep; another engine catches up below)
            if draft is not None and slot in draft._prefill_state:
                draft.prefill_chunk(slot)
            return None
        self.last_logits = logits
        first = int(tok)
        del self._prefill_state[slot]
        self.pos[slot] = n
        self.active[slot] = True
        self.last_ids[slot, 0] = first
        if draft is not None:
            while slot in draft._prefill_state:
                draft.prefill_chunk(slot)
            # the draft's stream mirrors the TARGET's: the target's
            # first token seeds both engines' next step
            draft.last_ids[slot, 0] = first
        return first

    def prefill(self, slot: int, prompt_ids,
                budget: Optional[int] = None) -> int:
        """One-shot prefill: admits with ``budget`` generation tokens
        reserved (default: the worst case, max_seq - len(prompt)) and
        runs every chunk back to back. The server path uses
        begin_request + prefill_chunk to interleave with decode."""
        prompt_ids = self._check_prompt(prompt_ids)
        if budget is None:
            budget = self.max_seq - int(prompt_ids.shape[0])
        if not self.begin_request(slot, prompt_ids, budget):
            raise RuntimeError(
                f"KV block pool exhausted admitting slot {slot} "
                f"({self._kv.stats()}); release a slot or raise "
                f"FLAGS_serving_num_blocks")
        while True:
            first = self.prefill_chunk(slot)
            if first is not None:
                return first

    def _extend_tables(self) -> None:
        """Step-boundary block extension: map the block covering each
        active slot's next write position (drawn from its admission
        reservation, so this cannot fail)."""
        for s in range(self.max_slots):
            if self.active[s]:
                self._shared_write_guard(s)
                self._kv.ensure_token(s, int(self.pos[s]))

    def step(self) -> np.ndarray:
        """One decode iteration for ALL active slots; returns next token
        per slot (garbage for inactive slots — callers consult
        .active). An attached draft runs a mirrored step on the same
        inputs, so its cache has no hole when the next iteration
        speculates again."""
        self._check_step()
        self._extend_tables()
        draft = self._draft
        if draft is not None:
            for s in range(self.max_slots):
                if self.active[s]:
                    draft._shared_write_guard(s)
                    draft._kv.ensure_token(s, int(self.pos[s]))
            draft._decode(draft.params, draft._kv_store, self.last_ids,
                          self.pos, draft._kv.block_tables, self.active)
        nxt, self.last_logits, _ = self._decode(
            self.params, self._kv_store, self.last_ids, self.pos,
            self._kv.block_tables, self.active)
        nxt = nxt.cpu().numpy()  # lint-allow: PTL001 the step's one read
        self._count_pa_path()
        for s in range(self.max_slots):
            if self.active[s]:
                self.pos[s] += 1
                self.last_ids[s, 0] = nxt[s]
                if draft is not None:
                    draft.pos[s] = self.pos[s]
                    draft.last_ids[s, 0] = nxt[s]
        return nxt

    def spec_ready(self) -> bool:
        """True when the next iteration can run speculatively: a draft
        is attached, no brownout suppresses it, at least one slot is
        active, and every active slot has room for the whole verify
        window (a slot within ``spec_k`` tokens of capacity drops the
        batch to a plain step for that iteration)."""
        if self._draft is None or self._spec_suppressed:
            return False
        act = [s for s in range(self.max_slots) if self.active[s]]
        if not act:
            return False
        k = self._spec_k
        return all(int(self.pos[s]) + k + 1 <= self.max_seq - 1
                   for s in act)

    def _spec_verify(self, draft_tok: torch.Tensor):
        """The verify program over this engine's live state: ``(t,
        n_acc)`` on the card, the window's logits in ``last_logits``."""
        t, n_acc, self.last_logits, _ = self._spec_verify_prog(
            self.params, self._kv_store, self.last_ids, draft_tok,
            self.pos, self._kv.block_tables, self.active)
        return t, n_acc

    def spec_step(self):
        """One SPECULATIVE decode iteration for all active slots: the
        draft proposes ``spec_k`` tokens (one program, chained on the
        card), the target verifies the window in one call, and ONE host
        read of ``(t, n_acc)`` closes it — the host-read budget of one
        plain step, for up to ``spec_k`` committed tokens.

        Greedy acceptance: with d1..dk the proposals and t0..tk the
        target's greedy tokens, the committed prefix is t[:m], m =
        min(n_acc + 1, k); every committed token conditions on a
        committed prefix, so the stream equals plain decoding. ``pos``
        moves by m and the rejected suffix's blocks roll back on both
        pools (``PagedKVCache.truncate``); stale K/V past ``pos`` is
        overwritten by the next write and masked by position until then.

        Returns ``(tokens [S, k+1], counts [S])``: row s's first
        ``counts[s]`` tokens continue its stream (garbage for inactive
        slots — callers consult ``.active``)."""
        k = self._spec_k
        draft = self._draft
        for s in range(self.max_slots):
            if self.active[s]:
                # window pre-extension, drawn from the +spec_k admission
                # margin: target writes [pos, pos+k], draft [pos,
                # pos+k-1]; both COW-guard the shared prefix first
                self._shared_write_guard(s)
                draft._shared_write_guard(s)
                self._kv.reserve_through(s, int(self.pos[s]) + k)
                draft._kv.reserve_through(s, int(self.pos[s]) + k - 1)
        draft_tok, _ = self._spec_propose(
            draft.params, draft._kv_store, self.last_ids, self.pos,
            draft._kv.block_tables, self.active)
        t, n_acc = self._spec_verify(draft_tok)
        self._count_pa_path()
        # the speculative step's one read, for up to k + 1 tokens
        host = torch.cat([t, n_acc[:, None]], dim=1).cpu().numpy()  # lint-allow: PTL001
        toks = host[:, :k + 1].astype(np.int32)
        acc = host[:, k + 1]
        counts = np.minimum(acc + 1, k).astype(np.int32)
        proposed = accepted = rolled = 0
        for s in range(self.max_slots):
            if not self.active[s]:
                continue
            m = int(counts[s])
            self.pos[s] += m
            self.last_ids[s, 0] = toks[s, m - 1]
            draft.pos[s] = self.pos[s]
            draft.last_ids[s, 0] = toks[s, m - 1]
            rolled += self._kv.truncate(s, int(self.pos[s]))
            rolled += draft._kv.truncate(s, int(self.pos[s]))
            proposed += k
            accepted += int(acc[s])
        _M_spec_steps.inc()
        if proposed:
            _M_spec_proposed.inc(proposed)
        if accepted:
            _M_spec_accepted.inc(accepted)
        if rolled:
            _M_spec_rolled.inc(rolled)
        _flight.record("serving", "spec_step", proposed=proposed,
                       accepted=accepted, rolled_back=rolled)
        return toks, counts

    def decode_steps(self, n: int) -> np.ndarray:
        """``n`` chained decode iterations, tokens kept on the card and
        ONE host fetch at the end; blocks for the whole window are
        mapped up front, so one copy of the tables serves every step."""
        if not self.active.all():
            raise ValueError(
                "decode_steps advances EVERY slot; use step() when "
                "some slots are free (the continuous-batching server "
                "path)")
        self._check_window(n)
        for s in range(self.max_slots):
            self._shared_write_guard(s)
            self._kv.reserve_through(s, int(self.pos[s]) + n - 1)
        if self._decode_collect is None:
            self._decode_collect = self._program(
                self._decode_collect_impl, "serving.paged_decode_window",
                donate=(0, 1, 4))
        dev = self.device
        buf = self._collect_buf(n)
        ids = torch.as_tensor(self.last_ids).to(dev)
        pos = torch.as_tensor(self.pos).to(dev)
        tables = torch.as_tensor(self._kv.block_tables).to(dev)
        act = torch.as_tensor(self.active).to(dev)
        for i in range(n):
            nxt, _, _ = self._decode_collect(
                self.params, self._kv_store, ids, pos, buf, np.int32(i),
                tables, act)
            ids = nxt[:, None]
            pos = pos + 1
        self._count_pa_path(n)
        toks = buf.cpu().numpy()  # lint-allow: PTL001 the window's one fetch
        self.pos += n
        self.last_ids = toks[:, -1:].copy()
        return toks

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 slot: int = 0) -> List[int]:
        """Single-request path over the block pool: the admission
        reservation is sized to ``max_new_tokens``."""
        out = [self.prefill(slot, prompt_ids, budget=max_new_tokens)]
        for _ in range(max_new_tokens - 1):
            if self.eos_id is not None and out[-1] == self.eos_id:
                break
            if self.pos[slot] >= self.max_seq - 1:
                break
            out.append(int(self.step()[slot]))
        self.release(slot)
        return out

    def release(self, slot: int, evicted: bool = False) -> None:
        """Free the slot AND return its blocks + reservation to the
        pool; ``evicted=True`` (expiry/failure/cancellation) counts them
        into ``serving.block_evictions_total``. An attached draft
        releases its mirrored slot in the same call."""
        self.active[slot] = False
        self.pos[slot] = 0
        self._prefill_state.pop(slot, None)
        self.prefix_hit_tokens.pop(slot, None)
        self._kv.release(slot, evicted=evicted)
        if self._draft is not None:
            self._draft.release(slot, evicted=evicted)

    def _export_args(self) -> tuple:
        dev = self.device
        return (self.params, self._kv_store,
                torch.as_tensor(self.last_ids).to(dev),
                torch.as_tensor(self.pos).to(dev),
                torch.as_tensor(self._kv.block_tables).to(dev),
                torch.as_tensor(self.active).to(dev))


class GenerationServer:
    """Iteration-level continuous batching around a decode engine:
    requests are admitted into free slots at step boundaries, every step
    advances all active requests together, finished requests free their
    slot for the next admission.

    With a :class:`PagedLlamaDecodeEngine` the loop also splits prefill
    from decode: admission allocates + reserves KV blocks (pool
    exhaustion DEFERS the request; deferred requests hold the line so a
    stream of small requests cannot starve a large one), and each
    iteration advances at most ONE prompt chunk before the decode step.

    ``submit(..., deadline=s)`` bounds a request's wall time: expiry
    (checked at step boundaries) fails THAT request with TimeoutError,
    keeping its tokens in ``req["out"]`` and returning its blocks as
    counted evictions. ``shutdown()`` drains: new submissions are
    rejected, queued and in-flight requests finish, then the loop
    exits. Each request dict records ``t0`` (submit), ``t_admit`` and
    ``t_first`` (first token) on the host's monotonic clock.

    With a draft attached (``engine.attach_draft``) an iteration runs
    ``engine.spec_step()`` whenever ``engine.spec_ready()``: up to
    ``spec_k`` tokens a slot, cut at eos or the budget mid-window.
    ``swap_weights`` installs new weights at a step boundary, and
    ``metrics_endpoint`` serves the metrics registry over HTTP.

    A ``ServingSupervisor`` (``serving_supervisor.supervise``) restarts
    a dead or stalled loop: each loop thread stamps the epoch it started
    in and exits, touching nothing, once the supervisor has moved the
    epoch on; ``_beat`` is the loop's heartbeat and ``_idle`` marks it
    parked on the empty queue."""

    _STOP = object()  # queue sentinel: wake the loop for shutdown

    def __init__(self, engine: LlamaDecodeEngine, policy=None):
        self.engine = engine
        self._paged = bool(getattr(engine, "paged", False))
        self._q: "_queue.Queue" = _queue.Queue()
        self._slots: Dict[int, dict] = {}
        self._prefilling: Dict[int, dict] = {}
        self._waiting: List[dict] = []
        self._cancel_waiting = False  # set by shutdown(drain=False)
        self.steps_run = 0
        self.admitted = 0
        self.rejected = 0
        self.shed = 0
        self.deadline_rejected = 0  # unmeetable-deadline rejections
        self.deadline_expired = 0
        self.weight_swaps = 0       # hot-swaps applied by this loop
        self.tokens_delivered = 0
        self.loop_restarts = 0      # supervisor restarts of this loop
        self.recovered = 0          # requests resumed after a loop death
        self.quarantined = 0        # poison requests failed, not retried
        if policy is None:
            from .serving_supervisor import default_policy
            policy = default_policy()
        self.policy = policy
        self._stopping = threading.Event()
        self._drained = threading.Event()
        # orders submit's stopping-check+enqueue against shutdown's
        # stopping.set(), so the drain loop cannot strand a request
        self._submit_lock = make_lock("serving.submit")
        # pending weight hot-swap: (prepared weights, done Event, result
        # dict), set under the submit lock, applied by the LOOP thread
        # at its next step boundary
        self._swap_req = None
        self._metrics_server = None
        # supervision: _epoch fences a replaced loop thread, _beat is the
        # heartbeat the stall watchdog reads, _idle marks the loop parked
        # on the empty queue (not a stall)
        self._epoch = 0
        self._beat = time.monotonic()
        self._idle = False
        self._start_loop()

    def _start_loop(self) -> None:
        """Start (or, from the supervisor, restart) the loop thread. The
        crash markers reset so that the supervisor tells this
        incarnation's death from the last one's, and the heartbeat
        restarts now, so that the stall watchdog does not fire on the
        dead loop's stale beat."""
        self._crashed = False
        self._crash_error: Optional[BaseException] = None
        self._beat = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-loop")
        self._thread.start()

    def _fenced(self) -> bool:
        """True on a replaced ("zombie") loop thread: its stamped epoch
        is no longer the server's. The admission and prefill helpers
        check it before they touch a request or the slot tables, so a
        stalled thread that wakes during a recovery commits nothing.
        Threads that are not loop threads carry no stamp and are never
        fenced."""
        my = getattr(threading.current_thread(),
                     "_serving_loop_epoch", None)
        return my is not None and my != self._epoch

    def _run(self) -> None:
        """Loop-thread body with a crash boundary: an escape that
        ``except Exception`` must not swallow still kills the thread,
        but first the crash is journaled and the gauges refreshed."""
        try:
            self._loop()
        except BaseException as e:
            self._crashed = True
            self._crash_error = e
            _flight.record("serving", "loop_crashed",
                           error=type(e).__name__,
                           in_flight=len(self._slots)
                           + len(self._prefilling))
            self._set_gauges()
            raise

    def _apply_brownout(self, spec_off: bool,
                        chunk_cap: Optional[int]) -> None:
        """Install the adaptive policy's brownout knobs on the engine
        (step-boundary safe: both steer only what the next iteration
        runs)."""
        eng = self.engine
        eng._spec_suppressed = bool(spec_off)
        eng._chunk_cap = chunk_cap

    def metrics_endpoint(self, port: int = 0, host: str = "127.0.0.1"):
        """Serve the process metrics registry over HTTP: ``GET
        /metrics`` (Prometheus text exposition), ``/metrics.json`` (the
        nested snapshot) and ``/healthz`` (readiness: loop alive, not
        draining, admission below hard shed). Idempotent per server;
        ``shutdown()`` closes it. Returns the handle (``.url``,
        ``.port``, ``.close()``)."""
        if self._metrics_server is None:
            from .observability.http import start_metrics_server
            from .serving_fleet import health_snapshot
            self._metrics_server = start_metrics_server(
                port=port, host=host,
                health_cb=lambda: health_snapshot(self))
        return self._metrics_server

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               deadline: Optional[float] = None) -> dict:
        """Enqueue a request. ``deadline`` (seconds from now) bounds its
        total wall time; None = unbounded. The returned dict carries
        ``trace_id``, the key of its flight-recorder trail."""
        trace_id = f"req-{next(_REQ_SEQ)}"
        _flight.record("serving", "submit", trace_id=trace_id,
                       max_new=int(max_new_tokens))
        if self._stopping.is_set():
            self._reject(trace_id, "shutting_down")
        if int(max_new_tokens) < 1:
            _flight.record("serving", "rejected", trace_id=trace_id,
                           reason="invalid_max_new")
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens} "
                f"(prefill always produces the first token)")
        if deadline is not None and deadline <= 0:
            _flight.record("serving", "rejected", trace_id=trace_id,
                           reason="invalid_deadline")
            raise ValueError(f"deadline must be > 0, got {deadline}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        verdict = self.policy.admit_verdict(
            self, int(prompt.shape[0]), int(max_new_tokens), deadline)
        if verdict == "deadline":
            self.deadline_rejected += 1
            _M_deadline_rej.inc()
            self._reject(trace_id, verdict)
        if verdict is not None:
            self.shed += 1
            _M_shed.inc()
            self._reject(trace_id, verdict)
        now = time.monotonic()
        req = {"prompt": prompt, "max_new": int(max_new_tokens),
               "out": [], "done": threading.Event(), "error": None,
               "trace_id": trace_id, "t0": now,
               "expires": now + deadline if deadline is not None
               else None}
        with self._submit_lock:
            if self._stopping.is_set():
                self._reject(trace_id, "shutting_down")
            self._q.put(req)
        _flight.record("serving", "queued", trace_id=trace_id,
                       prompt_len=int(prompt.shape[0]))
        return req

    def _reject(self, trace_id: str, reason: str) -> None:
        self.rejected += 1
        _M_rejected.inc()
        _flight.record("serving", "rejected", trace_id=trace_id,
                       reason=reason, policy=self.policy.name,
                       waiting=len(self._waiting))
        if reason == "shutting_down":
            raise RuntimeError(
                "GenerationServer is shutting down; new submissions are "
                "rejected (in-flight requests are draining)")
        if reason == "deadline":
            raise RuntimeError(
                f"request rejected by the {self.policy.name} admission "
                f"policy (reason=deadline): its deadline cannot be met "
                f"at the observed decode rate — retry with a larger "
                f"deadline or fewer tokens")
        raise RuntimeError(
            f"request rejected by the {self.policy.name} admission "
            f"policy (reason={reason}): the replica is overloaded (KV "
            f"blocks exhausted with a deferred backlog) — retry later "
            f"or raise FLAGS_serving_num_blocks")

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 timeout: float = 300.0,
                 deadline: Optional[float] = None) -> List[int]:
        req = self.submit(prompt_ids, max_new_tokens, deadline=deadline)
        if not req["done"].wait(timeout):
            raise TimeoutError("generation timed out")
        if req["error"] is not None:
            raise req["error"]
        return list(req["out"])

    @staticmethod
    def _swap_state(source, device=None) -> dict:
        """A swap source as a model state dict, on the caller's thread
        (disk reads and CRC checks never stall the loop): a
        ``CheckpointManager`` restores its newest good checkpoint, a path
        loads through the verifying ``framework.checkpoint`` reader (the
        tensors onto ``device``), and a dict passes through; a state dict
        nested under ``model`` / ``state_dict`` / ``params`` is taken out
        by ``extract_state_dict``."""
        from .framework.checkpoint import (CheckpointManager,
                                           extract_state_dict,
                                           load_checkpoint)
        if isinstance(source, CheckpointManager):
            got = source.restore(device=device)
            if got is None:
                raise ValueError(
                    f"no loadable checkpoint under {source.root!r} to "
                    f"swap from")
            source = got[1]
        elif isinstance(source, (str, os.PathLike)):
            source = load_checkpoint(os.fspath(source), device=device)
        return extract_state_dict(source)

    def swap_weights(self, state_dict=None,
                     timeout: Optional[float] = 300.0, *,
                     prepared=None) -> dict:
        """Install new weights into the running engine BETWEEN decode
        steps, dropping no in-flight request: their KV blocks and
        partial streams are untouched and the next step runs on the new
        weights (a weight-sharing draft follows in the same swap).

        ``state_dict`` is a model state dict, a checkpoint path or a
        ``CheckpointManager`` (see :meth:`_swap_state`); its weights are
        prepared on THIS thread
        (:meth:`~LlamaDecodeEngine.prepare_swap`), and the loop thread
        only validates and installs them at its next step boundary. A
        mismatch raises here with the old weights intact (counted in
        ``serving.weight_swaps_rejected_total``). Returns the swap's
        stats (``seconds`` at the boundary, ``in_flight``, ...). A
        timeout cancels the swap if the loop has not claimed it yet.
        ``prepared=`` skips the preparation (``prepare_swap``'s output,
        or a retained earlier ``engine.params``)."""
        if prepared is not None:
            prepped = prepared
        else:
            sd = self._swap_state(state_dict,
                                  getattr(self.engine, "device", None))
            try:
                prepped = self.engine.prepare_swap(sd)
            except Exception:
                _M_swap_rejected.inc()
                _flight.record("serving", "swap_end", ok=False,
                               error="prepare")
                raise
        done = threading.Event()
        slot: dict = {}
        with self._submit_lock:
            if self._stopping.is_set():
                raise RuntimeError(
                    "GenerationServer is shutting down; weights cannot "
                    "be swapped into a draining loop")
            if self._swap_req is not None:
                raise RuntimeError(
                    "a weight swap is already pending; wait for it "
                    "before submitting another")
            self._swap_req = (prepped, done, slot)
        self._q.put(self._STOP)  # wake an idle loop (sentinel no-op)
        if not done.wait(timeout):
            with self._submit_lock:
                cancelled = (self._swap_req is not None
                             and self._swap_req[1] is done)
                if cancelled:
                    self._swap_req = None
            raise TimeoutError(
                f"weight swap not applied within {timeout}s — "
                + ("cancelled before the loop claimed it"
                   if cancelled else
                   "the loop claimed it mid-apply; it may still land"))
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _apply_pending_swap(self) -> None:
        """Apply a pending weight swap HERE, on the loop thread, at a
        step boundary: the last step has committed its tokens and no
        new step has started, so no in-flight request drops or corrupts
        a token. A rejected swap leaves the old weights installed and
        the loop running."""
        if self._swap_req is None:
            return
        with self._submit_lock:  # the claim races a caller's timeout
            req = self._swap_req
            self._swap_req = None
        if req is None:
            return
        prepped, done, slot = req
        t0 = time.perf_counter()
        _flight.record("serving", "swap_begin",
                       in_flight=len(self._slots),
                       prefilling=len(self._prefilling))
        try:
            self.engine.swap_weights(prepared=prepped)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            _M_swap_rejected.inc()
            _flight.record("serving", "swap_end", ok=False,
                           error=type(e).__name__)
            slot["error"] = e
            done.set()
            return
        dt = time.perf_counter() - t0
        self.weight_swaps += 1
        _M_swaps.inc()
        _M_swap_s.observe(dt)
        _flight.record("serving", "swap_end", ok=True,
                       seconds=round(dt, 4))
        slot["result"] = {"seconds": dt,
                          "in_flight": len(self._slots),
                          "prefilling": len(self._prefilling),
                          "steps_run": self.steps_run}
        done.set()

    def _shed(self) -> bool:
        """The static load-shedding rule: shed when admission is
        block-starved (no available blocks AND a request already
        deferred) and the waiting backlog exceeds
        ``FLAGS_serving_shed_queue`` (0 disables)."""
        from .core.flags import flag_value
        bound = int(flag_value("serving_shed_queue"))
        if not self._paged or bound <= 0:
            return False
        return (self._waiting != []
                and self._q.qsize() + len(self._waiting) > bound
                and self.engine._kv.available_blocks() <= 0)

    def _expired(self, req) -> bool:
        return (req["expires"] is not None
                and time.monotonic() > req["expires"])

    def _fail(self, req, error) -> None:
        req["error"] = error
        req["done"].set()
        _M_failed.inc()
        _flight.record(
            "serving",
            "expired" if isinstance(error, TimeoutError) else "failed",
            trace_id=req.get("trace_id"), error=type(error).__name__,
            tokens=len(req["out"]))
        self._observe_done(req)

    def _expire(self, req, where: str) -> None:
        self.deadline_expired += 1
        _M_expired.inc()
        self._fail(req, TimeoutError(f"request deadline expired {where}"))

    @staticmethod
    def _observe_done(req) -> None:
        """Request-completion telemetry: tokens delivered + wall time +
        per-token latency, plus the queue/decode latency split."""
        tokens = len(req["out"])
        if tokens:
            _M_tokens.inc(tokens)
        now = time.monotonic()
        dt = now - req["t0"]
        _M_req_s.observe(dt)
        _M_token_s.observe(dt / max(tokens, 1))
        t_admit = req.get("t_admit")
        if t_admit is not None:
            _M_decode_s.observe(now - t_admit)
        else:
            # never admitted: its whole life WAS queue time
            _M_queue_s.observe(dt)

    def _first_token(self, slot, req, first: int) -> None:
        req["out"].append(first)
        # a recovered request's re-prefill keeps its first token's time
        req.setdefault("t_first", time.monotonic())
        self._slots[slot] = req

    def _observe_queue(self, req) -> None:
        """Stamp the admission and observe the queue wait, from
        ``t_queue0`` for a recovered request (its time before the loop
        died was decode, not queueing)."""
        req["t_admit"] = time.monotonic()
        _M_queue_s.observe(req["t_admit"] - req.get("t_queue0", req["t0"]))

    def _admit_one(self, req, slot) -> None:
        if self._expired(req):
            self._expire(req, "while queued")
            return
        self._observe_queue(req)
        try:
            first = self.engine.prefill(slot, req["prompt"])
        except Exception as e:  # noqa: BLE001 — surfaced per request
            if self._fenced():
                return  # zombie: the request was re-admitted already
            self._fail(req, e)
            return
        if self._fenced():
            return  # zombie woke from a wedged prefill: the new loop
            # owns this request
        self._first_token(slot, req, first)
        self.admitted += 1
        _M_admitted.inc()
        _flight.record("serving", "admitted",
                       trace_id=req.get("trace_id"), slot=slot)
        self._finish_if_done(slot, req)

    def _release_slot(self, slot, evicted: bool = False) -> None:
        self.engine.release(slot, evicted=evicted)

    def _free_slots(self):
        eng = self.engine
        return [s for s in range(eng.max_slots)
                if not eng.active[s] and s not in self._prefilling]

    def _admit_paged(self, req, slot) -> str:
        """Paged admission: allocate + reserve blocks and start the
        chunked prefill. Returns 'admitted', 'defer' (the pool cannot
        cover the reservation yet) or 'dropped'."""
        if req is self._STOP or req["done"].is_set() or self._fenced():
            return "dropped"
        if self._expired(req):
            self._expire(req, "while queued")
            return "dropped"
        try:
            # budget = the tokens still to come: a recovered request
            # re-admits with prompt + committed tokens as its prompt
            ok = self.engine.begin_request(
                slot, req["prompt"], max(req["max_new"] - len(req["out"]),
                                         1))
        except Exception as e:  # noqa: BLE001 — surfaced per request
            self._fail(req, e)
            return "dropped"
        if not ok:
            return "defer"
        self._observe_queue(req)
        req["prefix_hit_tokens"] = getattr(
            self.engine, "prefix_hit_tokens", {}).get(slot, 0)
        self._prefilling[slot] = req
        self.admitted += 1
        _M_admitted.inc()
        _flight.record("serving", "admitted",
                       trace_id=req.get("trace_id"), slot=slot,
                       prefix_hit=req["prefix_hit_tokens"])
        return "admitted"

    def _admit(self):
        if not self._paged:
            free = self._free_slots()
            # supervisor-recovered requests land in _waiting (a dense
            # engine never defers on blocks): admit them ahead of the
            # queue, oldest first
            while free and self._waiting:
                req = self._waiting.pop(0)
                if req["done"].is_set():
                    continue
                self._admit_one(req, free[0])
                if req["done"].is_set() and req["error"] is not None:
                    continue  # rejected before prefill: slot still free
                free.pop(0)
            while free:
                try:
                    req = self._q.get_nowait()
                except _queue.Empty:
                    return
                if req is self._STOP or req["done"].is_set():
                    continue
                self._admit_one(req, free[0])
                if req["done"].is_set() and req["error"] is not None:
                    continue  # rejected before prefill: slot still free
                free.pop(0)
            return
        if self._cancel_waiting:
            # shutdown(drain=False): cancel block-deferred requests on
            # the loop thread, which owns the _waiting list
            for req in self._waiting:
                if not req["done"].is_set():
                    self._fail(req, RuntimeError(
                        "request cancelled: server shut down before "
                        "admission"))
            self._waiting = []
        free = self._free_slots()
        # block-deferred requests retry first and HOLD THE LINE: while
        # any of them still cannot be covered, nothing newer is pulled
        # from the queue (fairness over utilization)
        still: List[dict] = []
        for req in self._waiting:
            if req["done"].is_set():
                continue
            if not free:
                still.append(req)
                continue
            verdict = self._admit_paged(req, free[0])
            if verdict == "admitted":
                free.pop(0)
            elif verdict == "defer":
                still.append(req)
        self._waiting = still
        while free and not self._waiting:
            try:
                req = self._q.get_nowait()
            except _queue.Empty:
                return
            verdict = self._admit_paged(req, free[0])
            if verdict == "admitted":
                free.pop(0)
            elif verdict == "defer":
                self._waiting.append(req)

    def _run_prefill(self):
        """Advance ONE prompt chunk of the OLDEST-admitted prefilling
        slot: each loop iteration costs at most one chunk on top of the
        decode step, so admitted slots keep streaming."""
        for slot in list(self._prefilling):
            req = self._prefilling[slot]
            try:
                first = self.engine.prefill_chunk(slot)
            except Exception as e:  # noqa: BLE001 — per-request
                if self._fenced():
                    return  # zombie: recovery owns the request now
                del self._prefilling[slot]
                self._release_slot(slot, evicted=True)
                self._fail(req, e)
                return
            if self._fenced():
                return  # zombie woke from a wedged chunk: commit nothing
            if first is not None:
                del self._prefilling[slot]
                self._first_token(slot, req, first)
                _flight.record("serving", "prefilled",
                               trace_id=req.get("trace_id"), slot=slot,
                               prompt_len=int(req["prompt"].shape[0]))
                self._finish_if_done(slot, req)
            return

    def _finish_if_done(self, slot, req):
        eng = self.engine
        done = (len(req["out"]) >= req["max_new"]
                or (eng.eos_id is not None
                    and req["out"][-1] == eng.eos_id)
                or eng.pos[slot] >= eng.max_seq - 1)
        if done:
            eng.release(slot)
            del self._slots[slot]
            req["done"].set()
            _flight.record("serving", "finished",
                           trace_id=req.get("trace_id"),
                           tokens=len(req["out"]))
            self._observe_done(req)
        return done

    def _expire_active(self):
        """Step-boundary deadline sweep over active, prefilling and
        block-waiting requests."""
        for slots, where in ((self._slots, "while decoding"),
                             (self._prefilling, "during prefill")):
            for slot in list(slots):
                req = slots[slot]
                if self._expired(req):
                    self._release_slot(slot, evicted=True)
                    del slots[slot]
                    self._expire(req, f"{where} after "
                                 f"{len(req['out'])} token(s)")
        still = []
        for req in self._waiting:
            if not req["done"].is_set() and self._expired(req):
                self._expire(req, "waiting for KV blocks")
            elif not req["done"].is_set():
                still.append(req)
        self._waiting = still

    def _expire_queued(self):
        """Fail expired requests still in the queue, even when every
        slot is busy; _admit() discards them on dequeue."""
        with self._q.mutex:
            waiting = list(self._q.queue)
        for req in waiting:
            if req is not self._STOP and not req["done"].is_set() \
                    and self._expired(req):
                self._expire(req, "while queued")

    def _step_boundary(self):
        self._expire_active()
        self._expire_queued()
        self._set_gauges()
        self.policy.on_step(self)

    def _loop(self):
        # the epoch read here fences THIS incarnation: after a supervisor
        # restart a zombie of it that wakes sees a newer epoch and exits
        # without touching slots, engine state or the queue (the thread
        # stamp lets the admission and prefill helpers check the same
        # fence from inside a call the zombie was wedged in)
        my_epoch = self._epoch
        threading.current_thread()._serving_loop_epoch = my_epoch
        while True:
            if self._epoch != my_epoch:
                return  # fenced: a supervisor replaced this loop
            self._beat = time.monotonic()  # the stall watchdog's heartbeat
            try:
                self._apply_pending_swap()
                self._admit()
                if self._paged and self._prefilling:
                    self._run_prefill()
                if not self._slots:
                    if self._prefilling or self._waiting:
                        self._step_boundary()
                        continue
                    if self._stopping.is_set() and self._q.empty():
                        break  # drained: nothing active, nothing queued
                    # idle: block for the next request and admit it
                    # directly (a get-then-requeue would break FIFO)
                    self._set_gauges()
                    self._idle = True  # parked, not stalled
                    try:
                        req = self._q.get()
                    finally:
                        self._idle = False
                    if self._epoch != my_epoch:
                        # fenced while parked: the request belongs to the
                        # new loop — hand it back and exit
                        if req is not self._STOP:
                            self._q.put(req)
                        return
                    if req is self._STOP or req["done"].is_set():
                        continue
                    if self._paged:
                        if self._admit_paged(req, self._free_slots()[0]) \
                                == "defer":
                            self._waiting.append(req)
                        continue
                    self._admit_one(req, self._free_slots()[0])
                    continue
                # fault site: a kill armed here is a crash mid-decode (the
                # thread dies: KillPoint is a BaseException)
                _fi.fire("serving.decode")
                eng = self.engine
                if self._paged and eng.spec_ready():
                    # speculative iteration: up to spec_k tokens a slot
                    # for one host read; the greedy stream equals plain
                    # stepping's, so a request cut off mid-window (eos,
                    # budget) sees exactly the tokens it would anyway
                    toks, counts = eng.spec_step()
                else:
                    # plain stepping: the counts == 1 case of the same
                    # commit loop
                    toks = eng.step()[:, None]
                    counts = np.ones(eng.max_slots, np.int32)
                if self._epoch != my_epoch:
                    return  # fenced mid-step (a stall restart): the new
                    # loop owns the slots — commit and fail nothing
                self.steps_run += 1
                _M_steps.inc()
                for slot in list(self._slots):
                    req = self._slots[slot]
                    before = len(req["out"])
                    for j in range(int(counts[slot])):
                        tok = int(toks[slot, j])
                        req["out"].append(tok)
                        if len(req["out"]) >= req["max_new"]:
                            break
                        if eng.eos_id is not None and tok == eng.eos_id:
                            break
                    self.tokens_delivered += len(req["out"]) - before
                    _flight.record("serving", "decode",
                                   trace_id=req.get("trace_id"),
                                   step=self.steps_run,
                                   tokens=len(req["out"]))
                    self._finish_if_done(slot, req)
                self._step_boundary()
            except Exception as e:  # noqa: BLE001 — fail loudly, stay up
                if self._epoch != my_epoch:
                    return  # fenced: the slots hold re-admitted requests
                _flight.record("serving", "loop_error",
                               error=type(e).__name__)
                for table in (self._slots, self._prefilling):
                    for slot, req in list(table.items()):
                        self._fail(req, e)
                        self._release_slot(slot, evicted=True)
                    table.clear()
                self._set_gauges()
        self._set_gauges()
        # a swap still pending at loop exit can never apply: unblock its
        # caller with the reason instead of letting it time out
        req = self._swap_req
        if req is not None:
            self._swap_req = None
            req[2]["error"] = RuntimeError(
                "server shut down before the weight swap applied")
            req[1].set()
        self._drained.set()

    def _set_gauges(self) -> None:
        _G_queue.set(self._q.qsize() + len(self._waiting))
        _G_inflight.set(len(self._slots) + len(self._prefilling))

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = 300.0) -> bool:
        """Stop the server. ``drain=True`` lets in-flight and queued
        requests finish while new submissions are rejected;
        ``drain=False`` also cancels everything still queued. Returns
        True once the loop has fully drained (the thread is joined)."""
        with self._submit_lock:
            self._stopping.set()
        if not drain:
            self._cancel_waiting = True
            while True:
                try:
                    req = self._q.get_nowait()
                except _queue.Empty:
                    break
                if req is not self._STOP:
                    self._fail(req, RuntimeError(
                        "request cancelled: server shut down before "
                        "admission"))
        self._q.put(self._STOP)  # wake an idle loop
        drained = self._drained.wait(timeout)
        if drained:
            self._thread.join(timeout)
        if self._metrics_server is not None:
            try:
                self._metrics_server.close()
            finally:
                self._metrics_server = None
        return drained

    @staticmethod
    def trace(request_id) -> List[dict]:
        """The flight-recorder lifecycle trail of ONE request (its
        ``trace_id`` or the dict :meth:`submit` returned)."""
        tid = (request_id.get("trace_id")
               if isinstance(request_id, dict) else request_id)
        return _flight.events(trace_id=tid)

    def stats(self) -> Dict[str, int]:
        with self._q.mutex:  # don't count _STOP sentinels as work
            queued = sum(1 for r in self._q.queue
                         if r is not self._STOP
                         and not r["done"].is_set())
        out = {"steps_run": self.steps_run, "admitted": self.admitted,
               "rejected": self.rejected, "shed": self.shed,
               "deadline_rejected": self.deadline_rejected,
               "deadline_expired": self.deadline_expired,
               "weight_swaps": self.weight_swaps,
               "tokens_delivered": self.tokens_delivered,
               "loop_restarts": self.loop_restarts,
               "recovered": self.recovered,
               "quarantined": self.quarantined,
               "crashed": int(self._crashed),
               "in_flight": len(self._slots), "queued": queued,
               "prefilling": len(self._prefilling),
               "waiting_for_blocks": len(self._waiting),
               "draining": int(self._stopping.is_set()),
               "drained": int(self._drained.is_set())}
        if self._paged:
            out["kv_pool"] = self.engine._kv.stats()
        return out
