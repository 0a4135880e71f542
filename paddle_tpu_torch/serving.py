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

Host orchestration mirrors the JAX package: slot positions, block
tables, write targets and the walk's tile count are host values, so
each step moves a few small index tensors to the card and reads back
one token per slot.

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

Left for later slices: warm bundles, ``export_decode``, the
``int8=True`` s8 projections, the supervisor and canary ``rollout``,
checkpoint paths as a swap source, and CUDA graphs for the step.
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
from .observability import flight as _flight
from .observability import metrics as _om

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


class LlamaDecodeEngine:
    """Decode engine for a ``LlamaForCausalLM`` over a dense cache.

    Host-side state per slot: position, active flag, last token.
    Device-side: the weights (views of the model's tensors when dtype
    and device already match — no second copy) and the K/V caches,
    updated in place.

    ``device`` defaults to ``cuda`` (raises without it unless
    ``device="cpu"``); ``attention_impl`` is ``"kernel"`` (the seam's
    default path) or ``"reference"`` (the plain walk, by name).

    ``num_layers`` below the model's depth builds the TRUNCATED-LAYER
    view (first N decoder layers + the full norm and head);
    ``share_params`` (another engine's ``params``) re-binds that
    engine's tensors instead of building weights — the draft of
    speculative decoding costs no second weight set (``make_draft``)."""

    paged = False

    def __init__(self, model, max_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None,
                 num_layers: Optional[int] = None, device=None,
                 attention_impl: str = "kernel",
                 share_params: Optional[Dict[str, object]] = None):
        cfg = model.config
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.eos_id = eos_id
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
        d2 = self.head_dim // 2
        self._inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(
            0, d2, dtype=torch.float32, device=self.device) / d2))

        S = self.max_slots
        self.pos = np.zeros(S, np.int32)          # next cache index
        self.active = np.zeros(S, bool)
        self.last_ids = np.zeros((S, 1), np.int32)
        # logits behind the latest greedy tokens: [S, V] after step(),
        # [S, k+1, V] after spec_step(), [V] after a prompt's final
        # prefill (a view, not a copy)
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
        self._init_cache()

    def _build_params(self, sd) -> Dict[str, object]:
        """Device weights from the model's state dict: the port's
        projections are already ``[out, in]`` (``torch.nn.Linear``), the
        layout ``_mm`` contracts, so nothing is transposed here — and a
        tensor already in the engine's dtype and device is shared, not
        copied."""
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
            layers.append(lp)
        p["layers"] = layers
        return p

    @staticmethod
    def _leaf_specs(p) -> Dict[str, tuple]:
        """leaf name -> (shape, dtype, device) of a weight tree."""
        def spec(v):
            return (tuple(v.shape), str(v.dtype), str(v.device))

        out: Dict[str, tuple] = {}
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
        independent draft keeps its own weights."""
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

    def reset_state(self) -> None:
        """Discard ALL slot and cache state: fresh zero caches replace
        the old ones and the host bookkeeping resets."""
        self.pos[:] = 0
        self.active[:] = False
        self.last_ids[:] = 0
        self._alloc_cache()

    def _alloc_cache(self) -> None:
        """(Re)allocate the dense per-layer cache tensors as zeros."""
        S, L = self.max_slots, self.n_layers
        kvh = self.cfg.num_key_value_heads
        shape = (S, self.max_seq, kvh, self.head_dim)
        self.k_cache = [torch.zeros(shape, dtype=self.dtype,
                                    device=self.device) for _ in range(L)]
        self.v_cache = [torch.zeros_like(self.k_cache[0])
                        for _ in range(L)]

    def _init_cache(self) -> None:
        """Build the DENSE cache layout (the paged engine overrides)."""
        self._alloc_cache()
        nb = self.max_seq // self._attend_tile
        # the identity block tables of the dense cache viewed as a pool
        self._dense_tables = torch.arange(
            self.max_slots * nb, dtype=torch.int32,
            device=self.device).view(self.max_slots, nb)

    # -- math ---------------------------------------------------------------
    # Weights are [out, in] and contracted against their LAST dim.
    def _mm(self, h, w):
        """h @ w^T, accumulated in f32 and cast to h's dtype (on the
        card a bf16 GEMM accumulates in f32 and rounds its output)."""
        return F.linear(h, w)

    def _rms(self, h, w):
        h32 = h.float()
        var = h32.square().mean(dim=-1, keepdim=True)
        return (h32 * torch.rsqrt(var + self.cfg.rms_norm_eps)).to(
            h.dtype) * w

    def _rope_cos_sin(self, positions):
        """cos/sin ``[S, T, 1, D/2]`` at per-slot absolute positions
        (positions [S, T]) — computed once per forward and shared by
        every layer's rotation."""
        freqs = positions.float()[..., None] * self._inv_freq
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

    def _head(self, h):
        return self._mm(self._rms(h, self.params["norm"]),
                        self.params["head"])

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

    def _forward(self, ids, positions, slots, tables, n_tiles):
        """ids [S', T] at positions [S', T] of cache rows ``slots`` [S']
        -> logits [S', T, V]; each layer writes its K/V rows in place."""
        dev = self.device
        ids = torch.as_tensor(ids).to(dev, torch.long)
        pos = torch.as_tensor(positions).to(dev, torch.int32)
        slots = torch.as_tensor(slots).to(dev, torch.long)
        nt = torch.tensor([n_tiles], dtype=torch.int32, device=dev)
        wslots = slots[:, None].expand(pos.shape)
        wcols = pos.long()
        cos, sin = self._rope_cos_sin(pos)
        h = F.embedding(ids, self.params["emb"]).to(self.dtype)
        for li, lp in enumerate(self.params["layers"]):
            kc, vc = self.k_cache[li], self.v_cache[li]
            q, k, v = self._qkv(lp, self._rms(h, lp["in_ln"]), cos, sin)
            kc.index_put_((wslots, wcols), k)
            vc.index_put_((wslots, wcols), v)
            att = self._attend(q, kc, vc, tables, pos, nt)
            h = h + self._mm(att.reshape(h.shape), lp["o_proj"])
            h = self._ffn(lp, h)
        return self._head(h)

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

    def prefill(self, slot: int, prompt_ids) -> int:
        """Load a prompt into ``slot``'s cache rows; returns the first
        generated token (greedy)."""
        prompt_ids = self._check_prompt(prompt_ids)
        n = int(prompt_ids.shape[0])
        logits = self._forward(
            prompt_ids[None, :], np.arange(n, dtype=np.int32)[None, :],
            [slot], self._dense_tables[slot:slot + 1],
            (n - 1) // self._attend_tile + 1)
        self.last_logits = logits[0, -1]
        first = int(self.last_logits.argmax())
        self._count_pa_path()
        self.pos[slot] = n
        self.active[slot] = True
        self.last_ids[slot, 0] = first
        return first

    def _decode_logits(self, ids, pos: np.ndarray) -> torch.Tensor:
        """Last-position logits [S, V] of one token for every slot at
        write positions ``pos`` [S] (inactive slots write row 0 of their
        own cache, which their next prefill overwrites)."""
        return self._forward(
            ids, pos[:, None], np.arange(self.max_slots),
            self._dense_tables,
            int(pos.max()) // self._attend_tile + 1)[:, -1]

    def step(self) -> np.ndarray:
        """One decode iteration for ALL slots; returns next token per
        slot (garbage for inactive slots — callers consult .active)."""
        act = self.pos[self.active]
        if act.size and int(act.max()) >= self.max_seq:
            raise ValueError(
                f"a decode step would write past the {self.max_seq}-"
                f"token cache (max pos {int(act.max())})")
        self.last_logits = self._decode_logits(self.last_ids, self.pos)
        nxt = self.last_logits.argmax(dim=-1).cpu().numpy()
        self._count_pa_path()
        for s in range(self.max_slots):
            if self.active[s]:
                self.pos[s] += 1
                self.last_ids[s, 0] = nxt[s]
        return nxt

    def decode_steps(self, n: int) -> np.ndarray:
        """``n`` chained decode iterations with the tokens kept on the
        card between steps and ONE host fetch at the end. Every slot
        must be active; returns [S, n] generated tokens."""
        if not self.active.all():
            raise ValueError(
                "decode_steps advances EVERY slot; use step() when some "
                "slots are free (the continuous-batching server path)")
        self._check_window(n)
        buf = torch.empty((self.max_slots, n), dtype=torch.long,
                          device=self.device)
        ids = torch.as_tensor(self.last_ids).to(self.device)
        for i in range(n):
            nxt = self._decode_logits(ids, self.pos + i).argmax(dim=-1)
            buf[:, i] = nxt
            ids = nxt[:, None]
        self._count_pa_path(n)
        toks = buf.cpu().numpy().astype(np.int32)   # the one fetch
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


class PagedLlamaDecodeEngine(LlamaDecodeEngine):
    """Paged-KV decode engine: the dense engine's math over a
    **block-pool cache**.

    Layout: one shared pool per layer ``[num_blocks, block_size, KVH,
    D]`` (``serving_cache.PagedKVCache``) addressed through per-slot
    block tables. Admission reserves a request's worst-case block count
    (prompt + generation budget), prompt blocks are mapped at once, and
    decode extends one block at a time at step boundaries — extension
    can never fail mid-stream.

    Prefill is CHUNKED: ``begin_request`` allocates, then
    ``prefill_chunk`` runs at most ``FLAGS_serving_prefill_chunk``
    prompt tokens per call, writing K/V straight into the slot's blocks
    (a chunk runs at its exact length: eager PyTorch needs no shape
    buckets). The GenerationServer interleaves one chunk with each
    decode step.

    ``kv_quant``: None stores blocks in the model dtype, "bfloat16"
    halves f32 pools, "int8" stores absmax codes + per-(token, head)
    scales, dequantized by the attention as it loads each tile.

    Speculative decoding: ``attach_draft(make_draft())`` and the server
    runs :meth:`spec_step` whenever :meth:`spec_ready`.
    """

    paged = True
    # the process-registry prefix metrics are the target's only: an
    # attached draft mirrors every admission (attach_draft clears this)
    _prefix_metrics = True

    def __init__(self, model, max_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 num_layers: Optional[int] = None, device=None,
                 attention_impl: str = "kernel",
                 share_params: Optional[Dict[str, object]] = None):
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
                         eos_id=eos_id, num_layers=num_layers,
                         device=device, attention_impl=attention_impl,
                         share_params=share_params)

    def _alloc_pools(self) -> Dict[str, list]:
        """Fresh zeroed block pools (per-layer K/V + int8 scales), at
        boot and again at ``reset_state``."""
        kvh = self.cfg.num_key_value_heads
        pool_dt = {"int8": torch.int8,
                   "bfloat16": torch.bfloat16}.get(self.kv_quant,
                                                   self.dtype)
        NB, bs, L = self.num_blocks, self.block_size, self.n_layers
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
        self.kvs = self._alloc_pools()
        self._prefill_state: Dict[int, dict] = {}
        self.prefix_hit_tokens: Dict[int, int] = {}

    def reset_state(self) -> None:
        """Reset over the block pool: every owned slot is released as a
        counted EVICTION, staged prefills are dropped, the radix tree
        empties (its blocks' content dies with the pools) and the pools
        are rebuilt as fresh zeros. An attached draft resets with it."""
        for s in range(self.max_slots):
            self._kv.release(s, evicted=True)
        self._kv.reset_prefix_cache()
        self.prefix_hit_tokens.clear()
        self._prefill_state.clear()
        self.pos[:] = 0
        self.active[:] = False
        self.last_ids[:] = 0
        self.kvs = self._alloc_pools()
        if self._draft is not None:
            self._draft.reset_state()

    # -- device side --------------------------------------------------------
    def _plan_writes(self, positions: np.ndarray, tables: np.ndarray,
                     wmask: np.ndarray) -> _sc.KVWritePlan:
        """Host-side (physical block, offset) cells of the rope'd K/V
        rows at ``positions [S, T]``: rows with ``wmask`` False or an
        unmapped table entry map to ``num_blocks`` and are dropped."""
        bidx = np.minimum(positions // self.block_size,
                          self._kv.max_blocks_per_slot - 1)
        phys = np.take_along_axis(tables, bidx, axis=1)
        ok = np.logical_and(wmask, phys >= 0)
        phys = np.where(ok, phys, self.num_blocks)
        off = positions % self.block_size
        return _sc.plan_kv_writes(phys, off, self.num_blocks, self.device)

    def _write_kv(self, kvl, k, v, plan) -> None:
        """Scatter K/V rows [S, T, KVH, D] into the pools IN PLACE
        (int8 pools take absmax codes + scales)."""
        kf = k.reshape((-1,) + tuple(k.shape[2:]))
        vf = v.reshape((-1,) + tuple(v.shape[2:]))
        if self.kv_quant == "int8":
            kq, ks = _sc.absmax_quantize(kf)
            vq, vs = _sc.absmax_quantize(vf)
            for name, vals in (("k", kq), ("v", vq), ("ksc", ks),
                               ("vsc", vs)):
                _sc.scatter_kv(kvl[name], plan, vals)
        else:
            _sc.scatter_kv(kvl["k"], plan, kf)
            _sc.scatter_kv(kvl["v"], plan, vf)

    def _forward_paged(self, ids, positions: np.ndarray,
                       tables: np.ndarray, wmask: np.ndarray,
                       n_tiles: int) -> torch.Tensor:
        """Shared chunked-prefill/decode body: ids [S, T] at host
        positions [S, T] with host block tables -> logits [S, T, V];
        pool writes land in place. The tables, positions and tile count
        move to the card once and serve every layer."""
        dev = self.device
        ids = torch.as_tensor(ids).to(dev, torch.long)
        plan = self._plan_writes(positions, tables, wmask)
        pos = torch.as_tensor(positions, dtype=torch.int32).to(dev)
        tab = torch.as_tensor(tables, dtype=torch.int32).to(dev)
        nt = torch.tensor([n_tiles], dtype=torch.int32, device=dev)
        cos, sin = self._rope_cos_sin(pos)
        h = F.embedding(ids, self.params["emb"]).to(self.dtype)
        for li, lp in enumerate(self.params["layers"]):
            kvl = {name: pools[li] for name, pools in self.kvs.items()}
            q, k, v = self._qkv(lp, self._rms(h, lp["in_ln"]), cos, sin)
            self._write_kv(kvl, k, v, plan)
            att = _sc.paged_attention(
                q, kvl["k"], kvl["v"], tab, pos,
                block_size=self.block_size, n_rep=self.n_rep,
                n_tiles=nt, k_scale=kvl.get("ksc"),
                v_scale=kvl.get("vsc"), use_kernel=self._use_kernel)
            h = h + self._mm(att.reshape(h.shape), lp["o_proj"])
            h = self._ffn(lp, h)
        return self._head(h)

    def _decode_logits(self, ids, pos: np.ndarray,
                       active: Optional[np.ndarray] = None
                       ) -> torch.Tensor:
        """One token for every slot at write positions ``pos`` [S];
        slots not ``active`` (default: this engine's) neither write nor
        advance. The walk is bounded by the LONGEST history, so short
        batches pay only their own tiles."""
        act = self.active if active is None else active
        return self._forward_paged(
            ids, pos[:, None], self._kv.block_tables, act[:, None],
            int(pos.max()) // self.block_size + 1)[:, -1]

    def _propose(self, last_ids, pos: np.ndarray, active: np.ndarray,
                 k: int) -> torch.Tensor:
        """DRAFT side of a speculative step: ``k`` chained greedy decode
        steps writing this engine's pool at positions [pos, pos + k).
        Each step's tokens feed the next on the card; positions and
        tile counts come from the host's ``pos + i``, so nothing is
        read back. Returns the proposals [S, k] (on the card)."""
        ids = torch.as_tensor(last_ids).to(self.device, torch.long)
        toks = []
        for i in range(k):
            nxt = self._decode_logits(ids, pos + i, active).argmax(dim=-1)
            toks.append(nxt)
            ids = nxt[:, None]
        return torch.stack(toks, dim=1)

    def _spec_verify(self, draft_tok: torch.Tensor):
        """TARGET side: score the whole window in ONE call — ids
        [S, k+1] = [last_id, d1..dk] at positions [pos, pos+k] —
        writing the target's K/V for every window position. Returns the
        greedy targets t [S, k+1] (t[:, i] conditions on the prefix
        through d_i) and the accepted-prefix length n_acc [S] = |leading
        i with d_{i+1} == t_i|, both computed on the card; the window's
        logits stay in ``last_logits``."""
        k = int(draft_tok.shape[1])
        ids = torch.cat([torch.as_tensor(self.last_ids).to(
            self.device, torch.long), draft_tok], dim=1)
        positions = self.pos[:, None] + np.arange(k + 1, dtype=np.int32)
        wmask = np.broadcast_to(self.active[:, None], positions.shape)
        logits = self._forward_paged(
            ids, positions, self._kv.block_tables, wmask,
            (int(self.pos.max()) + k) // self.block_size + 1)
        self.last_logits = logits
        t = logits.argmax(dim=-1)
        match = (draft_tok == t[:, :k]).long()
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)
        return t, n_acc

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
            eos_id=self.eos_id, block_size=self.block_size,
            num_blocks=self.num_blocks, kv_quant=self.kv_quant,
            prefill_chunk=self.prefill_chunk_len, num_layers=n,
            device=self.device, attention_impl=self.attention_impl,
            share_params=self.params)

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
        return self

    def _device_cow(self, slot: int, src: int, dst: int) -> None:
        """Boundary copy-on-write: clone block ``src`` into ``dst`` in
        every pool leaf (per-layer K/V + int8 scales), in place."""
        for pools in self.kvs.values():
            for pool in pools:
                _sc.copy_block(pool, src, dst)
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
        """Run the next prompt chunk for ``slot``. Returns None while
        prefill is incomplete; on the final chunk, activates the slot
        and returns the first generated token (greedy)."""
        st = self._prefill_state[slot]
        ids, start = st["ids"], st["next"]
        n = int(ids.shape[0])
        # _chunk_cap is the adaptive-admission brownout knob (floor 8)
        limit = self.prefill_chunk_len if self._chunk_cap is None \
            else max(8, min(self.prefill_chunk_len, self._chunk_cap))
        c = min(limit, n - start)
        positions = (start + np.arange(c, dtype=np.int32))[None, :]
        logits = self._forward_paged(
            ids[None, start:start + c], positions,
            self._kv.block_tables[slot:slot + 1],
            np.ones((1, c), bool), (start + c - 1) // self.block_size + 1)
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
        self.last_logits = logits[0, -1]
        first = int(self.last_logits.argmax())
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
        self._extend_tables()
        draft = self._draft
        if draft is not None:
            for s in range(self.max_slots):
                if self.active[s]:
                    draft._shared_write_guard(s)
                    draft._kv.ensure_token(s, int(self.pos[s]))
            draft._decode_logits(self.last_ids, self.pos, self.active)
        nxt = super().step()
        if draft is not None:
            for s in range(self.max_slots):
                if self.active[s]:
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

    def spec_step(self):
        """One SPECULATIVE decode iteration for all active slots: the
        draft proposes ``spec_k`` tokens (chained on the card), the
        target verifies the window in one call, and ONE host read of
        ``(t, n_acc)`` closes it — the host-read budget of one plain
        step, for up to ``spec_k`` committed tokens.

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
        draft_tok = draft._propose(self.last_ids, self.pos, self.active,
                                   k)
        t, n_acc = self._spec_verify(draft_tok)
        self._count_pa_path()
        host = torch.cat([t, n_acc[:, None]], dim=1).cpu().numpy()
        toks = host[:, :k + 1].astype(np.int32)       # the one read
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
        mapped up front."""
        if not self.active.all():
            raise ValueError(
                "decode_steps advances EVERY slot; use step() when "
                "some slots are free (the continuous-batching server "
                "path)")
        self._check_window(n)
        for s in range(self.max_slots):
            self._shared_write_guard(s)
            self._kv.reserve_through(s, int(self.pos[s]) + n - 1)
        return super().decode_steps(n)

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
    ``metrics_endpoint`` serves the metrics registry over HTTP."""

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
        self._crashed = False
        self._crash_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-loop")
        self._thread.start()

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
    def _swap_state(source) -> dict:
        """A swap source as a model state dict, on the caller's thread:
        a flat ``{name: tensor}`` mapping, or one nested under a
        ``model`` / ``state_dict`` / ``params`` key. Checkpoint paths
        and checkpoint managers need ``framework/checkpoint.py``, which
        the port does not have yet: they raise."""
        if isinstance(source, (str, bytes, os.PathLike)) \
                or hasattr(source, "restore"):
            raise NotImplementedError(
                "swap_weights from a checkpoint path or CheckpointManager "
                "needs framework/checkpoint.py, which is not ported yet: "
                "load the checkpoint yourself and pass its state dict")

        def flat(d):
            return (isinstance(d, dict) and d
                    and all(isinstance(k, str) for k in d)
                    and all(hasattr(v, "shape") for v in d.values()))

        if isinstance(source, dict):
            for key in ("model", "state_dict", "params"):
                if flat(source.get(key)):
                    return source[key]
            if flat(source):
                return source
        raise ValueError(
            "cannot find a model state dict in the swap source — "
            "expected a flat {name: tensor} mapping or one nested under "
            "a 'model'/'state_dict'/'params' key")

    def swap_weights(self, state_dict=None,
                     timeout: Optional[float] = 300.0, *,
                     prepared=None) -> dict:
        """Install new weights into the running engine BETWEEN decode
        steps, dropping no in-flight request: their KV blocks and
        partial streams are untouched and the next step runs on the new
        weights (a weight-sharing draft follows in the same swap).

        ``state_dict`` is a model state dict (see :meth:`_swap_state`);
        its weights are prepared on THIS thread
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
            sd = self._swap_state(state_dict)
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
        req["t_first"] = time.monotonic()
        self._slots[slot] = req

    def _admit_one(self, req, slot) -> None:
        if self._expired(req):
            self._expire(req, "while queued")
            return
        req["t_admit"] = time.monotonic()
        _M_queue_s.observe(req["t_admit"] - req["t0"])
        try:
            first = self.engine.prefill(slot, req["prompt"])
        except Exception as e:  # noqa: BLE001 — surfaced per request
            self._fail(req, e)
            return
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
        if req is self._STOP or req["done"].is_set():
            return "dropped"
        if self._expired(req):
            self._expire(req, "while queued")
            return "dropped"
        try:
            ok = self.engine.begin_request(
                slot, req["prompt"], max(req["max_new"] - len(req["out"]),
                                         1))
        except Exception as e:  # noqa: BLE001 — surfaced per request
            self._fail(req, e)
            return "dropped"
        if not ok:
            return "defer"
        req["t_admit"] = time.monotonic()
        _M_queue_s.observe(req["t_admit"] - req["t0"])
        req["prefix_hit_tokens"] = self.engine.prefix_hit_tokens.get(
            slot, 0)
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
                del self._prefilling[slot]
                self._release_slot(slot, evicted=True)
                self._fail(req, e)
                return
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
        while True:
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
                    req = self._q.get()
                    if req is self._STOP or req["done"].is_set():
                        continue
                    if self._paged:
                        if self._admit_paged(req, self._free_slots()[0]) \
                                == "defer":
                            self._waiting.append(req)
                        continue
                    self._admit_one(req, self._free_slots()[0])
                    continue
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
               "crashed": int(self._crashed),
               "in_flight": len(self._slots), "queued": queued,
               "prefilling": len(self._prefilling),
               "waiting_for_blocks": len(self._waiting),
               "draining": int(self._stopping.is_set()),
               "drained": int(self._drained.is_set())}
        if self._paged:
            out["kv_pool"] = self.engine._kv.stats()
        return out
