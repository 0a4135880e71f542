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

Left for later slices: speculative decoding, weight hot-swap, warm
bundles, ``export_decode``, the ``int8=True`` s8 projections, the
supervisor and adaptive admission, and CUDA graphs for the step.
"""
from __future__ import annotations

import itertools
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
_M_shed = _M.counter(
    "shed_total",
    "Submissions rejected by the load-shedding policy (block pool "
    "exhausted AND the deferred list over FLAGS_serving_shed_queue)")
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
    default path) or ``"reference"`` (the plain walk, by name)."""

    paged = False

    def __init__(self, model, max_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None,
                 num_layers: Optional[int] = None, device=None,
                 attention_impl: str = "kernel"):
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
        self.params = self._build_params(model.state_dict())
        d2 = self.head_dim // 2
        self._inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(
            0, d2, dtype=torch.float32, device=self.device) / d2))

        S = self.max_slots
        self.pos = np.zeros(S, np.int32)          # next cache index
        self.active = np.zeros(S, bool)
        self.last_ids = np.zeros((S, 1), np.int32)
        # logits behind the latest greedy tokens: [S, V] after step(),
        # [V] after a prompt's final prefill (a view, not a copy)
        self.last_logits: Optional[torch.Tensor] = None
        self._attend_tile = next(
            ts for ts in (128, 64, 32, 16, 8, 4, 2, 1)
            if self.max_seq % ts == 0)
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
    """

    paged = True
    _prefix_metrics = True

    def __init__(self, model, max_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 num_layers: Optional[int] = None, device=None,
                 attention_impl: str = "kernel"):
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
                         device=device, attention_impl=attention_impl)

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
        are rebuilt as fresh zeros."""
        for s in range(self.max_slots):
            self._kv.release(s, evicted=True)
        self._kv.reset_prefix_cache()
        self.prefix_hit_tokens.clear()
        self._prefill_state.clear()
        self.pos[:] = 0
        self.active[:] = False
        self.last_ids[:] = 0
        self.kvs = self._alloc_pools()

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

    def _decode_logits(self, ids, pos: np.ndarray) -> torch.Tensor:
        """One token for every slot at write positions ``pos`` [S];
        inactive slots neither write nor advance. The walk is bounded by
        the LONGEST history, so short batches pay only their own
        tiles."""
        return self._forward_paged(
            ids, pos[:, None], self._kv.block_tables,
            self.active[:, None],
            int(pos.max()) // self.block_size + 1)[:, -1]

    # -- host orchestration -------------------------------------------------
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
        reserve its worst-case generation budget. Returns False when the
        pool cannot cover it right now (the caller keeps it queued);
        raises ValueError for a request the pool could NEVER hold."""
        prompt_ids = self._check_prompt(prompt_ids)
        n = int(prompt_ids.shape[0])
        budget = max(int(max_new_tokens), 1)
        total = min(n + budget, self.max_seq)
        if not self._kv.admit(slot, n, total, token_ids=prompt_ids):
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
        c = min(self.prefill_chunk_len, n - start)
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
        if st["next"] < n:
            return None
        self.last_logits = logits[0, -1]
        first = int(self.last_logits.argmax())
        del self._prefill_state[slot]
        self.pos[slot] = n
        self.active[slot] = True
        self.last_ids[slot, 0] = first
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
        .active)."""
        self._extend_tables()
        return super().step()

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
        into ``serving.block_evictions_total``."""
        self.active[slot] = False
        self.pos[slot] = 0
        self._prefill_state.pop(slot, None)
        self.prefix_hit_tokens.pop(slot, None)
        self._kv.release(slot, evicted=evicted)


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
    ``t_first`` (first token) on the host's monotonic clock."""

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
        self.deadline_expired = 0
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
                toks = eng.step()
                self.steps_run += 1
                _M_steps.inc()
                for slot in list(self._slots):
                    req = self._slots[slot]
                    req["out"].append(int(toks[slot]))
                    self.tokens_delivered += 1
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
               "deadline_expired": self.deadline_expired,
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
