#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and MoE paths on one card.

Run from the root of a checkout on a machine with a Hopper card:

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. ``env``            card name and power limit, torch and CUDA versions;
2. ``build``          compiles every kernel from ``paddle_tpu_torch``'s
                      sources with nvcc (sm_90a), one process per source,
                      printing ptxas' report; fails if the TMA flash
                      kernels spill;
3. ``kernel_parity``  the paged-attention kernel against its plain walk
                      on the card, over the serving geometries (decode,
                      GQA, prefill chunk, dense whole-prompt prefill,
                      int8 pools, the int8-KV engine's own shapes, f32,
                      poisoned blocks), and against the same walk on
                      f32 copies of the inputs (the kernel's arithmetic)
                      within one bf16 rounding of the output;
4. ``kernel_time``    the kernel, the plain walk and PyTorch's
                      scaled_dot_product_attention (a yardstick only)
                      at the decode geometry, beside the memory bound;
5. ``serve``          THE SERVING PATH: a Llama-2-7B-width bf16 model with
                      random weights behind a PagedLlamaDecodeEngine and
                      a GenerationServer answers 12 requests; the kernel
                      launch count is reset just before and read just
                      after, and must equal layers x (decode steps +
                      prefill chunks); then a 4-layer int8-KV engine
                      answers 2 more requests through the kernel;
6. ``serve_parity``   an engine built with attention_impl="reference"
                      over the same weights runs one prompt beside a
                      kernel engine: logits compared, greedy agreement
                      printed;
7. ``flash_parity``   the flash-attention forward, dQ and dK/dV kernels
                      against their plain versions on the card, bf16 and
                      f32, at the training geometry (B 4, L 2048, H 32,
                      D 128) causal and full, D 64 through the [BH, L, D]
                      strides, a ragged L, L = 1 and q, k, v as strided
                      views of one [B, L, 3, H, D] projection: each call's
                      counts must show the design takes_tma names (the
                      TMA / wgmma kernels for bf16 at D 128, the first
                      design for f32 and D 64); elementwise against the
                      plain version in the working dtype (the same
                      roundings), and in RMS against the plain version on
                      f32 copies of the inputs; then the FlashAttention
                      autograd function against autograd through the
                      plain sdpa;
8. ``flash_time``     the three kernels, the whole backward (with delta)
                      and forward + backward at the training geometry
                      (the TMA design, and the first design on the same
                      inputs through its C entries: general_ms) and at D
                      64 in the [BH, L, D] layout (BERT-base heads),
                      beside their plain versions, their bounds and
                      PyTorch's scaled_dot_product_attention (a
                      yardstick only);
9. ``train``          THE TRAINING PATH: a Llama-2-7B-width bf16 model
                      (4 layers, random weights) trains with AdamW
                      through TrainStep on a batch of 4 x 2048 tokens:
                      2 warm-up and 5 timed steps; the three flash
                      launch counts and their TMA counts are reset just
                      before the timed steps and read just after, and
                      must each equal layers x timed steps; losses finite
                      and falling; then one step under torch.profiler;
10. ``train_parity``  one step of the same widths at 2 layers through
                      the kernels against the same step with
                      use_flash_attention=False (autograd through the
                      plain sdpa): loss and every gradient compared;
11. ``flash_dropout_parity``  attention dropout inside the three flash
                      kernels (K5) at the BERT-base geometry (B 24, L 512,
                      H 12, D 64, bf16) and a small f32 case, p = 0.1,
                      causal and full: each kernel against its plain
                      version with the same seed (working dtype and f32
                      copies), the keep rate of the mask, p = 0 equal to
                      the launch without dropout, two seeds differing, and
                      the FlashAttention autograd function against
                      autograd through the plain sdpa with the same mask;
12. ``flash_varlen_parity``  the segment-masked kernels (K4) on 12,288
                      packed tokens (sequences of 32-512 from a numpy
                      seed, H 12, D 64), bf16 and f32, causal and full:
                      against their plain versions and against the plain
                      sdpa with the block-diagonal mask; then the packed
                      entry flash_attn_varlen_qkvpacked, forward and
                      backward, with the segmented launch counts reset
                      just before and read just after;
13. ``flash_time_bert``  the kernels with and without dropout at the BERT
                      geometry and the segmented kernels at the packed
                      geometry, beside their plain versions, their
                      bounds (the pairs the function needs) and
                      PyTorch's SDPA (a yardstick);
14. ``bert_train``    THE BERT PATH: BERT-base MLM (12 layers, hidden 768,
                      vocab 30522, bf16, dropout 0.1) trains with AdamW
                      through TrainStep on 24 x 512 tokens: 2 warm-up and
                      5 timed steps; the flash launch counts (and their
                      dropout launches) are reset just before the timed
                      steps and read just after, and must each equal
                      layers x timed steps; losses finite and falling;
                      then one step under torch.profiler;
15. ``bert_train_parity``  one step of BERT-base widths at 2 layers
                      through the kernels against the same step through
                      the plain sdpa (an all-zero additive mask routes it
                      there) with the same seeds drawn in the same order:
                      loss and every gradient compared;
16. ``gmm_parity``    the grouped-matmul kernels (K6 forward, K6 as dlhs on
                      the transposed weights, K7 drhs) against their plain
                      versions, bf16 and f32, on the op bench's geometry,
                      ERNIE-MoE's expert FFN (w_in and w_out at 8 x 5120
                      rows), a ragged layout with an empty expert and
                      padding rows, an unaligned one (K 200, N 72), a
                      given tile map, 64 groups of 0-200 rows (numpy
                      seed), row ranges ending inside K7's 64-row boxes
                      and K 37, N 45: elementwise in the working dtype and
                      in RMS against the plain versions on f32 copies;
                      each call's per-design counts must show the TMA /
                      wgmma kernels for bf16 with 16-byte rows and the
                      general mma.sync kernels for f32 and K 37, N 45;
                      then GroupedMatmul's autograd against autograd
                      through the dense oracle;
17. ``gmm_op``        THE OP PATH: one forward + backward through the
                      grouped_matmul entry at the op bench's geometry
                      (bf16); the three counts and their TMA counts are
                      reset just before and read just after: K6 twice
                      (forward, dlhs), K7 once, all through the TMA
                      kernels;
18. ``gmm_time``      the three kernels at the op bench's geometry and at
                      ERNIE-MoE's w_in and w_out products (the TMA
                      kernels), beside the first design's general kernels
                      on the same inputs, their plain versions, their
                      bounds, torch.bmm over the equal groups and
                      torch._grouped_mm (yardsticks);
19. ``moe_train``     THE ERNIE-MOE PATH: ERNIE-MoE at ErnieMoEConfig()
                      (12 layers, 6 of them MoE with 8 experts, top-2,
                      hidden 768, vocab 30522, bf16) trains with AdamW
                      through TrainStep on 8 x 2048 tokens with the LM loss
                      plus the aux loss: 2 warm-up and 5 timed steps; the
                      flash launch counts (causal, D 64) are reset just
                      before the timed steps and read just after, and must
                      each equal layers x timed steps; losses finite and
                      falling; the share of token choices capacity drops
                      per MoE layer; then one step under torch.profiler;
20. ``moe_train_parity``  one step of a 2-layer ERNIE-MoE (one dense, one
                      MoE layer) through the kernels against the same step
                      through the plain sdpa: loss, every gradient and the
                      share of tokens whose top-2 experts differ.

Then the ``nvidia-smi`` name/power line, the ``{"kernels": [...]}`` line
(K3, K1b and K2b at the Llama training geometry, K5 in K1a/K2a at the
BERT geometry, K4 at the packed geometry, K6 and K7 at the op bench's
geometry, each flash and K6/K7 row naming the design it timed, its TMA
launches and the first design's time where the TMA design took it)
and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Without CUDA, or when run outside a checkout, it
exits non-zero and prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0                         # weights, prompts and inputs
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense tensor-core peak
# kernel vs the plain walk on the same inputs, abs + rel: in bf16 the
# walk rounds dequantized tiles and the probabilities to bf16 before
# the PV product, where the kernel stays in f32
F32_TOL = 1e-4
BF16_TOL = 2e-2
# kernel vs the walk run on f32 copies of the same inputs, which does
# the kernel's all-f32 arithmetic: the only differences left are the
# f32 summation order (OUT_ATOL) and, for a bf16 output, one rounding
# of the output to bf16 (< 2^-8 relative)
OUT_ATOL = 1e-5
OUT_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# end-to-end logits of the kernel engine vs the reference-walk engine,
# bf16 at 32 layers: the walk rounds the probabilities to bf16 before
# the PV product where the kernel stays in f32, and the difference
# compounds through the layers (|logits| reach ~2)
LOGITS_ATOL = 0.1
LOGITS_RTOL = 0.02
# flash kernels vs their plain versions in the working dtype, which do
# the same roundings (P and dS to the input dtype, f32 accumulation):
# elementwise |err| <= tol * (1 + |ref|); in bf16 what is left is the
# f32 summation order flipping a rounding by one bf16 ulp
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# ... and in RMS against the plain versions on f32 copies of the inputs
# (no P/dS/output rounding): rms(err) <= r * rms(ref) + 1e-5; in bf16
# the kernel's roundings of P (or dS) and of the output, each < 2^-9
# relative, add up to about one rounding in RMS, and r = 2^-8 allows two
FLASH_RMS = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
FLASH_RMS_ATOL = 1e-5
# FlashAttention's autograd vs autograd through the plain sdpa, relative
# RMS of out and each gradient: in bf16 the sdpa rounds the logits and
# the PV product's output to bf16, where the kernels keep f32
AUTOGRAD_RMS = {"float32": 1e-5, "bfloat16": 2e-2}
# train_parity, bf16 at 2 layers: the loss and each parameter's gradient
# (relative RMS) through the kernels vs through the plain sdpa; the
# differences are the sdpa's bf16 roundings above, carried through the
# layers into bf16 gradients
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RMS = 5e-2
TRAIN = dict(batch=4, seq=2048, layers=4, warmup=2, steps=5, lr=3e-4)
# BERT-base MLM, the JAX bench's configuration (bench.py:803-840)
BERT = dict(batch=24, seq=512, layers=12, warmup=2, steps=5, lr=1e-4,
            dropout=0.1)
BERT_SHAPE = (24, 512, 12, 64)       # [B, L, H, D] of its attention
VARLEN = dict(total=12288, heads=12, head_dim=64, min_len=32, max_len=512)
# bert_train_parity, bf16 at 2 layers with dropout 0.1: the kernels vs
# the plain sdpa with the same keep masks; besides train_parity's
# roundings, the plain sdpa divides the bf16 probabilities by bf16(0.9)
# where the kernels scale the f32 accumulator by 1/0.9
BERT_LOSS_RTOL = 1e-2
BERT_GRAD_RMS = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, samples: int = 20, inner: int = 5, warmup: int = 3):
    """Median over ``samples`` of the CUDA-event time of ``inner``
    back-to-back calls, per call (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel geometries
# ---------------------------------------------------------------------------

def make_case(name, S, T, H, K, D, bs, MB, dtype, pos, quant=False,
              poison=False, n_tiles=None, seed=0):
    """Seeded inputs on the card for one paged-attention geometry.
    ``pos`` [S] is each slot's last position; row t of slot s sits at
    ``pos[s] - T + 1 + t``."""
    import torch
    from paddle_tpu_torch.serving_cache import absmax_quantize
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    NB = S * MB + 2
    q = torch.randn((S, T, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((NB, bs, K, D), generator=g, device=dev)
    vp = torch.randn((NB, bs, K, D), generator=g, device=dev)
    first = 1 if poison else 0
    perm = torch.randperm(NB - first, generator=g, device=dev) + first
    tables = perm[:S * MB].view(S, MB).to(torch.int32).contiguous()
    last = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    positions = (last[:, None] - (T - 1)
                 + torch.arange(T, dtype=torch.int32, device=dev)[None])
    if poison:
        # every tile past a slot's last one is unmapped (-1 clamps to
        # the poisoned block 0), and block 0 holds NaN/inf
        for s in range(S):
            tables[s, int(pos[s]) // bs + 1:] = -1
        kp[0] = float("nan")
        vp[0] = float("inf")
    kw = dict(block_size=bs, n_rep=H // K, n_tiles=n_tiles)
    if quant:
        kq, ks = absmax_quantize(kp.view(NB * bs, K, D))
        vq, vs = absmax_quantize(vp.view(NB * bs, K, D))
        kp, vp = kq.view(NB, bs, K, D), vq.view(NB, bs, K, D)
        kw.update(k_scale=ks.view(NB, bs, K).contiguous(),
                  v_scale=vs.view(NB, bs, K).contiguous())
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return {"name": name, "args": (q, kp, vp, tables, positions),
            "kw": kw, "tol": F32_TOL if dtype == torch.float32
            else BF16_TOL, "pos": list(pos), "geometry": dict(
                S=S, T=T, H=H, KVH=K, D=D, bs=bs, MB=MB,
                dtype=str(dtype).replace("torch.", ""),
                pools="int8" if quant else str(dtype).replace(
                    "torch.", ""))}


def decode_case():
    import torch
    # the serve geometry: 8 slots of a Llama-2-7B layer at 2048 context
    return make_case("decode", 8, 1, 32, 32, 128, 16, 128, torch.bfloat16,
                     [2047, 1900, 1536, 1024, 700, 300, 100, 17])


def parity_cases():
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    return [
        decode_case(),
        make_case("gqa_decode", 4, 1, 32, 8, 128, 16, 32, bf,
                  [511, 400, 77, 0], seed=1),
        make_case("gqa_verify_t5", 4, 5, 32, 8, 128, 16, 32, bf,
                  [511, 333, 64, 4], seed=2),
        make_case("prefill_chunk", 1, 64, 32, 32, 128, 16, 128, bf,
                  [575], seed=3),
        make_case("dense_prefill", 1, 512, 32, 32, 128, 128, 16, bf,
                  [511], seed=4),
        make_case("int8_pools", 4, 1, 32, 8, 128, 16, 32, bf,
                  [500, 250, 31, 1], quant=True, seed=5),
        make_case("int8_pools_t8", 2, 8, 32, 8, 128, 16, 32, bf,
                  [300, 20], quant=True, seed=6),
        # the serve phase's int8-KV engine: MHA (R = 1), 2 slots of
        # 1024 tokens; its decode step and one 64-row prefill chunk
        make_case("int8_engine_decode", 2, 1, 32, 32, 128, 16, 64, bf,
                  [1023, 231], quant=True, seed=11),
        make_case("int8_engine_prefill_chunk", 1, 64, 32, 32, 128, 16, 64,
                  bf, [199], quant=True, seed=12),
        make_case("f32_d64", 4, 3, 8, 4, 64, 16, 16, f32,
                  [255, 130, 40, 2], seed=7),
        make_case("f32_int8_d64", 3, 2, 8, 2, 64, 16, 16, f32,
                  [200, 17, 1], quant=True, seed=8),
        make_case("poisoned_ntiles", 4, 1, 32, 8, 128, 16, 32, bf,
                  [200, 150, 47, 5], poison=True, n_tiles=13, seed=9),
        make_case("poisoned_f32", 2, 4, 8, 8, 64, 16, 16, f32,
                  [100, 60], poison=True, seed=10),
    ]


def phase_kernel_parity(result):
    import torch
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_reference)
    rows = []
    worst = worst32 = 0.0
    for case in parity_cases():
        got = paged_attention_kernel(*case["args"], **case["kw"])
        torch.cuda.synchronize()
        g = got.float()
        ref = paged_attention_reference(*case["args"], **case["kw"])
        # the same walk over f32 copies of the same inputs (int8 codes
        # and their scales stay as they are: the walk dequantizes into
        # q's dtype, now f32)
        q, kp, vp, tables, positions = case["args"]
        if kp.dtype != torch.int8:
            kp, vp = kp.float(), vp.float()
        ref32 = paged_attention_reference(q.float(), kp, vp, tables,
                                          positions, **case["kw"])
        out_dtype = case["geometry"]["dtype"]
        tol, rtol32 = case["tol"], OUT_RTOL[out_dtype]
        checks = {}
        for key, r, atol, rtol in (("walk", ref.float(), tol, tol),
                                   ("f32_walk", ref32, OUT_ATOL, rtol32)):
            fin = torch.isfinite(r)
            if not bool(torch.isfinite(g)[fin].all()):
                raise AssertionError(f"{case['name']}: non-finite kernel "
                                     f"output where the {key} is finite")
            err = (g - r).abs()[fin]
            # the share of the tolerance used, worst element; > 1 fails
            checks[key] = (float(err.max()), float(
                (err / (atol + rtol * r[fin].abs())).max()))
        (mae, used), (mae32, used32) = checks["walk"], checks["f32_walk"]
        rows.append({"case": case["name"], **case["geometry"],
                     "max_abs_err": mae, "tol": tol,
                     "tol_used": used, "max_abs_err_f32_walk": mae32,
                     "tol_f32_walk": {"atol": OUT_ATOL, "rtol": rtol32},
                     "tol_f32_walk_used": used32,
                     "ok": used <= 1 and used32 <= 1})
        if not rows[-1]["ok"]:
            emit({"phase": "kernel_parity", "failed": rows[-1]})
            raise AssertionError(
                f"{case['name']}: kernel disagrees with the walk "
                f"(max abs err {mae}, tolerance {tol} abs/rel) or with "
                f"the f32 walk (max abs err {mae32}, tolerance "
                f"{OUT_ATOL} + {rtol32} rel)")
        if case["name"] == "decode":
            result["max_abs_err"] = mae
        worst = max(worst, mae)
        worst32 = max(worst32, used32)
    result["parity"] = "ok"
    return {"cases": rows, "worst_abs_err": worst,
            "worst_tol_f32_walk_used": worst32}


def decode_bytes_and_flops(case, n_tiles):
    """What the decode call (T = 1) must move and do at these inputs:
    the K/V of the columns the rows attend (slot s: columns 0..pos_s),
    q, out, the table entries walked (slot s: min(n_tiles, the tiles
    its columns span)), the positions and n_tiles; and 2 flops per MAC
    of QK and PV over those columns."""
    import torch
    q, kp, _vp, _tables, positions = case["args"]
    S, T, H, D = q.shape
    assert T == 1, "the count assumes one query row a slot"
    bs, K = kp.shape[1], kp.shape[2]
    live_cols = sum(p + 1 for p in case["pos"])
    kv = live_cols * K * D * 2 * kp.element_size()
    if kp.dtype == torch.int8:
        kv += live_cols * K * 2 * 4
    walked = sum(min(n_tiles, p // bs + 1) for p in case["pos"])
    io = 2 * q.numel() * q.element_size() + walked * 4 \
        + positions.numel() * positions.element_size() + 4
    flops = 4 * T * H * D * live_cols
    return kv + io, flops


def phase_kernel_time(result):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_reference)
    case = decode_case()
    q, kp, vp, tables, positions = case["args"]
    kw = dict(case["kw"])
    n_tiles = max(case["pos"]) // kw["block_size"] + 1
    kw["n_tiles"] = torch.tensor([n_tiles], dtype=torch.int32,
                                 device=q.device)
    kernel_ms = time_ms(
        lambda: paged_attention_kernel(q, kp, vp, tables, positions, **kw))
    plain_ms = time_ms(
        lambda: paged_attention_reference(q, kp, vp, tables, positions,
                                          **kw), samples=20, inner=1)
    # yardstick: SDPA over the same K/V pre-gathered into dense
    # per-slot tensors with the same mask (timed here only)
    S, T, H, D = q.shape
    bs = kw["block_size"]
    nt = max(case["pos"]) // bs + 1
    L = nt * bs
    phys = tables[:, :nt].clamp(min=0).long()
    kd = kp[phys].reshape(S, L, H, D).transpose(1, 2).contiguous()
    vd = vp[phys].reshape(S, L, H, D).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    cols = torch.arange(L, device=q.device)
    mask = (cols[None, None, None, :]
            <= positions[:, None, :, None])   # [S, 1, T, L]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    nbytes, flops = decode_bytes_and_flops(case, n_tiles)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    out = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops,
           "share_of_bound": bound_ms / kernel_ms,
           "geometry": case["geometry"], "positions": case["pos"]}
    result.update({k: out[k] for k in ("kernel_ms", "plain_ms",
                                       "library_ms", "bound_ms",
                                       "bound_by")})
    result["ms"] = kernel_ms
    return out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def wait_all(reqs, timeout):
    t_end = time.monotonic() + timeout
    for r in reqs:
        if not r["done"].wait(max(0.0, t_end - time.monotonic())):
            raise TimeoutError("a request did not finish in time")
        if r["error"] is not None:
            raise r["error"]


def check_budget(reqs, vocab):
    for r in reqs:
        out = r["out"]
        if len(out) != r["max_new"]:
            raise AssertionError(f"{r['trace_id']}: {len(out)} tokens, "
                                 f"budget {r['max_new']}")
        if not all(0 <= t < vocab for t in out):
            raise AssertionError(f"{r['trace_id']}: token out of vocab")


def profile_decode(eng, rng, vocab, ctx=1000, steps=10):
    """Where a full decode step's time goes: all slots active at ``ctx``
    tokens of history, host wall time per step (synchronized), and the
    device time per step by kernel from torch.profiler (CUDA activity
    only, so every event is device work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    for s in range(eng.max_slots):
        eng.prefill(s, rng.integers(0, vocab, ctx), budget=2 * steps + 4)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    before = pak.launches
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_step = (pak.launches - before) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us
    for s in range(eng.max_slots):
        eng.release(s)
    device_ms = sum(by_kernel.values()) / 1e3 / steps
    attn_ms = sum(v for k, v in by_kernel.items()
                  if "paged_attention" in k) / 1e3 / steps
    gemm_ms = sum(v for k, v in by_kernel.items()
                  if any(tag in k.lower() for tag in
                         ("gemm", "gemv", "cutlass", "nvjet"))
                  ) / 1e3 / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"slots": eng.max_slots, "context": ctx, "steps": steps,
            "step_wall_ms": wall_ms,
            "launches_per_decode_step": per_step,
            "device_ms_per_step": device_ms or None,
            "attention_ms_per_step": attn_ms or None,
            "gemm_ms_per_step": gemm_ms or None,
            "device_idle_share": (1 - device_ms / wall_ms)
            if device_ms else None,
            "top_kernels_ms_per_step": [[k[:80], v / 1e3 / steps]
                                        for k, v in top]}


def phase_serve(state, result):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    from paddle_tpu_torch.serving import (GenerationServer,
                                          PagedLlamaDecodeEngine)
    cfg = LlamaConfig(dtype="bfloat16", use_flash_attention=False)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state["model"] = model
    eng = PagedLlamaDecodeEngine(model, max_slots=8, max_seq=2048)
    rng = np.random.default_rng(SEED)
    V = cfg.vocab_size
    prefix = rng.integers(0, V, 256)
    lengths = [296, 1000, 16, 640, 48, 356, 800, 120, 500, 64, 200, 900]
    prompts = [rng.integers(0, V, n) for n in lengths]
    # requests 0 and 5 share the 256-token prefix; 0 is submitted and
    # prefilled first, so 5's admission finds it in the radix tree
    prompts[0] = np.concatenate([prefix, rng.integers(0, V, 40)])
    prompts[5] = np.concatenate([prefix, rng.integers(0, V, 100)])
    budgets = [int(b) for b in rng.integers(32, 65, len(prompts))]
    hits0 = eng._kv.prefix_hits
    srv = GenerationServer(eng)
    pak.launches = 0                       # the count starts here
    t_start = time.monotonic()
    reqs = [srv.submit(prompts[0], budgets[0])]
    while "t_first" not in reqs[0] and not reqs[0]["done"].is_set():
        time.sleep(0.005)
    reqs += [srv.submit(p, b) for p, b in zip(prompts[1:], budgets[1:])]
    wait_all(reqs, timeout=600)
    torch.cuda.synchronize()
    t_end = time.monotonic()
    launches = pak.launches                # ... and is read here
    if not srv.shutdown(drain=True, timeout=60):
        raise RuntimeError("server did not drain")
    check_budget(reqs, V)
    chunk = eng.prefill_chunk_len
    chunks = sum(math.ceil((len(r["prompt"]) - r["prefix_hit_tokens"])
                           / chunk) for r in reqs)
    steps = srv.steps_run
    expected = eng.n_layers * (steps + chunks)
    if launches != expected or launches == 0:
        raise AssertionError(
            f"kernel launches {launches} != layers x (decode steps + "
            f"prefill chunks) = {eng.n_layers} x ({steps} + {chunks})")
    if eng._kv.prefix_hits - hits0 < 1 \
            or reqs[5]["prefix_hit_tokens"] < 256:
        raise AssertionError("the shared prefix did not hit the radix "
                             "tree")
    wall = t_end - t_start
    generated = sum(len(r["out"]) for r in reqs)
    decode_tokens = sum(len(r["out"]) - 1 for r in reqs)
    ttft = [r["t_first"] - r["t0"] for r in reqs]
    state["launches"] = launches
    result["launches"] = launches
    state["layers"] = eng.n_layers
    out = {"card": nvidia_smi_line(), "model": "llama2-7b-width",
           "layers": eng.n_layers,
           "hidden": cfg.hidden_size, "dtype": "bfloat16",
           "init_seconds": init_s, "requests": len(reqs),
           "prompt_lengths": [len(p) for p in prompts],
           "budgets": budgets, "prefix_hit_tokens":
               [r["prefix_hit_tokens"] for r in reqs],
           "ttft_s": ttft, "ttft_median_s": statistics.median(ttft),
           "wall_s": wall, "generated_tokens": generated,
           "decode_tokens": decode_tokens,
           "decode_tokens_per_s": decode_tokens / wall,
           "steps": steps, "prefill_chunks": chunks,
           "kernel_launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    out["decode_profile"] = profile_decode(eng, rng, V)
    del eng, srv
    torch.cuda.empty_cache()
    # the int8-KV dtype path: 4 layers of the same weights
    eng8 = PagedLlamaDecodeEngine(model, max_slots=2, max_seq=1024,
                                  kv_quant="int8", num_layers=4)
    srv8 = GenerationServer(eng8)
    before = pak.launches
    reqs8 = [srv8.submit(rng.integers(0, V, n), 32) for n in (200, 90)]
    wait_all(reqs8, timeout=300)
    if not srv8.shutdown(drain=True, timeout=60):
        raise RuntimeError("int8 server did not drain")
    check_budget(reqs8, V)
    if pak.launches - before <= 0:
        raise AssertionError("the int8-KV engine did not launch the "
                             "kernel")
    out["int8_kv"] = {"layers": 4, "requests": 2,
                      "kernel_launches": pak.launches - before}
    return out


def phase_serve_parity(state):
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import PagedLlamaDecodeEngine
    model = state["model"]           # the serve phase's weights
    prompt = np.random.default_rng(SEED + 1).integers(
        0, model.config.vocab_size, 300)
    n_tok = 16

    def run(impl):
        eng = PagedLlamaDecodeEngine(model, max_slots=1, max_seq=512,
                                     attention_impl=impl)
        toks = [eng.prefill(0, prompt, budget=n_tok)]
        logits = [eng.last_logits.float().clone()]
        while len(toks) < n_tok:
            toks.append(int(eng.step()[0]))
            if len(logits) == 1:
                logits.append(eng.last_logits[0].float().clone())
        eng.release(0)
        return toks, logits

    k_toks, k_logits = run("kernel")
    r_toks, r_logits = run("reference")
    checks = []
    for name, a, b in zip(("prefill", "first_decode_step"), k_logits,
                          r_logits):
        err = (a - b).abs()
        bad = err > LOGITS_ATOL + LOGITS_RTOL * b.abs()
        checks.append({"logits": name, "max_abs_err": float(err.max()),
                       "max_abs_ref": float(b.abs().max()),
                       "argmax_equal": int(a.argmax()) == int(b.argmax()),
                       "ok": not bool(bad.any())})
        if bad.any():
            emit({"phase": "serve_parity", "failed": checks[-1]})
            raise AssertionError(f"{name} logits of the kernel engine "
                                 f"disagree with the reference engine")
    agree = sum(int(x == y) for x, y in zip(k_toks, r_toks))
    return {"prompt_len": len(prompt), "checks": checks,
            "tolerance": {"atol": LOGITS_ATOL, "rtol": LOGITS_RTOL},
            "greedy_agreement": f"{agree}/{n_tok}",
            "kernel_tokens": k_toks, "reference_tokens": r_toks}


# ---------------------------------------------------------------------------
# flash attention: parity and time
# ---------------------------------------------------------------------------

def flash_inputs(shape, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def flash_cases():
    """(name, shape, causal): the training geometry causal and full, D 64
    through the [BH, L, D] strides, a ragged L, L = 1, and q, k, v as
    strided views of one [B, L, 3, H, D] projection."""
    return [("train", (4, 2048, 32, 128), True),
            ("train_full", (4, 2048, 32, 128), False),
            ("bhld_d64", (48, 512, 64), False),
            ("ragged_l1000", (2, 1000, 8, 128), True),
            ("l1", (4, 1, 32, 128), True),
            ("strided_qkv", (2, 1024, 16, 128), True)]


def flash_case_inputs(case, shape, dtype, seed):
    """q, k, v, do of one flash_parity case; ``strided_qkv`` takes q, k, v
    as the views of one [B, L, 3, H, D] projection."""
    if case != "strided_qkv":
        return flash_inputs(shape, dtype, seed)
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, L, H, D = shape
    qkv = torch.randn((B, L, 3, H, D), generator=g, device="cuda").to(dtype)
    do = torch.randn(shape, generator=g, device="cuda").to(dtype)
    return [*qkv.unbind(2), do]


def flash_tma_expected(dtype, shape):
    """Whether the TMA / wgmma design should take a flash_parity call
    (no dropout, no segments): bf16 at head dim 128 (the inputs are
    fresh tensors or views with 16-byte rows)."""
    import torch
    return dtype == torch.bfloat16 and shape[-1] == 128


def flash_wrappers():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


def flash_counts():
    return [(w.launches, w.tma_launches) for w in flash_wrappers()]


def flash_paths(before):
    """(launches, TMA launches) of each wrapper since ``before``."""
    return [(a - c, b - d) for (a, b), (c, d) in zip(flash_counts(),
                                                      before)]


def plain_all(q, k, v, do, causal, **kw):
    """out, lse, dq, dk, dv through the plain versions, the backward
    parts on the forward's own lse and delta (``kw``: dropout_p, seed,
    seg)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    out, lse = fa.flash_attention_fwd_reference(q, k, v, causal, None, **kw)
    delta = fa.attention_delta(out, do)
    return (out, lse,
            fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, None, **kw),
            *fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                  causal, None, **kw))


def kernels_all(q, k, v, do, causal, lse, delta, **kw):
    """out, lse, dq, dk, dv through the kernels, the backward kernels on
    the given (the plain forward's) lse and delta, so that each kernel is
    held alone against its plain part."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    return (*fa.flash_attention_fwd(q, k, v, causal, None, **kw),
            fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, None,
                                      **kw),
            *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        None, **kw))


def parity_row(row, got, ref, ref32, dname):
    """Each of out, lse, dq, dk, dv: elementwise against the plain
    version in the working dtype, RMS against the plain version on f32
    copies (FLASH_TOL, FLASH_RMS). Fills ``row``; returns whether all
    passed."""
    tol, rms_r = FLASH_TOL[dname], FLASH_RMS[dname]
    row.update(tol=tol, rms_tol=rms_r)
    ok = True
    for n, g_, r, r32 in zip(("out", "lse", "dq", "dk", "dv"), got, ref,
                             ref32):
        g_, r, r32 = g_.float(), r.float(), r32.float()
        err = (g_ - r).abs()
        used = float((err / (tol * (1 + r.abs()))).max())
        rms = float((g_ - r32).square().mean().sqrt())
        rms_ref = float(r32.square().mean().sqrt())
        used_rms = rms / (rms_r * rms_ref + FLASH_RMS_ATOL)
        row[n] = {"max_abs_err": float(err.max()), "tol_used": used,
                  "rms_err_f32": rms, "rms_ref": rms_ref,
                  "rms_tol_used": used_rms}
        ok &= used <= 1 and used_rms <= 1
    row["ok"] = ok
    return ok


def autograd_row(q, k, v, do, flash_fn, plain_fn, dname):
    """Relative RMS of out, dq, dk, dv: the FlashAttention autograd
    function against autograd through the plain sdpa."""
    import torch
    outs = []
    for fn in (flash_fn, plain_fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*xs)
        outs.append([o.detach().float()] + [
            g_.float() for g_ in torch.autograd.grad(o, xs, do)])
        del xs, o
    row = {"dtype": dname, "shape": list(q.shape),
           "rms_tol": AUTOGRAD_RMS[dname]}
    for n, a, b in zip(("out", "dq", "dk", "dv"), *outs):
        row[n] = float((a - b).square().mean().sqrt()
                       / b.square().mean().sqrt())
    row["ok"] = all(row[n] <= AUTOGRAD_RMS[dname]
                    for n in ("out", "dq", "dk", "dv"))
    return row


def phase_flash_parity(results):
    import torch
    from paddle_tpu_torch.nn.functional import sdpa_reference
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rows, failed = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for i, (case, shape, causal) in enumerate(flash_cases()):
            q, k, v, do = flash_case_inputs(case, shape, dtype, seed=100 + i)
            ref = plain_all(q, k, v, do, causal)
            delta = fa.attention_delta(ref[0], do)
            before = flash_counts()
            got = kernels_all(q, k, v, do, causal, ref[1], delta)
            torch.cuda.synchronize()
            paths = flash_paths(before)
            ref32 = plain_all(*(x.float() for x in (q, k, v, do)), causal)
            tma = flash_tma_expected(dtype, shape)
            row = {"case": case, "shape": list(shape), "causal": causal,
                   "dtype": dname,
                   "design": "tma_wgmma" if tma else "general_mma_sync",
                   "launches_and_tma_launches": paths}
            rows.append(row)
            # each kernel launched once, through the design expected
            ok = parity_row(row, got, ref, ref32, dname)
            row["ok"] = ok = ok and paths == [(1, int(tma))] * 3
            if not ok:
                failed.append(row)
            if case == "train" and dtype == torch.bfloat16:
                record_errors(results, "", row)
            del q, k, v, do, ref, ref32, got
            torch.cuda.empty_cache()
    # the autograd function against autograd through the plain sdpa
    auto = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = flash_inputs((2, 512, 8, 128), dtype, seed=7)
        before = flash_counts()
        auto.append(autograd_row(
            q, k, v, do, lambda a, b, c: fa.flash_attention(a, b, c, True),
            lambda a, b, c: sdpa_reference(a, b, c, causal=True), dname))
        paths = flash_paths(before)
        tma = flash_tma_expected(dtype, q.shape)
        auto[-1]["launches_and_tma_launches"] = paths
        auto[-1]["ok"] &= paths == [(1, int(tma))] * 3
        if not auto[-1]["ok"]:
            failed.append({"autograd": auto[-1]})
    finish_parity("flash_parity", results, "", failed)
    return {"cases": rows, "autograd": auto}


def record_errors(results, suffix, row):
    """The worst max abs error of each kernel's outputs into its entry
    of the kernels line."""
    for kname, outs in (("flash_attention_fwd", ("out", "lse")),
                        ("flash_attention_bwd_dq", ("dq",)),
                        ("flash_attention_bwd_dkv", ("dk", "dv"))):
        results[kname + suffix]["max_abs_err"] = max(
            row[m]["max_abs_err"] for m in outs)


def finish_parity(phase, results, suffix, failed):
    for kname in ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv"):
        results[kname + suffix]["parity"] = "failed" if failed else "ok"
    if failed:
        emit({"phase": phase, "failed": failed})
        raise AssertionError(f"{len(failed)} {phase} checks failed")


def attention_work(B, L, H, D, causal, products, tensors, stats,
                   elem_bytes, pairs=None):
    """(flops, bytes) of ``products`` L x L x D matrix products over
    the attended pairs (causal: L(L+1)/2 a head; ``pairs`` when the
    function needs fewer, as segments do), reading or writing
    ``tensors`` [B, L, H, D] tensors and ``stats`` f32 [B, H, L] arrays
    (lse, delta) once each."""
    if pairs is None:
        pairs = L * (L + 1) // 2 if causal else L * L
    flops = products * 2 * B * H * pairs * D
    nbytes = (tensors * B * L * H * D * elem_bytes
              + stats * B * H * L * 4)
    return flops, nbytes


def bound(flops, nbytes):
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def flash_general(q, k, v, do, lse, delta, causal):
    """The first design's kernels (mma.sync, flash_attention.cuh) on bf16
    inputs that the wrappers send to the TMA design: called through the
    first design's C entries, so one run times both designs on one
    card."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, L, H, D = fa._as4(q).shape
    lib = fa._kernel_lib(q.dtype, D)

    def tail():  # sizes, causal, scale, bf16; no segments, no dropout
        return (B, L, H, D, int(causal), 1.0 / math.sqrt(D), 1, None, 0,
                None, 0, 0, 0, 1.0, torch.cuda.current_stream().cuda_stream)

    def check(rc, what):
        if rc:
            raise RuntimeError(f"first-design {what} launch failed: "
                               f"cudaError {rc}")

    def fwd():
        out = torch.empty_like(q)
        ls = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
        check(lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ls.data_ptr(), fa._strides(q, k, v, out), *tail()), "forward")

    def dq():
        g = torch.empty_like(q)
        check(lib.flash_attention_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), g.data_ptr(),
            fa._strides(q, k, v, do, g), *tail()), "dQ")

    def dkv():
        gk, gv = torch.empty_like(k), torch.empty_like(v)
        check(lib.flash_attention_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), gk.data_ptr(), gv.data_ptr(),
            fa._strides(q, k, v, do, gk, gv), *tail()), "dK/dV")

    return {"flash_attention_fwd": fwd, "flash_attention_bwd_dq": dq,
            "flash_attention_bwd_dkv": dkv}


def flash_timings(shape, causal, kw=None, pairs=None, lib_kw=None,
                  extra_bytes=0):
    """Kernel, plain and library times of the flash functions at one
    geometry (bf16), beside their bounds. ``shape`` is [B, L, H, D] or
    [BH, L, D]; the library (SDPA) gets the same values as [B, H, L, D]
    (a [BH, L, D] input as [BH, 1, L, D]) and ``lib_kw`` (its dropout or
    mask). ``kw`` goes to every kernel and plain call (dropout_p, seed,
    seg); ``pairs`` is the pairs a head needs, ``extra_bytes`` what the
    call reads besides (the segment ids). Where the wrappers take the TMA
    design (checked by their counts), general_ms times the first design
    on the same inputs."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    kw, lib_kw = kw or {}, lib_kw or {"is_causal": causal}
    q, k, v, do = flash_inputs(shape, torch.bfloat16, seed=1)
    B, L, H, D = (shape[0], shape[1], 1, shape[2]) if len(shape) == 3 \
        else shape
    out, lse = fa.flash_attention_fwd(q, k, v, causal, None, **kw)
    delta = fa.attention_delta(out, do)
    tma = fa.takes_tma(q, k, v, do, dropout_p=kw.get("dropout_p", 0.0),
                       seg=kw.get("seg"))
    before = flash_counts()
    kernels_all(q, k, v, do, causal, lse, delta, **kw)
    torch.cuda.synchronize()
    if flash_paths(before) != [(1, int(tma))] * 3:
        raise AssertionError(f"flash_time: the wrappers took another design "
                             f"than takes_tma ({tma}) at {list(shape)}")
    first = flash_general(q, k, v, do, lse, delta, causal) if tma else {}
    lib_in = [(x[:, :, None] if x.dim() == 3 else x).transpose(1, 2)
              .contiguous() for x in (q, k, v, do)]
    qt, kt, vt, dot = lib_in
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, **lib_kw)
        torch.autograd.grad(o, (qg, kg, vg), dot)

    def fwd_bwd():
        o, ls = fa.flash_attention_fwd(q, k, v, causal, None, **kw)
        fa.flash_attention_bwd(q, k, v, o, ls, do, causal, None, **kw)

    rows = {
        # name: (kernel, plain, library, products, [B, L, H, D] tensors
        # read or written, f32 [B, H, L] arrays read or written)
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal, None, **kw),
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal, None,
                                                     **kw),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw),
            2, 4, 1),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              causal, None, **kw),
            lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, do, lse, delta, causal, None, **kw),
            None, 3, 5, 2),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               causal, None, **kw),
            lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, causal, None, **kw),
            None, 4, 6, 2),
        "backward_with_delta": (
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                           None, **kw),
            lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                     causal, None, **kw),
            None, 5, 8, 1),
        "forward_backward": (fwd_bwd, None, lib_fwd_bwd, 7, 8, 0),
    }
    table = {}
    for name, (kern, plain, lib, products, tensors, stats) in rows.items():
        flops, nbytes = attention_work(B, L, H, D, causal, products,
                                       tensors, stats, 2, pairs)
        nbytes += extra_bytes
        b_ms, b_by = bound(flops, nbytes)
        r = {"design": "tma_wgmma" if tma else "general_mma_sync",
             "kernel_ms": time_ms(kern, samples=10, inner=5),
             "general_ms": time_ms(first[name], samples=10, inner=5)
             if name in first else None,
             "plain_ms": time_ms(plain, samples=5, inner=1)
             if plain else None,
             "library_ms": time_ms(lib, samples=10, inner=5)
             if lib else None,
             "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
             "bytes": nbytes}
        r["share_of_bound"] = b_ms / r["kernel_ms"]
        table[name] = r
    return table


def phase_flash_time(results):
    train = flash_timings((4, 2048, 32, 128), True)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        results[name].update({key: train[name][key] for key in (
            "design", "kernel_ms", "general_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")})
        results[name]["ms"] = train[name]["kernel_ms"]
    return {"train": {"shape": [4, 2048, 32, 128], "layout": "B L H D",
                      "causal": True, "dtype": "bfloat16", "times": train},
            # the [BH, L, D] launchers' geometry (BERT-base heads: B 8 x
            # H 12, L 512, D 64, bidirectional)
            "bhld_d64": {"shape": [96, 512, 64], "layout": "BH L D",
                         "causal": False, "dtype": "bfloat16",
                         "times": flash_timings((96, 512, 64), False)},
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "on [B, H, L, D] inputs (forward; forward + "
                       "backward through torch.autograd.grad)",
            "general_ms": "the first design's mma.sync kernels "
                          "(flash_attention.cuh) on the same inputs, where "
                          "the wrappers take the TMA design",
            "bound_note": "products of the function: forward 2 (QK^T, PV), "
                          "dQ 3, dK/dV 4, backward 5 (the two-kernel recipe "
                          "does 7); causal pairs L(L+1)/2"}


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def train_model(layers, flash=True):
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(num_hidden_layers=layers, dtype="bfloat16",
                      max_position_embeddings=TRAIN["seq"],
                      use_flash_attention=flash)
    return LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))


def train_ids(vocab):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(
        0, vocab, (TRAIN["batch"], TRAIN["seq"]))).to("cuda")


def profile_train_step(step, ids):
    """Device time of one train step by kernel group (torch.profiler,
    CUDA activity only) beside its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(*ids)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us
    groups = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0,
              "gemm": 0.0, "other": 0.0}
    for key, us in by_kernel.items():
        kl = key.lower()
        if "flash_fwd" in kl:
            groups["flash_fwd"] += us
        elif "flash_bwd_dq" in kl:
            groups["flash_dq"] += us
        elif "flash_bwd_dkv" in kl:
            groups["flash_dkv"] += us
        elif any(tag in kl for tag in ("gemm", "cutlass", "nvjet", "sm90")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    device_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms or None,
            "device_idle_share": (1 - device_ms / wall_ms)
            if device_ms else None,
            "groups_ms": {k: v / 1e3 for k, v in groups.items()},
            "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]}


def phase_train(results):
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    t0 = time.perf_counter()
    model = train_model(TRAIN["layers"])
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=TRAIN["lr"],
                parameters=model.named_parameters(), multi_precision=False)
    step = TrainStep(model, LlamaPretrainingCriterion(), opt)
    ids = train_ids(cfg.vocab_size)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, ids) for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = kern.tma_launches = 0    # the counts start here
    t0 = time.perf_counter()
    for _ in range(TRAIN["steps"]):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [kern.launches for kern in kernels]   # ... and are read here
    tma = [kern.tma_launches for kern in kernels]
    expected = TRAIN["layers"] * TRAIN["steps"]
    if launches != [expected] * 3 or tma != [expected] * 3:
        raise AssertionError(
            f"flash launches (fwd, dq, dkv) {launches}, of them through the "
            f"TMA design {tma}, != layers x timed steps = "
            f"{TRAIN['layers']} x {TRAIN['steps']} each")
    for kern, n, nt in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv"), launches, tma):
        results[kern]["launches"] = n
        results[kern]["tma_launches"] = nt
    loss_values = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_values):
        raise AssertionError(f"non-finite loss: {loss_values}")
    if not loss_values[-1] < loss_values[0]:
        raise AssertionError(f"the loss did not fall: {loss_values}")
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN["batch"] * TRAIN["seq"]
    tok_s = tokens * TRAIN["steps"] / wall
    heads, hd = cfg.num_attention_heads, cfg.hidden_size // \
        cfg.num_attention_heads
    # attention products per token, forward + backward: 3 x (QK^T + PV)
    # over (L + 1) / 2 keys on average (causal), 2 flops a MAC
    attn_per_token = 3 * 2 * 2 * heads * hd * (TRAIN["seq"] + 1) / 2 \
        * TRAIN["layers"]
    mfu = (6 * n_params + attn_per_token) * tok_s / BF16_FLOPS
    prof = profile_train_step(step, (ids, ids))
    out = {"card": nvidia_smi_line(), "model": "llama2-7b-width",
           "layers": TRAIN["layers"], "hidden": cfg.hidden_size,
           "intermediate": cfg.intermediate_size, "heads": heads,
           "kv_heads": cfg.num_key_value_heads, "vocab": cfg.vocab_size,
           "dtype": "bfloat16", "params": n_params,
           "optimizer": f"AdamW(lr={TRAIN['lr']}, multi_precision=False)",
           "batch": TRAIN["batch"], "seq": TRAIN["seq"],
           "reduced": ["depth 32 -> 4 layers",
                       "random weights from a seed (no checkpoint in the "
                       "repo)"],
           "init_seconds": init_s, "losses": loss_values,
           "warmup_steps": TRAIN["warmup"], "timed_steps": TRAIN["steps"],
           "step_ms": wall / TRAIN["steps"] * 1e3, "tokens_per_s": tok_s,
           "mfu": mfu, "mfu_flops_per_token": 6 * n_params + attn_per_token,
           "flash_launches": dict(zip(("fwd", "dq", "dkv"), launches)),
           "flash_tma_launches": dict(zip(("fwd", "dq", "dkv"), tma)),
           "peak_mem_gb": peak / 2 ** 30, "profile_one_step": prof}
    del step, opt, model
    torch.cuda.empty_cache()
    return out


def phase_train_parity():
    import torch
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    model = train_model(2)
    ids = train_ids(model.config.vocab_size)
    crit = LlamaPretrainingCriterion()
    runs = []
    for flash in (True, False):
        model.config.use_flash_attention = flash
        loss = crit(model(ids), ids).float()
        loss.backward()
        runs.append((loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()}))
        model.zero_grad(set_to_none=True)
    (lk, gk), (lr_, gr) = runs
    loss_rel = abs(lk - lr_) / abs(lr_)
    worst, rows = 0.0, {}
    for name, a in gk.items():
        b = gr[name].float()
        rel = float((a.float() - b).square().mean().sqrt()
                    / b.square().mean().sqrt().clamp(min=1e-30))
        rows[name] = rel
        worst = max(worst, rel)
    ok = loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RMS
    out = {"layers": 2, "loss_kernels": lk, "loss_reference": lr_,
           "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
           "grad_rel_rms_worst": worst, "grad_rel_rms_tol": TRAIN_GRAD_RMS,
           "grad_rel_rms": rows, "ok": ok}
    del model, gk, gr, runs
    torch.cuda.empty_cache()
    if not ok:
        emit({"phase": "train_parity", "failed": out})
        raise AssertionError("the step through the kernels disagrees with "
                             "the step through the plain sdpa")
    return out


# ---------------------------------------------------------------------------
# dropout (K5) and segments (K4) inside the flash kernels
# ---------------------------------------------------------------------------

DROP_SEED = 0x5EED0123456789AB     # the kernels' Philox key in the checks


def phase_flash_dropout_parity(results):
    import torch
    from paddle_tpu_torch.nn.functional import sdpa_reference
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    p = BERT["dropout"]
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("bert", BERT_SHAPE, False, bf),
             ("bert_causal", BERT_SHAPE, True, bf),
             ("small_f32", (2, 300, 4, 64), False, f32),
             ("small_f32_causal", (2, 300, 4, 64), True, f32)]
    rows, failed = [], []
    kw = dict(dropout_p=p, seed=DROP_SEED)
    for i, (case, shape, causal, dtype) in enumerate(cases):
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = flash_inputs(shape, dtype, seed=200 + i)
        ref = plain_all(q, k, v, do, causal, **kw)
        delta = fa.attention_delta(ref[0], do)
        before = flash_counts()
        got = kernels_all(q, k, v, do, causal, ref[1], delta, **kw)
        torch.cuda.synchronize()
        paths = flash_paths(before)
        ref32 = plain_all(*(x.float() for x in (q, k, v, do)), causal, **kw)
        row = {"case": case, "shape": list(shape), "causal": causal,
               "dtype": dname, "dropout_p": p, "design": "general_mma_sync",
               "launches_and_tma_launches": paths}
        # dropout takes the first design, one launch each
        ok = parity_row(row, got, ref, ref32, dname) and \
            paths == [(1, 0)] * 3
        # p = 0 is the launch without dropout, bit for bit; another seed
        # drops other pairs
        plain_launch = kernels_all(q, k, v, do, causal, ref[1], delta)
        zero = kernels_all(q, k, v, do, causal, ref[1], delta,
                           dropout_p=0.0, seed=DROP_SEED)
        other = kernels_all(q, k, v, do, causal, ref[1], delta,
                            dropout_p=p, seed=DROP_SEED + 1)
        row["p0_bit_equal"] = all(torch.equal(a, b)
                                  for a, b in zip(plain_launch, zero))
        row["seeds_differ"] = not any(torch.equal(a, b) for a, b in
                                      zip(got[2:], other[2:])) and \
            not torch.equal(got[0], other[0])
        row["ok"] = ok = ok and row["p0_bit_equal"] and row["seeds_differ"]
        rows.append(row)
        if not ok:
            failed.append(row)
        if case == "bert":
            record_errors(results, "_dropout", row)
        del q, k, v, do, ref, ref32, got, plain_launch, zero, other
        torch.cuda.empty_cache()
    B, L, H, _ = BERT_SHAPE
    keep = fa.flash_dropout_keep_mask(DROP_SEED, B, H, L, p, "cuda")
    rate = float(keep.float().mean())
    sigma = math.sqrt(p * (1 - p) / keep.numel())
    keep_row = {"shape": [B, H, L, L], "keep_rate": rate,
                "expected": 1 - p, "sigma": sigma,
                "ok": abs(rate - (1 - p)) <= 4 * sigma}
    del keep
    if not keep_row["ok"]:
        failed.append({"keep_rate": keep_row})
    auto = []
    for dtype in (bf, f32):
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = flash_inputs((2, 512, 12, 64), dtype, seed=8)
        auto.append(autograd_row(
            q, k, v, do,
            lambda a, b, c: fa.flash_attention(a, b, c, False, None, p,
                                               DROP_SEED),
            lambda a, b, c: sdpa_reference(a, b, c, dropout_p=p,
                                           seed=DROP_SEED), dname))
        if not auto[-1]["ok"]:
            failed.append({"autograd": auto[-1]})
    finish_parity("flash_dropout_parity", results, "_dropout", failed)
    return {"cases": rows, "keep_rate": keep_row, "autograd": auto}


def varlen_lengths():
    """Sequence lengths in [min_len, max_len] from a numpy seed, packed
    to exactly ``total`` tokens (the last one cut to fit, merged into its
    neighbour if that leaves it short)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    lens = []
    while sum(lens) < VARLEN["total"]:
        lens.append(int(rng.integers(VARLEN["min_len"],
                                     VARLEN["max_len"] + 1)))
    lens[-1] -= sum(lens) - VARLEN["total"]
    if lens[-1] < VARLEN["min_len"]:
        last = lens.pop()
        lens[-1] += last
    return lens


def varlen_seg(lens):
    import torch
    return torch.repeat_interleave(
        torch.arange(len(lens), dtype=torch.int32),
        torch.tensor(lens))[None].to("cuda")


def phase_flash_varlen_parity(results):
    import torch
    from paddle_tpu_torch.nn.functional import (flash_attn_varlen_qkvpacked,
                                                sdpa_reference)
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    lens = varlen_lengths()
    seg = varlen_seg(lens)
    T, H, D = VARLEN["total"], VARLEN["heads"], VARLEN["head_dim"]
    shape = (1, T, H, D)
    rows, auto, failed = [], [], []
    same = seg[0][:, None] == seg[0][None, :]
    block_mask = torch.where(same, 0.0, -1e30)[None, None]  # [1,1,T,T]
    del same
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        dname = str(dtype).replace("torch.", "")
        for causal in (False, True):
            q, k, v, do = flash_inputs(shape, dtype, seed=300 + 2 * i +
                                       causal)
            ref = plain_all(q, k, v, do, causal, seg=seg)
            delta = fa.attention_delta(ref[0], do)
            before = flash_counts()
            got = kernels_all(q, k, v, do, causal, ref[1], delta, seg=seg)
            torch.cuda.synchronize()
            paths = flash_paths(before)
            ref32 = plain_all(*(x.float() for x in (q, k, v, do)), causal,
                              seg=seg)
            row = {"shape": list(shape), "sequences": len(lens),
                   "causal": causal, "dtype": dname,
                   "design": "general_mma_sync",
                   "launches_and_tma_launches": paths}
            rows.append(row)
            # segments take the first design, one launch each
            ok = parity_row(row, got, ref, ref32, dname)
            row["ok"] = ok = ok and paths == [(1, 0)] * 3
            if not ok:
                failed.append(row)
            if dtype == torch.bfloat16 and not causal:
                record_errors(results, "_segmented", row)
            del ref, ref32, got
            torch.cuda.empty_cache()
            auto.append(autograd_row(
                q, k, v, do,
                lambda a, b, c: fa.flash_attention_segmented(a, b, c, seg,
                                                             causal),
                lambda a, b, c: sdpa_reference(a, b, c, causal=causal,
                                               mask=block_mask), dname))
            auto[-1]["causal"] = causal
            if not auto[-1]["ok"]:
                failed.append({"autograd": auto[-1]})
            del q, k, v, do
            torch.cuda.empty_cache()
    del block_mask
    finish_parity("flash_varlen_parity", results, "_segmented", failed)
    # the packed entry as a user calls it: forward and backward of one
    # [total, 3, H, D] batch; the counts start here ...
    g = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn((T, 3, H, D), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    dout = torch.randn((T, H, D), generator=g, device="cuda").to(
        torch.bfloat16)
    cu = torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for w in wrappers:
        w.launches = w.dropout_launches = w.segmented_launches = 0
        w.tma_launches = 0
    out, _ = flash_attn_varlen_qkvpacked(qkv, cu, cu, max(lens), max(lens),
                                         None, causal=False)
    out.backward(dout)
    torch.cuda.synchronize()
    launches = [w.segmented_launches for w in wrappers]   # ... read here
    tma = [w.tma_launches for w in wrappers]
    finite = bool(torch.isfinite(out).all() and
                  torch.isfinite(qkv.grad).all())
    if launches != [1, 1, 1] or tma != [0, 0, 0] or not finite:
        raise AssertionError(f"varlen entry: segmented launches {launches} "
                             f"(want 1 each), TMA launches {tma} (want "
                             f"none: segments take the first design), "
                             f"finite {finite}")
    for name, n in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"), launches):
        results[name + "_segmented"]["launches"] = n
        results[name + "_segmented"]["tma_launches"] = 0
    return {"sequences": len(lens), "lengths": lens, "cases": rows,
            "autograd_vs_block_diagonal_sdpa": auto,
            "entry": {"qkv": [T, 3, H, D], "segmented_launches": launches,
                      "finite": finite}}


def phase_flash_time_bert(results):
    import torch
    B, L, H, D = BERT_SHAPE
    p = BERT["dropout"]
    # the same kernels without dropout at the same geometry: what the
    # keep mask costs
    no_drop = flash_timings(BERT_SHAPE, False)
    drop = flash_timings(BERT_SHAPE, False,
                         kw=dict(dropout_p=p, seed=DROP_SEED),
                         lib_kw={"dropout_p": p})
    lens = varlen_lengths()
    seg = varlen_seg(lens)
    T = VARLEN["total"]
    same = seg[0][:, None] == seg[0][None, :]
    seg_t = flash_timings((1, T, VARLEN["heads"], VARLEN["head_dim"]),
                          False, kw=dict(seg=seg),
                          pairs=sum(n * n for n in lens),
                          lib_kw={"attn_mask": same[None, None]},
                          extra_bytes=seg.numel() * 4)
    del same
    torch.cuda.empty_cache()
    for suffix, table in (("_dropout", drop), ("_segmented", seg_t)):
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            row = table[name]
            results[name + suffix].update(
                {key: row[key] for key in ("design", "kernel_ms",
                                           "general_ms", "plain_ms",
                                           "library_ms", "bound_ms",
                                           "bound_by")})
            results[name + suffix]["ms"] = row["kernel_ms"]
    return {"no_dropout": {"shape": list(BERT_SHAPE), "layout": "B L H D",
                           "causal": False, "dtype": "bfloat16",
                           "times": no_drop},
            "dropout": {"shape": list(BERT_SHAPE), "layout": "B L H D",
                        "causal": False, "dtype": "bfloat16",
                        "dropout_p": p, "times": drop},
            "segmented": {"shape": [1, T, VARLEN["heads"],
                                    VARLEN["head_dim"]],
                          "sequences": len(lens), "causal": False,
                          "dtype": "bfloat16",
                          "pairs": sum(n * n for n in lens),
                          "dense_pairs": T * T, "times": seg_t},
            "library": "torch.nn.functional.scaled_dot_product_attention: "
                       "with dropout_p (its own random bits) for the "
                       "dropout rows, with the block-diagonal bool mask "
                       "for the segmented rows",
            "bound_note": "the pairs each function needs: L^2 a head at "
                          "the BERT geometry, sum of n_i^2 for the packed "
                          "sequences; dropout adds no products"}


def bert_model(layers):
    import torch
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    cfg = BertConfig(num_hidden_layers=layers, dropout=BERT["dropout"])
    return BertForMaskedLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(SEED))


def bert_ids(vocab):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(
        0, vocab, (BERT["batch"], BERT["seq"]))).to("cuda")


def phase_bert_train(results):
    import torch
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    t0 = time.perf_counter()
    model = bert_model(BERT["layers"])
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=BERT["lr"],
                parameters=model.named_parameters(), multi_precision=False)
    step = TrainStep(model, CrossEntropyLoss(), opt)
    ids = bert_ids(cfg.vocab_size)
    trandom.seed(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, ids) for _ in range(BERT["warmup"])]
    torch.cuda.synchronize()
    for w in wrappers:                     # the counts start here
        w.launches = w.dropout_launches = w.segmented_launches = 0
        w.tma_launches = 0
    t0 = time.perf_counter()
    for _ in range(BERT["steps"]):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [w.launches for w in wrappers]        # ... and are read here
    dropped = [w.dropout_launches for w in wrappers]
    tma = [w.tma_launches for w in wrappers]
    expected = BERT["layers"] * BERT["steps"]
    if launches != [expected] * 3 or dropped != [expected] * 3 \
            or tma != [0, 0, 0]:
        raise AssertionError(
            f"flash launches (fwd, dq, dkv) {launches}, with dropout "
            f"{dropped} != layers x timed steps = {BERT['layers']} x "
            f"{BERT['steps']}, or TMA launches {tma} (dropout at D 64 takes "
            f"the first design)")
    for name, n in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"), dropped):
        results[name + "_dropout"]["launches"] = n
        results[name + "_dropout"]["tma_launches"] = 0
    loss_values = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_values):
        raise AssertionError(f"non-finite loss: {loss_values}")
    if not loss_values[-1] < loss_values[0]:
        raise AssertionError(f"the loss did not fall: {loss_values}")
    peak = torch.cuda.max_memory_allocated()
    tokens = BERT["batch"] * BERT["seq"]
    tok_s = tokens * BERT["steps"] / wall
    mfu = 6 * n_params * tok_s / BF16_FLOPS      # as bench.py:848 counts
    prof = profile_train_step(step, (ids, ids))
    out = {"card": nvidia_smi_line(), "model": "bert-base-mlm",
           "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
           "intermediate": cfg.intermediate_size,
           "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
           "dropout": cfg.dropout, "dtype": "bfloat16", "params": n_params,
           "optimizer": f"AdamW(lr={BERT['lr']}, multi_precision=False)",
           "loss": "CrossEntropyLoss on [B, L, V] logits (fused CE)",
           "batch": BERT["batch"], "seq": BERT["seq"],
           "reduced": ["random weights from a seed (no checkpoint in the "
                       "repo)"],
           "init_seconds": init_s, "losses": loss_values,
           "ln_vocab": math.log(cfg.vocab_size),
           "warmup_steps": BERT["warmup"], "timed_steps": BERT["steps"],
           "step_ms": wall / BERT["steps"] * 1e3, "tokens_per_s": tok_s,
           "mfu": mfu, "mfu_flops_per_token": 6 * n_params,
           "flash_launches": dict(zip(("fwd", "dq", "dkv"), launches)),
           "flash_dropout_launches": dict(zip(("fwd", "dq", "dkv"),
                                              dropped)),
           "peak_mem_gb": peak / 2 ** 30, "profile_one_step": prof}
    del step, opt, model
    torch.cuda.empty_cache()
    return out


def phase_bert_train_parity():
    import torch
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    model = bert_model(2)
    model.train()
    ids = bert_ids(model.config.vocab_size)
    crit = CrossEntropyLoss()
    # an all-zero additive mask changes no logit and routes attention to
    # the plain sdpa, which draws the same kernel seed at the same point
    zero_mask = torch.zeros((BERT["batch"], 1, 1, BERT["seq"]),
                            device="cuda")
    trandom.seed(SEED + 1)
    state = trandom.get_rng_state()
    runs = []
    for mask in (None, zero_mask):
        trandom.set_rng_state(state)
        before = fa.flash_attention_fwd.dropout_launches
        loss = crit(model(ids, attention_mask=mask), ids).float()
        loss.backward()
        launched = fa.flash_attention_fwd.dropout_launches - before
        runs.append((loss.item(), launched,
                     {n: p.grad for n, p in model.named_parameters()}))
        model.zero_grad(set_to_none=True)
    (lk, nk, gk), (lr_, nr, gr) = runs
    if (nk, nr) != (2, 0):
        raise AssertionError(f"dropout launches kernels/plain {nk}/{nr}, "
                             "want 2/0")
    loss_rel = abs(lk - lr_) / abs(lr_)

    def rms(x):
        return float(x.float().square().mean().sqrt())

    worst, rows, key_bias = 0.0, {}, {}
    for name, a in gk.items():
        b = gr[name]
        if a is None or b is None:      # token types and the pooler
            if (a is None) != (b is None):
                raise AssertionError(f"{name}: a gradient on one side only")
            continue
        if name.endswith("self_attn.k_proj.bias"):
            # zero in exact arithmetic (the softmax of a row is invariant
            # to adding q.b_k to all its logits): both sides are
            # round-off, held small against the query bias's gradient
            scale = rms(gr[name.replace("k_proj", "q_proj")])
            key_bias[name] = max(rms(a), rms(b)) / scale
            worst = max(worst, key_bias[name])
            continue
        rel = rms(a.float() - b.float()) / max(rms(b), 1e-30)
        rows[name] = rel
        worst = max(worst, rel)
    ok = loss_rel <= BERT_LOSS_RTOL and worst <= BERT_GRAD_RMS
    out = {"layers": 2, "dropout": BERT["dropout"], "loss_kernels": lk,
           "loss_reference": lr_, "loss_rel_err": loss_rel,
           "loss_rtol": BERT_LOSS_RTOL, "grad_rel_rms_worst": worst,
           "grad_rel_rms_tol": BERT_GRAD_RMS, "grad_rel_rms": rows,
           "key_bias_grad_vs_query_bias_grad": key_bias, "ok": ok}
    del model, gk, gr, runs
    torch.cuda.empty_cache()
    if not ok:
        emit({"phase": "bert_train_parity", "failed": out})
        raise AssertionError("the BERT step through the kernels disagrees "
                             "with the step through the plain sdpa")
    return out


# ---------------------------------------------------------------------------
# grouped matmul (K6, K7) and the ERNIE-MoE training path
# ---------------------------------------------------------------------------

# the op bench's geometry (bench_ops.py:176-206): the MoE expert FFN of
# BASELINE workload 5 at E 16, block_t 512
GMM_BENCH = dict(T=16384, K=1024, N=4096, E=16, block_t=512)
# ERNIE-MoE's expert FFN as a grouped matmul: 8 experts x capacity 5120
# (16,384 tokens, top-2, capacity factor 1.25), w_in and w_out
GMM_MOE = dict(T=40960, E=8, H=768, F=3072)
# kernel vs plain version in the working dtype, the plain versions doing
# the kernels' arithmetic (f32 accumulation, one rounding of the output)
# in another summation order: |err| <= tol (rms(ref) + |ref|), i.e.
# tol (1 + |ref|) on outputs scaled to unit RMS (a sum of thousands of
# products that cancels keeps the f32 rounding of its terms, ~1e-3 at
# an RMS of 64); and in RMS against the plain versions on f32 copies:
# rms(err) <= r rms(ref) + 1e-5, r one bf16 rounding of the output
# (2^-8), 1e-5 in f32
GMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GMM_RMS = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# GroupedMatmul's autograd vs autograd through the dense oracle, relative
# RMS: in bf16 the oracle's einsum rounds its one-hot products and its
# backward's intermediates to bf16
GMM_AUTOGRAD_RMS = {"float32": 1e-5, "bfloat16": 1e-2}
# ERNIE-MoE at ErnieMoEConfig() defaults, batch 8 x seq 2048
MOE = dict(batch=8, seq=2048, warmup=2, steps=5, lr=3e-4)
# moe_train_parity, bf16 at 2 layers (one dense, one MoE): as
# train_parity, and at most 1 % of tokens routed to another top-2 pair
MOE_LOSS_RTOL = 1e-2
MOE_GRAD_RMS = 5e-2
MOE_ROUTE_FLIP_SHARE = 0.01


def gmm_many_small_sizes():
    """64 group sizes in [0, 200] from a numpy seed: most groups smaller
    than a 128-row tile, so tiles straddle several group boundaries."""
    import numpy as np
    return [int(x) for x in np.random.default_rng(SEED).integers(0, 201, 64)]


def gmm_layouts():
    """(name, T, K, N, E, group sizes or None, tile ids or None,
    block_t): the op bench's geometry, ERNIE-MoE's w_in and w_out
    products, a ragged tile-aligned layout with an empty expert and
    padding rows, an unaligned one (K 200, N 72), a given tile map, 64
    groups smaller than a tile (with padding rows), row ranges that end
    inside K7's 64-row boxes, and K 37, N 45 (no 16-byte rows: the
    general kernels even in bf16)."""
    b, m = GMM_BENCH, GMM_MOE
    c = m["T"] // m["E"]
    small = gmm_many_small_sizes()
    return [
        ("op_bench", b["T"], b["K"], b["N"], b["E"],
         [b["T"] // b["E"]] * b["E"], None, b["block_t"]),
        ("moe_w_in", m["T"], m["H"], m["F"], m["E"], [c] * m["E"], None,
         128),
        ("moe_w_out", m["T"], m["F"], m["H"], m["E"], [c] * m["E"], None,
         128),
        ("ragged_empty_padding", 4096, 512, 1024, 8,
         [512, 0, 1024, 256, 768, 0, 512, 256], None, 128),
        ("unaligned", 3000, 200, 72, 6, [37, 0, 1001, 299, 1100, 500], None,
         128),
        ("tile_ids", 4096, 512, 512, 8, None, [0, 0, 1, 3, 3, 4, 6, 7], 512),
        ("many_small_groups", sum(small) + 40, 512, 768, 64, small, None,
         128),
        ("mid_box_ranges", 4096, 256, 512, 8,
         [70, 130, 1, 63, 65, 0, 1500, 2000], None, 128),
        ("odd_k_n", 1000, 37, 45, 4, [100, 600, 0, 250], None, 128),
    ]


def gmm_tma_expected(dtype, k, n):
    """Whether the TMA / wgmma kernels should take a gmm_parity call:
    bf16 with 16-byte rows (the inputs are fresh, aligned tensors)."""
    import torch
    return dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0


def gmm_inputs(t, k, n, e, sizes, ids, block_t, dtype, seed):
    import torch
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gmm
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs, dy = (torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((t, k), (t, n)))
    rhs = torch.randn((e, k, n), generator=g, device="cuda").to(dtype)
    if ids is None:
        off = gmm.offsets_from_group_sizes(sizes, e, t, "cuda")
    else:
        off = gmm.offsets_from_tile_ids(ids, e, block_t, t, "cuda")
    return lhs, rhs, dy, off


def gmm_three(lhs, rhs, dy, off, plain):
    """K6 forward, K6 as dlhs and K7, or their plain versions."""
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gmm
    e = rhs.shape[0]
    if plain:
        return (gmm.grouped_matmul_fwd_reference(lhs, rhs, off),
                gmm.grouped_matmul_fwd_reference(dy, rhs.transpose(1, 2),
                                                 off),
                gmm.grouped_matmul_drhs_reference(lhs, dy, off, e))
    return (gmm.grouped_matmul_fwd(lhs, rhs, off),
            gmm.grouped_matmul_dlhs(dy, rhs, off),
            gmm.grouped_matmul_drhs(lhs, dy, off, e))


GMM_KERNELS = ("grouped_matmul_fwd", "grouped_matmul_dlhs",
               "grouped_matmul_drhs")


def phase_gmm_parity(results):
    import torch
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gmm
    rows, failed = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        tol, rms_r = GMM_TOL[dname], GMM_RMS[dname]
        for i, (case, t, k, n, e, sizes, ids, bt) in enumerate(
                gmm_layouts()):
            lhs, rhs, dy, off = gmm_inputs(t, k, n, e, sizes, ids, bt,
                                           dtype, seed=400 + i)
            ws = [getattr(gmm, kname) for kname in GMM_KERNELS]
            before = [(w.launches, w.tma_launches) for w in ws]
            got = gmm_three(lhs, rhs, dy, off, plain=False)
            torch.cuda.synchronize()
            tma = gmm_tma_expected(dtype, k, n)
            paths = [(w.launches - a, w.tma_launches - b)
                     for w, (a, b) in zip(ws, before)]
            ref = gmm_three(lhs, rhs, dy, off, plain=True)
            ref32 = gmm_three(lhs.float(), rhs.float(), dy.float(), off,
                              plain=True)
            row = {"case": case, "T": t, "K": k, "N": n, "E": e,
                   "group_sizes": sizes, "tile_ids": ids, "dtype": dname,
                   "tol": tol, "rms_tol": rms_r,
                   "design": "tma_wgmma" if tma else "general_mma_sync",
                   "launches_and_tma_launches": paths}
            # each kernel launched once, through the design expected
            ok = paths == [(1, int(tma))] * 3
            for kname, g_, r, r32 in zip(GMM_KERNELS, got, ref, ref32):
                g_, r, r32 = g_.float(), r.float(), r32.float()
                err = (g_ - r).abs()
                scale = float(r.square().mean().sqrt())
                used = float((err / (tol * (scale + r.abs()))).max())
                rms = float((g_ - r32).square().mean().sqrt())
                rms_ref = float(r32.square().mean().sqrt())
                used_rms = rms / (rms_r * rms_ref + 1e-5)
                row[kname] = {"max_abs_err": float(err.max()),
                              "tol_used": used, "rms_err_f32": rms,
                              "rms_ref": rms_ref, "rms_tol_used": used_rms}
                ok &= used <= 1 and used_rms <= 1
            # an expert without rows: exact zeros from K7
            empty = [j for j in range(e) if ids is None and sizes[j] == 0]
            row["empty_experts_zero"] = all(not bool(got[2][j].any())
                                            for j in empty)
            row["ok"] = ok = ok and row["empty_experts_zero"]
            rows.append(row)
            if not ok:
                failed.append(row)
            if case == "op_bench" and dtype == torch.bfloat16:
                for kname in GMM_KERNELS:
                    results[kname]["max_abs_err"] = row[kname]["max_abs_err"]
            del lhs, rhs, dy, got, ref, ref32
            torch.cuda.empty_cache()
    # the autograd function against autograd through the dense oracle
    auto = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for case, t, k, n, e, sizes, _, bt in gmm_layouts()[3:5]:
            lhs, rhs, dy, _ = gmm_inputs(t, k, n, e, sizes, None, bt, dtype,
                                         seed=7)
            outs = []
            for fn in (gmm.grouped_matmul, gmm.grouped_matmul_reference):
                xs = [x.clone().requires_grad_() for x in (lhs, rhs)]
                y = fn(*xs, torch.tensor(sizes, device="cuda"))
                outs.append([y.detach().float()] + [
                    x.float() for x in torch.autograd.grad(y, xs, dy)])
            row = {"case": case, "dtype": dname,
                   "rms_tol": GMM_AUTOGRAD_RMS[dname]}
            for nm, a, b_ in zip(("out", "dlhs", "drhs"), *outs):
                row[nm] = float((a - b_).square().mean().sqrt()
                                / b_.square().mean().sqrt())
            row["ok"] = all(row[nm] <= GMM_AUTOGRAD_RMS[dname]
                            for nm in ("out", "dlhs", "drhs"))
            auto.append(row)
            if not row["ok"]:
                failed.append({"autograd": row})
    for kname in GMM_KERNELS:
        results[kname]["parity"] = "failed" if failed else "ok"
    if failed:
        emit({"phase": "gmm_parity", "failed": failed})
        raise AssertionError(f"{len(failed)} gmm_parity checks failed")
    return {"cases": rows, "autograd_vs_dense_oracle": auto}


def phase_gmm_op(results):
    """THE OP PATH: one forward + backward through the grouped_matmul
    entry at the op bench's geometry (bf16, block_t 512), as bench_ops.py
    drives it; the counts are reset just before and read just after, and
    must be K6 twice (forward, dlhs) and K7 once."""
    import torch
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gmm
    b = GMM_BENCH
    g = torch.Generator(device="cuda").manual_seed(SEED)
    lhs = torch.randn((b["T"], b["K"]), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    rhs = (torch.randn((b["E"], b["K"], b["N"]), generator=g, device="cuda")
           * 0.03).to(torch.bfloat16).requires_grad_()
    dy = torch.randn((b["T"], b["N"]), generator=g, device="cuda").to(
        torch.bfloat16)
    sizes = torch.full((b["E"],), b["T"] // b["E"], dtype=torch.int32,
                       device="cuda")
    wrappers = [getattr(gmm, k) for k in GMM_KERNELS]
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = w.tma_launches = 0        # the counts start here
    y = gmm.grouped_matmul(lhs, rhs, sizes, b["block_t"])
    y.backward(dy)
    torch.cuda.synchronize()
    launches = [w.launches for w in wrappers]  # ... and are read here
    tma = [w.tma_launches for w in wrappers]
    finite = bool(torch.isfinite(y).all() and torch.isfinite(lhs.grad).all()
                  and torch.isfinite(rhs.grad).all())
    if launches != [1, 1, 1] or tma != [1, 1, 1] or not finite:
        raise AssertionError(f"grouped_matmul entry: launches (fwd, dlhs, "
                             f"drhs) {launches}, of them through the TMA "
                             f"kernels {tma}, want [1, 1, 1] each; finite "
                             f"{finite}")
    for kname, n, nt in zip(GMM_KERNELS, launches, tma):
        results[kname]["launches"] = n
        results[kname]["tma_launches"] = nt
    names = ("fwd_k6", "dlhs_k6", "drhs_k7")
    return {"geometry": b, "dtype": "bfloat16",
            "launches": dict(zip(names, launches)),
            "tma_launches": dict(zip(names, tma)), "finite": finite,
            "out_rms": float(y.detach().float().square().mean().sqrt())}


def gmm_general(lhs, rhs, dy, off):
    """The general (mma.sync) kernels, the first design, on bf16 inputs
    that the wrappers send to the TMA kernels: called through the
    library's C entries, so one run times both designs on one card."""
    import torch
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gmm
    lib = gmm._kernel_lib()
    t, k = lhs.shape
    e, n = rhs.shape[0], rhs.shape[2]

    def k6(a, b):
        out = torch.empty((t, b.shape[2]), dtype=a.dtype, device=a.device)
        rc = lib.grouped_matmul_forward(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), off.data_ptr(), t,
            a.shape[1], b.shape[2], e, *b.stride(), 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"general K6 launch failed: cudaError {rc}")
        return out

    def k7():
        out = torch.empty((e, k, n), dtype=torch.float32, device=lhs.device)
        rc = lib.grouped_matmul_drhs(
            lhs.data_ptr(), dy.data_ptr(), out.data_ptr(), off.data_ptr(), t,
            k, n, e, 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"general K7 launch failed: cudaError {rc}")
        return out

    return dict(zip(GMM_KERNELS, (lambda: k6(lhs, rhs),
                                  lambda: k6(dy, rhs.transpose(1, 2)), k7)))


def gmm_timings(t, k, n, e, block_t):
    """Kernel, plain and library times of K6 forward, K6 as dlhs and K7
    at one equal-group geometry (bf16), beside their bounds: 2 T K N
    flops each; each input read once and each output written once. The
    wrappers take the TMA kernels here; general_ms times the first
    design on the same inputs."""
    import torch
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gmm
    lhs, rhs, dy, off = gmm_inputs(t, k, n, e, [t // e] * e, None, block_t,
                                   torch.bfloat16, seed=1)
    general = gmm_general(lhs, rhs, dy, off)
    c = t // e
    rhs_t = rhs.transpose(1, 2)
    ends = off[1:].contiguous()
    lib = {  # the batched product the JAX MoE layer uses instead
        "grouped_matmul_fwd": lambda: torch.bmm(lhs.view(e, c, k), rhs),
        "grouped_matmul_dlhs": lambda: torch.bmm(dy.view(e, c, n), rhs_t),
        "grouped_matmul_drhs": lambda: torch.bmm(
            lhs.view(e, c, k).transpose(1, 2), dy.view(e, c, n)),
    }
    grouped = {
        "grouped_matmul_fwd": lambda: torch._grouped_mm(lhs, rhs, offs=ends),
        "grouped_matmul_dlhs": lambda: torch._grouped_mm(dy, rhs_t,
                                                         offs=ends),
        "grouped_matmul_drhs": lambda: torch._grouped_mm(lhs.t(), dy,
                                                         offs=ends),
    }
    kern = dict(zip(GMM_KERNELS, (
        lambda: gmm.grouped_matmul_fwd(lhs, rhs, off),
        lambda: gmm.grouped_matmul_dlhs(dy, rhs, off),
        lambda: gmm.grouped_matmul_drhs(lhs, dy, off, e))))
    plain = dict(zip(GMM_KERNELS, (
        lambda: gmm.grouped_matmul_fwd_reference(lhs, rhs, off),
        lambda: gmm.grouped_matmul_fwd_reference(dy, rhs_t, off),
        lambda: gmm.grouped_matmul_drhs_reference(lhs, dy, off, e))))
    nbytes = {  # inputs once, outputs once (drhs writes f32)
        "grouped_matmul_fwd": 2 * (t * k + e * k * n + t * n),
        "grouped_matmul_dlhs": 2 * (t * n + e * k * n + t * k),
        "grouped_matmul_drhs": 2 * (t * k + t * n) + 4 * e * k * n,
    }
    flops = 2 * t * k * n
    table = {}
    ws = [getattr(gmm, name) for name in GMM_KERNELS]
    tma_before = [w.tma_launches for w in ws]
    for name in GMM_KERNELS:
        kern[name]()
    torch.cuda.synchronize()
    if [w.tma_launches - b for w, b in zip(ws, tma_before)] != [1, 1, 1]:
        raise AssertionError("gmm_time: the wrappers did not take the TMA "
                             f"kernels at T {t} K {k} N {n} E {e}")
    for name in GMM_KERNELS:
        b_ms, b_by = bound(flops, nbytes[name] + 4 * (e + 1))
        r = {"design": "tma_wgmma",
             "kernel_ms": time_ms(kern[name], samples=10, inner=5),
             "general_ms": time_ms(general[name], samples=10, inner=5),
             "plain_ms": time_ms(plain[name], samples=5, inner=1),
             "library_ms": time_ms(lib[name], samples=10, inner=5),
             "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
             "bytes": nbytes[name]}
        r["share_of_bound"] = b_ms / r["kernel_ms"]
        if hasattr(torch, "_grouped_mm"):
            try:
                r["grouped_mm_ms"] = time_ms(grouped[name], samples=10,
                                             inner=5)
            except RuntimeError as exc:   # a yardstick off the path
                r["grouped_mm_ms"] = None
                r["grouped_mm_error"] = str(exc)[:200]
        table[name] = r
    return table


def phase_gmm_time(results):
    b, m = GMM_BENCH, GMM_MOE
    bench = gmm_timings(b["T"], b["K"], b["N"], b["E"], b["block_t"])
    for name in GMM_KERNELS:
        results[name].update({key: bench[name][key] for key in (
            "design", "kernel_ms", "general_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")})
        results[name]["ms"] = bench[name]["kernel_ms"]
    return {"op_bench": {"geometry": b, "dtype": "bfloat16",
                         "times": bench},
            "moe_w_in": {"T": m["T"], "K": m["H"], "N": m["F"],
                         "E": m["E"], "dtype": "bfloat16",
                         "times": gmm_timings(m["T"], m["H"], m["F"],
                                              m["E"], 128)},
            "moe_w_out": {"T": m["T"], "K": m["F"], "N": m["H"],
                          "E": m["E"], "dtype": "bfloat16",
                          "times": gmm_timings(m["T"], m["F"], m["H"],
                                               m["E"], 128)},
            "general_ms": "the general mma.sync kernels (the first "
                          "design) on the same inputs",
            "library": "torch.bmm over the equal groups as [E, C, K] "
                       "(the batched product the JAX MoE layer runs); "
                       "grouped_mm_ms: torch._grouped_mm with the same "
                       "offsets, a second yardstick off the path",
            "bound_note": "2 T K N flops at 989 TFLOP/s vs inputs and "
                          "outputs once at 3.35 TB/s (drhs writes f32)"}


def moe_model(layers=None):
    import torch
    from paddle_tpu_torch.models.ernie_moe import (ErnieMoEConfig,
                                                   ErnieMoEForCausalLM)
    cfg = ErnieMoEConfig()
    if layers is not None:
        cfg.num_hidden_layers = layers
    return ErnieMoEForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(SEED))


def moe_ids(vocab):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(
        0, vocab, (MOE["batch"], MOE["seq"]))).to("cuda")


def moe_loss(model):
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    crit = LlamaPretrainingCriterion()

    def loss_fn(logits, labels):        # tests/test_moe.py:110-116
        aux = model.total_aux_loss()
        loss = crit(logits, labels)
        return loss if aux is None else loss + aux
    return loss_fn


def moe_param_counts(model):
    """(all parameters, parameters a token is computed with): of each MoE
    layer's expert stacks only top_k of E experts act on a token."""
    cfg = model.config
    total = sum(p.numel() for p in model.parameters())
    experts = sum(m.w_in.numel() + m.w_out.numel()
                  for m in model.moe_layers())
    return total, total - experts + experts * cfg.top_k // cfg.num_experts


def phase_moe_train(results):
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    t0 = time.perf_counter()
    model = moe_model()
    cfg = model.config
    n_params, n_active = moe_param_counts(model)
    opt = AdamW(learning_rate=MOE["lr"],
                parameters=model.named_parameters(), multi_precision=False)
    step = TrainStep(model, moe_loss(model), opt)
    ids = moe_ids(cfg.vocab_size)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, ids) for _ in range(MOE["warmup"])]
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = kern.tma_launches = 0    # the counts start here
    t0 = time.perf_counter()
    drops = []
    for _ in range(MOE["steps"]):
        losses.append(step(ids, ids))
        drops.append([m.drop_share for m in model.moe_layers()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [kern.launches for kern in kernels]   # ... and are read here
    tma = [kern.tma_launches for kern in kernels]
    expected = cfg.num_hidden_layers * MOE["steps"]
    if launches != [expected] * 3 or tma != [0, 0, 0]:
        raise AssertionError(
            f"flash launches (fwd, dq, dkv) {launches} != layers x timed "
            f"steps = {cfg.num_hidden_layers} x {MOE['steps']}, or TMA "
            f"launches {tma} (D 64 takes the first design)")
    loss_values = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_values):
        raise AssertionError(f"non-finite loss: {loss_values}")
    if not loss_values[-1] < loss_values[0]:
        raise AssertionError(f"the loss did not fall: {loss_values}")
    peak = torch.cuda.max_memory_allocated()
    tokens = MOE["batch"] * MOE["seq"]
    tok_s = tokens * MOE["steps"] / wall
    hd = cfg.hidden_size // cfg.num_attention_heads
    # attention products per token, forward + backward: 3 x (QK^T + PV)
    # over (L + 1) / 2 keys on average (causal), 2 flops a MAC
    attn_per_token = 3 * 2 * 2 * cfg.num_attention_heads * hd * \
        (MOE["seq"] + 1) / 2 * cfg.num_hidden_layers
    mfu = (6 * n_active + attn_per_token) * tok_s / BF16_FLOPS
    prof = profile_train_step(step, (ids, ids))
    capacity = max(1, int(cfg.capacity_factor * tokens * cfg.top_k
                          / cfg.num_experts))
    out = {"card": nvidia_smi_line(), "model": "ernie-moe",
           "config": "ErnieMoEConfig() defaults", "layers":
               cfg.num_hidden_layers, "moe_layers": len(model.moe_layers()),
           "hidden": cfg.hidden_size,
           "intermediate": cfg.intermediate_size,
           "heads": cfg.num_attention_heads, "head_dim": hd,
           "vocab": cfg.vocab_size, "experts": cfg.num_experts,
           "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
           "capacity": capacity, "dtype": "bfloat16", "params": n_params,
           "active_params": n_active,
           "optimizer": f"AdamW(lr={MOE['lr']}, multi_precision=False)",
           "loss": "LlamaPretrainingCriterion + total_aux_loss()",
           "batch": MOE["batch"], "seq": MOE["seq"],
           "reduced": ["random weights from a seed (no checkpoint in the "
                       "repo)"],
           "init_seconds": init_s, "losses": loss_values,
           "warmup_steps": MOE["warmup"], "timed_steps": MOE["steps"],
           "step_ms": wall / MOE["steps"] * 1e3, "tokens_per_s": tok_s,
           "mfu": mfu, "mfu_flops_per_token": 6 * n_active + attn_per_token,
           "mfu_note": "6 x active parameters (top_k of E experts) + "
                       "causal attention, per token, over 989e12",
           "drop_share_per_moe_layer": [
               [float(x) for x in row] for row in drops],
           "flash_launches": dict(zip(("fwd", "dq", "dkv"), launches)),
           "peak_mem_gb": peak / 2 ** 30, "profile_one_step": prof,
           # the profiled step's own wall carries the profiler's cost:
           # the idle share against the timed steps' mean
           "device_idle_share_of_timed_step":
               1 - prof["device_ms"] / (wall / MOE["steps"] * 1e3)
               if prof["device_ms"] else None}
    del step, opt, model
    torch.cuda.empty_cache()
    return out


def phase_moe_train_parity():
    import torch
    model = moe_model(layers=2)
    ids = moe_ids(model.config.vocab_size)
    loss_fn = moe_loss(model)
    moe = model.moe_layers()[0]
    runs = []
    for flash in (True, False):
        for blk in model.blocks:
            blk.attn.use_flash = flash
        seen = {}
        hook = moe.register_forward_pre_hook(
            lambda mod, args: seen.update(x=args[0].detach()))
        loss = loss_fn(model(ids), ids).float()
        loss.backward()
        hook.remove()
        x = seen["x"].reshape(-1, seen["x"].shape[-1])
        top2 = (x.float() @ moe.gate.weight.float()).topk(2, dim=-1)
        runs.append((loss.item(), top2.indices.sort(dim=-1).values,
                     {n: p.grad for n, p in model.named_parameters()}))
        model.zero_grad(set_to_none=True)
    (lk, rk, gk), (lr_, rr, gr) = runs
    flipped = int((rk != rr).any(dim=-1).sum())
    flip_share = flipped / rk.shape[0]
    loss_rel = abs(lk - lr_) / abs(lr_)
    worst, rows = 0.0, {}
    for name, a in gk.items():
        b = gr[name].float()
        rel = float((a.float() - b).square().mean().sqrt()
                    / b.square().mean().sqrt().clamp(min=1e-30))
        rows[name] = rel
        worst = max(worst, rel)
    ok = loss_rel <= MOE_LOSS_RTOL and worst <= MOE_GRAD_RMS and \
        flip_share <= MOE_ROUTE_FLIP_SHARE
    out = {"layers": 2, "moe_layers": 1, "loss_kernels": lk,
           "loss_reference": lr_, "loss_rel_err": loss_rel,
           "loss_rtol": MOE_LOSS_RTOL, "grad_rel_rms_worst": worst,
           "grad_rel_rms_tol": MOE_GRAD_RMS, "grad_rel_rms": rows,
           "tokens": rk.shape[0], "tokens_top2_differ": flipped,
           "top2_differ_share": flip_share,
           "top2_differ_tol": MOE_ROUTE_FLIP_SHARE, "ok": ok}
    del model, gk, gr, runs
    torch.cuda.empty_cache()
    if not ok:
        emit({"phase": "moe_train_parity", "failed": out})
        raise AssertionError("the ERNIE-MoE step through the kernels "
                             "disagrees with the step through the plain "
                             "sdpa")
    return out


def phase_build():
    from paddle_tpu_torch.ops.kernels import build
    out = {name: {"nvcc_seconds": b.seconds,
                  "ptxas": [ln.strip() for ln in b.log.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling entry" in ln]}
           for name, b in build.build_all(verbose=True).items()}
    # the TMA flash kernels are sized to the registers a thread has (168):
    # a spill is a fault of the design
    spills = [ln for ln in out["flash_attention_tma"]["ptxas"]
              if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        emit({"phase": "build", "failed": spills})
        raise AssertionError("the TMA flash kernels spill registers")
    return out


def main() -> int:
    if not (ROOT / "paddle_tpu_torch" / "serving.py").is_file():
        print("chip_smoke.py must run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs the card",
              file=sys.stderr)
        return 1
    # f32 parity without TF32, and bf16 GEMMs reducing in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    result = {"name": "paged_attention", "route": "cuda",
              "source": "paddle_tpu_torch/ops/kernels/csrc/"
                        "paged_attention.cu",
              "replaces": "paddle_tpu/ops/pallas/paged_attention.py:63",
              "tpu_kernel": "paddle_tpu/ops/pallas/paged_attention.py:"
                            "_kernel",
              "launches": None, "parity": None, "max_abs_err": None,
              "ms": None, "kernel_ms": None, "plain_ms": None,
              "bound_ms": None, "bound_by": None, "library_ms": None}
    # K1b/K2b at the Llama training geometry (the TMA / wgmma design;
    # general_ms times the first design alongside); K5 (dropout) in
    # K1a/K2a at the BERT geometry and K4 (segments) at the packed
    # geometry, both on the first design
    flash = {
        name: {"name": name, "route": "cuda",
               "source": "paddle_tpu_torch/ops/kernels/csrc/" + src,
               "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
               "tpu_kernel": f"paddle_tpu/ops/pallas/flash_attention.py:"
                             f"{body}",
               "design": None, "launches": None, "tma_launches": None,
               "parity": None, "max_abs_err": None,
               "ms": None, "kernel_ms": None, "general_ms": None,
               "plain_ms": None, "bound_ms": None, "bound_by": None,
               "library_ms": None}
        for name, line, body, src in (
            ("flash_attention_fwd", 476,
             "_flash_fwd_pallas_blhd (_fwd_kernel :99)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dq", 527,
             "_flash_bwd_pallas_blhd (_bwd_dq_kernel :208)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dkv", 540,
             "_flash_bwd_pallas_blhd (_bwd_dkv_kernel :278)",
             "flash_attention_tma.cu"),
            ("flash_attention_fwd_dropout", 76,
             "_keep_mask in _fwd_kernel (dropout_p > 0)",
             "flash_attention.cuh"),
            ("flash_attention_bwd_dq_dropout", 76,
             "_keep_mask in _bwd_dq_kernel (dropout_p > 0)",
             "flash_attention.cuh"),
            ("flash_attention_bwd_dkv_dropout", 76,
             "_keep_mask in _bwd_dkv_kernel (dropout_p > 0)",
             "flash_attention.cuh"),
            ("flash_attention_fwd_segmented", 738,
             "_flash_fwd_pallas_seg (_fwd_kernel, segmented=True)",
             "flash_attention.cuh"),
            ("flash_attention_bwd_dq_segmented", 768,
             "_flash_bwd_pallas_seg (_bwd_dq_kernel, segmented=True)",
             "flash_attention.cuh"),
            ("flash_attention_bwd_dkv_segmented", 768,
             "_flash_bwd_pallas_seg (_bwd_dkv_kernel, segmented=True)",
             "flash_attention.cuh"))}
    # K6 (forward, and dlhs on the transposed weights) and K7
    for name, line, body in (
            ("grouped_matmul_fwd", 180, "_gmm_kernel via _gmm_fwd_impl"),
            ("grouped_matmul_dlhs", 180,
             "_gmm_kernel via _gmm_fwd_impl on swapaxes(rhs) (:222)"),
            ("grouped_matmul_drhs", 206,
             "_gmm_drhs_kernel via _gmm_drhs_impl")):
        flash[name] = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/grouped_matmul.cu",
            "replaces": f"paddle_tpu/ops/pallas/grouped_matmul.py:{line}",
            "tpu_kernel": f"paddle_tpu/ops/pallas/grouped_matmul.py:{body}",
            # the design timed: gmm_fwd_tma_kernel / gmm_drhs_tma_kernel;
            # general_ms times the first design (mma.sync) alongside
            "design": None, "launches": None, "tma_launches": None,
            "parity": None, "max_abs_err": None,
            "ms": None, "kernel_ms": None, "general_ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None}
    state: dict = {}

    def free_serving():
        state.clear()
        torch.cuda.empty_cache()
        return {}

    phases = [
        ("env", lambda: {"nvidia_smi": smi, "torch": torch.__version__,
                         "cuda": torch.version.cuda, "device": kind,
                         "count": torch.cuda.device_count()}),
        ("build", phase_build),
        ("kernel_parity", lambda: phase_kernel_parity(result)),
        ("kernel_time", lambda: phase_kernel_time(result)),
        ("serve", lambda: phase_serve(state, result)),
        ("serve_parity", lambda: {**phase_serve_parity(state),
                                  **free_serving()}),
        ("flash_parity", lambda: phase_flash_parity(flash)),
        ("flash_time", lambda: phase_flash_time(flash)),
        ("train", lambda: phase_train(flash)),
        ("train_parity", phase_train_parity),
        ("flash_dropout_parity", lambda: phase_flash_dropout_parity(flash)),
        ("flash_varlen_parity", lambda: phase_flash_varlen_parity(flash)),
        ("flash_time_bert", lambda: phase_flash_time_bert(flash)),
        ("bert_train", lambda: phase_bert_train(flash)),
        ("bert_train_parity", phase_bert_train_parity),
        ("gmm_parity", lambda: phase_gmm_parity(flash)),
        ("gmm_op", lambda: phase_gmm_op(flash)),
        ("gmm_time", lambda: phase_gmm_time(flash)),
        ("moe_train", lambda: phase_moe_train(flash)),
        ("moe_train_parity", phase_moe_train_parity),
    ]
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        emit({"phase": name, "seconds": time.perf_counter() - t0, **info})
    print(smi, flush=True)
    emit({"kernels": [result, *flash.values()],
          "seconds": time.perf_counter() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
