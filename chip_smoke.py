#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and MoE paths on one card.

Run from the root of a checkout on a machine with a Hopper card:

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. ``env``            card name and power limit, torch and CUDA versions;
2. ``build``          compiles every kernel from ``paddle_tpu_torch``'s
                      sources with nvcc (sm_90a), one process per source,
                      printing ptxas' report (registers and spills per
                      TMA flash kernel instance, the segment instances
                      among them, and per split paged-attention instance,
                      and each one's CTAs an SM and shared memory); fails
                      if one of those spills or an instance is missing;
3. ``kernel_parity``  the paged-attention kernels against their plain
                      walk on the card, over the serving geometries
                      (decode, GQA, verify windows — serve_spec's among
                      them —, prefill chunk, dense
                      whole-prompt prefill, int8 pools, the int8-KV
                      engine's own shapes, f32, poisoned blocks, a long
                      GQA history in many spans cut by n_tiles): each
                      call's counts must show the design takes_split
                      names (the split design for bf16 q over bf16 or
                      int8 pools, the first design for f32); against the
                      walk in the working dtype, and against the walk and
                      the split walk (the kernel's spans, merged by its
                      rule) on f32 copies of the inputs (the kernel's
                      arithmetic) within one bf16 rounding of the output;
4. ``kernel_time``    the split design, the first design through its C
                      entry (general_ms), the plain walk and PyTorch's
                      scaled_dot_product_attention over the same K/V
                      gathered beforehand (a yardstick only), beside the
                      bound: decode with bf16 and with int8 pools, the
                      64-row prefill chunk with its K/V out of L2 (calls
                      rotate over four copies of the pools) and the
                      speculative verify window (8 slots x 5 rows at the
                      decode's positions) beside the decode's time;
5. ``serve``          THE SERVING PATH: a Llama-2-7B-width bf16 model with
                      random weights behind a PagedLlamaDecodeEngine and
                      a GenerationServer answers 12 requests; the kernel
                      launch counts are reset just before and read just
                      after: launches and split-design launches must both
                      equal layers x (decode steps + prefill chunks), the
                      tensor-core launches layers x the chunks split_plan
                      sends there (the kernels line reports these counts
                      by path); the decode profile reports
                      attention_ms_per_step; then a 4-layer int8-KV
                      engine answers 2 more requests under the same
                      gates;
6. ``serve_parity``   an engine built with attention_impl="reference"
                      over the same weights runs one prompt beside a
                      kernel engine: logits compared, greedy agreement
                      printed;
7. ``serve_spec``     SPECULATIVE SERVING: the serve phase's model and 12
                      requests through a target at 8 slots x 2048 tokens
                      with make_draft()'s 16-layer view (the target's own
                      weight tensors, by data_ptr; its extra memory is its
                      KV pool alone) proposing 4 tokens a step: exact
                      budgets; K3 launches = target layers x (plain steps
                      + verify steps + chunks) + draft layers x (4 x spec
                      steps + plain steps + draft chunks), the verify
                      windows and 64-row chunks on the tensor cores;
                      exactly one device-to-host read a spec step
                      (counted on the loop thread over the run, and the
                      profiled step's DtoH copies); check_invariants() on
                      both pools; every stream equal to the serve phase's
                      or parted where the plain logits are a near-tie
                      (0.1 + 0.02 |top|); acceptance, tokens a verify,
                      tokens/s and TTFT beside the plain phase's, and a
                      profiled spec step (K3 ms of verify and proposals);
8. ``serve_spec_full_accept``  4 layers of the same weights with an
                      independent 4-layer engine as the draft: the same
                      gates on launches and budgets, acceptance >= 95 %,
                      each rejection a near-tie of the verify logits;
9. ``hot_swap``       4 layers, 4 slots: 4 requests unswapped, then again
                      with a swap to cloned weights mid-stream (the
                      streams must equal the unswapped run's, the clones
                      installed) and a swap to a state dict with one leaf
                      of another shape (rejected and counted, the
                      streams go on); the swap's seconds at the step
                      boundary;
10. ``serve_supervised``  THE SUPERVISED SERVING PATH: the serve phase's
                      model and 12 requests at 8 slots x 2048 tokens under
                      supervise(srv), with the flight crash hooks on and
                      dumps to a temporary directory: a KillPoint at
                      serving.decode on the 31st decode passage (every
                      slot taken), then a stall (a 5 s sleep after the
                      70th engine.step has returned, against a 2 s
                      watchdog); gates: 2 restarts and 1 stall, the
                      requests recovered at each death = the requests
                      active then, none quarantined (quarantine_after=3:
                      a request active at both deaths is recovered
                      twice), one terminal flight event a request, exact
                      budgets, K3 launches = layers x (engine steps +
                      prefill chunks) over both incarnations (the stalled
                      step ran, its tokens uncommitted), all split, the
                      tensor-core ones = layers x the chunks split_plan
                      sends there; the supervisor's dumps hold loop_death,
                      recover and restart; check_invariants(); device
                      memory after the run within one KV pool of before
                      the kill; each stream equal to the serve phase's or
                      parted at a near-tie; recovery seconds (death to the
                      restarted loop's first committed token), the extra
                      prefill chunks, tokens/s and TTFT beside serve's;
11. ``rollout``       two replicas at the 7B widths, 2 layers and 4 slots
                      each; a CheckpointManager saves (a) their own
                      weights, (b) weights of another seed, (c) (a) with
                      one NaN, and rollout() deploys each from its path
                      with RolloutPolicy(max_divergence=0.0): (a) swaps
                      both with equal probes, (b) rolls the canary back
                      (its probe as before the swap; replica 2 never
                      swapped), (c) halts before any swap with the NaN
                      counted; a file truncated by
                      fault_injection.write_bytes is skipped by latest();
                      checkpoint bytes, save seconds (fsync on), load +
                      CRC-verify seconds and each stage's swap_seconds;
12. ``fleet``         THE FLEET PATH: Llama-2 7B widths (32 layers, the
                      serve phase's weights by seed), bf16, in replica
                      processes (serving_fleet, 8 slots x 2048, block 16,
                      chunk 64, supervised): (a) one replica boots
                      against an empty FLAGS_executable_cache_dir — nvcc
                      of every kernel source, gated: misses = writes =
                      the sources — primes, exports the warm bundle and
                      answers serve_workload's first 8 requests one by
                      one (the oracle); (b) spawn_fleet(2) boots two
                      replicas from that cache and bundle (misses 0,
                      pre-warmed programs > 0, failures 0), policy rr,
                      0.2 s heartbeat, and a FleetRouter takes the 8
                      requests while fault_injection SIGKILLs replica 1
                      at its 4th poll that brought tokens: every request
                      finishes, one terminal fleet event each, a
                      failover, replica 1 resurrected with misses 0 and
                      one more request through it equal to its oracle
                      stream, every stream equal to the oracle's or
                      parted at a near-tie of logits this process
                      computes from the same seeded weights, each
                      replica's K3 counters (from its stats reply) all
                      split and = layers x its engine calls; seconds of
                      the cold boot, each warm boot, kill to
                      resurrected and kill to the next token of each
                      failed-over request, decode tokens/s and TTFT
                      through the router beside the serve phase's;
13. ``serve_http``    THE INFERENCE FRONT END: save_inference_model of a
                      2-layer model at the 7B widths, inference.serve(
                      generate=True, fleet=2) over it; four concurrent
                      POST /generate equal to this process's engine's
                      greedy streams or parted at near-ties, one POST
                      /run equal to Predictor.run, the server and its
                      replica processes stopped within bounded waits;
14. ``flash_parity``  the flash-attention forward, dQ and dK/dV kernels
                      against their plain versions on the card, bf16 and
                      f32, at the training geometry (B 4, L 2048, H 32,
                      D 128) causal and full, D 64 through the [BH, L, D]
                      strides, a ragged L, L = 1, q, k, v as strided
                      views of one [B, L, 3, H, D] projection and
                      ERNIE-MoE's attention (B 8, L 2048, H 12, D 64,
                      causal) as GPTAttention's views: each call's
                      counts must show the design takes_tma names (the
                      TMA / wgmma kernels for bf16 at D 64 and 128, the
                      first design for f32); elementwise against the
                      plain version in the working dtype (the same
                      roundings), and in RMS against the plain version on
                      f32 copies of the inputs; then the FlashAttention
                      autograd function against autograd through the
                      plain sdpa;
15. ``flash_time``    the three kernels, the whole backward (with delta)
                      and forward + backward at the training geometry,
                      ERNIE-MoE's (D 64, causal) and D 64 in the [BH, L,
                      D] layout (BERT-base heads), all on the TMA design,
                      with the first design on the same inputs through
                      its C entries (general_ms), beside their plain
                      versions, their bounds and
                      PyTorch's scaled_dot_product_attention (a
                      yardstick only);
16. ``optimizer_parity``  the fused optimizer step's kernels (O1
                      unscale / finite check / norms / clip scale, O2
                      Adam-AdamW) against their plain versions on the card:
                      AdamW and Adam, bf16 and f16 parameters with moments
                      of their dtype and f32, f32, transposed parameters
                      and moments with strided gradients, decay
                      exemptions, each clip
                      spec, the plain, found and scaled modes (an inf
                      planted, a prior flag), numel 1, odd sizes, a
                      misaligned view and more tensors than one launch
                      takes: parameters, moments and powers bit-equal given
                      the same clip scale, O1's scale and norms within
                      1e-6, unscaled gradients bit-equal, a skipped step
                      bit-equal to before it, launches per case counted;
17. ``optimizer_time``  the JAX bench's 64 x (64x64) AdamW + global-norm
                      clip + cosine schedule step (host µs, fused and the
                      loop), and at the train phase's 1.07 B bf16
                      parameters O2 and O1 beside their bounds, their plain
                      versions, the loop, the optimizer's whole fused step
                      and torch._fused_adamw_ / torch._foreach_norm
                      (yardsticks); before the timing, O2 without a clip
                      and then O1 (unscale, global norm) and O2 with its
                      scale and flag are held against their plain versions
                      on those tensors (O2 bit-equal, O1 within 1e-6);
18. ``train``          THE TRAINING PATH: a Llama-2-7B-width bf16 model
                      (4 layers, random weights) trains with AdamW
                      through TrainStep on a batch of 4 x 2048 tokens:
                      2 warm-up and 5 timed steps; the three flash
                      launch counts and their TMA counts are reset just
                      before the timed steps and read just after, and
                      must each equal layers x timed steps; losses finite
                      and falling; then one step under torch.profiler;
                      AdamW steps through O2 (launches = timed steps x
                      batches of <= 256 tensors, no fallback to the loop,
                      counted the same way); the profiled step runs once
                      through the kernels and once through the loop
                      (FLAGS_fused_optimizer=0), each with the device ms
                      of its optimizer.step();
19. ``train_parity``  one step of the same widths at 2 layers through
                      the kernels against the same step with
                      use_flash_attention=False (autograd through the
                      plain sdpa): loss and every gradient compared;
20. ``amp_scaler``  THE AMP PATH: a 2-layer Llama-2-7B-width bf16 model
                      trains with ClipGradByGlobalNorm(1.0), LinearWarmup
                      over CosineAnnealingDecay and GradScaler(2**15,
                      decr_every_n_nan_or_inf=1) through O1 and O2; one
                      step gets an inf planted: that step leaves every
                      parameter and state bit-equal and halves the scale;
                      an earlier step is held against the plain versions
                      (unscaled gradients, parameters and states bit-equal
                      given the kernel's clip scale, which is within 1e-6);
                      scaler.step, scaler.update and scheduler.step run
                      under torch.cuda.set_sync_debug_mode("error"); the
                      O1/O2 launch counts are reset before and read after
                      (batches + finalize and batches a step, no
                      fallback);
21. ``flash_dropout_parity``  attention dropout inside the three flash
                      kernels (K5) at the BERT-base geometry (B 24, L 512,
                      H 12, D 64, bf16) and a small f32 case, p = 0.1,
                      causal and full: each kernel against its plain
                      version with the same seed (working dtype and f32
                      copies), bf16 on the TMA kernels and f32 on the
                      first design by their counts, the keep rate of the
                      mask, the TMA kernels' mask bit for bit (L = 64,
                      uniform P, v = I and dO = I), p = 0 equal to the
                      launch without dropout, two seeds differing, and
                      the FlashAttention autograd function against
                      autograd through the plain sdpa with the same mask;
22. ``flash_varlen_parity``  the segment-masked kernels (K4) on 12,288
                      packed tokens (sequences of 32-512 from a numpy
                      seed, H 12, D 64), bf16 and f32, causal and full,
                      and bf16 on the same ids shuffled, and at the JAX
                      package's segmented op bench (B 2, L 2048, H 8,
                      D 128, 4 segments a row), bf16 and f32, causal and
                      full: against their plain versions, each call's
                      design gated by its counts (the TMA kernels with
                      their windows for bf16, the first design for f32),
                      the first design forced on every bf16 case and held
                      against the same plain versions, and the autograd
                      function against the plain sdpa with the
                      block-diagonal mask; then the packed entry
                      flash_attn_varlen_qkvpacked, forward and backward,
                      on the packed batch (full) and on the op bench's
                      rows packed (causal), each with the segmented and
                      TMA launch counts reset just before and read just
                      after (1 each), its output and gradient held
                      against the plain versions on the same views;
23. ``flash_time_bert``  the kernels with and without dropout at the BERT
                      geometry (the TMA design, the first design beside
                      it with the same dropout: general_ms; what dropout
                      adds to each) and the segmented kernels at the
                      packed geometry and at the JAX package's segmented
                      op bench (B 2, L 2048, H 8, D 128, causal, 4
                      segments), the first design with the same segments
                      beside them, their plain versions, their bounds
                      (the pairs the function needs) and PyTorch's SDPA
                      (a yardstick);
24. ``bert_train``    THE BERT PATH: BERT-base MLM (12 layers, hidden 768,
                      vocab 30522, bf16, dropout 0.1) trains with AdamW
                      through TrainStep on 24 x 512 tokens: 2 warm-up and
                      5 timed steps; the flash launch counts (and their
                      dropout and TMA launches) are reset just before the
                      timed steps and read just after, and must each
                      equal layers x timed steps; losses finite and
                      falling;
                      then one step under torch.profiler;
                      AdamW steps through O2 (launches = timed steps x
                      batches of <= 256 tensors, no fallback to the loop,
                      counted the same way); the profiled step runs once
                      through the kernels and once through the loop
                      (FLAGS_fused_optimizer=0), each with the device ms
                      of its optimizer.step();
25. ``bert_train_parity``  one step of BERT-base widths at 2 layers
                      through the kernels against the same step through
                      the plain sdpa (an all-zero additive mask routes it
                      there) with the same seeds drawn in the same order:
                      loss and every gradient compared;
26. ``gmm_parity``    the grouped-matmul kernels (K6 forward, K6 as dlhs on
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
27. ``gmm_op``        THE OP PATH: one forward + backward through the
                      grouped_matmul entry at the op bench's geometry
                      (bf16); the three counts and their TMA counts are
                      reset just before and read just after: K6 twice
                      (forward, dlhs), K7 once, all through the TMA
                      kernels;
28. ``gmm_time``      the three kernels at the op bench's geometry and at
                      ERNIE-MoE's w_in and w_out products (the TMA
                      kernels), beside the first design's general kernels
                      on the same inputs, their plain versions, their
                      bounds, torch.bmm over the equal groups and
                      torch._grouped_mm (yardsticks);
29. ``moe_train``     THE ERNIE-MOE PATH: ERNIE-MoE at ErnieMoEConfig()
                      (12 layers, 6 of them MoE with 8 experts, top-2,
                      hidden 768, vocab 30522, bf16) trains with AdamW
                      through TrainStep on 8 x 2048 tokens with the LM loss
                      plus the aux loss: 2 warm-up and 5 timed steps; the
                      flash launch counts (causal, D 64) and their TMA
                      launches are reset just before the timed steps and
                      read just after, and must each equal layers x timed
                      steps; losses finite and
                      falling; the share of token choices capacity drops
                      per MoE layer; then one step under torch.profiler;
                      AdamW steps through O2 (launches = timed steps x
                      batches of <= 256 tensors, no fallback to the loop,
                      counted the same way); the profiled step runs once
                      through the kernels and once through the loop
                      (FLAGS_fused_optimizer=0), each with the device ms
                      of its optimizer.step();
30. ``moe_train_parity``  one step of a 2-layer ERNIE-MoE (one dense, one
                      MoE layer) through the kernels against the same step
                      through the plain sdpa: loss, every gradient and the
                      share of tokens whose top-2 experts differ; beside
                      it the same comparison with the plain step replaying
                      the kernel step's routing (the kernels alone).

Then the ``nvidia-smi`` name/power line, the ``{"kernels": [...]}`` line
(K3 on the split design at decode with bf16 and with int8 pools, at
the prefill chunk and at the speculative verify window, each with the
first design's time — the decode and prefill-chunk rows also carry
``fleet_launches``, the fleet replicas' launches on that path —, K1b and K2b at the Llama training geometry, K1a
and K2a at ERNIE-MoE's, K5 in K1a/K2a at the BERT geometry, K4 in them at the
packed geometry, K6 and K7 at the op bench's geometry, each flash and
K6/K7 row naming the design it timed, its TMA launches and the first
design's time where the TMA design took it, and O1 and O2 at the train
phase's parameters with their launches from the amp_scaler and train
phases)
and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Without CUDA, or when run outside a checkout, it
exits non-zero and prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
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
# the JAX package's segmented op bench (bench_ops.py:161-174): B 2, L 2048,
# H 8, D 128, causal, 4 equal segments a row
SEG_D128 = dict(shape=(2, 2048, 8, 128), segments=4)
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


def host_us(fn, calls: int = 20):
    """Host time to issue one call (us, no synchronisation inside): what
    a wrapper's checks, tensor-map encoding and launch cost the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return dt * 1e6


def time_ms(fn, samples: int = 20, inner: int = 5, warmup: int = 3):
    """Median over ``samples`` of the CUDA-event time of ``inner``
    back-to-back calls, per call (ms). Each sample is queued behind a
    device sleep longer than the host takes to issue it, so that the
    events time the device's work and not the host's issue rate (a
    wrapper's host cost can exceed a short kernel's device time)."""
    import torch
    for _ in range(warmup):
        fn()
    issue_s = host_us(fn, inner) * 1e-6 * inner
    cycles = int(2e9 * (1.5 * issue_s + 1e-4))   # clocks are <= 2 GHz
    times = []
    for _ in range(samples):
        torch.cuda._sleep(cycles)
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
        if poison:
            # and so do the poisoned block's scales
            kw["k_scale"][0] = float("nan")
            kw["v_scale"][0] = float("inf")
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
        # a long GQA history in 16 spans, n_tiles cutting span 12
        make_case("gqa_long_ntiles", 2, 1, 32, 8, 128, 16, 256, bf,
                  [4095, 3000], n_tiles=200, seed=13),
        make_case("int8_poisoned_ntiles", 4, 1, 32, 8, 128, 16, 32, bf,
                  [200, 150, 47, 5], quant=True, poison=True, n_tiles=13,
                  seed=14),
        # GQA at R = 8 and head dim 64, MHA verify windows of 2 and 3
        # rows (CUDA-core groups of 4 rows), 16-row int8 chunks at head
        # dim 64 on 32-column blocks
        make_case("gqa8_decode_d64", 4, 1, 32, 4, 64, 16, 32, bf,
                  [500, 260, 16, 3], seed=15),
        make_case("mha_verify_t3", 3, 3, 16, 16, 128, 16, 32, bf,
                  [300, 100, 2], seed=17),
        make_case("int8_mha_verify_t2_d64", 2, 2, 8, 8, 64, 16, 32, bf,
                  [480, 33], quant=True, seed=18),
        make_case("int8_d64_chunk", 2, 16, 8, 8, 64, 32, 16, bf,
                  [400, 40], quant=True, seed=16),
        verify_case(),
    ]


def verify_case():
    import torch
    # the serve_spec phase's verify window: k + 1 = 5 rows a slot at the
    # serve geometry (MHA: 5 rows a KV head, one 64-row tensor-core group)
    return make_case("mha_verify_t5_serve", 8, 5, 32, 32, 128, 16, 128,
                     torch.bfloat16, decode_case()["pos"], seed=19)


def phase_kernel_parity(result):
    import torch
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        _MMA_GROUP, _sms, paged_attention_kernel, paged_attention_reference,
        paged_attention_split_reference, split_plan, takes_split)
    pak = paged_attention_kernel
    rows = []
    worst = worst32 = 0.0
    for case in parity_cases():
        q, kp, vp, tables, positions = case["args"]
        split = takes_split(q, kp, tables)
        S, T, H, D = q.shape
        g, _, span, _ = split_plan(T, H // kp.shape[2], S, kp.shape[2], D,
                                   kp.shape[1], tables.shape[1],
                                   _sms(q.device))
        want = (1, int(split), int(split and g == _MMA_GROUP))
        before = (pak.launches, pak.split_launches, pak.mma_launches)
        got = pak(*case["args"], **case["kw"])
        torch.cuda.synchronize()
        counts = (pak.launches - before[0], pak.split_launches - before[1],
                  pak.mma_launches - before[2])
        if counts != want:
            raise AssertionError(
                f"{case['name']}: launches / split / tensor-core launches "
                f"{counts}, expected {want}: takes_split names the "
                f"{'split' if split else 'first'} design, split_plan "
                f"{g}-row groups")
        g = got.float()
        ref = paged_attention_reference(*case["args"], **case["kw"])
        # the same walk over f32 copies of the same inputs (int8 codes
        # and their scales stay as they are: the walk dequantizes into
        # q's dtype, now f32)
        if kp.dtype != torch.int8:
            kp, vp = kp.float(), vp.float()
        ref32 = paged_attention_reference(q.float(), kp, vp, tables,
                                          positions, **case["kw"])
        out_dtype = case["geometry"]["dtype"]
        tol, rtol32 = case["tol"], OUT_RTOL[out_dtype]
        refs = [("walk", ref.float(), tol, tol),
                ("f32_walk", ref32, OUT_ATOL, rtol32)]
        if split:
            # ... and split into the kernel's spans, merged by its rule
            refs.append(("f32_split", paged_attention_split_reference(
                q.float(), kp, vp, tables, positions, span=span,
                **case["kw"]), OUT_ATOL, rtol32))
        checks = {}
        for key, r, atol, rtol in refs:
            fin = torch.isfinite(r)
            if not bool(torch.isfinite(g)[fin].all()):
                raise AssertionError(f"{case['name']}: non-finite kernel "
                                     f"output where the {key} is finite")
            err = (g - r).abs()[fin]
            # the share of the tolerance used, worst element; > 1 fails
            checks[key] = (float(err.max()), float(
                (err / (atol + rtol * r[fin].abs())).max()))
        (mae, used), (mae32, used32) = checks["walk"], checks["f32_walk"]
        used32 = max(used32, checks.get("f32_split", (0, 0))[1])
        rows.append({"case": case["name"], **case["geometry"],
                     "design": "split" if split else "first",
                     "max_abs_err": mae, "tol": tol,
                     "tol_used": used, "max_abs_err_f32_walk": mae32,
                     "tol_f32_walk": {"atol": OUT_ATOL, "rtol": rtol32},
                     "tol_f32_walk_used": used32,
                     "max_abs_err_f32_split": checks.get(
                         "f32_split", (None,))[0],
                     "ok": used <= 1 and used32 <= 1})
        if not rows[-1]["ok"]:
            emit({"phase": "kernel_parity", "failed": rows[-1]})
            raise AssertionError(
                f"{case['name']}: kernel disagrees with the walk "
                f"(max abs err {mae}, tolerance {tol} abs/rel) or with "
                f"the f32 walk or its spans (max abs err {mae32}, "
                f"tolerance {OUT_ATOL} + {rtol32} rel)")
        if case["name"] == "decode":
            result["max_abs_err"] = mae
        worst = max(worst, mae)
        worst32 = max(worst32, used32)
    result["parity"] = "ok"
    return {"cases": rows, "worst_abs_err": worst,
            "worst_tol_f32_walk_used": worst32}


def attention_bytes_and_flops(case, n_tiles):
    """What a paged-attention call must move and do at these inputs:
    each K/V column a slot needs read once (slot s: columns 0 .. its last
    row's position, and none at or past n_tiles), with its int8 scales;
    q and out; the table entries of those columns, the positions and
    n_tiles; and 2 flops per MAC of QK and PV, summed over the rows (row
    (s, t) attends columns 0 .. positions[s, t])."""
    import torch
    q, kp, _vp, _tables, positions = case["args"]
    S, T, H, D = q.shape
    bs, K = kp.shape[1], kp.shape[2]
    cap = n_tiles * bs
    pos = positions.cpu().tolist()
    need = [min(max(row) + 1, cap) for row in pos]
    live_cols = sum(need)
    kv = live_cols * K * D * 2 * kp.element_size()
    if kp.dtype == torch.int8:
        kv += live_cols * K * 2 * 4
    walked = sum(-(-n // bs) for n in need)
    io = 2 * q.numel() * q.element_size() + walked * 4 \
        + positions.numel() * positions.element_size() + 4
    flops = sum(4 * H * D * min(p + 1, cap) for row in pos for p in row)
    return kv + io, flops


def k3_time_cases():
    import torch
    bf = torch.bfloat16
    dec = decode_case()
    dec8 = make_case("decode_int8", 8, 1, 32, 32, 128, 16, 128, bf,
                     dec["pos"], quant=True)
    # the serve run's longest prompt's last 64-row chunk
    chunk = make_case("prefill_chunk", 1, 64, 32, 32, 128, 16, 128, bf,
                      [999], seed=3)
    return {"decode_bf16": (dec, 1), "decode_int8": (dec8, 1),
            "prefill_chunk": (chunk, 4), "spec_verify_t5": (verify_case(), 1)}


def k3_timing(case, copies):
    """The split design (through the wrapper), the first design (its C
    entry), the plain walk and SDPA over the same K/V gathered into dense
    tensors beforehand (a yardstick only), device times. With copies > 1
    the calls rotate over that many copies of the pools, so that each
    finds its K/V out of L2, as a layer's chunk does in the serve run."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    q, kp, vp, tables, positions = case["args"]
    kw = dict(case["kw"])
    S, T, H, D = q.shape
    NB, bs, K, _ = kp.shape
    MB = tables.shape[1]
    n_tiles = max(case["pos"]) // bs + 1
    kw["n_tiles"] = nt = torch.tensor([n_tiles], dtype=torch.int32,
                                      device=q.device)
    quant = "k_scale" in kw and kw["k_scale"] is not None
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(copies - 1)]
    turn = [0]

    def pool():
        turn[0] = (turn[0] + 1) % copies
        return pools[turn[0]]

    def split():
        k, v = pool()
        pa.paged_attention_kernel(q, k, v, tables, positions, **kw)

    out = torch.empty_like(q)
    lib = pa._kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream

    def first():
        k, v = pool()
        rc = lib.paged_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kw["k_scale"].data_ptr() if quant else None,
            kw["v_scale"].data_ptr() if quant else None, tables.data_ptr(),
            positions.data_ptr(), nt.data_ptr(), out.data_ptr(), S, T, H, K,
            D, bs, MB, NB, pa._DTYPE_CODES[q.dtype],
            pa._DTYPE_CODES[k.dtype], stream)
        if rc:
            raise RuntimeError(f"first design's launch failed: {rc}")

    pak = pa.paged_attention_kernel
    mma = pa.split_plan(T, H // K, S, K, D, bs, MB,
                        pa._sms(q.device))[0] == pa._MMA_GROUP
    before = (pak.split_launches, pak.mma_launches)
    got = pak(q, kp, vp, tables, positions, **kw)
    torch.cuda.synchronize()
    if (pak.split_launches - before[0],
            pak.mma_launches - before[1]) != (1, int(mma)):
        raise AssertionError(f"{case['name']}: not the split design's "
                             f"{'tensor' if mma else 'CUDA'}-core path")
    ref = pa.paged_attention_reference(q, kp, vp, tables, positions, **kw)
    err = (got.float() - ref.float()).abs()
    if bool((err > case["tol"] * (1 + ref.float().abs())).any()):
        raise AssertionError(f"{case['name']}: the split design disagrees "
                             f"with the walk (max abs err "
                             f"{float(err.max())})")
    kernel_ms = time_ms(split)
    general_ms = time_ms(first)
    plain_ms = time_ms(
        lambda: pa.paged_attention_reference(q, kp, vp, tables, positions,
                                             **kw), samples=5, inner=1)
    # yardstick: SDPA over the same K/V (int8: dequantized to bf16)
    # pre-gathered into dense per-slot tensors with the same mask
    L = n_tiles * bs
    phys = tables[:, :n_tiles].clamp(min=0).long()
    dense = []
    for k, v in pools:
        if quant:
            k = (k.float() * kw["k_scale"][..., None]).to(q.dtype)
            v = (v.float() * kw["v_scale"][..., None]).to(q.dtype)
        rep = H // K
        dense.append(tuple(
            x[phys].reshape(S, L, K, 1, D).expand(S, L, K, rep, D)
            .reshape(S, L, H, D).transpose(1, 2).contiguous()
            for x in (k, v)))
    qd = q.transpose(1, 2).contiguous()
    cols = torch.arange(L, device=q.device)
    mask = (cols[None, None, None, :]
            <= positions[:, None, :, None])   # [S, 1, T, L]

    def library():
        turn[0] = (turn[0] + 1) % copies
        kd, vd = dense[turn[0]]
        F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)

    library_ms = time_ms(library)
    nbytes, flops = attention_bytes_and_flops(case, n_tiles)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    g, units, span, n_span = pa.split_plan(T, H // K, S, K, D, bs, MB,
                                           pa._sms(q.device))
    return {"max_abs_err": float(err.max()),
            "kernel_ms": kernel_ms, "general_ms": general_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "share_of_bound": bound_ms / kernel_ms,
            "general_share_of_bound": bound_ms / general_ms,
            "pool_copies": copies,
            "plan": {"group_rows": g, "ctas": units * n_span, "span": span},
            "geometry": case["geometry"], "positions": case["pos"]}


def phase_kernel_time(k3_rows):
    rows = {}
    for name, (case, copies) in k3_time_cases().items():
        rows[name] = k3_timing(case, copies)
        row = k3_rows[name]
        row.update({k: rows[name][k] for k in (
            "kernel_ms", "general_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")})
        row["ms"] = rows[name]["kernel_ms"]
        if name != "decode_bf16":       # kernel_parity sets the decode's
            row["max_abs_err"] = rows[name]["max_abs_err"]
    # the verify window reads the decode's K/V with 5 rows a slot in a
    # 64-row tensor-core group: its time beside the decode's
    verify = rows["spec_verify_t5"]
    verify["decode_kernel_ms"] = rows["decode_bf16"]["kernel_ms"]
    verify["vs_decode"] = verify["kernel_ms"] / verify["decode_kernel_ms"]
    k3_rows["spec_verify_t5"]["decode_ms"] = verify["decode_kernel_ms"]
    return {"card": nvidia_smi_line(), "rows": rows}


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


def serve_workload(vocab):
    """The serve phases' 12 requests: prompts of 16-1000 tokens from the
    seed (requests 0 and 5 share a 256-token prefix) and budgets of
    32-64 tokens, and the generator the rest of the phase draws from."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, vocab, 256)
    lengths = [296, 1000, 16, 640, 48, 356, 800, 120, 500, 64, 200, 900]
    prompts = [rng.integers(0, vocab, n) for n in lengths]
    prompts[0] = np.concatenate([prefix, rng.integers(0, vocab, 40)])
    prompts[5] = np.concatenate([prefix, rng.integers(0, vocab, 100)])
    budgets = [int(b) for b in rng.integers(32, 65, len(prompts))]
    return prompts, budgets, rng


def serve_requests(srv, prompts, budgets, timeout=600):
    """Submit the requests as every serve phase does — request 0 first,
    the rest once it has prefilled, so that request 5's admission finds
    the shared prefix in the radix tree — and wait for all of them.
    Returns the requests and the run's wall seconds (synchronized)."""
    import torch
    t_start = time.monotonic()
    reqs = [srv.submit(prompts[0], budgets[0])]
    while "t_first" not in reqs[0] and not reqs[0]["done"].is_set():
        time.sleep(0.005)
    reqs += [srv.submit(p, b) for p, b in zip(prompts[1:], budgets[1:])]
    wait_all(reqs, timeout=timeout)
    torch.cuda.synchronize()
    return reqs, time.monotonic() - t_start


def serve_numbers(reqs, wall):
    decode_tokens = sum(len(r["out"]) - 1 for r in reqs)
    ttft = [r["t_first"] - r["t0"] for r in reqs]
    return {"wall_s": wall,
            "generated_tokens": sum(len(r["out"]) for r in reqs),
            "decode_tokens": decode_tokens,
            "decode_tokens_per_s": decode_tokens / wall,
            "ttft_s": ttft, "ttft_median_s": statistics.median(ttft),
            "ttft_max_s": max(ttft)}


def phase_serve(state, k3):
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
    V = cfg.vocab_size
    prompts, budgets, rng = serve_workload(V)
    hits0 = eng._kv.prefix_hits
    srv = GenerationServer(eng)
    pak.launches = pak.split_launches = pak.mma_launches = 0  # counts start
    reqs, wall = serve_requests(srv, prompts, budgets)
    launches = pak.launches                # ... and are read here
    split_launches, mma_launches = pak.split_launches, pak.mma_launches
    if not srv.shutdown(drain=True, timeout=60):
        raise RuntimeError("server did not drain")
    check_budget(reqs, V)
    steps = srv.steps_run
    chunks, mma_chunks = serve_chunks(eng, reqs)
    check_serve_launches("the bf16 engine", eng.n_layers, steps, chunks,
                         mma_chunks, launches, split_launches, mma_launches)
    if eng._kv.prefix_hits - hits0 < 1 \
            or reqs[5]["prefix_hit_tokens"] < 256:
        raise AssertionError("the shared prefix did not hit the radix "
                             "tree")
    numbers = serve_numbers(reqs, wall)
    state["serve"] = {"prompts": prompts, "budgets": budgets,
                      "streams": [list(r["out"]) for r in reqs],
                      "steps": steps, "chunks": chunks, **numbers}
    state["launches"] = launches
    # each row's count as the wrapper counted it, by path: the decode
    # steps ran the CUDA-core kernel, the prefill chunks the tensor cores
    k3["decode_bf16"]["launches"] = split_launches - mma_launches
    k3["prefill_chunk"]["launches"] = mma_launches
    state["layers"] = eng.n_layers
    out = {"card": nvidia_smi_line(), "model": "llama2-7b-width",
           "layers": eng.n_layers,
           "hidden": cfg.hidden_size, "dtype": "bfloat16",
           "init_seconds": init_s, "requests": len(reqs),
           "prompt_lengths": [len(p) for p in prompts],
           "budgets": budgets, "prefix_hit_tokens":
               [r["prefix_hit_tokens"] for r in reqs],
           **numbers, "steps": steps, "prefill_chunks": chunks,
           "kernel_launches": launches,
           "split_launches": split_launches,
           "mma_launches": mma_launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    out["decode_profile"] = profile_decode(eng, rng, V)
    del eng, srv
    torch.cuda.empty_cache()
    # the int8-KV dtype path: 4 layers of the same weights
    eng8 = PagedLlamaDecodeEngine(model, max_slots=2, max_seq=1024,
                                  kv_quant="int8", num_layers=4)
    srv8 = GenerationServer(eng8)
    pak.launches = pak.split_launches = pak.mma_launches = 0  # counts start
    reqs8 = [srv8.submit(rng.integers(0, V, n), 32) for n in (200, 90)]
    wait_all(reqs8, timeout=300)
    if not srv8.shutdown(drain=True, timeout=60):
        raise RuntimeError("int8 server did not drain")
    n8, split8, mma8 = (pak.launches, pak.split_launches,  # ... are read
                        pak.mma_launches)
    check_budget(reqs8, V)
    steps8 = srv8.steps_run
    chunks8, mma_chunks8 = serve_chunks(eng8, reqs8)
    check_serve_launches("the int8-KV engine", eng8.n_layers, steps8,
                         chunks8, mma_chunks8, n8, split8, mma8)
    k3["decode_int8"]["launches"] = split8 - mma8
    out["int8_kv"] = {"layers": 4, "requests": 2, "steps": steps8,
                      "prefill_chunks": chunks8, "kernel_launches": n8,
                      "split_launches": split8, "mma_launches": mma8}
    return out


def serve_chunks(eng, reqs):
    """The prefill chunks a serve run ran, and of those the ones whose
    rows ``split_plan`` sends to the tensor cores."""
    import torch
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    kvh, mb = eng.cfg.num_key_value_heads, eng._kv.block_tables.shape[1]
    sms = pa._sms(torch.device("cuda", torch.cuda.current_device()))
    chunks = mma = 0
    for r in reqs:
        left = len(r["prompt"]) - r["prefix_hit_tokens"]
        while left > 0:
            c = min(eng.prefill_chunk_len, left)
            g = pa.split_plan(c, eng.n_rep, 1, kvh, eng.head_dim,
                              eng.block_size, mb, sms)[0]
            chunks, mma = chunks + 1, mma + int(g == pa._MMA_GROUP)
            left -= c
    return chunks, mma


def check_serve_launches(what, layers, steps, chunks, mma_chunks,
                         launches, split, mma):
    """Every launch of a serve run took the split design, on the tensor
    cores once a layer for each chunk split_plan sends there, on the
    CUDA cores for the decode steps and the other chunks."""
    want = (layers * (steps + chunks), layers * (steps + chunks),
            layers * mma_chunks)
    if (launches, split, mma) != want or launches == 0:
        raise AssertionError(
            f"{what}: launches / split / tensor-core launches "
            f"{(launches, split, mma)}, expected {want} = layers x "
            f"(decode steps + prefill chunks), layers x tensor-core "
            f"chunks: {layers} x ({steps} + {chunks}), {layers} x "
            f"{mma_chunks}")


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
# speculative serving and weight hot-swap
# ---------------------------------------------------------------------------

SPEC_K = 4                      # draft tokens a speculative step proposes
# acceptance of a draft equal to its target, counting the proposals a
# near-tie rejection forfeits as explained (bf16 logits tie often:
# their unit in the last place is 2^-7 near |logit| 1-2)
SPEC_ACCEPT_MIN = 0.95


class HostReads:
    """Counts, while a thread has set ``on``, the ways a CUDA tensor's
    values reach the host: ``.cpu()``, ``.to("cpu")``, ``.item()``,
    ``.tolist()`` and int / float / bool / index of a tensor. Installed
    on ``torch.Tensor`` for the ``with`` block only."""

    NAMES = ("cpu", "to", "item", "tolist", "__int__", "__float__",
             "__bool__", "__index__")

    def __init__(self):
        import threading
        self.local = threading.local()
        self.count = 0
        self._saved = {}

    def _host_bound(self, name, a, kw):
        if name != "to":
            return True
        import torch
        dev = kw.get("device", a[0] if a else None)
        return isinstance(dev, (str, torch.device)) \
            and torch.device(dev).type == "cpu"

    def __enter__(self):
        import torch
        for name in self.NAMES:
            self._saved[name] = torch.Tensor.__dict__.get(name)
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, _name=name, **kw):
                if getattr(self.local, "on", False) and t.is_cuda \
                        and self._host_bound(_name, a, kw):
                    self.count += 1
                return _orig(t, *a, **kw)

            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        import torch
        for name, orig in self._saved.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)
        return False

    def watch(self, fn):
        """``fn`` with counting on for the calling thread."""
        def watched(*a, **kw):
            self.local.on = True
            try:
                return fn(*a, **kw)
            finally:
                self.local.on = False
        return watched


def count_chunks(eng):
    """Record the rows of every prefill chunk ``eng`` runs (its own
    calls and, for a draft, the target's mirrored ones)."""
    rows = []
    orig = eng.prefill_chunk

    def chunk(slot):
        st = eng._prefill_state[slot]
        limit = eng.prefill_chunk_len if eng._chunk_cap is None \
            else max(8, min(eng.prefill_chunk_len, eng._chunk_cap))
        rows.append(min(limit, len(st["ids"]) - st["next"]))
        return orig(slot)

    eng.prefill_chunk = chunk
    return rows


def spec_counters():
    from paddle_tpu_torch.observability import metrics as om
    reg = om.default_registry()
    return {n: reg.get("serving." + n).value() for n in (
        "spec_steps_total", "spec_proposed_total", "spec_accepted_total",
        "spec_rolled_back_total")}


def commit_counter(eng):
    """Wrap ``eng.spec_step`` to add up the tokens each verify commits
    and the slot windows it closes."""
    tally = {"committed": 0, "windows": 0}
    orig = eng.spec_step

    def step():
        act = eng.active.copy()
        toks, counts = orig()
        tally["committed"] += int(counts[act].sum())
        tally["windows"] += int(act.sum())
        return toks, counts

    eng.spec_step = step
    return tally


def check_spec_launches(what, eng, rows_t, rows_d, spec_steps, plain_steps,
                        got):
    """K3's launches in a speculative serve run, by path: the target
    once a layer for each plain step, verify step and prefill chunk; the
    draft once a layer for each of its k proposals a spec step, each
    mirrored plain step and each of its prefill chunks. Verify windows
    and chunks that split_plan sends to the tensor cores count there."""
    import torch
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    draft = eng._draft
    lt, ld, k = eng.n_layers, draft.n_layers, eng._spec_k
    kvh, mb = eng.cfg.num_key_value_heads, eng._kv.block_tables.shape[1]
    sms = pa._sms(torch.device("cuda", torch.cuda.current_device()))

    def mma(rows, S=1):
        return pa.split_plan(rows, eng.n_rep, S, kvh, eng.head_dim,
                             eng.block_size, mb, sms)[0] == pa._MMA_GROUP

    verify_mma = mma(k + 1, eng.max_slots)
    total = lt * (plain_steps + spec_steps + len(rows_t)) \
        + ld * (k * spec_steps + plain_steps + len(rows_d))
    on_mma = lt * (spec_steps * verify_mma + sum(map(mma, rows_t))) \
        + ld * sum(map(mma, rows_d))
    if tuple(got) != (total, total, on_mma) or total == 0:
        raise AssertionError(
            f"{what}: launches / split / tensor-core launches {tuple(got)},"
            f" expected {(total, total, on_mma)}: target {lt} layers x "
            f"({plain_steps} plain + {spec_steps} verify steps + "
            f"{len(rows_t)} chunks), draft {ld} layers x ({k} x "
            f"{spec_steps} + {plain_steps} + {len(rows_d)} chunks)")
    return {"verify_launches": lt * spec_steps,
            "verify_on_tensor_cores": bool(verify_mma),
            "propose_launches": ld * k * spec_steps,
            "target_chunks": len(rows_t), "draft_chunks": len(rows_d)}


def profile_spec(eng, rng, vocab, ctx=1000, steps=5, tries=3):
    """Where a full speculative step's time goes: every slot active at
    ``ctx`` tokens of history, host wall time per step (synchronized),
    the device time by kernel from torch.profiler (K3 split into the
    verify's tensor-core launches and the proposals' CUDA-core ones),
    and the step's device-to-host copies as the profiler sees them.

    At 32 layers (~5,300 device records a step) the profiler can drop
    records at both ends of its window: the first step's first copies,
    and a copy that ends just before the window closes. So the window
    opens after a warm-up step (a schedule) and closes after a pause,
    and a profile counts only when its device memcpy records match the
    runtime's memcpy calls one for one; one that does not is taken
    again, at most ``tries`` times, on slots filled anew."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    wall_ms = None
    for attempt in range(1, tries + 1):
        for s in range(eng.max_slots):
            eng.prefill(s, rng.integers(0, vocab, ctx),
                        budget=(steps * 2 + 4) * eng._spec_k)
        for _ in range(2):
            eng.spec_step()
        torch.cuda.synchronize()
        if wall_ms is None:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.spec_step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps,
                                       repeat=1)) as prof:
            for i in range(steps + 1):
                eng.spec_step()
                torch.cuda.synchronize()
                if i == steps:
                    time.sleep(0.05)
                prof.step()
        by_kernel, d2h, copies, calls = {}, 0, 0, 0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if ev.key.startswith("Memcpy "):
                copies += ev.count
                d2h += ev.count if "DtoH" in ev.key else 0
            elif ev.key.startswith("cudaMemcpy"):
                calls += ev.count
            if us:
                by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us
        for s in range(eng.max_slots):
            eng.release(s)
        if calls and copies == calls:
            break
    else:
        raise AssertionError(
            f"torch.profiler kept {copies} device memcpy records of "
            f"{calls} runtime memcpy calls in each of {tries} profiles")
    if d2h != steps:
        raise AssertionError(f"a profiled spec step made {d2h / steps} "
                             f"device-to-host copies, expected 1")
    device_ms = sum(by_kernel.values()) / 1e3 / steps
    verify_ms = sum(v for k, v in by_kernel.items()
                    if "paged_attention_split_mma" in k) / 1e3 / steps
    propose_ms = sum(v for k, v in by_kernel.items()
                     if "paged_attention" in k
                     and "split_mma" not in k) / 1e3 / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"slots": eng.max_slots, "context": ctx, "steps": steps,
            "step_wall_ms": wall_ms, "device_ms_per_step": device_ms,
            "k3_verify_ms_per_step": verify_ms,
            "k3_propose_ms_per_step": propose_ms,
            "device_to_host_copies_per_step": d2h / steps,
            "memcpy_records_per_step": copies / steps,
            "profiles_taken": attempt,
            "device_idle_share": 1 - device_ms / wall_ms,
            "top_kernels_ms_per_step": [[k[:80], v / 1e3 / steps]
                                        for k, v in top]}


def near_tie(eng1, prompt, stream, j, other):
    """The plain target's logits where two greedy streams part (token
    ``j``: ``stream[j]`` there, ``other`` in the other stream),
    recomputed by prefilling ``prompt + stream[:j]`` into a one-slot
    engine: both tokens must lie within the engine logit tolerance of
    the largest logit (0.1 + 0.02 |top|)."""
    import numpy as np
    eng1.prefill(0, np.concatenate([prompt, np.asarray(stream[:j])]),
                 budget=1)
    lg = eng1.last_logits.float()
    eng1.release(0)
    top2 = lg.topk(2).values
    top = float(top2[0])
    tol = LOGITS_ATOL + LOGITS_RTOL * abs(top)
    below = top - min(float(lg[stream[j]]), float(lg[other]))
    return {"token": j, "top2_gap": top - float(top2[1]),
            "candidates_below_top": below, "tol": tol, "ok": below <= tol}


def shared_weights(eng, draft):
    """Every weight tensor of the draft is one of the target's (the same
    storage), for the first ``draft.n_layers`` layers and the embedding,
    norm and head."""
    ok = all(draft.params[n].data_ptr() == eng.params[n].data_ptr()
             for n in ("emb", "norm", "head"))
    for i, lp in enumerate(draft.params["layers"]):
        ok &= all(w.data_ptr() == eng.params["layers"][i][nm].data_ptr()
                  for nm, w in lp.items())
    return ok and len(draft.params["layers"]) == draft.n_layers


def phase_serve_spec(state, k3):
    """The serve phase's model and requests through a speculative
    server: the target at 8 slots and 2048 tokens with make_draft()'s
    16-layer weight-sharing view proposing SPEC_K tokens a step."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    from paddle_tpu_torch.serving import (GenerationServer,
                                          PagedLlamaDecodeEngine)
    model, plain = state["model"], state["serve"]
    V = model.config.vocab_size
    eng = PagedLlamaDecodeEngine(model, max_slots=8, max_seq=2048)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    draft = eng.make_draft()
    torch.cuda.synchronize()
    draft_mem = torch.cuda.memory_allocated() - mem0
    eng.attach_draft(draft, spec_tokens=SPEC_K)
    pool_bytes = sum(t.numel() * t.element_size()
                     for ts in draft.kvs.values() for t in ts)
    if not shared_weights(eng, draft) or draft.n_layers != 16 \
            or not 0 <= draft_mem - pool_bytes < 2 ** 20:
        raise AssertionError(
            f"the draft ({draft.n_layers} layers) does not share the "
            f"target's weights, or takes {draft_mem} bytes for a "
            f"{pool_bytes}-byte KV pool")
    rows_t, rows_d = count_chunks(eng), count_chunks(draft)
    tally = commit_counter(eng)
    srv = GenerationServer(eng)
    c0 = spec_counters()
    with HostReads() as reads:
        eng.spec_step = reads.watch(eng.spec_step)
        pak.launches = pak.split_launches = pak.mma_launches = 0
        reqs, wall = serve_requests(srv, plain["prompts"], plain["budgets"])
        got = (pak.launches, pak.split_launches, pak.mma_launches)
    if not srv.shutdown(drain=True, timeout=60):
        raise RuntimeError("speculative server did not drain")
    check_budget(reqs, V)
    c1 = spec_counters()
    spec_steps = c1["spec_steps_total"] - c0["spec_steps_total"]
    proposed = c1["spec_proposed_total"] - c0["spec_proposed_total"]
    accepted = c1["spec_accepted_total"] - c0["spec_accepted_total"]
    plain_steps = srv.steps_run - spec_steps
    paths = check_spec_launches("the speculative engine", eng, rows_t,
                                rows_d, spec_steps, plain_steps, got)
    if reads.count != spec_steps or spec_steps == 0:
        raise AssertionError(
            f"{reads.count} device-to-host reads in {spec_steps} spec "
            f"steps: each must make exactly one")
    eng._kv.check_invariants()
    draft._kv.check_invariants()
    k3["spec_verify_t5"]["launches"] = paths["verify_launches"]
    out = {"card": nvidia_smi_line(), "target_layers": eng.n_layers,
           "draft_layers": draft.n_layers, "spec_tokens": SPEC_K,
           "draft_weights_shared": True, "draft_extra_bytes": draft_mem,
           "draft_pool_bytes": pool_bytes,
           **serve_numbers(reqs, wall),
           "spec_steps": spec_steps, "plain_steps": plain_steps,
           "proposed": proposed, "accepted": accepted,
           "acceptance": accepted / max(proposed, 1),
           "rolled_back_blocks": c1["spec_rolled_back_total"]
           - c0["spec_rolled_back_total"],
           "tokens_per_verify_step": tally["committed"] / max(spec_steps, 1),
           "tokens_per_verify_window": tally["committed"]
           / max(tally["windows"], 1),
           "host_reads_in_spec_steps": reads.count,
           "kernel_launches": got[0], "mma_launches": got[2], **paths}
    out["spec_profile"] = profile_spec(eng, np.random.default_rng(SEED + 2),
                                       V)
    del srv, eng, draft
    torch.cuda.empty_cache()
    # the streams against the plain serve phase's: where one parts, the
    # plain target's logits there must be a near-tie
    eng1 = PagedLlamaDecodeEngine(model, max_slots=1, max_seq=2048)
    parted = []
    for i, (r, want) in enumerate(zip(reqs, plain["streams"])):
        got_s = list(r["out"])
        j = next((j for j, (a, b) in enumerate(zip(want, got_s))
                  if a != b), None)
        if j is not None:
            tie = near_tie(eng1, plain["prompts"][i], want, j, got_s[j])
            parted.append({"request": i, **tie})
    del eng1
    torch.cuda.empty_cache()
    out["streams_equal_plain"] = len(reqs) - len(parted)
    out["streams_parted_at_near_ties"] = parted
    out["plain"] = {k: plain[k] for k in (
        "decode_tokens_per_s", "ttft_median_s", "ttft_max_s", "wall_s",
        "steps")}
    if not all(p["ok"] for p in parted):
        emit({"phase": "serve_spec", "failed": parted})
        raise AssertionError("a speculative stream parted from the plain "
                             "one where the plain logits are no near-tie")
    return out


def phase_serve_spec_full_accept(state):
    """4 layers of the same weights with, as the draft, an independent
    engine of the target's full depth: every proposal is the target's
    own greedy token up to the numerics of the two paths (the draft's
    M = 8 products and CUDA-core K3, the verify's M = 40 products and
    tensor-core K3), so each rejection must be a near-tie of the
    verify's logits, and the acceptance, with the proposals those
    near-ties forfeit counted as explained, must reach
    SPEC_ACCEPT_MIN."""
    import torch
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    from paddle_tpu_torch.serving import (GenerationServer,
                                          PagedLlamaDecodeEngine)
    model, plain = state["model"], state["serve"]
    V = model.config.vocab_size
    geo = dict(max_slots=8, max_seq=2048, num_layers=4)
    eng = PagedLlamaDecodeEngine(model, **geo)
    draft = PagedLlamaDecodeEngine(model, **geo)
    eng.attach_draft(draft, spec_tokens=SPEC_K)
    rows_t, rows_d = count_chunks(eng), count_chunks(draft)
    rejections = []
    verify = eng._spec_verify

    def inspected(draft_tok):
        t, n_acc = verify(draft_tok)
        act = torch.as_tensor(eng.active, device=t.device)
        for s in torch.nonzero((n_acc < SPEC_K) & act).flatten().tolist():
            i = int(n_acc[s])
            lg = eng.last_logits[s, i].float()
            a, b = int(t[s, i]), int(draft_tok[s, i])
            tol = LOGITS_ATOL + LOGITS_RTOL * abs(float(lg[a]))
            gap = float(lg[a] - lg[b])
            rejections.append({"gap": gap, "tol": tol, "ok": gap <= tol,
                               "forfeit": SPEC_K - i})
        return t, n_acc

    eng._spec_verify = inspected
    srv = GenerationServer(eng)
    c0 = spec_counters()
    pak.launches = pak.split_launches = pak.mma_launches = 0
    reqs, wall = serve_requests(srv, plain["prompts"], plain["budgets"])
    got = (pak.launches, pak.split_launches, pak.mma_launches)
    if not srv.shutdown(drain=True, timeout=60):
        raise RuntimeError("full-accept server did not drain")
    check_budget(reqs, V)
    c1 = spec_counters()
    spec_steps = c1["spec_steps_total"] - c0["spec_steps_total"]
    proposed = c1["spec_proposed_total"] - c0["spec_proposed_total"]
    accepted = c1["spec_accepted_total"] - c0["spec_accepted_total"]
    paths = check_spec_launches("the full-accept engine", eng, rows_t,
                                rows_d, spec_steps,
                                srv.steps_run - spec_steps, got)
    eng._kv.check_invariants()
    draft._kv.check_invariants()
    acceptance = accepted / max(proposed, 1)
    explained = (accepted + sum(r["forfeit"] for r in rejections
                                if r["ok"])) / max(proposed, 1)
    out = {"target_layers": 4, "draft_layers": 4, "spec_tokens": SPEC_K,
           "spec_steps": spec_steps,
           "plain_steps": srv.steps_run - spec_steps,
           "proposed": proposed, "accepted": accepted,
           "acceptance": acceptance,
           "acceptance_with_near_ties": explained,
           "rejections": len(rejections),
           "rejections_near_tie": sum(r["ok"] for r in rejections),
           "worst_rejection_gap": max((r["gap"] for r in rejections),
                                      default=None),
           **serve_numbers(reqs, wall), **paths}
    del srv, eng, draft
    torch.cuda.empty_cache()
    forfeited = sum(r["forfeit"] for r in rejections)
    if explained < SPEC_ACCEPT_MIN or not all(r["ok"] for r in rejections) \
            or forfeited != proposed - accepted:
        emit({"phase": "serve_spec_full_accept", "failed": out})
        raise AssertionError(
            f"acceptance {acceptance:.4f} of a draft equal to its target, "
            f"{explained:.4f} with near-ties (limit {SPEC_ACCEPT_MIN}), a "
            f"rejection that is no near-tie, or rejections that do not "
            f"add up to the counters ({forfeited} forfeited, "
            f"{proposed - accepted} not accepted)")
    return out


def phase_hot_swap(state):
    """4 layers, 4 slots: four requests run once unswapped and once with
    two swaps mid-stream — to a copy of the same weights (installed at a
    step boundary; the streams must equal the unswapped run's) and to a
    state dict with one leaf of another shape (rejected: the counter
    rises, the copies stay installed, the streams go on)."""
    import torch
    from paddle_tpu_torch.observability import metrics as om
    from paddle_tpu_torch.serving import (GenerationServer,
                                          PagedLlamaDecodeEngine)
    model, plain = state["model"], state["serve"]
    prompts, budgets = plain["prompts"][:4], [64] * 4
    geo = dict(max_slots=4, max_seq=2048, num_layers=4)
    ref_srv = GenerationServer(PagedLlamaDecodeEngine(model, **geo))
    ref, _ = serve_requests(ref_srv, prompts, budgets)
    if not ref_srv.shutdown(drain=True, timeout=60):
        raise RuntimeError("reference server did not drain")
    del ref_srv
    keys = ["llama.embed_tokens.weight", "llama.norm.weight"] + \
        ([] if model.config.tie_word_embeddings else ["lm_head.weight"]) + \
        [k for k in model.state_dict() if any(
            k.startswith(f"llama.layers.{i}.") for i in range(4))]
    sd = model.state_dict()
    copy = {k: sd[k].clone() for k in keys}
    bad = dict(copy)
    up = "llama.layers.0.mlp.up_proj.weight"
    bad[up] = copy[up][:-8]
    reg = om.default_registry()
    rejected0 = reg.get("serving.weight_swaps_rejected_total").value()
    eng = PagedLlamaDecodeEngine(model, **geo)
    srv = GenerationServer(eng)
    reqs = [srv.submit(p, b) for p, b in zip(prompts, budgets)]

    def wait_tokens(n):
        t_end = time.monotonic() + 120
        while min(len(r["out"]) for r in reqs) < n:
            if time.monotonic() > t_end:
                raise TimeoutError("hot_swap requests made no progress")
            time.sleep(0.001)

    wait_tokens(4)
    res = srv.swap_weights(copy, timeout=60)
    installed = eng.params
    wait_tokens(12)
    try:
        srv.swap_weights(bad, timeout=60)
        raise AssertionError("a swap to another shape was accepted")
    except ValueError as e:
        reason = str(e)
    in_flight = sum(not r["done"].is_set() for r in reqs)
    wait_all(reqs, timeout=300)
    if not srv.shutdown(drain=True, timeout=60):
        raise RuntimeError("hot_swap server did not drain")
    rejected = reg.get("serving.weight_swaps_rejected_total").value() \
        - rejected0
    streams_equal = [list(a["out"]) == list(b["out"])
                     for a, b in zip(reqs, ref)]
    out = {"layers": 4, "slots": 4, "requests": 4,
           "swap_seconds": res["seconds"], "in_flight_at_swap":
               res["in_flight"], "steps_before_swap": res["steps_run"],
           "weight_swaps": srv.stats()["weight_swaps"],
           "rejected_swaps": rejected, "rejection": reason[:160],
           "in_flight_after_rejection": in_flight,
           "copies_installed": eng.params is installed
           and eng.params["emb"].data_ptr()
           == copy["llama.embed_tokens.weight"].data_ptr(),
           "streams_equal_unswapped": streams_equal}
    del srv, eng, copy, bad
    torch.cuda.empty_cache()
    if not (all(streams_equal) and res["in_flight"] >= 1 and rejected == 1
            and in_flight >= 1 and out["copies_installed"]
            and out["weight_swaps"] == 1):
        emit({"phase": "hot_swap", "failed": out})
        raise AssertionError("hot swap: streams, swap counts or the "
                             "installed weights are not as required")
    return out


# ---------------------------------------------------------------------------
# the supervised serving path and canary rollout
# ---------------------------------------------------------------------------

SUP_KILL_SKIP = 30      # the kill: the 31st decode passage (slots full)
SUP_STALL_STEP = 70     # the stall: after the 70th engine.step returned
SUP_STALL_SECONDS = 2.0  # the watchdog's limit (a step or chunk: < 0.3 s)
SUP_STALL_SLEEP = 5.0   # the stalled thread's sleep, past the limit


def quiet_killpoints():
    """A thread hook that stays silent for the phase's own KillPoint and
    prints any other thread death as the default hook does; returns the
    hook it replaced."""
    import threading
    from paddle_tpu_torch.utils import fault_injection as fi
    prev = threading.excepthook

    def hook(args):
        if not issubclass(args.exc_type, fi.KillPoint):
            prev(args)

    threading.excepthook = hook
    return prev


def first_commit_after(evs, t_us):
    """Timestamp of the first committed token (a decode step's or a
    finished prefill's) at or after ``t_us``."""
    return min(e["ts_us"] for e in evs if e["cat"] == "serving"
               and e["name"] in ("decode", "prefilled")
               and e["ts_us"] >= t_us)


def phase_serve_supervised(state):
    """The serve phase's model and 12 requests under supervise(srv): a
    KillPoint at serving.decode mid-stream with every slot taken, then a
    stall (a sleep past the watchdog's limit after an engine.step has
    returned, so the stalled thread's device work is done before the
    fence). Both deaths are recovered: the pools rebuilt, the loop
    restarted, every active request re-prefilled with its committed
    tokens. quarantine_after=3, so that a request active at both deaths
    is recovered twice rather than quarantined."""
    import gc
    import shutil
    import tempfile
    import threading
    import torch
    from paddle_tpu_torch.core.flags import get_flags, set_flags
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    from paddle_tpu_torch.serving import (GenerationServer,
                                          PagedLlamaDecodeEngine)
    from paddle_tpu_torch.serving_supervisor import supervise
    from paddle_tpu_torch.utils import fault_injection as fi
    model, plain = state["model"], state["serve"]
    V = model.config.vocab_size
    gc.collect()  # earlier phases' engines in reference cycles: gone
    # before the memory level is read
    dump_dir = tempfile.mkdtemp(prefix="flight-")
    saved = get_flags(["FLAGS_flight_dump_dir",
                       "FLAGS_flight_recorder_capacity"])
    set_flags({"FLAGS_flight_dump_dir": dump_dir,
               "FLAGS_flight_recorder_capacity": 1 << 17})
    prev_hook = quiet_killpoints()
    flight.install_crash_hooks()
    eng = PagedLlamaDecodeEngine(model, max_slots=8, max_seq=2048)
    pool_bytes = sum(t.numel() * t.element_size()
                     for ts in eng.kvs.values() for t in ts)
    rows = count_chunks(eng)
    chunk_call = eng.prefill_chunk
    calls = {"steps": 0, "stall_at": None, "slowest_step_s": 0.0,
             "slowest_chunk_s": 0.0, "mem_before_kill": None}
    step_call = eng.step

    def step():
        t0 = time.perf_counter()
        out = step_call()
        calls["slowest_step_s"] = max(calls["slowest_step_s"],
                                      time.perf_counter() - t0)
        calls["steps"] += 1
        if calls["steps"] == SUP_KILL_SKIP:  # the last step before the kill
            torch.cuda.synchronize()
            calls["mem_before_kill"] = torch.cuda.memory_allocated()
        if calls["steps"] == SUP_STALL_STEP:
            torch.cuda.synchronize()
            calls["stall_at"] = time.perf_counter()
            time.sleep(SUP_STALL_SLEEP)
        return out

    def chunk(slot):
        t0 = time.perf_counter()
        out = chunk_call(slot)
        calls["slowest_chunk_s"] = max(calls["slowest_chunk_s"],
                                       time.perf_counter() - t0)
        return out

    eng.step, eng.prefill_chunk = step, chunk
    srv = GenerationServer(eng)
    sup = supervise(srv, stall_seconds=SUP_STALL_SECONDS,
                    quarantine_after=3)
    fired0 = fi.stats().get("serving.decode", 0)
    try:
        flight.clear()
        fi.inject("serving.decode", kill=True, skip=SUP_KILL_SKIP)
        pak.launches = pak.split_launches = pak.mma_launches = 0  # start
        reqs, wall = serve_requests(srv, plain["prompts"], plain["budgets"])
        got = (pak.launches, pak.split_launches, pak.mma_launches)  # read
        evs = flight.events()
        fired = fi.stats().get("serving.decode", 0) - fired0
        sup.stop()
        if not srv.shutdown(drain=True, timeout=60):
            raise RuntimeError("supervised server did not drain")
        steps_committed = srv.steps_run
        sup_dumps = [d for d in flight.find_dumps(dump_dir)
                     if d.endswith("-supervisor.jsonl")]
        dumped = {e["name"] for e in flight.load_dump(sup_dumps[0])[1]
                  if e["cat"] == "supervisor"} if sup_dumps else set()
        crash_dumps = [d for d in flight.find_dumps(dump_dir)
                       if d.endswith("-exception.jsonl")]
    finally:
        fi.clear("serving.decode")
        sup.stop()
        srv.shutdown(drain=False, timeout=10)
        flight.uninstall_crash_hooks()
        threading.excepthook = prev_hook
        set_flags(saved)
        shutil.rmtree(dump_dir, ignore_errors=True)
    check_budget(reqs, V)
    eng._kv.check_invariants()
    st = sup.stats()
    del srv, sup
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    # the journal: two deaths (the kill, then the stall), every active
    # request recovered at each, one terminal event a request
    sup_evs = [e for e in evs if e["cat"] == "supervisor"]
    deaths = [e["attrs"] for e in sup_evs if e["name"] == "loop_death"]
    restarts = [e for e in sup_evs if e["name"] == "restart"]
    recovered = [e for e in sup_evs if e["name"] == "recover"]
    crashed = [e for e in evs if e["cat"] == "serving"
               and e["name"] == "loop_crashed"]
    terminal = {r["trace_id"]: sum(
        1 for e in evs if e.get("trace_id") == r["trace_id"]
        and e["name"] in ("finished", "expired", "failed")) for r in reqs}
    twice = [t for t in {e.get("trace_id") for e in recovered}
             if sum(e.get("trace_id") == t for e in recovered) == 2]
    # K3: every engine.step (the stalled one included: it ran, and its
    # tokens were never committed) and every chunk, both incarnations
    kvh, mb = eng.cfg.num_key_value_heads, eng._kv.block_tables.shape[1]
    sms = pa._sms(torch.device("cuda", torch.cuda.current_device()))
    mma_chunks = sum(pa.split_plan(r, eng.n_rep, 1, kvh, eng.head_dim,
                                   eng.block_size, mb, sms)[0]
                     == pa._MMA_GROUP for r in rows)
    L = eng.n_layers
    want = (L * (calls["steps"] + len(rows)),) * 2 + (L * mma_chunks,)
    kill_t = crashed[0]["ts_us"] if crashed else 0.0
    recovery_s = [
        (first_commit_after(evs, restarts[0]["ts_us"]) - kill_t) / 1e6,
        first_commit_after(evs, restarts[1]["ts_us"]) / 1e6
        - calls["stall_at"]] if len(restarts) == 2 and crashed else None
    numbers = serve_numbers(reqs, wall)
    out = {"card": nvidia_smi_line(), "layers": L, "slots": eng.max_slots,
           "requests": len(reqs), "killpoints_fired": fired,
           "restarts": st["restarts"], "stalls": st["stalls"],
           "recovered": st["recovered"], "quarantined": st["quarantined"],
           "deaths": deaths,
           "recovered_per_restart": [e["attrs"]["recovered"]
                                     for e in restarts],
           "backoff_s": [e["attrs"]["backoff"] for e in restarts],
           "recovered_twice": len(twice),
           "recovery_seconds": recovery_s,
           "stall_seconds": SUP_STALL_SECONDS,
           "slowest_step_s": calls["slowest_step_s"],
           "slowest_chunk_s": calls["slowest_chunk_s"],
           "prefill_chunks": len(rows),
           "extra_prefill_chunks": len(rows) - plain["chunks"],
           "engine_steps": calls["steps"],
           "steps_committed": steps_committed,
           "kernel_launches": got[0], "split_launches": got[1],
           "mma_launches": got[2], "expected_launches": list(want),
           "supervisor_dumps": len(sup_dumps),
           "supervisor_dump_events": sorted(dumped),
           "crash_dumps": len(crash_dumps),
           "pool_bytes": pool_bytes,
           "mem_before_kill": calls["mem_before_kill"],
           "mem_after_recovery": mem_after, **numbers,
           "serve": {k: plain[k] for k in (
               "decode_tokens_per_s", "ttft_median_s", "ttft_max_s",
               "wall_s", "steps")}}
    # the streams against the serve phase's: where one parts, the plain
    # logits there must be a near-tie
    eng.step, eng.prefill_chunk = step_call, chunk_call
    eng1 = PagedLlamaDecodeEngine(model, max_slots=1, max_seq=2048)
    parted = []
    for i, (r, want_s) in enumerate(zip(reqs, plain["streams"])):
        got_s = list(r["out"])
        j = next((j for j, (a, b) in enumerate(zip(want_s, got_s))
                  if a != b), None)
        if j is not None:
            parted.append({"request": i, **near_tie(
                eng1, plain["prompts"][i], want_s, j, got_s[j])})
    del eng1, eng
    torch.cuda.empty_cache()
    out["streams_equal_serve"] = len(reqs) - len(parted)
    out["streams_parted_at_near_ties"] = parted
    checks = {
        "one kill fired": fired == 1,
        "restarts 2, stalls 1": (st["restarts"], st["stalls"]) == (2, 1),
        "the deaths: the kill, then the stall": [
            (d["kind"], d["error"]) for d in deaths]
        == [("crash", "KillPoint"), ("stall", "stall")]
        and [e["attrs"]["error"] for e in crashed] == ["KillPoint"],
        "the kill with every slot taken": bool(deaths)
        and deaths[0]["in_flight"] == out["slots"],
        "recovered = active at each death": len(restarts) == 2
        and [e["attrs"]["recovered"] for e in restarts]
        == [d["in_flight"] for d in deaths]
        and st["recovered"] == len(recovered) == sum(
            d["in_flight"] for d in deaths),
        "quarantined 0": st["quarantined"] == 0,
        "one terminal event a request": set(terminal.values()) == {1},
        "K3 launches by path": got == want and got[0] > 0,
        "the stalled step uncommitted": calls["steps"]
        == steps_committed + 1,
        "the supervisor's dumps": len(sup_dumps) == 2
        and {"loop_death", "recover", "restart"} <= dumped,
        "memory back within one pool": calls["mem_before_kill"] is not None
        and abs(mem_after - calls["mem_before_kill"]) < pool_bytes,
        "streams equal or parted at near-ties": all(p["ok"]
                                                    for p in parted),
    }
    out["failed_gates"] = [k for k, ok in checks.items() if not ok]
    if out["failed_gates"]:
        emit({"phase": "serve_supervised", "failed": out})
        raise AssertionError("serve_supervised: " +
                             "; ".join(out["failed_gates"]))
    return out


def rollout_keys(model, layers):
    return ["llama.embed_tokens.weight", "llama.norm.weight"] + \
        ([] if model.config.tie_word_embeddings else ["lm_head.weight"]) + \
        [k for k in model.state_dict() if any(
            k.startswith(f"llama.layers.{i}.") for i in range(layers))]


def phase_rollout(state):
    """Two replicas at the 7B widths, 2 layers and 4 slots each. A
    CheckpointManager saves three checkpoints — (a) the replicas' own
    weights, (b) weights of another seed, (c) (a) with one NaN — and
    rollout() deploys each from its path: (a) reaches both replicas with
    equal probes, (b) rolls the canary back bit-equal and never reaches
    replica 2, (c) halts before any swap; a file truncated by
    fault_injection.write_bytes is skipped by latest()."""
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch.core.flags import flag_value
    from paddle_tpu_torch.framework.checkpoint import (CheckpointManager,
                                                       load_checkpoint)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import metrics as om
    from paddle_tpu_torch.serving import (GenerationServer,
                                          PagedLlamaDecodeEngine)
    from paddle_tpu_torch.serving_supervisor import RolloutPolicy, rollout
    from paddle_tpu_torch.utils import fault_injection as fi
    model = state["model"]
    layers = 2
    geo = dict(max_slots=4, max_seq=2048, num_layers=layers)
    sd = model.state_dict()
    own = {k: sd[k] for k in rollout_keys(model, layers)}
    other_model = LlamaForCausalLM(
        LlamaConfig(dtype="bfloat16", use_flash_attention=False,
                    num_hidden_layers=layers), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 7))
    other = dict(other_model.state_dict())
    nan = dict(own)
    nan["llama.norm.weight"] = own["llama.norm.weight"].clone()
    nan["llama.norm.weight"][0] = float("nan")
    root = tempfile.mkdtemp(prefix="ckpt-")
    reg = om.default_registry()

    def count(name):
        inst = reg.get("serving." + name)
        return inst.value() if inst is not None else 0

    servers = []
    try:
        mgr = CheckpointManager(root, keep_n=4)
        saves = []
        for step, tree in enumerate((own, other, nan)):
            t0 = time.perf_counter()
            path = mgr.save({"model": tree, "step": step}, step=step)
            saves.append((path, time.perf_counter() - t0))
        del other_model, other, nan
        torch.cuda.empty_cache()
        nbytes = os.path.getsize(saves[0][0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_checkpoint(saves[0][0])  # CRC check, then the card
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        equal_load = all(torch.equal(loaded["model"][k], own[k])
                         for k in own)
        del loaded
        servers = [GenerationServer(PagedLlamaDecodeEngine(model, **geo))
                   for _ in range(2)]
        pol = RolloutPolicy(max_divergence=0.0)
        probe = servers[0].generate(pol.probe_prompt, pol.probe_tokens)
        rb0, nf0 = count("rollout_rollbacks_total"), count(
            "rollout_nonfinite_weights_total")
        rep_a = rollout(saves[0][0], servers, pol)
        before_1 = servers[1].engine.params
        swaps_1 = servers[1].stats()["weight_swaps"]
        rep_b = rollout(saves[1][0], servers, pol)
        probe_b = servers[0].generate(pol.probe_prompt, pol.probe_tokens)
        untouched = servers[1].engine.params is before_1 \
            and servers[1].stats()["weight_swaps"] == swaps_1
        rep_c = rollout(saves[2][0], servers, pol)
        probe_c = servers[0].generate(pol.probe_prompt, pol.probe_tokens)
        nonfinite = count("rollout_nonfinite_weights_total") - nf0
        rollbacks = count("rollout_rollbacks_total") - rb0
        swaps = [s.stats()["weight_swaps"] for s in servers]
        # a torn write at the next step's path: latest() walks past it
        skipped0 = mgr.stats()["corrupt_skipped"]
        with open(saves[0][0], "rb") as f:
            head = f.read(1 << 20)
        fi.inject("chip.torn_write", truncate_at=4096)
        with open(mgr._path(3), "wb") as f:
            try:
                fi.write_bytes("chip.torn_write", f, head)
                torn = False
            except fi.InjectedFault:
                torn = True
        latest = mgr.latest()
        skipped = mgr.stats()["corrupt_skipped"] - skipped0
    finally:
        fi.clear("chip.torn_write")
        for srv in servers:
            srv.shutdown(drain=True, timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    stages = {name: [{k: v for k, v in st.items()
                      if k not in ("probe_pre", "probe_post")}
                     for st in rep["stages"]]
              for name, rep in (("a", rep_a), ("b", rep_b), ("c", rep_c))}
    out = {"card": nvidia_smi_line(), "replicas": 2, "layers": layers,
           "slots": 4, "checkpoint_bytes": nbytes,
           "save_seconds": [s for _, s in saves],
           "save_gb_per_s": [nbytes / s / 1e9 for _, s in saves],
           "load_verify_seconds": load_s,
           "load_verify_gb_per_s": nbytes / load_s / 1e9,
           "fsync": bool(flag_value("checkpoint_fsync")),
           "probe": probe,
           "verdicts": {n: {k: r[k] for k in ("swapped", "rolled_back",
                                               "halted", "reason")}
                        for n, r in (("a", rep_a), ("b", rep_b),
                                     ("c", rep_c))},
           "stages": stages,
           "swap_seconds": {n: [st.get("swap_seconds") for st in v]
                            for n, v in stages.items()},
           "weight_swaps": swaps, "nonfinite_counted": nonfinite,
           "rollbacks_counted": rollbacks,
           "torn_file_skipped": skipped,
           "latest_after_torn_write": os.path.basename(latest or "")}
    checks = {
        "the load equals what was saved": equal_load,
        "(a) swaps both, probes equal": rep_a["swapped"] == 2
        and not rep_a["halted"] and rep_a["stages"][0]["divergence"] == 0.0
        and rep_a["stages"][0]["probe_pre"] == probe
        and rep_a["stages"][0]["probe_post"] == probe,
        "(b) rolls the canary back": rep_b["halted"]
        and rep_b["rolled_back"] == 1 and rollbacks == 1
        and rep_b["reason"] == "probe_divergence"
        and rep_b["stages"][0]["divergence"] > 0.0,
        "(b) the canary's probe as before the swap": probe_b == probe,
        "(b) replica 2 never swapped": untouched
        and len(rep_b["stages"]) == 1,
        "(c) halts before any swap": rep_c["halted"]
        and rep_c["swapped"] == 0 and rep_c["reason"] == "nonfinite_weights"
        and nonfinite == 1 and probe_c == probe,
        "swap counts": swaps == [3, 1],
        "the torn file skipped": torn and skipped == 1
        and latest == saves[2][0],
    }
    out["failed_gates"] = [k for k, ok in checks.items() if not ok]
    if out["failed_gates"]:
        emit({"phase": "rollout", "failed": out})
        raise AssertionError("rollout: " + "; ".join(out["failed_gates"]))
    return out


# ---------------------------------------------------------------------------
# the serving fleet and the inference front end
# ---------------------------------------------------------------------------

FLEET_LAYERS = 32       # Llama-2 7B's depth: two replicas take ~45 GB
FLEET_REQUESTS = 8      # the first 8 of serve_workload's requests
FLEET_KILL_SKIP = 3     # SIGKILL replica 1 at its 4th poll with tokens
FLEET_HEARTBEAT = 0.2
FLEET_TERMINAL = ("finished", "failed", "shed")


def gpu_memory():
    """The card's memory in use and in all (MiB) as nvidia-smi reads it:
    every process on the card counted; None without nvidia-smi."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used,memory.total",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    used, total = (int(x) for x in
                   got.stdout.strip().splitlines()[0].split(","))
    return {"used_mib": used, "total_mib": total}


def fleet_model_spec(layers, widths=None):
    """The replicas' tiny_llama model: Llama-2 7B widths (the serve
    phase's config and seed, so the same weights), bf16."""
    cfg = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
               num_attention_heads=32, num_key_value_heads=32,
               max_position_embeddings=4096, use_flash_attention=False,
               dtype="bfloat16")
    cfg.update(widths or {})
    cfg["num_hidden_layers"] = layers
    return {"kind": "tiny_llama", "seed": SEED, "config": cfg}


def fleet_parent_model(spec, device):
    """The same seeded weights in this process, to judge near-ties."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(
        LlamaConfig.tiny(**spec["config"]), device=device,
        generator=torch.Generator(device=device).manual_seed(spec["seed"]))


def streams_against(model, prompts, want, got, max_seq):
    """Each got stream against its want: equal, or parted where the
    logits of ``model`` (a one-slot engine) are a near-tie."""
    from paddle_tpu_torch.serving import PagedLlamaDecodeEngine
    eng1 = PagedLlamaDecodeEngine(model, max_slots=1, max_seq=max_seq,
                                  device=model.llama.embed_tokens.weight
                                  .device)
    parted = []
    for i, (w, g) in enumerate(zip(want, got)):
        if len(w) != len(g):
            parted.append({"request": i, "ok": False,
                           "lengths": [len(w), len(g)]})
            continue
        j = next((j for j, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if j is not None:
            parted.append({"request": i, **near_tie(
                eng1, prompts[i], w, j, g[j])})
    return parted


def phase_fleet(state, k3, device="cuda", widths=None, layers=FLEET_LAYERS,
                timeout=900):
    """THE FLEET PATH. (a) One replica process boots against an empty
    FLAGS_executable_cache_dir (nvcc of every kernel source), primes,
    exports the warm bundle and answers the 8 prompts one by one through
    ReplicaClient.generate: the oracle. (b) spawn_fleet(2) boots two
    replicas from that cache and bundle (no nvcc; the bundle's programs
    pre-warmed), round-robin, 0.2 s heartbeat; the router takes the 8
    requests and fault_injection SIGKILLs replica 1 at its 4th poll that
    brought tokens; the victims fail over to replica 0 with their
    committed tokens and replica 1 is resurrected from the cache."""
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.serving_fleet import (ReplicaClient,
                                                launch_replica, spawn_fleet)
    from paddle_tpu_torch.utils import fault_injection as fi
    spec = fleet_model_spec(layers, widths)
    V = spec["config"]["vocab_size"]
    prompts, budgets, _ = serve_workload(V)
    prompts, budgets = prompts[:FLEET_REQUESTS], budgets[:FLEET_REQUESTS]
    prompts = [[int(t) for t in p] for p in prompts]
    base = {"model": spec, "device": device, "max_slots": 8,
            "max_seq": 2048, "block_size": 16, "prefill_chunk": 64,
            "supervised": True}
    root = tempfile.mkdtemp(prefix="fleet-")
    bundle = os.path.join(root, "warm_bundle.json")
    env = {"FLAGS_executable_cache_dir": os.path.join(root, "cache")}
    n_src = len(build.sources()) if device == "cuda" else 0
    out = {"card": nvidia_smi_line(), "model": "llama2-7b-width",
           "layers": layers, "dtype": "bfloat16", "slots": 8,
           "max_seq": 2048, "requests": len(prompts),
           "kernel_sources": n_src}
    router = None
    try:
        # (a) the cold boot and the oracle
        cold = dict(base, prime=prompts[2] + prompts[4][:100],
                    prime_tokens=4, export_bundle=bundle)
        t0 = time.perf_counter()
        proc, port, boot = launch_replica(cold, env=env, timeout=timeout)
        out["cold_boot_seconds"] = time.perf_counter() - t0
        out["cold_boot"] = boot
        cli = ReplicaClient("127.0.0.1", port)
        try:
            oracle = [cli.generate(p, b, timeout=timeout)
                      for p, b in zip(prompts, budgets)]
            out["cold_cache_after_traffic"] = cli._call(
                {"op": "cache_stats"})["cache"]
            cli._call({"op": "shutdown", "drain": True})
        finally:
            cli.close()
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            proc.stderr_log.close()
        with open(bundle) as f:
            out["bundle_entries"] = [e["name"] + ":" + str(
                e["meta"].get("bucket", "")) for e in
                json.load(f)["entries"]]
        # (b) the fleet
        flight.clear()
        warm = dict(base, warm_bundle=bundle)
        t0 = time.perf_counter()
        router = spawn_fleet(2, warm, env=env, timeout=timeout,
                             router_kwargs=dict(
                                 policy="rr",
                                 heartbeat_seconds=FLEET_HEARTBEAT,
                                 heartbeat_misses=3, restart_backoff=0.05,
                                 max_restarts=4))
        out["fleet_boot_seconds"] = time.perf_counter() - t0
        out["gpu_memory_two_replicas"] = gpu_memory()
        boots = [h.boot for h in router.replicas]
        fi.inject("fleet.apply.r1", skip=FLEET_KILL_SKIP)
        reqs, wall = serve_requests(router, prompts, budgets,
                                    timeout=timeout)
        got = [list(r["out"]) for r in reqs]
        out["gpu_memory_after_traffic"] = gpu_memory()
        evs = flight.events(category="fleet")
        dead = [e for e in evs if e["name"] == "replica_dead"]
        t_end = time.monotonic() + timeout
        while router.stats()["live"] < 2 and time.monotonic() < t_end:
            time.sleep(0.05)
        evs = flight.events(category="fleet")
        back = [e for e in evs if e["name"] == "resurrected"]
        reborn = router.replicas[1]
        boots.append(reborn.boot)
        cli = ReplicaClient(reborn.host, reborn.port)
        try:
            t0 = time.perf_counter()
            extra = cli.generate(prompts[1], budgets[1], timeout=timeout)
            extra_s = time.perf_counter() - t0
        finally:
            cli.close()
        k3s = [h.call({"op": "stats"})["k3"] for h in router.replicas]
        stats = router.stats()
        terminal = {r["trace_id"]: sum(
            1 for e in evs if e.get("trace_id") == r["trace_id"]
            and e["name"] in FLEET_TERMINAL) for r in reqs}
        resume = [r["t_resume"] - r["t_failover"] for r in reqs
                  if "t_resume" in r]
        numbers = serve_numbers(reqs, wall)
        t0 = time.perf_counter()
        router.shutdown(drain=False, timeout=120)
        out["shutdown_seconds"] = time.perf_counter() - t0
        procs = [h.proc for h in router.replicas]
        router = None
    finally:
        fi.clear()
        if router is not None:
            router.shutdown(drain=False, timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    out.update({
        "warm_boots": boots,
        "warm_boot_seconds": [b.get("seconds") for b in boots],
        "kill_to_resurrected_seconds": (back[-1]["ts_us"]
                                        - dead[0]["ts_us"]) / 1e6
        if dead and back else None,
        "kill_to_next_token_seconds": resume,
        "router": stats, "replica_k3": k3s,
        "extra_request_seconds": extra_s,
        **numbers,
        "serve": state.get("serve_summary")})
    # the streams against the oracle: equal, or parted at near-ties of
    # logits this process computes from the same seeded weights
    model = fleet_parent_model(spec, device)
    parted = streams_against(model, prompts, oracle, got, 2048)
    parted_extra = streams_against(model, [prompts[1]], [oracle[1]],
                                   [extra], 2048)
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    out["streams_equal_oracle"] = len(prompts) - len(parted)
    out["streams_parted_at_near_ties"] = parted
    out["extra_request_equals_oracle"] = extra == oracle[1]
    k3["decode_bf16"]["fleet_launches"] = sum(
        k["split_launches"] - k["mma_launches"] for k in k3s)
    k3["prefill_chunk"]["fleet_launches"] = sum(k["mma_launches"]
                                                for k in k3s)
    kernel = device == "cuda"
    checks = {
        "cold boot: misses = kernel sources = writes":
            (out["cold_boot"]["cache"]["misses"],
             out["cold_boot"]["cache"]["writes"]) == (n_src, n_src),
        "warm boots: misses 0, programs > 0, failures 0": all(
            b["cache"]["misses"] == 0 and b["prewarm"]["programs"] > 0
            and b["prewarm"]["failures"] == 0 for b in boots),
        "every request finished without error": all(
            r["error"] is None for r in reqs),
        "exact budgets": all(len(g) == b for g, b in zip(got, budgets)),
        "one terminal fleet event a request":
            set(terminal.values()) == {1},
        "a failover": stats["failovers"] >= 1 and len(dead) >= 1
        and dead[0]["attrs"]["replica"] == 1,
        "replica 1 back": stats["live"] == 2 and reborn.restarts >= 1,
        "streams equal or parted at near-ties":
            all(p["ok"] for p in parted),
        "replica 1's extra request equals its oracle stream":
            extra == oracle[1],
        "K3 in every replica: launches = split = layers x engine calls":
            not kernel or all(k["launches"] == k["split_launches"]
                              == k["layers"] * k["engine_calls"] > 0
                              for k in k3s),
        "replicas exited": all(p.poll() is not None for p in procs),
    }
    out["parted_extra"] = parted_extra
    out["failed_gates"] = [k for k, ok in checks.items() if not ok]
    if out["failed_gates"]:
        emit({"phase": "fleet", "failed": out})
        raise AssertionError("fleet: " + "; ".join(out["failed_gates"]))
    return out


def http_post_npz(port, path, timeout=600, **arrays):
    import http.client
    import io
    import numpy as np
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=buf.getvalue())
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"POST {path}: {resp.status} {body[:500]!r}")
    return dict(np.load(io.BytesIO(body)))


def phase_serve_http(device="cuda", widths=None, layers=2):
    """THE INFERENCE FRONT END: save_inference_model stores a 2-layer
    model at the 7B widths; inference.serve(generate=True, fleet=2)
    serves it over HTTP from two replica processes; four concurrent
    POST /generate calls against this process's engine over the same
    weights, one POST /run against Predictor.run; then the server and
    its replicas stop."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import PagedLlamaDecodeEngine
    spec = fleet_model_spec(layers, widths)
    spec["config"]["use_flash_attention"] = device == "cuda"
    model = fleet_parent_model(spec, device)
    V = spec["config"]["vocab_size"]
    rng = np.random.default_rng(SEED + 13)
    prompts = [[int(t) for t in rng.integers(0, V, n)]
               for n in (100, 37, 200, 64)]
    budget = 16
    root = tempfile.mkdtemp(prefix="serve-http-")
    path = os.path.join(root, "llama")
    out = {"card": nvidia_smi_line(), "layers": layers, "dtype": "bfloat16"}
    server = None
    try:
        t0 = time.perf_counter()
        inference.save_inference_model(path, model)
        out["save_seconds"] = time.perf_counter() - t0
        out["pdmodel_bytes"] = os.path.getsize(path + ".pdmodel")
        eng = PagedLlamaDecodeEngine(model, max_slots=4, max_seq=512,
                                     device=device)
        want = [eng.generate(np.asarray(p), budget) for p in prompts]
        del eng
        t0 = time.perf_counter()
        server = inference.serve(path, port=0, generate=True, fleet=2,
                                 block=False, max_seq=512, device=device)
        out["serve_up_seconds"] = time.perf_counter() - t0
        port = server.server_address[1]
        got = [None] * len(prompts)
        errors = []

        def post(i):
            try:
                got[i] = [int(t) for t in http_post_npz(
                    port, "/generate", input_ids=np.asarray(prompts[i]),
                    max_new_tokens=np.asarray(budget))["output_ids"]]
            except Exception as e:  # noqa: BLE001 — gated below
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        out["generate_seconds"] = time.perf_counter() - t0
        ids = rng.integers(0, V, (1, 32)).astype(np.int32)
        run = http_post_npz(port, "/run", input_0=ids)["output_0"]
        ref = inference.Predictor(inference.Config(path),
                                  device=device).run(ids)[0]
        procs = [h.proc for h in server.fleet_router.replicas]
        t0 = time.perf_counter()
        server.shutdown(timeout=120)
        out["stop_seconds"] = time.perf_counter() - t0
        server = None
    finally:
        if server is not None:
            server.shutdown(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    parted = streams_against(model, prompts, want,
                             [g or [] for g in got], 512)
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    out.update({"errors": errors, "streams_equal": len(prompts)
                - len(parted), "streams_parted_at_near_ties": parted,
                "run_shape": list(run.shape),
                "run_max_abs_diff": float(np.abs(run - ref).max())})
    checks = {
        "no request failed": not errors,
        "/generate equal or parted at near-ties":
            all(p["ok"] for p in parted),
        "/run equals Predictor.run": run.shape == ref.shape
        and bool(np.array_equal(run, ref)),
        "replicas exited": all(p.poll() is not None for p in procs),
    }
    out["failed_gates"] = [k for k, ok in checks.items() if not ok]
    if out["failed_gates"]:
        emit({"phase": "serve_http", "failed": out})
        raise AssertionError("serve_http: " + "; ".join(out["failed_gates"]))
    return out


# ---------------------------------------------------------------------------
# flash attention: parity and time
# ---------------------------------------------------------------------------

def flash_inputs(shape, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(4)]


# ERNIE-MoE's attention (ErnieMoEConfig(): 12 heads of 64, causal) at
# moe_train's batch
MOE_SHAPE = (8, 2048, 12, 64)


def flash_cases():
    """(name, shape, causal): the training geometry causal and full, D 64
    through the [BH, L, D] strides, a ragged L, L = 1, q, k, v as strided
    views of one [B, L, 3, H, D] projection, and ERNIE-MoE's attention as
    GPTAttention builds it (views of one [B, L, 3 x 768] projection)."""
    return [("train", (4, 2048, 32, 128), True),
            ("train_full", (4, 2048, 32, 128), False),
            ("bhld_d64", (48, 512, 64), False),
            ("ragged_l1000", (2, 1000, 8, 128), True),
            ("l1", (4, 1, 32, 128), True),
            ("strided_qkv", (2, 1024, 16, 128), True),
            ("moe_gpt_qkv", MOE_SHAPE, True)]


def flash_case_inputs(case, shape, dtype, seed):
    """q, k, v, do of one flash_parity case; ``strided_qkv`` takes q, k, v
    as the views of one [B, L, 3, H, D] projection, ``moe_gpt_qkv`` as
    GPTAttention's views of one [B, L, 3 H D] projection (row stride
    3 H D, k and v H D and 2 H D elements in)."""
    if case not in ("strided_qkv", "moe_gpt_qkv"):
        return flash_inputs(shape, dtype, seed)
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, L, H, D = shape
    if case == "strided_qkv":
        qkv = torch.randn((B, L, 3, H, D), generator=g,
                          device="cuda").to(dtype).unbind(2)
    else:
        qkv = [x.view(B, L, H, D) for x in torch.randn(
            (B, L, 3 * H * D), generator=g, device="cuda").to(dtype).split(
                H * D, dim=-1)]
    do = torch.randn(shape, generator=g, device="cuda").to(dtype)
    return [*qkv, do]


def flash_tma_expected(dtype, shape, dropout=False, seg=False):
    """Whether the TMA / wgmma design should take a call: bf16 at head
    dim 64 or 128, with dropout at 64 only, with segments without dropout
    (the inputs are fresh tensors or views with 16-byte rows)."""
    import torch
    return dtype == torch.bfloat16 and shape[-1] in (64, 128) and \
        (not dropout or shape[-1] == 64) and not (dropout and seg)


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


def parity_row(row, got, ref, ref32, dname,
               names=("out", "lse", "dq", "dk", "dv")):
    """Each output (``names``): elementwise against the plain version in
    the working dtype, RMS against the plain version on f32 copies
    (FLASH_TOL, FLASH_RMS). Fills ``row``; returns whether all passed."""
    tol, rms_r = FLASH_TOL[dname], FLASH_RMS[dname]
    row.update(tol=tol, rms_tol=rms_r)
    ok = True
    for n, g_, r, r32 in zip(names, got, ref, ref32, strict=True):
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
            if case == "moe_gpt_qkv" and dtype == torch.bfloat16:
                record_errors(results, "_d64", row)
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
    finish_parity("flash_parity", results, ("", "_d64"), failed)
    return {"cases": rows, "autograd": auto}


def record_errors(results, suffix, row):
    """The worst max abs error of each kernel's outputs into its entry
    of the kernels line."""
    for kname, outs in (("flash_attention_fwd", ("out", "lse")),
                        ("flash_attention_bwd_dq", ("dq",)),
                        ("flash_attention_bwd_dkv", ("dk", "dv"))):
        results[kname + suffix]["max_abs_err"] = max(
            row[m]["max_abs_err"] for m in outs)


def finish_parity(phase, results, suffixes, failed):
    for suffix in suffixes:
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


def flash_general(q, k, v, do, lse, delta, causal, dropout_p=0.0,
                  seed=None, seg=None):
    """The first design's kernels (mma.sync, flash_attention.cuh) on bf16
    inputs that the wrappers send to the TMA design: called through the
    first design's C entries (with the same dropout or segments), so one
    run times both designs on one card. Each call returns its outputs:
    (out, lse), dq, (dk, dv)."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, L, H, D = fa._as4(q).shape
    lib = fa._kernel_lib(q.dtype, D)
    thresh, inv = fa._dropout_args(dropout_p, seed)
    lo, hi = fa._seed_words(seed) if thresh else (0, 0)
    rng = fa._seg_ranges(seg) if seg is not None else None
    segs = (seg.data_ptr(), seg.stride(0), rng.data_ptr()) \
        if seg is not None else (None, 0, None)

    def tail():  # sizes, causal, scale, bf16, the segments, the dropout
        return (B, L, H, D, int(causal), 1.0 / math.sqrt(D), 1, *segs,
                lo, hi, thresh, inv, torch.cuda.current_stream().cuda_stream)

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
        return out, fa._lse_shape(q, ls)

    def dq():
        g = torch.empty_like(q)
        check(lib.flash_attention_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), g.data_ptr(),
            fa._strides(q, k, v, do, g), *tail()), "dQ")
        return g

    def dkv():
        gk, gv = torch.empty_like(k), torch.empty_like(v)
        check(lib.flash_attention_backward_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), gk.data_ptr(), gv.data_ptr(),
            fa._strides(q, k, v, do, gk, gv), *tail()), "dK/dV")
        return gk, gv

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
    on the same inputs. Segmented rows also give wrapper_host_us_ids, the
    host cost of the same launch given the ids instead of their plan."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    kw, lib_kw = kw or {}, lib_kw or {"is_causal": causal}
    q, k, v, do = flash_inputs(shape, torch.bfloat16, seed=1)
    plain_kw, seg = kw, kw.get("seg")
    if seg is not None:
        # the kernels reuse one plan (chunk ranges, windows), as a step does
        kw = dict(kw, seg=fa.SegmentPlan(seg))
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
    first = flash_general(q, k, v, do, lse, delta, causal,
                          kw.get("dropout_p", 0.0), kw.get("seed"),
                          seg) if tma else {}
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

    # the segmented launches given the ids alone, so that each builds its
    # chunk ranges and window anew: what the plan saves the host a call
    ids_calls = {} if seg is None else {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, causal, None, **plain_kw),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal, None, **plain_kw),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal, None, **plain_kw)}
    rows = {
        # name: (kernel, plain, library, products, [B, L, H, D] tensors
        # read or written, f32 [B, H, L] arrays read or written)
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal, None, **kw),
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal, None,
                                                     **plain_kw),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw),
            2, 4, 1),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              causal, None, **kw),
            lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, do, lse, delta, causal, None, **plain_kw),
            None, 3, 5, 2),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               causal, None, **kw),
            lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, causal, None, **plain_kw),
            None, 4, 6, 2),
        "backward_with_delta": (
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                           None, **kw),
            lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                     causal, None,
                                                     **plain_kw),
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
             "wrapper_host_us": host_us(kern),
             "wrapper_host_us_ids": host_us(ids_calls[name])
             if name in ids_calls else None,
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


def fill_times(results, suffix, table):
    """The kernels line's times of one geometry's table."""
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        results[name + suffix].update({key: table[name][key] for key in (
            "design", "kernel_ms", "general_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")})
        results[name + suffix]["ms"] = table[name]["kernel_ms"]


def phase_flash_time(results):
    train = flash_timings((4, 2048, 32, 128), True)
    fill_times(results, "", train)
    # ERNIE-MoE's attention (causal, D 64), which moe_train launches
    moe = flash_timings(MOE_SHAPE, True)
    fill_times(results, "_d64", moe)
    return {"train": {"shape": [4, 2048, 32, 128], "layout": "B L H D",
                      "causal": True, "dtype": "bfloat16", "times": train},
            "moe": {"shape": list(MOE_SHAPE), "layout": "B L H D",
                    "causal": True, "dtype": "bfloat16", "times": moe},
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
    CUDA activity only; "optimizer" is the fused step's multi_tensor
    kernels) beside its wall time."""
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
              "gemm": 0.0, "optimizer": 0.0, "other": 0.0}
    for key, us in by_kernel.items():
        kl = key.lower()
        if "multi_tensor" in kl:
            groups["optimizer"] += us
        elif "flash_fwd" in kl:
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
    reset_optimizer_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN["steps"]):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [kern.launches for kern in kernels]   # ... and are read here
    tma = [kern.tma_launches for kern in kernels]
    opt_counts = check_optimizer_launches("train", opt, TRAIN["steps"],
                                          False)
    results["multi_tensor_adam"]["launches"] = opt_counts["o2"]
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
    both = optimizer_both_ways(step, (ids, ids))
    prof = both["fused"]
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
           "optimizer_launches": opt_counts,
           "peak_mem_gb": peak / 2 ** 30, "profile_one_step": prof,
           "profile_one_step_loop": both["loop"]}
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
        tma = flash_tma_expected(dtype, shape, dropout=True)
        row = {"case": case, "shape": list(shape), "causal": causal,
               "dtype": dname, "dropout_p": p,
               "design": "tma_wgmma" if tma else "general_mma_sync",
               "launches_and_tma_launches": paths}
        # one launch each, through the design expected (bf16 at D 64: the
        # TMA kernels; f32: the first design)
        ok = parity_row(row, got, ref, ref32, dname) and \
            paths == [(1, int(tma))] * 3
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
    exact = keep_mask_exact(p)
    if not exact["ok"]:
        failed.append({"keep_mask_exact": exact})
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
    finish_parity("flash_dropout_parity", results, ("_dropout",), failed)
    return {"cases": rows, "keep_rate": keep_row, "keep_mask_exact": exact,
            "autograd": auto}


def keep_mask_exact(p):
    """The TMA kernels' keep mask against flash_dropout_keep_mask, bit for
    bit: at L = 64 = D with q = k = 0 (uniform P) and v = I, out·L·(1 − p)
    is the forward's mask; with dO = I, dVᵀ·L·(1 − p) is the backward's
    (bf16 holds 1/(L(1 − p)) to within 0.3 %, so rounding recovers each
    bit). Then p = 0 against the launch without dropout."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, L, H = 3, 64, 4
    zeros = torch.zeros((B, L, H, 64), dtype=torch.bfloat16, device="cuda")
    eye = torch.eye(L, dtype=torch.bfloat16, device="cuda")
    ident = eye[None, :, None, :].expand(B, L, H, L).contiguous()
    keep = fa.flash_dropout_keep_mask(DROP_SEED, B, H, L, p, "cuda").float()
    before = flash_counts()
    out, lse = fa.flash_attention_fwd(zeros, zeros, ident, False, None, p,
                                      DROP_SEED)
    delta = fa.attention_delta(out, ident)
    _, dv = fa.flash_attention_bwd_dkv(zeros, zeros, ident, ident, lse,
                                       delta, False, None, p, DROP_SEED)
    torch.cuda.synchronize()
    paths = flash_paths(before)
    fwd = (out.float() * L * (1 - p)).round().permute(0, 2, 1, 3)
    bwd = (dv.float() * L * (1 - p)).round().permute(0, 2, 3, 1)
    plain = fa.flash_attention_fwd(zeros, zeros, ident)
    zero_p = fa.flash_attention_fwd(zeros, zeros, ident, False, None, 0.0,
                                    DROP_SEED)
    row = {"shape": [B, L, H, 64], "dropout_p": p,
           "launches_and_tma_launches": paths,
           "forward_bits_differ": int((fwd != keep).sum()),
           "backward_bits_differ": int((bwd != keep).sum()),
           "kept": int(keep.sum()), "pairs": keep.numel(),
           "p0_bit_equal": all(torch.equal(a, b)
                               for a, b in zip(plain, zero_p))}
    row["ok"] = (paths == [(1, 1), (0, 0), (1, 1)]
                 and row["forward_bits_differ"] == 0
                 and row["backward_bits_differ"] == 0
                 and row["p0_bit_equal"])
    return row


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


def seg_d128_ids():
    """SEG_D128's ids: each row's segments of equal length, in order."""
    import torch
    B, L = SEG_D128["shape"][:2]
    n = L // SEG_D128["segments"]
    return torch.arange(SEG_D128["segments"], dtype=torch.int32,
                        device="cuda").repeat_interleave(n)[None] \
        .repeat(B, 1).contiguous()


def block_diagonal_mask(ids):
    """The additive mask [B, 1, L, L] of the pairs ``ids`` [B, L] allow."""
    import torch
    return torch.where(ids[:, :, None] == ids[:, None, :], 0.0,
                       -1e30)[:, None]


def segmented_parity(shape, ids, causal, dtype, seed, info):
    """One segmented case: the kernels (one launch each, on the design
    flash_tma_expected names) and, where that is the TMA design, the
    first design forced on the same inputs, each held against the plain
    versions in the working dtype and on f32 copies. -> (rows, inputs)."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    dname = str(dtype).replace("torch.", "")
    q, k, v, do = flash_inputs(shape, dtype, seed=seed)
    ref = plain_all(q, k, v, do, causal, seg=ids)
    delta = fa.attention_delta(ref[0], do)
    before = flash_counts()
    got = kernels_all(q, k, v, do, causal, ref[1], delta, seg=ids)
    torch.cuda.synchronize()
    paths = flash_paths(before)
    ref32 = plain_all(*(x.float() for x in (q, k, v, do)), causal, seg=ids)
    tma = flash_tma_expected(dtype, shape, seg=True)
    row = {"shape": list(shape), **info, "causal": causal, "dtype": dname,
           "design": "tma_wgmma" if tma else "general_mma_sync",
           "launches_and_tma_launches": paths}
    # bf16 takes the TMA design, f32 the first, one launch each
    row["ok"] = parity_row(row, got, ref, ref32, dname) and \
        paths == [(1, int(tma))] * 3
    rows = [row]
    if tma:
        # the first design forced on the same inputs, held against the
        # same plain versions
        first = flash_general(q, k, v, do, ref[1], delta, causal, seg=ids)
        got1 = (*first["flash_attention_fwd"](),
                first["flash_attention_bwd_dq"](),
                *first["flash_attention_bwd_dkv"]())
        torch.cuda.synchronize()
        row1 = {"shape": list(shape), **info, "causal": causal,
                "dtype": dname, "design": "general_mma_sync", "forced": True}
        parity_row(row1, got1, ref, ref32, dname)
        rows.append(row1)
        del got1
    del ref, ref32, got
    torch.cuda.empty_cache()
    return rows, (q, k, v, do)


def varlen_entry(results, suffix, lens, H, D, causal):
    """The packed entry as a user calls it: forward and backward of one
    [total, 3, H, D] batch of sequences of ``lens``, its counts set to 0
    just before and read just after; its output and gradient held against
    the plain versions on the same views and ids, in bf16 and on f32
    copies (FLASH_TOL, FLASH_RMS)."""
    import torch
    from paddle_tpu_torch.nn.functional import flash_attn_varlen_qkvpacked
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    T = sum(lens)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn((T, 3, H, D), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    dout = torch.randn((T, H, D), generator=g, device="cuda").to(
        torch.bfloat16)
    cu = torch.tensor([0] + lens, device="cuda").cumsum(0).to(torch.int32)
    wrappers = flash_wrappers()
    for w in wrappers:                        # the counts start here ...
        w.launches = w.dropout_launches = w.segmented_launches = 0
        w.tma_launches = 0
    out, _ = flash_attn_varlen_qkvpacked(qkv, cu, cu, max(lens), max(lens),
                                         None, causal=causal)
    out.backward(dout)
    torch.cuda.synchronize()
    launches = [w.segmented_launches for w in wrappers]   # ... read here
    tma = [w.tma_launches for w in wrappers]
    seg = varlen_seg(lens)
    views = [x.detach()[None] for x in qkv.unbind(1)]     # [1, T, H, D]

    def plain(q, k, v, do):
        o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, None,
                                                  seg=seg)
        return (o, *fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                     causal, None, seg=seg))

    ref = plain(*views, dout[None])
    ref32 = plain(*(x.float() for x in (*views, dout[None])))
    got = (out.detach()[None], *(x[None] for x in qkv.grad.unbind(1)))
    row = {"qkv": [T, 3, H, D], "sequences": len(lens), "causal": causal,
           "segmented_launches": launches, "tma_launches": tma}
    ok = parity_row(row, got, ref, ref32, "bfloat16",
                    names=("out", "dq", "dk", "dv"))
    del ref, ref32, got, views, qkv, out
    torch.cuda.empty_cache()
    if launches != [1, 1, 1] or tma != [1, 1, 1] or not ok:
        raise AssertionError(f"varlen entry {row}: want one segmented TMA "
                             f"launch a wrapper (bf16 segments take the TMA "
                             f"design) and outputs within the limits")
    for name, n, m in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"), launches, tma):
        results[name + suffix]["launches"] = n
        results[name + suffix]["tma_launches"] = m
    return row


def phase_flash_varlen_parity(results):
    import torch
    from paddle_tpu_torch.nn.functional import sdpa_reference
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    lens = varlen_lengths()
    seg = varlen_seg(lens)
    T, H, D = VARLEN["total"], VARLEN["heads"], VARLEN["head_dim"]
    # the same ids shuffled: the TMA kernels' windows are then supersets
    # and every tile in them is masked element by element
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shuffled = seg[:, torch.randperm(seg.shape[1], generator=g,
                                     device="cuda")].contiguous()
    seg2 = seg_d128_ids()
    d64 = {"sequences": len(lens)}
    d128 = {"segments": SEG_D128["segments"]}
    # (suffix, shape, ids, row info, causal, seed): D 64 at the packed
    # geometry, sorted causal and full and shuffled; D 128 at the op
    # bench's geometry, causal and full
    cases = [("_segmented", (1, T, H, D), seg, {**d64, "ids": "sorted"},
              False, 300),
             ("_segmented", (1, T, H, D), seg, {**d64, "ids": "sorted"},
              True, 301),
             ("_segmented", (1, T, H, D), shuffled,
              {**d64, "ids": "shuffled"}, False, 304),
             ("_segmented_d128", SEG_D128["shape"], seg2,
              {**d128, "ids": "sorted"}, True, 311),
             ("_segmented_d128", SEG_D128["shape"], seg2,
              {**d128, "ids": "sorted"}, False, 310)]
    rows, auto, failed = [], [], []
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        dname = str(dtype).replace("torch.", "")
        for suffix, shape, ids, info, causal, seed in cases:
            sorted_ids = info["ids"] == "sorted"
            if dtype == torch.float32 and not sorted_ids:
                continue
            case_rows, (q, k, v, do) = segmented_parity(
                shape, ids, causal, dtype, seed + 2 * i, info)
            rows += case_rows
            failed += [r for r in case_rows if not r["ok"]]
            # the kernels line's errors: D 64 from the full case, D 128
            # from the op bench's causal one
            if dtype == torch.bfloat16 and sorted_ids and \
                    causal == (suffix == "_segmented_d128"):
                record_errors(results, suffix, case_rows[0])
            if sorted_ids:
                tma = flash_tma_expected(dtype, shape, seg=True)
                mask = block_diagonal_mask(ids)
                before = flash_counts()
                auto.append(autograd_row(
                    q, k, v, do,
                    lambda a, b, c: fa.flash_attention_segmented(
                        a, b, c, ids, causal),
                    lambda a, b, c: sdpa_reference(a, b, c, causal=causal,
                                                   mask=mask), dname))
                paths = flash_paths(before)
                auto[-1].update(causal=causal,
                                launches_and_tma_launches=paths)
                auto[-1]["ok"] &= paths == [(1, int(tma))] * 3
                if not auto[-1]["ok"]:
                    failed.append({"autograd": auto[-1]})
                del mask
            del q, k, v, do
            torch.cuda.empty_cache()
    finish_parity("flash_varlen_parity", results,
                  ("_segmented", "_segmented_d128"), failed)
    B2, L2 = SEG_D128["shape"][:2]
    entry = [varlen_entry(results, "_segmented", lens, H, D, False),
             # D 128: the op bench's rows packed one after the other
             varlen_entry(results, "_segmented_d128",
                          [L2 // SEG_D128["segments"]]
                          * (B2 * SEG_D128["segments"]),
                          *SEG_D128["shape"][2:], True)]
    return {"sequences": len(lens), "lengths": lens, "cases": rows,
            "autograd_vs_block_diagonal_sdpa": auto, "entry": entry}


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
    # D 128 at the op bench's geometry (causal, 4 equal segments): the
    # pairs a head needs are the causal halves of each segment, B x the
    # sum of n (n + 1) / 2
    L2 = SEG_D128["shape"][1]
    n2 = L2 // SEG_D128["segments"]
    seg2 = seg_d128_ids()
    same2 = seg2[:, :, None] == seg2[:, None, :]
    causal2 = torch.ones(L2, L2, dtype=torch.bool, device="cuda").tril()
    seg128 = flash_timings(SEG_D128["shape"], True, kw=dict(seg=seg2),
                           pairs=SEG_D128["segments"] * n2 * (n2 + 1) // 2,
                           lib_kw={"attn_mask": (same2 & causal2)[:, None]},
                           extra_bytes=seg2.numel() * 4)
    del same2, causal2
    torch.cuda.empty_cache()
    for suffix, table in (("_dropout", drop), ("_segmented", seg_t),
                          ("_segmented_d128", seg128)):
        fill_times(results, suffix, table)
    # what the keep mask costs each design: the same call with dropout
    # minus without
    overhead = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        a, b = drop[name], no_drop[name]
        overhead[name] = {
            "tma_ms": a["kernel_ms"] - b["kernel_ms"],
            "tma_share": a["kernel_ms"] / b["kernel_ms"] - 1,
            "general_ms": a["general_ms"] - b["general_ms"],
            "general_share": a["general_ms"] / b["general_ms"] - 1}
    return {"dropout_overhead": overhead,
            "no_dropout": {"shape": list(BERT_SHAPE), "layout": "B L H D",
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
            "segmented_d128": {"shape": list(SEG_D128["shape"]),
                               "segments": SEG_D128["segments"],
                               "causal": True, "dtype": "bfloat16",
                               "source": "bench_ops.py:161-174",
                               "pairs": SEG_D128["segments"] * n2 *
                               (n2 + 1) // 2, "times": seg128},
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
    reset_optimizer_counts()
    t0 = time.perf_counter()
    for _ in range(BERT["steps"]):
        losses.append(step(ids, ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [w.launches for w in wrappers]        # ... and are read here
    dropped = [w.dropout_launches for w in wrappers]
    tma = [w.tma_launches for w in wrappers]
    opt_counts = check_optimizer_launches("bert_train", opt, BERT["steps"],
                                          False)
    expected = BERT["layers"] * BERT["steps"]
    if launches != [expected] * 3 or dropped != [expected] * 3 \
            or tma != [expected] * 3:
        raise AssertionError(
            f"flash launches (fwd, dq, dkv) {launches}, with dropout "
            f"{dropped}, through the TMA design {tma}: each should be "
            f"layers x timed steps = {BERT['layers']} x {BERT['steps']}")
    for name, n, nt in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv"), dropped, tma):
        results[name + "_dropout"]["launches"] = n
        results[name + "_dropout"]["tma_launches"] = nt
    loss_values = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_values):
        raise AssertionError(f"non-finite loss: {loss_values}")
    if not loss_values[-1] < loss_values[0]:
        raise AssertionError(f"the loss did not fall: {loss_values}")
    peak = torch.cuda.max_memory_allocated()
    tokens = BERT["batch"] * BERT["seq"]
    tok_s = tokens * BERT["steps"] / wall
    mfu = 6 * n_params * tok_s / BF16_FLOPS      # as bench.py:848 counts
    both = optimizer_both_ways(step, (ids, ids))
    prof = both["fused"]
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
           "flash_tma_launches": dict(zip(("fwd", "dq", "dkv"), tma)),
           "optimizer_launches": opt_counts,
           "peak_mem_gb": peak / 2 ** 30, "profile_one_step": prof,
           "profile_one_step_loop": both["loop"]}
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
    reset_optimizer_counts()
    t0 = time.perf_counter()
    drops = []
    for _ in range(MOE["steps"]):
        losses.append(step(ids, ids))
        drops.append([m.drop_share for m in model.moe_layers()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [kern.launches for kern in kernels]   # ... and are read here
    tma = [kern.tma_launches for kern in kernels]
    opt_counts = check_optimizer_launches("moe_train", opt, MOE["steps"],
                                          False)
    expected = cfg.num_hidden_layers * MOE["steps"]
    if launches != [expected] * 3 or tma != [expected] * 3:
        raise AssertionError(
            f"flash launches (fwd, dq, dkv) {launches}, through the TMA "
            f"design {tma}: each should be layers x timed steps = "
            f"{cfg.num_hidden_layers} x {MOE['steps']}")
    for kname, n, nt in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv"), launches, tma):
        results[kname + "_d64"]["launches"] = n
        results[kname + "_d64"]["tma_launches"] = nt
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
    both = optimizer_both_ways(step, (ids, ids))
    prof = both["fused"]
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
           "flash_tma_launches": dict(zip(("fwd", "dq", "dkv"), tma)),
           "optimizer_launches": opt_counts,
           "peak_mem_gb": peak / 2 ** 30, "profile_one_step": prof,
           "profile_one_step_loop": both["loop"],
           # the profiled step's own wall carries the profiler's cost:
           # the idle share against the timed steps' mean
           "device_idle_share_of_timed_step":
               1 - prof["device_ms"] / (wall / MOE["steps"] * 1e3)
               if prof["device_ms"] else None}
    del step, opt, model
    torch.cuda.empty_cache()
    return out


class PinnedRouting:
    """Stands in for ``moe_dispatch.capacity_dispatch_indices`` while
    installed: the first run through it records its routing tables, a
    replay hands them to the second run. The replayed gate weights and
    aux loss come from the second run's own logits (its gate keeps its
    gradient); only which experts and slots each token takes is the
    first run's. So two runs that differ only in their attention kernels
    compare those kernels alone."""

    def __init__(self):
        from paddle_tpu_torch.incubate import moe_dispatch
        self.module = moe_dispatch
        self.original = moe_dispatch.capacity_dispatch_indices
        self.tables, self.replay, self.at = [], False, 0

    def __call__(self, gate_logits, top_k, capacity):
        import torch
        if not self.replay:
            out = self.original(gate_logits, top_k, capacity)
            self.tables.append(out)
            return out
        token_idx, slot_used, expert_k, slot_k, weight_k, _ = \
            self.tables[self.at]
        self.at += 1
        probs = torch.softmax(gate_logits.float(), dim=-1)
        e = probs.shape[1]
        weight = torch.where(weight_k > 0,
                             probs.gather(1, expert_k.long()), 0.0)
        ce = torch.nn.functional.one_hot(expert_k[:, 0].long(),
                                         e).float().mean(dim=0)
        aux = e * (probs.mean(dim=0) * ce).sum()
        return token_idx, slot_used, expert_k, slot_k, weight, aux

    def __enter__(self):
        self.module.capacity_dispatch_indices = self
        return self

    def __exit__(self, *exc):
        self.module.capacity_dispatch_indices = self.original


def moe_parity_runs(model, ids, pin=None):
    """One forward + backward through the kernels, then one through the
    plain sdpa: (loss, each token's sorted top-2 experts by the f32 gate,
    gradients) of each. With ``pin`` the second run replays the first's
    routing."""
    loss_fn = moe_loss(model)
    moe = model.moe_layers()[0]
    runs = []
    for flash in (True, False):
        for blk in model.blocks:
            blk.attn.use_flash = flash
        if pin is not None:
            pin.replay = not flash
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
    return runs


def moe_compare(runs):
    """Loss and gradient differences of two moe_parity_runs."""
    (lk, rk, gk), (lr_, rr, gr) = runs
    flipped = int((rk != rr).any(dim=-1).sum())
    worst, rows = 0.0, {}
    for name, a in gk.items():
        b = gr[name].float()
        rel = float((a.float() - b).square().mean().sqrt()
                    / b.square().mean().sqrt().clamp(min=1e-30))
        rows[name] = rel
        worst = max(worst, rel)
    return {"loss_kernels": lk, "loss_reference": lr_,
            "loss_rel_err": abs(lk - lr_) / abs(lr_),
            "loss_rtol": MOE_LOSS_RTOL, "grad_rel_rms_worst": worst,
            "grad_rel_rms_tol": MOE_GRAD_RMS, "grad_rel_rms": rows,
            "tokens": rk.shape[0], "tokens_top2_differ": flipped,
            "top2_differ_share": flipped / rk.shape[0]}


def phase_moe_train_parity():
    import torch
    model = moe_model(layers=2)
    ids = moe_ids(model.config.vocab_size)
    out = {"layers": 2, "moe_layers": 1,
           **moe_compare(moe_parity_runs(model, ids))}
    out["top2_differ_tol"] = MOE_ROUTE_FLIP_SHARE
    ok = out["loss_rel_err"] <= MOE_LOSS_RTOL and \
        out["grad_rel_rms_worst"] <= MOE_GRAD_RMS and \
        out["top2_differ_share"] <= MOE_ROUTE_FLIP_SHARE
    # beside the gate: the same two runs with the plain run replaying the
    # kernel run's routing, so a flipped near-tie in the router cannot
    # move the comparison; held to the same limits
    with PinnedRouting() as pin:
        pinned = moe_compare(moe_parity_runs(model, ids, pin))
    pinned["ok"] = pinned["loss_rel_err"] <= MOE_LOSS_RTOL and \
        pinned["grad_rel_rms_worst"] <= MOE_GRAD_RMS and pin.at == 1
    out["pinned_routing"] = pinned
    out["ok"] = ok = ok and pinned["ok"]
    del model
    torch.cuda.empty_cache()
    if not ok:
        emit({"phase": "moe_train_parity", "failed": out})
        raise AssertionError("the ERNIE-MoE step through the kernels "
                             "disagrees with the step through the plain "
                             "sdpa")
    return out


# ---------------------------------------------------------------------------
# the optimizer step: O1 (unscale, finite check, norms) and O2 (Adam/AdamW)
# ---------------------------------------------------------------------------

# O1's clip scale and sums of squares vs the plain version's: the same f32
# squares added in another order (chunks, then tensors, on the card)
OPT_NORM_RTOL = 1e-6
OPT_LOSS_SCALE = 2.0 ** 15
OPT_MIXED = [(1000, 4096), (4096,), (1,), (37,), (129, 65), (3, 5, 7)]
OPT_MISALIGNED = 1001        # a view one element past its buffer's start
# (name, decoupled, param dtype, f32 moments, decay exemption, clip spec,
#  mode, planted inf, prior found flag, tensors)
OPT_CASES = (
    ("adamw_bf16_plain", True, "bfloat16", False, 3, (), "plain", False,
     None, "mixed"),
    ("adamw_bf16_f32m_global", True, "bfloat16", True, 3,
     ("global_norm", 1.0), "plain", False, None, "mixed"),
    ("adam_f32_norm", False, "float32", True, 0, ("norm", 0.5), "plain",
     False, None, "mixed"),
    ("adamw_bf16_value_found0", True, "bfloat16", False, 2,
     ("value", -0.3, 0.3), "found", False, False, "mixed"),
    ("adam_bf16_f32m_scaled_global", False, "bfloat16", True, 0,
     ("global_norm", 1.0), "scaled", False, None, "mixed"),
    ("adamw_f32_scaled_inf", True, "float32", True, 3, ("global_norm", 1.0),
     "scaled", True, None, "mixed"),
    ("adamw_bf16_found1_norm", True, "bfloat16", False, 0, ("norm", 0.5),
     "found", False, True, "mixed"),
    ("adam_f32_value_scaled_prior", False, "float32", True, 0,
     ("value", -0.3, 0.3), "scaled", False, True, "mixed"),
    ("adamw_bf16_f32m_many_scaled", True, "bfloat16", True, 5,
     ("global_norm", 1.0), "scaled", False, None, "many"),
    ("adam_f16_f32m_scaled_global", False, "float16", True, 0,
     ("global_norm", 1.0), "scaled", False, None, "mixed"),
    ("adamw_f16_norm_inf", True, "float16", False, 3, ("norm", 0.5),
     "scaled", True, None, "mixed"),
    ("adamw_bf16_f32m_strided_scaled", True, "bfloat16", True, 2,
     ("global_norm", 1.0), "scaled", False, None, "strided"),
)
# the loss scale of an f16 case: 2**15 times a unit normal overflows f16
OPT_LOSS_SCALE_F16 = 2.0 ** 10


def opt_shapes(kind):
    import numpy as np
    if kind == "mixed":
        return OPT_MIXED + [(OPT_MISALIGNED,)]
    if kind == "strided":
        return [(1000, 4096), (129, 65), (1, 7), (37, 1)]
    rng = np.random.default_rng(SEED)
    # more tensors than one launch takes, odd sizes, one of several chunks
    return [(int(n),) for n in rng.integers(1, 3000, 300)] + [(70001,)]


def opt_tensors(shapes, dtype, mdtype, gscale, seed, device,
                strided=False):
    """Parameters, gradients (the parameters' dtype, times ``gscale``),
    moments mid-run and beta powers; the last entry of a "mixed" table is
    a view one element into its buffers (not 16-byte aligned). With
    ``strided`` each parameter and moment is the transpose of a
    contiguous tensor and each gradient every other column of a tensor
    twice as wide."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def make(shape, dt, scale, positive=False, offset=0):
        n = math.prod(shape)
        x = (torch.rand if positive else torch.randn)(
            n + offset, generator=g, device=device) * scale
        return x.to(dt)[offset:].view(shape)

    def make_t(shape, dt, scale, positive=False):
        return make(shape[::-1], dt, scale, positive).t()

    cols = {k: [] for k in ("p", "g", "m1", "m2", "b1", "b2")}
    for i, shape in enumerate(shapes):
        if strided:
            cols["p"].append(make_t(shape, dtype, 1.0))
            cols["g"].append(make((shape[0], 2 * shape[1]), dtype,
                                  gscale)[:, ::2])
            cols["m1"].append(make_t(shape, mdtype, 0.1))
            cols["m2"].append(make_t(shape, mdtype, 0.01, True))
            cols["b1"].append(torch.full((), 0.9 ** 3, device=device))
            cols["b2"].append(torch.full((), 0.999 ** 3, device=device))
            continue
        off = int(shape == (OPT_MISALIGNED,))
        cols["p"].append(make(shape, dtype, 1.0, offset=off))
        cols["g"].append(make(shape, dtype, gscale, offset=off))
        cols["m1"].append(make(shape, mdtype, 0.1, offset=off))
        cols["m2"].append(make(shape, mdtype, 0.01, True, offset=off))
        cols["b1"].append(torch.full((), 0.9 ** 3, device=device))
        cols["b2"].append(torch.full((), 0.999 ** 3, device=device))
    return cols


def opt_clone(cols):
    import torch
    out = {}
    for k, ts in cols.items():
        out[k] = []
        for t in ts:
            if t.storage_offset():      # keep the view's misalignment
                base = torch.empty(t.numel() + t.storage_offset(),
                                   dtype=t.dtype, device=t.device)
                c = base[t.storage_offset():].view(t.shape)
                c.copy_(t)
            else:
                c = t.clone()
            out[k].append(c)
    return out


def opt_equal(a, b):
    """Bit-equal tensors (NaN equal to NaN at the same places)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(
        torch.equal(torch.where(na, 0, a), torch.where(nb, 0, b)))


def rel_err(a, b):
    import torch
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    err = ((a - b).abs() / b.abs().clamp(min=1e-30)).masked_fill(same, 0)
    return float(err.max()) if err.numel() else 0.0


def abs_err(a, b):
    """max |a - b|, equal values (infinities, NaN beside NaN) 0."""
    import torch
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    err = (a - b).abs().masked_fill(same, 0)
    return float(err.max()) if err.numel() else 0.0


def o1_errors(rk, rr):
    """O1's results against its plain version's: the largest relative
    and absolute errors of the sums of squares, the norm and the clip
    scale."""
    pairs = [(rk.stats, rr.stats)]
    if rk.scale is not None:
        pairs.append((rk.scale, rr.scale))
    return (max(rel_err(a, b) for a, b in pairs),
            max(abs_err(a, b) for a, b in pairs))


def opt_mismatches(got, want, keys=("p", "m1", "m2", "b1", "b2")):
    """The entries of ``got`` not bit-equal to ``want`` (dicts of
    columns), named column[index]."""
    return [f"{k}[{i}]" for k in keys
            for i, (a, b) in enumerate(zip(got[k], want[k]))
            if not opt_equal(a, b)]


def note_optimizer_parity(results, o1_rel, o1_abs, o2_abs, ok):
    """Fold one parity check into the kernels line's O1 and O2 rows:
    the largest errors so far, and parity "ok" while every check held."""
    r1, r2 = results["multi_tensor_unscale_norm"], \
        results["multi_tensor_adam"]
    r1["max_rel_err"] = max(r1["max_rel_err"] or 0.0, o1_rel)
    r1["max_abs_err"] = max(r1["max_abs_err"] or 0.0, o1_abs)
    r2["max_abs_err"] = max(r2["max_abs_err"] or 0.0, o2_abs)
    for r in (r1, r2):
        r["parity"] = "ok" if ok and r["parity"] in (None, "ok") \
            else "fail"


def optimizer_case(case, device="cuda"):
    """One case of optimizer_parity: O1 and O2 on the kernel side, their
    plain versions on a copy, on the card; the plain O2 gets the kernel
    O1's scale and found flag (the same clip scale)."""
    import torch
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    (name, decoupled, dname, f32m, exempt, clip, mode, poison, prior,
     kind) = case
    dtype = getattr(torch, dname)
    shapes = opt_shapes(kind)
    scaled = mode == "scaled"
    loss_scale = OPT_LOSS_SCALE_F16 if dtype == torch.float16 \
        else OPT_LOSS_SCALE
    ks = opt_tensors(shapes, dtype, torch.float32 if f32m else dtype,
                     loss_scale if scaled else 1.0, SEED + len(name),
                     device, strided=kind == "strided")
    if poison:
        ks["g"][1].reshape(-1)[7] = float("inf")
    ps = opt_clone(ks)
    before = opt_clone(ks)
    lr = torch.full((), 1e-3, device=device)
    wds = [0.0 if exempt and i % exempt == 0 else 0.01
           for i in range(len(shapes))]
    inv = torch.reciprocal(torch.full((), loss_scale, device=device)) \
        if scaled else None
    flags = [] if prior is None else [
        torch.full((), prior, dtype=torch.bool, device=device)]
    on_card = device != "cpu"
    if on_card:
        _, most = mt.config()
        batches = -(-len(shapes) // most)
    l1, l2 = mt.multi_tensor_unscale_norm.launches, \
        mt.multi_tensor_adam.launches
    row = {"case": name, "tensors": len(shapes), "dtype": dname,
           "moments": "float32" if f32m else dname, "clip": list(clip),
           "mode": mode, "planted_inf": poison, "prior_found": prior,
           "decoupled": decoupled}
    ok = True
    scale = None
    if scaled or clip[:1] in (("global_norm",), ("norm",)):
        rk = mt.multi_tensor_unscale_norm(ks["g"], inv, clip)
        rr = mt.multi_tensor_unscale_norm_reference(ps["g"], inv, clip)
        scale = rk.scale
        row["o1_stats_rel_err"] = rel_err(rk.stats, rr.stats)
        row["o1_scale_rel_err"] = 0.0 if scale is None else \
            rel_err(rk.scale, rr.scale)
        row["o1_max_abs_err"] = o1_errors(rk, rr)[1]
        row["o1_grads_bit_equal"] = all(
            opt_equal(a, b) for a, b in zip(ks["g"], ps["g"]))
        ok &= row["o1_stats_rel_err"] <= OPT_NORM_RTOL and \
            row["o1_scale_rel_err"] <= OPT_NORM_RTOL and \
            row["o1_grads_bit_equal"]
        if scaled:
            row["found"] = bool(rk.found)
            ok &= row["found"] == bool(rr.found) == poison
            flags = [rk.found] + flags
    kw = dict(lr=lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
              decoupled=decoupled, clip=clip, scale=scale, found=flags)
    mt.multi_tensor_adam(ks["p"], ks["g"], ks["m1"], ks["m2"], ks["b1"],
                         ks["b2"], wds, **kw)
    mt.multi_tensor_adam_reference(ps["p"], ps["g"], ps["m1"], ps["m2"],
                                   ps["b1"], ps["b2"], wds, **kw)
    bad = opt_mismatches(ks, ps)
    row["o2_bit_equal"] = not bad
    row["o2_max_abs_err"] = max(
        float((a.double() - b.double()).abs().nan_to_num(0).max())
        for k in ("p", "m1", "m2") for a, b in zip(ks[k], ps[k]))
    ok &= not bad
    skip = poison or bool(prior)
    if skip:
        unchanged = opt_mismatches(ks, before)
        row["skipped_step_unchanged"] = not unchanged
        ok &= not unchanged
    else:
        row["params_moved"] = not all(
            opt_equal(a, b) for a, b in zip(ks["p"], before["p"]))
        ok &= row["params_moved"]
    if on_card:
        n1 = mt.multi_tensor_unscale_norm.launches - l1
        n2 = mt.multi_tensor_adam.launches - l2
        want1 = batches + 1 if "o1_stats_rel_err" in row else 0
        row["launches"] = {"o1": n1, "o2": n2}
        ok &= n1 == want1 and n2 == batches
    if bad:
        row["o2_mismatches"] = bad[:8]
    row["ok"] = bool(ok)
    return row


def phase_optimizer_parity(results, device="cuda"):
    rows = [optimizer_case(case, device) for case in OPT_CASES]
    failed = [r for r in rows if not r["ok"]]
    note_optimizer_parity(
        results,
        max(max(r.get("o1_scale_rel_err", 0.0),
                r.get("o1_stats_rel_err", 0.0)) for r in rows),
        max(r.get("o1_max_abs_err", 0.0) for r in rows),
        max(r["o2_max_abs_err"] for r in rows), not failed)
    out = {"cases": rows, "norm_rtol": OPT_NORM_RTOL,
           "note": "params, moments and beta powers bit-equal to the plain "
                   "version given the kernel O1's scale and flag; O1's "
                   "scale and sums of squares within norm_rtol (summation "
                   "order); unscaled grads bit-equal; a skipped step "
                   "leaves every tensor bit-equal to before it"}
    if failed:
        emit({"phase": "optimizer_parity", "failed": failed})
        raise AssertionError(f"optimizer kernels disagree with their plain "
                             f"versions in {[r['case'] for r in failed]}")
    return out


def optimizer_fallbacks():
    """The sum over reasons of ``optimizer.fallbacks_total``."""
    from paddle_tpu_torch.observability import metrics
    c = metrics.default_registry().get("optimizer.fallbacks_total")
    return 0 if c is None else c.total()


def reset_optimizer_counts():
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    mt.multi_tensor_unscale_norm.launches = 0
    mt.multi_tensor_adam.launches = 0
    c = metrics.default_registry().get("optimizer.fallbacks_total")
    if c is not None:
        c.reset()


def check_optimizer_launches(phase, opt, steps, o1_per_batch):
    """After ``steps`` steps: O2 launched once a batch of parameters a
    step, O1 (with a clip by norm or a scaler) once a batch plus its
    finalize, no fallback to the loop."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    _, most = mt.config()
    batches = -(-len(opt._parameter_list) // most)
    got = {"o1": mt.multi_tensor_unscale_norm.launches,
           "o2": mt.multi_tensor_adam.launches,
           "fallbacks": optimizer_fallbacks()}
    want = {"o1": steps * (batches + 1) if o1_per_batch else 0,
            "o2": steps * batches, "fallbacks": 0}
    if got != want:
        from paddle_tpu_torch.observability import metrics
        c = metrics.default_registry().get("optimizer.fallbacks_total")
        raise AssertionError(f"{phase}: optimizer launches and fallbacks "
                             f"{got} != {want} over {steps} steps "
                             f"(fallback reasons {dict(c._cells)})")
    return got


def optimizer_both_ways(step, batch):
    """One profiled train step through the fused kernels and one through
    the loop (FLAGS_fused_optimizer=0), in this run: each step's profile
    (its "optimizer" group: the multi_tensor kernels), the device ms of
    ``optimizer.step()`` inside it (CUDA events around the call) and the
    wall ms of one more step without the profiler (synchronised before
    and after)."""
    import torch
    from paddle_tpu_torch.core.flags import set_flags
    opt = step.optimizer
    out = {}
    for name, flag in (("fused", True), ("loop", False)):
        events = []
        inner = type(opt).step.__get__(opt)

        def timed():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            inner()
            b.record()
            events.append((a, b))

        set_flags({"FLAGS_fused_optimizer": flag})
        opt.step = timed
        try:
            prof = profile_train_step(step, batch)
            del opt.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*batch)
            torch.cuda.synchronize()
            prof["step_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            if "step" in vars(opt):
                del opt.step
            set_flags({"FLAGS_fused_optimizer": True})
        prof["optimizer_step_ms"] = events[0][0].elapsed_time(events[0][1])
        out[name] = prof
    return out


def bench_small_optimizer():
    """The JAX package's bench_fused_optimizer_step (bench.py:1415-1500):
    64 f32 parameters of 64 x 64, AdamW + ClipGradByGlobalNorm(1.0) +
    CosineAnnealingDecay(1e-3, T_max=200), gradients kept across steps;
    host µs a step (20 steps, one sync at the end, best of 3) and the
    host µs to issue one, fused and through the loop."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.optimizer import AdamW, lr
    n_params, shape, steps = 64, (64, 64), 20
    rng = np.random.default_rng(0)
    grads = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                              * 1e-3).cuda() for _ in range(n_params)]

    def measure(reps=3):
        ps = [torch.from_numpy(np.random.default_rng(i).standard_normal(
            shape).astype(np.float32)).cuda().requires_grad_()
            for i in range(n_params)]
        sched = lr.CosineAnnealingDecay(learning_rate=1e-3, T_max=200)
        opt = AdamW(learning_rate=sched, parameters=ps,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        for p, g in zip(ps, grads):
            p.grad = g
        for _ in range(3):
            opt.step()
            sched.step()
        torch.cuda.synchronize()
        best = issue = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(steps):
                opt.step()
                sched.step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / steps)
            issue = min(issue, (t1 - t0) / steps)
        return best * 1e6, issue * 1e6

    out = {"n_params": n_params, "shape": list(shape), "steps": steps,
           "optimizer": "AdamW + ClipGradByGlobalNorm(1.0) + "
                        "CosineAnnealingDecay(1e-3, T_max=200), f32"}
    try:
        set_flags({"FLAGS_fused_optimizer": True})
        l1, l2 = mt.multi_tensor_unscale_norm.launches, \
            mt.multi_tensor_adam.launches
        out["fused_us"], out["fused_issue_us"] = measure()
        n = 3 + 3 * steps
        out["fused_launches_per_step"] = {
            "o1": (mt.multi_tensor_unscale_norm.launches - l1) / n,
            "o2": (mt.multi_tensor_adam.launches - l2) / n}
        set_flags({"FLAGS_fused_optimizer": False})
        out["loop_us"], out["loop_issue_us"] = measure()
    finally:
        set_flags({"FLAGS_fused_optimizer": True})
    out["speedup"] = out["loop_us"] / out["fused_us"]
    return out


def optimizer_train_parity(cols, wds):
    """O1 and O2 against their plain versions on the train phase's
    tensors (``cols``: p, g, m1, m2, b1, b2; thousands of chunks in the
    largest tensor, tens of thousands of blocks a launch): a step of O2
    alone, then the GradScaler's step, the gradients times the loss
    scale: O1 unscales them with a global-norm clip and O2 takes its
    scale and flag. The plain versions run on copies; the kernels leave
    the gradients as they found them (times the scale, unscaled)."""
    import torch
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    keys = ("p", "g", "m1", "m2", "b1", "b2")
    ks = dict(zip(keys, cols))
    ps = {k: [t.detach().clone() for t in v] for k, v in ks.items()}
    kw = dict(lr=torch.full((), 1e-3, device="cuda"), beta1=0.9,
              beta2=0.999, epsilon=1e-8, decoupled=True)
    row = {"tensors": len(cols[0]),
           "largest_tensor": max(t.numel() for t in cols[0]),
           "chunks": sum(-(-t.numel() // mt.config()[0]) for t in cols[0])}
    mt.multi_tensor_adam(*cols, wds, **kw)
    mt.multi_tensor_adam_reference(*(ps[k] for k in keys), wds, **kw)
    bad = opt_mismatches(ks, ps)
    err = [float((a.detach().double() - b.double()).abs().max())
           for k in ("p", "m1", "m2") for a, b in zip(ks[k], ps[k])]
    for g in ks["g"] + ps["g"]:
        g.mul_(OPT_LOSS_SCALE)          # a power of two: exact in bf16
    inv = torch.reciprocal(torch.full((), OPT_LOSS_SCALE, device="cuda"))
    clip = ("global_norm", 1.0)
    rk = mt.multi_tensor_unscale_norm(ks["g"], inv, clip)
    rr = mt.multi_tensor_unscale_norm_reference(ps["g"], inv, clip)
    row["o1_rel_err"], row["o1_abs_err"] = o1_errors(rk, rr)
    row["global_norm"] = float(rk.stats[-1])
    row["clip_scale"] = float(rk.scale[0])
    row["found"] = [bool(rk.found), bool(rr.found)]
    row["o1_grads_bit_equal"] = not opt_mismatches(ks, ps, ("g",))
    step = dict(kw, clip=clip, scale=rk.scale, found=[rk.found])
    mt.multi_tensor_adam(*cols, wds, **step)
    mt.multi_tensor_adam_reference(*(ps[k] for k in keys), wds, **step)
    bad += [f"scaled step {x}" for x in opt_mismatches(ks, ps)]
    err += [float((a.detach().double() - b.double()).abs().max())
            for k in ("p", "m1", "m2") for a, b in zip(ks[k], ps[k])]
    row["o2_bit_equal"] = not bad
    row["o2_max_abs_err"] = max(err)
    row["ok"] = (row["o2_bit_equal"] and row["o1_grads_bit_equal"]
                 and row["o1_rel_err"] <= OPT_NORM_RTOL
                 and row["found"] == [False, False])
    if bad:
        row["o2_mismatches"] = bad[:8]
    del ps, rk, rr
    torch.cuda.empty_cache()
    return row


def phase_optimizer_time(results):
    import torch
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.optimizer import AdamW
    small = bench_small_optimizer()
    # the train phase's parameters (7B widths, 4 layers, bf16), bf16
    # gradients and bf16 moments (multi_precision=False, as train runs)
    model = train_model(TRAIN["layers"])
    named = list(model.named_parameters())
    ps = [p for _, p in named]
    n = sum(p.numel() for p in ps)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    gs = [(torch.randn(p.shape, generator=g, device="cuda") * 1e-3).to(
        torch.bfloat16) for p in ps]
    m1 = [torch.zeros_like(p) for p in ps]
    m2 = [torch.zeros_like(p) for p in ps]
    b1 = [torch.ones((), device="cuda") for _ in ps]
    b2 = [torch.ones((), device="cuda") for _ in ps]
    wds = [0.01] * len(ps)
    lr = torch.full((), 1e-3, device="cuda")
    one = torch.ones((), device="cuda")
    clip = ("global_norm", 1.0)
    kw = dict(lr=lr, beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=True)
    parity = optimizer_train_parity([ps, gs, m1, m2, b1, b2], wds)
    note_optimizer_parity(results, parity["o1_rel_err"],
                          parity["o1_abs_err"], parity["o2_max_abs_err"],
                          parity["ok"])
    if not parity["ok"]:
        emit({"phase": "optimizer_time", "failed": parity})
        raise AssertionError("O1/O2 disagree with their plain versions on "
                             "the train phase's tensors")
    res = mt.multi_tensor_unscale_norm(gs, None, clip)
    fns = {
        "o2": lambda: mt.multi_tensor_adam(ps, gs, m1, m2, b1, b2, wds, **kw),
        "o2_clip": lambda: mt.multi_tensor_adam(
            ps, gs, m1, m2, b1, b2, wds, clip=clip, scale=res.scale, **kw),
        "o1_norm": lambda: mt.multi_tensor_unscale_norm(gs, None, clip),
        "o1_scaled": lambda: mt.multi_tensor_unscale_norm(gs, one, clip),
    }
    t = {k: time_ms(f, samples=10, inner=2) for k, f in fns.items()}
    t["o2_plain"] = time_ms(lambda: mt.multi_tensor_adam_reference(
        ps, gs, m1, m2, b1, b2, wds, **kw), samples=3, inner=1, warmup=1)
    t["o1_plain"] = time_ms(lambda: mt.multi_tensor_unscale_norm_reference(
        gs, None, clip), samples=3, inner=1, warmup=1)
    steps = [torch.zeros((), device="cuda") for _ in ps]
    t["library_fused_adamw"] = time_ms(lambda: torch._fused_adamw_(
        ps, gs, m1, m2, [], steps, lr=1e-3, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
        samples=10, inner=2)
    t["library_foreach_norm"] = time_ms(lambda: torch._foreach_norm(gs),
                                        samples=10, inner=2)
    # the optimizer itself, fused and through the loop, with and without
    # the clip
    for clipped in (False, True):
        opt = AdamW(learning_rate=1e-3, parameters=named,
                    multi_precision=False,
                    grad_clip=ClipGradByGlobalNorm(1.0) if clipped else None)
        for p, gr in zip(ps, gs):
            p.grad = gr
        tag = "_clip" if clipped else ""
        try:
            set_flags({"FLAGS_fused_optimizer": False})
            t["loop" + tag] = time_ms(opt.step, samples=3, inner=1,
                                      warmup=1)
            set_flags({"FLAGS_fused_optimizer": True})
            t["fused_step" + tag] = time_ms(opt.step, samples=10, inner=2)
        finally:
            set_flags({"FLAGS_fused_optimizer": True})
        opt.clear_grad()
        del opt
    bound = {"o2": 14 * n / HBM_BYTES_PER_S * 1e3,
             "o1_norm": 2 * n / HBM_BYTES_PER_S * 1e3,
             "o1_scaled": 4 * n / HBM_BYTES_PER_S * 1e3}
    bound["o2_clip"] = bound["o2"]
    rows = (("multi_tensor_adam", "o2", "o2_plain", "library_fused_adamw"),
            ("multi_tensor_unscale_norm", "o1_norm", "o1_plain",
             "library_foreach_norm"))
    for key, k, plain, lib in rows:
        r = results[key]
        r.update(ms=t[k], kernel_ms=t[k], plain_ms=t[plain],
                 bound_ms=bound[k], bound_by="bytes", library_ms=t[lib],
                 loop_ms=t["loop"] if k == "o2" else None)
    out = {"card": nvidia_smi_line(), "small_bench": small,
           "train_geometry_parity": parity,
           "geometry": "the train phase's parameters: llama2-7b widths, "
                       f"{TRAIN['layers']} layers, {len(ps)} tensors, "
                       f"{n} bf16 parameters, bf16 gradients and moments",
           "params": n, "tensors": len(ps), "times_ms": t,
           "bound_ms": bound,
           "bound_note": "O2 14 B a parameter (p, g, m1, m2 read; p, m1, m2 "
                         "written, bf16), O1 2 B (g read; 4 B when it "
                         "unscales in place); at 3.35 TB/s",
           "library": "torch._fused_adamw_ on the same bf16 tensors (decays "
                      "before the step and updates in bf16: a yardstick, "
                      "not the JAX formula); torch._foreach_norm over the "
                      "gradients for O1 (the norms only: no clip scale, "
                      "no finite check, no unscale)",
           "loop": "Optimizer.step with FLAGS_fused_optimizer=0 (the "
                   "per-parameter loop) on the same parameters and "
                   "gradients; fused_step: Optimizer.step through O1/O2"}
    for p in ps:
        p.grad = None
    del model, named, ps, gs, m1, m2, b1, b2, steps, res
    torch.cuda.empty_cache()
    return out


AMP = dict(layers=2, batch=2, seq=2048, steps=6, poison_step=3,
           parity_step=2, lr=1e-4, warmup=2, t_max=100)


def amp_snapshot(opt, scaler):
    """What one scaler.step reads: the parameters with gradients (in the
    fused table's order), copies of them, of their gradients (times the
    loss scale), of their states, the loss scale and the decays."""
    params = [p for p, _ in opt._params_grads()]
    idx = [opt._index[id(p)] for p in params]
    return {"params": params,
            "p": [p.detach().clone() for p in params],
            "g": [p.grad.clone() for p in params],
            **{k: [opt._states[i][slot].clone() for i in idx]
               for k, slot in (("m1", "moment1"), ("m2", "moment2"),
                               ("b1", "beta1_pow"), ("b2", "beta2_pow"))},
            "scale": scaler._scale.clone(),
            "wds": [float(opt._use_wd(i)) for i in idx], "idx": idx}


def amp_step_parity(opt, snap, o1, lr):
    """One fused scaler.step against the plain versions run on its
    snapshot: the unscaled gradients and O1's clip scale and norms
    (``o1``: the UnscaleNorm the step's O1 returned), then O2 given that
    scale and flag: parameters, moments and powers bit-equal."""
    import torch
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    clip = ("global_norm", 1.0)
    rr = mt.multi_tensor_unscale_norm_reference(
        snap["g"], torch.reciprocal(snap["scale"]), clip)
    row = {"step": AMP["parity_step"], "tensors": len(snap["p"])}
    row["o1_rel_err"], row["o1_abs_err"] = o1_errors(o1, rr)
    row["found"] = [bool(o1.found), bool(rr.found)]
    row["o1_grads_bit_equal"] = all(
        opt_equal(p.grad, g) for p, g in zip(snap["params"], snap["g"]))
    before = [t.clone() for t in snap["p"]]
    mt.multi_tensor_adam_reference(
        snap["p"], snap["g"], snap["m1"], snap["m2"], snap["b1"],
        snap["b2"], snap["wds"], lr=torch.full((), lr, device="cuda"),
        beta1=opt._beta1, beta2=opt._beta2, epsilon=opt._epsilon,
        decoupled=opt._decoupled_wd, clip=clip, scale=o1.scale,
        found=[o1.found])
    got = {"p": [p.detach() for p in snap["params"]],
           **{k: [opt._states[i][slot] for i in snap["idx"]]
              for k, slot in (("m1", "moment1"), ("m2", "moment2"),
                              ("b1", "beta1_pow"), ("b2", "beta2_pow"))}}
    bad = opt_mismatches(got, snap)
    row["o2_bit_equal"] = not bad
    row["o2_max_abs_err"] = max(
        float((a.double() - b.double()).abs().max())
        for k in ("p", "m1", "m2") for a, b in zip(got[k], snap[k]))
    row["params_moved"] = not all(opt_equal(a, b)
                                  for a, b in zip(got["p"], before))
    row["ok"] = (not bad and row["o1_grads_bit_equal"]
                 and row["o1_rel_err"] <= OPT_NORM_RTOL
                 and row["found"] == [False, False])
    if bad:
        row["o2_mismatches"] = bad[:8]
    return row


def phase_amp_scaler(results):
    """THE AMP PATH: a 2-layer bf16 Llama at 7B widths trains with
    ClipGradByGlobalNorm(1.0), LinearWarmup over CosineAnnealingDecay
    and GradScaler(2**15, decr_every_n_nan_or_inf=1); one step gets an
    inf planted in a gradient. scaler.step, scaler.update and every
    scheduler.step() run under torch.cuda.set_sync_debug_mode("error")."""
    import torch
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.optimizer import AdamW, lr
    model = train_model(AMP["layers"])
    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(AMP["lr"], T_max=AMP["t_max"]),
        warmup_steps=AMP["warmup"], start_lr=0.0, end_lr=AMP["lr"])
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                multi_precision=False, grad_clip=ClipGradByGlobalNorm(1.0))
    scaler = GradScaler(init_loss_scaling=OPT_LOSS_SCALE,
                        decr_every_n_nan_or_inf=1)
    crit = LlamaPretrainingCriterion()
    ids = train_ids(model.config.vocab_size)[:AMP["batch"]]
    losses, scales, lrs, skipped, parity = [], [], [], None, None
    reset_optimizer_counts()
    o1_seen = []
    o1_call = mt.AdamTable.unscale_norm

    def o1_spy(table, *a, **k):       # keeps the step's O1 results
        o1_seen.append(o1_call(table, *a, **k))
        return o1_seen[-1]

    for s in range(AMP["steps"]):
        loss = crit(model(ids), ids).float()
        scaler.scale(loss).backward()
        snap = amp_snapshot(opt, scaler) if s == AMP["parity_step"] \
            else None
        if s == AMP["poison_step"]:
            before = {"params": [p.detach().clone()
                                 for p in opt._parameter_list],
                      "states": {i: {k: v.clone() for k, v in st.items()}
                                 for i, st in opt._states.items()}}
            opt._parameter_list[1].grad.view(-1)[5] = float("inf")
        scale_before = float(scaler._scale)
        lrs.append(opt.get_lr())
        torch.cuda.synchronize()
        o1_seen.clear()
        mt.AdamTable.unscale_norm = o1_spy
        torch.cuda.set_sync_debug_mode("error")
        try:
            scaler.step(opt)
            scaler.update()
            sched.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            mt.AdamTable.unscale_norm = o1_call
        if snap is not None:
            parity = amp_step_parity(opt, snap, o1_seen[0], lrs[-1])
            del snap
        opt.clear_grad()
        losses.append(float(loss))
        scales.append(float(scaler._scale))
        if s == AMP["poison_step"]:
            params_same = all(opt_equal(a, b) for a, b in zip(
                before["params"], opt._parameter_list))
            states_same = all(opt_equal(v, opt._states[i][k])
                              for i, st in before["states"].items()
                              for k, v in st.items())
            skipped = {"params_bit_equal": params_same,
                       "states_bit_equal": states_same,
                       "scale_before": scale_before,
                       "scale_after": scales[-1]}
            del before
    counts = check_optimizer_launches("amp_scaler", opt, AMP["steps"], True)
    results["multi_tensor_unscale_norm"]["launches"] = counts["o1"]
    expected_scales = []
    sc = OPT_LOSS_SCALE
    for s in range(AMP["steps"]):
        sc = sc / 2 if s == AMP["poison_step"] else sc
        expected_scales.append(sc)
    note_optimizer_parity(results, parity["o1_rel_err"],
                          parity["o1_abs_err"], parity["o2_max_abs_err"],
                          parity["ok"])
    ok = (skipped["params_bit_equal"] and skipped["states_bit_equal"]
          and parity["ok"] and parity["params_moved"]
          and scales == expected_scales
          and all(math.isfinite(x) for x in losses)
          and opt._global_step == AMP["steps"])
    out = {"card": nvidia_smi_line(), "model": "llama2-7b-width",
           "layers": AMP["layers"], "batch": AMP["batch"],
           "seq": AMP["seq"], "dtype": "bfloat16",
           "optimizer": "AdamW(multi_precision=False, "
                        "grad_clip=ClipGradByGlobalNorm(1.0))",
           "lr": f"LinearWarmup({AMP['warmup']} steps, 0 -> {AMP['lr']}) "
                 f"over CosineAnnealingDecay({AMP['lr']}, "
                 f"T_max={AMP['t_max']})",
           "scaler": f"GradScaler(init_loss_scaling={OPT_LOSS_SCALE}, "
                     "decr_every_n_nan_or_inf=1)",
           "reduced": ["depth 32 -> 2 layers", "batch 2 x 2048",
                       "random weights from a seed"],
           "losses": losses, "lrs": lrs, "loss_scales": scales,
           "expected_loss_scales": expected_scales,
           "poisoned_step": AMP["poison_step"], "skipped_step": skipped,
           "step_parity": parity,
           "launches": counts,
           "sync_debug_mode": "error around scaler.step, scaler.update "
                              "and scheduler.step: no sync raised",
           "ok": ok}
    del opt, model, scaler
    torch.cuda.empty_cache()
    if not ok:
        emit({"phase": "amp_scaler", "failed": out})
        raise AssertionError("the AMP step did not skip the poisoned step "
                             "bit-exactly, a step disagreed with the plain "
                             "versions or the loss scale went wrong")
    return out


def ptxas_instances(lines):
    """{kernel<template args>: (registers, spill bytes)} from ptxas'
    report of one library: each "Compiling entry function" line, then its
    spill and register lines."""
    out, name = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # the kernel's name is the one whose length prefix fits it
            k = [x for x in re.finditer(
                r"(?=(\d{1,3})((?:flash|gmm|paged)\w*?_kernel)I(\w*?)EEv)",
                m.group(1)) if int(x.group(1)) == len(x.group(2))]
            args = re.findall(r"L[ib](\d+)E", k[0].group(3)) if k else []
            if k and k[0].group(2).startswith("paged"):
                # the split kernels' first template argument is the pool
                # dtype: __nv_bfloat16 or int8_t (signed char, "a")
                args.insert(0, "bf16" if k[0].group(3).startswith(
                    "13__nv_bfloat16") else "int8")
            plain = re.search(r"multi_tensor_(?:adam|unscale_norm|finalize)"
                              r"_kernel", m.group(1))
            name = f"{k[0].group(2)}<{','.join(args)}>" if k else \
                plain.group(0) if plain else m.group(1)
            out[name] = [None, 0]
        elif name and "spill" in ln:
            out[name][1] = sum(int(x) for x in
                               re.findall(r"(\d+) bytes spill", ln))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def flash_tma_occupancy():
    """Per TMA flash kernel instance: CTAs an SM (the runtime's occupancy
    calculator) and dynamic shared memory (bytes)."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    fn = fa._kernel_lib_tma().flash_attention_tma_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for which, kname in enumerate(("fwd", "dq", "dkv")):
        for d, drop, seg in ((128, 0, 0), (128, 0, 1), (64, 0, 0),
                             (64, 1, 0), (64, 0, 1)):
            smem = ctypes.c_int(0)
            ctas = fn(which, d, 1, drop, seg, ctypes.byref(smem))
            tag = "_dropout" if drop else "_segments" if seg else ""
            out[f"{kname}_d{d}{tag}"] = {"ctas_per_sm": ctas,
                                        "smem_bytes": smem.value}
    return out


def paged_split_occupancy():
    """Per split paged-attention instance: CTAs an SM and dynamic shared
    memory (bytes)."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    fn = pa._kernel_lib_split().paged_attention_split_occupancy
    out = {}
    for kv, code in (("bf16", 1), ("int8", 2)):
        for d in (64, 128):
            for g in (1, 4, 64):
                smem = ctypes.c_int(0)
                ctas = fn(code, d, g, ctypes.byref(smem))
                out[f"{kv}_d{d}_g{g}"] = {"ctas_per_sm": ctas,
                                          "smem_bytes": smem.value}
    return out


def phase_build():
    from paddle_tpu_torch.ops.kernels import build
    out = {name: {"nvcc_seconds": b.seconds,
                  "ptxas": [ln.strip() for ln in b.log.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling entry" in ln
                            or "Performance Loss" in ln]}
           for name, b in build.build_all(verbose=True).items()}
    # the TMA flash kernels are sized to the registers a thread has: a
    # spill, or wgmmas that ptxas serialises ("Potential Performance
    # Loss"), is a fault of the design
    tma = ptxas_instances(out["flash_attention_tma"]["ptxas"])
    spills = {k: v for k, v in tma.items() if v[1] or v[0] is None}
    serial = [ln for ln in out["flash_attention_tma"]["ptxas"]
              if "Performance Loss" in ln]
    # the D-64 instances: forward, dQ and dK/dV <causal, dropout,
    # segments>, six each (no dropout with segments); D 128 <128, causal,
    # segments>, four each
    d64 = [k for k in tma if k.startswith(("flash_fwd64_tma_kernel<",
                                           "flash_bwd_dq64_tma_kernel<",
                                           "flash_bwd_dkv64_tma_kernel<"))]
    d128 = [k for k in tma if k.startswith(("flash_fwd_tma_kernel<",
                                            "flash_bwd_dq_tma_kernel<",
                                            "flash_bwd_dkv_tma_kernel<"))]
    if spills or serial or len(d64) != 18 or len(d128) != 12:
        emit({"phase": "build", "failed": {"spills": spills,
                                           "serialised": serial,
                                           "d64_instances": d64,
                                           "d128_instances": d128}})
        raise AssertionError("the TMA flash kernels spill registers, have "
                             "serialised wgmmas or lack instances")
    out["flash_attention_tma"]["registers_and_spills"] = tma
    out["flash_attention_tma"]["occupancy"] = flash_tma_occupancy()
    # the split paged-attention kernels: 8 CUDA-core instances (bf16 /
    # int8 pools, D 64 / 128, groups of 1 and 4 rows) and 4 tensor-core
    # ones; none may spill
    paged = ptxas_instances(out["paged_attention_split"]["ptxas"])
    spills = {k: v for k, v in paged.items() if v[1] or v[0] is None}
    if spills or len(paged) != 12:
        emit({"phase": "build", "failed": {"paged_spills": spills,
                                           "paged_instances": list(paged)}})
        raise AssertionError("the split paged-attention kernels spill "
                             "registers or lack instances")
    out["paged_attention_split"]["registers_and_spills"] = paged
    out["paged_attention_split"]["occupancy"] = paged_split_occupancy()
    # the optimizer kernels: O1, its finalize and O2; none may spill
    opt = ptxas_instances(out["multi_tensor_optimizer"]["ptxas"])
    spills = {k: v for k, v in opt.items() if v[1] or v[0] is None}
    if spills or len(opt) != 3:
        emit({"phase": "build", "failed": {"optimizer_spills": spills,
                                           "optimizer_instances": list(opt)}})
        raise AssertionError("the optimizer kernels spill registers or lack "
                             "instances")
    out["multi_tensor_optimizer"]["registers_and_spills"] = opt
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
    # K3 on the split design at four geometries: decode (bf16 and int8
    # pools), the 64-row prefill chunk and the speculative verify window
    # (5 rows a slot, tensor cores); general_ms times the first design
    # (csrc/paged_attention.cu) on the same inputs
    k3 = {
        row: {"name": name, "route": "cuda",
              "source": "paddle_tpu_torch/ops/kernels/csrc/"
                        "paged_attention_split.cu",
              "replaces": "paddle_tpu/ops/pallas/paged_attention.py:63",
              "tpu_kernel": "paddle_tpu/ops/pallas/paged_attention.py:"
                            "_kernel",
              "design": "split", "geometry": row,
              "launches": None, "parity": None, "max_abs_err": None,
              "ms": None, "kernel_ms": None, "general_ms": None,
              "plain_ms": None, "bound_ms": None, "bound_by": None,
              "library_ms": None}
        for row, name in (("decode_bf16", "paged_attention"),
                          ("decode_int8", "paged_attention_int8_decode"),
                          ("prefill_chunk", "paged_attention_prefill_chunk"),
                          ("spec_verify_t5", "paged_attention_spec_verify"))}
    result = k3["decode_bf16"]
    # K1b/K2b at the Llama training geometry and K1a/K2a at ERNIE-MoE's
    # (D 64, causal), both on the TMA / wgmma design (general_ms times the
    # first design alongside); K5 (dropout) in K1a/K2a at the BERT
    # geometry and K4 (segments) at the packed geometry (D 64) and the op
    # bench's (D 128), on the TMA design too
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
            ("flash_attention_fwd_d64", 380,
             "_flash_fwd_pallas (_fwd_kernel :99)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dq_d64", 414,
             "_flash_bwd_pallas (_bwd_dq_kernel :208)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dkv_d64", 432,
             "_flash_bwd_pallas (_bwd_dkv_kernel :278)",
             "flash_attention_tma.cu"),
            ("flash_attention_fwd_dropout", 76,
             "_keep_mask in _fwd_kernel (dropout_p > 0)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dq_dropout", 76,
             "_keep_mask in _bwd_dq_kernel (dropout_p > 0)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dkv_dropout", 76,
             "_keep_mask in _bwd_dkv_kernel (dropout_p > 0)",
             "flash_attention_tma.cu"),
            ("flash_attention_fwd_segmented", 746,
             "_flash_fwd_pallas_seg :738 (_fwd_kernel, segmented=True)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dq_segmented", 773,
             "_flash_bwd_pallas_seg :768 (_bwd_dq_kernel, segmented=True)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dkv_segmented", 791,
             "_flash_bwd_pallas_seg :768 (_bwd_dkv_kernel, segmented=True)",
             "flash_attention_tma.cu"),
            ("flash_attention_fwd_segmented_d128", 746,
             "_flash_fwd_pallas_seg :738 (_fwd_kernel, segmented=True)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dq_segmented_d128", 773,
             "_flash_bwd_pallas_seg :768 (_bwd_dq_kernel, segmented=True)",
             "flash_attention_tma.cu"),
            ("flash_attention_bwd_dkv_segmented_d128", 791,
             "_flash_bwd_pallas_seg :768 (_bwd_dkv_kernel, segmented=True)",
             "flash_attention_tma.cu"))}
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
    # O1 and O2, the fused optimizer step's kernels: the JAX package runs
    # the step as one XLA program (no Pallas kernel); "replaces" names
    # the function of that program each kernel computes
    for name, line, body in (
            ("multi_tensor_unscale_norm", 535,
             "_unscale_fn :535 and clip_by_spec's norms "
             "(utils/clip_grad.py:48-73) inside _make_fn :217"),
            ("multi_tensor_adam", 217,
             "_make_fn :217 (apply_update_tail :190: Adam._update, "
             "optimizer.py:299, and where(found, old, new) :240)")):
        flash[name] = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/"
                      "multi_tensor_optimizer.cu",
            "replaces": f"paddle_tpu/optimizer/fused_step.py:{line}",
            "tpu_kernel": "none: one XLA program, fused_step.py " + body,
            "design": "multi-tensor table in the kernel parameters, "
                      "(tensor, chunk) blocks, 16-byte vectors",
            "launches": None, "parity": None, "max_abs_err": None,
            "ms": None, "kernel_ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
            "loop_ms": None}
    # O1's norms add in another order than the plain version's: its
    # relative error beside the absolute one (O2's is bit-equal)
    flash["multi_tensor_unscale_norm"]["max_rel_err"] = None
    state: dict = {}

    def free_serving():
        serve = state.get("serve", {})
        state.clear()
        # the fleet phase prints its rates beside the serve phase's
        state["serve_summary"] = {k: serve.get(k) for k in (
            "decode_tokens_per_s", "ttft_median_s", "ttft_max_s", "wall_s")}
        torch.cuda.empty_cache()
        return {}

    phases = [
        ("env", lambda: {"nvidia_smi": smi, "torch": torch.__version__,
                         "cuda": torch.version.cuda, "device": kind,
                         "count": torch.cuda.device_count()}),
        ("build", phase_build),
        ("kernel_parity", lambda: phase_kernel_parity(result)),
        ("kernel_time", lambda: phase_kernel_time(k3)),
        ("serve", lambda: phase_serve(state, k3)),
        ("serve_parity", lambda: phase_serve_parity(state)),
        ("serve_spec", lambda: phase_serve_spec(state, k3)),
        ("serve_spec_full_accept",
         lambda: phase_serve_spec_full_accept(state)),
        ("hot_swap", lambda: phase_hot_swap(state)),
        ("serve_supervised", lambda: phase_serve_supervised(state)),
        ("rollout", lambda: {**phase_rollout(state), **free_serving()}),
        ("fleet", lambda: phase_fleet(state, k3)),
        ("serve_http", phase_serve_http),
        ("flash_parity", lambda: phase_flash_parity(flash)),
        ("flash_time", lambda: phase_flash_time(flash)),
        ("optimizer_parity", lambda: phase_optimizer_parity(flash)),
        ("optimizer_time", lambda: phase_optimizer_time(flash)),
        ("train", lambda: phase_train(flash)),
        ("train_parity", phase_train_parity),
        ("amp_scaler", lambda: phase_amp_scaler(flash)),
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
    for row in k3.values():
        row["parity"] = result["parity"]
    emit({"kernels": [*k3.values(), *flash.values()],
          "seconds": time.perf_counter() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
