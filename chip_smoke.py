#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, MoE, eager, Model.fit, vision, dy2static and export paths on one card.

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
12. ``fleet``         THE FLEET PATH: Llama-2 7B widths (depth 32 cut to
                      8 layers for the run's time, the serve phase's
                      weights by seed), bf16, in replica
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
                      of its optimizer.step() (a replay's from the
                      profile's optimizer kernels);
                      TrainStep runs on CapturedStep: the first warm-up
                      step eager, the second captured as one CUDA graph
                      and replayed, the timed steps replays under
                      torch.cuda.set_sync_debug_mode("error") (gated: as
                      many captured steps as timed steps, one graph, no
                      fallback); then the same steps through a plain
                      eager loop from the same weights (copied before the
                      run), seed and batches: every loss within 1e-3
                      relative, the final parameters within 5e-2 relative
                      RMS, the port's stream state equal after both (bit
                      equality reported), the eager step ms, tokens/s and
                      peak memory beside the captured ones;
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
                      every launch reads its Philox key from device
                      memory (an int64 [2] key tensor); a small dropout
                      call (a key drawn from the port's key stream, then
                      the three kernels) captured in one CUDA graph and
                      replayed 3 times gives 3 different outputs, each
                      bit-equal to the eager call with the same place in
                      the stream after the same seed, and a reseed between
                      replays restarts the stream inside the graph;
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
                      of its optimizer.step(); captured and held against
                      the eager loop as ``train`` is, each replay drawing
                      its 49 dropout keys (37 hash, 12 K5) on the card;
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
                      of its optimizer.step(); captured and held against
                      the eager loop as ``train`` is (the capacity
                      dispatch reads nothing on the host);
30. ``moe_train_parity``  one step of a 2-layer ERNIE-MoE (one dense, one
                      MoE layer) through the kernels against the same step
                      through the plain sdpa: loss, every gradient and the
                      share of tokens whose top-2 experts differ; beside
                      it the same comparison with the plain step replaying
                      the kernel step's routing (the kernels alone);
31. ``eager_core``    the paddle-API eager core on the card through
                      ``import paddle_tpu_torch as paddle``: a linear
                      regression fitted with ``to_tensor``, ``matmul``,
                      ``.backward()``, ``.grad`` and ``set_value``, a small
                      ``nn.Layer`` MLP trained with AdamW (both losses
                      gated at their targets), and the host us of a
                      grad-recording ``paddle.add`` on 128 x 128 beside a
                      raw ``torch.add`` (best of 5 x 500, the JAX bench's
                      op);
32. ``gpt_train``     GPT at GPT-3 13B widths (hidden 5120, 40 heads of
                      128, FFN 20480, vocab 50304), 3 layers, bf16,
                      4 x 2048 tokens, the eager paddle loop
                      (``CrossEntropyLoss`` over ``logits.reshape([-1,
                      vocab])``, ``backward``, ``AdamW(1e-4,
                      multi_precision=False).step``, ``clear_grad``), 2
                      warm-up and 5 timed steps: tokens/s, step ms, MFU and
                      a profiled step; K1b and K2b launches = layers x
                      steps, all on the TMA design, O2 launches = steps,
                      no fallback, losses finite and falling; then one
                      2-layer step through the kernels against the same
                      step through the plain sdpa (loss and every
                      gradient);
33. ``gpt_fit``       the high-level trainer: ``paddle.Model`` over GPT at
                      the same widths, 3 layers, f32 master weights,
                      ``prepare(AdamW(1e-4, ClipGradByGlobalNorm(1.0)),
                      CrossEntropyLoss, Accuracy(), amp_configs="O1")``,
                      ``fit`` over a ``paddle.io.DataLoader`` (2 worker
                      processes) of seeded token ids, 4 x 2048 tokens a
                      batch, 8 steps, then ``evaluate`` over 3 batches,
                      through ``CapturedStep`` (whole-step CUDA graphs),
                      then again with ``FLAGS_sot_capture=0``: step ms,
                      tokens/s, MFU and a profiled step's idle share both
                      ways, capture seconds, peak memory; gates: 7 of 8
                      train steps and 2 of 3 eval batches captured, one
                      train and one eval graph, no fallback, K1b = 3 x
                      (8 + 3) and dQ = dK/dV = 3 x 8 (all TMA) and O1/O2
                      = their per-step counts x 8, counted through the
                      replays, the replays under
                      ``set_sync_debug_mode("error")``, every loss within
                      1e-2 of the eager run's, the final parameters
                      within 5e-2 relative RMS (bit-equality reported),
                      losses finite and falling;
34. ``gpt_fit_scaled`` 2 layers at GPT-3 6.7B widths through
                      ``Model.train_batch`` with a ``GradScaler(2**15,
                      decr_every_n_nan_or_inf=1)``, the whole scaled
                      iteration captured, an inf in the loss at step 3:
                      that step skipped with the weights bit-equal, the
                      scale halved, O1/O2 counted, no fallback.
35. ``resnet50_train`` THE VISION PATH: ResNet-50 NHWC, ``bfloat16()``
                      (bf16 parameters and batch-norm buffers),
                      ``Momentum(0.1, 0.9)``, ``CrossEntropyLoss``,
                      ``jit.TrainStep``, batch 128 at 224 x 224 x 3, 1000
                      classes, the JAX bench's configuration
                      (``bench.py:258-293``; its int32 labels taken to
                      int64 for the port's loss), the same seeded batch
                      every step: one eager step (cuDNN's algorithm
                      search, ``cudnn.benchmark`` set here, never inside
                      a capture), then the capture, then 20 timed
                      replays under ``set_sync_debug_mode("error")``;
                      gates: 20 captured, one graph, no fallback, losses
                      finite, running statistics moved, no layout copy
                      of an activation (a dispatch count over one eager
                      step); then the same 22 steps through a plain
                      eager loop from the same start: losses, parameters,
                      velocities and running statistics against the
                      replays' (bit-equality reported); img/s, ms a
                      step, a profiled replay's device split (cuDNN
                      convolutions, the fc GEMM, pooling, the
                      optimizer's multi-tensor kernels, the rest:
                      batch norm, ReLU, residual adds, loss, casts), its
                      copy and layout-transform kernels, the idle share,
                      peak memory, and the port's batch norm beside
                      ``torch.nn.functional.batch_norm`` (cuDNN,
                      channels-last) on the 53 layers' shapes;
36. ``resnet_parity`` ResNet-18 at 64 x 64, batch 8, 10 classes, both
                      layouts, f32 (TF32 off) and bf16: the port on the
                      card against the port on the CPU from the same
                      weights (logits, loss, gradients, then parameters,
                      velocities and running statistics after 2 Momentum
                      steps), and NHWC against NCHW logits on the card;
37. ``resnet_fit``    ``paddle.Model(resnet18(num_classes=10))`` with
                      ``Momentum``, ``CrossEntropyLoss`` and
                      ``metric.Accuracy`` over the synthetic ``Cifar10``
                      (``RandomCrop``, ``RandomHorizontalFlip``,
                      ``ToTensor``, ``Normalize``): one epoch of 16
                      batches and an evaluate of 4, captured (strict)
                      and then eager from the same weights and the same
                      draws; gates: 15 train and 3 eval steps captured,
                      one graph each, no fallback, losses within 1e-2;
38. ``to_static_gpt`` GPT at GPT-3 13B widths (3 layers, bf16, eval, ids
                      [4, 2048] from the seed) through
                      ``paddle.jit.to_static``: an eager forward under
                      no-grad is the reference; 12 SOT calls (1 record,
                      1 op-by-op replay, 10 CUDA-graph replays), gates:
                      logits bit-equal to eager (else within 2e-2 (1 +
                      |ref|), said why), one cache entry, no fallback,
                      K1b 3 a call counted through the replays; the same
                      under ``full_graph=True`` (1 eager call, 1 capture,
                      11 replays); a function branching on the logits,
                      called with two id batches in turns: both paths
                      recorded, guard misses and replays counted, results
                      equal to eager, one device-to-host copy in a
                      profiled guarded replay; eager and replay ms (CUDA
                      events), the host us to issue a replay, the
                      logits' clone ms, capture seconds, peak memory;
39. ``jit_export``    ``save_inference_model(aot=True)`` of that GPT
                      (``InputSpec([4, 2048], "int64")``) and of
                      ResNet-50 (NHWC bf16, eval,
                      ``InputSpec([128, 224, 224, 3], "bfloat16")``),
                      each payload's module renamed so that its class
                      cannot be imported; one fresh child process runs
                      ``jit.load`` -> ``TranslatedLayer`` on both on the
                      card; gates: the child imported neither model
                      module, K1b 3 in the child for GPT, logits of both
                      within the bf16 gate of the parent's eager logits,
                      the GPT program under 1 % of its payload's bytes;
                      save seconds, payload and blob bytes, the child's
                      load and forward seconds;
40. ``llama_recompute_train`` Llama-2 7B widths at 8 layers, bf16, 4 x
                      2048, AdamW through the captured TrainStep (2
                      warm-up steps, 5 replays) with and without
                      ``LlamaConfig.recompute`` from the same weights and
                      ids; gates: one graph, no fallback, K1b 16 / 8 a
                      replay (all TMA), K2b 8 / 8, losses and parameters
                      of the two within the train gates; step ms,
                      tokens/s, peak memory above the start both ways;
41. ``llama_generate`` ``LlamaForCausalLM.generate``: f32 (TF32 off), 2
                      layers, batch 4, 128-token prompts, 32 new ids
                      equal to the teacher-forced argmax (and, reported,
                      the paged engine's); bf16, 4 layers, 512-token
                      prompts, 64 new ids: K1b once a layer in the
                      prefill (TMA) and none in the decode steps, each id
                      that parts from the teacher-forced argmax a near-tie
                      (NEAR_TIE of the top logit) over 2 weight seeds x 3
                      prompt seeds, and two planted decode faults (RoPE
                      one position too far; steps that miss the ids
                      generated before them) parting beyond it; prefill
                      ms, decode ms a token, tokens/s;
42. ``fused_encoder_train`` 12 ``FusedTransformerEncoderLayer`` at
                      BERT-base widths (post-norm, GELU, dropout 0.1), a
                      30,522-id embedding and head, bf16, 24 x 512, FFN
                      weights pruned 2:4 and ``asp.decorate(AdamW)``,
                      through the captured TrainStep and then eager from
                      the same weights and key stream; gates: one graph,
                      no fallback, K1a / K2a with K5 12 a replay (TMA),
                      the BERT gates, 2:4 kept; step ms, tokens/s, peak,
                      the device split;
43. ``autograd_core_parity`` f32: PyLayer and jacobian / hessian / vjp /
                      jvp on the card against the CPU, a PyLayer in a
                      captured 2-layer GPT step against its eager loop,
                      ``FLAGS_check_nan_inf`` at stride 8 over a planted
                      inf (the op named, one fetch a stride), and a
                      capture and a replay with the flag on and flags
                      queued from before (nothing fetched in the capture,
                      the queue kept for the flush after);
44. ``warm_bundle_boot`` GPT at 13B widths, 1 layer, through
                      ``Model.fit`` with the warm bundle exported; a
                      child process pre-warms a fresh model from it
                      (parameters, optimizer state, step count and key
                      stream unchanged) and its first fit step is a
                      graph replay; boot seconds against a cold step.

Then the ``nvidia-smi`` name/power line, the ``{"kernels": [...]}`` line
(K3 on the split design at decode with bf16 and with int8 pools, at
the prefill chunk and at the speculative verify window, each with the
first design's time — the decode and prefill-chunk rows also carry
``fleet_launches``, the fleet replicas' launches on that path —, K1b and K2b at the Llama training geometry (with
``gpt_launches``, their launches in the gpt_train phase, and
``fit_launches``, those of gpt_fit's captured run), K1a
and K2a at ERNIE-MoE's, K5 in K1a/K2a at the BERT geometry, K4 in them at the
packed geometry, K6 and K7 at the op bench's geometry, each flash and
K6/K7 row naming the design it timed, its TMA launches and the first
design's time where the TMA design took it, and O1 and O2 at the train
phase's parameters with their launches from the amp_scaler and train
phases and ``fit_launches`` from gpt_fit's captured run; K1b's row also
has ``to_static_launches``, ``full_graph_launches`` and
``jit_export_child_launches`` from to_static_gpt and jit_export,
``recompute_launches`` and ``generate_launches`` from
llama_recompute_train and llama_generate, and
``op_host_us`` / ``op_dispatch_us``, the host cost of the same forward
through the ``paddle_tpu_torch::flash_fwd`` operator)
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
    return {"card": nvidia_smi_line(), "rows": rows,
            "k3_dispatch_host_us": k3_dispatch()}


def k3_dispatch(calls: int = 200):
    """Host microseconds to issue one K3 call at the decode geometry
    (the tile count a device tensor, as the engines pass it), in turns:
    through the ``paddle_tpu_torch::paged_attention`` operator as the
    wrapper calls it, and the launch path alone (``_launch``: the checks
    and the ctypes call, no dispatcher)."""
    import torch
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    case = decode_case()
    q, kp, vp, tables, pos = case["args"]
    nt = torch.full((1,), 128, dtype=torch.int32, device="cuda")
    args = (q, kp, vp, tables, pos, nt, None, None, 16, 1)
    ways = {"operator": lambda: pa.paged_attention_op(*args),
            "direct": lambda: pa._launch(*args)}
    out = {k: [] for k in ways}
    for _ in range(2):
        for k, fn in ways.items():
            out[k].append(host_us(fn, calls))
    return {k: min(v) for k, v in out.items()}


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


def profile_decode(eng, rng, vocab, ctx=1000, steps=10, tries=3):
    """Where a full decode step's time goes: all slots active at ``ctx``
    tokens of history, host wall time per step (synchronized), the
    device time per step by kernel from torch.profiler (CUDA activity
    only, so every event is device work; the window opens after a
    warm-up step) and the step's device-to-host copies. As in
    ``profile_spec``, a profile counts only when its device memcpy
    records match the runtime's memcpy calls one for one (an eager step
    makes ~5,000 records a step and the profiler can drop some at a
    window's ends); one that does not is taken again, at most ``tries``
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    for s in range(eng.max_slots):
        eng.prefill(s, rng.integers(0, vocab, ctx),
                    budget=(tries + 1) * (steps + 1) + 4)
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
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps,
                                       repeat=1)) as prof:
            for i in range(steps + 1):
                eng.step()
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
            elif us:
                by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us
        if calls and copies == calls:
            break
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
            "device_to_host_copies_per_step": d2h / steps,
            "memcpy_records_per_step": copies / steps,
            "profiles_taken": attempt,
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


def group_stats(eng):
    """An engine's CUDA graphs (``capture_jit`` programs): graphs,
    captures and their seconds, replays by program, the K3 launches the
    replays made, fallbacks, failed captures and the shared pool's
    MiB."""
    st = eng._graphs.stats()
    st["pool_mib"] = eng._graphs.pool_bytes() / 2 ** 20
    return st


def graph_stats(eng):
    out = {"target": group_stats(eng)}
    if eng._draft is not None:
        out["draft"] = group_stats(eng._draft)
    return out


def check_graphs(what, stats, programs):
    """Every program in ``programs`` replayed its graph (in some group of
    ``stats``), and no call of any program fell back or lost its
    capture."""
    bad = [f"{who}: {st['fallbacks']} fallbacks, {st['capture_failures']} "
           f"failed captures" for who, st in stats.items()
           if st["fallbacks"] or st["capture_failures"]]
    replays = {}
    for st in stats.values():
        for name, v in st["by_program"].items():
            replays[name] = replays.get(name, 0) + v["replays"]
    bad += [f"{p} replayed no graph" for p in programs
            if replays.get(p, 0) < 1]
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(bad))
    return replays


def k3_replayed(stats, attr, programs=None):
    """K3's launches, by counter ``attr`` (``launches``,
    ``split_launches``, ``mma_launches``), that the graph replays of
    ``programs`` (every program when None) made: each replay adds what
    its capture counted, summed over the groups of ``stats``
    (:func:`graph_stats`)."""
    key = f"paged_attention_kernel.{attr}"
    return sum(v["replayed"].get(key, 0) for st in stats.values()
               for name, v in st["by_program"].items()
               if programs is None or name in programs)


def set_in_replays(k3, row, n):
    """A K3 row's launches made inside graph replays: at least one, and
    no more than the row's launches."""
    if not 0 < n <= k3[row]["launches"]:
        raise AssertionError(
            f"K3 {row}: {n} launches in graph replays for "
            f"{k3[row]['launches']} launches in all")
    k3[row]["launches_in_replays"] = n


def serve_run(model, prompts, budgets, capture):
    """The serve phase's engine (8 slots x 2048) and requests, with
    ``FLAGS_sot_capture`` at ``capture``: the run's numbers, K3 counts by
    path (gated), the decode profile at 8 x 1000 tokens, and the
    engine."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    from paddle_tpu_torch.serving import (GenerationServer,
                                          PagedLlamaDecodeEngine)
    V = model.config.vocab_size
    set_flags({"FLAGS_sot_capture": capture})
    try:
        eng = PagedLlamaDecodeEngine(model, max_slots=8, max_seq=2048)
        hits0 = eng._kv.prefix_hits
        srv = GenerationServer(eng)
        pak.launches = pak.split_launches = pak.mma_launches = 0  # start
        reqs, wall = serve_requests(srv, prompts, budgets)
        got = (pak.launches, pak.split_launches,  # ... and are read here
               pak.mma_launches)
        in_run = {"target": eng._graphs.stats()}   # with the counts
        if not srv.shutdown(drain=True, timeout=60):
            raise RuntimeError("server did not drain")
        check_budget(reqs, V)
        steps = srv.steps_run
        chunks, mma_chunks = serve_chunks(eng, reqs)
        what = "the captured bf16 engine" if capture else "the eager one"
        check_serve_launches(what, eng.n_layers, steps, chunks, mma_chunks,
                             *got)
        if eng._kv.prefix_hits - hits0 < 1 \
                or reqs[5]["prefix_hit_tokens"] < 256:
            raise AssertionError("the shared prefix did not hit the radix "
                                 "tree")
        run = {"streams": [list(r["out"]) for r in reqs], "steps": steps,
               "chunks": chunks, "mma_chunks": mma_chunks, "launches": got,
               "replayed_launches": in_run["target"]["replayed_launches"],
               "replays_in_run": {k: v["replays"] for k, v in
                                  in_run["target"]["by_program"].items()},
               "k3_in_replays": {a: k3_replayed(in_run, a) for a in (
                   "launches", "split_launches", "mma_launches")},
               **serve_numbers(reqs, wall)}
        if capture:
            # two block-aligned full-prefix hits: the copy-on-write
            # program runs op by op and captures, then replays
            for slot in (0, 1):
                eng.prefill(slot, prompts[0][:256], budget=2)
                eng.release(slot)
        run["decode_profile"] = profile_decode(
            eng, np.random.default_rng(SEED + 3), V)
        run["graphs"] = graph_stats(eng)
        prof = run["decode_profile"]
        d2h = prof["device_to_host_copies_per_step"]
        if d2h != 1:
            raise AssertionError(
                f"{what}: a decode step made {d2h} device-to-host copies "
                f"in the last of {prof['profiles_taken']} profiles "
                f"({prof['memcpy_records_per_step']} memcpy records a "
                f"step), expected 1")
        return run, eng
    finally:
        set_flags({"FLAGS_sot_capture": True})


def phase_serve(state, k3):
    """Llama-2 7B widths, 32 layers, bf16, 8 slots x 2048: the 12
    requests once on the engine's CUDA graphs (the main path) and once
    with every program op by op (``FLAGS_sot_capture=0``), each run's
    numbers beside the other's; the captured streams must equal the
    eager ones or part at near-ties of the plain logits. Then the
    int8-KV engine (4 layers)."""
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
    V = cfg.vocab_size
    prompts, budgets, rng = serve_workload(V)
    # the process's first use of the serving kernels (~10 s on the first
    # prompt chunk in development runs) lands on a throwaway engine, so
    # that neither run of the comparison pays it
    t0 = time.perf_counter()
    warm = PagedLlamaDecodeEngine(model, max_slots=8, max_seq=2048)
    for p in (prompts[1][:100], np.asarray(prompts[2])):
        warm.generate(p, 4)
    del warm
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cap, eng = serve_run(model, prompts, budgets, capture=True)
    replays = check_graphs("the captured serve run", cap["graphs"],
                           ("serving.paged_decode", "serving.paged_prefill",
                            "serving.prefix_cow"))
    launches, split_launches, mma_launches = cap["launches"]
    steps, chunks = cap["steps"], cap["chunks"]
    state["serve"] = {"prompts": prompts, "budgets": budgets,
                      "streams": cap["streams"], "steps": steps,
                      "chunks": chunks,
                      **{k: cap[k] for k in (
                          "decode_tokens_per_s", "ttft_median_s",
                          "ttft_max_s", "wall_s")}}
    state["launches"] = launches
    # each row's count as the wrapper counted it, by path (graph replays
    # included): the decode steps ran the CUDA-core kernel, the prefill
    # chunks the tensor cores
    k3["decode_bf16"]["launches"] = split_launches - mma_launches
    k3["prefill_chunk"]["launches"] = mma_launches
    # ... and of those, the launches that graph replays made (what each
    # replay's capture counted, by path)
    rep = cap["k3_in_replays"]
    set_in_replays(k3, "decode_bf16",
                   rep["split_launches"] - rep["mma_launches"])
    set_in_replays(k3, "prefill_chunk", rep["mma_launches"])
    state["layers"] = eng.n_layers
    del eng
    torch.cuda.empty_cache()
    eager, eng = serve_run(model, prompts, budgets, capture=False)
    out = {"card": nvidia_smi_line(), "model": "llama2-7b-width",
           "layers": eng.n_layers,
           "hidden": cfg.hidden_size, "dtype": "bfloat16",
           "init_seconds": init_s, "first_use_seconds": warm_s,
           "requests": len(prompts),
           "prompt_lengths": [len(p) for p in prompts],
           "budgets": budgets, **{k: v for k, v in cap.items()
                                  if k not in ("streams", "launches")},
           "replays_by_program": replays,
           "kernel_launches": launches,
           "split_launches": split_launches,
           "mma_launches": mma_launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "eager": {k: v for k, v in eager.items()
                     if k not in ("streams", "graphs")}}
    del eng
    torch.cuda.empty_cache()
    # the captured streams against the eager ones: where one parts, the
    # plain logits there must be a near-tie
    eng1 = PagedLlamaDecodeEngine(model, max_slots=1, max_seq=2048)
    parted = []
    for i, (want, got_s) in enumerate(zip(eager["streams"], cap["streams"])):
        j = next((j for j, (a, b) in enumerate(zip(want, got_s))
                  if a != b), None)
        if j is not None:
            parted.append({"request": i, **near_tie(
                eng1, prompts[i], want, j, got_s[j])})
    del eng1
    torch.cuda.empty_cache()
    out["streams_equal_eager"] = len(prompts) - len(parted)
    out["streams_parted_at_near_ties"] = parted
    if not all(p["ok"] for p in parted):
        emit({"phase": "serve", "failed": parted})
        raise AssertionError("a captured stream parted from the eager one "
                             "where the plain logits are no near-tie")
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
    g8 = graph_stats(eng8)
    check_graphs("the int8-KV engine", g8, ("serving.paged_decode",))
    k3["decode_int8"]["launches"] = split8 - mma8
    set_in_replays(k3, "decode_int8",
                   k3_replayed(g8, "split_launches")
                   - k3_replayed(g8, "mma_launches"))
    out["int8_kv"] = {"layers": 4, "requests": 2, "steps": steps8,
                      "prefill_chunks": chunks8, "kernel_launches": n8,
                      "split_launches": split8, "mma_launches": mma8,
                      "graphs": g8}
    return out


def serve_chunks(eng, reqs):
    """The prefill chunks a serve run ran, and of those the ones whose
    rows (the chunk's bucket: its program pads it) ``split_plan`` sends
    to the tensor cores."""
    import torch
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    kvh, mb = eng.cfg.num_key_value_heads, eng._kv.block_tables.shape[1]
    sms = pa._sms(torch.device("cuda", torch.cuda.current_device()))
    chunks = mma = 0
    for r in reqs:
        left = len(r["prompt"]) - r["prefix_hit_tokens"]
        while left > 0:
            c = min(eng.prefill_chunk_len, left)
            b = min(eng._bucket(c), eng.prefill_chunk_len)
            g = pa.split_plan(b, eng.n_rep, 1, kvh, eng.head_dim,
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
    calls and, for a draft, the target's mirrored ones): the chunk's
    bucket, the rows its program gives K3."""
    rows = []
    orig = eng.prefill_chunk

    def chunk(slot):
        st = eng._prefill_state[slot]
        limit = eng.prefill_chunk_len if eng._chunk_cap is None \
            else max(8, min(eng.prefill_chunk_len, eng._chunk_cap))
        c = min(limit, len(st["ids"]) - st["next"])
        rows.append(min(eng._bucket(c), eng.prefill_chunk_len))
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
    # the draft's pool stores: its blocks and their sink block
    pool_bytes = sum(t.numel() * t.element_size()
                     for ts in draft._kv_store.values() for t in ts)
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
    graphs = graph_stats(eng)
    replays = check_graphs("the speculative engine", graphs, (
        "serving.spec_draft", "serving.spec_verify",
        "serving.paged_prefill"))
    k3["spec_verify_t5"]["launches"] = paths["verify_launches"]
    set_in_replays(k3, "spec_verify_t5",
                   k3_replayed({"target": graphs["target"]}, "launches",
                               ("serving.spec_verify",)))
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
           "kernel_launches": got[0], "mma_launches": got[2], **paths,
           "graphs": graphs, "replays_by_program": replays}
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
    graphs = graph_stats(eng)
    replays = check_graphs("the full-accept engine", graphs, (
        "serving.spec_draft", "serving.spec_verify"))
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
           **serve_numbers(reqs, wall), **paths,
           "graphs": graphs, "replays_by_program": replays}
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
    rises, the copies stay installed, the streams go on). Then a swap to
    other weights on an engine whose graphs hold the first weights: its
    next requests must give a fresh engine's streams on the new weights
    (a graph still reading the old tensors would give the old ones)."""
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
    del srv, eng, bad
    torch.cuda.empty_cache()
    # a swap to DIFFERENT weights under graphs: the engine's graphs hold
    # the old weights' addresses, so its next calls must capture anew;
    # the streams after the swap must equal a fresh engine's on the new
    # weights (and differ from the old weights' streams)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    other = {k: (v.float() + 0.5 * v.float().std() * torch.randn(
        v.shape, generator=g, device=v.device)).to(v.dtype)
        for k, v in copy.items()}
    del copy
    eng = PagedLlamaDecodeEngine(model, **geo)
    srv = GenerationServer(eng)
    serve_requests(srv, prompts[:2], budgets[:2])
    before = eng._graphs.stats()
    swap_s = srv.swap_weights(other, timeout=60)["seconds"]
    after, _ = serve_requests(srv, prompts[2:], budgets[2:])
    if not srv.shutdown(drain=True, timeout=60):
        raise RuntimeError("the second hot_swap server did not drain")
    st = graph_stats(eng)
    del srv, eng
    fresh_eng = PagedLlamaDecodeEngine(model, **geo)
    fresh_eng.swap_weights(other)          # before its first program call
    fresh_srv = GenerationServer(fresh_eng)
    fresh, _ = serve_requests(fresh_srv, prompts[2:], budgets[2:])
    if not fresh_srv.shutdown(drain=True, timeout=60):
        raise RuntimeError("the fresh hot_swap server did not drain")
    del fresh_srv, fresh_eng, other
    torch.cuda.empty_cache()
    out["swap_to_other_weights"] = {
        "swap_seconds": swap_s,
        "captures_before_swap": before["captures"],
        "captures_after_swap": st["target"]["captures"]
        - before["captures"],
        "graphs": st,
        "streams_equal_fresh_engine": [
            list(a["out"]) == list(b["out"]) for a, b in zip(after, fresh)],
        "streams_differ_from_old_weights": [
            list(a["out"]) != list(b["out"])
            for a, b in zip(after, ref[2:])]}
    sw = out["swap_to_other_weights"]
    try:
        check_graphs("the swapped engine", st, ("serving.paged_decode",))
        graphs_ok = True
    except AssertionError as e:
        sw["graphs_failed"] = str(e)
        graphs_ok = False
    if not (all(streams_equal) and res["in_flight"] >= 1 and rejected == 1
            and in_flight >= 1 and out["copies_installed"]
            and out["weight_swaps"] == 1
            and all(sw["streams_equal_fresh_engine"])
            and any(sw["streams_differ_from_old_weights"])
            and sw["captures_after_swap"] > 0 and graphs_ok):
        emit({"phase": "hot_swap", "failed": out})
        raise AssertionError("hot swap: streams, swap counts, the "
                             "installed weights or the graphs after a "
                             "swap are not as required")
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
           "graphs": graph_stats(eng),
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
        "the restarted loops replayed the graphs, none re-captured":
        out["graphs"]["target"]["captures"]
        == out["graphs"]["target"]["graphs"],
    }
    try:
        out["replays_by_program"] = check_graphs(
            "the supervised engine", out["graphs"],
            ("serving.paged_decode", "serving.paged_prefill"))
    except AssertionError as e:
        checks["graphs: " + str(e)] = False
    out["failed_gates"] = [k for k, ok in checks.items() if not ok]
    if out["failed_gates"]:
        emit({"phase": "serve_supervised", "failed": out})
        raise AssertionError("serve_supervised: " +
                             "; ".join(out["failed_gates"]))
    return out


def phase_serve_export(state):
    """``export_decode`` of the paged engine at the serve phase's widths
    and depth (32 layers, 8 slots x 2048, three slots prefilled): the
    export's seconds and the program's bytes (gated below 1 % of the
    weights: weights and pools are inputs), the program loaded from its
    bytes, one step through it (K3 through the operator, once a layer)
    against the live step: tokens and pool writes equal."""
    import io
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    from paddle_tpu_torch.serving import PagedLlamaDecodeEngine
    model = state["model"]
    V = model.config.vocab_size
    eng = PagedLlamaDecodeEngine(model, max_slots=8, max_seq=2048)
    rng = np.random.default_rng(SEED + 5)
    for slot, n in ((0, 300), (3, 64), (5, 700)):
        eng.prefill(slot, rng.integers(0, V, n), budget=8)
    eng._extend_tables()        # the step's tables, mapped before it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = eng.export_decode()
    export_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in {id(t): t for t in pytree.tree_leaves(
                           eng.params)}.values())
    t0 = time.perf_counter()
    ep = torch.export.load(io.BytesIO(blob))
    load_s = time.perf_counter() - t0
    k3_nodes = sum(1 for n in ep.graph.nodes if n.op == "call_function"
                   and "paddle_tpu_torch.paged_attention" in str(n.target))
    args = list(eng._export_args())
    args[1] = pytree.tree_map(lambda t: t.clone(), args[1])
    before = pak.launches
    t0 = time.perf_counter()
    nxt = ep.module()(*args)
    torch.cuda.synchronize()
    program_step_s = time.perf_counter() - t0
    launched = pak.launches - before
    want = eng.step()
    got = nxt.cpu().numpy()
    pool_diff = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(pytree.tree_leaves(args[1]),
                                    pytree.tree_leaves(eng._kv_store)))
    out = {"card": nvidia_smi_line(), "layers": eng.n_layers,
           "slots": eng.max_slots, "max_seq": eng.max_seq,
           "export_seconds": export_s, "load_seconds": load_s,
           "program_bytes": len(blob), "weight_bytes": weight_bytes,
           "program_share_of_weights": len(blob) / weight_bytes,
           "k3_operator_nodes": k3_nodes, "k3_launches_one_step": launched,
           "program_step_seconds": program_step_s,
           "tokens_equal_live": got.tolist() == want.tolist(),
           "pool_max_abs_diff": pool_diff,
           "state_dict_entries": len(ep.state_dict),
           "constants": len(ep.constants)}
    del ep, args, eng, nxt
    torch.cuda.empty_cache()
    checks = {"program < 1 % of the weights": len(blob) < 0.01 * weight_bytes,
              "no weights in the program": out["state_dict_entries"] == 0
              and out["constants"] == 0,
              "K3 as the operator, once a layer": k3_nodes == launched
              == out["layers"],
              "tokens equal the live step": out["tokens_equal_live"],
              "pool writes equal the live step": pool_diff == 0.0}
    out["failed_gates"] = [k for k, ok in checks.items() if not ok]
    if out["failed_gates"]:
        emit({"phase": "serve_export", "failed": out})
        raise AssertionError("serve_export: " +
                             "; ".join(out["failed_gates"]))
    return out


def plain_s8(qh, w_q, budget=2 ** 28):
    """The plain int32 product ``qh [M, K] x w_q[N, K]^T``: integer
    multiply and sum, as many output columns at a time as keep the
    products within ``budget`` bytes."""
    import torch
    a = qh.to(torch.int32)
    cols = max(1, budget // (4 * a.shape[0] * a.shape[1]))
    return torch.cat([(a[:, None, :] * w_q[i:i + cols].to(torch.int32)[
        None]).sum(dim=-1, dtype=torch.int32)
        for i in range(0, w_q.shape[0], cols)], dim=1)


def phase_serve_int8(state):
    """``int8=True`` at the serve phase's widths, 4 layers (as the
    int8-KV engine), 8 slots: the s8 accumulators of every projection
    of layer 0 and of the head (``_s8_matmul``, ``torch._int_mm`` with
    the row padding) against the plain int32 product on the card, for a
    decode batch (8 rows) and a prefill bucket (64 rows); then four of
    the serve phase's prompts through ``GenerationServer`` one after
    another, twice on fresh engines: the streams must be equal (the
    dynamic per-tensor activation scales see the same batches)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention_kernel as pak
    from paddle_tpu_torch.serving import (GenerationServer,
                                          PagedLlamaDecodeEngine,
                                          _s8_matmul)
    model, plain = state["model"], state["serve"]
    geo = dict(max_slots=8, max_seq=2048, num_layers=4, int8=True)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = PagedLlamaDecodeEngine(model, **geo)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    int8_bytes = torch.cuda.memory_allocated() - mem0
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    acc_checks = []
    lp = eng.params["layers"][0]
    for name, w in list(lp.items()) + [("head", eng.params["head"])]:
        if not isinstance(w, tuple):
            continue
        for rows in (8, 64):
            qh = torch.randint(-127, 128, (rows, w[0].shape[1]),
                               generator=g, device="cuda",
                               dtype=torch.int8)
            got = _s8_matmul(qh, w[0])
            acc_checks.append({"weight": name, "rows": rows,
                               "equal": bool(torch.equal(
                                   got, plain_s8(qh, w[0])))})
    prompts = plain["prompts"][:4]
    budgets = [32] * 4
    runs = []
    for run in range(2):
        if run:
            eng = PagedLlamaDecodeEngine(model, **geo)
        srv = GenerationServer(eng)
        pak.launches = 0
        t0 = time.perf_counter()
        streams = [srv.generate(p, n, timeout=300)
                   for p, n in zip(prompts, budgets)]
        wall = time.perf_counter() - t0
        if not srv.shutdown(drain=True, timeout=60):
            raise RuntimeError("int8 server did not drain")
        runs.append({"streams": streams, "wall_s": wall,
                     "steps": srv.steps_run, "k3_launches": pak.launches,
                     "graphs": graph_stats(eng)})
        del srv, eng
        torch.cuda.empty_cache()
    out = {"card": nvidia_smi_line(), "layers": 4, "slots": 8,
           "quantize_seconds": quantize_s, "engine_bytes": int8_bytes,
           "accumulators": acc_checks,
           "runs": [{k: v for k, v in r.items() if k != "streams"}
                    for r in runs],
           "tokens": sum(len(x) for x in runs[0]["streams"]),
           "streams_stable": runs[0]["streams"] == runs[1]["streams"]}
    checks = {"s8 accumulators equal the plain int32 product": all(
        c["equal"] for c in acc_checks) and len(acc_checks) == 16,
              "streams stable across two runs": out["streams_stable"],
              "exact budgets": all(len(x) == n for x, n in zip(
                  runs[0]["streams"], budgets))}
    try:
        out["replays_by_program"] = check_graphs(
            "the int8 engine", runs[1]["graphs"],
            ("serving.paged_decode", "serving.paged_prefill"))
    except AssertionError as e:
        checks["graphs: " + str(e)] = False
    out["failed_gates"] = [k for k, ok in checks.items() if not ok]
    if out["failed_gates"]:
        emit({"phase": "serve_int8", "failed": out})
        raise AssertionError("serve_int8: " + "; ".join(out["failed_gates"]))
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

FLEET_LAYERS = 8        # Llama-2 7B widths, depth 32 -> 8 (run time)
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
        replies = [h.call({"op": "stats"}) for h in router.replicas]
        k3s = [r["k3"] for r in replies]
        graphs = [r.get("graphs") or {} for r in replies]
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
        "router": stats, "replica_k3": k3s, "replica_graphs": graphs,
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
        "every replica served from graphs, no fallback": not kernel or all(
            g.get("replays", 0) > 0 and g.get("fallbacks", 1) == 0
            and g.get("capture_failures", 1) == 0 for g in graphs),
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
    key = fa._key_ptr(seed, q.device, "flash_general") if thresh else None
    rng = fa._seg_ranges(seg) if seg is not None else None
    segs = (seg.data_ptr(), seg.stride(0), rng.data_ptr()) \
        if seg is not None else (None, 0, None)

    def tail():  # sizes, causal, scale, bf16, the segments, the dropout
        return (B, L, k.shape[1], H, D, int(causal), 1.0 / math.sqrt(D), 1,
                *segs, key, thresh, inv,
                torch.cuda.current_stream().cuda_stream)

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
        if name == "flash_attention_fwd":
            # the same launch through the paddle_tpu_torch::flash_fwd
            # operator (FlashAttention.forward's route): what the
            # dispatcher adds to the wrapper's host cost
            plan = kw.get("seg")
            r["op_host_us"] = host_us(lambda: fa.flash_fwd_op(
                q, k, v, causal, None, float(kw.get("dropout_p", 0.0)),
                kw.get("seed"), None if plan is None else plan.ids,
                None if plan is None else plan.ranges))
            r["op_dispatch_us"] = r["op_host_us"] - r["wrapper_host_us"]
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
    for key in ("op_host_us", "op_dispatch_us"):
        results["flash_attention_fwd" + suffix][key] = \
            table["flash_attention_fwd"].get(key)


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


def train_group(kernel: str) -> str:
    """The training phases' kernel groups: "optimizer" is the fused
    step's multi_tensor kernels."""
    kl = kernel.lower()
    if "multi_tensor" in kl:
        return "optimizer"
    if "flash_fwd" in kl:
        return "flash_fwd"
    if "flash_bwd_dq" in kl:
        return "flash_dq"
    if "flash_bwd_dkv" in kl:
        return "flash_dkv"
    if any(tag in kl for tag in ("gemm", "cutlass", "nvjet", "sm90")):
        return "gemm"
    return "other"


def profile_train_step(step, ids, classify=train_group,
                       groups=("flash_fwd", "flash_dq", "flash_dkv",
                               "gemm", "optimizer", "other"), named=()):
    """Device time of one train step by kernel group (torch.profiler,
    CUDA activity only; ``classify`` names a kernel's group) beside its
    wall time; the kernels of the groups in ``named`` listed with their
    launches and ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(*ids)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, calls = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    totals = dict.fromkeys(groups, 0.0)
    launches = dict.fromkeys(groups, 0)
    for key, us in by_kernel.items():
        totals[classify(key)] += us
        launches[classify(key)] += calls[key]
    device_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms or None,
            "device_idle_share": (1 - device_ms / wall_ms)
            if device_ms else None,
            "groups_ms": {k: v / 1e3 for k, v in totals.items()},
            "group_launches": launches,
            "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top],
            "named_kernels": {g: [[k[:120], calls[k], us / 1e3]
                                  for k, us in by_kernel.items()
                                  if classify(k) == g] for g in named}}


# TrainStep's captured steps against a plain eager loop with the same
# seed, weights and batches: every loss within CAPTURE_LOSS_RTOL
# relative, the final parameters within CAPTURE_PARAM_RMS relative RMS
CAPTURE_LOSS_RTOL = 1e-3
CAPTURE_PARAM_RMS = 5e-2


def fresh_peak():
    """Collect what earlier phases left to the garbage collector, empty
    the allocator's cache and reset the peak, so that a peak counts what
    the run after it holds; returns the bytes allocated at the reset."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def param_copies(model):
    """Copies of the model's parameters (the torch tensors: a paddle
    Layer's ``parameters()`` gives its Parameter wrappers)."""
    import torch
    return [p.detach().clone() for p in torch.nn.Module.parameters(model)]


def timed_replays(step, batch, n, on_step=None):
    """``n`` timed TrainStep calls, synchronised before and after, under
    torch.cuda.set_sync_debug_mode("error") (a host sync in a replay
    raises): (lazy losses, wall seconds, captured steps among them)."""
    import torch
    torch.cuda.synchronize()
    c0 = step.stats["captured_steps"]
    losses = []
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            losses.append(step(*batch))
            if on_step is not None:
                on_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0, \
        step.stats["captured_steps"] - c0


def check_captured(phase, step, captured, steps):
    """The timed steps were graph replays: as many as timed steps, one
    train graph, no fallback (no "rng": dropout draws device keys)."""
    got = {"captured_timed_steps": captured, "graphs": step._step.graphs(),
           "fallbacks": dict(step.stats["fallbacks"])}
    want = {"captured_timed_steps": steps, "graphs": {"train": 1},
            "fallbacks": {}}
    if got != want:
        raise AssertionError(f"{phase}: TrainStep capture {got} != {want}")
    return {**got, "eager_steps": step.stats["eager_steps"],
            "compiles": step.stats["compiles"],
            "capture_seconds": step.stats["capture_seconds"]}


def eager_reference(model, start, make_opt, loss_fn, batch, warmup, steps):
    """The captured run's steps through a plain eager loop: the parameters
    put back to ``start`` in place, a fresh optimizer, the port's stream
    reseeded with SEED (as before the captured run); each step forward,
    the f32 loss, backward, a zero gradient for a parameter the loss does
    not reach (as TrainStep gives it), ``opt.step()``, ``clear_grad()``.
    Returns the losses, the wall seconds of the last ``steps`` steps, the
    peak memory and the stream's state after."""
    import torch
    from paddle_tpu_torch.core import random as trandom
    with torch.no_grad():
        for p, s0 in zip(torch.nn.Module.parameters(model), start):
            p.copy_(s0)
    opt = make_opt()
    model.train()
    trandom.seed(SEED)
    ins, lbls = batch[:-1], batch[-1:]

    def one():
        loss = loss_fn(model(*ins), *lbls).float()
        loss.backward()
        for p in opt._parameter_list:
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        opt.clear_grad()
        return loss.detach()
    base = fresh_peak()
    losses = [one() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [one() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"losses": [float(x) for x in losses], "wall_s": wall,
           "step_ms": wall / steps * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "mem_at_start_gb": base / 2 ** 30,
           "rng_state": list(trandom.get_rng_state())}
    del opt
    return out


def capture_vs_eager(phase, cap_losses, cap_params, cap_state, model, eager,
                     tokens, steps, loss_rtol=CAPTURE_LOSS_RTOL,
                     param_rms=CAPTURE_PARAM_RMS):
    """Captured losses and final parameters against the eager loop's
    (within ``loss_rtol`` and ``param_rms``); bit-equality reported; the
    stream's state after both runs equal."""
    import torch
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(cap_losses, eager["losses"])]
    num = den = 0.0
    worst = 0.0
    equal = True
    for a, b in zip(cap_params, torch.nn.Module.parameters(model)):
        b = b.detach()
        d = (a.float() - b.float()).square().sum()
        r = b.float().square().sum()
        num, den = num + float(d), den + float(r)
        if float(r) > 0:
            worst = max(worst, math.sqrt(float(d) / float(r)))
        equal = equal and torch.equal(a, b)
    out = {"eager_losses": eager["losses"],
           "eager_step_ms": eager["step_ms"],
           "eager_tokens_per_s": tokens * steps / eager["wall_s"],
           "eager_peak_mem_gb": eager["peak_mem_gb"],
           "eager_mem_at_start_gb": eager["mem_at_start_gb"],
           "loss_rel_err_max": max(rel), "loss_rtol": loss_rtol,
           "param_rel_rms": math.sqrt(num / max(den, 1e-30)),
           "param_rel_rms_worst_tensor": worst,
           "param_rms_tol": param_rms,
           "losses_bit_equal": cap_losses == eager["losses"],
           "params_bit_equal": equal,
           "rng_state_captured": list(cap_state),
           "rng_state_eager": eager["rng_state"]}
    out["ok"] = (out["loss_rel_err_max"] <= loss_rtol
                 and out["param_rel_rms"] <= param_rms
                 and out["rng_state_captured"] == out["rng_state_eager"])
    if not out["ok"]:
        emit({"phase": phase, "failed": out})
        raise AssertionError(f"{phase}: the captured steps disagree with "
                             f"the eager loop")
    return out


def phase_train(results):
    import torch
    from paddle_tpu_torch.core import random as trandom
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

    def make_opt():
        return AdamW(learning_rate=TRAIN["lr"],
                     parameters=model.named_parameters(),
                     multi_precision=False)
    opt = make_opt()
    crit = LlamaPretrainingCriterion()
    step = TrainStep(model, crit, opt)
    ids = train_ids(cfg.vocab_size)
    start = param_copies(model)
    trandom.seed(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem_start = fresh_peak()
    # the first step runs eager (builds the kernels and the optimizer
    # state), the second is captured and replayed, the timed ones replay
    losses = [step(ids, ids) for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = kern.tma_launches = 0    # the counts start here
    reset_optimizer_counts()
    timed, wall, captured = timed_replays(step, (ids, ids), TRAIN["steps"])
    losses += timed
    launches = [kern.launches for kern in kernels]   # ... and are read here
    tma = [kern.tma_launches for kern in kernels]
    opt_counts = check_optimizer_launches("train", opt, TRAIN["steps"],
                                          False)
    capture = check_captured("train", step, captured, TRAIN["steps"])
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
    cap_params, cap_state = param_copies(model), trandom.get_rng_state()
    both = optimizer_both_ways(step, (ids, ids))
    prof = both["fused"]
    del step, opt
    torch.cuda.empty_cache()
    eager = eager_reference(model, start, make_opt, crit, (ids, ids),
                            TRAIN["warmup"], TRAIN["steps"])
    vs = capture_vs_eager("train", loss_values, cap_params, cap_state,
                          model, eager, tokens, TRAIN["steps"])
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
           "peak_mem_gb": peak / 2 ** 30,
           "mem_at_start_gb": mem_start / 2 ** 30, "capture": capture,
           "vs_eager": vs, "profile_one_step": prof,
           "profile_one_step_loop": both["loop"],
           # the profiler's own cost lands in the profiled step's wall:
           # the idle share against the timed steps' mean
           "device_idle_share_of_timed_step":
               1 - prof["device_ms"] / (wall / TRAIN["steps"] * 1e3)
               if prof["device_ms"] else None}
    del model, start, cap_params
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
# the paddle-API eager core and GPT on it
# ---------------------------------------------------------------------------

# BASELINE workload 4 as bench.py:873-890 builds it: GPT-3 13B widths,
# depth cut from 40 to 3 layers
GPT = dict(batch=4, seq=2048, layers=3, warmup=2, steps=5, lr=1e-4)
GPT_WIDTHS = dict(vocab_size=50304, hidden_size=5120, num_attention_heads=40,
                  intermediate_size=20480, max_position_embeddings=2048)
EAGER_REG_LOSS = 1e-6        # the regression's final mean squared error
EAGER_REG_W_ERR = 1e-3       # ... and its weights against the true ones
EAGER_MLP_DROP = 0.1         # the MLP's final loss / its first loss


def phase_eager_core():
    """The verify skill's eager-core and nn/optimizer recipes on the
    card, through the paddle API, and the host cost of one op."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    paddle.seed(SEED)
    rng = np.random.default_rng(SEED)
    x_np = rng.standard_normal((256, 4)).astype(np.float32)
    w_true = np.float32([[1.5], [-2.0], [0.5], [3.0]])
    x = paddle.to_tensor(x_np)
    y = paddle.to_tensor(x_np @ w_true + 0.25)
    w = paddle.to_tensor(np.zeros((4, 1), np.float32), stop_gradient=False)
    b = paddle.to_tensor(np.zeros((1,), np.float32), stop_gradient=False)
    assert x.place == paddle.CUDAPlace(torch.cuda.current_device())
    for _ in range(500):
        loss = ((paddle.matmul(x, w) + b - y) ** 2).mean()
        loss.backward()
        w.set_value(w - 0.1 * w.grad)
        b.set_value(b - 0.1 * b.grad)
        w.clear_grad()
        b.clear_grad()
    reg_loss = float(((paddle.matmul(x, w) + b - y) ** 2).mean())
    w_err = float(np.abs(w.numpy() - w_true).max())
    b_err = abs(float(b) - 0.25)

    class MLP(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = paddle.nn.Linear(8, 64)
            self.fc2 = paddle.nn.Linear(64, 1)

        def forward(self, h):
            return self.fc2(paddle.nn.functional.gelu(self.fc1(h)))

    mlp = MLP()
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=mlp.parameters())
    xm = paddle.to_tensor(rng.standard_normal((512, 8)).astype(np.float32))
    ym = paddle.sin(xm.sum(axis=1, keepdim=True))
    mlp_losses = []
    for _ in range(300):
        loss = ((mlp(xm) - ym) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        mlp_losses.append(float(loss))
    a = paddle.to_tensor(rng.standard_normal((128, 128)).astype(np.float32),
                         stop_gradient=False)
    c = paddle.to_tensor(np.ones((128, 128), np.float32))

    def best_us(fn, n=500, reps=5):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
        return best * 1e6

    op_us = best_us(lambda: paddle.add(a, c))
    raw_us = best_us(lambda: torch.add(a._t, c._t))
    out = {"card": nvidia_smi_line(),
           "regression": {"steps": 500, "loss": reg_loss, "w_max_err": w_err,
                          "b_err": b_err, "loss_limit": EAGER_REG_LOSS,
                          "w_err_limit": EAGER_REG_W_ERR},
           "mlp": {"steps": 300, "first_loss": mlp_losses[0],
                   "last_loss": mlp_losses[-1],
                   "limit": f"last < {EAGER_MLP_DROP} x first"},
           "op_host_us": {"paddle.add (grad-recording, 128x128 f32)": op_us,
                          "torch.add (raw)": raw_us,
                          "wrapper_us": op_us - raw_us}}
    ok = (reg_loss < EAGER_REG_LOSS and w_err < EAGER_REG_W_ERR
          and b_err < EAGER_REG_W_ERR
          and mlp_losses[-1] < EAGER_MLP_DROP * mlp_losses[0])
    if not ok:
        emit({"phase": "eager_core", "failed": out})
        raise AssertionError("the eager core did not reach its targets")
    return out


def gpt_model(layers, flash=True, widths=None, device="cuda"):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    paddle.set_device("gpu" if device == "cuda" else device)
    paddle.seed(SEED)
    model = GPTForCausalLM(GPTConfig(num_hidden_layers=layers,
                                     use_flash_attention=flash,
                                     **(widths or GPT_WIDTHS)))
    model.bfloat16()
    return model


def gpt_ids(vocab, batch=None, seq=None, seed=SEED):
    import numpy as np
    import paddle_tpu_torch as paddle
    rng = np.random.default_rng(seed)
    return paddle.to_tensor(rng.integers(
        0, vocab, (batch or GPT["batch"], seq or GPT["seq"])))


def gpt_loss(model, crit, ids):
    vocab = model.config.vocab_size
    return crit(model(ids).reshape([-1, vocab]), ids.reshape([-1]))


def phase_gpt_train(results):
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    t0 = time.perf_counter()
    model = gpt_model(GPT["layers"])
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    opt = paddle.optimizer.AdamW(learning_rate=GPT["lr"],
                                 parameters=model.parameters(),
                                 multi_precision=False)
    crit = paddle.nn.CrossEntropyLoss()
    ids = gpt_ids(cfg.vocab_size)

    def step():
        loss = gpt_loss(model, crit, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(GPT["warmup"])]
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = kern.tma_launches = 0    # the counts start here
    reset_optimizer_counts()
    t0 = time.perf_counter()
    for _ in range(GPT["steps"]):
        losses.append(step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [kern.launches for kern in kernels]   # ... and are read here
    tma = [kern.tma_launches for kern in kernels]
    opt_counts = check_optimizer_launches("gpt_train", opt, GPT["steps"],
                                          False)
    expected = GPT["layers"] * GPT["steps"]
    if launches != [expected] * 3 or tma != [expected] * 3:
        raise AssertionError(
            f"gpt_train: flash launches (fwd, dq, dkv) {launches}, of them "
            f"through the TMA design {tma}, != layers x timed steps = "
            f"{GPT['layers']} x {GPT['steps']} each")
    for kern, n in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"), launches):
        results[kern]["gpt_launches"] = n
    loss_values = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_values):
        raise AssertionError(f"gpt_train: non-finite loss: {loss_values}")
    if not loss_values[-1] < loss_values[0]:
        raise AssertionError(f"gpt_train: the loss did not fall: "
                             f"{loss_values}")
    peak = torch.cuda.max_memory_allocated()
    tokens = GPT["batch"] * GPT["seq"]
    tok_s = tokens * GPT["steps"] / wall
    heads = cfg.num_attention_heads
    hd = cfg.hidden_size // heads
    # attention products per token, forward + backward: 3 x (QK^T + PV)
    # over (L + 1) / 2 keys on average (causal), 2 flops a MAC
    attn_per_token = 3 * 2 * 2 * heads * hd * (GPT["seq"] + 1) / 2 \
        * GPT["layers"]
    mfu = (6 * n_params + attn_per_token) * tok_s / BF16_FLOPS
    prof = profile_train_step(lambda: step(), ())
    if prof["device_ms"]:
        # the profiled step's wall holds the profiler's own start: the
        # idle share against the timed steps' mean is the one to read
        prof["device_idle_share_vs_step_ms"] = \
            1 - prof["device_ms"] / (wall / GPT["steps"] * 1e3)
    out = {"card": nvidia_smi_line(), "model": "gpt3-13b-width",
           "layers": GPT["layers"], "hidden": cfg.hidden_size,
           "intermediate": cfg.intermediate_size, "heads": heads,
           "head_dim": hd, "vocab": cfg.vocab_size, "dtype": "bfloat16",
           "params": n_params,
           "optimizer": f"AdamW(lr={GPT['lr']}, multi_precision=False)",
           "loop": "eager paddle: loss.backward(); opt.step(); "
                   "opt.clear_grad()",
           "batch": GPT["batch"], "seq": GPT["seq"],
           "reduced": ["depth 40 -> 3 layers (bench.py:873-890)",
                       "random weights from a seed (no checkpoint in the "
                       "repo)"],
           "init_seconds": init_s, "losses": loss_values,
           "warmup_steps": GPT["warmup"], "timed_steps": GPT["steps"],
           "step_ms": wall / GPT["steps"] * 1e3, "tokens_per_s": tok_s,
           "mfu": mfu, "mfu_flops_per_token": 6 * n_params + attn_per_token,
           "flash_launches": dict(zip(("fwd", "dq", "dkv"), launches)),
           "flash_tma_launches": dict(zip(("fwd", "dq", "dkv"), tma)),
           "optimizer_launches": opt_counts,
           "peak_mem_gb": peak / 2 ** 30, "profile_one_step": prof}
    del step, opt, model, losses
    torch.cuda.empty_cache()
    return out


def phase_gpt_train_parity():
    """One 2-layer GPT step (loss and gradients) through the kernels
    against the same step through the plain sdpa."""
    import torch
    import paddle_tpu_torch as paddle
    model = gpt_model(2)
    crit = paddle.nn.CrossEntropyLoss()
    ids = gpt_ids(model.config.vocab_size)
    runs = []
    for flash in (True, False):
        for blk in model.blocks:
            blk.attn.use_flash = flash
        loss = gpt_loss(model, crit, ids)
        loss.backward()
        runs.append((float(loss), {n: p.grad._t for n, p in
                                   model.named_parameters()}))
        model.clear_gradients()
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
        emit({"phase": "gpt_train_parity", "failed": out})
        raise AssertionError("gpt_train: the step through the kernels "
                             "disagrees with the step through the plain "
                             "sdpa")
    return out


# ---------------------------------------------------------------------------
# the high-level trainer: paddle.Model.fit on whole-step CUDA graphs
# ---------------------------------------------------------------------------

FIT = dict(batch=4, seq=2048, layers=3, steps=8, eval_batches=3, lr=1e-4,
           workers=2, ids=1024)
FIT_SCALED = dict(layers=2, batch=2, seq=2048, steps=6, poison_step=3,
                  lr=1e-4)
# GPT-3 6.7B's widths (d_model 4096, 32 heads of 128), "7B widths"
GPT7B_WIDTHS = dict(vocab_size=50304, hidden_size=4096,
                    num_attention_heads=32, intermediate_size=16384,
                    max_position_embeddings=2048)
FIT_LOSS_RTOL = 1e-2          # each captured step's loss vs the eager one
FIT_PARAM_RMS = 5e-2          # final parameters, relative RMS


def fit_dataset(vocab, n, seed):
    """``n`` seeded sequences of token ids, each its own label (as
    gpt_train trains), the ids drawn from the first FIT["ids"] of the
    vocabulary: 8 steps of distinct batches then see each id ~64 times,
    enough for the loss to fall (over the whole vocabulary most ids of a
    batch would be new to the model, and 8 steps would not move it)."""
    import numpy as np
    import paddle_tpu_torch as paddle

    class TokenIds(paddle.io.Dataset):
        def __init__(self):
            self.ids = np.random.default_rng(seed).integers(
                0, min(vocab, FIT["ids"]), (n, FIT["seq"]))

        def __len__(self):
            return n

        def __getitem__(self, i):
            return self.ids[i], self.ids[i]
    return TokenIds()


def fit_loss(vocab):
    import paddle_tpu_torch as paddle
    crit = paddle.nn.CrossEntropyLoss()

    def loss(logits, labels):
        return crit(logits.reshape([-1, vocab]), labels.reshape([-1]))
    return loss


def flash_fit_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    return {k: (getattr(fa, f"flash_attention_{k}").launches,
                getattr(fa, f"flash_attention_{k}").tma_launches)
            for k in ("fwd", "bwd_dq", "bwd_dkv")}


def reset_flash_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    for k in ("fwd", "bwd_dq", "bwd_dkv"):
        w = getattr(fa, f"flash_attention_{k}")
        w.launches = w.tma_launches = 0


def step_clock(strict_from=None):
    """A fit callback: CUDA events around each train batch (no sync),
    each batch's lazy loss kept, and torch.cuda.set_sync_debug_mode
    ("error") over the batches from ``strict_from`` on (the replays)."""
    import torch
    import paddle_tpu_torch as paddle

    class StepClock(paddle.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.events, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append([ev, None])
            if strict_from is not None and step >= strict_from:
                torch.cuda.set_sync_debug_mode("error")

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.set_sync_debug_mode("default")
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[-1][1] = ev
            self.losses.append(logs["loss"])

        def step_ms(self):
            return [a.elapsed_time(b) for a, b in self.events]
    return StepClock()


def gpt_fit_run(capture, vocab):
    """One Model.fit of FIT["steps"] steps and an evaluate of
    FIT["eval_batches"] batches, the whole-step capture on or off.
    Returns its numbers and the parameters after fit (on the host)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    set_flags({"FLAGS_sot_capture": capture})
    paddle.set_device("gpu")
    paddle.seed(SEED)
    t0 = time.perf_counter()
    net = GPTForCausalLM(GPTConfig(num_hidden_layers=FIT["layers"],
                                   **GPT_WIDTHS))
    opt = paddle.optimizer.AdamW(
        FIT["lr"], parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    model = paddle.Model(net).prepare(
        opt, fit_loss(vocab), metrics=paddle.metric.Accuracy(),
        amp_configs="O1")
    train = paddle.io.DataLoader(
        fit_dataset(vocab, FIT["batch"] * FIT["steps"], SEED),
        batch_size=FIT["batch"], num_workers=FIT["workers"])
    evald = paddle.io.DataLoader(
        fit_dataset(vocab, FIT["batch"] * FIT["eval_batches"], SEED + 1),
        batch_size=FIT["batch"], num_workers=FIT["workers"])
    clock = step_clock(strict_from=2 if capture else None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_flash_counts()
    reset_optimizer_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = model.fit(train, epochs=1, verbose=0, callbacks=[clock])
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    opt_counts = check_optimizer_launches(
        f"gpt_fit ({'captured' if capture else 'eager'})", opt,
        FIT["steps"], True)
    stats_fit = dict(model._captured.stats) if model._captured else None
    params = {k: v._t.detach().float().cpu()
              for k, v in net.state_dict().items()}
    logs = {k: float(v) for k, v in model.evaluate(evald, verbose=0).items()}
    torch.cuda.synchronize()
    counts = flash_fit_counts()
    engine = model._captured
    stats = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in engine.stats.items()} if engine else None
    x, y = next(iter(train))
    prof = profile_train_step(lambda: model.train_batch(x, y), ())
    out = {"losses": [float(v) for v in clock.losses],
           "step_ms": clock.step_ms(), "fit_wall_s": fit_wall,
           "history": history, "eval": logs, "init_seconds": init_s,
           "flash_launches": counts, "optimizer_launches": opt_counts,
           "stats_after_fit": stats_fit, "stats": stats,
           "graphs": engine.graphs() if engine else None,
           "global_step": opt._global_step,
           "peak_mem_gb": peak / 2 ** 30, "profile_one_step": prof}
    n_params = sum(p.numel() for p in net.parameters())
    del model, opt, net, engine, train, evald, x, y, clock
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return out, params, n_params


def phase_gpt_fit(results):
    """paddle.Model(GPT at 13B widths, 3 layers, f32 master weights)
    .prepare(AdamW(1e-4, ClipGradByGlobalNorm(1.0)), CrossEntropyLoss,
    Accuracy(), amp_configs="O1").fit over a DataLoader (2 workers) of
    seeded token ids, 8 steps, then evaluate over 3 batches: first with
    the whole-step capture (CapturedStep: 7 of the 8 steps and 2 of the
    3 eval batches replayed CUDA graphs, the replays under
    set_sync_debug_mode("error")), then the same weights and batches
    with FLAGS_sot_capture=0, each step's loss and the final parameters
    held against that eager run."""
    import torch
    from paddle_tpu_torch.core.flags import set_flags
    vocab = GPT_WIDTHS["vocab_size"]
    try:
        cap, p_cap, n_params = gpt_fit_run(True, vocab)
        eag, p_eag, _ = gpt_fit_run(False, vocab)
    finally:
        set_flags({"FLAGS_sot_capture": True})
        torch.cuda.set_sync_debug_mode("default")
    L, S, E = FIT["layers"], FIT["steps"], FIT["eval_batches"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(cap["losses"],
                                                     eag["losses"])]
    worst, rms = 0.0, {}
    for k, b in p_eag.items():
        a = p_cap[k]
        r = float((a - b).double().square().mean().sqrt()
                  / b.double().square().mean().sqrt().clamp(min=1e-30))
        rms[k] = r
        worst = max(worst, r)
    bit_equal = all(torch.equal(p_cap[k], p_eag[k]) for k in p_eag)
    del p_cap, p_eag
    cfg_hidden = GPT_WIDTHS["hidden_size"]
    heads = GPT_WIDTHS["num_attention_heads"]
    hd = cfg_hidden // heads
    tokens = FIT["batch"] * FIT["seq"]
    # attention products per token, forward + backward (as gpt_train)
    attn_per_token = 3 * 2 * 2 * heads * hd * (FIT["seq"] + 1) / 2 * L
    flops_per_token = 6 * n_params + attn_per_token

    def rates(run, first):
        ms = statistics.mean(run["step_ms"][first:])
        tok_s = tokens / (ms / 1e3)
        prof = run["profile_one_step"]
        if prof["device_ms"]:
            prof["device_idle_share_vs_step_ms"] = 1 - prof["device_ms"] / ms
        return {"step_ms": ms, "tokens_per_s": tok_s,
                "mfu": flops_per_token * tok_s / BF16_FLOPS,
                "timed_steps": len(run["step_ms"][first:])}
    # the same steps both ways: 3..8 (the captured run's replays after
    # its capture step)
    cap_rates, eag_rates = rates(cap, 2), rates(eag, 2)
    want_flash = {"fwd": (L * (S + E),) * 2, "bwd_dq": (L * S,) * 2,
                  "bwd_dkv": (L * S,) * 2}
    st = cap["stats"]
    checks = {
        "captured_train_steps": cap["stats_after_fit"]["captured_steps"]
        == S - 1,
        "captured_eval_batches": st["captured_steps"]
        - cap["stats_after_fit"]["captured_steps"] == E - 1,
        "eager_first_sightings": st["eager_steps"] == 2,
        "graphs": cap["graphs"] == {"train": 1, "eval": 1},
        "no_fallbacks": st["fallbacks"] == {},
        "flash_launches": {k: tuple(v) for k, v in
                           cap["flash_launches"].items()} == want_flash,
        "eager_flash_launches": {k: tuple(v) for k, v in
                                 eag["flash_launches"].items()}
        == want_flash,
        "optimizer_launches": cap["optimizer_launches"]
        == eag["optimizer_launches"],
        "global_step": cap["global_step"] == eag["global_step"] == S + 1,
        "losses_within_rtol": max(loss_rel) <= FIT_LOSS_RTOL,
        "params_within_rms": worst <= FIT_PARAM_RMS,
        "losses_finite_falling": all(map(math.isfinite, cap["losses"]))
        and cap["losses"][-1] < cap["losses"][0],
    }
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        key = name[len("flash_attention_"):]
        results[name]["fit_launches"] = cap["flash_launches"][key][0]
    results["multi_tensor_unscale_norm"]["fit_launches"] = \
        cap["optimizer_launches"]["o1"]
    results["multi_tensor_adam"]["fit_launches"] = \
        cap["optimizer_launches"]["o2"]
    out = {"card": nvidia_smi_line(), "model": "gpt3-13b-width",
           "layers": L, "hidden": cfg_hidden,
           "intermediate": GPT_WIDTHS["intermediate_size"], "heads": heads,
           "head_dim": hd, "vocab": vocab, "params": n_params,
           "master_weights": "float32", "amp": "O1 (bf16)",
           "optimizer": f"AdamW({FIT['lr']}, "
                        "grad_clip=ClipGradByGlobalNorm(1.0))",
           "loop": "paddle.Model(net).prepare(opt, CrossEntropyLoss over "
                   "logits.reshape([-1, vocab]), Accuracy(), "
                   "amp_configs='O1').fit(DataLoader(num_workers=2)); "
                   "evaluate",
           "batch": FIT["batch"], "seq": FIT["seq"], "steps": S,
           "eval_batches": E,
           "reduced": ["depth 40 -> 3 layers (as gpt_train)",
                       "random weights from a seed"],
           "captured": {**cap_rates, **{k: cap[k] for k in (
               "losses", "step_ms", "fit_wall_s", "history", "eval",
               "init_seconds", "flash_launches", "optimizer_launches",
               "stats_after_fit", "stats", "graphs", "peak_mem_gb",
               "profile_one_step")},
               "capture_seconds": st["capture_seconds"],
               "sync_debug_mode": "error over the train batches 3..8 "
                                  "(copy-in, replay, lazy loss): no sync "
                                  "raised"},
           "eager": {**eag_rates, **{k: eag[k] for k in (
               "losses", "step_ms", "fit_wall_s", "history", "eval",
               "init_seconds", "flash_launches", "optimizer_launches",
               "peak_mem_gb", "profile_one_step")}},
           "speedup_step_ms": eag_rates["step_ms"] / cap_rates["step_ms"],
           "loss_rel_err": loss_rel, "loss_rtol": FIT_LOSS_RTOL,
           "param_rel_rms_worst": worst, "param_rel_rms_tol": FIT_PARAM_RMS,
           "params_bit_equal": bit_equal,
           "param_rel_rms_top": sorted(rms.items(), key=lambda kv: -kv[1])[:5],
           "checks": checks}
    if not all(checks.values()):
        emit({"phase": "gpt_fit", "failed": out})
        raise AssertionError(f"gpt_fit: {[k for k, v in checks.items() if not v]}")
    return out


def phase_gpt_fit_scaled(results):
    """A 2-layer GPT at GPT-3 6.7B widths through Model.train_batch with
    amp_configs={"level": "O1", "scaler": GradScaler(2**15,
    decr_every_n_nan_or_inf=1)}: the whole GradScaler iteration captured
    (scale, backward, O1 unscale + finite check + clip scale, the masked
    O2 update, the scale bookkeeping in place); the loss times a device
    scalar that is inf at step 3 (filled on the device before that
    replay): that step is skipped with the weights bit-equal, the scale
    halves, the other steps update; replays under
    set_sync_debug_mode("error")."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    F = FIT_SCALED
    vocab = GPT7B_WIDTHS["vocab_size"]
    paddle.set_device("gpu")
    paddle.seed(SEED)
    net = GPTForCausalLM(GPTConfig(num_hidden_layers=F["layers"],
                                   **GPT7B_WIDTHS))
    opt = paddle.optimizer.AdamW(
        F["lr"], parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    scaler = GradScaler(init_loss_scaling=OPT_LOSS_SCALE,
                        decr_every_n_nan_or_inf=1)
    poison = torch.ones((), device="cuda")
    base = fit_loss(vocab)

    def loss(logits, labels):
        return base(logits, labels) * paddle.Tensor(poison)
    model = paddle.Model(net).prepare(
        opt, loss, amp_configs={"level": "O1", "scaler": scaler})
    data = fit_dataset(vocab, F["batch"] * F["steps"], SEED)
    reset_optimizer_counts()
    rows, skipped = [], None
    for s in range(F["steps"]):
        ids = paddle.to_tensor(data.ids[s * F["batch"]:(s + 1) * F["batch"]])
        poison.fill_(math.inf if s == F["poison_step"] else 1.0)
        before = [p._t.detach().clone() for p in net.parameters()] \
            if s == F["poison_step"] else None
        torch.cuda.synchronize()
        if s >= 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            lz = model.train_batch(ids, ids)[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        found = scaler._found_inf
        rows.append({"step": s, "loss": float(lz),
                     "scale": float(scaler._scale),
                     "found": bool(found) if isinstance(found, torch.Tensor)
                     else bool(found)})
        if before is not None:
            skipped = all(torch.equal(a, p._t)
                          for a, p in zip(before, net.parameters()))
            del before
    counts = check_optimizer_launches("gpt_fit_scaled", opt, F["steps"],
                                      True)
    st = model._captured.stats
    want_scales = [OPT_LOSS_SCALE] * F["poison_step"] + \
        [OPT_LOSS_SCALE / 2] * (F["steps"] - F["poison_step"])
    checks = {
        "captured_steps": st["captured_steps"] == F["steps"] - 1,
        "no_fallbacks": st["fallbacks"] == {},
        "poisoned_step_skipped": bool(skipped),
        "found_only_there": [r["found"] for r in rows]
        == [s == F["poison_step"] for s in range(F["steps"])],
        "scale_halves": [r["scale"] for r in rows] == want_scales,
        "other_losses_finite": all(math.isfinite(r["loss"]) for r in rows
                                   if r["step"] != F["poison_step"]),
        "global_step": opt._global_step == F["steps"],
    }
    out = {"card": nvidia_smi_line(), "model": "gpt3-6.7b-width",
           "layers": F["layers"], "batch": F["batch"], "seq": F["seq"],
           "amp": "O1 + GradScaler(2**15, decr_every_n_nan_or_inf=1)",
           "optimizer": f"AdamW({F['lr']}, "
                        "grad_clip=ClipGradByGlobalNorm(1.0))",
           "reduced": ["depth 32 -> 2 layers", "batch 2 x 2048",
                       "random weights from a seed"],
           "poisoned_step": F["poison_step"], "steps": rows,
           "expected_scales": want_scales, "launches": counts,
           "stats": {k: (dict(v) if isinstance(v, dict) else v)
                     for k, v in st.items()},
           "sync_debug_mode": "error over steps 3..6 (replays)",
           "checks": checks}
    del model, opt, net, scaler, poison
    torch.cuda.empty_cache()
    if not all(checks.values()):
        emit({"phase": "gpt_fit_scaled", "failed": out})
        raise AssertionError(
            f"gpt_fit_scaled: {[k for k, v in checks.items() if not v]}")
    return out


# ---------------------------------------------------------------------------
# dropout (K5) and segments (K4) inside the flash kernels
# ---------------------------------------------------------------------------

DROP_SEED = 0x5EED0123456789AB     # the kernels' Philox key in the checks


def drop_key(seed=DROP_SEED):
    """A 64-bit seed as the key tensor the flash wrappers take (int64
    [2] on the card: its low and high words), as core.random draws
    them."""
    import torch
    return torch.tensor([seed & 0xFFFFFFFF, seed >> 32], dtype=torch.int64,
                        device="cuda")


def dropout_graph_replays(p, replays=3):
    """A small dropout attention call (a key drawn from the port's key
    stream, then the three kernels with it) captured in one CUDA graph
    and replayed: every replay draws a fresh key on the card, so the
    replays' outputs differ from each other and each equals, bit for
    bit, the eager call with the same place in the stream after the
    same seed; a reseed between replays restarts the stream in the
    graph (the state is written in place, no recapture)."""
    import torch
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.ops.kernels import counters
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    dev = torch.device("cuda", torch.cuda.current_device())
    q, k, v, do = flash_inputs((2, 256, 4, 64), torch.bfloat16, seed=9)

    def call():
        key = trandom.next_key(dev)
        out, lse = fa.flash_attention_fwd(q, k, v, False, None, p, key)
        delta = fa.attention_delta(out, do)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, False, None,
                                       p, key)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, False,
                                            None, p, key)
        return out, dq, dk, dv

    def clone(xs):
        return [x.clone() for x in xs]
    counts = counters.snapshot()   # these launches are checks, not the path
    trandom.seed(SEED + 3)
    eager = [clone(call()) for _ in range(replays)]
    trandom.seed(SEED + 3)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            static = call()
    torch.cuda.current_stream().wait_stream(stream)
    # recording drew nothing on the card: the stream restarts here
    trandom.seed(SEED + 3)
    got = []
    for _ in range(replays):
        graph.replay()
        got.append(clone(static))
    trandom.seed(SEED + 3)
    graph.replay()
    again = clone(static)
    torch.cuda.synchronize()
    counters.restore(counts)
    row = {"shape": [2, 256, 4, 64], "dropout_p": p, "replays": replays,
           "replay_equals_eager_nth": [
               all(torch.equal(a, b) for a, b in zip(g_, e))
               for g_, e in zip(got, eager)],
           "replays_differ": all(
               not torch.equal(got[i][0], got[j][0])
               for i in range(replays) for j in range(i + 1, replays)),
           "reseed_restarts_in_graph": all(
               torch.equal(a, b) for a, b in zip(again, eager[0]))}
    row["ok"] = all(row["replay_equals_eager_nth"]) and \
        row["replays_differ"] and row["reseed_restarts_in_graph"]
    return row


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
    kw = dict(dropout_p=p, seed=drop_key())
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
                           dropout_p=0.0, seed=drop_key())
        other = kernels_all(q, k, v, do, causal, ref[1], delta,
                            dropout_p=p, seed=drop_key(DROP_SEED + 1))
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
    keep = fa.flash_dropout_keep_mask(drop_key(), B, H, L, p, "cuda")
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
    replays = dropout_graph_replays(p)
    if not replays["ok"]:
        failed.append({"graph_replays": replays})
    auto = []
    for dtype in (bf, f32):
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = flash_inputs((2, 512, 12, 64), dtype, seed=8)
        auto.append(autograd_row(
            q, k, v, do,
            lambda a, b, c: fa.flash_attention(a, b, c, False, None, p,
                                               drop_key()),
            lambda a, b, c: sdpa_reference(a, b, c, dropout_p=p,
                                           seed=drop_key()), dname))
        if not auto[-1]["ok"]:
            failed.append({"autograd": auto[-1]})
    finish_parity("flash_dropout_parity", results, ("_dropout",), failed)
    return {"cases": rows, "keep_rate": keep_row, "keep_mask_exact": exact,
            "graph_replays": replays, "autograd": auto}


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
    key = drop_key()
    keep = fa.flash_dropout_keep_mask(key, B, H, L, p, "cuda").float()
    before = flash_counts()
    out, lse = fa.flash_attention_fwd(zeros, zeros, ident, False, None, p,
                                      key)
    delta = fa.attention_delta(out, ident)
    _, dv = fa.flash_attention_bwd_dkv(zeros, zeros, ident, ident, lse,
                                       delta, False, None, p, key)
    torch.cuda.synchronize()
    paths = flash_paths(before)
    fwd = (out.float() * L * (1 - p)).round().permute(0, 2, 1, 3)
    bwd = (dv.float() * L * (1 - p)).round().permute(0, 2, 3, 1)
    plain = fa.flash_attention_fwd(zeros, zeros, ident)
    zero_p = fa.flash_attention_fwd(zeros, zeros, ident, False, None, 0.0,
                                    key)
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
                         kw=dict(dropout_p=p, seed=drop_key()),
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

    def make_opt():
        return AdamW(learning_rate=BERT["lr"],
                     parameters=model.named_parameters(),
                     multi_precision=False)
    opt = make_opt()
    crit = CrossEntropyLoss()
    step = TrainStep(model, crit, opt)
    ids = bert_ids(cfg.vocab_size)
    start = param_copies(model)
    trandom.seed(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem_start = fresh_peak()
    # the first step runs eager, the second is captured and replayed, the
    # timed ones replay: each replay draws its 49 dropout keys on the card
    losses = [step(ids, ids) for _ in range(BERT["warmup"])]
    torch.cuda.synchronize()
    for w in wrappers:                     # the counts start here
        w.launches = w.dropout_launches = w.segmented_launches = 0
        w.tma_launches = 0
    reset_optimizer_counts()
    timed, wall, captured = timed_replays(step, (ids, ids), BERT["steps"])
    losses += timed
    launches = [w.launches for w in wrappers]        # ... and are read here
    dropped = [w.dropout_launches for w in wrappers]
    tma = [w.tma_launches for w in wrappers]
    opt_counts = check_optimizer_launches("bert_train", opt, BERT["steps"],
                                          False)
    capture = check_captured("bert_train", step, captured, BERT["steps"])
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
    cap_params, cap_state = param_copies(model), trandom.get_rng_state()
    both = optimizer_both_ways(step, (ids, ids))
    prof = both["fused"]
    del step, opt
    torch.cuda.empty_cache()
    eager = eager_reference(model, start, make_opt, crit, (ids, ids),
                            BERT["warmup"], BERT["steps"])
    vs = capture_vs_eager("bert_train", loss_values, cap_params, cap_state,
                          model, eager, tokens, BERT["steps"])
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
           "peak_mem_gb": peak / 2 ** 30,
           "mem_at_start_gb": mem_start / 2 ** 30, "capture": capture,
           "vs_eager": vs, "profile_one_step": prof,
           "profile_one_step_loop": both["loop"],
           # the profiler's own cost lands in the profiled step's wall:
           # the idle share against the timed steps' mean
           "device_idle_share_of_timed_step":
               1 - prof["device_ms"] / (wall / BERT["steps"] * 1e3)
               if prof["device_ms"] else None}
    del model, start, cap_params
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
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    t0 = time.perf_counter()
    model = moe_model()
    cfg = model.config
    n_params, n_active = moe_param_counts(model)

    def make_opt():
        return AdamW(learning_rate=MOE["lr"],
                     parameters=model.named_parameters(),
                     multi_precision=False)
    opt = make_opt()
    loss_fn = moe_loss(model)
    step = TrainStep(model, loss_fn, opt)
    ids = moe_ids(cfg.vocab_size)
    start = param_copies(model)
    trandom.seed(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem_start = fresh_peak()
    # the first step runs eager, the second is captured and replayed (the
    # routing too: capacity dispatch has no host read), the timed replay
    losses = [step(ids, ids) for _ in range(MOE["warmup"])]
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = kern.tma_launches = 0    # the counts start here
    reset_optimizer_counts()
    drops = []
    timed, wall, captured = timed_replays(
        step, (ids, ids), MOE["steps"], lambda: drops.append(
            [m.drop_share.clone() for m in model.moe_layers()]))
    losses += timed
    launches = [kern.launches for kern in kernels]   # ... and are read here
    tma = [kern.tma_launches for kern in kernels]
    opt_counts = check_optimizer_launches("moe_train", opt, MOE["steps"],
                                          False)
    capture = check_captured("moe_train", step, captured, MOE["steps"])
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
    cap_params, cap_state = param_copies(model), trandom.get_rng_state()
    both = optimizer_both_ways(step, (ids, ids))
    prof = both["fused"]
    del step, opt
    torch.cuda.empty_cache()
    eager = eager_reference(model, start, make_opt, loss_fn, (ids, ids),
                            MOE["warmup"], MOE["steps"])
    vs = capture_vs_eager("moe_train", loss_values, cap_params, cap_state,
                          model, eager, tokens, MOE["steps"])
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
           "peak_mem_gb": peak / 2 ** 30,
           "mem_at_start_gb": mem_start / 2 ** 30, "capture": capture,
           "vs_eager": vs, "profile_one_step": prof,
           "profile_one_step_loop": both["loop"],
           # the profiled step's own wall carries the profiler's cost:
           # the idle share against the timed steps' mean
           "device_idle_share_of_timed_step":
               1 - prof["device_ms"] / (wall / MOE["steps"] * 1e3)
               if prof["device_ms"] else None}
    del model, start, cap_params
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
        if events:
            prof["optimizer_step_ms"] = events[0][0].elapsed_time(
                events[0][1])
            prof["optimizer_step_ms_from"] = "CUDA events around the call"
        else:
            # a graph replay calls no optimizer.step() on the host: the
            # profile's multi_tensor kernels are its device time
            prof["optimizer_step_ms"] = prof["groups_ms"]["optimizer"]
            prof["optimizer_step_ms_from"] = "profile, optimizer group"
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


# ---------------------------------------------------------------------------
# the vision path: ResNet-50 through the captured TrainStep, ResNet-18
# parity and Model.fit
# ---------------------------------------------------------------------------

# bench.py:258-293 (bench_resnet50): batch 128 at 224 x 224, 1000 classes
RESNET50 = dict(batch=128, hw=224, classes=1000, warmup=2, steps=20,
                lr=0.1, momentum=0.9)
# the replays against the eager loop: losses, parameters, velocities and
# running statistics (bit-equality reported); max pooling's backward adds
# with atomics, so the bits may part
RESNET_LOSS_RTOL = 1e-3
RESNET_STATE_RMS = 5e-2
RESNET_PARITY = dict(batch=8, hw=64, classes=10, steps=2, lr=0.01)
# the card against the CPU, f32 without TF32: logits and loss; gradients,
# velocities and running statistics per tensor in relative RMS (the
# closed-form batch-norm backward cancels Σg·x against m·Σg: two f32
# implementations of it were measured up to ~1e-2 apart on early layers,
# and in bf16 its outputs carry bf16's rounding of the cancelled terms);
# all parameters together in relative RMS after two steps
PARITY_TOL = {"float32": dict(logits=1e-3, loss=1e-4, grad=5e-2,
                              param=1e-3, stats=1e-3, velocity=5e-2),
              "bfloat16": dict(logits=1e-1, loss=5e-2, grad=6e-1,
                               param=2e-2, stats=1e-1, velocity=6e-1)}
RESNET_FIT = dict(batch=64, lr=0.01, momentum=0.9)


def resnet_group(kernel: str) -> str:
    """ResNet's kernel groups: cuDNN's convolutions, GEMM-named kernels
    (the fc's cuBLAS GEMMs and 1×1 convolutions cuDNN runs as GEMMs),
    pooling, the optimizer's multi-tensor kernels, layout transforms
    (transpose and NCHW/NHWC kernels), torch's copy kernels (dtype
    casts, as batch norm's ``x.float()``), and the rest (batch norm's
    reductions and elementwise passes, ReLU, residual adds, loss)."""
    kl = kernel.lower()
    if any(tag in kl for tag in LAYOUT_KERNEL_TAGS[1:]):
        return "layout"
    if "copy_kernel" in kl:
        return "copy"
    if "multi_tensor" in kl:
        return "optimizer"
    if "pool" in kl:
        return "pooling"
    if any(tag in kl for tag in ("nvjet", "gemv")) or (
            "gemm" in kl and "implicit" not in kl and "conv" not in kl):
        return "fc_gemm"
    # a convolution's own kernel may carry "transpose" in its template
    # arguments: cuDNN's NCHW/NHWC converters above, the convolutions,
    # then any other transpose
    if any(tag in kl for tag in ("cudnn", "conv", "xmma", "implicit",
                                 "dgrad", "wgrad", "fprop", "cutlass",
                                 "sm90")):
        return "conv"
    if LAYOUT_KERNEL_TAGS[0] in kl:
        return "layout"
    return "other"


RESNET_GROUPS = ("conv", "fc_gemm", "pooling", "optimizer", "layout",
                 "copy", "other")
LAYOUT_KERNEL_TAGS = ("transpose", "nchwtonhwc", "nhwctonchw")


def layout_copies(fn):
    """Run ``fn`` under a dispatch mode that lists every copy of a tensor
    of >= 3 dims and >= 65536 elements into another memory layout
    (``copy_``, ``_to_copy``, ``clone`` whose strides order the axes
    differently): an NCHW copy of an NHWC activation would be one."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    found = []

    def order(t):
        dims = [i for i in range(t.dim()) if t.shape[i] > 1]
        return sorted(dims, key=lambda i: -t.stride(i))

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (aten.copy_.default, aten._to_copy.default,
                        aten.clone.default):
                src = args[1] if func is aten.copy_.default else args[0]
                dst = args[0] if func is aten.copy_.default else out
                if isinstance(src, torch.Tensor) and src.dim() >= 3 and \
                        src.numel() >= 65536 and order(src) != order(dst):
                    found.append([str(func), list(src.shape),
                                  list(src.stride()), list(dst.stride())])
            return out

    with Spy():
        fn()
    return found


def resnet_state(model, opt):
    """Copies of the parameters, the batch norms' running statistics and
    the velocities."""
    params = {k: p.detach().clone()
              for k, p in torch_named(model, "parameters")}
    bufs = {k: b.detach().clone() for k, b in torch_named(model, "buffers")}
    vel = {i: s["velocity"].detach().clone()
           for i, s in sorted(opt._states.items())}
    return params, bufs, vel


def torch_named(model, what):
    import torch
    return list(getattr(torch.nn.Module, f"named_{what}")(model))


def rel_rms(a, b):
    d = float((a.double() - b.double()).square().sum())
    r = float(b.double().square().sum())
    return math.sqrt(d / r) if r > 0 else math.sqrt(d)


def compare_states(got, want):
    """Worst relative RMS per part (parameters, running statistics,
    velocities) and whether every tensor is bit-equal."""
    import torch
    out, equal = {}, True
    for name, a, b in zip(("params", "stats", "velocities"), got, want):
        out[name] = max(rel_rms(a[k], b[k]) for k in b)
        equal = equal and all(torch.equal(a[k], b[k]) for k in b)
    out["bit_equal"] = equal
    return out


def bn_shapes(model, x):
    """The input shape of every batch norm of ``model`` in one forward
    (hooks removed after)."""
    import torch
    from paddle_tpu_torch.nn.layers_conv_norm import _BatchNormBase
    shapes, hooks = [], []
    for m in model.sublayers():
        if isinstance(m, _BatchNormBase):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: shapes.append(tuple(args[0].shape))))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def bn_yardstick(shapes, dtype, device="cuda", data_format="NHWC"):
    """The port's training batch norm (forward + backward) against
    ``torch.nn.functional.batch_norm`` (cuDNN; for NHWC on the
    channels-last NCHW view) on each shape; device ms summed over the
    layers."""
    import torch
    import paddle_tpu_torch.nn.functional as F
    nhwc = data_format == "NHWC"
    port = cudnn = 0.0
    for shape in shapes:
        c = shape[-1] if nhwc else shape[1]
        x = torch.randn(shape, device=device).to(dtype).requires_grad_()
        g = torch.randn(shape, device=device).to(dtype)
        w = torch.ones(c, device=device, dtype=dtype, requires_grad=True)
        b = torch.zeros(c, device=device, dtype=dtype, requires_grad=True)
        rm = torch.zeros(c, device=device, dtype=dtype)
        rv = torch.ones(c, device=device, dtype=dtype)
        w32 = w.detach().float().requires_grad_()
        b32 = b.detach().float().requires_grad_()
        rm32, rv32 = rm.float(), rv.float()

        def ours():
            F.batch_norm(x, rm, rv, w, b, training=True,
                         data_format=data_format).backward(g)

        def theirs():
            xc, gc_ = (x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)) \
                if nhwc else (x, g)
            torch.nn.functional.batch_norm(
                xc, rm32, rv32, w32, b32, training=True,
                momentum=0.1, eps=1e-5).backward(gc_)
        port += time_ms(ours, samples=5, inner=2, warmup=1)
        cudnn += time_ms(theirs, samples=5, inner=2, warmup=1)
    return {"layers": len(shapes), "port_ms_per_step": port,
            "cudnn_ms_per_step": cudnn,
            "port_over_cudnn": port / cudnn if cudnn else None}


def phase_resnet50_train(device="cuda"):
    """bench_resnet50's step through the port's captured TrainStep
    (``device="cpu"`` rehearses the phase's code at a small size)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.vision.models import resnet50
    cfg = RESNET50
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    # the algorithm search runs in the eager first step, never inside
    # the capture; deterministic algorithms only, so that the replays
    # and the eager loop can be held to each other
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        paddle.set_device("gpu" if device == "cuda" else device)
        paddle.seed(SEED)
        model = resnet50(num_classes=cfg["classes"],
                         data_format="NHWC").bfloat16()
        n_params = sum(p.numel() for p in model.parameters())

        def make_opt():
            return paddle.optimizer.Momentum(
                learning_rate=cfg["lr"], momentum=cfg["momentum"],
                parameters=model.parameters())
        opt = make_opt()
        crit = paddle.nn.CrossEntropyLoss()
        step = TrainStep(model, crit, opt)
        rng = np.random.default_rng(SEED)
        b, hw = cfg["batch"], cfg["hw"]
        x = torch.from_numpy(rng.standard_normal((b, hw, hw, 3)).astype(
            np.float32) * 0.1).to(device, torch.bfloat16)
        # the bench feeds int32 labels; the port's loss takes int64
        y = torch.from_numpy(rng.integers(0, cfg["classes"], (b,)).astype(
            np.int32)).to(device).long()
        params0, bufs0, _ = resnet_state(model, opt)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        mem_start = fresh_peak()
        t1 = time.perf_counter()
        losses = [step(x, y) for _ in range(cfg["warmup"])]
        torch.cuda.synchronize()
        first_two_s = time.perf_counter() - t1
        timed, wall, captured = timed_replays(step, (x, y), cfg["steps"])
        losses += timed
        capture = check_captured("resnet50_train", step, captured,
                                 cfg["steps"])
        peak = torch.cuda.max_memory_allocated()
        loss_values = [float(v) for v in losses]
        if not all(math.isfinite(v) for v in loss_values):
            raise AssertionError(f"resnet50_train: non-finite loss "
                                 f"{loss_values}")
        cap = resnet_state(model, opt)
        moved = {k: not torch.equal(cap[1][k], bufs0[k]) for k in bufs0}
        if not all(moved.values()):
            raise AssertionError(
                "resnet50_train: running statistics that did not move: "
                f"{[k for k, v in moved.items() if not v][:5]}")
        prof = profile_train_step(step, (x, y), resnet_group, RESNET_GROUPS,
                                  named=("layout", "copy", "pooling"))
        step_ms = wall / cfg["steps"] * 1e3
        del step
        # the same steps through a plain eager loop from the same start
        with torch.no_grad():
            for k, p in torch_named(model, "parameters"):
                p.copy_(params0[k])
            for k, v in torch_named(model, "buffers"):
                v.copy_(bufs0[k])
        opt = make_opt()
        eager = []
        n = cfg["warmup"] + cfg["steps"]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(n):
            loss = crit(model(x), y).float()
            loss.backward()
            opt.step()
            opt.clear_grad()
            eager.append(loss.detach())
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t2) / n * 1e3
        eager = [float(v) for v in eager]
        vs = compare_states(cap, resnet_state(model, opt))
        vs["loss_rel_err_max"] = max(abs(a - e) / max(abs(e), 1e-30)
                                     for a, e in zip(loss_values, eager))
        vs["losses_bit_equal"] = loss_values == eager
        vs["eager_step_ms_mean_of_22"] = eager_ms
        vs["tol"] = {"loss_rtol": RESNET_LOSS_RTOL,
                     "state_rms": RESNET_STATE_RMS}
        if vs["loss_rel_err_max"] > RESNET_LOSS_RTOL or max(
                vs[k] for k in ("params", "stats", "velocities")) > \
                RESNET_STATE_RMS:
            emit({"phase": "resnet50_train", "failed": vs})
            raise AssertionError("resnet50_train: the replays disagree "
                                 "with the eager loop")
        if prof["group_launches"]["layout"]:
            raise AssertionError(
                f"resnet50_train: layout-transform kernels in a replayed "
                f"step: {prof['named_kernels']['layout']}")
        # no NCHW copy of an activation in one eager step
        copies = layout_copies(
            lambda: crit(model(x), y).float().backward())
        opt.clear_grad()
        if copies:
            raise AssertionError(f"resnet50_train: layout copies of "
                                 f"activations: {copies[:5]}")
        shapes = bn_shapes(model, x)
        yard = bn_yardstick(shapes, torch.bfloat16, device)
        out = {"card": nvidia_smi_line(), "model": "resnet50",
               "source": "bench.py:258-293 (bench_resnet50)",
               "data_format": "NHWC", "dtype": "bfloat16",
               "params": n_params, "batch": b, "hw": hw,
               "classes": cfg["classes"],
               "optimizer": f"Momentum({cfg['lr']}, {cfg['momentum']})",
               "labels": "int32 as the bench draws them, taken to int64",
               "cudnn": {"benchmark": True, "deterministic": True,
                         "allow_tf32": torch.backends.cudnn.allow_tf32},
               "init_seconds": init_s,
               "first_two_steps_s": first_two_s,
               "losses": loss_values, "timed_steps": cfg["steps"],
               "step_ms": step_ms, "imgs_per_s": b / step_ms * 1e3,
               "peak_mem_gb": peak / 2 ** 30,
               "mem_at_start_gb": mem_start / 2 ** 30,
               "capture": capture, "vs_eager": vs,
               "profile_one_replay": prof,
               "device_idle_share_of_timed_step":
                   1 - prof["device_ms"] / step_ms
                   if prof["device_ms"] else None,
               "layout_copies_one_eager_step": len(copies),
               "layout_kernels_one_replay":
                   prof["group_launches"]["layout"],
               "copy_kernels_one_replay": prof["group_launches"]["copy"],
               "copy_kernel_note": "torch's copy kernels of a replay are "
                                   "dtype casts (batch norm's f32 "
                                   "statistics, its bf16 outputs); no "
                                   "copy changes a layout (the dispatch "
                                   "count above)",
               "batch_norm": yard}
    finally:
        torch.backends.cudnn.benchmark, \
            torch.backends.cudnn.deterministic = flags
    del model, opt, x, y, params0, bufs0, cap
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resnet18_on(device, layout, dtype, state):
    """The port's resnet18 on ``device`` holding ``state`` (numpy), in
    ``dtype``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.vision.models import resnet18
    prev = tdevice._current
    paddle.set_device("cpu" if device == "cpu" else "gpu")
    try:
        model = resnet18(num_classes=RESNET_PARITY["classes"],
                         data_format=layout)
        model.set_state_dict(state)
        return model.to(dtype=dtype)
    finally:
        tdevice._current = prev


def resnet_parity_run(device, layout, dtype, state, x, y):
    """Logits, loss and gradients of one training forward, then the
    parameters, running statistics and velocities after
    RESNET_PARITY["steps"] Momentum steps (the first on the same batch),
    all on the host in f32."""
    import paddle_tpu_torch as paddle
    model = resnet18_on(device, layout, dtype, state)
    opt = paddle.optimizer.Momentum(RESNET_PARITY["lr"], 0.9,
                                    parameters=model.parameters())
    crit = paddle.nn.CrossEntropyLoss()
    xd, yd = x.to(device, dtype), y.to(device)
    if layout == "NHWC":
        xd = xd.permute(0, 2, 3, 1).contiguous()
    logits = model(xd)
    loss = crit(logits, yd)
    loss.float().backward()
    grads = {k: p.grad.detach().float().cpu()
             for k, p in torch_named(model, "parameters")}
    out = {"logits": logits.detach().float().cpu(),
           "loss": float(loss.detach()), "grads": grads}
    opt.step()
    opt.clear_grad()
    for _ in range(RESNET_PARITY["steps"] - 1):
        crit(model(xd), yd).float().backward()
        opt.step()
        opt.clear_grad()
    params, bufs, vel = resnet_state(model, opt)
    out["params"] = {k: v.float().cpu() for k, v in params.items()}
    out["stats"] = {k: v.float().cpu() for k, v in bufs.items()}
    out["velocities"] = {k: v.float().cpu() for k, v in vel.items()}
    return out


def phase_resnet_parity():
    """ResNet-18 on the card against the same model on the CPU (which
    the tier-1 tests hold against the JAX package), f32 and bf16, NHWC
    and NCHW; NHWC against NCHW logits on the card."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet18
    cfg = RESNET_PARITY
    paddle.seed(SEED)
    state = {k: v.numpy() for k, v in
             resnet18(num_classes=cfg["classes"]).state_dict().items()}
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal(
        (cfg["batch"], 3, cfg["hw"], cfg["hw"])).astype(np.float32) * 0.5)
    y = torch.from_numpy(rng.integers(0, cfg["classes"], (cfg["batch"],)))
    rows, logits_by_layout = {}, {}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = PARITY_TOL[str(dtype).split(".")[-1]]
        for layout in ("NHWC", "NCHW"):
            card = resnet_parity_run("cuda", layout, dtype, state, x, y)
            cpu = resnet_parity_run("cpu", layout, dtype, state, x, y)
            row = {"logits": rel_rms(card["logits"], cpu["logits"]),
                   "loss": abs(card["loss"] - cpu["loss"])
                   / max(abs(cpu["loss"]), 1e-30),
                   "loss_card": card["loss"], "loss_cpu": cpu["loss"]}
            for part in ("grads", "stats", "velocities"):
                row[part] = max(rel_rms(card[part][k], cpu[part][k])
                                for k in cpu[part])
            row["grads_global"] = rel_rms(
                torch.cat([card["grads"][k].reshape(-1) for k in cpu[
                    "grads"]]),
                torch.cat([v.reshape(-1) for v in cpu["grads"].values()]))
            # over all parameters at once: a bias starts at zero, so its
            # own relative error is its updates', the gradients' error
            row["params"] = rel_rms(
                torch.cat([card["params"][k].reshape(-1) for k in cpu[
                    "params"]]),
                torch.cat([v.reshape(-1) for v in cpu["params"].values()]))
            limits = {"logits": tol["logits"], "loss": tol["loss"],
                      "grads": tol["grad"], "params": tol["param"],
                      "stats": tol["stats"], "velocities": tol["velocity"]}
            row["tol"] = limits
            bad = [k for k, lim in limits.items() if not row[k] <= lim]
            if bad:
                failed.append((str(dtype), layout, bad))
            rows[f"{str(dtype).split('.')[-1]}_{layout}"] = row
            if dtype == torch.float32:
                logits_by_layout[layout] = card["logits"]
    layouts = rel_rms(logits_by_layout["NHWC"], logits_by_layout["NCHW"])
    if layouts > 1e-4:
        failed.append(("float32", "NHWC vs NCHW logits", layouts))
    out = {"model": "resnet18", "batch": cfg["batch"], "hw": cfg["hw"],
           "classes": cfg["classes"], "steps": cfg["steps"],
           "lr": cfg["lr"], "tf32": torch.backends.cudnn.allow_tf32,
           "rel_rms_card_vs_cpu": rows,
           "nhwc_vs_nchw_logits_rel_rms_f32": layouts,
           "nhwc_vs_nchw_tol": 1e-4}
    if failed:
        emit({"phase": "resnet_parity", "failed": failed, **out})
        raise AssertionError(f"resnet_parity: {failed}")
    return out


def resnet_fit_run(capture, state):
    """One epoch of Model.fit over the synthetic Cifar10 and an
    evaluate, the whole-step capture on or off; the same weights, data
    order and transform draws each time."""
    import random
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import Cifar10
    from paddle_tpu_torch.vision.models import resnet18
    set_flags({"FLAGS_sot_capture": capture})
    paddle.set_device("gpu")
    paddle.seed(SEED)
    random.seed(SEED)
    net = resnet18(num_classes=10)
    net.set_state_dict(state)
    opt = paddle.optimizer.Momentum(RESNET_FIT["lr"],
                                    RESNET_FIT["momentum"],
                                    parameters=net.parameters())
    model = paddle.Model(net).prepare(opt, paddle.nn.CrossEntropyLoss(),
                                      metrics=paddle.metric.Accuracy())
    norm = T.Normalize(mean=[0.5] * 3, std=[0.5] * 3)
    train = Cifar10(mode="train", transform=T.Compose([
        T.RandomCrop(32, padding=4), T.RandomHorizontalFlip(),
        T.ToTensor(), norm]))
    test = Cifar10(mode="test", transform=T.Compose([T.ToTensor(), norm]))
    clock = step_clock(strict_from=2 if capture else None)
    t0 = time.perf_counter()
    history = model.fit(train, test, batch_size=RESNET_FIT["batch"],
                        epochs=1, shuffle=False, drop_last=True,
                        verbose=0, callbacks=[clock])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine = model._captured
    out = {"losses": [float(v) for v in clock.losses],
           "step_ms": clock.step_ms(), "fit_wall_s": wall,
           "history": {k: [float(v) for v in vs]
                       for k, vs in history.items()},
           "stats": {k: (dict(v) if isinstance(v, dict) else v)
                     for k, v in engine.stats.items()} if engine else None,
           "graphs": engine.graphs() if engine else None}
    del model, opt, net, engine, clock
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_resnet_fit():
    """paddle.Model(resnet18) over the synthetic Cifar10, captured and
    then eager."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.vision.models import resnet18
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        paddle.set_device("gpu")
        paddle.seed(SEED)
        state = {k: v._t.detach().cpu().numpy()
                 for k, v in resnet18(num_classes=10).state_dict().items()}
        cap = resnet_fit_run(True, state)
        eager = resnet_fit_run(False, state)
    finally:
        set_flags({"FLAGS_sot_capture": True})
        torch.backends.cudnn.deterministic = deterministic
    n = len(cap["losses"])
    st = cap["stats"]
    # 16 train batches: the first eager, 15 captured; 4 eval batches:
    # the first eager, 3 captured
    want = {"captured_steps": (n - 1) + 3, "fallbacks": {},
            "graphs": {"train": 1, "eval": 1}}
    got = {"captured_steps": st["captured_steps"],
           "fallbacks": st["fallbacks"], "graphs": cap["graphs"]}
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(cap["losses"], eager["losses"]))
    eval_keys = [k for k in cap["history"] if k.startswith("eval_")]
    out = {"model": "resnet18", "dataset": "Cifar10 (synthetic, 1024 "
           "train / 256 test)", "batch": RESNET_FIT["batch"],
           "train_batches": n, "captured": got,
           "losses_captured": cap["losses"], "losses_eager": eager["losses"],
           "loss_rel_err_max": rel, "loss_rtol": FIT_LOSS_RTOL,
           "losses_bit_equal": cap["losses"] == eager["losses"],
           "history_captured": cap["history"],
           "history_eager": eager["history"],
           "step_ms_captured": cap["step_ms"],
           "step_ms_eager": eager["step_ms"],
           "fit_wall_s": [cap["fit_wall_s"], eager["fit_wall_s"]]}
    ok = (got == want and rel <= FIT_LOSS_RTOL and n == 16 and eval_keys
          and all(math.isfinite(v) for v in cap["losses"]))
    if not ok:
        emit({"phase": "resnet_fit", "failed": {"want": want}, **out})
        raise AssertionError("resnet_fit: capture or losses off")
    return out


# ---------------------------------------------------------------------------
# the rest of paddle.vision: MobileNetV2 through the captured TrainStep,
# the zoo and the detection ops on the card against the CPU
# ---------------------------------------------------------------------------

# MobileNetV2 at its published ImageNet widths (scale 1.0, 1000
# classes), the ResNet-50 phase's batch and resolution; the optimizer is
# the MobileNetV2 paper's initial rate and weight decay (Sandler et al.
# 2018, section 6.1) on the captured Momentum
MOBILENET_V2 = dict(batch=128, hw=224, classes=1000, warmup=2, steps=20,
                    lr=0.045, momentum=0.9, weight_decay=4e-5)
# every family's default constructor, f32 on the card against the CPU
# (batch 4, 1000 classes; Inception v3 at 299², LeNet at 1×28×28 with
# its 10 classes), and a bf16 eval forward at batch 64
ZOO_PARITY = ("mobilenet_v1", "mobilenet_v3_small", "mobilenet_v3_large",
              "vgg16", "LeNet", "alexnet", "squeezenet1_1", "densenet121",
              "shufflenet_v2_x1_0", "googlenet", "inception_v3")
ZOO_TRAIN = ("mobilenet_v3_large", "shufflenet_v2_x1_0")
ZOO_TOL = dict(logits=1e-3, loss=1e-4, grad=5e-2)
ZOO_BATCH, ZOO_TIME_BATCH = 4, 64
# the detection ops at a detector's sizes: one FPN level of an 800×1088
# image at stride 4 with 1000 boxes; R-FCN's 10·7·7 position-sensitive
# channels with 300 boxes; YOLOv3's three heads at 416² (the anchors and
# masks of its published config), 80 classes, batch 8
OPS_TOL = dict(out=1e-4, grad=1e-3)
# roi_align's samples sit at f32 coordinates up to ~272 px, whose
# rounding (3.05e-5 px) moves an interpolant of slope up to ~8: the
# port's f32 result is 8.6e-5 from float64 on the CPU at this size and
# the card's 1.34e-4 from the CPU's, so its outputs are held at 5e-4
ROI_ALIGN_TOL = dict(out=5e-4, grad=1e-3)
VISION_OPS = dict(fpn=(256, 200, 272), boxes=1000, ps_boxes=300,
                  deform=(2, 256, 64, 64), grid=(8, 64, 128, 128),
                  yolo_batch=8, nms_boxes=2000)
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = ((13, 32, [6, 7, 8]), (26, 16, [3, 4, 5]), (52, 8, [0, 1, 2]))


def zoo_boxes(rng, n, h, w, spatial_scale=1.0):
    """``n`` boxes (xyxy, image pixels) inside an ``h × w`` feature map
    at ``spatial_scale``."""
    import numpy as np
    H, W = h / spatial_scale, w / spatial_scale
    x1 = rng.uniform(0, W * 0.8, n)
    y1 = rng.uniform(0, H * 0.8, n)
    bw = rng.uniform(min(8.0, W * 0.1), W * 0.25, n)
    bh = rng.uniform(min(8.0, H * 0.1), H * 0.25, n)
    return np.stack([x1, y1, np.minimum(x1 + bw, W - 1),
                     np.minimum(y1 + bh, H - 1)], 1).astype(np.float32)


def worst_excess(got, want, tol):
    """(max(|got - want| - tol·(1 + |want|)), max |got - want|) on the
    host in f64: the first <= 0 passes."""
    a, b = got.detach().double().cpu(), want.detach().double().cpu()
    d = (a - b).abs()
    return float((d - tol * (1 + b.abs())).max()), float(d.max())


def phase_mobilenet_v2_train(device="cuda"):
    """MobileNetV2 at ImageNet widths through the port's captured
    TrainStep, then the same steps through a plain eager loop from the
    same weights and key stream (``device="cpu"`` rehearses the phase's
    code at a small size)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.vision.models import mobilenet_v2
    cfg = MOBILENET_V2
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    # the algorithm search runs in the eager first step, never inside
    # the capture; deterministic algorithms, so that the replays and the
    # eager loop can be held to each other
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        paddle.set_device("gpu" if device == "cuda" else device)
        paddle.seed(SEED)
        model = mobilenet_v2(scale=1.0,
                             num_classes=cfg["classes"]).bfloat16()
        n_params = sum(p.numel() for p in model.parameters())

        def make_opt():
            return paddle.optimizer.Momentum(
                learning_rate=cfg["lr"], momentum=cfg["momentum"],
                weight_decay=cfg["weight_decay"],
                parameters=model.parameters())
        opt = make_opt()
        crit = paddle.nn.CrossEntropyLoss()
        step = TrainStep(model, crit, opt)
        rng = np.random.default_rng(SEED)
        b, hw = cfg["batch"], cfg["hw"]
        x = torch.from_numpy(rng.standard_normal((b, 3, hw, hw)).astype(
            np.float32) * 0.1).to(device, torch.bfloat16)
        y = torch.from_numpy(rng.integers(0, cfg["classes"], (b,))).to(
            device)
        params0, bufs0, _ = resnet_state(model, opt)
        rng0 = trandom.get_rng_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        mem_start = fresh_peak()
        t1 = time.perf_counter()
        losses = [step(x, y) for _ in range(cfg["warmup"])]
        torch.cuda.synchronize()
        first_two_s = time.perf_counter() - t1
        timed, wall, captured = timed_replays(step, (x, y), cfg["steps"])
        losses += timed
        capture = check_captured("mobilenet_v2_train", step, captured,
                                 cfg["steps"])
        peak = torch.cuda.max_memory_allocated()
        loss_values = [float(v) for v in losses]
        if not all(math.isfinite(v) for v in loss_values):
            raise AssertionError(f"mobilenet_v2_train: non-finite loss "
                                 f"{loss_values}")
        cap = resnet_state(model, opt)
        rng_cap = list(trandom.get_rng_state())
        still = [k for k in bufs0 if torch.equal(cap[1][k], bufs0[k])]
        if still:
            raise AssertionError("mobilenet_v2_train: running statistics "
                                 f"that did not move: {still[:5]}")
        prof = profile_train_step(step, (x, y), resnet_group, RESNET_GROUPS,
                                  named=("conv", "layout", "pooling"))
        step_ms = wall / cfg["steps"] * 1e3
        del step
        # the same steps through a plain eager loop from the same start
        with torch.no_grad():
            for k, p in torch_named(model, "parameters"):
                p.copy_(params0[k])
            for k, v in torch_named(model, "buffers"):
                v.copy_(bufs0[k])
        opt = make_opt()
        trandom.set_rng_state(rng0)
        eager = []
        n = cfg["warmup"] + cfg["steps"]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(n):
            loss = crit(model(x), y).float()
            loss.backward()
            opt.step()
            opt.clear_grad()
            eager.append(loss.detach())
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t2) / n * 1e3
        eager = [float(v) for v in eager]
        vs = compare_states(cap, resnet_state(model, opt))
        vs["loss_rel_err_max"] = max(abs(a - e) / max(abs(e), 1e-30)
                                     for a, e in zip(loss_values, eager))
        vs["losses_bit_equal"] = loss_values == eager
        vs["rng_state_captured"] = rng_cap
        vs["rng_state_eager"] = list(trandom.get_rng_state())
        vs["eager_step_ms_mean_of_22"] = eager_ms
        vs["eager_imgs_per_s"] = b / eager_ms * 1e3
        vs["tol"] = {"loss_rtol": RESNET_LOSS_RTOL,
                     "state_rms": RESNET_STATE_RMS}
        if vs["loss_rel_err_max"] > RESNET_LOSS_RTOL or max(
                vs[k] for k in ("params", "stats", "velocities")) > \
                RESNET_STATE_RMS or rng_cap != vs["rng_state_eager"]:
            emit({"phase": "mobilenet_v2_train", "failed": vs})
            raise AssertionError("mobilenet_v2_train: the replays disagree "
                                 "with the eager loop")
        shapes = bn_shapes(model, x)
        yard = bn_yardstick(shapes, torch.bfloat16, device,
                            data_format="NCHW")
        conv = prof["named_kernels"]["conv"]
        depthwise = [k for k in conv if "depthwise" in k[0].lower()
                     or "dwconv" in k[0].lower()]
        out = {"card": nvidia_smi_line(), "model": "mobilenet_v2",
               "source": "paddle_tpu/vision/models/mobilenet.py:95 "
                         "(scale 1.0, 1000 classes)",
               "data_format": "NCHW", "dtype": "bfloat16",
               "params": n_params, "batch": b, "hw": hw,
               "classes": cfg["classes"],
               "optimizer": f"Momentum({cfg['lr']}, {cfg['momentum']}, "
                            f"weight_decay={cfg['weight_decay']})",
               "dropout": "classifier Dropout(0.2): the hash mask from the "
                          "device key stream, inside the graph",
               "cudnn": {"benchmark": True, "deterministic": True,
                         "allow_tf32": torch.backends.cudnn.allow_tf32},
               "init_seconds": init_s,
               "first_two_steps_s": first_two_s,
               "losses": loss_values, "timed_steps": cfg["steps"],
               "step_ms": step_ms, "imgs_per_s": b / step_ms * 1e3,
               "peak_mem_gb": peak / 2 ** 30,
               "mem_at_start_gb": mem_start / 2 ** 30,
               "capture": capture, "vs_eager": vs,
               "profile_one_replay": {k: v for k, v in prof.items()
                                      if k != "named_kernels"},
               "device_idle_share_of_timed_step":
                   1 - prof["device_ms"] / step_ms
                   if prof["device_ms"] else None,
               "depthwise_kernels_one_replay": depthwise,
               "conv_kernels_one_replay": conv,
               "layout_kernels_one_replay":
                   prof["named_kernels"]["layout"],
               "batch_norm_layers": len(shapes),
               "batch_norm": yard,
               "batch_norm_share_of_replay_device_ms":
                   yard["port_ms_per_step"] / prof["device_ms"]
                   if prof["device_ms"] else None}
    finally:
        torch.backends.cudnn.benchmark, \
            torch.backends.cudnn.deterministic = flags
    del model, opt, x, y, params0, bufs0, cap
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_model(arch, device, state=None):
    """The port's ``vision.models.<arch>`` (1000 classes; LeNet its 10)
    built on ``device``, holding ``state`` (numpy) when given."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as tdevice
    prev = tdevice._current
    paddle.set_device("cpu" if device == "cpu" else "gpu")
    try:
        kw = {} if arch == "LeNet" else {"num_classes": 1000}
        model = getattr(paddle.vision.models, arch)(**kw)
        if state is not None:
            model.set_state_dict(state)
        return model
    finally:
        tdevice._current = prev


def calibrate_batch_norms(model, x):
    """The running statistics set to ``x``'s batch statistics (one
    training forward without gradients, every batch norm at momentum
    0): the eval state of a trained network, whose activations stay near
    unit scale, where a fresh model's identity statistics let them grow
    through depth (MobileNetV3-Large's last feature map reaches ~600)."""
    import torch
    from paddle_tpu_torch.nn.layers_conv_norm import _BatchNormBase
    bns = [m for m in model.sublayers() if isinstance(m, _BatchNormBase)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(x)
    for m, mom in zip(bns, momenta):
        m.momentum = mom
    model.eval()


def zoo_input(arch, batch, rng):
    import numpy as np
    import torch
    c, hw = {"LeNet": (1, 28), "inception_v3": (3, 299)}.get(arch, (3, 224))
    return torch.from_numpy(rng.standard_normal(
        (batch, c, hw, hw)).astype(np.float32))


def zoo_train_step(arch, device, state, x, y):
    """The loss and the gradients (on the host) of one training forward
    and backward, the key stream reseeded first (the same dropout masks
    on both devices)."""
    import paddle_tpu_torch as paddle
    model = zoo_model(arch, device, state)
    model.train()
    paddle.seed(SEED)
    loss = paddle.nn.CrossEntropyLoss()(model(x.to(device)), y.to(device))
    loss.float().backward()
    return float(loss.detach()), {k: p.grad.detach().float().cpu()
                                  for k, p in torch_named(model,
                                                          "parameters")}


def phase_vision_zoo_parity():
    """Every zoo family's default constructor on the card in f32 (TF32
    off, cuDNN deterministic) against the same model on the CPU, which
    the tier-1 tests hold against the JAX package, in eval with its
    batch norms calibrated on the batch; one training step for two of
    them; a bf16 eval forward's device ms at batch 64."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rows, failed = {}, []
    try:
        for i, arch in enumerate(ZOO_PARITY):
            t0 = time.perf_counter()
            paddle.seed(SEED + i)
            cpu = zoo_model(arch, "cpu")
            rng = np.random.default_rng(SEED + i)
            x = zoo_input(arch, ZOO_BATCH, rng)
            calibrate_batch_norms(cpu, x)
            state = {k: v.numpy() for k, v in cpu.state_dict().items()}
            card = zoo_model(arch, "cuda", state)
            card.eval()
            with torch.no_grad():
                want = cpu(x)
                got = card(x.cuda())
            # GoogLeNet returns (out, aux1, aux2)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            excess = [worst_excess(g, w, ZOO_TOL["logits"])
                      for g, w in zip(got, want)]
            row = {"outputs": len(got),
                   "logits_excess_max": max(e[0] for e in excess),
                   "logits_abs_err_max": max(e[1] for e in excess),
                   "params": sum(p.numel() for p in cpu.parameters())}
            if row["logits_excess_max"] > 0:
                failed.append((arch, "logits", row["logits_excess_max"]))
            del cpu
            if arch in ZOO_TRAIN:
                y = torch.from_numpy(rng.integers(0, 1000, (ZOO_BATCH,)))
                lc, gcard = zoo_train_step(arch, "cuda", state, x, y)
                lh, ghost = zoo_train_step(arch, "cpu", state, x, y)
                # a gradient that is zero by structure (a batch norm's
                # bias feeding the next batch norm) is rounding on both
                # sides: gated are the tensors that reach 1e-3 of the
                # largest
                top = max(float(g.abs().max()) for g in ghost.values())
                rels = {k: rel_rms(gcard[k], ghost[k]) for k in ghost
                        if float(ghost[k].abs().max()) >= 1e-3 * top}
                row["train"] = {
                    "loss_card": lc, "loss_cpu": lh,
                    "loss_rel_err": abs(lc - lh) / max(abs(lh), 1e-30),
                    "grad_rel_rms_max": max(rels.values()),
                    "grad_rel_rms_worst": max(rels, key=rels.get),
                    "grads_gated": len(rels), "grads": len(ghost),
                    "grad_rel_rms_global": rel_rms(
                        torch.cat([gcard[k].reshape(-1) for k in ghost]),
                        torch.cat([v.reshape(-1) for v in ghost.values()]))}
                if row["train"]["loss_rel_err"] > ZOO_TOL["loss"] or \
                        row["train"]["grad_rel_rms_max"] > ZOO_TOL["grad"]:
                    failed.append((arch, "train", row["train"]))
            card = card.bfloat16()
            xb = zoo_input(arch, ZOO_TIME_BATCH, rng).cuda().bfloat16()

            def fwd():
                with torch.no_grad():
                    card(xb)
            row["bf16_eval_ms_batch64"] = time_ms(fwd, samples=5, inner=2,
                                                  warmup=2)
            row["bf16_eval_imgs_per_s"] = \
                ZOO_TIME_BATCH / row["bf16_eval_ms_batch64"] * 1e3
            row["seconds"] = time.perf_counter() - t0
            rows[arch] = row
            del card, xb
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out = {"card": nvidia_smi_line(), "batch": ZOO_BATCH,
           "time_batch": ZOO_TIME_BATCH, "tol": ZOO_TOL,
           "eval_state": "batch norms calibrated on the batch "
                         "(calibrate_batch_norms)",
           "tf32": torch.backends.cudnn.allow_tf32,
           "grad_gate": "relative RMS per tensor whose CPU gradient "
                        "reaches 1e-3 of the model's largest",
           "models": rows}
    if failed:
        emit({"phase": "vision_zoo_parity", "failed": failed, **out})
        raise AssertionError(f"vision_zoo_parity: {failed}")
    return out


def ops_case(name, fn, inputs, diff=(), tol=OPS_TOL):
    """One device op on the card against the same call on the CPU: the
    outputs, and with ``diff`` the gradients of Σ out² with respect to
    those inputs, within ``tol``; the card's device ms of the forward."""
    import torch

    def run(dev):
        ins = [t.detach().to(dev).requires_grad_(i in diff)
               if t.is_floating_point() else t.to(dev)
               for i, t in enumerate(inputs)]
        outs = fn(*ins)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        if diff:
            sum(o.float().square().sum() for o in outs).backward()
        res = [o.detach() for o in outs] + [ins[i].grad for i in diff]
        return ins, [r.cpu() for r in res]
    ins, got = run("cuda")
    _, want = run("cpu")
    n_out = len(got) - len(diff)
    row, bad = {"outputs": n_out, "tol": tol}, []
    for j, (g, w) in enumerate(zip(got, want)):
        kind = "out" if j < n_out else "grad"
        ex, err = worst_excess(g, w, tol[kind])
        key = f"{kind}{j if j < n_out else j - n_out}"
        row[f"{key}_abs_err_max"] = err
        if ex > 0:
            bad.append((name, key, ex))
    plain = [t.detach() for t in ins]
    with torch.no_grad():
        row["card_ms"] = time_ms(lambda: fn(*plain), samples=5, inner=2,
                                 warmup=1)
    return row, bad


def phase_vision_ops_parity():
    """The detection ops on the card against the port on the CPU at a
    detector's sizes; the host ops checked equal, with their host ms."""
    import numpy as np
    import torch
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision import ops
    rng = np.random.default_rng(SEED)
    rows, failed = {}, []
    cfg = VISION_OPS
    c, fh, fw = cfg["fpn"]
    n, dc, dh, dw = cfg["deform"]

    def t(a):
        return torch.from_numpy(np.asarray(a))

    feat = t(rng.standard_normal((1, c, fh, fw)).astype(np.float32))
    boxes = t(zoo_boxes(rng, cfg["boxes"], fh, fw, 0.25))
    cases = [
        ("roi_align_7x7", lambda f, b: ops.roi_align(f, b, None, 7, 0.25),
         [feat, boxes], (0,), ROI_ALIGN_TOL),
        ("roi_pool_7x7", lambda f, b: ops.roi_pool(f, b, None, 7, 0.25),
         [feat, boxes], (0,), OPS_TOL),
        ("psroi_pool_7x7", lambda f, b: ops.psroi_pool(f, b, None, 7, 0.25),
         [t(rng.standard_normal((1, 490, fh, fw)).astype(np.float32)),
          boxes[:cfg["ps_boxes"]]], (0,), OPS_TOL),
        ("deform_conv2d_mask", lambda x, o, w, m: ops.deform_conv2d(
            x, o, w, padding=1, mask=m),
         [t(rng.standard_normal((n, dc, dh, dw)).astype(np.float32)),
          t((rng.standard_normal((n, 18, dh, dw)) * 2).astype(np.float32)),
          t((rng.standard_normal((dc, dc, 3, 3)) * 0.02).astype(
              np.float32)),
          t(rng.uniform(size=(n, 9, dh, dw)).astype(np.float32))],
         (0, 1, 2, 3), OPS_TOL),
    ]
    gn, gc_, gh, gw = cfg["grid"]
    xs = t(rng.standard_normal((gn, gc_, gh, gw)).astype(np.float32))
    grid = t(rng.uniform(-1.1, 1.1, (gn, gh, gw, 2)).astype(np.float32))
    for mode in ("bilinear", "nearest"):
        for pad in ("zeros", "border", "reflection"):
            for align in (True, False):
                cases.append((
                    f"grid_sample_{mode}_{pad}_{'ac' if align else 'nac'}",
                    lambda x, g, m=mode, p=pad, a=align: F.grid_sample(
                        x, g, mode=m, padding_mode=p, align_corners=a),
                    [xs, grid], (), OPS_TOL))
    yb = cfg["yolo_batch"]
    img = t(np.full((yb, 2), 416, np.int32))
    gt_box = t(np.concatenate([rng.uniform(20, 396, (yb, 50, 2)),
                               rng.uniform(10, 200, (yb, 50, 2))],
                              -1).astype(np.float32))
    gt_box[:, 40:] = 0.0                       # padded ground truths
    gt_label = t(rng.integers(0, 80, (yb, 50)).astype(np.int32))
    for size, stride, mask in YOLO_HEADS:
        head = t((rng.standard_normal((yb, 3 * 85, size, size)) * 0.5)
                 .astype(np.float32))
        anchors = [YOLO_ANCHORS[2 * k + j] for k in mask for j in (0, 1)]
        cases.append((f"yolo_box_{size}", lambda x, s, an=anchors, st=stride:
                      ops.yolo_box(x, s, an, 80, 0.01, st), [head, img], (),
                      OPS_TOL))
        cases.append((f"yolo_loss_{size}", lambda x, gb, gl, m=mask,
                      st=stride: ops.yolo_loss(x, gb, gl, YOLO_ANCHORS, m,
                                               80, 0.7, st),
                      [head, gt_box, gt_label], (), OPS_TOL))
    for name, fn, inputs, diff, tol in cases:
        row, bad = ops_case(name, fn, inputs, diff, tol)
        rows[name] = row
        failed += bad
    # the host ops: the same numbers from card and from CPU inputs
    host = {}
    nb = t(zoo_boxes(rng, cfg["nms_boxes"], fh, fw))
    sc = t(rng.uniform(size=cfg["nms_boxes"]).astype(np.float32))
    t0 = time.perf_counter()
    keep = ops.nms(nb.cuda(), 0.5, scores=sc.cuda())
    host["nms_ms"] = (time.perf_counter() - t0) * 1e3
    host["nms_boxes"] = cfg["nms_boxes"]
    host["nms_kept"] = int(keep.numel())
    host["nms_equal"] = torch.equal(keep.cpu(), ops.nms(nb, 0.5, scores=sc))
    mb = t(np.stack([zoo_boxes(rng, 500, 1, 1) for _ in range(2)]))
    ms = t(rng.uniform(size=(2, 21, 500)).astype(np.float32))
    t0 = time.perf_counter()
    got = ops.matrix_nms(mb.cuda(), ms.cuda(), 0.05, 0.05, 400, 100,
                         return_index=True)
    host["matrix_nms_ms"] = (time.perf_counter() - t0) * 1e3
    want = ops.matrix_nms(mb, ms, 0.05, 0.05, 400, 100, return_index=True)
    host["matrix_nms_equal"] = all(torch.equal(g.cpu(), w)
                                   for g, w in zip(got, want))
    a, h, w = 15, 50, 68
    scores = t(rng.uniform(size=(1, a, h, w)).astype(np.float32))
    deltas = t((rng.standard_normal((1, 4 * a, h, w)) * 0.1).astype(
        np.float32))
    anchors = t(np.tile(zoo_boxes(rng, a, 800, 1088)[None, None],
                        (h, w, 1, 1)))
    var = t(np.ones((h, w, a, 4), np.float32))
    im = t(np.asarray([[800, 1088]], np.float32))
    args = (scores, deltas, im, anchors, var)
    t0 = time.perf_counter()
    got = ops.generate_proposals(*[v.cuda() for v in args])
    host["generate_proposals_ms"] = (time.perf_counter() - t0) * 1e3
    want = ops.generate_proposals(*args)
    host["generate_proposals_equal"] = all(
        torch.equal(g.cpu(), w) for g, w in zip(got, want))
    host["proposals"] = int(got[2].sum())
    if not all(v for k, v in host.items() if k.endswith("_equal")):
        failed.append(("host ops", host))
    out = {"card": nvidia_smi_line(), "sizes": cfg,
           "tf32": torch.backends.cudnn.allow_tf32, "ops": rows,
           "host": host}
    if failed:
        emit({"phase": "vision_ops_parity", "failed": failed, **out})
        raise AssertionError(f"vision_ops_parity: {failed}")
    return out


# ---------------------------------------------------------------------------
# dy2static and the inference artifact
# ---------------------------------------------------------------------------

TO_STATIC = dict(calls=12, branch_calls=8)
LOGITS_GATE = 2e-2     # |got - ref| <= 2e-2 (1 + |ref|): the bf16 gate


def bf16_gate(got, ref):
    """(max |got - ref|, whether every element is within the bf16 gate)."""
    import torch
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= LOGITS_GATE * (1 + ref.float().abs())).all())
    return float(err.max()), ok


def k1_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    f = fa.flash_attention_fwd
    return f.launches, f.tma_launches


def reset_k1():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    f = fa.flash_attention_fwd
    f.launches = f.tma_launches = 0


def count_dtoh(fn):
    """Device-to-host copies of one call of ``fn`` as torch.profiler's
    device records show them, checked against the runtime's memcpy
    calls (the profiler can drop records at its window's ends)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for i in range(2):
            fn()
            torch.cuda.synchronize()
            if i == 1:
                time.sleep(0.05)
            prof.step()
    d2h = copies = calls = 0
    for ev in prof.key_averages():
        if ev.key.startswith("Memcpy "):
            copies += ev.count
            d2h += ev.count if "DtoH" in ev.key else 0
        elif ev.key.startswith("cudaMemcpy"):
            calls += ev.count
    return {"dtoh": d2h, "memcpy_records": copies, "memcpy_calls": calls}


def run_calls(fn, ref, n, what):
    """``n`` calls of ``fn`` (no grad), each output held to ``ref``:
    bit-equal, or else within the bf16 gate. Returns the per-call
    seconds (synchronized) and the largest error."""
    import torch
    secs, worst, equal = [], 0.0, True
    for i in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = out._t if hasattr(out, "_t") else out
        if not torch.equal(got, ref):
            equal = False
            err, ok = bf16_gate(got, ref)
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"{what}: call {i + 1} is outside the "
                                     f"bf16 gate of the eager logits "
                                     f"(max |err| {err})")
        del out, got
    return secs, worst, equal


def phase_to_static_gpt(results, device="cuda", layers=None, widths=None,
                        batch=None, seq=None):
    """GPT at GPT-3 13B widths through paddle.jit.to_static: SOT (record,
    op-by-op replay, CUDA-graph replays), full_graph=True, and a branch
    on the logits (guards: hits, misses, one fetch a replay)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    cuda = device == "cuda"
    layers = layers or GPT["layers"]
    batch, seq = batch or GPT["batch"], seq or GPT["seq"]
    n = TO_STATIC["calls"]
    if cuda:
        fresh_peak()
    model = gpt_model(layers, widths=widths, device=device)
    model.eval()
    vocab = model.config.vocab_size
    ids = gpt_ids(vocab, batch, seq)
    with paddle.no_grad():
        ref = model(ids)._t
        eager_ms = time_ms(lambda: model(ids), samples=5, inner=1) \
            if cuda else None
    reset_k1()
    paddle.jit.to_static(model)
    sot = model.forward
    with paddle.no_grad():
        secs, worst, equal = run_calls(lambda: model(ids), ref, n,
                                       "to_static_gpt (SOT)")
    sot_launches = k1_counts()
    st = dict(sot.stats)
    want = {"records": 1, "op_replays": 1 if cuda else n - 1,
            "graph_replays": n - 2 if cuda else 0}
    got = {k: st[k] for k in want}
    if got != want or sot.cache_size() != 1 or st["fallbacks"] \
            or st["eager_calls"]:
        raise AssertionError(f"to_static_gpt: SOT ran {st} with "
                             f"cache_size {sot.cache_size()}, expected "
                             f"{want}, one entry and no fallback")
    if cuda and sot_launches != (layers * n, layers * n):
        raise AssertionError(f"to_static_gpt: K1b launches (all, TMA) "
                             f"{sot_launches} != layers x calls = "
                             f"{layers * n}")
    sot_info = {"stats": st, "cache_size": sot.cache_size(),
                "k1b_launches": sot_launches[0],
                "k1b_tma_launches": sot_launches[1],
                "bit_equal_to_eager": equal, "max_abs_err": worst,
                "call_seconds": secs}
    if cuda:
        with paddle.no_grad():
            sot_info["replay_ms"] = time_ms(lambda: model(ids), samples=5,
                                            inner=1)
            sot_info["replay_host_us"] = host_us(lambda: model(ids), 5)
            sot_info["logits_clone_ms"] = time_ms(lambda: ref.clone(),
                                                  samples=5, inner=1)
        sot_info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        reset_k1()
    del model.forward                    # the class's forward again

    # full_graph=True: one graph for the signature
    reset_k1()
    static = paddle.jit.to_static(model, full_graph=True)
    with paddle.no_grad():
        secs2, worst2, equal2 = run_calls(lambda: static(ids), ref, n,
                                          "to_static_gpt (full_graph)")
    fg_launches = k1_counts()
    fst = dict(static.stats)
    want2 = {"eager_calls": 1 if cuda else n,
             "captures": 1 if cuda else 0, "replays": n - 1 if cuda else 0}
    if {k: fst[k] for k in want2} != want2 or \
            fst["fallbacks"] != ({} if cuda else {"device": n - 1}):
        raise AssertionError(f"to_static_gpt: full_graph ran {fst}, "
                             f"expected {want2}")
    if cuda and fg_launches != (layers * n, layers * n):
        raise AssertionError(f"to_static_gpt: full_graph K1b launches "
                             f"{fg_launches} != {layers * n}")
    fg_info = {"stats": fst, "k1b_launches": fg_launches[0],
               "bit_equal_to_eager": equal2, "max_abs_err": worst2,
               "call_seconds": secs2}
    if cuda:
        with paddle.no_grad():
            fg_info["replay_ms"] = time_ms(lambda: static(ids), samples=5,
                                           inner=1)
            fg_info["replay_host_us"] = host_us(lambda: static(ids), 5)

    # a branch on the logits: both paths taken, guards hit and miss
    ids_b = gpt_ids(vocab, batch, seq, seed=SEED + 1)
    with paddle.no_grad():
        ref_b = model(ids_b)._t
        m_a = float(ref[:, -1].float().mean())
        m_b = float(ref_b[:, -1].float().mean())
    thresh = (m_a + m_b) / 2

    def pick(x):
        last = model(x)[:, -1].astype("float32")
        if last.mean() > thresh:
            return last.argmax(axis=-1)
        return last.argmin(axis=-1)

    want_a = (ref[:, -1].float().argmax(-1) if m_a > thresh
              else ref[:, -1].float().argmin(-1))
    want_b = (ref_b[:, -1].float().argmax(-1) if m_b > thresh
              else ref_b[:, -1].float().argmin(-1))
    branch = paddle.jit.to_static(pick)
    with paddle.no_grad():
        for i in range(TO_STATIC["branch_calls"]):
            x, want_i = (ids, want_a) if i % 2 == 0 else (ids_b, want_b)
            got_i = branch(x)._t
            if not torch.equal(got_i, want_i.to(got_i.dtype)):
                raise AssertionError(f"to_static_gpt: branch call {i + 1} "
                                     f"differs from eager")
        bst = dict(branch.stats)
        fetch = count_dtoh(lambda: branch(ids)) if cuda else None
    replays = bst["op_replays"] + bst["graph_replays"]
    if bst["records"] != 2 or bst["guard_misses"] < 1 or replays < 1 \
            or bst["fallbacks"] or branch.cache_size() != 2:
        raise AssertionError(f"to_static_gpt: branch ran {bst}")
    if cuda and (fetch["dtoh"] != 1
                 or fetch["memcpy_records"] != fetch["memcpy_calls"]):
        raise AssertionError(f"to_static_gpt: a guarded replay made "
                             f"{fetch} device-to-host copies, expected 1")
    out = {"model": "gpt3-13b-width", "layers": layers, "batch": batch,
           "seq": seq, "vocab": vocab, "dtype": "bfloat16", "mode": "eval",
           "eager_ms": eager_ms, "sot": sot_info, "full_graph": fg_info,
           "branch": {"stats": bst, "cache_size": branch.cache_size(),
                      "threshold": thresh, "means": [m_a, m_b],
                      "profiled_replay": fetch}}
    if cuda:
        out["card"] = nvidia_smi_line()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        results["flash_attention_fwd"]["to_static_launches"] = \
            sot_launches[0]
        results["flash_attention_fwd"]["full_graph_launches"] = \
            fg_launches[0]
    del model, static, branch, ref, ref_b
    if cuda:
        torch.cuda.empty_cache()
    return out


EXPORT_RESNET = dict(batch=128, hw=224)
EXPORT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops.kernels import flash_attention as fa
paddle.set_device(sys.argv[3])
out = {"import_s": time.perf_counter() - t0}
for name in ("gpt", "resnet"):
    path = sys.argv[2] + "/" + name
    t = time.perf_counter()
    tl = paddle.jit.load(path)
    load_s = time.perf_counter() - t
    x = torch.load(path + "_in.pt").to(sys.argv[3])
    ref = torch.load(path + "_ref.pt").to(sys.argv[3])
    fa.flash_attention_fwd.launches = 0
    t = time.perf_counter()
    y = tl(x)._t
    if sys.argv[3] == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    k1b = fa.flash_attention_fwd.launches
    t = time.perf_counter()
    y2 = tl(x)._t
    if sys.argv[3] == "cuda":
        torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs()
    gate = 2e-2 * (1 + ref.float().abs())
    out[name] = {"type": type(tl).__name__, "load_s": load_s,
                 "first_forward_s": first_s,
                 "forward_s": time.perf_counter() - t,
                 "shape": list(y.shape), "dtype": str(y.dtype),
                 "k1b_launches": k1b, "max_abs_err": float(err.max()),
                 "within_gate": bool((err <= gate).all()),
                 "repeat_equal": bool(torch.equal(y, y2)),
                 "digest": float(y.float().sum())}
    del tl, x, ref, y, y2
out["imported"] = [m for m in ("paddle_tpu_torch.models.gpt",
                               "paddle_tpu_torch.vision.models.resnet",
                               "paddle_tpu_torch.vision")
                   if m in sys.modules]
out["seconds"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def export_and_hide(path, model, spec, x, ref):
    """save_inference_model(aot=True), then the payload's module renamed
    so that its class cannot be imported; the input and the eager
    output written beside it for the child."""
    import torch
    from paddle_tpu_torch.framework.checkpoint import load_checkpoint
    from paddle_tpu_torch.framework.io import save as _save
    from paddle_tpu_torch.inference import save_inference_model
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    save_inference_model(path, model, input_spec=[spec], aot=True)
    save_s = time.perf_counter() - t0
    # the rename rewrites a file this phase just wrote in a temporary
    # directory: read without the CRC check, written without fsync
    payload = load_checkpoint(path + ".pdmodel", device="cpu", verify=False)
    blob = len(payload["aot"]["blob"])
    payload["module"] = "chip_smoke_unimportable." + payload["module"]
    fsync = paddle.get_flags(["FLAGS_checkpoint_fsync"])
    paddle.set_flags({"FLAGS_checkpoint_fsync": False})
    try:
        _save(payload, path + ".pdmodel")
    finally:
        paddle.set_flags(fsync)
    torch.save(x.cpu(), path + "_in.pt")
    torch.save(ref.cpu(), path + "_ref.pt")
    return {"save_s": save_s, "payload_bytes":
            os.path.getsize(path + ".pdmodel"), "blob_bytes": blob}


def phase_jit_export(results, device="cuda", layers=None, widths=None,
                     batch=None, seq=None, resnet=None):
    """save_inference_model(aot=True) of GPT (13B widths) and ResNet-50
    (NHWC bf16, batch 128 at 224^2), their classes made unimportable,
    then jit.load -> TranslatedLayer in one fresh child process."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.vision.models import resnet50
    cuda = device == "cuda"
    layers = layers or GPT["layers"]
    batch, seq = batch or GPT["batch"], seq or GPT["seq"]
    rn = dict(EXPORT_RESNET, **(resnet or {}))
    root = tempfile.mkdtemp(prefix="jit-export-")
    try:
        model = gpt_model(layers, widths=widths, device=device)
        model.eval()
        ids = gpt_ids(model.config.vocab_size, batch, seq)
        with paddle.no_grad():
            ref = model(ids)._t
        gpt = export_and_hide(os.path.join(root, "gpt"), model,
                              InputSpec([batch, seq], "int64"), ids._t, ref)
        del model, ref
        paddle.seed(SEED)
        net = resnet50(data_format="NHWC")
        net = net.to(device=device, dtype="bfloat16")
        net.eval()
        rng = np.random.default_rng(SEED)
        x = torch.from_numpy(rng.standard_normal(
            (rn["batch"], rn["hw"], rn["hw"], 3)).astype(np.float32)) \
            .to(device=device, dtype=torch.bfloat16)
        with paddle.no_grad():
            ref = net(x)
            ref = ref._t if hasattr(ref, "_t") else ref
        res = export_and_hide(os.path.join(root, "resnet"), net,
                              InputSpec(list(x.shape), "bfloat16"), x, ref)
        del net, x, ref
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, str(ROOT), root, device],
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"jit_export: the child failed "
                                 f"({proc.returncode}): "
                                 f"{proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    problems = []
    if child["imported"]:
        problems.append(f"the child imported {child['imported']}")
    for name in ("gpt", "resnet"):
        c = child[name]
        if c["type"] != "TranslatedLayer" or not c["within_gate"]:
            problems.append(f"{name}: {c}")
    if cuda and child["gpt"]["k1b_launches"] != layers:
        problems.append(f"gpt: K1b launches in the child "
                        f"{child['gpt']['k1b_launches']} != {layers}")
    if not gpt["blob_bytes"] < 0.01 * gpt["payload_bytes"]:
        problems.append(f"gpt: the program holds {gpt['blob_bytes']} of "
                        f"the payload's {gpt['payload_bytes']} bytes")
    if problems:
        raise AssertionError("jit_export: " + "; ".join(problems))
    if cuda:
        results["flash_attention_fwd"]["jit_export_child_launches"] = \
            child["gpt"]["k1b_launches"]
    return {"card": nvidia_smi_line() if cuda else None,
            "gpt": {"layers": layers, "batch": batch, "seq": seq, **gpt},
            "resnet50": {"layout": "NHWC", "dtype": "bfloat16", **rn,
                         **res},
            "child": child, "child_wall_s": child_s,
            "gate": f"|err| <= {LOGITS_GATE} (1 + |ref|)"}


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


# ---------------------------------------------------------------------------
# flash attention over unequal query and key lengths; Transformer-base;
# the PTB LSTM and its beam search; the op tail on the card
# ---------------------------------------------------------------------------

# (name, B, Lq, Lk, H, D, causal, dropout_p), each in bf16 and on a
# smaller f32 copy (B and H cut to 4 at most): the Transformer's
# cross-attention (with and without dropout), a KV-cache step (Lq 1, at
# D 128 causal: the diagonal offset), queries outnumbering keys under
# causal (rows with no allowed key), a chunk against its history
FLASH_CROSS = (
    ("transformer_cross", 128, 96, 128, 8, 64, False, 0.0),
    ("transformer_cross_dropout", 128, 96, 128, 8, 64, False, 0.1),
    ("cache_step", 64, 1, 200, 8, 64, False, 0.0),
    ("cache_step_causal_d128", 16, 1, 200, 32, 128, True, 0.0),
    ("more_queries_causal", 4, 300, 200, 8, 64, True, 0.0),
    ("more_queries_causal_d128", 4, 300, 200, 8, 128, True, 0.0),
    ("history_chunk_causal", 4, 512, 2048, 32, 128, True, 0.0),
    ("history_chunk", 4, 512, 2048, 32, 128, False, 0.0),
)
CROSS_KEY = (0x5EED1234, 0x0BADF00D)


def cross_inputs(B, Lq, Lk, H, D, dtype, seed):
    """Seeded q, do [B, Lq, H, D] and k, v [B, Lk, H, D] on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, L, H, D), generator=g,
                               device="cuda").to(dtype)
                   for L in (Lq, Lk, Lk, Lq))
    return q, k, v, do


def cross_key():
    import torch
    return torch.tensor(CROSS_KEY, dtype=torch.int64, device="cuda")


def cross_work(B, Lq, Lk, H, D, causal, products, q_tensors, k_tensors,
               stats, elem_bytes=2):
    """(flops, bytes) of ``products`` matrix products over the attended
    pairs (causal: row i sees min(Lk, max(0, i + Lk - Lq + 1)) keys),
    reading or writing ``q_tensors`` [B, Lq, H, D] and ``k_tensors``
    [B, Lk, H, D] tensors and ``stats`` f32 [B, H, Lq] arrays once."""
    if causal:
        off = Lk - Lq
        pairs = sum(min(Lk, max(0, i + off + 1)) for i in range(Lq))
    else:
        pairs = Lq * Lk
    flops = products * 2 * B * H * pairs * D
    nbytes = ((q_tensors * Lq + k_tensors * Lk) * B * H * D * elem_bytes
              + stats * B * H * Lq * 4)
    return flops, nbytes


def phase_flash_cross_parity(results):
    """K1a/K2a (with K5) and K1b/K2b at Lq != Lk: each kernel alone
    against its plain version on the same inputs (the backward kernels on
    the plain forward's lse and delta), in bf16 and on f32 copies, one
    launch each through the design expected; the autograd function
    against autograd through the plain sdpa where rows have no allowed
    key; the bf16 times at the Transformer geometry against SDPA."""
    import torch
    from paddle_tpu_torch.nn.functional import sdpa_reference
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rows, failed = [], []
    for i, (case, B, Lq, Lk, H, D, causal, p) in enumerate(FLASH_CROSS):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            b, h = (B, H) if dtype == torch.bfloat16 else (min(B, 4),
                                                           min(H, 4))
            q, k, v, do = cross_inputs(b, Lq, Lk, h, D, dtype, 300 + i)
            kw = {"dropout_p": p, "seed": cross_key()} if p else {}
            ref = plain_all(q, k, v, do, causal, **kw)
            delta = fa.attention_delta(ref[0], do)
            before = flash_counts()
            got = kernels_all(q, k, v, do, causal, ref[1], delta, **kw)
            torch.cuda.synchronize()
            paths = flash_paths(before)
            ref32 = plain_all(*(x.float() for x in (q, k, v, do)), causal,
                              **kw)
            tma = flash_tma_expected(dtype, (b, Lq, h, D), dropout=p > 0)
            row = {"case": case, "q": [b, Lq, h, D], "k": [b, Lk, h, D],
                   "causal": causal, "dropout_p": p, "dtype": dname,
                   "design": "tma_wgmma" if tma else "general_mma_sync",
                   "launches_and_tma_launches": paths}
            ok = parity_row(row, got, ref, ref32, dname)
            row["ok"] = ok = ok and paths == [(1, int(tma))] * 3
            rows.append(row)
            if not ok:
                failed.append(row)
            if case == "transformer_cross_dropout" and \
                    dtype == torch.bfloat16:
                record_errors(results, "_cross", row)
            del q, k, v, do, ref, ref32, got
            torch.cuda.empty_cache()
    # the autograd function (which fills the rows with no allowed key as
    # the oracle does) against autograd through the plain sdpa
    auto = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for (Lq, Lk, causal) in ((96, 128, False), (300, 200, True),
                                 (1, 200, True)):
            q, k, v, do = cross_inputs(2, Lq, Lk, 8, 64, dtype, 7)
            before = flash_counts()
            r = autograd_row(
                q, k, v, do,
                lambda a, b_, c, cz=causal: fa.flash_attention(a, b_, c, cz),
                lambda a, b_, c, cz=causal: sdpa_reference(a, b_, c,
                                                           causal=cz),
                dname)
            paths = flash_paths(before)
            tma = flash_tma_expected(dtype, q.shape)
            r.update(q=list(q.shape), k=list(k.shape), causal=causal,
                     launches_and_tma_launches=paths)
            r["ok"] &= paths == [(1, int(tma))] * 3
            auto.append(r)
            if not r["ok"]:
                failed.append({"autograd": r})
    finish_parity("flash_cross_parity", results, ("_cross",), failed)
    times = {name: cross_timings(*geo) for name, geo in (
        ("transformer_cross_dropout", (128, 96, 128, 8, 64, False, 0.1)),
        ("transformer_cross", (128, 96, 128, 8, 64, False, 0.0)),
        ("history_chunk_causal", (4, 512, 2048, 32, 128, True, 0.0)))}
    fill_times(results, "_cross", times["transformer_cross_dropout"])
    return {"card": nvidia_smi_line(), "cases": rows, "autograd": auto,
            "times": times}


def cross_timings(B, Lq, Lk, H, D, causal, p):
    """Kernel, plain and library times of the three flash functions at
    one cross-length geometry in bf16, beside their bounds (the work of
    cross_work; SDPA gets the same values as [B, H, L, D] and the same
    causal flag and dropout, whose mask is its own)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, do = cross_inputs(B, Lq, Lk, H, D, torch.bfloat16, 11)
    kw = {"dropout_p": p, "seed": cross_key()} if p else {}
    out, lse = fa.flash_attention_fwd(q, k, v, causal, None, **kw)
    delta = fa.attention_delta(out, do)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_kw = {"is_causal": causal, "dropout_p": p}
    if causal and Lq != Lk:
        # SDPA's is_causal puts the diagonal at j <= i: the offset one as
        # a bool mask
        lib_kw = {"attn_mask": torch.ones(Lq, Lk, dtype=torch.bool,
                                          device="cuda").tril(Lk - Lq),
                  "dropout_p": p}
    rows = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal, None, **kw),
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal, None,
                                                     **kw),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw),
            2, 2, 2, 1),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              causal, None, **kw),
            lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, do, lse, delta, causal, None, **kw),
            None, 3, 3, 2, 2),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               causal, None, **kw),
            lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, causal, None, **kw),
            None, 4, 2, 4, 2)}
    table = {}
    for name, (kern, plain, lib, prods, nq, nk, stats) in rows.items():
        flops, nbytes = cross_work(B, Lq, Lk, H, D, causal, prods, nq, nk,
                                   stats)
        b_ms, b_by = bound(flops, nbytes)
        r = {"design": "tma_wgmma" if fa.takes_tma(
                 q, k, v, do, dropout_p=p) else "general_mma_sync",
             "q": [B, Lq, H, D], "k": [B, Lk, H, D], "causal": causal,
             "dropout_p": p,
             "kernel_ms": time_ms(kern, samples=10, inner=5),
             "general_ms": None,
             "plain_ms": time_ms(plain, samples=5, inner=1),
             "library_ms": time_ms(lib, samples=10, inner=5)
             if lib else None,
             "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
             "bytes": nbytes}
        r["share_of_bound"] = b_ms / r["kernel_ms"]
        table[name] = r
    # SDPA's backward at the same geometry: its forward + backward through
    # torch.autograd.grad, less its forward (one library call computes dQ
    # and dK/dV together)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2).contiguous()

    def lib_both():
        o = F.scaled_dot_product_attention(qg, kg, vg, **lib_kw)
        torch.autograd.grad(o, (qg, kg, vg), dot)
    both = time_ms(lib_both, samples=10, inner=5)
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        table[name]["library_fwd_bwd_ms"] = both
        table[name]["library_bwd_ms"] = \
            both - table["flash_attention_fwd"]["library_ms"]
    return table


# Transformer-base of "Attention Is All You Need" (Vaswani et al., 2017,
# Table 3: d_model 512, 8 heads, 6 + 6 layers, d_ff 2048, dropout 0.1,
# label smoothing 0.1, Adam 0.9 / 0.98 / 1e-9 on the Noam schedule with
# 4000 warm-up steps) over WMT14 en-de's shared 37,000-token BPE
# vocabulary; 128 sentence pairs of 128 source and 96 target tokens
TRANSFORMER_BASE = dict(vocab=37000, d_model=512, heads=8, layers=6,
                        ffn=2048, dropout=0.1, batch=128, src_len=128,
                        tgt_len=96, warmup=2, steps=20, smoothing=0.1,
                        warmup_steps=4000)


def sinusoid_positions(n, d):
    """The fixed sinusoidal position table [n, d] of the paper (sin on
    the even channels, cos on the odd)."""
    import torch
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    inv = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
    table = torch.zeros(n, d, dtype=torch.float64)
    table[:, 0::2] = torch.sin(pos * inv)
    table[:, 1::2] = torch.cos(pos * inv)
    return table.float()


def transformer_mt(cfg, device, dtype):
    """chip_smoke.py's translation model around the port's
    ``nn.Transformer``: one embedding shared by source and target, scaled
    by sqrt(d_model), plus the sinusoidal positions and dropout; the
    output projection tied to the embedding; the decoder's self-attention
    under ``generate_square_subsequent_mask``."""
    import torch
    import paddle_tpu_torch as paddle

    class TransformerMT(torch.nn.Module):
        def __init__(self):
            super().__init__()
            d = cfg["d_model"]
            self.scale = math.sqrt(d)
            g = torch.Generator(device="cpu").manual_seed(SEED)
            self.embed = torch.nn.Parameter(
                (torch.randn(cfg["vocab"], d, generator=g) * d ** -0.5)
                .to(device, dtype))
            self.transformer = paddle.nn.Transformer(
                d, cfg["heads"], cfg["layers"], cfg["layers"], cfg["ffn"],
                cfg["dropout"], device=device, dtype=dtype)
            n = max(cfg["src_len"], cfg["tgt_len"])
            self.register_buffer("pos", sinusoid_positions(n, d).to(
                device, dtype))
            self.drop = paddle.nn.Dropout(cfg["dropout"])
            self.register_buffer(
                "tgt_mask", paddle.nn.Transformer
                .generate_square_subsequent_mask(cfg["tgt_len"])._t
                .to(device))

        def embed_ids(self, ids):
            e = torch.nn.functional.embedding(ids, self.embed)
            return self.drop(e * self.scale + self.pos[:ids.shape[1]])

        def forward(self, src, tgt):
            h = self.transformer(self.embed_ids(src), self.embed_ids(tgt),
                                 tgt_mask=self.tgt_mask)
            return h @ self.embed.t()

    torch.manual_seed(SEED)       # torch.nn.Linear's own initialisation
    return TransformerMT()


def transformer_group(kernel: str) -> str:
    """Transformer-base's kernel groups by name: the flash kernels, GEMMs
    (the projections, the tied output projection and the masked
    self-attention's two batched products), the optimizer's multi-tensor
    kernels, the softmax passes (the masked attention's and the
    cross-entropy's), and the rest (the Philox keep-mask draws, dropout,
    layer norms, residual adds, embedding)."""
    kl = kernel.lower()
    if "softmax" in kl:
        return "softmax"
    return train_group(kernel)


def masked_attention_ms(cfg, dtype):
    """Device ms of the decoder's masked self-attention of one layer
    (sdpa_reference, forward + backward, with its dropout) and of its
    keep-mask draw alone, at the phase's geometry."""
    import torch
    from paddle_tpu_torch.nn.functional import sdpa_reference
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, L, H = cfg["batch"], cfg["tgt_len"], cfg["heads"]
    D = cfg["d_model"] // H
    q, k, v, do = cross_inputs(B, L, L, H, D, dtype, 5)
    mask = (1.0 - torch.ones(L, L, device="cuda").tril()) * -1e9
    key = cross_key()
    xs = [x.requires_grad_() for x in (q, k, v)]

    def attn():
        o = sdpa_reference(*xs, mask=mask, dropout_p=cfg["dropout"],
                           seed=key)
        torch.autograd.grad(o, xs, do)

    def draw():
        fa.flash_dropout_keep_mask(key, B, H, L, cfg["dropout"], Lk=L)
    return (time_ms(attn, samples=5, inner=2),
            time_ms(draw, samples=5, inner=2))


def seq2seq_state(model, opt):
    """Copies of the parameters and of Adam's two moments."""
    params = {k: p.detach().clone()
              for k, p in torch_named(model, "parameters")}
    moments = {f"{i}.{m}": s[m].detach().clone()
               for i, s in sorted(opt._states.items())
               for m in ("moment1", "moment2") if m in s}
    return params, moments


def compare_seq2seq(got, want):
    """Worst relative RMS of the parameters and of the moments (None for
    an optimizer without them), and whether every tensor is bit-equal."""
    import torch
    out, equal = {}, True
    for name, a, b in zip(("params", "moments"), got, want):
        out[name] = max((rel_rms(a[k], b[k]) for k in b), default=None)
        equal = equal and all(torch.equal(a[k], b[k]) for k in b)
    out["bit_equal"] = equal
    return out


def captured_vs_eager(phase, model, make_opt, crit, batch, cfg,
                      sched=False, after_captured=None):
    """``cfg["warmup"]`` TrainStep calls, then ``cfg["steps"]`` timed
    replays (one graph, no fallback), then the same steps through a plain
    eager loop from the copied weights and the restored key stream, the
    losses and the parameters and moments held to each other
    (RESNET_LOSS_RTOL, RESNET_STATE_RMS). With ``sched`` the optimizer's
    LR scheduler is stepped after every step on both sides;
    ``after_captured`` is called between the two runs."""
    import torch
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.jit import TrainStep
    opt = make_opt()
    step = TrainStep(model, crit, opt)
    sched = opt._learning_rate if sched else None
    params0 = {k: p.detach().clone()
               for k, p in torch_named(model, "parameters")}
    rng0 = trandom.get_rng_state()
    mem_start = fresh_peak()
    t1 = time.perf_counter()
    losses = []
    for _ in range(cfg["warmup"]):
        losses.append(step(*batch))
        if sched is not None:
            sched.step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    timed, wall, captured = timed_replays(
        step, batch, cfg["steps"],
        on_step=sched.step if sched is not None else None)
    losses += timed
    capture = check_captured(phase, step, captured, cfg["steps"])
    peak = torch.cuda.max_memory_allocated()
    loss_values = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in loss_values):
        raise AssertionError(f"{phase}: non-finite loss {loss_values}")
    cap = seq2seq_state(model, opt)
    rng_cap = list(trandom.get_rng_state())
    if after_captured is not None:
        after_captured()
    out = {"losses": loss_values, "first_steps_s": first_s,
           "step_ms": wall / cfg["steps"] * 1e3, "capture": capture,
           "peak_mem_gb": peak / 2 ** 30,
           "mem_at_start_gb": mem_start / 2 ** 30, "step": step}
    # the same steps through a plain eager loop from the same start
    with torch.no_grad():
        for k, p in torch_named(model, "parameters"):
            p.copy_(params0[k])
    opt = make_opt()
    sched = opt._learning_rate if sched is not None else None
    trandom.set_rng_state(rng0)
    eager = []
    n = cfg["warmup"] + cfg["steps"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(n):
        loss = crit(model(*batch[:-1]), batch[-1]).float()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        eager.append(loss.detach())
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t2) / n * 1e3
    eager = [float(v) for v in eager]
    vs = compare_seq2seq(cap, seq2seq_state(model, opt))
    vs["loss_rel_err_max"] = max(abs(a - e) / max(abs(e), 1e-30)
                                 for a, e in zip(loss_values, eager))
    vs["losses_bit_equal"] = loss_values == eager
    vs["rng_state_captured"] = rng_cap
    vs["rng_state_eager"] = list(trandom.get_rng_state())
    vs["eager_step_ms_mean"] = eager_ms
    vs["tol"] = {"loss_rtol": RESNET_LOSS_RTOL,
                 "state_rms": RESNET_STATE_RMS}
    if vs["loss_rel_err_max"] > RESNET_LOSS_RTOL or max(
            vs["params"], vs["moments"] or 0.0) > RESNET_STATE_RMS or \
            rng_cap != vs["rng_state_eager"]:
        emit({"phase": phase, "failed": vs})
        raise AssertionError(f"{phase}: the replays disagree with the "
                             f"eager loop")
    out["vs_eager"] = vs
    return out


def phase_transformer_base_train(results):
    """Transformer-base at the published widths, bf16, through the
    captured TrainStep (2 warm-up steps, 20 timed replays), then the same
    22 steps in a plain eager loop; the encoder's self-attention and the
    cross-attention (Lq 96 against Lk 128) on K1a/K2a with K5, the
    decoder's masked self-attention on the plain sdpa."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    cfg = TRANSFORMER_BASE
    paddle.set_device("gpu")
    paddle.seed(SEED)
    t0 = time.perf_counter()
    model = transformer_mt(cfg, "cuda", torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    B, S, T, V = cfg["batch"], cfg["src_len"], cfg["tgt_len"], cfg["vocab"]
    src = torch.from_numpy(rng.integers(0, V, (B, S))).cuda()
    tgt = torch.from_numpy(rng.integers(0, V, (B, T + 1))).cuda()
    tgt_in, tgt_out = tgt[:, :-1].contiguous(), tgt[:, 1:].contiguous()

    def make_opt():
        sched = paddle.optimizer.lr.NoamDecay(
            d_model=cfg["d_model"], warmup_steps=cfg["warmup_steps"])
        return paddle.optimizer.Adam(
            learning_rate=sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
            parameters=list(model.parameters()))
    crit = paddle.nn.CrossEntropyLoss(label_smoothing=cfg["smoothing"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    wrappers = flash_wrappers()
    marks = {}

    def counts():
        return [(w.launches, w.tma_launches, w.dropout_launches)
                for w in wrappers]
    marks["start"] = counts()
    run = captured_vs_eager("transformer_base_train", model, make_opt,
                            crit, (src, tgt_in, tgt_out), cfg, sched=True,
                            after_captured=lambda: marks.update(
                                captured=counts()))
    step = run.pop("step")
    # the wrappers count the warm-up steps' launches (eager, then the
    # capture) and each replay adds what its capture counted; what a
    # replay launches on the card is read off a profiled replay: 6 encoder
    # self-attentions and 6 cross-attentions, each on the TMA design
    wrapper = [tuple(a - b for a, b in zip(x, y))
               for x, y in zip(marks["captured"], marks["start"])]
    per_step = 2 * cfg["layers"]
    prof = profile_train_step(
        step, (src, tgt_in, tgt_out), transformer_group,
        ("flash_fwd", "flash_dq", "flash_dkv", "gemm", "softmax",
         "optimizer", "other"), named=("flash_fwd", "flash_dq",
                                       "flash_dkv"))
    one_replay = {g: prof["group_launches"][g]
                  for g in ("flash_fwd", "flash_dq", "flash_dkv")}
    not_tma = [k for g in one_replay for k in prof["named_kernels"][g]
               if "tma" not in k[0]]
    if any(n != per_step for n in one_replay.values()) or not_tma or \
            any(w[0] == 0 or w[1] != w[0] or w[2] != w[0] for w in wrapper):
        raise AssertionError(
            f"transformer_base_train: a replay launched {one_replay} flash "
            f"kernels (not {per_step} each on the TMA design: {not_tma}); "
            f"the wrappers counted (launches, TMA, dropout) {wrapper}")
    for (name, g), w in zip((("flash_attention_fwd_cross", "flash_fwd"),
                             ("flash_attention_bwd_dq_cross", "flash_dq"),
                             ("flash_attention_bwd_dkv_cross", "flash_dkv")),
                            wrapper):
        results[name].update(launches=w[0], tma_launches=w[1],
                             launches_in_replays=one_replay[g]
                             * cfg["steps"])
    want = (cfg["warmup"] + cfg["steps"]) * per_step
    if any(w[0] != want for w in wrapper):
        raise AssertionError(f"transformer_base_train: the wrappers counted "
                             f"{wrapper} launches, not {want} each")
    masked_ms, draw_ms = masked_attention_ms(cfg, torch.bfloat16)
    tokens = B * (S + T)
    step_ms = run["step_ms"]
    out = {"card": nvidia_smi_line(),
           "model": "Transformer-base (Vaswani et al. 2017, Table 3)",
           "config": dict(cfg), "params": n_params, "dtype": "bfloat16",
           "init_seconds": init_s, **run,
           "tokens_per_step": tokens,
           "tokens_per_s": tokens / step_ms * 1e3,
           "eager_tokens_per_s":
               tokens / run["vs_eager"]["eager_step_ms_mean"] * 1e3,
           "flash_wrapper_launches_tma_dropout": wrapper,
           "flash_launches_one_replay": one_replay,
           "flash_launches_timed_replays": {g: n * cfg["steps"] for g, n
                                            in one_replay.items()},
           "profile_one_replay": prof,
           "device_idle_share_of_timed_step":
               1 - prof["device_ms"] / step_ms if prof["device_ms"]
               else None,
           "masked_self_attention_ms_per_layer": masked_ms,
           "keep_mask_draw_ms_per_layer": draw_ms,
           "masked_self_attention_share_of_replay":
               masked_ms * cfg["layers"] / prof["device_ms"]
               if prof["device_ms"] else None}
    del step, model
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the "large" PTB LSTM of Zaremba, Sutskever and Vinyals (2014): 2 layers
# of 1500, dropout 0.65, 35 unrolled steps at batch 20, SGD at lr 1 with
# the gradient's global norm clipped at 10, a 10,000-word vocabulary;
# its beam search: beam 4, up to 32 steps, tokens 0 (start) and 1 (end)
PTB_LSTM = dict(vocab=10000, hidden=1500, layers=2, dropout=0.65,
                batch=20, unroll=35, lr=1.0, clip=10.0, warmup=2,
                steps=20, beam=4, max_step=32, start=0, end=1)
BEAM_TOL = 1e-4


def lstm_lm(cfg):
    """chip_smoke.py's word-level language model around the port's
    ``nn.LSTM``: an embedding, dropout on its output and on the LSTM's,
    and the output projection (f32, the current device)."""
    import torch
    import paddle_tpu_torch as paddle

    class LSTMLM(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            V, H = cfg["vocab"], cfg["hidden"]
            self.embed = paddle.nn.Embedding(V, H)
            self.drop = paddle.nn.Dropout(cfg["dropout"])
            self.lstm = paddle.nn.LSTM(H, H, num_layers=cfg["layers"],
                                       dropout=cfg["dropout"])
            self.proj = paddle.nn.Linear(H, V)

        def forward(self, ids):
            out, _ = self.lstm(self.drop(self.embed(ids)))
            return self.proj(self.drop(out))

    del torch
    return LSTMLM()


def beam_parity(got, ref):
    """The card's beam search against the CPU's: per batch row the ids
    of every step equal, and the scores within BEAM_TOL·(1 + |ref|); a
    row whose two runs part at a step where their top scores still agree
    within that tolerance (a near-tie: other candidates of equal score)
    is compared up to that step and counted."""
    import torch
    (ids_g, sc_g, tok_g, par_g), (ids_c, sc_c, tok_c, par_c) = got, ref
    parted, worst, ok = [], 0.0, True
    for b in range(ids_c.shape[0]):
        same = (tok_g[:, b] == tok_c[:, b]).all(-1) & \
            (par_g[:, b] == par_c[:, b]).all(-1)
        steps = int(same.long().cumprod(0).sum())
        upto = min(steps + 1, sc_c.shape[0])
        err = ((sc_g[:upto, b] - sc_c[:upto, b]).abs()
               / (BEAM_TOL * (1 + sc_c[:upto, b].abs()))).max()
        worst = max(worst, float(err))
        if steps < sc_c.shape[0]:
            parted.append([b, steps])
        elif not torch.equal(ids_g[b], ids_c[b]):
            ok = False
    return ok and worst <= 1.0, worst, parted


def run_beam(cfg, cell, embed, proj, device):
    """dynamic_decode of a BeamSearchDecoder over ``cell`` from zero
    states at batch ``cfg["batch"]``: (final ids, per-step scores, tokens
    and parents), on the host, and the decode's wall ms."""
    import torch
    import paddle_tpu_torch as paddle
    dec = paddle.nn.BeamSearchDecoder(cell, cfg["start"], cfg["end"],
                                      cfg["beam"], embedding_fn=embed,
                                      output_fn=proj)
    ref = torch.zeros(cfg["batch"], cfg["hidden"], device=device)
    inits = cell.get_initial_states(ref)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, states = paddle.nn.dynamic_decode(dec, inits,
                                           max_step_num=cfg["max_step"])
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    del states
    return out._t.cpu(), ms


def port_clone(layer, make):
    """``make()`` built on the CPU holding ``layer``'s tensors."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as tdevice
    prev = tdevice._current
    paddle.set_device("cpu")
    try:
        twin = make()
    finally:
        tdevice._current = prev
    state = {k: v.detach().cpu()
             for k, v in torch.nn.Module.state_dict(layer).items()}
    torch.nn.Module.load_state_dict(twin, state)
    return twin


def phase_lstm_lm_beam(results):
    """The PTB LSTM through the captured TrainStep (2 warm-up steps, 20
    timed replays) against the eager loop, in f32 without TF32; then
    beam search with an LSTMCell of the same width over its embedding and
    projection on the card, against the same decode on the CPU."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import decode as tdecode
    cfg = PTB_LSTM
    record_beam_steps()
    paddle.set_device("gpu")
    paddle.seed(SEED)
    t0 = time.perf_counter()
    model = lstm_lm(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    B, T, V = cfg["batch"], cfg["unroll"], cfg["vocab"]
    ids = torch.from_numpy(rng.integers(0, V, (B, T + 1))).cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()

    def make_opt():
        return paddle.optimizer.SGD(
            learning_rate=cfg["lr"], parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(cfg["clip"]))
    crit = paddle.nn.CrossEntropyLoss()
    init_s = time.perf_counter() - t0
    run = captured_vs_eager("lstm_lm_beam", model, make_opt, crit, (x, y),
                            cfg)
    step = run.pop("step")
    prof = profile_train_step(step, (x, y), train_group,
                              ("gemm", "optimizer", "other",
                               "flash_fwd", "flash_dq", "flash_dkv"))
    del step
    # beam search: the card, then the CPU on copies of the same weights
    cell = paddle.nn.LSTMCell(cfg["hidden"], cfg["hidden"])
    model.eval()
    got_ids, ms = run_beam(cfg, cell, model.embed, model.proj, "cuda")
    steps_gpu = _last_steps(tdecode)
    cpu_cell = port_clone(cell, lambda: paddle.nn.LSTMCell(cfg["hidden"],
                                                           cfg["hidden"]))
    cpu_embed = port_clone(model.embed, lambda: paddle.nn.Embedding(
        V, cfg["hidden"]))
    cpu_proj = port_clone(model.proj, lambda: paddle.nn.Linear(
        cfg["hidden"], V))
    from paddle_tpu_torch.core import device as tdevice
    prev = tdevice._current
    paddle.set_device("cpu")
    try:
        ref_ids, cpu_ms = run_beam(cfg, cpu_cell, cpu_embed, cpu_proj,
                                   "cpu")
        steps_cpu = _last_steps(tdecode)
    finally:
        tdevice._current = prev
    ok, worst, parted = beam_parity((got_ids, *steps_gpu),
                                    (ref_ids, *steps_cpu))
    beam = {"batch": B, "beam": cfg["beam"], "max_step_num":
            cfg["max_step"], "steps": int(steps_cpu[0].shape[0]),
            "ids_shape": list(ref_ids.shape), "decode_ms": ms,
            "cpu_decode_ms": cpu_ms, "score_tol_used": worst,
            "rows_parted_at_near_ties": parted, "ok": ok}
    if not ok:
        emit({"phase": "lstm_lm_beam", "failed": beam})
        raise AssertionError("lstm_lm_beam: the card's beam search "
                             "disagrees with the CPU's")
    tokens = B * T
    out = {"card": nvidia_smi_line(),
           "model": "PTB large LSTM (Zaremba et al. 2014)",
           "config": dict(cfg), "params": n_params, "dtype": "float32",
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "init_seconds": init_s, **run,
           "tokens_per_s": tokens / run["step_ms"] * 1e3,
           "eager_tokens_per_s":
               tokens / run["vs_eager"]["eager_step_ms_mean"] * 1e3,
           "profile_one_replay": prof,
           "device_idle_share_of_timed_step":
               1 - prof["device_ms"] / run["step_ms"] if prof["device_ms"]
               else None,
           "beam_search": beam}
    del model, cell
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _last_steps(tdecode):
    """The per-step scores, tokens and parents of the last
    dynamic_decode, on the host (recorded by record_beam_steps)."""
    return [t.cpu() for t in tdecode.BeamSearchDecoder._chip_last]


def record_beam_steps():
    """Wrap BeamSearchDecoder.finalize to keep each decode's stacked
    per-step outputs (scores, tokens, parents) for beam_parity."""
    from paddle_tpu_torch.nn import decode as tdecode
    cls = tdecode.BeamSearchDecoder
    if getattr(cls.finalize, "_chip", False):
        return
    inner = cls.finalize

    def finalize(self, outputs, final_states, sequence_lengths):
        cls._chip_last = (outputs.scores, outputs.predicted_ids,
                          outputs.parent_ids)
        return inner(self, outputs, final_states, sequence_lengths)
    finalize._chip = True
    cls.finalize = finalize


# the functions this slice ported, once each on the card in f32 (TF32
# off) against the port on the CPU at small sizes: within
# OP_TAIL_TOL·(1 + |ref|) elementwise; the decompositions through what
# they reconstruct
OP_TAIL_TOL = 1e-4


def op_tail_cases(P, rng):
    """(group, name, thunk) for each function; a thunk returns a tensor
    or a tuple of them, built from numpy made by ``rng`` (the same on
    both devices) with the port ``P`` on its current device."""
    import numpy as np
    f32 = np.float32
    T = P.to_tensor

    def r(*shape, lo=None, hi=None):
        if lo is not None:
            return rng.uniform(lo, hi, shape).astype(f32)
        return rng.standard_normal(shape).astype(f32)
    A = r(6, 6) + 6 * np.eye(6, dtype=f32)
    spd = (A @ A.T).astype(f32)
    L = np.linalg.cholesky(spd).astype(f32)
    h, tau = np.linalg.qr(r(6, 4), mode="raw")
    h, tau = h.T.astype(f32), tau.astype(f32)     # LAPACK's layout
    M = r(8, 5)
    x, y = r(4, 7), r(4, 7)
    ints = rng.integers(-3, 4, (16, 16)).astype(f32)
    lin = P.linalg
    F = P.nn.functional
    IF = P.incubate.nn.functional
    cases = [
        ("linalg", "inv", lambda: lin.inv(T(A))),
        ("linalg", "lu", lambda: _product(lin.lu_unpack(*lin.lu(T(A))))),
        ("linalg", "cond", lambda: lin.cond(T(A))),
        ("linalg", "matrix_exp", lambda: lin.matrix_exp(T(A / 8))),
        ("linalg", "matrix_norm", lambda: (lin.matrix_norm(T(M)),
                                           lin.matrix_norm(T(M), p=2),
                                           lin.matrix_norm(T(M), p=1))),
        ("linalg", "vector_norm", lambda: (lin.vector_norm(T(M), p=3,
                                                           axis=1),
                                           lin.vector_norm(T(M)))),
        ("linalg", "ormqr", lambda: lin.ormqr(T(h), T(tau), T(r(6, 3)))),
        ("linalg", "cholesky_inverse", lambda: lin.cholesky_inverse(T(L))),
        ("linalg", "svd_lowrank", lambda: (lambda u, s, v: (u * s) @ v.t())(
            *lin.svd_lowrank(T(M), q=5))),
        ("linalg", "pca_lowrank", lambda: (lambda u, s, v: (u * s) @ v.t())(
            *lin.pca_lowrank(T(M), q=5))),
        ("linalg", "fp8_fp8_half_gemm_fused", lambda: lin
         .fp8_fp8_half_gemm_fused(T(ints), T(ints), transpose_y=True,
                                  output_dtype="float32")),
        ("loss", "hsigmoid_loss", lambda: F.hsigmoid_loss(
            T(r(5, 8)), T(rng.integers(0, 6, (5,))), 6, T(r(5, 8)),
            T(r(5, 1)))),
        ("loss", "rnnt_loss", lambda: F.rnnt_loss(
            T(r(2, 6, 4, 5)), T(rng.integers(1, 5, (2, 3)).astype(
                np.int32)), T(np.array([6, 5], np.int32)),
            T(np.array([3, 2], np.int32)), reduction="none")),
        ("loss", "margin_cross_entropy", lambda: F.margin_cross_entropy(
            T(r(5, 7, lo=-0.9, hi=0.9)), T(rng.integers(0, 7, (5,))),
            return_softmax=True, reduction="none")),
        ("loss", "adaptive_log_softmax_with_loss",
         lambda: F.adaptive_log_softmax_with_loss(
             T(r(6, 8)), T(rng.integers(0, 12, (6,))), T(r(8, 6)),
             [[T(r(8, 4)), T(r(4, 4))], [T(r(8, 2)), T(r(2, 4))]],
             [4, 8])),
        ("attention", "flashmask_attention_causal", lambda: F
         .flashmask_attention(T(r(2, 16, 2, 32)), T(r(2, 16, 2, 32)),
                              T(r(2, 16, 2, 32)),
                              T(rng.integers(8, 17, (2, 1, 16, 1))),
                              causal=True)),
        ("attention", "flashmask_attention_bidirectional", lambda: F
         .flashmask_attention(T(r(2, 16, 2, 32)), T(r(2, 16, 2, 32)),
                              T(r(2, 16, 2, 32)), T(np.concatenate(
                                  [rng.integers(10, 17, (2, 1, 16, 1)),
                                   rng.integers(0, 4, (2, 1, 16, 1))], -1)),
                              causal=False)),
        ("attention", "flash_attn_qkvpacked", lambda: F.flash_attn_qkvpacked(
            T(r(2, 16, 3, 2, 64)), causal=True)[0]),
        ("fused", "fused_linear", lambda: IF.fused_linear(
            T(x), T(r(7, 3)), T(r(3)))),
        ("fused", "fused_rms_norm", lambda: IF.fused_rms_norm(
            T(x), T(r(7)), T(r(7)))),
        ("fused", "fused_layer_norm", lambda: IF.fused_layer_norm(
            T(x), T(r(7)), T(r(7)))),
        ("fused", "fused_bias_act", lambda: (IF.fused_bias_act(
            T(x), T(r(7))), IF.fused_bias_act(T(r(4, 8)), None,
                                              "swiglu"))),
        ("fused", "swiglu", lambda: IF.swiglu(T(x), T(y))),
        ("fused", "fused_rotary_position_embedding",
         lambda: IF.fused_rotary_position_embedding(
             T(r(2, 5, 2, 8)), T(r(2, 5, 2, 8)))[:2]),
        ("fused", "fused_layernorm_residual_dropout",
         lambda: IF.fused_layernorm_residual_dropout(
             T(x), T(y), T(r(7)), T(r(7)), p=0.0)),
    ]
    pos = np.abs(r(4, 7)) + 0.5
    cases += [("extra_math", name, fn) for name, fn in (
        ("sinc", lambda: P.sinc(T(x))),
        ("copysign", lambda: P.copysign(T(x), T(y))),
        ("deg2rad", lambda: P.deg2rad(T(x))),
        ("rad2deg", lambda: P.rad2deg(T(x))),
        ("logit", lambda: P.logit(T(r(4, 7, lo=0.05, hi=0.95)))),
        ("logcumsumexp", lambda: P.logcumsumexp(T(x), axis=1)),
        ("heaviside", lambda: P.heaviside(T(x), T(y))),
        ("gammaln", lambda: P.gammaln(T(pos))),
        ("gammainc", lambda: P.gammainc(T(pos), T(pos + 0.3))),
        ("gammaincc", lambda: P.gammaincc(T(pos), T(pos + 0.3))),
        ("multigammaln", lambda: P.multigammaln(T(pos + 2), 3)),
        ("polygamma", lambda: P.polygamma(T(pos), 1)),
        ("i0e", lambda: P.i0e(T(x))),
        ("i1", lambda: P.i1(T(x))),
        ("trapezoid", lambda: P.trapezoid(T(x), axis=1)),
        ("cumulative_trapezoid", lambda: P.cumulative_trapezoid(T(x))),
        ("quantile", lambda: P.quantile(T(x), [0.25, 0.5], axis=1)),
        ("nanmedian", lambda: P.nanmedian(T(x), axis=0)),
        ("renorm", lambda: P.renorm(T(x), 2.0, 0, 1.0)),
        ("cdist", lambda: P.cdist(T(x), T(y))),
        ("pdist", lambda: P.pdist(T(x))),
        ("addmm", lambda: P.addmm(T(r(4, 4)), T(x), T(y.T.copy()), 0.5,
                                  2.0)),
        ("diag_embed", lambda: P.diag_embed(T(x), 1)),
        ("vander", lambda: P.vander(T(r(5)), 4)),
        ("block_diag", lambda: P.block_diag([T(x), T(r(2, 2))])),
        ("cartesian_prod", lambda: P.cartesian_prod([T(r(3)), T(r(2))])),
        ("combinations", lambda: P.combinations(T(r(5)), 3)),
        ("bucketize", lambda: P.bucketize(T(x), T(np.sort(r(6))))),
        ("take", lambda: P.take(T(x), T(rng.integers(0, 28, (3, 3))))),
        ("index_fill", lambda: P.index_fill(T(x), T(np.array([0, 2])), 0,
                                            -1.0)),
        ("masked_scatter", lambda: P.masked_scatter(T(x), T(x > 0),
                                                    T(r(28)))),
        ("diagonal_scatter", lambda: P.diagonal_scatter(T(r(5, 5)),
                                                        T(r(4)), 1)),
        ("slice_scatter", lambda: P.slice_scatter(T(x), T(r(4, 3)), [1],
                                                  [0], [6], [2])),
        ("histogram", lambda: P.histogram(T(x), bins=5, min=-2, max=2)),
        ("unique_consecutive", lambda: P.unique_consecutive(
            T(np.array([1, 1, 2, 2, 3, 1, 1], np.float32)),
            return_counts=True)),
        ("nan_to_num", lambda: P.nan_to_num(T(np.array(
            [np.nan, np.inf, -np.inf, 1.0], np.float32)))),
        ("frexp", lambda: P.frexp(T(x))[0]),
        ("ldexp", lambda: P.ldexp(T(x), T(np.array([1, 2, 3, 4, 5, 6, 7],
                                                    np.int32)))),
        ("polar", lambda: P.as_real(P.polar(T(pos), T(x)))),
        ("hstack", lambda: P.hstack([T(x), T(y)])),
        ("tensor_split", lambda: tuple(P.tensor_split(T(x), 3, axis=1))),
        ("reduce_as", lambda: P.reduce_as(T(x), T(r(1, 7)))),
    )]
    # the RNN layers with sequence_length, bidirect, 2 layers
    for cls in ("SimpleRNN", "LSTM", "GRU"):
        cases.append(("rnn", cls, lambda c=cls: _rnn_case(P, c)))
    return cases


def _product(mats):
    """The product of a sequence of matrices (P L U)."""
    out = mats[0]
    for m in mats[1:]:
        out = out @ m
    return out


_RNN_STATES = {}


def _rnn_case(P, cls):
    """The outputs and final states of ``P.nn.<cls>`` (6 -> 8, 2 layers,
    bidirect) over a seeded batch with sequence lengths, from the same
    weights on every device (kept the first time)."""
    import numpy as np
    import torch
    layer = getattr(P.nn, cls)(6, 8, num_layers=2, direction="bidirect")
    if cls not in _RNN_STATES:
        _RNN_STATES[cls] = {k: v.detach().cpu() for k, v in
                            torch.nn.Module.state_dict(layer).items()}
    torch.nn.Module.load_state_dict(layer, _RNN_STATES[cls])
    g = np.random.default_rng(3)
    x = P.to_tensor(g.standard_normal((3, 5, 6)).astype(np.float32))
    out, st = layer(x, sequence_length=P.to_tensor(np.array([5, 2, 4])))
    return (out, *(st if isinstance(st, tuple) else (st,)))


def _flat(v):
    import torch
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _flat(x)]
    t = v._t if hasattr(v, "_t") else v
    return [t.detach().cpu().double()] if isinstance(t, torch.Tensor) \
        else []


def phase_op_tail_parity():
    """Every case of op_tail_cases on the card against the CPU; the worst
    error of each group, as a share of OP_TAIL_TOL·(1 + |ref|)."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as tdevice
    prev = tdevice._current
    results = {}
    for dev in ("gpu", "cpu"):
        paddle.set_device(dev)
        paddle.seed(SEED)
        cases = op_tail_cases(paddle, np.random.default_rng(SEED))
        for group, name, fn in cases:
            results.setdefault(name, {"group": group})[dev] = _flat(fn())
    tdevice._current = prev
    worst, failed = {}, []
    for name, r in results.items():
        used = 0.0
        for a, b in zip(r["gpu"], r["cpu"], strict=True):
            if a.shape != b.shape:
                used = float("inf")
                break
            err = ((a - b).abs() / (OP_TAIL_TOL * (1 + b.abs())))
            err = err[~(a.isnan() & b.isnan())]
            used = max(used, float(err.max()) if err.numel() else 0.0)
        g = r["group"]
        if used > worst.get(g, (0.0, ""))[0] or g not in worst:
            worst[g] = (used, name)
        if not used <= 1.0:
            failed.append([name, used])
    out = {"card": nvidia_smi_line(), "tol": OP_TAIL_TOL,
           "functions": len(results),
           "worst_share_of_tol_by_group": worst, "failed": failed}
    if failed:
        emit({"phase": "op_tail_parity", "failed": out})
        raise AssertionError(f"op_tail_parity: {len(failed)} functions "
                             f"disagree with the CPU")
    return out


# ---------------------------------------------------------------------------
# recompute, generate, the fused encoder, the autograd core, warm bundles
# ---------------------------------------------------------------------------

# Llama-2 7B widths at 8 layers through the captured TrainStep, with
# LlamaConfig.recompute and without, from the same weights and ids
RECOMPUTE = dict(layers=8, warmup=2, steps=5)
# greedy generate: f32 at 2 layers (teacher-forced parity), bf16 at
# TRAIN's depth and batch (the rates)
GENERATE = dict(f32_layers=2, batch=4, f32_prompt=128, f32_new=32,
                bf16_layers=4, bf16_prompt=512, bf16_new=64,
                # bf16: the timed run's weights and prompts, then these
                # (weight seed, prompt seed) pairs, each run gated alike
                weight_seeds=(SEED, SEED + 7), prompt_seeds=(1, 2, 3))
# a parted id is a near-tie when the teacher-forced top-two logits lie
# within this share of the top one, about two bf16 ulps of a logit: the
# flash prefill and the plain sdpa of the decode steps part at gaps up
# to 2.2 x 2^-8 on these random weights. The phase shows the limit
# rejects a wrong decode: planted faults (RoPE one position too far;
# decode steps that miss the ids generated before them) must part
# beyond it. The count of parted ids beyond 2^-8 is reported beside it.
NEAR_TIE = 2.0 ** -6
# 12 FusedTransformerEncoderLayers at BERT-base widths (post-norm, GELU,
# dropout 0.1 everywhere), a 30,522 x 768 embedding and an untied output
# projection, BERT's batch
FUSED = dict(vocab=30522, d=768, heads=12, ffn=3072, layers=12,
             dropout=0.1, batch=24, seq=512, warmup=2, steps=5, lr=1e-4)
# the autograd core on the card against the CPU, f32
AUTOGRAD_TOL = 1e-5        # |card - cpu| <= tol (1 + |cpu|)
PYLAYER_GPT = dict(vocab_size=512, hidden_size=256, num_attention_heads=4,
                   intermediate_size=1024, max_position_embeddings=128)
NAN_STRIDE = 8
# GPT at 13B widths and 1 layer through Model.fit: a warm bundle recorded,
# then a child process pre-warmed from it
WARM = dict(layers=1, batch=4, steps=3)


def recompute_run(model, start, ids, recompute):
    """The captured TrainStep over RECOMPUTE's steps from ``start`` (the
    parameters put back in place, a fresh AdamW, the key stream reseeded)
    with ``model.config.recompute`` set as asked; the timed replays'
    flash launches, peak memory above the run's start, step ms, losses
    and final parameters."""
    import torch
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    with torch.no_grad():
        for p, s0 in zip(model.parameters(), start):
            p.copy_(s0)
    model.config.recompute = recompute
    opt = AdamW(learning_rate=TRAIN["lr"],
                parameters=model.named_parameters(), multi_precision=False)
    step = TrainStep(model, LlamaPretrainingCriterion(), opt)
    trandom.seed(SEED)
    base = fresh_peak()
    losses = [step(ids, ids) for _ in range(RECOMPUTE["warmup"])]
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = kern.tma_launches = 0
    timed, wall, captured = timed_replays(step, (ids, ids),
                                          RECOMPUTE["steps"])
    launches = [kern.launches for kern in kernels]
    tma = [kern.tma_launches for kern in kernels]
    phase = "llama_recompute_train" + (" (recompute)" if recompute else "")
    capture = check_captured(phase, step, captured, RECOMPUTE["steps"])
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN["batch"] * TRAIN["seq"]
    out = {"recompute": recompute,
           "losses": [float(x) for x in losses + timed],
           "step_ms": wall / RECOMPUTE["steps"] * 1e3,
           "tokens_per_s": tokens * RECOMPUTE["steps"] / wall,
           "flash_launches": dict(zip(("fwd", "dq", "dkv"), launches)),
           "flash_tma_launches": dict(zip(("fwd", "dq", "dkv"), tma)),
           "peak_mem_gb": peak / 2 ** 30,
           "mem_at_start_gb": base / 2 ** 30,
           "peak_above_start_gb": (peak - base) / 2 ** 30,
           "capture": capture}
    params = param_copies(model)
    del step, opt, timed, losses
    torch.cuda.empty_cache()
    return out, params


def phase_llama_recompute_train(results):
    """Llama-2 7B widths at 8 layers, bf16, 4 x 2048 tokens, AdamW through
    the captured TrainStep (2 warm-up steps, 5 timed replays), once with
    LlamaConfig.recompute and once without, from the same copied weights
    and ids. Gates: one graph and no fallback in both; K1b forward 16 a
    replay with recompute (the forward and the recompute), 8 without, all
    on the TMA design; K2b dQ and dK/dV 8 a replay; losses within
    TRAIN_LOSS_RTOL and final parameters within TRAIN_GRAD_RMS of each
    other."""
    import torch
    t0 = time.perf_counter()
    model = train_model(RECOMPUTE["layers"])
    cfg = model.config
    ids = train_ids(cfg.vocab_size)
    start = param_copies(model)
    init_s = time.perf_counter() - t0
    rc, p_rc = recompute_run(model, start, ids, True)
    plain, p_plain = recompute_run(model, start, ids, False)
    model.config.recompute = False
    steps, layers = RECOMPUTE["steps"], RECOMPUTE["layers"]
    want = {True: {"fwd": 2 * layers * steps, "dq": layers * steps,
                   "dkv": layers * steps},
            False: {"fwd": layers * steps, "dq": layers * steps,
                    "dkv": layers * steps}}
    problems = []
    for run in (rc, plain):
        w = want[run["recompute"]]
        if run["flash_launches"] != w or run["flash_tma_launches"] != w:
            problems.append(f"recompute={run['recompute']}: flash launches "
                            f"{run['flash_launches']}, TMA "
                            f"{run['flash_tma_launches']} != {w}")
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(rc["losses"], plain["losses"]))
    num = den = 0.0
    equal = True
    for a, b in zip(p_rc, p_plain):
        num += float((a.float() - b.float()).square().sum())
        den += float(b.float().square().sum())
        equal = equal and torch.equal(a, b)
    param_rms = math.sqrt(num / max(den, 1e-30))
    if loss_rel > TRAIN_LOSS_RTOL or param_rms > TRAIN_GRAD_RMS:
        problems.append(f"recompute vs plain: loss rel {loss_rel}, "
                        f"parameter rel RMS {param_rms}")
    if not all(map(math.isfinite, rc["losses"])):
        problems.append(f"non-finite loss: {rc['losses']}")
    out = {"card": nvidia_smi_line(), "model": "llama2-7b-width",
           "layers": layers, "hidden": cfg.hidden_size,
           "intermediate": cfg.intermediate_size, "dtype": "bfloat16",
           "batch": TRAIN["batch"], "seq": TRAIN["seq"],
           "optimizer": f"AdamW(lr={TRAIN['lr']}, multi_precision=False)",
           "reduced": ["depth 32 -> 8 layers",
                       "random weights from a seed (no checkpoint in the "
                       "repo)"],
           "init_seconds": init_s, "recompute": rc, "plain": plain,
           "memory_saving_gb": plain["peak_above_start_gb"]
           - rc["peak_above_start_gb"],
           "step_ms_ratio": rc["step_ms"] / plain["step_ms"],
           "loss_rel_err_max": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
           "param_rel_rms": param_rms, "param_rms_tol": TRAIN_GRAD_RMS,
           "losses_bit_equal": rc["losses"] == plain["losses"],
           "params_bit_equal": equal}
    if problems:
        emit({"phase": "llama_recompute_train", "failed": out})
        raise AssertionError("llama_recompute_train: " + "; ".join(problems))
    for name, key in (("flash_attention_fwd", "fwd"),
                      ("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv")):
        results[name]["recompute_launches"] = rc["flash_launches"][key]
    del model, start, p_rc, p_plain
    torch.cuda.empty_cache()
    return out


def generate_model(layers, dtype, seed=SEED):
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(num_hidden_layers=layers, dtype=dtype,
                      max_position_embeddings=TRAIN["seq"])
    model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.eval()
    return model


def prompt_ids(vocab, batch, n, seed=SEED):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, n))).to("cuda")


def planted_fault_generate(model, prompt, n_new, fault):
    """Greedy decoding through the cache path with a planted fault, the
    negative control of the near-tie limit: ``"rope_offset+1"`` gives
    each decode step a position one too far; ``"stale_cache"`` gives
    each step the prompt's caches only (it misses the ids generated
    before it)."""
    import torch
    if fault not in ("rope_offset+1", "stale_cache"):
        raise ValueError(fault)
    n = model.config.num_hidden_layers
    ids = prompt
    with torch.no_grad():
        logits, caches = model(ids, caches=[(None, None)] * n)
        prompt_caches = caches
        for _ in range(n_new):
            nxt = logits[:, -1, :].argmax(dim=-1)[:, None]
            pos = ids.shape[1]
            ids = torch.cat([ids, nxt.to(ids.dtype)], dim=1)
            if fault == "rope_offset+1":
                logits, caches = model(nxt, caches=caches,
                                       position_offset=pos + 1)
            else:
                logits, _ = model(nxt, caches=prompt_caches,
                                  position_offset=pos)
    return ids


def parted_positions(model, ids, n_prompt):
    """Each generated position against the argmax of one cache-free
    forward over the final ids (teacher-forced), its logits the f32
    product of the forward's final hidden state and the output weights
    (no rounding to the model's dtype at the end): the positions that
    part, those among them that are not near-ties (top-two logits within
    NEAR_TIE of the top one), and each parted position's gap as a share
    of its top logit."""
    import torch
    with torch.no_grad():
        h = model.llama(ids)[:, n_prompt - 1:-1]
        w = model.llama.embed_tokens.weight \
            if model.config.tie_word_embeddings else model.lm_head.weight
        logits = h.float() @ w.float().t()
    tf = logits.argmax(-1)
    gen = ids[:, n_prompt:]
    parted = (tf != gen).nonzero().tolist()
    top2 = logits.topk(2, dim=-1).values
    gaps = {f"{b},{t}": float(top2[b, t, 0] - top2[b, t, 1])
            / abs(float(top2[b, t, 0])) for b, t in parted}
    not_ties = [[b, t] for b, t in parted if gaps[f"{b},{t}"] > NEAR_TIE]
    return parted, not_ties, gaps


def phase_llama_generate(results):
    """LlamaForCausalLM.generate at Llama-2 7B widths. f32 (TF32 off), 2
    layers, batch 4, prompts of 128 seeded ids, 32 new tokens: the ids
    equal the teacher-forced argmax of one cache-free forward, and
    against the paged engine's greedy ids from the same model (reported).
    bf16, 4 layers, batch 4, prompt 512, 64 new tokens: K1b launched
    once a layer, all on the TMA design (the prefill; the decode steps
    take the plain sdpa, as the JAX model routes them), the rates, and
    each parted position a near-tie of the teacher-forced logits."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import PagedLlamaDecodeEngine
    g = GENERATE
    problems = []
    # f32 parity
    model = generate_model(g["f32_layers"], "float32")
    prompt = prompt_ids(model.config.vocab_size, g["batch"], g["f32_prompt"])
    t0 = time.perf_counter()
    ids = model.generate(prompt, g["f32_new"])
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    parted, _, _ = parted_positions(model, ids, g["f32_prompt"])
    if parted:
        problems.append(f"f32: generated ids part from the teacher-forced "
                        f"argmax at {parted}")
    eng = PagedLlamaDecodeEngine(model, max_slots=1,
                                 max_seq=g["f32_prompt"] + g["f32_new"] + 16,
                                 block_size=16, prefill_chunk=64)
    paged = [eng.generate(np.asarray(p), g["f32_new"])
             for p in prompt.cpu().numpy()]
    gen = ids[:, g["f32_prompt"]:].cpu().numpy().tolist()
    paged_parted = [[b, t] for b in range(g["batch"])
                    for t in range(g["f32_new"]) if paged[b][t] != gen[b][t]]
    f32 = {"layers": g["f32_layers"], "batch": g["batch"],
           "prompt": g["f32_prompt"], "new_tokens": g["f32_new"],
           "seconds": f32_s, "teacher_forced_parted": parted,
           "paged_engine_equal": not paged_parted,
           "paged_engine_first_parted": paged_parted[:4]}
    del model, eng, ids, prompt
    torch.cuda.empty_cache()
    # bf16 at TRAIN's depth and batch
    model = generate_model(g["bf16_layers"], "bfloat16")
    prompt = prompt_ids(model.config.vocab_size, g["batch"],
                        g["bf16_prompt"], SEED + g["prompt_seeds"][0])
    model.generate(prompt, 2)                  # warm: kernels, cuBLAS
    n = model.config.num_hidden_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        model(prompt, caches=[(None, None)] * n)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    reset_flash_counts()
    t0 = time.perf_counter()
    ids = model.generate(prompt, g["bf16_new"])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = flash_fit_counts()
    want = {"fwd": (n, n), "bwd_dq": (0, 0), "bwd_dkv": (0, 0)}
    if counts != want:
        problems.append(f"bf16: flash launches (launches, TMA) {counts} "
                        f"!= {want}: the prefill once a layer on the TMA "
                        f"design, nothing in the decode steps")
    parted, not_ties, gaps = parted_positions(model, ids, g["bf16_prompt"])
    if not_ties:
        problems.append(f"bf16: ids part from the teacher-forced argmax "
                        f"away from a near-tie at {not_ties}")
    decode_s = total_s - prefill_s
    # the near-tie limit against more seeds, and against planted faults
    # that it must reject
    faults = {}
    for fault in ("rope_offset+1", "stale_cache"):
        fids = planted_fault_generate(model, prompt, g["bf16_new"], fault)
        f_parted, f_not_ties, f_gaps = parted_positions(
            model, fids, g["bf16_prompt"])
        faults[fault] = {"parted": len(f_parted),
                         "beyond_near_tie": len(f_not_ties),
                         "largest_gap": max(f_gaps.values(), default=0.0)}
        if not f_not_ties:
            problems.append(f"bf16: the planted fault {fault} parts only "
                            f"at near-ties: {faults[fault]}")
    seeds = [{"weight_seed": SEED, "prompt_seed": SEED + g["prompt_seeds"][0],
              "parted": len(parted),
              "largest_gap": max(gaps.values(), default=0.0)}]
    for wseed in g["weight_seeds"]:
        if wseed != SEED:
            del model
            torch.cuda.empty_cache()
            model = generate_model(g["bf16_layers"], "bfloat16", wseed)
        for pseed in g["prompt_seeds"]:
            if wseed == SEED and pseed == g["prompt_seeds"][0]:
                continue
            p = prompt_ids(model.config.vocab_size, g["batch"],
                           g["bf16_prompt"], SEED + pseed)
            s_parted, s_not_ties, s_gaps = parted_positions(
                model, model.generate(p, g["bf16_new"]), g["bf16_prompt"])
            seeds.append({"weight_seed": wseed, "prompt_seed": SEED + pseed,
                          "parted": len(s_parted),
                          "largest_gap": max(s_gaps.values(), default=0.0),
                          "beyond_2^-8": sum(v > 2.0 ** -8
                                             for v in s_gaps.values())})
            if s_not_ties:
                problems.append(f"bf16, weight seed {wseed}, prompt seed "
                                f"{SEED + pseed}: ids part away from a "
                                f"near-tie at {s_not_ties}")
    new = g["batch"] * g["bf16_new"]
    bf16 = {"layers": n, "batch": g["batch"], "prompt": g["bf16_prompt"],
            "new_tokens": g["bf16_new"], "flash_launches": counts,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_token": decode_s / g["bf16_new"] * 1e3,
            "decode_tokens_per_s": new / decode_s,
            "tokens_per_s": new / total_s, "generate_s": total_s,
            "teacher_forced_parted": parted, "parted_gap_share": gaps,
            "parted_not_near_ties": not_ties, "near_tie": NEAR_TIE,
            "parted_beyond_2^-8": sum(v > 2.0 ** -8 for v in gaps.values()),
            "seeds": seeds,
            "largest_clean_gap": max(r["largest_gap"] for r in seeds),
            "planted_faults": faults,
            "smallest_fault_gap": min(f["largest_gap"]
                                      for f in faults.values())}
    results["flash_attention_fwd"]["generate_launches"] = counts["fwd"][0]
    out = {"card": nvidia_smi_line(), "model": "llama2-7b-width",
           "f32": f32, "bf16": bf16,
           "reduced": ["depth 32 -> 2 (f32) and 4 (bf16) layers",
                       "random weights from a seed"]}
    del model, ids, prompt
    torch.cuda.empty_cache()
    if problems:
        emit({"phase": "llama_generate", "failed": out})
        raise AssertionError("llama_generate: " + "; ".join(problems))
    return out


def fused_encoder_model():
    """12 FusedTransformerEncoderLayers between a token embedding and an
    untied output projection, bf16, on the card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    f = FUSED
    paddle.set_device("gpu")
    paddle.seed(SEED)

    class FusedEncoderLM(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = paddle.nn.Embedding(f["vocab"], f["d"])
            self.layers = paddle.nn.LayerList([
                FusedTransformerEncoderLayer(
                    f["d"], f["heads"], f["ffn"], dropout_rate=f["dropout"],
                    activation="gelu") for _ in range(f["layers"])])
            self.head = paddle.nn.Linear(f["d"], f["vocab"])

        def forward(self, ids):
            h = self.embed(ids)
            for layer in self.layers:
                h = layer(h)
            return self.head(h)
    model = FusedEncoderLM()
    model.bfloat16()
    return model


def fused_group(kernel: str) -> str:
    """The fused encoder's kernel groups; "dropout" is the hash mask's
    int64 element-wise passes (named by their ``long`` operands)."""
    kl = kernel.lower()
    if "multi_tensor" in kl:
        return "optimizer"
    if "flash" in kl:
        return "flash"
    if any(tag in kl for tag in ("gemm", "cutlass", "nvjet", "sm90")):
        return "gemm"
    if "index" not in kl and ("<long" in kl or "long>" in kl
                              or "bitwise" in kl or "shift" in kl):
        return "dropout"
    return "other"


def phase_fused_encoder_train(results):
    """FUSED through the captured TrainStep (AdamW, CrossEntropyLoss on
    [B, L, V] logits, 2 warm-up steps, 5 timed replays) with the 24 FFN
    Linears pruned 2:4 (incubate.asp.prune_model) and the optimizer
    asp.decorate'd; then the same steps through the eager loop from the
    copied weights and the same key stream. Gates: one graph, no
    fallback; K1a forward, K2a dQ and dK/dV each 12 a replay with K5's
    dropout, all on the TMA design; losses and parameters within
    BERT_LOSS_RTOL / BERT_GRAD_RMS of the eager run; every pruned weight
    2:4 sparse after the replays and after the eager run."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    f = FUSED
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    t0 = time.perf_counter()
    model = fused_encoder_model()
    n_params = sum(p.numel() for p in torch.nn.Module.parameters(model))
    masks = {}
    for i, layer in enumerate(model.layers):
        for k, m in asp.prune_model(layer.ffn).items():
            masks[f"layers.{i}.ffn.{k}"] = m
    pruned = dict(torch.nn.Module.named_parameters(model))
    pruned = {k: pruned[k] for k in masks}

    def make_opt():
        return asp.decorate(AdamW(
            learning_rate=f["lr"],
            parameters=torch.nn.Module.parameters(model),
            multi_precision=False))
    opt = make_opt()
    crit = paddle.nn.CrossEntropyLoss()
    step = TrainStep(model, crit, opt)
    ids = prompt_ids(f["vocab"], f["batch"], f["seq"])
    start = param_copies(model)
    trandom.seed(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem_start = fresh_peak()
    losses = [step(ids, ids) for _ in range(f["warmup"])]
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = w.dropout_launches = w.segmented_launches = 0
        w.tma_launches = 0
    timed, wall, captured = timed_replays(step, (ids, ids), f["steps"])
    losses += timed
    launches = [w.launches for w in wrappers]
    dropped = [w.dropout_launches for w in wrappers]
    tma = [w.tma_launches for w in wrappers]
    capture = check_captured("fused_encoder_train", step, captured,
                             f["steps"])
    expected = f["layers"] * f["steps"]
    problems = []
    if launches != [expected] * 3 or dropped != [expected] * 3 \
            or tma != [expected] * 3:
        problems.append(f"flash launches (fwd, dq, dkv) {launches}, with "
                        f"dropout {dropped}, TMA {tma}: each should be "
                        f"{f['layers']} x {f['steps']}")
    sparse_replays = all(asp.check_sparsity(p) for p in pruned.values())
    kept_zero = all(bool((p[masks[k] == 0] == 0).all())
                    for k, p in pruned.items())
    loss_values = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    tokens = f["batch"] * f["seq"]
    tok_s = tokens * f["steps"] / wall
    cap_params, cap_state = param_copies(model), trandom.get_rng_state()
    prof = profile_train_step(step, (ids, ids), classify=fused_group,
                              groups=("gemm", "flash", "dropout",
                                      "optimizer", "other"))
    del step, opt
    torch.cuda.empty_cache()
    eager = eager_reference(model, start, make_opt, crit, (ids, ids),
                            f["warmup"], f["steps"])
    sparse_eager = all(asp.check_sparsity(p) for p in pruned.values())
    vs = capture_vs_eager("fused_encoder_train", loss_values, cap_params,
                          cap_state, model, eager, tokens, f["steps"],
                          loss_rtol=BERT_LOSS_RTOL, param_rms=BERT_GRAD_RMS)
    if not (sparse_replays and sparse_eager and kept_zero):
        problems.append(f"2:4 sparsity lost: after the replays "
                        f"{sparse_replays}, pruned entries zero "
                        f"{kept_zero}, after the eager run {sparse_eager}")
    if len(masks) != 2 * f["layers"]:
        problems.append(f"{len(masks)} pruned weights, not "
                        f"{2 * f['layers']}")
    if not (all(map(math.isfinite, loss_values))
            and loss_values[-1] < loss_values[0]):
        problems.append(f"losses not finite and falling: {loss_values}")
    out = {"card": nvidia_smi_line(),
           "model": "12 FusedTransformerEncoderLayer(768, 12, 3072, "
                    "dropout 0.1, gelu), post-norm; embedding and head "
                    "30,522 x 768, untied",
           "params": n_params, "dtype": "bfloat16",
           "batch": f["batch"], "seq": f["seq"],
           "optimizer": f"asp.decorate(AdamW(lr={f['lr']}, "
                        f"multi_precision=False))",
           "pruned_weights": len(masks), "reduced": ["random weights from "
                                                     "a seed"],
           "init_seconds": init_s, "losses": loss_values,
           "step_ms": wall / f["steps"] * 1e3, "tokens_per_s": tok_s,
           "flash_launches": dict(zip(("fwd", "dq", "dkv"), launches)),
           "flash_dropout_launches": dict(zip(("fwd", "dq", "dkv"),
                                              dropped)),
           "flash_tma_launches": dict(zip(("fwd", "dq", "dkv"), tma)),
           "peak_mem_gb": peak / 2 ** 30,
           "mem_at_start_gb": mem_start / 2 ** 30, "capture": capture,
           "sparse_after_replays": sparse_replays,
           "sparse_after_eager": sparse_eager, "vs_eager": vs,
           "profile_one_step": prof,
           "device_idle_share_of_timed_step":
               1 - prof["device_ms"] / (wall / f["steps"] * 1e3)
               if prof["device_ms"] else None}
    if problems:
        emit({"phase": "fused_encoder_train", "failed": out})
        raise AssertionError("fused_encoder_train: " + "; ".join(problems))
    for name, n in zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"), dropped):
        results[name + "_dropout"]["fused_encoder_launches"] = n
    del model, start, cap_params, pruned, masks
    torch.cuda.empty_cache()
    return out


def pylayer_classes():
    """Cube and AddMul (the JAX package's PyLayer cases) and SoftCap
    (30 tanh(x / 30) with a hand-written backward, on torch tensors)."""
    import torch
    from paddle_tpu_torch.autograd import PyLayer

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x * x

    class AddMul(PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a + b, a * b

        @staticmethod
        def backward(ctx, da, dm):
            a, b = ctx.saved_tensor()
            return da + dm * b, da + dm * a

    class SoftCap(PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = torch.tanh(x / 30.0)
            ctx.save_for_backward(y)
            return y * 30.0

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return dy * (1 - y * y)
    return Cube, AddMul, SoftCap


def autograd_cases(paddle, rng):
    """(name, function) pairs of the autograd core, each giving Tensors
    on the current device."""
    import numpy as np
    Cube, AddMul, _ = pylayer_classes()
    A = paddle.autograd
    xa = rng.standard_normal(16).astype(np.float32)
    xb = rng.standard_normal(16).astype(np.float32)
    xv = rng.standard_normal(16).astype(np.float32)

    def t(a, grad=False):
        return paddle.to_tensor(a, stop_gradient=not grad)

    def cube():
        x = t(xa, True)
        y = Cube.apply(x)
        (y * t(xv)).sum().backward()
        return [y, x.grad]

    def add_mul():
        a, b = t(xa, True), t(xb, True)
        s, m = AddMul.apply(a, b)
        (s + m * t(xv)).sum().backward()
        return [s, m, a.grad, b.grad]

    def two(a, b):
        return paddle.sin(a) * b + a * a
    return [
        ("pylayer_cube", cube), ("pylayer_add_mul", add_mul),
        ("jacobian", lambda: [A.jacobian(two, (t(xa), t(xb)))]),
        ("hessian", lambda: [A.hessian(
            lambda a: (paddle.sin(a) * a).sum(), t(xa))]),
        ("vjp", lambda: list(A.vjp(two, (t(xa), t(xb)), t(xv)))),
        ("jvp", lambda: list(A.jvp(two, (t(xa), t(xb)),
                                   (t(xv), t(xb))))),
    ]


def _flat_tensors(v):
    if isinstance(v, (tuple, list)):
        return [x for item in v for x in _flat_tensors(item)]
    return [v._t.detach().float().cpu()]


def pylayer_gpt():
    """A 2-layer GPT at PYLAYER_GPT's widths, f32, whose logits pass
    through SoftCap, on the card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    _, _, SoftCap = pylayer_classes()
    paddle.set_device("gpu")
    paddle.seed(SEED)

    class Capped(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.gpt = GPTForCausalLM(GPTConfig(num_hidden_layers=2,
                                                **PYLAYER_GPT))

        def forward(self, ids):
            return SoftCap.apply(self.gpt(ids))
    return Capped()


def nan_planted_forward(paddle, x, w):
    """An eager forward whose 9th float output (a log of zeros) is -inf;
    returns the number of ops run."""
    n = 0

    def op(v):
        nonlocal n
        n += 1
        return v
    h = op(paddle.matmul(x, w))
    h = op(paddle.nn.functional.relu(h))
    h = op(h * 2.0)
    h = op(h + 1.0)
    h = op(paddle.tanh(h))
    h = op(h - 0.5)
    h = op(paddle.exp(h))
    z = op(h - h)
    z = op(paddle.log(z))
    for _ in range(15):
        h = op(h * 1.5)
    return n


def phase_autograd_core_parity():
    """The autograd core on the card, f32 (TF32 off): PyLayer (Cube,
    AddMul) and jacobian / hessian / vjp / jvp against the same calls on
    the CPU within AUTOGRAD_TOL·(1 + |cpu|); a PyLayer inside a captured
    TrainStep of a 2-layer GPT, replays against the eager loop;
    FLAGS_check_nan_inf at stride NAN_STRIDE over an eager forward with a
    planted inf (the error names the op, one host fetch a stride of
    queued outputs); a capture and a replay with the flag on and flags
    queued from before (nothing raised, nothing fetched, the queue kept
    for the first flush after, which fetches it once)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import autograd as tag
    from paddle_tpu_torch.core import device as tdevice
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    prev = tdevice._current
    problems = []
    got = {}
    for dev in ("gpu", "cpu"):
        paddle.set_device(dev)
        paddle.seed(SEED)
        for name, fn in autograd_cases(paddle, np.random.default_rng(SEED)):
            got.setdefault(name, {})[dev] = _flat_tensors(fn())
    paddle.set_device("gpu")
    parity = {}
    for name, r in got.items():
        worst, equal = 0.0, True
        for a, b in zip(r["gpu"], r["cpu"], strict=True):
            worst = max(worst, float(((a - b).abs()
                                      / (AUTOGRAD_TOL * (1 + b.abs())))
                                     .max()))
            equal = equal and torch.equal(a, b)
        parity[name] = {"share_of_tol": worst, "bit_equal": equal}
        if not worst <= 1.0:
            problems.append(f"{name}: {worst} of the tolerance")
    # a PyLayer in a captured TrainStep
    model = pylayer_gpt()
    crit = paddle.nn.CrossEntropyLoss()

    def make_opt():
        return AdamW(learning_rate=1e-3,
                     parameters=torch.nn.Module.parameters(model))
    ids = prompt_ids(PYLAYER_GPT["vocab_size"], 4,
                     PYLAYER_GPT["max_position_embeddings"])
    start = param_copies(model)
    opt = make_opt()
    step = TrainStep(model, crit, opt)
    trandom.seed(SEED)
    nodes0 = tag._dispatches.get("SoftCap", 0)
    losses = [step(ids, ids) for _ in range(2)]
    timed, _, captured = timed_replays(step, (ids, ids), 3)
    capture = check_captured("autograd_core_parity", step, captured, 3)
    nodes = tag._dispatches.get("SoftCap", 0) - nodes0
    cap_losses = [float(x) for x in losses + timed]
    cap_params, cap_state = param_copies(model), trandom.get_rng_state()
    del step, opt
    eager = eager_reference(model, start, make_opt, crit, (ids, ids), 2, 3)
    vs = capture_vs_eager("autograd_core_parity", cap_losses, cap_params,
                          cap_state, model, eager, ids.numel(), 3)
    # the NaN scan at stride NAN_STRIDE
    rng = np.random.default_rng(SEED)
    x = paddle.to_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    w = paddle.to_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    paddle.set_flags({"FLAGS_check_nan_inf": True,
                      "FLAGS_check_nan_inf_stride": NAN_STRIDE})
    nan = {}
    try:
        f0 = tag._nan_fetches
        calls = []
        try:
            calls.append(nan_planted_forward(paddle, x, w))
            nan["raised"] = None
        except FloatingPointError as e:
            nan["raised"] = str(e)
        nan["host_fetches"] = tag._nan_fetches - f0
        # ops run up to the raise: the one whose flush found the inf is
        # the NAN_STRIDE-th of its stride
        nan["queued_outputs"] = NAN_STRIDE * nan["host_fetches"]
        # a capture and replays with the flag on
        paddle.seed(SEED)
        model2 = pylayer_gpt()
        step2 = TrainStep(model2, crit, AdamW(
            learning_rate=1e-3,
            parameters=torch.nn.Module.parameters(model2)))
        step2(ids, ids)                      # the eager first sighting
        # the capture meets flags still queued (fewer than a stride): its
        # backward's flush keeps them for the first flush after it
        while not tag._nan_pending:
            x + 1.0
        f1, p1 = tag._nan_fetches, len(tag._nan_pending)
        torch.cuda.set_sync_debug_mode("error")
        try:
            step2(ids, ids)                  # capture and replay
            step2(ids, ids)                  # replay
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        nan["queued_at_capture"] = p1
        nan["captured_fetches"] = tag._nan_fetches - f1
        nan["captured_queued"] = len(tag._nan_pending) - p1
        nan["captured_steps"] = step2.stats["captured_steps"]
        tag.flush_nan_checks()
        nan["fetches_of_the_flush_after"] = \
            tag._nan_fetches - f1 - nan["captured_fetches"]
        del step2, model2
    finally:
        tag._nan_pending.clear()
        paddle.set_flags({"FLAGS_check_nan_inf": False,
                          "FLAGS_check_nan_inf_stride": 1})
        tdevice._current = prev
    if not (nan["raised"] or "").startswith("Operator log output 0"):
        problems.append(f"the NaN check named {nan['raised']!r}, not the "
                        f"planted log")
    if nan["host_fetches"] != 2:
        problems.append(f"{nan['host_fetches']} host fetches for the 16 "
                        f"queued outputs up to the planted one's stride, "
                        f"not 16 / {NAN_STRIDE}")
    if nan["captured_fetches"] or nan["captured_queued"] \
            or nan["captured_steps"] != 2 \
            or not 0 < nan["queued_at_capture"] < NAN_STRIDE \
            or nan["fetches_of_the_flush_after"] != 1:
        problems.append(f"a capture with the flag on and flags queued: "
                        f"{nan}")
    out = {"card": nvidia_smi_line(), "dtype": "float32",
           "tol": AUTOGRAD_TOL, "parity": parity,
           "pylayer_train_step": {"gpt_widths": PYLAYER_GPT, "layers": 2,
                                  "capture": capture,
                                  "pylayer_nodes_recorded": nodes,
                                  "vs_eager": vs},
           "nan_check": {"stride": NAN_STRIDE, **nan}}
    del model, start, cap_params
    torch.cuda.empty_cache()
    if problems:
        emit({"phase": "autograd_core_parity", "failed": out})
        raise AssertionError("autograd_core_parity: " + "; ".join(problems))
    return out


WARM_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import paddle_tpu_torch as paddle
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
paddle.set_device("gpu")
paddle.seed(cs.SEED)
net = GPTForCausalLM(GPTConfig(num_hidden_layers=cs.WARM["layers"],
                               **cs.GPT_WIDTHS))
opt = paddle.optimizer.AdamW(cs.FIT["lr"], parameters=net.parameters(),
                             grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
raw = list(torch.nn.Module.parameters(net))
before = [p.detach().clone() for p in raw]
rng = paddle.get_rng_state()
model = paddle.Model(net)
torch.cuda.synchronize()
t = time.perf_counter()
model.prepare(opt, cs.fit_loss(cs.GPT_WIDTHS["vocab_size"]),
              amp_configs="O1", warm_bundle=sys.argv[2])
torch.cuda.synchronize()
boot_s = time.perf_counter() - t
core = opt
states_init = all(
    all(torch.equal(v, core._init_state(core._parameter_list[i])[k])
        for k, v in st.items()) for i, st in core._states.items())
after = dict(model._captured.stats)
out = {"import_and_build_s": t - t0, "prewarm_s": boot_s,
       "params_bit_equal": all(torch.equal(a, b)
                               for a, b in zip(raw, before)),
       "states": len(core._states), "states_at_init": states_init,
       "global_step": core._global_step,
       "rng_equal": paddle.get_rng_state() == rng,
       "stats_after_prewarm": {k: v for k, v in after.items()},
       "graphs_after_prewarm": model._captured.graphs()}
data = paddle.io.DataLoader(
    cs.fit_dataset(cs.GPT_WIDTHS["vocab_size"],
                   cs.WARM["batch"] * cs.WARM["steps"], cs.SEED),
    batch_size=cs.WARM["batch"], num_workers=0)
clock = cs.step_clock()
model.fit(data, epochs=1, verbose=0, callbacks=[clock])
torch.cuda.synchronize()
st = model._captured.stats
out.update(step_ms=clock.step_ms(),
           losses=[float(v) for v in clock.losses],
           captured_steps=st["captured_steps"] - after["captured_steps"],
           eager_steps=st["eager_steps"] - after["eager_steps"],
           compiles=st["compiles"] - after["compiles"],
           fallbacks=dict(st["fallbacks"]),
           seconds=time.perf_counter() - t0)
print(json.dumps(out))
"""


def phase_warm_bundle_boot():
    """GPT at 13B widths, 1 layer, AMP O1 with a global-norm clip, through
    Model.fit (WARM's steps: the first sighting eager, the second
    captured, then replays) with the warm bundle recorded and exported;
    then a child process builds the same model and runs
    Model.prepare(warm_bundle=path). Gates: the child's parameters bit
    for bit and its optimizer states at their initial values after the
    pre-warm, step count and key stream unchanged; its fit steps (the
    parent's batches) graph replays from the first, with no eager first
    sighting and no capture; its first loss within FIT_LOSS_RTOL of the
    parent's eager first step."""
    import shutil
    import tempfile
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import warmup
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    vocab = GPT_WIDTHS["vocab_size"]
    root = tempfile.mkdtemp(prefix="warm-bundle-")
    try:
        paddle.set_device("gpu")
        paddle.seed(SEED)
        net = GPTForCausalLM(GPTConfig(num_hidden_layers=WARM["layers"],
                                       **GPT_WIDTHS))
        opt = paddle.optimizer.AdamW(
            FIT["lr"], parameters=net.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        model = paddle.Model(net).prepare(opt, fit_loss(vocab),
                                          amp_configs="O1")
        warmup.clear_recorded()
        data = paddle.io.DataLoader(
            fit_dataset(vocab, WARM["batch"] * WARM["steps"], SEED),
            batch_size=WARM["batch"], num_workers=0)
        clock = step_clock()
        model.fit(data, epochs=1, verbose=0, callbacks=[clock])
        torch.cuda.synchronize()
        parent = {"step_ms": clock.step_ms(),
                  "losses": [float(v) for v in clock.losses],
                  "stats": {k: v for k, v in model._captured.stats.items()}}
        path = warmup.export_bundle(os.path.join(root, "warm_bundle.json"))
        entries = warmup.load_bundle(path)["entries"]
        warmup.clear_recorded()
        del model, opt, net, data, clock
        fresh_peak()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", WARM_CHILD, str(ROOT), path],
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"warm_bundle_boot: the child failed "
                                 f"({proc.returncode}): "
                                 f"{proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    problems = []
    if [e.get("build") for e in entries] != ["train"]:
        problems.append(f"the bundle's entries {entries}")
    for key, want in (("params_bit_equal", True), ("states_at_init", True),
                      ("global_step", 0), ("rng_equal", True),
                      ("captured_steps", WARM["steps"]),
                      ("eager_steps", 0),
                      ("compiles", 0), ("fallbacks", {})):
        if child[key] != want:
            problems.append(f"child {key} {child[key]!r} != {want!r}")
    rel = abs(child["losses"][0] - parent["losses"][0]) / \
        abs(parent["losses"][0])
    if rel > FIT_LOSS_RTOL:
        problems.append(f"the child's first loss {child['losses'][0]} "
                        f"against the parent's {parent['losses'][0]}")
    out = {"card": nvidia_smi_line(),
           "model": f"GPT 13B widths, {WARM['layers']} layer, AMP O1, "
                    f"AdamW + global-norm clip",
           "batch": WARM["batch"], "seq": FIT["seq"], "parent": parent,
           "bundle_entries": len(entries), "child": child,
           "child_wall_s": child_s,
           "cold_first_steps_ms": parent["step_ms"][:2],
           "warm_first_step_ms": child["step_ms"][0],
           "first_loss_rel_err": rel}
    if problems:
        emit({"phase": "warm_bundle_boot", "failed": out})
        raise AssertionError("warm_bundle_boot: " + "; ".join(problems))
    return out


def phase_build():
    import importlib
    import threading
    from paddle_tpu_torch.ops.kernels import build
    # the first call of K1's custom operator and the first torch.export
    # import torch._dynamo, several seconds of host: it runs beside nvcc
    importer = threading.Thread(target=importlib.import_module,
                                args=("torch._dynamo",), daemon=True)
    importer.start()
    out = {name: {"nvcc_seconds": b.seconds,
                  "ptxas": [ln.strip() for ln in b.log.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling entry" in ln
                            or "Performance Loss" in ln]}
           for name, b in build.build_all(verbose=True).items()}
    importer.join()
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
             "flash_attention_tma.cu"),
            # Transformer-base's cross-attention: 96 queries against 128
            # keys, with K5's dropout
            ("flash_attention_fwd_cross", 380,
             "_flash_fwd_pallas (_fwd_kernel :99, dropout_p > 0), "
             "Lq != Lk", "flash_attention_tma.cu"),
            ("flash_attention_bwd_dq_cross", 414,
             "_flash_bwd_pallas (_bwd_dq_kernel :208, dropout_p > 0), "
             "Lq != Lk", "flash_attention_tma.cu"),
            ("flash_attention_bwd_dkv_cross", 432,
             "_flash_bwd_pallas (_bwd_dkv_kernel :278, dropout_p > 0), "
             "Lq != Lk", "flash_attention_tma.cu"))}
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
        ("serve_export", lambda: phase_serve_export(state)),
        ("serve_int8", lambda: phase_serve_int8(state)),
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
        ("eager_core", phase_eager_core),
        ("gpt_train", lambda: {**phase_gpt_train(flash),
                               "parity": phase_gpt_train_parity()}),
        ("gpt_fit", lambda: phase_gpt_fit(flash)),
        ("gpt_fit_scaled", lambda: phase_gpt_fit_scaled(flash)),
        ("resnet50_train", phase_resnet50_train),
        ("resnet_parity", phase_resnet_parity),
        ("resnet_fit", phase_resnet_fit),
        ("mobilenet_v2_train", phase_mobilenet_v2_train),
        ("vision_zoo_parity", phase_vision_zoo_parity),
        ("vision_ops_parity", phase_vision_ops_parity),
        ("flash_cross_parity", lambda: phase_flash_cross_parity(flash)),
        ("transformer_base_train",
         lambda: phase_transformer_base_train(flash)),
        ("lstm_lm_beam", lambda: phase_lstm_lm_beam(flash)),
        ("op_tail_parity", phase_op_tail_parity),
        ("to_static_gpt", lambda: phase_to_static_gpt(flash)),
        ("jit_export", lambda: phase_jit_export(flash)),
        ("llama_recompute_train",
         lambda: phase_llama_recompute_train(flash)),
        ("llama_generate", lambda: phase_llama_generate(flash)),
        ("fused_encoder_train", lambda: phase_fused_encoder_train(flash)),
        ("autograd_core_parity", phase_autograd_core_parity),
        ("warm_bundle_boot", phase_warm_bundle_boot),
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
