#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

Run from the root of a checkout on a machine with a Hopper card:

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. ``env``            card name and power limit, torch and CUDA versions;
2. ``build``          compiles every kernel from ``paddle_tpu_torch``'s
                      sources with nvcc (sm_90a), printing ptxas' report;
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
5. ``serve``          THE MAIN PATH: a Llama-2-7B-width bf16 model with
                      random weights behind a PagedLlamaDecodeEngine and
                      a GenerationServer answers 12 requests; the kernel
                      launch count is reset just before and read just
                      after, and must equal layers x (decode steps +
                      prefill chunks); then a 4-layer int8-KV engine
                      answers 2 more requests through the kernel;
6. ``serve_parity``   an engine built with attention_impl="reference"
                      over the same weights runs one prompt beside a
                      kernel engine: logits compared, greedy agreement
                      printed.

Then the ``nvidia-smi`` name/power line, the ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line. Without CUDA, or when run outside a checkout, it
exits non-zero and prints no result. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
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


def phase_build():
    from paddle_tpu_torch.ops.kernels import build
    return {name: {"nvcc_seconds": b.seconds,
                   "ptxas": [ln.strip() for ln in b.log.splitlines()
                             if "registers" in ln
                             or "Compiling entry" in ln]}
            for name, b in build.build_all(verbose=True).items()}


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
    state: dict = {}
    phases = [
        ("env", lambda: {"nvidia_smi": smi, "torch": torch.__version__,
                         "cuda": torch.version.cuda, "device": kind,
                         "count": torch.cuda.device_count()}),
        ("build", phase_build),
        ("kernel_parity", lambda: phase_kernel_parity(result)),
        ("kernel_time", lambda: phase_kernel_time(result)),
        ("serve", lambda: phase_serve(state, result)),
        ("serve_parity", lambda: phase_serve_parity(state)),
    ]
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        emit({"phase": name, "seconds": time.perf_counter() - t0, **info})
    print(smi, flush=True)
    emit({"kernels": [result], "seconds": time.perf_counter() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
