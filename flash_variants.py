#!/usr/bin/env python3
"""Time the head-dim-64 flash kernels of the TMA / wgmma design (K1a
forward, K2a dQ and dK/dV, with and without the dropout keep mask K5,
and their segment instances K4a / K4b) in variants of their design
choices, on one card, in one run.

Run from the root of a checkout on a machine with a Hopper card:

    python3 flash_variants.py [PARENT_SOURCE]

``PARENT_SOURCE``, optional, is another revision's
``flash_attention_tma.cu`` (e.g. ``git show HEAD~1:paddle_tpu_torch/ops/
kernels/csrc/flash_attention_tma.cu``, written to a file beforehand): it
is built as the variant ``parent`` and its instances without segments
are timed beside the shipped ones, in turns, their outputs compared bit
for bit with the shipped ones' on the same inputs.

Each variant is an edited copy of ``csrc/flash_attention_tma.cu``:

- ``shipped``     the source as it is;
- ``exp2f``       the accurate ``exp2f`` in place of the MUFU's
                  ``ex2.approx.ftz`` alone;
- ``head_order``  causal blocks longest first within each head (the
                  D-128 kernels' order) in place of across the grid;
- ``ring2``       a ring of two stages in place of four;
- ``dkv_q64``     dK/dV on 64-query stages (one CTA an SM: its four
                  64 x 64 tiles take more than 128 registers) in place of
                  32-query ones (two CTAs an SM);
- ``ids_global``  (segments) the element mask reads the tile's ids from
                  global memory in place of the ring stage's copy in
                  shared memory;
- ``mask_all``    (segments) every tile is masked element by element in
                  place of only those whose ids and the warpgroup's rows'
                  are not all one id;
- ``trace``       a probe, not a design: globaltimer stamps by thread 0
                  of each CTA of the D-64 forward (entry, Q landed, first
                  stage landed, walk done, end), whose summary splits a
                  segmented launch into its CTAs' prologue, first stage,
                  walk and epilogue.

Beside the builds, ``scan`` is the shipped library given a window of the
whole sequence for every CTA: each walks every tile and skips those of
other segments one by one, as the TPU kernels and the first design do.

Each copy is written under ``_scratch/variants/`` and built there with
the port's nvcc flags (``-I`` to the package's sources, so that its
includes resolve; the package's source directory is never written to),
its ptxas report read (registers and spills per D-64 instance), checked
against the plain versions (the largest error of out, dq, dk, dv as a
share of chip_smoke.py's bf16 limit), then its C entries timed
(chip_smoke.time_ms: CUDA events around calls queued behind a device
sleep, median of 10 samples of 5 calls), in two passes, the second in
reverse order: without segments at BERT's attention (B 24, L 512, H 12,
D 64, bidirectional) with and without dropout 0.1, at ERNIE-MoE's
(B 8, L 2048, H 12, D 64, causal) and at the Llama training geometry
(B 4, L 2048, H 32, D 128, causal: the D-128 kernels, which the D-64
variants leave as they are); with segments at the varlen geometry
(12,288 packed tokens in chip_smoke.py's sequences of 32-512, H 12,
D 64), full and causal. Then the first design (mma.sync) and PyTorch's
SDPA forward on the same inputs. Prints one JSON line per variant and
writes everything to ``_scratch/variants/flash_results.json``. Imports
nothing of JAX.
"""
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXP = ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
       "  y = exp2f(x);")
ORDER = ("  if (!kCausal) return make_int3(blockIdx.x, blockIdx.y, "
         "blockIdx.z);",
         "  return make_int3(blockIdx.x, blockIdx.y, blockIdx.z);")
RING = ("constexpr int k64Stages = 4;", "constexpr int k64Stages = 2;")
DKV_Q = ("constexpr int kDkv64Q = 32;", "constexpr int kDkv64Q = 64;")
DKV_BOUNDS = ("__global__ void __launch_bounds__(k64Threads, 2)\n"
              "    flash_bwd_dkv64_tma_kernel(",
              "__global__ void __launch_bounds__(k64Threads, 1)\n"
              "    flash_bwd_dkv64_tma_kernel(")
IDS_GLOBAL = [(f"seg_bits<{n}>(sm.ids_ptr(p.stage), {r})",
               f"seg_bits<{n}>(sg.ids + b * sg.sb + {c}, {r})")
              for n, r, c in (("k64Keys", "sr", "k0"),
                              ("kDkv64Q", "sk", "q0"))]
MASK_ALL = [("      seg_edge = !one_segment(tr, wr);\n",
             "      seg_edge = true;\n")]
TRACE_BUF = """
__device__ unsigned long long g_trace[1 << 15][8];
#define TRACE(k)                                                        \\
  do {                                                                  \\
    if (threadIdx.x == 0)                                               \\
      g_trace[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +       \\
              blockIdx.x][k] = globaltimer();                           \\
  } while (0)
"""
TRACE = [
    ("\nconstexpr int k64Warps", TRACE_BUF + "\nconstexpr int k64Warps"),
    ("  // full[s]: the copies' arrival (and with segments every filling "
     "lane's)\n  const S sm = make_smem64<S>(kSeg ? 1 + 32 : 1);",
     "  TRACE(0);\n  const S sm = make_smem64<S>(kSeg ? 1 + 32 : 1);"),
    ("  mbar_wait(sm.once_bar(), 0);\n  Pipe64 p;\n"
     "  for (int j = win.x; j < win.y; ++j, p.next()) {\n"
     "    const int k0 = j * k64Keys;\n"
     "    mbar_wait(sm.full(p.stage), p.phase);\n"
     "    // causal: skip a tile every key",
     "  mbar_wait(sm.once_bar(), 0);\n  TRACE(1);\n  Pipe64 p;\n"
     "  for (int j = win.x; j < win.y; ++j, p.next()) {\n"
     "    const int k0 = j * k64Keys;\n"
     "    mbar_wait(sm.full(p.stage), p.phase);\n"
     "    if (j == win.x) TRACE(2);\n"
     "    // causal: skip a tile every key"),
    ("  // out = acc / (1 - p) / max(l, 1e-30): one division a row\n",
     "  TRACE(3);\n"
     "  // out = acc / (1 - p) / max(l, 1e-30): one division a row\n"),
    ("        lp[row[r]] = l[r] > 0.f ? m[r] * kLn2 + logf(lm[r]) : "
     "kNegInf;\n  }\n}\n",
     "        lp[row[r]] = l[r] > 0.f ? m[r] * kLn2 + logf(lm[r]) : "
     "kNegInf;\n  }\n  TRACE(4);\n}\n"),
]
TRACE_ENTRY = """
extern "C" int flash_trace(void* dst, int n, int clear) {
  void* buf;
  if (cudaGetSymbolAddress(&buf, g_trace) != cudaSuccess) return 1;
  if (clear) return (int)cudaMemset(buf, 0, sizeof(g_trace));
  return (int)cudaMemcpy(dst, buf, (size_t)n * 64, cudaMemcpyDeviceToHost);
}
"""
VARIANTS = {"shipped": [], "exp2f": [EXP], "head_order": [ORDER],
            "ring2": [RING], "dkv_q64": [DKV_Q, DKV_BOUNDS],
            "ids_global": IDS_GLOBAL, "mask_all": MASK_ALL, "trace": TRACE}
SEG_VARIANTS = ("shipped", "scan", "ids_global", "mask_all")
GEOMETRIES = {"bert": ((24, 512, 12, 64), False, 0.0),
              "bert_dropout": ((24, 512, 12, 64), False, 0.1),
              "moe": ((8, 2048, 12, 64), True, 0.0),
              "llama": ((4, 2048, 32, 128), True, 0.0)}
SEG_GEOMETRIES = {"varlen": False, "varlen_causal": True}
SEED = 0x5EED0123456789AB


def seed_key():
    """SEED as the key tensor the wrappers take (its two words)."""
    import torch
    return torch.tensor([SEED & 0xFFFFFFFF, SEED >> 32], dtype=torch.int64,
                        device="cuda")


def variant_source(src: str, subs, tail: str = "") -> str:
    for old, new in subs:
        if old not in src:
            raise ValueError(f"flash_attention_tma.cu no longer holds "
                             f"{old!r}")
        src = src.replace(old, new)
    return src + tail


def bind(path, segments=True, key_ptr=True, key_len=True):
    """A variant's library with its three entries' argument types (a
    source from before the segment instances has no segment arguments;
    one from before the key in device memory takes the Philox key's two
    words by value; one from before unequal lengths has no key length
    after the query length)."""
    lib = ctypes.CDLL(str(path))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    seg = [p, ctypes.c_longlong, p, p] if segments else []
    key = [p] if key_ptr else [u, u]
    tail = [p] + [i] * (6 if key_len else 5) + [ctypes.c_float] + seg + \
        key + [u, ctypes.c_float, p]
    lib.flash_attention_tma_forward.argtypes = [p] * 5 + tail
    lib.flash_attention_tma_backward_dq.argtypes = [p] * 7 + tail
    lib.flash_attention_tma_backward_dkv.argtypes = [p] * 8 + tail
    lib.segments = segments
    lib.key_ptr = key_ptr
    lib.key_len = key_len
    return lib


def calls(lib, q, k, v, do, lse, delta, causal, p, plan=None,
          windows=None):
    """fwd, dq, dkv through a library's C entries, and their outputs;
    ``plan`` a SegmentPlan, ``windows`` {kernel: window table} in place of
    the plan's own."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, L, H, D = fa._as4(q).shape
    thresh, inv = fa._dropout_args(p, SEED if p else None)
    lo, hi = fa._seed_words(SEED) if thresh else (0, 0)
    key_t = torch.tensor([lo, hi], dtype=torch.int64, device="cuda")
    key = (key_t.data_ptr() if thresh else None,) if lib.key_ptr \
        else (lo, hi)
    out, g = torch.empty_like(q), torch.empty_like(q)
    gk, gv = torch.empty_like(k), torch.empty_like(v)
    ls = torch.empty((B, H, L), dtype=torch.float32, device="cuda")
    s4, s5 = fa._strides(q, k, v, out), fa._strides(q, k, v, do, g)
    s6 = fa._strides(q, k, v, do, gk, gv)

    def tail(kernel):
        seg = ()
        if lib.segments:
            seg = (None, 0, None, None)
            if plan is not None:
                win = (windows or {}).get(kernel)
                if win is None:
                    win = plan.window(kernel, D, causal)
                seg = (plan.ids.data_ptr(), plan.ids.stride(0),
                       plan.ranges.data_ptr(), win.data_ptr())
        lens = (L, k.shape[1]) if lib.key_len else (L,)
        return (B, *lens, H, D, int(causal), 1 / math.sqrt(D), *seg, *key,
                thresh, inv, torch.cuda.current_stream().cuda_stream)

    def check(rc):
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    ptr = [x.data_ptr() for x in (q, k, v, do)]
    return {
        "fwd": lambda: check(lib.flash_attention_tma_forward(
            *ptr[:3], out.data_ptr(), ls.data_ptr(), s4, *tail("fwd"))),
        "dq": lambda: check(lib.flash_attention_tma_backward_dq(
            *ptr, lse.data_ptr(), delta.data_ptr(), g.data_ptr(), s5,
            *tail("dq"))),
        "dkv": lambda: check(lib.flash_attention_tma_backward_dkv(
            *ptr, lse.data_ptr(), delta.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), s6, *tail("dkv")))}, (out, g, gk, gv)


def scan_windows(plan, D, causal):
    """The windows of a whole-sequence scan: every CTA from tile 0 to the
    last (the kernels clip causal ones at the diagonal)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    out = {}
    for kernel in ("fwd", "dq", "dkv"):
        w = plan.window(kernel, D, causal).clone()
        _, tile = fa._tma_tiles(kernel, D)
        w[..., 0] = 0
        w[..., 1] = -(-plan.ids.shape[1] // tile)
        out[kernel] = w
    return out


def max_tol_used(outs, ref, tol):
    return max(float(((a.float() - b.float()).abs()
                      / (tol * (1 + b.float().abs()))).max())
               for a, b in zip(outs, ref))


def plain_parts(q, k, v, do, lse, delta, causal, kw):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    return (fa.flash_attention_fwd_reference(q, k, v, causal, None, **kw)[0],
            fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, None, **kw),
            *fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                  causal, None, **kw))


def trace_summary(lib, q, k, v, do, lse, delta, causal, plan):
    """Where a segmented forward launch's time goes, from the trace
    probe: per CTA the medians and maxima (us) of its phases and of the
    tiles its window holds, how far apart the CTAs start, and the
    launch's span from the first entry to the last end."""
    import torch
    fns, _ = calls(lib, q, k, v, do, lse, delta, causal, 0.0, plan)
    B, L, H = q.shape[0], q.shape[1], q.shape[2]
    n = B * H * -(-L // 128)
    for _ in range(3):
        fns["fwd"]()
    torch.cuda.synchronize()
    lib.flash_trace.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    buf = (ctypes.c_ulonglong * (8 * n))()
    if lib.flash_trace(None, 0, 1):
        raise RuntimeError("trace clear failed")
    fns["fwd"]()
    torch.cuda.synchronize()
    if lib.flash_trace(ctypes.addressof(buf), n, 0):
        raise RuntimeError("trace read failed")
    ctas = [list(buf[8 * i:8 * i + 8]) for i in range(n)]
    t0 = min(c[0] for c in ctas)
    win = plan.window("fwd", q.shape[-1], causal)
    tiles = (win[..., 1] - win[..., 0]).flatten().tolist()

    def stat(xs):
        xs = [x / 1e3 for x in xs]
        return {"median": statistics.median(xs), "max": max(xs)}

    return {"launch_us": (max(c[4] for c in ctas) - t0) / 1e3,
            "ctas": n,
            "tiles_per_cta": {"median": statistics.median(tiles),
                              "max": max(tiles), "sum_per_head": sum(tiles)},
            "phases_us": {
                "start_offset": stat([c[0] - t0 for c in ctas]),
                "prologue_q_landed": stat([c[1] - c[0] for c in ctas]),
                "first_stage": stat([c[2] - c[1] for c in ctas]),
                "walk": stat([c[3] - c[2] for c in ctas]),
                "epilogue": stat([c[4] - c[3] for c in ctas]),
                "cta": stat([c[4] - c[0] for c in ctas])}}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("flash_variants.py needs the card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    print(cs.nvidia_smi_line(), flush=True)
    src = (build.CSRC / "flash_attention_tma.cu").read_text()
    sources = {name: variant_source(src, subs,
                                    TRACE_ENTRY if name == "trace" else "")
               for name, subs in VARIANTS.items()}
    if len(sys.argv) > 1:
        sources["parent"] = Path(sys.argv[1]).read_text()
    out = ROOT / "_scratch" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        # the copy lives under _scratch; -I resolves its includes
        cu = out / f"variant_{name}.cu"
        cu.write_text(text)
        cmd = build.nvcc_command(cu, out / f"libflash_{name}.so",
                                 verbose=True)
        cmd[cmd.index("-o"):cmd.index("-o")] = ["-I", str(build.CSRC)]
        procs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, res = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(name, "nvcc", proc.returncode, flush=True)
        if proc.returncode:
            print(log[-3000:])
            continue
        libs[name] = bind(out / f"libflash_{name}.so",
                          segments="Seg sg" in sources[name],
                          key_ptr="const long long* key" in sources[name],
                          key_len="int Lk" in sources[name])
        inst = cs.ptxas_instances([ln for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln
                                   or "Compiling entry" in ln])
        res[name] = {"registers_and_spills": {
            k: v for k, v in inst.items() if "64" in k},
            "checks": {}, "times": {}}
    tol = cs.FLASH_TOL["bfloat16"]
    # without segments: the design variants (and the parent's source)
    inputs = {}
    for g, (shape, causal, p) in GEOMETRIES.items():
        q, k, v, do = cs.flash_inputs(shape, torch.bfloat16, seed=1)
        kw = dict(dropout_p=p, seed=seed_key()) if p else {}
        o, lse = fa.flash_attention_fwd(q, k, v, causal, None, **kw)
        inputs[g] = (q, k, v, do, lse, fa.attention_delta(o, do), causal, p,
                     kw)
    plain = [n for n in libs if n not in ("trace", "ids_global",
                                          "mask_all")]
    firsts = {}      # the shipped and parent libraries' outputs, once each
    for name in plain + list(reversed(plain)):
        r = res[name]
        for g, (q, k, v, do, lse, delta, causal, p, kw) in inputs.items():
            fns, outs = calls(libs[name], q, k, v, do, lse, delta, causal, p)
            if name in ("shipped", "parent") and \
                    (name, g) not in firsts:
                for fn in fns.values():
                    fn()
                torch.cuda.synchronize()
                firsts[(name, g)] = [o.clone() for o in outs]
            if g.startswith("bert") and g not in r["checks"]:
                for fn in fns.values():
                    fn()
                r["checks"][g] = max_tol_used(
                    outs, plain_parts(q, k, v, do, lse, delta, causal, kw),
                    tol)
            for kn, fn in fns.items():
                r["times"].setdefault(f"{g}.{kn}", []).append(
                    round(cs.time_ms(fn, samples=10, inner=5), 4))
        print(json.dumps({name: r}), flush=True)
    if "parent" in res:
        res["parent"]["bit_equal_to_shipped"] = {
            g: all(torch.equal(a, b) for a, b in zip(
                firsts[("parent", g)], firsts[("shipped", g)]))
            for g in inputs}
        print(json.dumps({"parent_bit_equal": res["parent"][
            "bit_equal_to_shipped"]}), flush=True)
    del inputs, firsts
    # with segments: the window against a scan, the ids' path, the edge
    # rule, and the trace of the forward
    lens = cs.varlen_lengths()
    seg = cs.varlen_seg(lens)
    plan = fa.SegmentPlan(seg)
    shape = (1, cs.VARLEN["total"], cs.VARLEN["heads"],
             cs.VARLEN["head_dim"])
    seg_inputs = {}
    for g, causal in SEG_GEOMETRIES.items():
        q, k, v, do = cs.flash_inputs(shape, torch.bfloat16, seed=1)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, None, seg=plan)
        seg_inputs[g] = (q, k, v, do, lse, fa.attention_delta(o, do),
                         causal)
    seg_res = {n: {"checks": {}, "times": {}} for n in SEG_VARIANTS
               if n in libs or n == "scan"}
    order = list(seg_res)
    for name in order + list(reversed(order)):
        r = seg_res[name]
        lib = libs["shipped" if name == "scan" else name]
        for g, (q, k, v, do, lse, delta, causal) in seg_inputs.items():
            wins = scan_windows(plan, shape[-1], causal) \
                if name == "scan" else None
            fns, outs = calls(lib, q, k, v, do, lse, delta, causal, 0.0,
                              plan, wins)
            if g not in r["checks"]:
                for fn in fns.values():
                    fn()
                r["checks"][g] = max_tol_used(
                    outs, plain_parts(q, k, v, do, lse, delta, causal,
                                      {"seg": seg}), tol)
            for kn, fn in fns.items():
                r["times"].setdefault(f"{g}.{kn}", []).append(
                    round(cs.time_ms(fn, samples=10, inner=5), 4))
        print(json.dumps({f"segments.{name}": r}), flush=True)
    trace = {}
    if "trace" in libs:
        for g, (q, k, v, do, lse, delta, causal) in seg_inputs.items():
            trace[g] = trace_summary(libs["trace"], q, k, v, do, lse, delta,
                                     causal, plan)
        print(json.dumps({"trace": trace}), flush=True)
    # the first design and SDPA on the same inputs
    base = {}
    for g, (shape_g, causal, p) in GEOMETRIES.items():
        q, k, v, do = cs.flash_inputs(shape_g, torch.bfloat16, seed=1)
        kw = dict(dropout_p=p, seed=seed_key()) if p else {}
        o, lse = fa.flash_attention_fwd(q, k, v, causal, None, **kw)
        delta = fa.attention_delta(o, do)
        general = cs.flash_general(q, k, v, do, lse, delta, causal, p,
                                   kw.get("seed"))
        for kn, gname in (("fwd", "flash_attention_fwd"),
                          ("dq", "flash_attention_bwd_dq"),
                          ("dkv", "flash_attention_bwd_dkv")):
            base[f"{g}.{kn}.general"] = round(
                cs.time_ms(general[gname], samples=10, inner=5), 4)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        base[f"{g}.fwd.sdpa"] = round(cs.time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, dropout_p=p),
            samples=10, inner=5), 4)
    for g, (q, k, v, do, lse, delta, causal) in seg_inputs.items():
        general = cs.flash_general(q, k, v, do, lse, delta, causal, seg=seg)
        for kn, gname in (("fwd", "flash_attention_fwd"),
                          ("dq", "flash_attention_bwd_dq"),
                          ("dkv", "flash_attention_bwd_dkv")):
            base[f"{g}.{kn}.general"] = round(
                cs.time_ms(general[gname], samples=10, inner=5), 4)
    print(json.dumps({"baselines": base}), flush=True)
    (out / "flash_results.json").write_text(json.dumps(
        {"variants": res, "segments": seg_res, "trace": trace,
         "baselines": base}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
