#!/usr/bin/env python3
"""Time the head-dim-64 flash kernels of the TMA / wgmma design (K1a
forward, K2a dQ and dK/dV, with and without the dropout keep mask K5)
in variants of their design choices, on one card, in one run.

Run from the root of a checkout on a machine with a Hopper card:

    python3 flash_variants.py

Each variant is an edited copy of ``csrc/flash_attention_tma.cu``:

- ``shipped``     the source as it is;
- ``exp2f``       the accurate ``exp2f`` in place of the MUFU's
                  ``ex2.approx.ftz`` alone;
- ``head_order``  causal blocks longest first within each head (the
                  D-128 kernels' order) in place of across the grid;
- ``ring2``       a ring of two stages in place of four;
- ``dkv_q64``     dK/dV on 64-query stages (one CTA an SM: its four
                  64 x 64 tiles take more than 128 registers) in place of
                  32-query ones (two CTAs an SM).

Each copy is written under ``_scratch/variants/`` and built there with
the port's nvcc flags (``-I`` to the package's sources, so that its
includes resolve; the package's source directory is never written to),
its ptxas report read (registers and spills per
D-64 instance), checked against the plain versions at the BERT geometry
with and without dropout (the largest error of out, dq, dk, dv as a
share of chip_smoke.py's bf16 limit), then its C entries timed
(chip_smoke.time_ms: CUDA events around calls queued behind a device
sleep, median of 10 samples of 5 calls) at BERT's attention (B 24,
L 512, H 12, D 64, bidirectional) with and without dropout 0.1 and at
ERNIE-MoE's (B 8, L 2048, H 12, D 64, causal), in two passes, the
second in reverse order. Then the first design (mma.sync) and PyTorch's
SDPA forward on the same inputs. Prints one JSON line per variant and
writes everything to ``_scratch/variants/flash_results.json``. Imports
nothing of JAX.
"""
import ctypes
import json
import math
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
VARIANTS = {"shipped": [], "exp2f": [EXP], "head_order": [ORDER],
            "ring2": [RING], "dkv_q64": [DKV_Q, DKV_BOUNDS]}
GEOMETRIES = {"bert": ((24, 512, 12, 64), False, 0.0),
              "bert_dropout": ((24, 512, 12, 64), False, 0.1),
              "moe": ((8, 2048, 12, 64), True, 0.0)}
SEED = 0x5EED0123456789AB


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise ValueError(f"flash_attention_tma.cu no longer holds "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def bind(path):
    """A variant's library with its three entries' argument types."""
    lib = ctypes.CDLL(str(path))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    tail = [p, i, i, i, i, i, ctypes.c_float, u, u, u, ctypes.c_float, p]
    lib.flash_attention_tma_forward.argtypes = [p] * 5 + tail
    lib.flash_attention_tma_backward_dq.argtypes = [p] * 7 + tail
    lib.flash_attention_tma_backward_dkv.argtypes = [p] * 8 + tail
    return lib


def calls(lib, q, k, v, do, lse, delta, causal, p):
    """fwd, dq, dkv through a library's C entries, and their outputs."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, L, H, D = fa._as4(q).shape
    thresh, inv = fa._dropout_args(p, SEED if p else None)
    lo, hi = fa._seed_words(SEED) if thresh else (0, 0)
    out, g = torch.empty_like(q), torch.empty_like(q)
    gk, gv = torch.empty_like(k), torch.empty_like(v)
    ls = torch.empty((B, H, L), dtype=torch.float32, device="cuda")
    s4, s5 = fa._strides(q, k, v, out), fa._strides(q, k, v, do, g)
    s6 = fa._strides(q, k, v, do, gk, gv)

    def tail():
        return (B, L, H, D, int(causal), 1 / math.sqrt(D), lo, hi, thresh,
                inv, torch.cuda.current_stream().cuda_stream)

    def check(rc):
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    ptr = [x.data_ptr() for x in (q, k, v, do)]
    return {
        "fwd": lambda: check(lib.flash_attention_tma_forward(
            *ptr[:3], out.data_ptr(), ls.data_ptr(), s4, *tail())),
        "dq": lambda: check(lib.flash_attention_tma_backward_dq(
            *ptr, lse.data_ptr(), delta.data_ptr(), g.data_ptr(), s5,
            *tail())),
        "dkv": lambda: check(lib.flash_attention_tma_backward_dkv(
            *ptr, lse.data_ptr(), delta.data_ptr(), gk.data_ptr(),
            gv.data_ptr(), s6, *tail()))}, (out, g, gk, gv)


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
    out = ROOT / "_scratch" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        # the copy lives under _scratch; -I resolves its includes
        cu = out / f"variant_{name}.cu"
        cu.write_text(variant_source(src, subs))
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
        libs[name] = bind(out / f"libflash_{name}.so")
        inst = cs.ptxas_instances([ln for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln
                                   or "Compiling entry" in ln])
        res[name] = {"registers_and_spills": {
            k: v for k, v in inst.items() if "64" in k},
            "checks": {}, "times": {}}
    inputs = {}
    for g, (shape, causal, p) in GEOMETRIES.items():
        q, k, v, do = cs.flash_inputs(shape, torch.bfloat16, seed=1)
        kw = dict(dropout_p=p, seed=SEED) if p else {}
        o, lse = fa.flash_attention_fwd(q, k, v, causal, None, **kw)
        inputs[g] = (q, k, v, do, lse, fa.attention_delta(o, do), causal, p,
                     kw)
    tol = cs.FLASH_TOL["bfloat16"]
    for name in list(libs) + list(reversed(list(libs))):
        r = res[name]
        for g, (q, k, v, do, lse, delta, causal, p, kw) in inputs.items():
            fns, outs = calls(libs[name], q, k, v, do, lse, delta, causal, p)
            if g.startswith("bert") and g not in r["checks"]:
                for fn in fns.values():
                    fn()
                ref = (fa.flash_attention_fwd_reference(q, k, v, causal,
                                                        None, **kw)[0],
                       fa.flash_attention_bwd_dq_reference(
                           q, k, v, do, lse, delta, causal, None, **kw),
                       *fa.flash_attention_bwd_dkv_reference(
                           q, k, v, do, lse, delta, causal, None, **kw))
                r["checks"][g] = max(
                    float(((a.float() - b.float()).abs()
                           / (tol * (1 + b.float().abs()))).max())
                    for a, b in zip(outs, ref))
            for kn, fn in fns.items():
                r["times"].setdefault(f"{g}.{kn}", []).append(
                    round(cs.time_ms(fn, samples=10, inner=5), 4))
        print(json.dumps({name: r}), flush=True)
    base = {}
    for g, (q, k, v, do, lse, delta, causal, p, kw) in inputs.items():
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
    print(json.dumps({"baselines": base}), flush=True)
    (out / "flash_results.json").write_text(
        json.dumps({"variants": res, "baselines": base}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
