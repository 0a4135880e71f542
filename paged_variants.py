#!/usr/bin/env python3
"""Time the split paged-attention kernel (K3's Hopper design,
``csrc/paged_attention_split.cu``) in variants of its design choices, on
one card, in one run.

Run from the root of a checkout on a machine with a Hopper card:

    python3 paged_variants.py

Variants:

- ring depth: the source built as it is (the CUDA-core path's ring of 2
  stages, the tensor-core path's of 4) and as edited copies with 3 or 4
  and 6 or 8 stages. Every variant is a copy of the source written under
  ``_scratch/variants/`` and built there into its own library with the
  port's nvcc flags (its ptxas report is read: registers and spills per
  instance); the package's source directory is never written to;
- span: the columns a CTA walks (a launch argument, 128 to 1024) on the
  shipped library;
- the CUDA-core / tensor-core threshold: a KV head's query rows in the
  group the shipped plan picks and in the other kind (CUDA-core groups of
  4, or one tensor-core group of 64), at 1, 2, 4, 8, 16 and 64 rows (MHA
  decode, an MHA verify window of 2 tokens, GQA decode at R = 4 and 8, a
  4-token GQA verify window at R = 4, the prefill chunk);
- the CUDA-core path's registers sized for 6 or 8 CTAs an SM (1-row
  groups) in place of one, as edited copies;
- a probe, not a design: the walk without its products and softmax,
  which shows what streaming, the prologue and the merge cost alone;
  and a copy with ``globaltimer`` stamps per CTA, whose summary splits
  each launch into its CTAs' phases.

Geometries: chip_smoke.py's three K3 rows (decode with bf16 and with
int8 pools, and the 64-row prefill chunk, whose calls rotate over four
copies of the pools so that each finds its K/V out of L2), and the four
other threshold geometries. Every variant is first checked against the plain
walk (chip_smoke.py's bf16 limit), then timed with chip_smoke.time_ms
(CUDA events around calls queued behind a device sleep, median of 20
samples of 5 calls), in two passes, the second in reverse order; the
first design (``csrc/paged_attention.cu``) is timed beside them. Prints
one JSON line per row and writes everything to
``_scratch/variants/paged_results.json``. Imports nothing of JAX.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPANS = (128, 256, 512, 1024)
# the ring depths of the CUDA-core path (shipped 2) and of the
# tensor-core path (shipped 4), as edits
STAGES = {f"{path}_stages{n}": [(f"constexpr int k{kind}Stages = {was};",
                                 f"constexpr int k{kind}Stages = {n};")]
          for path, kind, was, ns in (("dot", "Dot", 2, (3, 4)),
                                      ("mma", "Mma", 4, (6, 8)))
          for n in ns}
# the timed builds: the shipped source and the edited copies below
BUILDS = ("shipped", *STAGES, "dot_ctas6", "dot_ctas8", "no_compute")
# the CUDA-core path's registers sized for more CTAs an SM (6 or 8 with
# 1-row groups, 3 or 4 with 4-row groups) than its one, as edits
DOT_BOUNDS = ("__global__ void __launch_bounds__(kThreads, 1)\n"
              "    paged_attention_split_kernel(")
DOT_CTAS = {n: [(DOT_BOUNDS, DOT_BOUNDS.replace(
    "(kThreads, 1)", f"(kThreads, G == 1 ? {n} : {n // 2})"))]
    for n in (6, 8)}
# a probe, not a design: the walk without its products and softmax (the
# tensor-core path skips them after each stage's prep; the CUDA-core path
# after the stage's copies are issued), to show what streaming, the
# prologue and the merge cost alone
NO_COMPUTE = [("    if (!active) continue;\n", "    continue;\n"),
              ("    const unsigned char* stg = work + (st % Lay::kStages) "
               "* Lay::kStageB;\n    const int cs = 8 * warp + c;",
               "    continue;\n    const unsigned char* stg = work + "
               "(st % Lay::kStages) * Lay::kStageB;\n    const int cs = 8 * "
               "warp + c;")]

# a second probe: globaltimer stamps by thread 0 of each CTA (entry, past
# the prologue, first stage landed, walk done, partial state written and
# fenced, ticket taken, end; or the exit of a CTA with no live column)
TRACE_BUF = """
__device__ unsigned long long g_trace[1 << 17][8];
#define TRACE(k)                                                       \\
  do {                                                                 \\
    if (threadIdx.x == 0)                                              \\
      g_trace[blockIdx.y * gridDim.x + blockIdx.x][k] = globaltimer(); \\
  } while (0)
"""
TRACE = [
    ("\nconstexpr int kThreads", TRACE_BUF + "\nconstexpr int kThreads"),
    ("  Unit u = unit_of<G>(p);", "  TRACE(0);\n  Unit u = unit_of<G>(p);"),
    ("  Unit u = unit_of<kMmaRows>(p);",
     "  TRACE(0);\n  Unit u = unit_of<kMmaRows>(p);"),
    ("  if (!prologue<G>(p, u, tok_s, pos_s, orow_s, red_s)) return;",
     "  if (!prologue<G>(p, u, tok_s, pos_s, orow_s, red_s)) {\n"
     "    TRACE(7);\n    return;\n  }\n  TRACE(1);"),
    ("  if (!prologue<kMmaRows>(p, u, tok_s, pos_s, orow_s, red_s)) return;",
     "  if (!prologue<kMmaRows>(p, u, tok_s, pos_s, orow_s, red_s)) {\n"
     "    TRACE(7);\n    return;\n  }\n  TRACE(1);"),
    ("    cp_async_wait<Lay::kStages - 2>();\n    __syncthreads();\n",
     "    cp_async_wait<Lay::kStages - 2>();\n    __syncthreads();\n"
     "    if (st == 0) TRACE(2);\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n",
     "  cp_async_wait<0>();\n  __syncthreads();\n  TRACE(3);\n"),
    ("             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));"
     "\n    }\n    return;",
     "             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));"
     "\n    }\n    TRACE(6);\n    return;"),
    ("  __threadfence();\n  __syncthreads();\n  if (tid == 0) *flag_s",
     "  __threadfence();\n  __syncthreads();\n  TRACE(4);\n"
     "  if (tid == 0) *flag_s"),
    ("  if (!*flag_s) return;", "  TRACE(5);\n  if (!*flag_s) return;"),
    ("  if (tid == 0) p.tickets[u.unit] = 0;\n}",
     "  if (tid == 0) p.tickets[u.unit] = 0;\n  TRACE(6);\n}"),
]
TRACE_ENTRY = """
extern "C" int paged_trace(void* dst, int n, int clear) {
  void* buf;
  if (cudaGetSymbolAddress(&buf, g_trace) != cudaSuccess) return 1;
  if (clear) return (int)cudaMemset(buf, 0, sizeof(g_trace));
  return (int)cudaMemcpy(dst, buf, (size_t)n * 64, cudaMemcpyDeviceToHost);
}
"""


def probe_source(text: str, subs, tail: str = "") -> str:
    for old, new in subs:
        if old not in text:
            raise ValueError(f"paged_attention_split.cu no longer holds "
                             f"{old!r}")
        text = text.replace(old, new)
    return text + tail


def variant_sources(text: str):
    """{build: source} of every timed build (BUILDS) and the trace
    probe, from the shipped source's text."""
    subs = {"shipped": [], **STAGES,
            **{f"dot_ctas{n}": s for n, s in DOT_CTAS.items()},
            "no_compute": NO_COMPUTE}
    out = {n: probe_source(text, s) for n, s in subs.items()}
    out["trace"] = probe_source(text, TRACE, TRACE_ENTRY)
    return out


def build_variants():
    """{variant: library path} for every entry of BUILDS and the trace
    probe, built in parallel from copies under ``_scratch/variants/``
    (their includes resolve through ``-I`` to the package's sources),
    and their ptxas reports (registers, spills)."""
    from paddle_tpu_torch.ops.kernels import build
    out_dir = ROOT / "_scratch" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "paged_attention_split.cu").read_text()
    procs = {}
    for name, body in variant_sources(text).items():
        src = out_dir / f"paged_split_{name}.cu"
        src.write_text(body)
        lib = out_dir / f"libpaged_split_{name}.so"
        cmd = build.nvcc_command(src, lib, verbose=True)
        cmd[cmd.index("-o"):cmd.index("-o")] = ["-I", str(build.CSRC)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = {n: proc.communicate()[0] for n, (_, proc) in procs.items()}
    import chip_smoke
    libs, reports = {}, {}
    for n, (lib, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{logs[n]}")
        reports[n] = chip_smoke.ptxas_instances(logs[n].splitlines())
        libs[n] = lib
    return libs, reports


def bind(path):
    """A variant's library with the split entry's argument types."""
    lib = ctypes.CDLL(str(path))
    fn = lib.paged_attention_split_forward
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def geometries():
    """{name: (case, pool copies)}: chip_smoke's three K3 rows and the
    GQA threshold geometries."""
    import torch
    import chip_smoke as cs
    out = dict(cs.k3_time_cases())
    bf = torch.bfloat16
    pos = [2047, 1900, 1536, 1024, 700, 300, 100, 17]
    out["mha_verify_t2"] = (cs.make_case("mha_verify_t2", 8, 2, 32, 32, 128,
                                         16, 128, bf, pos, seed=19), 1)
    out["gqa4_decode"] = (cs.make_case("gqa4_decode", 8, 1, 32, 8, 128, 16,
                                       128, bf, pos, seed=20), 1)
    out["gqa8_decode"] = (cs.make_case("gqa8_decode", 8, 1, 32, 4, 128, 16,
                                       128, bf, pos, seed=21), 1)
    out["gqa4_verify_t4"] = (cs.make_case("gqa4_verify_t4", 8, 4, 32, 8,
                                          128, 16, 128, bf, pos, seed=22), 1)
    return out


def caller(case, copies, group_rows, span):
    """One split launch through the current library on the case's inputs
    (rotating over pool copies), and its output."""
    import torch
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    q, kp, vp, tables, positions = case["args"]
    kw = case["kw"]
    nt = torch.tensor([max(case["pos"]) // kp.shape[1] + 1],
                      dtype=torch.int32, device=q.device)
    pools = [(kp, vp)] + [(kp.clone(), vp.clone())
                          for _ in range(copies - 1)]
    out = torch.empty_like(q)
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % copies
        k, v = pools[turn[0]]
        pa.launch_split(q, k, v, tables, positions, nt, out,
                        kw.get("k_scale"), kw.get("v_scale"),
                        group_rows=group_rows, span=span,
                        n_rep=kw["n_rep"])
        return out
    return call


def first_caller(case, copies):
    """One launch of the first design (its C entry) on the same inputs."""
    import torch
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    q, kp, vp, tables, positions = case["args"]
    kw = case["kw"]
    S, T, H, D = q.shape
    NB, bs, K, _ = kp.shape
    nt = torch.tensor([max(case["pos"]) // bs + 1], dtype=torch.int32,
                      device=q.device)
    pools = [(kp, vp)] + [(kp.clone(), vp.clone())
                          for _ in range(copies - 1)]
    out = torch.empty_like(q)
    lib = pa._kernel_lib()
    quant = kw.get("k_scale") is not None
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % copies
        k, v = pools[turn[0]]
        rc = lib.paged_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kw["k_scale"].data_ptr() if quant else None,
            kw["v_scale"].data_ptr() if quant else None, tables.data_ptr(),
            positions.data_ptr(), nt.data_ptr(), out.data_ptr(), S, T, H, K,
            D, bs, tables.shape[1], NB, pa._DTYPE_CODES[q.dtype],
            pa._DTYPE_CODES[k.dtype],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"first design's launch failed: {rc}")
        return out
    return call


def rows_of(geos):
    """(geometry, variant, build, group_rows, span) of every timed row."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    rows = []
    for name, (case, _) in geos.items():
        q, kp, _, tables, _ = case["args"]
        S, T, H, D = q.shape
        g, _, span, _ = pa.split_plan(T, H // kp.shape[2], S, kp.shape[2],
                                      D, kp.shape[1], tables.shape[1],
                                      pa._sms(q.device))
        path = "mma" if g == 64 else "dot"
        for b in BUILDS:
            if b == "shipped" or b.startswith(path) or b == "no_compute":
                rows.append((name, b, b, g, span))
        for sp in SPANS:
            if sp != span:
                rows.append((name, f"span{sp}", "shipped", g, sp))
        other = 4 if g == 64 else 64
        rows.append((name, f"group_rows{other}", "shipped", other, span))
    return rows


def trace_summary(lib, case, copies, group_rows, span):
    """Where a launch's time goes, from the trace probe: per CTA with live
    columns the medians and maxima (us) of its phases, how far apart the
    CTAs start, and the launch's span from the first entry to the last
    end; the CTAs with none, and how long they live."""
    import statistics
    import torch
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    q, kp, _, tables, _ = case["args"]
    S, T, H, D = q.shape
    K, bs, MB = kp.shape[2], kp.shape[1], tables.shape[1]
    units = S * K * -(-(T * H // K) // group_rows)
    n = units * -(-MB * bs // span)
    call = caller(case, copies, group_rows, span)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (8 * n))()
    lib.paged_trace.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    if lib.paged_trace(None, 0, 1):
        raise RuntimeError("trace clear failed")
    call()
    torch.cuda.synchronize()
    if lib.paged_trace(ctypes.addressof(buf), n, 0):
        raise RuntimeError("trace read failed")
    ctas = [list(buf[8 * i:8 * i + 8]) for i in range(n)]
    t0 = min(c[0] for c in ctas)
    live = [c for c in ctas if c[1]]
    dead = [c for c in ctas if c[7]]
    ends = [c[6] or c[5] for c in live]

    def stat(xs):
        xs = [x / 1e3 for x in xs]
        return {"median": statistics.median(xs), "max": max(xs)}

    phases = {
        "start_offset": stat([c[0] - t0 for c in live]),
        "prologue": stat([c[1] - c[0] for c in live]),
        "first_stage": stat([c[2] - c[1] for c in live if c[2]]),
        "walk": stat([c[3] - (c[2] or c[1]) for c in live]),
        "write_fence": stat([c[4] - c[3] for c in live if c[4]]),
        "ticket": stat([c[5] - c[4] for c in live if c[5]]),
        "merge": stat([c[6] - c[5] for c in live if c[5] and c[6]]),
        "cta": stat([e - c[0] for c, e in zip(live, ends)])}
    return {"launch_us": (max(ends + [c[7] for c in dead]) - t0) / 1e3,
            "live_ctas": len(live), "dead_ctas": len(dead),
            "dead_cta": stat([c[7] - c[0] for c in dead]) if dead else None,
            "phases_us": phases}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("paged_variants.py needs the card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi_line()
    libs, reports = build_variants()
    bound = {n: bind(path) for n, path in libs.items()}
    geos = geometries()
    rows = rows_of(geos)
    result = {"card": card, "registers_and_spills": reports, "rows": {}}
    # correctness of every row before any timing (the probe computes
    # nothing and is not checked)
    for name, var, n, g, span in rows:
        case, copies = geos[name]
        pa._split_lib = bound[n]
        got = caller(case, 1, g, span)().float()
        torch.cuda.synchronize()
        used = None
        if n != "no_compute":
            ref = pa.paged_attention_reference(*case["args"], **case["kw"])
            err = (got - ref.float()).abs()
            used = float((err / (cs.BF16_TOL * (1 + ref.float().abs())))
                         .max())
            if used > 1:
                raise AssertionError(f"{name}/{var}: {used} of the limit")
        result["rows"][f"{name}/{var}"] = {"tol_used": used, "ms": []}
    for order in (rows, rows[::-1]):
        for name, var, n, g, span in order:
            case, copies = geos[name]
            pa._split_lib = bound[n]
            r = result["rows"][f"{name}/{var}"]
            r["ms"].append(cs.time_ms(caller(case, copies, g, span)))
            r.update(build=n, group_rows=g, span=span, copies=copies)
    for name, (case, copies) in geos.items():
        result["rows"][f"{name}/first_design"] = {
            "ms": [cs.time_ms(first_caller(case, copies))]}
        nbytes, flops = cs.attention_bytes_and_flops(
            case, max(case["pos"]) // case["kw"]["block_size"] + 1)
        result["rows"][f"{name}/bound"] = {"ms": [max(
            nbytes / cs.HBM_BYTES_PER_S, flops / cs.BF16_FLOPS) * 1e3]}
    pa._split_lib = bound["trace"]
    result["trace"] = {}
    for name, (case, copies) in geos.items():
        q, kp, _, tables, _ = case["args"]
        S, T, H, D = q.shape
        g, _, span, _ = pa.split_plan(T, H // kp.shape[2], S, kp.shape[2],
                                      D, kp.shape[1], tables.shape[1],
                                      pa._sms(q.device))
        result["trace"][name] = trace_summary(bound["trace"], case, copies,
                                              g, span)
        print(json.dumps({"trace": name, **result["trace"][name]}),
              flush=True)
    pa._split_lib = None
    for key, r in result["rows"].items():
        print(json.dumps({"row": key, **r}), flush=True)
    (ROOT / "_scratch" / "variants" / "paged_results.json").write_text(
        json.dumps(result, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
