#!/usr/bin/env python3
"""Time the grouped-matmul TMA / wgmma kernels (K6 forward and dlhs, K7)
in variants of ring depth and tile width, on one card, in one run.

Run from the root of a checkout on a machine with a Hopper card:

    python3 gmm_variants.py

Each variant is an edited copy of ``csrc/grouped_matmul.cu`` (``kStages``
3 or 4; ``kTN`` 128 with wgmma m64n128k16, or 256 with m64n256k16),
built with the port's nvcc flags into ``_scratch/variants/`` and loaded
in place of the built library. Each variant is checked against the plain
versions on three ragged bf16 layouts (the largest error as a share of
chip_smoke.py's bf16 limit, fwd / dlhs / drhs), then timed at the op
bench's geometry and ERNIE-MoE's w_in and w_out products (CUDA events,
median of 10 samples of 5 calls), in two passes, the second in reverse
order. Then the general mma.sync kernels (the first design) and
torch.bmm over the equal groups on the same inputs. Prints one JSON line
per variant and writes everything to ``_scratch/variants/results.json``.
Imports nothing of JAX.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
VARIANTS = {"s3_n128": (3, 128), "s4_n128": (4, 128), "s3_n256": (3, 256),
            "s4_n256": (4, 256)}
GEOMETRIES = {"op_bench": (16384, 1024, 4096, 16),
              "moe_w_in": (40960, 768, 3072, 8),
              "moe_w_out": (40960, 3072, 768, 8)}


def wgmma256() -> str:
    """The m64n256k16 form of the source's wgmma function."""
    regs = ", ".join(f"%{i}" for i in range(128))
    accs = ", ".join(f'"+f"(d[{i}])' for i in range(128))
    return ('''template <int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[kAcc], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %130, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "''' + regs + '''"
      "}, %128, %129, p, 1, 1, %131, %132;\\n"
      "}\\n"
      : ''' + accs + '''
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}
''')


def variant_source(src: str, stages: int, tn: int) -> str:
    for anchor in ("constexpr int kStages = 3;", "constexpr int kTN = 128; ",
                   "template <int kTA, int kTB>",
                   "// The 1024-aligned shared memory"):
        if anchor not in src:
            raise ValueError(f"grouped_matmul.cu no longer holds {anchor!r}")
    s = src.replace("constexpr int kStages = 3;",
                    f"constexpr int kStages = {stages};")
    if tn != 128:
        s = s.replace("constexpr int kTN = 128; ", f"constexpr int kTN = {tn}; ")
        i = s.index("template <int kTA, int kTB>")
        j = s.index("// The 1024-aligned shared memory")
        s = s[:i] + wgmma256() + "\n" + s[j:]
    return s


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("gmm_variants.py needs the card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gmm

    print(cs.nvidia_smi_line(), flush=True)
    src = (build.CSRC / "grouped_matmul.cu").read_text()
    out = ROOT / "_scratch" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (stages, tn) in VARIANTS.items():
        cu = out / f"gmm_{name}.cu"
        cu.write_text(variant_source(src, stages, tn))
        procs[name] = subprocess.Popen(
            build.nvcc_command(cu, out / f"libgmm_{name}.so", verbose=True),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(name, "nvcc", proc.returncode, flush=True)
        if proc.returncode == 0:
            libs[name] = out / f"libgmm_{name}.so"
        else:
            print(log[-3000:])

    def use(path):
        """Load a variant's library in place of the built one."""
        gmm._lib = None
        orig = build.load
        build.load = lambda name: ctypes.CDLL(str(path))
        try:
            gmm._kernel_lib()
        finally:
            build.load = orig

    def check(t, k, n, sizes, seed=0):
        e = len(sizes)
        g_ = torch.Generator(device="cuda").manual_seed(seed)
        lhs = torch.randn(t, k, generator=g_, device="cuda").bfloat16()
        dy = torch.randn(t, n, generator=g_, device="cuda").bfloat16()
        rhs = torch.randn(e, k, n, generator=g_, device="cuda").bfloat16()
        off = gmm.offsets_from_group_sizes(sizes, e, t, "cuda")
        got = (gmm.grouped_matmul_fwd(lhs, rhs, off),
               gmm.grouped_matmul_dlhs(dy, rhs, off),
               gmm.grouped_matmul_drhs(lhs, dy, off, e))
        ref = (gmm.grouped_matmul_fwd_reference(lhs, rhs, off),
               gmm.grouped_matmul_fwd_reference(dy, rhs.transpose(1, 2),
                                                off),
               gmm.grouped_matmul_drhs_reference(lhs, dy, off, e))
        tol = cs.GMM_TOL["bfloat16"]
        used = []
        for a, b in zip(got, ref):
            a, b = a.float(), b.float()
            scale = b.square().mean().sqrt()
            used.append(float(((a - b).abs() / (tol * (scale + b.abs())))
                              .max()))
        return used

    small = [int(x) for x in np.random.default_rng(0).integers(0, 201, 64)]
    inputs = {g: cs.gmm_inputs(t, k, n, e, [t // e] * e, None, 128,
                               torch.bfloat16, 1)
              for g, (t, k, n, e) in GEOMETRIES.items()}
    res = {}
    for name in list(libs) + list(reversed(list(libs))):
        use(libs[name])
        r = res.setdefault(name, {"checks": [], "times": {}})
        if not r["checks"]:
            r["checks"] = [
                check(sum(small) + 40, 512, 768, small),
                check(300, 200, 72, [37, 0, 101, 150]),
                check(1000, 256, 256, [70, 130, 1, 63, 65, 0, 300, 200])]
        for g, (t, k, n, e) in GEOMETRIES.items():
            lhs, rhs, dy, off = inputs[g]
            for kn, fn in (
                    ("fwd", lambda: gmm.grouped_matmul_fwd(lhs, rhs, off)),
                    ("dlhs", lambda: gmm.grouped_matmul_dlhs(dy, rhs, off)),
                    ("drhs",
                     lambda: gmm.grouped_matmul_drhs(lhs, dy, off, e))):
                r["times"].setdefault(f"{g}.{kn}", []).append(
                    round(cs.time_ms(fn, samples=10, inner=5), 4))
        print(json.dumps({name: r}), flush=True)
    use(libs[next(iter(libs))])
    base = {}
    for g, (t, k, n, e) in GEOMETRIES.items():
        lhs, rhs, dy, off = inputs[g]
        general = cs.gmm_general(lhs, rhs, dy, off)
        c = t // e
        lib = {"fwd": lambda: torch.bmm(lhs.view(e, c, k), rhs),
               "dlhs": lambda: torch.bmm(dy.view(e, c, n),
                                         rhs.transpose(1, 2)),
               "drhs": lambda: torch.bmm(lhs.view(e, c, k).transpose(1, 2),
                                         dy.view(e, c, n))}
        for kn, gname in zip(("fwd", "dlhs", "drhs"), cs.GMM_KERNELS):
            base[f"{g}.{kn}"] = {
                "general": round(cs.time_ms(general[gname], samples=10,
                                            inner=5), 4),
                "bmm": round(cs.time_ms(lib[kn], samples=10, inner=5), 4)}
    print(json.dumps({"baselines": base}), flush=True)
    (out / "results.json").write_text(
        json.dumps({"variants": res, "baselines": base}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
