// Flash attention for Hopper (sm_90a), the TMA / wgmma design: the forward,
// dQ and dK/dV kernels for bf16 at head dim 128, causal or not, without
// dropout or segments (the Llama training attention).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py that
// _flash_fwd_pallas_blhd (_fwd_kernel) and _flash_bwd_pallas_blhd
// (_bwd_dq_kernel, _bwd_dkv_kernel) launch over [B, L, H, D]. The plain
// PyTorch versions beside the wrappers (ops/kernels/flash_attention.py) are
// the oracles; ops/kernels/flash_attention.py's takes_tma picks this design
// before a launch, and every other call (f32, D 64, dropout, segments, rows
// a tensor map cannot describe) takes the first design in
// flash_attention.cuh. The numerics are that design's:
//
//   forward  S = scale * Q K^T (masked: causal and the ragged tail ->
//            -1e30), online softmax over KV tiles in f32, O += P V with P
//            rounded to bf16; out = acc / max(l, 1e-30) in bf16 and
//            lse = m + log(max(l, 1e-30)) in f32 [B, H, L].
//   dQ       P = exp(scale * Q K^T - lse) (re-masked), dP = dO V^T,
//            dS = P * (dP - delta) * scale, dQ = dS K with dS rounded to
//            bf16; delta = rowsum(dO * O) comes in from outside (f32).
//   dK/dV    per KV block, over the query tiles at or after it:
//            dV = P^T dO, dK = dS^T Q (P, dS rounded to bf16), accumulated
//            in registers and written once: no atomics, so the result is
//            deterministic, as in the TPU recipe.
//
// What bounds them. At the Llama training geometry (B 4, L 2048, H 32,
// D 128, causal) the work is ~1.4e11 flops forward and ~3.4e11 needed
// backward against ~0.3 GB of inputs and outputs each way: tensor-core
// operations. The first design fed mma.sync from synchronous loads with
// one tile in flight and re-read every B operand once per warp. Here:
//
// - Every operand tile comes by TMA: a 4-D tensor map over the [B, L, H, D]
//   view with its own strides (dims D, H, L, B), 64-element boxes with
//   128-byte swizzle, two panels across D 128. Rows past L (a ragged L, or
//   L = 1) arrive as zeros and their columns are masked.
// - A CTA is one producer warp and two consumer warpgroups (288 threads).
//   One thread of the producer issues the copies: the tiles its CTA reads
//   once, then a ring of kStages stages guarded by full / empty mbarriers,
//   so the next tile is in flight while the current one is consumed. With
//   a ninth warp, three warps share an SM sub-partition's 16,384
//   registers, so a thread has 168; the tiles are sized to fit them
//   without spilling (setmaxnreg would not raise that bound: ptxas
//   allocates every thread under it whatever setmaxnreg asks).
// - Each consumer warpgroup runs wgmma with f32 accumulators in
//   registers. A score tile's accumulator layout is, pair by pair, the
//   register A operand of the next product, so P and dS go from the
//   softmax into the PV (dS K, P^T dO, dS^T Q) product after one rounding
//   to bf16. In the forward and dQ each warpgroup owns 64 of the CTA's 128
//   query rows; in dK/dV one accumulates dV and the other dK for the same
//   64 keys (below).
// - Under causal, tiles past the diagonal are not loaded, a warpgroup skips
//   a tile none of whose pairs it needs, only tiles on the diagonal or the
//   ragged edge are masked element by element, and the longest blocks are
//   issued first within each head (the block index is the grid's fastest
//   dimension, so that a head's blocks run together and share its K and
//   V, or Q and dO, through L2).
// - Every wait on an mbarrier traps after 10 s: a broken protocol fails
//   the launch instead of hanging.
//
// Each kernel is templated on the head dim; D 64 would add the m64n64k16
// register-A wgmma to hopper.cuh. The softmax runs in base 2 with the
// scale folded into the exponent (exp2f), which the numerics above allow.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kStages = 2;                   // depth of the ring
using Pipe = RingPos<kStages>;               // a position in it
constexpr int kConsumers = 256;              // two warpgroups run wgmma
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kRows = 128;                   // rows a CTA owns
constexpr int kFwdKV = 128;                  // keys a forward stage
constexpr int kFwdHalf = 64;                 // ... taken in two halves
constexpr int kDqKV = 64;                    // keys a dQ tile
constexpr int kDkvQ = 64;                    // queries a dK/dV tile
constexpr int kHeadDim = 128;                // the head dim built here
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

extern __shared__ __align__(1024) unsigned char fa_smem[];

// A [B, L, H, D] output view: element pointer and element strides.
struct View {
  void* ptr;
  long long sb, sl, sh;
};

// bytes of a tile of R rows of head dim D: D / 64 panels of R 128-byte rows
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

constexpr int kAux = 4;  // dK/dV's P ring between the consumer warpgroups

// The 1024-aligned shared memory of a CTA: the tiles read once (kOnce
// bytes), the ring's stages (kStage bytes each), kExtra bytes the consumer
// warpgroups share, then the barriers once, full[s], empty[s] and aux[i].
template <int kOnce, int kStage, int kExtra = 0>
struct Smem {
  unsigned char* p;  // generic address
  uint32_t s;        // the same in the shared window
  static constexpr int kExtraAt = kOnce + kStages * kStage;
  static constexpr int kBars = kExtraAt + kExtra;
  // the barriers and room to align to 1024 bytes (the swizzle's period)
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages + kAux) + 1024;
  __device__ uint32_t once() const { return s; }
  __device__ uint32_t stage(int st) const { return s + kOnce + st * kStage; }
  __device__ unsigned char* stage_ptr(int st) const {
    return p + kOnce + st * kStage;
  }
  __device__ unsigned char* extra() const { return p + kExtraAt; }
  __device__ uint32_t once_bar() const { return s + kBars; }
  __device__ uint32_t full(int st) const { return s + kBars + 8 + 8 * st; }
  __device__ uint32_t empty(int st) const { return full(st) + 8 * kStages; }
  __device__ uint32_t aux(int i) const { return empty(kStages) + 8 * i; }
};

// This CTA's shared memory, its barriers initialised: the once barrier
// completes with the producer's arrival and its bytes, full[s] with
// full_arrivals arrivals of the producer and the stage's bytes, empty[s]
// with every consumer warp's arrival (warp_arrive), aux[i] with the
// arrival of every thread of one consumer warpgroup.
template <typename S>
__device__ __forceinline__ S make_smem(int full_arrivals = 1) {
  const uint32_t raw = smem_u32(fa_smem);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const S sm{fa_smem + pad, raw + pad};
  if (threadIdx.x == 0) {
    mbar_init(sm.once_bar(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.full(st), full_arrivals);
      mbar_init(sm.empty(st), kConsumers / 32);
    }
    for (int i = 0; i < kAux; ++i) mbar_init(sm.aux(i), kConsumers / 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

// One arrival of this warp, once every lane is done with what it guards
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The producer's side of one stage: wait until the consumers released it,
// then announce its bytes; the caller issues the copies onto full.
template <typename S>
__device__ __forceinline__ uint32_t produce(const S& sm, const Pipe& p,
                                            uint32_t bytes) {
  mbar_wait(sm.empty(p.stage), p.phase ^ 1);
  const uint32_t full = sm.full(p.stage);
  mbar_expect_tx(full, bytes);
  return full;
}

// rows r0 .. r0 + R - 1 of head h, batch b: one box per 64-wide panel
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int h,
                                          int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(dst + c * R * 128, map, bar, 64 * c, h, r0, b);
}

// K-major slice kk of the head dim (the reduction of Q K^T, dO V^T and
// their transposes): slices 0-3 in the first panel, 4-7 in the second
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk,
                                           uint32_t panel) {
  return operand_desc<false>(tile + (kk >> 2) * panel, kk & 3, panel);
}

// the four-lane (same g) reductions of a row's statistics
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 16 KS score accumulator, rounded to bf16, as the register A
// operands of the next product: slice kk covers columns 16 kk .. 16 kk + 15.
template <int KS>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4],
                                     const float (&x)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = bf16_pair(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = bf16_pair(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = bf16_pair(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = bf16_pair(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// This thread's two rows of a 64 x D accumulator, divided by div[r], into
// rows row[r] < L of view o (head h, batch b), as bf16 pairs
template <int D>
__device__ __forceinline__ void store_rows(const View& o, int b, int h,
                                           const int (&row)[2], int L,
                                           const float (&acc)[D / 2],
                                           const float (&div)[2]) {
  const int t = threadIdx.x & 3;
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(o.ptr) + b * o.sb +
                        h * o.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= L) continue;
    __nv_bfloat16* dst = base + row[r] * o.sl + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / div[r], acc[4 * j + 2 * r + 1] / div[r]);
  }
}

// -- forward -----------------------------------------------------------------
// A CTA owns 128 query rows: Q loaded once, K and V in stages of 128 keys,
// each taken in two halves of 64 (so that a score tile is 32 registers).
// Per half a warpgroup runs S = Q K^T (A = Q, B = K, both K-major), the
// online softmax in registers (in base 2, the scale folded in), then
// O += P V (A = P from registers, B = V MN-major).
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, View o,
                         float* __restrict__ lse, int L, int H,
                         float scale) {
  using S = Smem<tile_bytes<D>(kRows), 2 * tile_bytes<D>(kFwdKV)>;
  const S sm = make_smem<S>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int blk = static_cast<int>(kCausal ? gridDim.x - 1 - blockIdx.x
                                           : blockIdx.x);
  const int q0 = blk * kRows;
  const int kv_end = kCausal ? min(L, q0 + kRows) : L;
  const int n_tiles = (kv_end + kFwdKV - 1) / kFwdKV;

  // the warpgroup (2: the producer warp), uniform across each warp
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers / 128) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(sm.once_bar(), tile_bytes<D>(kRows));
      load_rows<D, kRows>(sm.once(), &map_q, sm.once_bar(), q0, h, b);
      Pipe p;
      for (int j = 0; j < n_tiles; ++j, p.next()) {
        const uint32_t full = produce(sm, p, 2 * tile_bytes<D>(kFwdKV));
        const uint32_t kt = sm.stage(p.stage);
        load_rows<D, kFwdKV>(kt, &map_k, full, j * kFwdKV, h, b);
        load_rows<D, kFwdKV>(kt + tile_bytes<D>(kFwdKV), &map_v, full,
                             j * kFwdKV, h, b);
      }
    }
  } else {  // a consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * wg;  // this warpgroup's first row
    const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    const uint32_t qa = sm.once() + wg * 64 * 128;  // its rows of Q
    constexpr uint32_t kQPanel = kRows * 128, kKVPanel = kFwdKV * 128;
    const float sl2 = scale * kLog2e;  // logits in base-2 units

    // m is the running row maximum in base-2 units, l the row sum
    float acc[D / 2], s[kFwdHalf / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdHalf / 2; ++i) s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(sm.once_bar(), 0);
    Pipe p;
    for (int j = 0; j < n_tiles; ++j, p.next()) {
      mbar_wait(sm.full(p.stage), p.phase);
#pragma unroll 1
      for (int half = 0; half < kFwdKV / kFwdHalf; ++half) {
        const int k0 = j * kFwdKV + half * kFwdHalf;
        // causal: every key of the half is after all of this warpgroup's
        // rows (the upper half of the diagonal stage for warpgroup 0)
        const bool skip = kCausal && k0 > r0 + 63;
        // a half on the diagonal or the ragged edge is masked
        const bool edge =
            (kCausal && k0 + kFwdHalf - 1 > r0) || k0 + kFwdHalf > L;
        const uint32_t kt = sm.stage(p.stage) + half * kFwdHalf * 128;
        const uint32_t vt = kt + tile_bytes<D>(kFwdKV);
        if (skip) continue;
        fence_operand(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma<0, 0>(s, kmajor(qa, kk, kQPanel), kmajor(kt, kk, kKVPanel),
                      kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(s);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < kFwdHalf / 2; ++i) {
          float x = s[i] * sl2;
          if (edge) {
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool ok = col < L && (!kCausal || col <= row[(i >> 1) & 1]);
            x = ok ? x : kNegInf;
          }
          s[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          alpha[r] = exp2f(m[r] - mx[r]);
        }
#pragma unroll
        for (int i = 0; i < kFwdHalf / 2; ++i) {
          const int r = (i >> 1) & 1;
          float pv = exp2f(s[i] - mx[r]);
          if (edge) {
            // re-masked: a row whose columns are all masked so far has
            // s == m == -1e30 and exp2() == 1
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool ok = col < L && (!kCausal || col <= row[r]);
            pv = ok ? pv : 0.f;
          }
          rs[r] += pv;
          s[i] = pv;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
          m[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[kFwdHalf / 16][4];  // P, rounded to bf16
        to_a(pa, s);
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kFwdHalf / 16; ++kk)
          wgmma<1>(acc, pa[kk], operand_desc<true>(vt, kk, kKVPanel));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
      }
      warp_arrive(sm.empty(p.stage));
    }

    float lm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lm[r] = fmaxf(l[r], 1e-30f);
    store_rows<D>(o, b, h, row, L, acc, lm);
    if (t == 0) {
      float* lp = lse + static_cast<long long>(b * H + h) * L;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < L) lp[row[r]] = m[r] * kLn2 + logf(lm[r]);
    }
  }
}

// -- dQ ---------------------------------------------------------------------
// A CTA owns 128 query rows: Q, dO (and each row's lse and delta) loaded
// once, K and V in tiles of 64 keys. Per tile a warpgroup runs S = Q K^T
// and dP = dO V^T (K and V K-major), dS in registers, then dQ += dS K
// (A = dS from registers, B = K MN-major).
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, View dq, int L,
                            int H, float scale) {
  using S = Smem<2 * tile_bytes<D>(kRows), 2 * tile_bytes<D>(kDqKV)>;
  const S sm = make_smem<S>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int blk = static_cast<int>(kCausal ? gridDim.x - 1 - blockIdx.x
                                           : blockIdx.x);
  const int q0 = blk * kRows;
  const int kv_end = kCausal ? min(L, q0 + kRows) : L;
  const int n_tiles = (kv_end + kDqKV - 1) / kDqKV;

  // the warpgroup (2: the producer warp), uniform across each warp
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers / 128) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(sm.once_bar(), 2 * tile_bytes<D>(kRows));
      load_rows<D, kRows>(sm.once(), &map_q, sm.once_bar(), q0, h, b);
      load_rows<D, kRows>(sm.once() + tile_bytes<D>(kRows), &map_do,
                          sm.once_bar(), q0, h, b);
      Pipe p;
      for (int j = 0; j < n_tiles; ++j, p.next()) {
        const uint32_t full = produce(sm, p, 2 * tile_bytes<D>(kDqKV));
        const uint32_t kt = sm.stage(p.stage);
        load_rows<D, kDqKV>(kt, &map_k, full, j * kDqKV, h, b);
        load_rows<D, kDqKV>(kt + tile_bytes<D>(kDqKV), &map_v, full,
                            j * kDqKV, h, b);
      }
    }
  } else {  // a consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * wg;
    const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    const long long rbase = static_cast<long long>(b * H + h) * L;
    const float sl2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)
    float lse2[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = row[r] < L ? lse[rbase + row[r]] * kLog2e : 0.f;
      dl_r[r] = row[r] < L ? delta[rbase + row[r]] : 0.f;
    }
    const uint32_t qa = sm.once() + wg * 64 * 128;
    const uint32_t oa = qa + tile_bytes<D>(kRows);  // its rows of dO
    constexpr uint32_t kQPanel = kRows * 128, kKVPanel = kDqKV * 128;

    float acc[D / 2], s[kDqKV / 2], dp[kDqKV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDqKV / 2; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(sm.once_bar(), 0);
    Pipe p;
    for (int j = 0; j < n_tiles; ++j, p.next()) {
      const int k0 = j * kDqKV;
      mbar_wait(sm.full(p.stage), p.phase);
      // causal: no key of the tile is at or before any of this
      // warpgroup's rows
      if (!(kCausal && k0 > r0 + 63)) {
        const uint32_t kt = sm.stage(p.stage);
        const uint32_t vt = kt + tile_bytes<D>(kDqKV);
        fence_operand(s);
        fence_operand(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma<0, 0>(s, kmajor(qa, kk, kQPanel), kmajor(kt, kk, kKVPanel),
                      kk > 0);
          wgmma<0, 0>(dp, kmajor(oa, kk, kQPanel), kmajor(vt, kk, kKVPanel),
                      kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(s);
        fence_operand(dp);
        const bool edge = (kCausal && k0 + kDqKV - 1 > r0) || k0 + kDqKV > L;
#pragma unroll
        for (int i = 0; i < kDqKV / 2; ++i) {
          const int r = (i >> 1) & 1;
          float pv = exp2f(s[i] * sl2 - lse2[r]);
          if (edge) {
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool ok = col < L && (!kCausal || col <= row[r]);
            pv = ok ? pv : 0.f;
          }
          s[i] = pv * (dp[i] - dl_r[r]) * scale;  // dS
        }
        uint32_t da[kDqKV / 16][4];  // dS, rounded to bf16
        to_a(da, s);
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqKV / 16; ++kk)
          wgmma<1>(acc, da[kk], operand_desc<true>(kt, kk, kKVPanel));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
      }
      warp_arrive(sm.empty(p.stage));
    }
    const float one[2] = {1.f, 1.f};
    store_rows<D>(dq, b, h, row, L, acc, one);
  }
}

// -- dK / dV ----------------------------------------------------------------
// A CTA owns 64 key rows: K and V loaded once, Q and dO (with their rows'
// lse and delta) in tiles of 64 queries. The warpgroups split the work by
// output, so that each holds one 64 x 128 accumulator (a thread has 168
// registers: with the producer warp, three warps share an SM
// sub-partition's 16,384). Warpgroup 0 computes the transposed scores
// S^T = K Q^T, P^T, and dV += P^T dO; it hands P^T (f32) to warpgroup 1
// through a two-buffer ring in shared memory. Warpgroup 1 computes
// dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale, and dK += dS^T Q.
// Computing the transposes puts P^T and dS^T in registers as A operands (Q
// and dO are K-major for the scores and MN-major for the accumulations):
// no operand is transposed through shared memory. The producer warp's
// lanes copy each tile's lse and delta (two rows a lane) with plain loads
// and arrive on the stage's full barrier after their stores, beside the
// TMA copies: any L, no alignment.
constexpr int kDkvKeys = 64;                 // keys a dK/dV CTA owns
constexpr int kPBuf = kDkvKeys * kDkvQ * 4;  // one P^T tile in f32

// a dK/dV stage: Q, dO, lse and delta, rounded up to 1024 bytes
template <int D>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return (2 * tile_bytes<D>(kDkvQ) + 2 * kDkvQ * 4 + 1023) / 1024 * 1024;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, View dk,
                             View dv, int L, int H, float scale) {
  using S = Smem<2 * tile_bytes<D>(kDkvKeys), dkv_stage_bytes<D>(),
                 2 * kPBuf>;
  constexpr int kStats = 2 * tile_bytes<D>(kDkvQ);  // lse, then delta
  const S sm = make_smem<S>(1 + 32);  // the copies' arrival, every lane's
  const int h = blockIdx.y, b = blockIdx.z;
  // causal: the first key blocks see the most queries and go first
  const int k0 = static_cast<int>(blockIdx.x) * kDkvKeys;
  const int i0 = kCausal ? k0 / kDkvQ : 0;
  const int n_q = (L + kDkvQ - 1) / kDkvQ;

  // the warpgroup (2: the producer warp), uniform across each warp
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers / 128) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(sm.once_bar(), 2 * tile_bytes<D>(kDkvKeys));
      load_rows<D, kDkvKeys>(sm.once(), &map_k, sm.once_bar(), k0, h, b);
      load_rows<D, kDkvKeys>(sm.once() + tile_bytes<D>(kDkvKeys), &map_v,
                             sm.once_bar(), k0, h, b);
    }
    const long long rbase = static_cast<long long>(b * H + h) * L;
    Pipe p;
    for (int i = i0; i < n_q; ++i, p.next()) {
      mbar_wait(sm.empty(p.stage), p.phase ^ 1);
      const uint32_t full = sm.full(p.stage), qt = sm.stage(p.stage);
      if (lane == 0) {
        mbar_expect_tx(full, 2 * tile_bytes<D>(kDkvQ));
        load_rows<D, kDkvQ>(qt, &map_q, full, i * kDkvQ, h, b);
        load_rows<D, kDkvQ>(qt + tile_bytes<D>(kDkvQ), &map_do, full,
                            i * kDkvQ, h, b);
      }
      // rows past L read as zeros (their columns are masked)
      float* stats = reinterpret_cast<float*>(sm.stage_ptr(p.stage) + kStats);
#pragma unroll
      for (int r = lane; r < kDkvQ; r += 32) {
        const int row = i * kDkvQ + r;
        stats[r] = row < L ? lse[rbase + row] : 0.f;
        stats[kDkvQ + r] = row < L ? delta[rbase + row] : 0.f;
      }
      mbar_arrive(full);
    }
  } else {  // warpgroup 0 accumulates dV, warpgroup 1 dK
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int tid = threadIdx.x & 127;
    const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
    // warpgroup 0: S^T from K; warpgroup 1: dP^T from V
    const uint32_t a_rows = sm.once() + wg * tile_bytes<D>(kDkvKeys);
    constexpr uint32_t kKPanel = kDkvKeys * 128, kQPanel = kDkvQ * 128;
    const float sl2 = scale * kLog2e;
    // the P^T ring: buffer n & 1 holds tile n's P^T, float2 pair j of
    // thread tid at index j * 128 + tid; aux[b] completes when warpgroup 0
    // has written buffer b, aux[2 + b] when warpgroup 1 has read it
    float2* pbuf = reinterpret_cast<float2*>(sm.extra());

    float acc[D / 2], x[kDkvQ / 2];  // x: S^T, then P^T (or dP^T, dS^T)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDkvQ / 2; ++i) x[i] = 0.f;

    mbar_wait(sm.once_bar(), 0);
    Pipe p;
    for (int i = i0; i < n_q; ++i, p.next()) {
      const int q0 = i * kDkvQ, n = i - i0, pb = n & 1;
      mbar_wait(sm.full(p.stage), p.phase);
      const uint32_t qt = sm.stage(p.stage);
      const uint32_t ot = qt + tile_bytes<D>(kDkvQ);  // dO
      fence_operand(x);
      wgmma_fence();
#pragma unroll 1
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma<0, 0>(x, kmajor(a_rows, kk, kKPanel),
                    kmajor(wg == 0 ? qt : ot, kk, kQPanel), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(x);
      const float* stats = reinterpret_cast<const float*>(
          sm.stage_ptr(p.stage) + kStats);
      float2* mine = pbuf + pb * (kPBuf / 8) + tid;
      if (wg == 0) {
        const float* sl = stats;  // lse
        // on the diagonal or the ragged edge
        const bool edge =
            (kCausal && q0 < k0 + kDkvKeys - 1) || q0 + kDkvQ > L;
#pragma unroll
        for (int jn = 0; jn < kDkvQ / 8; ++jn) {
          const int c = 8 * jn + 2 * t;  // this thread's query columns
          const float2 lq = *reinterpret_cast<const float2*>(sl + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i4 = 4 * jn + e, cq = q0 + c + (e & 1);
            float pv = exp2f(x[i4] * sl2 - ((e & 1) ? lq.y : lq.x) * kLog2e);
            if (edge) {
              const bool ok = cq < L && (!kCausal || cq >= key[e >> 1]);
              pv = ok ? pv : 0.f;
            }
            x[i4] = pv;  // P^T
          }
        }
        // hand P^T over once warpgroup 1 has read this buffer's last tile
        if (n >= 2) mbar_wait(sm.aux(2 + pb), ((n >> 1) - 1) & 1);
#pragma unroll
        for (int j = 0; j < kDkvQ / 4; ++j)
          mine[j * 128] = make_float2(x[2 * j], x[2 * j + 1]);
        mbar_arrive(sm.aux(pb));
      } else {
        const float* sd = stats + kDkvQ;  // delta
        mbar_wait(sm.aux(pb), (n >> 1) & 1);
#pragma unroll
        for (int j = 0; j < kDkvQ / 4; ++j) {
          const float2 pt = mine[j * 128];
          const int c = 8 * (j >> 1) + 2 * t;  // query column of x[2 j]
          const float2 dl = *reinterpret_cast<const float2*>(sd + c);
          x[2 * j] = pt.x * (x[2 * j] - dl.x) * scale;  // dS^T
          x[2 * j + 1] = pt.y * (x[2 * j + 1] - dl.y) * scale;
        }
        mbar_arrive(sm.aux(2 + pb));
      }
      uint32_t a[kDkvQ / 16][4];  // P^T or dS^T, rounded to bf16
      to_a(a, x);
      // dV += P^T dO, dK += dS^T Q: B MN-major
      const uint32_t bt = wg == 0 ? ot : qt;
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk)
        wgmma<1>(acc, a[kk], operand_desc<true>(bt, kk, kQPanel));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      warp_arrive(sm.empty(p.stage));
    }
    const float one[2] = {1.f, 1.f};
    View out = dv;
    if (wg == 1) out = dk;
    store_rows<D>(out, b, h, key, L, acc, one);
  }
}

// -- launch ------------------------------------------------------------------

// The tensor map of a bf16 [B, L, H, D] view (element strides sb, sl, sh;
// D contiguous): dims D, H, L, B innermost first, boxes of 64 x 1 x rows x 1.
bool bhld_map(CUtensorMap* map, const void* base, const long long* st, int B,
              int L, int H, int rows) {
  const long long dims[4] = {kHeadDim, H, L, B};
  const long long bytes[3] = {st[2] * 2, st[1] * 2, st[0] * 2};
  const int box[4] = {64, 1, rows, 1};
  return encode_tiled(map, 4, base, dims, bytes, box);
}

View view(void* p, const long long* st) { return View{p, st[0], st[1], st[2]}; }

// What these kernels take, as takes_tma decides it: head dim 128, every
// size positive and inside the grid's and the tensor maps' int32 ranges,
// 16-byte aligned bases and (batch, seq, head) strides multiples of 8
// elements. n views, three strides each.
bool takes(void* const* ptrs, int n, const long long* strides, int B, int L,
           int H, int D) {
  if (D != kHeadDim || B <= 0 || L <= 0 || H <= 0 || B > 65535 ||
      H > 65535 || static_cast<long long>(B) * H * L > 0x7fffffffLL)
    return false;
  for (int i = 0; i < n; ++i) {
    if (!aligned16(ptrs[i])) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] % 8) return false;
  }
  return true;
}

// grid (row blocks of `rows`, H, B): the blocks of one head run together
// and share its K and V (Q and dO) through L2
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, int rows, int L, int H, int B,
           cudaStream_t stream, Args... args) {
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((L + rows - 1) / rows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes; the arguments of the first
// design's entries (flash_attention.cuh) without dtype, segments and
// dropout. Tensors are bf16 [B, L, H, D] views with D = 128 contiguous
// and their own element strides (batch, seq, head) in `strides`, three per
// view in argument order; lse and delta are contiguous f32 [B, H, L]. The
// caller allocates the outputs. Each returns 0, the cudaError_t of the
// launch, cudaErrorInvalidValue for a call takes_tma would refuse, or -1
// when cuTensorMapEncodeTiled refuses a map.
extern "C" int flash_attention_tma_forward(void* q, void* k, void* v,
                                           void* out, float* lse,
                                           const long long* strides, int B,
                                           int L, int H, int D, int causal,
                                           float scale, void* stream) {
  void* ptrs[4] = {q, k, v, out};
  if (!takes(ptrs, 4, strides, B, L, H, D))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!bhld_map(&mq, q, strides, B, L, H, kRows) ||
      !bhld_map(&mk, k, strides + 3, B, L, H, kFwdKV) ||
      !bhld_map(&mv, v, strides + 6, B, L, H, kFwdKV))
    return kEncodeFailed;
  const View o = view(out, strides + 9);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kD = kHeadDim;
  using S = Smem<tile_bytes<kD>(kRows), 2 * tile_bytes<kD>(kFwdKV)>;
  auto kernel = causal ? flash_fwd_tma_kernel<kD, true>
                       : flash_fwd_tma_kernel<kD, false>;
  return launch(kernel, S::kBytes, kRows, L, H, B, s, mq, mk, mv, o, lse, L,
                H, scale);
}

extern "C" int flash_attention_tma_backward_dq(
    void* q, void* k, void* v, void* dout, const float* lse,
    const float* delta, void* dq, const long long* strides, int B, int L,
    int H, int D, int causal, float scale, void* stream) {
  void* ptrs[5] = {q, k, v, dout, dq};
  if (!takes(ptrs, 5, strides, B, L, H, D))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mo;
  if (!bhld_map(&mq, q, strides, B, L, H, kRows) ||
      !bhld_map(&mk, k, strides + 3, B, L, H, kDqKV) ||
      !bhld_map(&mv, v, strides + 6, B, L, H, kDqKV) ||
      !bhld_map(&mo, dout, strides + 9, B, L, H, kRows))
    return kEncodeFailed;
  const View o = view(dq, strides + 12);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kD = kHeadDim;
  using S = Smem<2 * tile_bytes<kD>(kRows), 2 * tile_bytes<kD>(kDqKV)>;
  auto kernel = causal ? flash_bwd_dq_tma_kernel<kD, true>
                       : flash_bwd_dq_tma_kernel<kD, false>;
  return launch(kernel, S::kBytes, kRows, L, H, B, s, mq, mk, mv, mo, lse,
                delta, o, L, H, scale);
}

extern "C" int flash_attention_tma_backward_dkv(
    void* q, void* k, void* v, void* dout, const float* lse,
    const float* delta, void* dk, void* dv, const long long* strides, int B,
    int L, int H, int D, int causal, float scale, void* stream) {
  void* ptrs[6] = {q, k, v, dout, dk, dv};
  if (!takes(ptrs, 6, strides, B, L, H, D))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mo;
  if (!bhld_map(&mq, q, strides, B, L, H, kDkvQ) ||
      !bhld_map(&mk, k, strides + 3, B, L, H, kDkvKeys) ||
      !bhld_map(&mv, v, strides + 6, B, L, H, kDkvKeys) ||
      !bhld_map(&mo, dout, strides + 9, B, L, H, kDkvQ))
    return kEncodeFailed;
  const View vk = view(dk, strides + 12), vv = view(dv, strides + 15);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kD = kHeadDim;
  using S = Smem<2 * tile_bytes<kD>(kDkvKeys), dkv_stage_bytes<kD>(),
                 2 * kPBuf>;
  auto kernel = causal ? flash_bwd_dkv_tma_kernel<kD, true>
                       : flash_bwd_dkv_tma_kernel<kD, false>;
  return launch(kernel, S::kBytes, kDkvKeys, L, H, B, s, mq, mk, mv, mo, lse,
                delta, vk, vv, L, H, scale);
}
