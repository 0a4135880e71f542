// Flash attention for Hopper (sm_90a), the TMA / wgmma design: the forward,
// dQ and dK/dV kernels for bf16 at head dim 64 or 128, causal or not, with
// segment (varlen) masking or without; at head dim 64 also with attention
// dropout, without segments (the Llama training attention at D 128;
// BERT's and ERNIE-MoE's at D 64; the varlen entry's packed sequences).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// that _flash_fwd_pallas_blhd / _flash_fwd_pallas / _flash_fwd_pallas_seg
// (_fwd_kernel) and _flash_bwd_pallas_blhd / _flash_bwd_pallas /
// _flash_bwd_pallas_seg (_bwd_dq_kernel, _bwd_dkv_kernel) launch, with the
// dropout keep mask _keep_mask regenerates inside them (K5) and their
// segment mask (K4). The plain PyTorch versions beside the wrappers
// (ops/kernels/flash_attention.py) are the oracles;
// ops/kernels/flash_attention.py's takes_tma picks this design before a
// launch, and every other call (f32, dropout at D 128, dropout with
// segments, rows a tensor map cannot describe) takes the first design in
// flash_attention.cuh. The numerics are that design's:
//
//   forward  S = scale * Q K^T (masked: causal, other segments and the
//            ragged tail -> -1e30), online softmax over KV tiles in f32 on
//            the undropped P, O += (keep o P) V with keep o P rounded to
//            bf16; out = acc / (1 - p) / max(l, 1e-30) in bf16 and
//            lse = m + log(max(l, 1e-30)) in f32 [B, H, L].
//   dQ       P = exp(scale * Q K^T - lse) (re-masked), dP = dO V^T,
//            dP <- keep o dP / (1 - p), dS = P * (dP - delta) * scale,
//            dQ = dS K with dS rounded to bf16; delta = rowsum(dO * O)
//            comes in from outside (f32).
//   dK/dV    per KV block, over the query tiles at or after it:
//            dV = (keep o P / (1 - p))^T dO, dK = dS^T Q (both rounded to
//            bf16), accumulated in registers and written once: no atomics,
//            so the result is deterministic, as in the TPU recipe.
//
// Keys may outnumber or trail the queries (Lk != L: cross-attention, a KV
// cache step, a chunk against its history): K and V maps, the KV loop and
// the dK/dV grid run over Lk, and the causal diagonal is j = i + Lk - L, as
// in the first design (a row with no allowed key keeps zeros).
//
// Without dropout keep is all ones and the division by 1 - p is skipped
// (its own instance). The keep mask is philox.cuh's, the first design's
// bits: Philox4x32-10 on (col >> 2, row, b * H + h, 0) over absolute rows
// and columns, whatever the tiles. With segments a pair (i, j) is allowed
// iff seg[i] == seg[j] (and j <= i when causal); the segment instances are
// their own, so the others carry none of it (the Segments section below).
//
// What bounds them. At the Llama training geometry (B 4, L 2048, H 32,
// D 128, causal) the work is ~1.4e11 flops forward and ~3.4e11 needed
// backward against ~0.3 GB of inputs and outputs each way: tensor-core
// operations. At BERT's (B 24, L 512, H 12, D 64) the forward's 1.9e10
// flops take less time at the peak than its 76 MB of bytes, and with
// dropout a Philox call (ten rounds of two 32-bit multiply-wides) for
// every four pairs, 1.9e7 calls a kernel, is integer work of the same
// order as the products. The first design fed mma.sync from synchronous
// loads with one tile in flight and re-read every B operand once per
// warp. Here:
//
// - Every operand tile comes by TMA: a 4-D tensor map over the [B, L, H, D]
//   view with its own strides (dims D, H, L, B), 64-element boxes with
//   128-byte swizzle, D / 64 panels across the head dim. Rows past L (a
//   ragged L, or L = 1) arrive as zeros and their columns are masked.
// - At D 128 a CTA is one producer warp and two consumer warpgroups (288
//   threads). One thread of the producer issues the copies: the tiles its
//   CTA reads once, then a ring of kStages stages guarded by full / empty
//   mbarriers, so the next tile is in flight while the current one is
//   consumed. With a ninth warp, three warps share an SM sub-partition's
//   16,384 registers, so a thread has 168; the tiles are sized to fit them
//   without spilling (setmaxnreg would not raise that bound: ptxas
//   allocates every thread under it whatever setmaxnreg asks).
// - At D 64 a CTA is the two consumer warpgroups alone (256 threads): the
//   warp that releases a stage last refills it, and a thread may hold 128
//   registers with two CTAs an SM, which all three kernels fit (the D-64
//   section below says why).
// - Each consumer warpgroup runs wgmma with f32 accumulators in
//   registers. A score tile's accumulator layout is, pair by pair, the
//   register A operand of the next product, so P and dS go from the
//   softmax into the PV (dS K, P^T dO, dS^T Q) product after one rounding
//   to bf16. In the forward and dQ each warpgroup owns 64 of the CTA's 128
//   query rows. In dK/dV at D 128 one warpgroup accumulates dV and the
//   other dK for the same 64 keys; at D 64 both accumulators fit one
//   warpgroup, which owns 64 of the CTA's 128 keys (below).
// - The keep bits of a tile depend on the pair alone, not on S, so each
//   warpgroup draws them where they cost least: in the forward before the
//   score product (the score tile is not yet live, so both fit 128
//   registers), in dQ between issuing the score products and waiting for
//   them, in dK/dV under the previous tile's dV and dK products. They are
//   used where P (or dP) leaves the accumulator.
// - Under causal, tiles past the diagonal are not loaded, a warpgroup skips
//   a tile none of whose pairs it needs, only tiles on the diagonal or the
//   ragged edge are masked element by element, and the longest blocks are
//   issued first: at D 128 within each head (the block index is the
//   grid's fastest dimension, so that a head's blocks run together and
//   share its K and V, or Q and dO, through L2), at D 64 across the whole
//   grid (block_of).
// - With segments a CTA walks only its window of tiles (the Segments
//   section below), not the whole sequence.
// - Every wait on an mbarrier traps after 10 s: a broken protocol fails
//   the launch instead of hanging.
//
// The softmax runs in base 2 with the scale folded into the exponent
// (exp2f; at D 64 the MUFU's ex2.approx with the scale in one FMA), which
// the numerics above allow.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

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

// The dropout of a launch: where the Philox key lies in device memory
// (philox.cuh's load_key), the keep threshold (a pair is kept iff its
// word >= thresh) and 1 / (1 - p). The instances without dropout never
// read it.
struct Drop {
  const long long* key;
  uint32_t thresh;
  float inv_keep;
};

// bytes of a tile of R rows of head dim D: D / 64 panels of R 128-byte rows
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// -- Segments (K4) ----------------------------------------------------------
// A pair (i, j) is allowed iff seg[i] == seg[j]. The TPU kernels (and this
// port's first design) walk every tile of the sequence and skip those of
// other segments one by one: at the varlen geometry (12,288 packed tokens,
// sequences of 32-512) a CTA walks 96-384 tiles to find ~8 with work. Here
// each CTA walks a window: win [B, blocks, 2] holds, for its block of rows,
// the first tile of the other operand and one past the last whose 32-row
// chunk id ranges (rng [B, ceil(L / 32), 2], min and max id of each chunk)
// overlap the block's, built by the wrapper on the device (exact for sorted
// ids, a superset otherwise; causal clips it at the diagonal). Inside the
// window:
// - each ring stage carries its rows' ids and chunk ranges beside the
//   tiles, copied by cp.async (a lane a row, any L, no alignment) and
//   completing on the stage's full barrier, so the mask reads no global
//   memory; each thread keeps its own two rows' ids in registers;
// - a warpgroup skips the products of a tile whose id range is disjoint
//   from its rows' (as it skips a tile past the causal diagonal);
// - a tile is masked element by element unless its ids and the
//   warpgroup's rows' are all one and the same id. So every tile that
//   holds a disallowed pair is masked, and a row that meets whole tiles
//   of another segment before its own keys has them re-masked to exactly
//   0 after the exponential (s == m there, and 2^0 == 1 would leak into
//   l).
// The segment instances are their own (kSeg), without dropout: no public
// entry combines the two.
constexpr int kChunk = 32;  // rows of one rng entry

// The segments of a launch: ids [B, L] with batch stride sb, their chunk
// ranges and the CTAs' windows. Instances without segments never read it.
struct Seg {
  const int* ids;
  long long sb;
  const int* rng;
  const int* win;
};

// bytes of a stage's ids: N rows' ids, then the (min, max) of their N / 32
// chunks, rounded up to 16 bytes
template <int N>
__host__ __device__ constexpr int ids_bytes() {
  return (4 * N + 8 * (N / kChunk) + 15) / 16 * 16;
}

// 4 bytes from global to shared memory by cp.async, zeros when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on bar of this lane once its earlier cp.asyncs completed (the
// barrier counts it among its expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// The ids of rows r0 .. r0 + N - 1 and the ranges of their chunks into dst
// (every lane of one warp): rows past L read as id 0 (the ragged edge masks
// them), chunks past L as the last chunk's range.
template <int N>
__device__ __forceinline__ void fill_ids(uint32_t dst, const Seg& sg, int b,
                                         int r0, int L) {
  const int lane = threadIdx.x & 31;
  const int* ids = sg.ids + b * sg.sb;
#pragma unroll
  for (int r = lane; r < N; r += 32)
    cp_async4(dst + 4 * r, ids + min(r0 + r, L - 1), r0 + r < L);
  if (lane < 2 * (N / kChunk)) {
    const int n32 = (L + kChunk - 1) / kChunk;
    const int c = min(r0 / kChunk + lane / 2, n32 - 1);
    cp_async4(dst + 4 * N + 4 * lane,
              sg.rng + 2LL * (b * n32 + c) + (lane & 1), true);
  }
}

// The id range (min, max) of rows r0 .. r0 + 32 N - 1 from rng; empty
// (min > max) when r0 is past L
template <int N>
__device__ __forceinline__ int2 rows_range(const Seg& sg, int b, int r0,
                                           int L) {
  const int n32 = (L + kChunk - 1) / kChunk;
  const int* r = sg.rng + 2LL * b * n32;
  int2 out = make_int2(0x7fffffff, -0x7fffffff - 1);
#pragma unroll
  for (int c = r0 / kChunk; c < r0 / kChunk + N; ++c)
    if (c < n32) {
      out.x = min(out.x, r[2 * c]);
      out.y = max(out.y, r[2 * c + 1]);
    }
  return out;
}

// The id range of a stage's rows from its chunk ranges (N / 32 of them,
// after the N ids), read from shared memory
template <int N>
__device__ __forceinline__ int2 stage_range(const int* ids) {
  int2 out = *reinterpret_cast<const int2*>(ids + N);
#pragma unroll
  for (int c = 1; c < N / kChunk; ++c) {
    const int2 x = *reinterpret_cast<const int2*>(ids + N + 2 * c);
    out = make_int2(min(out.x, x.x), max(out.y, x.y));
  }
  return out;
}

// Whether a stage of range t needs no element mask for a warpgroup of
// range w: every id of both is one and the same
__device__ __forceinline__ bool one_segment(int2 t, int2 w) {
  return t.x == t.y && w.x == w.y && t.x == w.x;
}

// Whether the two ranges share no id: the warpgroup skips the tile
__device__ __forceinline__ bool disjoint(int2 t, int2 w) {
  return t.y < w.x || t.x > w.y;
}

// The pairs of an N-column stage whose ids equal their row's (sr): bit i
// for accumulator element i (column 8 (i >> 2) + 2 t + (i & 1) of the
// stage, row (i >> 1) & 1), the layout of mask_bits and mask_bits_keys
template <int N>
__device__ __forceinline__ uint32_t seg_bits(const int* ids,
                                             const int (&sr)[2]) {
  const int t = threadIdx.x & 3;
  uint32_t ok = 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int2 c = *reinterpret_cast<const int2*>(ids + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ok |= static_cast<uint32_t>(((e & 1) ? c.y : c.x) == sr[e >> 1])
            << (4 * j + e);
  }
  return ok;
}

// This CTA's window [first, end) of tiles from win, clipped to [0, n)
__device__ __forceinline__ int2 seg_window(const Seg& sg, int b, int blk,
                                           int n) {
  const int* w = sg.win + 2LL * (b * static_cast<int>(gridDim.x) + blk);
  return make_int2(max(w[0], 0), min(w[1], n));
}

// Thread's rows' ids: row[r] < L ? ids[row[r]] : anything (never stored)
__device__ __forceinline__ void row_ids(int (&sr)[2], const Seg& sg, int b,
                                        const int (&row)[2], int L) {
  const int* ids = sg.ids + b * sg.sb;
#pragma unroll
  for (int r = 0; r < 2; ++r) sr[r] = ids[min(row[r], L - 1)];
}

constexpr int kAux = 4;  // dK/dV's P ring between the consumer warpgroups

// The 1024-aligned shared memory of a CTA: the tiles read once (kOnce
// bytes), the ring's stages (kStage bytes each), kExtra bytes the consumer
// warpgroups share, each stage's segment ids (kIds bytes each, none
// without segments), then the barriers once, full[s], empty[s] and aux[i].
template <int kOnce, int kStage, int kExtra = 0, int kIds = 0>
struct Smem {
  unsigned char* p;  // generic address
  uint32_t s;        // the same in the shared window
  static constexpr int kExtraAt = kOnce + kStages * kStage;
  static constexpr int kIdsAt = kExtraAt + kExtra;
  static constexpr int kBars = kIdsAt + kStages * kIds;
  // the barriers and room to align to 1024 bytes (the swizzle's period)
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages + kAux) + 1024;
  __device__ uint32_t once() const { return s; }
  __device__ uint32_t stage(int st) const { return s + kOnce + st * kStage; }
  __device__ unsigned char* stage_ptr(int st) const {
    return p + kOnce + st * kStage;
  }
  __device__ unsigned char* extra() const { return p + kExtraAt; }
  __device__ uint32_t ids(int st) const { return s + kIdsAt + st * kIds; }
  __device__ int* ids_ptr(int st) const {
    return reinterpret_cast<int*>(p + kIdsAt + st * kIds);
  }
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

// -- head dim 128: forward ----------------------------------------------------
// A CTA owns 128 query rows: Q loaded once, K and V in stages of 128 keys,
// each taken in two halves of 64 (so that a score tile is 32 registers).
// Per half a warpgroup runs S = Q K^T (A = Q, B = K, both K-major), the
// online softmax in registers (in base 2, the scale folded in), then
// O += P V (A = P from registers, B = V MN-major). With segments the
// producer warp walks the CTA's window, all its lanes copying each stage's
// ids beside the TMA copies.
template <int D, bool kSeg>
using FwdSmem = Smem<tile_bytes<D>(kRows), 2 * tile_bytes<D>(kFwdKV), 0,
                     kSeg ? ids_bytes<kFwdKV>() : 0>;

template <int D, bool kCausal, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, View o,
                         float* __restrict__ lse, int L, int Lk, int H,
                         float scale, Seg sg) {
  using S = FwdSmem<D, kSeg>;
  // full[s]: the copies' arrival (and with segments every producer lane's)
  const S sm = make_smem<S>(kSeg ? 1 + 32 : 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const int blk = static_cast<int>(kCausal ? gridDim.x - 1 - blockIdx.x
                                           : blockIdx.x);
  const int q0 = blk * kRows;
  const int off = Lk - L;  // causal: row i sees the keys j <= i + off
  const int kv_end = kCausal ? max(0, min(Lk, q0 + kRows + off)) : Lk;
  int2 win = make_int2(0, (kv_end + kFwdKV - 1) / kFwdKV);
  if constexpr (kSeg) win = seg_window(sg, b, blk, win.y);

  // the warpgroup (2: the producer warp), uniform across each warp
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers / 128) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (kSeg || lane == 0) {
      if (lane == 0) {
        mbar_expect_tx(sm.once_bar(), tile_bytes<D>(kRows));
        load_rows<D, kRows>(sm.once(), &map_q, sm.once_bar(), q0, h, b);
      }
      Pipe p;
      for (int j = win.x; j < win.y; ++j, p.next()) {
        mbar_wait(sm.empty(p.stage), p.phase ^ 1);
        const uint32_t full = sm.full(p.stage), kt = sm.stage(p.stage);
        if (lane == 0) {
          mbar_expect_tx(full, 2 * tile_bytes<D>(kFwdKV));
          load_rows<D, kFwdKV>(kt, &map_k, full, j * kFwdKV, h, b);
          load_rows<D, kFwdKV>(kt + tile_bytes<D>(kFwdKV), &map_v, full,
                               j * kFwdKV, h, b);
        }
        if constexpr (kSeg) {
          fill_ids<kFwdKV>(sm.ids(p.stage), sg, b, j * kFwdKV, L);
          cp_async_arrive(full);
        }
      }
    }
  } else {  // a consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * wg;  // this warpgroup's first row
    const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    // causal: the last key of its first row and of each of its rows,
    // shifted once here so that the tile loop does what it does at Lk = L
    const int d0 = r0 + off, diag[2] = {row[0] + off, row[1] + off};
    const uint32_t qa = sm.once() + wg * 64 * 128;  // its rows of Q
    constexpr uint32_t kQPanel = kRows * 128, kKVPanel = kFwdKV * 128;
    const float sl2 = scale * kLog2e;  // logits in base-2 units
    // its rows' ids and their range
    int sr[2] = {0, 0};
    int2 wr = make_int2(0, 0);
    if constexpr (kSeg) {
      row_ids(sr, sg, b, row, L);
      wr = rows_range<2>(sg, b, r0, L);
    }

    // m is the running row maximum in base-2 units, l the row sum
    float acc[D / 2], s[kFwdHalf / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdHalf / 2; ++i) s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(sm.once_bar(), 0);
    Pipe p;
    for (int j = win.x; j < win.y; ++j, p.next()) {
      mbar_wait(sm.full(p.stage), p.phase);
#pragma unroll 1
      for (int half = 0; half < kFwdKV / kFwdHalf; ++half) {
        const int k0 = j * kFwdKV + half * kFwdHalf;
        // causal: every key of the half is after all of this warpgroup's
        // rows (the upper half of the diagonal stage for warpgroup 0)
        bool skip = kCausal && k0 > d0 + 63;
        // a half on the diagonal or the ragged edge is masked
        bool edge = (kCausal && k0 + kFwdHalf - 1 > d0) || k0 + kFwdHalf > Lk;
        // the half's ids; a half of other segments only is skipped, one
        // not all of this warpgroup's segment is masked
        const int* hid = nullptr;
        if constexpr (kSeg) {
          hid = sm.ids_ptr(p.stage) + half * kFwdHalf;
          const int2 c = *reinterpret_cast<const int2*>(
              sm.ids_ptr(p.stage) + kFwdKV + 4 * half);
          const int2 c1 = *reinterpret_cast<const int2*>(
              sm.ids_ptr(p.stage) + kFwdKV + 4 * half + 2);
          const int2 hr = make_int2(min(c.x, c1.x), max(c.y, c1.y));
          skip = skip || disjoint(hr, wr);
          edge = edge || !one_segment(hr, wr);
        }
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
        uint32_t sok = kFull;  // the pairs of this segment (bit i)
        if constexpr (kSeg)
          if (edge) sok = seg_bits<kFwdHalf>(hid, sr);
#pragma unroll
        for (int i = 0; i < kFwdHalf / 2; ++i) {
          float x = s[i] * sl2;
          if (edge) {
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool ok = col < Lk &&
                            (!kCausal || col <= diag[(i >> 1) & 1]) &&
                            ((sok >> i) & 1u);
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
            const bool ok = col < Lk && (!kCausal || col <= diag[r]) &&
                            ((sok >> i) & 1u);
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
      // a row with no allowed key (causal, i < L - Lk) keeps -1e30
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < L)
          lp[row[r]] = l[r] > 0.f ? m[r] * kLn2 + logf(lm[r]) : kNegInf;
    }
  }
}

// -- head dim 128: dQ ---------------------------------------------------------
// A CTA owns 128 query rows: Q, dO (and each row's lse and delta) loaded
// once, K and V in tiles of 64 keys. Per tile a warpgroup runs S = Q K^T
// and dP = dO V^T (K and V K-major), dS in registers, then dQ += dS K
// (A = dS from registers, B = K MN-major). With segments as the forward.
template <int D, bool kSeg>
using DqSmem = Smem<2 * tile_bytes<D>(kRows), 2 * tile_bytes<D>(kDqKV), 0,
                    kSeg ? ids_bytes<kDqKV>() : 0>;

template <int D, bool kCausal, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, View dq, int L,
                            int Lk, int H, float scale, Seg sg) {
  using S = DqSmem<D, kSeg>;
  const S sm = make_smem<S>(kSeg ? 1 + 32 : 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const int blk = static_cast<int>(kCausal ? gridDim.x - 1 - blockIdx.x
                                           : blockIdx.x);
  const int q0 = blk * kRows;
  const int off = Lk - L;  // causal: row i sees the keys j <= i + off
  const int kv_end = kCausal ? max(0, min(Lk, q0 + kRows + off)) : Lk;
  int2 win = make_int2(0, (kv_end + kDqKV - 1) / kDqKV);
  if constexpr (kSeg) win = seg_window(sg, b, blk, win.y);

  // the warpgroup (2: the producer warp), uniform across each warp
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers / 128) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (kSeg || lane == 0) {
      if (lane == 0) {
        mbar_expect_tx(sm.once_bar(), 2 * tile_bytes<D>(kRows));
        load_rows<D, kRows>(sm.once(), &map_q, sm.once_bar(), q0, h, b);
        load_rows<D, kRows>(sm.once() + tile_bytes<D>(kRows), &map_do,
                            sm.once_bar(), q0, h, b);
      }
      Pipe p;
      for (int j = win.x; j < win.y; ++j, p.next()) {
        mbar_wait(sm.empty(p.stage), p.phase ^ 1);
        const uint32_t full = sm.full(p.stage), kt = sm.stage(p.stage);
        if (lane == 0) {
          mbar_expect_tx(full, 2 * tile_bytes<D>(kDqKV));
          load_rows<D, kDqKV>(kt, &map_k, full, j * kDqKV, h, b);
          load_rows<D, kDqKV>(kt + tile_bytes<D>(kDqKV), &map_v, full,
                              j * kDqKV, h, b);
        }
        if constexpr (kSeg) {
          fill_ids<kDqKV>(sm.ids(p.stage), sg, b, j * kDqKV, L);
          cp_async_arrive(full);
        }
      }
    }
  } else {  // a consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * wg;
    const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    // causal: the last keys, shifted once (the forward's d0, diag)
    const int d0 = r0 + off, diag[2] = {row[0] + off, row[1] + off};
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
    int sr[2] = {0, 0};  // its rows' ids and their range
    int2 wr = make_int2(0, 0);
    if constexpr (kSeg) {
      row_ids(sr, sg, b, row, L);
      wr = rows_range<2>(sg, b, r0, L);
    }

    float acc[D / 2], s[kDqKV / 2], dp[kDqKV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kDqKV / 2; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(sm.once_bar(), 0);
    Pipe p;
    for (int j = win.x; j < win.y; ++j, p.next()) {
      const int k0 = j * kDqKV;
      mbar_wait(sm.full(p.stage), p.phase);
      // causal: no key of the tile is at or before any of this
      // warpgroup's rows; segments: none is of its rows' segments
      bool skip = kCausal && k0 > d0 + 63, seg_edge = false;
      if constexpr (kSeg) {
        const int2 tr = stage_range<kDqKV>(sm.ids_ptr(p.stage));
        skip = skip || disjoint(tr, wr);
        seg_edge = !one_segment(tr, wr);
      }
      if (!skip) {
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
        const bool edge = seg_edge || (kCausal && k0 + kDqKV - 1 > d0) ||
                          k0 + kDqKV > Lk;
        uint32_t sok = kFull;  // the pairs of this segment (bit i)
        if constexpr (kSeg)
          if (edge) sok = seg_bits<kDqKV>(sm.ids_ptr(p.stage), sr);
#pragma unroll
        for (int i = 0; i < kDqKV / 2; ++i) {
          const int r = (i >> 1) & 1;
          float pv = exp2f(s[i] * sl2 - lse2[r]);
          if (edge) {
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool ok = col < Lk && (!kCausal || col <= diag[r]) &&
                            ((sok >> i) & 1u);
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

// -- head dim 128: dK / dV ----------------------------------------------------
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
// TMA copies: any L, no alignment; with segments the tile's ids too. Both
// warpgroups own the same 64 keys, so a tile in the window holds work for
// both and none is skipped (warpgroup 0 masks P^T).
constexpr int kDkvKeys = 64;                 // keys a dK/dV CTA owns
constexpr int kPBuf = kDkvKeys * kDkvQ * 4;  // one P^T tile in f32

// a dK/dV stage: Q, dO, lse and delta, rounded up to 1024 bytes
template <int D>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return (2 * tile_bytes<D>(kDkvQ) + 2 * kDkvQ * 4 + 1023) / 1024 * 1024;
}

template <int D, bool kSeg>
using DkvSmem = Smem<2 * tile_bytes<D>(kDkvKeys), dkv_stage_bytes<D>(),
                     2 * kPBuf, kSeg ? ids_bytes<kDkvQ>() : 0>;

template <int D, bool kCausal, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, View dk,
                             View dv, int L, int Lk, int H, float scale,
                             Seg sg) {
  using S = DkvSmem<D, kSeg>;
  constexpr int kStats = 2 * tile_bytes<D>(kDkvQ);  // lse, then delta
  const S sm = make_smem<S>(1 + 32);  // the copies' arrival, every lane's
  const int h = blockIdx.y, b = blockIdx.z;
  // causal: the first key blocks see the most queries and go first
  const int k0 = static_cast<int>(blockIdx.x) * kDkvKeys;
  const int n_q = (L + kDkvQ - 1) / kDkvQ;
  // causal: key j is seen by the queries i >= j - off
  const int off = Lk - L;
  int2 win = make_int2(kCausal ? max(k0 - off, 0) / kDkvQ : 0, n_q);
  if constexpr (kSeg) {
    const int2 w = seg_window(sg, b, blockIdx.x, n_q);
    win = make_int2(max(win.x, w.x), w.y);
  }
  const int i0 = win.x;

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
    for (int i = i0; i < win.y; ++i, p.next()) {
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
      if constexpr (kSeg) {  // the ids and chunk ranges, as fill_ids
        int* ids = sm.ids_ptr(p.stage);
        const int* src = sg.ids + b * sg.sb;
#pragma unroll
        for (int r = lane; r < kDkvQ; r += 32) {
          const int row = i * kDkvQ + r;
          ids[r] = row < L ? src[row] : 0;
        }
        if (lane < 2 * (kDkvQ / kChunk)) {
          const int n32 = (L + kChunk - 1) / kChunk;
          const int c = min(i * kDkvQ / kChunk + lane / 2, n32 - 1);
          ids[kDkvQ + lane] = sg.rng[2LL * (b * n32 + c) + (lane & 1)];
        }
      }
      mbar_arrive(full);
    }
  } else {  // warpgroup 0 accumulates dV, warpgroup 1 dK
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int tid = threadIdx.x & 127;
    const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
    // causal: the first query of the block's last key and of each of this
    // thread's keys, shifted once (the tile loop is as at Lk = L)
    const int e0 = k0 + kDkvKeys - 1 - off;
    const int first_q[2] = {key[0] - off, key[1] - off};
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
    int sk[2] = {0, 0};  // the keys' ids and the CTA's range
    int2 wr = make_int2(0, 0);
    if constexpr (kSeg) {
      if (wg == 0) row_ids(sk, sg, b, key, L);
      wr = rows_range<2>(sg, b, k0, L);
    }

    mbar_wait(sm.once_bar(), 0);
    Pipe p;
    for (int i = i0; i < win.y; ++i, p.next()) {
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
        // on the diagonal or the ragged edge, or not one segment
        bool edge = (kCausal && q0 < e0) || q0 + kDkvQ > L;
        uint32_t sok = kFull;  // the pairs of this segment (bit i4)
        if constexpr (kSeg) {
          const int* ids = sm.ids_ptr(p.stage);
          edge = edge || !one_segment(stage_range<kDkvQ>(ids), wr);
          if (edge) sok = seg_bits<kDkvQ>(ids, sk);
        }
#pragma unroll
        for (int jn = 0; jn < kDkvQ / 8; ++jn) {
          const int c = 8 * jn + 2 * t;  // this thread's query columns
          const float2 lq = *reinterpret_cast<const float2*>(sl + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i4 = 4 * jn + e, cq = q0 + c + (e & 1);
            float pv = exp2f(x[i4] * sl2 - ((e & 1) ? lq.y : lq.x) * kLog2e);
            if (edge) {
              const bool ok = cq < L && (!kCausal || cq >= first_q[e >> 1]) &&
                              ((sok >> i4) & 1u);
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
    store_rows<D>(out, b, h, key, Lk, acc, one);
  }
}

// -- head dim 64 --------------------------------------------------------------
// At D 64 a tile is one 64-wide panel and every accumulator half the size
// of D 128's, and per pair the exponential (MUFU), the softmax's float
// work and, with dropout, the Philox draw cost about as much as the
// products. What bounds these kernels is the chain of dependent work a
// warpgroup does per tile (wait for the scores, the softmax, the keep
// bits, the next product), which only more warps in flight hide: one
// 288-thread CTA an SM leaves eight. So the D-64 kernels have no producer
// warp. A CTA is the two consumer warpgroups alone (256 threads); thread 0
// (warp 0 in dK/dV) issues the first copies, and the warp that releases a
// stage last (a count per stage in shared memory) refills it, so no warp
// waits on another. The forward and dQ take 64-key stages, dK/dV 32-query
// ones; all three fit 128 registers a thread, dropout included, and run
// two CTAs an SM (four warpgroups). The ring is four stages deep; dK/dV's
// lse and delta come by cp.async beside the TMA copies, so a refill never
// stalls its warp. Tiles on the
// diagonal or the ragged edge mask element by element in loops of their
// own that the other tiles branch around (with a per-element test in
// every tile the causal forward ran slower than the full one, which has
// twice its pairs). The exponentials run on the
// MUFU alone (ex2.approx.ftz: results below 2^-126 flush to zero, far
// below a bf16 P's resolution), with the scale folded into one FMA.

constexpr int k64Warps = 8;                // two consumer warpgroups
constexpr int k64Threads = 32 * k64Warps;  // and no producer warp
constexpr int k64Stages = 4;               // depth of the ring
using Pipe64 = RingPos<k64Stages>;
constexpr int k64Keys = 64;                // keys a forward or dQ stage
constexpr int kDkv64Keys = 128;            // keys a dK/dV CTA owns
constexpr int kDkv64Q = 32;                // queries a dK/dV stage

// a D-64 dK/dV stage: Q, dO, lse and delta, rounded up to 1024 bytes
constexpr int kDkv64Stage =
    (2 * tile_bytes<64>(kDkv64Q) + 2 * kDkv64Q * 4 + 1023) / 1024 * 1024;

// The 1024-aligned shared memory of a D-64 CTA: the tiles read once (kOnce
// bytes), the ring's stages (kStage bytes each), each stage's segment ids
// (kIds bytes each, none without segments), then the barriers once and
// full[s] and a release count per stage.
template <int kOnce, int kStage, int kIds = 0>
struct Smem64 {
  unsigned char* p;  // generic address
  uint32_t s;        // the same in the shared window
  static constexpr int kIdsAt = kOnce + k64Stages * kStage;
  static constexpr int kBars = kIdsAt + k64Stages * kIds;
  static constexpr int kBytes =
      kBars + 8 * (1 + k64Stages) + 4 * k64Stages + 1024;
  __device__ uint32_t once() const { return s; }
  __device__ uint32_t stage(int st) const { return s + kOnce + st * kStage; }
  __device__ unsigned char* stage_ptr(int st) const {
    return p + kOnce + st * kStage;
  }
  __device__ uint32_t ids(int st) const { return s + kIdsAt + st * kIds; }
  __device__ int* ids_ptr(int st) const {
    return reinterpret_cast<int*>(p + kIdsAt + st * kIds);
  }
  __device__ uint32_t once_bar() const { return s + kBars; }
  __device__ uint32_t full(int st) const { return s + kBars + 8 + 8 * st; }
  __device__ int* count(int st) const {
    return reinterpret_cast<int*>(p + kBars + 8 * (1 + k64Stages)) + st;
  }
};

template <bool kSeg>
using Fwd64Smem = Smem64<tile_bytes<64>(kRows), 2 * tile_bytes<64>(k64Keys),
                         kSeg ? ids_bytes<k64Keys>() : 0>;
template <bool kSeg>
using Dq64Smem =
    Smem64<2 * tile_bytes<64>(kRows), 2 * tile_bytes<64>(k64Keys),
           kSeg ? ids_bytes<k64Keys>() : 0>;
template <bool kSeg>
using Dkv64Smem = Smem64<2 * tile_bytes<64>(kDkv64Keys), kDkv64Stage,
                         kSeg ? ids_bytes<kDkv64Q>() : 0>;

// This CTA's shared memory, its barriers initialised and its counts
// zeroed: once completes with one arrival and its bytes, full[s] with
// full_arrivals arrivals and the stage's bytes.
template <typename S>
__device__ __forceinline__ S make_smem64(int full_arrivals) {
  const uint32_t raw = smem_u32(fa_smem);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const S sm{fa_smem + pad, raw + pad};
  if (threadIdx.x == 0) {
    mbar_init(sm.once_bar(), 1);
    for (int st = 0; st < k64Stages; ++st) {
      mbar_init(sm.full(st), full_arrivals);
      *sm.count(st) = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

// This warp's release of stage st, once its lanes are done with it (its
// products waited for). True, on every lane, in the warp that releases it
// last of the CTA's k64Warps, which then refills it: a count that only
// grows, k64Warps a round.
template <typename S>
__device__ __forceinline__ bool release_last(const S& sm, int st) {
  __syncwarp();
  int last = 0;
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    last = atomicAdd(sm.count(st), 1) % k64Warps == k64Warps - 1;
    __threadfence_block();
  }
  return __shfl_sync(kFull, last, 0) != 0;
}

// 2^x on the MUFU alone
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// This CTA's (rank, h, b) in a grid of (blocks, H, B): rank 0 is a
// head's longest block. Causal blocks differ in length, so their ranks
// run across the whole grid, every head's longest first, and no long
// block starts last (11-13 % off ERNIE-MoE's causal kernels); otherwise a
// head's blocks run together and share its K and V (Q and dO) through L2.
template <bool kCausal>
__device__ __forceinline__ int3 block_of() {
  if (!kCausal) return make_int3(blockIdx.x, blockIdx.y, blockIdx.z);
  const int n_heads = gridDim.y * gridDim.z;
  const int idx = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                                            blockIdx.z);
  const int hb = idx % n_heads;
  return make_int3(idx / n_heads, hb % gridDim.y, hb / gridDim.y);
}

// The allowed pairs of a 64-column tile from column k0 whose rows are
// queries: bit i for accumulator element i (column k0 + 8 (i >> 2) + 2 t +
// (i & 1), row (i >> 1) & 1) iff the column is inside Lk and, causal, at
// or before the row's last key diag[(i >> 1) & 1] (its index + Lk - L).
template <bool kCausal>
__device__ __forceinline__ uint32_t mask_bits(int k0, const int (&diag)[2],
                                              int Lk) {
  const int t = threadIdx.x & 3;
  uint32_t ok = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    ok |= static_cast<uint32_t>(col < Lk &&
                                (!kCausal || col <= diag[(i >> 1) & 1]))
          << i;
  }
  return ok;
}

// The same for a tile of N queries from q0 whose rows are keys (dK/dV's
// transposed scores; N / 2 elements a thread): column q0 + 8 (i >> 2) +
// 2 t + (i & 1), row (i >> 1) & 1, allowed iff the query is inside L and,
// causal, at or after the key's first query key[(i >> 1) & 1] (its index
// less Lk - L).
template <bool kCausal, int N>
__device__ __forceinline__ uint32_t mask_bits_keys(int q0,
                                                   const int (&key)[2],
                                                   int L) {
  const int t = threadIdx.x & 3;
  uint32_t ok = 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int cq = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
    ok |= static_cast<uint32_t>(cq < L &&
                                (!kCausal || cq >= key[(i >> 1) & 1]))
          << i;
  }
  return ok;
}

// Tile j's K and V rows (64 keys) into stage st, completing on full[st]:
// one lane; with segments a whole warp, whose lanes also copy the tile's
// ids (fill_ids) and arrive once those land.
template <bool kSeg, typename S>
__device__ __forceinline__ void fill_kv64(const S& sm, int st,
                                          const CUtensorMap* map_k,
                                          const CUtensorMap* map_v, int j,
                                          int h, int b, const Seg& sg,
                                          int L) {
  const uint32_t full = sm.full(st), kt = sm.stage(st);
  if (!kSeg || (threadIdx.x & 31) == 0) {
    mbar_expect_tx(full, 2 * tile_bytes<64>(k64Keys));
    load_rows<64, k64Keys>(kt, map_k, full, j * k64Keys, h, b);
    load_rows<64, k64Keys>(kt + tile_bytes<64>(k64Keys), map_v, full,
                           j * k64Keys, h, b);
  }
  if constexpr (kSeg) {
    fill_ids<k64Keys>(sm.ids(st), sg, b, j * k64Keys, L);
    cp_async_arrive(full);
  }
}

// Forward: a CTA owns 128 query rows (64 a warpgroup), Q loaded once, K and
// V in stages of 64 keys. Per tile a warpgroup runs S = Q K^T, draws the
// tile's keep bits under it (dropout), takes the row maxima of the raw
// scores (the scale is positive), P = 2^(S scale log2 e - m) and the
// online softmax in registers, then O += (keep o P) V (A = P from
// registers, B = V MN-major). With segments (kSeg, never with kDrop) it
// walks the CTA's window of tiles only.
template <bool kCausal, bool kDrop, bool kSeg>
__global__ void __launch_bounds__(k64Threads, 2)
    flash_fwd64_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, View o,
                           float* __restrict__ lse, int L, int Lk, int H,
                           float scale, Drop dr, Seg sg) {
  constexpr int D = 64;
  using S = Fwd64Smem<kSeg>;
  // full[s]: the copies' arrival (and with segments every filling lane's)
  const S sm = make_smem64<S>(kSeg ? 1 + 32 : 1);
  const int3 at = block_of<kCausal>();
  const int h = at.y, b = at.z;
  const int blk = kCausal ? static_cast<int>(gridDim.x) - 1 - at.x : at.x;
  const int q0 = blk * kRows;
  const int off = Lk - L;  // causal: row i sees the keys j <= i + off
  const int kv_end = kCausal ? max(0, min(Lk, q0 + kRows + off)) : Lk;
  int2 win = make_int2(0, (kv_end + k64Keys - 1) / k64Keys);
  if constexpr (kSeg) win = seg_window(sg, b, blk, win.y);
  if (threadIdx.x < (kSeg ? 32 : 1)) {  // the first copies
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.once_bar(), tile_bytes<D>(kRows));
      load_rows<D, kRows>(sm.once(), &map_q, sm.once_bar(), q0, h, b);
    }
    for (int j = win.x; j < min(win.y, win.x + k64Stages); ++j)
      fill_kv64<kSeg>(sm, j - win.x, &map_k, &map_v, j, h, b, sg, L);
  }
  const int wg = threadIdx.x / 128;  // uniform across each warp
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  // causal: the last key of its first row and of each of its rows,
  // shifted once so that the tile loop does what it does at Lk = L
  const int d0 = r0 + off, diag[2] = {row[0] + off, row[1] + off};
  const int bh = b * H + h;
  const uint32_t qa = sm.once() + wg * 64 * 128;  // its rows of Q
  constexpr uint32_t kQPanel = kRows * 128, kKVPanel = k64Keys * 128;
  const float sl2 = scale * kLog2e;  // logits in base-2 units
  PhiloxKey mk{};
  if constexpr (kDrop) mk = load_key(dr.key, dr.thresh);

  int sr[2] = {0, 0};  // this thread's rows' ids, its warpgroup's range
  int2 wr = make_int2(0, 0);
  if constexpr (kSeg) {
    row_ids(sr, sg, b, row, L);
    wr = rows_range<2>(sg, b, r0, L);
  }

  // m is the running row maximum in base-2 units, l the row sum
  float acc[D / 2], s[k64Keys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(sm.once_bar(), 0);
  Pipe64 p;
  for (int j = win.x; j < win.y; ++j, p.next()) {
    const int k0 = j * k64Keys;
    mbar_wait(sm.full(p.stage), p.phase);
    // causal: skip a tile every key of which is after all of this
    // warpgroup's rows. Segments: skip a tile of other segments only,
    // mask one that is not all this warpgroup's one segment.
    bool skip = kCausal && k0 > d0 + 63, seg_edge = false;
    if constexpr (kSeg) {
      const int2 tr = stage_range<k64Keys>(sm.ids_ptr(p.stage));
      skip = skip || disjoint(tr, wr);
      seg_edge = !one_segment(tr, wr);
    }
    if (!skip) {
      // a tile on the diagonal or the ragged edge is masked
      const bool edge = seg_edge || (kCausal && k0 + k64Keys - 1 > d0) ||
                        k0 + k64Keys > Lk;
      const uint32_t kt = sm.stage(p.stage);
      const uint32_t vt = kt + tile_bytes<D>(k64Keys);
      // the keep bits of s[i] (bit i), drawn while the scores are dead
      // (wgmma_first writes them afresh), so that the Philox state and
      // the score tile do not hold registers at once: the two fit 128
      // registers a thread, two CTAs an SM
      uint32_t keep = 0;
      if constexpr (kDrop) keep = keep_bits_qrows<8>(mk, bh, row, k0);
      wgmma_fence();
      wgmma_first<0, 0>(s, kmajor(qa, 0, kQPanel), kmajor(kt, 0, kKVPanel));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma<0, 0>(s, kmajor(qa, kk, kQPanel), kmajor(kt, kk, kKVPanel));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      // the tile's allowed pairs (bit i for s[i]), on the diagonal, the
      // ragged edge or not one segment only: the loops below branch
      // around the masking
      uint32_t ok = kFull;
      if (edge) {
        ok = mask_bits<kCausal>(k0, diag, Lk);
        if constexpr (kSeg) ok &= seg_bits<k64Keys>(sm.ids_ptr(p.stage), sr);
#pragma unroll
        for (int i = 0; i < k64Keys / 2; ++i)
          s[i] = (ok >> i) & 1u ? s[i] : kNegInf;
      }
      float rm[2] = {kNegInf, kNegInf};  // raw row maxima
#pragma unroll
      for (int i = 0; i < k64Keys / 2; ++i)
        rm[(i >> 1) & 1] = fmaxf(rm[(i >> 1) & 1], s[i]);
      float mx[2], nm[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(m[r], quad_max(rm[r]) * sl2);
        nm[r] = -mx[r];
        alpha[r] = fast_exp2(m[r] - mx[r]);
      }
#pragma unroll
      for (int i = 0; i < k64Keys / 2; ++i)
        s[i] = fast_exp2(fmaf(s[i], sl2, nm[(i >> 1) & 1]));
      if (edge) {
        // re-masked: a row whose columns are all masked so far has
        // s sl2 == m and 2^0 == 1
#pragma unroll
        for (int i = 0; i < k64Keys / 2; ++i)
          s[i] = (ok >> i) & 1u ? s[i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < k64Keys / 2; ++i) {
        rs[(i >> 1) & 1] += s[i];  // l is the undropped row sum
        if constexpr (kDrop) s[i] = (keep >> i) & 1u ? s[i] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[k64Keys / 16][4];  // keep o P, rounded to bf16
      to_a(pa, s);
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < k64Keys / 16; ++kk)
        wgmma<1>(acc, pa[kk], operand_desc<true>(vt, kk, kKVPanel));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
    }
    if (release_last(sm, p.stage) && j + k64Stages < win.y &&
        (kSeg || lane == 0))
      fill_kv64<kSeg>(sm, p.stage, &map_k, &map_v, j + k64Stages, h, b, sg,
                      L);
  }

  // out = acc / (1 - p) / max(l, 1e-30): one division a row
  float lm[2], mul[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lm[r] = fmaxf(l[r], 1e-30f);
    mul[r] = (kDrop ? dr.inv_keep : 1.f) / lm[r];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= mul[(i >> 1) & 1];
  const float one[2] = {1.f, 1.f};
  store_rows<D>(o, b, h, row, L, acc, one);
  if (t == 0) {
    float* lp = lse + static_cast<long long>(bh) * L;
    // a row with no allowed key (causal, i < L - Lk) keeps -1e30
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < L)
        lp[row[r]] = l[r] > 0.f ? m[r] * kLn2 + logf(lm[r]) : kNegInf;
  }
}

// dQ: a CTA owns 128 query rows, Q and dO (and each row's lse and delta)
// loaded once, K and V in stages of 64 keys. Per tile a warpgroup runs
// S = Q K^T and dP = dO V^T, draws the keep bits under them (dropout),
// computes dS in registers, then dQ += dS K (A = dS from registers, B = K
// MN-major). Segments as the forward.
template <bool kCausal, bool kDrop, bool kSeg>
__global__ void __launch_bounds__(k64Threads, 2)
    flash_bwd_dq64_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, View dq,
                              int L, int Lk, int H, float scale, Drop dr,
                              Seg sg) {
  constexpr int D = 64;
  using S = Dq64Smem<kSeg>;
  const S sm = make_smem64<S>(kSeg ? 1 + 32 : 1);
  const int3 at = block_of<kCausal>();
  const int h = at.y, b = at.z;
  const int blk = kCausal ? static_cast<int>(gridDim.x) - 1 - at.x : at.x;
  const int q0 = blk * kRows;
  const int off = Lk - L;  // causal: row i sees the keys j <= i + off
  const int kv_end = kCausal ? max(0, min(Lk, q0 + kRows + off)) : Lk;
  int2 win = make_int2(0, (kv_end + k64Keys - 1) / k64Keys);
  if constexpr (kSeg) win = seg_window(sg, b, blk, win.y);
  if (threadIdx.x < (kSeg ? 32 : 1)) {  // the first copies
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.once_bar(), 2 * tile_bytes<D>(kRows));
      load_rows<D, kRows>(sm.once(), &map_q, sm.once_bar(), q0, h, b);
      load_rows<D, kRows>(sm.once() + tile_bytes<D>(kRows), &map_do,
                          sm.once_bar(), q0, h, b);
    }
    for (int j = win.x; j < min(win.y, win.x + k64Stages); ++j)
      fill_kv64<kSeg>(sm, j - win.x, &map_k, &map_v, j, h, b, sg, L);
  }
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int r0 = q0 + 64 * wg;
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  // causal: the last key of its first row and of each of its rows,
  // shifted once so that the tile loop does what it does at Lk = L
  const int d0 = r0 + off, diag[2] = {row[0] + off, row[1] + off};
  const int bh = b * H + h;
  const long long rbase = static_cast<long long>(bh) * L;
  const float sl2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)
  float nlse2[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    nlse2[r] = row[r] < L ? -lse[rbase + row[r]] * kLog2e : 0.f;
    dl_r[r] = row[r] < L ? delta[rbase + row[r]] : 0.f;
  }
  const uint32_t qa = sm.once() + wg * 64 * 128;
  const uint32_t oa = qa + tile_bytes<D>(kRows);  // its rows of dO
  constexpr uint32_t kQPanel = kRows * 128, kKVPanel = k64Keys * 128;
  PhiloxKey mk{};
  if constexpr (kDrop) mk = load_key(dr.key, dr.thresh);
  int sr[2] = {0, 0};  // this thread's rows' ids, its warpgroup's range
  int2 wr = make_int2(0, 0);
  if constexpr (kSeg) {
    row_ids(sr, sg, b, row, L);
    wr = rows_range<2>(sg, b, r0, L);
  }

  float acc[D / 2], s[k64Keys / 2], dp[k64Keys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < k64Keys / 2; ++i) s[i] = dp[i] = 0.f;

  mbar_wait(sm.once_bar(), 0);
  Pipe64 p;
  for (int j = win.x; j < win.y; ++j, p.next()) {
    const int k0 = j * k64Keys;
    mbar_wait(sm.full(p.stage), p.phase);
    // causal: no key of the tile is at or before any of this
    // warpgroup's rows; segments: none is of its rows' segments
    bool skip = kCausal && k0 > d0 + 63, seg_edge = false;
    if constexpr (kSeg) {
      const int2 tr = stage_range<k64Keys>(sm.ids_ptr(p.stage));
      skip = skip || disjoint(tr, wr);
      seg_edge = !one_segment(tr, wr);
    }
    if (!skip) {
      const uint32_t kt = sm.stage(p.stage);
      const uint32_t vt = kt + tile_bytes<D>(k64Keys);
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
      // the keep bits of dp[i] (bit i), drawn while the tensor cores run
      uint32_t keep = 0;
      if constexpr (kDrop) keep = keep_bits_qrows<8>(mk, bh, row, k0);
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
#pragma unroll
      for (int i = 0; i < k64Keys / 2; ++i)
        s[i] = fast_exp2(fmaf(s[i], sl2, nlse2[(i >> 1) & 1]));  // P
      // on the diagonal, the ragged edge or not one segment: re-masked
      if (seg_edge || (kCausal && k0 + k64Keys - 1 > d0) ||
          k0 + k64Keys > Lk) {
        uint32_t ok = mask_bits<kCausal>(k0, diag, Lk);
        if constexpr (kSeg) ok &= seg_bits<k64Keys>(sm.ids_ptr(p.stage), sr);
#pragma unroll
        for (int i = 0; i < k64Keys / 2; ++i)
          s[i] = (ok >> i) & 1u ? s[i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < k64Keys / 2; ++i) {
        float d = dp[i];
        if constexpr (kDrop) d = (keep >> i) & 1u ? d * dr.inv_keep : 0.f;
        s[i] = s[i] * (d - dl_r[(i >> 1) & 1]) * scale;  // dS
      }
      uint32_t da[k64Keys / 16][4];  // dS, rounded to bf16
      to_a(da, s);
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < k64Keys / 16; ++kk)
        wgmma<1>(acc, da[kk], operand_desc<true>(kt, kk, kKVPanel));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
    }
    if (release_last(sm, p.stage) && j + k64Stages < win.y &&
        (kSeg || lane == 0))
      fill_kv64<kSeg>(sm, p.stage, &map_k, &map_v, j + k64Stages, h, b, sg,
                      L);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, b, h, row, L, acc, one);
}

// Query tile i's Q and dO rows into stage st by TMA (lane 0) and its lse
// and delta (with segments also its ids) by cp.async (every lane, a row
// each), each lane's copies arriving on full[st] once complete: a whole
// warp, none of which waits. Rows past L read as zeros (their columns are
// masked).
template <bool kSeg, typename S>
__device__ __forceinline__ void fill_qdo64(
    const S& sm, int st, const CUtensorMap* map_q, const CUtensorMap* map_do,
    const float* __restrict__ lse, const float* __restrict__ delta, int i,
    int h, int b, int L, long long rbase, const Seg& sg) {
  constexpr int kStats = 2 * tile_bytes<64>(kDkv64Q);  // lse, then delta
  const int lane = threadIdx.x & 31;
  const uint32_t full = sm.full(st), qt = sm.stage(st);
  if (lane == 0) {
    mbar_expect_tx(full, 2 * tile_bytes<64>(kDkv64Q));
    load_rows<64, kDkv64Q>(qt, map_q, full, i * kDkv64Q, h, b);
    load_rows<64, kDkv64Q>(qt + tile_bytes<64>(kDkv64Q), map_do, full,
                         i * kDkv64Q, h, b);
  }
  const uint32_t stats = qt + kStats;
#pragma unroll
  for (int r = lane; r < kDkv64Q; r += 32) {
    const int row = i * kDkv64Q + r;
    const long long at = rbase + min(row, L - 1);
    cp_async4(stats + 4 * r, lse + at, row < L);
    cp_async4(stats + 4 * (kDkv64Q + r), delta + at, row < L);
  }
  if constexpr (kSeg) fill_ids<kDkv64Q>(sm.ids(st), sg, b, i * kDkv64Q, L);
  cp_async_arrive(full);
}

// dK / dV: the dK and dV accumulators are 32 registers each, so one
// warpgroup holds both for its keys. A CTA owns 128 key rows, 64 a
// warpgroup, with K and V loaded once and Q and dO (with their rows' lse
// and delta) in stages of 32 queries, each serving all 128 keys: the
// score tiles are then 16 registers, and a thread fits 128, two CTAs an
// SM (64-query tiles took 155-227 registers and one CTA). Per tile
// a warpgroup computes S^T = K Q^T and dP^T = V dO^T, draws the tile's
// keep bits under them (dropout; the rows are keys, so keep_bits_krows),
// then P^T, the dropped P_d^T = keep o P^T / (1 - p) and dS^T = P^T (keep o
// dP^T / (1 - p) - delta) scale in registers, and dV += P_d^T dO,
// dK += dS^T Q (A from registers, B MN-major). Computing the transposes
// puts P^T and dS^T in registers as A operands (Q and dO are K-major for
// the scores and MN-major for the accumulations). Nothing passes between
// the warpgroups: the D-128 kernel's P^T ring is not needed. With segments
// (kSeg, never with kDrop) a CTA walks its window of query stages only.
template <bool kCausal, bool kDrop, bool kSeg>
__global__ void __launch_bounds__(k64Threads, 2)
    flash_bwd_dkv64_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, View dk,
                               View dv, int L, int Lk, int H, float scale,
                               Drop dr, Seg sg) {
  constexpr int D = 64;
  constexpr int kStats = 2 * tile_bytes<D>(kDkv64Q);  // lse, then delta
  using S = Dkv64Smem<kSeg>;
  // full[s]: the copies' arrival and every lane's of the filling warp
  const S sm = make_smem64<S>(1 + 32);
  // causal: the first key blocks see the most queries and go first
  const int3 at = block_of<kCausal>();
  const int h = at.y, b = at.z;
  const int k0 = at.x * kDkv64Keys;
  const int n_q = (L + kDkv64Q - 1) / kDkv64Q;
  // causal: key j is seen by the queries i >= j - off
  const int off = Lk - L;
  int2 win = make_int2(kCausal ? max(k0 - off, 0) / kDkv64Q : 0, n_q);
  if constexpr (kSeg) {
    const int2 w = seg_window(sg, b, at.x, n_q);
    win = make_int2(max(win.x, w.x), w.y);
  }
  const int i0 = win.x;
  const int bh = b * H + h;
  const long long rbase = static_cast<long long>(bh) * L;
  if (threadIdx.x < 32) {  // warp 0: the first copies
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.once_bar(), 2 * tile_bytes<D>(kDkv64Keys));
      load_rows<D, kDkv64Keys>(sm.once(), &map_k, sm.once_bar(), k0, h, b);
      load_rows<D, kDkv64Keys>(sm.once() + tile_bytes<D>(kDkv64Keys),
                               &map_v, sm.once_bar(), k0, h, b);
    }
    for (int i = i0; i < min(win.y, i0 + k64Stages); ++i)
      fill_qdo64<kSeg>(sm, i - i0, &map_q, &map_do, lse, delta, i, h, b, L,
                       rbase, sg);
  }
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw = k0 + 64 * wg;  // this warpgroup's first key
  const int key[2] = {kw + 16 * warp + g, kw + 16 * warp + g + 8};
  // causal: the first query of each of its keys (the skip and edge tests
  // below add the offset in the loop: one more register held across it
  // spilled the causal dropout instance)
  const int first_q[2] = {key[0] - off, key[1] - off};
  const uint32_t ka = sm.once() + wg * 64 * 128;  // its rows of K
  const uint32_t va = ka + tile_bytes<D>(kDkv64Keys);  // ... and of V
  constexpr uint32_t kKPanel = kDkv64Keys * 128, kQPanel = kDkv64Q * 128;
  const float sl2 = scale * kLog2e;

  int sk[2] = {0, 0};  // this thread's keys' ids, its warpgroup's range
  int2 wr = make_int2(0, 0);
  if constexpr (kSeg) {
    row_ids(sk, sg, b, key, L);
    wr = rows_range<2>(sg, b, kw, L);
  }

  // x: S^T, then the dropped P^T; y: dP^T, then dS^T
  float dk_acc[D / 2], dv_acc[D / 2], x[kDkv64Q / 2], y[kDkv64Q / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // the keep bits of a tile's x[i], y[i] (bit i): each tile's are drawn
  // while the tensor cores run the previous tile's dV and dK products
  // (issued and waited for in one branch: ptxas serialises wgmmas whose
  // wait a divergent path separates from their issue)
  PhiloxKey mk{};
  if constexpr (kDrop) mk = load_key(dr.key, dr.thresh);
  const auto next_keep = [&](int qt0) {
    return keep_bits_krows<kDkv64Q / 8>(mk, bh, kw + 16 * warp, qt0);
  };
  uint32_t keep_next = 0;
  if constexpr (kDrop) keep_next = next_keep(i0 * kDkv64Q);
  mbar_wait(sm.once_bar(), 0);
  Pipe64 p;
  for (int i = i0; i < win.y; ++i, p.next()) {
    const int q0 = i * kDkv64Q;
    const uint32_t keep = keep_next;
    mbar_wait(sm.full(p.stage), p.phase);
    // causal: every query of the tile is before all of this warpgroup's
    // keys (the first tile for warpgroup 1); segments: none is of its
    // keys' segments
    bool skip = kCausal && q0 + kDkv64Q - 1 + off < kw, seg_edge = false;
    if constexpr (kSeg) {
      const int2 tr = stage_range<kDkv64Q>(sm.ids_ptr(p.stage));
      skip = skip || disjoint(tr, wr);
      seg_edge = !one_segment(tr, wr);
    }
    const uint32_t qt = sm.stage(p.stage);
    const uint32_t ot = qt + tile_bytes<D>(kDkv64Q);  // dO
    if (!skip) {
      wgmma_fence();
      wgmma_first<0, 0>(x, kmajor(ka, 0, kKPanel), kmajor(qt, 0, kQPanel));
      wgmma_first<0, 0>(y, kmajor(va, 0, kKPanel), kmajor(ot, 0, kQPanel));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        wgmma<0, 0>(x, kmajor(ka, kk, kKPanel), kmajor(qt, kk, kQPanel));
        wgmma<0, 0>(y, kmajor(va, kk, kKPanel), kmajor(ot, kk, kQPanel));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(x);
      fence_operand(y);
      const float* stats = reinterpret_cast<const float*>(
          sm.stage_ptr(p.stage) + kStats);
#pragma unroll
      for (int jn = 0; jn < kDkv64Q / 8; ++jn) {
        // this thread's query columns 8 jn + 2 t, + 1
        const float2 lq =
            *reinterpret_cast<const float2*>(stats + 8 * jn + 2 * t);
        const float nl[2] = {-lq.x * kLog2e, -lq.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e)  // P^T
          x[4 * jn + e] = fast_exp2(fmaf(x[4 * jn + e], sl2, nl[e & 1]));
      }
      // on the diagonal, the ragged edge or not one segment: re-masked
      if (seg_edge || (kCausal && q0 + off < kw + 63) || q0 + kDkv64Q > L) {
        uint32_t ok = mask_bits_keys<kCausal, kDkv64Q>(q0, first_q, L);
        if constexpr (kSeg) ok &= seg_bits<kDkv64Q>(sm.ids_ptr(p.stage), sk);
#pragma unroll
        for (int i = 0; i < kDkv64Q / 2; ++i)
          x[i] = (ok >> i) & 1u ? x[i] : 0.f;
      }
#pragma unroll
      for (int jn = 0; jn < kDkv64Q / 8; ++jn) {
        const float2 dl = *reinterpret_cast<const float2*>(
            stats + kDkv64Q + 8 * jn + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i4 = 4 * jn + e;
          const float pv = x[i4];
          float pd = pv, d = y[i4];
          if constexpr (kDrop) {
            const bool kept = (keep >> i4) & 1u;
            pd = kept ? pv * dr.inv_keep : 0.f;
            d = kept ? d * dr.inv_keep : 0.f;
          }
          x[i4] = pd;                                          // P_d^T
          y[i4] = pv * (d - ((e & 1) ? dl.y : dl.x)) * scale;  // dS^T
        }
      }
      uint32_t ap[kDkv64Q / 16][4], as[kDkv64Q / 16][4];  // in bf16
      to_a(ap, x);
      to_a(as, y);
      // dV += P_d^T dO, dK += dS^T Q: B MN-major
      fence_operand(dv_acc);
      fence_operand(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkv64Q / 16; ++kk) {
        wgmma<1>(dv_acc, ap[kk], operand_desc<true>(ot, kk, kQPanel));
        wgmma<1>(dk_acc, as[kk], operand_desc<true>(qt, kk, kQPanel));
      }
      wgmma_commit();
      if constexpr (kDrop)
        if (i + 1 < win.y) keep_next = next_keep(q0 + kDkv64Q);
      wgmma_wait<0>();
      fence_operand(dv_acc);
      fence_operand(dk_acc);
    } else if constexpr (kDrop) {
      if (i + 1 < win.y) keep_next = next_keep(q0 + kDkv64Q);
    }
    if (release_last(sm, p.stage) && i + k64Stages < win.y)
      fill_qdo64<kSeg>(sm, p.stage, &map_q, &map_do, lse, delta,
                       i + k64Stages, h, b, L, rbase, sg);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, b, h, key, Lk, dk_acc, one);
  store_rows<D>(dv, b, h, key, Lk, dv_acc, one);
}

// -- launch ------------------------------------------------------------------

// The tensor map of a bf16 [B, L, H, D] view (element strides sb, sl, sh;
// D contiguous): dims D, H, L, B innermost first, boxes of 64 x 1 x rows x 1.
bool bhld_map(CUtensorMap* map, const void* base, const long long* st, int B,
              int L, int H, int D, int rows) {
  const long long dims[4] = {D, H, L, B};
  const long long bytes[3] = {st[2] * 2, st[1] * 2, st[0] * 2};
  const int box[4] = {64, 1, rows, 1};
  return encode_tiled(map, 4, base, dims, bytes, box);
}

View view(void* p, const long long* st) { return View{p, st[0], st[1], st[2]}; }

// What these kernels take, as takes_tma decides it: head dim 64 or 128
// (dropout, thresh != 0, at 64 only and without segments), every size
// positive and inside the grid's and the tensor maps' int32 ranges, 16-byte
// aligned bases and (batch, seq, head) strides multiples of 8 elements. n
// views, three strides each.
bool takes(void* const* ptrs, int n, const long long* strides, int B, int L,
           int Lk, int H, int D, uint32_t thresh, bool seg) {
  if ((D != 64 && D != 128) || (thresh != 0u && (D != 64 || seg)) ||
      (seg && Lk != L) || B <= 0 || L <= 0 || Lk <= 0 || H <= 0 ||
      B > 65535 || H > 65535 ||
      static_cast<long long>(B) * H * max(L, Lk) > 0x7fffffffLL)
    return false;
  for (int i = 0; i < n; ++i) {
    if (!aligned16(ptrs[i])) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] % 8) return false;
  }
  return true;
}

// The tensor maps and output views of one call
struct Call {
  CUtensorMap maps[4];
  View views[2];
};

// Encodes the tensor maps of the first n_maps views (lengths lens[i], box
// heights rows[i]) and wraps the next n_views as output views; false when
// the encoder refuses a map.
bool prepare(Call* c, void* const* ptrs, int n_maps, int n_views,
             const long long* strides, int B, const int* lens, int H, int D,
             const int* rows) {
  for (int i = 0; i < n_maps; ++i)
    if (!bhld_map(&c->maps[i], ptrs[i], strides + 3 * i, B, lens[i], H, D,
                  rows[i]))
      return false;
  for (int i = 0; i < n_views; ++i)
    c->views[i] = view(ptrs[n_maps + i], strides + 3 * (n_maps + i));
  return true;
}

// Each kernel of the library by its flags, with its threads and dynamic
// shared memory.
struct Kernel {
  const void* fn;
  int threads, smem;
};

// One instance per (causal, dropout, segments) flag set; dropout and
// segments never together.
template <bool kC>
const void* fwd64(bool drop, bool seg) {
  return drop  ? (const void*)flash_fwd64_tma_kernel<kC, true, false>
         : seg ? (const void*)flash_fwd64_tma_kernel<kC, false, true>
               : (const void*)flash_fwd64_tma_kernel<kC, false, false>;
}
template <bool kC>
const void* dq64(bool drop, bool seg) {
  return drop  ? (const void*)flash_bwd_dq64_tma_kernel<kC, true, false>
         : seg ? (const void*)flash_bwd_dq64_tma_kernel<kC, false, true>
               : (const void*)flash_bwd_dq64_tma_kernel<kC, false, false>;
}
template <bool kC>
const void* dkv64(bool drop, bool seg) {
  return drop  ? (const void*)flash_bwd_dkv64_tma_kernel<kC, true, false>
         : seg ? (const void*)flash_bwd_dkv64_tma_kernel<kC, false, true>
               : (const void*)flash_bwd_dkv64_tma_kernel<kC, false, false>;
}

template <bool kC>
const void* fwd128(bool seg) {
  return seg ? (const void*)flash_fwd_tma_kernel<128, kC, true>
             : (const void*)flash_fwd_tma_kernel<128, kC, false>;
}
template <bool kC>
const void* dq128(bool seg) {
  return seg ? (const void*)flash_bwd_dq_tma_kernel<128, kC, true>
             : (const void*)flash_bwd_dq_tma_kernel<128, kC, false>;
}
template <bool kC>
const void* dkv128(bool seg) {
  return seg ? (const void*)flash_bwd_dkv_tma_kernel<128, kC, true>
             : (const void*)flash_bwd_dkv_tma_kernel<128, kC, false>;
}

Kernel fwd_kernel(int D, bool causal, bool drop, bool seg) {
  if (D == 128)
    return {causal ? fwd128<true>(seg) : fwd128<false>(seg), kThreads,
            seg ? FwdSmem<128, true>::kBytes : FwdSmem<128, false>::kBytes};
  return {causal ? fwd64<true>(drop, seg) : fwd64<false>(drop, seg),
          k64Threads,
          seg ? Fwd64Smem<true>::kBytes : Fwd64Smem<false>::kBytes};
}

Kernel dq_kernel(int D, bool causal, bool drop, bool seg) {
  if (D == 128)
    return {causal ? dq128<true>(seg) : dq128<false>(seg), kThreads,
            seg ? DqSmem<128, true>::kBytes : DqSmem<128, false>::kBytes};
  return {causal ? dq64<true>(drop, seg) : dq64<false>(drop, seg), k64Threads,
          seg ? Dq64Smem<true>::kBytes : Dq64Smem<false>::kBytes};
}

Kernel dkv_kernel(int D, bool causal, bool drop, bool seg) {
  if (D == 128)
    return {causal ? dkv128<true>(seg) : dkv128<false>(seg), kThreads,
            seg ? DkvSmem<128, true>::kBytes : DkvSmem<128, false>::kBytes};
  return {causal ? dkv64<true>(drop, seg) : dkv64<false>(drop, seg),
          k64Threads,
          seg ? Dkv64Smem<true>::kBytes : Dkv64Smem<false>::kBytes};
}

// Launches kernel k on a grid (blocks of `rows` of the L rows a kernel owns
// — queries, or keys for dK/dV —, H, B), so that the blocks of one head run
// together and share its K and V (Q and dO) through L2. args points to each
// argument in order: the D-64 kernels end with (Drop, Seg), the D-128 ones
// with the Seg alone and ignore the last.
int launch_kernel(const Kernel& k, int rows, int L, int H, int B,
                  cudaStream_t stream, void** args) {
  const cudaError_t rc = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((L + rows - 1) / rows, H, B);
  const cudaError_t rl =
      cudaLaunchKernel(k.fn, grid, dim3(k.threads), args, k.smem, stream);
  return static_cast<int>(rl != cudaSuccess ? rl : cudaGetLastError());
}

Kernel kernel_of(int which, int D, bool causal, bool drop, bool seg) {
  return which == 0   ? fwd_kernel(D, causal, drop, seg)
         : which == 1 ? dq_kernel(D, causal, drop, seg)
                      : dkv_kernel(D, causal, drop, seg);
}

// The tiles of kernel `which` (0 forward, 1 dQ, 2 dK/dV) at head dim D:
// x the rows a CTA owns (queries; keys for dK/dV), y the rows of the other
// operand a tile or ring stage holds, the units of win's windows
int2 tiles_of(int which, int D) {
  if (which == 0) return make_int2(kRows, D == 128 ? kFwdKV : k64Keys);
  if (which == 1) return make_int2(kRows, D == 128 ? kDqKV : k64Keys);
  return D == 128 ? make_int2(kDkvKeys, kDkvQ)
                  : make_int2(kDkv64Keys, kDkv64Q);
}

// The argument after the scale: the D-64 kernels' Drop (then their Seg),
// the D-128 kernels' Seg (they take no dropout)
void* last(int D, Drop* dr, Seg* sg) {
  return D == 128 ? static_cast<void*>(sg) : static_cast<void*>(dr);
}

// The segments of a call: all three arrays or none
bool make_seg(Seg* sg, const int* seg, long long seg_sb, const int* seg_rng,
              const int* win) {
  *sg = Seg{seg, seg_sb, seg_rng, win};
  return (seg == nullptr) == (seg_rng == nullptr) &&
         (seg == nullptr) == (win == nullptr);
}

}  // namespace

// Plain C entry points, bound with ctypes; the arguments of the first
// design's entries (flash_attention.cuh) without dtype, with each CTA's
// window of tiles after the segment ranges. Tensors are bf16 [B, L, H, D]
// views (k, v, dk, dv [B, Lk, H, D]; causal, query i sees the keys
// j <= i + Lk - L) with D = 64 or 128 contiguous and their own element
// strides (batch, seq, head) in `strides`, three per view in argument
// order; lse and delta are contiguous f32 [B, H, L]. The caller allocates the
// outputs. `seg` ([B, L] int32, batch stride seg_sb), `seg_rng`
// ([B, ceil(L / 32), 2] int32: min and max id of every 32-row chunk) and
// `win` ([B, blocks, 2] int32: the first tile and one past the last of
// each CTA's block, in the kernel's tiles: flash_attention_tma_tiles) are
// all null without segments.
// `thresh` is 0 without dropout (`key` is then not read), else the keep
// threshold with the Philox key at `key` (int64 [2] in device memory, two
// unsigned 32-bit words, read by each CTA before its first tile) and
// inv_keep = 1 / (1 - p) (D 64, no segments).
// Each returns 0, the cudaError_t of the launch, cudaErrorInvalidValue for
// a call takes_tma would refuse, or -1 when cuTensorMapEncodeTiled refuses
// a map.
extern "C" int flash_attention_tma_forward(
    void* q, void* k, void* v, void* out, float* lse,
    const long long* strides, int B, int L, int Lk, int H, int D,
    int causal, float scale, const int* seg, long long seg_sb,
    const int* seg_rng, const int* win, const long long* key,
    uint32_t thresh, float inv_keep, void* stream) {
  void* ptrs[4] = {q, k, v, out};
  Seg sg;
  if (!make_seg(&sg, seg, seg_sb, seg_rng, win) ||
      (thresh != 0u && key == nullptr) ||
      !takes(ptrs, 4, strides, B, L, Lk, H, D, thresh, seg != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int2 t = tiles_of(0, D);
  const int rows[3] = {t.x, t.y, t.y}, lens[3] = {L, Lk, Lk};
  Call c;
  if (!prepare(&c, ptrs, 3, 1, strides, B, lens, H, D, rows))
    return kEncodeFailed;
  Drop dr{key, thresh, inv_keep};
  void* args[] = {&c.maps[0], &c.maps[1], &c.maps[2], &c.views[0],
                  &lse,       &L,         &Lk,        &H,
                  &scale,     last(D, &dr, &sg), &sg};
  return launch_kernel(fwd_kernel(D, causal, thresh != 0u, seg != nullptr),
                       t.x, L, H, B, static_cast<cudaStream_t>(stream),
                       args);
}

extern "C" int flash_attention_tma_backward_dq(
    void* q, void* k, void* v, void* dout, const float* lse,
    const float* delta, void* dq, const long long* strides, int B, int L,
    int Lk, int H, int D, int causal, float scale, const int* seg,
    long long seg_sb, const int* seg_rng, const int* win,
    const long long* key, uint32_t thresh, float inv_keep, void* stream) {
  void* ptrs[5] = {q, k, v, dout, dq};
  Seg sg;
  if (!make_seg(&sg, seg, seg_sb, seg_rng, win) ||
      (thresh != 0u && key == nullptr) ||
      !takes(ptrs, 5, strides, B, L, Lk, H, D, thresh, seg != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int2 t = tiles_of(1, D);
  const int rows[4] = {t.x, t.y, t.y, t.x}, lens[4] = {L, Lk, Lk, L};
  Call c;
  if (!prepare(&c, ptrs, 4, 1, strides, B, lens, H, D, rows))
    return kEncodeFailed;
  Drop dr{key, thresh, inv_keep};
  void* args[] = {&c.maps[0], &c.maps[1], &c.maps[2],  &c.maps[3],
                  &lse,       &delta,     &c.views[0], &L,
                  &Lk,        &H,         &scale,      last(D, &dr, &sg),
                  &sg};
  return launch_kernel(dq_kernel(D, causal, thresh != 0u, seg != nullptr),
                       t.x, L, H, B, static_cast<cudaStream_t>(stream),
                       args);
}

extern "C" int flash_attention_tma_backward_dkv(
    void* q, void* k, void* v, void* dout, const float* lse,
    const float* delta, void* dk, void* dv, const long long* strides, int B,
    int L, int Lk, int H, int D, int causal, float scale, const int* seg,
    long long seg_sb, const int* seg_rng, const int* win,
    const long long* key, uint32_t thresh, float inv_keep, void* stream) {
  void* ptrs[6] = {q, k, v, dout, dk, dv};
  Seg sg;
  if (!make_seg(&sg, seg, seg_sb, seg_rng, win) ||
      (thresh != 0u && key == nullptr) ||
      !takes(ptrs, 6, strides, B, L, Lk, H, D, thresh, seg != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int2 t = tiles_of(2, D);
  const int rows[4] = {t.y, t.x, t.x, t.y}, lens[4] = {L, Lk, Lk, L};
  Call c;
  if (!prepare(&c, ptrs, 4, 2, strides, B, lens, H, D, rows))
    return kEncodeFailed;
  Drop dr{key, thresh, inv_keep};
  void* args[] = {&c.maps[0], &c.maps[1], &c.maps[2],  &c.maps[3],
                  &lse,       &delta,     &c.views[0], &c.views[1],
                  &L,         &Lk,        &H,          &scale,
                  last(D, &dr, &sg), &sg};
  return launch_kernel(dkv_kernel(D, causal, thresh != 0u, seg != nullptr),
                       t.x, Lk, H, B, static_cast<cudaStream_t>(stream),
                       args);
}

// The tiles of each kernel of this library (which: 0 forward, 1 dQ, 2
// dK/dV) at head dim D, the units of win's windows: the rows a CTA owns
// (queries; keys for dK/dV) in *block, the rows of the other operand a
// tile holds in *tile. Returns 0, or -1 for a kernel the library does not
// hold.
extern "C" int flash_attention_tma_tiles(int which, int D, int* block,
                                         int* tile) {
  if ((D != 64 && D != 128) || which < 0 || which > 2) return -1;
  const int2 t = tiles_of(which, D);
  *block = t.x;
  *tile = t.y;
  return 0;
}

// Per kernel of this library (which: 0 forward, 1 dQ, 2 dK/dV; D and the
// flags of the instance): the CTAs an SM holds, by the runtime's
// occupancy calculator (registers, threads, shared memory), with its
// dynamic shared memory in *smem; -1 for an instance the library does not
// hold or a refused query.
extern "C" int flash_attention_tma_occupancy(int which, int D, int causal,
                                             int dropout, int segments,
                                             int* smem) {
  if ((D != 64 && D != 128) || (dropout && (D != 64 || segments)) ||
      which < 0 || which > 2)
    return -1;
  const Kernel k =
      kernel_of(which, D, causal != 0, dropout != 0, segments != 0);
  *smem = k.smem;
  int n = 0;
  if (cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k.fn, k.threads,
                                                    k.smem) != cudaSuccess)
    return -1;
  return n;
}
