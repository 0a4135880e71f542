// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels,
// with in-kernel attention dropout and segment (varlen) masking.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel (launched by _flash_fwd_pallas, _flash_fwd_pallas_blhd and,
// segmented, _flash_fwd_pallas_seg) and the two-kernel backward
// _bwd_dq_kernel / _bwd_dkv_kernel (launched by _flash_bwd_pallas,
// _flash_bwd_pallas_blhd and _flash_bwd_pallas_seg), including the
// dropout keep mask that _keep_mask regenerates inside all three. One
// kernel serves both TPU layouts: every tensor comes with its own (batch,
// seq, head) element strides and a contiguous head dim, so [B, L, H, D]
// and [B*H, L, D] (viewed as [B*H, L, 1, D]) are the same call. The plain
// PyTorch versions beside the wrappers (ops/kernels/flash_attention.py,
// flash_attention_fwd_reference and the two backward parts) are the
// oracles; they follow the same roundings and draw the same keep mask.
//
// Queries and keys may differ in length (L and Lk: cross-attention, a KV
// cache step, a chunk against its history); causal puts the diagonal at
// j = i + Lk - L, as the JAX oracle _sdpa_xla does. A causal row with no
// allowed key (i < L - Lk) is written as zeros with lse -1e30; the autograd
// entry fills it (ops/kernels/flash_attention.py). Segments need Lk = L.
//
// This header is compiled once per (dtype, head dim) by the four
// flash_attention_<dtype>_d<D>.cu files, so the four builds run in
// parallel; each library exports the same three C entry points and takes
// only its own dtype and head dim. bf16 calls that a TMA tensor map
// describes, with dropout (at D 64 only) or segments but not both, take
// the TMA / wgmma kernels of flash_attention_tma.cu instead (takes_tma in
// ops/kernels/flash_attention.py); this design keeps f32, dropout at
// D 128, dropout with segments and the layouts TMA cannot describe.
//
//   forward  S = scale * Q K^T (masked: causal, other segments and the
//            ragged tail -> -1e30), online softmax over KV tiles in f32
//            on the undropped P, O = (keep o P) V with P rounded to V's
//            dtype; out = acc / (1 - p) / max(l, 1e-30) in q's dtype and
//            lse = m + log(max(l, 1e-30)) in f32 [B, H, L].
//   dQ       P = exp(scale * Q K^T - lse) (re-masked), dP = dO V^T,
//            dP <- keep o dP / (1 - p), dS = P * (dP - delta) * scale,
//            dQ = dS K with dS rounded to K's dtype. delta = rowsum(dO * O)
//            of the dropped output comes in from outside (f32).
//   dK/dV    per KV tile, looping over the query tiles at or after it:
//            dV = (keep o P / (1 - p))^T dO, dK = dS^T Q (dS as in dQ, on
//            the undropped P; both rounded to the input dtype),
//            accumulated in registers and written once: no atomics, so
//            the result is deterministic, as in the TPU recipe.
//
// Dropout (K5). The keep mask is a pure function of (seed, b, h, row,
// col), so the forward's 64-row query tiles and dK/dV's 32-row ones draw
// the same bits: Philox4x32-10 with key (seed_lo, seed_hi), read from the
// key tensor the launch points to at each tile (an L1 hit: held across
// the tile loop, the two words made the dQ instance spill), and counter
// (col >> 2, row, b * H + h, 0) gives four words for four neighbouring
// columns; the pair (row, col) is kept iff word[col & 3] >= thresh, with
// thresh = min(floor(p * 2^32), 2^32 - 1). thresh = 0 turns dropout off
// and leaves the arithmetic bit for bit what it is without it. In the
// m16n8k16 accumulator a lane holds columns 2t, 2t+1 of rows g and g+8:
// in the forward and dQ the two lanes t, t^1 share both counters, each
// computes one row's and they swap halves; in dK/dV (rows are keys, the
// columns queries) the four lanes of a key group each compute one of the
// four counters and exchange words in three shuffles. So every Philox
// word is used once: a quarter of a call per (row, col) pair. The
// generator and both helpers live in philox.cuh, which the TMA design
// includes too.
//
// Segments (K4). seg [B, L] int32 (its own batch stride): a pair (i, j)
// is allowed iff seg[i] == seg[j] (and j <= i when causal); masked logits
// are -1e30 and masked probabilities are re-masked to exactly 0 (a row
// whose columns are all masked so far has m == -1e30 and exp(0) == 1). A
// KV (query) tile whose [min, max] segment range is disjoint from this
// CTA's is skipped: seg_rng [B, ceil(L/32), 2] holds the range of every
// 32-row chunk, computed by the wrapper. That is valid for any ids,
// sorted or not, and is the analogue of the causal skip: a packed batch
// of short sequences does only the pairs near the diagonal.
//
// Design. A CTA of four warps owns 64 rows (query rows for the forward
// and dQ, key rows for dK/dV); each warp owns 16 of them. The TPU grid's
// sequential KV (or query) axis becomes a loop inside the CTA: each tile
// of the other operand is staged in shared memory with 16-byte loads
// (rows past L read as zeros and their columns are masked), and every
// product runs on the tensor cores as mma.sync m16n8k16 with bf16
// operands and f32 accumulators. The score tile S never leaves
// registers: its accumulator layout is the A-operand layout of the next
// product, so P (and dS) go straight into the PV (dS K, P^T dO, dS^T Q)
// products after one rounding to bf16. Softmax statistics are per row in
// f32, reduced across the four lanes that share a row with two shuffles.
// Under `causal`, tiles entirely past the diagonal are skipped and the
// diagonal tile is masked element by element; query blocks are issued
// longest-first so the tail of the grid is short. f32 inputs take the
// same code with the product emulated on the CUDA cores (f32 FMAs over
// the same fragments, fetched with shuffles), so both dtypes share every
// index and mask. Dropout and segments are flags uniform across the grid:
// bf16 compiles one instance per (dropout, segments) pair, so the plain
// kernel carries neither; f32 keeps them as runtime flags in one
// instance (see launch_flags).
//
// What bounds it. At the Llama training geometry (B 4, L 2048, H 32,
// D 128, causal) the work is ~1.4e11 flops forward and ~3.4e11 needed
// backward (4.8e11 done by the two-kernel recipe) against ~0.3 GB of
// inputs and outputs each way: the kernels are bound by tensor-core
// operations. This first design feeds the tensor cores from shared memory
// with synchronous loads and one tile in flight, so it stalls on every
// tile load and re-reads the B operands once per warp. Dropout adds
// integer work (ten rounds of two 32-bit multiplies a Philox call), no
// products. Left for later: cp.async/TMA double buffering, ldmatrix,
// wgmma with warp-specialised producers, and a larger query block per
// CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

#if !defined(FLASH_DTYPE) || !defined(FLASH_HEAD_DIM)
#error "compile through flash_attention_<dtype>_d<D>.cu"
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16 * kWarps;  // rows a CTA owns (query or key rows)
constexpr int kBN = 64;           // key rows a tile of the fwd / dQ loop
constexpr int kBQ = 32;           // query rows a tile of the dK/dV loop
constexpr int kChunk = 32;        // rows of one seg_rng entry
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

// A [B, L, H, D] view: element pointer and element strides (D contiguous).
struct View {
  void* ptr;
  long long sb, sl, sh;
};

// The dropout and segment flags of a launch (uniform across the grid).
struct Mask {
  const int* seg;      // [B, L] segment ids, or nullptr: no segments
  long long seg_sb;    // seg's batch stride (elements)
  const int* seg_rng;  // [B, ceil(L / 32), 2]: min, max id of each chunk
  const long long* key;  // the Philox key's two words (philox.cuh)
  uint32_t thresh;     // keep iff word >= thresh; 0: no dropout
  float inv_keep;      // 1 / (1 - p)
};

template <typename T>
__device__ __forceinline__ T* base(const View& x, int b, int h) {
  return static_cast<T*>(x.ptr) + b * x.sb + h * x.sh;
}

// the segment-id range of rows [r0, r0 + 64): two chunks of 32
__device__ __forceinline__ void chunk_range(const int* rng, int c, int n32,
                                            int& lo, int& hi) {
  lo = rng[2 * c];
  hi = rng[2 * c + 1];
  if (c + 1 < n32) {
    lo = min(lo, rng[2 * c + 2]);
    hi = max(hi, rng[2 * c + 3]);
  }
}

// -- fragments -----------------------------------------------------------
// A register of an mma operand holds two consecutive k (or n) elements:
// two bf16 in one 32-bit word, or, on the f32 path, a float2.
template <typename T>
struct PairOf;
template <>
struct PairOf<__nv_bfloat16> {
  using type = uint32_t;
};
template <>
struct PairOf<float> {
  using type = float2;
};
template <typename T>
using pair_t = typename PairOf<T>::type;

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ uint32_t mk_pair(__nv_bfloat16 lo,
                                            __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ float2 mk_pair(float lo, float hi) {
  return make_float2(lo, hi);
}

// two f32 values rounded to T (round to nearest even, as torch's cast)
template <typename T>
__device__ __forceinline__ pair_t<T> round_pair(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t round_pair<__nv_bfloat16>(float lo,
                                                              float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ float2 round_pair<float>(float lo, float hi) {
  return make_float2(lo, hi);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float lo,
                                           float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void store_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// D (16x8, f32) += A (16x16) B (16x8) in the m16n8k16 fragment layout
// (lane = 4 * g + t): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..],
// a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..]; b[0] = B[2t..2t+1][g],
// b[1] = B[2t+8..2t+9][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float pick(const float2& v, int e) {
  return e ? v.y : v.x;
}

// the same product in f32 on the CUDA cores: each lane fetches the A row
// and B column elements it needs from their owner lanes, k in order
__device__ __forceinline__ void mma(float (&d)[4], const float2 (&a)[4],
                                    const float2 (&b)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int hi = k >> 3, src = (k & 7) >> 1, e = k & 1;
    const float a_g = __shfl_sync(kFull, pick(a[hi ? 2 : 0], e),
                                  g * 4 + src);
    const float a_g8 = __shfl_sync(kFull, pick(a[hi ? 3 : 1], e),
                                   g * 4 + src);
    const float b_n0 = __shfl_sync(kFull, pick(b[hi], e), (2 * t) * 4 + src);
    const float b_n1 = __shfl_sync(kFull, pick(b[hi], e),
                                   (2 * t + 1) * 4 + src);
    d[0] = fmaf(a_g, b_n0, d[0]);
    d[1] = fmaf(a_g, b_n1, d[1]);
    d[2] = fmaf(a_g8, b_n0, d[2]);
    d[3] = fmaf(a_g8, b_n1, d[3]);
  }
}

// A (16x16) from a row-major shared tile: A[m][k] = X[r0 + m][c0 + k]
template <typename T, int LD>
__device__ __forceinline__ void load_a(pair_t<T> (&a)[4], const T* X,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = X + (r0 + g) * LD + c0 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * LD);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * LD + 8);
}

// B (16x8) whose columns are tile rows: B[k][n] = X[n0 + n][k0 + k]
template <typename T, int LD>
__device__ __forceinline__ void load_b_nrows(pair_t<T> (&b)[2], const T* X,
                                             int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = X + (n0 + g) * LD + k0 + 2 * t;
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}

// B (16x8) whose rows are tile rows: B[k][n] = X[k0 + k][n0 + n]
template <typename T, int LD>
__device__ __forceinline__ void load_b_krows(pair_t<T> (&b)[2], const T* X,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = X + (k0 + 2 * t) * LD + n0 + g;
  b[0] = mk_pair(p[0], p[LD]);
  b[1] = mk_pair(p[8 * LD], p[9 * LD]);
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

// rows row0 .. row0 + ROWS - 1 of one (b, h) into a [ROWS][LD] shared
// tile, 16 bytes a thread; rows at or past L read as zeros
template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long sl, int row0, int L) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    int4 x = make_int4(0, 0, 0, 0);
    if (row0 + r < L)
      x = *reinterpret_cast<const int4*>(src + (row0 + r) * sl + c);
    *reinterpret_cast<int4*>(dst + r * LD + c) = x;
  }
}

// the segment ids of rows row0 .. row0 + ROWS - 1 into shared memory
template <int ROWS>
__device__ __forceinline__ void load_seg(int* dst, const int* segb, int row0,
                                         int L) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads)
    dst[i] = row0 + i < L ? segb[row0 + i] : 0;
}

template <typename T, int D>
struct Geo {
  static constexpr int LD = D + 16 / sizeof(T);  // padded row: no conflicts
};

// -- forward ---------------------------------------------------------------
template <typename T, int D, bool kCausal, bool kDrop, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(View q, View k, View v, View o, float* __restrict__ lse,
                     int L, int Lk, int H, float scale, Mask mk) {
  constexpr int LD = Geo<T, D>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBM * LD;
  T* sV = sK + kBN * LD;
  int* sSeg = reinterpret_cast<int*>(sV + kBN * LD);  // the tile's key ids
  const int n_blk = (L + kBM - 1) / kBM;
  const int q0 = (kCausal ? n_blk - 1 - blockIdx.x : blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* kp = base<const T>(k, b, h);
  const T* vp = base<const T>(v, b, h);
  load_tile<T, kBM, D, LD>(sQ, base<const T>(q, b, h), q.sl, q0, L);

  const bool seg_on = kSeg && mk.seg != nullptr;
  const bool drop_on = kDrop && mk.thresh != 0u;
  const int n32 = (L + kChunk - 1) / kChunk;
  const int* segb = seg_on ? mk.seg + b * mk.seg_sb : nullptr;
  const int* rng = seg_on ? mk.seg_rng + 2LL * b * n32 : nullptr;
  int seg_row[2] = {0, 0}, q_lo = 0, q_hi = 0;
  if (seg_on) {
#pragma unroll
    for (int i = 0; i < 2; ++i) seg_row[i] = row[i] < L ? segb[row[i]] : 0;
    chunk_range(rng, q0 / kChunk, n32, q_lo, q_hi);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // causal: row i sees keys j <= i + off (off = Lk - L: a cache step or
  // a chunk against its history); a row with none keeps zeros
  const int off = Lk - L;
  const int kv_end = kCausal ? max(0, min(Lk, q0 + kBM + off)) : Lk;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    if (seg_on) {  // uniform: every thread reads the same ranges
      int lo, hi;
      chunk_range(rng, k0 / kChunk, n32, lo, hi);
      if (hi < q_lo || lo > q_hi) continue;
    }
    __syncthreads();  // the previous tile is consumed
    load_tile<T, kBN, D, LD>(sK, kp, k.sl, k0, Lk);
    load_tile<T, kBN, D, LD>(sV, vp, v.sl, k0, Lk);
    if (seg_on) load_seg<kBN>(sSeg, segb, k0, L);
    __syncthreads();
    const uint32_t keep =
        drop_on ? keep_bits_qrows<kBN / 8>(load_key(mk.key, mk.thresh), bh,
                                           row, k0)
                : kFull;

    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      pair_t<T> a[4];
      load_a<T, LD>(a, sQ, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        pair_t<T> bb[2];
        load_b_nrows<T, LD>(bb, sK, n * 8, kk * 16);
        mma(s[n], a, bb);
      }
    }

    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), col = k0 + c;
        const bool ok = col < Lk && (!kCausal || col <= row[e >> 1] + off) &&
                        (!seg_on || sSeg[c] == seg_row[e >> 1]);
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = quad_max(m_new[i]);
      alpha[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), col = k0 + c;
        const bool ok = col < Lk && (!kCausal || col <= row[e >> 1] + off) &&
                        (!seg_on || sSeg[c] == seg_row[e >> 1]);
        // re-masked: a row whose columns are all masked so far has
        // s == m_new == -1e30 and exp() == 1
        const float p = ok ? expf(s[n][e] - m_new[e >> 1]) : 0.f;
        rs[e >> 1] += p;  // l is the undropped row sum
        s[n][e] = (keep >> (4 * n + e)) & 1u ? p : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = alpha[i] * l[i] + quad_sum(rs[i]);
      m[i] = m_new[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pair_t<T> a[4];  // keep o P, rounded to V's dtype
      a[0] = round_pair<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = round_pair<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = round_pair<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = round_pair<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        pair_t<T> bb[2];
        load_b_krows<T, LD>(bb, sV, kk * 16, n * 8);
        mma(acc[n], a, bb);
      }
    }
  }

  // x * 1.0f == x: without dropout the output is what it always was
  const float sc = drop_on ? mk.inv_keep : 1.f;
  T* op = base<T>(o, b, h);
  float* lp = lse + static_cast<long long>(bh) * L;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= L) continue;
    const float lm = fmaxf(l[i], 1e-30f);
    T* dst = op + row[i] * o.sl + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair(dst + n * 8, acc[n][2 * i] * sc / lm,
                 acc[n][2 * i + 1] * sc / lm);
    if (t == 0) lp[row[i]] = m[i] + logf(lm);
  }
}

// -- dQ --------------------------------------------------------------------
template <typename T, int D, bool kCausal, bool kDrop, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(View q, View k, View v, View dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, View dq, int L,
                        int Lk, int H, float scale, Mask mk) {
  constexpr int LD = Geo<T, D>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kBM * LD;  // dO
  T* sK = sO + kBM * LD;
  T* sV = sK + kBN * LD;
  int* sSeg = reinterpret_cast<int*>(sV + kBN * LD);
  const int n_blk = (L + kBM - 1) / kBM;
  const int q0 = (kCausal ? n_blk - 1 - blockIdx.x : blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* kp = base<const T>(k, b, h);
  const T* vp = base<const T>(v, b, h);
  load_tile<T, kBM, D, LD>(sQ, base<const T>(q, b, h), q.sl, q0, L);
  load_tile<T, kBM, D, LD>(sO, base<const T>(dout, b, h), dout.sl, q0, L);
  const long long rbase = static_cast<long long>(bh) * L;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = row[i] < L ? lse[rbase + row[i]] : 0.f;
    dl_r[i] = row[i] < L ? delta[rbase + row[i]] : 0.f;
  }

  const bool seg_on = kSeg && mk.seg != nullptr;
  const bool drop_on = kDrop && mk.thresh != 0u;
  const int n32 = (L + kChunk - 1) / kChunk;
  const int* segb = seg_on ? mk.seg + b * mk.seg_sb : nullptr;
  const int* rng = seg_on ? mk.seg_rng + 2LL * b * n32 : nullptr;
  int seg_row[2] = {0, 0}, q_lo = 0, q_hi = 0;
  if (seg_on) {
#pragma unroll
    for (int i = 0; i < 2; ++i) seg_row[i] = row[i] < L ? segb[row[i]] : 0;
    chunk_range(rng, q0 / kChunk, n32, q_lo, q_hi);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // causal: row i sees keys j <= i + off (off = Lk - L: a cache step or
  // a chunk against its history); a row with none keeps zeros
  const int off = Lk - L;
  const int kv_end = kCausal ? max(0, min(Lk, q0 + kBM + off)) : Lk;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    if (seg_on) {
      int lo, hi;
      chunk_range(rng, k0 / kChunk, n32, lo, hi);
      if (hi < q_lo || lo > q_hi) continue;
    }
    __syncthreads();
    load_tile<T, kBN, D, LD>(sK, kp, k.sl, k0, Lk);
    load_tile<T, kBN, D, LD>(sV, vp, v.sl, k0, Lk);
    if (seg_on) load_seg<kBN>(sSeg, segb, k0, L);
    __syncthreads();
    const uint32_t keep =
        drop_on ? keep_bits_qrows<kBN / 8>(load_key(mk.key, mk.thresh), bh,
                                           row, k0)
                : kFull;

    float s[kBN / 8][4], dp[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      pair_t<T> aq[4], ao[4];
      load_a<T, LD>(aq, sQ, warp * 16, kk * 16);
      load_a<T, LD>(ao, sO, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        pair_t<T> bb[2];
        load_b_nrows<T, LD>(bb, sK, n * 8, kk * 16);
        mma(s[n], aq, bb);
        load_b_nrows<T, LD>(bb, sV, n * 8, kk * 16);
        mma(dp[n], ao, bb);
      }
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), col = k0 + c;
        const bool ok = col < Lk && (!kCausal || col <= row[e >> 1] + off) &&
                        (!seg_on || sSeg[c] == seg_row[e >> 1]);
        const float p = ok ? expf(scale * s[n][e] - lse_r[e >> 1]) : 0.f;
        float d = dp[n][e];
        if (drop_on) d = (keep >> (4 * n + e)) & 1u ? d * mk.inv_keep : 0.f;
        s[n][e] = p * (d - dl_r[e >> 1]) * scale;  // dS
      }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pair_t<T> a[4];  // dS, rounded to K's dtype
      a[0] = round_pair<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = round_pair<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = round_pair<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = round_pair<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        pair_t<T> bb[2];
        load_b_krows<T, LD>(bb, sK, kk * 16, n * 8);
        mma(acc[n], a, bb);
      }
    }
  }

  T* dp_out = base<T>(dq, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= L) continue;
    T* dst = dp_out + row[i] * dq.sl + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair(dst + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// -- dK / dV -----------------------------------------------------------------
template <typename T, int D, bool kCausal, bool kDrop, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(View q, View k, View v, View dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, View dk, View dv,
                         int L, int Lk, int H, float scale, Mask mk) {
  constexpr int LD = Geo<T, D>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBM * LD;
  T* sQ = sV + kBM * LD;
  T* sO = sQ + kBQ * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + kBQ * LD);
  float* sD = sL + kBQ;
  int* sSeg = reinterpret_cast<int*>(sD + kBQ);  // the tile's query ids
  const int k0 = blockIdx.x * kBM;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const T* qp = base<const T>(q, b, h);
  const T* op = base<const T>(dout, b, h);
  const long long rbase = static_cast<long long>(bh) * L;
  load_tile<T, kBM, D, LD>(sK, base<const T>(k, b, h), k.sl, k0, Lk);
  load_tile<T, kBM, D, LD>(sV, base<const T>(v, b, h), v.sl, k0, Lk);

  const bool seg_on = kSeg && mk.seg != nullptr;
  const bool drop_on = kDrop && mk.thresh != 0u;
  const int n32 = (L + kChunk - 1) / kChunk;
  const int* segb = seg_on ? mk.seg + b * mk.seg_sb : nullptr;
  const int* rng = seg_on ? mk.seg_rng + 2LL * b * n32 : nullptr;
  int seg_row[2] = {0, 0}, k_lo = 0, k_hi = 0;
  if (seg_on) {
#pragma unroll
    for (int i = 0; i < 2; ++i) seg_row[i] = row[i] < L ? segb[row[i]] : 0;
    chunk_range(rng, k0 / kChunk, n32, k_lo, k_hi);
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // causal: only the query tiles at or after this key block (less the
  // offset Lk - L of the diagonal) contribute
  const int off = Lk - L;
  const int i0 = kCausal ? max(k0 - off, 0) / kBQ : 0;
  const int n_q = (L + kBQ - 1) / kBQ;
  for (int i = i0; i < n_q; ++i) {
    const int q0 = i * kBQ;
    if (seg_on && (rng[2 * i + 1] < k_lo || rng[2 * i] > k_hi)) continue;
    __syncthreads();
    load_tile<T, kBQ, D, LD>(sQ, qp, q.sl, q0, L);
    load_tile<T, kBQ, D, LD>(sO, op, dout.sl, q0, L);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const bool in = q0 + r < L;
      sL[r] = in ? lse[rbase + q0 + r] : 0.f;
      sD[r] = in ? delta[rbase + q0 + r] : 0.f;
    }
    if (seg_on) load_seg<kBQ>(sSeg, segb, q0, L);
    __syncthreads();
    const uint32_t keep =
        drop_on ? keep_bits_krows<kBQ / 8>(load_key(mk.key, mk.thresh), bh,
                                         k0 + warp * 16, q0)
                : kFull;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys
    float s[kBQ / 8][4], dp[kBQ / 8][4];
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      pair_t<T> ak[4], av[4];
      load_a<T, LD>(ak, sK, warp * 16, kk * 16);
      load_a<T, LD>(av, sV, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        pair_t<T> bb[2];
        load_b_nrows<T, LD>(bb, sQ, n * 8, kk * 16);
        mma(s[n], ak, bb);
        load_b_nrows<T, LD>(bb, sO, n * 8, kk * 16);
        mma(dp[n], av, bb);
      }
    }
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);  // query column in the tile
        const bool ok = q0 + c < L &&
                        (!kCausal || q0 + c + off >= row[e >> 1]) &&
                        (!seg_on || sSeg[c] == seg_row[e >> 1]);
        const float p = ok ? expf(scale * s[n][e] - sL[c]) : 0.f;
        float pd = p, d = dp[n][e];
        if (drop_on) {
          const bool kept = (keep >> (4 * n + e)) & 1u;
          pd = kept ? p * mk.inv_keep : 0.f;
          d = kept ? d * mk.inv_keep : 0.f;
        }
        s[n][e] = pd;                          // dropped P^T, for dV
        dp[n][e] = p * (d - sD[c]) * scale;    // dS^T
      }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      pair_t<T> ap[4], as[4];  // P^T and dS^T, rounded to the input dtype
      ap[0] = round_pair<T>(s[2 * kk][0], s[2 * kk][1]);
      ap[1] = round_pair<T>(s[2 * kk][2], s[2 * kk][3]);
      ap[2] = round_pair<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      ap[3] = round_pair<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      as[0] = round_pair<T>(dp[2 * kk][0], dp[2 * kk][1]);
      as[1] = round_pair<T>(dp[2 * kk][2], dp[2 * kk][3]);
      as[2] = round_pair<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      as[3] = round_pair<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        pair_t<T> bb[2];
        load_b_krows<T, LD>(bb, sO, kk * 16, n * 8);
        mma(dv_acc[n], ap, bb);
        load_b_krows<T, LD>(bb, sQ, kk * 16, n * 8);
        mma(dk_acc[n], as, bb);
      }
    }
  }

  T* dkp = base<T>(dk, b, h);
  T* dvp = base<T>(dv, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Lk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store_pair(dkp + row[i] * dk.sl + n * 8 + 2 * t, dk_acc[n][2 * i],
                 dk_acc[n][2 * i + 1]);
      store_pair(dvp + row[i] * dv.sl + n * 8 + 2 * t, dv_acc[n][2 * i],
                 dv_acc[n][2 * i + 1]);
    }
  }
}

// -- launch ------------------------------------------------------------------
struct Args {
  const View* views;  // q, k, v, dout?, outputs...
  const float* lse_in;
  const float* delta;
  float* lse_out;
  int B, L, Lk, H;
  float scale;
  Mask mask;
  cudaStream_t stream;
};

template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int D, bool C, bool kDrop, bool kSeg>
int launch_fwd(const Args& a) {
  constexpr int LD = Geo<T, D>::LD;
  const size_t smem = static_cast<size_t>(kBM + 2 * kBN) * LD * sizeof(T) +
                      kBN * sizeof(int);
  auto kern = flash_fwd_kernel<T, D, C, kDrop, kSeg>;
  if (int rc = prepare(kern, smem)) return rc;
  const dim3 grid((a.L + kBM - 1) / kBM, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(a.views[0], a.views[1],
                                           a.views[2], a.views[3],
                                           a.lse_out, a.L, a.Lk, a.H,
                                           a.scale, a.mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool C, bool kDrop, bool kSeg>
int launch_dq(const Args& a) {
  constexpr int LD = Geo<T, D>::LD;
  const size_t smem =
      static_cast<size_t>(2 * kBM + 2 * kBN) * LD * sizeof(T) +
      kBN * sizeof(int);
  auto kern = flash_bwd_dq_kernel<T, D, C, kDrop, kSeg>;
  if (int rc = prepare(kern, smem)) return rc;
  const dim3 grid((a.L + kBM - 1) / kBM, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      a.views[0], a.views[1], a.views[2], a.views[3], a.lse_in, a.delta,
      a.views[4], a.L, a.Lk, a.H, a.scale, a.mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool C, bool kDrop, bool kSeg>
int launch_dkv(const Args& a) {
  constexpr int LD = Geo<T, D>::LD;
  const size_t smem = static_cast<size_t>(2 * kBM + 2 * kBQ) * LD * sizeof(T) +
                      2 * kBQ * sizeof(float) + kBQ * sizeof(int);
  auto kern = flash_bwd_dkv_kernel<T, D, C, kDrop, kSeg>;
  if (int rc = prepare(kern, smem)) return rc;
  const dim3 grid((a.Lk + kBM - 1) / kBM, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      a.views[0], a.views[1], a.views[2], a.views[3], a.lse_in, a.delta,
      a.views[4], a.views[5], a.L, a.Lk, a.H, a.scale, a.mask);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D, bool C, bool kDrop, bool kSeg>
int launch(int which, const Args& a) {
  switch (which) {
    case kFwd:
      return launch_fwd<T, D, C, kDrop, kSeg>(a);
    case kDq:
      return launch_dq<T, D, C, kDrop, kSeg>(a);
    default:
      return launch_dkv<T, D, C, kDrop, kSeg>(a);
  }
}

// The instance for the launch's flags. A runtime check of a flag that is
// off still slows the bf16 hot loop, so bf16 has one instance per
// (dropout, segments) pair and the plain one is the kernel without
// either; the f32 kernels, the CUDA-core check of the same indices and
// masks, keep one instance with runtime flags (their builds are the slow
// ones).
template <typename T, int D, bool C>
int launch_flags(int which, const Args& a) {
  const bool drop = a.mask.thresh != 0u, segm = a.mask.seg != nullptr;
  if (std::is_same<T, float>::value || (drop && segm))
    return launch<T, D, C, true, true>(which, a);
  if constexpr (!std::is_same<T, float>::value) {
    if (drop) return launch<T, D, C, true, false>(which, a);
    if (segm) return launch<T, D, C, false, true>(which, a);
    return launch<T, D, C, false, false>(which, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
constexpr int dtype_code();
template <>
constexpr int dtype_code<float>() {
  return kF32;
}
template <>
constexpr int dtype_code<__nv_bfloat16>() {
  return kBF16;
}

int dispatch(int which, void* const* ptrs, int n_views,
             const long long* strides, const float* lse_in,
             const float* delta, float* lse_out, int B, int L, int Lk, int H,
             int D, int causal, float scale, int dtype, const int* seg,
             long long seg_sb, const int* seg_rng, const long long* key,
             uint32_t thresh, float inv_keep, void* stream) {
  using T = FLASH_DTYPE;
  constexpr int kD = FLASH_HEAD_DIM;
  // this library holds one (dtype, head dim): anything else is refused
  if (dtype != dtype_code<T>() || D != kD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0 || Lk <= 0 || H <= 0) return 0;
  // segment ids index queries and keys alike: one length
  if ((seg != nullptr && Lk != L) ||
      (seg == nullptr) != (seg_rng == nullptr) ||
      (thresh != 0u && key == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  View views[6];
  for (int i = 0; i < n_views; ++i)
    views[i] = View{ptrs[i], strides[3 * i], strides[3 * i + 1],
                    strides[3 * i + 2]};
  const Mask mask{seg, seg_sb, seg_rng, key, thresh, inv_keep};
  const Args a{views, lse_in, delta, lse_out, B, L, Lk, H, scale, mask,
               static_cast<cudaStream_t>(stream)};
  return causal ? launch_flags<T, kD, true>(which, a)
                : launch_flags<T, kD, false>(which, a);
}

}  // namespace

// Plain C entry points, bound with ctypes. Tensors are [B, L, H, D] views
// (k, v, dk, dv [B, Lk, H, D]: keys may outnumber or trail the queries)
// with a contiguous head dim, 16-byte-aligned rows and their own element
// strides (batch, seq, head) in `strides`, three per view in argument
// order; lse and delta are contiguous f32 [B, H, L]. Causal, query row i
// sees the keys j <= i + Lk - L. The caller allocates
// the outputs. `seg` ([B, L] int32, batch stride seg_sb) and `seg_rng`
// ([B, ceil(L / 32), 2] int32) are both null without segments; `thresh`
// is 0 without dropout (`key` is then not read), else the keep threshold
// with the Philox key at `key` (int64 [2] in device memory: two unsigned
// 32-bit words) and inv_keep = 1 / (1 - p). Each returns 0 or the
// cudaError_t of the launch (cudaErrorInvalidValue for a dtype or head
// dim this library does not hold).
extern "C" int flash_attention_forward(
    void* q, void* k, void* v, void* out, float* lse,
    const long long* strides, int B, int L, int Lk, int H, int D,
    int causal, float scale, int dtype, const int* seg, long long seg_sb,
    const int* seg_rng, const long long* key, uint32_t thresh,
    float inv_keep, void* stream) {
  void* ptrs[4] = {q, k, v, out};
  return dispatch(kFwd, ptrs, 4, strides, nullptr, nullptr, lse, B, L, Lk,
                  H, D, causal, scale, dtype, seg, seg_sb, seg_rng, key,
                  thresh, inv_keep, stream);
}

extern "C" int flash_attention_backward_dq(
    void* q, void* k, void* v, void* dout, const float* lse,
    const float* delta, void* dq, const long long* strides, int B, int L,
    int Lk, int H, int D, int causal, float scale, int dtype, const int* seg,
    long long seg_sb, const int* seg_rng, const long long* key,
    uint32_t thresh, float inv_keep, void* stream) {
  void* ptrs[5] = {q, k, v, dout, dq};
  return dispatch(kDq, ptrs, 5, strides, lse, delta, nullptr, B, L, Lk, H,
                  D, causal, scale, dtype, seg, seg_sb, seg_rng, key, thresh,
                  inv_keep, stream);
}

extern "C" int flash_attention_backward_dkv(
    void* q, void* k, void* v, void* dout, const float* lse,
    const float* delta, void* dk, void* dv, const long long* strides, int B,
    int L, int Lk, int H, int D, int causal, float scale, int dtype,
    const int* seg, long long seg_sb, const int* seg_rng,
    const long long* key, uint32_t thresh, float inv_keep, void* stream) {
  void* ptrs[6] = {q, k, v, dout, dk, dv};
  return dispatch(kDkv, ptrs, 6, strides, lse, delta, nullptr, B, L, Lk, H,
                  D, causal, scale, dtype, seg, seg_sb, seg_rng, key, thresh,
                  inv_keep, stream);
}
