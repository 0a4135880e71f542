// Block-table paged attention for Hopper (sm_90a): the history split
// across CTAs, pages streamed through a shared-memory ring, and the
// products of 4 or more query rows a KV head on the tensor cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (_kernel, launched by _paged_attention_call) for bf16 queries over
// bf16 or int8 pools, head dim 64 or 128, block sizes that are multiples
// of 16 up to 128: the calls ops/kernels/paged_attention.py's takes_split
// accepts. Every other call (f32 q or pools, other block sizes) keeps the
// first design, csrc/paged_attention.cu, whose note states the contract
// both meet: q [S, T, H, D] against pool blocks [NB, bs, KVH, D] through
// tables [S, MB] (entry < 0 clamps to block 0), row (s, t) attending
// columns c <= positions[s, t], query head h = kvh * R + r on KV head kvh,
// int8 codes with f32 scales [NB, bs, KVH], nan_to_num on every loaded
// value, masked columns contributing exactly zero, tiles at or past
// *n_tiles (a device int32) skipped. The plain walk beside the wrapper
// (paged_attention_reference) is the oracle;
// paged_attention_split_reference walks the same spans and merges them
// by this kernel's rule.
//
// What bounds it. Every serve geometry is bound by device-memory bytes:
// a decode row does ~1 flop per K/V byte, a 64-row prefill chunk 64,
// against the ~295 at which the card's bf16 tensor cores would become
// the limit. So the design is about bytes in flight and balance; wgmma's
// rate buys nothing here, and mma.sync (m16n8k16) is enough for the
// products.
//
// Design.
// - Work unit: (slot, KV head, group of query rows, span of `span`
//   columns); grid (S * KVH * row groups, ceil(MB * bs / span)), sized
//   from shapes alone, the last spans dispatched first (the grid ends on
//   span 0 of every unit, side by side, not on a long history's last
//   spans alone). A CTA reads its rows' positions and *n_tiles and
//   exits at once when its span starts past the last column its rows
//   need; nothing of the device data reaches the host, so a launch can
//   be captured in a CUDA graph and replayed with new positions.
// - Ring: the span's table entries are read once into shared memory
//   (one per 16 columns: a 16-column chunk never crosses a page). Each
//   stage holds 32 columns of K and V of one KV head (rows KVH * D
//   apart in the pool), copied with cp.async 16 bytes a thread (int8
//   scales 4 bytes a column); kStages - 1 stages are in flight while one
//   is computed (kStages: 2 on the CUDA-core path, which runs several
//   CTAs an SM; 4 on the tensor-core path, one or two CTAs an SM).
//   Columns past the span's live end are zero-filled.
// - Products, fewer than 4 rows a KV head (MHA decode, short MHA verify
//   windows): f32 dots on the CUDA cores, 128 threads, groups of 1 or 4
//   rows. Each warp takes 8 columns of a stage; four lanes share a
//   column's QK dot (16-byte vectors, rotated by column so the two
//   columns of a quarter-warp hit disjoint banks), and for PV each lane
//   owns D / 32 output dims. Each warp keeps its own online softmax; the
//   four merge in shared memory at the span's end.
// - Products, 4 or more rows a KV head (prefill chunks, GQA decode and
//   verify windows): mma.sync m16n8k16 on the tensor cores, 64-row
//   groups, 256 threads: warp w takes rows 16 (w % 4) ... and columns
//   16 (w / 4) ... of each stage, with its own online softmax; the two
//   column halves merge at the end. Q (in shared memory), K and V reach
//   the products through ldmatrix on 16-byte padded rows (conflict-free),
//   and at most 128 registers a thread let two CTAs share an SM. P enters
//   PV as a bf16 hi + lo pair (two products), so its f32 value survives
//   to ~2^-17. The tensor cores were faster from 4 rows up, the CUDA
//   cores below (paged_variants.py).
// - Numerics: q and bf16 K/V are exact as bf16 operands; int8 codes are
//   exact in bf16 and f32, and their scales are applied in f32 outside
//   the products: the K scale on each score column, the V scale on p,
//   which is then re-masked so a masked column stays exactly zero even
//   with a non-finite scale. bf16 values are sanitised as torch's
//   nan_to_num does on a bf16 tile (NaN -> 0, +-inf -> +-bf16 max)
//   before any product; the tensor-core path does it once a stage in
//   shared memory, rewriting only a vector that holds a non-finite value.
//   Softmax runs in base 2 (the scores carry log2(e) / sqrt(D)).
// - Merge in the same launch: a group whose live columns fit one span
//   writes its output directly. Otherwise each CTA writes its (m, l, acc)
//   in f32 to scratch the wrapper allocates, and the last CTA to take a
//   ticket (an atomic counter per unit, left at zero by that CTA, so no
//   memset runs per call) combines them: M = max m_i, w_i = 2^(m_i - M),
//   out = sum w_i acc_i / max(sum w_i l_i, 1e-30). A span with no live
//   column (m = -1e30, l = 0, acc = 0) adds exactly zero; a row with no
//   live column at all writes 0.
// A live column whose int8 scale is not finite is outside what the
// kernel matches (the walk sanitises code * scale; here the scale is
// sanitised alone).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>
#include <type_traits>

#include "hopper.cuh"

namespace {

// ring depths: the CUDA-core path runs several CTAs an SM, the tensor-core
// path one or two, which need more bytes in flight each
constexpr int kDotStages = 2;
constexpr int kMmaStages = 4;
constexpr int kThreads = 128;          // a CUDA-core CTA: four warps
constexpr int kMmaThreads = 256;       // a tensor-core CTA: eight warps
constexpr int kCols = 32;              // columns a ring stage holds
constexpr int kChunk = 16;             // columns one table entry covers
constexpr int kMaxSpan = 2048;         // columns a CTA walks at most
constexpr int kMaxSpans = 64;          // spans of a unit at most
constexpr int kMmaRows = 64;           // rows of a tensor-core group
constexpr int kHeadInts = kMaxSpan / kChunk + 2 * kMmaRows + 16;
constexpr int kFlag = 12;  // red_s[0 .. 7]: per-warp maxima; [kFlag]: last
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kMaxSpan / kChunk <= kThreads, "a table entry a thread");
static_assert(kMaxSpan % kCols == 0 && kCols % kChunk == 0, "stages");

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Params {
  const __nv_bfloat16* q;
  const unsigned char* k_pool;
  const unsigned char* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* positions;
  const int* n_tiles;
  __nv_bfloat16* out;
  float* part;   // [units, n_span_max, G, D]: each span's acc
  float* ml;     // [units, n_span_max, G, 2]: each span's (m, l)
  int* tickets;  // [units]: zero between launches
  int T, H, KVH, R, bs, MB, NB, span, n_rg, n_span_max;
  float qk_scale;  // log2(e) / sqrt(D)
};

// One CTA's unit and span, and its span's live columns [c0, c0 + len).
struct Unit {
  int unit, span, s, kvh, row0, nrows, n_spans, c0, len;
};

// -- small helpers -----------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// numpy's nan_to_num for float32: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float x) {
  return x == x ? fminf(fmaxf(x, -3.402823466e38f), 3.402823466e38f) : 0.f;
}

// The top bit of each half of a bf16 pair whose value is not finite.
__device__ __forceinline__ uint32_t nonfinite_bf16x2(uint32_t u) {
  return ((u & 0x7fff7fffu) + 0x00800080u) & 0x80008000u;
}

// nan_to_num on a bf16 pair as torch does it on a bf16 tensor: NaN -> 0,
// +-inf -> +-bf16 max (0x7f7f).
__device__ __forceinline__ uint32_t sanitize_bf16x2(uint32_t u) {
  const uint32_t a = u & 0x7fff7fffu;
  const uint32_t em = (((a + 0x00800080u) & 0x80008000u) >> 15) * 0xffffu;
  const uint32_t nm = (((a + 0x007f007fu) & 0x80008000u) >> 15) * 0xffffu;
  const uint32_t big = (u & 0x80008000u) | 0x7f7f7f7fu;
  return ((u & ~em) | (big & em)) & ~nm;
}

// Byte i of x (an int8 code) as f32: (code + 128) in the mantissa of
// 2^23, less 2^23 + 128; x8 is x ^ 0x80808080.
template <int i>
__device__ __forceinline__ float code_f32(uint32_t x8) {
  return __int_as_float(__byte_perm(x8, 0x4b000000u, 0x7650 + i)) -
         8388736.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int W>
struct alignas(4 * W) Words {
  uint32_t w[W];
};

// N consecutive pool values at src (16/8/4/2-byte aligned) as f32,
// sanitised when bf16.
template <typename KVT, int N>
__device__ __forceinline__ void load_vals(const unsigned char* src,
                                          float* out) {
  if constexpr (std::is_same<KVT, __nv_bfloat16>::value) {
    constexpr int W = N / 2;
    Words<W> x = *reinterpret_cast<const Words<W>*>(src);
    uint32_t bad = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) bad |= nonfinite_bf16x2(x.w[i]);
    if (bad) {
#pragma unroll
      for (int i = 0; i < W; ++i) x.w[i] = sanitize_bf16x2(x.w[i]);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      out[2 * i] = __uint_as_float(x.w[i] << 16);
      out[2 * i + 1] = __uint_as_float(x.w[i] & 0xffff0000u);
    }
  } else if constexpr (N == 2) {
    const uint32_t x8 =
        *reinterpret_cast<const uint16_t*>(src) ^ 0x8080u;
    out[0] = code_f32<0>(x8);
    out[1] = code_f32<1>(x8);
  } else {
    constexpr int W = N / 4;
    const Words<W> x = *reinterpret_cast<const Words<W>*>(src);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t x8 = x.w[i] ^ 0x80808080u;
      out[4 * i] = code_f32<0>(x8);
      out[4 * i + 1] = code_f32<1>(x8);
      out[4 * i + 2] = code_f32<2>(x8);
      out[4 * i + 3] = code_f32<3>(x8);
    }
  }
}

// -- cp.async, ldmatrix, mma.sync -------------------------------------------

// 16 bytes into shared memory; zeros when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- shared-memory layout ----------------------------------------------------

// head: table chunks (tok_s), row positions (pos_s), output rows (orow_s),
// per-warp maxima and the last-CTA flag (red_s); then the query rows;
// then the work region: the ring (+ the int8 tensor-core path's bf16
// tile), reused after the walk for the merge.
template <typename KVT, int D, int G>
struct Layout {
  static constexpr bool kI8 = std::is_same<KVT, int8_t>::value;
  static constexpr bool kMma = G == kMmaRows;
  static constexpr int kStages = kMma ? kMmaStages : kDotStages;
  static constexpr int kRowB = D * (int)sizeof(KVT) + (kMma ? 16 : 0);
  static constexpr int kStageB = 2 * kCols * kRowB + (kI8 ? 2 * kCols * 4 : 0);
  static constexpr int kTileRowB = 2 * D + 16;  // the bf16 tile's rows
  static constexpr int kConvB = kMma && kI8 ? 2 * kCols * kTileRowB : 0;
  // the query rows: f32 for the dot path, bf16 on padded rows for ldmatrix
  static constexpr int kQRowB = 2 * D + 16;
  static constexpr int kQB = kMma ? G * kQRowB : G * D * 4;
  static constexpr int kWorkOff = (kHeadInts * 4 + kQB + 127) / 128 * 128;
  // merge floats: the CTA's acc (where the last CTA later reads every
  // span's (m, l)) and (m, l), and the per-warp states (CUDA cores) or
  // the second column half's (tensor cores) merged into them
  static constexpr int kAccF = G * D > 2 * kMaxSpans * G ? G * D
                                                         : 2 * kMaxSpans * G;
  static constexpr int kMergeB =
      4 * ((kMma ? 4 * G + G * D : 4 * (2 * G + G * D)) + 2 * G + kAccF);
  static constexpr int kRingB = kStages * kStageB + kConvB;
  static constexpr int kSmem =
      kWorkOff + (kRingB > kMergeB ? kRingB : kMergeB);
};

// -- the parts both paths share ---------------------------------------------

// The CTA's unit and span from blockIdx alone (no device data).
template <int G>
__device__ __forceinline__ Unit unit_of(const Params& p) {
  Unit u;
  u.unit = blockIdx.x;
  // the last spans, live only for the longest histories, go first: the
  // grid ends on span 0 of every unit, many CTAs side by side, instead of
  // on a few long histories' last spans
  u.span = gridDim.y - 1 - blockIdx.y;
  const int rg = u.unit % p.n_rg, sk = u.unit / p.n_rg;
  u.kvh = sk % p.KVH;
  u.s = sk / p.KVH;
  u.row0 = rg * G;
  u.nrows = min(G, p.T * p.R - u.row0);
  u.c0 = u.span * p.span;
  return u;
}

// The query row r of the group: its row of q and out, [S * T * H].
__device__ __forceinline__ int q_row(const Params& p, const Unit& u, int r) {
  const int row = u.row0 + r;
  return (u.s * p.T + row / p.R) * p.H + u.kvh * p.R + row % p.R;
}

// Reads the group's positions, *n_tiles and the span's table entries,
// all at once (one round trip), then the span's live columns. Returns
// false (for the whole CTA) when the span holds no live column; span 0
// always runs, so a group with no live column writes its zeros.
template <int G>
__device__ __forceinline__ bool prologue(const Params& p, Unit& u, int* tok_s,
                                         int* pos_s, int* orow_s,
                                         int* red_s) {
  const int tid = threadIdx.x;
  int pos = -1;
  if (tid < u.nrows) pos = p.positions[u.s * p.T + (u.row0 + tid) / p.R];
  const int n_tiles = *p.n_tiles;
  // one entry per 16 columns of the span (at most kMaxSpan / kChunk)
  const int col = u.c0 + tid * kChunk, tile = col / p.bs;
  int phys = 0;
  if (tid * kChunk < p.span && tile < p.MB)
    phys = p.tables[(size_t)u.s * p.MB + tile];
  if (tid < G) {
    pos_s[tid] = pos;
    if (tid < u.nrows) orow_s[tid] = q_row(p, u, tid);
  }
  phys = phys < 0 ? 0 : (phys >= p.NB ? p.NB - 1 : phys);
  if (tid < kMaxSpan / kChunk) tok_s[tid] = phys * p.bs + col % p.bs;
  pos = __reduce_max_sync(0xffffffffu, pos);
  if ((tid & 31) == 0) red_s[tid >> 5] = pos;
  __syncthreads();
  int max_pos = -1;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) max_pos = max(max_pos, red_s[w]);
  const int n_live = max(0, min(n_tiles, p.MB));
  const int n_cols = max(0, min(n_live * p.bs, max_pos + 1));
  u.n_spans = (n_cols + p.span - 1) / p.span;
  u.len = max(0, min(p.span, n_cols - u.c0));
  return u.span < max(u.n_spans, 1);
}

// Copies stage st (span columns st * kCols ...) of K, V (and the int8
// scales) into the ring stage at stg; columns past the live end are zeros.
template <typename KVT, int D, int kRowB>
__device__ __forceinline__ void issue_stage(const Params& p, const Unit& u,
                                            const int* tok_s,
                                            unsigned char* stg, int st) {
  constexpr int kVecRow = D * (int)sizeof(KVT) / 16;
  constexpr size_t kHeadB = (size_t)D * sizeof(KVT);
  const uint32_t dst = smem_u32(stg);
  const int nt = blockDim.x;
  const size_t tok_b = (size_t)p.KVH * kHeadB;
  const size_t head_off = (size_t)u.kvh * kHeadB;
  for (int i = threadIdx.x; i < kCols * kVecRow; i += nt) {
    const int c = i / kVecRow, v = i % kVecRow;
    const int lc = st * kCols + c;
    const bool ok = lc < u.len;
    const int tok = ok ? tok_s[lc / kChunk] + lc % kChunk : 0;
    const size_t off = (size_t)tok * tok_b + head_off + v * 16;
    cp_async16(dst + c * kRowB + v * 16, p.k_pool + off, ok);
    cp_async16(dst + (kCols + c) * kRowB + v * 16, p.v_pool + off, ok);
  }
  if constexpr (std::is_same<KVT, int8_t>::value) {
    for (int c = threadIdx.x; c < kCols; c += nt) {
      const int lc = st * kCols + c;
      const bool ok = lc < u.len;
      const int tok = ok ? tok_s[lc / kChunk] + lc % kChunk : 0;
      const size_t si = (size_t)tok * p.KVH + u.kvh;
      cp_async4(dst + 2 * kCols * kRowB + 4 * c, p.k_scale + si, ok);
      cp_async4(dst + 2 * kCols * kRowB + 4 * (kCols + c), p.v_scale + si,
                ok);
    }
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// Writes the rows' output from the CTA's state (m_s, l_s, acc_s), or,
// when the unit has more than one live span, its partial state; then the
// last CTA of the unit to arrive combines every span's. ml_s may overlap
// acc_s (it is read only before the partial state is written).
template <int G, int D>
__device__ __forceinline__ void epilogue(const Params& p, const Unit& u,
                                         const int* orow_s, int* flag_s,
                                         const float* m_s, const float* l_s,
                                         const float* acc_s, float2* ml_s) {
  constexpr int kQ = D / 4;  // float4s a row
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n4 = u.nrows * kQ;
  const float4* acc4 = reinterpret_cast<const float4*>(acc_s);
  if (u.n_spans <= 1) {
    for (int i = tid; i < n4; i += nt) {
      const int r = i / kQ;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      const float4 a = acc4[i];
      store4(p.out + (size_t)orow_s[r] * D + 4 * (i % kQ),
             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
    return;
  }
  const size_t ubase = (size_t)u.unit * p.n_span_max * G;
  const size_t base = ubase + (size_t)u.span * G;
  float4* part4 = reinterpret_cast<float4*>(p.part + base * D);
  for (int i = tid; i < n4; i += nt) part4[i] = acc4[i];
  float2* ml2 = reinterpret_cast<float2*>(p.ml);
  for (int r = tid; r < u.nrows; r += nt)
    ml2[base + r] = make_float2(m_s[r], l_s[r]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag_s = atomicAdd(p.tickets + u.unit, 1) == u.n_spans - 1;
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  // every span's (m, l), in one pass of independent loads
  for (int i = tid; i < u.n_spans * G; i += nt)
    if (i % G < u.nrows) ml_s[i] = __ldcg(ml2 + ubase + i);
  __syncthreads();
  // per row: w_i = 2^(m_i - M) / sum_j l_j 2^(m_j - M), in place of m_i
  for (int r = tid; r < u.nrows; r += nt) {
    float m_all = kNegInf;
    for (int i = 0; i < u.n_spans; ++i) m_all = fmaxf(m_all, ml_s[i * G + r].x);
    float l_all = 0.f;
    for (int i = 0; i < u.n_spans; ++i) {
      const float f = ex2(ml_s[i * G + r].x - m_all);
      ml_s[i * G + r].x = f;
      l_all = fmaf(ml_s[i * G + r].y, f, l_all);
    }
    const float inv = 1.f / fmaxf(l_all, 1e-30f);
    for (int i = 0; i < u.n_spans; ++i) ml_s[i * G + r].x *= inv;
  }
  __syncthreads();
  // kB float4s a thread, four spans at a time: up to 4 kB loads in flight
  constexpr int kB = G * kQ >= 4 * kThreads ? 4 : 1;
  const float4* parts = reinterpret_cast<const float4*>(p.part + ubase * D);
  for (int i0 = tid; i0 < n4; i0 += kB * nt) {
    float4 o[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) o[b] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < u.n_spans; ++j) {
      float4 x[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int i = min(i0 + b * nt, n4 - 1);
        x[b] = __ldcg(parts + (size_t)j * G * kQ + i);
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float w = ml_s[j * G + min(i0 + b * nt, n4 - 1) / kQ].x;
        o[b].x = fmaf(w, x[b].x, o[b].x);
        o[b].y = fmaf(w, x[b].y, o[b].y);
        o[b].z = fmaf(w, x[b].z, o[b].z);
        o[b].w = fmaf(w, x[b].w, o[b].w);
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = i0 + b * nt;
      if (i < n4)
        store4(p.out + (size_t)orow_s[i / kQ] * D + 4 * (i % kQ), o[b]);
    }
  }
  if (tid == 0) p.tickets[u.unit] = 0;
}

// -- fewer than 16 rows: f32 dots on the CUDA cores --------------------------

template <typename KVT, int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
    paged_attention_split_kernel(const Params p) {
  using Lay = Layout<KVT, D, G>;
  constexpr bool kI8 = Lay::kI8;
  constexpr int kRowB = Lay::kRowB;
  constexpr int kVecRow = D * (int)sizeof(KVT) / 16;  // vectors a row
  constexpr int kE = 16 / (int)sizeof(KVT);           // values a vector
  constexpr int kNV = kVecRow / 4;  // vectors of a lane's K slice
  constexpr int kDims = D / 32;     // output dims a lane
  static_assert(kNV >= 1 && kVecRow % 4 == 0, "head dim");
  extern __shared__ __align__(128) unsigned char smem[];
  int* tok_s = reinterpret_cast<int*>(smem);
  int* pos_s = tok_s + kMaxSpan / kChunk;
  int* orow_s = pos_s + kMmaRows;
  int* red_s = orow_s + kMmaRows;
  float* q_s = reinterpret_cast<float*>(smem + kHeadInts * 4);
  unsigned char* work = smem + Lay::kWorkOff;

  Unit u = unit_of<G>(p);
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = r < u.nrows
                 ? __bfloat162float(p.q[(size_t)q_row(p, u, r) * D + i % D])
                 : 0.f;
  }
  if (!prologue<G>(p, u, tok_s, pos_s, orow_s, red_s)) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane >> 2, part = lane & 3;
  float m[G], l[G], acc[G][kDims];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < kDims; ++k) acc[r][k] = 0.f;
  }

  const int n_st = (u.len + kCols - 1) / kCols;
#pragma unroll
  for (int st = 0; st < Lay::kStages - 1; ++st) {
    if (st < n_st)
      issue_stage<KVT, D, kRowB>(p, u, tok_s, work + st * Lay::kStageB, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<Lay::kStages - 2>();
    __syncthreads();
    {
      const int nx = st + Lay::kStages - 1;
      if (nx < n_st)
        issue_stage<KVT, D, kRowB>(p, u, tok_s,
                                   work + (nx % Lay::kStages) * Lay::kStageB, nx);
      cp_async_commit();
    }
    const unsigned char* stg = work + (st % Lay::kStages) * Lay::kStageB;
    const int cs = 8 * warp + c;  // this lane's column of the stage
    const int lc = st * kCols + cs;
    const bool live = lc < u.len;
    const int col = u.c0 + lc;
    float kf[kNV * kE];
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      load_vals<KVT, kE>(stg + cs * kRowB + 16 * (4 * ((j + c) % kNV) + part),
                         kf + j * kE);
    float vf[8][kDims];
    const unsigned char* vrows = stg + kCols * kRowB;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      load_vals<KVT, kDims>(
          vrows + (8 * warp + cc) * kRowB + lane * kDims * sizeof(KVT),
          vf[cc]);
    float ks = 1.f, vs = 1.f;
    if constexpr (kI8) {
      const float* sc = reinterpret_cast<const float*>(vrows + kCols * kRowB);
      ks = nan_to_num(sc[cs]);
      vs = nan_to_num(sc[kCols + cs]);
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= u.nrows) break;
      float d2[2] = {0.f, 0.f};  // two chains of FMAs
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        const float4* qv = reinterpret_cast<const float4*>(
            q_s + r * D + (4 * ((j + c) % kNV) + part) * kE);
#pragma unroll
        for (int e = 0; e < kE / 4; ++e) {
          const float4 x = qv[e];
          float& d = d2[e & 1];
          d = fmaf(x.x, kf[j * kE + 4 * e], d);
          d = fmaf(x.y, kf[j * kE + 4 * e + 1], d);
          d = fmaf(x.z, kf[j * kE + 4 * e + 2], d);
          d = fmaf(x.w, kf[j * kE + 4 * e + 3], d);
        }
      }
      float dot = d2[0] + d2[1];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const bool ok = live && col <= pos_s[r];
      const float sc = ok ? dot * ks * p.qk_scale : kNegInf;
      float mt = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 4));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
      const float m_new = fmaxf(m[r], mt);
      // a fully masked row has sc == m_new == -1e30 and 2^0 == 1: p is
      // re-masked so its contribution is exactly zero
      const float pr = ok ? ex2(sc - m_new) : 0.f;
      const float corr = ex2(m[r] - m_new);
      float ps = pr + __shfl_xor_sync(0xffffffffu, pr, 4);
      ps += __shfl_xor_sync(0xffffffffu, ps, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l[r] = l[r] * corr + ps;
      const float pv = kI8 ? (ok ? pr * vs : 0.f) : pr;
#pragma unroll
      for (int k = 0; k < kDims; ++k) acc[r][k] *= corr;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float pc = __shfl_sync(0xffffffffu, pv, cc * 4);
#pragma unroll
        for (int k = 0; k < kDims; ++k)
          acc[r][k] = fmaf(pc, vf[cc][k], acc[r][k]);
      }
      m[r] = m_new;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four warps' states merge into the CTA's
  float* acc_s = reinterpret_cast<float*>(work);  // [G][D]
  float* wacc = acc_s + Lay::kAccF;               // [4][G][D]
  float* wm = wacc + 4 * G * D;                   // [4][G]
  float* wl = wm + 4 * G;                         // [4][G]
  float* m_s = wl + 4 * G;                        // [G]
  float* l_s = m_s + G;                           // [G]
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (lane == 0) {
      wm[warp * G + r] = m[r];
      wl[warp * G + r] = l[r];
    }
#pragma unroll
    for (int k = 0; k < kDims; ++k)
      wacc[(warp * G + r) * D + lane * kDims + k] = acc[r][k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < u.nrows * D; i += kThreads) {
    const int r = i / D;
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) m_all = fmaxf(m_all, wm[w * G + r]);
    float o = 0.f, l_all = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = ex2(wm[w * G + r] - m_all);
      o = fmaf(wacc[w * G * D + i], f, o);
      l_all = fmaf(wl[w * G + r], f, l_all);
    }
    acc_s[i] = o;
    if (i % D == 0) {
      m_s[r] = m_all;
      l_s[r] = l_all;
    }
  }
  __syncthreads();
  epilogue<G, D>(p, u, orow_s, red_s + kFlag, m_s, l_s, acc_s,
                 reinterpret_cast<float2*>(acc_s));
}

// -- 16 or more rows: mma.sync on the tensor cores ---------------------------

// bf16 stage: rewrite, in place, every 16-byte vector that holds a
// non-finite value (nan_to_num as on a bf16 tile)
template <int D, int kRowB>
__device__ __forceinline__ void sanitize_stage(unsigned char* stg) {
  constexpr int kVecRow = D / 8;
  for (int i = threadIdx.x; i < 2 * kCols * kVecRow; i += blockDim.x) {
    uint4* v = reinterpret_cast<uint4*>(stg + (i / kVecRow) * kRowB +
                                        16 * (i % kVecRow));
    uint4 x = *v;
    if (nonfinite_bf16x2(x.x) | nonfinite_bf16x2(x.y) |
        nonfinite_bf16x2(x.z) | nonfinite_bf16x2(x.w)) {
      x.x = sanitize_bf16x2(x.x);
      x.y = sanitize_bf16x2(x.y);
      x.z = sanitize_bf16x2(x.z);
      x.w = sanitize_bf16x2(x.w);
      *v = x;
    }
  }
}

// int8 stage: the K and V codes as bf16 (exact) into the padded tile
template <int D, int kRowB, int kTileRowB>
__device__ __forceinline__ void convert_stage(const unsigned char* stg,
                                              unsigned char* tile) {
  constexpr int kVecRow = D / 16;
  for (int i = threadIdx.x; i < 2 * kCols * kVecRow; i += blockDim.x) {
    const int row = i / kVecRow, v = i % kVecRow;
    const uint4 x = *reinterpret_cast<const uint4*>(stg + row * kRowB + 16 * v);
    const uint32_t w[4] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u,
                           x.z ^ 0x80808080u, x.w ^ 0x80808080u};
    uint32_t b[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[2 * j] = pack_bf16(code_f32<0>(w[j]), code_f32<1>(w[j]));
      b[2 * j + 1] = pack_bf16(code_f32<2>(w[j]), code_f32<3>(w[j]));
    }
    uint4* dst = reinterpret_cast<uint4*>(tile + row * kTileRowB + 32 * v);
    dst[0] = make_uint4(b[0], b[1], b[2], b[3]);
    dst[1] = make_uint4(b[4], b[5], b[6], b[7]);
  }
}

template <typename KVT, int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
    paged_attention_split_mma_kernel(const Params p) {
  using Lay = Layout<KVT, D, kMmaRows>;
  constexpr bool kI8 = Lay::kI8;
  constexpr int kRowB = Lay::kRowB;
  constexpr int kTileB = kI8 ? Lay::kTileRowB : kRowB;  // bf16 rows read
  constexpr int kKS = D / 16;  // k-steps of QK
  constexpr int kNT = D / 8;   // n-tiles of PV
  extern __shared__ __align__(128) unsigned char smem[];
  int* tok_s = reinterpret_cast<int*>(smem);
  int* pos_s = tok_s + kMaxSpan / kChunk;
  int* orow_s = pos_s + kMmaRows;
  int* red_s = orow_s + kMmaRows;
  unsigned char* q_s = smem + kHeadInts * 4;  // [64][kQRowB] bf16
  unsigned char* work = smem + Lay::kWorkOff;
  unsigned char* conv = work + Lay::kStages * Lay::kStageB;

  // warp w: rows 16 (w % 4) ... of the group, columns 16 (w / 4) ... of
  // each stage; the two column halves of a row block merge at the end
  Unit u = unit_of<kMmaRows>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g, r1 = r0 + 8;
  const bool active = 16 * (warp & 3) < u.nrows;  // uniform in the warp
  // the group's query rows (rows past nrows zero) go to shared memory and
  // are read back as A fragments each stage, so that registers allow two
  // CTAs an SM; loaded here, stored once the first copies are issued
  constexpr int kQV = kMmaRows * D / 8 / kMmaThreads;  // 16-byte vectors
  uint4 qv[kQV];
#pragma unroll
  for (int j = 0; j < kQV; ++j) {
    const int i = threadIdx.x + j * kMmaThreads, r = i / (D / 8);
    qv[j] = r < u.nrows ? *reinterpret_cast<const uint4*>(
                              p.q + (size_t)q_row(p, u, r) * D + 8 * (i % (D / 8)))
                        : make_uint4(0u, 0u, 0u, 0u);
  }
  if (!prologue<kMmaRows>(p, u, tok_s, pos_s, orow_s, red_s)) return;
  // A fragments (16 x 16) of this warp's rows: matrices rows 0-7 / 8-15 x
  // columns 0-7 / 8-15 of k-step kk at qaddr + 32 kk
  const uint32_t qaddr =
      smem_u32(q_s) +
      (16 * (warp & 3) + (lane & 7) + 8 * ((lane >> 3) & 1)) * Lay::kQRowB +
      16 * (lane >> 4);
  const int pos0 = pos_s[r0], pos1 = pos_s[r1];
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int n_st = (u.len + kCols - 1) / kCols;
#pragma unroll
  for (int st = 0; st < Lay::kStages - 1; ++st) {
    if (st < n_st)
      issue_stage<KVT, D, kRowB>(p, u, tok_s, work + st * Lay::kStageB, st);
    cp_async_commit();
  }
#pragma unroll
  for (int j = 0; j < kQV; ++j) {  // read after the first stage's barrier
    const int i = threadIdx.x + j * kMmaThreads;
    *reinterpret_cast<uint4*>(q_s + (i / (D / 8)) * Lay::kQRowB +
                              16 * (i % (D / 8))) = qv[j];
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<Lay::kStages - 2>();
    __syncthreads();
    {
      const int nx = st + Lay::kStages - 1;
      if (nx < n_st)
        issue_stage<KVT, D, kRowB>(p, u, tok_s,
                                   work + (nx % Lay::kStages) * Lay::kStageB,
                                   nx);
      cp_async_commit();
    }
    unsigned char* stg = work + (st % Lay::kStages) * Lay::kStageB;
    const unsigned char* kt = stg;
    if constexpr (kI8) {
      convert_stage<D, kRowB, kTileB>(stg, conv);
      kt = conv;
    } else {
      sanitize_stage<D, kRowB>(stg);
    }
    __syncthreads();
    if (!active) continue;
    const unsigned char* vt = kt + kCols * kTileB;

    // S (16 x 16) = Q K^T over this warp's 16 columns of the stage
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const uint32_t kaddr = smem_u32(kt) +
                           (16 * half + (lane & 7)) * kTileB +
                           16 * (lane >> 3);
#pragma unroll
    for (int k2 = 0; k2 < kKS / 2; ++k2) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, qaddr + 64 * k2);
      ldsm_x4(a1, qaddr + 64 * k2 + 32);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b[4];
        ldsm_x4(b, kaddr + 8 * nt * kTileB + 64 * k2);
        mma(s[nt], a0, b[0], b[1]);
        mma(s[nt], a1, b[2], b[3]);
      }
    }

    // mask, scale, online softmax (rows r0: s[.][0..1], r1: s[.][2..3])
    const float* scl = reinterpret_cast<const float*>(stg + 2 * kCols * kRowB);
    uint32_t okm = 0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cs = 16 * half + 8 * nt + 2 * t + (e & 1);
        const int lc = st * kCols + cs;
        const bool ok = lc < u.len && u.c0 + lc <= (e < 2 ? pos0 : pos1);
        float x = s[nt][e] * p.qk_scale;
        if constexpr (kI8) x *= nan_to_num(scl[cs]);
        s[nt][e] = ok ? x : kNegInf;
        okm |= (ok ? 1u : 0u) << (4 * nt + e);
        if (e < 2)
          mx0 = fmaxf(mx0, s[nt][e]);
        else
          mx1 = fmaxf(mx1, s[nt][e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (okm >> (4 * nt + e)) & 1u;
        // masked: exactly zero, also after a non-finite V scale
        const float pr = ok ? ex2(s[nt][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        if (e < 2)
          ps0 += pr;
        else
          ps1 += pr;
        float pv = pr;
        if constexpr (kI8)
          pv = ok ? pr * nan_to_num(scl[kCols + 16 * half + 8 * nt + 2 * t +
                                        (e & 1)])
                  : 0.f;
        s[nt][e] = pv;
      }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    // the rescale is skipped while no row's maximum moves (c == 1)
    if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
    }
    // P as an A fragment (16 x 16), hi + lo
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* x = &s[i >> 1][2 * (i & 1)];
      ah[i] = pack_bf16(x[0], x[1]);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&ah[i]);
      al[i] = pack_bf16(x[0] - __low2float(h), x[1] - __high2float(h));
    }
    // O (16 x D) += P V over the same 16 columns
    const uint32_t vaddr = smem_u32(vt) +
                           (16 * half + 8 * ((lane >> 3) & 1) + (lane & 7)) *
                               kTileB +
                           16 * (lane >> 4);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, vaddr + 32 * np);
      mma(o[2 * np], ah, b[0], b[1]);
      mma(o[2 * np], al, b[0], b[1]);
      mma(o[2 * np + 1], ah, b[2], b[3]);
      mma(o[2 * np + 1], al, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the column halves merge: half 1 leaves its state in shared memory in
  // its fragment layout, half 0 (the same rows, the same layout) folds it
  // in and writes the CTA's
  float* acc_s = reinterpret_cast<float*>(work);  // [64][D]
  float* m_s = acc_s + Lay::kAccF;                // [64]
  float* l_s = m_s + kMmaRows;                    // [64]
  float* oth = l_s + kMmaRows;                    // [kNT][4][128]: half 1
  float* mh_s = oth + kNT * 4 * 128;              // [64]
  float* lh_s = mh_s + kMmaRows;                  // [64]
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int slot = threadIdx.x & 127;  // this thread's place in its half
  if (active && half == 1) {
    if (t == 0) {
      mh_s[r0] = m0;
      lh_s[r0] = l0;
      mh_s[r1] = m1;
      lh_s[r1] = l1;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oth[(n * 4 + e) * 128 + slot] = o[n][e];
  }
  __syncthreads();
  if (active && half == 0) {
    const float mb0 = mh_s[r0], mb1 = mh_s[r1];
    const float ma0 = fmaxf(m0, mb0), ma1 = fmaxf(m1, mb1);
    const float fa0 = ex2(m0 - ma0), fb0 = ex2(mb0 - ma0);
    const float fa1 = ex2(m1 - ma1), fb1 = ex2(mb1 - ma1);
    if (t == 0) {
      m_s[r0] = ma0;
      l_s[r0] = l0 * fa0 + lh_s[r0] * fb0;
      m_s[r1] = ma1;
      l_s[r1] = l1 * fa1 + lh_s[r1] * fb1;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float* b = oth + n * 4 * 128 + slot;
      *reinterpret_cast<float2*>(acc_s + r0 * D + 8 * n + 2 * t) =
          make_float2(o[n][0] * fa0 + b[0] * fb0, o[n][1] * fa0 + b[128] * fb0);
      *reinterpret_cast<float2*>(acc_s + r1 * D + 8 * n + 2 * t) =
          make_float2(o[n][2] * fa1 + b[256] * fb1,
                      o[n][3] * fa1 + b[384] * fb1);
    }
  }
  __syncthreads();
  epilogue<kMmaRows, D>(p, u, orow_s, red_s + kFlag, m_s, l_s, acc_s,
                        reinterpret_cast<float2*>(acc_s));
}

// -- host side ---------------------------------------------------------------

template <typename KVT, int D, int G>
void* kernel_fn() {
  if constexpr (G == kMmaRows)
    return reinterpret_cast<void*>(paged_attention_split_mma_kernel<KVT, D>);
  else
    return reinterpret_cast<void*>(paged_attention_split_kernel<KVT, D, G>);
}

struct Instance {
  void* fn;
  int smem;
  int threads;
};

template <typename KVT, int D>
Instance instance_g(int G) {
  switch (G) {
    case 1:
      return {kernel_fn<KVT, D, 1>(), Layout<KVT, D, 1>::kSmem, kThreads};
    case 4:
      return {kernel_fn<KVT, D, 4>(), Layout<KVT, D, 4>::kSmem, kThreads};
    case kMmaRows:
      return {kernel_fn<KVT, D, kMmaRows>(), Layout<KVT, D, kMmaRows>::kSmem,
              kMmaThreads};
    default:
      return {nullptr, 0, 0};
  }
}

// The kernel of (pool dtype, head dim, rows a group); fn null if none.
Instance instance_of(int kv_dtype, int D, int G) {
  if (kv_dtype == kBF16)
    return D == 64    ? instance_g<__nv_bfloat16, 64>(G)
           : D == 128 ? instance_g<__nv_bfloat16, 128>(G)
                      : Instance{nullptr, 0, 0};
  if (kv_dtype == kI8)
    return D == 64    ? instance_g<int8_t, 64>(G)
           : D == 128 ? instance_g<int8_t, 128>(G)
                      : Instance{nullptr, 0, 0};
  return {nullptr, 0, 0};
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// Plain C entry point, bound with ctypes. q, pools, scales, tables,
// positions and out are contiguous on the current device; q and out bf16;
// pools bf16 (kv_dtype 1) or int8 (2, with f32 scales). group_rows (1, 4:
// CUDA-core dots; 64: tensor cores) and span (columns a CTA walks, a
// multiple of 32 up to 2048) are the wrapper's choice; part
// [units, n_span_max, group_rows, D] and ml [.., 2] (f32) are scratch and
// tickets [units] (int32) is zero and left zero, where units = S * KVH *
// ceil(T * R / group_rows) and n_span_max = ceil(max_blocks * block_size /
// span) (the three may be null when n_span_max is 1). Returns 0 or a
// cudaError_t (cudaErrorInvalidValue for what this design does not take).
extern "C" int paged_attention_split_forward(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, const void* n_tiles, void* out, void* part,
    void* ml, void* tickets, int S, int T, int H, int KVH, int D,
    int block_size, int max_blocks, int num_blocks, int kv_dtype,
    int group_rows, int span, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  const Instance k = instance_of(kv_dtype, D, group_rows);
  const bool quant = kv_dtype == kI8;
  if (k.fn == nullptr || KVH <= 0 || H % KVH != 0 || block_size < kChunk ||
      block_size > 128 || block_size % kChunk != 0 || max_blocks <= 0 ||
      num_blocks <= 0 || span < kCols || span > kMaxSpan ||
      span % kCols != 0 || quant != (k_scale != nullptr) ||
      quant != (v_scale != nullptr) || !aligned(k_pool, 16) ||
      !aligned(v_pool, 16) || !aligned(q, 16) || !aligned(out, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cols = (long long)max_blocks * block_size;
  const long long n_span_max = (cols + span - 1) / span;
  const int R = H / KVH;
  const long long n_rg = ((long long)T * R + group_rows - 1) / group_rows;
  const long long units = (long long)S * KVH * n_rg;
  if (n_span_max > kMaxSpans || units > INT_MAX ||
      (long long)T * H > INT_MAX / S ||
      (long long)num_blocks * block_size > INT_MAX ||
      (n_span_max > 1 &&
       (part == nullptr || ml == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_pool = static_cast<const unsigned char*>(k_pool);
  p.v_pool = static_cast<const unsigned char*>(v_pool);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.positions = static_cast<const int*>(positions);
  p.n_tiles = static_cast<const int*>(n_tiles);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);
  p.ml = static_cast<float*>(ml);
  p.tickets = static_cast<int*>(tickets);
  p.T = T;
  p.H = H;
  p.KVH = KVH;
  p.R = R;
  p.bs = block_size;
  p.MB = max_blocks;
  p.NB = num_blocks;
  p.span = span;
  p.n_rg = static_cast<int>(n_rg);
  p.n_span_max = static_cast<int>(n_span_max);
  p.qk_scale = static_cast<float>(kLog2e / std::sqrt(static_cast<double>(D)));
  const cudaError_t rc = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  void* args[] = {&p};
  const cudaError_t rl = cudaLaunchKernel(
      k.fn, dim3(static_cast<unsigned>(units), static_cast<unsigned>(n_span_max)),
      dim3(k.threads), args, static_cast<size_t>(k.smem),
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(rl != cudaSuccess ? rl : cudaGetLastError());
}

// CTAs an SM (the runtime's occupancy calculator) and dynamic shared
// memory (bytes) of one instance; -1 for an instance that does not exist.
extern "C" int paged_attention_split_occupancy(int kv_dtype, int D,
                                               int group_rows, int* smem) {
  const Instance k = instance_of(kv_dtype, D, group_rows);
  if (k.fn == nullptr) return -1;
  *smem = k.smem;
  int n = 0;
  if (cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k.fn, k.threads,
                                                    k.smem) != cudaSuccess)
    return -1;
  return n;
}
