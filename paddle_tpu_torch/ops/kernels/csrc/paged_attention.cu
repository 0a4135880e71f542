// Block-table paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (_kernel, launched by _paged_attention_call). Same contract as the
// plain walk beside its wrapper (ops/kernels/paged_attention.py,
// paged_attention_reference), which is this kernel's oracle:
//
//   q [S, T, H, D] attends to the K/V history of its slot, stored as
//   pool blocks [NB, bs, KVH, D] addressed through tables [S, MB]
//   (entry < 0 = unmapped, clamped to block 0). Row (s, t) attends
//   every column c <= positions[s, t]. Query head h = kvh * R + r
//   attends the UNEXPANDED KV head kvh (grouped GQA, R = H / KVH).
//   int8 pools carry per-(token, head) f32 scales [NB, bs, KVH] and
//   are dequantized (code * scale) as they are loaded. Every loaded
//   K/V value goes through nan_to_num, and a masked column contributes
//   exactly zero (p is re-masked), so garbage left in a recycled or
//   unmapped block can never leak into a row. Tiles at or past
//   *n_tiles are skipped; n_tiles is a device int32 so that a captured
//   (CUDA-graph) step can change it without re-capture.
//
// Design. One CTA of eight warps per (slot, KV head, group of four
// query rows); the rows of a (slot, KV head) are the T*R query rows
// (t, r). The TPU grid's sequential tile axis becomes a loop inside
// the CTA, dealt round-robin to the eight warps (tile t to warp t % 8),
// and stopped at the last tile any of the CTA's rows needs (later
// columns are masked to exactly zero, so stopping there gives the same
// numbers). A warp takes its tile eight columns at a time straight
// from device memory into registers with 16-byte loads: for the QK dot
// four lanes share a column, each holding a quarter of its D values
// (the partial dots meet in two shuffles); for PV each lane owns D/32
// output elements and loads those elements of all eight V rows. Each
// warp keeps its own online-softmax state (m, l, acc) per row in f32;
// at the end the warps' states merge through shared memory, one warp
// per row, and the output is acc / max(l, 1e-30) cast to q's
// dtype.
//
// What bounds it. At decode (T = 1) the work is ~1 flop per byte of
// K/V read: the kernel is bound by device-memory bytes, each live K/V
// tile read once per step by one warp. The design keeps a warp's next
// loads independent of its arithmetic, and eight warps per CTA stream
// different tiles. Left for later: split-K over the sequence across
// CTAs (flash-decoding) so one long history is not walked by a single
// CTA, cp.async/TMA double buffering, and tensor-core (mma/wgmma) dot
// products for large T (prefill chunks re-read each tile once per
// group of four rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int kWarps = 8;   // warps per CTA; tiles are dealt round-robin
constexpr int kRows = 4;    // query rows per CTA; warp r merges row r
constexpr int kCols = 8;    // columns a warp holds per step
constexpr int kParts = 4;   // lanes sharing one column's QK dot
constexpr float kNegInf = -1e30f;
static_assert(kCols * kParts == 32, "a warp covers kCols columns");
static_assert(kRows <= kWarps, "one warp merges each row");

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// NaN -> 0, +-inf -> +-FLT_MAX (numpy's nan_to_num for float32)
__device__ __forceinline__ float nan_to_num(float x) {
  if (x != x) return 0.f;
  if (fabsf(x) > FLT_MAX) return x > 0.f ? FLT_MAX : -FLT_MAX;
  return x;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// N consecutive elements in one aligned vector load, widened to f32
template <int N, typename T>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  const Pack<T, N> x = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(x.v[i]);
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const QT* __restrict__ q,
                           const KVT* __restrict__ k_pool,
                           const KVT* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ tables,
                           const int* __restrict__ positions,
                           const int* __restrict__ n_tiles,
                           QT* __restrict__ out, int T, int H, int KVH,
                           int R, int bs, int MB, int NB, float scale) {
  constexpr bool kDequant = std::is_same<KVT, int8_t>::value;
  constexpr int kVec = 16 / sizeof(KVT);        // K elements a load
  constexpr int kKLoads = D / (kParts * kVec);  // K loads a lane a column
  constexpr int kDims = D / 32;                 // output elements a lane
  static_assert(kKLoads >= 1 && D % (kParts * kVec) == 0, "head dim");
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = lane / kParts;
  const int part = lane % kParts;
  const int TR = T * R;
  const int row0 = blockIdx.z * kRows;

  __shared__ float q_s[kRows][D];
  __shared__ float m_s[kWarps][kRows];
  __shared__ float l_s[kWarps][kRows];
  __shared__ float acc_s[kWarps][kRows][D];

  int pos_r[kRows];
  int max_pos = -1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    pos_r[r] = row < TR ? positions[s * T + row / R] : -1;
    max_pos = max(max_pos, pos_r[r]);
  }
  // stage the CTA's query rows as f32 (rows past T*R are zeros)
  for (int e = threadIdx.x; e < kRows * D; e += blockDim.x) {
    const int i = e / D, d = e % D, row = row0 + i;
    float val = 0.f;
    if (row < TR) {
      const int t = row / R, h = kvh * R + row % R;
      val = to_f32(q[((size_t)(s * T + t) * H + h) * D + d]);
    }
    q_s[i][d] = val;
  }
  __syncthreads();

  float m_r[kRows], l_r[kRows], acc[kRows][kDims];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int k = 0; k < kDims; ++k) acc[r][k] = 0.f;
  }

  const int n_live = min(*n_tiles, MB);
  const int n_need = max_pos >= 0 ? max_pos / bs + 1 : 0;
  const int n_walk = min(n_live, n_need);

  for (int tile = warp; tile < n_walk; tile += kWarps) {
    int phys = tables[s * MB + tile];
    phys = phys < 0 ? 0 : (phys >= NB ? NB - 1 : phys);
    for (int c0 = 0; c0 < bs; c0 += kCols) {
      const int cn = min(kCols, bs - c0);
      const bool have = col < cn;
      // columns past the tile's end read column c0 (masked below)
      const size_t tok0 = (size_t)phys * bs + c0;
      const size_t tok_c = tok0 + (have ? col : 0);
      float kf[kKLoads * kVec];
      const KVT* kp = k_pool + (tok_c * KVH + kvh) * D;
#pragma unroll
      for (int j = 0; j < kKLoads; ++j)
        load_f32<kVec>(kp + (part + kParts * j) * kVec, kf + j * kVec);
      float vf[kCols][kDims];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const size_t tok = tok0 + (c < cn ? c : 0);
        load_f32<kDims>(v_pool + (tok * KVH + kvh) * D + lane * kDims,
                        vf[c]);
        if (kDequant) {
          const float vs = v_scale[tok * KVH + kvh];
#pragma unroll
          for (int k = 0; k < kDims; ++k) vf[c][k] *= vs;
        }
#pragma unroll
        for (int k = 0; k < kDims; ++k) vf[c][k] = nan_to_num(vf[c][k]);
      }
      const float ks = kDequant ? k_scale[tok_c * KVH + kvh] : 1.f;
#pragma unroll
      for (int i = 0; i < kKLoads * kVec; ++i)
        kf[i] = nan_to_num(kDequant ? kf[i] * ks : kf[i]);

      const int colg = tile * bs + c0 + col;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (pos_r[r] < 0) continue;  // uniform: no such row in the CTA
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kKLoads; ++j)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            dot = fmaf(q_s[r][(part + kParts * j) * kVec + e],
                       kf[j * kVec + e], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const bool ok = have && colg <= pos_r[r];
        const float sc = ok ? dot * scale : kNegInf;
        const float m_new = fmaxf(m_r[r], warp_max(sc));
        // a fully masked row has sc == m_new == -1e30 and exp() == 1:
        // re-mask p so its contribution is exactly zero
        const float p = ok ? expf(sc - m_new) : 0.f;
        const float corr = expf(m_r[r] - m_new);
        l_r[r] = l_r[r] * corr + warp_sum(part == 0 ? p : 0.f);
#pragma unroll
        for (int k = 0; k < kDims; ++k) acc[r][k] *= corr;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float pc = __shfl_sync(0xffffffffu, p, c * kParts);
#pragma unroll
          for (int k = 0; k < kDims; ++k)
            acc[r][k] = fmaf(pc, vf[c][k], acc[r][k]);
        }
        m_r[r] = m_new;
      }
    }
  }

  // merge the warps' online-softmax states; warp r finishes row r
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      m_s[warp][r] = m_r[r];
      l_s[warp][r] = l_r[r];
    }
#pragma unroll
    for (int k = 0; k < kDims; ++k) acc_s[warp][r][lane * kDims + k] = acc[r][k];
  }
  __syncthreads();
  const int row = row0 + warp;
  if (warp >= kRows || row >= TR) return;
  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_s[w][warp]);
  float l_all = 0.f, o[kDims];
#pragma unroll
  for (int k = 0; k < kDims; ++k) o[k] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float f = expf(m_s[w][warp] - m_all);
    l_all += l_s[w][warp] * f;
#pragma unroll
    for (int k = 0; k < kDims; ++k)
      o[k] = fmaf(acc_s[w][warp][lane * kDims + k], f, o[k]);
  }
  const float inv = 1.f / fmaxf(l_all, 1e-30f);
  const int t = row / R, h = kvh * R + row % R;
  QT* dst = out + ((size_t)(s * T + t) * H + h) * D + lane * kDims;
#pragma unroll
  for (int k = 0; k < kDims; ++k) store(dst + k, o[k] * inv);
}

template <typename QT, typename KVT, int D>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* k_scale, const void* v_scale, const void* tables,
            const void* positions, const void* n_tiles, void* out, int S,
            int T, int H, int KVH, int bs, int MB, int NB,
            cudaStream_t stream) {
  const int R = H / KVH;
  const dim3 grid(S, KVH, (T * R + kRows - 1) / kRows);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  paged_attention_kernel<QT, KVT, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<const int*>(n_tiles),
      static_cast<QT*>(out), T, H, KVH, R, bs, MB, NB, scale);
}

template <typename QT, typename KVT>
int dispatch_d(int D, const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale, const void* tables,
               const void* positions, const void* n_tiles, void* out, int S,
               int T, int H, int KVH, int bs, int MB, int NB,
               cudaStream_t stream) {
  if (D == 64)
    launch<QT, KVT, 64>(q, k_pool, v_pool, k_scale, v_scale, tables,
                        positions, n_tiles, out, S, T, H, KVH, bs, MB, NB,
                        stream);
  else if (D == 128)
    launch<QT, KVT, 128>(q, k_pool, v_pool, k_scale, v_scale, tables,
                         positions, n_tiles, out, S, T, H, KVH, bs, MB, NB,
                         stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, int D, const void* q, const void* k_pool,
                const void* v_pool, const void* k_scale, const void* v_scale,
                const void* tables, const void* positions,
                const void* n_tiles, void* out, int S, int T, int H, int KVH,
                int bs, int MB, int NB, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return dispatch_d<QT, float>(D, q, k_pool, v_pool, k_scale, v_scale,
                                   tables, positions, n_tiles, out, S, T, H,
                                   KVH, bs, MB, NB, stream);
    case kBF16:
      return dispatch_d<QT, __nv_bfloat16>(D, q, k_pool, v_pool, k_scale,
                                           v_scale, tables, positions,
                                           n_tiles, out, S, T, H, KVH, bs,
                                           MB, NB, stream);
    case kI8:
      return dispatch_d<QT, int8_t>(D, q, k_pool, v_pool, k_scale, v_scale,
                                    tables, positions, n_tiles, out, S, T, H,
                                    KVH, bs, MB, NB, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. All tensors are contiguous
// and on the current device; the caller allocates `out`. Returns 0 or
// the cudaError_t of the launch (cudaErrorInvalidValue for an
// unsupported dtype pair or head dim).
extern "C" int paged_attention_forward(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, const void* n_tiles, void* out, int S, int T,
    int H, int KVH, int D, int block_size, int max_blocks, int num_blocks,
    int q_dtype, int kv_dtype, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || block_size <= 0 || max_blocks <= 0 ||
      num_blocks <= 0 || (kv_dtype == kI8) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return dispatch_kv<float>(kv_dtype, D, q, k_pool, v_pool, k_scale,
                                v_scale, tables, positions, n_tiles, out, S,
                                T, H, KVH, block_size, max_blocks,
                                num_blocks, st);
    case kBF16:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, D, q, k_pool, v_pool,
                                        k_scale, v_scale, tables, positions,
                                        n_tiles, out, S, T, H, KVH,
                                        block_size, max_blocks, num_blocks,
                                        st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
