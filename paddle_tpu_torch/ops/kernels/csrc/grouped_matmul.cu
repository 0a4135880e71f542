// Grouped (ragged) matmul for Hopper (sm_90a): the MoE expert-FFN kernels.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/grouped_matmul.py:
// _gmm_kernel (launched by _gmm_fwd_impl, for the forward and, on the
// transposed expert weights, for dlhs) and _gmm_drhs_kernel (launched by
// _gmm_drhs_impl, the per-expert weight gradient). The plain PyTorch
// versions beside the wrappers (ops/kernels/grouped_matmul.py,
// grouped_matmul_fwd_reference and grouped_matmul_drhs_reference) are the
// oracles.
//
// One contract serves every caller: row offsets `offsets` int32 [E + 1]
// in device memory, non-decreasing, rows offsets[e] .. offsets[e+1] - 1
// going to expert e (offsets past T count as T). The TPU kernel instead
// takes one expert id per token tile and needs every group padded to a
// multiple of the tile; here groups may start and end anywhere.
//
//   forward (K6)  out[r] = lhs[r] . B[e(r)] for offsets[e] <= r <
//                 offsets[e+1], and 0 for rows no expert owns. lhs [T, K]
//                 row-major, B [E, K, N] through its element strides
//                 (se, sk, sn) with sn == 1 (the expert weights) or
//                 sk == 1 (the same weights transposed, for dlhs =
//                 g . rhs[e]^T: read in place, no transposed copy); out
//                 [T, N] in the input dtype.
//   drhs (K7)     out[e] = sum over offsets[e] <= r < offsets[e+1] of
//                 lhs[r]^T g[r], f32 [E, K, N]; exact zeros for an expert
//                 without rows.
//
// Design. A CTA of eight warps owns a 128 x 128 output tile (warps 2 x 4,
// 64 x 32 each); its reduction runs in steps of 32. Each operand tile is
// staged in shared memory in its source's own layout, row by row with
// 16-byte loads and stores (a rows x columns copy, no scatter), and the
// mma fragments are read from it as 32-bit pairs where the reduction
// index is contiguous in the row, or by ldmatrix .trans where it runs
// down the rows (the expert weights as stored, and both drhs operands).
// The forward's CTA finds the experts whose row ranges meet its 128 rows
// by a binary search over `offsets` and runs one reduction per such
// expert with the rows of the others read as zeros, so a tile on a group
// boundary needs no padding and rows no expert owns come out as zeros;
// an aligned layout (every group a multiple of 128) runs exactly one
// reduction a tile, the TPU's case. drhs gives each (expert, K tile, N
// tile) one CTA that walks that expert's rows and accumulates in
// registers: no atomics, so the result is deterministic, and rows no
// expert owns count nowhere. bf16 products run on the tensor cores as
// mma.sync m16n8k16 with f32 accumulators; f32 inputs take the same
// tiles with the product as f32 FMAs on the CUDA cores (true f32, no
// TF32, as the JAX package pins f32 to HIGHEST). Any T, K and N: tile
// edges are masked, and rows whose length or alignment rules out 16-byte
// loads are read element by element.
//
// What bounds it. At the MoE geometries (T 16384, K 1024, N 4096; T
// 40960, K 768 / 3072, N 3072 / 768) each call is 2 T K N flops (1.4e11
// and 1.9e11) against 0.1-0.3 GB of operands: bound by tensor-core
// operations. This first design loads synchronously with one tile in
// flight, so the tensor cores wait on every load. Left for later:
// cp.async/TMA multi-stage pipelining, wgmma with warp-specialised
// producers, and a persistent tile scheduler.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;  // 256
constexpr int kBM = 128;                          // output rows a CTA owns
constexpr int kBN = 128;                          // output columns
constexpr int kBK = 32;                           // reduction step
constexpr int kWM = kBM / kWarpsM;                // 64 rows a warp
constexpr int kWN = kBN / kWarpsN;                // 32 columns a warp
constexpr int kMT = kWM / 16;                     // m16 tiles a warp
constexpr int kNT = kWN / 8;                      // n8 tiles a warp

enum DType { kF32 = 0, kBF16 = 1 };

// shared row pitches, 16 bytes of padding each, so the eight rows a
// fragment load touches fall in distinct banks: kLDR for a tile whose
// rows run along the output (128 x kBK, the reduction along the row),
// kLDC for one whose rows run along the reduction (kBK x 128)
template <typename T>
constexpr int kLDR = kBK + 16 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kLDC = kBM + 16 / static_cast<int>(sizeof(T));
static_assert(kBM == kBN, "one pitch serves both operands");

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float lo,
                                       float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// One operand tile, copied in its source's layout: S[r][c] (row pitch
// LD) = src[(row0 + r) * rs + col0 + c] for r < ROWS, c < COLS, zero where
// row0 + r is outside [row_lo, row_hi) or col0 + c >= col_lim. Each thread
// moves 16 bytes along a row; `vec` (uniform) says the source's row
// stride and base allow 16-byte loads, and a vector that crosses a bound
// is read element by element.
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void fill(T* S, const T* src, long long rs,
                                     int row0, int row_lo, int row_hi,
                                     int col0, int col_lim, bool vec) {
  constexpr int V = 16 / sizeof(T), PER = COLS / V;
  for (int i = threadIdx.x; i < ROWS * PER; i += kThreads) {
    const int r = i / PER, c = (i % PER) * V;
    const int row = row0 + r, col = col0 + c;
    T* dst = S + r * LD + c;
    const T* s = src + row * rs + col;
    const bool row_ok = row >= row_lo && row < row_hi;
    if (row_ok && vec && col + V <= col_lim) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(s);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        dst[j] = row_ok && col + j < col_lim ? s[j] : zero<T>();
    }
  }
}

// D (16x8, f32) += A (16x16) B (16x8) in the m16n8k16 fragment layout
// (lane = 4 g + t): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..],
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four (two) 8 x 8 b16 matrices from shared memory, transposed: lane
// 4 g + t receives elements [2t][g] and [2t+1][g] of each matrix, whose
// rows lanes 8 i .. 8 i + 7 address
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// acc += A B over one staged reduction step. kAC: sA is [kBK][kLDC] (A's
// rows along the row, the reduction down the rows), else [kBM][kLDR];
// kBC: sB is [kBK][kLDC] (B's columns along the row), else [kBN][kLDR].
// The warp's rows start at wm, its columns at wn.
template <bool kAC, bool kBC>
__device__ __forceinline__ void step(float (&acc)[kMT][kNT][4],
                                     const __nv_bfloat16* sA,
                                     const __nv_bfloat16* sB, int wm,
                                     int wn) {
  using T = __nv_bfloat16;
  constexpr int LDA = kAC ? kLDC<T> : kLDR<T>;
  constexpr int LDB = kBC ? kLDC<T> : kLDR<T>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int m0 = wm + mt * 16;
      if (kAC) {
        // matrix i: reduction rows kk + 8 (i >> 1) .., A rows m0 + 8 (i & 1)
        ldsm_x4_t(a[mt], sA + (kk + (lane & 7) + ((lane >> 4) << 3)) * LDA +
                             m0 + ((lane >> 3) & 1) * 8);
      } else {
        const T* p = sA + (m0 + g) * LDA + kk + 2 * t;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * LDA);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * LDA + 8);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n0 = wn + nt * 8;
      if (kBC) {
        // matrix i: reduction rows kk + 8 i .., B columns n0 ..
        ldsm_x2_t(b[nt], sB + (kk + (lane & 15)) * LDB + n0);
      } else {
        const T* p = sB + (n0 + g) * LDB + kk + 2 * t;
        b[nt][0] = ld32(p);
        b[nt][1] = ld32(p + 8);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], a[mt], b[nt]);
  }
}

// the same step in f32 on the CUDA cores, into the same accumulator
// layout: each lane reads its rows' and columns' elements, k in order
template <bool kAC, bool kBC>
__device__ __forceinline__ void step(float (&acc)[kMT][kNT][4],
                                     const float* sA, const float* sB,
                                     int wm, int wn) {
  constexpr int LDA = kAC ? kLDC<float> : kLDR<float>;
  constexpr int LDB = kBC ? kLDC<float> : kLDR<float>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float a0[kMT], a1[kMT], b0[kNT], b1[kNT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int m = wm + mt * 16 + g;
      a0[mt] = kAC ? sA[k * LDA + m] : sA[m * LDA + k];
      a1[mt] = kAC ? sA[k * LDA + m + 8] : sA[(m + 8) * LDA + k];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = wn + nt * 8 + 2 * t;
      b0[nt] = kBC ? sB[k * LDB + n] : sB[n * LDB + k];
      b1[nt] = kBC ? sB[k * LDB + n + 1] : sB[(n + 1) * LDB + k];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[mt][nt][0] = fmaf(a0[mt], b0[nt], acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(a0[mt], b1[nt], acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(a1[mt], b0[nt], acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(a1[mt], b1[nt], acc[mt][nt][3]);
      }
  }
}

// the accumulator tile into out[rows, cols] (row stride ld), masked to
// rows < M and cols < N; `pair` says two neighbouring columns may be
// stored as one aligned pair (N even)
template <typename O>
__device__ __forceinline__ void store_tile(O* out, long long ld, int m0,
                                           int n0, int M, int N, bool pair,
                                           const float (&acc)[kMT][kNT][4],
                                           int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + wn + nt * 8 + 2 * t;
        const float lo = acc[mt][nt][2 * h], hi = acc[mt][nt][2 * h + 1];
        O* p = out + row * ld + col;
        if (pair && col + 1 < N) {
          store2(p, lo, hi);
        } else {
          if (col < N) store1(p, lo);
          if (col + 1 < N) store1(p + 1, hi);
        }
      }
    }
}

__device__ __forceinline__ int clamp_row(const int* offsets, int i, int T) {
  return max(0, min(offsets[i], T));
}

// shared memory of one CTA: two operand tiles of the larger shape
template <typename T>
constexpr int kSmemElems = 2 * (kBM * kLDR<T> > kBK * kLDC<T>
                                    ? kBM * kLDR<T>
                                    : kBK * kLDC<T>);

// K6: one CTA per (128-row, 128-column) output tile. kBT: B is read
// transposed (sk == 1, dlhs), its tile [n][k]; else B as stored (sn ==
// 1), its tile [k][n].
template <typename T, bool kBT>
__global__ void __launch_bounds__(kThreads)
    gmm_fwd_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                   T* __restrict__ out, const int* __restrict__ offsets,
                   int Tn, int K, int N, int E, long long se, long long sk,
                   long long sn, bool vec_a, bool vec_b, bool pair) {
  __shared__ __align__(16) unsigned char smem[kSmemElems<T> * sizeof(T)];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kSmemElems<T> / 2;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the first expert whose rows end past m0 (offsets are non-decreasing)
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (clamp_row(offsets, mid + 1, Tn) > m0)
      hi = mid;
    else
      lo = mid + 1;
  }
  for (int e = lo; e < E; ++e) {
    const int r_lo = clamp_row(offsets, e, Tn);
    if (r_lo >= m0 + kBM) break;
    const int r_hi = min(clamp_row(offsets, e + 1, Tn), m0 + kBM);
    if (r_hi <= max(r_lo, m0)) continue;  // no rows of this tile
    const T* b = rhs + e * se;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();  // the previous step is consumed
      // A [row][k] = lhs[row * K + k], rows of expert e only
      fill<T, kBM, kBK, kLDR<T>>(sA, lhs, K, m0, r_lo, r_hi, k0, K, vec_a);
      if (kBT)  // B [n][k] = b[n * sn + k]
        fill<T, kBN, kBK, kLDR<T>>(sB, b, sn, n0, 0, N, k0, K, vec_b);
      else      // B [k][n] = b[k * sk + n]
        fill<T, kBK, kBN, kLDC<T>>(sB, b, sk, k0, 0, K, n0, N, vec_b);
      __syncthreads();
      step<false, !kBT>(acc, sA, sB, wm, wn);
    }
  }
  store_tile(out, N, m0, n0, Tn, N, pair, acc, wm, wn);
}

// K7: one CTA per (K tile, N tile, expert) walks the expert's rows; both
// tiles are [row][k] and [row][n], the reduction down the rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_drhs_kernel(const T* __restrict__ lhs, const T* __restrict__ g,
                    float* __restrict__ out, const int* __restrict__ offsets,
                    int Tn, int K, int N, bool vec_a, bool vec_b,
                    bool pair) {
  __shared__ __align__(16) unsigned char smem[kSmemElems<T> * sizeof(T)];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kSmemElems<T> / 2;
  const int k0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, e = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int r_lo = clamp_row(offsets, e, Tn);
  const int r_hi = clamp_row(offsets, e + 1, Tn);
  for (int r0 = r_lo; r0 < r_hi; r0 += kBK) {
    __syncthreads();
    fill<T, kBK, kBM, kLDC<T>>(sA, lhs, K, r0, r0, r_hi, k0, K, vec_a);
    fill<T, kBK, kBN, kLDC<T>>(sB, g, N, r0, r0, r_hi, n0, N, vec_b);
    __syncthreads();
    step<true, true>(acc, sA, sB, wm, wn);
  }
  store_tile(out + static_cast<long long>(e) * K * N, N, k0, n0, K, N, pair,
             acc, wm, wn);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_fwd(const void* lhs, const void* rhs, void* out,
               const int* offsets, int Tn, int K, int N, int E, long long se,
               long long sk, long long sn, cudaStream_t stream) {
  constexpr long long V = 16 / sizeof(T);
  const dim3 grid((Tn + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_a = aligned16(lhs) && K % V == 0;
  const bool pair = N % 2 == 0;
  const T* a = static_cast<const T*>(lhs);
  const T* b = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  if (sn == 1) {  // the expert weights as stored: contiguous along n
    const bool vec_b = aligned16(rhs) && sk % V == 0 && se % V == 0;
    gmm_fwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        a, b, o, offsets, Tn, K, N, E, se, sk, sn, vec_a, vec_b, pair);
  } else if (sk == 1) {  // transposed (dlhs): contiguous along k
    const bool vec_b = aligned16(rhs) && sn % V == 0 && se % V == 0;
    gmm_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        a, b, o, offsets, Tn, K, N, E, se, sk, sn, vec_a, vec_b, pair);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_drhs(const void* lhs, const void* g, float* out,
                const int* offsets, int Tn, int K, int N, int E,
                cudaStream_t stream) {
  constexpr long long V = 16 / sizeof(T);
  const dim3 grid((K + kBM - 1) / kBM, (N + kBN - 1) / kBN, E);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  gmm_drhs_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(g), out, offsets,
      Tn, K, N, aligned16(lhs) && K % V == 0, aligned16(g) && N % V == 0,
      N % 2 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. lhs [T, K] and out [T, N] are
// contiguous; rhs is [E, K, N] through its element strides (se, sk, sn),
// one of sk, sn equal to 1; offsets int32 [E + 1] on the device; dtype 0
// is float32, 1 bfloat16 (lhs, rhs and out share it). The caller
// allocates the output. Returns 0 or the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int grouped_matmul_forward(const void* lhs, const void* rhs,
                                      void* out, const int* offsets, int T,
                                      int K, int N, int E, long long se,
                                      long long sk, long long sn, int dtype,
                                      void* stream) {
  if (T < 0 || K < 0 || N < 0 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(lhs, rhs, out, offsets, T, K, N, E, se,
                                     sk, sn, s);
  if (dtype == kF32)
    return launch_fwd<float>(lhs, rhs, out, offsets, T, K, N, E, se, sk, sn,
                             s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// lhs [T, K] and g [T, N] contiguous, both of `dtype`; out f32 [E, K, N]
// contiguous, every element written.
extern "C" int grouped_matmul_drhs(const void* lhs, const void* g, float* out,
                                   const int* offsets, int T, int K, int N,
                                   int E, int dtype, void* stream) {
  if (T < 0 || K < 0 || N < 0 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0 || K == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_drhs<__nv_bfloat16>(lhs, g, out, offsets, T, K, N, E, s);
  if (dtype == kF32)
    return launch_drhs<float>(lhs, g, out, offsets, T, K, N, E, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
