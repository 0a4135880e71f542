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
// Two designs share that contract. Both give each output tile to one CTA,
// use no atomics (deterministic) and read nothing on the host.
//
// The TMA / wgmma kernels (gmm_fwd_tma_kernel, gmm_drhs_tma_kernel) take
// bf16 operands that a tensor map can describe: 16-byte aligned bases and
// row strides. A CTA of one producer warp and two consumer warpgroups owns
// a 128 x 128 output tile. The producer's TMA copies fill a ring of three
// 32 KB stages (128-byte swizzle), guarded by full / empty mbarriers; each
// consumer warpgroup runs wgmma m64n128k16 on its 64 rows with f32
// accumulators in registers, keeping one step's products in flight while
// it waits for the next stage. One main loop serves the three products,
// which differ only in operand layout: the forward's A is K-major and its
// B (the weights as stored) MN-major; dlhs reads the weights K-major in
// place; K7's A (lhs read as [K, rows]) and B (g) are both MN-major. With
// 107 KB of shared memory two CTAs share an SM, so one's epilogue overlaps
// the other's main loop. The epilogue stages each warp's 16 rows through
// shared memory and stores 16-byte vectors. The forward runs one
// reduction per expert meeting its rows (TMA zero-fills rows past T and
// the reduction's edge) and stores only that expert's rows, then writes
// zeros to rows no expert owns; an aligned layout runs one reduction a
// tile. K7 walks its expert's rows in 64-row boxes that start at
// offsets[e]; the last box's rows past the range are zeroed in shared
// memory (a generic-proxy write, fenced before wgmma reads it).
//
// The general kernels (gmm_fwd_kernel, gmm_drhs_kernel), the first design,
// take everything else: f32 and bf16 rows TMA cannot describe. A CTA of
// eight warps owns a 128 x 128 output tile (warps 2 x 4, 64 x 32 each);
// its reduction runs in steps of 32. Each operand tile is staged in shared
// memory in its source's own layout, row by row with 16-byte loads and
// stores (a rows x columns copy, no scatter), and the mma fragments are
// read from it as 32-bit pairs where the reduction index is contiguous in
// the row, or by ldmatrix .trans where it runs down the rows (the expert
// weights as stored, and both drhs operands). The forward's CTA finds the
// experts whose row ranges meet its 128 rows by a binary search over
// `offsets` and runs one reduction per such expert with the rows of the
// others read as zeros, so a tile on a group boundary needs no padding and
// rows no expert owns come out as zeros. drhs gives each (expert, K tile,
// N tile) one CTA that walks that expert's rows and accumulates in
// registers. bf16 products run on the tensor cores as mma.sync m16n8k16
// with f32 accumulators; f32 inputs take the same tiles with the product
// as f32 FMAs on the CUDA cores (true f32, no TF32, as the JAX package
// pins f32 to HIGHEST). Any T, K and N: tile edges are masked, and rows
// whose length or alignment rules out 16-byte loads are read element by
// element.
//
// What bounds them. At the MoE geometries (T 16384, K 1024, N 4096; T
// 40960, K 768 / 3072, N 3072 / 768) each call is 2 T K N flops (1.4e11
// and 1.9e11) against 0.1-0.3 GB of operands: bound by tensor-core
// operations. K7 also writes 4 E K N bytes of f32, near half its byte
// bound at the op bench's geometry. The general kernels load
// synchronously with one tile in flight; the TMA kernels keep two stages
// of loads ahead of the tensor cores.

#include <cuda.h>
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


// ---------------------------------------------------------------------------
// The TMA / wgmma design (bf16)
// ---------------------------------------------------------------------------

constexpr int kTM = 128;                      // output rows a CTA owns
constexpr int kTN = 128;                      // output columns
constexpr int kTK = 64;                       // reduction step: 128-byte rows
constexpr int kStages = 3;                    // depth of the ring
constexpr int kConsumers = 256;               // two warpgroups run wgmma
constexpr int kTmaThreads = kConsumers + 32;  // and one producer warp
constexpr int kAcc = kTN / 2;                 // f32 accumulators a thread
constexpr int kPanel = 64 * kTK * 2;          // a 64 x 64 bf16 box: 8 KB
constexpr int kATile = kTM * kTK * 2;         // 16 KB
constexpr int kStage = kATile + kTN * kTK * 2;  // 32 KB
constexpr int kOutBuf = 16 * 64;              // a warp's epilogue rows
constexpr int kPanels = kStage / kPanel;      // 64-wide panels a stage
// the ring, eight epilogue buffers, the barriers and room to align to
// 1024 bytes (the 128-byte swizzle's period): 107 KB, two CTAs an SM
constexpr int kTmaSmem =
    kStages * kStage + (kConsumers / 32) * kOutBuf + 2 * kStages * 8 + 1024;
constexpr int kTmaCtas = kTmaSmem <= 113 * 1024 ? 2 : 1;  // CTAs an SM
static_assert(kATile == 2 * kPanel && kTN % 64 == 0,
              "a stage is whole 64-row panels, two of them A's");

extern __shared__ __align__(1024) unsigned char gmm_smem[];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits until the barrier's phase of this parity has completed. A wait
// past 10 s traps: a broken ring fails the launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > 10000000000ull) __trap();
}

// one box of a 2-D / 3-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// The descriptor of reduction slice kk (16 deep) of an operand tile.
// K-major (kMN false): 128-byte rows along the reduction, eight-row groups
// 1024 bytes apart; the slice starts 32 bytes further along the row.
// MN-major: 128-byte rows along M or N, one a reduction index, 64-wide
// panels kPanel apart (the leading offset); the slice starts 16 rows down.
template <bool kMN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int kk) {
  return kMN ? gmma_desc(tile + kk * 16 * 128, kPanel, 1024)
             : gmma_desc(tile + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 of the warpgroup, f32) += A (64 x 16) B (16 x 128), both from
// shared memory; kTA / kTB: the operand is MN-major (transposed). Thread
// 32 q + 4 g + t holds rows 16 q + g (+ 8) and columns 8 j + 2 t (+ 1):
// d[4 j] = (16 q + g, 8 j + 2 t), d[4 j + 1] its right neighbour,
// d[4 j + 2], d[4 j + 3] the same eight rows down.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[kAcc], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// The 1024-aligned shared memory of a CTA: the ring's stages, the
// consumer warps' epilogue buffers, then full[s] and empty[s].
struct Ring {
  unsigned char* p;  // generic address
  uint32_t s;        // the same in the shared window
  __device__ uint32_t a(int st) const { return s + st * kStage; }
  __device__ uint32_t b(int st) const { return a(st) + kATile; }
  __device__ unsigned char* stage(int st) const { return p + st * kStage; }
  __device__ unsigned char* out_buf(int warp) const {
    return p + kStages * kStage + warp * kOutBuf;
  }
  __device__ uint32_t full(int st) const {
    return s + kStages * kStage + (kConsumers / 32) * kOutBuf + 8 * st;
  }
  __device__ uint32_t empty(int st) const { return full(st) + 8 * kStages; }
};

// The ring of this CTA, its barriers initialised: full[s] completes with
// the producer's arrival and the stage's bytes, empty[s] with every
// consumer thread's arrival.
__device__ __forceinline__ Ring make_ring() {
  const uint32_t raw = smem_u32(gmm_smem);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const Ring ring{gmm_smem + pad, raw + pad};
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(ring.full(st), 1);
      mbar_init(ring.empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// a position in the ring: the stage and the parity of its current round
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The producer's side of one stage: wait until the consumers released it,
// then announce its bytes; the caller issues the copies onto full.
__device__ __forceinline__ uint32_t produce(const Ring& ring, const Pipe& p) {
  mbar_wait(ring.empty(p.stage), p.phase ^ 1);
  const uint32_t full = ring.full(p.stage);
  mbar_expect_tx(full, kStage);
  return full;
}

// K7's last box reaches past its expert's rows: rows [valid, kTK) of every
// panel of the stage (both operands) become zeros. The consumers write
// them through the generic proxy and fence before wgmma reads.
__device__ __forceinline__ void zero_tail(unsigned char* stage, int valid) {
  const int per = (kTK - valid) * 8;  // 16-byte vectors a panel
  for (int i = threadIdx.x; i < kPanels * per; i += kConsumers)
    *reinterpret_cast<int4*>(stage + (i / per) * kPanel + valid * 128 +
                             (i % per) * 16) = make_int4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The main loop: acc += A B over `steps` stages of the ring, warpgroup wg's
// 64 rows of A against all kTN columns of B. kAT / kBT: A / B MN-major.
// `valid` (K7 only, with kAT) is the rows of the reduction the last stage
// holds. One step's products stay in flight while the next stage is
// awaited; a stage goes back to the producer when its products are done.
template <bool kAT, bool kBT>
__device__ __forceinline__ void mainloop(float (&acc)[kAcc], const Ring& ring,
                                         Pipe& p, int steps, int valid,
                                         int wg) {
  int prev = -1;
  for (int it = 0; it < steps; ++it) {
    mbar_wait(ring.full(p.stage), p.phase);
    if (kAT && it == steps - 1 && valid < kTK)
      zero_tail(ring.stage(p.stage), valid);
    const uint32_t a = ring.a(p.stage) + wg * kPanel, b = ring.b(p.stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      wgmma<kAT, kBT>(acc, operand_desc<kAT>(a, kk), operand_desc<kBT>(b, kk));
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(ring.empty(prev));
    prev = p.stage;
    p.next();
  }
  wgmma_wait<0>();
  if (prev >= 0) mbar_arrive(ring.empty(prev));
}

__device__ __forceinline__ void put2(unsigned char* p, float lo, float hi,
                                     __nv_bfloat16*) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void put2(unsigned char* p, float lo, float hi,
                                     float*) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// The epilogue of one consumer warp: its 16 accumulator rows (starting at
// output row row0, columns col0 ..) into out (row stride ld), rows in
// [lo, hi) and columns below ncols only. Chunks of 64 bytes a row go
// through the warp's buffer (16-byte groups XOR-swizzled by row, so
// neither the fragment writes nor the row reads conflict) and leave as
// 16-byte stores; ncols is a multiple of the vector.
template <typename O>
__device__ __forceinline__ void store_acc(const float (&acc)[kAcc],
                                          unsigned char* buf, O* out,
                                          long long ld, int row0, int col0,
                                          int lo, int hi, int ncols) {
  constexpr int kCols = 64 / sizeof(O);  // columns a chunk
  constexpr int kVec = 16 / sizeof(O);   // columns a vector
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto swz = [](int r) { return sizeof(O) == 2 ? (r >> 1) & 3 : r & 2; };
#pragma unroll
  for (int c = 0; c < kTN / kCols; ++c) {
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int jb = c * (kCols / 8) + j;
      const int byte = (8 * j + 2 * t) * static_cast<int>(sizeof(O));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        put2(buf + r * 64 + (((byte >> 4) ^ swz(r)) << 4) + (byte & 15),
             acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1],
             static_cast<O*>(nullptr));
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = lane + 32 * i, r = v >> 2, q = v & 3;
      const int row = row0 + r, col = col0 + c * kCols + q * kVec;
      const int4 x =
          *reinterpret_cast<const int4*>(buf + r * 64 + ((q ^ swz(r)) << 4));
      if (row >= lo && row < hi && col < ncols)
        *reinterpret_cast<int4*>(out + row * ld + col) = x;
    }
    __syncwarp();
  }
}

// K6 on the TMA ring: one CTA per (kTN-column, 128-row) output tile. A is
// lhs [T, K] (box 64 x 128, K-major). kBK: B is the transposed weights
// (dlhs), K-major, one box of 64 x kTN from the map [K, N, E]; else the
// weights as stored, MN-major, boxes of 64 x 64 from [N, K, E].
template <bool kBK>
__global__ void __launch_bounds__(kTmaThreads, kTmaCtas)
    gmm_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ offsets, int Tn, int K, int N,
                       int E) {
  const Ring ring = make_ring();
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * kTM;
  const int warp = threadIdx.x >> 5;
  const int steps = (K + kTK - 1) / kTK;
  // the first expert whose rows end past m0 (offsets are non-decreasing)
  int first = 0;
  for (int hi = E; first < hi;) {
    const int mid = (first + hi) >> 1;
    if (clamp_row(offsets, mid + 1, Tn) > m0)
      hi = mid;
    else
      first = mid + 1;
  }
  if (warp == kConsumers / 32) {  // the producer warp: one lane copies
    if ((threadIdx.x & 31) == 0) {
      Pipe p;
      for (int e = first; e < E; ++e) {
        const int r_lo = clamp_row(offsets, e, Tn);
        if (r_lo >= m0 + kTM) break;
        const int r_hi = min(clamp_row(offsets, e + 1, Tn), m0 + kTM);
        if (r_hi <= max(r_lo, m0)) continue;  // no rows of this tile
        for (int s = 0; s < steps; ++s, p.next()) {
          const uint32_t full = produce(ring, p);
          const uint32_t b = ring.b(p.stage);
          tma_load(ring.a(p.stage), &map_a, full, s * kTK, m0);
          if (kBK) {
            tma_load(b, &map_b, full, s * kTK, n0, e);
          } else {
            for (int c = 0; c < kTN / 64; ++c)
              tma_load(b + c * kPanel, &map_b, full, n0 + 64 * c, s * kTK,
                       e);
          }
        }
      }
    }
    return;
  }
  const int wg = warp >> 2;
  const int row0 = m0 + wg * 64 + (warp & 3) * 16;
  float acc[kAcc];
  Pipe p;
  for (int e = first; e < E; ++e) {
    const int r_lo = clamp_row(offsets, e, Tn);
    if (r_lo >= m0 + kTM) break;
    const int r_hi = min(clamp_row(offsets, e + 1, Tn), m0 + kTM);
    if (r_hi <= max(r_lo, m0)) continue;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    mainloop<false, !kBK>(acc, ring, p, steps, kTK, wg);
    // only expert e's rows: the tile's other rows met other weights
    store_acc(acc, ring.out_buf(warp), out, N, row0, n0, max(r_lo, m0), r_hi,
              N);
  }
  // rows no expert owns are zeros
  const int own_lo = clamp_row(offsets, 0, Tn), own_hi = clamp_row(offsets, E, Tn);
  const int tile_hi = min(m0 + kTM, Tn);
  if (own_lo > m0 || own_hi < tile_hi) {
    constexpr int kVecs = kTN / 8;
    for (int i = threadIdx.x; i < kTM * kVecs; i += kConsumers) {
      const int row = m0 + i / kVecs, col = n0 + (i % kVecs) * 8;
      if (row < tile_hi && (row < own_lo || row >= own_hi) && col < N)
        *reinterpret_cast<int4*>(out + static_cast<long long>(row) * N +
                                 col) = make_int4(0, 0, 0, 0);
    }
  }
}

// K7 on the TMA ring: one CTA per (N tile, K tile, expert) walks the
// expert's rows from offsets[e] in boxes of 64; A is lhs read as [K, rows]
// and B is g [rows, N], both MN-major, in 64 x 64 boxes.
__global__ void __launch_bounds__(kTmaThreads, kTmaCtas)
    gmm_drhs_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        float* __restrict__ out,
                        const int* __restrict__ offsets, int Tn, int K,
                        int N) {
  const Ring ring = make_ring();
  const int n0 = blockIdx.x * kTN, k0 = blockIdx.y * kTM, e = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int r_lo = clamp_row(offsets, e, Tn);
  const int rows = max(clamp_row(offsets, e + 1, Tn) - r_lo, 0);
  const int steps = (rows + kTK - 1) / kTK;
  if (warp == kConsumers / 32) {
    if ((threadIdx.x & 31) == 0) {
      Pipe p;
      for (int s = 0; s < steps; ++s, p.next()) {
        const uint32_t full = produce(ring, p);
        const uint32_t a = ring.a(p.stage), b = ring.b(p.stage);
        const int r0 = r_lo + s * kTK;
        tma_load(a, &map_a, full, k0, r0);
        tma_load(a + kPanel, &map_a, full, k0 + 64, r0);
        for (int c = 0; c < kTN / 64; ++c)
          tma_load(b + c * kPanel, &map_b, full, n0 + 64 * c, r0);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  Pipe p;
  mainloop<true, true>(acc, ring, p, steps, rows - (steps - 1) * kTK, wg);
  store_acc(acc, ring.out_buf(warp),
            out + static_cast<long long>(e) * K * N, N,
            k0 + wg * 64 + (warp & 3) * 16, n0, 0, K, N);
}

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map with 128-byte swizzle, zeros out of bounds: dims
// innermost first, strides (in elements) of dims 1 .. rank - 1.
bool tensor_map(CUtensorMap* map, const void* base, int rank,
                const long long* dims, const long long* strides,
                const int* box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], one[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i + 1 < rank; ++i)
    s[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), d, s, b, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kEncodeFailed = -1;

template <typename Kernel, typename... Args>
int launch_tma(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, kTmaThreads, kTmaSmem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_tma(const void* lhs, const void* rhs, void* out,
                   const int* offsets, int Tn, int K, int N, int E,
                   long long se, long long sk, long long sn,
                   cudaStream_t stream) {
  // B's contiguous dimension (N as stored, K transposed), its strided one
  const bool mn = sn == 1;
  const long long inner = mn ? N : K, outer = mn ? K : N, so = mn ? sk : sn;
  if (E == 1) se = so * outer;  // one expert: its stride is never taken
  if (!(mn || sk == 1) || !aligned16(lhs) || !aligned16(rhs) ||
      !aligned16(out) || K % 8 || N % 8 || so % 8 || se % 8 || so < inner ||
      se < so * outer)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTN - 1) / kTN, (Tn + kTM - 1) / kTM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  const long long da[2] = {K, Tn}, sa[1] = {K};
  const int ba[2] = {kTK, kTM};
  const long long db[3] = {inner, outer, E}, sb[2] = {so, se};
  const int bb[3] = {64, mn ? kTK : kTN, 1};
  if (!tensor_map(&ma, lhs, 2, da, sa, ba) ||
      !tensor_map(&mb, rhs, 3, db, sb, bb))
    return kEncodeFailed;
  auto* o = static_cast<__nv_bfloat16*>(out);
  return mn ? launch_tma(gmm_fwd_tma_kernel<false>, grid, stream, ma, mb, o,
                         offsets, Tn, K, N, E)
            : launch_tma(gmm_fwd_tma_kernel<true>, grid, stream, ma, mb, o,
                         offsets, Tn, K, N, E);
}

int launch_drhs_tma(const void* lhs, const void* g, float* out,
                    const int* offsets, int Tn, int K, int N, int E,
                    cudaStream_t stream) {
  if (!aligned16(lhs) || !aligned16(g) || !aligned16(out) || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTN - 1) / kTN, (K + kTM - 1) / kTM, E);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  const long long da[2] = {K, Tn}, sa[1] = {K};
  const long long db[2] = {N, Tn}, sb[1] = {N};
  const int box[2] = {64, kTK};
  if (!tensor_map(&ma, lhs, 2, da, sa, box) ||
      !tensor_map(&mb, g, 2, db, sb, box))
    return kEncodeFailed;
  return launch_tma(gmm_drhs_tma_kernel, grid, stream, ma, mb, out, offsets,
                    Tn, K, N);
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

// The TMA / wgmma kernels (bf16 only), for the calls grouped_matmul.py's
// predicate sends them: T, K, N and (forward) E positive, lhs / g and the
// output with 16-byte aligned bases and K, N multiples of 8; for the
// forward, rhs's base aligned and its strides nested and multiples of 8
// elements. The arguments are the general entries' (the dtype implied);
// drhs with no expert writes nothing, as the general entry. Returns 0, the
// cudaError_t of the launch, cudaErrorInvalidValue for arguments these
// kernels do not take, or -1 when cuTensorMapEncodeTiled refuses a map.
extern "C" int grouped_matmul_forward_tma(const void* lhs, const void* rhs,
                                          void* out, const int* offsets,
                                          int T, int K, int N, int E,
                                          long long se, long long sk,
                                          long long sn, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd_tma(lhs, rhs, out, offsets, T, K, N, E, se, sk, sn,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_matmul_drhs_tma(const void* lhs, const void* g,
                                       float* out, const int* offsets, int T,
                                       int K, int N, int E, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;  // no expert: an empty output
  return launch_drhs_tma(lhs, g, out, offsets, T, K, N, E,
                         static_cast<cudaStream_t>(stream));
}
