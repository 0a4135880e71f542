// The fused optimizer step's two kernels, for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: paddle_tpu/optimizer/
// fused_step.py compiles the whole optimizer step (unscale, finite check,
// clip, every Adam/AdamW update and the skip of a non-finite step) into
// one XLA program. These two kernels are that program on the card:
//
//   O1 multi_tensor_unscale_norm: one pass over every gradient. With a
//      loss scale it first unscales in place, (g.f32 * inv_scale) rounded
//      back to the gradient's dtype (fused_step.py _unscale_fn), then
//      writes an f32 sum of squares and a non-finite flag for each
//      (tensor, chunk) block. The last block of a tensor to finish (an
//      atomic ticket, left at zero) adds its tensor's partials in a fixed
//      order (each thread a strided run of chunks, then the block's tree).
//      A one-block finalize launch then adds the tensors in
//      parameter order (a Python sum in the JAX package,
//      utils/clip_grad.py:50-52) and writes to device memory the found
//      flag, the global norm and the clip scale: cn / max(norm, cn) for
//      ClipGradByGlobalNorm, min(cn / max(norm_i, 1e-12), 1) per tensor
//      for ClipGradByNorm. No float atomics: the result is the same on
//      every run.
//   O2 multi_tensor_adam: one pass over every parameter: clip (the
//      scale from O1, or a value clamp), the L2 or decoupled decay, the
//      Adam moments and bias corrections, the parameter, each written in
//      place; lr, the clip scale and the found flags are read from device
//      memory, so no step syncs with the host. A found flag set skips
//      every write (where(found, old, new), fused_step.py:240-248). The
//      beta powers, read by every block of their parameter, are written
//      by the parameter's last block (an atomic ticket).
//
// Numerics: every operation is its own f32 operation with
// round-to-nearest (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: nvcc would otherwise contract a*b + c into an FMA), in the
// order of the per-parameter loop (paddle_tpu_torch/optimizer/
// optimizer.py Adam._update), with the host's Python-float constants
// rounded to f32 once (1 - beta1 is computed in double on the host). A
// clipped or unscaled gradient is rounded to its own dtype before the
// update, as the JAX package's (g * s).astype(g.dtype). Parameters,
// gradients and moments are each f32, bf16 or f16, each role on its own. So the update is
// bit-equal to the loop and to its plain version; only O1's sums of
// squares add in another order.
//
// Bound: bytes. O2 reads p, g, m1, m2 and writes p, m1, m2 once (14 B a
// parameter for bf16 parameters, gradients and moments); O1 reads the
// gradients once (2 B), twice with a write when it unscales. The design:
// (tensor, chunk) blocks of 32768 elements over a grid, 16-byte vector
// loads and stores (8 elements a thread a step) where every pointer of a
// tensor is 16-byte aligned, a scalar path for the others and for tails.
// The table of tensors travels in the kernel's parameters (up to 256
// tensors a launch, about 18 KB; CUDA 12.1+ takes 32 KB), so nothing is
// uploaded; more tensors take more launches.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements a thread moves per step
constexpr int kChunk = 32768;      // elements of one (tensor, chunk) block
constexpr int kMaxTensors = 256;   // tensors one launch's parameters carry

// table row of one tensor, as the Python wrapper writes it (int64 x 8)
enum Col { kP = 0, kG, kM1, kM2, kB1p, kB2p, kNumel, kCode, kCols };
// code: bits 0-1 the parameter's dtype, 2-3 the gradient's, 4-5 the
// moments' (Dt); bit 6 decay on
enum Dt { kF32 = 0, kBf16 = 1, kF16 = 2 };
enum Code { kGShift = 2, kMShift = 4, kUseWd = 64 };
__device__ __forceinline__ int dt_of(int code, int shift) {
  return (code >> shift) & 3;
}

struct Batch {
  int n;            // tensors in this launch
  int first;        // global index of the first one
  int chunk_base;   // global index of its first chunk (O1's partials)
  int chunk_start[kMaxTensors + 1];   // chunks before each tensor
  void* p[kMaxTensors];
  void* g[kMaxTensors];
  void* m1[kMaxTensors];
  void* m2[kMaxTensors];
  float* b1p[kMaxTensors];
  float* b2p[kMaxTensors];
  long long numel[kMaxTensors];
  int code[kMaxTensors];
  float wd[kMaxTensors];
};

struct AdamArgs {
  float b1, b2, omb1, omb2, eps;   // beta1, beta2, 1 - beta1, 1 - beta2
  float lo, hi;                    // value clip bounds
  int clip;                        // 0 none, 1 global scale, 2 per tensor, 3 value
  int decoupled;                   // AdamW
};

typedef __nv_bfloat16 bf16;
typedef __half f16;

template <typename T> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ void load(const float* p, float x[kVec]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float x[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <> struct Io<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float x[kVec]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float x[kVec]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ float get(const bf16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(bf16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <> struct Io<f16> {
  static __device__ __forceinline__ void load(const f16* p, float x[kVec]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __half22float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(f16* p, const float x[kVec]) {
    uint4 v;
    __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i)
      h[i] = __floats2half2_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ float get(const f16* p) {
    return __half2float(*p);
  }
  static __device__ __forceinline__ void put(f16* p, float x) {
    *p = __float2half_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// max / min that return NaN when either operand is NaN (torch.maximum,
// torch.clamp and jnp.maximum do; fmaxf and fminf do not)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// the tensor of a block: chunk_start[t] <= blk < chunk_start[t + 1]
__device__ __forceinline__ int find_tensor(const Batch& b, int blk) {
  int lo = 0, hi = b.n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (b.chunk_start[mid] <= blk) lo = mid; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// O1
// ---------------------------------------------------------------------------

template <typename G>
__device__ __forceinline__ void o1_elem(float& x, bool unscale, float inv,
                                        float& acc, bool& bad) {
  if (unscale) x = Io<G>::round(__fmul_rn(x, inv));
  bad |= !isfinite(x);
  acc = __fmaf_rn(x, x, acc);
}

template <typename G>
__device__ void o1_chunk(G* g, long long lo, long long hi, bool unscale,
                         float inv, float& acc, bool& bad) {
  long long e0 = lo;
  if (aligned16(g)) {
    const long long nvec = (hi - lo) / kVec;
    for (long long k = threadIdx.x; k < nvec; k += kThreads) {
      const long long e = lo + k * kVec;
      float x[kVec];
      Io<G>::load(g + e, x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) o1_elem<G>(x[j], unscale, inv, acc, bad);
      if (unscale) Io<G>::store(g + e, x);
    }
    e0 = lo + nvec * kVec;
  }
  for (long long e = e0 + threadIdx.x; e < hi; e += kThreads) {
    float x = Io<G>::get(g + e);
    o1_elem<G>(x, unscale, inv, acc, bad);
    if (unscale) Io<G>::put(g + e, x);
  }
}

// sum over the block in a fixed tree: warps by shuffles, then the warps'
// sums in order; the OR of the flags. Thread 0 gets the results.
__device__ __forceinline__ void block_reduce(float& acc, bool& bad) {
  __shared__ float s_acc[kThreads / 32];
  __shared__ int s_bad[kThreads / 32];
  int flag = bad;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
    flag |= __shfl_down_sync(0xffffffffu, flag, o);
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_acc[w] = acc;
    s_bad[w] = flag;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    acc = s_acc[0];
    flag = s_bad[0];
    for (int i = 1; i < kThreads / 32; ++i) {
      acc = __fadd_rn(acc, s_acc[i]);
      flag |= s_bad[i];
    }
    bad = flag;
  }
}

__global__ void __launch_bounds__(kThreads)
multi_tensor_unscale_norm_kernel(const __grid_constant__ Batch b, const float* inv_scale,
                    float* partials, unsigned char* chunk_bad, float* sumsq,
                    unsigned char* tensor_bad, int* tickets) {
  const int t = find_tensor(b, blockIdx.x);
  const int nchunks = b.chunk_start[t + 1] - b.chunk_start[t];
  const long long lo = (long long)(blockIdx.x - b.chunk_start[t]) * kChunk;
  const long long hi = min(lo + kChunk, b.numel[t]);
  const bool unscale = inv_scale != nullptr;
  const float inv = unscale ? *inv_scale : 1.0f;
  float acc = 0.0f;
  bool bad = false;
  switch (dt_of(b.code[t], kGShift)) {
    case kF32: o1_chunk<float>(static_cast<float*>(b.g[t]), lo, hi, unscale, inv, acc, bad); break;
    case kBf16: o1_chunk<bf16>(static_cast<bf16*>(b.g[t]), lo, hi, unscale, inv, acc, bad); break;
    default: o1_chunk<f16>(static_cast<f16*>(b.g[t]), lo, hi, unscale, inv, acc, bad); break;
  }
  block_reduce(acc, bad);
  __shared__ int s_last;
  const int tg = b.first + t;
  if (threadIdx.x == 0) {
    const int slot = b.chunk_base + blockIdx.x;
    partials[slot] = acc;
    chunk_bad[slot] = bad;
    __threadfence();
    s_last = atomicAdd(&tickets[tg], 1) == nchunks - 1;
  }
  __syncthreads();
  if (s_last) {
    // the last block of this tensor adds its partials: thread i those of
    // chunks i, i + 256, ... in order, then the block's fixed tree (a
    // sum in chunk order would lose ~sqrt(chunks) roundings: 1e-6 at the
    // 4,000 chunks of a 7B model's embedding)
    __threadfence();
    const int base = b.chunk_base + b.chunk_start[t];
    float s = 0.0f;
    bool any = false;
    for (int k = threadIdx.x; k < nchunks; k += kThreads) {
      s = __fadd_rn(s, __ldcg(partials + base + k));
      any |= __ldcg(chunk_bad + base + k) != 0;
    }
    block_reduce(s, any);
    if (threadIdx.x == 0) {
      sumsq[tg] = s;
      tensor_bad[tg] = any;
      tickets[tg] = 0;
    }
  }
}

// one block: found = OR of the tensors' flags; stats[n] = the global norm
// (the tensors' sums added in parameter order); the clip scale
__global__ void __launch_bounds__(kThreads)
multi_tensor_finalize_kernel(int n, float* stats, const unsigned char* tensor_bad,
                unsigned char* found, int clip, float clip_norm,
                float* scale) {
  __shared__ int s_bad;
  if (threadIdx.x == 0) s_bad = 0;
  __syncthreads();
  int any = 0;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    any |= tensor_bad[t];
    if (clip == 2) {
      const float norm = __fsqrt_rn(stats[t]);
      scale[t] = min_nan(__fdiv_rn(clip_norm, max_nan(norm, 1e-12f)), 1.0f);
    }
  }
  if (any) atomicOr(&s_bad, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int t = 0; t < n; ++t) total = __fadd_rn(total, stats[t]);
    const float norm = __fsqrt_rn(total);
    stats[n] = norm;
    if (clip == 1) scale[0] = __fdiv_rn(clip_norm, max_nan(norm, clip_norm));
    if (found != nullptr) *found = s_bad != 0;
  }
}

// ---------------------------------------------------------------------------
// O2
// ---------------------------------------------------------------------------

struct Step {
  AdamArgs a;
  float lr, scale, bc1, bc2, wd;   // wd 0 when the tensor has no decay
  bool use_wd;
};

template <typename G>
__device__ __forceinline__ void adam_elem(float& p, float g, float& m1,
                                          float& m2, const Step& s) {
  if (s.a.clip == 3) {   // min(max(g, lo), hi); NaN stays NaN
    g = g < s.a.lo ? s.a.lo : g;
    g = Io<G>::round(g > s.a.hi ? s.a.hi : g);
  } else if (s.a.clip != 0) {
    g = Io<G>::round(__fmul_rn(g, s.scale));
  }
  if (s.use_wd && !s.a.decoupled) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m1 = __fadd_rn(__fmul_rn(s.a.b1, m1), __fmul_rn(s.a.omb1, g));
  m2 = __fadd_rn(__fmul_rn(s.a.b2, m2),
                 __fmul_rn(__fmul_rn(s.a.omb2, g), g));
  const float m1h = __fdiv_rn(m1, s.bc1);
  const float m2h = __fdiv_rn(m2, s.bc2);
  float upd = __fdiv_rn(m1h, __fadd_rn(__fsqrt_rn(m2h), s.a.eps));
  if (s.use_wd && s.a.decoupled) upd = __fadd_rn(upd, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

template <typename P, typename G, typename M>
__device__ void adam_chunk(void* pv, const void* gv, void* m1v, void* m2v,
                           long long lo, long long hi, const Step& s) {
  P* p = static_cast<P*>(pv);
  const G* g = static_cast<const G*>(gv);
  M* m1 = static_cast<M*>(m1v);
  M* m2 = static_cast<M*>(m2v);
  long long e0 = lo;
  if (aligned16(p) && aligned16(g) && aligned16(m1) && aligned16(m2)) {
    const long long nvec = (hi - lo) / kVec;
    for (long long k = threadIdx.x; k < nvec; k += kThreads) {
      const long long e = lo + k * kVec;
      float xp[kVec], xg[kVec], x1[kVec], x2[kVec];
      Io<P>::load(p + e, xp);
      Io<G>::load(g + e, xg);
      Io<M>::load(m1 + e, x1);
      Io<M>::load(m2 + e, x2);
#pragma unroll
      for (int j = 0; j < kVec; ++j) adam_elem<G>(xp[j], xg[j], x1[j], x2[j], s);
      Io<P>::store(p + e, xp);
      Io<M>::store(m1 + e, x1);
      Io<M>::store(m2 + e, x2);
    }
    e0 = lo + nvec * kVec;
  }
  for (long long e = e0 + threadIdx.x; e < hi; e += kThreads) {
    float xp = Io<P>::get(p + e), x1 = Io<M>::get(m1 + e),
          x2 = Io<M>::get(m2 + e);
    adam_elem<G>(xp, Io<G>::get(g + e), x1, x2, s);
    Io<P>::put(p + e, xp);
    Io<M>::put(m1 + e, x1);
    Io<M>::put(m2 + e, x2);
  }
}

// the chunk's instance for its tensor's dtypes: moments, then gradient,
// then parameter
template <typename P, typename G>
__device__ void adam_chunk_m(int code, void* p, const void* g, void* m1,
                             void* m2, long long lo, long long hi,
                             const Step& s) {
  switch (dt_of(code, kMShift)) {
    case kF32: adam_chunk<P, G, float>(p, g, m1, m2, lo, hi, s); break;
    case kBf16: adam_chunk<P, G, bf16>(p, g, m1, m2, lo, hi, s); break;
    default: adam_chunk<P, G, f16>(p, g, m1, m2, lo, hi, s); break;
  }
}

template <typename P>
__device__ void adam_chunk_g(int code, void* p, const void* g, void* m1,
                             void* m2, long long lo, long long hi,
                             const Step& s) {
  switch (dt_of(code, kGShift)) {
    case kF32: adam_chunk_m<P, float>(code, p, g, m1, m2, lo, hi, s); break;
    case kBf16: adam_chunk_m<P, bf16>(code, p, g, m1, m2, lo, hi, s); break;
    default: adam_chunk_m<P, f16>(code, p, g, m1, m2, lo, hi, s); break;
  }
}

__global__ void __launch_bounds__(kThreads)
multi_tensor_adam_kernel(const __grid_constant__ Batch b, AdamArgs a, const float* lr,
            const float* scale, const unsigned char* found_a,
            const unsigned char* found_b, int* tickets) {
  // a non-finite step writes nothing: parameters, moments and powers
  // keep their old values
  if ((found_a != nullptr && *found_a) || (found_b != nullptr && *found_b))
    return;
  const int t = find_tensor(b, blockIdx.x);
  const int nchunks = b.chunk_start[t + 1] - b.chunk_start[t];
  const long long lo = (long long)(blockIdx.x - b.chunk_start[t]) * kChunk;
  const long long hi = min(lo + kChunk, b.numel[t]);
  Step s;
  s.a = a;
  s.lr = *lr;
  s.scale = a.clip == 1 ? scale[0] : (a.clip == 2 ? scale[b.first + t] : 1.0f);
  const float b1p = __fmul_rn(*b.b1p[t], a.b1);
  const float b2p = __fmul_rn(*b.b2p[t], a.b2);
  s.bc1 = __fsub_rn(1.0f, b1p);
  s.bc2 = __fsub_rn(1.0f, b2p);
  s.use_wd = (b.code[t] & kUseWd) != 0;
  s.wd = b.wd[t];
  const int code = b.code[t];
  switch (dt_of(code, 0)) {
    case kF32: adam_chunk_g<float>(code, b.p[t], b.g[t], b.m1[t], b.m2[t], lo, hi, s); break;
    case kBf16: adam_chunk_g<bf16>(code, b.p[t], b.g[t], b.m1[t], b.m2[t], lo, hi, s); break;
    default: adam_chunk_g<f16>(code, b.p[t], b.g[t], b.m1[t], b.m2[t], lo, hi, s); break;
  }
  // the powers: every block of this tensor has read the old ones once
  // it has taken its ticket, so the last one writes the new ones
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int tg = b.first + t;
    if (atomicAdd(&tickets[tg], 1) == nchunks - 1) {
      *b.b1p[t] = b1p;
      *b.b2p[t] = b2p;
      tickets[tg] = 0;
    }
  }
}

int chunks_of(long long numel) {
  const long long c = (numel + kChunk - 1) / kChunk;
  return c > 0 ? (int)c : 1;   // an empty tensor takes one (empty) block
}

// fills b with the tensors [first, first + count) of the table; returns
// the batch's chunks
int fill_batch(Batch& b, const long long* table, const float* wd, int first,
               int count, int chunk_base) {
  b.n = count;
  b.first = first;
  b.chunk_base = chunk_base;
  int chunks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* row = table + (long long)(first + i) * kCols;
    b.chunk_start[i] = chunks;
    b.p[i] = reinterpret_cast<void*>(row[kP]);
    b.g[i] = reinterpret_cast<void*>(row[kG]);
    b.m1[i] = reinterpret_cast<void*>(row[kM1]);
    b.m2[i] = reinterpret_cast<void*>(row[kM2]);
    b.b1p[i] = reinterpret_cast<float*>(row[kB1p]);
    b.b2p[i] = reinterpret_cast<float*>(row[kB2p]);
    b.numel[i] = row[kNumel];
    b.code[i] = (int)row[kCode];
    b.wd[i] = wd != nullptr ? wd[first + i] : 0.0f;
    chunks += chunks_of(row[kNumel]);
  }
  b.chunk_start[count] = chunks;
  return chunks;
}

}  // namespace

extern "C" {

// the kernels' chunk (elements a block takes) and tensors a launch takes
void mt_config(int* chunk, int* max_tensors) {
  *chunk = kChunk;
  *max_tensors = kMaxTensors;
}

// O1 over the table's n gradients (int64 [n, 8] rows, see Col): unscale by
// *inv_scale in place when inv_scale is not null; stats [n + 1] gets the
// per-tensor sums of squares and the global norm, scale the clip scale
// (clip 1: [1], 2: [n]), found (when not null) the non-finite flag.
// partials / chunk_bad hold one slot a chunk, tickets n zeroed ints (left
// zeroed). *launches gets the kernels launched. Returns a cudaError_t.
int mt_unscale_norm(const long long* table, int n, const float* inv_scale,
                    float* partials, unsigned char* chunk_bad,
                    unsigned char* tensor_bad, int* tickets, float* stats,
                    int clip, float clip_norm, float* scale,
                    unsigned char* found, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Batch b;
  int chunk_base = 0;
  *launches = 0;
  for (int first = 0; first < n; first += kMaxTensors) {
    const int count = n - first < kMaxTensors ? n - first : kMaxTensors;
    const int chunks = fill_batch(b, table, nullptr, first, count, chunk_base);
    multi_tensor_unscale_norm_kernel<<<chunks, kThreads, 0, st>>>(
        b, inv_scale, partials, chunk_bad, stats, tensor_bad, tickets);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
    chunk_base += chunks;
  }
  multi_tensor_finalize_kernel<<<1, kThreads, 0, st>>>(n, stats, tensor_bad, found, clip,
                                          clip_norm, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return 0;
}

// O2 over the table's n parameters, in place; wd [n] f32 decay
// coefficients (used where the row's code has kUseWd). found_a / found_b
// may be null. tickets: n zeroed ints (left zeroed).
int mt_adam(const long long* table, const float* wd, int n, const float* lr,
            const float* scale, int clip, float lo, float hi,
            const unsigned char* found_a, const unsigned char* found_b,
            float b1, float b2, float omb1, float omb2, float eps,
            int decoupled, int* tickets, int* launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  AdamArgs a{b1, b2, omb1, omb2, eps, lo, hi, clip, decoupled};
  Batch b;
  *launches = 0;
  for (int first = 0; first < n; first += kMaxTensors) {
    const int count = n - first < kMaxTensors ? n - first : kMaxTensors;
    const int chunks = fill_batch(b, table, wd, first, count, 0);
    multi_tensor_adam_kernel<<<chunks, kThreads, 0, st>>>(b, a, lr, scale, found_a,
                                             found_b, tickets);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}

}  // extern "C"
