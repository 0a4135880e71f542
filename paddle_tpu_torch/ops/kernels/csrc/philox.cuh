// The attention-dropout keep mask (K5) of both flash designs: one
// definition, included by flash_attention.cuh (the mma.sync kernels) and
// flash_attention_tma.cu (the TMA / wgmma kernels), so that the two draw
// the same bits and cannot drift apart.
//
// The mask is a pure function of (seed, b, h, row, col): Philox4x32-10
// with key (seed_lo, seed_hi) on the counter (col >> 2, row, b * H + h, 0)
// gives four words for four neighbouring columns; the pair (row, col) is
// kept iff word[col & 3] >= thresh, with thresh = min(floor(p * 2^32),
// 2^32 - 1). Both helpers below return a lane's keep bits in the m16n8
// accumulator layout (lane 4 g + t holds columns 2t, 2t + 1 of rows g and
// g + 8 in each n-tile of 8 columns), which is also, warp by warp, the
// layout of a wgmma accumulator tile: bit 4 n + e is accumulator element
// 4 n + e. The mask argument is any type with seed_lo, seed_hi and thresh
// (uint32_t): a PhiloxKey, read with load_key from the key the launch
// points to (the TMA kernels once per CTA, before the first tile; the
// first design at each tile), an int64 [2] tensor of two unsigned 32-bit
// words that the device wrote (core/random.py's key streams), so that a
// CUDA graph that holds the launch replays it with a fresh key.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The key words and the keep threshold of a launch with dropout.
struct PhiloxKey {
  uint32_t seed_lo, seed_hi, thresh;
};

// The key at `key` (two words held in int64).
__device__ __forceinline__ PhiloxKey load_key(const long long* key,
                                              uint32_t thresh) {
  return PhiloxKey{static_cast<uint32_t>(__ldg(key)),
                   static_cast<uint32_t>(__ldg(key + 1)), thresh};
}

// -- Philox4x32-10 (Salmon et al., SC'11; the Random123 constants) --------
__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The keep bits of a lane's accumulator elements over a tile whose rows
// are queries: bit 4n + e for n-tile n (columns c0 + 8n + 2t + (e & 1)) and
// row row[e >> 1]. c0 is a multiple of 8. The lanes t and t ^ 1 share both
// counters: each computes one row's and they swap halves, so every Philox
// word is used once.
template <int NT, typename M>
__device__ __forceinline__ uint32_t keep_bits_qrows(const M& mk, int bh,
                                                    const int (&row)[2],
                                                    int c0) {
  const int lane = threadIdx.x & 31, t = lane & 3, u = t & 1;
  const int my_row = u ? row[1] : row[0];
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    // lanes t and t^1 share this counter for both rows: lane u computes
    // row[u] and hands the partner the two words it needs
    const uint4 r = philox(
        make_uint4(static_cast<uint32_t>((c0 >> 2) + 2 * n + (t >> 1)),
                   static_cast<uint32_t>(my_row),
                   static_cast<uint32_t>(bh), 0u),
        mk.seed_lo, mk.seed_hi);
    const uint32_t ra = __shfl_xor_sync(0xffffffffu, u ? r.x : r.z, 1);
    const uint32_t rb = __shfl_xor_sync(0xffffffffu, u ? r.y : r.w, 1);
    const uint32_t w0 = u ? ra : r.x, w1 = u ? rb : r.y;  // row[0]
    const uint32_t w2 = u ? r.z : ra, w3 = u ? r.w : rb;  // row[1]
    bits |= (static_cast<uint32_t>(w0 >= mk.thresh) |
             static_cast<uint32_t>(w1 >= mk.thresh) << 1 |
             static_cast<uint32_t>(w2 >= mk.thresh) << 2 |
             static_cast<uint32_t>(w3 >= mk.thresh) << 3)
            << (4 * n);
  }
  return bits;
}

// The same over a tile whose rows are keys (dK/dV computes S^T): bit
// 4n + e for key row key0 + g + 8 (e >> 1) and query q0 + 8n + 2t + (e & 1),
// where key0 = this warp's first key (a multiple of 16). The four lanes of
// a key group each compute one of the four counters and exchange words in
// three shuffles.
template <int NT, typename M>
__device__ __forceinline__ uint32_t keep_bits_krows(const M& mk, int bh,
                                                    int key0, int q0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w = g & 3, a = g >> 2;  // key & 3 and the key group
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    // the four lanes (w = 0..3) of a key group need word w of the same
    // four counters, one per element e: lane w computes e = w's
    const uint4 r = philox(
        make_uint4(static_cast<uint32_t>((key0 >> 2) + a + 2 * (w >> 1)),
                   static_cast<uint32_t>(q0 + 8 * n + 2 * t + (w & 1)),
                   static_cast<uint32_t>(bh), 0u),
        mk.seed_lo, mk.seed_hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // round j: receive word w of element w ^ j's counter from the lane
      // that computed it, sending it word (w ^ j) of ours
      uint32_t x = word(r, w ^ j);
      if (j) x = __shfl_xor_sync(0xffffffffu, x, 4 * j);
      bits |= static_cast<uint32_t>(x >= mk.thresh) << (4 * n + (w ^ j));
    }
  }
  return bits;
}

}  // namespace
