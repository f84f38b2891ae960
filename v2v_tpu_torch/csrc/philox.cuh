// Philox4x32-10 counter-based generator and the simulator's noise draws.
//
// Shared by the event simulator (K1) and the raw gaussian sampler (K2)
// in esim.cu, and by K5 (sim_interleave.cu). The plain PyTorch twin in
// v2v_tpu_torch/ops/voxel_cuda.py computes the same bits in int64
// tensor arithmetic, so kernel and plain version agree bit for bit,
// noise included.
//
// The draw layout. Every call yields four 32-bit words, and every word
// is used. Counters are (c0, c1, stream, 0) under key (seed, 0):
//
//   start-up of pixel p    call (p, 0, kStreamInit, 0): word x the
//                          initial potential's uniform, y the hot-pixel
//                          mask's uniform, z the hot-pixel value's
//                          gaussian (w is unused)
//   noise of pixel p at    word (i-1) & 3 of call (p, (i-1) >> 2,
//   frame i (1-based)      kStreamNoise, 0)
//   K2's sample i          word i & 3 of call (i >> 2, 0, kStreamNoise, 0)
//
// A draw depends on the seed, the pixel and the frame only, not on how
// many pixels or clips a thread owns or on the launch shape.
//
// Constants: Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3" (SC'11), as in PyTorch's ATen/core/PhiloxRNGEngine.h.
#pragma once

#include <cstdint>

namespace v2v {

constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;  // key bump, word 0
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;  // key bump, word 1
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;  // round multiplier 0
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;  // round multiplier 1

// Stream ids (third counter word), so that no two kinds of draw share a
// counter.
constexpr uint32_t kStreamInit = 0;   // a pixel's three start-up draws
constexpr uint32_t kStreamNoise = 1;  // per-frame noise; K2's samples

__host__ __device__ inline uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
#ifdef __CUDA_ARCH__
    // the high and low words as two 32-bit multiplies: the 64-bit product
    // compiled to a wide multiply plus an add of zero to its high word
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
#else
    const uint64_t p0 = static_cast<uint64_t>(kPhiloxM0) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(kPhiloxM1) * c.z;
    const uint32_t hi0 = static_cast<uint32_t>(p0 >> 32);
    const uint32_t lo0 = static_cast<uint32_t>(p0);
    const uint32_t hi1 = static_cast<uint32_t>(p1 >> 32);
    const uint32_t lo1 = static_cast<uint32_t>(p1);
#endif
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words of the call at counter (c0, c1, stream, 0), key
// (seed, 0).
__host__ __device__ inline uint4 philox_draws(uint32_t seed, uint32_t c0,
                                              uint32_t c1, uint32_t stream) {
  return philox4x32_10(make_uint4(c0, c1, stream, 0u), make_uint2(seed, 0u));
}

// Word f (0..3) of a call; f is a constant once the caller's frame loop
// is unrolled, so this is a register pick.
__host__ __device__ __forceinline__ uint32_t word(uint4 w, int f) {
  return f == 0 ? w.x : f == 1 ? w.y : f == 2 ? w.z : w.w;
}

// Uniform in (0, 1]: the top 24 bits, exact in float32.
__host__ __device__ inline float uniform01(uint32_t w) {
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f) +
         (1.0f / 16777216.0f);
}

// Irwin-Hall gaussian over the 4 bytes of one word (the TPU kernel's
// _gaussian(fast=True)): mean 0, variance 1, 1021 levels, truncated at
// +-510/147.795 = 3.45 sigma. On the card the byte sum is one dp4a and
// the integer s - 510 becomes a float by the 2^23 trick (exact for
// 0 <= s < 2^23), with no conversion instruction: the same bits as
// (float)s - 510.
__host__ __device__ inline float irwin_hall_gaussian(uint32_t w) {
  const float inv_std = static_cast<float>(1.0 / 147.7950834);
#ifdef __CUDA_ARCH__
  const uint32_t s = __dp4a(w, 0x01010101u, 0u);
  const float x = __uint_as_float(0x4B000000u | s) - 8389118.0f;  // 2^23+510
  return x * inv_std;
#else
  const int s = static_cast<int>((w & 0xFFu) + ((w >> 8) & 0xFFu) +
                                 ((w >> 16) & 0xFFu) + (w >> 24));
  return (static_cast<float>(s) - 510.0f) * inv_std;
#endif
}

}  // namespace v2v
