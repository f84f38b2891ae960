// The event simulator's per-pixel chain, shared by K1 (esim.cu) and K5
// (sim_interleave.cu): the log intensity of a frame, the quantization of
// the potential into signed event counts, and the pieces of a thread's
// frame loop (its vector loads and stores, one frame of its chains).
//
// Rounding: the including sources build with -fmad=false and never with
// --use_fast_math, so that these match the plain PyTorch versions
// (v2v_tpu_torch/ops/voxel.py) op for op: no FMA contraction, and IEEE
// division in floorf(|pot| / theta).
#pragma once

#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "philox.cuh"

namespace v2v {

__device__ __forceinline__ float log_intensity(float v) {
  // log(0.001 + reverse_gamma(v) / 255), the reference form with the
  // x255 / 255 round trip (v2v_tpu/ops/voxel.py:32-34, :94)
  float x = v / 255.0f;
  x = powf(x, 2.2f);
  x = x * 255.0f;
  x = x / 255.0f;
  return logf(0.001f + x);
}

// The events this frame fires, positive minus negative, with float
// floor-division semantics; `pot` keeps the residual. At most one side
// can fire (both thresholds are positive), so one IEEE division of |pot|
// by that side's threshold serves both: |pot| / t is the same bits as
// pot / tp above and -pot / tn below, so this is the plain version's
// two-division form (ops/voxel.py::_quantize_events) bit for bit. The
// residual update is that form's, op for op, and a count is never -0.
__device__ __forceinline__ float quantize_events(float& pot, float tp,
                                                 float tn) {
  const bool up = pot >= tp;
  const bool down = pot <= -tn;
  const float q = floorf(fabsf(pot) / (up ? tp : tn));
  const float pos_ev = up ? q : 0.0f;
  const float neg_ev = down ? q : 0.0f;
  pot = pot - pos_ev * tp + neg_ev * tn;
  return pos_ev - neg_ev;
}

// The unsigned type of kBytes bytes, for one vector load or store.
template <int kBytes> struct Vec;
template <> struct Vec<1> { using T = uint8_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<16> { using T = uint4; };

// kN elements from src, one vector load (kVec) or element by element
// with the first `valid` read and the rest zero.
template <bool kVec, int kN, typename T>
__device__ __forceinline__ void load_pixels(const T* src, int valid,
                                            T (&dst)[kN]) {
  if (kVec) {
    using V = typename Vec<sizeof(T) * kN>::T;
    const V v = __ldg(reinterpret_cast<const V*>(src));
    memcpy(dst, &v, sizeof(V));
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) dst[j] = j < valid ? __ldg(src + j) : T(0);
  }
}

// kN counts to dst as bfloat16 (round to nearest even): one vector store
// (kVec) or the first `valid` element by element.
template <bool kVec, int kN>
__device__ __forceinline__ void store_counts(__nv_bfloat16* dst, int valid,
                                             const float (&c)[kN]) {
  __nv_bfloat16 h[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) h[j] = __float2bfloat16_rn(c[j]);
  if (kVec) {
    using V = typename Vec<2 * kN>::T;
    V v;
    memcpy(&v, h, sizeof(V));
    *reinterpret_cast<V*>(dst) = v;
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (j < valid) dst[j] = h[j];
  }
}

// uint8 video reads its log value from a 256-entry table (in shared
// memory) that the wrapper computes with the plain version's own
// expression, so the log values are the same bits in both versions.
__device__ __forceinline__ float log_of(uint8_t v, const float* table) {
  return table[v];
}

__device__ __forceinline__ float log_of(float v, const float*) {
  return log_intensity(v);
}

// A clip's thresholds, noise std and seed.
struct Clip {
  float tp, tn, std_b;
  uint32_t seed;
};

// One frame of kN chains: the log step, the noise (word f of each
// chain's Philox call), the quantization.
template <bool kNoise, int kN, typename In>
__device__ __forceinline__ void frame_step(const In (&raw)[kN],
                                           const uint4 (&w)[kN], int f,
                                           const float* table,
                                           const Clip& c, float (&pot)[kN],
                                           float (&prev)[kN],
                                           const float (&hot)[kN],
                                           float (&counts)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float log_new = log_of(raw[j], table);
    pot[j] = pot[j] + (log_new - prev[j]);
    if (kNoise) {
      const float g = irwin_hall_gaussian(word(w[j], f));
      pot[j] = pot[j] + c.std_b * g;
      pot[j] = pot[j] + hot[j];
    }
    counts[j] = quantize_events(pot[j], c.tp, c.tn);
    prev[j] = log_new;
  }
}

// Whether kN pixels a thread can load and store as one vector: H*W a
// multiple of kN and both pointers aligned to the vectors (every clip
// and frame then starts at a multiple of kN elements).
template <int kN>
inline bool vector_ok(const void* video, bool u8, const void* out, int hw) {
  const uintptr_t in_bytes = static_cast<uintptr_t>(kN) * (u8 ? 1 : 4);
  return hw % kN == 0 &&
         reinterpret_cast<uintptr_t>(video) % in_bytes == 0 &&
         reinterpret_cast<uintptr_t>(out) % (2 * kN) == 0;
}

}  // namespace v2v
