// The event simulator's per-pixel chain, shared by K1 (esim.cu) and K5
// (sim_interleave.cu): the log intensity of a frame and the quantization
// of the potential into signed event counts.
//
// Rounding: the including sources build with -fmad=false and never with
// --use_fast_math, so that these match the plain PyTorch versions
// (v2v_tpu_torch/ops/voxel.py) op for op: no FMA contraction, and IEEE
// division in floorf(|pot| / theta).
#pragma once

#include <cstddef>
#include <cstdint>

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

// uint8 video reads its log value from a 256-entry table that the
// wrapper computes with the plain version's own expression, so the log
// values are the same bits in both versions.
template <bool kU8>
__device__ __forceinline__ float load_log(const void* video, size_t i,
                                          const float* table) {
  if (kU8) return table[static_cast<const uint8_t*>(video)[i]];
  return log_intensity(static_cast<const float*>(video)[i]);
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

}  // namespace v2v
