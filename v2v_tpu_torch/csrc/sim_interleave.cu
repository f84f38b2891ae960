// K5: the event simulator with the chains of `spp` clips interleaved in
// one thread, bfloat16 counts.
//
// Replaces scripts/exp_sim_interleave.py::simulate (body _kernel), an
// experiment on whether independent per-pixel state chains in one
// program hide the latency of the simulator's ~30-op float32 chain per
// frame. The arithmetic is K1's (esim.cu) with the hot-pixel mask always
// on and the hot std fixed at 0.05.
//
// What bounds it: the video read once and the counts written once. At
// the experiment's shape (B=12, N=201, 128x128, uint8 in, bfloat16 out)
// that is 39.5 MB + 78.6 MB = 118.2 MB, about 35 us at 3.35 TB/s; the
// 12 float32 operations a pixel and frame are far below that. On an
// H100 it takes ~6x that (0.22 ms back to back at kSpp = 1, PERF.md),
// with the time growing with the work: it is bound by issued
// instructions, K1's chain a pixel and frame (a quarter of a Philox
// call, one division: esim.cuh, philox.cuh) with none of K1's sharing
// of a call's set-up between pixels (esim.cu).
//
// Design: one thread per (pixel, group of kSpp clips). Each of the kSpp
// chains keeps its potential, previous log value, hot noise and
// parameters in registers, and the frame loop runs the kSpp chains
// unrolled one after the other, so their loads, Philox rounds and
// divisions are independent instructions the scheduler can overlap. That
// interleaving is what the experiment measures: kSpp = 1 is K1's thread
// with bfloat16 output. Neighbouring threads hold neighbouring x, so
// each frame's uint8 reads and bfloat16 writes coalesce across a warp.
// The TPU kernel's row tile (a VMEM budget) has no counterpart here.
//
// Random bits: every draw is K1's, keyed by the clip's own seed in K1's
// layout (philox.cuh: one call serves a pixel's 4 frames), so the result
// does not depend on kSpp or the launch shape and the plain PyTorch
// version reproduces it.
//
// Rounding: build with -fmad=false and never --use_fast_math, as K1
// (esim.cu, esim.cuh): the potential update keeps the plain version's
// separate adds in its order, and floorf(pot / theta) needs IEEE
// division. The counts are small integers, exact in bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "esim.cuh"
#include "philox.cuh"

namespace {

constexpr float kHotStd = 0.05f;

template <int kSpp, bool kU8>
__global__ void sim_interleave_kernel(const void* __restrict__ video,
                                      const float* __restrict__ table,
                                      const int32_t* __restrict__ seeds,
                                      const float* __restrict__ pos_thres,
                                      const float* __restrict__ neg_thres,
                                      const float* __restrict__ noise_std,
                                      __nv_bfloat16* __restrict__ out,
                                      int groups, int N, int HW) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(groups) * HW) return;
  const int group = static_cast<int>(idx / HW);
  const uint32_t p =
      static_cast<uint32_t>(idx - static_cast<long long>(group) * HW);

  float tp[kSpp], tn[kSpp], std_b[kSpp], pot[kSpp], hot[kSpp], prev[kSpp];
  uint32_t seed[kSpp];
  size_t in_base[kSpp], out_base[kSpp];
#pragma unroll
  for (int j = 0; j < kSpp; ++j) {
    const int b = group * kSpp + j;
    tp[j] = pos_thres[b];
    tn[j] = neg_thres[b];
    std_b[j] = noise_std[b];
    seed[j] = static_cast<uint32_t>(seeds[b]);
    // K1's start-up call: x the initial potential, z the hot value (the
    // mask, y, is always on here)
    const uint4 w0 = v2v::philox_draws(seed[j], p, 0, v2v::kStreamInit);
    pot[j] = v2v::uniform01(w0.x) * (tp[j] + tn[j]) - tn[j];
    hot[j] = kHotStd * v2v::irwin_hall_gaussian(w0.z);
    in_base[j] = static_cast<size_t>(b) * N * HW + p;
    out_base[j] = static_cast<size_t>(b) * (N - 1) * HW + p;
    prev[j] = v2v::load_log<kU8>(video, in_base[j], table);
  }
  uint4 w[kSpp];
  for (int i = 1; i < N; ++i) {
    const int f = (i - 1) & 3;  // the word of this frame's noise
#pragma unroll
    for (int j = 0; j < kSpp; ++j) {
      if (f == 0)
        w[j] = v2v::philox_draws(seed[j], p, (i - 1) >> 2,
                                 v2v::kStreamNoise);
      const float log_new = v2v::load_log<kU8>(
          video, in_base[j] + static_cast<size_t>(i) * HW, table);
      pot[j] = pot[j] + (log_new - prev[j]);
      const float g = v2v::irwin_hall_gaussian(v2v::word(w[j], f));
      pot[j] = pot[j] + std_b[j] * g;
      pot[j] = pot[j] + hot[j];
      out[out_base[j] + static_cast<size_t>(i - 1) * HW] =
          __float2bfloat16_rn(v2v::quantize_events(pot[j], tp[j], tn[j]));
      prev[j] = log_new;
    }
  }
}

constexpr int kThreads = 256;

template <int kSpp>
void launch(const void* video, int video_is_u8, const float* table,
            const int32_t* seeds, const float* pos_thres,
            const float* neg_thres, const float* noise_std,
            __nv_bfloat16* out, int B, int N, int HW, cudaStream_t s) {
  const int groups = B / kSpp;
  const long long threads = static_cast<long long>(groups) * HW;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (video_is_u8)
    sim_interleave_kernel<kSpp, true><<<blocks, kThreads, 0, s>>>(
        video, table, seeds, pos_thres, neg_thres, noise_std, out, groups, N,
        HW);
  else
    sim_interleave_kernel<kSpp, false><<<blocks, kThreads, 0, s>>>(
        video, table, seeds, pos_thres, neg_thres, noise_std, out, groups, N,
        HW);
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue (1) for a kSpp without an
// instance or a B that is not a multiple of it (the wrapper checks both).
extern "C" int v2v_simulate_interleave(const void* video, int video_is_u8,
                                       const float* table,
                                       const int32_t* seeds,
                                       const float* pos_thres,
                                       const float* neg_thres,
                                       const float* noise_std, void* out,
                                       int B, int N, int H, int W, int spp,
                                       void* stream) {
  if (spp <= 0 || B % spp) return static_cast<int>(cudaErrorInvalidValue);
  const int hw = H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (spp) {
    case 1: launch<1>(video, video_is_u8, table, seeds, pos_thres, neg_thres,
                      noise_std, o, B, N, hw, s); break;
    case 2: launch<2>(video, video_is_u8, table, seeds, pos_thres, neg_thres,
                      noise_std, o, B, N, hw, s); break;
    case 4: launch<4>(video, video_is_u8, table, seeds, pos_thres, neg_thres,
                      noise_std, o, B, N, hw, s); break;
    case 8: launch<8>(video, video_is_u8, table, seeds, pos_thres, neg_thres,
                      noise_std, o, B, N, hw, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
