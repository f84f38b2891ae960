// K1: fused video -> signed event count simulator.
// K2: raw samples of K1's gaussian generator.
//
// Replaces v2v_tpu/ops/voxel_pallas.py::simulate_batch_pallas (K1, body
// _sim_kernel) and ::sample_gaussian_pallas (K2).
//
// What bounds it: K1 reads the video once and writes the counts once.
// At the flagship shape (B=12, N=201, 128x128, uint8 in, float32 out)
// that is 39.5 MB + 157.3 MB = 196.8 MB, about 59 us at 3.35 TB/s. The
// float32 arithmetic per pixel and frame is small beside that, so the
// roofline bound is bytes. On an H100 it runs at about 0.5 TB/s: K5
// (sim_interleave.cu), the same chain writing bfloat16 counts, takes a
// third less time back to back, and the rest goes to issuing the Philox
// draw's integer rounds (PERF.md).
//
// Design: one thread per pixel (b, y, x) walks frames 1..N-1 with the
// membrane potential, the previous log frame and the hot-pixel noise in
// registers: nothing but the video and the counts touches device
// memory. Neighbouring threads hold neighbouring x, so every frame's
// read and write is coalesced across the warp. The random bits come
// from a per-pixel Philox counter, so the result does not depend on the
// launch shape, and the plain PyTorch twin reproduces it exactly.
//
// Rounding: build with -fmad=false (no FMA contraction of the potential
// update, which the plain version runs as separate ops) and never with
// --use_fast_math (floorf(pot / theta) needs IEEE division); the log
// values and the quantization are esim.cuh's, shared with K5.
#include <cuda_runtime.h>

#include <cstdint>

#include "esim.cuh"
#include "philox.cuh"

namespace {

template <bool kU8, bool kNoise>
__global__ void esim_kernel(const void* __restrict__ video,
                            const float* __restrict__ table,
                            const int32_t* __restrict__ seeds,
                            const float* __restrict__ pos_thres,
                            const float* __restrict__ neg_thres,
                            const float* __restrict__ noise_std,
                            const float* __restrict__ hot_frac,
                            const float* __restrict__ hot_std,
                            float* __restrict__ out, int B, int N, int HW) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * HW) return;
  const int b = static_cast<int>(idx / HW);
  const uint32_t p = static_cast<uint32_t>(idx - static_cast<long long>(b) * HW);
  const float tp = pos_thres[b];
  const float tn = neg_thres[b];

  float pot = 0.0f;
  float hot = 0.0f;
  float std_b = 0.0f;
  uint32_t seed = 0;
  if (kNoise) {
    seed = static_cast<uint32_t>(seeds[b]);
    std_b = noise_std[b];
    const float u = v2v::uniform01(v2v::philox_word(seed, p, 0, v2v::kStreamInit));
    pot = u * (tp + tn) - tn;
    const float um =
        v2v::uniform01(v2v::philox_word(seed, p, 0, v2v::kStreamHotMask));
    const float g =
        v2v::irwin_hall_gaussian(v2v::philox_word(seed, p, 0, v2v::kStreamHotVal));
    const float hv = hot_std[b] * g;
    hot = um < hot_frac[b] ? hv : 0.0f;
  }

  const size_t in_base = static_cast<size_t>(b) * N * HW + p;
  const size_t out_base = static_cast<size_t>(b) * (N - 1) * HW + p;
  float log_prev = v2v::load_log<kU8>(video, in_base, table);
  for (int i = 1; i < N; ++i) {
    const float log_new = v2v::load_log<kU8>(
        video, in_base + static_cast<size_t>(i) * HW, table);
    pot = pot + (log_new - log_prev);
    if (kNoise) {
      const float g = v2v::irwin_hall_gaussian(
          v2v::philox_word(seed, p, static_cast<uint32_t>(i), v2v::kStreamNoise));
      pot = pot + std_b * g;
      pot = pot + hot;
    }
    out[out_base + static_cast<size_t>(i - 1) * HW] =
        v2v::quantize_events(pot, tp, tn);
    log_prev = log_new;
  }
}

__global__ void gaussian_kernel(uint32_t seed, float* __restrict__ out,
                                long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = v2v::irwin_hall_gaussian(
      v2v::philox_word(seed, static_cast<uint32_t>(i), 0, v2v::kStreamNoise));
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int v2v_simulate_batch(const void* video, int video_is_u8,
                                  const float* table, const int32_t* seeds,
                                  const float* pos_thres,
                                  const float* neg_thres,
                                  const float* noise_std,
                                  const float* hot_frac, const float* hot_std,
                                  float* out, int B, int N, int H, int W,
                                  int noise_free, void* stream) {
  const int hw = H * W;
  const long long threads = static_cast<long long>(B) * hw;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define V2V_LAUNCH(U8, NOISE)                                              \
  esim_kernel<U8, NOISE><<<blocks, kThreads, 0, s>>>(                      \
      video, table, seeds, pos_thres, neg_thres, noise_std, hot_frac,      \
      hot_std, out, B, N, hw)
  if (video_is_u8) {
    if (noise_free) V2V_LAUNCH(true, false); else V2V_LAUNCH(true, true);
  } else {
    if (noise_free) V2V_LAUNCH(false, false); else V2V_LAUNCH(false, true);
  }
#undef V2V_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int v2v_sample_gaussian(int seed, float* out, long long n,
                                   void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  gaussian_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t>(seed), out, n);
  return static_cast<int>(cudaGetLastError());
}
