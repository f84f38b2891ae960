// K1: fused video -> signed event count simulator, bfloat16 counts.
// K2: raw samples of K1's gaussian generator (its design and bound by
// gaussian_kernel below).
//
// Replaces v2v_tpu/ops/voxel_pallas.py::simulate_batch_pallas (K1, body
// _sim_kernel) and ::sample_gaussian_pallas (K2).
//
// What bounds it. K1 reads the video once and writes the counts once, in
// bfloat16 as the TPU kernel writes them (voxel_pallas.py:225). At the
// flagship shape (B=12, N=201, 128x128, uint8 in) that is 39.5 MB + 78.6
// MB = 118.2 MB, 0.0353 ms at 3.35 TB/s. But each of the 39.3 M
// pixel-frames also issues a chain of integer and float32 instructions
// (a quarter of a Philox call, the Irwin-Hall sum, the potential update,
// one IEEE division and the residual): at the 49 of them a pixel-frame
// that this kernel's loop issues (its SASS, the divisions' slow paths
// left out) the card needs 0.058 ms just to issue them (4 warp
// instructions a clock on each of 132 SMs at 1.98 GHz). So K1 is bound
// by issued instructions; chip_smoke.py's [k1] counts them in this
// file's SASS. Target, back to back at the flagship shape with noise:
// <= 0.15 ms (the previous design, a Philox call per draw, two divisions
// and float32 counts, took 0.3571 ms); it runs 0.087-0.089 ms (PERF.md).
//
// Design, against that bound:
// - Every word of a Philox call is used (philox.cuh's draw layout): a
//   pixel's noise for 4 frames comes from one call, its three start-up
//   draws from another. The frame loop walks quads of 4 frames, the
//   draw layout's unit; a ragged last quad runs after the loop.
// - quantize_events (esim.cuh) divides once; the Irwin-Hall sum is one
//   dp4a and its float conversion an add (philox.cuh).
// - A thread owns kPix neighbouring pixels of one clip: one vector load
//   of kPix uint8 per frame, one vector store of kPix bfloat16 counts,
//   and kPix independent chains for the scheduler to overlap. The next
//   quad's 4 frames are loaded before the current quad is computed.
//   Where H*W is not a multiple of kPix or a pointer is not aligned
//   for the vector, the same thread shape loads and stores pixel by
//   pixel and masks the clip's ragged tail.
// - The 1 KB log table of the 256 uint8 levels sits in shared memory.
// kPix and the block size were chosen on the card by timing each of 1,
// 2, 4 and 8 pixels a thread in blocks of 64 to 256 (PERF.md): at the
// flagship shape 2 pixels a thread in blocks of 256 ran 0.0873 ms back
// to back, 4 in blocks of 128 0.0887, 1 0.099-0.107, 8 0.147 (H100 80GB
// HBM3, 700 W). Only the kept shape is built;
// v2v_tpu_torch/scripts/k1_designs.py times it against an older tree.
// More pixels a thread issue fewer instructions a pixel-frame (SASS: 55.5
// at 1, 49.0 at 2, 45.4 at 4, 44.7 at 8: a Philox call's set-up and the
// loop's bookkeeping are shared) but leave fewer warps to hide latency.
//
// The result does not depend on kPix or the launch shape: each pixel's
// chain is its own, and its draws are keyed by (seed, pixel, frame).
//
// Rounding: build with -fmad=false (no FMA contraction of the potential
// update, which the plain version runs as separate ops) and never with
// --use_fast_math (floorf(|pot| / theta) needs IEEE division); the log
// values and the quantization are esim.cuh's, shared with K5. Counts
// are rounded to bfloat16 to nearest even, as the plain version's cast
// and JAX's astype: the integers up to 256 in magnitude are exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "esim.cuh"
#include "philox.cuh"

namespace {

constexpr int kPix = 2;          // pixels a thread
constexpr int kThreads = 256;    // threads a block

// K2's threads a block; a thread makes one Philox call. At 4096x4096
// (67.1 MB written, a bytes bound of 0.0200 ms) one and two calls a
// thread ran 0.0229 and 0.0230 ms back to back through the C entry, a
// tie (H100 80GB HBM3, 700 W; PERF.md), so the simpler one is kept.
constexpr int kGaussThreads = 256;

// A launch's arguments; (B,) per-clip parameters.
struct SimArgs {
  const void* video;      // (B, N, H, W) uint8 or float32
  const float* table;     // log values of the 256 uint8 levels
  const int32_t* seeds;
  const float* pos_thres;
  const float* neg_thres;
  const float* noise_std;
  const float* hot_frac;
  const float* hot_std;
  __nv_bfloat16* out;     // (B, N-1, H, W)
  int B, N, HW;
};

template <bool kU8, bool kNoise, bool kVec, int kN>
__global__ void __launch_bounds__(kThreads) esim_kernel(SimArgs a) {
  using In = typename std::conditional<kU8, uint8_t, float>::type;
  __shared__ float s_table[256];
  if (kU8) {
    for (int k = threadIdx.x; k < 256; k += blockDim.x)
      s_table[k] = a.table[k];
    __syncthreads();
  }
  const int HW = a.HW, N = a.N;
  const int per_clip = (HW + kN - 1) / kN;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(a.B) * per_clip) return;
  const int b = static_cast<int>(t / per_clip);
  const int p0 = static_cast<int>(t - static_cast<long long>(b) * per_clip) *
                 kN;
  const int valid = min(kN, HW - p0);
  const In* src = static_cast<const In*>(a.video) +
                  static_cast<size_t>(b) * N * HW + p0;
  __nv_bfloat16* dst = a.out + static_cast<size_t>(b) * (N - 1) * HW + p0;

  v2v::Clip c;
  c.tp = a.pos_thres[b];
  c.tn = a.neg_thres[b];
  c.std_b = 0.0f;
  c.seed = 0;
  float pot[kN], hot[kN], prev[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) pot[j] = hot[j] = 0.0f;
  if (kNoise) {
    c.seed = static_cast<uint32_t>(a.seeds[b]);
    c.std_b = a.noise_std[b];
    const float frac = a.hot_frac[b];
    const float hstd = a.hot_std[b];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const uint4 w = v2v::philox_draws(c.seed, p0 + j, 0, v2v::kStreamInit);
      pot[j] = v2v::uniform01(w.x) * (c.tp + c.tn) - c.tn;
      const float hv = hstd * v2v::irwin_hall_gaussian(w.z);
      hot[j] = v2v::uniform01(w.y) < frac ? hv : 0.0f;
    }
  }
  {
    In raw[kN];
    v2v::load_pixels<kVec>(src, valid, raw);
#pragma unroll
    for (int j = 0; j < kN; ++j) prev[j] = v2v::log_of(raw[j], s_table);
  }

  uint4 w[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) w[j] = make_uint4(0u, 0u, 0u, 0u);
  const int quads = (N - 1) >> 2;  // whole quads of frames
  In next[4][kN];
  if (quads > 0) {
#pragma unroll
    for (int f = 0; f < 4; ++f)
      v2v::load_pixels<kVec>(src + static_cast<size_t>(1 + f) * HW, valid,
                             next[f]);
  }
#pragma unroll 1
  for (int q = 0; q < quads; ++q) {
    In cur[4][kN];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int j = 0; j < kN; ++j) cur[f][j] = next[f][j];
    if (q + 1 < quads) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        v2v::load_pixels<kVec>(
            src + static_cast<size_t>(4 * q + 5 + f) * HW, valid, next[f]);
    }
    if (kNoise) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        w[j] = v2v::philox_draws(c.seed, p0 + j, q, v2v::kStreamNoise);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      float counts[kN];
      v2v::frame_step<kNoise>(cur[f], w, f, s_table, c, pot, prev, hot,
                              counts);
      v2v::store_counts<kVec>(dst + static_cast<size_t>(4 * q + f) * HW,
                              valid, counts);
    }
  }
  // the last 1-3 frames when N-1 is not a multiple of 4
  const int rest = (N - 1) - 4 * quads;
  if (rest > 0) {
    if (kNoise) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        w[j] = v2v::philox_draws(c.seed, p0 + j, quads, v2v::kStreamNoise);
    }
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if (f < rest) {
        const int i = 4 * quads + 1 + f;
        In raw[kN];
        v2v::load_pixels<kVec>(src + static_cast<size_t>(i) * HW, valid,
                               raw);
        float counts[kN];
        v2v::frame_step<kNoise>(raw, w, f, s_table, c, pot, prev, hot,
                                counts);
        v2v::store_counts<kVec>(dst + static_cast<size_t>(i - 1) * HW, valid,
                                counts);
      }
    }
  }
}

// K2: sample i is word i & 3 of the call at (i >> 2, 0, kStreamNoise).
// A thread makes call t and writes its 4 samples as one 16-byte store
// (kVec: `out` 16-byte aligned), so a warp's store covers 512
// neighbouring bytes; the ragged last call (n % 4 != 0), or every call
// when `out` is not aligned, stores sample by sample.
template <bool kVec>
__global__ void __launch_bounds__(kGaussThreads)
    gaussian_kernel(uint32_t seed, float* __restrict__ out, long long n) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kGaussThreads + threadIdx.x;
  const long long i0 = 4 * t;
  if (i0 >= n) return;
  const uint4 w = v2v::philox_draws(seed, static_cast<uint32_t>(t), 0,
                                    v2v::kStreamNoise);
  const float4 g = make_float4(
      v2v::irwin_hall_gaussian(w.x), v2v::irwin_hall_gaussian(w.y),
      v2v::irwin_hall_gaussian(w.z), v2v::irwin_hall_gaussian(w.w));
  if (kVec && i0 + 4 <= n) {
    *reinterpret_cast<float4*>(out + i0) = g;
  } else {
    const float s[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int f = 0; f < 4; ++f)
      if (i0 + f < n) out[i0 + f] = s[f];
  }
}

template <bool kU8, bool kNoise, bool kVec>
int start(const SimArgs& a, cudaStream_t s) {
  const long long total =
      static_cast<long long>(a.B) * ((a.HW + kPix - 1) / kPix);
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  esim_kernel<kU8, kNoise, kVec, kPix><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t. `out` is (B, N-1, H, W) bfloat16.
extern "C" int v2v_simulate_batch(const void* video, int video_is_u8,
                                  const float* table, const int32_t* seeds,
                                  const float* pos_thres,
                                  const float* neg_thres,
                                  const float* noise_std,
                                  const float* hot_frac, const float* hot_std,
                                  void* out, int B, int N, int H, int W,
                                  int noise_free, void* stream) {
  const SimArgs a{video,     table,     seeds,    pos_thres,
                  neg_thres, noise_std, hot_frac, hot_std,
                  static_cast<__nv_bfloat16*>(out), B, N, H * W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (video_is_u8) {
    const bool vec = v2v::vector_ok<kPix>(video, true, out, a.HW);
    if (noise_free)
      return vec ? start<true, false, true>(a, s)
                 : start<true, false, false>(a, s);
    return vec ? start<true, true, true>(a, s) : start<true, true, false>(a, s);
  }
  const bool vec = v2v::vector_ok<kPix>(video, false, out, a.HW);
  if (noise_free)
    return vec ? start<false, false, true>(a, s)
               : start<false, false, false>(a, s);
  return vec ? start<false, true, true>(a, s) : start<false, true, false>(a, s);
}

extern "C" int v2v_sample_gaussian(int seed, float* out, long long n,
                                   void* stream) {
  const long long calls = (n + 3) / 4;
  const unsigned blocks =
      static_cast<unsigned>((calls + kGaussThreads - 1) / kGaussThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t key = static_cast<uint32_t>(seed);
  if (reinterpret_cast<uintptr_t>(out) % 16 == 0)
    gaussian_kernel<true><<<blocks, kGaussThreads, 0, s>>>(key, out, n);
  else
    gaussian_kernel<false><<<blocks, kGaussThreads, 0, s>>>(key, out, n);
  return static_cast<int>(cudaGetLastError());
}
