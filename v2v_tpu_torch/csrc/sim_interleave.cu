// K5: the event simulator with the chains of `spp` clips interleaved in
// one thread, bfloat16 counts.
//
// Replaces scripts/exp_sim_interleave.py::simulate (body _kernel), an
// experiment on whether independent per-pixel state chains in one
// program hide the latency of the simulator's chain a frame. The
// arithmetic is K1's (esim.cu) with the hot-pixel mask always on and the
// hot std fixed at 0.05.
//
// What bounds it: the video read once and the counts written once. At
// the experiment's shape (B=12, N=201, 128x128, uint8 in, bfloat16 out)
// that is 39.5 MB + 78.6 MB = 118.2 MB, 0.0353 ms at 3.35 TB/s. But, as
// for K1, each pixel-frame issues a chain of integer and float32
// instructions (a quarter of a Philox call, the Irwin-Hall sum, the
// potential update, one IEEE division, the residual): chip_smoke.py's
// [k5] counts them in this file's SASS, a pixel-frame of each instance's
// quad loop, and gives the issue bound they set.
//
// Design: K1's thread (esim.cu), looped over kSpp clips. A thread owns
// kPix neighbouring pixels of each of kSpp clips, kPix * kSpp
// independent chains in registers, each one K1's:
// - each frame loads kPix uint8 of a clip as one vector and stores kPix
//   bfloat16 counts as one vector; where H*W is not a multiple of kPix
//   or a pointer is not aligned for the vector, the same thread shape
//   loads and stores pixel by pixel and masks the clip's ragged tail
//   (esim.cuh's load_pixels, store_counts, vector_ok);
// - the 1 KB log table of the 256 uint8 levels sits in shared memory;
// - the frame loop walks quads of 4 frames with the next quad's loads
//   for all kSpp clips in flight; a quad makes one Philox call a pixel
//   and clip, whose words the unrolled quad picks by a compile-time
//   frame (esim.cuh's frame_step); the last 1-3 frames run after the
//   loop;
// - a clip's offset is worked out once, and a frame's is a 32-bit add
//   (the wrapper keeps a group of kSpp clips under 2^31 elements).
// spp keeps its meaning, clips a thread, so the experiment still
// measures whether more independent chains a thread hide the chain's
// latency; at kSpp = 1 this is K1's thread with every pixel hot.
//
// kPix and the block size for each spp were chosen on the card by a
// sweep, back to back through the C entry at the experiment's shape
// (H100 80GB HBM3, 700 W; PERF.md; ms, blocks of 128 / 256 threads):
//            1 pixel a thread  2 pixels          4 pixels
//   spp 1    0.1012 / 0.1014   0.0923 / 0.0914   0.0915 / 0.1094
//   spp 2    0.1060 / 0.1025   0.0956 / 0.1176   0.1464 / 0.1496
//   spp 4    0.1049 / 0.1645   0.1536 / 0.1535   0.3118 / 0.3678
// K1 on the same clips ran 0.0912. Up to 4 chains a thread the time
// stays within 15% of K1's; at 8 chains (ptxas: 152-210 registers) an
// SM holds too few warps, and at 16 (spp 4 x 4 pixels) it spills. So
// more clips a thread do not hide the chain's latency better than more
// pixels or more threads. Only the kept shapes are built;
// scripts/k5_designs.py times them against an older tree.
// spp 8, outside the experiment, is 8 chains at its least (1 pixel); its
// uint8 instance uses 255 registers and spills.
//
// Random bits: every draw is K1's, keyed by the clip's own seed in K1's
// layout (philox.cuh: one call serves a pixel's 4 frames), so the result
// depends on neither kSpp, kPix nor the launch shape, and the plain
// PyTorch version reproduces it.
//
// Rounding: build with -fmad=false and never --use_fast_math, as K1
// (esim.cu, esim.cuh): the potential update keeps the plain version's
// separate adds in its order, and floorf(pot / theta) needs IEEE
// division. The counts are small integers, exact in bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "esim.cuh"
#include "philox.cuh"

namespace {

constexpr float kHotStd = 0.05f;

// Pixels a thread (kPix) and threads a block (kThreads), by clips a
// thread (kSpp).
template <int kSpp> struct Shape;
template <> struct Shape<1> { static constexpr int kPix = 2, kThreads = 256; };
template <> struct Shape<2> { static constexpr int kPix = 2, kThreads = 128; };
template <> struct Shape<4> { static constexpr int kPix = 1, kThreads = 128; };
template <> struct Shape<8> { static constexpr int kPix = 1, kThreads = 128; };

// A launch's arguments; (B,) per-clip parameters.
struct K5Args {
  const void* video;      // (B, N, H, W) uint8 or float32
  const float* table;     // log values of the 256 uint8 levels
  const int32_t* seeds;
  const float* pos_thres;
  const float* neg_thres;
  const float* noise_std;
  __nv_bfloat16* out;     // (B, N-1, H, W)
  int groups, N, HW;      // groups = B / kSpp
};

template <int kSpp, bool kU8, bool kVec>
__global__ void __launch_bounds__(Shape<kSpp>::kThreads)
    sim_interleave_kernel(K5Args a) {
  constexpr int kPix = Shape<kSpp>::kPix;
  using In = typename std::conditional<kU8, uint8_t, float>::type;
  __shared__ float s_table[256];
  if (kU8) {
    for (int k = threadIdx.x; k < 256; k += blockDim.x)
      s_table[k] = a.table[k];
    __syncthreads();
  }
  const int HW = a.HW, N = a.N;
  const int per_group = (HW + kPix - 1) / kPix;  // threads a group
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.groups * per_group) return;
  const int group = t / per_group;
  const int p0 = (t - group * per_group) * kPix;
  const int valid = min(kPix, HW - p0);
  // the group's first clip; clip j is j clips further, in 32 bits
  const In* src = static_cast<const In*>(a.video) +
                  static_cast<size_t>(group) * kSpp * N * HW + p0;
  __nv_bfloat16* dst =
      a.out + static_cast<size_t>(group) * kSpp * (N - 1) * HW + p0;
  const int in_clip = N * HW, out_clip = (N - 1) * HW;

  v2v::Clip c[kSpp];
  float pot[kSpp][kPix], hot[kSpp][kPix], prev[kSpp][kPix];
#pragma unroll
  for (int j = 0; j < kSpp; ++j) {
    const int b = group * kSpp + j;
    c[j].tp = a.pos_thres[b];
    c[j].tn = a.neg_thres[b];
    c[j].std_b = a.noise_std[b];
    c[j].seed = static_cast<uint32_t>(a.seeds[b]);
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      // K1's start-up call: x the initial potential, z the hot value
      // (the mask, y, is always on here)
      const uint4 w =
          v2v::philox_draws(c[j].seed, p0 + k, 0, v2v::kStreamInit);
      pot[j][k] = v2v::uniform01(w.x) * (c[j].tp + c[j].tn) - c[j].tn;
      hot[j][k] = kHotStd * v2v::irwin_hall_gaussian(w.z);
    }
    In raw[kPix];
    v2v::load_pixels<kVec>(src + j * in_clip, valid, raw);
#pragma unroll
    for (int k = 0; k < kPix; ++k) prev[j][k] = v2v::log_of(raw[k], s_table);
  }

  uint4 w[kSpp][kPix];
  const int quads = (N - 1) >> 2;  // whole quads of frames
  In next[4][kSpp][kPix];
  if (quads > 0) {
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int j = 0; j < kSpp; ++j)
        v2v::load_pixels<kVec>(src + (j * in_clip + (1 + f) * HW), valid,
                               next[f][j]);
  }
  // the quad's first count frame; its video frames start one further
  int off = 0;
#pragma unroll 1
  for (int q = 0; q < quads; ++q, off += 4 * HW) {
    In cur[4][kSpp][kPix];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int j = 0; j < kSpp; ++j)
#pragma unroll
        for (int k = 0; k < kPix; ++k) cur[f][j][k] = next[f][j][k];
    if (q + 1 < quads) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int j = 0; j < kSpp; ++j)
          v2v::load_pixels<kVec>(src + (j * in_clip + off + (5 + f) * HW),
                                 valid, next[f][j]);
    }
#pragma unroll
    for (int j = 0; j < kSpp; ++j)
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        w[j][k] = v2v::philox_draws(c[j].seed, p0 + k, q, v2v::kStreamNoise);
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int j = 0; j < kSpp; ++j) {
        float counts[kPix];
        v2v::frame_step<true>(cur[f][j], w[j], f, s_table, c[j], pot[j],
                              prev[j], hot[j], counts);
        v2v::store_counts<kVec>(dst + (j * out_clip + off + f * HW), valid,
                                counts);
      }
  }
  // the last 1-3 frames when N-1 is not a multiple of 4
  const int rest = (N - 1) - 4 * quads;
  if (rest > 0) {
#pragma unroll
    for (int j = 0; j < kSpp; ++j)
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        w[j][k] =
            v2v::philox_draws(c[j].seed, p0 + k, quads, v2v::kStreamNoise);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if (f < rest) {
#pragma unroll
        for (int j = 0; j < kSpp; ++j) {
          In raw[kPix];
          v2v::load_pixels<kVec>(src + (j * in_clip + off + (1 + f) * HW),
                                 valid, raw);
          float counts[kPix];
          v2v::frame_step<true>(raw, w[j], f, s_table, c[j], pot[j], prev[j],
                                hot[j], counts);
          v2v::store_counts<kVec>(dst + (j * out_clip + off + f * HW), valid,
                                  counts);
        }
      }
    }
  }
}

template <int kSpp, bool kU8, bool kVec>
int start(const K5Args& a, cudaStream_t s) {
  constexpr int kPix = Shape<kSpp>::kPix, kThreads = Shape<kSpp>::kThreads;
  const long long total =
      static_cast<long long>(a.groups) * ((a.HW + kPix - 1) / kPix);
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  sim_interleave_kernel<kSpp, kU8, kVec><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kSpp>
int launch(const K5Args& a, bool u8, cudaStream_t s) {
  constexpr int kPix = Shape<kSpp>::kPix;
  // one pixel a thread is always a whole, aligned "vector"
  if constexpr (kPix == 1) {
    return u8 ? start<kSpp, true, true>(a, s) : start<kSpp, false, true>(a, s);
  } else {
    const bool vec = v2v::vector_ok<kPix>(a.video, u8, a.out, a.HW);
    if (u8)
      return vec ? start<kSpp, true, true>(a, s)
                 : start<kSpp, true, false>(a, s);
    return vec ? start<kSpp, false, true>(a, s)
               : start<kSpp, false, false>(a, s);
  }
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue (1) for a spp without an
// instance, a B that is not a multiple of it, or a group of spp clips
// (or B*H*W) of 2^31 elements or more (the wrapper checks all three).
extern "C" int v2v_simulate_interleave(const void* video, int video_is_u8,
                                       const float* table,
                                       const int32_t* seeds,
                                       const float* pos_thres,
                                       const float* neg_thres,
                                       const float* noise_std, void* out,
                                       int B, int N, int H, int W, int spp,
                                       void* stream) {
  const long long hw = static_cast<long long>(H) * W;
  if (spp <= 0 || B % spp || static_cast<long long>(spp) * N * hw > INT_MAX ||
      B * hw > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const K5Args a{video,     table,     seeds,
                 pos_thres, neg_thres, noise_std,
                 static_cast<__nv_bfloat16*>(out), B / spp, N,
                 static_cast<int>(hw)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool u8 = video_is_u8 != 0;
  switch (spp) {
    case 1: return launch<1>(a, u8, s);
    case 2: return launch<2>(a, u8, s);
    case 4: return launch<4>(a, u8, s);
    case 8: return launch<8>(a, u8, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
