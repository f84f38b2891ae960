// Bilinear x2 upsample of NCHW or channels-last (NHWC) tensors,
// align_corners=False, forward and backward:
//
//   out[p, y, x] = sum over rows r and columns c of wy(y, r) wx(x, c) in[p, r, c]
//
// for each plane p of N*C, with ATen's rule for scale_factor=2: output
// index d reads source index max(0.5 * (d + 0.5) - 0.5, 0), so output
// 2j reads j - 0.25 (weights 0.25 on j-1 and 0.75 on j; 1 on 0 and 0 on
// 1 at j = 0) and output 2j+1 reads j + 0.25 (0.75 on j and 0.25 on
// min(j+1, n-1)). Types float32, bfloat16 and float16; sums in float32,
// rounded once to the output type.
//
// Replaces no TPU kernel: the JAX package resizes with jax.image.resize
// (two matmuls with the interpolation matrix). It replaces ATen's NCHW
// kernels (upsample_bilinear2d_out_frame and its backward), which give a
// thread to each output pixel and loop it over all N*C planes: at the
// flagship's (480, 256, 16, 16) bf16 input that is 1,024 threads each
// walking 122,880 planes, 47.9 ms for 314.6 MB (0.094 ms at 3.35 TB/s).
// On the path: UpsampleConvLayer (models/submodules.py), so every UNet
// decoder, ETNet's and NerNet's, and HyperE2VID's dynamic decoder
// (models/hyper.py); three calls each way a flagship train step.
//
// What bounds it: bytes. The forward reads the input once and writes four
// times as many outputs; the backward reads the four-times-larger output
// gradient and writes the input gradient. At most 16 float32 operations an
// output, far below the card's ridge.
//
// Design. Both kernels parallelise over every (plane, input row, group of
// 4 input columns): a thread per group. In NCHW consecutive threads take
// consecutive groups of a row, then the rows of a plane, then the planes,
// so a block of 256 threads covers whole neighbouring rows and its
// neighbours' rows come from L1. In NHWC (the layout follows the tensor,
// as ATen's kernels do, so a channels-last caller pays no layout copy)
// consecutive threads take consecutive channels of one group, then the
// groups, rows and images: a warp's loads and stores fall on neighbouring
// channels of a pixel, whole sectors, element by element.
//
// Forward: a thread reads input columns j0-1 .. j0+4 (clamped to the
// row) of rows k-1, k, k+1 (clamped to the plane), interpolates each row
// along the width into 8 values, then rows 2k and 2k+1 of the output
// along the height, and writes its 2 x 8 outputs with 16-byte stores.
// Each output is ATen's expression h0 * (w0 * a + w1 * b) + h1 * (w0 * c +
// w1 * d) on the same taps and weights, each sum contracted as nvcc
// contracts ATen's: in its NCHW kernel fma(w0, a, w1 * b) everywhere (the
// one of nine roundings that gave ATen's float32 bits on the card); in its
// NHWC kernel, which ATen takes for channels-last tensors of 16 channels
// or more, fma(w1, b, w0 * a) for the upper row's sum and fma(w0, c, w1 *
// d) for the lower row's and the outer sum (the one of 27; PERF.md,
// section 6). So the kernel gives ATen's bits in every type and layout.
//
// Backward: a gather, no atomics and no zero fill. A thread owns 4
// neighbouring input-gradient elements of one row k and reads output
// gradient rows 2k-1 .. 2k+2 (those that exist) at columns 2*j0-1 ..
// 2*j0+8 (zero outside the row). Along each axis input j collects output
// 2j-1 with 0.25, 2j with 0.75 (1 at j = 0, where output 0 reads j alone),
// 2j+1 with 0.75 (1 at j = n-1, where output 2j+1 reads j twice) and 2j+2
// with 0.25: the sum of every weight ATen's scatter gives it. A thread
// sums each row along the width, then the rows with their height weights,
// in that fixed order, and writes each element once: two calls give equal
// bits. The sums are float32 for bfloat16 and float16 gradients and
// float64 for float32 ones: in float32 the gather's worst error matched
// that of ATen's float32 atomics only by chance (PERF.md, section 6), and the
// float64 adds cost nothing against the bytes.
//
// Vector path (NCHW): where W is a multiple of 4 and both pointers are
// 16-byte aligned, a thread's centre columns load and its outputs store as
// whole 8- or 16-byte words; else element by element, masked at the row's
// end (odd sizes, W < 4, views).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kCols = 4;        // input columns a thread
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// w0 * a + w1 * b rounded as ATen's kernels round it (and, where
// kSwap, as its NHWC kernel rounds the upper row's sum)
template <bool kSwap = false>
__device__ __forceinline__ float mix(float w0, float a, float w1, float b) {
  return kSwap ? __fmaf_rn(w1, b, __fmul_rn(w0, a))
               : __fmaf_rn(w0, a, __fmul_rn(w1, b));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// N elements moved as one aligned word (8 or 16 bytes)
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// A thread's place: its row (plane * h + k in NCHW, image * h + k in
// NHWC), first column and channel (0 in NCHW, where the plane holds it).
// Indices are 32-bit: a thread covers 4 input elements, so 2^32 threads
// would be a 128 GiB bfloat16 output, more than the card holds.
struct Place {
  unsigned row;
  int k, j0, c;
};

template <bool kNhwc>
__device__ __forceinline__ Place place(unsigned t, int h, int groups,
                                       int channels) {
  Place p;
  p.c = 0;
  if (kNhwc) {
    const unsigned q = t / static_cast<unsigned>(channels);
    p.c = static_cast<int>(t - q * static_cast<unsigned>(channels));
    t = q;
  }
  p.row = t / static_cast<unsigned>(groups);
  p.j0 = static_cast<int>(t - p.row * static_cast<unsigned>(groups)) * kCols;
  p.k = static_cast<int>(p.row % static_cast<unsigned>(h));
  return p;
}

// Columns j0-1 .. j0+kCols of an input row, each clamped to [0, w-1];
// columns cs elements apart (1 in NCHW, C in NHWC).
template <typename T, bool kVec>
__device__ __forceinline__ void load_input(const T* __restrict__ row, int j0,
                                           int w, int cs,
                                           float (&v)[kCols + 2]) {
  if (kVec) {
    const Pack<T, kCols> p = *reinterpret_cast<const Pack<T, kCols>*>(row + j0);
#pragma unroll
    for (int i = 0; i < kCols; ++i) v[i + 1] = to_f32(p.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      v[i + 1] = to_f32(row[static_cast<size_t>(min(j0 + i, w - 1)) * cs]);
  }
  v[0] = to_f32(row[static_cast<size_t>(max(j0 - 1, 0)) * cs]);
  v[kCols + 1] = to_f32(row[static_cast<size_t>(min(j0 + kCols, w - 1)) * cs]);
}

// N values to a row, those before `valid`, columns cs elements apart.
template <typename T, bool kVec, int N>
__device__ __forceinline__ void store(T* __restrict__ out, const float (&v)[N],
                                      int valid, int cs) {
  if (kVec) {
    constexpr int kWord = 16 / sizeof(T) < N ? 16 / sizeof(T) : N;
#pragma unroll
    for (int s = 0; s < N / kWord; ++s) {
      Pack<T, kWord> p;
#pragma unroll
      for (int e = 0; e < kWord; ++e) p.v[e] = from_f32<T>(v[s * kWord + e]);
      reinterpret_cast<Pack<T, kWord>*>(out)[s] = p;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < valid) out[static_cast<size_t>(c) * cs] = from_f32<T>(v[c]);
  }
}

template <typename T, bool kVec, bool kNhwc, bool kNhwcRounding>
__global__ void __launch_bounds__(kThreads)
    upsample2x_kernel(const T* __restrict__ in, T* __restrict__ out, int h,
                      int w, int channels, int groups, unsigned total) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const Place p = place<kNhwc>(t, h, groups, channels);
  const size_t row = static_cast<size_t>(p.row);
  // a column's and an input row's strides, in elements
  const int cs = kNhwc ? channels : 1;
  const size_t rs = static_cast<size_t>(w) * cs;
  // rows k-1, k, k+1 of the plane, clamped to it
  const size_t rows[3] = {row - (p.k > 0), row, row + (p.k < h - 1)};
  // each row interpolated along the width, rounded as the upper row of an
  // output's pair (up) and as the lower (low): alike but in ATen's NHWC
  // kernel
  float up[3][2 * kCols], low[3][2 * kCols];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float v[kCols + 2];
    load_input<T, kVec>(in + rows[r] * rs + p.c, p.j0, w, cs, v);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      // output 2j: source j - 0.25, or 0 at j = 0 (1 on 0, 0 on 1)
      const bool left = p.j0 + i == 0;
      const float w0 = left ? 1.f : 0.25f, w1 = left ? 0.f : 0.75f;
      const float a = left ? v[1] : v[i], b = left ? v[2] : v[i + 1];
      up[r][2 * i] = mix<kNhwcRounding>(w0, a, w1, b);
      low[r][2 * i] = mix(w0, a, w1, b);
      // output 2j+1: source j + 0.25 (0.75 on j, 0.25 on min(j+1, w-1))
      up[r][2 * i + 1] = mix<kNhwcRounding>(0.75f, v[i + 1], 0.25f, v[i + 2]);
      low[r][2 * i + 1] = mix(0.75f, v[i + 1], 0.25f, v[i + 2]);
    }
  }
  // output row 2k: source k - 0.25, or 0 at k = 0; row 2k+1: k + 0.25
  const bool top = p.k == 0;
  const float h0 = top ? 1.f : 0.25f, h1 = top ? 0.f : 0.75f;
  float even[2 * kCols], odd[2 * kCols];
#pragma unroll
  for (int c = 0; c < 2 * kCols; ++c) {
    const float x0 = top ? up[1][c] : up[0][c];
    const float x1 = top ? low[2][c] : low[1][c];
    even[c] = mix(h0, x0, h1, x1);
    odd[c] = mix(0.75f, up[1][c], 0.25f, low[2][c]);
  }
  // output rows 2k and 2k+1, 2 * rs apart; column 2 * j0
  T* o = out + 4 * row * rs + 2 * static_cast<size_t>(p.j0) * cs + p.c;
  const int valid = 2 * (w - p.j0);
  store<T, kVec>(o, even, valid, cs);
  store<T, kVec>(o + 2 * rs, odd, valid, cs);
}

// Output-gradient columns 2*j0-1 .. 2*j0+2*kCols of a row, zero outside
// [0, width); columns cs elements apart.
template <typename T, bool kVec>
__device__ __forceinline__ void load_grad(const T* __restrict__ row, int j0,
                                          int width, int cs,
                                          float (&v)[2 * kCols + 2]) {
  const int x0 = 2 * j0;
  const auto at = [&](int x) { return to_f32(row[static_cast<size_t>(x) * cs]); };
  if (kVec) {
    constexpr int kWord = 16 / sizeof(T) < 2 * kCols ? 16 / sizeof(T)
                                                     : 2 * kCols;
    const Pack<T, kWord>* src = reinterpret_cast<const Pack<T, kWord>*>(row + x0);
#pragma unroll
    for (int s = 0; s < 2 * kCols / kWord; ++s) {
      const Pack<T, kWord> p = src[s];
#pragma unroll
      for (int e = 0; e < kWord; ++e) v[1 + s * kWord + e] = to_f32(p.v[e]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < 2 * kCols; ++m)
      v[m + 1] = x0 + m < width ? at(x0 + m) : 0.f;
  }
  v[0] = x0 > 0 ? at(x0 - 1) : 0.f;
  v[2 * kCols + 1] = x0 + 2 * kCols < width ? at(x0 + 2 * kCols) : 0.f;
}

// The weight that output 2j+d (d = -1 .. 2) gives input j of n along one
// axis; an output past the edge reads as zero, whatever its weight.
__device__ __forceinline__ float weight(int d, int j, int n) {
  switch (d) {
    case -1: return 0.25f;
    case 0: return j == 0 ? 1.f : 0.75f;
    case 1: return j == n - 1 ? 1.f : 0.75f;
    default: return 0.25f;
  }
}

// The backward's sums: float64 for float32 gradients, else float32.
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<float> {
  using type = double;
};

template <typename T, bool kVec, bool kNhwc>
__global__ void __launch_bounds__(kThreads)
    upsample2x_backward_kernel(const T* __restrict__ gout, T* __restrict__ gin,
                               int h, int w, int channels, int groups,
                               unsigned total) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const Place p = place<kNhwc>(t, h, groups, channels);
  const size_t row = static_cast<size_t>(p.row);
  const int width = 2 * w;
  // a column's and an input row's strides, in elements; output rows are
  // 2 * rs apart
  const int cs = kNhwc ? channels : 1;
  const size_t rs = static_cast<size_t>(w) * cs;
  const T* rows = gout + 4 * row * rs + p.c;  // output rows 2k, 2k+1, ...
  using A = typename Acc<T>::type;
  A acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0;
#pragma unroll
  for (int d = -1; d <= 2; ++d) {
    const int y = 2 * p.k + d;
    if (y < 0 || y >= 2 * h) continue;
    float v[2 * kCols + 2];
    load_grad<T, kVec>(rows + d * 2 * static_cast<ptrdiff_t>(rs), p.j0, width,
                       cs, v);
    const A wy = weight(d, p.k, h);
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int j = p.j0 + i;
      const A s = A(weight(-1, j, w)) * v[2 * i] +
                  A(weight(0, j, w)) * v[2 * i + 1] +
                  A(weight(1, j, w)) * v[2 * i + 2] +
                  A(weight(2, j, w)) * v[2 * i + 3];
      acc[i] += wy * s;
    }
  }
  float out[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) out[i] = static_cast<float>(acc[i]);
  store<T, kVec>(gin + row * rs + static_cast<size_t>(p.j0) * cs + p.c, out,
                 w - p.j0, cs);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool kBackward, bool kVec, bool kNhwc,
          bool kNhwcRounding = false>
void start(unsigned blocks, cudaStream_t stream, const T* src, T* dst, int h,
           int w, int channels, int groups, unsigned total) {
  if constexpr (kBackward)
    upsample2x_backward_kernel<T, kVec, kNhwc>
        <<<blocks, kThreads, 0, stream>>>(src, dst, h, w, channels, groups,
                                          total);
  else
    upsample2x_kernel<T, kVec, kNhwc, kNhwcRounding>
        <<<blocks, kThreads, 0, stream>>>(src, dst, h, w, channels, groups,
                                          total);
}

// ATen takes its NHWC forward kernel for channels-last tensors of this
// many channels or more, and its NCHW kernel on an NCHW copy below
constexpr int kAtenNhwcChannels = 16;

template <typename T, bool kBackward>
int launch(const void* src, void* dst, long long images, int channels, int h,
           int w, bool nhwc, cudaStream_t stream) {
  const int groups = (w + kCols - 1) / kCols;
  const unsigned long long total =
      static_cast<unsigned long long>(images) * channels * h * groups;
  // every thread's index, the last block's too, fits in 32 bits
  if (total > UINT_MAX - kThreads) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const unsigned n = static_cast<unsigned>(total);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(dst);
  if (nhwc && !kBackward && channels >= kAtenNhwcChannels)
    start<T, kBackward, false, true, true>(blocks, stream, s, o, h, w,
                                           channels, groups, n);
  else if (nhwc)
    start<T, kBackward, false, true>(blocks, stream, s, o, h, w, channels,
                                     groups, n);
  else if (w % kCols == 0 && aligned(src) && aligned(dst))
    start<T, kBackward, true, false>(blocks, stream, s, o, h, w, 1, groups, n);
  else
    start<T, kBackward, false, false>(blocks, stream, s, o, h, w, 1, groups,
                                      n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBackward>
int dispatch(const void* src, void* dst, long long images, int channels,
             int h, int w, int nhwc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cl = nhwc != 0;
  switch (dtype) {
    case 0: return launch<float, kBackward>(src, dst, images, channels, h, w, cl, s);
    case 1: return launch<__nv_bfloat16, kBackward>(src, dst, images, channels, h, w, cl, s);
    case 2: return launch<__half, kBackward>(src, dst, images, channels, h, w, cl, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. in (images, channels, h, w) ->
// out (images, channels, 2h, 2w), both NCHW-contiguous, or both
// channels-last where nhwc is 1; images, channels, h, w > 0. Returns the
// launch's cudaError_t, or -1 for an unknown dtype.
extern "C" int v2v_upsample2x(const void* in, void* out, long long images,
                              int channels, int h, int w, int nhwc, int dtype,
                              void* stream) {
  return dispatch<false>(in, out, images, channels, h, w, nhwc, dtype, stream);
}

// grad_out (images, channels, 2h, 2w) -> grad_in (images, channels, h, w),
// in one layout as above.
extern "C" int v2v_upsample2x_backward(const void* grad_out, void* grad_in,
                                       long long images, int channels, int h,
                                       int w, int nhwc, int dtype,
                                       void* stream) {
  return dispatch<true>(grad_out, grad_in, images, channels, h, w, nhwc, dtype,
                        stream);
}
