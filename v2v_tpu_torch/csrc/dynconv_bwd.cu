// K4's gradient: the VJP of HyperE2VID's dynamic shift-sum, k = 5,
//
//   out[b,y,x,o] = sum_{l<25, m<M} atoms[b,y,x,m,l] * z[b, y+i-2, x+j-2, m, o]
//
// with l = i*5 + j and z read as zero outside the image. Given the
// cotangent g (B,H,W,CO) float32 (any strides), it computes
//
//   datoms[b,y,x,m,l] = sum_o z[b, y+i-2, x+j-2, m, o] * g[b,y,x,o]
//   dz[b,y,x,m,o]     = sum_l atoms[b, y-i+2, x-j+2, m, l]
//                             * g[b, y-i+2, x-j+2, o]
//
// over the source pixels that lie in the image: datoms float32, dz
// accumulated in float32 and rounded once to z's type (bfloat16 on the
// train path). z (B,H,W,M,CO) float32 or bfloat16 and atoms (B,H,W,M,25)
// float32 are contiguous; dz and datoms are written contiguous.
//
// Replaces v2v_tpu/ops/dynconv.py::_shift_sum_bwd (:118), which is jnp:
// the JAX package has no backward kernel (its fused Pallas backward was
// retired over an on-chip dz mismatch). On the path: the train step of
// configs/train_v2v_hyper_10k.yaml, z (12,32,32,6,128) bf16, 40 times a
// step; the plain PyTorch loop it replaces made ~117 launches a call.
//
// What bounds it: bytes. At the train shape it reads z 18.87 MB (bf16),
// atoms 7.37 MB and g 6.29 MB and writes dz 18.87 MB and datoms 7.37 MB:
// 58.8 MB, 0.0176 ms at 3.35 TB/s, against 2 * 2 * 150 * B*H*W*CO = 0.94
// GFLOP, 0.014 ms at 67 TFLOP/s float32. Tensor cores do not pay: both
// gradients are matrix-vector work per pixel (datoms 150 dot products of
// length CO against the pixel's own g; dz a 25-tap box sum of a*g per
// atom), about 16 FLOP a byte, far below the card's ridge, and neither
// has the shared operand a matrix product needs. The design reads each
// operand from device memory about once and launches twice; what it
// spends is shared-memory traffic and load latency.
//
// Both kernels: blocks of 256 threads over 8x8 tiles, a warp per tile
// row, and each lane owns four neighbouring channels of a 128-channel
// chunk, read from shared memory as one float4 (rows padded to 132
// floats, so a warp's read is 512 contiguous bytes). At most 128
// registers a thread (__launch_bounds__(256, 2)): two blocks an SM.
//
// dz, as a gather: each output reads its 25 mirrored source pixels and is
// written once; no block adds into another's outputs (the retired Pallas
// backward read-modify-wrote overlapping halo windows). One block per
// (tile, batch item, 128-channel chunk of CO). Shared memory holds the
// haloed 12x12 g tile of the chunk (float32), loaded once, and for each
// atom m in turn the haloed tile's atoms[..., m, :], each offset row's 5
// taps padded to 8 (a float4 and a float load): 99,072 B. The next
// atom's tile is fetched into registers while the current one's sums
// run. A lane walks the 5 source rows of its output row and their 12
// columns once; each source g feeds the up to 5 outputs that read it,
// and each atom, one broadcast load, 4 channels. Its 8x4 sums stay in
// registers.
//
// datoms, as a per-pixel channel reduction: one block per (tile, batch
// item, atom). It loops over the chunks of CO inside itself (CO = 97 and
// 256 need no atomics and no second pass), holding the haloed z tile
// (12x12, widened to float32) and the tile's g (8x8) in shared memory:
// 109,824 B. Both load 16 bytes at a time where the layout allows (z when
// CO is a multiple of 16 / sizeof(z); g along x for the model's NCHW
// view). A warp takes its row's pixels in pairs, which share 4 of the 6
// source columns of each source row; a lane sums its 4 channels of each
// of the 25 offsets, then a fixed 31-shuffle transposing tree leaves
// offset l's sum over the warp in lane l, which writes it (a later chunk
// adds to what the lane wrote, in chunk order). No atomics: the results
// are the same bits from run to run.
//
// Registers and spills (-Xptxas -v, printed by chip_smoke.py's [build]):
// 128 registers each; dz spills 232 B (float) / 240 B (bf16) and datoms
// 20 B, at 128 registers (the prefetched atom tile in dz). Unrolled in
// full, or without the cap, both kernels took 255 registers, spilled and
// ran one block an SM (PERF.md, section 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kK = 5;
constexpr int kL = kK * kK;
constexpr int kHalo = kK / 2;
constexpr int kT = 8;                  // rows and columns of a tile
constexpr int kZt = kT + kK - 1;       // rows and columns of a haloed tile
constexpr int kVec = 4;                // channels of a lane
constexpr int kCo = 32 * kVec;         // channels of a chunk
constexpr int kPitch = kCo + kVec;     // a pixel's channels in shared memory
constexpr int kThreads = 32 * kT;      // a warp a tile row
constexpr int kAp = 8;                 // an offset row's 5 taps, padded
constexpr int kAt = (kZt * kZt * kL + kThreads - 1) / kThreads;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);  // round to nearest even, as torch does
}

struct GStrides {
  long long b, y, x, c;
};

// g[b, y_lo + q / n, x_lo + q % n, c0 + ch] into dst[q * kPitch + ch]
// for the n x n pixels q and ch < kCo, zero off the image and past CO.
// With contiguous channels (NHWC) a warp reads 32 channels of a pixel;
// otherwise (the NCHW view the model's permute hands back) 4 channels of
// 8 pixels, 32-byte runs along x, whose shared-memory stores fall in 32
// different banks.
__device__ __forceinline__ void load_g(float* dst, const float* g,
                                       GStrides s, int b, int y_lo,
                                       int x_lo, int n, int c0, int co,
                                       int h, int w) {
  const int n_pix = n * n;
  for (int i = threadIdx.x; i < n_pix * kCo; i += kThreads) {
    int q, ch;
    if (s.c == 1) {
      q = i / kCo;
      ch = i % kCo;
    } else {
      q = (i / kVec) % n_pix;
      ch = i / (kVec * n_pix) * kVec + i % kVec;
    }
    const int y = y_lo + q / n;
    const int x = x_lo + q % n;
    const int c = c0 + ch;
    float v = 0.f;
    if (y >= 0 && y < h && x >= 0 && x < w && c < co) {
      v = g[b * s.b + y * s.y + x * s.x + c * s.c];
    }
    dst[q * kPitch + ch] = v;
  }
}

// 16 bytes of z widened to float32
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {    // little-endian: the low half first
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dz_kernel(const float* __restrict__ atoms, const float* __restrict__ g,
          GStrides gs, T* __restrict__ dz, int h, int w, int m_atoms,
          int co) {
  extern __shared__ __align__(16) float smem[];
  float* gt = smem;                          // [kZt*kZt][kPitch]
  float* at = smem + kZt * kZt * kPitch;     // [kZt*kZt][kK][kAp], atom m
  const int lane = threadIdx.x & 31;
  const int py = threadIdx.x >> 5;           // the warp's output row
  const int tiles_w = (w + kT - 1) / kT;
  const int y0 = (blockIdx.x / tiles_w) * kT;
  const int x0 = (blockIdx.x % tiles_w) * kT;
  const int b = blockIdx.y;
  const long long pix0 = static_cast<long long>(b) * h * w;
  const int c0 = blockIdx.z * kCo;

  // the haloed tile's atoms of one atom, kAt values a thread, fetched
  // into registers while the previous atom's sums run
  float pre[kAt];
  auto fetch = [&](int m) {
#pragma unroll
    for (int r = 0; r < kAt; ++r) {
      const int i = threadIdx.x + r * kThreads;
      const int q = i / kL;
      const int y = y0 - kHalo + q / kZt;
      const int x = x0 - kHalo + q % kZt;
      pre[r] = i < kZt * kZt * kL && y >= 0 && y < h && x >= 0 && x < w
                   ? atoms[((pix0 + static_cast<long long>(y) * w + x) *
                                m_atoms + m) * kL + i % kL]
                   : 0.f;
    }
  };
  fetch(0);
  load_g(gt, g, gs, b, y0 - kHalo, x0 - kHalo, kZt, c0, co, h, w);

  for (int m = 0; m < m_atoms; ++m) {
    __syncthreads();  // the previous atom's tile is consumed
#pragma unroll
    for (int r = 0; r < kAt; ++r) {
      const int i = threadIdx.x + r * kThreads;
      const int l = i % kL;
      if (i < kZt * kZt * kL) {
        at[(i / kL * kK + l / kK) * kAp + l % kK] = pre[r];
      }
    }
    __syncthreads();  // and g is loaded
    if (m + 1 < m_atoms) fetch(m + 1);

    float4 acc[kT];
#pragma unroll
    for (int px = 0; px < kT; ++px) acc[px] = make_float4(0.f, 0.f, 0.f, 0.f);

    // Output (py, px) reads offset l = 5i + j at the haloed tile's
    // (py + 4 - i, px + 4 - j). Walk the source rows py + s (i = 4 - s)
    // and columns sx: the source feeds column px = sx + j - 4. (Unrolling
    // s too lets the compiler hoist loads until the registers spill.)
#pragma unroll 1
    for (int s = 0; s < kK; ++s) {
      const int i = kK - 1 - s;
#pragma unroll
      for (int sx = 0; sx < kZt; ++sx) {
        const int q = (py + s) * kZt + sx;
        const float4 gv = lds4(gt + q * kPitch + kVec * lane);
        const float* aq = at + (q * kK + i) * kAp;
        const float4 a4 = lds4(aq);          // taps j = 0..3, a broadcast
        const float a5 = aq[4];
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          const int px = sx + j - (kK - 1);
          if (px < 0 || px >= kT) continue;
          const float a = j == 0 ? a4.x : j == 1 ? a4.y : j == 2 ? a4.z
                        : j == 3 ? a4.w : a5;
          acc[px].x = fmaf(a, gv.x, acc[px].x);
          acc[px].y = fmaf(a, gv.y, acc[px].y);
          acc[px].z = fmaf(a, gv.z, acc[px].z);
          acc[px].w = fmaf(a, gv.w, acc[px].w);
        }
      }
    }

    const int y = y0 + py;
    const int c = c0 + kVec * lane;
    if (y < h) {
#pragma unroll
      for (int px = 0; px < kT; ++px) {
        const int x = x0 + px;
        if (x >= w) continue;
        T* d = dz + ((pix0 + static_cast<long long>(y) * w + x) * m_atoms +
                     m) * co + c;
        const float v[kVec] = {acc[px].x, acc[px].y, acc[px].z, acc[px].w};
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (c + k < co) narrow(v[k], d + k);
        }
      }
    }
  }
}

// One stage of the transposing reduction: lanes that differ in bit kW
// swap halves of v[0..2kW) and add, so v[k] (k < kW) then holds the sum
// over both lanes of the value that was v[k + (lane & kW)].
template <int kW>
__device__ __forceinline__ void reduce_stage(float (&v)[32], int lane) {
  const bool upper = (lane & kW) != 0;
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const float send = upper ? v[k] : v[k + kW];
    const float keep = upper ? v[k + kW] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, kW);
  }
}

// v[l] summed over the warp, returned in lane l (31 shuffles, a fixed
// order).
__device__ __forceinline__ float transpose_reduce(float (&v)[32],
                                                  int lane) {
  reduce_stage<16>(v, lane);
  reduce_stage<8>(v, lane);
  reduce_stage<4>(v, lane);
  reduce_stage<2>(v, lane);
  reduce_stage<1>(v, lane);
  return v[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
datoms_kernel(const T* __restrict__ z, const float* __restrict__ g,
              GStrides gs, float* __restrict__ datoms, int h, int w,
              int m_atoms, int co, bool z_vec, bool g_vec_x) {
  extern __shared__ __align__(16) float smem[];
  float* zt = smem;                          // [kZt*kZt][kPitch]
  float* gt = smem + kZt * kZt * kPitch;     // [kT*kT][kPitch]
  const int lane = threadIdx.x & 31;
  const int py = threadIdx.x >> 5;           // the warp's tile row
  const int tiles_w = (w + kT - 1) / kT;
  const int y0 = (blockIdx.x / tiles_w) * kT;
  const int x0 = (blockIdx.x % tiles_w) * kT;
  const int b = blockIdx.y;
  const int m = blockIdx.z;
  const long long pix0 = static_cast<long long>(b) * h * w;
  const int y = y0 + py;

  for (int c0 = 0; c0 < co; c0 += kCo) {
    if (c0 > 0) __syncthreads();  // the previous chunk's tiles are consumed
    if (z_vec) {       // 16-byte loads: CO a multiple of 16 / sizeof(T)
      constexpr int kPer = 16 / sizeof(T);
#pragma unroll 4
      for (int i = threadIdx.x; i < kZt * kZt * kCo / kPer; i += kThreads) {
        const int q = i / (kCo / kPer);
        const int ch = i % (kCo / kPer) * kPer;
        const int yz = y0 - kHalo + q / kZt;
        const int xz = x0 - kHalo + q % kZt;
        float f[kPer] = {};
        if (yz >= 0 && yz < h && xz >= 0 && xz < w && c0 + ch < co) {
          load16(z + ((pix0 + static_cast<long long>(yz) * w + xz) *
                          m_atoms + m) * co + c0 + ch, f);
        }
#pragma unroll
        for (int k = 0; k < kPer; k += 4) {
          *reinterpret_cast<float4*>(zt + q * kPitch + ch + k) =
              make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
        }
      }
    } else {
      for (int i = threadIdx.x; i < kZt * kZt * kCo; i += kThreads) {
        const int q = i / kCo;
        const int ch = i % kCo;
        const int yz = y0 - kHalo + q / kZt;
        const int xz = x0 - kHalo + q % kZt;
        float v = 0.f;
        if (yz >= 0 && yz < h && xz >= 0 && xz < w && c0 + ch < co) {
          v = widen(z[((pix0 + static_cast<long long>(yz) * w + xz) *
                           m_atoms + m) * co + c0 + ch]);
        }
        zt[q * kPitch + ch] = v;
      }
    }
    if (g_vec_x) {     // the NCHW view: x contiguous, rows 16-byte aligned
      // a warp: 8 channels x 4 of the tile's 16 half rows, so its stores
      // fall in 16 banks and its loads in 32-byte runs
#pragma unroll 4
      for (int i = threadIdx.x; i < kT * kT * kCo / 4; i += kThreads) {
        const int half_row = i / 8 % (kT * kT / 4);
        const int xq = half_row % 2 * 4;
        const int yq = half_row / 2;
        const int ch = i / (8 * kT * kT / 4) * 8 + i % 8;
        const int y = y0 + yq;
        const int c = c0 + ch;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (y < h && x0 + xq < w && c < co) {
          v = *reinterpret_cast<const float4*>(
              g + b * gs.b + y * gs.y + (x0 + xq) + c * gs.c);
        }
        float* d = gt + (yq * kT + xq) * kPitch + ch;
        d[0] = v.x;
        d[kPitch] = v.y;
        d[2 * kPitch] = v.z;
        d[3 * kPitch] = v.w;
      }
    } else {
      load_g(gt, g, gs, b, y0, x0, kT, c0, co, h, w);
    }
    __syncthreads();
    // pixel px0 + d reads offset (i, j) at the haloed tile's
    // (py + i, px0 + d + j): source column px0 + cx serves j = cx - d
#pragma unroll 1
    for (int px0 = 0; px0 < kT; px0 += 2) {
      float4 gv[2];
      float v[2][32];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        gv[d] = lds4(gt + (py * kT + px0 + d) * kPitch + kVec * lane);
#pragma unroll
        for (int l = kL; l < 32; ++l) v[d][l] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kK; ++i) {
#pragma unroll
        for (int cx = 0; cx < kK + 1; ++cx) {
          const float4 zq =
              lds4(zt + ((py + i) * kZt + px0 + cx) * kPitch + kVec * lane);
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int j = cx - d;
            if (j >= 0 && j < kK) v[d][i * kK + j] = dot4(zq, gv[d]);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float sum = transpose_reduce(v[d], lane);
        const int x = x0 + px0 + d;
        if (lane < kL && y < h && x < w) {
          // chunks in order; a later chunk adds to what this lane wrote
          float* out = datoms + ((pix0 + static_cast<long long>(y) * w + x) *
                                     m_atoms + m) * kL + lane;
          *out = c0 > 0 ? *out + sum : sum;
        }
      }
    }
  }
}

constexpr size_t kDzSmem =
    sizeof(float) * kZt * kZt * (kPitch + kK * kAp);           // 99,072 B
constexpr size_t kDaSmem =
    sizeof(float) * (kZt * kZt + kT * kT) * kPitch;            // 109,824 B

template <typename T>
int launch(const void* z, const float* atoms, const float* g, GStrides gs,
           void* dz, float* datoms, int b, int h, int w, int m_atoms, int co,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dz_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDzSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(datoms_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDaSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((h + kT - 1) / kT) * ((w + kT - 1) / kT);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool z_vec = co % (16 / sizeof(T)) == 0 && aligned(z);
  const bool g_vec_x = gs.x == 1 && w % 4 == 0 && gs.y % 4 == 0 &&
                       gs.c % 4 == 0 && gs.b % 4 == 0 && aligned(g);
  dz_kernel<T><<<dim3(tiles, b, (co + kCo - 1) / kCo), kThreads, kDzSmem,
                 stream>>>(atoms, g, gs, static_cast<T*>(dz), h, w, m_atoms,
                           co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  datoms_kernel<T><<<dim3(tiles, b, m_atoms), kThreads, kDaSmem, stream>>>(
      static_cast<const T*>(z), g, gs, datoms, h, w, m_atoms, co, z_vec,
      g_vec_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (B,H,W,M,CO) float32 (z_bf16 = 0) or bfloat16 (z_bf16 = 1) and atoms
// (B,H,W,M,25) float32, contiguous; g (B,H,W,CO) float32 with element
// strides g_sb, g_sy, g_sx, g_sc; dz (B,H,W,M,CO) in z's type and datoms
// (B,H,W,M,25) float32, contiguous. The wrapper checks shapes and types.
extern "C" int v2v_shift_sum_bwd(const void* z, const float* atoms,
                                 const float* g, long long g_sb,
                                 long long g_sy, long long g_sx,
                                 long long g_sc, void* dz, float* datoms,
                                 int b, int h, int w, int m_atoms, int co,
                                 int z_bf16, void* stream) {
  const GStrides gs{g_sb, g_sy, g_sx, g_sc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_bf16) {
    return launch<__nv_bfloat16>(z, atoms, g, gs, dz, datoms, b, h, w,
                                 m_atoms, co, s);
  }
  return launch<float>(z, atoms, g, gs, dz, datoms, b, h, w, m_atoms, co, s);
}
