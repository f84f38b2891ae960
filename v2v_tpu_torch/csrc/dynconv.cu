// K4: HyperE2VID's dynamic shift-sum, k = 5,
//
//   out[b,y,x,o] = sum_{l<25, m<M} atoms[b,y,x,m,l] * z[b, y+i-2, x+j-2, m, o]
//
// with l = i*5 + j (torch-unfold row-major) and z read as zero outside
// the image. z (B,H,W,M,CO) float32 or bfloat16, atoms (B,H,W,M,25)
// float32, out (B,H,W,CO) float32, all contiguous.
//
// Replaces v2v_tpu/ops/dynconv.py::dynamic_shift_sum (:145; Pallas body
// `_fwd_kernel` :70), the decoder-0 dynamic conv of HyperE2VID. On the
// path: the 720p eval, z (1,180,320,6,128) float32, once a frame; the
// train step, z (12,32,32,6,128) bfloat16, 40 times a step.
//
// What bounds it: bytes. Each input read once and the output written
// once is 241.0 MB at the eval shape, 0.0719 ms at 3.35 TB/s, against
// 2 * 150 * B*H*W*CO = 2.2 GFLOP, 0.033 ms at 67 TFLOP/s float32; at the
// train shape 32.5 MB, 0.0097 ms, against 0.47 GFLOP, 0.007 ms. No
// tensor cores: about 9 FLOP a byte, far below the card's ridge, and no
// operand is shared between pixels (each has its own atoms), so there is
// no matrix product to give them; TF32 or bfloat16 atoms would also miss
// the float32 tolerance (1e-4).
//
// What the design spends instead is shared-memory wavefronts (an SM
// serves one 128-byte wavefront a clock and issues four warp-FMAs), and
// the latency of each atom's tile load. One block per (tile of R rows x
// 8 columns, batch item, 128-channel chunk of CO): R warps, a warp per
// tile row, and a lane owns 4 neighbouring channels. For each atom m in
// turn the block holds the haloed (R+4) x 12 z tile of its chunk in z's
// own type (a pixel's 128 channels contiguous: a warp's read is 512 B of
// float32 or 256 B of bfloat16, no bank conflict) and the tile's taps
// atoms[..., m, :], each offset row's 5 taps padded to 8 so they load as
// a float4 and a float (a broadcast). A warp walks each of its 5 source
// rows once: it loads the row's 12 z vectors into registers (bfloat16
// widened there), then for each of its 8 outputs loads the row's 5 taps
// and adds 20 products; each z vector feeds the up to 5 outputs that read
// it. Per warp and (m, i): 160 warp-FMAs against 12 z loads (48
// wavefronts float32, 24 bfloat16) and 16 atom loads (16 wavefronts):
// 2.5 FMAs a wavefront in float32, 4 in bfloat16. The earlier kernel, a
// thread per channel reading one atom and one z value for every FMA, ran
// at about 1.
//
// Loads, for each atom m: the z tile by cp.async, 16 bytes at a time
// when CO is a multiple of 16 / sizeof(z) (else plain loads), zero-filled
// off the image and past CO; the taps of atom m+1 into registers (7 a
// thread, a warp reading 32 consecutive floats) while atom m's sums run,
// stored into their padded slots after the barrier. One buffer: while a
// block waits for its tile, the SM's other resident block computes. A
// second buffer for the next atom's tile (one block an SM, 8 warps) and
// 64-channel blocks (a quarter more wavefronts an FMA) both measured
// slower (PERF.md, section 6). Shared memory a block:
// (R+4)*12*128*sizeof(z) + R*8*5*8*4 bytes: at R = 8, 83,968 B in
// float32 and 47,104 B in bfloat16; at R = 4, 54,272 and 29,696 B; two
// blocks or more fit on an SM. The wrapper (ops/dynconv.py) picks R = 8,
// or R = 4 when the 8-row grid would give the card fewer than two blocks
// an SM (the train shape: 384 blocks of R = 4 against 192 of R = 8 on
// 132 SMs). At most 128 registers a thread (__launch_bounds__(256, 2)):
// 119 in float32 and 127 in bfloat16, no spills (CUDA 12.8's ptxas, as
// chip_smoke.py's [build] prints them).
//
// Rounding: each output's float32 fused multiply-adds in the order m,
// then the offset row i, then the tap j, where the plain version sums
// over m for each offset; they agree to float32 rounding of 150 terms
// (chip_smoke.py states the tolerance). No atomics: two calls give equal
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kK = 5;
constexpr int kL = kK * kK;
constexpr int kHalo = kK / 2;
constexpr int kTw = 8;                 // output columns of a tile
constexpr int kZw = kTw + kK - 1;      // columns of the haloed tile
constexpr int kVec = 4;                // channels of a lane
constexpr int kCo = 32 * kVec;         // channels of a block
constexpr int kAp = 8;                 // an offset row's 5 taps, padded
constexpr int kMaxRows = 8;            // tile rows, a warp each
constexpr int kAt = (kTw * kL + 31) / 32;  // taps a thread holds: 7

// shared memory: the haloed z tile, then the tile's taps
template <typename T>
constexpr int smem_bytes(int rows) {
  return (rows + kK - 1) * kZw * kCo * static_cast<int>(sizeof(T)) +
         rows * kTw * kK * kAp * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __ushort_as_bfloat16(0);
}

// a lane's 4 channels of one z pixel, widened to float32
__device__ __forceinline__ float4 lds_z(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds_z(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  // little-endian: the lower channel in the low half
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 v) {
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxRows, 2)
shift_sum_kernel(const T* __restrict__ z, const float* __restrict__ atoms,
                 float* __restrict__ out, int h, int w, int m_atoms, int co,
                 bool z_vec, bool out_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x / 32;
  const int nq = (rows + kK - 1) * kZw;      // pixels of the haloed tile
  T* zs = reinterpret_cast<T*>(smem);        // [nq][kCo]
  float* as = reinterpret_cast<float*>(      // [rows*kTw][kK][kAp]
      smem + nq * kCo * static_cast<int>(sizeof(T)));
  const int lane = threadIdx.x & 31;
  const int py = threadIdx.x >> 5;           // the warp's output row
  const int tiles_w = (w + kTw - 1) / kTw;
  const int y0 = (blockIdx.x / tiles_w) * rows;
  const int x0 = (blockIdx.x % tiles_w) * kTw;
  const long long pix0 = static_cast<long long>(blockIdx.y) * h * w;
  const int c0 = blockIdx.z * kCo;

  // atom m's haloed z tile of the block's channels into shared memory
  const auto fetch_z = [&](int m) {
    if (z_vec) {
      constexpr int kPer = 16 / sizeof(T);
      constexpr int kNv = kCo / kPer;
      for (int i = threadIdx.x; i < nq * kNv; i += blockDim.x) {
        const int q = i / kNv;
        const int ch = i % kNv * kPer;
        const int y = y0 - kHalo + q / kZw;
        const int x = x0 - kHalo + q % kZw;
        const bool ok =
            y >= 0 && y < h && x >= 0 && x < w && c0 + ch < co;
        cp_async16(zs + q * kCo + ch,
                   ok ? z + ((pix0 + static_cast<long long>(y) * w + x) *
                                 m_atoms + m) * co + c0 + ch
                      : z,
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < nq * kCo; i += blockDim.x) {
        const int q = i / kCo;
        const int ch = i % kCo;
        const int y = y0 - kHalo + q / kZw;
        const int x = x0 - kHalo + q % kZw;
        T v = zero_of(T());
        if (y >= 0 && y < h && x >= 0 && x < w && c0 + ch < co) {
          v = z[((pix0 + static_cast<long long>(y) * w + x) * m_atoms + m) *
                    co + c0 + ch];
        }
        zs[i] = v;
      }
    }
    // committed before the taps' loads are issued: a commit after them
    // made the wait below wait for those loads too
    cp_async_commit();
  };
  // atom m's taps of the tile, kAt a thread, into registers; a warp reads
  // 32 consecutive taps (a pixel's 25 are contiguous)
  float taps[kAt];
  const auto fetch_taps = [&](int m) {
#pragma unroll
    for (int r = 0; r < kAt; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      const int p = i / kL;
      const int y = y0 + p / kTw;
      const int x = x0 + p % kTw;
      taps[r] = p < rows * kTw && y < h && x < w
                    ? atoms[((pix0 + static_cast<long long>(y) * w + x) *
                                 m_atoms + m) * kL + i % kL]
                    : 0.f;
    }
  };

  float4 acc[kTw];
#pragma unroll
  for (int px = 0; px < kTw; ++px) acc[px] = make_float4(0.f, 0.f, 0.f, 0.f);

  fetch_taps(0);
  for (int m = 0; m < m_atoms; ++m) {
    fetch_z(m);              // the previous atom's sums are done
#pragma unroll
    for (int r = 0; r < kAt; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      const int l = i % kL;
      if (i < rows * kTw * kL) as[(i / kL * kK + l / kK) * kAp + l % kK] =
          taps[r];
    }
    if (m + 1 < m_atoms) fetch_taps(m + 1);  // in flight during the sums
    cp_async_wait();
    __syncthreads();         // atom m's tiles are in shared memory
    const T* zr = zs + kVec * lane;
    const float* ar = as + py * kTw * kK * kAp;
    // Output (py, px) reads offset (i, j) at the haloed tile's
    // (py + i, px + j). (Unrolling i too lets the compiler hoist loads
    // until the registers spill.)
#pragma unroll 1
    for (int i = 0; i < kK; ++i) {
      float4 zv[kZw];
#pragma unroll
      for (int sx = 0; sx < kZw; ++sx) {
        zv[sx] = lds_z(zr + ((py + i) * kZw + sx) * kCo);
      }
#pragma unroll
      for (int px = 0; px < kTw; ++px) {
        const float* a = ar + (px * kK + i) * kAp;
        const float4 a4 = *reinterpret_cast<const float4*>(a);  // broadcast
        const float a5 = a[4];
        fma4(acc[px], a4.x, zv[px]);
        fma4(acc[px], a4.y, zv[px + 1]);
        fma4(acc[px], a4.z, zv[px + 2]);
        fma4(acc[px], a4.w, zv[px + 3]);
        fma4(acc[px], a5, zv[px + 4]);
      }
    }
    __syncthreads();         // atom m's tiles are consumed
  }

  const int y = y0 + py;
  const int c = c0 + kVec * lane;
  if (y >= h || c >= co) return;
#pragma unroll
  for (int px = 0; px < kTw; ++px) {
    const int x = x0 + px;
    if (x >= w) continue;
    float* o = out + (pix0 + static_cast<long long>(y) * w + x) * co + c;
    if (out_vec) {
      *reinterpret_cast<float4*>(o) = acc[px];
    } else {
      const float v[kVec] = {acc[px].x, acc[px].y, acc[px].z, acc[px].w};
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (c + k < co) o[k] = v[k];
      }
    }
  }
}

template <typename T>
int launch(const void* z, const float* atoms, float* out, int b, int h,
           int w, int m_atoms, int co, int rows, cudaStream_t stream) {
  if (rows < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes<T>(rows);
  cudaError_t err = cudaFuncSetAttribute(
      shift_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool z_vec = co % (16 / sizeof(T)) == 0 && aligned(z);
  const bool out_vec = co % kVec == 0 && aligned(out);
  const dim3 grid(((h + rows - 1) / rows) * ((w + kTw - 1) / kTw), b,
                  (co + kCo - 1) / kCo);
  shift_sum_kernel<T><<<grid, 32 * rows, smem, stream>>>(
      static_cast<const T*>(z), atoms, out, h, w, m_atoms, co, z_vec,
      out_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (B,H,W,M,CO) float32 (z_bf16 = 0) or bfloat16 (z_bf16 = 1), atoms
// (B,H,W,M,25) float32, out (B,H,W,CO) float32; contiguous. tile_rows
// (1-8) as the note above says; the wrapper checks shapes and types and
// picks it.
extern "C" int v2v_shift_sum(const void* z, const float* atoms, float* out,
                             int b, int h, int w, int m_atoms, int co,
                             int z_bf16, int tile_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_bf16) {
    return launch<__nv_bfloat16>(z, atoms, out, b, h, w, m_atoms, co,
                                 tile_rows, s);
  }
  return launch<float>(z, atoms, out, b, h, w, m_atoms, co, tile_rows, s);
}
