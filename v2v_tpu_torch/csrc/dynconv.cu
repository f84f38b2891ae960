// K4: HyperE2VID's dynamic shift-sum, k = 5,
//
//   out[b,y,x,o] = sum_{l<25, m<M} atoms[b,y,x,m,l] * z[b, y+i-2, x+j-2, m, o]
//
// with l = i*5 + j (torch-unfold row-major) and z read as zero outside
// the image. z (B,H,W,M,CO) float32 or bfloat16, atoms (B,H,W,M,25)
// float32, out (B,H,W,CO) float32, all contiguous.
//
// Replaces v2v_tpu/ops/dynconv.py::dynamic_shift_sum (Pallas body
// `_fwd_kernel`), the decoder-0 dynamic conv of HyperE2VID. On the
// path: eval at 720p, z (1,180,320,6,128) f32 once a frame; the train
// step, z (12,32,32,6,128) bf16, 40 times a step.
//
// What bounds it: bytes. Each input read once and the output written
// once is 241 MB at the eval shape (0.072 ms at 3.35 TB/s) against
// 2 * 150 * B*H*W*CO = 2.2 GFLOP (0.033 ms at 67 TFLOP/s float32).
// The plain loop reads z k*k = 25 times.
//
// Design, kept from the TPU kernel: locality. Each block reads its z
// tile once per atom, with a halo of 2, and its atoms once, and does all
// 150 multiply-adds of an output from shared memory. Not kept: the TPU's
// one program per batch item (1 to 12 blocks here), its whole-image VMEM
// blocks (a 720p z is 177 MB) and the padded, transposed copy of z that
// JAX makes outside the kernel (here bounds checks read the border as
// zero).
//
// One block per (8x8 output tile, batch item, 128 output channels), 256
// threads: threadIdx.x is the channel, so each warp reads 32 neighbouring
// channels of z's innermost axis (coalesced), and threadIdx.y picks four
// of the tile's eight rows. Shared memory, dynamic: the tile's atoms
// (8*8*M*25 float32, 38,400 B at M = 6), then, for each atom m in turn,
// its haloed z tile widened to float32 (12*12*128 float32, 73,728 B):
// 112,128 B at M = 6, opted into above 48 KB with cudaFuncSetAttribute;
// two blocks fit on an SM. Each thread keeps its 4x8 outputs in float32
// registers: 128 registers a thread, no spills (-Xptxas -v, which
// chip_smoke.py prints). The atom a thread reads is the same for its
// whole warp (a broadcast); its z reads are 32 consecutive floats (no
// bank conflict).
//
// Rounding: float32 fused multiply-adds, summed over m, then over the 25
// offsets, where the plain version sums over m for each offset; the
// results agree to float32 rounding of 150 terms (chip_smoke.py states
// the tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 5;
constexpr int kL = kK * kK;
constexpr int kHalo = kK / 2;
constexpr int kTh = 8;                 // output rows of a tile
constexpr int kTw = 8;                 // output columns of a tile
constexpr int kCo = 128;               // channels of a block, one a thread
constexpr int kRg = 2;                 // row groups (threadIdx.y)
constexpr int kRows = kTh / kRg;       // output rows of a thread
constexpr int kZh = kTh + kK - 1;      // haloed z tile
constexpr int kZw = kTw + kK - 1;
constexpr int kThreads = kCo * kRg;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shift_sum_kernel(const T* __restrict__ z, const float* __restrict__ atoms,
                 float* __restrict__ out, int h, int w, int m_atoms,
                 int co) {
  extern __shared__ float smem[];
  const int ml = m_atoms * kL;
  float* as = smem;                      // [kTh*kTw][M][kL]
  float* zs = smem + kTh * kTw * ml;     // [kZh][kZw][kCo]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kCo + tx;
  const int tiles_w = (w + kTw - 1) / kTw;
  const int y0 = (blockIdx.x / tiles_w) * kTh;
  const int x0 = (blockIdx.x % tiles_w) * kTw;
  const long long pix0 = static_cast<long long>(blockIdx.y) * h * w;
  const int c0 = blockIdx.z * kCo;

  // the tile's atoms, once: each pixel's M*25 values are contiguous
  for (int i = tid; i < kTh * kTw * ml; i += kThreads) {
    const int p = i / ml;
    const int y = y0 + p / kTw;
    const int x = x0 + p % kTw;
    as[i] = (y < h && x < w)
                ? atoms[(pix0 + static_cast<long long>(y) * w + x) * ml +
                        i % ml]
                : 0.f;
  }

  float acc[kRows][kTw];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int px = 0; px < kTw; ++px) acc[r][px] = 0.f;

  for (int m = 0; m < m_atoms; ++m) {
    __syncthreads();  // the previous z tile is consumed
    for (int i = tid; i < kZh * kZw * kCo; i += kThreads) {
      const int q = i / kCo;
      const int ch = c0 + i % kCo;
      const int y = y0 - kHalo + q / kZw;
      const int x = x0 - kHalo + q % kZw;
      float v = 0.f;
      if (y >= 0 && y < h && x >= 0 && x < w && ch < co) {
        v = widen(z[((pix0 + static_cast<long long>(y) * w + x) * m_atoms +
                     m) * co + ch]);
      }
      zs[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int py = ty * kRows + r;
#pragma unroll
      for (int px = 0; px < kTw; ++px) {
        const float* a = as + ((py * kTw + px) * m_atoms + m) * kL;
        float s = acc[r][px];
#pragma unroll
        for (int i = 0; i < kK; ++i) {
#pragma unroll
          for (int j = 0; j < kK; ++j) {
            s = fmaf(a[i * kK + j], zs[((py + i) * kZw + px + j) * kCo + tx],
                     s);
          }
        }
        acc[r][px] = s;
      }
    }
  }

  const int c = c0 + tx;
  if (c >= co) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + ty * kRows + r;
#pragma unroll
    for (int px = 0; px < kTw; ++px) {
      const int x = x0 + px;
      if (y < h && x < w) {
        out[(pix0 + static_cast<long long>(y) * w + x) * co + c] =
            acc[r][px];
      }
    }
  }
}

template <typename T>
int launch(const void* z, const float* atoms, float* out, int b, int h,
           int w, int m_atoms, int co, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kTh * kTw * m_atoms * kL + kZh * kZw * kCo);
  cudaError_t err = cudaFuncSetAttribute(
      shift_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((h + kTh - 1) / kTh) * ((w + kTw - 1) / kTw), b,
                  (co + kCo - 1) / kCo);
  shift_sum_kernel<T><<<grid, dim3(kCo, kRg), smem, stream>>>(
      static_cast<const T*>(z), atoms, out, h, w, m_atoms, co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (B,H,W,M,CO) float32 (z_bf16 = 0) or bfloat16 (z_bf16 = 1), atoms
// (B,H,W,M,25) float32, out (B,H,W,CO) float32; contiguous (the wrapper
// checks shapes, types and the shared-memory size).
extern "C" int v2v_shift_sum(const void* z, const float* atoms, float* out,
                             int b, int h, int w, int m_atoms, int co,
                             int z_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_bf16) {
    return launch<__nv_bfloat16>(z, atoms, out, b, h, w, m_atoms, co, s);
  }
  return launch<float>(z, atoms, out, b, h, w, m_atoms, co, s);
}
