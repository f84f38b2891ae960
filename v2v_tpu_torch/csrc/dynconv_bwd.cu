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
// step.
//
// What bounds it: bytes. At the train shape it reads z 18.87 MB (bf16),
// atoms 7.37 MB and g 6.29 MB and writes dz 18.87 MB and datoms 7.37 MB:
// 58.8 MB, 0.0176 ms at 3.35 TB/s (H100 SXM data sheet), against 2 * 2 *
// 150 * B*H*W*CO = 0.94 GFLOP, 0.014 ms at 67 TFLOP/s float32. Tensor
// cores do not pay: both gradients are matrix-vector work per pixel
// (datoms 25 dot products of length CO per pixel and atom against the
// pixel's own g; dz a 25-tap box sum of a*g per atom), about 16 FLOP a
// byte, and neither has the shared operand a matrix product needs (as a
// product of the tile's g by its haloed z, datoms would use 25 of each
// 144 dot products, and g would need three TF32 passes to keep float32).
// What the kernels spend is the tiles' bytes from L2 into shared memory
// (the halo and the re-reads make them several times the bound's bytes),
// shared-memory wavefronts (an SM serves one 128-byte wavefront a clock
// and issues four warp instructions) and the latency of the tile loads.
//
// Two kernels (the wrapper, ops/dynconv.py, launches dz, then datoms),
// each with a block per (tile of R rows x 8 columns, batch item, group of
// atoms): R warps, a warp per tile row; R = 8 for dz, 4 for datoms. The earlier design, dz with a
// block per (8x8 tile, batch item) walking the atoms (192 blocks on 132
// SMs at the train shape) and datoms with a block per atom, ran at
// 0.1425 ms back to back on an H100 80GB HBM3 at 700 W, 8x its bound.
// What this design does about each of its faults (PERF.md, section 6,
// measured on that card):
//
// - The loads are bound by bytes from L2 into shared memory (about 3 TB/s
//   for these tiles), so a block keeps its g tile for a group of atoms:
//   a tile of g, haloed for dz, is read once a group, not once an atom.
//   The wrapper gives each kernel the most atoms a block that still gives
//   every SM a block: at the train shape all 6, 240 dz blocks of 8 rows
//   and 384 datoms blocks of 4 rows (3 an SM, one wave). More, smaller
//   blocks were slower, since a block an atom reads g 6 times: dz took
//   0.0463-0.0468 ms at 240 blocks, 0.0480 at 480 (3 atoms a block) and
//   0.0547-0.0551 at 1,440 (one), fewer than 2 blocks an SM winning
//   (k4_backward_designs, H100 80GB HBM3 at 700 W). The tile rows were
//   measured the same way with both built, then fixed: dz in 4-row tiles
//   (480 blocks) took 0.0652 ms, datoms in 8-row tiles (192 blocks)
//   0.0398, against 0.0300-0.0326 in 4-row ones.
// - No spills, and nothing held across atoms in registers: the next
//   atom's taps (dz) or z tile (datoms) land in shared memory.
// - z stays in its own type in shared memory (bfloat16 widened when
//   read), which leaves room for two z buffers in bfloat16.
// - Tiles arrive by TMA where the layout allows (one box a tile, zeros
//   outside the image; the wait on its mbarrier comes after every
//   ordinary load is issued), else by 4-byte cp.async; dz's taps by
//   cp.async into a staging buffer during the previous atom's sums. A
//   layout that allows TMA and whose map fails to encode is an error,
//   not a slower path.
// - g is read in place from the model's NCHW view: dz's haloed tile as a
//   TMA box of the (x, c, y, b) view, datoms' tile 16 bytes along x.
// - The attribute that lets a block use more than 48 KB of shared
//   memory is set once per device, on the first call there.
//
// dz, as a gather: each output reads its 25 mirrored source pixels and is
// written once; no block adds into another's outputs. Shared memory: the
// haloed (R+4) x 12 g tile of a 128-channel chunk, float32, as
// [row][channel][12] (a channel's row is three 16-byte units, so 8 lanes
// reading one unit of 8 channels hit 8 bank groups); atom m's taps of the
// haloed tile, each offset row's 5 padded to 8 (a float4 and a float, a
// broadcast); atom m+1's taps as they arrive. TMA wants a box's innermost
// start 16-byte aligned: dz's tiles start 2 columns left of a multiple
// of 8, so the haloed tile's first column is (at W = 32 a row of the
// image takes 5 tiles, not 4). Lane l owns channels l, l+32, l+64, l+96.
// A warp walks its 5 source rows once: it loads the row's 12 g values of
// its 4 channels (12 float4 loads) into registers, then for each of the
// 12 source columns the 5 taps of the row's offset, and adds each source
// to the up to 5 outputs that read it (8x4 sums in registers). Per warp
// and source row: 48 + 24 wavefronts for 160 warp-FMAs. dz is stored 2
// (bf16) or 4 bytes a lane, a warp's store 32 consecutive channels.
//
// datoms, as a per-pixel channel reduction, walking chunk by chunk of CO
// and, inside a chunk, atom by atom (CO = 97 and 256 need no atomics and
// no second pass). Shared memory: the haloed z tile of an atom in z's
// own type, one TMA box of the (c, m, x, y, b) view when CO * sizeof(z)
// is a multiple of 16 (else plain loads), two buffers in bfloat16; and
// the tile's g, loaded 16 bytes along x from the NCHW view into registers
// and stored transposed. A warp is 4 groups of 8 lanes; a group takes a
// pixel pair of its row (which share 4 of the 6 source columns of each
// source row) and a lane 16 channels of each; a lane sums its channels of
// each of the 25 offsets, then a fixed 3-stage transposing tree over the
// group (28 shuffles a pair, against 62 for a 32-lane tree) leaves
// offsets 4k..4k+3 in the group's lane k, which writes them (a later
// chunk adds to what the lane wrote, in chunk order). No atomics
// anywhere: the results are the same bits from run to run.
//
// Shared memory a block (bytes), as `_bwd_smem_bytes` in ops/dynconv.py
// computes it: dz (8+4)*12*(128 + 40 + 25)*4 + 144 = 111,312, two blocks
// an SM; datoms buffers*((4+4)*12*128*sizeof(z) + 16) + 4*8*128*4 + 128
// = 65,696 (bf16, two buffers, three blocks an SM) or 65,680 (float32,
// one). At most 128 registers a thread (__launch_bounds__(32 R, 16 / R));
// CUDA 12.8's ptxas gives dz 127 and datoms 126 (bf16) or 128 (float32),
// no spills, no stack frame.
#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from
                    // cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kK = 5;
constexpr int kL = kK * kK;
constexpr int kHalo = kK / 2;
constexpr int kDzRows = 8;             // rows of a dz tile
constexpr int kDaRows = 4;             // rows of a datoms tile
constexpr int kTw = 8;                 // columns of a tile
constexpr int kZw = kTw + kK - 1;      // columns of a haloed tile
constexpr int kCo = 128;               // channels of a chunk
constexpr int kAp = 8;                 // an offset row's 5 taps, padded
constexpr int kAlign = 128;            // a TMA destination's alignment
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int halo_pixels(int rows) {
  return (rows + kK - 1) * kZw;
}
// dynamic shared memory: the tiles, then an mbarrier, and the slack that
// aligns the tiles to kAlign. dz: the g tile, atom m's taps padded, and
// atom m+1's taps as they arrive
constexpr int dz_smem() {
  return (halo_pixels(kDzRows) * (kCo + kK * kAp + kL)) *
             static_cast<int>(sizeof(float)) + 16 + kAlign;
}
// z tile buffers of datoms: two in bfloat16 (the next atom's tile lands
// during the sums), one in float32 (two would leave one block an SM)
template <typename T>
__host__ __device__ constexpr int z_buffers() {
  return sizeof(T) == 2 ? 2 : 1;
}

template <typename T>
constexpr int datoms_smem() {
  return z_buffers<T>() *
             (halo_pixels(kDaRows) * kCo * static_cast<int>(sizeof(T)) +
              16) +
         kDaRows * kTw * kCo * static_cast<int>(sizeof(float)) + kAlign;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return p + ((kAlign - (smem_addr(p) & (kAlign - 1))) & (kAlign - 1));
}

// N bytes from global to shared memory, zeros when !valid
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Returns once the phase of parity `parity` has completed. A wait of more
// than 4 s (a load that never lands) traps: the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0) {
      start = now;
    } else if (now - start > 4000000000ull) {
      __trap();
    }
  }
}

// One thread: `bytes` expected on `bar`, then the box of `map` at the
// coordinates into dst (zeros where the box leaves the tensor)
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, uint32_t bytes,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, uint32_t bytes,
                                          int c0, int c1, int c2, int c3,
                                          int c4) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) {
  return __ushort_as_bfloat16(0);
}
__device__ __forceinline__ void narrow(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);  // round to nearest even, as torch does
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct GStrides {
  long long b, y, x, c;
};

struct Dims {
  int h, w, m_atoms, co;
};

template <typename T>
__global__ void __launch_bounds__(32 * kDzRows, 16 / kDzRows)
dz_kernel(const __grid_constant__ CUtensorMap g_map, bool g_tma,
          const float* __restrict__ atoms, const float* __restrict__ g,
          GStrides gs, T* __restrict__ dz, Dims d, int n_chunks,
          int per_block) {
  constexpr int R = kDzRows;
  constexpr int kNq = halo_pixels(R);
  extern __shared__ unsigned char smem_raw[];
  // [R+4][kCo][12] g: a row's 12 floats of a channel, 3 16-byte units,
  // so 8 lanes reading one unit of 8 channels hit 8 bank groups
  float* gt = reinterpret_cast<float*>(aligned_smem(smem_raw));
  float* at = gt + kNq * kCo;                // [kNq][kK][kAp], atom m
  float* raw = at + kNq * kK * kAp;          // [kNq][kL], atom m+1
  uint64_t* bar = reinterpret_cast<uint64_t*>(raw + kNq * kL);
  const int lane = threadIdx.x & 31;
  const int py = threadIdx.x >> 5;           // the warp's output row
  // tiles start 2 columns left of a multiple of 8, so that the haloed
  // tile's first column, x0 - 2, is 16-byte aligned as TMA requires
  const int tiles_w = (d.w + kHalo + kTw - 1) / kTw;
  const int y0 = (blockIdx.x / tiles_w) * R;
  const int x0 = (blockIdx.x % tiles_w) * kTw - kHalo;
  const int b = blockIdx.y;
  const int m0 = blockIdx.z / n_chunks * per_block;   // the block's atoms
  const int m1 = min(m0 + per_block, d.m_atoms);
  const int c0 = blockIdx.z % n_chunks * kCo;
  const long long pix0 = static_cast<long long>(b) * d.h * d.w;
  // atom m's taps of the haloed tile as they lie in memory; a warp reads
  // 32 consecutive taps
  const auto fetch_taps = [&](int m) {
    for (int i = threadIdx.x; i < kNq * kL; i += 32 * R) {
      const int q = i / kL;
      const int y = y0 - kHalo + q / kZw;
      const int x = x0 - kHalo + q % kZw;
      const bool ok = y >= 0 && y < d.h && x >= 0 && x < d.w;
      cp_async<4>(raw + i,
                  ok ? atoms + ((pix0 + static_cast<long long>(y) * d.w +
                                 x) * d.m_atoms + m) * kL + i % kL
                     : atoms,
                  ok);
    }
    cp_async_commit();
  };

  // the haloed g tile of the chunk: one TMA box where the view allows (x
  // contiguous, 16-byte strides), else 4-byte copies
  if (g_tma && threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();           // the barrier's init
  if (g_tma) {
    if (threadIdx.x == 0) {
      tma_load4(gt, &g_map, bar, kNq * kCo * sizeof(float), x0 - kHalo, c0,
                y0 - kHalo, b);
    }
  } else {
    const float* gb = g + b * gs.b;
    for (int i = threadIdx.x; i < kCo * kNq; i += 32 * R) {
      const int col = i % kZw;
      const int c = i / kZw % kCo;
      const int r = i / (kZw * kCo);
      const int y = y0 - kHalo + r;
      const int x = x0 - kHalo + col;
      const bool ok = y >= 0 && y < d.h && x >= 0 && x < d.w && c0 + c < d.co;
      cp_async<4>(gt + i,
                  ok ? gb + y * gs.y + x * gs.x + (c0 + c) * gs.c : g, ok);
    }
  }
  fetch_taps(m0);
  for (int m = m0; m < m1; ++m) {
    cp_async_wait();           // atom m's taps (and the copied g tile)
    __syncthreads();           // atom m-1's sums are done
    // each thread pads the taps it copied: each offset row's 5 to 8
    for (int i = threadIdx.x; i < kNq * kL; i += 32 * R) {
      const int l = i % kL;
      at[(i / kL * kK + l / kK) * kAp + l % kK] = raw[i];
    }
    __syncthreads();
    if (m + 1 < m1) fetch_taps(m + 1);       // lands during the sums
    if (g_tma && m == m0) mbar_wait(bar, 0);

    // lane l owns channels l, l+32, l+64, l+96 of the chunk
    float acc[4][kTw];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int px = 0; px < kTw; ++px) acc[k][px] = 0.f;
    }
    // Output (py, px) reads offset l = 5i + j at the haloed tile's
    // (py + 4 - i, px + 4 - j). Walk the source rows py + s (i = 4 - s)
    // and columns sx: the source feeds column px = sx + j - 4. (Unrolling
    // s too lets the compiler hoist loads until the registers spill.)
#pragma unroll 1
    for (int s = 0; s < kK; ++s) {
      const int i = kK - 1 - s;
      const int row = py + s;
      float gv[4][kZw];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int t = 0; t < kZw; t += 4) {
          const float4 v =
              lds4(gt + (row * kCo + lane + 32 * k) * kZw + t);
          gv[k][t] = v.x;
          gv[k][t + 1] = v.y;
          gv[k][t + 2] = v.z;
          gv[k][t + 3] = v.w;
        }
      }
#pragma unroll
      for (int sx = 0; sx < kZw; ++sx) {
        const float* aq = at + ((row * kZw + sx) * kK + i) * kAp;
        const float4 a4 = lds4(aq);          // taps j = 0..3, a broadcast
        const float a[kK] = {a4.x, a4.y, a4.z, a4.w, aq[4]};
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          const int px = sx + j - (kK - 1);
          if (px < 0 || px >= kTw) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k][px] = fmaf(a[j], gv[k][sx], acc[k][px]);
          }
        }
      }
    }

    const int y = y0 + py;
    if (y >= d.h) continue;
#pragma unroll
    for (int px = 0; px < kTw; ++px) {
      const int x = x0 + px;
      if (x < 0 || x >= d.w) continue;
      T* o = dz + ((pix0 + static_cast<long long>(y) * d.w + x) *
                   d.m_atoms + m) * d.co + c0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = lane + 32 * k;
        if (c0 + c < d.co) narrow(acc[k][px], o + c);
      }
    }
  }
}

// datoms' channels. Lane k (0..7) of an 8-lane group owns 16 channels of
// the chunk: four 16-byte units of a float32 z pixel, k, k+8, k+16, k+24
// (channels 4k.., 32+4k.., 64+4k.., 96+4k..), or two of a bfloat16 one,
// k and k+8 (channels 8k.., 64+8k..); 8 lanes reading one unit each of one
// pixel hit 8 bank groups. The tile's g is stored with its float4 unit u
// (channels 4u..4u+3) at slot g_slot(u), so that lane k's four g units are
// slots k, k+8, k+16, k+24 in either type.
template <typename T>
__host__ __device__ constexpr int g_slot(int u) {
  if constexpr (sizeof(T) == 4) {
    return u;
  } else {
    return u % 16 / 2 + 8 * (u % 2) + 16 * (u / 16);
  }
}

// a lane's 16 channels of z pixel zq, widened to float32, in the order of
// its g slots k, k+8, k+16, k+24
__device__ __forceinline__ void lds_z16(const float* zq, int k,
                                        float (&f)[16]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float4 r = lds4(zq + 4 * (k + 8 * v));
    f[4 * v] = r.x;
    f[4 * v + 1] = r.y;
    f[4 * v + 2] = r.z;
    f[4 * v + 3] = r.w;
  }
}
__device__ __forceinline__ void lds_z16(const __nv_bfloat16* zq, int k,
                                        float (&f)[16]) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint4 r = *reinterpret_cast<const uint4*>(zq + 8 * (k + 8 * v));
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // little-endian: the low half first
      f[8 * v + 2 * e] = __uint_as_float(u[e] << 16);
      f[8 * v + 2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
}

// One stage of the transposing reduction over an 8-lane group: lanes that
// differ in bit kLane swap halves of v[0..2 kHalf) and add, so v[s]
// (s < kHalf) then holds the sum over both lanes of the value that was
// v[s + kHalf * (lane has bit kLane)].
template <int kLane, int kHalf>
__device__ __forceinline__ void reduce_stage(float (&v)[32], int lane) {
  const bool upper = (lane & kLane) != 0;
#pragma unroll
  for (int s = 0; s < kHalf; ++s) {
    const float send = upper ? v[s] : v[s + kHalf];
    const float keep = upper ? v[s + kHalf] : v[s];
    v[s] = keep + __shfl_xor_sync(kFull, send, kLane);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kDaRows, 16 / kDaRows)
datoms_kernel(const __grid_constant__ CUtensorMap z_map, bool z_tma,
              const T* __restrict__ z, const float* __restrict__ g,
              GStrides gs, float* __restrict__ datoms, Dims d,
              bool g_vec_x, int per_block) {
  constexpr int R = kDaRows;
  constexpr int kNq = halo_pixels(R);
  constexpr int kNp = R * kTw;               // pixels of the tile
  constexpr int kBufs = z_buffers<T>();
  extern __shared__ unsigned char smem_raw[];
  // [kBufs][kNq][kCo] z tiles, [kNp][kCo] g, kBufs barriers
  T* zbuf = reinterpret_cast<T*>(aligned_smem(smem_raw));
  float* gt = reinterpret_cast<float*>(zbuf + kBufs * kNq * kCo);
  uint64_t* bar = reinterpret_cast<uint64_t*>(gt + kNp * kCo);
  const int lane = threadIdx.x & 31;
  const int k = lane & 7;                    // the lane in its group
  const int px0 = (lane >> 3) * 2;           // the group's pixel pair
  const int py = threadIdx.x >> 5;           // the warp's tile row
  const int tiles_w = (d.w + kTw - 1) / kTw;
  const int y0 = (blockIdx.x / tiles_w) * R;
  const int x0 = (blockIdx.x % tiles_w) * kTw;
  const int b = blockIdx.y;
  const int m0 = blockIdx.z * per_block;     // the block's atoms
  const int na = min(per_block, d.m_atoms - m0);
  const long long pix0 = static_cast<long long>(b) * d.h * d.w;
  const float* gb = g + b * gs.b;
  const int y = y0 + py;
  // step n: the chunk c0 = n / na * 128 of atom m0 + n % na
  const int steps = (d.co + kCo - 1) / kCo * na;
  const auto issue = [&](int n) {            // one thread: step n's z box
    const int buf = n % kBufs;
    tma_load5(zbuf + buf * kNq * kCo, &z_map, bar + buf,
              kNq * kCo * sizeof(T), n / na * kCo, m0 + n % na, x0 - kHalo,
              y0 - kHalo, b);
  };

  if (z_tma && threadIdx.x == 0) {
    for (int i = 0; i < kBufs; ++i) mbar_init(bar + i, 1);
  }
  __syncthreads();    // the barriers' init
  if (z_tma && threadIdx.x == 0) {
    for (int n = 0; n < kBufs - 1 && n < steps; ++n) issue(n);
  }
  for (int n = 0; n < steps; ++n) {
    const int c0 = n / na * kCo;
    const int m = m0 + n % na;
    T* zt = zbuf + n % kBufs * kNq * kCo;
    if (n > 0) __syncthreads();  // step n-1's tiles are consumed
    if (z_tma) {      // one box: CO * sizeof(z) a multiple of 16
      if (threadIdx.x == 0 && n + kBufs - 1 < steps) issue(n + kBufs - 1);
    } else {
      for (int i = threadIdx.x; i < kNq * kCo; i += 32 * R) {
        const int q = i / kCo;
        const int ch = i % kCo;
        const int yz = y0 - kHalo + q / kZw;
        const int xz = x0 - kHalo + q % kZw;
        T v = zero_of(T());
        if (yz >= 0 && yz < d.h && xz >= 0 && xz < d.w && c0 + ch < d.co) {
          v = z[((pix0 + static_cast<long long>(yz) * d.w + xz) *
                     d.m_atoms + m) * d.co + c0 + ch];
        }
        zt[i] = v;
      }
    }
    if (n % na == 0) {  // a new chunk: its g tile, shared by the atoms
      if (g_vec_x) {     // the NCHW view: x contiguous, rows 16-byte aligned
        // a warp: 8 channels x 4 of the tile's half rows, so its loads
        // fall in 32-byte runs
        for (int i = threadIdx.x; i < kNp * kCo / 4; i += 32 * R) {
          const int half_row = i / 8 % (kNp / 4);
          const int xq = half_row % 2 * 4;
          const int yq = half_row / 2;
          const int ch = i / (8 * kNp / 4) * 8 + i % 8;
          const int yg = y0 + yq;
          const int c = c0 + ch;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (yg < d.h && x0 + xq < d.w && c < d.co) {
            v = *reinterpret_cast<const float4*>(gb + yg * gs.y + x0 + xq +
                                                 c * gs.c);
          }
          float* dst = gt + (yq * kTw + xq) * kCo + 4 * g_slot<T>(ch / 4) +
                       ch % 4;
          dst[0] = v.x;
          dst[kCo] = v.y;
          dst[2 * kCo] = v.z;
          dst[3 * kCo] = v.w;
        }
      } else {
        // contiguous channels (NHWC): a warp reads 32 channels of a pixel;
        // otherwise 4 channels of 8 pixels
        for (int i = threadIdx.x; i < kNp * kCo; i += 32 * R) {
          int q, ch;
          if (gs.c == 1) {
            q = i / kCo;
            ch = i % kCo;
          } else {
            q = i / 4 % kNp;
            ch = i / (4 * kNp) * 4 + i % 4;
          }
          const int yg = y0 + q / kTw;
          const int xg = x0 + q % kTw;
          const int c = c0 + ch;
          float v = 0.f;
          if (yg < d.h && xg < d.w && c < d.co) {
            v = gb[yg * gs.y + xg * gs.x + c * gs.c];
          }
          gt[q * kCo + 4 * g_slot<T>(ch / 4) + ch % 4] = v;
        }
      }
    }
    __syncthreads();
    if (z_tma) mbar_wait(bar + n % kBufs, n / kBufs & 1);

    // pixel px0 + e reads offset (i, j) at the haloed tile's
    // (py + i, px0 + e + j): source column px0 + cx serves j = cx - e. A
    // lane sums its 16 channels of each offset; slots 25-31 stay zero.
    float v[2][32];
    float gv[2][16];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* gq = gt + (py * kTw + px0 + e) * kCo;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 r = lds4(gq + 4 * (k + 8 * u));
        gv[e][4 * u] = r.x;
        gv[e][4 * u + 1] = r.y;
        gv[e][4 * u + 2] = r.z;
        gv[e][4 * u + 3] = r.w;
      }
#pragma unroll
      for (int l = kL; l < 32; ++l) v[e][l] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kK; ++i) {
#pragma unroll
      for (int cx = 0; cx < kK + 1; ++cx) {
        float f[16];
        lds_z16(zt + ((py + i) * kZw + px0 + cx) * kCo, k, f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = cx - e;
          if (j < 0 || j >= kK) continue;
          float sum = f[0] * gv[e][0];
#pragma unroll
          for (int c = 1; c < 16; ++c) sum = fmaf(f[c], gv[e][c], sum);
          v[e][i * kK + j] = sum;
        }
      }
    }
    // over the group's 8 lanes: lane k ends with offsets 4k..4k+3
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      reduce_stage<4, 16>(v[e], lane);
      reduce_stage<2, 8>(v[e], lane);
      reduce_stage<1, 4>(v[e], lane);
      const int x = x0 + px0 + e;
      if (y < d.h && x < d.w) {
        float* out = datoms + ((pix0 + static_cast<long long>(y) * d.w + x) *
                               d.m_atoms + m) * kL;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // chunks in order; a later chunk adds to what this lane wrote
          const int l = 4 * k + s;
          if (l < kL) out[l] = c0 > 0 ? out[l] + v[e][s] : v[e][s];
        }
      }
    }
  }
}

template <typename Kernel>
void allow_smem(Kernel* kernel, int bytes, cudaError_t& err) {
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
}

// Each instance's shared-memory opt-in, once per device (at most 64; a
// higher ordinal sets them on every call).
int configure() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  allow_smem(dz_kernel<float>, dz_smem(), err);
  allow_smem(dz_kernel<__nv_bfloat16>, dz_smem(), err);
  allow_smem(datoms_kernel<float>, datoms_smem<float>(), err);
  allow_smem(datoms_kernel<__nv_bfloat16>, datoms_smem<__nv_bfloat16>(),
             err);
  if (err != cudaSuccess) return static_cast<int>(err);
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Errors besides cudaError_t values: the driver has no
// cuTensorMapEncodeTiled, encoding a map failed.
enum { kErrNoEncoder = -1, kErrEncode = -2 };

// A map of `rank` dimensions, innermost first: extents dims, byte strides
// of the outer dimensions, box; no swizzle, zeros outside the tensor.
// Returns 0 or one of the errors above.
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
               const void* base, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : kErrEncode;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch_dz(const float* atoms, const float* g, GStrides gs, void* dz,
              int b, Dims d, int per_block, cudaStream_t stream) {
  constexpr int R = kDzRows;
  const int n_chunks = (d.co + kCo - 1) / kCo;
  // g as (x, c, y, b), a box of the haloed tile's 12 columns, 128
  // channels and R+4 rows: x contiguous, the other strides 16-byte
  // multiples
  CUtensorMap map{};
  const bool tma = gs.x == 1 && gs.y % 4 == 0 && gs.c % 4 == 0 &&
                   gs.b % 4 == 0 && aligned(g, 16);
  if (tma) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d.w),
                                static_cast<cuuint64_t>(d.co),
                                static_cast<cuuint64_t>(d.h),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(gs.c) * 4,
                                   static_cast<cuuint64_t>(gs.y) * 4,
                                   static_cast<cuuint64_t>(gs.b) * 4};
    const cuuint32_t box[4] = {kZw, kCo, R + kK - 1, 1};
    const int err = tensor_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g,
                               dims, strides, box);
    if (err != 0) return err;
  }
  const dim3 grid(((d.h + R - 1) / R) * ((d.w + kHalo + kTw - 1) / kTw), b,
                  (d.m_atoms + per_block - 1) / per_block * n_chunks);
  dz_kernel<T><<<grid, 32 * R, dz_smem(), stream>>>(
      map, tma, atoms, g, gs, static_cast<T*>(dz), d, n_chunks, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_datoms(const void* z, const float* g, GStrides gs, float* datoms,
                  int b, Dims d, int per_block, cudaStream_t stream) {
  constexpr int R = kDaRows;
  // z as (c, m, x, y, b), a box of 128 channels of one atom over the
  // haloed tile: CO * sizeof(z) a multiple of 16
  CUtensorMap map{};
  const bool tma = d.co * sizeof(T) % 16 == 0 && aligned(z, 16);
  if (tma) {
    const cuuint64_t c = static_cast<cuuint64_t>(d.co);
    const cuuint64_t dims[5] = {c, static_cast<cuuint64_t>(d.m_atoms),
                                static_cast<cuuint64_t>(d.w),
                                static_cast<cuuint64_t>(d.h),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[4] = {c * sizeof(T), c * sizeof(T) * dims[1],
                                   c * sizeof(T) * dims[1] * dims[2],
                                   c * sizeof(T) * dims[1] * dims[2] *
                                       dims[3]};
    const cuuint32_t box[5] = {kCo, 1, kZw, R + kK - 1, 1};
    const int err = tensor_map(&map,
                               sizeof(T) == 4
                                   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                               5, z, dims, strides, box);
    if (err != 0) return err;
  }
  const bool g_vec_x = gs.x == 1 && d.w % 4 == 0 && gs.y % 4 == 0 &&
                       gs.c % 4 == 0 && gs.b % 4 == 0 && aligned(g, 16);
  const dim3 grid(((d.h + R - 1) / R) * ((d.w + kTw - 1) / kTw), b,
                  (d.m_atoms + per_block - 1) / per_block);
  datoms_kernel<T><<<grid, 32 * R, datoms_smem<T>(), stream>>>(
      map, tma, static_cast<const T*>(z), g, gs, datoms, d, g_vec_x,
      per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* z, const float* atoms, const float* g, GStrides gs,
           void* dz, float* datoms, int b, Dims d, int dz_atoms,
           int da_atoms, cudaStream_t stream) {
  const int err = launch_dz<T>(atoms, g, gs, dz, b, d, dz_atoms, stream);
  if (err != 0) return err;
  return launch_datoms<T>(z, g, gs, datoms, b, d, da_atoms, stream);
}

template <typename T>
int occupancy(int* dz_blocks, int* da_blocks) {
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      dz_blocks, dz_kernel<T>, 32 * kDzRows, dz_smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      da_blocks, datoms_kernel<T>, 32 * kDaRows, datoms_smem<T>()));
}

}  // namespace

// z (B,H,W,M,CO) float32 (z_bf16 = 0) or bfloat16 (z_bf16 = 1) and atoms
// (B,H,W,M,25) float32, contiguous; g (B,H,W,CO) float32 with element
// strides g_sb, g_sy, g_sx, g_sc; dz (B,H,W,M,CO) in z's type and datoms
// (B,H,W,M,25) float32, contiguous. Each kernel's atoms a block (at least
// 1). The wrapper checks shapes and types. Returns 0, a cudaError_t or
// one of the errors above.
extern "C" int v2v_shift_sum_bwd(const void* z, const float* atoms,
                                 const float* g, long long g_sb,
                                 long long g_sy, long long g_sx,
                                 long long g_sc, void* dz, float* datoms,
                                 int b, int h, int w, int m_atoms, int co,
                                 int z_bf16, int dz_atoms, int da_atoms,
                                 void* stream) {
  if (dz_atoms < 1 || da_atoms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = configure();
  if (err != 0) return err;
  const GStrides gs{g_sb, g_sy, g_sx, g_sc};
  const Dims d{h, w, m_atoms, co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_bf16) {
    return launch<__nv_bfloat16>(z, atoms, g, gs, dz, datoms, b, d, dz_atoms,
                                 da_atoms, s);
  }
  return launch<float>(z, atoms, g, gs, dz, datoms, b, d, dz_atoms, da_atoms,
                       s);
}

// Blocks an SM of the dz and datoms kernels, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device.
extern "C" int v2v_shift_sum_bwd_occupancy(int z_bf16, int* dz_blocks,
                                           int* da_blocks) {
  const int err = configure();
  if (err != 0) return err;
  return z_bf16 ? occupancy<__nv_bfloat16>(dz_blocks, da_blocks)
                : occupancy<float>(dz_blocks, da_blocks);
}
