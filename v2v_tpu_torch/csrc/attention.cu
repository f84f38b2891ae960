// K3: softmax(Q K^T / sqrt(dh)) V over every key, float32, dh = 32, on
// the Hopper tensor cores (wgmma) fed by TMA.
//
// Replaces v2v_tpu/models/eitr.py::_flash_attention_padded (:42), the TPU
// flash attention that ETNet's MultiheadAttention runs in eval above
// chunk_threshold = 4096 tokens (720p: B=1, 8 heads, N = 14,400, 21 calls
// a frame, self and cross attention alike).
//
// What bounds it at (1, 8, 14400, 32), on an H100 SXM at 700 W:
//   - the products Q K^T and P V: 4*B*h*Nq*Nk*dh = 2.123e11 FLOP. Three
//     TF32 passes (below) are 6.37e11 FLOP: 1.29 ms at the dense TF32
//     rate of 495 TFLOP/s. One pass would be 0.43 ms; the same FLOP on
//     the float32 CUDA cores (67 TFLOP/s) 3.17 ms.
//   - B*h*Nq*Nk = 1.66e9 exponentials on the special-function units, 16
//     a clock per SM: ~0.40 ms at 1.98 GHz.
//   - about 0.3 ms of float32 ALU work: scale, max, sum, rescale, the
//     split of P.
//   - bytes: Q, K, V read and O written once, 59 MB, 0.018 ms at
//     3.35 TB/s (the scratch below adds ~0.02 ms).
// So it is bound by the tensor cores' three passes, with the
// exponentials a third of that beside them.
//
// Why three passes: one TF32 pass keeps 10 mantissa bits of each operand
// and misses float32 by ~4e-5 at 14,400 keys (unit-normal q, k, v,
// emulated in tests/test_torch_k3_precision.py), against the port's 1e-5
// tolerance. Each operand x is split into hi = rna_tf32(x) and lo = x - hi
// (which the tensor cores truncate to TF32), and x*y is taken as
// lo*hi + hi*lo + hi*hi, summed in float32: the dropped lo*lo and lo's
// truncation are ~2^-21 of each product, and the emulation stays within
// 5e-8 of float64, as plain float32 does.
//
// Design (one call = two kernels on the caller's stream):
//   1. split_kernel writes four scratch tensors: K_hi, K_lo (BH, Nk_pad,
//      32) and Vt_hi, Vt_lo (BH, 32, Nk_pad), Nk_pad = Nk rounded up to
//      the key tile, the padding zero. V is transposed because wgmma
//      takes .tf32 operands K-major only, and in P V the reduction runs
//      over keys; TMA cannot transpose 4-byte elements. Within each
//      group of 8 keys Vt's columns are permuted (perm8) so that the
//      float32 accumulator fragment of S (columns 2t, 2t+1 in thread t of
//      a quad) can be fed as the TF32 register fragment A of P V (columns
//      t, t+4) with no data movement: P V sums over keys, so a
//      permutation applied to both P's columns and V's rows changes
//      nothing. The padding keeps every TMA stride a multiple of 16 B.
//   2. attention_kernel: one block per (batch*head, 128 queries), three
//      warpgroups. In warpgroup 2 one thread keeps a ring of kStages
//      stages of TMA loads (128-byte swizzle; a row of K is 128 B, Vt's
//      64-key rows go in two 32-key boxes) in flight, completion on
//      mbarriers. Warpgroups 0 and 1 are the consumers; each owns 64
//      query rows; their Q_hi and Q_lo sit in registers for the whole
//      call. For each tile of 64 keys a consumer warpgroup
//        - runs S = Q K^T as three chains of wgmma.m64n64k8.f32.tf32
//          (lo*hi, hi*lo, hi*hi, four k-steps each) into one float32
//          accumulator;
//        - masks keys >= Nk to -inf (last tile only), updates the running
//          row max and sum, and takes
//          P = exp2(S * log2(e)/sqrt(dh) - m * log2(e)/sqrt(dh)): the
//          1/sqrt(dh) scale is folded into the exponent, where the JAX and
//          plain versions divide the logits first (float32 rounding);
//        - splits P into hi and lo in registers and runs the tile's P V as
//          three chains of wgmma.m64n32k8 with A from registers and Vt
//          from shared memory, into an accumulator of its own;
//        - releases the stage to the producer and folds the tile into O
//          as O = alpha O + P V in round-to-nearest float32. The tensor
//          cores' own adds round toward zero: one accumulator over all
//          1,800 k-steps of 14,400 keys drifts O by ~1e-5
//          (tests/test_torch_k3_precision.py).
//      The last divide by the row sum and the store skip rows >= Nq.
//      The two consumer warpgroups run unsynchronized, so one's softmax
//      overlaps the other's tensor-core work. setmaxnreg moves registers
//      from the producer (24) to the consumers (240): at the 168 a
//      384-thread block starts with, the consumers spill.
// Nq and Nk may differ (cross attention) and both may be ragged; Nk may be
// smaller than one key tile. Real queries see exactly the real keys.
#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from
                    // cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kDh = 32;
constexpr int kBq = 128;                    // queries a block
constexpr int kBk = 64;                     // keys a tile
constexpr int kStages = 3;
constexpr int kThreads = 384;               // 2 consumer + 1 producer WG
constexpr int kTileBytes = kBk * kDh * 4;   // one operand tile, 8 KB
constexpr int kStageBytes = 4 * kTileBytes; // K_hi, K_lo, Vt_hi, Vt_lo
constexpr int kBoxBytes = kTileBytes / 2;   // a 32-key box of Vt
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 64;
constexpr int kSplitThreads = 256;

// Vt column c of each group of 8 keys holds key perm8(c): the key that
// the S accumulator puts where the A fragment of P V expects column c.
__host__ __device__ constexpr int perm8(int c) {
  return ((c & 3) << 1) | (c >> 2);
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (exp2f adds a range check and two multiplies around the same MUFU.EX2)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the split pre-pass -------------------------------------------------

// grid (Nk_pad / kBk, BH): one tile of 64 keys of one head a block.
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ k_hi, float* __restrict__ k_lo,
             float* __restrict__ vt_hi, float* __restrict__ vt_lo, int nk,
             int nk_pad) {
  __shared__ float vs[kBk][kDh + 1];
  const long long bh = blockIdx.y;
  const int k0 = blockIdx.x * kBk;
  for (int i = threadIdx.x; i < kBk * kDh; i += kSplitThreads) {
    const int r = i / kDh, c = i % kDh;
    const int key = k0 + r;
    float kx = 0.f, vx = 0.f;
    if (key < nk) {
      const long long at = (bh * nk + key) * kDh + c;
      kx = k[at];
      vx = v[at];
    }
    const float hi = tf32_rna(kx);
    const long long to = (bh * nk_pad + key) * kDh + c;
    k_hi[to] = hi;
    k_lo[to] = kx - hi;
    vs[r][c] = vx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBk * kDh; i += kSplitThreads) {
    const int d = i / kBk, j = i % kBk;
    const float x = vs[(j & ~7) | perm8(j & 7)][d];
    const float hi = tf32_rna(x);
    const long long to = (bh * kDh + d) * nk_pad + k0 + j;
    vt_hi[to] = hi;
    vt_lo[to] = x - hi;
  }
}

// ---- barriers, TMA, wgmma ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
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
        : "r"(smem_u32(bar)), "r"(parity)
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

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Shared-memory descriptor of a K-major operand laid out by TMA with the
// 128-byte swizzle: rows of 128 B, 8-row groups 1024 B apart (SBO), the
// leading offset unused (1). A k-step of 8 TF32 values starts 32 B on.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator across the wait
// (the asynchronous wgmma writes it until then).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, float32) += a (64 x 8 TF32, registers) * b (8 x 64, smem);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x 32, float32) += a (64 x 8 TF32, registers) * b (8 x 32, smem);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ---- the attention kernel ----------------------------------------------

// Fragments (per warp of a warpgroup, 16 of its 64 rows; lane = 4g + t):
// the float32 accumulator of an m64nN wgmma holds, for each 8 columns j,
// d[4j..4j+3] = (row g, col 8j+2t), (g, 8j+2t+1), (g+8, 8j+2t),
// (g+8, 8j+2t+1); the TF32 register A of a k8 step holds a[0..3] =
// (g, t), (g+8, t), (g, t+4), (g+8, t+4).
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap map_khi,
                 const __grid_constant__ CUtensorMap map_klo,
                 const __grid_constant__ CUtensorMap map_vthi,
                 const __grid_constant__ CUtensorMap map_vtlo,
                 const float* __restrict__ q, float* __restrict__ o, int nq,
                 int nk, int nk_pad, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int bh = blockIdx.y;
  const int ntiles = (nk + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        uint8_t* st = tiles + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        const int krow = bh * nk_pad + it * kBk;
        const int kcol = it * kBk;
        tma_load(st, &map_khi, &full[s], 0, krow);
        tma_load(st + kTileBytes, &map_klo, &full[s], 0, krow);
        tma_load(st + 2 * kTileBytes, &map_vthi, &full[s], kcol, bh * kDh);
        tma_load(st + 2 * kTileBytes + kBoxBytes, &map_vthi, &full[s],
                 kcol + kBk / 2, bh * kDh);
        tma_load(st + 3 * kTileBytes, &map_vtlo, &full[s], kcol, bh * kDh);
        tma_load(st + 3 * kTileBytes + kBoxBytes, &map_vtlo, &full[s],
                 kcol + kBk / 2, bh * kDh);
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int row = blockIdx.x * kBq + (threadIdx.x / 32) * 16 + g;

    // Q as TF32 hi and lo A fragments, one per k-step of 8 of dh
    uint32_t qh[4][4], ql[4][4];
    const float* qb = q + static_cast<long long>(bh) * nq * kDh;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e & 1) * 8;
        const int c = 8 * kk + t + (e >> 1) * 4;
        const float x = r < nq ? qb[static_cast<long long>(r) * kDh + c] : 0.f;
        const float hi = tf32_rna(x);
        qh[kk][e] = __float_as_uint(hi);
        ql[kk][e] = __float_as_uint(x - hi);
      }
    }

    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    // running max (unscaled logits) and this thread's share of the sum,
    // for rows g and g+8
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* st = tiles + s * kStageBytes;

      // S = Q K^T in three TF32 passes, small terms first
      float sc[32];
      const uint64_t dkhi = sw128_desc(st);
      const uint64_t dklo = sw128_desc(st + kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_n64(sc, ql[kk], dkhi + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_n64(sc, qh[kk], dklo + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_n64(sc, qh[kk], dkhi + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      if ((it + 1) * kBk > nk) {          // the ragged last tile
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (it * kBk + 8 * j + 2 * t + e >= nk) {
              sc[4 * j + e] = -CUDART_INF_F;
              sc[4 * j + 2 + e] = -CUDART_INF_F;
            }
          }
        }
      }

      // online softmax: every tile holds a real key, so the new max is
      // finite and the first tile's alpha is exp2(-inf) = 0
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = exp2_sfu((m0 - mx0) * scale_log2);
      const float alpha1 = exp2_sfu((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
      const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;

      // P in TF32 hi and lo A fragments: a = (g, t), (g+8, t), (g, t+4),
      // (g+8, t+4) take S's (g, 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1),
      // which Vt's column order perm8 matches
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p[4] = {exp2_sfu(fmaf(sc[4 * j], scale_log2, -ms0)),
                            exp2_sfu(fmaf(sc[4 * j + 2], scale_log2, -ms1)),
                            exp2_sfu(fmaf(sc[4 * j + 1], scale_log2, -ms0)),
                            exp2_sfu(fmaf(sc[4 * j + 3], scale_log2, -ms1))};
        l0 += p[0] + p[2];
        l1 += p[1] + p[3];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hi = tf32_rna(p[e]);
          ph[j][e] = __float_as_uint(hi);
          pl[j][e] = __float_as_uint(p[e] - hi);
        }
      }

      // P V of this tile in three TF32 passes; k-step j reads keys
      // 8j..8j+7, the first four from Vt's first 32-key box, the rest
      // from the second
      float pv[16];
      const uint64_t dvhi = sw128_desc(st + 2 * kTileBytes);
      const uint64_t dvlo = sw128_desc(st + 3 * kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wgmma_n32(pv, pl[j], dvhi + (j / 4) * (kBoxBytes >> 4) + 2 * (j % 4),
                  j);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wgmma_n32(pv, ph[j], dvlo + (j / 4) * (kBoxBytes >> 4) + 2 * (j % 4),
                  1);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wgmma_n32(pv, ph[j], dvhi + (j / 4) * (kBoxBytes >> 4) + 2 * (j % 4),
                  1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
      if (lane == 0) mbar_arrive(&empty[s]);
      // O = alpha O + P V in round-to-nearest float32
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[4 * j] = fmaf(acc[4 * j], alpha0, pv[4 * j]);
        acc[4 * j + 1] = fmaf(acc[4 * j + 1], alpha0, pv[4 * j + 1]);
        acc[4 * j + 2] = fmaf(acc[4 * j + 2], alpha1, pv[4 * j + 2]);
        acc[4 * j + 3] = fmaf(acc[4 * j + 3], alpha1, pv[4 * j + 3]);
      }
    }

    // the row sums over the quad, the last divide, the store
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    float* ob = o + static_cast<long long>(bh) * nq * kDh;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * t;
      if (row < nq) {
        *reinterpret_cast<float2*>(ob + static_cast<long long>(row) * kDh +
                                   c) =
            make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      }
      if (row + 8 < nq) {
        *reinterpret_cast<float2*>(ob + static_cast<long long>(row + 8) *
                                            kDh + c) =
            make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

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

// A 2D float32 map of `rows` rows of `inner` values, box (box_inner,
// box_rows), 128-byte swizzle.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, float* base,
                uint64_t inner, uint64_t rows, uint32_t box_inner,
                uint32_t box_rows) {
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {inner * sizeof(float)};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Errors besides cudaError_t values: the driver has no
// cuTensorMapEncodeTiled, the scratch is too small, encoding failed.
enum { kErrNoEncoder = -1, kErrScratch = -2, kErrEncode = -3 };

extern "C" int v2v_attention_key_tile() { return kBk; }

extern "C" int v2v_attention_smem_bytes() { return kSmemBytes; }

// q (BH, nq, 32), k and v (BH, nk, 32), o (BH, nq, 32): contiguous
// float32, 16-byte aligned (the wrapper checks). scratch holds
// 4 * BH * nk_pad * 32 floats (nk_pad: nk rounded up to the key tile),
// 16-byte aligned. scale_log2 is log2(e) / sqrt(dh).
extern "C" int v2v_attention(const float* q, const float* k, const float* v,
                             float* o, float* scratch,
                             long long scratch_floats, int bh, int nq,
                             int nk, float scale_log2, void* stream) {
  const int nk_pad = (nk + kBk - 1) / kBk * kBk;
  const long long part = static_cast<long long>(bh) * nk_pad * kDh;
  if (scratch_floats < 4 * part) return kErrScratch;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  float* k_hi = scratch;
  float* k_lo = scratch + part;
  float* vt_hi = scratch + 2 * part;
  float* vt_lo = scratch + 3 * part;
  CUtensorMap maps[4];
  const uint64_t krows = static_cast<uint64_t>(bh) * nk_pad;
  const uint64_t vrows = static_cast<uint64_t>(bh) * kDh;
  if (!tensor_map(encode, &maps[0], k_hi, kDh, krows, kDh, kBk) ||
      !tensor_map(encode, &maps[1], k_lo, kDh, krows, kDh, kBk) ||
      !tensor_map(encode, &maps[2], vt_hi, nk_pad, vrows, kBk / 2, kDh) ||
      !tensor_map(encode, &maps[3], vt_lo, nk_pad, vrows, kBk / 2, kDh)) {
    return kErrEncode;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  split_kernel<<<dim3(nk_pad / kBk, bh), kSplitThreads, 0, st>>>(
      k, v, k_hi, k_lo, vt_hi, vt_lo, nk, nk_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<<<dim3((nq + kBq - 1) / kBq, bh), kThreads, kSmemBytes,
                     st>>>(maps[0], maps[1], maps[2], maps[3], q, o, nq, nk,
                           nk_pad, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
