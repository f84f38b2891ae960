// K3: softmax(Q K^T / sqrt(dh)) V over every key, float32, dh = 32.
//
// Replaces v2v_tpu/models/eitr.py::_flash_attention_padded, the TPU
// flash attention that ETNet's MultiheadAttention runs in eval above
// chunk_threshold = 4096 tokens (720p: B=1, 8 heads, N = 14,400).
//
// What bounds it: 4*B*h*Nq*Nk*dh float32 operations (Q K^T and P V,
// two per multiply-add), 2.12e11 at 720p, against 4*B*h*N*dh*4 bytes
// of Q, K, V and O (59 MB). At 67 TFLOP/s of float32 outside the tensor
// cores that is 3.17 ms, and the bytes take 18 us: the bound is
// operations. (On the TF32 tensor cores, 495 TFLOP/s, it would be
// 0.43 ms; that is a later kernel's work.)
//
// Design: the function, not the TPU kernel's blocks. One block per
// (batch*head, 128-query tile), one thread per query row, its q and a
// 32-wide accumulator in registers. The block walks the keys in tiles of
// 64 staged in shared memory (K and V, 16 KB); each thread reads a key
// row as eight float4 broadcasts. An online softmax in float32 (running
// max m and sum l, the accumulator rescaled once per tile) means the
// Nq x Nk logits never exist; the last divide by l happens once per row.
// The ragged last tile is zero-filled and its scores masked to -inf, so
// no padding and no segment ids are needed: real queries see exactly
// the real keys. Nq and Nk may differ (cross attention).
//
// Rounding: the 1/sqrt(dh) scale is folded into the exponent,
// exp2((s - m) * log2(e)/sqrt(dh)), where the JAX and plain versions
// divide the logits by sqrt(dh) before the softmax; the results agree
// to float32 rounding (a few ulps, chip_smoke.py states the tolerance).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kDh = 32;
constexpr int kVec = kDh / 4;   // float4 per row
constexpr int kBq = 128;        // queries per block, one per thread
constexpr int kBk = 64;         // keys per shared-memory tile

__global__ void __launch_bounds__(kBq)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int nq,
                 int nk, float scale_log2) {
  __shared__ float4 ks[kBk][kVec];
  __shared__ float4 vs[kBk][kVec];
  const long long bh = blockIdx.y;
  const int row = blockIdx.x * kBq + threadIdx.x;
  const float4* kb = reinterpret_cast<const float4*>(k) + bh * nk * kVec;
  const float4* vb = reinterpret_cast<const float4*>(v) + bh * nk * kVec;

  float qr[kDh];
  if (row < nq) {
    const float4* qp =
        reinterpret_cast<const float4*>(q) + (bh * nq + row) * kVec;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float4 t = qp[c];
      qr[4 * c] = t.x;
      qr[4 * c + 1] = t.y;
      qr[4 * c + 2] = t.z;
      qr[4 * c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < kDh; ++d) qr[d] = 0.f;
  }
  float acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kBk) {
    const int valid = min(kBk, nk - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBk * kVec; i += kBq) {
      const int r = i / kVec;
      const int c = i % kVec;
      float4 kt = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vt = kt;
      if (r < valid) {
        const long long at = static_cast<long long>(k0 + r) * kVec + c;
        kt = kb[at];
        vt = vb[at];
      }
      ks[r][c] = kt;
      vs[r][c] = vt;
    }
    __syncthreads();

    float s[kBk];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float4 kk = ks[j][c];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
      s[j] = j < valid ? dot : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // every tile holds at least one real key, so m_new is finite and
    // the first tile's alpha is exp2(-inf) = 0
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f((m - m_new) * scale_log2);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kDh; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const float p = exp2f((s[j] - m_new) * scale_log2);
      l += p;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float4 vv = vs[j][c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (row < nq) {
    const float inv = 1.f / l;
    float4* op = reinterpret_cast<float4*>(o) + (bh * nq + row) * kVec;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      op[c] = make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                          acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
    }
  }
}

}  // namespace

// q (BH, nq, 32), k and v (BH, nk, 32), o (BH, nq, 32): contiguous
// float32, 16-byte aligned (the wrapper checks). scale_log2 is
// log2(e) / sqrt(dh).
extern "C" int v2v_attention(const float* q, const float* k, const float* v,
                             float* o, int bh, int nq, int nk,
                             float scale_log2, void* stream) {
  const dim3 grid((nq + kBq - 1) / kBq, bh);
  attention_kernel<<<grid, kBq, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, nq, nk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
