// K5: int4 weight-only matmul for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built by ops/_build.py, bound with ctypes by
// ops/quant_matmul.py).
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `int4_matmul`
//   (pallas_call) and its body `_kernel4`.
//
// Computes out[M, F] = sum_g scale[g] * (x[:, g] @ unpack(q4)[g]): x bf16 or
// f32; q4 packed int4 [D/2, F] (byte row i holds row 2i in its low nibble,
// 2i+1 in its high one), unpacked on chip — in registers for the mma.sync
// bodies, where one packed byte is one k-pair of one column, a bf16x2 word
// of the B fragment (of the A fragment in the stream body, which swaps the
// operands); into shared memory for the wgmma body; scale
// [G, F] per group of D/G rows. Each group's partial product is summed in
// f32, multiplied by the group's scale row in f32 and then added to the f32
// sum (the reference's order: partial, scale, accumulate); the result is
// rounded once to x's dtype. The weight never exists unpacked in device
// memory and is never rounded: nibbles are exact in bf16.
//
// What bounds it on this card, and what the design does about it:
//   * Decode (M = the slot count, 32 in the 3072-context deployment): ~4*M
//     flops per packed weight byte, far below the ~295 flop/byte bf16
//     ridge: bound by reading the packed bytes once (3.35 TB/s), which
//     needs tens of KB of weight in flight on every SM.
//     `int4_matmul_stream_fwd` runs the stream body of int4_stream.cuh for
//     bf16 x at M <= 32: TMA keeps four 8 KB weight stages in flight a CTA
//     through an mbarrier ring, the weight unpacked in registers (a byte
//     permute, a lop3 and one bf16x2 subtract per byte) is mma.sync's A
//     operand with the tokens as n8 tiles, and the contraction is split by
//     whole groups only where F is narrow, the last CTA of a column tile
//     summing the splits in order (see that header's note). Layouts it
//     refuses (group % 128, F % 16) keep the split `qgemm` of
//     quant_mma.cuh: a 32-row tile, 128 columns a block, whole groups a
//     split over blockIdx.z, an f32 workspace summed by a second pass.
//   * Prefill (M > 32, up to 2 x 2816): bound by operations on the bf16
//     tensor cores (989 TFLOP/s). `int4_matmul_wgmma_fwd` runs the Hopper
//     body of int4_wgmma.cuh: wgmma m64n192k16 fed by TMA through a
//     4-stage mbarrier ring, the weight unpacked in shared memory into
//     wgmma's MN-major layout (see that header's note). Layouts it does not
//     take (F % 16, group % 64) go by the wrapper's shape rule to the
//     mma.sync tiling of quant_mma.cuh, which K4 and K6 share.
//   * f32 x (a test dtype; serving is bf16): a 64x64-tile CUDA-core loop.

#include "int4_stream.cuh"
#include "int4_wgmma.cuh"
#include "quant_mma.cuh"

namespace {

constexpr int ST = 64, SK = 32;    // CUDA-core tile: 64x64 outputs, k 32

__global__ void __launch_bounds__(256)
int4_simt(const float* __restrict__ x, const int8_t* __restrict__ q4,
          const float* __restrict__ scale, float* __restrict__ out, int M,
          int D, int F, int group) {
  __shared__ float sA[SK][ST + 4];   // [k][m]
  __shared__ float sB[SK][ST + 4];   // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * ST, n0 = blockIdx.x * ST;
  float pacc[4][4] = {}, facc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += SK) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {              // x: 64 rows x 32 k
      const int idx = tid + 256 * p;
      const int r = idx >> 5, kk = idx & 31;
      sA[kk][r] = (m0 + r < M) ? x[(size_t)(m0 + r) * D + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {              // q4: 16 packed rows x 64
      const int idx = tid + 256 * p;
      const int pr = idx >> 6, c = idx & 63;
      int b = 0;
      if (n0 + c < F) b = q4[(size_t)(k0 / 2 + pr) * F + n0 + c];
      sB[2 * pr][c] = (float)(((b & 0xF) ^ 8) - 8);
      sB[2 * pr + 1][c] = (float)(b >> 4);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pacc[i][j] = fmaf(a[i], bv[j], pacc[i][j]);
    }
    __syncthreads();
    if ((k0 + SK) % group == 0) {
      const float* srow = scale + (size_t)(k0 / group) * F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        const float s = n < F ? srow[n] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          facc[i][j] = __fadd_rn(facc[i][j], __fmul_rn(pacc[i][j], s));
          pacc[i][j] = 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < F) out[(size_t)m * F + n] = facc[i][j];
    }
}

}  // namespace

extern "C" int int4_matmul_fwd(const void* x, const void* q4,
                               const void* scale, void* out, void* workspace,
                               int M, int D, int F, int G, int splits,
                               int is_bf16, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || G <= 0 || D % G || splits < 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q4);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)qmma::launch_qgemm<qmma::W4BF16, __nv_bfloat16>(
        x, qq, sc, nullptr, static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(workspace), M, D, F, G, splits, st);
  const int group = D / G;
  if (splits != 0 || group % SK) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + ST - 1) / ST, (M + ST - 1) / ST);
  int4_simt<<<grid, 256, 0, st>>>(static_cast<const float*>(x), qq, sc,
                                  static_cast<float*>(out), M, D, F, group);
  return (int)cudaGetLastError();
}

// the wgmma body (bf16 x, the tiled extents): x, q4, scale, out
extern "C" int int4_matmul_wgmma_fwd(const void* x, const void* q4,
                                     const void* scale, void* out, int M,
                                     int D, int F, int G, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || G <= 0 || D % G)
    return (int)cudaErrorInvalidValue;
  return (int)k5w::launch(x, static_cast<const int8_t*>(q4),
                          static_cast<const float*>(scale),
                          static_cast<__nv_bfloat16*>(out), M, D, F, D / G,
                          static_cast<cudaStream_t>(stream));
}

// the stream body (bf16 x, M <= 32): x, q4, scale, out, workspace and
// counters (both unused when splits == 1), and the wrapper's plan: column
// tile tn, splits, whole groups a split
extern "C" int int4_matmul_stream_fwd(const void* x, const void* q4,
                                      const void* scale, void* out,
                                      void* workspace, void* counters, int M,
                                      int D, int F, int G, int tn, int splits,
                                      int per, void* stream) {
  return (int)k5s::launch(x, static_cast<const int8_t*>(q4),
                          static_cast<const float*>(scale),
                          static_cast<__nv_bfloat16*>(out),
                          static_cast<float*>(workspace),
                          static_cast<int*>(counters), M, D, F, G, tn,
                          splits, per, static_cast<cudaStream_t>(stream));
}

// the stream body's dynamic shared memory a CTA for nt token tiles (1-4)
extern "C" int int4_matmul_stream_smem(int nt) {
  return (int)k5s::smem_for(nt);
}

// the wgmma body's dynamic shared memory a CTA, in bytes
extern "C" int int4_matmul_wgmma_smem() { return (int)k5w::SMEM_BYTES; }

extern "C" const char* int4_matmul_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
