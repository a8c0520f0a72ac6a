// K2: int8 weight-only matmul for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built by ops/_build.py, bound with ctypes by
// ops/quant_matmul.py).
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `int8_matmul`
//   (pallas_call) and its body `_kernel`.
//
// Computes out[M, F] = (x[M, D] @ q[D, F]) * scale[F]: x bf16 or f32, q int8
// converted to the compute type in registers / shared memory (never written
// back to device memory), f32 accumulation, the per-output-channel scale
// applied in f32 once at the end, out in x's dtype. Any M, D, F.
//
// What bounds it on this card, and what the design does about it:
//   * Decode (M = the slot count, 4 contiguous or 8 paged): ~2·M flops per
//     weight byte, far below the H100's ~295 flop/byte ridge — bound by
//     reading the int8 bytes once (3.35 TB/s). bf16 x with D % 128 == 0
//     and F % 16 == 0 (every Mistral-7B leaf) runs `int8_matmul_stream_fwd`,
//     the Hopper weight stream of int8_stream.cuh: TMA keeps four 16 KB
//     weight stages in flight a CTA through an mbarrier ring, the weight
//     converted exactly to bf16 in registers (two byte permutes and one f32
//     subtraction a byte) is mma.sync's A operand with the tokens as one n8
//     tile, and the contraction is split by whole stages only where F is
//     narrow, the last CTA of a column tile summing the splits in order —
//     one launch a call (see that header's note). f32 x and the layouts it
//     refuses keep the split GEMV, `gemv_partial` + `gemv_reduce` (M <= 8,
//     taken when the wrapper passes splits > 0): each lane streams 8
//     consecutive int8 columns of a weight row with one 8-byte load, warps
//     of a block take interleaved rows, and the contraction axis is split
//     over blockIdx.y. Per-split partials go to an f32 workspace [splits,
//     M, F] (allocated by the wrapper) and a second pass sums them in a
//     fixed order — deterministic, no atomics — then scales and rounds.
//     The wrapper's shape rule (`int8_body`) picks the body.
//   * Prefill (M = rows × bucket, 2048-4096 in the int8 waves): bound by
//     operations on the bf16 tensor cores (989 TFLOP/s). bf16 x with D %
//     64 == 0 and F % 16 == 0 (every Mistral-7B leaf) runs
//     `int8_matmul_wgmma_fwd`, the Hopper body of int8_wgmma.cuh: wgmma
//     fed by TMA through a 4-stage mbarrier ring, the weight converted to
//     bf16 in shared memory into wgmma's MN-major layout (see that
//     header's note). Other bf16 layouts take `gemm_wmma`: 128×128 output
//     tiles, 8 warps each owning 32×64, WMMA (mma.sync m16n8k16) fragments
//     with f32 accumulators, the int8 tile converted on its way into shared
//     memory, no pipelining. Nothing falls back.
//     Path `gemm_simt` (f32 x): a 64×64-tile CUDA-core loop, kept for f32
//     callers (tests); the serving dtype is bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "int8_stream.cuh"
#include "int8_wgmma.cuh"

namespace {

constexpr int GV_COLS = 256;      // columns per GEMV block (32 lanes × 8)
constexpr int GV_WARPS = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float byte_f(unsigned w, int i) {
  return (float)(signed char)((w >> (8 * i)) & 0xffu);
}

// ---------------------------------------------------------------------------
// GEMV path (M <= 8): partial sums over one contraction split
// ---------------------------------------------------------------------------

template <typename T, int M>
__global__ void __launch_bounds__(GV_WARPS * 32)
gemv_partial(const T* __restrict__ x, const int8_t* __restrict__ q,
             float* __restrict__ ws, int D, int F, int chunk) {
  __shared__ float red[GV_WARPS][M][GV_COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * GV_COLS + lane * 8;
  const int d_begin = blockIdx.y * chunk;
  const int d_end = min(D, d_begin + chunk);
  const bool vec = (F % 8 == 0) && (f0 + 8 <= F);

  float acc[M][8];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;

#pragma unroll 4
  for (int d = d_begin + warp; d < d_end; d += GV_WARPS) {
    const int8_t* row = q + (size_t)d * F + f0;
    float w[8];
    if (vec) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(row));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        w[c] = byte_f(u.x, c);
        w[c + 4] = byte_f(u.y, c);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) w[c] = (f0 + c < F) ? (float)row[c] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float xv = to_f(x[(size_t)m * D + d]);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) red[warp][m][lane * 8 + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < M * GV_COLS; i += GV_WARPS * 32) {
    const int m = i / GV_COLS, c = i % GV_COLS;
    const int f = blockIdx.x * GV_COLS + c;
    if (f < F) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w) s += red[w][m][c];
      ws[((size_t)blockIdx.y * M + m) * F + f] = s;
    }
  }
}

template <typename T>
__global__ void gemv_reduce(const float* __restrict__ ws,
                            const float* __restrict__ scale,
                            T* __restrict__ out, int M, int F, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * F) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[(size_t)p * M * F + i];
  out[i] = from_f<T>(s * scale[i % F]);
}

// ---------------------------------------------------------------------------
// Tiled path, bf16: tensor-core fragments
// ---------------------------------------------------------------------------

constexpr int TM = 128, TN = 128, TK = 32;
constexpr int LDA = TK + 8;    // bf16 elements per staged x row
constexpr int LDB = TN + 8;    // bf16 elements per staged weight row

__global__ void __launch_bounds__(256)
gemm_wmma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
          int M, int D, int F) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 sA[TM * LDA];
  __shared__ __align__(128) __nv_bfloat16 sB[TK * LDB];
  __shared__ __align__(128) float stage[8][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;   // warp tile: 32 rows × 64 cols
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const bool vec_a = (D % 8 == 0);
  const bool vec_b = (F % 16 == 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < D; k0 += TK) {
    // x tile [TM][TK]: 512 chunks of 8 bf16, two per thread
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int ci = tid + 256 * p;
      const int r = ci >> 2, cc = (ci & 3) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M) {
        const __nv_bfloat16* src = x + (size_t)gm * D + gk;
        if (vec_a && gk + 8 <= D) {
          val = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            tmp[e] = (gk + e < D) ? src[e] : __float2bfloat16(0.f);
          val = *reinterpret_cast<uint4*>(tmp);
        }
      }
      *reinterpret_cast<uint4*>(&sA[r * LDA + cc]) = val;
    }
    // weight tile [TK][TN]: 16 int8 per thread, converted to bf16
    {
      const int r = tid >> 3, cc = (tid & 7) * 16;
      const int gk = k0 + r, gn = n0 + cc;
      float w[16];
      if (gk < D && vec_b && gn + 16 <= F) {
        const uint4 u =
            __ldg(reinterpret_cast<const uint4*>(q + (size_t)gk * F + gn));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = byte_f(u.x, e);
          w[e + 4] = byte_f(u.y, e);
          w[e + 8] = byte_f(u.z, e);
          w[e + 12] = byte_f(u.w, e);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          w[e] = (gk < D && gn + e < F) ? (float)q[(size_t)gk * F + gn + e]
                                        : 0.f;
      }
      __align__(16) __nv_bfloat162 pk[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        pk[e] = __floats2bfloat162_rn(w[2 * e], w[2 * e + 1]);
      uint4* dst = reinterpret_cast<uint4*>(&sB[r * LDB + cc]);
      dst[0] = *reinterpret_cast<uint4*>(&pk[0]);
      dst[1] = *reinterpret_cast<uint4*>(&pk[4]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sA[(wm * 32 + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], &sB[kk * LDB + wn * 64 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each 16×16 fragment through the warp's staging tile, scaled
  // in f32 and rounded once
  float* st = stage[warp];
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 32 + i * 16 + er;
      const int gn = n0 + wn * 64 + j * 16 + ec;
      if (gm < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (gn + e < F)
            out[(size_t)gm * F + gn + e] =
                __float2bfloat16(st[er * 16 + ec + e] * scale[gn + e]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// Tiled path, f32: CUDA-core loop
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
gemm_simt(const T* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ scale, T* __restrict__ out, int M, int D,
          int F) {
  __shared__ float sA[16][64 + 4];   // [k][m]
  __shared__ float sB[16][64 + 4];   // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += 16) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int idx = tid + 256 * p;
      const int r = idx >> 4, kk = idx & 15;     // x: 64 rows × 16 k
      sA[kk][r] = (m0 + r < M && k0 + kk < D)
                      ? to_f(x[(size_t)(m0 + r) * D + k0 + kk])
                      : 0.f;
      const int kr = idx >> 6, c = idx & 63;     // q: 16 k × 64 cols
      sB[kr][c] = (k0 + kr < D && n0 + c < F)
                      ? (float)q[(size_t)(k0 + kr) * F + n0 + c]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < F)
        out[(size_t)gm * F + gn] = from_f<T>(acc[i][j] * scale[gn]);
    }
}

template <typename T, int MM>
cudaError_t gemv_m(const T* x, const int8_t* q, float* ws, int D, int F,
                   int splits, cudaStream_t st) {
  const int chunk = (D + splits - 1) / splits;
  const dim3 grid((F + GV_COLS - 1) / GV_COLS, splits);
  gemv_partial<T, MM><<<grid, GV_WARPS * 32, 0, st>>>(x, q, ws, D, F, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* xv, const int8_t* q, const float* scale,
                void* outv, float* ws, int M, int D, int F, int splits,
                cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  // the caller picks the path: splits > 0 is the GEMV path (built for
  // M = 1 .. 8, partials in `ws`), splits = 0 the tiled path
  if (splits > 0) {
    if (M > 8 || ws == nullptr) return cudaErrorInvalidValue;
    cudaError_t e;
    switch (M) {
      case 1: e = gemv_m<T, 1>(x, q, ws, D, F, splits, st); break;
      case 2: e = gemv_m<T, 2>(x, q, ws, D, F, splits, st); break;
      case 3: e = gemv_m<T, 3>(x, q, ws, D, F, splits, st); break;
      case 4: e = gemv_m<T, 4>(x, q, ws, D, F, splits, st); break;
      case 5: e = gemv_m<T, 5>(x, q, ws, D, F, splits, st); break;
      case 6: e = gemv_m<T, 6>(x, q, ws, D, F, splits, st); break;
      case 7: e = gemv_m<T, 7>(x, q, ws, D, F, splits, st); break;
      default: e = gemv_m<T, 8>(x, q, ws, D, F, splits, st); break;
    }
    if (e != cudaSuccess) return e;
    const int n = M * F;
    gemv_reduce<T><<<(n + 255) / 256, 256, 0, st>>>(ws, scale, out, M, F,
                                                     splits);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((F + TN - 1) / TN, (M + TM - 1) / TM);
    gemm_wmma<<<grid, 256, 0, st>>>(x, q, scale, out, M, D, F);
  } else {
    const dim3 grid((F + 63) / 64, (M + 63) / 64);
    gemm_simt<T><<<grid, 256, 0, st>>>(x, q, scale, out, M, D, F);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_matmul_fwd(const void* x, const void* q,
                               const void* scale, void* out, void* workspace,
                               int M, int D, int F, int splits, int is_bf16,
                               void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || splits < 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(x, qq, sc, out, ws, M, D, F, splits, st);
  return (int)run<float>(x, qq, sc, out, ws, M, D, F, splits, st);
}

// the wgmma body (bf16 x, the tiled extents): x, q, scale, out; tn = the
// CTA's output columns (128 or 256)
extern "C" int int8_matmul_wgmma_fwd(const void* x, const void* q,
                                     const void* scale, void* out, int M,
                                     int D, int F, int tn, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  return (int)k2w::launch(x, static_cast<const int8_t*>(q),
                          static_cast<const float*>(scale),
                          static_cast<__nv_bfloat16*>(out), M, D, F, tn,
                          static_cast<cudaStream_t>(stream));
}

// the wgmma body's dynamic shared memory a CTA at tile width tn, in bytes
extern "C" int int8_matmul_wgmma_smem(int tn) {
  return tn == 256 ? (int)k2w::smem_bytes<256>()
                   : (int)k2w::smem_bytes<128>();
}

// the stream body (bf16 x, M <= 8): x, q, scale, out, workspace and
// counters (both unused when splits == 1), and the wrapper's plan: column
// tile tn, splits, contraction rows a split
extern "C" int int8_matmul_stream_fwd(const void* x, const void* q,
                                      const void* scale, void* out,
                                      void* workspace, void* counters, int M,
                                      int D, int F, int tn, int splits,
                                      int rows, void* stream) {
  return (int)k2s::launch(x, static_cast<const int8_t*>(q),
                          static_cast<const float*>(scale),
                          static_cast<__nv_bfloat16*>(out),
                          static_cast<float*>(workspace),
                          static_cast<int*>(counters), M, D, F, tn, splits,
                          rows, static_cast<cudaStream_t>(stream));
}

// the stream body's dynamic shared memory a CTA, in bytes
extern "C" int int8_matmul_stream_smem() { return (int)k2s::SMEM_BYTES; }

extern "C" const char* int8_matmul_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
