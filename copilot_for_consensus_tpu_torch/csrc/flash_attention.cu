// K1: flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built by ops/_build.py, bound with ctypes by
// ops/flash_attention.py).
//
// Replaces: copilot_for_consensus_tpu/ops/flash_attention.py,
//   `flash_attention` (pallas_call) and its body `_flash_kernel`.
//
// Contract (same as the TPU kernel): q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D],
// bf16 or f32, contiguous; GQA with kv head h / (Hq / Hkv); causal and
// sliding-window masks against per-row query offsets; per-row kv_lengths
// and kv_begins; scores scaled by D^-0.5; softmax statistics and the
// accumulator in f32; output in q's dtype; a query row with no attendable
// key writes zeros.
//
// What bounds it on this card depends on the body, and the wrapper picks
// one of three from dtype and head dim alone:
//   * bf16 at D 64 and 128 — every prefill the port serves — runs
//     `flash_attention_wgmma_fwd`, the Hopper body of flash_wgmma.cuh
//     (wgmma products fed by TMA through a 2-stage K/V ring, 128-byte
//     swizzle). At the serving prefill shapes (Sq = Skv up to 2816, D = 128)
//     the work is ~4·Sq·Skv·D/2 flops per (row, head) against ~4·S·D·2
//     bytes, well above the H100's ~295 flop/byte ridge: bound by
//     arithmetic.
//   * bf16 at D 32 — the MiniLM encoder's attention — runs
//     `flash_attention_d32_fwd`, the Hopper body of flash_d32.cuh (wgmma
//     fed by TMA through a 3-stage ring on the 64-byte swizzle, one
//     warpgroup of 64 query rows a CTA). At the encoder's tiles the bytes
//     of q and out bound it; see that header's note.
//   * f32 at any head dim (a test dtype) runs `flash_attention_fwd`, the
//     CUDA-core body below: f32 FMAs, so its ceiling is the 67 TFLOP/s f32
//     rate.
//
// Design of the CUDA-core body. The TPU ran kv tiles as its innermost,
// sequential grid axis with the running max / denominator / accumulator in
// VMEM scratch. Here one block owns (b, q-head, 64-row q tile) and loops over
// the kv tiles itself, so the statistics live in registers:
//   * 128 threads = 4 warps; a group of 8 lanes owns 4 query rows, and each
//     lane holds 8 of the tile's 64 score columns and D/8 output columns of
//     those rows. Row max and row sum are 3-step xor shuffles inside the
//     8-lane group.
//   * Q (once) and each K/V tile are staged in shared memory as f32, rows
//     padded by one word so the column reads of Q·K^T hit distinct banks.
//   * kv tiles wholly outside [kv_begin, kv_len), past the causal frontier
//     or before the window are never visited (the TPU kernel's dead-tile
//     skip, done as loop bounds); the ragged Sq/Skv edges are masked here,
//     not padded by the caller.
//   * masked scores are -1e30 (the TPU's NEG_INF) and their probabilities
//     are zeroed explicitly, so a fully masked row keeps l == 0 and emits 0
//     instead of NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_d32.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // kv rows per tile
constexpr int NT = 128;     // threads per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ kv_lengths,
                 const int* __restrict__ q_offsets,
                 const int* __restrict__ kv_begins, int Hq, int Hkv, int Sq,
                 int Skv, int causal, int window, float scale) {
  constexpr int DP = D + 1;    // padded f32 row of Q and K
  constexpr int CPT = D / 8;   // output columns per lane
  constexpr int PP = BK + 1;   // padded row of P
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][DP]
  float* sK = sQ + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;    // [BK][D]
  float* sP = sV + BK * D;     // [BQ][PP]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = (warp * 4 + (lane >> 3)) * 4;   // first of my 4 rows
  const int tc = lane & 7;                        // my column lane

  const int q0 = qt * BQ;
  const int q_off = q_offsets[b];
  const int kv_len = min(kv_lengths[b], Skv);
  const int kv_begin = max(kv_begins[b], 0);

  const T* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Skv * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Skv * D;
  T* ob = o + (size_t)(b * Hq + h) * Sq * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    sQ[r * DP + c] = (q0 + r < Sq) ? to_f(qb[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  // kv range any row of this tile can attend: [k_lo, k_hi)
  const int nq = min(BQ, Sq - q0);
  const int qpos_first = q_off + q0, qpos_last = q_off + q0 + nq - 1;
  int k_lo = kv_begin;
  if (window > 0) k_lo = max(k_lo, qpos_first - window + 1);
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, qpos_last + 1);

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = (max(k_lo, 0) / BK) * BK; kt < k_hi; kt += BK) {
    __syncthreads();   // Q staged / previous tile fully consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, kr = kt + r;
      const bool in = kr < Skv;
      sK[r * DP + c] = in ? to_f(kb[(size_t)kr * D + c]) : 0.f;
      sV[r * D + c] = in ? to_f(vb[(size_t)kr * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(r0 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(tc + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_off + q0 + r0 + i;
      unsigned ok = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = kt + tc + 8 * j;
        const bool a = kp < kv_len && kp >= kv_begin &&
                       (!causal || kp <= qpos) &&
                       (window <= 0 || kp > qpos - window);
        ok |= (unsigned)a << j;
        s[i][j] = a ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ((ok >> j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(r0 + i) * PP + tc + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = corr * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();   // P rows are written and read inside one 8-lane group

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(r0 + i) * PP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = sV[j * D + tc + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + r0 + i;
    if (qr >= Sq) continue;
    const float den = l_i[i] == 0.f ? 1.f : l_i[i];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[(size_t)qr * D + tc + 8 * c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lens, const int* offs, const int* begins, int B,
                   int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lens, offs, begins, Hq,
      Hkv, Sq, Skv, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int D, const void* q, const void* k, const void* v,
                         void* o, const int* lens, const int* offs,
                         const int* begins, int B, int Hq, int Hkv, int Sq,
                         int Skv, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<float, 32>(q, k, v, o, lens, offs, begins, B, Hq, Hkv,
                               Sq, Skv, causal, window, st);
    case 64:
      return launch<float, 64>(q, k, v, o, lens, offs, begins, B, Hq, Hkv,
                               Sq, Skv, causal, window, st);
    case 128:
      return launch<float, 128>(q, k, v, o, lens, offs, begins, B, Hq, Hkv,
                                Sq, Skv, causal, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// the CUDA-core body: f32 q, k, v at D 32, 64 or 128 (bf16 is the wgmma
// and d32 bodies')
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const void* kv_lengths,
                                   const void* q_offsets,
                                   const void* kv_begins, int B, int Hq,
                                   int Hkv, int Sq, int Skv, int D,
                                   int causal, int window, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_f32(D, q, k, v, o, static_cast<const int*>(kv_lengths),
                           static_cast<const int*>(q_offsets),
                           static_cast<const int*>(kv_begins), B, Hq, Hkv, Sq,
                           Skv, causal, window,
                           static_cast<cudaStream_t>(stream));
}

// the wgmma body: bf16 q, k, v at D 64 or 128
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o,
                                         const void* kv_lengths,
                                         const void* q_offsets,
                                         const void* kv_begins, int B, int Hq,
                                         int Hkv, int Sq, int Skv, int D,
                                         int causal, int window,
                                         void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(kv_lengths);
  const int* offs = static_cast<const int*>(q_offsets);
  const int* begins = static_cast<const int*>(kv_begins);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)fa3::launch<128>(q, k, v, o, lens, offs, begins, B, Hq, Hkv,
                                 Sq, Skv, causal, window, st);
  if (D == 64)
    return (int)fa3::launch<64>(q, k, v, o, lens, offs, begins, B, Hq, Hkv,
                                Sq, Skv, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

// the d32 body: bf16 q, k, v at D 32
extern "C" int flash_attention_d32_fwd(const void* q, const void* k,
                                       const void* v, void* o,
                                       const void* kv_lengths,
                                       const void* q_offsets,
                                       const void* kv_begins, int B, int Hq,
                                       int Hkv, int Sq, int Skv, int D,
                                       int causal, int window, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
      D != 32)
    return (int)cudaErrorInvalidValue;
  return (int)fd32::launch(q, k, v, o, static_cast<const int*>(kv_lengths),
                           static_cast<const int*>(q_offsets),
                           static_cast<const int*>(kv_begins), B, Hq, Hkv, Sq,
                           Skv, causal, window,
                           static_cast<cudaStream_t>(stream));
}

// the d32 body's dynamic shared memory a CTA, in bytes
extern "C" int flash_attention_d32_smem() { return (int)fd32::smem_bytes(); }

// the wgmma body's dynamic shared memory a CTA at head dim D, in bytes
extern "C" int flash_attention_wgmma_smem(int D) {
  return D == 128 ? (int)fa3::smem_bytes<128>()
                  : D == 64 ? (int)fa3::smem_bytes<64>() : 0;
}

extern "C" const char* flash_attention_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
