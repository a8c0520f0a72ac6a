// K1's bf16 path (D 64 and 128: every prefill of the served models) as a
// Hopper flash-attention forward in the FA3 manner: wgmma tensor-core
// products fed by TMA through a ring of K/V stages. Included by
// flash_attention.cu; f32 and D = 32 keep the CUDA-core body there.
//
// Replaces: copilot_for_consensus_tpu/ops/flash_attention.py,
//   `flash_attention` (pallas_call) and its body `_flash_kernel`, at bf16.
//
// What bounds it on this card: at the serving prefill shapes (Sq = Skv up
// to 2816, D = 128) a (row, head) does ~4 Skv D flops against ~4 D bytes
// of its own: bound by operations on the bf16 tensor cores (989 TFLOP/s),
// which only wgmma reaches. The design:
//   * One CTA owns 128 query rows of one q head: two consumer warpgroups of
//     64 rows and a producer warpgroup, which gives most of its registers to
//     the consumers (setmaxnreg: 40 against 232) so S, O and P stay in
//     registers. One producer thread loads Q once, then keeps
//     K and V tiles of 128 kv rows in flight with TMA (128-byte swizzle,
//     64-column boxes) in a 2-stage ring, K and V each under their own full
//     mbarrier, so S = Q K^T starts before V lands. A stage is refilled
//     when all 8 consumer warps have arrived on its empty mbarrier.
//   * S = Q K^T: wgmma m64n128k16, Q and K both K-major from shared memory.
//     The softmax runs on the accumulator registers: a thread holds 2 rows
//     x 32 columns, a row's max and sum reduce over the quad of lanes that
//     share it; statistics in f32, exponentials in base 2 with the scale
//     folded in; the row sum stays per thread until the end.
//   * O += P V: P is wgmma's A from registers (the accumulator layout of S
//     is the A fragment layout, no shuffles); V [Skv, D] with D contiguous
//     is wgmma's MN-major B from shared memory. The Pallas kernel keeps p
//     in f32; rounding it once to bf16 (FA2/FA3's choice) costs 2^-9 of
//     each weight, which the int8-quantized activations of the a8 path
//     amplify over 32 layers past the model's logits bound. So P goes in
//     as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), each a pass of
//     wgmma into the same f32 O: P to ~2^-18, for a third more products.
//   * The contract of the CUDA-core body holds: GQA (kv head h / (Hq /
//     Hkv)); causal and sliding-window masks against q_offsets, kv_lengths
//     and kv_begins; dead kv tiles skipped by the loop bounds; masks
//     evaluated only on tiles that cross an edge (a per-tile test, uniform
//     over the CTA); a row with no attendable key writes 0 (its max stays
//     -inf, its exponentials 0, its sum 0); ragged Sq and Skv (TMA fills
//     rows past the tensor with zeros, the epilogue masks its stores).
//   * The grid's slowest axis walks q tiles from the last to the first, so
//     the causal tiles with the most kv tiles start first and the tail of
//     the grid is short.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace fa3 {

constexpr int BM = 128;       // query rows a CTA (two warpgroups of 64)
constexpr int BN = 128;       // kv rows a tile
constexpr int NCONS = 256;    // consumer threads
constexpr int NTHREADS = NCONS + 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int D>
struct Smem {
  static constexpr int C = D / 64;               // 64-column boxes a row
  alignas(1024) __nv_bfloat16 q[C][BM * 64];
  alignas(1024) __nv_bfloat16 k[2][C][BN * 64];
  alignas(1024) __nv_bfloat16 v[2][C][BN * 64];
  uint64_t q_full, k_full[2], v_full[2], empty[2];
};
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 128)
    hop::wgmma_rs_n128<1>(o, a, db, 1);
  else
    hop::wgmma_rs_n64<1>(o, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_lengths,
            const int* __restrict__ q_offsets,
            const int* __restrict__ kv_begins, int Hq, int Hkv, int Sq,
            int Skv, int causal, int window, float scale_log2) {
  constexpr int C = D / 64;
  constexpr int NO = D / 2;                      // O registers a thread
  extern __shared__ uint8_t raw[];
  Smem<D>& s = *reinterpret_cast<Smem<D>*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;     // longest q tiles first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int q0 = qt * BM;
  const int q_off = q_offsets[b];
  const int kv_len = min(kv_lengths[b], Skv);
  const int kv_begin = max(kv_begins[b], 0);

  // the kv range any row of this tile can attend: [k_lo, k_hi)
  const int nq = min(BM, Sq - q0);
  const int qpos_first = q_off + q0, qpos_last = q_off + q0 + nq - 1;
  int k_lo = kv_begin;
  if (window > 0) k_lo = max(k_lo, qpos_first - window + 1);
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, qpos_last + 1);
  const int kt0 = (max(k_lo, 0) / BN) * BN;
  const int ntiles = k_hi > kt0 ? (k_hi - kt0 + BN - 1) / BN : 0;

  if (tid == 0) {
    hop::mbar_init(&s.q_full, 1);
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&s.k_full[i], 1);
      hop::mbar_init(&s.v_full[i], 1);
      hop::mbar_init(&s.empty[i], NCONS / 32);   // one arrive a warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (hop::warpgroup() == NCONS / 128) {
    hop::reg_dealloc<PRODUCER_REGS>();
    // ---- producer: Q once, then the K/V ring
    if (tid == NCONS) {
      const int bq = b * Hq + h, bk = b * Hkv + hk;
      constexpr uint32_t TILE = BN * D * 2;
      hop::mbar_expect_tx(&s.q_full, BM * D * 2);
#pragma unroll
      for (int c = 0; c < C; ++c)
        hop::tma_load_3d(s.q[c], &qmap, &s.q_full, 64 * c, q0, bq);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j & 1;
        const int kt = kt0 + j * BN;
        hop::mbar_wait(&s.empty[st], ((j >> 1) & 1) ^ 1);
        hop::mbar_expect_tx(&s.k_full[st], TILE);
#pragma unroll
        for (int c = 0; c < C; ++c)
          hop::tma_load_3d(s.k[st][c], &kmap, &s.k_full[st], 64 * c, kt, bk);
        hop::mbar_expect_tx(&s.v_full[st], TILE);
#pragma unroll
        for (int c = 0; c < C; ++c)
          hop::tma_load_3d(s.v[st][c], &vmap, &s.v_full[st], 64 * c, kt, bk);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64);
    // a thread holds rows r and r + 8 of them, columns 8j + 2 (lane % 4) + e
    hop::reg_alloc<CONSUMER_REGS>();
    const int wg = hop::warpgroup(), lane = tid & 31, warp = (tid & 127) >> 5;
    const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
    const int qpos0 = q_off + row0;
    float acc[NO], sc[64];
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;

    hop::mbar_wait(&s.q_full, 0);
    const uint8_t* qs = reinterpret_cast<const uint8_t*>(s.q[0]) + wg * 64 * 128;

    for (int j = 0; j < ntiles; ++j) {
      const int st = j & 1;
      const uint32_t parity = (j >> 1) & 1;
      const int kt = kt0 + j * BN;

      // ---- S = Q K^T (f32 accumulators)
      hop::mbar_wait(&s.k_full[st], parity);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk >> 2, off = (kk & 3) * 32;
        const uint64_t da = hop::desc_sw128(
            qs + c * (BM * 128) + off, 16, 1024);
        const uint64_t db = hop::desc_sw128(
            reinterpret_cast<const uint8_t*>(s.k[st][c]) + off, 16, 1024);
        if (kk == 0)
          hop::wgmma_ss_n128_zero<0>(sc, da, db);
        else
          hop::wgmma_ss_n128<0>(sc, da, db, 1);
      }
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs<64>(sc);

      // ---- masks, only on a tile that crosses an edge
      const bool edge = kt < kv_begin || kt + BN > kv_len ||
                        (causal && kt + BN - 1 > qpos_first) ||
                        (window > 0 && kt <= qpos_last - window);
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      if (edge) {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kt + 8 * jj + 2 * (lane & 3) + (e & 1);
            const int qpos = qpos0 + 8 * (e >> 1);
            const bool ok = kp >= kv_begin && kp < kv_len &&
                            (!causal || kp <= qpos) &&
                            (window <= 0 || kp > qpos - window);
            if (!ok) sc[4 * jj + e] = -INFINITY;
          }
      }

      // ---- online softmax on the registers
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m_i[hh];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hh], sc[4 * jj + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mu = mx == -INFINITY ? 0.f : mx;
        const float corr = exp2f(m_i[hh] - mu);
        float rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * jj + 2 * hh + e] - mu);
            sc[4 * jj + 2 * hh + e] = p;
            rs += p;
          }
        l_i[hh] = l_i[hh] * corr + rs;
        m_i[hh] = mx;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          acc[4 * jj + 2 * hh] *= corr;
          acc[4 * jj + 2 * hh + 1] *= corr;
        }
      }

      // ---- O += P V: P as two bf16 A fragments (P = hi + lo), V MN-major
      // from shared memory
      uint32_t ph[32], pl[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        hop::split_bf16(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);
      hop::mbar_wait(&s.v_full[st], parity);
      hop::fence_regs<32>(ph);
      hop::fence_regs<32>(pl);
      hop::fence_regs<NO>(acc);
      hop::wg_fence();
      const uint8_t* vs = reinterpret_cast<const uint8_t*>(s.v[st][0]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_pv<D>(acc, ph + 4 * kk,
                    hop::desc_sw128(vs + kk * 16 * 128, BN * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_pv<D>(acc, pl + 4 * kk,
                    hop::desc_sw128(vs + kk * 16 * 128, BN * 128, 1024));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs<NO>(acc);
      if (lane == 0) hop::mbar_arrive(&s.empty[st]);
    }

    // ---- epilogue: the quad's row sums, then O / l (0 for an empty row)
    __nv_bfloat16* ob = o + ((size_t)(b * Hq + h) * Sq) * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_i[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l == 0.f ? 0.f : 1.f / l;
      const int r = row0 + 8 * hh;
      if (r >= Sq) continue;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + (size_t)r * D + 8 * jj + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * hh] * inv,
                                  acc[4 * jj + 2 * hh + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lens, const int* offs, const int* begins, int B,
                   int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                   cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return cudaErrorMisalignedAddress;
  CUtensorMap qmap, kmap, vmap;
  const cuuint64_t qdims[3] = {(cuuint64_t)D, (cuuint64_t)Sq,
                               (cuuint64_t)B * Hq};
  const cuuint64_t kdims[3] = {(cuuint64_t)D, (cuuint64_t)Skv,
                               (cuuint64_t)B * Hkv};
  const cuuint64_t qstr[2] = {(cuuint64_t)D * 2, (cuuint64_t)Sq * D * 2};
  const cuuint64_t kstr[2] = {(cuuint64_t)D * 2, (cuuint64_t)Skv * D * 2};
  const cuuint32_t qbox[3] = {64, BM, 1};
  const cuuint32_t kbox[3] = {64, BN, 1};
  cudaError_t e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q,
                                qdims, qstr, qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = hop::make_map(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kdims,
                      kstr, kbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = hop::make_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kdims,
                      kstr, kbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_wgmma<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid(Hq, B, (Sq + BM - 1) / BM);
  flash_wgmma<D><<<grid, NTHREADS, smem, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lens, offs, begins,
      Hq, Hkv, Sq, Skv, causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace fa3
