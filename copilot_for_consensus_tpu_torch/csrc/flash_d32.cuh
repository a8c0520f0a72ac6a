// K1's bf16 path at head dim 32 (the MiniLM encoder's attention: 12 heads
// of 32, non-causal, kv_lengths padding) as a Hopper flash-attention
// forward: wgmma tensor-core products fed by TMA through a ring of K/V
// stages, on the 64-byte swizzle. Included by flash_attention.cu beside
// flash_wgmma.cuh (bf16 at D 64 and 128); f32 keeps the CUDA-core body there.
//
// Replaces: copilot_for_consensus_tpu/ops/flash_attention.py,
//   `flash_attention` (pallas_call) and its body `_flash_kernel`, at bf16
//   and head dim 32.
//
// What bounds it on this card: at the encoder's largest tile (B 64, 12
// heads, S 512, lengths over 1-512) a (row, head) reads 64 bytes of q and
// writes 64 of out for ~4 x 32 x len flops, while K and V rows are shared
// by every row of a head: q and out are two thirds of the bytes, and the
// bytes (~76 MB, 0.023 ms at 3.35 TB/s) outweigh the operations (12.9
// GFLOP, 0.013 ms at 989 TFLOP/s). At f32 FMA rate the same products take
// >= 0.19 ms, so only the tensor cores get near the bound. Past them, a
// score costs one exponential (MUFU) and ~9 more instructions (max, FFMA,
// sum, the hi/lo split), and at D 32 each score carries only 64 products a
// pass: the softmax's instructions, not the bytes, set the pace (~450 a
// warp a 64 x 64 tile). The design keeps them few and the warps many:
//   * One CTA is one warpgroup: 64 query rows of one q head (wgmma's M),
//     128 threads, no producer warp. Thread 0 loads Q once and the first
//     K/V tiles of BN = 64 kv rows by TMA into a 3-stage ring, K and V each
//     under their own full mbarrier (S = Q K^T starts before V lands), and
//     refills a stage once all four warps have arrived on its empty
//     mbarrier. ~30 KB of shared memory and 79 registers a thread: six CTAs
//     share an SM, so one CTA's softmax overlaps another's products and
//     loads, and the encoder's 32- and 64-token buckets leave no warpgroup
//     idle. K/V tiles are read from L2 once per 64 query rows.
//   * Layout: a bf16 row of D 32 is 64 bytes, half the 128-byte swizzle
//     every other wgmma body uses. The tiles take the 64-byte swizzle
//     (TMA's CU_TENSOR_MAP_SWIZZLE_64B with 32-column boxes, wgmma
//     descriptor layout type 2, `hop::desc_sw64`): Q and K K-major, SBO 512
//     (8 rows of 64 bytes), the two k16 steps of a row 32 bytes apart; V
//     MN-major (n = D = 32, one line), SBO 512, a k16 step 16 lines.
//   * S = Q K^T: two wgmma m64n64k16, Q and K from shared memory. The
//     softmax runs on the accumulator registers: a thread holds 2 rows x 16
//     columns, a row's max and sum reduce over the quad of lanes that share
//     it; statistics in f32, the max in raw units, and 2^(s c - m c) with
//     the scale c folded into one FFMA and one ex2.approx a score; the row
//     sum stays per thread until the end.
//   * O += P V: wgmma m64n32k16 with P as the register A operand (the
//     accumulator layout of S is the A fragment layout, no shuffles) and V
//     from shared memory. P goes in as two bf16 parts, hi = bf16(P) and lo =
//     bf16(P - hi), each a pass into the same f32 O (flash_wgmma.cuh's
//     numerics: P to ~2^-18 where one rounding would cost 2^-9); the lo
//     pass is about a sixth of the body's time on the card at the
//     encoder's largest tile (PERF.md).
//   * The contract of the other bodies holds: GQA (kv head h / (Hq / Hkv));
//     causal and sliding-window masks against q_offsets, kv_lengths and
//     kv_begins; dead kv tiles skipped by the loop bounds; masks applied
//     only on tiles that cross an edge (a per-tile test, uniform over the
//     CTA), each row's as one interval [lo, hi) of keys; a row with no
//     attendable key writes 0 (its max stays -inf, its exponentials 0, its
//     sum 0); ragged Sq and Skv (TMA fills rows past the tensor with zeros,
//     the epilogue masks its stores).
//   * The grid's fastest axis walks the q tiles of one head, from the last
//     to the first: the CTAs that read one head's K and V run together (it
//     stays in L2), and causal tiles with the most kv tiles start first.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace fd32 {

constexpr int D = 32;
constexpr int BM = 64;           // query rows a CTA: one warpgroup
constexpr int BN = 64;           // kv rows a tile
constexpr int NSTAGE = 3;        // K/V ring depth
constexpr int TILE = BN * D * 2; // bytes of one K or V tile

struct Smem {
  alignas(1024) __nv_bfloat16 q[BM * D];
  alignas(1024) __nv_bfloat16 k[NSTAGE][BN * D];
  alignas(1024) __nv_bfloat16 v[NSTAGE][BN * D];
  uint64_t q_full, k_full[NSTAGE], v_full[NSTAGE], empty[NSTAGE];
};
constexpr size_t smem_bytes() { return sizeof(Smem) + 1024; }

// 2^x in one MUFU op; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// hop::split_bf16 with the bf16 -> f32 widening done by bit operations
// (two instructions a pair where __bfloat1622float2 compiles to four; the
// same values): hi = bf16x2(a, b), lo = bf16x2(a - hi.x, b - hi.y). The
// bodies of K1 at D 64/128 and K3 keep hop::split_bf16: their code and
// times stay as they are in this change of one kernel.
__device__ __forceinline__ void split_p(float a, float b, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// one kv tile's loads into ring stage st
__device__ __forceinline__ void load_kv(Smem& s, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int st,
                                        int kt, int bk) {
  hop::mbar_expect_tx(&s.k_full[st], TILE);
  hop::tma_load_3d(s.k[st], kmap, &s.k_full[st], 0, kt, bk);
  hop::mbar_expect_tx(&s.v_full[st], TILE);
  hop::tma_load_3d(s.v[st], vmap, &s.v_full[st], 0, kt, bk);
}

__global__ void __launch_bounds__(128, 6)
flash_d32(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          __nv_bfloat16* __restrict__ o, const int* __restrict__ kv_lengths,
          const int* __restrict__ q_offsets,
          const int* __restrict__ kv_begins, int Hq, int Hkv, int Sq,
          int Skv, int causal, int window, float scale_log2) {
  extern __shared__ uint8_t raw[];
  Smem& s = *reinterpret_cast<Smem*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int bk = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
    for (int i = 0; i < NSTAGE; ++i) {
      hop::mbar_init(&s.k_full[i], 1);
      hop::mbar_init(&s.v_full[i], 1);
      hop::mbar_init(&s.empty[i], 4);   // one arrive a warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  // thread 0 issues every load: Q once, the ring's first stages now, and
  // each stage again once all four warps have arrived on its empty barrier
  if (tid == 0) {
    hop::mbar_expect_tx(&s.q_full, BM * D * 2);
    hop::tma_load_3d(s.q, &qmap, &s.q_full, 0, q0, b * Hq + h);
    for (int j = 0; j < min(ntiles, NSTAGE); ++j)
      load_kv(s, &kmap, &vmap, j, kt0 + j * BN, bk);
  }

  // a thread holds rows r and r + 8 of the tile, columns 8j + 2 (lane % 4)
  // + e; the interval [lo, hi) of keys each row may attend
  const int row0 = q0 + warp * 16 + (lane >> 2);
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qpos = q_off + row0 + 8 * hh;
    lo[hh] = window > 0 ? max(kv_begin, qpos - window + 1) : kv_begin;
    hi[hh] = causal ? min(kv_len, qpos + 1) : kv_len;
  }
  float acc[16];
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  hop::mbar_wait(&s.q_full, 0);
  const uint8_t* qs = reinterpret_cast<const uint8_t*>(s.q);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % NSTAGE;
    const uint32_t parity = (j / NSTAGE) & 1;
    const int kt = kt0 + j * BN;

    // ---- S = Q K^T (f32 accumulators), two k16 steps of a 64-byte row
    float sc[32];
    const uint8_t* ks = reinterpret_cast<const uint8_t*>(s.k[st]);
    hop::mbar_wait(&s.k_full[st], parity);
    hop::wg_fence();
    hop::wgmma_ss_n64_zero<0>(sc, hop::desc_sw64(qs, 16, 512),
                              hop::desc_sw64(ks, 16, 512));
    hop::wgmma_ss_n64<0>(sc, hop::desc_sw64(qs + 32, 16, 512),
                         hop::desc_sw64(ks + 32, 16, 512), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs<32>(sc);

    // ---- masks, only on a tile that crosses an edge of some row's range
    // (a test uniform over the CTA)
    const bool edge = kt < kv_begin || kt + BN > kv_len ||
                      (causal && kt + BN - 1 > qpos_first) ||
                      (window > 0 && kt <= qpos_last - window);
    if (edge) {
      const int c0 = kt + 2 * (lane & 3);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = c0 + 8 * jj + (e & 1);
          if (kp < lo[e >> 1] || kp >= hi[e >> 1]) sc[4 * jj + e] = -INFINITY;
        }
    }

    // ---- online softmax on the registers: 2^(s c - m c), the scale c
    // folded into one FFMA a score; the max in raw units
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m_i[hh];
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hh], sc[4 * jj + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mu = mx == -INFINITY ? 0.f : mx;
      const float nmc = -mu * scale_log2;
      const float corr = ex2((m_i[hh] - mu) * scale_log2);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(sc[4 * jj + 2 * hh + e], scale_log2, nmc));
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

    // ---- O += P V: P as two bf16 A fragments (P = hi + lo), V MN-major,
    // four k16 steps of 16 lines each
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) split_p(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);
    const uint8_t* vs = reinterpret_cast<const uint8_t*>(s.v[st]);
    hop::mbar_wait(&s.v_full[st], parity);
    hop::fence_regs<16>(ph);
    hop::fence_regs<16>(pl);
    hop::fence_regs<16>(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hop::wgmma_rs_n32<1>(acc, ph + 4 * kk,
                           hop::desc_sw64(vs + kk * 16 * 64, TILE, 512), 1);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hop::wgmma_rs_n32<1>(acc, pl + 4 * kk,
                           hop::desc_sw64(vs + kk * 16 * 64, TILE, 512), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs<16>(acc);
    // ---- stage st is free again: refill it with tile j + NSTAGE
    if (lane == 0) hop::mbar_arrive(&s.empty[st]);
    if (tid == 0 && j + NSTAGE < ntiles) {
      hop::mbar_wait(&s.empty[st], parity);
      load_kv(s, &kmap, &vmap, st, kt + NSTAGE * BN, bk);
    }
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

inline cudaError_t launch(const void* q, const void* k, const void* v,
                         void* o, const int* lens, const int* offs,
                         const int* begins, int B, int Hq, int Hkv, int Sq,
                         int Skv, int causal, int window, cudaStream_t st) {
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
  const cuuint32_t qbox[3] = {D, BM, 1};
  const cuuint32_t kbox[3] = {D, BN, 1};
  cudaError_t e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q,
                                qdims, qstr, qbox, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == cudaSuccess)
    e = hop::make_map(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kdims,
                      kstr, kbox, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == cudaSuccess)
    e = hop::make_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kdims,
                      kstr, kbox, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes();
  e = cudaFuncSetAttribute(flash_d32,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_d32<<<grid, 128, smem, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lens, offs, begins,
      Hq, Hkv, Sq, Skv, causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace fd32
