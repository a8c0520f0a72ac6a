// K3's seeded regime (bf16 q_rows and bf16 pool, D 64/128, R > 16 rows a
// kv head: the group x suffix rows of a seeded admission pass) as a Hopper
// flash partial: wgmma tensor-core products fed by TMA through the block
// table. Included by paged_attention.cu; decode's few rows take the
// split-KV body of paged_decode.cuh, the f32 and fp8 pools and D 32 the
// CUDA-core body there.
//
// Replaces: copilot_for_consensus_tpu/ops/paged_attention.py,
//   `paged_attention_partial_pallas` (pallas_call) and its body
//   `_paged_partial_kernel`, at the seeded pass's many rows.
//
// What bounds it on this card: the raw partials it must write. At the main
// path's S1024 shape (R = 4096 rows a kv head, 128 prefix positions) a
// call writes 134 MB of f32 acc and reads 67 MB of q against 4 MB of K/V:
// bound by bytes (~0.06 ms). Its ~17 GFLOP cost 0.26 ms at the card's f32
// rate on the CUDA cores but ~0.02 ms on the bf16 tensor cores, so only
// wgmma keeps the products under the bytes. The design is K1's
// (flash_wgmma.cuh) with the table between the loads and the pool:
//   * The work items are the row tiles of 128 rows of every (slot, kv
//     head), slot-major; a grid of about one CTA an SM walks them
//     round-robin (CTA c takes items c, c + G, ...), so every CTA gets a
//     like share of each slot's tiles however unequal the slots' lengths.
//     A CTA has two consumer warpgroups of 64 rows and a producer
//     warpgroup (setmaxnreg: 40 against 232). One producer thread loads
//     each item's Q by TMA (128-byte swizzle, 64-column boxes) into one of
//     two Q buffers, so the next item's Q lands while this one computes and
//     its partials leave, and keeps K and V tiles of 128 positions in
//     flight in a 2-stage ring:
//     each tile is 128 / blk boxes (or one box inside a block of 128 or
//     more), each box the rows of one pool block, addressed through a 3-D
//     tensor map over [L * NBtot * Hkv, blk, D] at slab (li * NBtot +
//     clamp(id)) * Hkv + h — every table id is clamped to [0, NBtot - 1]
//     before it forms an address.
//   * S = Q K^T by wgmma m64n128k16, both operands K-major; the softmax
//     runs on the accumulator registers in base 2 with the scale folded in.
//     All R rows of a slot attend the same positions [lo, hi), so the loop
//     runs over exactly the tiles that meet them (dead tiles are loop
//     bounds) and masks are evaluated only on a tile that crosses lo or hi.
//   * O += P V with P as two bf16 parts (hi + lo, each a pass of wgmma into
//     the same f32 O), as K1 does: the Pallas kernel keeps p in f32.
//   * The epilogue writes the raw partials, not a normalised output: acc
//     in f32; m converted to natural-log units of s * D^-0.5 (m2 * ln 2);
//     l = sum exp(s - m). A row that attends nothing gives m = -inf, l = 0
//     and acc = 0, never NaN. acc leaves as 8-byte stores, a quad of lanes
//     filling each 32-byte sector of a row.
// It takes blk % 8 == 0 with blk dividing 128 or a multiple of 128 (the
// boxes tile the 128-position tile exactly); the wrapper routes other
// layouts to the CUDA-core body.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace k3s {

constexpr int BM = 128;       // query rows a CTA (two warpgroups of 64)
constexpr int BN = 128;       // positions a K/V tile
constexpr int NCONS = 256;    // consumer threads
constexpr int NTHREADS = NCONS + 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int D>
struct Smem {
  static constexpr int C = D / 64;               // 64-column boxes a row
  alignas(1024) __nv_bfloat16 q[2][C][BM * 64];
  alignas(1024) __nv_bfloat16 k[2][C][BN * 64];
  alignas(1024) __nv_bfloat16 v[2][C][BN * 64];
  uint64_t q_full[2], q_empty[2], k_full[2], v_full[2], empty[2];
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

// load one K or V tile of positions [kt, kt + BN) of slot b, head h: BN / br
// boxes of br pool rows, each from the block the table names
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[BN * 64],
                                          const CUtensorMap* map,
                                          uint64_t* bar, const int* tbl,
                                          int kt, int br, int blk, int NB,
                                          int NBtot, int li, int Hkv, int h) {
  constexpr int C = D / 64;
  for (int sb = 0; sb < BN / br; ++sb) {
    const int p = kt + sb * br;
    const int e = min(p / blk, NB - 1);
    const int id = min(max(__ldg(tbl + e), 0), NBtot - 1);
    const int slab = (li * NBtot + id) * Hkv + h;
#pragma unroll
    for (int c = 0; c < C; ++c)
      hop::tma_load_3d(dst[c] + sb * br * 64, map, bar, 64 * c, p % blk,
                       slab);
  }
}

// the positions every row of slot b attends, [lo, hi), and the K/V tiles
// that meet them: ntiles from kt0
struct Span {
  int lo, hi, kt0, ntiles;
};
__device__ __forceinline__ void span(Span& sp, const int* lengths,
                                     const int* q_pos, int b, int NB,
                                     int blk, int window) {
  sp.hi = min(lengths[b], NB * blk);
  sp.lo = window > 0 ? max(0, q_pos[b] - window + 1) : 0;
  sp.kt0 = (sp.lo / BN) * BN;
  sp.ntiles = sp.hi > sp.lo ? (sp.hi - sp.kt0 + BN - 1) / BN : 0;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
paged_wgmma(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const int* __restrict__ tables, const int* __restrict__ lengths,
            const int* __restrict__ q_pos, float* __restrict__ acc_out,
            float* __restrict__ m_out, float* __restrict__ l_out, int B,
            int Hkv, int R, int NBtot, int blk, int NB, int li, int window,
            int br, float scale_log2) {
  constexpr int C = D / 64;
  constexpr int NO = D / 2;                      // O registers a thread
  extern __shared__ uint8_t raw[];
  Smem<D>& s = *reinterpret_cast<Smem<D>*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  const int row_tiles = (R + BM - 1) / BM;
  const int items = B * Hkv * row_tiles;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&s.q_full[i], 1);
      hop::mbar_init(&s.q_empty[i], NCONS / 32);  // one arrive a warp
      hop::mbar_init(&s.k_full[i], 1);
      hop::mbar_init(&s.v_full[i], 1);
      hop::mbar_init(&s.empty[i], NCONS / 32);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  // Item it = (b * Hkv + h) * row_tiles + rt. Items whose slot attends
  // nothing load nothing (their rows get m = -inf, l = 0, acc = 0); the
  // others are counted (n) for the Q buffers, their K/V tiles (t) for the
  // ring, alike on both sides.
  if (hop::warpgroup() == NCONS / 128) {
    hop::reg_dealloc<PRODUCER_REGS>();
    // ---- producer: each item's Q, then the K/V ring through the table
    if (tid == NCONS) {
      constexpr uint32_t TILE = BN * D * 2;
      int n = 0, t = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int rt = it % row_tiles, bh = it / row_tiles;
        const int b = bh / Hkv, h = bh % Hkv;
        Span sp;
        span(sp, lengths, q_pos, b, NB, blk, window);
        if (sp.ntiles == 0) continue;
        const int qb = n & 1;
        hop::mbar_wait(&s.q_empty[qb], ((n >> 1) & 1) ^ 1);
        hop::mbar_expect_tx(&s.q_full[qb], BM * D * 2);
#pragma unroll
        for (int c = 0; c < C; ++c)
          hop::tma_load_3d(s.q[qb][c], &qmap, &s.q_full[qb], 64 * c,
                           rt * BM, bh);
        ++n;
        const int* tbl = tables + (size_t)b * NB;
        for (int j = 0; j < sp.ntiles; ++j, ++t) {
          const int st = t & 1;
          const int kt = sp.kt0 + j * BN;
          hop::mbar_wait(&s.empty[st], ((t >> 1) & 1) ^ 1);
          hop::mbar_expect_tx(&s.k_full[st], TILE);
          load_tile<D>(s.k[st], &kmap, &s.k_full[st], tbl, kt, br, blk, NB,
                       NBtot, li, Hkv, h);
          hop::mbar_expect_tx(&s.v_full[st], TILE);
          load_tile<D>(s.v[st], &vmap, &s.v_full[st], tbl, kt, br, blk, NB,
                       NBtot, li, Hkv, h);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [128 rt + 64 wg, + 64) of the
    // item; a thread holds rows r and r + 8 of them, columns 8j + 2 (lane
    // % 4) + e
    hop::reg_alloc<CONSUMER_REGS>();
    const int wg = hop::warpgroup(), lane = tid & 31, warp = (tid & 127) >> 5;
    constexpr float LN2 = 0.693147180559945309f;
    int n = 0, t = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int rt = it % row_tiles;
      const size_t bh = it / row_tiles;
      Span sp;
      span(sp, lengths, q_pos, (int)(bh / Hkv), NB, blk, window);
      const int lo = sp.lo, hi = sp.hi, kt0 = sp.kt0, ntiles = sp.ntiles;
      const int qb = n & 1;
      const int row0 = rt * BM + wg * 64 + warp * 16 + (lane >> 2);
      float acc[NO], sc[64];
      float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < NO; ++e) acc[e] = 0.f;
      const uint8_t* qs =
          reinterpret_cast<const uint8_t*>(s.q[qb][0]) + wg * 64 * 128;
      if (ntiles > 0) hop::mbar_wait(&s.q_full[qb], (n++ >> 1) & 1);

      for (int j = 0; j < ntiles; ++j, ++t) {
        const int st = t & 1;
        const uint32_t parity = (t >> 1) & 1;
        const int kt = kt0 + j * BN;

        // ---- S = Q K^T (f32 accumulators); the item's last product of Q
        // frees its buffer for the next item's
        hop::mbar_wait(&s.k_full[st], parity);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk >> 2, off = (kk & 3) * 32;
          const uint64_t da =
              hop::desc_sw128(qs + c * (BM * 128) + off, 16, 1024);
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
        if (j == ntiles - 1 && lane == 0) hop::mbar_arrive(&s.q_empty[qb]);

        // ---- masks, only on a tile that crosses lo or hi (uniform over
        // the CTA: every row attends the same positions)
#pragma unroll
        for (int e = 0; e < 64; ++e) sc[e] *= scale_log2;
        if (kt < lo || kt + BN > hi) {
#pragma unroll
          for (int jj = 0; jj < 16; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kp = kt + 8 * jj + 2 * (lane & 3) + (e & 1);
              if (kp < lo || kp >= hi) sc[4 * jj + e] = -INFINITY;
            }
        }

        // ---- online softmax on the registers (base 2)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = m_i[hh];
#pragma unroll
          for (int jj = 0; jj < 16; ++jj)
            mx = fmaxf(mx,
                       fmaxf(sc[4 * jj + 2 * hh], sc[4 * jj + 2 * hh + 1]));
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

        // ---- O += P V: P as two bf16 A fragments (P = hi + lo), V
        // MN-major
        uint32_t ph[32], pl[32];
#pragma unroll
        for (int e = 0; e < 32; ++e)
          hop::split_bf16(sc[2 * e], sc[2 * e + 1], ph[e], pl[e]);
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

      // ---- epilogue: the raw partials. The quad's row sums; m back to
      // natural-log units.
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float l = l_i[hh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int r = row0 + 8 * hh;
        if (r >= R) continue;
        const size_t o = bh * R + r;
        float* ab = acc_out + o * D;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<float2*>(ab + 8 * jj + 2 * (lane & 3)) =
              make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
        if ((lane & 3) == 0) {
          m_out[o] = m_i[hh] * LN2;
          l_out[o] = l;
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const int* tables, const int* lengths, const int* q_pos,
                   float* acc, float* m, float* l, int B, int Hkv, int R,
                   int L, int NBtot, int blk, int NB, int li, int window,
                   cudaStream_t st) {
  if (blk % 8 || (BN % blk && blk % BN)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(pool_k) |
       reinterpret_cast<uintptr_t>(pool_v) | reinterpret_cast<uintptr_t>(acc)) &
      15)
    return cudaErrorMisalignedAddress;
  const int br = blk < BN ? blk : BN;   // pool rows a box
  CUtensorMap qmap, kmap, vmap;
  const cuuint64_t qdims[3] = {(cuuint64_t)D, (cuuint64_t)R,
                               (cuuint64_t)B * Hkv};
  const cuuint64_t qstr[2] = {(cuuint64_t)D * 2, (cuuint64_t)R * D * 2};
  const cuuint32_t qbox[3] = {64, BM, 1};
  const cuuint64_t pdims[3] = {(cuuint64_t)D, (cuuint64_t)blk,
                               (cuuint64_t)L * NBtot * Hkv};
  const cuuint64_t pstr[2] = {(cuuint64_t)D * 2, (cuuint64_t)blk * D * 2};
  const cuuint32_t pbox[3] = {64, (cuuint32_t)br, 1};
  cudaError_t e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q,
                                qdims, qstr, qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = hop::make_map(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, pool_k,
                      pdims, pstr, pbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = hop::make_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, pool_v,
                      pdims, pstr, pbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<D>();
  e = cudaFuncSetAttribute(paged_wgmma<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  // about one CTA an SM, each walking every gridDim.x-th item
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const long long items = (long long)B * Hkv * ((R + BM - 1) / BM);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;
  paged_wgmma<D><<<grid, NTHREADS, smem, st>>>(
      qmap, kmap, vmap, tables, lengths, q_pos, acc, m, l, B, Hkv, R, NBtot,
      blk, NB, li, window, br, scale_log2);
  return cudaGetLastError();
}

}  // namespace k3s
