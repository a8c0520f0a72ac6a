// K3's decode regime (bf16 q_rows and bf16 pool, D 64/128, R <= 16 rows a
// kv head: the grouped queries of one token) as a split-KV pass over the
// block table and a merge. Included by paged_attention.cu; the f32 and
// fp8 pools and D 32 keep the CUDA-core body there, R > 16 takes the wgmma
// body of paged_wgmma.cuh.
//
// Replaces: copilot_for_consensus_tpu/ops/paged_attention.py,
//   `paged_attention_partial_pallas` (pallas_call) and its body
//   `_paged_partial_kernel`, at decode's few rows.
//
// What bounds it on this card: each K/V byte serves only R = 4 query rows
// (~2 flops a byte), so the work is bound by the bytes of the attended
// positions (~34 MB a layer at ~1050 positions a slot: ~10 us at 3.35
// TB/s). The earlier body walked a slot's whole chain of 64-position tiles
// in one 128-thread block (one block a (slot, head): 64 blocks for 132
// SMs, ~6.5 us a tile), so the longest slot set the time. The design is
// about bytes in flight:
//   * Split-KV: the grid is splits x Hkv x (B x row groups), a split being
//     `split_len` positions (a fixed count of whole pool blocks, chosen by
//     the wrapper). A CTA whose positions lie wholly past lengths[b] (or
//     past the table's reach), or wholly before the window's first
//     position, exits at once. The grid comes from the table's width,
//     which the host knows: no host read of lengths or q_pos.
//   * Each of the CTA's 8 (D 128) or 16 (D 64) lane groups owns one pool
//     row at a time, D / 8 lanes of 16 bytes each, so a warp reads whole
//     256-byte (or 128-byte) rows of neighbouring positions. A thread
//     issues NP K and NP V loads before it uses any: 64 positions (32 KB)
//     of a CTA in flight, two or three CTAs an SM, against the ~25 KB an SM
//     needs in flight at 3.35 TB/s.
//   * All R rows in one pass (RT = 4, or 8 rows a row group past 4), on
//     the CUDA cores with f32 statistics: a dot product reduces over the
//     lane group by xor shuffles, the softmax is online over the group's
//     positions, and the groups' states meet in shared memory at the end.
//     There is no tile of zero rows.
//   * A second pass merges each (slot, head)'s live splits in a fixed order
//     (ascending), deterministic and without atomics, from an f32 scratch
//     the wrapper makes with torch.empty, and writes the contract's three
//     outputs. A split is live when its positions meet [lo, hi); the merge
//     takes the same splits (a slot's live splits are contiguous), so a
//     dead CTA writes nothing.
//   * Every table id is clamped to [0, NBtot - 1] before it forms an
//     address; a parked slot (length past what its table covers) reads
//     its table's reach, spread over the splits like any other slot's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace k3d {

constexpr int NT = 128;   // threads a CTA

// 8 bf16 (16 bytes) -> 8 f32: a bf16 is the high half of the same f32
__device__ __forceinline__ void bf16x8(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the positions [s0, s1) split `split` attends of a slot that attends
// [lo, hi)
__device__ __forceinline__ void split_range(int split, int split_len, int lo,
                                            int hi, int& s0, int& s1) {
  s0 = max(split * split_len, lo);
  s1 = min((split + 1) * split_len, hi);
}

// one CTA: positions of one split, one kv head, RT rows of one slot.
// Partials: acc [B, Hkv, NS, R, D], (m, l) [B, Hkv, NS, R, 2], f32.
template <int D, int RT, int NP>
__global__ void __launch_bounds__(NT)
paged_split(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ pool_k,
            const __nv_bfloat16* __restrict__ pool_v,
            const int* __restrict__ tables, const int* __restrict__ lengths,
            const int* __restrict__ q_pos, float* __restrict__ part_acc,
            float* __restrict__ part_ml, int Hkv, int R, int NBtot, int blk,
            int NB, int li, int window, int split_len, int NS, float scale) {
  constexpr int LPR = D / 8;             // lanes a pool row, 16 bytes each
  constexpr int PPW = 32 / LPR;          // rows a warp-wide load
  constexpr int NG = (NT / 32) * PPW;    // lane groups a CTA
  constexpr int PIT = NG * NP;           // positions a CTA iteration
  __shared__ float sm_ml[NG][RT][2];
  __shared__ __align__(16) float sm_acc[NG][RT][D];

  const int split = blockIdx.x, h = blockIdx.y;
  const int groups = (R + RT - 1) / RT;
  const int b = blockIdx.z / groups, rg = blockIdx.z % groups;
  const int hi = min(lengths[b], NB * blk);
  const int lo = window > 0 ? max(0, q_pos[b] - window + 1) : 0;
  int s0, s1;
  split_range(split, split_len, lo, hi, s0, s1);
  if (s0 >= s1) return;   // nothing attended here: the merge skips it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp * PPW + lane / LPR;   // my lane group
  const int dc = (lane % LPR) * 8;           // my 8 columns
  const size_t bh = (size_t)b * Hkv + h;

  float qf[RT][8];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = rg * RT + r;
    if (row < R) {
      bf16x8(__ldg(reinterpret_cast<const uint4*>(q + (bh * R + row) * D +
                                                  dc)),
             qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[r][e] = 0.f;
    }
  }

  float m_i[RT], l_i[RT], acc[RT][8];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  const int* tbl = tables + (size_t)b * NB;
  const size_t slab0 = (size_t)li * NBtot;
  // the first iteration that reaches s0 (whole dead iterations before the
  // window's start are skipped)
  int base = split * split_len;
  base += ((s0 - base) / PIT) * PIT;
  for (; base < s1; base += PIT) {
    uint4 kr[NP], vr[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = base + i * NG + grp;
      if (p >= s0 && p < s1) {
        const int id = min(max(__ldg(tbl + p / blk), 0), NBtot - 1);
        const size_t off =
            (((slab0 + id) * Hkv + h) * blk + p % blk) * D + dc;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(pool_k + off));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(pool_v + off));
      } else {
        kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // scores: my 8 columns' share of each dot product, summed over the
    // lane group
    float s[RT][NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float kf[8];
      bf16x8(kr[i], kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[r][e], kf[e], d);
        s[r][i] = d;
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int i = 0; i < NP; ++i)
          s[r][i] += __shfl_xor_sync(0xffffffffu, s[r][i], o);

    // online softmax over my group's NP positions; masked scores are -inf
    // and their probabilities exactly 0
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int p = base + i * NG + grp;
        s[r][i] = (p >= s0 && p < s1) ? s[r][i] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][i]);
      }
      const float m_new = fmaxf(m_i[r], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m_i[r] == -INFINITY ? 0.f : expf(m_i[r] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float pr = s[r][i] == -INFINITY ? 0.f : expf(s[r][i] - m_safe);
        s[r][i] = pr;
        rs += pr;
      }
      l_i[r] = alpha * l_i[r] + rs;
      m_i[r] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float vf[8];
      bf16x8(vr[i], vf);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(s[r][i], vf[e], acc[r][e]);
    }
  }

  // the groups' states meet in shared memory; one weighted sum a (row,
  // column), groups in ascending order
  if (lane % LPR == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      sm_ml[grp][r][0] = m_i[r];
      sm_ml[grp][r][1] = l_i[r];
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float4* dst = reinterpret_cast<float4*>(&sm_acc[grp][r][dc]);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  for (int idx = tid; idx < RT * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = rg * RT + r;
    if (row >= R) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, sm_ml[g][r][0]);
    const float m_safe = mx == -INFINITY ? 0.f : mx;
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float mg = sm_ml[g][r][0];
      const float w = mg == -INFINITY ? 0.f : expf(mg - m_safe);
      a = fmaf(w, sm_acc[g][r][d], a);
      l = fmaf(w, sm_ml[g][r][1], l);
    }
    const size_t o = (bh * NS + split) * R + row;
    part_acc[o * D + d] = a;
    if (d == 0) {
      part_ml[2 * o] = mx;
      part_ml[2 * o + 1] = l;
    }
  }
}

// the second pass: one CTA a (slot, head), four columns a thread, the live
// splits in ascending order (they are contiguous: those from lo's split to
// the split of hi - 1); writes acc [B, Hkv, R, D], m and l [B, Hkv, R]
template <int D>
__global__ void __launch_bounds__(NT)
paged_merge(const float* __restrict__ part_acc,
            const float* __restrict__ part_ml,
            const int* __restrict__ lengths, const int* __restrict__ q_pos,
            float* __restrict__ acc_out, float* __restrict__ m_out,
            float* __restrict__ l_out, int Hkv, int R, int blk, int NB,
            int window, int split_len, int NS) {
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / Hkv);
  const int hi = min(lengths[b], NB * blk);
  const int lo = window > 0 ? max(0, q_pos[b] - window + 1) : 0;
  const int first = lo / split_len;
  const int end = hi > lo ? (hi - 1) / split_len + 1 : first;
  for (int idx = threadIdx.x; idx < R * D / 4; idx += NT) {
    const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
    float mx = -INFINITY;
#pragma unroll 4
    for (int sp = first; sp < end; ++sp)
      mx = fmaxf(mx, part_ml[2 * ((bh * NS + sp) * R + r)]);
    const float m_safe = mx == -INFINITY ? 0.f : mx;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll 4
    for (int sp = first; sp < end; ++sp) {
      const size_t o = (bh * NS + sp) * R + r;
      const float ms = part_ml[2 * o];
      const float w = ms == -INFINITY ? 0.f : expf(ms - m_safe);
      const float4 pa = *reinterpret_cast<const float4*>(part_acc + o * D + d);
      a.x = fmaf(w, pa.x, a.x);
      a.y = fmaf(w, pa.y, a.y);
      a.z = fmaf(w, pa.z, a.z);
      a.w = fmaf(w, pa.w, a.w);
      l = fmaf(w, part_ml[2 * o + 1], l);
    }
    *reinterpret_cast<float4*>(acc_out + (bh * R + r) * D + d) = a;
    if (d == 0) {
      m_out[bh * R + r] = mx;
      l_out[bh * R + r] = l;
    }
  }
}

template <int D, int RT, int NP>
cudaError_t launch_rt(const void* q, const void* pool_k, const void* pool_v,
                      const int* tables, const int* lengths, const int* q_pos,
                      float* acc, float* m, float* l, float* part_acc,
                      float* part_ml, int B, int Hkv, int R, int NBtot,
                      int blk, int NB, int li, int window, int split_len,
                      int NS, cudaStream_t st) {
  const int groups = (R + RT - 1) / RT;
  if ((long long)B * groups > 65535) return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  paged_split<D, RT, NP><<<dim3(NS, Hkv, B * groups), NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), tables, lengths, q_pos,
      part_acc, part_ml, Hkv, R, NBtot, blk, NB, li, window, split_len, NS,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_merge<D><<<B * Hkv, NT, 0, st>>>(part_acc, part_ml, lengths, q_pos,
                                         acc, m, l, Hkv, R, blk, NB, window,
                                         split_len, NS);
  return cudaGetLastError();
}

// R <= 4: one row group of 4, 8 positions a lane group an iteration;
// otherwise row groups of 8 with 4 positions (the registers of 8 rows)
template <int D>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const int* tables, const int* lengths, const int* q_pos,
                   float* acc, float* m, float* l, float* part_acc,
                   float* part_ml, int B, int Hkv, int R, int NBtot, int blk,
                   int NB, int li, int window, int split_len, int NS,
                   cudaStream_t st) {
  if (R <= 4)
    return launch_rt<D, 4, 8>(q, pool_k, pool_v, tables, lengths, q_pos, acc,
                              m, l, part_acc, part_ml, B, Hkv, R, NBtot, blk,
                              NB, li, window, split_len, NS, st);
  return launch_rt<D, 8, 4>(q, pool_k, pool_v, tables, lengths, q_pos, acc,
                            m, l, part_acc, part_ml, B, Hkv, R, NBtot, blk,
                            NB, li, window, split_len, NS, st);
}

}  // namespace k3d
