// K3: paged flash-partial attention for Hopper (sm_90a), CUDA C++ with a
// plain C interface (built by ops/_build.py, bound with ctypes by
// ops/paged_attention.py).
//
// Replaces: copilot_for_consensus_tpu/ops/paged_attention.py,
//   `paged_attention_partial_pallas` (pallas_call) and its body
//   `_paged_partial_kernel`.
//
// Contract (same as the TPU kernel): q_rows [B, Hkv, R, D] f32 or bf16; the
// stacked pool halves [L, NBtot, Hkv, blk, D] in f32, bf16 or fp8 e4m3; a
// layer index li; block tables [B, NB] int32; lengths and q_pos [B] int32.
// Position p of slot b lives in pool block tables[b, p / blk] at offset
// p % blk of layer li. For each (b, kv head h) and each of the R rows, an
// online softmax over the positions p < lengths[b] (and, when window > 0,
// p > q_pos[b] - window) of scores (q.k) * D^-0.5 in f32, K and V converted
// to f32 on load. Outputs, all f32: acc = sum exp(s - m) v [B, Hkv, R, D],
// the max m and l = sum exp(s - m) [B, Hkv, R, 1]. A row masked everywhere
// gives m = -inf, l = 0, acc = 0 and never NaN (the TPU kernel's m_safe /
// alpha guards).
//
// What bounds it on this card: two regimes, each with its own body for the
// main path's bf16 q_rows and bf16 pool at D 64/128 (the wrapper picks one
// by `paged_body`; nothing falls back):
//   * Decode (R = group = 4, B = 8, Hkv = 8, D = 128, blk = 64): each K/V
//     byte is used by only 4 query rows, so the work is bound by the bytes
//     of the attended positions (~34 MB a layer at ~1050 positions, ~10 us
//     at 3.35 TB/s). `paged_attention_decode_fwd` runs the split-KV body of
//     paged_decode.cuh (R <= 16): the table split over CTAs, 64 positions
//     a CTA in flight, all R rows in one pass, a fixed-order merge.
//   * Seeded admission (R = group * S, S up to 1024): also bound by bytes
//     at the main path's shapes (the f32 acc it writes and the q it reads
//     outweigh the K/V), but its products cost more than those bytes on
//     the CUDA cores' f32 rate. `paged_attention_seeded_fwd` runs the
//     wgmma body of paged_wgmma.cuh (R > 16): K1's Hopper flash partial,
//     its K/V boxes addressed through the table.
//   * The f32 and fp8 pools, f32 q_rows and D 32 (test and off-path
//     layouts: the engine's KV is its activation dtype) take the CUDA-core
//     body below, `paged_attention_fwd`.
//
// Design of the CUDA-core body. The TPU walked the table entries as a
// sequential grid axis with (m, l, acc) in VMEM scratch and the table in
// scalar prefetch. Here one block owns a (b, h, row tile) and loops over
// the slot's positions itself, reading the table and lengths[b] from
// memory, with f32 FMAs (67 TFLOP/s at most):
//   * the loop runs from the first 64-position tile the window can reach to
//     min(lengths[b], NB * blk): dead blocks are loop bounds, not masked
//     work (a parked slot's length can exceed what its table covers);
//   * every table id is clamped to [0, NBtot - 1] before it forms an address
//     (pad ids equal NBtot);
//   * a (layer, block, head) tile [blk, D] is contiguous in the pool; each
//     thread loads 16-byte chunks of the positions' rows, neighbouring
//     threads on neighbouring addresses, all of its chunks issued before
//     any is used, converts them to f32 (fp8 through cuda_fp8.h) and stages
//     K (rows padded by one word) and V in shared memory; with few rows the
//     next tile's chunks are in flight while the current tile computes;
//   * two row tilings share one body: RT = 8 rows (16 lanes a row, for
//     R <= 8) and RT = 64 rows (8 lanes own 4 rows, as K1), with the row
//     max and sum as xor shuffles inside each lane group;
//   * masked scores are -inf; probabilities of masked positions are zeroed
//     explicitly and exp(-inf - -inf) is never formed.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>

#include "paged_decode.cuh"
#include "paged_wgmma.cuh"

namespace {

constexpr int BK = 64;    // pool positions per kv tile
constexpr int NT = 128;   // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a pool row (raw) converted to N floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void convert(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void convert(const uint4& raw, float* out) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of the f32 with the same value
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ static void convert(const uint4& raw, float* out) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      __nv_fp8_e4m3 x;
      x.__x = static_cast<__nv_fp8_storage_t>((w[i / 4] >> (8 * (i % 4))) &
                                              0xffu);
      out[i] = static_cast<float>(x);
    }
  }
};

template <int D, int RPT, int LPR>
constexpr size_t smem_bytes() {
  constexpr int RT = RPT * (NT / LPR);
  return sizeof(float) *
         (size_t)(RT * (D + 1) + BK * (D + 1) + BK * D + RT * (BK + 1));
}

template <typename TQ, typename TKV, int D, int RPT, int LPR>
__global__ void __launch_bounds__(NT)
paged_partial_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
                     const TKV* __restrict__ pool_v,
                     const int* __restrict__ tables,
                     const int* __restrict__ lengths,
                     const int* __restrict__ q_pos, float* __restrict__ acc_out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Hkv, int R, int NBtot, int blk, int NB, int li,
                     int window, float scale) {
  constexpr int RT = RPT * (NT / LPR);   // query rows per block
  constexpr int SC = BK / LPR;           // score columns per lane
  constexpr int OC = D / LPR;            // output columns per lane
  constexpr int DP = D + 1;              // padded f32 row of Q and K
  constexpr int PP = BK + 1;             // padded row of P
  constexpr int VE = Vec<TKV>::N;        // pool elements per 16 bytes
  constexpr int CH = D / VE;             // 16-byte chunks per pool row
  extern __shared__ float smem[];
  float* sQ = smem;              // [RT][DP]
  float* sK = sQ + RT * DP;      // [BK][DP]
  float* sV = sK + BK * DP;      // [BK][D]
  float* sP = sV + BK * D;       // [RT][PP]

  const int row0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r0 = (tid / LPR) * RPT;   // first of my rows in the tile
  const int tc = tid % LPR;           // my column lane
  const size_t bh = (size_t)b * Hkv + h;

  const TQ* qb = q + bh * R * D;
  for (int i = tid; i < RT * D; i += NT) {
    const int r = i / D, c = i % D;
    sQ[r * DP + c] =
        (row0 + r < R) ? to_f(qb[(size_t)(row0 + r) * D + c]) : 0.f;
  }

  // positions this slot attends: [lo, hi)
  const int hi = min(lengths[b], NB * blk);
  const int lo = window > 0 ? max(0, q_pos[b] - window + 1) : 0;
  const int* tbl = tables + (size_t)b * NB;
  const size_t layer0 = (size_t)li * NBtot;

  float m_i[RPT], l_i[RPT], acc[RPT][OC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // Each thread moves ITER 16-byte chunks of a tile (K and V alike), all
  // issued before any is stored. The decode tiling (RPT == 1) keeps the
  // next tile's chunks in flight in registers while it computes on this
  // one; the 64-row tiling, bound by arithmetic, loads in batches of 8.
  constexpr int ITER = BK * CH / NT;
  constexpr bool PREFETCH = RPT == 1;
  constexpr int NBATCH = PREFETCH ? ITER : (ITER < 8 ? ITER : 8);
  auto fetch = [&](int kt, int it, uint4& k4, uint4& v4) {
    const int i = tid + it * NT;
    const int p = kt + i / CH;
    if (p < hi) {
      const int bid = min(max(__ldg(tbl + p / blk), 0), NBtot - 1);
      const size_t off = (((layer0 + bid) * Hkv + h) * blk + p % blk) * D +
                         (i % CH) * VE;
      k4 = __ldg(reinterpret_cast<const uint4*>(pool_k + off));
      v4 = __ldg(reinterpret_cast<const uint4*>(pool_v + off));
    } else {
      k4 = v4 = make_uint4(0u, 0u, 0u, 0u);   // zero bits: 0.0 in every type
    }
  };
  auto stash = [&](int it, const uint4& k4, const uint4& v4) {
    const int i = tid + it * NT;
    const int r = i / CH, c = (i % CH) * VE;
    float f[VE];
    Vec<TKV>::convert(k4, f);
#pragma unroll
    for (int e = 0; e < VE; ++e) sK[r * DP + c + e] = f[e];
    Vec<TKV>::convert(v4, f);
#pragma unroll
    for (int e = 0; e < VE; ++e) sV[r * D + c + e] = f[e];
  };

  const int kt0 = (lo / BK) * BK;
  uint4 nk[NBATCH], nv[NBATCH];
  if (PREFETCH && kt0 < hi) {
#pragma unroll
    for (int it = 0; it < NBATCH; ++it) fetch(kt0, it, nk[it], nv[it]);
  }
  for (int kt = kt0; kt < hi; kt += BK) {
    __syncthreads();   // Q staged / previous tile fully consumed
    if constexpr (PREFETCH) {
#pragma unroll
      for (int it = 0; it < ITER; ++it) stash(it, nk[it], nv[it]);
      if (kt + BK < hi) {
#pragma unroll
        for (int it = 0; it < ITER; ++it) fetch(kt + BK, it, nk[it], nv[it]);
      }
    } else {
#pragma unroll
      for (int it0 = 0; it0 < ITER; it0 += NBATCH) {
#pragma unroll
        for (int j = 0; j < NBATCH; ++j) fetch(kt, it0 + j, nk[j], nv[j]);
#pragma unroll
        for (int j = 0; j < NBATCH; ++j) stash(it0 + j, nk[j], nv[j]);
      }
    }
    __syncthreads();

    float s[RPT][SC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kk[SC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(r0 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) kk[j] = sK[(tc + LPR * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      unsigned long long ok = 0;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int p = kt + tc + LPR * j;
        const bool a = p >= lo && p < hi;
        ok |= (unsigned long long)a << j;
        s[i][j] = a ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m_i[i] == -INFINITY ? 0.f : expf(m_i[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = ((ok >> j) & 1ull) ? expf(s[i][j] - m_safe) : 0.f;
        rs += p;
        sP[(r0 + i) * PP + tc + LPR * j] = p;
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();   // P rows are written and read inside one lane group

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(r0 + i) * PP + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float v = sV[j * D + tc + LPR * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], v, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + r0 + i;
    if (row >= R) continue;
    const size_t o = bh * R + row;
    float* ab = acc_out + o * D;
#pragma unroll
    for (int c = 0; c < OC; ++c) ab[tc + LPR * c] = acc[i][c];
    if (tc == 0) {
      m_out[o] = m_i[i];
      l_out[o] = l_i[i];
    }
  }
}

struct Args {
  const void *q, *pool_k, *pool_v;
  const int *tables, *lengths, *q_pos;
  float *acc, *m, *l;
  int B, Hkv, R, NBtot, blk, NB, li, window;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int RPT, int LPR>
cudaError_t launch(const Args& a) {
  constexpr int RT = RPT * (NT / LPR);
  const size_t smem = smem_bytes<D, RPT, LPR>();
  cudaError_t e = cudaFuncSetAttribute(
      paged_partial_kernel<TQ, TKV, D, RPT, LPR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((a.R + RT - 1) / RT, a.Hkv, a.B);
  paged_partial_kernel<TQ, TKV, D, RPT, LPR><<<grid, NT, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.pool_k),
      static_cast<const TKV*>(a.pool_v), a.tables, a.lengths, a.q_pos, a.acc,
      a.m, a.l, a.Hkv, a.R, a.NBtot, a.blk, a.NB, a.li, a.window, scale);
  return cudaGetLastError();
}

// R <= 8 (decode): 8-row tiles, 16 lanes a row; otherwise 64-row tiles.
template <typename TQ, typename TKV, int D>
cudaError_t dispatch_rows(const Args& a) {
  if (a.R <= 8) return launch<TQ, TKV, D, 1, 16>(a);
  return launch<TQ, TKV, D, 4, 8>(a);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 32:
      return dispatch_rows<TQ, TKV, 32>(a);
    case 64:
      return dispatch_rows<TQ, TKV, 64>(a);
    case 128:
      return dispatch_rows<TQ, TKV, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_kind, int D, const Args& a) {
  switch (kv_kind) {
    case 0:
      return dispatch_d<TQ, float>(D, a);
    case 1:
      return dispatch_d<TQ, __nv_bfloat16>(D, a);
    case 2:
      return dispatch_d<TQ, __nv_fp8_e4m3>(D, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_kind: 0 = f32, 1 = bf16, 2 = fp8 e4m3 pools; q_bf16: q_rows in bf16.
extern "C" int paged_attention_fwd(const void* q, const void* pool_k,
                                   const void* pool_v, const void* tables,
                                   const void* lengths, const void* q_pos,
                                   void* acc, void* m, void* l, int B, int Hkv,
                                   int R, int D, int L, int NBtot, int blk,
                                   int NB, int li, int window, int q_bf16,
                                   int kv_kind, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || R <= 0 ||
      NBtot <= 0 || blk <= 0 || NB <= 0 || li < 0 || li >= L)
    return (int)cudaErrorInvalidValue;
  const Args a{q,
               pool_k,
               pool_v,
               static_cast<const int*>(tables),
               static_cast<const int*>(lengths),
               static_cast<const int*>(q_pos),
               static_cast<float*>(acc),
               static_cast<float*>(m),
               static_cast<float*>(l),
               B,
               Hkv,
               R,
               NBtot,
               blk,
               NB,
               li,
               window,
               static_cast<cudaStream_t>(stream)};
  if (q_bf16) return (int)dispatch_kv<__nv_bfloat16>(kv_kind, D, a);
  return (int)dispatch_kv<float>(kv_kind, D, a);
}

// the split-KV decode body (bf16 q_rows and pool, D 64/128, R <= 16): the
// same arguments plus the f32 scratch of the splits' partials, part_acc
// [B, Hkv, NS, R, D] and part_ml [B, Hkv, NS, R, 2], and the split length
// in positions (NS = ceil(NB * blk / split_len))
extern "C" int paged_attention_decode_fwd(
    const void* q, const void* pool_k, const void* pool_v, const void* tables,
    const void* lengths, const void* q_pos, void* acc, void* m, void* l,
    void* part_acc, void* part_ml, int B, int Hkv, int R, int D, int L,
    int NBtot, int blk, int NB, int li, int window, int split_len, int NS,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hkv > 65535 || R <= 0 || R > 16 || NBtot <= 0 ||
      blk <= 0 || NB <= 0 || li < 0 || li >= L || split_len <= 0 ||
      NS != (NB * blk + split_len - 1) / split_len)
    return (int)cudaErrorInvalidValue;
  if (D != 128 && D != 64) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* qp = static_cast<const int*>(q_pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)k3d::launch<128>(
        q, pool_k, pool_v, tb, ln, qp, static_cast<float*>(acc),
        static_cast<float*>(m), static_cast<float*>(l), pa, pm, B, Hkv, R,
        NBtot, blk, NB, li, window, split_len, NS, st);
  return (int)k3d::launch<64>(
      q, pool_k, pool_v, tb, ln, qp, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), pa, pm, B, Hkv, R,
      NBtot, blk, NB, li, window, split_len, NS, st);
}

// the wgmma seeded body (bf16 q_rows and pool, D 64/128, R > 16): the
// arguments of paged_attention_fwd without the dtypes
extern "C" int paged_attention_seeded_fwd(
    const void* q, const void* pool_k, const void* pool_v, const void* tables,
    const void* lengths, const void* q_pos, void* acc, void* m, void* l,
    int B, int Hkv, int R, int D, int L, int NBtot, int blk, int NB, int li,
    int window, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || R <= 0 ||
      NBtot <= 0 || blk <= 0 || NB <= 0 || li < 0 || li >= L)
    return (int)cudaErrorInvalidValue;
  if (D != 128 && D != 64) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)k3s::launch<128>(
        q, pool_k, pool_v, tb, ln, qp, static_cast<float*>(acc),
        static_cast<float*>(m), static_cast<float*>(l), B, Hkv, R, L, NBtot,
        blk, NB, li, window, st);
  return (int)k3s::launch<64>(
      q, pool_k, pool_v, tb, ln, qp, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), B, Hkv, R, L, NBtot,
      blk, NB, li, window, st);
}

// the seeded body's dynamic shared memory a CTA at head dim D, in bytes
extern "C" int paged_attention_seeded_smem(int D) {
  return D == 64 ? (int)k3s::smem_bytes<64>() : (int)k3s::smem_bytes<128>();
}

extern "C" const char* paged_attention_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
