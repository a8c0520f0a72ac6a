// K6's stream body (M <= 32: every a8 int4 decode projection and the
// lm_head of an a8 decode step or admission wave) as a Hopper weight
// stream: TMA keeps the packed weight and xq's rows in flight through a
// ring of mbarrier stages, and the weight, unpacked to int8 in registers,
// is the register-fed A operand of int8 mma.sync. One launch after
// `quantize_rows`. Included by w4a8_matmul.cu; the tiled extents (M > 32)
// keep w4a8_wgmma.cuh, and layouts this body refuses keep the split qgemm
// of quant_mma.cuh.
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `w4a8_matmul`
//   (pallas_call) and its body `_kernel_w4a8`, at decode extents.
//
// What bounds it on this card: a decode step multiplies M <= 32 int8 rows
// of xq by the whole packed weight, ~4M operations per weight byte against
// the ~590 op/byte int8 ridge, so it is bound by reading the packed bytes
// once at 3.35 TB/s (w_gu 4096 x 28672: 58.7 MB, 17.5 us; an a8 decode
// step of Mistral-7B: 3.67 GB with scales, 1.10 ms). That needs ~25-40 KB
// of weight in flight on every SM, and the unpacking must stay a few
// integer operations a byte between the loads and the products.
// The design (K5's stream body, int4_stream.cuh, on int8 products):
//   * Swapped operands: out^T[F, M] = W^T xq^T with mma.sync m16n8k32 s8
//     -> s32. The weight is A (16 F columns x 32 k), the tokens are n8
//     tiles (NT = ceil(M / 8) of them, rows past M zero-filled by TMA). A
//     B fragment is four consecutive k bytes of one token row, so xq's
//     fragments come by ldmatrix (.b16) from the stage's [8 NT tokens, 128
//     k] slice, one 128-byte line a token.
//   * The A fragment: register a0 of lane (g, t) holds fragment row g at
//     k 4t .. 4t + 3, which lie in packed rows 2t and 2t + 1 (a packed byte
//     is one k-pair of one column); a2 the same at k + 16, rows 2t + 8 and
//     2t + 9. A thread loads one 32-bit word (four adjacent columns) from
//     each of those four rows of a k32 slice: four shared loads give the
//     registers of two m16 tiles. Fragment row (tile T, row g + 8h) is
//     byte 2T + h of its words: column 16c + 4(g % 4) + 2T + h of the
//     warp's chunk c (below). The epilogue stores each token's four
//     columns at once (8 bytes in bf16, 16 in f32).
//   * Nibbles to signed bytes in integer operations, four a word with no
//     borrow between bytes, as the wgmma body unpacks them
//     (`qmma::nibble_quads`): ten operations give two A registers.
//   * Stages: one producer warp (one thread) keeps four stages in flight,
//     each 64 packed rows x 128 columns of q4 (8 KB, TMA 128-byte swizzle)
//     and xq's [8 NT tokens, 128 k] slice (one box, same swizzle). Four
//     consumer warps own 32 adjacent columns each and release a stage with
//     one mbarrier arrive a warp, never a block barrier. Warp w takes
//     16-byte chunks 2w and 2w + 1 of every 128-byte line, so a load's
//     four even (or odd) packed rows, XOR'd into the chunk index, land on
//     eight distinct chunks, 32 distinct banks; xq's ldmatrix rows are
//     eight tokens in distinct chunks. A deeper ring (six or eight
//     stages) measured no faster, and a variant that only streams the
//     stages (no unpack, no products) took most of the body's time: the
//     stream itself, not the unpack, is what stands between the body and
//     its bound.
//   * Group fold in registers, the reference's order: each scale group's
//     products start a fresh s32 accumulator, exact; after the group's
//     last stage, cvt.rn.f32.s32, __fmul_rn by the group's scale row (read
//     at the group's first stage), __fadd_rn into the split's f32 sum.
//   * Filling the card: 128-column tiles, two CTAs an SM, the contraction
//     split by whole groups only as far as a narrow F needs (the wrapper's
//     `stream_plan`, which K5 shares: the packed layout is K5's). Split
//     partials go to an f32 workspace [splits, M, F]; the last CTA of a
//     column tile (a counter a tile, reset by that CTA) sums them in split
//     order, multiplies by sx (__fmul_rn) and rounds once to x's dtype:
//     one launch for the product, no float atomics, and operation for
//     operation the plain version `w4a8_matmul_stream_ref`, so the two are
//     equal bit for bit.
// It takes M <= 32, group % 128 (whole stages) and F % 16 (TMA's 16-byte
// row pitch), 16-byte aligned operands; the wrapper sends other layouts
// to the split qgemm. x's dtype changes only the store.

#pragma once

#include "hopper.cuh"
#include "quant_mma.cuh"

namespace k6s {

constexpr int TN = 128;                  // output columns a CTA
constexpr int KS = 128;                  // k a stage: one line of xq
constexpr int KP = KS / 2;               // packed rows a stage
constexpr int STAGES = 4;                // TMA ring depth
constexpr int NCW = TN / 32;             // consumer warps, 32 columns each
constexpr int NTHREADS = (NCW + 1) * 32; // + the producer warp
constexpr uint32_t W_BYTES = KP * TN;    // 8 KB of packed weight a stage

template <int NT>
struct Smem {
  alignas(1024) uint8_t w[STAGES][W_BYTES];
  // [8 NT tokens][128 k] int8, 128-byte lines
  alignas(1024) uint8_t x[STAGES][NT * 8 * KS];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  int last;
};

template <int NT>
constexpr size_t smem_bytes() {
  return sizeof(Smem<NT>) + 1024;   // + alignment slack
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four adjacent outputs of one token, times sx, rounded once
__device__ __forceinline__ void store4(float* p, float4 v, float s) {
  *reinterpret_cast<float4*>(p) =
      make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                  __fmul_rn(v.w, s));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, float s) {
  const __nv_bfloat162 lo =
      __floats2bfloat162_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
  const __nv_bfloat162 hi =
      __floats2bfloat162_rn(__fmul_rn(v.z, s), __fmul_rn(v.w, s));
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// grid (column tiles, splits); split y takes groups [y per, (y + 1) per)
template <int NT, typename OutT>
__global__ void __launch_bounds__(NTHREADS, 2)
w4a8_stream(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap qmap,
            const float* __restrict__ scale, const float* __restrict__ sx,
            OutT* __restrict__ out, float* __restrict__ ws,
            int* __restrict__ counters, int M, int F, int G, int group,
            int per) {
  constexpr uint32_t X_BYTES = NT * 8 * KS;    // xq's slice a stage
  extern __shared__ uint8_t raw[];
  Smem<NT>& s = *reinterpret_cast<Smem<NT>*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * TN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int gsteps = group / KS;
  const int gb = split * per, ge = min(G, gb + per);
  const int kb = gb * gsteps;                  // first stage of the split
  const int nsteps = max(0, ge - gb) * gsteps;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&s.full[i], 1);
      hop::mbar_init(&s.empty[i], NCW);        // one arrive a consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == NCW) {
    // ---- producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % STAGES, k = kb + i;
        hop::mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&s.full[st], W_BYTES + X_BYTES);
        hop::tma_load_2d(s.w[st], &qmap, &s.full[st], n0, k * KP);
        hop::tma_load_2d(s.x[st], &xmap, &s.full[st], k * KS, 0);
      }
    }
    return;
  }

  // ---- consumers: warp w owns the 32 columns of chunks 2w and 2w + 1
  const int g = lane >> 2, t = lane & 3;
  const int c = 2 * warp + (g >> 2);           // 16-byte chunk of a line
  const int col = n0 + 16 * c + 4 * (g & 3);   // this thread's 4 columns
  // packed rows 2t and 2t + 1 of a k32 slice (16 rows), swizzled; rows
  // 2t + 8 and 2t + 9 are 1024 bytes further, in the same swizzle phase
  const uint32_t aoff0 = 2 * t * 128 + ((c ^ (2 * t)) << 4) + 4 * (g & 3);
  const uint32_t aoff1 =
      (2 * t + 1) * 128 + ((c ^ (2 * t + 1)) << 4) + 4 * (g & 3);
  // ldmatrix: lane l gives row l % 8 of matrix l / 8; matrices (tile j,
  // k 0-15), (j, k 16-31), (j + 1, k 0-15), (j + 1, k 16-31) of a k32 step
  const int mi = lane >> 3, r8 = lane & 7;
  const uint32_t xrow = (uint32_t)(8 * (mi >> 1) + r8) * 128;

  int acc[2][NT][4];
  float facc[2][NT][4];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[T][j][e] = 0;
        facc[T][j][e] = 0.f;
      }
  float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < nsteps; ++i) {
    const int st = i % STAGES;
    if (i % gsteps == 0 && col < F)            // a group starts: its scales
      sv = __ldg(reinterpret_cast<const float4*>(
          scale + (size_t)(gb + i / gsteps) * F + col));
    hop::mbar_wait(&s.full[st], (i / STAGES) & 1);
    const uint8_t* wt = s.w[st];
    const uint32_t xb = hop::smem_u32(s.x[st]);
#pragma unroll
    for (int sub = 0; sub < KS / 32; ++sub) {
      const uint8_t* w32 = wt + sub * 2048;
      const uint32_t u0 = lds32(w32 + aoff0);           // row 2t
      const uint32_t u1 = lds32(w32 + aoff1);           // row 2t + 1
      const uint32_t u2 = lds32(w32 + 1024 + aoff0);    // row 2t + 8
      const uint32_t u3 = lds32(w32 + 1024 + aoff1);    // row 2t + 9
      uint32_t a[2][4];
      // tile T, rows g and g + 8: columns 2T and 2T + 1 of the words
      qmma::nibble_quads<0>(u0, u1, a[0][0], a[0][1]);
      qmma::nibble_quads<1>(u0, u1, a[1][0], a[1][1]);
      qmma::nibble_quads<0>(u2, u3, a[0][2], a[0][3]);   // at k + 16
      qmma::nibble_quads<1>(u2, u3, a[1][2], a[1][3]);
      // B: xq's k32 slice, 16-byte chunks 2 sub and 2 sub + 1
      const uint32_t xaddr =
          xb + xrow + (((2 * sub + (mi & 1)) ^ r8) << 4);
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2)
        hop::ldsm_x4(xaddr + j * 8 * 128, b[j][0], b[j][1], b[j + 1][0],
                     b[j + 1][1]);
      if constexpr (NT % 2 == 1)
        hop::ldsm_x2(xaddr + (NT - 1) * 8 * 128, b[NT - 1][0],
                     b[NT - 1][1]);
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          qmma::mma_s8(acc[T][j], a[T], b[j][0], b[j][1]);
    }
    // the stage was read through the generic proxy (ld.shared,
    // ldmatrix) and the producer's next TMA writes it through the
    // async proxy: order the reads before the release
    hop::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&s.empty[st]);

    if (i % gsteps == gsteps - 1) {
      // the group's exact partial, then its scale, then the running sum;
      // column offset 2T + h of fragment (tile T, row g + 8h)
      const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[T][j][e] = __fadd_rn(
                facc[T][j][e], __fmul_rn(__int2float_rn(acc[T][j][e]),
                                         sc[2 * T + (e >> 1)]));
            acc[T][j][e] = 0;
          }
    }
  }

  // ---- epilogue: token 8j + 2t + e, columns col .. col + 3
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t + e;
        if (m < M && col < F)
          store4(out + (size_t)m * F + col,
                 make_float4(facc[0][j][e], facc[0][j][2 + e], facc[1][j][e],
                             facc[1][j][2 + e]),
                 __ldg(sx + m));
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * t + e;
      if (m < M && col < F)
        *reinterpret_cast<float4*>(ws + ((size_t)split * M + m) * F + col) =
            make_float4(facc[0][j][e], facc[0][j][2 + e], facc[1][j][e],
                        facc[1][j][2 + e]);
    }
  // the last CTA of this column tile sums the splits in order
  __threadfence();
  hop::named_sync(1, NCW * 32);
  if (tid == 0)
    s.last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  hop::named_sync(1, NCW * 32);
  if (!s.last) return;
  __threadfence();
  // split by split, all of a split's loads in flight together: one L2
  // round trip a split, not one a token and split
  float4 v[NT][2];
  for (int p = 0; p < splits; ++p) {
    float4 u[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t + e;
        u[j][e] = (m < M && col < F)
                      ? __ldcg(reinterpret_cast<const float4*>(
                            ws + ((size_t)p * M + m) * F + col))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (p == 0) {
          v[j][e] = u[j][e];
        } else {
          v[j][e].x = __fadd_rn(v[j][e].x, u[j][e].x);
          v[j][e].y = __fadd_rn(v[j][e].y, u[j][e].y);
          v[j][e].z = __fadd_rn(v[j][e].z, u[j][e].z);
          v[j][e].w = __fadd_rn(v[j][e].w, u[j][e].w);
        }
      }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * t + e;
      if (m < M && col < F)
        store4(out + (size_t)m * F + col, v[j][e], __ldg(sx + m));
    }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next launch
}

template <int NT, typename OutT>
cudaError_t launch_nt(const CUtensorMap& xmap, const CUtensorMap& qmap,
                      const float* scale, const float* sx, OutT* out,
                      float* ws, int* counters, int M, int F, int G,
                      int group, int per, int splits, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<NT>();
  cudaError_t e = cudaFuncSetAttribute(
      w4a8_stream<NT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((F + TN - 1) / TN, splits);
  w4a8_stream<NT, OutT><<<grid, NTHREADS, smem, st>>>(
      xmap, qmap, scale, sx, out, ws, counters, M, F, G, group, per);
  return cudaGetLastError();
}

// the layouts this body takes (the wrapper's `w4a8_body` mirrors it)
static inline bool takes(int M, int D, int F, int G) {
  if (M < 1 || M > 32 || G < 1 || D % G) return false;
  return (D / G) % KS == 0 && F % 16 == 0;
}

// xq int8 [M, D] and sx f32 [M] (quantize_rows), q4 int8 [D/2, F], scale
// f32 [G, F] -> out [M, F] in OutT; the plan (tn, splits, per) from the
// wrapper; ws f32 [splits, M, F] and counters int32 [column tiles], all
// zero, when splits > 1
template <typename OutT>
static inline cudaError_t launch(const int8_t* xq, const int8_t* q4,
                                 const float* scale, const float* sx,
                                 OutT* out, float* ws, int* counters, int M,
                                 int D, int F, int G, int tn, int splits,
                                 int per, cudaStream_t st) {
  if (!takes(M, D, F, G) || tn != TN || splits < 1 || per < 1 ||
      (splits - 1) * per >= G || splits * per < G ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(q4) |
       reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(ws)) & 15)
    return cudaErrorMisalignedAddress;
  const int nt = (M + 7) / 8;
  CUtensorMap xmap, qmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)D};
  const cuuint32_t xbox[2] = {KS, (cuuint32_t)(8 * nt)};
  cudaError_t e = hop::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq,
                                xdims, xstr, xbox,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const cuuint64_t qdims[2] = {(cuuint64_t)F, (cuuint64_t)(D / 2)};
  const cuuint64_t qstr[1] = {(cuuint64_t)F};
  const cuuint32_t qbox[2] = {TN, KP};
  e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q4, qdims, qstr,
                    qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const int group = D / G;
  switch (nt) {
    case 1:
      return launch_nt<1>(xmap, qmap, scale, sx, out, ws, counters, M, F, G,
                          group, per, splits, st);
    case 2:
      return launch_nt<2>(xmap, qmap, scale, sx, out, ws, counters, M, F, G,
                          group, per, splits, st);
    case 3:
      return launch_nt<3>(xmap, qmap, scale, sx, out, ws, counters, M, F, G,
                          group, per, splits, st);
    default:
      return launch_nt<4>(xmap, qmap, scale, sx, out, ws, counters, M, F, G,
                          group, per, splits, st);
  }
}

// dynamic shared memory a CTA for NT token tiles (1-4)
static inline size_t smem_for(int nt) {
  switch (nt) {
    case 1: return smem_bytes<1>();
    case 2: return smem_bytes<2>();
    case 3: return smem_bytes<3>();
    default: return smem_bytes<4>();
  }
}

}  // namespace k6s
