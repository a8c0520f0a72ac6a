// K5's stream body (bf16 x, M <= 32: every int4 decode projection and the
// lm_head of a decode step) as a Hopper weight stream: TMA keeps the packed
// weight in flight through a ring of mbarrier stages, and the unpacked
// weight is the register-fed A operand of mma.sync. Included by
// int4_matmul.cu; the tiled extents (M > 32) keep int4_wgmma.cuh, and
// layouts this body refuses keep the split qgemm of quant_mma.cuh.
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `int4_matmul`
//   (pallas_call) and its body `_kernel4`, at decode extents.
//
// What bounds it on this card: a decode step multiplies M <= 32 rows of x
// by the whole packed weight, ~4M flops per weight byte against the ~295
// flop/byte bf16 ridge, so reading the packed bytes once at 3.35 TB/s is
// the bound (w_gu 4096 x 28672: 58.7 MB, 17.5 us). That needs ~25-40 KB
// of weight in flight on every SM, and the unpacking must not sit between
// the loads and the products. The design:
//   * Swapped operands: out^T[F, M] = W^T x^T with mma.sync m16n8k16 bf16
//     -> f32. The weight is A (16 F columns x 16 k), the tokens are n8
//     tiles (NT = ceil(M / 8) of them, rows past M zero-filled by TMA).
//     One packed byte (k-pair i, column n) is exactly one bf16x2 register
//     of an A fragment (low nibble k = 2i, high nibble 2i + 1), and one
//     32-bit word of a packed row holds four adjacent columns of one
//     k-pair. So a thread takes its rows g and g + 8 of two m16 tiles from
//     the four columns of one word: its A fragments for 2 tiles x k16 are
//     two 32-bit shared loads, with no transpose and no B tile. Fragment
//     row (tile T, row g + 8h) is F column 16c + 4(g % 4) + 2T + h of the
//     warp's chunk c (below); the epilogue stores each token's four
//     columns as one 8-byte word.
//   * Nibble to bf16 in integer operations, exactly: a byte permute puts
//     the byte's low nibble in bits 0-3 and its high nibble in bits 16-19,
//     one lop3 masks them and writes 0x4308 ^ nibble, read as bf16 that is
//     128 + (v ^ 8) = 136 + v; one bf16x2 subtraction of 136 leaves v.
//   * Stages: one producer warp (one thread) keeps four stages in flight,
//     each 64 packed rows x 128 columns of q4 (8 KB, TMA 128-byte swizzle)
//     and x's [8 NT tokens, 128 k] slice (two 64-k boxes, same swizzle).
//     Four consumer warps own 32 columns each and release a stage with one
//     mbarrier arrive a warp, never a block barrier. The swizzle makes both
//     kinds of fragment load conflict-free: warp w takes 16-byte chunks w
//     and w + 4 of every 128-byte line, so the four k-pair rows a load
//     touches (chunk ^ row % 8) land on eight distinct chunks; x's B
//     fragments come by ldmatrix from token rows in distinct chunks.
//   * Group fold in registers: after a group's last stage, the f32 partial
//     times the group's scale (__fmul_rn) is added to the f32 sum
//     (__fadd_rn), the reference's order; the scale slice is read at the
//     group's first stage.
//   * Filling the card: 128-column tiles, two CTAs an SM (~66 KB of shared
//     memory each at M = 32), the contraction split by whole groups only
//     as far as a narrow F needs (the wrapper's `stream_plan`, workspace at
//     most a quarter of the weight's bytes). Split partials go to an f32
//     workspace [splits, M, F]; the last CTA of a column tile (a counter a
//     tile, reset by that CTA) sums them in split order: one launch, no
//     float atomics, the same sum on every run.
// It takes M <= 32, group % 128 (whole stages) and F % 16 (TMA's 16-byte
// row pitch), 16-byte aligned operands; the wrapper sends other layouts
// to the split qgemm.

#pragma once

#include "hopper.cuh"
#include "quant_mma.cuh"

namespace k5s {

constexpr int TN = 128;                  // output columns a CTA
constexpr int KS = 128;                  // unpacked k a stage
constexpr int KP = KS / 2;               // packed rows a stage
constexpr int STAGES = 4;                // TMA ring depth
constexpr int NCW = TN / 32;             // consumer warps, 32 columns each
constexpr int NTHREADS = (NCW + 1) * 32; // + the producer warp
constexpr uint32_t W_BYTES = KP * TN;    // 8 KB of packed weight a stage

template <int NT>
struct Smem {
  alignas(1024) uint8_t w[STAGES][KP * TN];
  // two boxes of [8 NT tokens][64 k] bf16, 128-byte lines
  alignas(1024) uint8_t x[STAGES][2][NT * 8 * 128];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  int last;
};

template <int NT>
constexpr size_t smem_bytes() {
  return sizeof(Smem<NT>) + 1024;   // + alignment slack
}

// byte J of a packed word w (w4 = w >> 4) -> bf16x2 {low nibble, high
// nibble} as signed values, exactly
template <int J>
__device__ __forceinline__ uint32_t unpack_byte(uint32_t w, uint32_t w4) {
  constexpr uint32_t sel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t biased = (__byte_perm(w, w4, sel) & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const uint32_t c136 = 0x43084308u;    // bf16x2 {136, 136}
  v = __hsub2(v, *reinterpret_cast<const __nv_bfloat162*>(&c136));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// grid (column tiles, splits); split y takes groups [y per, (y + 1) per)
template <int NT>
__global__ void __launch_bounds__(NTHREADS, 2)
int4_stream(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap qmap,
            const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
            float* __restrict__ ws, int* __restrict__ counters, int M, int F,
            int G, int group, int per) {
  constexpr uint32_t X_BYTES = NT * 8 * 128;   // one 64-k box of x
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
        hop::mbar_expect_tx(&s.full[st], W_BYTES + 2 * X_BYTES);
        hop::tma_load_2d(s.w[st], &qmap, &s.full[st], n0, k * KP);
        hop::tma_load_2d(s.x[st][0], &xmap, &s.full[st], k * KS, 0);
        hop::tma_load_2d(s.x[st][1], &xmap, &s.full[st], k * KS + 64, 0);
      }
    }
    return;
  }

  // ---- consumers: warp w owns the 32 columns of chunks w and w + 4
  const int g = lane >> 2, t = lane & 3;
  const int c = warp + 4 * (g >> 2);           // 16-byte chunk of a line
  const int col = n0 + 16 * c + 4 * (g & 3);   // this thread's 4 columns
  // k-pair rows t and t + 4 of each 8-row k16 slice, swizzled
  const uint32_t aoff0 = t * 128 + ((c ^ t) << 4) + 4 * (g & 3);
  const uint32_t aoff1 = (t + 4) * 128 + ((c ^ (t + 4)) << 4) + 4 * (g & 3);
  // ldmatrix: lane l gives row l % 8 of matrix l / 8; matrices (tile j,
  // k 0-7), (j, k 8-15), (j + 1, k 0-7), (j + 1, k 8-15)
  const int mi = lane >> 3, r8 = lane & 7;
  const uint32_t xrow = (uint32_t)(8 * (mi >> 1) + r8) * 128;

  float acc[2][NT][4], facc[2][NT][4];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[T][j][e] = facc[T][j][e] = 0.f;
  float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < nsteps; ++i) {
    const int st = i % STAGES;
    if (i % gsteps == 0 && col < F)            // a group starts: its scales
      sv = __ldg(reinterpret_cast<const float4*>(
          scale + (size_t)(gb + i / gsteps) * F + col));
    hop::mbar_wait(&s.full[st], (i / STAGES) & 1);
    const uint8_t* wt = s.w[st];
    const uint32_t xb0 = hop::smem_u32(s.x[st][0]);
#pragma unroll
    for (int sub = 0; sub < KS / 16; ++sub) {
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(wt + sub * 1024 + aoff0);
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(wt + sub * 1024 + aoff1);
      const uint32_t w0s = w0 >> 4, w1s = w1 >> 4;
      uint32_t a[2][4];
      a[0][0] = unpack_byte<0>(w0, w0s);   // tile 0, row g,     k 2t
      a[0][1] = unpack_byte<1>(w0, w0s);   // tile 0, row g + 8, k 2t
      a[0][2] = unpack_byte<0>(w1, w1s);   // tile 0, row g,     k 2t + 8
      a[0][3] = unpack_byte<1>(w1, w1s);   // tile 0, row g + 8, k 2t + 8
      a[1][0] = unpack_byte<2>(w0, w0s);
      a[1][1] = unpack_byte<3>(w0, w0s);
      a[1][2] = unpack_byte<2>(w1, w1s);
      a[1][3] = unpack_byte<3>(w1, w1s);
      // B: x's k16 slice, 16-byte chunks cc and cc + 1 of box sub / 4
      const uint32_t xb = xb0 + (sub >> 2) * X_BYTES;
      const int cc = 2 * (sub & 3) + (mi & 1);
      const uint32_t xaddr = xb + xrow + ((cc ^ r8) << 4);
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
          qmma::mma_bf16(acc[T][j], a[T], b[j][0], b[j][1]);
    }
    // the stage was read through the generic proxy (ld.shared,
    // ldmatrix) and the producer's next TMA writes it through the
    // async proxy: order the reads before the release
    hop::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&s.empty[st]);

    if (i % gsteps == gsteps - 1) {
      // the group's partial, then its scale, then the running sum; column
      // offset 2T + h of fragment (tile T, row g + 8h)
      const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[T][j][e] = __fadd_rn(
                facc[T][j][e], __fmul_rn(acc[T][j][e], sc[2 * T + (e >> 1)]));
            acc[T][j][e] = 0.f;
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
          store4(out + (size_t)m * F + col, facc[0][j][e], facc[0][j][2 + e],
                 facc[1][j][e], facc[1][j][2 + e]);
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
        store4(out + (size_t)m * F + col, v[j][e].x, v[j][e].y, v[j][e].z,
               v[j][e].w);
    }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next launch
}

template <int NT>
cudaError_t launch_nt(const CUtensorMap& xmap, const CUtensorMap& qmap,
                      const float* scale, __nv_bfloat16* out, float* ws,
                      int* counters, int M, int F, int G, int group, int per,
                      int splits, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<NT>();
  cudaError_t e = cudaFuncSetAttribute(
      int4_stream<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((F + TN - 1) / TN, splits);
  int4_stream<NT><<<grid, NTHREADS, smem, st>>>(xmap, qmap, scale, out, ws,
                                                counters, M, F, G, group, per);
  return cudaGetLastError();
}

// x bf16 [M, D], q4 int8 [D/2, F], scale f32 [G, F] -> out bf16 [M, F];
// the plan (tn, splits, per) from the wrapper; ws f32 [splits, M, F] and
// counters int32 [column tiles], all zero, when splits > 1
static inline cudaError_t launch(const void* x, const int8_t* q4,
                                 const float* scale, __nv_bfloat16* out,
                                 float* ws, int* counters, int M, int D,
                                 int F, int G, int tn, int splits, int per,
                                 cudaStream_t st) {
  if (M < 1 || M > 32 || G < 1 || D % G || (D / G) % KS || F % 16 ||
      tn != TN || splits < 1 || per < 1 || (splits - 1) * per >= G ||
      splits * per < G || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q4) |
       reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(ws)) & 15)
    return cudaErrorMisalignedAddress;
  const int nt = (M + 7) / 8;
  CUtensorMap xmap, qmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {64, (cuuint32_t)(8 * nt)};
  cudaError_t e = hop::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
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
      return launch_nt<1>(xmap, qmap, scale, out, ws, counters, M, F, G,
                          group, per, splits, st);
    case 2:
      return launch_nt<2>(xmap, qmap, scale, out, ws, counters, M, F, G,
                          group, per, splits, st);
    case 3:
      return launch_nt<3>(xmap, qmap, scale, out, ws, counters, M, F, G,
                          group, per, splits, st);
    default:
      return launch_nt<4>(xmap, qmap, scale, out, ws, counters, M, F, G,
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

}  // namespace k5s
