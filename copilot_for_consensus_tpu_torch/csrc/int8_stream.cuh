// K2's stream body (bf16 x, M <= 8: every int8 decode projection and the
// lm_head of a decode step or an admission wave) as a Hopper weight stream:
// TMA keeps the int8 weight in flight through a ring of mbarrier stages,
// and the weight, converted to bf16 in registers, is the register-fed A
// operand of mma.sync. One launch a call. Included by int8_matmul.cu; the
// tiled extents (M > 8) keep int8_wgmma.cuh, and f32 x and the layouts this
// body refuses keep the split GEMV of int8_matmul.cu.
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `int8_matmul`
//   (pallas_call) and its body `_kernel`, at decode extents.
//
// What bounds it on this card: a decode step multiplies M <= 8 rows of x
// by the whole int8 weight, 2 M <= 16 flops per weight byte against the
// ~295 flop/byte bf16 ridge, so it is bound by reading the int8 bytes once
// at 3.35 TB/s (w_gate 4096 x 14336: 58.7 MB, 17.5 us; a whole decode step
// of Mistral-7B: 32 x 218.1 MB + 131 MB = 7.11 GB, 2.12 ms). That needs
// ~25 KB of weight in flight on every SM (3.35 TB/s x ~1 us / 132 SMs),
// and the per-byte work between the loads and the products must stay a
// few instructions. The design (K5's stream body, int4_stream.cuh, with
// the k-pairing of int8):
//   * Swapped operands: out^T[F, M] = W^T x^T with mma.sync m16n8k16 bf16
//     -> f32. The weight is A (16 F columns x 16 k); the <= 8 tokens are
//     one n8 tile, rows past M zero-filled by TMA. x's B fragments come by
//     ldmatrix from the stage's x slice in shared memory.
//   * Pairing along k: an A register holds two consecutive k of one
//     column, and in int8 [D, F] they lie F bytes apart, in rows d and
//     d + 1. So a thread loads one 32-bit word (4 adjacent columns) from
//     each of its rows 2t, 2t + 1, 2t + 8, 2t + 9 of a k16 slice and pairs
//     byte j of the two words of a row pair with one byte permute. Its
//     fragment row (tile T, row g + 8h) is byte 2T + h of its words:
//     column 32w + 4g + 2T + h of warp w's 32. The epilogue undoes the
//     permutation: a token's four columns are one 8-byte store.
//   * int8 -> bf16 exactly, in integer and f32 operations: byte ^ 0x80
//     (v + 128) placed in the low byte of 2^23 by one byte permute is the
//     f32 2^23 + 128 + v; one f32 subtraction of 2^23 + 128 leaves v. An
//     integer with |v| <= 128 has 8 significant bits, so the low 16 bits of
//     its f32 are zero and its bf16 is the f32's high half: one more byte
//     permute takes the high halves of two such floats as a bf16x2 word,
//     with no rounding conversion. bf16 m16n8k16, not tf32 m16n8k8: tf32
//     takes each f32 as it is (no pairing permute), but it needs twice
//     the products and needs x widened from bf16 one 16-bit value at a
//     time for its B fragments, which costs about what the permute saves;
//     the bf16 route keeps K5's ldmatrix B path.
//   * Stages: one producer warp (one thread) keeps four stages in flight,
//     each 128 k x 128 columns of int8 (16 KB, TMA 128-byte swizzle) and
//     x's [8 tokens, 128 k] slice (two 64-k boxes, same swizzle): 64 KB of
//     weight in flight a CTA. Four consumer warps own 32 adjacent columns
//     each and release a stage with one mbarrier arrive a warp, never a
//     block barrier. The swizzle makes the weight loads conflict-free:
//     warp w takes 16-byte chunks 2w and 2w + 1 of every 128-byte line, so
//     a load's four even (or odd) rows, XOR'd into the chunk index, land
//     on eight distinct chunks, 32 distinct banks; x's ldmatrix rows are
//     eight tokens in distinct chunks.
//   * One launch: 128-column tiles, the contraction split by whole stages
//     only as far as a narrow F needs to bring the CTAs toward one an SM
//     (the wrapper's `int8_stream_plan`, workspace at most a quarter of the
//     weight's bytes). One CTA an SM measured faster than two (more
//     splits) at every decode leaf, and a deeper ring (8 stages) or eight
//     consumer warps splitting each stage's k16 slices no faster. Split partials go to an f32 workspace [splits, M,
//     F]; the last CTA of a column tile (a counter a tile, reset by that
//     CTA) sums them in split order: no second kernel, no float atomics,
//     the same sum on every run.
//   * Epilogue: the f32 sum times scale[f] (__fmul_rn), rounded once to
//     bf16, as the reference does at finalize.
// It takes M <= 8, D % 128 (whole stages) and F % 16 (TMA's 16-byte row
// pitch), 16-byte aligned operands; the wrapper sends other layouts to the
// split GEMV.

#pragma once

#include "hopper.cuh"

namespace k2s {

constexpr int TN = 128;                  // output columns a CTA
constexpr int KS = 128;                  // contraction rows a stage
constexpr int STAGES = 4;                // TMA ring depth
constexpr int NCW = TN / 32;             // consumer warps, 32 columns each
constexpr int NTHREADS = (NCW + 1) * 32; // + the producer warp
constexpr uint32_t W_BYTES = KS * TN;    // 16 KB of weight a stage
constexpr uint32_t X_BYTES = 8 * 128;    // one [8 tokens][64 k] bf16 box

struct Smem {
  alignas(1024) uint8_t w[STAGES][KS * TN];
  alignas(1024) uint8_t x[STAGES][2][X_BYTES];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  int last;
};

constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;   // + alignment slack

// byte J of u0 and of u1 (bytes already ^ 0x80) -> bf16x2 {low: u0's,
// high: u1's} as signed values, exactly
template <int J>
__device__ __forceinline__ uint32_t pair_byte(uint32_t u0, uint32_t u1) {
  constexpr uint32_t sel = 0x7650u + J;       // byte J into 0x4B0000__
  const float magic = 8388736.f;              // 2^23 + 128
  const float f0 =
      __uint_as_float(__byte_perm(u0, 0x4B000000u, sel)) - magic;
  const float f1 =
      __uint_as_float(__byte_perm(u1, 0x4B000000u, sel)) - magic;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ float4 scaled(float4 v, float4 s) {
  return make_float4(__fmul_rn(v.x, s.x), __fmul_rn(v.y, s.y),
                     __fmul_rn(v.z, s.z), __fmul_rn(v.w, s.w));
}

// grid (column tiles, splits); split y takes contraction rows [y rows,
// min(D, (y + 1) rows))
__global__ void __launch_bounds__(NTHREADS, 2)
int8_stream(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap qmap,
            const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
            float* __restrict__ ws, int* __restrict__ counters, int M, int D,
            int F, int rows) {
  extern __shared__ uint8_t raw[];
  Smem& s = *reinterpret_cast<Smem*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * TN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int kb = split * (rows / KS);            // first stage of the split
  const int nsteps = min(rows, D - split * rows) / KS;

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
        const int st = i % STAGES, k = (kb + i) * KS;
        hop::mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&s.full[st], W_BYTES + 2 * X_BYTES);
        hop::tma_load_2d(s.w[st], &qmap, &s.full[st], n0, k);
        hop::tma_load_2d(s.x[st][0], &xmap, &s.full[st], k, 0);
        hop::tma_load_2d(s.x[st][1], &xmap, &s.full[st], k + 64, 0);
      }
    }
    return;
  }

  // ---- consumers: warp w owns the 32 columns of chunks 2w and 2w + 1
  const int g = lane >> 2, t = lane & 3;
  const int c = 2 * warp + (g >> 2);           // 16-byte chunk of a line
  const int col = n0 + 16 * c + 4 * (g & 3);   // this thread's 4 columns
  // rows 2t and 2t + 1 of a k16 slice, swizzled (rows 2t + 8 and 2t + 9
  // are 1024 bytes further, in the same swizzle phase)
  const uint32_t aoff0 = 2 * t * 128 + ((c ^ (2 * t)) << 4) + 4 * (g & 3);
  const uint32_t aoff1 =
      (2 * t + 1) * 128 + ((c ^ (2 * t + 1)) << 4) + 4 * (g & 3);
  // ldmatrix x2: lanes 0-15 give token row lane % 8 of matrix lane / 8
  // (k 0-7, k 8-15 of the slice); lanes 16-31 repeat them (ignored)
  const int mi = (lane >> 3) & 1, r8 = lane & 7;
  const uint32_t xrow = (uint32_t)r8 * 128;

  float acc[2][4];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[T][e] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    const int st = i % STAGES;
    hop::mbar_wait(&s.full[st], (i / STAGES) & 1);
    const uint8_t* wt = s.w[st];
    const uint32_t xb0 = hop::smem_u32(s.x[st][0]);
#pragma unroll
    for (int sub = 0; sub < KS / 16; ++sub) {
      const uint8_t* ws16 = wt + sub * 2048;
      const uint32_t u0 = lds32(ws16 + aoff0);           // row 2t
      const uint32_t u1 = lds32(ws16 + aoff1);           // row 2t + 1
      const uint32_t u2 = lds32(ws16 + 1024 + aoff0);    // row 2t + 8
      const uint32_t u3 = lds32(ws16 + 1024 + aoff1);    // row 2t + 9
      uint32_t a[2][4];
      a[0][0] = pair_byte<0>(u0, u1);   // tile 0, row g,     k 2t
      a[0][1] = pair_byte<1>(u0, u1);   // tile 0, row g + 8, k 2t
      a[0][2] = pair_byte<0>(u2, u3);   // tile 0, row g,     k 2t + 8
      a[0][3] = pair_byte<1>(u2, u3);   // tile 0, row g + 8, k 2t + 8
      a[1][0] = pair_byte<2>(u0, u1);
      a[1][1] = pair_byte<3>(u0, u1);
      a[1][2] = pair_byte<2>(u2, u3);
      a[1][3] = pair_byte<3>(u2, u3);
      // B: x's k16 slice, 16-byte chunk cc of box sub / 4
      const int cc = 2 * (sub & 3) + mi;
      uint32_t b0, b1;
      hop::ldsm_x2(xb0 + (sub >> 2) * X_BYTES + xrow + ((cc ^ r8) << 4), b0,
                   b1);
      mma_bf16(acc[0], a[0], b0, b1);
      mma_bf16(acc[1], a[1], b0, b1);
    }
    // the stage was read through the generic proxy (ld.shared,
    // ldmatrix) and the producer's next TMA writes it through the
    // async proxy: order the reads before the release
    hop::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&s.empty[st]);
  }

  // ---- epilogue: token 2t + e, columns col .. col + 3 (fragment row
  // g + 8h of tile T is column col + 2T + h)
  const bool live = col < F;
  const float4 sv = live ? __ldg(reinterpret_cast<const float4*>(scale + col))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  if (splits == 1) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 2 * t + e;
      if (m < M && live) {
        const float4 v = scaled(
            make_float4(acc[0][e], acc[0][2 + e], acc[1][e], acc[1][2 + e]),
            sv);
        store4(out + (size_t)m * F + col, v.x, v.y, v.z, v.w);
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = 2 * t + e;
    if (m < M && live)
      *reinterpret_cast<float4*>(ws + ((size_t)split * M + m) * F + col) =
          make_float4(acc[0][e], acc[0][2 + e], acc[1][e], acc[1][2 + e]);
  }
  // the last CTA of this column tile sums the splits in order
  __threadfence();
  hop::named_sync(1, NCW * 32);
  if (tid == 0)
    s.last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  hop::named_sync(1, NCW * 32);
  if (!s.last) return;
  __threadfence();
  // eight splits at a time, their loads in flight together: one L2 round
  // trip a batch, not one a split
  constexpr int BATCH = 8;
  float4 v[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                 make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int p0 = 0; p0 < splits; p0 += BATCH) {
    float4 u[BATCH][2];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 2 * t + e, p = p0 + b;
        u[b][e] = (p < splits && m < M && live)
                      ? __ldcg(reinterpret_cast<const float4*>(
                            ws + ((size_t)p * M + m) * F + col))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (p0 + b >= splits) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (p0 + b == 0) {
          v[e] = u[b][e];
        } else {
          v[e].x = __fadd_rn(v[e].x, u[b][e].x);
          v[e].y = __fadd_rn(v[e].y, u[b][e].y);
          v[e].z = __fadd_rn(v[e].z, u[b][e].z);
          v[e].w = __fadd_rn(v[e].w, u[b][e].w);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = 2 * t + e;
    if (m < M && live) {
      const float4 r = scaled(v[e], sv);
      store4(out + (size_t)m * F + col, r.x, r.y, r.z, r.w);
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next launch
}

// x bf16 [M, D], q int8 [D, F], scale f32 [F] -> out bf16 [M, F]; the
// plan (tn, splits, rows) from the wrapper; ws f32 [splits, M, F] and
// counters int32 [column tiles], all zero, when splits > 1
static inline cudaError_t launch(const void* x, const int8_t* q,
                                 const float* scale, __nv_bfloat16* out,
                                 float* ws, int* counters, int M, int D,
                                 int F, int tn, int splits, int rows,
                                 cudaStream_t st) {
  if (M < 1 || M > 8 || D < KS || D % KS || F < 16 || F % 16 || tn != TN ||
      splits < 1 || rows < KS || rows % KS ||
      (long long)(splits - 1) * rows >= D || (long long)splits * rows < D ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(ws)) & 15)
    return cudaErrorMisalignedAddress;
  CUtensorMap xmap, qmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {64, 8};
  cudaError_t e = hop::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                                xdims, xstr, xbox,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const cuuint64_t qdims[2] = {(cuuint64_t)F, (cuuint64_t)D};
  const cuuint64_t qstr[1] = {(cuuint64_t)F};
  const cuuint32_t qbox[2] = {TN, KS};
  e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstr,
                    qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int8_stream,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((F + TN - 1) / TN, splits);
  int8_stream<<<grid, NTHREADS, SMEM_BYTES, st>>>(xmap, qmap, scale, out, ws,
                                                  counters, M, D, F, rows);
  return cudaGetLastError();
}

}  // namespace k2s
