// K5's tiled path (bf16 x, M > 32: the prefill waves) as a Hopper GEMM
// with mixed inputs: wgmma tensor-core products fed by TMA through a ring
// of shared-memory stages. Included by int4_matmul.cu; the split path
// (M <= 32) and f32 x keep their own bodies there.
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `int4_matmul`
//   (pallas_call) and its body `_kernel4`, at prefill extents.
//
// What bounds it on this card: at the int4 admission wave (M = 2 x 2816
// rows against 4096-14336 deep weights) it does ~2.8 k flops per packed
// weight byte and ~M flops per x byte, far above the ~295 flop/byte bf16
// ridge: bound by operations on the bf16 tensor cores (989 TFLOP/s),
// which only wgmma reaches. The design:
//   * One CTA owns a 128 x 192 output tile: two consumer warpgroups of 64
//     rows each and a producer warpgroup, which gives most of its registers
//     to the consumers (setmaxnreg: 40 against 232) so both accumulators
//     stay in registers. One producer thread keeps STAGES k-steps
//     of 64 in flight with TMA: an x tile [128 rows, 64 k] (bf16, 128-byte
//     swizzle: wgmma's K-major A) and the packed weight tile [32 packed
//     rows, 192 columns] (int8, unswizzled), each stage under a full and
//     an empty mbarrier.
//   * Unpacked, q4's natural layout is [k][n] with n contiguous: wgmma's
//     MN-major B. Each consumer warpgroup unpacks half of the stage's
//     packed rows into a bf16 B tile in that swizzled layout (four tiles
//     in a ring, so a tile is rewritten only after both warpgroups'
//     products of it retired), then fence.proxy.async and a barrier of
//     the 256 consumer threads. A step issues 4 wgmma m64n192k16 on its
//     stage and unpacks the next stage while they run.
//   * Nibble to bf16 without a conversion instruction: (nibble ^ 8) |
//     0x4300 read as bf16 is 128 + (nibble ^ 8); minus 136 it is the
//     signed nibble, exactly. Two packed bytes give one bf16x2 word per
//     nibble half: a byte permute, one lop3 and one bf16x2 subtract.
//   * The group fold keeps the reference's order: each scale group (group
//     / 64 stages) starts its accumulator with scale-d = 0, so after the
//     group's last product (wgmma.wait_group 0) it holds the group's f32
//     partial; the partial times the group's scale row is added to the f32
//     sum with __fmul_rn / __fadd_rn (no contraction); the scale row slice
//     comes with the group's last stage, by TMA. The bf16 weights are
//     never scaled: w * s rounded to bf16 would not be the reference. Both
//     accumulators (96 + 96 f32 a thread) stay in registers, which is why
//     a warpgroup owns 64 x 192 and not 64 x 256 (256 + addressing would
//     not fit the 232 registers a consumer gets). 192 rather than 128
//     columns: the x tile, read from L2 again for every column tile, is
//     most of a stage's bytes (16 KB of 22), and a wider tile reads it
//     for more products.
//   * Ragged M and F: TMA fills rows and columns outside x and q4 with
//     zeros, the epilogue masks its stores. Output tiles are visited in
//     groups of 8 row tiles so the x rows and weight columns in flight
//     stay in L2.
// It takes D % 64, F % 16 (TMA's 16-byte row pitch) and group % 64; the
// wrapper routes any other layout to the mma.sync body (quant_mma.cuh).

#pragma once

#include "hopper.cuh"

namespace k5w {

constexpr int TM = 128;        // output rows a CTA (two warpgroups of 64)
constexpr int TN = 192;        // output columns a CTA: wgmma m64n192
constexpr int KS = 64;         // unpacked k a stage
constexpr int STAGES = 4;      // TMA ring depth
constexpr int BBUFS = 4;       // unpacked B tiles in flight
constexpr int NCONS = 256;     // consumer threads
constexpr int NTHREADS = NCONS + 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int GROUP_M = 8;     // row tiles a raster group
constexpr uint32_t A_BYTES = TM * KS * 2;        // 16 KB
constexpr uint32_t Q_BYTES = (KS / 2) * TN;      // 4 KB
constexpr uint32_t S_BYTES = TN * 4;             // a scale row slice
constexpr int CH = TN / 8;     // 16-byte chunks of an unpacked B row

struct Smem {
  alignas(1024) __nv_bfloat16 a[STAGES][TM * KS];
  alignas(1024) __nv_bfloat16 b[BBUFS][KS * TN];
  alignas(128) int8_t q[STAGES][(KS / 2) * TN];
  alignas(128) float sc[STAGES][TN];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;   // + alignment slack

// the byte offset of 16-byte chunk `c` (0..7) of line `r` in a 128-byte
// swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// two packed bytes p = [b0, 0, b1, 0] -> bf16x2 of their low (or high)
// nibbles as signed values, exactly
__device__ __forceinline__ uint32_t nib2(uint32_t p) {
  const uint32_t biased = (p & 0x000F000Fu) ^ 0x43084308u;   // 128 + (v ^ 8)
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// unpack packed rows [pr0, pr0 + 16) of a stage (16 rows x TN columns)
// into the MN-major B tile: packed row pr holds k = 2pr (low nibbles) and
// 2pr + 1 (high nibbles). 128 threads, TN / 64 8-column units each.
__device__ __forceinline__ void unpack_half(const int8_t* q, uint8_t* b,
                                            int pr0, int t) {
#pragma unroll
  for (int i = 0; i < 16 * CH / 128; ++i) {
    const int u = t + 128 * i;
    const int pr = pr0 + u / CH, c16 = u % CH;
    const uint2 w = *reinterpret_cast<const uint2*>(q + pr * TN + c16 * 8);
    const uint32_t p[4] = {__byte_perm(w.x, 0, 0x4140),
                           __byte_perm(w.x, 0, 0x4342),
                           __byte_perm(w.y, 0, 0x4140),
                           __byte_perm(w.y, 0, 0x4342)};
    uint4 lo, hi;
    lo.x = nib2(p[0]);
    lo.y = nib2(p[1]);
    lo.z = nib2(p[2]);
    lo.w = nib2(p[3]);
    hi.x = nib2(p[0] >> 4);
    hi.y = nib2(p[1] >> 4);
    hi.z = nib2(p[2] >> 4);
    hi.w = nib2(p[3] >> 4);
    uint8_t* blk = b + (c16 >> 3) * (KS * 128);   // 64-column block
    const int c = c16 & 7;
    *reinterpret_cast<uint4*>(blk + swz(2 * pr, c)) = lo;
    *reinterpret_cast<uint4*>(blk + swz(2 * pr + 1, c)) = hi;
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
int4_wgmma(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap smap,
           __nv_bfloat16* __restrict__ out, int M, int D, int F, int group) {
  extern __shared__ uint8_t raw[];
  Smem& s = *reinterpret_cast<Smem*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  // grouped raster: GROUP_M row tiles share each column tile in turn
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (F + TN - 1) / TN;
  const int per_group = GROUP_M * tiles_n;
  const int gid = blockIdx.x / per_group;
  const int first_m = gid * GROUP_M;
  const int gm = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * TM;
  const int n0 = (in_group / gm) * TN;
  const int ksteps = D / KS, gsteps = group / KS;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&s.full[i], 1);
      hop::mbar_init(&s.empty[i], NCONS / 32);   // one arrive a warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (hop::warpgroup() == NCONS / 128) {
    // ---- producer: one thread keeps the ring full; a group's last stage
    // also brings the group's scale row
    hop::reg_dealloc<PRODUCER_REGS>();
    if (tid == NCONS) {
      for (int k = 0; k < ksteps; ++k) {
        const int st = k % STAGES;
        const bool g_last = (k % gsteps) == gsteps - 1;
        hop::mbar_wait(&s.empty[st], ((k / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&s.full[st],
                            A_BYTES + Q_BYTES + (g_last ? S_BYTES : 0));
        hop::tma_load_2d(s.a[st], &xmap, &s.full[st], k * KS, m0);
        hop::tma_load_2d(s.q[st], &qmap, &s.full[st], n0, k * (KS / 2));
        if (g_last)
          hop::tma_load_2d(s.sc[st], &smap, &s.full[st], n0, k / gsteps);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64).
    // Step k: issue the products of stage k, then unpack stage k + 1 while
    // they run, then retire stage k (at a group's end: fold it).
    hop::reg_alloc<CONSUMER_REGS>();
    const int wg = hop::warpgroup(), t = tid & 127;
    const int lane = tid & 31, warp = t >> 5;
    float acc[TN / 2], facc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = facc[i] = 0.f;

    hop::mbar_wait(&s.full[0], 0);
    unpack_half(s.q[0], reinterpret_cast<uint8_t*>(s.b[0]), wg * 16, t);
    hop::fence_proxy_async();
    hop::named_sync(1, NCONS);

    int prev = -1;   // the k-step whose stage is not yet released
    for (int k = 0; k < ksteps; ++k) {
      const int st = k % STAGES;
      const bool g_first = (k % gsteps) == 0;
      const bool g_last = (k % gsteps) == gsteps - 1;
      const uint8_t* at =
          reinterpret_cast<const uint8_t*>(s.a[st]) + wg * 64 * 128;
      const uint8_t* bt = reinterpret_cast<const uint8_t*>(s.b[k % BBUFS]);
      hop::fence_regs<TN / 2>(acc);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
        hop::wgmma_ss_n192<1>(
            acc, hop::desc_sw128(at + kk * 32, 16, 1024),
            hop::desc_sw128(bt + kk * 16 * 128, KS * 128, 1024),
            (kk > 0 || !g_first) ? 1 : 0);
      hop::wg_commit();

      if (k + 1 < ksteps) {
        const int nx = (k + 1) % STAGES;
        hop::mbar_wait(&s.full[nx], ((k + 1) / STAGES) & 1);
        unpack_half(s.q[nx],
                    reinterpret_cast<uint8_t*>(s.b[(k + 1) % BBUFS]),
                    wg * 16, t);
        hop::fence_proxy_async();
        hop::named_sync(1, NCONS);
      }

      if (g_last) {
        hop::wg_wait<0>();
        hop::fence_regs<TN / 2>(acc);
        // the group's partial, then its scale, then the running sum
        const float* srow = s.sc[st];
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const float2 sv = *reinterpret_cast<const float2*>(
              srow + 8 * j + 2 * (lane & 3));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            facc[4 * j + e] = __fadd_rn(
                facc[4 * j + e],
                __fmul_rn(acc[4 * j + e], (e & 1) ? sv.y : sv.x));
        }
        // the scales were read through the generic proxy and the
        // producer's next TMA writes the stage through the async proxy:
        // order the reads before the release
        hop::fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          if (prev >= 0) hop::mbar_arrive(&s.empty[prev % STAGES]);
          hop::mbar_arrive(&s.empty[st]);
        }
        prev = -1;
      } else {
        hop::wg_wait<1>();
        hop::fence_regs<TN / 2>(acc);
        if (lane == 0 && prev >= 0) hop::mbar_arrive(&s.empty[prev % STAGES]);
        prev = k;
      }
    }

    // ---- epilogue: rows 16 warp + lane / 4 (+ 8), columns 8j + 2 (lane % 4)
    const int r = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (n < F)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * F + n) =
              __floats2bfloat162_rn(facc[4 * j + 2 * h],
                                    facc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// x bf16 [M, D], q4 int8 [D/2, F], scale f32 [D/group, F] -> out bf16 [M, F]
static inline cudaError_t launch(const void* x, const int8_t* q4,
                                 const float* scale, __nv_bfloat16* out,
                                 int M, int D, int F, int group,
                                 cudaStream_t st) {
  if (D % KS || F % 16 || group % KS || D % group)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q4) |
       reinterpret_cast<uintptr_t>(scale)) & 15)
    return cudaErrorMisalignedAddress;
  CUtensorMap xmap, qmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {KS, TM};
  cudaError_t e = hop::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                                xdims, xstr, xbox,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const cuuint64_t qdims[2] = {(cuuint64_t)F, (cuuint64_t)(D / 2)};
  const cuuint64_t qstr[1] = {(cuuint64_t)F};
  const cuuint32_t qbox[2] = {TN, KS / 2};
  e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q4, qdims, qstr,
                    qbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  CUtensorMap smap;
  const cuuint64_t sdims[2] = {(cuuint64_t)F, (cuuint64_t)(D / group)};
  const cuuint64_t sstr[1] = {(cuuint64_t)F * 4};
  const cuuint32_t sbox[2] = {TN, 1};
  e = hop::make_map(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scale, sdims,
                    sstr, sbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int4_wgmma,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + TM - 1) / TM) * ((F + TN - 1) / TN);
  int4_wgmma<<<tiles, NTHREADS, SMEM_BYTES, st>>>(xmap, qmap, smap, out, M,
                                                  D, F, group);
  return cudaGetLastError();
}

}  // namespace k5w
