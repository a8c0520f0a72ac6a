// K6's tiled path (M > 32: the a8 prefill waves) as a Hopper int8 GEMM:
// wgmma with s32 accumulators, fed by TMA through a ring of shared-memory
// stages, the group fold in registers. Included by w4a8_matmul.cu; the
// split qgemm (M <= 32) and the layouts this body refuses keep the bodies
// of quant_mma.cuh.
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `w4a8_matmul`
//   (pallas_call) and its body `_kernel_w4a8`, at prefill extents.
//
// What bounds it on this card: at the a8 admission wave (M = 2 x 2816 rows
// against 4096-14336 deep weights) it does ~2M operations per packed
// weight byte, far above the ~590 op/byte int8 ridge: bound by operations
// on the int8 tensor cores (1,979 TOP/s), which only wgmma reaches. What
// limits the body first is nearer: a tile reads ~256 operations' worth per
// byte from L2 (xq again for every 128 columns), and the card's L2 does not
// feed that at the tensor cores' rate. The design:
//   * Swapped operands: out^T = W^T xq^T. wgmma on 8-bit types takes
//     K-major operands only, and q4 unpacked is [k][n] with n contiguous,
//     so the weight is wgmma's register A (K-major by definition) and the
//     int8 activations xq, [tokens, k] with k contiguous, its shared B as
//     TMA brings them. No unpacked tile exists in shared memory: no
//     fence.proxy.async, no consumer barrier a stage.
//   * One CTA owns 128 output columns x 176 tokens: two consumer
//     warpgroups of 64 columns each (wgmma m64n176k32; 176 divides the
//     wave's 5632 rows) and a producer warpgroup, which gives most of its
//     registers to the consumers (setmaxnreg: 40 against 232) so the s32
//     partials and the f32 sums (88 + 88 a thread) stay in registers. One
//     producer thread keeps STAGES k-steps of 128 in flight with TMA, each
//     under a full and an empty mbarrier: xq [176 tokens, 128 k] and q4
//     [64 packed rows, 128 columns], both in the 128-byte swizzle.
//   * The A fragment: fragment rows g and g + 8 of warp w (lane = 4g + t)
//     are the adjacent columns 64 wg + 16 w + 2g and + 1, so a lane's four
//     bytes of a k32 step are two 16-bit loads from packed rows 2t, 2t + 1
//     and two from 2t + 8, 2t + 9 (one packed byte is a k-pair of one
//     column), conflict-free under the swizzle. Nibbles become signed
//     bytes in integer operations, four a word: ((v ^ 8) | 0x80) - 8 is 128
//     plus the signed nibble with no borrow between bytes, ^ 0x80 makes it
//     two's complement; two byte permutes put k in order. A's registers are
//     double-buffered: step j + 1 is unpacked while wgmma j runs, after
//     wgmma j - 1, the last reader of that buffer, has retired.
//   * The group fold keeps the reference's order: each scale group's first
//     wgmma starts its s32 accumulator with scale-d = 0, so after the
//     group's last product (wgmma.wait_group 0) it holds the group's exact
//     int32 partial; cvt.rn.f32.s32 takes it to f32 (exactly: |partial| <=
//     127 * 8 * group < 2^24 up to group 16384, and past that it rounds as
//     the plain version's f32 cast of its exact sum does), __fmul_rn by the
//     group's scale row, __fadd_rn into the f32 sum, in group order; the
//     epilogue multiplies by sx (__fmul_rn) and rounds once to x's dtype:
//     the plain version's arithmetic, operation for operation, so the two
//     are equal bit for bit. The scale row slice comes with the group's
//     last stage, by TMA.
//   * Persistent CTAs, one an SM, each walking the output tiles in turn:
//     the producer fills the ring for the next tile while the consumers
//     fold the last group and store. Tiles are visited in groups of 8
//     token tiles so the xq rows and weight columns in flight stay in L2.
//   * Ragged M and F: TMA fills tokens and columns outside xq and q4 with
//     zeros, the epilogue masks its stores.
// It takes D % 128, group % 128 and F % 16 (TMA's 16-byte row pitch of
// q4); the wrapper routes any other layout to the mma.sync tiling
// (quant_mma.cuh). x's dtype changes only the store.

#pragma once

#include "hopper.cuh"
#include "quant_mma.cuh"

namespace k6w {

constexpr int TT = 176;        // tokens a CTA: wgmma N
constexpr int TC = 128;        // output columns a CTA: two warpgroups of 64
constexpr int KS = 128;        // k a stage: one 128-byte line of xq
constexpr int KP = KS / 2;     // packed weight rows a stage
constexpr int STAGES = 4;      // TMA ring depth
constexpr int NCONS = 256;     // consumer threads
constexpr int NTHREADS = NCONS + 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int GROUP_M = 8;     // token tiles a raster group
constexpr int NACC = TT / 2;   // s32 partials (and f32 sums) a thread
constexpr uint32_t X_BYTES = TT * KS;      // 22 KB
constexpr uint32_t Q_BYTES = KP * TC;      // 8 KB
constexpr uint32_t S_BYTES = TC * 4;       // a scale row slice

struct Smem {
  alignas(1024) uint8_t x[STAGES][X_BYTES];
  alignas(1024) uint8_t q[STAGES][Q_BYTES];
  alignas(16) float sc[STAGES][TC];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;   // + alignment slack

// the A fragment of k32 step j of a stage's q4 tile; off_e and off_o are
// the lane's swizzled byte offsets at packed rows 2t and 2t + 1: the
// packed bytes of columns (c, c + 1) at rows r and r + 1, each a 16-bit
// load, unpacked to the A registers of those two fragment rows
__device__ __forceinline__ void load_a(const uint8_t* q, int j,
                                       uint32_t off_e, uint32_t off_o,
                                       uint32_t* a) {
  const uint8_t* p = q + j * 16 * 128;
  const uint32_t h0 = *reinterpret_cast<const uint16_t*>(p + off_e);
  const uint32_t h1 = *reinterpret_cast<const uint16_t*>(p + off_o);
  const uint32_t h2 = *reinterpret_cast<const uint16_t*>(p + 1024 + off_e);
  const uint32_t h3 = *reinterpret_cast<const uint16_t*>(p + 1024 + off_o);
  qmma::nibble_quads<0>(h0, h1, a[0], a[1]);   // k 4t .. 4t + 3
  qmma::nibble_quads<0>(h2, h3, a[2], a[3]);   // k 16 + 4t .. + 3
}

// the four k32 products of one stage (x tile xt, q4 tile q), A's step 0
// already in a[0]: issue product j, retire j - 1, unpack step j + 1 into
// the buffer j - 1 read. The first product starts the accumulators from
// zero when `first` (a scale group's first stage), and once it is issued
// the products before it have retired, so `release` (the previous stage's
// empty barrier, or null) is arrived on. Leaves the fourth product, and
// possibly the third, in flight.
__device__ __forceinline__ void stage_products(uint32_t* acc,
                                               uint32_t (&a)[2][4],
                                               const uint8_t* xt,
                                               const uint8_t* q, bool first,
                                               uint32_t off_e, uint32_t off_o,
                                               uint64_t* release, int lane) {
#pragma unroll
  for (int j = 0; j < KS / 32; ++j) {
    hop::fence_regs<NACC>(acc);
    hop::wg_fence();
    hop::wgmma_rs_s8_n176(acc, a[j & 1],
                          hop::desc_sw128(xt + 32 * j, 16, 1024),
                          (j > 0 || !first) ? 1 : 0);
    hop::wg_commit();
    if (j + 1 < KS / 32) {
      hop::wg_wait<1>();
      if (j == 0 && release != nullptr) {
        // the stage's q4 was read through the generic proxy (ld.shared)
        // and the producer's next TMA writes it through the async proxy:
        // order the reads before the release
        hop::fence_proxy_async();
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(release);
      }
      load_a(q, j + 1, off_e, off_o, a[(j + 1) & 1]);
      hop::fence_regs<4>(a[(j + 1) & 1]);
    }
  }
}

// the origin (first token, first column) of output tile `tile` in the
// grouped raster: GROUP_M token tiles share each column tile in turn
__device__ __forceinline__ void tile_origin(int tile, int tiles_m,
                                            int tiles_n, int& m0, int& n0) {
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (tile / per_group) * GROUP_M;
  const int gm = min(tiles_m - first_m, GROUP_M);
  const int in_group = tile % per_group;
  m0 = (first_m + in_group % gm) * TT;
  n0 = (in_group / gm) * TC;
}

template <typename OutT>
__global__ void __launch_bounds__(NTHREADS, 1)
w4a8_wgmma(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap smap,
           const float* __restrict__ sx, OutT* __restrict__ out, int M,
           int D, int F, int group) {
  extern __shared__ uint8_t raw[];
  Smem& s = *reinterpret_cast<Smem*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  const int tiles_m = (M + TT - 1) / TT, tiles_n = (F + TC - 1) / TC;
  const int tiles = tiles_m * tiles_n;
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
      int st = 0;
      uint32_t ph = 0;   // the parity of the ring's current pass
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, tiles_m, tiles_n, m0, n0);
        for (int k = 0; k < ksteps; ++k) {
          const bool g_last = (k % gsteps) == gsteps - 1;
          hop::mbar_wait(&s.empty[st], ph ^ 1);
          hop::mbar_expect_tx(&s.full[st],
                              X_BYTES + Q_BYTES + (g_last ? S_BYTES : 0));
          hop::tma_load_2d(s.x[st], &xmap, &s.full[st], k * KS, m0);
          hop::tma_load_2d(s.q[st], &qmap, &s.full[st], n0, k * KP);
          if (g_last)
            hop::tma_load_2d(s.sc[st], &smap, &s.full[st], n0, k / gsteps);
          if (++st == STAGES) st = 0, ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns columns [n0 + 64 wg, + 64): a scale
    // group's stages, then the fold
    hop::reg_alloc<CONSUMER_REGS>();
    const int wg = hop::warpgroup();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int cb = 64 * wg + 16 * warp + 2 * g;   // columns cb, cb + 1
    const int c = cb >> 4;                        // their 16-byte chunk
    const uint32_t off_e = 2 * t * 128 + ((c ^ (2 * t)) << 4) + 2 * g;
    const uint32_t off_o =
        (2 * t + 1) * 128 + ((c ^ (2 * t + 1)) << 4) + 2 * g;
    uint32_t acc[NACC];
    float facc[NACC];
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0u;

    const int groups = ksteps / gsteps;
    int st = 0;          // the ring slot of the next stage
    uint32_t ph = 0;     // and the parity of its full barrier
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, tiles_m, tiles_n, m0, n0);
#pragma unroll
      for (int i = 0; i < NACC; ++i) facc[i] = 0.f;
      hop::mbar_wait(&s.full[st], ph);
      load_a(s.q[st], 0, off_e, off_o, a[0]);
      hop::fence_regs<4>(a[0]);
      for (int gi = 0; gi < groups; ++gi) {
        uint64_t* release = nullptr;   // a stage whose last product may run
        for (int sg = 0; sg + 1 < gsteps; ++sg) {
          stage_products(acc, a, s.x[st], s.q[st], sg == 0, off_e, off_o,
                         release, lane);
          hop::wg_wait<1>();         // the stage's third product: a[0] free
          release = &s.empty[st];
          if (++st == STAGES) st = 0, ph ^= 1;
          hop::mbar_wait(&s.full[st], ph);
          load_a(s.q[st], 0, off_e, off_o, a[0]);
          hop::fence_regs<4>(a[0]);
        }
        // the group's last stage
        stage_products(acc, a, s.x[st], s.q[st], gsteps == 1, off_e, off_o,
                       release, lane);
        hop::wg_wait<0>();
        hop::fence_regs<NACC>(acc);
        // the group's exact partial, then its scale, then the running sum
        const float2 sv = *reinterpret_cast<const float2*>(s.sc[st] + cb);
#pragma unroll
        for (int i = 0; i < NACC; ++i)
          facc[i] = __fadd_rn(
              facc[i],
              __fmul_rn(__int2float_rn((int)acc[i]), (i & 2) ? sv.y : sv.x));
        hop::fence_proxy_async();    // q4 and scales read, as above
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&s.empty[st]);
        if (++st == STAGES) st = 0, ph ^= 1;
        if (gi + 1 < groups) {
          hop::mbar_wait(&s.full[st], ph);
          load_a(s.q[st], 0, off_e, off_o, a[0]);
          hop::fence_regs<4>(a[0]);
        }
      }

      // ---- epilogue, while the producer fills the ring for the next
      // tile: fragment row g + 8h is column cb + h, accumulator 4j + 2h + e
      // is token 8j + 2t + e
      const int n = n0 + cb;
      if (n < F) {
#pragma unroll
        for (int j = 0; j < TT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * j + 2 * t + e;
            if (m < M) {
              const float sm = __ldg(sx + m);
              qmma::store2(out + (size_t)m * F + n,
                           __fmul_rn(facc[4 * j + e], sm),
                           __fmul_rn(facc[4 * j + 2 + e], sm));
            }
          }
      }
    }
  }
}

// the layouts this body takes (the wrapper's `w4a8_body` mirrors it)
static inline bool takes(int M, int D, int F, int G) {
  if (M < 1 || G < 1 || D % G) return false;
  const int group = D / G;
  return D % KS == 0 && group % KS == 0 && F % 16 == 0;
}

// xq int8 [M, D], q4 int8 [D/2, F], scale f32 [G, F], sx f32 [M] -> out
// [M, F] in OutT
template <typename OutT>
static inline cudaError_t launch(const int8_t* xq, const int8_t* q4,
                                 const float* scale, const float* sx,
                                 OutT* out, int M, int D, int F, int G,
                                 cudaStream_t st) {
  if (!takes(M, D, F, G)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(q4) |
       reinterpret_cast<uintptr_t>(scale)) & 15)
    return cudaErrorMisalignedAddress;
  CUtensorMap xmap, qmap, smap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)D};
  const cuuint32_t xbox[2] = {KS, TT};
  cudaError_t e = hop::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq,
                                xdims, xstr, xbox,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const cuuint64_t qdims[2] = {(cuuint64_t)F, (cuuint64_t)(D / 2)};
  const cuuint64_t qstr[1] = {(cuuint64_t)F};
  const cuuint32_t qbox[2] = {TC, KP};
  e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q4, qdims, qstr,
                    qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const cuuint64_t sdims[2] = {(cuuint64_t)F, (cuuint64_t)G};
  const cuuint64_t sstr[1] = {(cuuint64_t)F * 4};
  const cuuint32_t sbox[2] = {TC, 1};
  e = hop::make_map(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scale, sdims,
                    sstr, sbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(w4a8_wgmma<OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  // persistent: one CTA an SM (at most), each walking the tiles in turn
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + TT - 1) / TT) * ((F + TC - 1) / TC);
  w4a8_wgmma<OutT><<<min(tiles, sms), NTHREADS, SMEM_BYTES, st>>>(
      xmap, qmap, smap, sx, out, M, D, F, D / G);
  return cudaGetLastError();
}

}  // namespace k6w
