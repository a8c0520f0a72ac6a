// K4's tiled path (the a8 prefill waves: M >= 1024 rows on the serving
// path) as a Hopper int8 GEMM: wgmma with s32 accumulators over the whole
// contraction, fed by TMA through a ring of shared-memory stages. Included
// by w8a8_matmul.cu; the layouts this body refuses keep the mma.sync tiling
// of quant_mma.cuh.
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `w8a8_matmul`
//   (pallas_call) and its body `_kernel_w8a8`, at prefill extents.
//
// What bounds it on this card: at the 4 x 1024 a8 wave (M = 4096 rows
// against 4096-14336 deep int8 weights) it does ~2M / (M + F) operations per
// byte, far above the ~590 op/byte int8 ridge: bound by operations on the
// int8 tensor cores (1,979 TOP/s), which only wgmma reaches. Nearer than
// that, a tile reads its operands again from L2 for every 128 columns (xq)
// and every 256 tokens (q): ~175 operations per L2 byte. The design:
//   * Swapped operands: out^T = W^T xq^T. wgmma on 8-bit types takes
//     K-major operands only, and q is [k][n] with n contiguous, so the
//     weight is wgmma's register A (K-major by definition) and the int8
//     activations xq, [tokens, k] with k contiguous, its shared B as TMA
//     brings them. Neither operand is transposed in memory: q stays the
//     [D, F] leaf K2 also reads.
//   * One CTA owns 128 output columns x 256 tokens: two consumer
//     warpgroups of 64 columns each (wgmma m64n256k32, 128 s32 partials a
//     thread) and a producer warpgroup, which gives most of its registers
//     to the consumers (setmaxnreg: 40 against 232). One producer thread
//     keeps STAGES k-steps of 128 in flight with TMA, each under a full and
//     an empty mbarrier: xq [256 tokens, 128 k] (32 KB) and q [128 k, 128
//     columns] (16 KB), both in the 128-byte swizzle. 256 tokens divide the
//     4 x 1024 wave.
//   * The A fragment: fragment rows g and g + 8 of warp w (lane = 4g + t)
//     are the adjacent columns 64 wg + 16 w + 2g and + 1, so warp w reads
//     one 16-byte chunk of each k row, and a 16-bit element of that chunk
//     is the lane's two columns at one k. One ldmatrix.x4.trans a k32 step
//     gives lane (g, t) four such elements per matrix pair: matrices 0 and
//     1 hold k 4t .. 4t + 3 (in two pairs), 2 and 3 the same at k + 16, and
//     two byte permutes a pair split the columns, which leaves each column's
//     four k in order: the m16n8k32 s8 A fragment wgmma takes. The rows a
//     matrix reads are chosen so the eight have distinct k % 8 and so hit
//     eight distinct chunks of the swizzle (conflict-free): lanes t = 0, 1
//     take their pair {4t, 4t + 1} from matrix 0, lanes t = 2, 3 theirs
//     from matrix 1, and their byte permute selects the other way round.
//     A's registers are double-buffered: step j + 1 is loaded while wgmma j
//     runs, after wgmma j - 1, the last reader of that buffer, has retired.
//   * One s32 chain over the whole contraction (|acc| <= 127 * 128 * D <
//     2^31 up to D 132,104): the first product of a tile starts it with
//     scale-d 0. The epilogue takes cvt.rn.f32.s32 (exactly as the plain
//     version's f32 cast of its exact sum rounds), __fmul_rn by sx[token],
//     __fmul_rn by sw[column], one rounding to x's dtype: the plain
//     version's arithmetic, operation for operation, so the two are equal
//     bit for bit.
//   * Persistent CTAs, one an SM, each walking the output tiles in turn:
//     the producer fills the ring for the next tile while the consumers
//     store. Tiles are visited in groups of 8 token tiles so the xq rows
//     and weight columns in flight stay in L2.
//   * Ragged M and F: TMA fills tokens and columns outside xq and q with
//     zeros, the epilogue masks its stores.
// It takes D % 128 and F % 16 (TMA's 16-byte row pitch of q); the wrapper
// routes any other layout to the mma.sync tiling (quant_mma.cuh). x's
// dtype changes only the store.

#pragma once

#include "hopper.cuh"
#include "quant_mma.cuh"

namespace k4w {

constexpr int TT = 256;        // tokens a CTA: wgmma N
constexpr int TC = 128;        // output columns a CTA: two warpgroups of 64
constexpr int KS = 128;        // k a stage: one 128-byte line of xq
constexpr int STAGES = 4;      // TMA ring depth
constexpr int NCONS = 256;     // consumer threads
constexpr int NTHREADS = NCONS + 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int GROUP_M = 8;     // token tiles a raster group
constexpr int NACC = TT / 2;   // s32 partials a thread
constexpr uint32_t X_BYTES = TT * KS;      // 32 KB
constexpr uint32_t Q_BYTES = KS * TC;      // 16 KB

struct Smem {
  alignas(1024) uint8_t x[STAGES][X_BYTES];
  alignas(1024) uint8_t q[STAGES][Q_BYTES];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;   // + alignment slack

// the A fragment of k32 step j of a stage's q tile (shared address q_addr):
// `off` is the lane's swizzled row offset, sel0 / sel1 its byte permutes
// for the even and odd column
__device__ __forceinline__ void load_a(uint32_t q_addr, int j, uint32_t off,
                                       uint32_t sel0, uint32_t sel1,
                                       uint32_t* a) {
  uint32_t r0, r1, r2, r3;
  hop::ldsm_x4_t(q_addr + j * 32 * 128 + off, r0, r1, r2, r3);
  a[0] = __byte_perm(r0, r1, sel0);   // column cb, k 4t .. 4t + 3
  a[1] = __byte_perm(r0, r1, sel1);   // column cb + 1
  a[2] = __byte_perm(r2, r3, sel0);   // the same at k + 16
  a[3] = __byte_perm(r2, r3, sel1);
}

// the four k32 products of one stage (x tile xt, q tile at q_addr), A's
// step 0 already in a[0]: issue product j, retire j - 1, load step j + 1
// into the buffer j - 1 read. The first product starts the accumulators
// from zero when `first` (a tile's first stage), and once it is issued the
// products before it have retired, so `release` (the previous stage's empty
// barrier, or null) is arrived on. Leaves the fourth product, and possibly
// the third, in flight.
__device__ __forceinline__ void stage_products(uint32_t* acc,
                                               uint32_t (&a)[2][4],
                                               const uint8_t* xt,
                                               uint32_t q_addr, bool first,
                                               uint32_t off, uint32_t sel0,
                                               uint32_t sel1,
                                               uint64_t* release, int lane) {
#pragma unroll
  for (int j = 0; j < KS / 32; ++j) {
    hop::fence_regs<NACC>(acc);
    hop::wg_fence();
    hop::wgmma_rs_s8_n256(acc, a[j & 1],
                          hop::desc_sw128(xt + 32 * j, 16, 1024),
                          (j > 0 || !first) ? 1 : 0);
    hop::wg_commit();
    if (j + 1 < KS / 32) {
      hop::wg_wait<1>();
      if (j == 0 && release != nullptr) {
        // the stage's q was read through the generic proxy (ldmatrix)
        // and the producer's next TMA writes it through the async proxy:
        // order the reads before the release
        hop::fence_proxy_async();
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(release);
      }
      load_a(q_addr, j + 1, off, sel0, sel1, a[(j + 1) & 1]);
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
w8a8_wgmma(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap qmap,
           const float* __restrict__ scale, const float* __restrict__ sx,
           OutT* __restrict__ out, int M, int D, int F) {
  extern __shared__ uint8_t raw[];
  Smem& s = *reinterpret_cast<Smem*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  const int tiles_m = (M + TT - 1) / TT, tiles_n = (F + TC - 1) / TC;
  const int tiles = tiles_m * tiles_n;
  const int ksteps = D / KS;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&s.full[i], 1);
      hop::mbar_init(&s.empty[i], NCONS / 32);   // one arrive a warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (hop::warpgroup() == NCONS / 128) {
    // ---- producer: one thread keeps the ring full
    hop::reg_dealloc<PRODUCER_REGS>();
    if (tid == NCONS) {
      int st = 0;
      uint32_t ph = 0;   // the parity of the ring's current pass
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, tiles_m, tiles_n, m0, n0);
        for (int k = 0; k < ksteps; ++k) {
          hop::mbar_wait(&s.empty[st], ph ^ 1);
          hop::mbar_expect_tx(&s.full[st], X_BYTES + Q_BYTES);
          hop::tma_load_2d(s.x[st], &xmap, &s.full[st], k * KS, m0);
          hop::tma_load_2d(s.q[st], &qmap, &s.full[st], n0, k * KS);
          if (++st == STAGES) st = 0, ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns columns [n0 + 64 wg, + 64)
    hop::reg_alloc<CONSUMER_REGS>();
    const int wg = hop::warpgroup();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int cb = 64 * wg + 16 * warp + 2 * g;   // columns cb, cb + 1
    const int c = cb >> 4;                        // their 16-byte chunk
    // the k row whose address this lane gives ldmatrix: row p = lane % 8
    // of matrix lane / 8 (odd matrices the second pair, matrices 2 and 3
    // at k + 16); row p serves lane t' = p / 2 of every g
    const int p = lane & 7, mi = lane >> 3, tp = p >> 1;
    const int k0 = 16 * (mi >> 1) + 4 * tp + (p & 1) +
                   2 * ((mi & 1) ^ (tp >> 1));
    const uint32_t off = k0 * 128 + ((c ^ (k0 & 7)) << 4);
    // lanes t = 0, 1 find k 4t, 4t + 1 in the even matrix; t = 2, 3 in the
    // odd one
    const uint32_t sel0 = t < 2 ? 0x6420u : 0x2064u;
    const uint32_t sel1 = t < 2 ? 0x7531u : 0x3175u;
    uint32_t acc[NACC];
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0u;

    int st = 0;          // the ring slot of the next stage
    uint32_t ph = 0;     // and the parity of its full barrier
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, tiles_m, tiles_n, m0, n0);
      hop::mbar_wait(&s.full[st], ph);
      load_a(hop::smem_u32(s.q[st]), 0, off, sel0, sel1, a[0]);
      hop::fence_regs<4>(a[0]);
      uint64_t* release = nullptr;   // a stage whose last product may run
      for (int k = 0; k + 1 < ksteps; ++k) {
        stage_products(acc, a, s.x[st], hop::smem_u32(s.q[st]), k == 0, off,
                       sel0, sel1, release, lane);
        hop::wg_wait<1>();         // the stage's third product: a[0] free
        release = &s.empty[st];
        if (++st == STAGES) st = 0, ph ^= 1;
        hop::mbar_wait(&s.full[st], ph);
        load_a(hop::smem_u32(s.q[st]), 0, off, sel0, sel1, a[0]);
        hop::fence_regs<4>(a[0]);
      }
      // the tile's last stage
      stage_products(acc, a, s.x[st], hop::smem_u32(s.q[st]), ksteps == 1,
                     off, sel0, sel1, release, lane);
      hop::wg_wait<0>();
      hop::fence_regs<NACC>(acc);
      hop::fence_proxy_async();    // q read by ldmatrix, as above
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&s.empty[st]);
      if (++st == STAGES) st = 0, ph ^= 1;

      // ---- epilogue, while the producer fills the ring for the next
      // tile: fragment row g + 8h is column cb + h, accumulator 4j + 2h + e
      // is token 8j + 2t + e
      const int n = n0 + cb;
      if (n < F) {
        const float2 sw = __ldg(reinterpret_cast<const float2*>(scale + n));
#pragma unroll
        for (int j = 0; j < TT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * j + 2 * t + e;
            if (m < M) {
              const float sm = __ldg(sx + m);
              qmma::store2(
                  out + (size_t)m * F + n,
                  __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + e]),
                                      sm), sw.x),
                  __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 2 + e]),
                                      sm), sw.y));
            }
          }
      }
    }
  }
}

// the layouts this body takes (the wrapper's `w8a8_body` mirrors it)
static inline bool takes(int M, int D, int F) {
  return M >= 1 && D >= KS && D % KS == 0 && F >= 16 && F % 16 == 0;
}

// xq int8 [M, D], q int8 [D, F], scale f32 [F], sx f32 [M] -> out [M, F]
// in OutT
template <typename OutT>
static inline cudaError_t launch(const int8_t* xq, const int8_t* q,
                                 const float* scale, const float* sx,
                                 OutT* out, int M, int D, int F,
                                 cudaStream_t st) {
  if (!takes(M, D, F)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(scale)) & 15)
    return cudaErrorMisalignedAddress;
  CUtensorMap xmap, qmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)D};
  const cuuint32_t xbox[2] = {KS, TT};
  cudaError_t e = hop::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq,
                                xdims, xstr, xbox,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const cuuint64_t qdims[2] = {(cuuint64_t)F, (cuuint64_t)D};
  const cuuint64_t qstr[1] = {(cuuint64_t)F};
  const cuuint32_t qbox[2] = {TC, KS};
  e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstr,
                    qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(w8a8_wgmma<OutT>,
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
  w8a8_wgmma<OutT><<<min(tiles, sms), NTHREADS, SMEM_BYTES, st>>>(
      xmap, qmap, scale, sx, out, M, D, F);
  return cudaGetLastError();
}

}  // namespace k4w
