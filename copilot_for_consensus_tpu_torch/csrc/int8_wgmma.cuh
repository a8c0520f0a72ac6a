// K2's tiled path (bf16 x, M > 8: the prefill waves) as a Hopper GEMM with
// mixed inputs: wgmma tensor-core products fed by TMA through a ring of
// shared-memory stages, the int8 weight converted to bf16 on chip. Included
// by int8_matmul.cu; the decode bodies (M <= 8), f32 x and the layouts this
// body does not take keep their own bodies there.
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `int8_matmul`
//   (pallas_call) and its body `_kernel`, at prefill extents.
//
// What bounds it on this card: at the int8 admission waves (M = 2048-4096
// rows against 4096-14336 deep weights) it does ~2 M flops per weight byte
// and ~2 F per x byte, far above the ~295 flop/byte bf16 ridge: bound by
// operations on the bf16 tensor cores (989 TFLOP/s), which only wgmma
// reaches. The design is K5's (int4_wgmma.cuh) with one group of depth D
// and an 8-bit conversion:
//   * One CTA owns a 128 x TN output tile: two consumer warpgroups of 64
//     rows each and a producer warpgroup, which gives most of its registers
//     to the consumers (setmaxnreg: 40 against 232). One producer thread
//     keeps STAGES k-steps of 64 in flight with TMA: an x tile [128 rows,
//     64 k] (bf16, 128-byte swizzle: wgmma's K-major A) and the weight tile
//     [64 k, TN columns] (int8, unswizzled), each stage under a full and an
//     empty mbarrier.
//   * q's natural layout is [k][n] with n contiguous: wgmma's MN-major B.
//     Each consumer warpgroup converts half of the stage's 64 rows into a
//     bf16 B tile in that swizzled layout (three tiles in a ring), then
//     fence.proxy.async and a barrier of the 256 consumer threads. A step
//     issues 4 wgmma m64nTNk16 on its stage, retires the step before and
//     releases its stage, then converts the next stage while its own
//     products run: a B tile is rewritten only after both warpgroups'
//     products of it retired.
//   * int8 to bf16, exactly: bf16 has 8 significant bits, too few for
//     K5's 0x4300 | nibble trick on a whole byte, so the byte goes through
//     f32: (v + 128) in the low mantissa bits of 2^23 is the f32 2^23 +
//     128 + v (one byte permute), minus 2^23 + 128 it is v exactly, and a
//     pair of such values rounds to one bf16x2 word without loss.
//   * No groups: the f32 accumulator runs over all of D, and the epilogue
//     folds the per-column scale once, acc * scale[n] in f32 (__fmul_rn),
//     rounded to bf16 once, as the reference does at finalize. With one
//     accumulator (TN / 2 f32 a thread) the registers leave room for a
//     256-column tile.
//   * Tile width TN (128 or 256) is the wrapper's choice (`int8_tile_n`):
//     256 columns read each x tile from L2 for twice the products and halve
//     the B tile's share of the wgmma operand traffic, but where 256-wide
//     tiles would not fill one wave of 132 SMs (the k and v projections'
//     F 1024, or few rows) the CTAs are 128 wide.
//   * Ragged M and F: TMA fills rows and columns outside x and q with
//     zeros, the epilogue masks its stores. Output tiles are visited in
//     groups of 8 row tiles so the x rows and weight columns in flight
//     stay in L2.
// It takes D % 64 and F % 16 (TMA's 16-byte row pitch); the wrapper routes
// any other layout to the WMMA body of int8_matmul.cu.

#pragma once

#include "hopper.cuh"

namespace k2w {

constexpr int TM = 128;        // output rows a CTA (two warpgroups of 64)
constexpr int KS = 64;         // k a stage
constexpr int STAGES = 4;      // TMA ring depth
constexpr int BBUFS = 3;       // converted B tiles in flight
constexpr int NCONS = 256;     // consumer threads
constexpr int NTHREADS = NCONS + 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int GROUP_M = 8;     // row tiles a raster group
constexpr uint32_t A_BYTES = TM * KS * 2;        // 16 KB

template <int TN>
struct Smem {
  alignas(1024) __nv_bfloat16 a[STAGES][TM * KS];
  alignas(1024) __nv_bfloat16 b[BBUFS][KS * TN];
  alignas(128) int8_t q[STAGES][KS * TN];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
template <int TN>
constexpr size_t smem_bytes() {
  return sizeof(Smem<TN>) + 1024;   // + alignment slack
}
static_assert(smem_bytes<256>() <= 232448, "K2's tile over shared memory");

// the byte offset of 16-byte chunk `c` (0..7) of line `r` in a 128-byte
// swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// four signed bytes -> bf16x2 of bytes 0, 1 and bf16x2 of bytes 2, 3
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& p01,
                                          uint32_t& p23) {
  const uint32_t u = w ^ 0x80808080u;            // v + 128, unsigned
  const float magic = 8388736.f;                 // 2^23 + 128
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - magic;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - magic;
  const float f2 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - magic;
  const float f3 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - magic;
  const __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f2, f3);
  p01 = *reinterpret_cast<const uint32_t*>(&a);
  p23 = *reinterpret_cast<const uint32_t*>(&b);
}

// convert rows [r0, r0 + 32) of a stage's weight tile (32 k rows x TN
// columns of int8) into the MN-major B tile; 128 threads, each 16 columns
// of a row at a time
template <int TN>
__device__ __forceinline__ void convert_half(const int8_t* q, uint8_t* b,
                                             int r0, int t) {
  constexpr int CPR = TN / 16;   // 16-byte chunks of a weight row
#pragma unroll
  for (int i = 0; i < 32 * CPR / 128; ++i) {
    const int u = t + 128 * i;
    const int r = r0 + u / CPR, c16 = u % CPR;
    const uint4 w = *reinterpret_cast<const uint4*>(q + r * TN + c16 * 16);
    uint4 lo, hi;
    i8x4_bf16(w.x, lo.x, lo.y);
    i8x4_bf16(w.y, lo.z, lo.w);
    i8x4_bf16(w.z, hi.x, hi.y);
    i8x4_bf16(w.w, hi.z, hi.w);
    uint8_t* blk = b + (c16 >> 2) * (KS * 128);   // 64-column block
    const int c = (c16 & 3) * 2;                  // its 8-column chunk
    *reinterpret_cast<uint4*>(blk + swz(r, c)) = lo;
    *reinterpret_cast<uint4*>(blk + swz(r, c + 1)) = hi;
  }
}

template <int TN>
__device__ __forceinline__ void mma(float* acc, uint64_t da, uint64_t db) {
  if constexpr (TN == 256)
    hop::wgmma_ss_n256<1>(acc, da, db, 1);
  else
    hop::wgmma_ss_n128<1>(acc, da, db, 1);
}

template <int TN>
__global__ void __launch_bounds__(NTHREADS, 1)
int8_wgmma(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap qmap,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
           int M, int D, int F) {
  extern __shared__ uint8_t raw[];
  Smem<TN>& s = *reinterpret_cast<Smem<TN>*>(
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
      for (int k = 0; k < ksteps; ++k) {
        const int st = k % STAGES;
        hop::mbar_wait(&s.empty[st], ((k / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&s.full[st], A_BYTES + KS * TN);
        hop::tma_load_2d(s.a[st], &xmap, &s.full[st], k * KS, m0);
        hop::tma_load_2d(s.q[st], &qmap, &s.full[st], n0, k * KS);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64).
    // Step k: issue the products of stage k, retire step k - 1 and release
    // its stage, then convert stage k + 1 while step k's products run.
    hop::reg_alloc<CONSUMER_REGS>();
    const int wg = hop::warpgroup(), t = tid & 127;
    const int lane = tid & 31, warp = t >> 5;
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;

    hop::mbar_wait(&s.full[0], 0);
    convert_half<TN>(s.q[0], reinterpret_cast<uint8_t*>(s.b[0]), wg * 32, t);
    hop::fence_proxy_async();
    hop::named_sync(1, NCONS);

    for (int k = 0; k < ksteps; ++k) {
      const int st = k % STAGES;
      const uint8_t* at =
          reinterpret_cast<const uint8_t*>(s.a[st]) + wg * 64 * 128;
      const uint8_t* bt = reinterpret_cast<const uint8_t*>(s.b[k % BBUFS]);
      hop::fence_regs<TN / 2>(acc);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
        mma<TN>(acc, hop::desc_sw128(at + kk * 32, 16, 1024),
                hop::desc_sw128(bt + kk * 16 * 128, KS * 128, 1024));
      hop::wg_commit();
      hop::wg_wait<1>();
      hop::fence_regs<TN / 2>(acc);
      if (lane == 0 && k > 0) hop::mbar_arrive(&s.empty[(k - 1) % STAGES]);

      if (k + 1 < ksteps) {
        const int nx = (k + 1) % STAGES;
        hop::mbar_wait(&s.full[nx], ((k + 1) / STAGES) & 1);
        convert_half<TN>(s.q[nx],
                         reinterpret_cast<uint8_t*>(s.b[(k + 1) % BBUFS]),
                         wg * 32, t);
        hop::fence_proxy_async();
        hop::named_sync(1, NCONS);
      }
    }
    hop::wg_wait<0>();
    hop::fence_regs<TN / 2>(acc);

    // ---- epilogue: rows 16 warp + lane / 4 (+ 8), columns 8j + 2 (lane %
    // 4) (+ 1); the scale in f32, one rounding to bf16
    const int r = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= F) continue;
      const float2 sv = __ldg(reinterpret_cast<const float2*>(scale + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r + 8 * h;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * F + n) =
              __floats2bfloat162_rn(__fmul_rn(acc[4 * j + 2 * h], sv.x),
                                    __fmul_rn(acc[4 * j + 2 * h + 1], sv.y));
      }
    }
  }
}

template <int TN>
cudaError_t launch_tn(const void* x, const int8_t* q, const float* scale,
                      __nv_bfloat16* out, int M, int D, int F,
                      cudaStream_t st) {
  CUtensorMap xmap, qmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t xstr[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {KS, TM};
  cudaError_t e = hop::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                                xdims, xstr, xbox,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const cuuint64_t qdims[2] = {(cuuint64_t)F, (cuuint64_t)D};
  const cuuint64_t qstr[1] = {(cuuint64_t)F};
  const cuuint32_t qbox[2] = {TN, KS};
  e = hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstr,
                    qbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int8_wgmma<TN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<TN>());
  if (e != cudaSuccess) return e;
  const int tiles = ((M + TM - 1) / TM) * ((F + TN - 1) / TN);
  int8_wgmma<TN><<<tiles, NTHREADS, smem_bytes<TN>(), st>>>(
      xmap, qmap, scale, out, M, D, F);
  return cudaGetLastError();
}

// x bf16 [M, D], q int8 [D, F], scale f32 [F] -> out bf16 [M, F]; tn is
// the CTA's output columns, 128 or 256
static inline cudaError_t launch(const void* x, const int8_t* q,
                                 const float* scale, __nv_bfloat16* out,
                                 int M, int D, int F, int tn,
                                 cudaStream_t st) {
  if (D % KS || F % 16) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(out)) &
      15)
    return cudaErrorMisalignedAddress;
  if (tn == 128) return launch_tn<128>(x, q, scale, out, M, D, F, st);
  if (tn == 256) return launch_tn<256>(x, q, scale, out, M, D, F, st);
  return cudaErrorInvalidValue;
}

}  // namespace k2w
