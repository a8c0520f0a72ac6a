// P's dot and unpack bodies (convdot, i8dot, unpack8, unpack32) as one
// Hopper weight stream: wgmma fed by TMA, the weight as the register A
// operand, x as the shared B, multicast across a cluster of two CTAs, and
// no workspace in device memory. Included by probe_stream.cu; the layouts
// this body refuses keep the mma.sync body there (`probe_gemm`).
//
// Replaces: scripts/probe_stream.py, the pallas_calls of `build` with the
//   bodies `k_convdot`, `k_i8dot` and `k_unpack` (widen False and True).
//
// What bounds it on this card: at the probe's B = 128 x 4096 x 14336 the
// work is 15.03 G operations on 58.7 MB of int8 weight (29.4 MB packed):
// 17.5 us of bytes against 15.2 us of bf16 tensor time at the data
// sheet's peak (convdot: at the bf16 ridge, so only wgmma gets near it),
// and 7.6 us of int8 tensor time (i8dot and unpack: bound by bytes, with
// 2x headroom on the int8 tensor cores). Measured on one H100 (700 W,
// chip_smoke.py's probe phase, L2 flushed): 30-32 us of device time for
// i8dot and unpack, 38 us for convdot. What limits it first: i8dot the
// weight stream itself (1.86 TB/s; a variant that loads no x ran as long);
// convdot and unpack the consumers (the conversion, and at most two wgmma
// in flight a warpgroup; a variant that loads no weight ran about as
// long). Tried on the card and not kept: x laid out stage by stage,
// programmatic dependent launch after the pre-pass, a cheaper exact cvt
// in unpack's fold (none moved the time), and a 4-deep A ring with three
// wgmma in flight (slower). The design:
//   * Swapped operands: out^T = W^T x^T. The weight, [k][n] with n
//     contiguous, becomes wgmma's register A (K-major by definition) with
//     no transpose in memory; x, [tokens][k] with k contiguous, is the
//     K-major shared B as TMA brings it. 128 tokens are one wgmma N.
//   * One CTA owns 128 output columns and the whole contraction: two
//     consumer warpgroups of 64 columns each (m64n128: 64 accumulators a
//     thread) and a producer warpgroup that gives its registers to them
//     (setmaxnreg 40 against 232). One producer thread keeps a ring of
//     stages in flight with TMA, each under a full and an empty mbarrier,
//     in the 128-byte swizzle: 128 k (64 for convdot's bf16 x) a stage,
//     the weight [k, 128 columns] (16 KB int8, 8 KB packed or convdot's
//     64 rows) and x [128 tokens, one 128-byte line] (16 KB). Rings: 8
//     stages for convdot (192 KB), 6 for i8dot (192 KB) and unpack (144
//     KB): 64, 96 and 48 KB of weight in flight an SM.
//   * x from L2 once per cluster: the two CTAs of a cluster own adjacent
//     column tiles over the same k, so each brings half of every x stage
//     (64 tokens) with one TMA multicast into both CTAs' shared memory.
//     Each full barrier expects both halves; each empty barrier counts the
//     consumer warps of both CTAs (each warp arrives on both, after the
//     wgmma that read the stage retired), so neither producer overwrites a
//     stage its peer still reads. The remote arrive takes the default
//     semantics: with .release.cluster every stage took a long fixed time
//     on the card whatever its bytes, and the body ran several times
//     slower. L2 bytes of x per weight byte: 1.0 for convdot (bf16 x, 256
//     bytes a k for 256 weight bytes a k of the cluster), 0.5 for i8dot,
//     1.0 for unpack (packed weight); without the multicast twice that.
//   * Grid: F / 128 CTAs in clusters of 2 (112 CTAs, 56 clusters at F
//     14336), one CTA an SM (the ring's shared memory), one wave: 112 of
//     132 SMs busy, 85% — the same as 224 half-depth CTAs in two waves,
//     without their cross-CTA combine. 64 columns a CTA would give 224
//     CTAs and read x twice as often.
//   * No workspace: the contraction tiles of the function (bd 2048 for
//     convdot, gdp * groups packed rows for unpack) follow one another in
//     the CTA and are combined in a fixed order, (0 + part0) + part1 + ...:
//     convdot in registers (64 sums beside the 64 accumulators), unpack
//     through shared memory (64 KB, one slot a thread: its part and
//     accumulators already hold 128 registers). No second launch.
//   * The A fragment, per conversion (each the port's proven loader):
//     fragment rows g and g + 8 of warp w (lane = 4g + t) are the adjacent
//     columns cb = 64 wg + 16 w + 2g and cb + 1.
//       - i8dot: K4's ldmatrix.x4.trans and four byte permutes a k32 step
//         (w8a8_wgmma.cuh), rows chosen so the eight of a matrix hit eight
//         swizzle chunks.
//       - convdot: one ldmatrix.x2.trans a k16 step: matrix 0 holds k rows
//         0-7 and matrix 1 rows 8-15 of the lane's chunk, so lane (g, t)
//         gets the 16-bit column pair (cb, cb + 1) at k 2t and 2t + 1 in
//         one register (and at 2t + 8, 2t + 9 in the other); each byte goes
//         to bf16 exactly with K2's 2^23 + 128 trick (int8_stream.cuh's
//         pair_byte), two bytes of one register a bf16x2.
//       - unpack8: K6's four 16-bit loads (packed rows 2t, 2t + 1, 2t + 8,
//         2t + 9) and its nibble unpack in the int8 domain,
//         ((v ^ 8) | 0x80) - 8 then ^ 0x80, four nibbles a word
//         (w4a8_wgmma.cuh, quant_mma.cuh's nibble_quads).
//       - unpack32: the same loads, each nibble widened through int32 as
//         the reference's widen=True does: p = int32(signed byte),
//         ((p & 0xF) ^ 8) - 8 and p >> 4, then packed back to bytes.
//     A's registers are double-buffered: step j + 1 is loaded while wgmma
//     j runs, after wgmma j - 1, the last reader of that buffer, retired.
//   * The reference's arithmetic where it is exact:
//       - i8dot: one s32 chain over the whole contraction (|acc| <= 127^2
//         * D < 2^31), cvt.rn.f32.s32, __fmul_rn by 1e-4f, one bf16
//         rounding: i8dot_ref's, bit for bit.
//       - unpack: each group's first wgmma starts its s32 accumulator with
//         scale-d 0; after the group's last product the exact partial is
//         cvt.rn to f32, __fmul_rn by f32(1e-4 (g + 1)) (g within its
//         tile), __fadd_rn in group order into the tile's part; the parts
//         are added in tile order from 0: unpack_ref's, bit for bit.
//       - convdot: f32 sums of exact products in tensor-core order within
//         a bd tile, the tiles added in order from 0.
//   * i8dot's truncation of x and unpack's clip(rint(x * 16), +-127) are
//     made once a call by a pre-pass kernel into int8 x (probe_stream.cu's
//     `x_int8`), as the TPU wrapper does outside its pallas_call.
// It takes 1 <= B <= 128, F % 256 == 0 (two 128-column tiles a cluster,
// TMA's 16-byte row pitch), and D whole stages: bd % 64 for convdot, D %
// 128 for i8dot, a group of 2 * gdp unpacked rows a multiple of 128 for
// unpack. The wrapper's `probe_body` mirrors `takes`.

#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "quant_mma.cuh"

namespace pw {

enum Mode { CONVDOT = 1, I8DOT = 2, UNPACK8 = 3, UNPACK32 = 4 };

constexpr int TT = 128;        // tokens: wgmma N
constexpr int TC = 128;        // output columns a CTA: two warpgroups of 64
constexpr int CL = 2;          // CTAs a cluster, adjacent column tiles
constexpr int NCONS = 256;     // consumer threads
constexpr int NTHREADS = NCONS + 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int NACC = TT / 2;   // accumulators a thread
constexpr int LINE = 128;      // bytes of a swizzled line
constexpr uint32_t X_BYTES = TT * LINE;          // an x stage: 16 KB
constexpr uint32_t X_PART = X_BYTES / CL;        // the half a CTA brings

template <int MODE>
struct Cfg {
  static constexpr bool UNPACK = MODE == UNPACK8 || MODE == UNPACK32;
  static constexpr int KS = MODE == CONVDOT ? 64 : 128;   // k a stage
  static constexpr int WROWS = UNPACK ? KS / 2 : KS;      // weight rows
  static constexpr int STAGES = MODE == CONVDOT ? 8 : 6;
  static constexpr int STEPS = 4;           // wgmma a stage: k16 or k32
  static constexpr uint32_t W_BYTES = WROWS * TC;
  using Acc = typename std::conditional<MODE == CONVDOT, float,
                                        uint32_t>::type;
};

template <int MODE>
struct Smem {
  using C = Cfg<MODE>;
  alignas(1024) uint8_t x[C::STAGES][X_BYTES];
  alignas(1024) uint8_t w[C::STAGES][C::W_BYTES];
  // unpack: the tiles' running sum, one column of slots a thread
  alignas(16) float total[C::UNPACK ? NACC * NCONS : 4];
  uint64_t full[C::STAGES];
  uint64_t empty[C::STAGES];
};
template <int MODE>
constexpr size_t smem_bytes() { return sizeof(Smem<MODE>) + 1024; }

// ---------------------------------------------------------------------------
// A fragments
// ---------------------------------------------------------------------------

// bytes J0 and J1 of u (already ^ 0x80) -> bf16x2 {low: J0, high: J1} as
// signed values, exactly (K2's pair_byte on two bytes of one word)
template <int J0, int J1>
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t u) {
  const float magic = 8388736.f;              // 2^23 + 128
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + J0)) - magic;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + J1)) - magic;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
}

// byte b of the packed words e (row 2r) and o (row 2r + 1) -> k 4r .. 4r +
// 3 of that column as four signed bytes, each nibble widened through int32
__device__ __forceinline__ uint32_t quad_int32(uint32_t e, uint32_t o,
                                               int b) {
  const int pe = (int)(signed char)((e >> (8 * b)) & 0xffu);
  const int po = (int)(signed char)((o >> (8 * b)) & 0xffu);
  const int v0 = ((pe & 0xF) ^ 8) - 8, v1 = pe >> 4;
  const int v2 = ((po & 0xF) ^ 8) - 8, v3 = po >> 4;
  return ((uint32_t)v0 & 0xffu) | (((uint32_t)v1 & 0xffu) << 8) |
         (((uint32_t)v2 & 0xffu) << 16) | (((uint32_t)v3 & 0xffu) << 24);
}

// the lane's A-fragment loader for one mode: set up once from (warpgroup,
// warp, lane), then `load(stage, j, a)` fills the four A registers of
// wgmma step j of a weight stage
template <int MODE>
struct Frag;

template <>
struct Frag<I8DOT> {        // K4's: ldmatrix.x4.trans, byte permutes
  uint32_t off, sel0, sel1;
  __device__ __forceinline__ Frag(int wg, int warp, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const int c = (64 * wg + 16 * warp + 2 * g) >> 4;
    const int p = lane & 7, mi = lane >> 3, tp = p >> 1;
    const int k0 = 16 * (mi >> 1) + 4 * tp + (p & 1) +
                   2 * ((mi & 1) ^ (tp >> 1));
    off = k0 * LINE + ((c ^ (k0 & 7)) << 4);
    sel0 = t < 2 ? 0x6420u : 0x2064u;
    sel1 = t < 2 ? 0x7531u : 0x3175u;
  }
  __device__ __forceinline__ void load(const uint8_t* w, int j,
                                       uint32_t* a) const {
    uint32_t r0, r1, r2, r3;
    hop::ldsm_x4_t(hop::smem_u32(w) + j * 32 * LINE + off, r0, r1, r2, r3);
    a[0] = __byte_perm(r0, r1, sel0);   // column cb, k 4t .. 4t + 3
    a[1] = __byte_perm(r0, r1, sel1);   // column cb + 1
    a[2] = __byte_perm(r2, r3, sel0);   // the same at k + 16
    a[3] = __byte_perm(r2, r3, sel1);
  }
};

template <>
struct Frag<CONVDOT> {      // ldmatrix.x2.trans, bytes to bf16 exactly
  uint32_t off;
  __device__ __forceinline__ Frag(int wg, int warp, int lane) {
    const int c = (64 * wg + 16 * warp) >> 4;
    const int k = lane & 15;   // row k % 8 of matrix k / 8 (lanes 16-31:
                               // the same, unread)
    off = k * LINE + ((c ^ (k & 7)) << 4);
  }
  __device__ __forceinline__ void load(const uint8_t* w, int j,
                                       uint32_t* a) const {
    uint32_t r0, r1;
    hop::ldsm_x2_t(hop::smem_u32(w) + j * 16 * LINE + off, r0, r1);
    r0 ^= 0x80808080u;        // bytes: (cb, cb + 1) at k 2t, then at 2t + 1
    r1 ^= 0x80808080u;        // the same at k 2t + 8, 2t + 9
    a[0] = bytes_bf16x2<0, 2>(r0);   // row g (column cb), k 2t, 2t + 1
    a[1] = bytes_bf16x2<1, 3>(r0);   // row g + 8 (column cb + 1)
    a[2] = bytes_bf16x2<0, 2>(r1);   // row g, k 2t + 8, 2t + 9
    a[3] = bytes_bf16x2<1, 3>(r1);   // row g + 8
  }
};

// K6's loads: the packed bytes of columns (cb, cb + 1) at packed rows 2t,
// 2t + 1 (k 4t .. 4t + 3) and 2t + 8, 2t + 9 (k + 16), 16 bits each
struct PackedLoads {
  uint32_t off_e, off_o;
  __device__ __forceinline__ PackedLoads(int wg, int warp, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const int cb = 64 * wg + 16 * warp + 2 * g, c = cb >> 4;
    off_e = 2 * t * LINE + ((c ^ (2 * t)) << 4) + 2 * g;
    off_o = (2 * t + 1) * LINE + ((c ^ (2 * t + 1)) << 4) + 2 * g;
  }
  __device__ __forceinline__ void words(const uint8_t* w, int j,
                                        uint32_t* h) const {
    const uint8_t* p = w + j * 16 * LINE;
    h[0] = *reinterpret_cast<const uint16_t*>(p + off_e);
    h[1] = *reinterpret_cast<const uint16_t*>(p + off_o);
    h[2] = *reinterpret_cast<const uint16_t*>(p + 1024 + off_e);
    h[3] = *reinterpret_cast<const uint16_t*>(p + 1024 + off_o);
  }
};

template <>
struct Frag<UNPACK8> : PackedLoads {     // in the int8 domain
  __device__ __forceinline__ Frag(int wg, int warp, int lane)
      : PackedLoads(wg, warp, lane) {}
  __device__ __forceinline__ void load(const uint8_t* w, int j,
                                       uint32_t* a) const {
    uint32_t h[4];
    words(w, j, h);
    qmma::nibble_quads<0>(h[0], h[1], a[0], a[1]);   // k 4t .. 4t + 3
    qmma::nibble_quads<0>(h[2], h[3], a[2], a[3]);   // k 16 + 4t .. + 3
  }
};

template <>
struct Frag<UNPACK32> : PackedLoads {    // through int32
  __device__ __forceinline__ Frag(int wg, int warp, int lane)
      : PackedLoads(wg, warp, lane) {}
  __device__ __forceinline__ void load(const uint8_t* w, int j,
                                       uint32_t* a) const {
    uint32_t h[4];
    words(w, j, h);
    a[0] = quad_int32(h[0], h[1], 0);   // column cb, k 4t .. 4t + 3
    a[1] = quad_int32(h[0], h[1], 1);   // column cb + 1
    a[2] = quad_int32(h[2], h[3], 0);   // the same at k + 16
    a[3] = quad_int32(h[2], h[3], 1);
  }
};

// ---------------------------------------------------------------------------
// the body
// ---------------------------------------------------------------------------

template <int MODE>
__device__ __forceinline__ void mma(typename Cfg<MODE>::Acc* acc,
                                    const uint32_t* a, uint64_t db,
                                    int scale_d) {
  if constexpr (MODE == CONVDOT)
    hop::wgmma_rs_n128<0>(acc, a, db, scale_d);
  else
    hop::wgmma_rs_s8_n128(acc, a, db, scale_d);
}

// every consumer warp of the cluster arrives once on each CTA's empty
// barrier of a stage: both producers write into it. The warp read the
// stage's weight tile through the generic proxy (ldmatrix or ld.shared)
// and the next TMA writes it through the async proxy: the reads are
// ordered first.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  hop::fence_proxy_async();
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < CL; ++r) hop::mbar_arrive_cluster(bar, r);
  }
}

// the four products of one stage (x tile xt, weight tile wt), A's step 0
// already in a[0]: issue product j, retire j - 1, load step j + 1 into the
// buffer j - 1 read. The first product starts the accumulators from zero
// when `first` (a segment's first stage); once it is issued the products
// before it have retired, so `prev` (the previous stage's empty barrier,
// or null) is released. Leaves the fourth product, and possibly the third,
// in flight.
template <int MODE>
__device__ __forceinline__ void stage_products(
    typename Cfg<MODE>::Acc* acc, uint32_t (&a)[2][4], const uint8_t* xt,
    const uint8_t* wt, bool first, const Frag<MODE>& fr, uint64_t* prev,
    int lane) {
#pragma unroll
  for (int j = 0; j < Cfg<MODE>::STEPS; ++j) {
    hop::fence_regs<NACC>(acc);
    hop::wg_fence();
    mma<MODE>(acc, a[j & 1], hop::desc_sw128(xt + 32 * j, 16, 1024),
              (j > 0 || !first) ? 1 : 0);
    hop::wg_commit();
    if (j + 1 < Cfg<MODE>::STEPS) {
      hop::wg_wait<1>();
      if (j == 0 && prev != nullptr) release(prev, lane);
      fr.load(wt, j + 1, a[(j + 1) & 1]);
      hop::fence_regs<4>(a[(j + 1) & 1]);
    }
  }
}

// x: bf16 [B, D] (convdot) or int8 [B, D]; w: int8 [D, F] or packed [D/2,
// F]; out bf16 [B, F]. A segment is `seg` stages that one accumulator
// chain covers (convdot: a bd tile; i8dot: all of D; unpack: a group), a
// contraction tile `per_tile` segments (unpack: its groups; else 1).
template <int MODE>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NTHREADS, 1)
probe_wgmma(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap wmap,
            __nv_bfloat16* __restrict__ out, int B, int D, int F, int seg,
            int per_tile) {
  using C = Cfg<MODE>;
  using Acc = typename C::Acc;
  extern __shared__ uint8_t raw[];
  // the same offset in every CTA: multicast writes land at the sender's
  // offsets in each receiver
  Smem<MODE>& s = *reinterpret_cast<Smem<MODE>*>(
      raw + ((1024 - (hop::smem_u32(raw) & 1023)) & 1023));

  const int tid = threadIdx.x;
  const int stages = D / C::KS;
  const int n0 = blockIdx.x * TC;

  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      hop::mbar_init(&s.full[i], 1);
      hop::mbar_init(&s.empty[i], CL * NCONS / 32);   // each warp, each CTA
    }
    hop::fence_barrier_init();
  }
  // every barrier of the cluster is live before any CTA sends to it
  hop::cluster_sync();

  if (hop::warpgroup() == NCONS / 128) {
    // ---- producer: one thread keeps the ring full; its x part goes to
    // both CTAs of the cluster
    hop::reg_dealloc<PRODUCER_REGS>();
    if (tid == NCONS) {
      const uint32_t rank = hop::cluster_rank();
      const uint16_t all = (uint16_t)((1u << CL) - 1);
      int st = 0;
      uint32_t ph = 0;   // the parity of the ring's current pass
      for (int k = 0; k < stages; ++k) {
        hop::mbar_wait(&s.empty[st], ph ^ 1);
        hop::mbar_expect_tx(&s.full[st], C::W_BYTES + X_BYTES);
        hop::tma_load_2d_multicast(s.x[st] + rank * X_PART, &xmap,
                                   &s.full[st], k * C::KS, rank * (TT / CL),
                                   all);
        hop::tma_load_2d(s.w[st], &wmap, &s.full[st], n0, k * C::WROWS);
        if (++st == C::STAGES) st = 0, ph ^= 1;
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns columns [n0 + 64 wg, + 64)
    hop::reg_alloc<CONSUMER_REGS>();
    const int wg = hop::warpgroup();
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int t = lane & 3;
    const int cb = 64 * wg + 16 * warp + 2 * (lane >> 2);
    const Frag<MODE> fr(wg, warp, lane);
    Acc acc[NACC];
    float sum[NACC];     // convdot: the tiles' sum; unpack: the tile's part
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      acc[i] = 0;
      sum[i] = 0.f;
    }

    const int segs = stages / seg;
    int st = 0;          // the ring slot of the next stage
    uint32_t ph = 0;     // and the parity of its full barrier
    hop::mbar_wait(&s.full[st], ph);
    fr.load(s.w[st], 0, a[0]);
    hop::fence_regs<4>(a[0]);
    for (int si = 0; si < segs; ++si) {
      uint64_t* prev = nullptr;   // a stage whose last product may run
      for (int k = 0; k + 1 < seg; ++k) {
        stage_products<MODE>(acc, a, s.x[st], s.w[st], k == 0, fr, prev,
                             lane);
        hop::wg_wait<1>();          // the stage's third product: a[0] free
        prev = &s.empty[st];
        if (++st == C::STAGES) st = 0, ph ^= 1;
        hop::mbar_wait(&s.full[st], ph);
        fr.load(s.w[st], 0, a[0]);
        hop::fence_regs<4>(a[0]);
      }
      // the segment's last stage
      stage_products<MODE>(acc, a, s.x[st], s.w[st], seg == 1, fr, prev,
                           lane);
      hop::wg_wait<0>();
      hop::fence_regs<NACC>(acc);
      release(&s.empty[st], lane);
      if (++st == C::STAGES) st = 0, ph ^= 1;
      if (si + 1 < segs) {
        hop::mbar_wait(&s.full[st], ph);
        fr.load(s.w[st], 0, a[0]);
        hop::fence_regs<4>(a[0]);
      }

      // ---- the fold, in the reference's order
      if constexpr (MODE == CONVDOT) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      } else if constexpr (C::UNPACK) {
        const int g = si % per_tile;
        const float sc = (float)(1e-4 * (double)(g + 1));
#pragma unroll
        for (int i = 0; i < NACC; ++i)
          sum[i] = __fadd_rn(sum[i],
                             __fmul_rn(__int2float_rn((int)acc[i]), sc));
        if (g == per_tile - 1) {
          // the tile's part into the tiles' sum, from 0 in tile order; the
          // last tile's sum stays in registers for the epilogue
          const bool first_tile = si + 1 == per_tile;
          const bool last_tile = si + 1 == segs;
          float* tot = s.total + (tid & (NCONS - 1));
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            const float v =
                __fadd_rn(first_tile ? 0.f : tot[i * NCONS], sum[i]);
            if (last_tile)
              sum[i] = v;
            else
              tot[i * NCONS] = v, sum[i] = 0.f;
          }
        }
      }
    }

    // ---- epilogue: fragment row g + 8h is column cb + h, accumulator
    // 4j + 2h + e is token 8j + 2t + e
    const int n = n0 + cb;
#pragma unroll
    for (int j = 0; j < TT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t + e;
        float v0, v1;
        if constexpr (MODE == I8DOT) {
          v0 = __fmul_rn(__int2float_rn((int)acc[4 * j + e]), 1e-4f);
          v1 = __fmul_rn(__int2float_rn((int)acc[4 * j + 2 + e]), 1e-4f);
        } else {
          v0 = sum[4 * j + e];
          v1 = sum[4 * j + 2 + e];
        }
        if (m < B)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * F + n) =
              __floats2bfloat162_rn(v0, v1);
      }
  }
  // no CTA leaves while its peer may still arrive on its barriers
  hop::cluster_sync();
}

// the layouts this body takes (the wrapper's `probe_body` mirrors it); D is
// x's width, bd convdot's tile, gdp and groups unpack's
static inline bool takes(int mode, int B, int D, int F, int bd, int gdp,
                         int groups) {
  if (B < 1 || B > TT || D < 1 || F < 1 || F % (TC * CL)) return false;
  switch (mode) {
    case CONVDOT: return bd >= 64 && bd % 64 == 0 && D % bd == 0;
    case I8DOT: return D % 128 == 0;
    case UNPACK8:
    case UNPACK32:
      return gdp >= 64 && gdp % 64 == 0 && groups >= 1 &&
             D % (2 * gdp * groups) == 0;
    default: return false;
  }
}

// xin: x bf16 [B, D] (convdot) or the pre-pass's int8 x [B, D]; w int8
// [D, F] or packed [D/2, F]; out bf16 [B, F]
template <int MODE>
static inline cudaError_t launch(const void* xin, const int8_t* w,
                                 __nv_bfloat16* out, int B, int D, int F,
                                 int bd, int gdp, int groups,
                                 cudaStream_t st) {
  using C = Cfg<MODE>;
  if (!takes(MODE, B, D, F, bd, gdp, groups)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xin) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  const int elt = MODE == CONVDOT ? 2 : 1;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t xstr[1] = {(cuuint64_t)D * elt};
  const cuuint32_t xbox[2] = {(cuuint32_t)(LINE / elt), TT / CL};
  cudaError_t e = hop::make_map(
      &xmap, MODE == CONVDOT ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, xin, xdims, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const int wrows = C::UNPACK ? D / 2 : D;
  const cuuint64_t wdims[2] = {(cuuint64_t)F, (cuuint64_t)wrows};
  const cuuint64_t wstr[1] = {(cuuint64_t)F};
  const cuuint32_t wbox[2] = {TC, C::WROWS};
  e = hop::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, wstr,
                    wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(probe_wgmma<MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<MODE>());
  if (e != cudaSuccess) return e;
  // stages a segment, segments a contraction tile
  int seg, per_tile = 1;
  if (MODE == CONVDOT) {
    seg = bd / C::KS;
  } else if (MODE == I8DOT) {
    seg = D / C::KS;
  } else {
    seg = 2 * gdp / C::KS;
    per_tile = groups;
  }
  probe_wgmma<MODE><<<F / TC, NTHREADS, smem_bytes<MODE>(), st>>>(
      xmap, wmap, out, B, D, F, seg, per_tile);
  return cudaGetLastError();
}

}  // namespace pw
