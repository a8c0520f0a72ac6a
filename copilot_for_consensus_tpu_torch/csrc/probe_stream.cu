// P: the weight-stream probe for Hopper (sm_90a), CUDA C++ with a plain C
// interface (built by ops/_build.py, bound with ctypes by
// ops/probe_stream.py).
//
// Replaces: scripts/probe_stream.py, the pallas_calls of `build` and their
//   bodies `k_dma`, `k_convdot`, `k_i8dot` and `k_unpack` (int8 and int32
//   unpacking).
//
// Each mode streams one weight-shaped tensor (int8 [D, F], or packed int4
// [D/2, F]) against a small batch x [B, D] bf16 and writes bf16 [B, F]:
//   * dma: out[b, f] = bf16(sum_t w[t*bd, f] + x[b, (D/bd - 1)*bd]) in f32:
//     one sampled row per bd-row tile, the first column of x's last block.
//     Every byte of w is loaded all the same, as the TPU's DMA streams it.
//   * convdot: bf16(x @ bf16(w)), f32 sums, per bd tile, tiles in order.
//   * i8dot: bf16(f32(int32(trunc_int8(x) @ w)) * 1e-4), exact up to that
//     finalize.
//   * unpack (int8 or int32 unpacking of the nibbles; the same output):
//     xq = clip(rint(x * 16), +-127); packed row r belongs to group
//     g = (r / gdp) % groups of its tile of gdp * groups packed rows; each
//     group's exact int32 product of xq and the unpacked rows is scaled in
//     f32 by f32(1e-4 * (g + 1)) and summed into its tile's part in group
//     order, the parts are summed in tile order, and the result is rounded
//     to bf16 — the reference's order, operation for operation.
// x is read in its natural [B, D] layout and converted on its way into
// shared memory (truncated to int8 for i8dot, quantized for unpack); the
// TPU wrapper's even/odd split of xq is gone (K6 reads it the same way).
//
// What bounds it on this card, and what the design does about it:
//   * dma moves D*F bytes and does next to no arithmetic: bound by the
//     3.35 TB/s of device memory. The tensor is read as one run of 16-byte
//     words, grid-stride, 8 blocks of 256 threads an SM, 4 loads in flight
//     a thread (the TPU grid, 28 x 2 blocks, would fill a fifth of the 132
//     SMs). The loads of rows nobody samples are kept live by folding every
//     word into a value that is stored only behind a kernel argument the
//     wrapper always passes as 0, so nvcc cannot drop them; the sampled
//     rows go to a [D/bd, F] workspace, which a second pass adds up with
//     x's column (integers: exact in any order). No atomics.
//   * convdot, i8dot and unpack at B = 128: 2*B*D*F operations on D*F
//     weight bytes (D*F/2 for int4), ~256 (512) operations a byte — near
//     the bf16 ridge (~295 flop/byte: 15.2 us of tensor-core time against
//     18.9 us of bytes a layer) and below the int8 one (~590 op/byte). A
//     128-row x 64-column tile of 8 warps on mma.sync (bf16 m16n8k16 for
//     convdot, s8 m16n8k32 for i8dot and unpack, quant_mma.cuh's
//     fragments), one contraction tile (bd rows, or a tile of gdp * groups
//     packed rows) a block over blockIdx.z: 224 x 2 = 448 blocks at the
//     full shape. Partials go to a [tiles, B, F] workspace (f32; int32 for
//     i8dot, whose sum stays exact) that a second pass sums in tile order.
// That body (`probe_gemm` + `probe_reduce`, entry `probe_stream_fwd`) has
// no cp.async/TMA pipeline and no wgmma: one tile in flight a block. The
// wrapper keeps it for the layouts the Hopper body refuses and calls it
// "simple". Every layout of the probe script runs the Hopper body of
// probe_wgmma.cuh instead (entry `probe_stream_wgmma_fwd`): a TMA-fed wgmma
// weight stream, x multicast across a cluster of two CTAs, no workspace and
// one launch (after a pre-pass `x_int8` that makes i8dot's and unpack's
// int8 x once a call); see that header's note.

#include "probe_wgmma.cuh"
#include "quant_mma.cuh"

namespace {

enum Mode { DMA = 0, CONVDOT = 1, I8DOT = 2, UNPACK8 = 3, UNPACK32 = 4 };

// ---------------------------------------------------------------------------
// dma
// ---------------------------------------------------------------------------

constexpr int DMA_THREADS = 256;
constexpr int DMA_BLOCKS_PER_SM = 8;  // with 132 SMs: 1056 blocks
constexpr int DMA_UNROLL = 4;         // 16-byte loads in flight a thread

__device__ __forceinline__ void store_row16(float* p, uint4 v) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 f;
    f.x = (float)(signed char)(words[i] & 0xffu);
    f.y = (float)(signed char)((words[i] >> 8) & 0xffu);
    f.z = (float)(signed char)((words[i] >> 16) & 0xffu);
    f.w = (float)(signed char)(words[i] >> 24);
    reinterpret_cast<float4*>(p)[i] = f;
  }
}

// streams w [D, F] (F % 16 == 0) as n16 = D * F / 16 consecutive 16-byte
// words, grid-stride, DMA_UNROLL loads in flight a thread; word i lies in
// row i / f16 (32-bit indices: the wrapper keeps n16 below 2^31). Writes
// sampled[t, :] = f32(w[t * bd, :]).
__global__ void __launch_bounds__(DMA_THREADS)
dma_stream(const uint4* __restrict__ w, float* __restrict__ sampled,
           unsigned n16, unsigned f16, unsigned bd, int never) {
  const unsigned stride = gridDim.x * DMA_THREADS;
  const unsigned tile16 = bd * f16;             // words of one bd tile
  unsigned fold = 0u;
  for (unsigned base = blockIdx.x * DMA_THREADS + threadIdx.x; base < n16;
       base += stride * DMA_UNROLL) {
    uint4 v[DMA_UNROLL];
#pragma unroll
    for (int j = 0; j < DMA_UNROLL; ++j)
      if (base + j * stride < n16) v[j] = __ldg(w + base + j * stride);
#pragma unroll
    for (int j = 0; j < DMA_UNROLL; ++j) {
      const unsigned i = base + j * stride;
      if (i >= n16) break;
      fold ^= v[j].x ^ v[j].y ^ v[j].z ^ v[j].w;
      const unsigned in_tile = i % tile16;
      if (in_tile < f16)                        // row t * bd of tile t
        store_row16(sampled + ((size_t)(i / tile16) * f16 + in_tile) * 16,
                    v[j]);
    }
  }
  // never taken (the wrapper passes 0), but the compiler cannot know it:
  // every loaded word stays live
  if (never) sampled[threadIdx.x] = __uint_as_float(fold);
}

// out[b, f] = bf16(sum_t sampled[t, f] + x[b, c]), the sum from 0 in t
// order; eight columns a thread (F % 16 == 0), one 16-byte store
__global__ void dma_finalize(const float* __restrict__ sampled,
                             const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ out, int B, int D,
                             int F, int tiles, int c) {
  const int f8 = F / 8;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * f8) return;
  const int b = i / f8, f = (i % f8) * 8;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float4* p = reinterpret_cast<const float4*>(
        sampled + (size_t)t * F + f);
    const float4 lo = p[0], hi = p[1];
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = __fadd_rn(s[j], v[j]);
  }
  const float xc = __bfloat162float(x[(size_t)b * D + c]);
  unsigned packed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 v = __floats2bfloat162_rn(__fadd_rn(s[2 * j], xc),
                                             __fadd_rn(s[2 * j + 1], xc));
    packed[j] = *reinterpret_cast<unsigned*>(&v);
  }
  *reinterpret_cast<uint4*>(out + (size_t)b * F + f) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// ---------------------------------------------------------------------------
// convdot, i8dot, unpack: one contraction tile a block
// ---------------------------------------------------------------------------

constexpr int WM = 4, WN = 2, MF = 2;          // 8 warps
constexpr int NT = WM * WN * 32;
constexpr int TM = WM * MF * 16;               // 128 rows
constexpr int TN = WN * 32;                    // 64 columns
constexpr int LDW = qmma::LDW;

template <int MODE> struct ModeTraits {
  static constexpr int KT = 64;                // k a step: 64 int8 values
  using Acc = int;
};
template <> struct ModeTraits<CONVDOT> {
  static constexpr int KT = 32;                // 32 bf16 values
  using Acc = float;
};

// eight bf16 values -> eight int8 values, k ascending in two words:
// truncation toward zero (i8dot) or clip(rint(v * 16), +-127) (unpack)
template <int MODE>
__device__ __forceinline__ uint2 x_to_int8(uint4 v) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  unsigned out[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned short h = (unsigned short)(words[i / 2] >> (16 * (i & 1)));
    const float f = __bfloat162float(__ushort_as_bfloat16(h));
    int q;
    if constexpr (MODE == I8DOT)
      q = __float2int_rz(f);
    else
      q = (int)fminf(fmaxf(rintf(f * 16.f), -127.f), 127.f);
    out[i / 4] |= ((unsigned)q & 0xffu) << (8 * (i & 3));
  }
  return make_uint2(out[0], out[1]);
}

// one packed word (four bytes of four columns) -> low / high nibbles as
// four signed bytes, each widened through int32: ((p & 0xF) ^ 8) - 8 and
// the arithmetic p >> 4 of the signed byte
__device__ __forceinline__ void nibbles_int32(unsigned w, unsigned* lo,
                                              unsigned* hi) {
  unsigned l = 0u, h = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = (int)(signed char)((w >> (8 * j)) & 0xffu);
    l |= ((unsigned)(((p & 0xF) ^ 8) - 8) & 0xffu) << (8 * j);
    h |= ((unsigned)(p >> 4) & 0xffu) << (8 * j);
  }
  *lo = l;
  *hi = h;
}

// x bf16 [B, D]; w int8 [D, F] or packed [D/2, F]; ws [tiles, B, F] (f32,
// int32 for i8dot). ktile: unpacked k of one contraction tile (bd, or
// 2 * gdp * groups); gdp: packed rows a group (unpack only).
template <int MODE>
__global__ void __launch_bounds__(NT)
probe_gemm(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
           void* __restrict__ ws, int B, int D, int F, int ktile, int gdp,
           int groups) {
  using Tr = ModeTraits<MODE>;
  using Acc = typename Tr::Acc;
  constexpr int KT = Tr::KT;
  constexpr bool UNPACK = (MODE == UNPACK8 || MODE == UNPACK32);
  constexpr int XCH = KT / 8;                  // 16-byte x chunks a row
  __shared__ __align__(16) unsigned sA[TM * LDW];
  __shared__ __align__(16) unsigned sB[TN * LDW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int kb = blockIdx.z * ktile, ke = kb + ktile;

  Acc acc[MF][4][4];
  float part[UNPACK ? MF : 1][UNPACK ? 4 : 1][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  if constexpr (UNPACK) {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
  }

  for (int k0 = kb; k0 < ke; k0 += KT) {
    // ---- A: TM rows x KT values of x, as 64 bytes a row (bf16 or int8)
    for (int c = tid; c < TM * XCH; c += NT) {
      const int r = c / XCH, q = c % XCH;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < B)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * D + k0 + q * 8));
      if constexpr (MODE == CONVDOT) {
        *reinterpret_cast<uint4*>(&sA[r * LDW + q * 4]) = v;
      } else {
        *reinterpret_cast<uint2*>(&sA[r * LDW + q * 2]) = x_to_int8<MODE>(v);
      }
    }
    // ---- B: the KT x TN weight tile -> sB[n][k-word], 8 columns a unit
    for (int u = tid; u < 16 * (TN / 8); u += NT) {
      const int kq = u & 15, nseg = u >> 4;
      const int n = n0 + nseg * 8;
      unsigned col[8];
      if constexpr (MODE == CONVDOT) {
        // k-pair kq: rows k0 + 2kq, k0 + 2kq + 1 -> one bf16x2 a column
        uint2 a = make_uint2(0, 0), b = make_uint2(0, 0);
        if (n < F) {
          a = __ldg(reinterpret_cast<const uint2*>(
              w + (size_t)(k0 + 2 * kq) * F + n));
          b = __ldg(reinterpret_cast<const uint2*>(
              w + (size_t)(k0 + 2 * kq + 1) * F + n));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned wa = j < 4 ? a.x : a.y, wb = j < 4 ? b.x : b.y;
          const int s = 8 * (j & 3);
          __nv_bfloat162 v = __floats2bfloat162_rn(
              (float)(signed char)((wa >> s) & 0xffu),
              (float)(signed char)((wb >> s) & 0xffu));
          col[j] = *reinterpret_cast<unsigned*>(&v);
        }
      } else {
        // k-quad kq: four int8 rows (i8dot), or two packed rows (unpack)
        unsigned r[4][2];
        if (n < F) {
          if constexpr (MODE == I8DOT) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                  w + (size_t)(k0 + kq * 4 + i) * F + n));
              r[i][0] = v.x;
              r[i][1] = v.y;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                  w + (size_t)(k0 / 2 + kq * 2 + i) * F + n));
              if constexpr (MODE == UNPACK8) {
                // in the int8 domain: four bytes at once (__vsub4)
                r[2 * i][0] = qmma::lo_nibbles(v.x);     // k = 4kq + 2i
                r[2 * i][1] = qmma::lo_nibbles(v.y);
                r[2 * i + 1][0] = qmma::hi_nibbles(v.x); // k = 4kq + 2i + 1
                r[2 * i + 1][1] = qmma::hi_nibbles(v.y);
              } else {
                nibbles_int32(v.x, &r[2 * i][0], &r[2 * i + 1][0]);
                nibbles_int32(v.y, &r[2 * i][1], &r[2 * i + 1][1]);
              }
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i][0] = r[i][1] = 0u;
        }
        qmma::transpose4(r[0][0], r[1][0], r[2][0], r[3][0], &col[0]);
        qmma::transpose4(r[0][1], r[1][1], r[2][1], r[3][1], &col[4]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sB[(nseg * 8 + j) * LDW + kq] = col[j];
    }
    __syncthreads();

    // ---- two 32-byte k slices: k16 bf16 or k32 int8
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kw = ks * 8;
      unsigned af[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int r = wm * MF * 16 + i * 16 + g;
        af[i][0] = sA[r * LDW + kw + t];
        af[i][1] = sA[(r + 8) * LDW + kw + t];
        af[i][2] = sA[r * LDW + kw + 4 + t];
        af[i][3] = sA[(r + 8) * LDW + kw + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        const unsigned b0 = sB[n * LDW + kw + t];
        const unsigned b1 = sB[n * LDW + kw + 4 + t];
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if constexpr (MODE == CONVDOT)
            qmma::mma_bf16(acc[i][j], af[i], b0, b1);
          else
            qmma::mma_s8(acc[i][j], af[i], b0, b1);
        }
      }
    }
    __syncthreads();

    // ---- unpack: at a group's end, part += f32(int32 partial) * scale
    if constexpr (UNPACK) {
      if ((k0 + KT) % (2 * gdp) == 0) {
        const int grp = ((k0 / 2) / gdp) % groups;
        const float s = (float)(1e-4 * (double)(grp + 1));
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              part[i][j][e] = __fadd_rn(
                  part[i][j][e], __fmul_rn(__int2float_rn(acc[i][j][e]), s));
              acc[i][j][e] = 0;
            }
      }
    }
  }

  // ---- the tile's partial -> ws[blockIdx.z]
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * MF * 16 + i * 16 + g + 8 * h;
      if (m >= B) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= F) continue;
        const size_t o = ((size_t)blockIdx.z * B + m) * F + n;
        if constexpr (MODE == I8DOT) {
          *reinterpret_cast<int2*>(static_cast<int*>(ws) + o) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else if constexpr (MODE == CONVDOT) {
          qmma::store2(static_cast<float*>(ws) + o, acc[i][j][2 * h],
                       acc[i][j][2 * h + 1]);
        } else {
          qmma::store2(static_cast<float*>(ws) + o, part[i][j][2 * h],
                       part[i][j][2 * h + 1]);
        }
      }
    }
}

// the tiles' partials summed in tile order from 0 (int32 for i8dot, then
// f32 * 1e-4), rounded to bf16
template <int MODE>
__global__ void probe_reduce(const void* __restrict__ ws,
                             __nv_bfloat16* __restrict__ out, int n,
                             int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v;
  if constexpr (MODE == I8DOT) {
    const int* p = static_cast<const int*>(ws);
    int s = 0;
    for (int k = 0; k < tiles; ++k) s += p[(size_t)k * n + i];
    v = __fmul_rn(__int2float_rn(s), 1e-4f);
  } else {
    const float* p = static_cast<const float*>(ws);
    v = 0.f;
    for (int k = 0; k < tiles; ++k) v = __fadd_rn(v, p[(size_t)k * n + i]);
  }
  out[i] = __float2bfloat16(v);
}

// the Hopper body's int8 x, once a call: x_to_int8 on 8 values a thread
// (n8 = B * D / 8)
template <int MODE>
__global__ void x_int8(const uint4* __restrict__ x, uint2* __restrict__ xq,
                       int n8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n8) xq[i] = x_to_int8<MODE>(__ldg(x + i));
}

template <int MODE>
cudaError_t run_wgmma(const __nv_bfloat16* x, const int8_t* w, int8_t* xq,
                      __nv_bfloat16* out, int B, int D, int F, int bd,
                      int gdp, int groups, cudaStream_t st) {
  if (!pw::takes(MODE, B, D, F, bd, gdp, groups))
    return cudaErrorInvalidValue;
  if constexpr (MODE == CONVDOT) {
    return pw::launch<MODE>(x, w, out, B, D, F, bd, gdp, groups, st);
  } else {
    if (xq == nullptr || ((reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(xq)) & 15))
      return cudaErrorMisalignedAddress;
    const int n8 = B * (D / 8);               // D % 128 == 0
    x_int8<MODE><<<(n8 + 255) / 256, 256, 0, st>>>(
        reinterpret_cast<const uint4*>(x), reinterpret_cast<uint2*>(xq), n8);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return pw::launch<MODE>(xq, w, out, B, D, F, bd, gdp, groups, st);
  }
}

template <int MODE>
cudaError_t run_gemm(const __nv_bfloat16* x, const int8_t* w, void* ws,
                     __nv_bfloat16* out, int B, int D, int F, int ktile,
                     int gdp, int groups, cudaStream_t st) {
  const int tiles = D / ktile;
  const dim3 grid((F + TN - 1) / TN, (B + TM - 1) / TM, tiles);
  probe_gemm<MODE><<<grid, NT, 0, st>>>(x, w, ws, B, D, F, ktile, gdp,
                                         groups);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = B * F;
  probe_reduce<MODE><<<(n + 255) / 256, 256, 0, st>>>(ws, out, n, tiles);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 dma, 1 convdot, 2 i8dot, 3 unpack8, 4 unpack32.
// x bf16 [B, D]; w int8 [D, F] (modes 0-2) or packed [D/2, F] (3-4); out
// bf16 [B, F]; ws: f32 [D/bd, F] (dma), f32 [D/bd, B, F] (convdot), int32
// [D/bd, B, F] (i8dot), f32 [D/(2*gdp*groups), B, F] (unpack). D is x's
// width in every mode; gdp and groups are read by unpack only.
extern "C" int probe_stream_fwd(int mode, const void* x, const void* w,
                                void* out, void* ws, int B, int D, int F,
                                int bd, int gdp, int groups, void* stream) {
  if (B <= 0 || D <= 0 || F <= 0 || F % 8) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case DMA: {
      if (bd <= 0 || D % bd || F % 16) return (int)cudaErrorInvalidValue;
      float* sampled = static_cast<float*>(ws);
      int dev = 0, sms = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      const long long n16 = (long long)D * (F / 16);
      if (n16 >= (1ll << 31)) return (int)cudaErrorInvalidValue;
      const long long want = (n16 + DMA_THREADS - 1) / DMA_THREADS;
      const long long cap = (long long)sms * DMA_BLOCKS_PER_SM;
      const int blocks = (int)(want < cap ? want : cap);
      dma_stream<<<blocks, DMA_THREADS, 0, st>>>(
          reinterpret_cast<const uint4*>(wq), sampled, (unsigned)n16,
          (unsigned)(F / 16), (unsigned)bd, 0);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      const int n = B * (F / 8);
      dma_finalize<<<(n + 255) / 256, 256, 0, st>>>(sampled, xb, ob, B, D, F,
                                                    D / bd, D - bd);
      return (int)cudaGetLastError();
    }
    case CONVDOT:
    case I8DOT:
      if (bd <= 0 || D % bd || bd % 64) return (int)cudaErrorInvalidValue;
      if (mode == CONVDOT)
        return (int)run_gemm<CONVDOT>(xb, wq, ws, ob, B, D, F, bd, 0, 1, st);
      return (int)run_gemm<I8DOT>(xb, wq, ws, ob, B, D, F, bd, 0, 1, st);
    case UNPACK8:
    case UNPACK32: {
      const int ktile = 2 * gdp * groups;
      if (gdp <= 0 || groups <= 0 || gdp % 32 || D % ktile)
        return (int)cudaErrorInvalidValue;
      if (mode == UNPACK8)
        return (int)run_gemm<UNPACK8>(xb, wq, ws, ob, B, D, F, ktile, gdp,
                                      groups, st);
      return (int)run_gemm<UNPACK32>(xb, wq, ws, ob, B, D, F, ktile, gdp,
                                     groups, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the Hopper body (the layouts pw::takes) for mode 1 convdot, 2 i8dot, 3
// unpack8, 4 unpack32: x bf16 [B, D]; w int8 [D, F] or packed [D/2, F];
// out bf16 [B, F]; xq the pre-pass's int8 x [B, D] (modes 2-4; unread
// by convdot, may be null). bd is read by convdot, gdp and groups by
// unpack.
extern "C" int probe_stream_wgmma_fwd(int mode, const void* x, const void* w,
                                      void* out, void* xq, int B, int D,
                                      int F, int bd, int gdp, int groups,
                                      void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  int8_t* xqq = static_cast<int8_t*>(xq);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case CONVDOT:
      return (int)run_wgmma<CONVDOT>(xb, wq, xqq, ob, B, D, F, bd, gdp,
                                     groups, st);
    case I8DOT:
      return (int)run_wgmma<I8DOT>(xb, wq, xqq, ob, B, D, F, bd, gdp, groups,
                                   st);
    case UNPACK8:
      return (int)run_wgmma<UNPACK8>(xb, wq, xqq, ob, B, D, F, bd, gdp,
                                     groups, st);
    case UNPACK32:
      return (int)run_wgmma<UNPACK32>(xb, wq, xqq, ob, B, D, F, bd, gdp,
                                      groups, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the Hopper body's dynamic shared memory a CTA, in bytes, for mode 1-4
extern "C" int probe_stream_wgmma_smem(int mode) {
  switch (mode) {
    case CONVDOT: return (int)pw::smem_bytes<pw::CONVDOT>();
    case I8DOT: return (int)pw::smem_bytes<pw::I8DOT>();
    case UNPACK8: return (int)pw::smem_bytes<pw::UNPACK8>();
    case UNPACK32: return (int)pw::smem_bytes<pw::UNPACK32>();
    default: return -1;
  }
}

extern "C" const char* probe_stream_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
