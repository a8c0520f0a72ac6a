// Shared pieces of the quantized-matmul kernels K5 (int4_matmul.cu), K4
// (w8a8_matmul.cu) and K6 (w4a8_matmul.cu): per-row int8 activation
// quantization, nibble unpacking, the tensor-core fragments, and one tiled
// matmul body templated on the operand kinds.
//
// The tiled body (`qgemm`) computes a [TM, TN] output tile with raw
// `mma.sync` PTX; WM x WN warps each own (16*MF) rows x 32 columns
// (MF m-fragments x 4 n-fragments of m16n8). Per k-step it stages
//   * A: TM rows x 64 bytes of the activations (bf16 x for K5: 32 values;
//     int8 xq for K4/K6: 64 values), k-contiguous, read in place from the
//     row-major [M, D] operand (no even/odd split as in the TPU wrapper);
//   * B: the weight's KT x TN tile TRANSPOSED to [n][k] in shared memory,
//     because the B fragment of m16n8k16 / m16n8k32 holds consecutive k of
//     one column. int8 rows are transposed 4x4 bytes at a time in registers
//     (__byte_perm); packed int4 bytes are unpacked in registers, and since
//     byte row i holds k = 2i (low nibble) and 2i+1 (high nibble) of one
//     column, one packed byte is one k-pair: a bf16x2 word for K5, half an
//     int8 k-quad for K6. The weight never exists unpacked in device memory.
//
// Accumulator layout of m16n8 (PTX ISA, "Matrix fragments for mma.m16n8k*"):
// lane = 4*g + t; c0, c1 hold row g, columns 2t and 2t+1; c2, c3 hold row
// g+8, the same columns. So a thread knows the output column of each of its
// accumulators, and a per-column scale — K5's and K6's group scale — can be
// applied to the register accumulators after each group's k-steps: the
// group's partial first (f32 for K5, exact int32 for K6), then the scale,
// then the running sum, the reference's order. The fold uses __fmul_rn and
// __fadd_rn, so no multiply-add is contracted and K6's sum is the plain
// version's, operation for operation; K4's finalize (acc * sx) * sw too.
//
// Split-K (the streaming path of K5/K6 at M <= 32): blockIdx.z takes a run
// of whole scale groups; its f32 partial goes to a workspace [splits, M, F]
// that `qgemm_reduce` sums in a fixed order (deterministic, no atomics).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmma {

enum Kind { W8A8 = 0, W4BF16 = 1, W4A8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two consecutive outputs of one row (n even, F even: 4/8-byte aligned)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

// ---------------------------------------------------------------------------
// per-row int8 activations, bit for bit the reference's quantize_rows:
// sx = amax / 127 (1 for an all-zero row), xq = clip(rint(x / sx), +-127),
// IEEE division (no reciprocal), rounding half to even
// ---------------------------------------------------------------------------

constexpr int QR_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(QR_THREADS)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq,
              float* __restrict__ sx, int D) {
  __shared__ float red[QR_THREADS / 32];
  const T* row = x + (size_t)blockIdx.x * D;
  float amax = 0.f;
  for (int i = threadIdx.x; i < D; i += QR_THREADS)
    amax = fmaxf(amax, fabsf(to_f(row[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QR_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  int8_t* out = xq + (size_t)blockIdx.x * D;
  for (int i = threadIdx.x; i < D; i += QR_THREADS) {
    const float v = rintf(__fdiv_rn(to_f(row[i]), s));
    out[i] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
}

// ---------------------------------------------------------------------------
// bytes and nibbles
// ---------------------------------------------------------------------------

// 4x4 byte transpose: c[j] byte i = r_i byte j
__device__ __forceinline__ void transpose4(unsigned r0, unsigned r1,
                                           unsigned r2, unsigned r3,
                                           unsigned* c) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);
  const unsigned t1 = __byte_perm(r2, r3, 0x5140);
  const unsigned t2 = __byte_perm(r0, r1, 0x7362);
  const unsigned t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// four packed bytes -> their low / high nibbles as four signed bytes:
// low ((p & 0xF) ^ 8) - 8, high the arithmetic p >> 4 of the signed byte
__device__ __forceinline__ unsigned lo_nibbles(unsigned w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ unsigned hi_nibbles(unsigned w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// packed words w0 (row r) and w1 (row r + 1), four columns each (K6's
// int8 products): columns 2P and 2P + 1 -> one register each holding the
// column's four nibbles [lo(r), hi(r), lo(r + 1), hi(r + 1)] as signed
// bytes, i.e. four consecutive k. ((v ^ 8) | 0x80) - 8 is 128 plus the
// signed nibble with no borrow between bytes, ^ 0x80 makes it two's
// complement; one byte permute pairs the two rows' columns first, two
// more put each column's k in order. Words that hold only columns 0 and 1
// (16-bit loads) take P = 0.
template <int P>
__device__ __forceinline__ void nibble_quads(unsigned w0, unsigned w1,
                                             unsigned& c0, unsigned& c1) {
  const unsigned w = __byte_perm(w0, w1, P == 0 ? 0x5410 : 0x7632);
  const unsigned lo = ((w & 0x0F0F0F0Fu) ^ 0x88888888u) - 0x08080808u;
  const unsigned hi = (((w >> 4) & 0x0F0F0F0Fu) ^ 0x88888888u) - 0x08080808u;
  c0 = __byte_perm(lo, hi, 0x6240) ^ 0x80808080u;
  c1 = __byte_perm(lo, hi, 0x7351) ^ 0x80808080u;
}

// one packed byte -> bf16x2 (k = 2i in the low half, 2i+1 in the high)
__device__ __forceinline__ unsigned nibbles_bf16x2(unsigned byte) {
  const int b = (int)(signed char)byte;
  const float lo = (float)(((b & 0xF) ^ 8) - 8);
  const float hi = (float)(b >> 4);
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// tensor-core fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// the tiled body
// ---------------------------------------------------------------------------

constexpr int LDW = 20;    // shared row pitch in 32-bit words (16 + 4):
                             // fragment reads hit 32 distinct banks

template <Kind K> struct KindTraits;
template <> struct KindTraits<W8A8> {
  static constexpr int KT = 64;         // unpacked k per step
  using Acc = int;
};
template <> struct KindTraits<W4BF16> {
  static constexpr int KT = 32;
  using Acc = float;
};
template <> struct KindTraits<W4A8> {
  static constexpr int KT = 64;
  using Acc = int;
};

// a:  K5: bf16 x [M, D]; K4/K6: int8 xq [M, D]
// w:  K4: int8 q [D, F]; K5/K6: packed int8 q4 [D/2, F]
// scale: K4: [F]; K5/K6: [G, F] (group = D / G, a multiple of KT)
// sx: K4/K6 per-row activation scales [M]
// out (splits == 1): [M, F] in OutT; ws (splits > 1): f32 [splits, M, F]
template <Kind K, int WM, int WN, int MF, typename OutT>
__global__ void __launch_bounds__(WM * WN * 32)
qgemm(const void* __restrict__ a_ptr, const int8_t* __restrict__ w,
      const float* __restrict__ scale, const float* __restrict__ sx,
      OutT* __restrict__ out, float* __restrict__ ws, int M, int D, int F,
      int group, int kchunk) {
  using Tr = KindTraits<K>;
  using Acc = typename Tr::Acc;
  constexpr int KT = Tr::KT;
  constexpr int NT = WM * WN * 32;
  constexpr int TM = WM * MF * 16;
  constexpr int TN = WN * 32;
  constexpr bool GROUPED = (K != W8A8);
  constexpr int A_ELT = (K == W4BF16) ? 2 : 1;   // activation bytes
  __shared__ __align__(16) unsigned sA[TM * LDW];
  __shared__ __align__(16) unsigned sB[TN * LDW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(D, kb + kchunk);
  const char* a_bytes = static_cast<const char*>(a_ptr);

  Acc acc[MF][4][4];
  float facc[GROUPED ? MF : 1][GROUPED ? 4 : 1][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  if constexpr (GROUPED) {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) facc[i][j][e] = 0.f;
  }

  for (int k0 = kb; k0 < ke; k0 += KT) {
    // ---- A: TM rows x 64 bytes, 16-byte chunks
    for (int c = tid; c < TM * 4; c += NT) {
      const int r = c >> 2, cb = (c & 3) * 16;
      const int gm = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M)
        v = __ldg(reinterpret_cast<const uint4*>(
            a_bytes + ((size_t)gm * D + k0) * A_ELT + cb));
      *reinterpret_cast<uint4*>(&sA[r * LDW + cb / 4]) = v;
    }
    // ---- B: KT x TN weight tile -> sB[n][k], 8 columns a unit
    for (int u = tid; u < 16 * (TN / 8); u += NT) {
      const int kq = u & 15, nseg = u >> 4;
      const int n = n0 + nseg * 8;
      unsigned col[8];
      if constexpr (K == W4BF16) {
        // packed row kq = k-pair kq of this step: one word per column
        uint2 p = make_uint2(0, 0);
        if (n < F)
          p = __ldg(reinterpret_cast<const uint2*>(
              w + ((size_t)(k0 / 2 + kq)) * F + n));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          col[j] = nibbles_bf16x2((p.x >> (8 * j)) & 0xffu);
          col[j + 4] = nibbles_bf16x2((p.y >> (8 * j)) & 0xffu);
        }
      } else {
        // k-quad kq: four int8 rows (K4), or two packed rows (K6)
        unsigned r[4][2];
        if (n < F) {
          if constexpr (K == W8A8) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                  w + ((size_t)(k0 + kq * 4 + i)) * F + n));
              r[i][0] = v.x;
              r[i][1] = v.y;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                  w + ((size_t)(k0 / 2 + kq * 2 + i)) * F + n));
              r[2 * i][0] = lo_nibbles(v.x);       // k = 4kq + 2i
              r[2 * i][1] = lo_nibbles(v.y);
              r[2 * i + 1][0] = hi_nibbles(v.x);   // k = 4kq + 2i + 1
              r[2 * i + 1][1] = hi_nibbles(v.y);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i][0] = r[i][1] = 0u;
        }
        transpose4(r[0][0], r[1][0], r[2][0], r[3][0], &col[0]);
        transpose4(r[0][1], r[1][1], r[2][1], r[3][1], &col[4]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sB[(nseg * 8 + j) * LDW + kq] = col[j];
    }
    __syncthreads();

    // ---- the tile's mma: two 32-byte k slices (k16 bf16 or k32 int8)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kw = ks * 8;                  // word offset of the slice
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
          if constexpr (K == W4BF16)
            mma_bf16(acc[i][j], af[i], b0, b1);
          else
            mma_s8(acc[i][j], af[i], b0, b1);
        }
      }
    }
    __syncthreads();

    // ---- group fold: partial, then its scale, then the running sum
    if constexpr (GROUPED) {
      if ((k0 + KT) % group == 0) {
        const float* srow = scale + (size_t)(k0 / group) * F;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t;
          const float s0 = n < F ? srow[n] : 0.f;
          const float s1 = n < F ? srow[n + 1] : 0.f;
#pragma unroll
          for (int i = 0; i < MF; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p;
              if constexpr (K == W4BF16)
                p = acc[i][j][e];
              else
                p = __int2float_rn(acc[i][j][e]);
              facc[i][j][e] =
                  __fadd_rn(facc[i][j][e], __fmul_rn(p, (e & 1) ? s1 : s0));
              acc[i][j][e] = 0;
            }
        }
      }
    }
  }

  // ---- epilogue
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * MF * 16 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float sxm = (K == W4BF16) ? 1.f : sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= F) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (K == W8A8)
            v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]),
                                       sxm),
                             scale[n + e]);
          else
            v[e] = facc[i][j][2 * h + e];
        }
        if (gridDim.z > 1) {
          store2(ws + ((size_t)blockIdx.z * M + m) * F + n, v[0], v[1]);
        } else {
          if constexpr (K == W4A8) {
            v[0] = __fmul_rn(v[0], sxm);
            v[1] = __fmul_rn(v[1], sxm);
          }
          store2(out + (size_t)m * F + n, v[0], v[1]);
        }
      }
    }
}

// split-K partials [splits, M, F] summed in split order, times sx for K6
template <typename OutT>
__global__ void qgemm_reduce(const float* __restrict__ ws,
                             const float* __restrict__ sx,
                             OutT* __restrict__ out, int M, int F,
                             int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * F) return;
  float s = ws[i];
  for (int p = 1; p < splits; ++p) s = __fadd_rn(s, ws[(size_t)p * M * F + i]);
  if (sx != nullptr) s = __fmul_rn(s, sx[i / F]);
  store1(out + i, s);
}

// the streaming tiling (32 rows: a decode step of 32 slots) and the prefill
// tiling (128 rows), both 128 columns wide
constexpr int STREAM_TM = 32;

template <Kind K, typename OutT>
cudaError_t launch_qgemm(const void* a, const int8_t* w, const float* scale,
                         const float* sx, OutT* out, float* ws, int M, int D,
                         int F, int G, int splits, cudaStream_t st) {
  constexpr int KT = KindTraits<K>::KT;
  const int group = D / G;
  if (D % KT || F % 8 || group % KT) return cudaErrorInvalidValue;
  if (splits > 0) {
    if (K == W8A8 || M > STREAM_TM || ws == nullptr)
      return cudaErrorInvalidValue;
    const int per = (G + splits - 1) / splits;      // whole groups a split
    const dim3 grid((F + 127) / 128, 1, splits);
    qgemm<K, 1, 4, 2, OutT><<<grid, 128, 0, st>>>(
        a, w, scale, sx, out, ws, M, D, F, group, per * group);
    cudaError_t e = cudaGetLastError();
    // one split writes the output itself
    if (e != cudaSuccess || splits == 1) return e;
    const int n = M * F;
    qgemm_reduce<OutT><<<(n + 255) / 256, 256, 0, st>>>(
        ws, K == W4A8 ? sx : nullptr, out, M, F, splits);
    return cudaGetLastError();
  }
  const dim3 grid((F + 127) / 128, (M + 127) / 128, 1);
  qgemm<K, 2, 4, 4, OutT><<<grid, 256, 0, st>>>(a, w, scale, sx, out, nullptr,
                                                M, D, F, group, D);
  return cudaGetLastError();
}

}  // namespace qmma
