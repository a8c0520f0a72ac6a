// K6: W4A8 matmul for Hopper (sm_90a), CUDA C++ with a plain C interface
// (built by ops/_build.py, bound with ctypes by ops/quant_matmul.py).
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `w4a8_matmul`
//   (pallas_call) and its body `_kernel_w4a8`.
//
// Computes out[M, F] = sx * sum_g scale[g] * (xq[:, g] @ unpack(q4)[g]):
// x (bf16 or f32) quantized per row to int8 by `quantize_rows` (into
// scratch the wrapper allocates); q4 packed int4 [D/2, F] (byte row i holds
// row 2i in its low nibble, 2i+1 in its high one), unpacked to int8 in
// registers; each scale group's int8 product summed exactly in int32 on
// the tensor cores (wgmma m64n176k32 s8 on the wgmma body, mma.sync
// m16n8k32 s8 on the others), converted to f32 and multiplied by the
// group's scale row, then added to the f32 sum in group order; sx
// multiplies the sum at the end, and the result is rounded once to x's
// dtype. On the tiled paths (wgmma and mma.sync) that is the plain
// version's arithmetic, operation for operation; the stream body's is
// `w4a8_matmul_stream_ref`'s (its splits' partials summed in split order,
// then sx), so each equals its plain version bit for bit. The split
// qgemm sums its splits' partials in another order (f32 rounding level).
//
// What bounds it on this card, and what the design does about it:
//   * Decode (M = the slot count, 32 in the 3072-context deployment): ~4*M
//     operations per packed weight byte, far below the ~590 op/byte int8
//     ridge: bound by reading the packed bytes once (3.35 TB/s), which
//     needs tens of KB of weight in flight on every SM.
//     `w4a8_matmul_stream_fwd` runs the stream body of w4a8_stream.cuh at
//     M <= 32: TMA keeps four 8 KB weight stages (with xq's rows) in flight
//     a CTA through an mbarrier ring, the weight unpacked to int8 in
//     registers is int8 mma.sync's A operand with the tokens as n8 tiles,
//     and the contraction is split by whole groups only where F is narrow,
//     the last CTA of a column tile summing the splits in order and
//     multiplying by sx (see that header's note): `quantize_rows` and one
//     launch, bit-equal to `w4a8_matmul_stream_ref`. Layouts it refuses
//     (group % 128, F % 16) keep the split `qgemm` of quant_mma.cuh, which
//     `w4a8_matmul_fwd` runs when given splits > 0: a 32-row tile, 128
//     columns a block, whole groups a split over blockIdx.z, an f32
//     workspace summed by a second pass (`qgemm_reduce`).
//   * Prefill (M > 32, up to 2 x 2816): bound by operations on the int8
//     tensor cores (1,979 TOP/s), which only wgmma reaches.
//     `w4a8_matmul_wgmma_fwd` runs the Hopper body of w4a8_wgmma.cuh: the
//     unpacked weight as wgmma's register A, xq by TMA as its shared B, s32
//     accumulators a scale group, the fold in registers (see that header's
//     note). Layouts it does not take (D or the group not whole 128-k
//     stages, a group over 4096, F % 16) go by the wrapper's shape rule to
//     the 128x128 mma.sync tiling of quant_mma.cuh (splits = 0 here), which
//     K4 and K5 share.
// The weight never exists unpacked in device memory.

#include "quant_mma.cuh"
#include "w4a8_stream.cuh"
#include "w4a8_wgmma.cuh"

namespace {

template <typename T>
cudaError_t run(const void* xv, const int8_t* q4, const float* scale,
                void* outv, int8_t* xq, float* sx, float* ws, int M, int D,
                int F, int G, int splits, cudaStream_t st) {
  qmma::quantize_rows<T><<<M, qmma::QR_THREADS, 0, st>>>(
      static_cast<const T*>(xv), xq, sx, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return qmma::launch_qgemm<qmma::W4A8, T>(xq, q4, scale, sx,
                                           static_cast<T*>(outv), ws, M, D,
                                           F, G, splits, st);
}

}  // namespace

extern "C" int w4a8_matmul_fwd(const void* x, const void* q4,
                               const void* scale, void* out, void* xq,
                               void* sx, void* workspace, int M, int D, int F,
                               int G, int splits, int is_bf16, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || G <= 0 || D % G || splits < 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q4);
  const float* sc = static_cast<const float*>(scale);
  int8_t* xqq = static_cast<int8_t*>(xq);
  float* sxx = static_cast<float*>(sx);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(x, qq, sc, out, xqq, sxx, ws, M, D, F, G,
                                   splits, st);
  return (int)run<float>(x, qq, sc, out, xqq, sxx, ws, M, D, F, G, splits,
                         st);
}

// the wgmma body (M > 32, the layouts k6w::takes): x (bf16 or f32), q4,
// scale, out, the scratch xq [M, D] int8 and sx [M] f32
extern "C" int w4a8_matmul_wgmma_fwd(const void* x, const void* q4,
                                     const void* scale, void* out, void* xq,
                                     void* sx, int M, int D, int F, int G,
                                     int is_bf16, void* stream) {
  if (D <= 0 || F <= 0 || !k6w::takes(M, D, F, G))
    return (int)cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q4);
  const float* sc = static_cast<const float*>(scale);
  int8_t* xqq = static_cast<int8_t*>(xq);
  float* sxx = static_cast<float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16) {
    qmma::quantize_rows<__nv_bfloat16><<<M, qmma::QR_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xqq, sxx, D);
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = k6w::launch(xqq, qq, sc, sxx, static_cast<__nv_bfloat16*>(out), M,
                      D, F, G, st);
  } else {
    qmma::quantize_rows<float><<<M, qmma::QR_THREADS, 0, st>>>(
        static_cast<const float*>(x), xqq, sxx, D);
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = k6w::launch(xqq, qq, sc, sxx, static_cast<float*>(out), M, D, F, G,
                      st);
  }
  return (int)e;
}

// the wgmma body's dynamic shared memory a CTA, in bytes
extern "C" int w4a8_matmul_wgmma_smem() { return (int)k6w::SMEM_BYTES; }

// the stream body (M <= 32, the layouts k6s::takes): x (bf16 or f32), q4,
// scale, out, the scratch xq [M, D] int8 and sx [M] f32, the split
// workspace [splits, M, F] f32 and the per-tile counters (both null when
// splits = 1), and the wrapper's plan (tn, splits, per)
extern "C" int w4a8_matmul_stream_fwd(const void* x, const void* q4,
                                      const void* scale, void* out, void* xq,
                                      void* sx, void* workspace,
                                      void* counters, int M, int D, int F,
                                      int G, int tn, int splits, int per,
                                      int is_bf16, void* stream) {
  if (D <= 0 || F <= 0 || !k6s::takes(M, D, F, G))
    return (int)cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q4);
  const float* sc = static_cast<const float*>(scale);
  int8_t* xqq = static_cast<int8_t*>(xq);
  float* sxx = static_cast<float*>(sx);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16) {
    qmma::quantize_rows<__nv_bfloat16><<<M, qmma::QR_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xqq, sxx, D);
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = k6s::launch(xqq, qq, sc, sxx, static_cast<__nv_bfloat16*>(out), ws,
                      cnt, M, D, F, G, tn, splits, per, st);
  } else {
    qmma::quantize_rows<float><<<M, qmma::QR_THREADS, 0, st>>>(
        static_cast<const float*>(x), xqq, sxx, D);
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = k6s::launch(xqq, qq, sc, sxx, static_cast<float*>(out), ws, cnt, M,
                      D, F, G, tn, splits, per, st);
  }
  return (int)e;
}

// the stream body's dynamic shared memory a CTA for nt token tiles (1-4)
extern "C" int w4a8_matmul_stream_smem(int nt) {
  return (int)k6s::smem_for(nt);
}

extern "C" const char* w4a8_matmul_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
