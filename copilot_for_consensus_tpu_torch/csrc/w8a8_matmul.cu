// K4: W8A8 matmul for Hopper (sm_90a), CUDA C++ with a plain C interface
// (built by ops/_build.py, bound with ctypes by ops/quant_matmul.py).
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `w8a8_matmul`
//   (pallas_call) and its body `_kernel_w8a8`.
//
// Computes out[M, F] = (xq @ q) * sx * sw: x (bf16 or f32) quantized per
// row to int8 by `quantize_rows` (scale amax/127, IEEE division, rounding
// half to even, a clip to +-127; into scratch the wrapper allocates), the
// int8 product summed exactly in int32 on the tensor cores, then (acc * sx)
// * sw in f32, rounded once to x's dtype. The arithmetic is exact up to
// that finalize, which is the plain version's operation for operation, so
// both bodies agree with it bit for bit.
//
// What bounds it on this card, and what the design does about it: on the
// serving path K4 runs only for prefill waves (M >= 1024 rows: the int8
// leaves at M = 4096 in the 4 x 1024 wave), where 2*M*D*F operations on
// about (M + F)*D bytes put it far above the ~590 op/byte int8 ridge: it is
// bound by operations, on the int8 tensor cores at 1,979 TOP/s, which only
// wgmma reaches. Two bodies, chosen by the wrapper's shape rule
// (`w8a8_body`):
//   * `w8a8_matmul_wgmma_fwd` (D % 128, F % 16: every Mistral-7B int8
//     leaf) runs the Hopper body of w8a8_wgmma.cuh: the weight as wgmma's
//     register A straight from the TMA-loaded [k, n] tile (ldmatrix.trans
//     and byte permutes, no transpose in memory), xq by TMA as its shared
//     B, one s32 chain over the whole contraction, 128 columns x 256
//     tokens a persistent CTA (see that header's note).
//   * `w8a8_matmul_fwd` (any other layout) runs the 128x128 mma.sync
//     tiling of quant_mma.cuh, which K5 and K6 share: the weight tile is
//     transposed to k-contiguous columns in registers on its way into
//     padded static shared memory, with no TMA pipeline.
// (Below 1024 rows the engine sends int8 leaves to K2, bound by bytes;
// both bodies take any M all the same.)

#include "quant_mma.cuh"
#include "w8a8_wgmma.cuh"

namespace {

template <typename T>
cudaError_t run(const void* xv, const int8_t* q, const float* scale,
                void* outv, int8_t* xq, float* sx, int M, int D, int F,
                cudaStream_t st) {
  qmma::quantize_rows<T><<<M, qmma::QR_THREADS, 0, st>>>(
      static_cast<const T*>(xv), xq, sx, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return qmma::launch_qgemm<qmma::W8A8, T>(xq, q, scale, sx,
                                           static_cast<T*>(outv), nullptr,
                                           M, D, F, 1, 0, st);
}

}  // namespace

extern "C" int w8a8_matmul_fwd(const void* x, const void* q,
                               const void* scale, void* out, void* xq,
                               void* sx, int M, int D, int F, int is_bf16,
                               void* stream) {
  if (M <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  int8_t* xqq = static_cast<int8_t*>(xq);
  float* sxx = static_cast<float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(x, qq, sc, out, xqq, sxx, M, D, F, st);
  return (int)run<float>(x, qq, sc, out, xqq, sxx, M, D, F, st);
}

// the wgmma body (the layouts k4w::takes): x (bf16 or f32), q, scale,
// out, the scratch xq [M, D] int8 and sx [M] f32
extern "C" int w8a8_matmul_wgmma_fwd(const void* x, const void* q,
                                     const void* scale, void* out, void* xq,
                                     void* sx, int M, int D, int F,
                                     int is_bf16, void* stream) {
  if (!k4w::takes(M, D, F)) return (int)cudaErrorInvalidValue;
  const int8_t* qq = static_cast<const int8_t*>(q);
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
      e = k4w::launch(xqq, qq, sc, sxx, static_cast<__nv_bfloat16*>(out), M,
                      D, F, st);
  } else {
    qmma::quantize_rows<float><<<M, qmma::QR_THREADS, 0, st>>>(
        static_cast<const float*>(x), xqq, sxx, D);
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = k4w::launch(xqq, qq, sc, sxx, static_cast<float*>(out), M, D, F,
                      st);
  }
  return (int)e;
}

// the wgmma body's dynamic shared memory a CTA, in bytes
extern "C" int w8a8_matmul_wgmma_smem() { return (int)k4w::SMEM_BYTES; }

extern "C" const char* w8a8_matmul_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
