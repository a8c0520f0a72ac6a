// K4: W8A8 matmul for Hopper (sm_90a), CUDA C++ with a plain C interface
// (built by ops/_build.py, bound with ctypes by ops/quant_matmul.py).
//
// Replaces: copilot_for_consensus_tpu/ops/quant_matmul.py, `w8a8_matmul`
//   (pallas_call) and its body `_kernel_w8a8`.
//
// Computes out[M, F] = (xq @ q) * sx * sw: x (bf16 or f32) quantized per
// row to int8 by `quantize_rows` (scale amax/127, IEEE division, rounding
// half to even, a clip to +-127; into scratch the wrapper allocates), the
// int8 product summed exactly in int32 on the tensor cores (mma.sync
// m16n8k32 s8), then (acc * sx) * sw in f32, rounded once to x's dtype.
// The arithmetic is exact up to that finalize, which is the plain
// version's operation for operation, so the two agree bit for bit.
//
// What bounds it on this card, and what the design does about it: on the
// serving path K4 runs only for prefill waves (M >= 1024 rows: the int8
// leaves at M = 4096 in the 4 x 1024 wave), where 2*M*D*F operations on
// about (M + F)*D bytes put it far above the ~590 op/byte int8 ridge: it is
// bound by operations, on the int8 tensor cores at 1,979 TOP/s. The design
// takes the int8 tensor-core path (twice the bf16 rate) with 128x128 tiles
// of 8 warps; the weight tile is transposed to k-contiguous columns in
// registers on its way into shared memory. No cp.async/TMA pipeline or
// wgmma yet: later work. (Below 1024 rows the engine sends int8 leaves to
// K2, bound by bytes; this kernel takes any M all the same.) The tiled
// body is shared with K5 and K6 (quant_mma.cuh).

#include "quant_mma.cuh"

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

extern "C" const char* w8a8_matmul_error(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
