// One pass of the CG's sparse term over a chunk, with the row gather fused in.
//
// Replaces the TPU kernel implicit_tpu/ops/pallas_ops.py:_weighted_matvec_kernel
// (reached through weighted_matvec), including its int8 variant (scales=,
// dequantized by the row loader of cg_common.cuh). For row c:
//
//   out[c] = sum_l (alpha * bv[c, l] + beta * w[c, l] * (y_l . v[c])) * y_l
//
// with y_l = Y[idx[c, l]] read straight from the factor table. (alpha, beta)
// = (1, -1) is the sparse part of the CG residual and (0, 1) that of A p;
// the composed CG (implicit_tpu_torch/ops/als.py:_cg_class, use_pallas=True)
// calls it cg_steps + 1 times per chunk.
//
// Bound: bytes, one read of the row's L * F gathered values per call. The
// TPU kernel tiles L and carries a (BC, F) accumulator across a sequential
// grid axis, masking a partial last tile; here one warp owns a row and walks
// all of it (sparse_term in cg_common.cuh, the loop cg_full.cu runs), so
// nothing carries between blocks and the loop ends at L for any L.

#include "cg_common.cuh"

namespace als {

constexpr int kWarps = 8;  // rows in flight per block

template <class Rows, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
weighted_matvec_kernel(const typename Rows::Elem* __restrict__ Y, const float* __restrict__ S,
                       const int* __restrict__ idx, const float* __restrict__ w,
                       const float* __restrict__ bv, const float* __restrict__ v,
                       float* __restrict__ out, int C, int L, int F, float alpha, float beta) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long c = (long)blockIdx.x * kWarps + warp;
  if (c >= C) return;  // whole warps leave: the shuffles below stay full
  float vr[VPT], acc[VPT];
  load_row<VPT>(v + c * F, vr, F, lane);
  sparse_term<VPT, Rows, WeightEntries>(Y, S, w + c * L, bv + c * L, idx + c * L, L, F, lane,
                                        alpha, beta, vr, acc);
  store_row<VPT>(out + c * F, acc, F, lane);
}

template <class Rows, int VPT>
int launch(const void* Y, const void* S, const void* idx, const void* w, const void* bv,
           const void* v, void* out, int C, int L, int F, float alpha, float beta,
           cudaStream_t stream) {
  const int grid = (C + kWarps - 1) / kWarps;
  weighted_matvec_kernel<Rows, VPT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const typename Rows::Elem*>(Y), static_cast<const float*>(S),
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(bv), static_cast<const float*>(v), static_cast<float*>(out),
      C, L, F, alpha, beta);
  return (int)cudaGetLastError();
}

template <class Rows>
int dispatch(const void* Y, const void* S, const void* idx, const void* w, const void* bv,
             const void* v, void* out, int C, int L, int F, float alpha, float beta,
             void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 32) return launch<Rows, 1>(Y, S, idx, w, bv, v, out, C, L, F, alpha, beta, s);
  if (F <= 64) return launch<Rows, 2>(Y, S, idx, w, bv, v, out, C, L, F, alpha, beta, s);
  if (F <= 128) return launch<Rows, 4>(Y, S, idx, w, bv, v, out, C, L, F, alpha, beta, s);
  if (F <= 256) return launch<Rows, 8>(Y, S, idx, w, bv, v, out, C, L, F, alpha, beta, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace als

// Y (N, F) float32 or bfloat16; idx (C, L) int32; w, bv (C, L) float32;
// v (C, F) float32 -> out (C, F) float32. Returns the launch's cudaError_t
// (0 on success).
extern "C" int weighted_matvec_f32(const void* Y, const void* idx, const void* w,
                                   const void* bv, const void* v, void* out, int C, int L,
                                   int F, float alpha, float beta, void* stream) {
  return als::dispatch<als::TableRows<float>>(Y, nullptr, idx, w, bv, v, out, C, L, F, alpha,
                                              beta, stream);
}

extern "C" int weighted_matvec_bf16(const void* Y, const void* idx, const void* w,
                                    const void* bv, const void* v, void* out, int C, int L,
                                    int F, float alpha, float beta, void* stream) {
  return als::dispatch<als::TableRows<__nv_bfloat16>>(Y, nullptr, idx, w, bv, v, out, C, L, F,
                                                      alpha, beta, stream);
}

// The int8 table: Yq (N, F) int8 and its per-row scales s (N,) float32;
// the other arguments as above.
extern "C" int weighted_matvec_i8(const void* Yq, const void* s, const void* idx,
                                  const void* w, const void* bv, const void* v, void* out,
                                  int C, int L, int F, float alpha, float beta, void* stream) {
  return als::dispatch<als::QuantRows>(Yq, s, idx, w, bv, v, out, C, L, F, alpha, beta, stream);
}
