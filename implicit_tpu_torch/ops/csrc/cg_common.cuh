// Shared pieces of the ALS solve kernels (cg_full.cu, gramian_cg.cu).
//
// One warp owns one row of the solve. A factor vector of width F <= 256 is
// held in registers, VPT = ceil(F / 32) values per lane, in a strided layout:
// lane `lane` holds f = k * 32 + lane for k < VPT. Entries with f >= F are
// kept at 0, so they never enter a dot product. Dots are warp-shuffle
// reductions; every branch on a reduced value is warp-uniform.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace als {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kFreeze = 1e-20f;  // rows freeze once rs < this

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int VPT>
__device__ __forceinline__ float dot(const float (&a)[VPT], const float (&b)[VPT]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) s += a[k] * b[k];
  return warp_sum(s);
}

template <int VPT>
__device__ __forceinline__ void load_row(const float* src, float (&v)[VPT], int F, int lane) {
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int f = k * 32 + lane;
    v[k] = f < F ? src[f] : 0.f;
  }
}

template <int VPT>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[VPT], int F, int lane) {
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int f = k * 32 + lane;
    if (f < F) dst[f] = v[k];
  }
}

// out[f] = sum_g v[g] * M[g * F + f]: the row vector v times an (F, F)
// matrix M, in shared or global memory. v is staged through the warp's
// F-float slot `vs` so that every lane sees all of it; lanes read
// consecutive f, so the loads of M coalesce.
template <int VPT>
__device__ __forceinline__ void row_matvec(const float* __restrict__ M, float* vs,
                                           const float (&v)[VPT], float (&out)[VPT],
                                           int F, int lane) {
  store_row<VPT>(vs, v, F, lane);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < VPT; ++k) out[k] = 0.f;
  for (int g = 0; g < F; ++g) {
    const float vg = vs[g];
    const float* mg = M + (size_t)g * F;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int f = k * 32 + lane;
      if (f < F) out[k] += vg * mg[f];
    }
  }
  __syncwarp();  // vs is rewritten by the next call
}

// `cg_steps` masked conjugate-gradient iterations from residual r, updating
// x in place. The same steps as implicit_tpu.ops.als._masked_cg on one row:
// a row whose squared residual is below 1e-20 freezes (here: leaves the
// loop, which keeps x, as the masked form does).
template <int VPT, class ApplyA>
__device__ __forceinline__ void masked_cg(float (&x)[VPT], float (&r)[VPT], int cg_steps,
                                          ApplyA apply_a) {
  float p[VPT], Ap[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) p[k] = r[k];
  float rsold = dot<VPT>(r, r);
  if (!(rsold >= kFreeze)) return;  // NaN freezes too, as in the masked form
  for (int it = 0; it < cg_steps; ++it) {
    apply_a(p, Ap);
    const float pAp = dot<VPT>(p, Ap);
    const float alpha = rsold / (pAp == 0.f ? 1.f : pAp);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      x[k] += alpha * p[k];
      r[k] -= alpha * Ap[k];
    }
    const float rsnew = dot<VPT>(r, r);
    if (!(rsnew >= kFreeze)) return;
    const float beta = rsnew / rsold;
#pragma unroll
    for (int k = 0; k < VPT; ++k) p[k] = r[k] + beta * p[k];
    rsold = rsnew;
  }
}

// Blocks to launch for a kernel whose blocks loop over rows: enough to fill
// every SM at the kernel's occupancy, never more than the rows need.
template <class Kernel>
inline int resident_grid(Kernel kernel, int threads, size_t smem, long needed) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  long grid = (long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > needed) grid = needed;
  return (int)(grid > 0 ? grid : 1);
}

}  // namespace als

extern "C" const char* als_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
