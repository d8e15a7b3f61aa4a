// Whole warm-started masked CG solve per row, with the row gather fused in.
//
// Replaces the TPU kernel implicit_tpu/ops/pallas_ops.py:_cg_full_kernel
// (reached through cg_solve_full). For row c with entries (idx[c, l],
// dat[c, l]) and w = |d| - 1, bv = max(d, 0) where d != 0:
//
//   r  = sum_l (bv - w * (y_l . x)) y_l - x YtY_reg
//   Ap = sum_l w * (y_l . p) y_l + p YtY_reg          (cg_steps iterations)
//
// with y_l = Y[idx[c, l]] read straight from the factor table: the (C, L, F)
// gathered block is never written to device memory.
//
// Bound: bytes. Each of the cg_steps + 1 passes re-reads the row's L * F
// gathered values. The design keeps everything else off that path: one warp
// per row holds x, r, p in registers; y . p is a shuffle reduction; a row's
// 32 (index, value) pairs are loaded once per 32 entries and broadcast by
// shuffles; four entries are in flight at once. YtY_reg is staged once per
// block in shared memory when F <= 128 (64 KB) and read from L2 above that.
// Blocks loop over rows, so the staging is paid once per resident block.

#include "cg_common.cuh"

namespace als {

constexpr int kWarps = 8;   // rows in flight per block
constexpr int kUnroll = 4;  // row entries in flight per warp

// acc = sum_l coeff_l * y_l over one row, coeff_l = bv - w * (y_l . v) for
// the residual (RESID) and w * (y_l . v) for A p. Padding (d == 0) has
// coeff 0 and so contributes nothing, as in the TPU kernel.
template <typename T, int VPT, bool RESID>
__device__ __forceinline__ void sparse_term(const T* __restrict__ Y, const int* __restrict__ ci,
                                            const float* __restrict__ cd, int L, int F,
                                            int lane, const float (&v)[VPT],
                                            float (&acc)[VPT]) {
#pragma unroll
  for (int k = 0; k < VPT; ++k) acc[k] = 0.f;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    const float dl = lane < n ? cd[l0 + lane] : 0.f;
    const int il = lane < n ? ci[l0 + lane] : 0;
    for (int j = 0; j < n; j += kUnroll) {
      float d[kUnroll];
      int i[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        d[u] = __shfl_sync(kFull, dl, (j + u) & 31);
        i[u] = __shfl_sync(kFull, il, (j + u) & 31);
        if (j + u >= n) d[u] = 0.f;
      }
      if (d[0] == 0.f && d[1] == 0.f && d[2] == 0.f && d[3] == 0.f) continue;
      float y[kUnroll][VPT];
      float t[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* yr = Y + (size_t)i[u] * F;
        t[u] = 0.f;
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int f = k * 32 + lane;
          y[u][k] = (f < F && d[u] != 0.f) ? to_f(yr[f]) : 0.f;
          t[u] += y[u][k] * v[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) t[u] = warp_sum(t[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float w = d[u] != 0.f ? fabsf(d[u]) - 1.f : 0.f;
        const float coeff = RESID ? fmaxf(d[u], 0.f) - w * t[u] : w * t[u];
#pragma unroll
        for (int k = 0; k < VPT; ++k) acc[k] += coeff * y[u][k];
      }
    }
  }
}

template <typename T, int VPT, bool SMEM_YTY>
__global__ void __launch_bounds__(kWarps * 32)
cg_full_kernel(const T* __restrict__ Y, const int* __restrict__ idx,
               const float* __restrict__ dat, const float* __restrict__ x0,
               const float* __restrict__ yty, float* __restrict__ out,
               int C, int L, int F, int cg_steps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* vs = smem + warp * F;
  const float* M = yty;
  if (SMEM_YTY) {
    float* ys = smem + kWarps * F;
    for (int e = threadIdx.x; e < F * F; e += blockDim.x) ys[e] = yty[e];
    __syncthreads();
    M = ys;
  }
  for (long c = (long)blockIdx.x * kWarps + warp; c < C; c += (long)gridDim.x * kWarps) {
    const int* ci = idx + c * L;
    const float* cd = dat + c * L;
    float x[VPT], r[VPT], sp[VPT], dn[VPT];
    load_row<VPT>(x0 + c * F, x, F, lane);
    sparse_term<T, VPT, true>(Y, ci, cd, L, F, lane, x, sp);
    row_matvec<VPT>(M, vs, x, dn, F, lane);
#pragma unroll
    for (int k = 0; k < VPT; ++k) r[k] = sp[k] - dn[k];
    masked_cg<VPT>(x, r, cg_steps, [&](const float (&p)[VPT], float (&Ap)[VPT]) {
      sparse_term<T, VPT, false>(Y, ci, cd, L, F, lane, p, sp);
      row_matvec<VPT>(M, vs, p, dn, F, lane);
#pragma unroll
      for (int k = 0; k < VPT; ++k) Ap[k] = sp[k] + dn[k];
    });
    store_row<VPT>(out + c * F, x, F, lane);
  }
}

template <typename T, int VPT, bool SMEM_YTY>
int launch(const void* Y, const void* idx, const void* dat, const void* x0, const void* yty,
           void* out, int C, int L, int F, int cg_steps, cudaStream_t stream) {
  auto kernel = cg_full_kernel<T, VPT, SMEM_YTY>;
  const int threads = kWarps * 32;
  const size_t smem = sizeof(float) * ((size_t)kWarps * F + (SMEM_YTY ? (size_t)F * F : 0));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = resident_grid(kernel, threads, smem, (C + kWarps - 1) / kWarps);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(Y), static_cast<const int*>(idx), static_cast<const float*>(dat),
      static_cast<const float*>(x0), static_cast<const float*>(yty), static_cast<float*>(out),
      C, L, F, cg_steps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* Y, const void* idx, const void* dat, const void* x0, const void* yty,
             void* out, int C, int L, int F, int cg_steps, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 32) return launch<T, 1, true>(Y, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 64) return launch<T, 2, true>(Y, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 128) return launch<T, 4, true>(Y, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 256) return launch<T, 8, false>(Y, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace als

// Y (N, F) float32 or bfloat16; idx (C, L) int32; dat (C, L) float32;
// x0 (C, F) float32; yty (F, F) float32 -> out (C, F) float32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int cg_full_f32(const void* Y, const void* idx, const void* dat, const void* x0,
                           const void* yty, void* out, int C, int L, int F, int cg_steps,
                           void* stream) {
  return als::dispatch<float>(Y, idx, dat, x0, yty, out, C, L, F, cg_steps, stream);
}

extern "C" int cg_full_bf16(const void* Y, const void* idx, const void* dat, const void* x0,
                            const void* yty, void* out, int C, int L, int F, int cg_steps,
                            void* stream) {
  return als::dispatch<__nv_bfloat16>(Y, idx, dat, x0, yty, out, C, L, F, cg_steps, stream);
}
