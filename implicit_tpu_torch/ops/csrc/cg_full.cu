// Whole warm-started masked CG solve per row, with the row gather fused in.
//
// Replaces the TPU kernel implicit_tpu/ops/pallas_ops.py:_cg_full_kernel
// (reached through cg_solve_full), including its int8 variant (scales=,
// dequantized as _dequant_tile does). For row c with entries (idx[c, l],
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
// shuffles; four entries are in flight at once (sparse_term in
// cg_common.cuh). YtY_reg is staged once per block in shared memory when
// F <= 128 (64 KB) and read from L2 above that. Blocks loop over rows, so
// the staging is paid once per resident block. The int8 table reads a
// quarter of the float32 bytes per pass, plus one scale per entry.

#include "cg_common.cuh"

namespace als {

constexpr int kWarps = 8;  // rows in flight per block

template <class Rows, int VPT, bool SMEM_YTY>
__global__ void __launch_bounds__(kWarps * 32)
cg_full_kernel(const typename Rows::Elem* __restrict__ Y, const float* __restrict__ S,
               const int* __restrict__ idx, const float* __restrict__ dat,
               const float* __restrict__ x0, const float* __restrict__ yty,
               float* __restrict__ out, int C, int L, int F, int cg_steps) {
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
    sparse_term<VPT, Rows, DatEntries>(Y, S, cd, nullptr, ci, L, F, lane, 1.f, -1.f, x, sp);
    row_matvec<VPT>(M, vs, x, dn, F, lane);
#pragma unroll
    for (int k = 0; k < VPT; ++k) r[k] = sp[k] - dn[k];
    masked_cg<VPT>(x, r, cg_steps, [&](const float (&p)[VPT], float (&Ap)[VPT]) {
      sparse_term<VPT, Rows, DatEntries>(Y, S, cd, nullptr, ci, L, F, lane, 0.f, 1.f, p, sp);
      row_matvec<VPT>(M, vs, p, dn, F, lane);
#pragma unroll
      for (int k = 0; k < VPT; ++k) Ap[k] = sp[k] + dn[k];
    });
    store_row<VPT>(out + c * F, x, F, lane);
  }
}

template <class Rows, int VPT, bool SMEM_YTY>
int launch(const void* Y, const void* S, const void* idx, const void* dat, const void* x0,
           const void* yty, void* out, int C, int L, int F, int cg_steps, cudaStream_t stream) {
  auto kernel = cg_full_kernel<Rows, VPT, SMEM_YTY>;
  const int threads = kWarps * 32;
  const size_t smem = sizeof(float) * ((size_t)kWarps * F + (SMEM_YTY ? (size_t)F * F : 0));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = resident_grid(kernel, threads, smem, (C + kWarps - 1) / kWarps);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const typename Rows::Elem*>(Y), static_cast<const float*>(S),
      static_cast<const int*>(idx), static_cast<const float*>(dat),
      static_cast<const float*>(x0), static_cast<const float*>(yty), static_cast<float*>(out),
      C, L, F, cg_steps);
  return (int)cudaGetLastError();
}

template <class Rows>
int dispatch(const void* Y, const void* S, const void* idx, const void* dat, const void* x0,
             const void* yty, void* out, int C, int L, int F, int cg_steps, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 32) return launch<Rows, 1, true>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 64) return launch<Rows, 2, true>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 128) return launch<Rows, 4, true>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 256)
    return launch<Rows, 8, false>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace als

// Y (N, F) float32 or bfloat16; idx (C, L) int32; dat (C, L) float32;
// x0 (C, F) float32; yty (F, F) float32 -> out (C, F) float32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int cg_full_f32(const void* Y, const void* idx, const void* dat, const void* x0,
                           const void* yty, void* out, int C, int L, int F, int cg_steps,
                           void* stream) {
  return als::dispatch<als::TableRows<float>>(Y, nullptr, idx, dat, x0, yty, out, C, L, F,
                                              cg_steps, stream);
}

extern "C" int cg_full_bf16(const void* Y, const void* idx, const void* dat, const void* x0,
                            const void* yty, void* out, int C, int L, int F, int cg_steps,
                            void* stream) {
  return als::dispatch<als::TableRows<__nv_bfloat16>>(Y, nullptr, idx, dat, x0, yty, out, C, L,
                                                      F, cg_steps, stream);
}

// The int8 table: Yq (N, F) int8 and its per-row scales s (N,) float32;
// the other arguments as above.
extern "C" int cg_full_i8(const void* Yq, const void* s, const void* idx, const void* dat,
                          const void* x0, const void* yty, void* out, int C, int L, int F,
                          int cg_steps, void* stream) {
  return als::dispatch<als::QuantRows>(Yq, s, idx, dat, x0, yty, out, C, L, F, cg_steps, stream);
}
