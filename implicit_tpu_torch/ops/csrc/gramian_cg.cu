// Long-row solve: explicit normal matrix per row, then masked CG on it.
//
// Replaces the TPU kernel implicit_tpu/ops/pallas_ops.py:_gramian_cg_kernel
// (reached through gramian_cg_solve), including its int8 variant (scales=,
// dequantized by the row loader of cg_common.cuh). For row c, with
// w = |d| - 1 and bv = max(d, 0) where d != 0 and y_l = Y[idx[c, l]]:
//
//   A[c] = YtY_reg + sum_l w_l y_l y_l^T,   b[c] = sum_l bv_l y_l
//
// then the same masked CG as cg_full.cu on the explicit A[c].
//
// Two launches. gramian_build_kernel forms A and b over a grid of
// (row, F-tile, F-tile): each block streams the row's entries in groups of
// 32, gathering the two 64-wide column tiles of every y_l through idx into
// shared memory (w folded into one of them), and accumulates a 64 x 64 tile
// of A in registers, 4 x 4 values per thread. The F x F accumulator is split
// across blocks, so F = 256 (256 KB in f32, more than a block's 227 KB of
// shared memory) takes the same path. A and b go to (C, F, F) and (C, F)
// float32 scratch that the caller allocates; A is stored transposed, so
// that the CG's matvec reads it along coalesced rows. gramian_cg_kernel
// then runs the CG with one warp per row, reading A[c] from L2.
//
// Bound: FMAs. The build does 2 * L * F^2 flops per row against L * F
// gathered values; at L >> F that is above what the CUDA cores sustain at
// the row's bytes. Tensor cores (wgmma) are the next step for this kernel.
// The int8 table changes only the loads: a quarter of the float32 bytes and
// one scale per staged entry, with the same FMAs.

#include "cg_common.cuh"

namespace als {

constexpr int kTile = 64;      // A-tile edge per block
constexpr int kChunk = 32;     // row entries staged per shared-memory round
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 A values each
constexpr int kCgWarps = 8;

template <class Rows>
__global__ void __launch_bounds__(kThreads)
gramian_build_kernel(const typename Rows::Elem* __restrict__ Y, const float* __restrict__ S,
                     const int* __restrict__ idx,
                     const float* __restrict__ dat, const float* __restrict__ yty,
                     float* __restrict__ At, float* __restrict__ b, int L, int F) {
  __shared__ float yi[kChunk][kTile];  // w_l * y_l over the row tile
  __shared__ float yj[kChunk][kTile];  // y_l over the column tile
  __shared__ float ws[kChunk], bvs[kChunk];
  __shared__ int is[kChunk];

  const long c = blockIdx.x;
  const int ti = blockIdx.y, tj = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool diag = ti == tj;  // diagonal blocks also accumulate b
  const int* ci = idx + c * L;
  const float* cd = dat + c * L;

  float acc[4][4];
  float bacc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    bacc[u] = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  }

  for (int l0 = 0; l0 < L; l0 += kChunk) {
    const int n = min(kChunk, L - l0);
    if (threadIdx.x < kChunk) {
      const int l = threadIdx.x;
      const float2 wb = DatEntries::weights(l < n ? cd[l0 + l] : 0.f);
      ws[l] = wb.x;
      bvs[l] = wb.y;
      is[l] = l < n ? ci[l0 + l] : 0;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int l = e / kTile, f = e % kTile;
      const int fi = ti * kTile + f, fj = tj * kTile + f;
      const typename Rows::Elem* yr = Y + (size_t)is[l] * F;
      const float sc = Rows::scale(S, is[l]);
      const bool live = l < n;
      yi[l][f] = (live && fi < F) ? Rows::at(yr, sc, fi) * ws[l] : 0.f;
      yj[l][f] = (live && fj < F) ? Rows::at(yr, sc, fj) : 0.f;
    }
    __syncthreads();
    for (int l = 0; l < n; ++l) {
      float a[4], bb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = yi[l][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bb[v] = yj[l][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * bb[v];
      if (diag && ty == 0) {
#pragma unroll
        for (int v = 0; v < 4; ++v) bacc[v] += bvs[l] * bb[v];
      }
    }
    __syncthreads();
  }

  float* Ac = At + c * F * F;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int fi = ti * kTile + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int fj = tj * kTile + tx + 16 * v;
      // At[g][f] = A[f][g]
      if (fi < F && fj < F) Ac[(size_t)fj * F + fi] = yty[(size_t)fi * F + fj] + acc[u][v];
    }
  }
  if (diag && ty == 0) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int f = tj * kTile + tx + 16 * v;
      if (f < F) b[c * F + f] = bacc[v];
    }
  }
}

template <int VPT>
__global__ void __launch_bounds__(kCgWarps * 32)
gramian_cg_kernel(const float* __restrict__ At, const float* __restrict__ b,
                  const float* __restrict__ x0, float* __restrict__ out, int C, int F,
                  int cg_steps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* vs = smem + warp * F;
  for (long c = (long)blockIdx.x * kCgWarps + warp; c < C; c += (long)gridDim.x * kCgWarps) {
    const float* M = At + c * F * F;
    float x[VPT], r[VPT], ax[VPT];
    load_row<VPT>(x0 + c * F, x, F, lane);
    load_row<VPT>(b + c * F, r, F, lane);
    row_matvec<VPT>(M, vs, x, ax, F, lane);
#pragma unroll
    for (int k = 0; k < VPT; ++k) r[k] -= ax[k];
    masked_cg<VPT>(x, r, cg_steps, [&](const float (&p)[VPT], float (&Ap)[VPT]) {
      row_matvec<VPT>(M, vs, p, Ap, F, lane);
    });
    store_row<VPT>(out + c * F, x, F, lane);
  }
}

template <int VPT>
int launch_cg(const float* At, const float* b, const float* x0, float* out, int C, int F,
              int cg_steps, cudaStream_t stream) {
  auto kernel = gramian_cg_kernel<VPT>;
  const int threads = kCgWarps * 32;
  const size_t smem = sizeof(float) * (size_t)kCgWarps * F;
  const int grid = resident_grid(kernel, threads, smem, (C + kCgWarps - 1) / kCgWarps);
  kernel<<<grid, threads, smem, stream>>>(At, b, x0, out, C, F, cg_steps);
  return (int)cudaGetLastError();
}

template <class Rows>
int dispatch(const void* Y, const void* S, const void* idx, const void* dat, const void* x0,
             const void* yty, void* A, void* b, void* out, int C, int L, int F, int cg_steps,
             void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (F > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (F + kTile - 1) / kTile;
  gramian_build_kernel<Rows><<<dim3(C, nt, nt), kThreads, 0, s>>>(
      static_cast<const typename Rows::Elem*>(Y), static_cast<const float*>(S),
      static_cast<const int*>(idx), static_cast<const float*>(dat),
      static_cast<const float*>(yty), static_cast<float*>(A), static_cast<float*>(b), L, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* At = static_cast<const float*>(A);
  const float* bb = static_cast<const float*>(b);
  const float* xx = static_cast<const float*>(x0);
  float* o = static_cast<float*>(out);
  if (F <= 32) return launch_cg<1>(At, bb, xx, o, C, F, cg_steps, s);
  if (F <= 64) return launch_cg<2>(At, bb, xx, o, C, F, cg_steps, s);
  if (F <= 128) return launch_cg<4>(At, bb, xx, o, C, F, cg_steps, s);
  return launch_cg<8>(At, bb, xx, o, C, F, cg_steps, s);
}

}  // namespace als

// Y (N, F) float32 or bfloat16; idx (C, L) int32; dat (C, L) float32;
// x0 (C, F) float32; yty (F, F) float32; A (C, F, F) and b (C, F) float32
// scratch -> out (C, F) float32. Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int gramian_cg_f32(const void* Y, const void* idx, const void* dat, const void* x0,
                              const void* yty, void* A, void* b, void* out, int C, int L,
                              int F, int cg_steps, void* stream) {
  return als::dispatch<als::TableRows<float>>(Y, nullptr, idx, dat, x0, yty, A, b, out, C, L, F,
                                              cg_steps, stream);
}

extern "C" int gramian_cg_bf16(const void* Y, const void* idx, const void* dat, const void* x0,
                               const void* yty, void* A, void* b, void* out, int C, int L,
                               int F, int cg_steps, void* stream) {
  return als::dispatch<als::TableRows<__nv_bfloat16>>(Y, nullptr, idx, dat, x0, yty, A, b, out,
                                                      C, L, F, cg_steps, stream);
}

// The int8 table: Yq (N, F) int8 and its per-row scales s (N,) float32;
// the other arguments as above.
extern "C" int gramian_cg_i8(const void* Yq, const void* s, const void* idx, const void* dat,
                             const void* x0, const void* yty, void* A, void* b, void* out,
                             int C, int L, int F, int cg_steps, void* stream) {
  return als::dispatch<als::QuantRows>(Yq, s, idx, dat, x0, yty, A, b, out, C, L, F, cg_steps,
                                       stream);
}
