// The dense term and the masked update of one CG pass, for every row of a
// chunk. With weighted_matvec.cu, which gives each pass's sparse term, it is
// the CG solve of a fit wider than cg_full.cu and gramian_cg.cu take
// (F > 256 factors), launched by cg_kernels.cg_solve_wide.
//
// Replaces, past F = 256, the CG arithmetic that the TPU kernels
// implicit_tpu/ops/pallas_ops.py:_cg_full_kernel (the residual, Ap's dense
// term dense(p) = p YtY_reg, and the masked x, r, p updates of each step) and
// _gramian_cg_kernel run in their bodies. For row c, with s[c] what
// weighted_matvec gave:
//
//   first pass, s = sum_l (bv - w (y_l . x0)) y_l:
//     r = s - x0 YtY_reg;  x = x0;  p = r;  rs = r . r;  act = rs >= 1e-20
//   each CG step, s = sum_l w (y_l . p) y_l:
//     Ap = s + p YtY_reg;  alpha = act ? rs / (p . Ap) : 0  (p . Ap == 0 reads 1)
//     x += alpha p;  r -= alpha Ap;  rs' = r . r;  still = act && rs' >= 1e-20
//     beta = act ? rs' / rs : 0;  p = still ? r + beta p : p
//     rs = still ? rs' : rs;  act = still
//
// the steps of implicit_tpu.ops.als._masked_cg, row by row. s is read
// only; the product goes through a (C, F) scratch t.
//
// Bound: a pass costs 2 F^2 flops of dense term per row against 28 F bytes
// of row vectors (p, s, x, r read, x, r, p written). On the float32 CUDA
// cores (67 TFLOP/s) that product binds from F ~ 300 up; in 3xTF32 on the
// tensor cores (495 / 3 TFLOP/s, float32 accuracy, as gramian_cg.cu's
// build) the bytes would bind up to F ~ 700. A 3xTF32 mma.sync version of
// phase 1 (32 x 16 per warp, scalar fragment loads from shared memory) ran
// 1.25x slower at F = 512 on an H100 and no faster at F = 320, so the
// product stays on the CUDA cores, register-tiled:
//
// - A block of 256 threads owns 64 rows. Phase 1, the dense term: each
//   thread accumulates 8 rows x 8 columns of a 256-column panel, from chunks
//   of 16 k-values of p (transposed) and YtY_reg in shared memory, so that
//   64 FMAs cost 4 16-byte shared loads (a warp's 8 rows are one broadcast;
//   its columns two runs of 128 contiguous values, no bank conflict). The
//   chunks are double-buffered: cp.async copies the next one while this
//   one is multiplied, which costs no registers (a register prefetch held
//   the tile to 32 rows at 2 blocks per SM and ran 1.1-1.2x slower on an
//   H100). YtY_reg is read once per block and panel, from L2. The sum over
//   k runs in one fixed order, and the product is stored to t without a
//   read.
// - Phase 2, the update: a warp per row, lanes over f, 4 values per lane
//   loaded before any is stored (the vectors may alias, so the compiler
//   would not batch them). Each dot is the lanes' sums in f order reduced
//   by warp_sum: the same inputs give the same bits, with no atomics.

#include "cg_common.cuh"

namespace als {
namespace cgu {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                                  // rows per block
constexpr int kRowsPer = 8;                                // rows per thread, phase 1
constexpr int kColsPer = 8;                                // columns per thread, phase 1
constexpr int kColThreads = kThreads / (kRows / kRowsPer);  // 32: a warp shares its rows
constexpr int kPanel = kColThreads * kColsPer;             // 256 columns per panel
constexpr int kHalf = kPanel / 2;  // a thread's columns: 4 at ct * 4, 4 more kHalf on
constexpr int kDepth = 16;                                 // k-values per staged chunk
constexpr int kStride = kRows + 4;  // staged p^T row: 16-byte aligned, fewer bank conflicts
constexpr int kBatch = 4;  // values per lane loaded together in phase 2
static_assert(kPanel == kThreads, "a thread stages one column of each chunk");

// Phase 2's batches: lane `lane` holds f = f0 + 32 u, u < kBatch, of a row
__device__ __forceinline__ void load_batch(const float* src, int f0, int F, float (&out)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) out[u] = f0 + 32 * u < F ? src[f0 + 32 * u] : 0.f;
}

__device__ __forceinline__ void store_batch(float* dst, int f0, int F, const float (&in)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (f0 + 32 * u < F) dst[f0 + 32 * u] = in[u];
}

// 4 bytes from global to shared memory, asynchronously; zeros where !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}

// v is the product's left operand: x0 on the first pass, p (the same
// pointer) on a step; t (C, F) is scratch for the product v YtY_reg.
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ yty, const float* v, const float* s, float* t,
                 float* x, float* r, float* p, float* rs, int* act, int C, int F, int first) {
  __shared__ __align__(16) float pt[2][kDepth][kStride];
  __shared__ __align__(16) float yt[2][kDepth][kPanel];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid / kColThreads, ct = tid % kColThreads;
  const long c0 = (long)blockIdx.x * kRows;
  const int nrows = (int)min((long)kRows, C - c0);

  // phase 1: t <- v YtY_reg, panel by panel; chunk step + 1 is copied into
  // the other shared buffer (cp.async) while chunk step is multiplied
  const int chunks = (F + kDepth - 1) / kDepth, panels = (F + kPanel - 1) / kPanel;
  const int steps = panels * chunks;
  auto stage = [&](int step) {
    const int b = step & 1, n = (step / chunks) * kPanel + tid, k0 = (step % chunks) * kDepth;
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      const bool ok = k0 + q < F && n < F;
      cp_async4(&yt[b][q][tid], ok ? yty + (long)(k0 + q) * F + n : yty, ok);
    }
#pragma unroll
    for (int q = 0; q < kRows * kDepth / kThreads; ++q) {
      const int e = tid + q * kThreads, i = e / kDepth, k = k0 + e % kDepth;
      const bool ok = i < nrows && k < F;
      cp_async4(&pt[b][e % kDepth][i], ok ? v + (c0 + i) * F + k : v, ok);
    }
  };
  float acc[kRowsPer][kColsPer];
  stage(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int step = 0; step < steps; ++step) {
    if (step % chunks == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kColsPer; ++j) acc[i][j] = 0.f;
    }
    if (step + 1 < steps) stage(step + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk step has landed
    __syncthreads();
    const int b = step & 1;
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&pt[b][kk][rg * kRowsPer]);
      const float4 a1 = *reinterpret_cast<const float4*>(&pt[b][kk][rg * kRowsPer + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&yt[b][kk][ct * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&yt[b][kk][kHalf + ct * 4]);
      const float a[kRowsPer] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[kColsPer] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kColsPer; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();  // buffer b is read: the next step may refill it
    if (step % chunks == chunks - 1) {  // the panel's sums are complete
      const int n0 = (step / chunks) * kPanel + ct * 4;
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int row = rg * kRowsPer + i;
        if (row >= nrows) continue;
        float* tr = t + (c0 + row) * F;
#pragma unroll
        for (int j = 0; j < kColsPer; ++j) {
          const int n = n0 + (j / 4) * kHalf + j % 4;
          if (n < F) tr[n] = acc[i][j];
        }
      }
    }
  }
  __syncthreads();  // t holds v YtY_reg for the block's rows

  // phase 2: a warp per row, kBatch values per lane loaded together
  for (int i = warp; i < nrows; i += kWarps) {
    const long c = c0 + i, o = c * F;
    float a[kBatch], b[kBatch], e[kBatch], d[kBatch], q[kBatch];
    if (first) {  // r = s - x0 YtY_reg, x = x0, p = r
      float sum = 0.f;
      for (int f0 = lane; f0 < F; f0 += 32 * kBatch) {
        load_batch(s + o, f0, F, a);
        load_batch(t + o, f0, F, b);
        load_batch(v + o, f0, F, e);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          a[u] -= b[u];
          sum += a[u] * a[u];
        }
        store_batch(x + o, f0, F, e);
        store_batch(r + o, f0, F, a);
        store_batch(p + o, f0, F, a);
      }
      const float rs0 = warp_sum(sum);
      if (lane == 0) {
        rs[c] = rs0;
        act[c] = rs0 >= kFreeze;  // NaN freezes too, as in the masked form
      }
      continue;
    }
    float pap = 0.f;  // Ap = s + p YtY_reg
    for (int f0 = lane; f0 < F; f0 += 32 * kBatch) {
      load_batch(p + o, f0, F, a);
      load_batch(s + o, f0, F, b);
      load_batch(t + o, f0, F, e);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) pap += a[u] * (b[u] + e[u]);
    }
    pap = warp_sum(pap);
    const float rsold = rs[c];
    const bool on = act[c] != 0;
    const float alpha = on ? rsold / (pap == 0.f ? 1.f : pap) : 0.f;
    float sum = 0.f;
    for (int f0 = lane; f0 < F; f0 += 32 * kBatch) {
      load_batch(p + o, f0, F, a);
      load_batch(s + o, f0, F, b);
      load_batch(t + o, f0, F, e);
      load_batch(x + o, f0, F, d);
      load_batch(r + o, f0, F, q);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        d[u] += alpha * a[u];
        q[u] -= alpha * (b[u] + e[u]);
        sum += q[u] * q[u];
      }
      store_batch(x + o, f0, F, d);
      store_batch(r + o, f0, F, q);
    }
    const float rsnew = warp_sum(sum);
    const bool still = on && rsnew >= kFreeze;
    const float beta = on ? rsnew / rsold : 0.f;
    if (still) {
      for (int f0 = lane; f0 < F; f0 += 32 * kBatch) {
        load_batch(r + o, f0, F, q);
        load_batch(p + o, f0, F, a);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) a[u] = q[u] + beta * a[u];
        store_batch(p + o, f0, F, a);
      }
    }
    if (lane == 0) {
      rs[c] = still ? rsnew : rsold;
      act[c] = still;
    }
  }
}

}  // namespace cgu
}  // namespace als

// One pass over a chunk of C rows of F values: yty (F, F), v, s (C, F)
// float32 in; t (C, F) float32 scratch; x, r, p (C, F) float32, rs (C,)
// float32 and act (C,) int32 in place. first != 0: the residual pass, v =
// x0 (x, r, p, rs, act are written); else a CG step, v = p. Returns the
// launch's cudaError_t (0 on success).
extern "C" int cg_update(const void* yty, const void* v, const void* s, void* t, void* x,
                         void* r, void* p, void* rs, void* act, int C, int F, int first,
                         void* stream) {
  using namespace als::cgu;
  if (C < 0 || F < 1) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  cg_update_kernel<<<(C + kRows - 1) / kRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yty), static_cast<const float*>(v), static_cast<const float*>(s),
      static_cast<float*>(t), static_cast<float*>(x), static_cast<float*>(r),
      static_cast<float*>(p), static_cast<float*>(rs), static_cast<int*>(act), C, F, first);
  return (int)cudaGetLastError();
}
