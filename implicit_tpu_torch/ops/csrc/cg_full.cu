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
// Bound. Per row and pass (the residual and each CG step) the work is
// 2 F^2 flops of dense term and 4 F flops per live entry of sparse term, in
// float32 on the CUDA cores: the function is bound by operations (67 TFLOP/s
// f32 on an H100 SXM), far above its bytes when each table row is counted
// once. The kernel cannot reach that bound, since it re-gathers each row's
// y_l on every pass (an SM cannot hold a row's block; staging the rows that
// fit is ROADMAP B8), so in practice the sparse term is bound by the latency
// and rate of its gathers from L2 and HBM. On an H100 SXM at 700 W this
// design reaches 10-11% of the bound at (C, L, F) = (4096, 64, 128) in
// float32, 6-8% in bfloat16 and int8, 12-14% at F = 256 (PERF.md, section 6).
//
// Resources (ptxas, sm_90a): 79-80 registers at VPT <= 4, 123-128 at
// VPT = 8, no spills. Shared memory: 2 R x 32 VPT floats (8 KB at F = 128,
// 16 KB at F = 256), plus YtY_reg at F <= 128 (64 KB at F = 128). Blocks
// of 8 warps per SM: 3 at F <= 128 (shared memory), 2 above (registers).
//
// Design: a block of R = kRows warps solves R rows in lockstep, as the TPU
// kernel solves its (BC, L) block:
// - Each warp owns one row for the sparse term and the CG's vector updates:
//   x, r, p in registers, VPT = ceil(F / 32) (rounded to a power of 2)
//   values per lane in a contiguous layout, f = lane * VPT + k. A row of the
//   table is then one vector load per lane (16 bytes at F = 128 float32 and
//   F = 256 bfloat16): the load width W is the largest of 16, 8, 4 bytes that
//   divides the row pitch F * elem and the table's address and is at most a
//   lane's VPT * elem bytes; rows whose pitch is no multiple of 4 bytes (int8
//   at F = 10) load element by element. W is a template parameter picked on
//   the host. The entries' (index, weight) pairs are loaded once per 32
//   entries and broadcast by shuffles, kEntries entries in flight at once,
//   and groups of kEntries padding entries are skipped.
// - The dense term is one product per block and pass: the R vectors go to
//   shared memory (Vs, R x PP floats), and the block computes Vs * YtY_reg
//   for all of them, each thread holding RT rows of one column f, so that
//   each value of YtY_reg it loads feeds RT = R / 2 (F <= 128) or R
//   (F > 128) FMAs, and the vectors are read as float4 broadcasts. The
//   product is added into the warps' sparse terms (Ds), in float32 FMAs
//   (not tensor cores: the float32 bar is 1e-4, and the plain version sums
//   in float32). At F <= 128 YtY_reg (64 KB) is staged once per block in
//   shared memory; above that each thread reads its column of YtY_reg from
//   L2 directly, coalesced across the warp, once per block and pass: the L2
//   reads of YtY_reg per row and pass fall by a factor of R against one
//   warp per row, and a copy through shared memory would move the same
//   bytes once more.
// - Freezing copies the masked form (pallas_ops.py:213-228): a row whose
//   squared residual falls below 1e-20 (NaN included) stops changing x; its
//   warp skips its sparse term and updates, p and rsold are held, and pAp ==
//   0 is guarded. Rows past C in the last block take part as frozen rows.
//   When every row of the block is frozen, the block leaves the CG loop.
// - Two block barriers per pass: after the sparse terms (the vectors are in
//   Vs) and after the dense product (Ds holds sparse +- dense).
// - Blocks loop over the chunk's row groups (resident_grid), so YtY_reg is
//   staged once per resident block.
// Each row's result depends on its own inputs only, in a fixed order: the
// same inputs give the same bits on every run.

#include "cg_common.cuh"

namespace als {

constexpr int kRows = 8;  // R: rows (warps) per block, solved in lockstep

// Row entries in flight per warp: 4 at VPT <= 4, kUnroll at VPT = 8 (registers)
template <int VPT>
constexpr int kEntries = VPT <= 4 ? 4 : kUnroll;

// Blocks per SM the kernel is compiled for (__launch_bounds__): what shared
// memory (YtY_reg, 64 KB, at F <= 128) or the registers (at F > 128) admit.
// Without it ptxas spilled at VPT <= 4, holding registers under 40-64.
template <int VPT>
constexpr int kMinBlocks = VPT <= 4 ? 3 : 2;

// A table as the vector path reads it: 32-bit words of kPer elements each,
// converted to floats; read-only loads (__ldg) where the scalar loaders use
// them (bfloat16 and int8), plain loads for float32.
template <class Rows>
struct VecRows;

template <>
struct VecRows<TableRows<float>> {
  static constexpr int kPer = 1;
  static constexpr bool kReadOnly = false;
  __device__ __forceinline__ static void convert(uint32_t w, float, float* out) {
    out[0] = __uint_as_float(w);
  }
};

template <>
struct VecRows<TableRows<__nv_bfloat16>> {
  static constexpr int kPer = 2;
  static constexpr bool kReadOnly = true;
  __device__ __forceinline__ static void convert(uint32_t w, float, float* out) {
    out[0] = __uint_as_float(w << 16);  // element 0 is the low half
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
};

template <>
struct VecRows<QuantRows> {
  static constexpr int kPer = 4;
  static constexpr bool kReadOnly = true;
  // bf16(q * bf16(s)), as QuantRows::at; s is the row's bf16-rounded scale
  __device__ __forceinline__ static void convert(uint32_t w, float s, float* out) {
#pragma unroll
    for (int b = 0; b < 4; ++b) out[b] = bf16_round((float)(int8_t)(w >> (8 * b)) * s);
  }
};

// W bytes at p as W / 4 words
template <int W, bool RO>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W / 4]) {
  if constexpr (W == 16) {
    const uint4 v = RO ? __ldg(static_cast<const uint4*>(p)) : *static_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = RO ? __ldg(static_cast<const uint2*>(p)) : *static_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = RO ? __ldg(static_cast<const unsigned*>(p)) : *static_cast<const unsigned*>(p);
  }
}

// The lane's VPT values of the table row at yr (f = lane * VPT + k), 0 past
// F: in chunks of W bytes, or element by element when W == 0. A chunk that
// starts below F ends at or before it, since W divides the row pitch.
template <class Rows, int VPT, int W>
__device__ __forceinline__ void load_y(const typename Rows::Elem* yr, float sc, int F, int lane,
                                       float (&y)[VPT]) {
  const int f0 = lane * VPT;
  if constexpr (W == 0) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) y[k] = f0 + k < F ? Rows::at(yr, sc, f0 + k) : 0.f;
  } else {
    using V = VecRows<Rows>;
    constexpr int kChunk = W / sizeof(typename Rows::Elem);  // elements per chunk
    static_assert(kChunk <= VPT && VPT % kChunk == 0, "a chunk lies inside a lane's values");
#pragma unroll
    for (int j = 0; j < VPT / kChunk; ++j) {
      const int f = f0 + j * kChunk;
      if (f < F) {
        uint32_t w[W / 4];
        load_words<W, V::kReadOnly>(yr + f, w);
#pragma unroll
        for (int q = 0; q < W / 4; ++q) V::convert(w[q], sc, &y[j * kChunk + q * V::kPer]);
      } else {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) y[j * kChunk + k] = 0.f;
      }
    }
  }
}

// A lane's VPT consecutive floats of a shared-memory row, as vectors
template <int VPT>
__device__ __forceinline__ void smem_store(float* row, const float (&v)[VPT], int lane) {
  float* p = row + lane * VPT;
  if constexpr (VPT % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VPT; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (VPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int VPT>
__device__ __forceinline__ void smem_load(const float* row, float (&v)[VPT], int lane) {
  const float* p = row + lane * VPT;
  if constexpr (VPT % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VPT; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
    }
  } else if constexpr (VPT == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// acc = sum_l (alpha * bv_l + beta * w_l * (y_l . v)) * y_l over one row in
// the contiguous layout, with vector row loads.
template <class Rows, int VPT, int W>
__device__ __forceinline__ void row_sparse(const typename Rows::Elem* __restrict__ Y,
                                           const float* __restrict__ S,
                                           const float* __restrict__ cd,
                                           const int* __restrict__ ci, int L, int F, int lane,
                                           float alpha, float beta, const float (&v)[VPT],
                                           float (&acc)[VPT]) {
  constexpr int E = kEntries<VPT>;
#pragma unroll
  for (int k = 0; k < VPT; ++k) acc[k] = 0.f;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    const float raw = lane < n ? cd[l0 + lane] : 0.f;
    const int il = lane < n ? ci[l0 + lane] : 0;
    for (int j = 0; j < n; j += E) {
      float e[E];
      int i[E];
      bool any = false;
#pragma unroll
      for (int u = 0; u < E; ++u) {
        e[u] = __shfl_sync(kFull, raw, (j + u) & 31);
        i[u] = __shfl_sync(kFull, il, (j + u) & 31);
        if (j + u >= n) e[u] = 0.f;
        any |= DatEntries::live(e[u]);
      }
      if (!any) continue;  // warp-uniform: every lane holds the same entries
      float y[E][VPT];
      float t[E];
#pragma unroll
      for (int u = 0; u < E; ++u) {
        if (DatEntries::live(e[u])) {
          load_y<Rows, VPT, W>(Y + (size_t)i[u] * F, Rows::scale(S, i[u]), F, lane, y[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VPT; ++k) y[u][k] = 0.f;
        }
        t[u] = 0.f;
#pragma unroll
        for (int k = 0; k < VPT; ++k) t[u] += y[u][k] * v[k];
      }
#pragma unroll
      for (int u = 0; u < E; ++u) t[u] = warp_sum(t[u]);
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const float2 wb = DatEntries::weights(e[u]);  // (w, bv)
        // alpha == 0 (the A p pass) drops the bv term outright: neither
        // 0 * bv nor 0 + x folds away in IEEE arithmetic
        const float wt = beta * (wb.x * t[u]);
        const float coeff = alpha != 0.f ? alpha * wb.y + wt : wt;
#pragma unroll
        for (int k = 0; k < VPT; ++k) acc[k] += coeff * y[u][k];
      }
    }
  }
}

// Ds[r][f] += sign * sum_g Vs[r][g] * M[g * F + f] for the block's R rows:
// thread (rg, f) holds rows rg * RT .. rg * RT + RT - 1 of column f, so each
// value of M it loads feeds RT FMAs; the vectors are read as float4
// broadcasts (every thread of a warp reads the same row group, but for one
// boundary). (R / RT) * F <= R * 32 threads: one item per thread at most.
template <int R, int RT, int PP, bool SMEM_M>
__device__ __forceinline__ void dense_add(const float* __restrict__ M, const float* Vs, float* Ds,
                                          int F, float sign) {
  const int item = threadIdx.x;
  if (item >= (R / RT) * F) return;
  const int rg = item / F, f = item - rg * F;
  const float* v = Vs + rg * RT * PP;
  const float* m = M + f;
  float acc[RT];
#pragma unroll
  for (int j = 0; j < RT; ++j) acc[j] = 0.f;
  auto ld = [&](int g) { return SMEM_M ? m[(size_t)g * F] : __ldg(m + (size_t)g * F); };
  int g = 0;
#pragma unroll 2
  for (; g + 4 <= F; g += 4) {
    const float m0 = ld(g), m1 = ld(g + 1), m2 = ld(g + 2), m3 = ld(g + 3);
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(v + j * PP + g);
      acc[j] = fmaf(q.x, m0, acc[j]);
      acc[j] = fmaf(q.y, m1, acc[j]);
      acc[j] = fmaf(q.z, m2, acc[j]);
      acc[j] = fmaf(q.w, m3, acc[j]);
    }
  }
  for (; g < F; ++g) {
    const float mg = ld(g);
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[j] = fmaf(v[j * PP + g], mg, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < RT; ++j) Ds[(rg * RT + j) * PP + f] += sign * acc[j];
}

template <class Rows, int VPT, int W>
__global__ void __launch_bounds__(kRows * 32, kMinBlocks<VPT>)
cg_full_kernel(const typename Rows::Elem* __restrict__ Y, const float* __restrict__ S,
               const int* __restrict__ idx, const float* __restrict__ dat,
               const float* __restrict__ x0, const float* __restrict__ yty,
               float* __restrict__ out, int C, int L, int F, int cg_steps) {
  constexpr int R = kRows;
  constexpr int PP = 32 * VPT;          // a row's floats in shared memory
  constexpr int RT = VPT <= 4 ? R / 2 : R;
  constexpr bool SMEM_M = VPT <= 4;     // F <= 128: YtY_reg (64 KB) in shared memory
  // (R / RT) * F <= R * 32: one dense item per thread at most
  static_assert(RT >= VPT && R % RT == 0, "dense_add covers the block's rows");
  extern __shared__ float4 smem4[];
  float* Vs = reinterpret_cast<float*>(smem4);  // R x PP: x, then p, per row
  float* Ds = Vs + R * PP;                      // R x PP: sparse term +- dense term
  const float* M = yty;
  if constexpr (SMEM_M) {
    float* Ms = Ds + R * PP;
    for (int e = threadIdx.x; e < F * F; e += R * 32) Ms[e] = yty[e];
    M = Ms;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* vrow = Vs + warp * PP;
  float* drow = Ds + warp * PP;
  const int f0 = lane * VPT;
  for (long base = (long)blockIdx.x * R; base < C; base += (long)gridDim.x * R) {
    const long c = base + warp;
    const bool live = c < C;  // rows past C take part frozen
    const int* ci = idx + c * L;
    const float* cd = dat + c * L;
    float x[VPT], r[VPT], p[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) x[k] = live && f0 + k < F ? x0[c * F + f0 + k] : 0.f;
    // the residual: r = sparse(x; 1, -1) - x YtY_reg
    smem_store<VPT>(vrow, x, lane);
    if (live) {
      row_sparse<Rows, VPT, W>(Y, S, cd, ci, L, F, lane, 1.f, -1.f, x, r);
      smem_store<VPT>(drow, r, lane);
    }
    __syncthreads();  // Vs and Ds written; on the first row group, Ms too
    dense_add<R, RT, PP, SMEM_M>(M, Vs, Ds, F, -1.f);
    __syncthreads();
    smem_load<VPT>(drow, r, lane);
#pragma unroll
    for (int k = 0; k < VPT; ++k) p[k] = r[k];
    float rsold = dot<VPT>(r, r);
    bool active = live && rsold >= kFreeze;  // NaN freezes too, as in the masked form
    for (int it = 0; it < cg_steps; ++it) {
      if (active) {
        float sp[VPT];
        smem_store<VPT>(vrow, p, lane);
        row_sparse<Rows, VPT, W>(Y, S, cd, ci, L, F, lane, 0.f, 1.f, p, sp);
        smem_store<VPT>(drow, sp, lane);
      }
      if (!__syncthreads_or(active)) break;  // every row of the block frozen
      dense_add<R, RT, PP, SMEM_M>(M, Vs, Ds, F, 1.f);
      __syncthreads();
      if (active) {
        float Ap[VPT];
        smem_load<VPT>(drow, Ap, lane);
        const float pAp = dot<VPT>(p, Ap);
        const float alpha = rsold / (pAp == 0.f ? 1.f : pAp);
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          x[k] += alpha * p[k];
          r[k] -= alpha * Ap[k];
        }
        const float rsnew = dot<VPT>(r, r);
        if (rsnew >= kFreeze) {
          const float beta = rsnew / rsold;
#pragma unroll
          for (int k = 0; k < VPT; ++k) p[k] = r[k] + beta * p[k];
          rsold = rsnew;
        } else {
          active = false;
        }
      }
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < VPT; ++k)
        if (f0 + k < F) out[c * F + f0 + k] = x[k];
    }
  }
}

template <class Rows, int VPT, int W>
int launch(const void* Y, const void* S, const void* idx, const void* dat, const void* x0,
           const void* yty, void* out, int C, int L, int F, int cg_steps, cudaStream_t stream) {
  auto kernel = cg_full_kernel<Rows, VPT, W>;
  const int threads = kRows * 32;
  const size_t smem =
      sizeof(float) * (2 * (size_t)kRows * 32 * VPT + (VPT <= 4 ? (size_t)F * F : 0));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = resident_grid(kernel, threads, smem, (C + kRows - 1) / kRows);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const typename Rows::Elem*>(Y), static_cast<const float*>(S),
      static_cast<const int*>(idx), static_cast<const float*>(dat),
      static_cast<const float*>(x0), static_cast<const float*>(yty), static_cast<float*>(out),
      C, L, F, cg_steps);
  return (int)cudaGetLastError();
}

// The widest load the row pitch, the table's address and a lane's share of
// the row allow: 16, 8 or 4 bytes, else 0 (element by element)
template <class Rows, int VPT>
int launch_vpt(const void* Y, const void* S, const void* idx, const void* dat, const void* x0,
               const void* yty, void* out, int C, int L, int F, int cg_steps, cudaStream_t s) {
  constexpr int kLane = VPT * (int)sizeof(typename Rows::Elem);  // bytes a lane holds
  const size_t pitch = (size_t)F * sizeof(typename Rows::Elem);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(Y);
  auto fits = [&](int w) { return kLane >= w && pitch % w == 0 && addr % w == 0; };
  if constexpr (kLane >= 16)
    if (fits(16)) return launch<Rows, VPT, 16>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if constexpr (kLane >= 8)
    if (fits(8)) return launch<Rows, VPT, 8>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if constexpr (kLane >= 4)
    if (fits(4)) return launch<Rows, VPT, 4>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  return launch<Rows, VPT, 0>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
}

template <class Rows>
int dispatch(const void* Y, const void* S, const void* idx, const void* dat, const void* x0,
             const void* yty, void* out, int C, int L, int F, int cg_steps, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 32) return launch_vpt<Rows, 1>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 64) return launch_vpt<Rows, 2>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 128) return launch_vpt<Rows, 4>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
  if (F <= 256) return launch_vpt<Rows, 8>(Y, S, idx, dat, x0, yty, out, C, L, F, cg_steps, s);
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
