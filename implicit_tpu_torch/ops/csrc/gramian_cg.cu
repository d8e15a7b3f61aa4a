// Long-row solve: explicit normal matrix per row, then masked CG on it.
//
// Replaces the TPU kernel implicit_tpu/ops/pallas_ops.py:_gramian_cg_kernel
// (reached through gramian_cg_solve), including its int8 variant (scales=).
// For row c, with w = |d| - 1 and bv = max(d, 0) where d != 0 and
// y_l = Y[idx[c, l]] (int8 rows dequantized to bf16(q * bf16(s))):
//
//   A[c] = YtY_reg + sum_l w_l y_l y_l^T,   b[c] = sum_l bv_l y_l
//
// then the same masked CG as cg_full.cu on the explicit A[c].
//
// Bound. The build is 2 L F^2 flops against L F gathered values per row: a
// matrix product whose depth is the entry axis, so it runs on the tensor
// cores. The first version, on the float32 CUDA cores, reached 15-25% of
// their peak, held back by shared-memory load issue. This one builds the
// (256, 8192, 128) phase-2 chunk in 1.17 ms in float32 (bf16 0.77, int8 1.25;
// H100 SXM, 700 W): 29 TFLOP/s counted as the full F x F product of the live
// entries (55 TFLOP/s of tensor-core work, 3xTF32 on the upper triangle),
// 32-75 TFLOP/s in the last.fm-360k fits, with the gather at 0.25-0.55 TB/s
// of the card's 3.35. Neither bound is reached: cycle counters put ~12 of
// ~5900 cycles per stage in waiting for data, and the rest in issuing each
// warp's work: scalar fragment loads, the hi/lo splits, the mma and its share
// of the copies, with one block of 10 warps per SM (125-135 registers).
// Smaller blocks (2-3 per SM), a block-wide conversion pass, a producer warp
// and one bulk copy per row were each measured no faster. wgmma, which reads
// its operands from shared memory, is the next step.
//
// gramian_build_kernel, grid (row, L-slice, pair group):
// - The F x F matrix is cut into 32 x 32 blocks; only the upper triangle's
//   block pairs (bi <= bj) are built, one warp each (10 warps at F = 128).
//   At F > 192 the pairs are split into groups of at most 12 warps, one
//   block each.
// - The row's entries are taken in groups of 32. A group whose d values are
//   all 0 (padding) contributes exactly 0 and is skipped: each block first
//   lists its slice's live groups. The live groups stream through a ring of
//   4 shared-memory stages filled with cp.async (zero-filled past F and
//   past L), so the next groups' rows are in flight while this one is used;
//   each group's indices and weights are copied in 3 steps before its rows,
//   so no thread waits on a global load to address a row.
// - Operands: A-tile += (w y)^T y over the group, with mma.sync.
//   float32 tables: 3xTF32, w y and y each split into hi + lo TF32 parts,
//   lo*hi + hi*lo + hi*hi (single-pass TF32 is not the float32 model).
//   bfloat16 and int8 tables: y is exact in bf16; w y is split into hi + lo
//   bf16, two m16n8k16 passes. f32 accumulators throughout.
// - b = sum bv y is 1/F of the work: CUDA cores, from the same stages.
// - A long row is split over L-slices so that short classes still fill the
//   SMs. A slice writes its partial upper triangle to a (C, S, F, F) +
//   (C, S, F) scratch, summed in slice order by gramian_reduce_kernel: the
//   same inputs give the same bits on every run (no atomics). With one
//   slice the build writes A itself.
// - Each upper entry is written to (i, j) and (j, i) with YtY_reg[i][j]
//   added once, so the stored A is exactly symmetric; the CG's matvec reads
//   it along coalesced rows.
// gramian_cg_kernel then runs the CG with one warp per row, reading A[c]
// from L2.

#include <algorithm>
#include <type_traits>

#include "cg_common.cuh"

namespace als {

constexpr int kGroup = 32;      // row entries per pipeline stage
constexpr int kStages = 4;      // shared-memory ring depth (row stages)
constexpr int kMeta = 2 * kStages - 1;  // entry slots: rows go out kStages - 1 steps ahead
constexpr int kBlk = 32;        // edge of one warp's block of A
constexpr int kMaxWarps = 12;   // block pairs per thread block
constexpr int kMaxSliceGroups = 2048;          // live-list capacity per block
constexpr int kMinSliceGroups = 8;             // shortest L-slice, in groups
constexpr int kBlocksPerSm = 4;                // build blocks wanted per SM
constexpr int kCgWarps = 8;

struct BuildPlan {
  int F, nb, npairs, groups, warps;  // groups: pair groups (grid z)
  int S, slice;                      // L-slices and groups per slice
  int pitch;                         // bytes per staged row
  int cb;                            // cp.async bytes per copy; 0: plain loads
};

__host__ __device__ inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

inline int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

// How a row of C rows x L entries at width F is cut over blocks.
inline BuildPlan make_plan(int C, int L, int F, int elem, const void* Y) {
  BuildPlan p;
  p.F = F;
  p.nb = cdiv(F, kBlk);
  p.npairs = p.nb * (p.nb + 1) / 2;
  p.groups = cdiv(p.npairs, kMaxWarps);
  p.warps = cdiv(p.npairs, p.groups);
  const int ngroups = cdiv(L, kGroup);
  const long blocks = (long)C * p.groups;
  int S = cdiv((long)kBlocksPerSm * sm_count(), blocks);
  S = std::min(S, cdiv(ngroups, kMinSliceGroups));
  S = std::max(S, cdiv(ngroups, kMaxSliceGroups));
  S = std::max(S, 1);
  p.slice = std::max(cdiv(ngroups, S), 1);
  p.S = std::max(cdiv(ngroups, p.slice), 1);
  const int fp = p.nb * kBlk;
  // staged row pitch: fp plus 32 bytes for f32 / 16 for bf16 and int8, so
  // that the fragment loads of one warp hit 32 distinct banks
  p.pitch = fp * elem + (elem == 4 ? 32 : 16);
  const int row = F * elem;
  p.cb = 0;
  for (int cb = 16; cb >= 4; cb >>= 1) {
    if (row % cb == 0 && reinterpret_cast<uintptr_t>(Y) % cb == 0) {
      p.cb = cb;
      break;
    }
  }
  return p;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int cb, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (cb == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
                 : "memory");
  else if (cb == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A staged row element as a float: the table's own value, or the int8
// value times its row's staged bf16(scale), as QuantRows::at computes it.
__device__ __forceinline__ float staged(const float* r, int f, float) { return r[f]; }
__device__ __forceinline__ float staged(const __nv_bfloat16* r, int f, float) {
  return __bfloat162float(r[f]);
}
__device__ __forceinline__ float staged(const int8_t* r, int f, float s) {
  return bf16_round((float)r[f] * s);
}

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (the 3xTF32 split)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 k0, __nv_bfloat16 k1) {
  return (unsigned)__bfloat16_as_ushort(k0) | ((unsigned)__bfloat16_as_ushort(k1) << 16);
}

// (x0, x1) = hi + lo, each a pair of bf16 (k0 in the low half)
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tensor cores' f32 accumulation does not round to nearest (it
// truncates), so one chain of mma over a whole row biases every sum: 1.3e-5
// off in the phase-2 solve on the H100, a third of single-pass TF32's
// error. So each stage sums its 32 entries in fresh accumulators, and the
// stages are added in IEEE float32.
__device__ __forceinline__ void add_stage(float (&acc)[2][4][4], const float (&part)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] += part[mt][nt][r];
}

// w = |d| - 1 where d != 0 (DatEntries::weights)
__device__ __forceinline__ float entry_w(float d) { return d != 0.f ? fabsf(d) - 1.f : 0.f; }

// acc[mt][nt] (m16 x n8 tiles) += sum over the stage's entries of
// (w_l y_l[i0 + .]) y_l[j0 + .]: one warp's 32 x 32 block of A. d holds the
// entries' raw weights, sc their bf16 scales (int8 tables only).
// Fragment lanes: g = lane / 4 picks the row (A) or column (B), t = lane % 4
// the entry.
__device__ __forceinline__ void stage_mma(const float* ys, int pitch, const float* d,
                                          const float*, int i0, int j0, int g, int t,
                                          float (&acc)[2][4][4]) {
  float part[2][4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kGroup; k0 += 8) {
    const float* y0 = ys + (k0 + t) * pitch;
    const float* y1 = ys + (k0 + t + 4) * pitch;
    const float w0 = entry_w(d[k0 + t]), w1 = entry_w(d[k0 + t + 4]);
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int i = i0 + mt * 16 + g;
      split_tf32(y0[i] * w0, ah[mt][0], al[mt][0]);
      split_tf32(y0[i + 8] * w0, ah[mt][1], al[mt][1]);
      split_tf32(y1[i] * w1, ah[mt][2], al[mt][2]);
      split_tf32(y1[i + 8] * w1, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j0 + nt * 8 + g;
      split_tf32(y0[j], bh[nt][0], bl[nt][0]);
      split_tf32(y1[j], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(part[mt][nt], al[mt], bh[nt]);
        mma_tf32(part[mt][nt], ah[mt], bl[nt]);
        mma_tf32(part[mt][nt], ah[mt], bh[nt]);
      }
  }
  add_stage(acc, part);
}

template <class Elem>
__device__ __forceinline__ void stage_mma(const Elem* ys, int pitch, const float* d,
                                          const float* sc, int i0, int j0, int g, int t,
                                          float (&acc)[2][4][4]) {
  float part[2][4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kGroup; k0 += 16) {
    // entries k0 + 2t, +1 (fragment halves 0, 1) and k0 + 2t + 8, +9 (2, 3)
    float wl[4], sl[4];
    const Elem* yr[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int l = k0 + 2 * t + (h & 1) + (h >> 1) * 8;
      wl[h] = entry_w(d[l]);
      sl[h] = std::is_same<Elem, int8_t>::value ? bf16_round(sc[l]) : 1.f;
      yr[h] = ys + l * pitch;
    }
    unsigned ah[2][4], al[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // a0: row g, k 2t..; a1: row g + 8; a2: row g, k 2t + 8..; a3: row g + 8
        const int i = i0 + mt * 16 + g + (r & 1) * 8;
        const int h = (r >> 1) * 2;
        split_bf16(staged(yr[h], i, sl[h]) * wl[h], staged(yr[h + 1], i, sl[h + 1]) * wl[h + 1],
                   ah[mt][r], al[mt][r]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j0 + nt * 8 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        b[nt][r] = pack_bf16(__float2bfloat16_rn(staged(yr[2 * r], j, sl[2 * r])),
                             __float2bfloat16_rn(staged(yr[2 * r + 1], j, sl[2 * r + 1])));
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_bf16(part[mt][nt], al[mt], b[nt]);
        mma_bf16(part[mt][nt], ah[mt], b[nt]);
      }
  }
  add_stage(acc, part);
}

// Dynamic shared memory of the build: the row stages, then the entries'
// indices and raw weights (kMeta slots), then the int8 rows' scales.
inline size_t build_smem(const BuildPlan& p) {
  return (size_t)kStages * kGroup * p.pitch + sizeof(int) * kMeta * kGroup +
         sizeof(float) * kMeta * kGroup + sizeof(float) * kStages * kGroup;
}

template <class Rows>
__global__ void __launch_bounds__(kMaxWarps * 32)
gramian_build_kernel(const typename Rows::Elem* __restrict__ Y, const float* __restrict__ S,
                     const int* __restrict__ idx, const float* __restrict__ dat,
                     const float* __restrict__ yty, float* __restrict__ A,
                     float* __restrict__ b, float* __restrict__ part, int L, BuildPlan p) {
  using Elem = typename Rows::Elem;
  constexpr bool kQuant = std::is_same<Elem, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t masks[kMaxSliceGroups / 32];
  __shared__ unsigned short live[kMaxSliceGroups];
  __shared__ int n_live;

  const long c = blockIdx.x;
  const int s = blockIdx.y, grp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int F = p.F;
  const int* ci = idx + c * L;
  const float* cd = dat + c * L;
  const size_t stage_bytes = (size_t)kGroup * p.pitch;
  int* mi = reinterpret_cast<int*>(smem + kStages * stage_bytes);  // [kMeta][kGroup]
  float* md = reinterpret_cast<float*>(mi + kMeta * kGroup);       // [kMeta][kGroup]
  float* msc = md + kMeta * kGroup;                                // [kStages][kGroup]

  // 1. the slice's live groups (any d != 0), in order
  const int g_begin = s * p.slice;
  const int ng = max(min(p.slice, cdiv(L, kGroup) - g_begin), 0);
  const int nchunks = (ng + 31) / 32;
  for (int ch = warp; ch < nchunks; ch += nwarps) {
    float v[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int gq = ch * 32 + q;
      const long l = (long)(g_begin + gq) * kGroup + lane;
      v[q] = (gq < ng && l < L) ? cd[l] : 0.f;
    }
    uint32_t m = 0;
#pragma unroll
    for (int q = 0; q < 32; ++q) m |= (uint32_t)__any_sync(kFull, v[q] != 0.f) << q;
    if (lane == 0) masks[ch] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int ch = 0; ch < nchunks; ++ch) {
      const uint32_t m = masks[ch];
      if ((m >> lane) & 1u) live[base + __popc(m & ((1u << lane) - 1u))] = ch * 32 + lane;
      base += __popc(m);
    }
    if (lane == 0) n_live = base;
  }
  __syncthreads();
  const int n = n_live;

  // 2. asynchronous loads of live group j: its entries' indices and raw
  // weights (zero past L) into meta slot j % kMeta, then, once those have
  // landed, the rows they name (zero past F, and for entries with d = 0)
  // into stage j % kStages
  auto issue_meta = [&](int j) {
    if (j >= n) return;
    const int slot = j % kMeta;
    for (int k = tid; k < 2 * kGroup; k += nthreads) {  // a block may have 32 threads
      const int e = k & (kGroup - 1);
      const long l = (long)(g_begin + live[j]) * kGroup + e;
      const bool in = l < L;
      if (k < kGroup)
        cp_async(mi + slot * kGroup + e, in ? ci + l : ci, 4, in ? 4 : 0);
      else
        cp_async(md + slot * kGroup + e, in ? cd + l : cd, 4, in ? 4 : 0);
    }
  };
  const int fp = p.nb * kBlk;
  const int row_bytes = F * (int)sizeof(Elem);
  auto issue_rows = [&](int j) {
    if (j >= n) return;
    const int st = j % kStages, slot = j % kMeta;
    const int* ii = mi + slot * kGroup;
    const float* dd = md + slot * kGroup;
    unsigned char* dst = smem + st * stage_bytes;
    if (p.cb > 0) {
      const int per_row = fp * (int)sizeof(Elem) / p.cb;
      for (int k = tid; k < kGroup * per_row; k += nthreads) {
        const int e = k / per_row, off = (k - e * per_row) * p.cb;
        const bool copy = dd[e] != 0.f && off < row_bytes;
        const void* src = copy ? reinterpret_cast<const unsigned char*>(Y + (size_t)ii[e] * F) + off
                               : static_cast<const void*>(Y);
        cp_async(dst + e * p.pitch + off, src, p.cb, copy ? p.cb : 0);
      }
    } else {  // rows not a whole number of 4-byte words: plain loads
      for (int k = tid; k < kGroup * fp; k += nthreads) {
        const int e = k / fp, f = k - e * fp;
        Elem v;
        memset(&v, 0, sizeof v);
        if (dd[e] != 0.f && f < F) v = Y[(size_t)ii[e] * F + f];
        reinterpret_cast<Elem*>(dst + e * p.pitch)[f] = v;
      }
    }
    if (kQuant && tid < kGroup) {
      const bool live_e = dd[tid] != 0.f;
      cp_async(msc + st * kGroup + tid, live_e ? S + ii[tid] : S, 4, live_e ? 4 : 0);
    }
  };

  // this warp's block pair (bi <= bj), row-major over the upper triangle
  const int pair = grp * p.warps + warp;
  const bool active = pair < p.npairs;
  int bi = 0, rem = pair;
  while (bi < p.nb && rem >= p.nb - bi) rem -= p.nb - bi++;
  const int bj = bi + rem;
  const int i0 = bi * kBlk, j0 = bj * kBlk;
  const int g = lane >> 2, t = lane & 3;

  // b: thread (q, f) sums the entries q, q + parts, ... of each group
  const bool do_b = grp == 0;
  const int parts = max(nthreads / F, 1);
  const int bq = tid / F, bf = tid - bq * F;
  const bool b_thread = do_b && bq < parts && tid < parts * F;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  float bacc = 0.f;

  // 3. the ring. Commit group k carries the rows of live group k and the
  // entries of group k + kStages - 1, whose rows go out kStages - 1 commits
  // later; so at step j, after the wait, group j's rows and the entries of
  // every group issued next have landed.
  for (int j = 0; j < kStages - 1; ++j) issue_meta(j);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int j = 0; j < kStages - 1; ++j) {
    issue_rows(j);
    issue_meta(j + kStages - 1);
    cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // refill the slots that step j - 1 used
    issue_rows(j + kStages - 1);
    issue_meta(j + 2 * kStages - 2);
    cp_async_commit();
    const int st = j % kStages;
    const Elem* ys = reinterpret_cast<const Elem*>(smem + st * stage_bytes);
    const float* dd = md + (j % kMeta) * kGroup;
    const float* sc = msc + st * kGroup;
    const int pitch = p.pitch / (int)sizeof(Elem);
    if (active) stage_mma(ys, pitch, dd, sc, i0, j0, g, t, acc);
    if (b_thread) {
      for (int l = bq; l < kGroup; l += parts)
        bacc += fmaxf(dd[l], 0.f) *
                staged(ys + l * pitch, bf, kQuant ? bf16_round(sc[l]) : 1.f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. write: with one slice, A = YtY_reg + acc mirrored; else the partials
  const bool direct = p.S == 1;
  float* Pc = part + ((size_t)c * p.S + s) * F * F;
  if (active) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + mt * 16 + g + (r >> 1) * 8;
          const int jj = j0 + nt * 8 + 2 * t + (r & 1);
          if (i >= F || jj >= F || i > jj) continue;
          const float v = acc[mt][nt][r];
          if (direct) {
            const float a = yty[(size_t)i * F + jj] + v;
            A[(c * F + i) * F + jj] = a;
            A[(c * F + jj) * F + i] = a;
          } else {
            Pc[(size_t)i * F + jj] = v;
          }
        }
  }
  if (do_b) {
    float* red = reinterpret_cast<float*>(smem);  // the stages are free now
    if (b_thread) red[tid] = bacc;
    __syncthreads();
    float* bd = direct ? b + c * F
                       : part + (size_t)p.S * F * F * gridDim.x + ((size_t)c * p.S + s) * F;
    for (int f = tid; f < F; f += nthreads) {
      float v = 0.f;
      for (int q = 0; q < parts; ++q) v += red[q * F + f];
      bd[f] = v;
    }
  }
}

// A[c] = YtY_reg + sum over slices of the upper partials, mirrored; b[c] the
// sum of the partial b's; both in slice order.
__global__ void gramian_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ yty, float* __restrict__ A,
                                      float* __restrict__ b, int C, int F, int S) {
  const long c = blockIdx.x;
  const float* P = part + (size_t)c * S * F * F;
  const float* Pb = part + (size_t)C * S * F * F + (size_t)c * S * F;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < F * F + F; e += gridDim.y * blockDim.x) {
    float v = 0.f;
    if (e < F * F) {
      const int i = e / F, j = e - i * F;
      if (i > j) continue;
      for (int s = 0; s < S; ++s) v += P[(size_t)s * F * F + e];
      const float a = yty[e] + v;
      A[(c * F + i) * F + j] = a;
      A[(c * F + j) * F + i] = a;
    } else {
      const int f = e - F * F;
      for (int s = 0; s < S; ++s) v += Pb[(size_t)s * F + f];
      b[c * F + f] = v;
    }
  }
}

template <int VPT>
__global__ void __launch_bounds__(kCgWarps * 32)
gramian_cg_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  const float* __restrict__ x0, float* __restrict__ out, int C, int F,
                  int cg_steps) {
  extern __shared__ float smem_cg[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* vs = smem_cg + warp * F;
  for (long c = (long)blockIdx.x * kCgWarps + warp; c < C; c += (long)gridDim.x * kCgWarps) {
    const float* M = A + c * F * F;  // symmetric: its rows are its columns
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
int launch_cg(const float* A, const float* b, const float* x0, float* out, int C, int F,
              int cg_steps, cudaStream_t stream) {
  auto kernel = gramian_cg_kernel<VPT>;
  const int threads = kCgWarps * 32;
  const size_t smem = sizeof(float) * (size_t)kCgWarps * F;
  const int grid = resident_grid(kernel, threads, smem, (C + kCgWarps - 1) / kCgWarps);
  kernel<<<grid, threads, smem, stream>>>(A, b, x0, out, C, F, cg_steps);
  return (int)cudaGetLastError();
}

template <class Rows>
int dispatch(const void* Y, const void* S, const void* idx, const void* dat, const void* x0,
             const void* yty, void* A, void* b, void* part, void* out, int C, int L, int F,
             int cg_steps, void* stream) {
  using Elem = typename Rows::Elem;
  if (C <= 0) return (int)cudaSuccess;
  if (F <= 0 || F > 256 || L < 0) return (int)cudaErrorInvalidValue;
  const BuildPlan p = make_plan(C, L, F, (int)sizeof(Elem), Y);
  if (p.S > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = build_smem(p);
  auto kernel = gramian_build_kernel<Rows>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* Af = static_cast<float*>(A);
  float* bf = static_cast<float*>(b);
  float* pf = static_cast<float*>(part);
  const float* ytyf = static_cast<const float*>(yty);
  kernel<<<dim3(C, p.S, p.groups), p.warps * 32, smem, s>>>(
      static_cast<const Elem*>(Y), static_cast<const float*>(S), static_cast<const int*>(idx),
      static_cast<const float*>(dat), ytyf, Af, bf, pf, L, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p.S > 1) {
    const int ny = cdiv((long)F * F + F, 256 * 4);
    gramian_reduce_kernel<<<dim3(C, ny), 256, 0, s>>>(pf, ytyf, Af, bf, C, F, p.S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const float* xx = static_cast<const float*>(x0);
  float* o = static_cast<float*>(out);
  if (F <= 32) return launch_cg<1>(Af, bf, xx, o, C, F, cg_steps, s);
  if (F <= 64) return launch_cg<2>(Af, bf, xx, o, C, F, cg_steps, s);
  if (F <= 128) return launch_cg<4>(Af, bf, xx, o, C, F, cg_steps, s);
  return launch_cg<8>(Af, bf, xx, o, C, F, cg_steps, s);
}

}  // namespace als

// L-slices the build cuts each row of a (C, L) chunk at width F into, on the
// current device: the caller allocates C * S * (F * F + F) float32 of
// partial scratch when it is above 1.
extern "C" int gramian_cg_slices(int C, int L, int F) {
  return als::make_plan(C, L, F, 4, nullptr).S;
}

// Y (N, F) float32 or bfloat16; idx (C, L) int32; dat (C, L) float32;
// x0 (C, F) float32; yty (F, F) float32; A (C, F, F) and b (C, F) float32
// scratch; part the partial scratch of gramian_cg_slices (null when it is
// 1) -> out (C, F) float32. Returns the first failing launch's cudaError_t
// (0 on success).
extern "C" int gramian_cg_f32(const void* Y, const void* idx, const void* dat, const void* x0,
                              const void* yty, void* A, void* b, void* part, void* out, int C,
                              int L, int F, int cg_steps, void* stream) {
  return als::dispatch<als::TableRows<float>>(Y, nullptr, idx, dat, x0, yty, A, b, part, out, C,
                                              L, F, cg_steps, stream);
}

extern "C" int gramian_cg_bf16(const void* Y, const void* idx, const void* dat, const void* x0,
                               const void* yty, void* A, void* b, void* part, void* out, int C,
                               int L, int F, int cg_steps, void* stream) {
  return als::dispatch<als::TableRows<__nv_bfloat16>>(Y, nullptr, idx, dat, x0, yty, A, b, part,
                                                      out, C, L, F, cg_steps, stream);
}

// The int8 table: Yq (N, F) int8 and its per-row scales s (N,) float32;
// the other arguments as above.
extern "C" int gramian_cg_i8(const void* Yq, const void* s, const void* idx, const void* dat,
                             const void* x0, const void* yty, void* A, void* b, void* part,
                             void* out, int C, int L, int F, int cg_steps, void* stream) {
  return als::dispatch<als::QuantRows>(Yq, s, idx, dat, x0, yty, A, b, part, out, C, L, F,
                                       cg_steps, stream);
}
