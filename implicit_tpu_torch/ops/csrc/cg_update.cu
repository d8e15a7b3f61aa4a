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
// the steps of implicit_tpu.ops.als._masked_cg, row by row. s is read only.
//
// Bound: a pass costs 2 F^2 flops of dense term per row against 28 F bytes
// of row vectors (p, s, x, r read, x, r, p written). On the float32 CUDA
// cores (67 TFLOP/s) the product alone would take 55% of the bytes' time at
// F = 512, so it runs on the tensor cores, wgmma in 3xTF32 (float32 accuracy
// at a third of the 495 TFLOP/s TF32 rate, as gramian_cg.cu's build): each
// float32 operand splits into a TF32 part and a TF32 residual, and lo hi +
// hi lo + hi hi sum into a float32 accumulator. There the bytes bind up to
// F ~ 700.
//
// - yty_split_kernel, launched first, splits YtY_reg once per call into the
//   scratch, in the order and layout of the main kernel's ring (K-major,
//   wgmma's core matrices of 8 columns x 4 k-values, no swizzle), so that a
//   stage of it is one cp.async.bulk. Its diagonal goes apart: the kernel
//   adds v_n YtY_reg[n, n] in float32 itself (below).
// - cg_update_kernel: a block owns 64 rows (one wgmma M) and runs one pass
//   per 256 columns (F = 512 two passes of 256, F = 320 two of 160). Two
//   consumer warpgroups each own NP of a pass's 2 NP columns. A producer
//   warpgroup fills a ring of 4 stages of 16 k-values: one thread copies the
//   stage's split YtY_reg (all 2 NP columns, both halves) by cp.async.bulk,
//   and every thread loads 4 k-values of two of the block's rows of v (4
//   chunks ahead, in registers), splits them and stores both halves into
//   the stage; full / empty mbarriers pace the ring. setmaxnreg moves the
//   producers' registers to the consumers, which issue lo hi, hi lo and hi
//   hi per k8 step as wgmma with both operands in shared memory (one
//   instruction per warpgroup and term where NP allows: each reads v's
//   operand again).
// - The tensor cores truncate the low bits of each wgmma's sum, an error
//   that grows with the magnitude and the number of k8 steps summed into
//   one accumulator (F = 512 in one sum missed the 1e-4 bar of the card
//   tests). So every 4 chunks (64 k-values) a consumer waits for its wgmma
//   and adds the accumulators into a float32 sum in registers; and the
//   diagonal, usually YtY_reg's largest term, stays out of the tensor cores.
// - The update is the epilogue. The sums go row-major into the idle ring (a
//   pass before the last waits in shared memory meanwhile), and a warp per
//   row runs the update from there: p, s, x and r are read from device
//   memory once (p again from L2; the block's rows of v prefetched into L2
//   as it starts, s, x and r during the last pass, by
//   cp.async.bulk.prefetch) and x, r, p written once; the product never
//   goes to device memory. Each row dot is the lanes' sums in column order
//   reduced by warp_sum: the same inputs give the same bits, with no
//   atomics. The update starts behind a barrier after both warpgroups'
//   products, so v may alias p.
// - Past F = 512 the passes' sums go to the scratch and the same update
//   reads them there. No fit of the port is that wide.
// - One block per SM (the ring and the held sums fill the shared memory,
//   the sums half the registers), so a block's update does not overlap its
//   product. At (65536, 512) on an H100 the pass takes 0.83 ms, the product
//   alone 0.45 and the ring alone (no product, no update) 0.35, whether or
//   not it copies YtY_reg or splits v: the ring's round trips bind it, not
//   L2 (paired blocks with multicast copies were no faster); the update
//   adds 0.38 (scripts/kernel_sweep.py with copies of this file that leave
//   parts out).

#include <algorithm>
#include <type_traits>

#include "cg_common.cuh"

namespace als {
namespace cgu {

constexpr int kRows = 64;  // rows per block: one wgmma M
constexpr int kConsumers = 2;  // warpgroups over the columns of a pass
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerThreads = 128;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
// setmaxnreg: 56 + 2 x 224 = 3 x 168, what __launch_bounds__ gives each thread
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kDepth = 16;  // k-values per ring stage: two k8 steps
constexpr int kPassCols = 256;  // widest pass: two warpgroups of 128 columns
constexpr int kFusedPasses = 2;  // passes the epilogue keeps on chip
constexpr int kDrainChunks = 4;  // chunks summed by the tensor cores at a time
constexpr int kAhead = 4;  // chunks of v a producer thread holds in registers
constexpr int kMaxStages = 4;
constexpr int kSmemBytes = 232448;  // a block's shared memory on an H100
constexpr unsigned kABytes = 2 * kRows * kDepth * 4;  // v's halves in a stage

// How a width is cut: passes of 2 np columns (np one of 32, 64, 80, 128), k
// padded to whole chunks. The scratch holds the split YtY_reg (split_floats),
// its diagonal (diag_floats, one per column of the passes) and past F = 512
// the product. The wrapper (cg_kernels._update_scratch) computes the same.
struct Layout {
  int passes, np, kp, chunks;
  long split_floats, diag_floats;
};

inline Layout update_layout(int F) {
  Layout l;
  l.passes = (F + kPassCols - 1) / kPassCols;
  const int widths[] = {32, 64, 80, 128};
  l.np = 128;
  for (int np : widths)
    if (2 * np * l.passes >= F) {
      l.np = np;
      break;
    }
  l.kp = (F + kDepth - 1) / kDepth * kDepth;
  l.chunks = l.kp / kDepth;
  l.split_floats = 2L * l.passes * l.kp * 2 * l.np;  // hi and lo halves
  l.diag_floats = 2L * l.passes * l.np;
  return l;
}

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// a stage's split YtY_reg, global to shared, counted on `bar` by its bytes
__device__ __forceinline__ void stage_copy(void* dst, const float* src, unsigned bytes,
                                           uint64_t* bar) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a hint: n floats from src into L2 (whole 16-byte pieces of an aligned range)
__device__ __forceinline__ void prefetch_l2(const float* src, long n) {
  const long bytes = n * 4 & ~15L;
  if ((reinterpret_cast<uintptr_t>(src) & 15) || bytes <= 0) return;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"((unsigned)bytes)
               : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a shared-memory operand's descriptor: K-major, no swizzle; core matrices
// of 8 rows x 16 bytes, 128 bytes apart along M or N, lbo bytes apart along K
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d (64 x N, this thread's N / 2 values) += a (64 x 8) b (8 x N), both in
// shared memory
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n32(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n16(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// YtY_reg's halves in the ring's order: per (pass, chunk) [hi | lo][k8 step
// t][k / 4 half h][column n of the pass][k % 4], k = 16 chunk + 8 t + 4 h +
// (k % 4). Zero past F and on the diagonal, which goes to `diag` (ncols
// values, zero past F).
__global__ void yty_split_kernel(const float* __restrict__ yty, float* __restrict__ out,
                                 float* __restrict__ diag, int F, int np, int chunks,
                                 long half_floats_total, int ncols) {
  const int ntot = 2 * np;
  const long half = (long)kDepth * ntot;  // floats of one half of a stage
  const long start = blockIdx.x * (long)blockDim.x + threadIdx.x;
  for (long i = start; i < ncols; i += (long)gridDim.x * blockDim.x)
    diag[i] = i < F ? yty[i * F + i] : 0.f;
  for (long i = start; i < half_floats_total; i += (long)gridDim.x * blockDim.x) {
    const long stage = i / half, within = i % half;
    const int n = (int)((within >> 2) % ntot);
    const int th = (int)((within >> 2) / ntot);  // k8 step * 2 + half
    const int pass = (int)(stage / chunks), chunk = (int)(stage % chunks);
    const int k = chunk * kDepth + 4 * th + (int)(within & 3);
    const int col = pass * ntot + n;
    const float y = k < F && col < F && k != col ? yty[(long)k * F + col] : 0.f;
    const unsigned hi = tf32(y);
    out[stage * 2 * half + within] = __uint_as_float(hi);
    out[stage * 2 * half + half + within] = __uint_as_float(tf32(y - __uint_as_float(hi)));
  }
}

// The update of the block's rows from their products t (row i at t + i
// tstride: the kernel's tile in shared memory, or past F = 512 the scratch),
// a warp per row, lanes over columns. Each sweep loads a row's values (up to
// 32 kVals columns at a time) before it stores any: x, r and p may alias as
// far as the compiler knows, so it would not batch them. Ap and then the new
// r replace the row's t; p is read again from L2. Each dot is the lanes' sums
// in column order reduced by warp_sum: the same inputs give the same bits.
template <int kVals>
__device__ void update_rows(float* t, long tstride, const float* __restrict__ diag,
                            const float* v, const float* s, float* x, float* r, float* p,
                            float* rs, int* act, long c0, int nrows, int F, int first, int warp,
                            int lane) {
  constexpr int kWarps = kConsumerThreads / 32, kSpan = 32 * kVals;
  for (int i = warp; i < nrows; i += kWarps) {
    const long c = c0 + i, o = c * F;
    float* tr = t + i * tstride;
    float a[kVals], b[kVals], e[kVals], d[kVals];
    if (first) {  // r = s - x0 YtY_reg, x = x0, p = r
      float sum = 0.f;
      for (int f0 = lane; f0 < F; f0 += kSpan) {
#pragma unroll
        for (int u = 0; u < kVals; ++u) {
          const int f = f0 + 32 * u;
          const bool ok = f < F;
          a[u] = ok ? s[o + f] : 0.f;
          b[u] = ok ? tr[f] : 0.f;
          e[u] = ok ? v[o + f] : 0.f;
          d[u] = ok ? diag[f] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kVals; ++u) {
          const int f = f0 + 32 * u;
          a[u] -= fmaf(e[u], d[u], b[u]);
          sum += a[u] * a[u];
          if (f < F) {
            x[o + f] = e[u];
            r[o + f] = a[u];
            p[o + f] = a[u];
          }
        }
      }
      const float rs0 = warp_sum(sum);
      if (lane == 0) {
        rs[c] = rs0;
        act[c] = rs0 >= kFreeze;  // NaN freezes too, as in the masked form
      }
      continue;
    }
    float pap = 0.f;  // Ap = s + p YtY_reg, into the tile; p . Ap
    for (int f0 = lane; f0 < F; f0 += kSpan) {
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        const int f = f0 + 32 * u;
        const bool ok = f < F;
        a[u] = ok ? p[o + f] : 0.f;
        b[u] = ok ? s[o + f] : 0.f;
        e[u] = ok ? tr[f] : 0.f;
        d[u] = ok ? diag[f] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        const int f = f0 + 32 * u;
        b[u] += fmaf(a[u], d[u], e[u]);
        pap += a[u] * b[u];
        if (f < F) tr[f] = b[u];
      }
    }
    pap = warp_sum(pap);
    const float rsold = rs[c];
    const bool on = act[c] != 0;
    const float alpha = on ? rsold / (pap == 0.f ? 1.f : pap) : 0.f;
    float sum = 0.f;  // x += alpha p, r -= alpha Ap (r into the tile); r . r
    for (int f0 = lane; f0 < F; f0 += kSpan) {
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        const int f = f0 + 32 * u;
        const bool ok = f < F;
        a[u] = ok ? p[o + f] : 0.f;
        b[u] = ok ? x[o + f] : 0.f;
        e[u] = ok ? r[o + f] : 0.f;
        d[u] = ok ? tr[f] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        const int f = f0 + 32 * u;
        b[u] += alpha * a[u];
        e[u] -= alpha * d[u];
        sum += e[u] * e[u];
        if (f < F) {
          x[o + f] = b[u];
          r[o + f] = e[u];
          tr[f] = e[u];
        }
      }
    }
    const float rsnew = warp_sum(sum);
    const bool still = on && rsnew >= kFreeze;
    const float beta = on ? rsnew / rsold : 0.f;
    if (still) {  // p = r + beta p
      for (int f0 = lane; f0 < F; f0 += kSpan) {
#pragma unroll
        for (int u = 0; u < kVals; ++u) {
          const int f = f0 + 32 * u;
          const bool ok = f < F;
          a[u] = ok ? p[o + f] : 0.f;
          e[u] = ok ? tr[f] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kVals; ++u) {
          const int f = f0 + 32 * u;
          if (f < F) p[o + f] = e[u] + beta * a[u];
        }
      }
    }
    if (lane == 0) {
      rs[c] = still ? rsnew : rsold;
      act[c] = still;
    }
  }
}

// v is the product's left operand: x0 on the first pass, p (the same
// pointer) on a step. split and diag are YtY_reg's, from yty_split_kernel;
// t (more than kFusedPasses passes only) the product's scratch.
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
cg_update_kernel(const float* __restrict__ split, const float* __restrict__ diag,
                 const float* v, const float* s, float* t, float* x, float* r, float* p,
                 float* rs, int* act, int C, int F, int first, int passes, int chunks,
                 int stages) {
  constexpr int kCols = 2 * NP;  // columns per pass
  constexpr int kBHalf = kDepth * kCols;  // floats of one half of a stage's YtY_reg
  constexpr unsigned kBBytes = 2 * kBHalf * 4;
  constexpr unsigned kStageBytes = kBBytes + kABytes;
  constexpr int kAcc = NP / 2, kPairs = NP / 4;  // a thread's values of a pass, in pairs
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  // the sums of the pass before the last, [pair][consumer thread]
  float2* held = reinterpret_cast<float2*>(smem + stages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(held + kPairs * kConsumerThreads);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long c0 = (long)blockIdx.x * kRows;
  const int nrows = (int)min((long)kRows, C - c0);
  const int total = passes * chunks;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], kProducerThreads);  // every producer, and the copy's bytes
      mbar_init(&empty[i], kConsumerThreads / 32);  // each consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // this thread's k-values 4 j .. 4 j + 3 of a chunk, rows row and row + 32
    const int pt = tid - kConsumerThreads, j = pt & 3, row = pt >> 2;
    const bool vec = F % 4 == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0;
    const float* vrow = v + (c0 + row) * F;
    const bool ok0 = row < nrows, ok1 = row + 32 < nrows;
    auto load = [&](int g, float4 (&out)[2]) {
      const int k = (g % chunks) * kDepth + 4 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* src = vrow + 32L * h * F + k;
        const bool ok = h ? ok1 : ok0;
        if (vec) {
          out[h] = ok && k < F ? *reinterpret_cast<const float4*>(src)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          out[h] = make_float4(ok && k < F ? src[0] : 0.f, ok && k + 1 < F ? src[1] : 0.f,
                               ok && k + 2 < F ? src[2] : 0.f, ok && k + 3 < F ? src[3] : 0.f);
        }
      }
    };
    auto split4 = [](float4 f, float4& hi, float4& lo) {
      hi = make_float4(__uint_as_float(tf32(f.x)), __uint_as_float(tf32(f.y)),
                       __uint_as_float(tf32(f.z)), __uint_as_float(tf32(f.w)));
      lo = make_float4(__uint_as_float(tf32(f.x - hi.x)), __uint_as_float(tf32(f.y - hi.y)),
                       __uint_as_float(tf32(f.z - hi.z)), __uint_as_float(tf32(f.w - hi.w)));
    };
    if (pt == 0) prefetch_l2(v + c0 * F, (long)nrows * F);  // the block's rows of v, whole
    float4 ahead[kAhead][2];  // the next kAhead chunks' loads, in flight
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i < total) load(i, ahead[i]);
    for (int g0 = 0; g0 < total; g0 += kAhead) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int g = g0 + i, b = g % stages, round = g / stages;
        if (g >= total) break;
        if (round > 0) mbar_wait(&empty[b], (round - 1) & 1);
        unsigned char* stage = ring + b * kStageBytes;
        if (pt == 0) stage_copy(stage, split + (long)g * (kBBytes / 4), kBBytes, &full[b]);
        // v's halves: [hi | lo][k / 4][row][k % 4], k8 step t = (k / 4) / 2
        float* a = reinterpret_cast<float*>(stage + kBBytes);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 hi, lo;
          split4(ahead[i][h], hi, lo);
          const int o = (j * kRows + row + 32 * h) * 4;
          *reinterpret_cast<float4*>(a + o) = hi;
          *reinterpret_cast<float4*>(a + kRows * kDepth + o) = lo;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        mbar_arrive(&full[b]);
        if (g + kAhead < total) load(g + kAhead, ahead[i]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, g8 = lane >> 2, q = lane & 3;
  const int rowA = 16 * (warp & 3) + g8;  // a thread's rows: rowA and rowA + 8
  const bool okA = rowA < nrows, okB = rowA + 8 < nrows;
  const unsigned ring_addr = smem_u32(ring);

  float acc[kAcc];  // the tensor cores' sum of the chunks since the last drain
  float sum[kAcc];  // the pass's product: the drained sums, added in float32
  // acc += a (64 rows x 8 k) b (8 k x this warpgroup's NP columns), in as
  // few instructions as the widths allow: each reads a again
  auto product = [&](uint64_t a, unsigned b) {
    const uint64_t b0 = desc(b, kCols * 16);
    if constexpr (NP == 128) wgmma_n128(acc, a, b0);
    if constexpr (NP == 64 || NP == 80) wgmma_n64(acc, a, b0);
    if constexpr (NP == 80) wgmma_n16(acc + 32, a, desc(b + 64 * 16, kCols * 16));
    if constexpr (NP == 32) wgmma_n32(acc, a, b0);
  };
  for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = sum[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int g = pass * chunks + c, b = g % stages;
      if (tid == 0 && pass == passes - 1 && c == 0)  // the update's rows, into L2
        prefetch_l2(s + c0 * F, (long)nrows * F);
      if (tid == 0 && pass == passes - 1 && c == chunks / 2 && !first) {
        prefetch_l2(x + c0 * F, (long)nrows * F);
        prefetch_l2(r + c0 * F, (long)nrows * F);
      }
      mbar_wait(&full[b], (g / stages) & 1);
      wgmma_fence();
      const unsigned stage = ring_addr + b * kStageBytes;
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const unsigned bh = stage + st * 2 * kCols * 16 + wg * NP * 16, bl = bh + kBHalf * 4;
        const unsigned a_addr = stage + kBBytes + st * 2 * kRows * 16;
        const uint64_t ah = desc(a_addr, kRows * 16);
        const uint64_t al = desc(a_addr + kRows * kDepth * 4, kRows * 16);
        product(al, bh);  // the small terms first
        product(ah, bl);
        product(ah, bh);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (c > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % stages]);
      if ((c + 1) % kDrainChunks == 0 || c + 1 == chunks) {  // drain into the sums
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          asm volatile("" : "+f"(acc[i])::"memory");
          sum[i] += acc[i];
          acc[i] = 0.f;
        }
      }
    }
    if (lane == 0) mbar_arrive(&empty[(pass * chunks + chunks - 1) % stages]);
    if (passes > kFusedPasses) {  // the pass's product to the scratch
      const int col0 = pass * kCols + wg * NP + 2 * q;
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const int col = col0 + 8 * (e >> 2) + (e & 1);
        if (((e >> 1) & 1 ? okB : okA) && col < F)
          t[(c0 + rowA + 8 * ((e >> 1) & 1)) * F + col] = sum[e];
      }
    } else if (pass + 1 < passes) {
#pragma unroll
      for (int u = 0; u < kPairs; ++u)
        held[u * kConsumerThreads + tid] = make_float2(sum[2 * u], sum[2 * u + 1]);
    }
  }

  consumers_sync();  // every product is done: v may be overwritten, the ring reused
  if (passes > kFusedPasses) {
    update_rows<kCols / 16>(t + c0 * F, F, diag, v, s, x, r, p, rs, act, c0, nrows, F, first,
                            warp, lane);
    return;
  }
  // the products, row-major in the ring: row stride W + 8 floats (W, the
  // passes' columns, is a multiple of 32), so that a warp's 8 rows of 8
  // values take the 2 wavefronts their 256 bytes need
  const int stride = passes * kCols + 8;
  float* tile = reinterpret_cast<float*>(ring);
  auto put = [&](int pi, int u, float2 w) {  // pair u: row rowA / rowA + 8, 2 columns
    const int row = rowA + 8 * (u & 1), col = pi * kCols + wg * NP + 2 * q + 8 * (u >> 1);
    *reinterpret_cast<float2*>(tile + row * stride + col) = w;
  };
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    if (passes == 2) put(0, u, held[u * kConsumerThreads + tid]);
    put(passes - 1, u, make_float2(sum[2 * u], sum[2 * u + 1]));
  }
  consumers_sync();
  update_rows<kCols / 16>(tile, stride, diag, v, s, x, r, p, rs, act, c0, nrows, F, first, warp,
                          lane);
}

template <int NP>
int launch(const float* split, const float* diag, const float* v, const float* s, float* t,
           float* x, float* r, float* p, float* rs, int* act, int C, int F, int first,
           const Layout& l, cudaStream_t stream) {
  constexpr unsigned kStageBytes = 2 * kDepth * 2 * NP * 4 + kABytes;
  // the held sums and the barriers
  constexpr int kFixedBytes = NP / 4 * kConsumerThreads * 8 + 2 * kMaxStages * 8;
  const int stages = std::min(kMaxStages, (int)((kSmemBytes - kFixedBytes) / kStageBytes));
  const size_t smem = stages * kStageBytes + kFixedBytes;
  // on every launch: a flag kept here would be one object across every
  // loaded build of this file (a template's static), and the device may change
  const cudaError_t e = cudaFuncSetAttribute(
      cg_update_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cg_update_kernel<NP><<<(C + kRows - 1) / kRows, kThreads, smem, stream>>>(
      split, diag, v, s, t, x, r, p, rs, act, C, F, first, l.passes, l.chunks, stages);
  return (int)cudaGetLastError();
}

}  // namespace cgu
}  // namespace als

// One pass over a chunk of C rows of F values: yty (F, F), v, s (C, F)
// float32 in; scratch float32, at least cg_kernels._update_scratch(C, F)
// values (the split YtY_reg, its diagonal, and past F = 512 the product),
// 16-byte aligned; x, r, p (C, F) float32, rs (C,) float32 and act (C,)
// int32 in place. first != 0: the residual pass, v = x0 (x, r, p, rs, act
// are written); else a CG step, v = p. Returns the launches' cudaError_t (0
// on success).
extern "C" int cg_update(const void* yty, const void* v, const void* s, void* scratch, void* x,
                         void* r, void* p, void* rs, void* act, int C, int F, int first,
                         void* stream) {
  using namespace als::cgu;
  if (C < 0 || F < 1) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  const Layout l = update_layout(F);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* split = static_cast<float*>(scratch);
  float* diag = split + l.split_floats;
  const long half_total = l.split_floats / 2;
  const int blocks = (int)std::min((half_total + 255) / 256, 4096L);
  yty_split_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(yty), split, diag, F, l.np,
                                           l.chunks, half_total, (int)l.diag_floats);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto run = [&](auto launcher) {
    return launcher(split, diag, static_cast<const float*>(v), static_cast<const float*>(s),
                    diag + l.diag_floats, static_cast<float*>(x), static_cast<float*>(r),
                    static_cast<float*>(p), static_cast<float*>(rs), static_cast<int*>(act), C,
                    F, first, l, st);
  };
  switch (l.np) {
    case 32: return run(launch<32>);
    case 64: return run(launch<64>);
    case 80: return run(launch<80>);
    default: return run(launch<128>);
  }
}
