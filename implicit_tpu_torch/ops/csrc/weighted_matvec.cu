// One pass of the CG's sparse term over a chunk, with the row gather fused in.
//
// Replaces the TPU kernel implicit_tpu/ops/pallas_ops.py:_weighted_matvec_kernel
// (reached through weighted_matvec), including its int8 variant (scales=,
// dequantized as _dequant_tile does). For row c:
//
//   out[c] = sum_l (alpha * bv[c, l] + beta * w[c, l] * (y_l . v[c])) * y_l
//
// with y_l = Y[idx[c, l]] read straight from the factor table. (alpha, beta)
// = (1, -1) is the sparse part of the CG residual and (0, 1) that of A p;
// the composed CG (implicit_tpu_torch/ops/als.py:_cg_class, use_pallas=True)
// calls it cg_steps + 1 times per chunk, and every class of a fit with more
// than 256 factors solves that way.
//
// Bound: bytes. Each live entry costs 4 F flops against F * elem bytes of
// gathered row, so on an H100 SXM the function is bound by the gather: from
// HBM for a table larger than the 50 MB L2, from L2 otherwise. A gather has
// a long latency and no reuse, so the design is about keeping many row loads
// in flight on every SM, for any C, L and F:
//
// - Work items are (row, L-slice) pairs, one block of 4 warps each (8 warps
//   per block ran the f=512 short class 1.5x slower: more blocks per SM
//   overlap their staging and reduction phases). Rows that are few and
//   long (the head class: C = 8, L = 65536) are cut into S slices so that
//   the grid fills the card twice over (slices_for); the slices' partial
//   sums go to a (C, S, F) scratch and a second kernel adds them in slice
//   order. No atomics: the same inputs give the same bits.
// - A block stages a tile of up to 1024 entries of its slice in shared
//   memory: index, w, bv (and the row's dequant scale for int8), compacted
//   to the live entries (w or bv nonzero) in a fixed order. The padding
//   tail of a row, half of a chunk's entries, costs no gather and no work.
// - Lanes hold a table row as contiguous 16-byte pieces (4 float32, 8
//   bfloat16 or 16 int8 values; element by element when the row pitch or
//   the table's address is no multiple of 16 bytes): piece j of the lane
//   with group rank g covers f = (j * G + g) * CH ... + CH - 1, so each load
//   instruction of a group reads G * 16 contiguous bytes. 16-bit values stay
//   packed in registers until used. The int8 pieces are dequantized inside
//   the load to bf16(q * bf16(s)): byte permutes and one exact FMA per value
//   instead of integer conversions.
// - Narrow rows (F <= 512): a row is held by a group of G = 8, 16 or 32
//   lanes, so a warp works on 32 / G entries side by side, U entries per
//   group in flight (in_flight: as many as 48 registers of rows hold, at
//   most 8): 8 to 32 entries per warp. int8 rows go through a cp.async
//   ring in shared memory instead, two batches ahead (Narrow). The U dots
//   of a group reduce in one transposed butterfly (U - 1 + log2(G / U)
//   shuffles, not U * log2 G), each lane computes the coefficient of one
//   entry, and U shuffles broadcast them. The warps take interleaved
//   batches of the tile; their partial sums meet in shared memory, added in
//   warp order.
// - Wide rows (F > 512, any F): two sweeps per tile. First the warps
//   compute the coefficients of the tile's entries (each lane walks its
//   pieces of every row, U rows at a time) into shared memory; then each
//   warp takes 512-value panels of the output and adds coeff * y_l over the
//   tile into its registers, gathering the rows a second time. The block
//   owns its output row, so a panel's sum over tiles accumulates there.
//
// On an H100 SXM at 700 W this design runs (C, L, F) = (1024, 600, 128) in
// 0.045 / 0.029 / 0.032 ms for float32 / bfloat16 / int8 tables, 52% / 44% /
// 25% of the bound, where a warp per row took 0.126 / 0.36 / 0.24 ms
// (PERF.md, section 6, with the reasons the 16-bit tables stay under half).

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "cg_common.cuh"

namespace als {
namespace wmv {

constexpr int kWarps = 4;                   // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;                 // entries staged per tile
constexpr int kPerThread = kTile / kThreads;
constexpr int kPanel = 512;                 // values a warp holds of a row: 16 per lane
constexpr int kMinSlice = 256;              // entries per L-slice at least

template <class Rows>
constexpr bool kQuant = std::is_same<Rows, QuantRows>::value;

// A tile's live entries, compacted. The wide kernel's first sweep replaces
// w by each entry's coefficient.
struct Stage {
  int idx[kTile];
  float w[kTile];
  float bv[kTile];
  float sc[kTile];  // the row's bf16-rounded scale (int8 tables)
};

// How a lane holds the values it loaded: float32 rows as floats; 16-bit
// values (bfloat16 rows, int8 rows dequantized to bfloat16) as packed pairs,
// unpacked where they are used, so that twice the entries fit in the
// registers of a batch. Values loaded one by one (CH == 1) stay floats.
template <class Rows, int CH>
struct Held {
  static constexpr bool kPacked = sizeof(typename Rows::Elem) < 4 && CH > 1;
  static constexpr int kPer = kPacked ? 2 : 1;  // values per word
  using Word = typename std::conditional<kPacked, uint32_t, float>::type;
};

// value k of a lane's held values
__device__ __forceinline__ float value(const float* y, int k) { return y[k]; }
__device__ __forceinline__ float value(const uint32_t* y, int k) {
  return __uint_as_float(k & 1 ? y[k >> 1] & 0xffff0000u : y[k >> 1] << 16);
}

// 16 bytes of a table row as held words: fetch reads them from the table
// (read-only loads for the 16-bit tables, which measured faster there, plain
// for float32), convert turns the raw bytes, from the table or from shared
// memory, into held words.
template <class Rows>
struct Vec;

template <>
struct Vec<TableRows<float>> {
  static constexpr int kPer = 4;  // values per 16 bytes
  __device__ __forceinline__ static uint4 fetch(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void convert(uint4 v, float, float* out) {
    out[0] = __uint_as_float(v.x), out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z), out[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec<TableRows<__nv_bfloat16>> {
  static constexpr int kPer = 8;
  __device__ __forceinline__ static uint4 fetch(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void convert(uint4 v, float, uint32_t* out) {
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;  // element 0 is the low half
  }
};

// bf16(q * s) for the 16 int8 values q of a piece and the row's bf16-rounded
// scale s, as QuantRows::at computes it, as 8 packed pairs. Byte b of a
// word, flipped by 0x80, is q + 128; placed under the exponent of 2^23 it
// reads m = 2^23 + q + 128, so q * s = m * s - (2^23 + 128) * s: one FMA,
// exact, since (2^23 + 128) * s = s * 2^7 * (2^16 + 1) spans 24 bits for the
// 8 of s, and q * s has 15. One rounding (two values per cvt) gives the
// bfloat16 product.
template <>
struct Vec<QuantRows> {
  static constexpr int kPer = 16;
  __device__ __forceinline__ static uint4 fetch(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void convert(uint4 v, float s, uint32_t* out) {
    const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                           v.w ^ 0x80808080u};
    const float c = -8388736.f * s;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; b += 2) {
        const float m0 = __uint_as_float(__byte_perm(w[q], 0x4B000000u, 0x7540 + b));
        const float m1 = __uint_as_float(__byte_perm(w[q], 0x4B000000u, 0x7540 + b + 1));
        const __nv_bfloat162 h = __floats2bfloat162_rn(__fmaf_rn(m0, s, c), __fmaf_rn(m1, s, c));
        out[2 * q + b / 2] = *reinterpret_cast<const uint32_t*>(&h);  // m0 the low half
      }
    }
  }
};

// NCH pieces of CH values of the row at yr for the lane of group rank g, as
// held words: piece j covers f = (j * G + g) * CH + e, 0 past F. CH is 16
// bytes of elements (F a multiple of it) or 1.
template <class Rows, int CH, int G, int NCH>
__device__ __forceinline__ void load_row(
    const typename Rows::Elem* __restrict__ yr, float sc, int F, int g,
    typename Held<Rows, CH>::Word (&y)[CH * NCH / Held<Rows, CH>::kPer]) {
  constexpr int kWords = CH / Held<Rows, CH>::kPer;  // per piece
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int f = (j * G + g) * CH;
    if (f < F) {
      if constexpr (CH == 1) {
        y[j] = Rows::at(yr, sc, f);
      } else {
        Vec<Rows>::convert(Vec<Rows>::fetch(yr + f), sc, &y[j * kWords]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kWords; ++e) y[j * kWords + e] = 0;
    }
  }
}

// The same layout for a float32 vector (v in, the sums out)
template <int CH, int G, int NCH>
__device__ __forceinline__ void load_vec(const float* __restrict__ src, int F, int g,
                                         float (&x)[CH * NCH]) {
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      const int f = (j * G + g) * CH + e;
      x[j * CH + e] = f < F ? src[f] : 0.f;
    }
}

template <int CH, int G, int NCH>
__device__ __forceinline__ void store_vec(float* dst, int F, int g, const float (&x)[CH * NCH],
                                          bool add) {
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      const int f = (j * G + g) * CH + e;
      if (f < F) dst[f] = add ? dst[f] + x[j * CH + e] : x[j * CH + e];
    }
}

// group_dots: sums over the G lanes of each group of t[u], for U entries at
// once, by a transposed butterfly. Each step (halve) halves the values a lane
// keeps (the lane whose bit O is set keeps the upper half and sends the
// lower), so after log2 U steps a lane holds one partial, of entry
// g / (G / U), and the remaining steps are a plain butterfly. Returns that
// entry's sum.
template <int U, int N, int O>
__device__ __forceinline__ void halve(float (&t)[U], int g) {
  if constexpr (N > 1) {
    const bool hi = g & O;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = hi ? t[j] : t[j + N / 2];
      const float keep = hi ? t[j + N / 2] : t[j];
      t[j] = keep + __shfl_xor_sync(kFull, send, O);
    }
    halve<U, N / 2, O / 2>(t, g);
  }
}

template <int G, int U>
__device__ __forceinline__ float group_dots(float (&t)[U], int g) {
  static_assert(U <= G && (U & (U - 1)) == 0 && (G & (G - 1)) == 0, "powers of 2, U <= G");
  halve<U, U, G / 2>(t, g);
  float s = t[0];
#pragma unroll
  for (int o = G / (2 * U); o > 0; o /= 2) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// alpha == 0 (the A p pass) drops the bv term outright: neither 0 * bv nor
// 0 + x folds away in IEEE arithmetic
__device__ __forceinline__ float coefficient(float w, float bv, float t, float alpha,
                                             float beta) {
  const float wt = beta * (w * t);
  return alpha != 0.f ? alpha * bv + wt : wt;
}

// 16 bytes from global to shared memory, asynchronously (L2 only: a gathered
// row is not read again by the block)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages the live entries of [l0, l1) of one row (at most kTile) into st,
// in a fixed order (by thread, then by each thread's entries); returns their
// count. Every thread of the block calls it; it ends with a barrier.
template <class Rows>
__device__ __forceinline__ int stage_tile(Stage& st, int* cnt, const float* __restrict__ S,
                                          const int* __restrict__ ci,
                                          const float* __restrict__ cw,
                                          const float* __restrict__ cb, int l0, int l1) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int i[kPerThread];
  float w[kPerThread], b[kPerThread];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int l = l0 + k * kThreads + tid;
    i[k] = 0, w[k] = 0.f, b[k] = 0.f;
    if (l < l1) {
      i[k] = ci[l];
      w[k] = cw[l];
      b[k] = cb[l];
    }
    if (w[k] != 0.f || b[k] != 0.f) live |= 1u << k;
  }
  const int mine = __popc(live);
  int incl = mine;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) cnt[warp] = incl;
  __syncthreads();
  int pos = incl - mine, total = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    const int n = cnt[q];
    pos += q < warp ? n : 0;
    total += n;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (live >> k & 1u) {
      st.idx[pos] = i[k];
      st.w[pos] = w[k];
      st.bv[pos] = b[k];
      if constexpr (kQuant<Rows>) st.sc[pos] = Rows::scale(S, i[k]);
      ++pos;
    }
  }
  __syncthreads();
  return total;
}

template <class Rows>
__device__ __forceinline__ float stage_scale(const Stage& st, int e) {
  if constexpr (kQuant<Rows>) return st.sc[e];
  return 1.f;
}

// Entries a group keeps in flight, for W held words of a row per lane: the
// most (a power of 2, at most 8 and at most G) whose rows fit in 48
// registers.
__host__ __device__ constexpr int in_flight(int W, int g) {
  int u = 8;
  while (u > 1 && u * W > 48) u /= 2;
  return u < g ? u : g;
}

// Batches of rows a warp has in its shared-memory ring: it works on one
// while the next kDepth - 1 are in flight.
constexpr int kDepth = 3;

// The narrow kernel's shape for rows of NCH pieces of CH values per lane in
// groups of G lanes: U entries per group and batch, B per warp and batch.
// Rows are gathered into registers, U as many as fit there (in_flight),
// except the 16-byte pieces of int8 rows: those land in a per-warp ring in
// shared memory by cp.async, kDepth - 1 batches of 4 entries per group
// ahead, so that their dequant does not hold the entries in flight in
// registers. (On an H100 the ring ran int8 1.2-1.5x faster and float32 and
// bfloat16 up to 1.1x slower than registers; PERF.md, section 6.)
template <class Rows, int CH, int G, int NCH>
struct Narrow {
  using H = Held<Rows, CH>;
  using Word = typename H::Word;
  static constexpr bool kRing = kQuant<Rows> && CH > 1;
  static constexpr int VPT = CH * NCH;   // values of a row per lane
  static constexpr int W = VPT / H::kPer;  // held words of a row per lane
  static constexpr int U = kRing ? 4 : in_flight(W, G);
  static constexpr int P = 32 / G;       // entries side by side in a warp
  static constexpr int B = P * U;
  // the ring: [warp][depth][u][piece][lane] of 16 bytes, lanes contiguous
  static constexpr int kRingBytes = kRing ? kWarps * kDepth * U * NCH * 32 * 16 : 0;
};

// F <= 512: block (row c, slice s) sums its slice's entries into
// dst[(c * S + s) * F ...], a group of G lanes per entry.
template <class Rows, int CH, int G, int NCH>
__global__ void __launch_bounds__(kThreads, 3)
wmv_narrow(const typename Rows::Elem* __restrict__ Y, const float* __restrict__ S,
           const int* __restrict__ idx, const float* __restrict__ w,
           const float* __restrict__ bv, const float* __restrict__ v, float* __restrict__ dst,
           int L, int F, int slices, int slice_len, float alpha, float beta) {
  using K = Narrow<Rows, CH, G, NCH>;
  using Word = typename K::Word;
  constexpr int VPT = K::VPT, W = K::W, U = K::U, P = K::P, B = K::B;
  constexpr int kWords = CH / K::H::kPer;  // held words per piece
  __shared__ union {
    Stage st;
    float acc[kWarps][kPanel];
  } sm;
  __shared__ int cnt[kWarps];
  extern __shared__ uint4 ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = lane / G, g = lane % G;
  const long c = blockIdx.x / slices;
  const int s = blockIdx.x % slices;
  const int l_begin = min(L, s * slice_len), l_end = min(L, l_begin + slice_len);
  const long row = c * L;
  uint4* my_ring = ring + (size_t)warp * kDepth * U * NCH * 32 + lane;
  auto slot = [&](int d, int u, int j) -> uint4* {
    return my_ring + ((d * U + u) * NCH + j) * 32;
  };

  float vr[VPT], acc[VPT];
  load_vec<CH, G, NCH>(v + c * F, F, g, vr);
#pragma unroll
  for (int k = 0; k < VPT; ++k) acc[k] = 0.f;

  for (int t0 = l_begin; t0 < l_end; t0 += kTile) {
    const int n = stage_tile<Rows>(sm.st, cnt, S, idx + row, w + row, bv + row, t0,
                                   min(l_end, t0 + kTile));
    // this warp's batches of the tile: entries e0 .. e0 + B - 1, e0 = (warp + k * kWarps) * B
    const int first = warp * B;
    const int nb = n > first ? (n - first + kWarps * B - 1) / (kWarps * B) : 0;
    auto fetch = [&](int k) {  // batch k's pieces of this lane into ring slot k % kDepth
      if constexpr (K::kRing) {
        const int e0 = first + k * kWarps * B;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * P + p;
          if (e < n) {
            const typename Rows::Elem* yr = Y + (size_t)sm.st.idx[e] * F;
#pragma unroll
            for (int j = 0; j < NCH; ++j) {
              const int f = (j * G + g) * CH;
              if (f < F) cp_async16(slot(k % kDepth, u, j), yr + f);
            }
          }
        }
      }
    };
#pragma unroll
    for (int k = 0; k < kDepth - 1; ++k) {
      if (k < nb) fetch(k);
      cp_async_commit();  // one group per batch, empty or not: the waits count them
    }
    for (int k = 0; k < nb; ++k) {
      if (k + kDepth - 1 < nb) fetch(k + kDepth - 1);
      cp_async_commit();
      cp_async_wait<kDepth - 1>();  // batch k's pieces of this lane have landed
      const int e0 = first + k * kWarps * B;
      Word y[U][W];
      float t[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * P + p;
#pragma unroll
        for (int k2 = 0; k2 < W; ++k2) y[u][k2] = 0;
        if (e < n) {
          if constexpr (K::kRing) {
            const float sc = stage_scale<Rows>(sm.st, e);
#pragma unroll
            for (int j = 0; j < NCH; ++j)
              if ((j * G + g) * CH < F) Vec<Rows>::convert(*slot(k % kDepth, u, j), sc,
                                                           &y[u][j * kWords]);
          } else {
            load_row<Rows, CH, G, NCH>(Y + (size_t)sm.st.idx[e] * F,
                                       stage_scale<Rows>(sm.st, e), F, g, y[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        t[u] = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < VPT; ++k2) t[u] += value(y[u], k2) * vr[k2];
      }
      const float dot = group_dots<G, U>(t, g);
      const int eo = e0 + (g / (G / U)) * P + p;  // the entry this lane's dot belongs to
      const float co = eo < n ? coefficient(sm.st.w[eo], sm.st.bv[eo], dot, alpha, beta) : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float cu = __shfl_sync(kFull, co, p * G + u * (G / U));
#pragma unroll
        for (int k2 = 0; k2 < VPT; ++k2) acc[k2] += cu * value(y[u], k2);
      }
    }
    __syncthreads();  // the stage is rewritten next (or becomes sm.acc)
  }
  // the warp's groups, then the block's warps, in a fixed order
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < VPT; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], o);
  if (p == 0) store_vec<CH, G, NCH>(sm.acc[warp], F, g, acc, false);
  __syncthreads();
  float* out = dst + (c * slices + s) * F;
  for (int f = threadIdx.x; f < F; f += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) sum += sm.acc[q][f];
    out[f] = sum;
  }
}

// F > 512 (any F): per tile, the coefficients of all entries first, then
// the output in 512-value panels, one warp per panel at a time.
template <class Rows, int CH>
__global__ void __launch_bounds__(kThreads, 4)
wmv_wide(const typename Rows::Elem* __restrict__ Y, const float* __restrict__ S,
         const int* __restrict__ idx, const float* __restrict__ w,
         const float* __restrict__ bv, const float* __restrict__ v, float* __restrict__ dst,
         int L, int F, int slices, int slice_len, float alpha, float beta) {
  using H = Held<Rows, CH>;
  using Word = typename H::Word;
  constexpr int NCH = kPanel / (32 * CH);  // pieces per lane in a panel
  constexpr int W = CH * NCH / H::kPer;    // held words per lane of a panel
  constexpr int U = 32 / (CH / H::kPer) < 8 ? 32 / (CH / H::kPer) : 8;  // rows per step, sweep 1
  constexpr int U2 = in_flight(W, 32);     // rows per step, sweep 2
  __shared__ Stage st;
  __shared__ int cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long c = blockIdx.x / slices;
  const int s = blockIdx.x % slices;
  const int l_begin = min(L, s * slice_len), l_end = min(L, l_begin + slice_len);
  const long row = c * L;
  const float* vc = v + c * F;
  float* out = dst + (c * slices + s) * F;
  const int pieces = (F + 32 * CH - 1) / (32 * CH);  // a lane's pieces of a whole row
  const int panels = (F + kPanel - 1) / kPanel;

  int t0 = l_begin;
  do {  // at least once: an empty slice still writes its zeros
    const int n = stage_tile<Rows>(st, cnt, S, idx + row, w + row, bv + row, t0,
                                   min(l_end, t0 + kTile));
    // sweep 1: st.w[e] <- the coefficient of entry e
    for (int e0 = warp * U; e0 < n; e0 += kWarps * U) {
      float t[U];
#pragma unroll
      for (int u = 0; u < U; ++u) t[u] = 0.f;
      for (int j = 0; j < pieces; ++j) {
        float x[CH];
        load_vec<CH, 32, 1>(vc + j * 32 * CH, F - j * 32 * CH, lane, x);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u;
          if (e < n) {
            Word y[CH / H::kPer];
            load_row<Rows, CH, 32, 1>(Y + (size_t)st.idx[e] * F + j * 32 * CH,
                                      stage_scale<Rows>(st, e), F - j * 32 * CH, lane, y);
#pragma unroll
            for (int k = 0; k < CH; ++k) t[u] += value(y, k) * x[k];
          }
        }
      }
      const float dot = group_dots<32, U>(t, lane);
      const int eo = e0 + lane / (32 / U);
      if (lane % (32 / U) == 0 && eo < n)
        st.w[eo] = coefficient(st.w[eo], st.bv[eo], dot, alpha, beta);
    }
    __syncthreads();
    // sweep 2: each warp's panels of sum_e coef_e * y_e over the tile
    for (int pn = warp; pn < panels; pn += kWarps) {
      const int f0 = pn * kPanel;
      float acc[CH * NCH];
#pragma unroll
      for (int k = 0; k < CH * NCH; ++k) acc[k] = 0.f;
      for (int e0 = 0; e0 < n; e0 += U2) {
        Word y[U2][W];
#pragma unroll
        for (int u = 0; u < U2; ++u) {
          const int e = e0 + u;
          if (e < n) {
            load_row<Rows, CH, 32, NCH>(Y + (size_t)st.idx[e] * F + f0,
                                        stage_scale<Rows>(st, e), F - f0, lane, y[u]);
          } else {
#pragma unroll
            for (int k = 0; k < W; ++k) y[u][k] = 0;
          }
        }
#pragma unroll
        for (int u = 0; u < U2; ++u) {
          const float cu = e0 + u < n ? st.w[e0 + u] : 0.f;
#pragma unroll
          for (int k = 0; k < CH * NCH; ++k) acc[k] += cu * value(y[u], k);
        }
      }
      store_vec<CH, 32, NCH>(out + f0, F - f0, lane, acc, t0 != l_begin);
    }
    __syncthreads();  // the stage is rewritten next
    t0 += kTile;
  } while (t0 < l_end);
}

// out[c, f] = sum over s of part[c, s, f], in slice order
__global__ void wmv_sum_slices(const float* __restrict__ part, float* __restrict__ out, long CF,
                               int F, int slices) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= CF) return;
  const long c = i / F, f = i % F;
  const float* p = part + c * slices * F + f;
  float sum = 0.f;
  for (int s = 0; s < slices; ++s) sum += p[(long)s * F];
  out[i] = sum;
}

template <class Rows>
using KernelFn = void (*)(const typename Rows::Elem*, const float*, const int*, const float*,
                          const float*, const float*, float*, int, int, int, int, float, float);

// A kernel and the dynamic shared memory it launches with
template <class Rows>
struct Kernel {
  KernelFn<Rows> fn;
  int smem;
};

template <class Rows, int CH, int G, int NCH>
Kernel<Rows> narrow() {
  return {wmv_narrow<Rows, CH, G, NCH>, Narrow<Rows, CH, G, NCH>::kRingBytes};
}

// The instantiation for a row of F elements of the table at Y: 16-byte
// pieces where the row pitch and the address allow, else element by element;
// the narrowest group that holds the row, else more pieces per lane; past
// 512 values the two-sweep kernel.
template <class Rows>
Kernel<Rows> pick(const void* Y, int F) {
  using E = typename Rows::Elem;
  constexpr int V = Vec<Rows>::kPer;
  const bool vec = ((size_t)F * sizeof(E)) % 16 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  if (vec) {
    if (F <= 8 * V) return narrow<Rows, V, 8, 1>();
    if (F <= 16 * V) return narrow<Rows, V, 16, 1>();
    if (F <= 32 * V) return narrow<Rows, V, 32, 1>();
    if constexpr (V <= 8)
      if (F <= 64 * V) return narrow<Rows, V, 32, 2>();
    if constexpr (V <= 4) {
      if (F <= 96 * V) return narrow<Rows, V, 32, 3>();
      if (F <= 128 * V) return narrow<Rows, V, 32, 4>();
    }
    return {wmv_wide<Rows, V>, 0};
  }
  if (F <= 32) return narrow<Rows, 1, 32, 1>();
  if (F <= 64) return narrow<Rows, 1, 32, 2>();
  if (F <= 128) return narrow<Rows, 1, 32, 4>();
  if (F <= 256) return narrow<Rows, 1, 32, 8>();
  if (F <= 512) return narrow<Rows, 1, 32, 16>();
  return {wmv_wide<Rows, 1>, 0};
}

// The current device's SM count and the kernel's blocks per SM there. The
// first call per kernel and device sets the kernel's dynamic shared memory
// limit, which the occupancy depends on, and keeps both numbers: a launch
// then costs the host no attribute or occupancy query.
struct Occupancy {
  int sms, per_sm;
};

template <class Rows>
cudaError_t occupancy(Kernel<Rows> k, Occupancy* out) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, Occupancy> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(reinterpret_cast<const void*>(k.fn), device);
  const auto it = known.find(key);
  if (it != known.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  Occupancy o{0, 0};
  err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, k.fn, kThreads, k.smem);
  if (err != cudaSuccess) return err;
  known[key] = o;
  *out = o;
  return cudaSuccess;
}

// L-slices per row: enough (row, slice) blocks to fill every SM twice at the
// kernel's occupancy, slices of kMinSlice entries at least.
template <class Rows>
int slices_for(Kernel<Rows> k, int C, int L) {
  Occupancy o{0, 0};
  if (occupancy(k, &o) != cudaSuccess) return 1;  // the launch reports the error
  const long want = 2L * o.sms * (o.per_sm > 0 ? o.per_sm : 1);
  long S = C >= want ? 1 : (want + C - 1) / C;
  const long most = L / kMinSlice > 1 ? L / kMinSlice : 1;
  return (int)(S < most ? S : most);
}

template <class Rows>
int run(const void* Y, const void* S, const void* idx, const void* w, const void* bv,
        const void* v, void* out, void* part, int C, int L, int F, int slices, float alpha,
        float beta, void* stream) {
  if (C < 0 || L < 0 || F < 1 || slices < 1 || (slices > 1 && part == nullptr) ||
      (long)C * slices > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slice_len = (L + slices - 1) / slices;
  float* dst = static_cast<float*>(slices > 1 ? part : out);
  const Kernel<Rows> k = pick<Rows>(Y, F);
  Occupancy o{0, 0};
  cudaError_t err = occupancy(k, &o);  // sets the shared memory limit once
  if (err != cudaSuccess) return (int)err;
  k.fn<<<C * slices, kThreads, k.smem, st>>>(
      static_cast<const typename Rows::Elem*>(Y), static_cast<const float*>(S),
      static_cast<const int*>(idx), static_cast<const float*>(w), static_cast<const float*>(bv),
      static_cast<const float*>(v), dst, L, F, slices, slice_len, alpha, beta);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const long CF = (long)C * F;
  wmv_sum_slices<<<(unsigned)((CF + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), CF, F, slices);
  return (int)cudaGetLastError();
}

}  // namespace wmv
}  // namespace als

// L-slices a (C, L) chunk of rows of F values of the table at Y is cut into
// on the current device; table 0 float32, 1 bfloat16, 2 int8. Above 1, the
// caller allocates C * slices * F float32 of partial scratch.
extern "C" int weighted_matvec_slices(int table, const void* Y, int C, int L, int F) {
  using namespace als;
  if (C <= 0 || F < 1) return 1;
  if (table == 0) return wmv::slices_for<TableRows<float>>(wmv::pick<TableRows<float>>(Y, F), C, L);
  if (table == 1)
    return wmv::slices_for<TableRows<__nv_bfloat16>>(
        wmv::pick<TableRows<__nv_bfloat16>>(Y, F), C, L);
  return wmv::slices_for<QuantRows>(wmv::pick<QuantRows>(Y, F), C, L);
}

// Y (N, F) float32 or bfloat16; idx (C, L) int32; w, bv (C, L) float32;
// v (C, F) float32 -> out (C, F) float32; part (C, slices, F) float32
// scratch, null when slices is 1. Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int weighted_matvec_f32(const void* Y, const void* idx, const void* w,
                                   const void* bv, const void* v, void* out, void* part, int C,
                                   int L, int F, int slices, float alpha, float beta,
                                   void* stream) {
  return als::wmv::run<als::TableRows<float>>(Y, nullptr, idx, w, bv, v, out, part, C, L, F,
                                              slices, alpha, beta, stream);
}

extern "C" int weighted_matvec_bf16(const void* Y, const void* idx, const void* w,
                                    const void* bv, const void* v, void* out, void* part, int C,
                                    int L, int F, int slices, float alpha, float beta,
                                    void* stream) {
  return als::wmv::run<als::TableRows<__nv_bfloat16>>(Y, nullptr, idx, w, bv, v, out, part, C,
                                                      L, F, slices, alpha, beta, stream);
}

// The int8 table: Yq (N, F) int8 and its per-row scales s (N,) float32;
// the other arguments as above.
extern "C" int weighted_matvec_i8(const void* Yq, const void* s, const void* idx,
                                  const void* w, const void* bv, const void* v, void* out,
                                  void* part, int C, int L, int F, int slices, float alpha,
                                  float beta, void* stream) {
  return als::wmv::run<als::QuantRows>(Yq, s, idx, w, bv, v, out, part, C, L, F, slices, alpha,
                                       beta, stream);
}
