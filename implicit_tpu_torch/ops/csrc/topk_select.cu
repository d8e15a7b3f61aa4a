// The top k of each row of a float32 score block, with per-row exclusions
// applied while it selects: the serving engine's selection
// (ops/topk.py:select_topk), in place of torch.topk and a scatter of
// -FLT_MAX into the liked entries before it.
//
// Replaces no TPU kernel: the JAX package leaves the selection to
// lax.top_k (implicit_tpu/ops/topk.py) and writes its exclusions with a
// scatter, as the port did with torch.topk, whose radix select reads the
// score block once for each 8-bit digit it counts.
//
// Semantics (those of the scatter and torch.topk before it):
// - an id found in the row's exclusions scores exactly -FLT_MAX and is still
//   offered, so a fully filtered row pads with filtered ids; ids outside
//   [0, n) never match;
// - the order is total: a float maps to torch.topk's order-preserving 32-bit
//   key (every NaN above +inf, -0 below +0), and ties go to the lower id. An
//   entry is the 64-bit composite key << 32 | ~id, so a larger composite
//   ranks first and every entry of a row is distinct;
// - results are (k) scores in descending order and int64 ids a row.
//
// Bound: the score block's bytes, read once (1024 x 292,385 float32, 1.2 GB:
// 0.358 ms at 3.35 TB/s); the output and the exclusions are a few KB. So:
//
// - A block of 256 threads takes one segment of one row (the wrapper picks
//   the segments from Q and n, so that a small batch still fills the card);
//   threads stream it with 16-byte loads, four in flight each. A row starts
//   where the previous ends (n is odd in the last.fm catalog), so the
//   segment's scalar head up to the first 16-byte boundary, and its tail,
//   are taken by the first warp.
// - Each warp keeps its own top k, sorted, one entry a lane (two where
//   k > 32), and the k-th of them as its threshold in every lane. An
//   element costs one composite compare with the threshold; an element
//   that passes (about k ln(m / k) of a warp's m) is checked against the
//   row's exclusions by binary search in shared memory, and inserted into
//   the warp's list by a shift across the lanes.
// - The warps' lists merge in the first warp; with several segments a row,
//   a second launch of this kernel merges their (Q, segments x k)
//   candidates, taking the candidates' ids from `in_ids`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;           // 16-byte loads in flight per thread
constexpr int kSharedIds = 2048;     // a row's exclusions staged in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNegMaxKey = 0x00800000u;  // the key of -FLT_MAX

// torch.topk's order-preserving key of a float, NaN above everything
__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t x = __float_as_uint(v);
  const uint32_t mask = (x & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return v == v ? x ^ mask : 0xffffffffu;
}

// the float of a key (a NaN for NaN's key)
__device__ __forceinline__ float value_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? key ^ 0x80000000u : ~key);
}

__device__ __forceinline__ uint64_t entry(uint32_t key, uint32_t id) {
  return (uint64_t)key << 32 | (uint32_t)~id;
}

// whether the sorted ids[0, len) hold x
__device__ __forceinline__ bool contains(const int* ids, int len, int x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < len && ids[lo] == x;
}

// A warp's sorted list: rank `lane` in a, rank 32 + lane in b (K = 64).
// Empty places hold 0, below every entry.
template <int K>
struct WarpList {
  uint64_t a = 0, b = 0;

  // c (not in the list) into its place; the last entry drops out
  __device__ __forceinline__ void insert(uint64_t c, int lane) {
    const uint64_t up_a = __shfl_up_sync(kFull, a, 1);
    if (K == 64) {
      uint64_t up_b = __shfl_up_sync(kFull, b, 1);
      const uint64_t a31 = __shfl_sync(kFull, a, 31);
      if (lane == 0) up_b = a31;
      b = b > c ? b : (up_b > c ? c : up_b);
    }
    a = a > c ? a : ((lane == 0 || up_a > c) ? c : up_a);
  }

  // the k-th entry, in every lane
  __device__ __forceinline__ uint64_t kth(int k) const {
    if (K == 64 && k > 32) return __shfl_sync(kFull, b, k - 33);
    return __shfl_sync(kFull, a, k - 1);
  }
};

struct Exclusions {
  const int* ids;
  int len;
};

// Whether the element (key, id) may beat the threshold: its entry with the
// key raised to -FLT_MAX's is at least its entry, excluded or not, so only
// an element that passes is looked up in the exclusions.
__device__ __forceinline__ bool may_beat(uint32_t key, uint32_t id, uint64_t thr) {
  return entry(max(key, kNegMaxKey), id) > thr;
}

// Offers each lane's element (key, id), where `offered`, to the warp's list.
template <int K>
__device__ __forceinline__ void offer(WarpList<K>& list, uint64_t& thr, int k, int lane,
                                      bool offered, uint32_t key, uint32_t id,
                                      const Exclusions& ex) {
  const bool pass = offered && may_beat(key, id, thr);
  if (!__any_sync(kFull, pass)) return;
  uint64_t exact = 0;
  if (pass) {
    exact = (ex.len > 0 && contains(ex.ids, ex.len, (int)id)) ? entry(kNegMaxKey, id)
                                                             : entry(key, id);
  }
  unsigned m = __ballot_sync(kFull, exact > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const uint64_t c = __shfl_sync(kFull, exact, src);
    if (c > thr) {
      list.insert(c, lane);
      thr = list.kth(k);
    }
  }
}

// One block: segment `blockIdx.x % segs` of row `blockIdx.x / segs` of the
// (rows, n) block `scores`; its top k into (rows * segs, k) `out_vals` /
// `out_ids`. Element j's id is j, or in_ids[row, j] where kIds.
template <int K, bool kIds>
__global__ void __launch_bounds__(kThreads, 4)
    topk_select_kernel(const float* __restrict__ scores, const int64_t* __restrict__ in_ids,
                       long long n, int k, int segs, long long seg_len,
                       const int* __restrict__ excl_ptr, const int* __restrict__ excl_ids,
                       float* __restrict__ out_vals, int64_t* __restrict__ out_ids) {
  __shared__ int s_ids[kSharedIds];
  __shared__ uint64_t s_lists[kWarps][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / segs;
  const long long lo = (long long)(blockIdx.x % segs) * seg_len;
  const long long hi = min(n, lo + seg_len);

  // the row's exclusions, in shared memory where they fit
  Exclusions ex = {nullptr, 0};
  if (excl_ptr != nullptr) {
    const int e0 = excl_ptr[row];
    ex.len = excl_ptr[row + 1] - e0;
    ex.ids = excl_ids + e0;
    if (ex.len <= kSharedIds) {
      for (int i = threadIdx.x; i < ex.len; i += kThreads) s_ids[i] = ex.ids[i];
      ex.ids = s_ids;
    }
    __syncthreads();
  }

  const float* p = scores + row * n + lo;
  const int64_t* pid = kIds ? in_ids + row * n + lo : nullptr;
  const long long cnt = hi - lo;
  const long long head = min(cnt, (long long)((0 - ((uintptr_t)p >> 2)) & 3));
  const long long nvec = (cnt - head) >> 2;
  const long long tail0 = head + 4 * nvec;

  WarpList<K> list;
  uint64_t thr = 0;
  auto id_at = [&](long long j) -> uint32_t {
    return kIds ? (uint32_t)pid[j] : (uint32_t)(lo + j);
  };

  if (warp == 0) {  // the head (lanes 0-3) and the tail (lanes 4-7)
    long long j = -1;
    if (lane < head) j = lane;
    if (lane >= 4 && lane - 4 < cnt - tail0) j = tail0 + lane - 4;
    const bool ok = j >= 0;
    const float v = ok ? p[j] : 0.f;
    offer(list, thr, k, lane, ok, key_of(v), ok ? id_at(j) : 0u, ex);
  }

  const float4* pv = reinterpret_cast<const float4*>(p + head);
  for (long long i0 = (long long)warp * 32; i0 < nvec; i0 += (long long)kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads + lane;
      v[u] = i < nvec ? __ldcs(pv + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads + lane;
      const bool ok = i < nvec;
      const long long j = head + 4 * i;
      const uint32_t key[4] = {key_of(v[u].x), key_of(v[u].y), key_of(v[u].z), key_of(v[u].w)};
      uint32_t id[4] = {0u, 0u, 0u, 0u};
      bool any = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ok) id[e] = id_at(j + e);
        any |= ok && may_beat(key[e], id[e], thr);
      }
      if (!__any_sync(kFull, any)) continue;  // the common case: no element passes
#pragma unroll
      for (int e = 0; e < 4; ++e) offer(list, thr, k, lane, ok, key[e], id[e], ex);
    }
  }

  // the warps' lists into the first warp's: each list is sorted, so its
  // first entry at or below the threshold ends it
  s_lists[warp][lane] = list.a;
  if (K == 64) s_lists[warp][lane + 32] = list.b;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    for (int r = 0; r < k; ++r) {
      const uint64_t c = s_lists[w][r];
      if (c <= thr) break;
      list.insert(c, lane);
      thr = list.kth(k);
    }
  }
  const long long o = (long long)blockIdx.x * k;
  if (lane < k) {
    out_vals[o + lane] = value_of((uint32_t)(list.a >> 32));
    out_ids[o + lane] = (int64_t)(uint32_t)~(uint32_t)list.a;
  }
  if (K == 64 && lane + 32 < k) {
    out_vals[o + lane + 32] = value_of((uint32_t)(list.b >> 32));
    out_ids[o + lane + 32] = (int64_t)(uint32_t)~(uint32_t)list.b;
  }
}

template <int K>
void launch(const float* scores, const int64_t* in_ids, long long rows, long long n, int k,
            int segs, const int* excl_ptr, const int* excl_ids, float* out_vals,
            int64_t* out_ids, cudaStream_t st) {
  const long long seg_len = (n + segs - 1) / segs;
  const unsigned blocks = (unsigned)(rows * segs);
  if (in_ids != nullptr) {
    topk_select_kernel<K, true><<<blocks, kThreads, 0, st>>>(
        scores, in_ids, n, k, segs, seg_len, excl_ptr, excl_ids, out_vals, out_ids);
  } else {
    topk_select_kernel<K, false><<<blocks, kThreads, 0, st>>>(
        scores, in_ids, n, k, segs, seg_len, excl_ptr, excl_ids, out_vals, out_ids);
  }
}

}  // namespace topk

// The top k (1 to 64) of each segment of each row of the (rows, n) float32
// block `scores` (4-byte aligned), n < 2^31: `segs` segments a row of
// ceil(n / segs) elements each, every one at least k long. Writes (rows *
// segs, k) scores in descending order to `out_vals` and int64 ids to
// `out_ids`. Element j of a row has id j, or in_ids[row * n + j] (int64,
// in [0, 2^31)) where in_ids is not null. `excl_ptr` (rows + 1 int32) and
// `excl_ids` (int32, sorted within each row) are the rows' exclusions, or
// both null. Returns the launch's cudaError_t (0 on success).
extern "C" int topk_select(const void* scores, const void* in_ids, long long rows, long long n,
                           int k, int segs, const void* excl_ptr, const void* excl_ids,
                           void* out_vals, void* out_ids, void* stream) {
  using namespace topk;
  const long long seg_len = segs < 1 ? 0 : (n + segs - 1) / segs;
  if (rows < 0 || n < 1 || n >= (1ll << 31) || k < 1 || k > 64 || segs < 1 || seg_len < k ||
      n - (segs - 1) * seg_len < k || rows * segs >= (1ll << 31) ||
      (excl_ptr == nullptr) != (excl_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)scores % 4) return (int)cudaErrorMisalignedAddress;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scores);
  const int64_t* ids = static_cast<const int64_t*>(in_ids);
  const int* ep = static_cast<const int*>(excl_ptr);
  const int* ei = static_cast<const int*>(excl_ids);
  float* ov = static_cast<float*>(out_vals);
  int64_t* oi = static_cast<int64_t*>(out_ids);
  if (k <= 32) {
    launch<32>(s, ids, rows, n, k, segs, ep, ei, ov, oi, st);
  } else {
    launch<64>(s, ids, rows, n, k, segs, ep, ei, ov, oi, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* als_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
