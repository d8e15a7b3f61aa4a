// One chunk's item-row updates in BPR's grouped epoch, each row's sum taken
// in a fixed order (ops/bpr_update.py:bpr_item_update), in place of four
// index_put_(accumulate=True) calls over materialised (C*L, F) update
// tensors, each of which sorted its ids and summed the rows' updates at 1-2%
// of what the card's memory allows.
//
// Replaces no TPU kernel: the JAX package's grouped epoch
// (implicit_tpu/models/bpr.py) is plain XLA, its item updates four
// scatter-adds.
//
// What it computes. A chunk holds C user rows of L entries. Its 2*C*L
// entries are the liked items (cidx) then the drawn negatives (negids), each
// row-major; entry e names an item row key[e] and a user row c(e), and
// carries w_e = +z or -z (liked, negative). Every kept entry's update reads
// its item row as the chunk found it (y, b), so with sreg = lr reg each adds
//     (lr w_e) x[c(e)] - sreg y   to Y[key[e]],
//     lr (w_e - reg b)            to yb[key[e]],
// the terms index_put_ summed before, rounded as they were (each product and
// difference rounded on its own: no contraction into FMAs). The wrapper
// sorts the keys stably (dropped entries keyed n_items, so they sort last
// and are never written) and passes the permutation: each row's entries are
// one run, in entry order, the order in which index_put_ added them.
//
// Bound: bytes. Per entry its key, its position and its z; the touched rows
// read and written once (F + 1 floats each); x read once. At the last.fm
// cell's chunks (2*C*L about 131k entries, tens of thousands of rows touched
// at F = 128) the rows dominate: tens of MB a chunk, 10-30 us. The design:
//
// - A warp takes a tile of kTile sorted positions, one entry a lane: key,
//   position, coefficient and user row loaded once, then broadcast by
//   shuffles. The lanes hold the columns (a float4 each, 128 columns a warp;
//   a wider F is cut into column slabs along the grid's y; an F that is no
//   multiple of 4 takes one float a lane). x (C rows, at most 4 MB at the
//   cell) stays in L2. A warp issues the loads of kGroup entries' x rows and
//   of the rows their runs start on before it sums any.
// - A warp walks exactly its kTile entries, so a hot item (hundreds of
//   entries a chunk) never serialises one warp. A run sums from its row's
//   value, term by term in entry order, as index_put_ did; one that starts
//   and ends inside the tile is written there: the row read once, written
//   once. A run that reaches back over the tile's start leaves its terms'
//   sum, from 0, as a "head" partial in scratch; one that begins in the tile
//   and runs past its end, its row plus its terms as a "tail". The second
//   kernel, for each tile that owns a tail, finds the run's last tile (32
//   tiles' first keys a ballot), adds the tail and the heads in tile order,
//   and writes the row. So only a run cut by a tile's edge groups its sum
//   otherwise than index_put_ did.
// - No atomics: each row is written by one warp (per slab), and every sum
//   runs in an order fixed by the inputs, so two runs give the same bits.
//   Nothing waits on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace bpru {

constexpr int kTile = 32;   // sorted positions a warp walks
constexpr int kGroup = 8;   // entries whose loads a warp keeps in flight
constexpr int kWarps = 4;   // warps a block
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Cols {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Cols<VEC> zero() {
  Cols<VEC> r;
#pragma unroll
  for (int i = 0; i < VEC; ++i) r.v[i] = 0.f;
  return r;
}

template <int VEC>
__device__ __forceinline__ Cols<VEC> load(const float* p) {
  Cols<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Cols<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// the launch's shapes and pointers
struct Args {
  const int* keys;         // (n,) sorted
  const long long* perm;   // (n,) entry of each sorted position
  const float* z;          // (C*L,) the entries' 1 - sigmoid(score)
  const float* x;          // (C, F) the chunk's user rows
  float* Y;                // (n_items, F)
  float* yb;               // (n_items,)
  float* part;             // (2, n_tiles, F) head, tail partial rows
  float* part_b;           // (2, n_tiles) their biases'
  int n, n_tiles, CL, L, F, n_items;
  float lr, reg;
};

// the sums of row `k` (acc) and its bias (accb): into the tables, or as a
// partial in slot 0 (head) or 1 (tail) of tile t
template <int VEC>
__device__ __forceinline__ void put(const Args& a, int slot, int t, int k, int col, bool live,
                                    bool first, const Cols<VEC>& acc, float accb) {
  if (slot < 0) {
    if (live) store<VEC>(a.Y + (size_t)k * a.F + col, acc);
    if (first) a.yb[k] = accb;
    return;
  }
  const size_t at = (size_t)slot * a.n_tiles + t;
  if (live) store<VEC>(a.part + at * a.F + col, acc);
  if (first) a.part_b[at] = accb;
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32) tiles_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= a.n_tiles) return;
  const int col = (blockIdx.y * 32 + lane) * VEC;
  const bool live = col < a.F;
  const bool first = blockIdx.y == 0 && lane == 0;  // writes the biases
  const int base = t * kTile;
  const int p = base + lane;
  const int key = p < a.n ? a.keys[p] : a.n_items;
  const int prev = t > 0 ? a.keys[base - 1] : -1;
  const int next = base + kTile < a.n ? a.keys[base + kTile] : -1;
  const float sreg = __fmul_rn(a.lr, a.reg);

  float w = 0.f;
  int c = 0;
  if (key < a.n_items) {
    const long long e = a.perm[p];
    const bool liked = e < a.CL;
    const int q = (int)(liked ? e : e - a.CL);
    c = q / a.L;
    w = liked ? a.z[q] : -a.z[q];
  }
  const float lw = __fmul_rn(a.lr, w);
  const int before = __shfl_up_sync(kFull, key, 1);
  const int after = __shfl_down_sync(kFull, key, 1);
  const unsigned starts = __ballot_sync(kFull, key != (lane == 0 ? prev : before));
  const unsigned ends = __ballot_sync(kFull, key != (lane == 31 ? next : after));
  const int m = __popc(__ballot_sync(kFull, key < a.n_items));  // kept entries: a prefix

  Cols<VEC> acc = zero<VEC>(), y = zero<VEC>();
  float accb = 0.f, b = 0.f;
  bool head = false;  // the open run began in an earlier tile
  for (int j0 = 0; j0 < m; j0 += kGroup) {
    Cols<VEC> xv[kGroup], yv[kGroup];
    float lwv[kGroup], wv[kGroup], bv[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + u;
      const int cj = __shfl_sync(kFull, c, j);
      const int kj = __shfl_sync(kFull, key, j);
      lwv[u] = __shfl_sync(kFull, lw, j);
      wv[u] = __shfl_sync(kFull, w, j);
      const bool in = j < m;
      const bool opens = in && (j == 0 || ((starts >> j) & 1u));
      xv[u] = live && in ? load<VEC>(a.x + (size_t)cj * a.F + col) : zero<VEC>();
      yv[u] = live && opens ? load<VEC>(a.Y + (size_t)kj * a.F + col) : zero<VEC>();
      bv[u] = opens ? a.yb[kj] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + u;
      if (j < m) {
        const bool starts_j = (starts >> j) & 1u;
        if (j == 0 || starts_j) {  // the row as the chunk found it
          y = yv[u];
          b = bv[u];
          head = !starts_j;
          acc = head ? zero<VEC>() : y;
          accb = head ? 0.f : b;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc.v[i] = __fadd_rn(acc.v[i], __fsub_rn(__fmul_rn(lwv[u], xv[u].v[i]),
                                                   __fmul_rn(sreg, y.v[i])));
        accb = __fadd_rn(accb, __fmul_rn(a.lr, __fsub_rn(wv[u], __fmul_rn(a.reg, b))));
        if ((ends >> j) & 1u)
          put<VEC>(a, head ? 0 : -1, t, __shfl_sync(kFull, key, j), col, live, first, acc, accb);
      }
    }
  }
  // a run still open runs on into the next tile
  if (m == kTile && !(ends >> (kTile - 1)))
    put<VEC>(a, head ? 0 : 1, t, 0, col, live, first, acc, accb);
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32) runs_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= a.n_tiles - 1) return;  // the last tile's runs end in it
  const int col = (blockIdx.y * 32 + lane) * VEC;
  const bool live = col < a.F;
  const bool first = blockIdx.y == 0 && lane == 0;
  const int base = t * kTile;
  const int k = a.keys[base + kTile - 1];
  // this tile owns a tail: its last run is kept, began in it and runs past it
  if (k >= a.n_items || a.keys[base + kTile] != k || (t > 0 && a.keys[base - 1] == k)) return;
  int last = t + 1;  // the run's last tile
  for (;;) {
    const int tt = last + 1 + lane;
    const unsigned same = __ballot_sync(kFull, tt < a.n_tiles && a.keys[tt * kTile] == k);
    if (same != kFull) {
      last += __ffs(~same) - 1;
      break;
    }
    last += 32;
  }
  const size_t tail = (size_t)a.n_tiles + t;
  Cols<VEC> acc = live ? load<VEC>(a.part + tail * a.F + col) : zero<VEC>();
  float accb = a.part_b[tail];
#pragma unroll 4
  for (int h = t + 1; h <= last; ++h) {
    if (live) {
      const Cols<VEC> v = load<VEC>(a.part + (size_t)h * a.F + col);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc.v[i] = __fadd_rn(acc.v[i], v.v[i]);
    }
    accb = __fadd_rn(accb, a.part_b[h]);
  }
  put<VEC>(a, -1, t, k, col, live, first, acc, accb);
}

template <int VEC>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const dim3 grid((a.n_tiles + kWarps - 1) / kWarps, (a.F + 32 * VEC - 1) / (32 * VEC));
  tiles_kernel<VEC><<<grid, kWarps * 32, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  runs_kernel<VEC><<<grid, kWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace bpru

// keys (2 CL,) int32 sorted, perm (2 CL,) int64, z (CL,) and x (C, F)
// float32, Y (n_items, F) and yb (n_items,) float32 updated in place, part
// the scratch: every tile's head and tail partials, rows and biases, at
// least 2 ceil(2 CL / kTile) (F + 1) floats (ops/bpr_update.py:_scratch_floats)
extern "C" int bpr_item_update(const void* keys, const void* perm, const void* z, const void* x,
                               void* Y, void* yb, void* part, long long part_floats, int CL,
                               int L, int F, int n_items, float lr, float reg, void* stream) {
  using namespace bpru;
  if (CL < 0 || CL >= (1 << 30) || L < 1 || CL % L || F < 1 || n_items < 1 ||
      n_items == 0x7fffffff ||
      part_floats < 2 * ((2ll * CL + kTile - 1) / kTile) * ((long long)F + 1))
    return (int)cudaErrorInvalidValue;
  if (CL == 0) return (int)cudaSuccess;
  Args a;
  a.keys = static_cast<const int*>(keys);
  a.perm = static_cast<const long long*>(perm);
  a.z = static_cast<const float*>(z);
  a.x = static_cast<const float*>(x);
  a.Y = static_cast<float*>(Y);
  a.yb = static_cast<float*>(yb);
  a.n = 2 * CL;
  a.n_tiles = (a.n + kTile - 1) / kTile;
  a.part = static_cast<float*>(part);
  a.part_b = a.part + 2ll * a.n_tiles * F;
  a.CL = CL;
  a.L = L;
  a.F = F;
  a.n_items = n_items;
  a.lr = lr;
  a.reg = reg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = F % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)Y % 16 == 0 &&
                    (uintptr_t)part % 16 == 0;
  return (int)(vec4 ? launch<4>(a, st) : launch<1>(a, st));
}

extern "C" const char* als_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
