// Host routines of implicit_tpu_torch: the item-item similarity build and
// its per-row top-K, and the placement of the BPR pair-membership table.
//
// cuckoo_build is the JAX package's packer's (implicit_tpu/native/packer.cpp)
// cuckoo placement, copied, so both packages build the same table from the
// same pairs. topk_rows, knn_max_threads and knn_all_pairs are that packer's
// KNN routines, copied: built with the same flags, they give the JAX
// package's similarity bit for bit. Built with g++ at first use and bound
// with ctypes. The bucketed CSR is packed by torch ops, not here
// (sparse._pack_side).

#include <algorithm>
#include <cstdint>
#include <functional>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Per-row top-K by value over a CSR block; emits COO triples.
// out_* arrays must hold rows*K entries; returns number written.
int64_t topk_rows(int64_t rows, int64_t K, const int64_t *indptr,
                  const int32_t *indices, const double *data,
                  int32_t row_offset, int32_t *out_rows, int32_t *out_cols,
                  double *out_vals) {
  if (K <= 0) return 0;  // heap.front() below is UB on an empty heap
  int64_t written = 0;
  std::vector<std::pair<double, int32_t>> heap;
  heap.reserve(K + 1);
  for (int64_t r = 0; r < rows; ++r) {
    heap.clear();
    const int64_t lo = indptr[r], hi = indptr[r + 1];
    for (int64_t i = lo; i < hi; ++i) {
      if (static_cast<int64_t>(heap.size()) < K) {
        heap.emplace_back(data[i], indices[i]);
        std::push_heap(heap.begin(), heap.end(),
                       std::greater<std::pair<double, int32_t>>());
      } else if (data[i] > heap.front().first) {
        std::pop_heap(heap.begin(), heap.end(),
                      std::greater<std::pair<double, int32_t>>());
        heap.back() = {data[i], indices[i]};
        std::push_heap(heap.begin(), heap.end(),
                       std::greater<std::pair<double, int32_t>>());
      }
    }
    for (const auto &kv : heap) {
      out_rows[written] = row_offset + static_cast<int32_t>(r);
      out_cols[written] = kv.second;
      out_vals[written] = kv.first;
      ++written;
    }
  }
  return written;
}

// Fused item-item similarity: per item row i in [row_start, row_end) of
// item_users (items x users), accumulate row i of AᵀA into a dense
// per-thread accumulator (SMMP) and select its top-K in place — the CSR
// product never exists in memory. out_cols/out_vals are
// (row_end - row_start, K) row-sliced scratch (callers bound the scratch by
// chunking the row range; the accumulator always spans all `items`
// columns); out_cnt[i - row_start] says how many entries row i wrote (rows
// are independent, so this parallelizes without synchronization). Values
// accumulate in f64 like the scipy path.
// Hardware parallelism actually available to knn_all_pairs: the OpenMP
// worker pool size, or 1 when this object was built by the -fopenmp-less
// fallback (the Python cost model must not assume cpu_count threads then).
int32_t knn_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

void knn_all_pairs(int64_t items, int64_t K, int64_t row_start,
                   int64_t row_end, const int64_t *indptr_iu,
                   const int32_t *idx_iu, const double *dat_iu,
                   const int64_t *indptr_ui, const int32_t *idx_ui,
                   const double *dat_ui, int32_t num_threads,
                   int32_t *out_cols, double *out_vals, int32_t *out_cnt) {
  if (K <= 0) {  // heap.front() below is UB on an empty heap
    std::fill(out_cnt, out_cnt + (row_end - row_start), 0);
    return;
  }
#ifdef _OPENMP
  const int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
#pragma omp parallel num_threads(nt)
#endif
  {
    // 8B value array + a separate 1B/item stamp array: the stamp array is
    // items bytes (L2-resident at catalog scale) so "seen" checks rarely
    // miss, and no in-band sentinel exists — a NaN-valued accumulation
    // stays a value. uint8 stamps wrap every 256 rows; a cheap memset
    // re-arms them.
    std::vector<double> acc(items, 0.0);
    std::vector<uint8_t> stamp(items, 255);
    uint8_t cur = 0;
    int64_t rows_since_reset = 0;
    std::vector<int32_t> touched;
    touched.reserve(1 << 16);
    std::vector<std::pair<double, int32_t>> heap;
    heap.reserve(K + 1);
    const auto less = std::greater<std::pair<double, int32_t>>();

#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t i = row_start; i < row_end; ++i) {
      touched.clear();
      if (++rows_since_reset >= 255) {  // re-arm the wrapped stamps
        std::fill(stamp.begin(), stamp.end(), 255);
        cur = 0;
        rows_since_reset = 1;
      } else {
        ++cur;
      }
      const int64_t phi = indptr_iu[i + 1];
      for (int64_t p = indptr_iu[i]; p < phi; ++p) {
        // user rows are visited in random order: prefetch the next rows'
        // extents and entries so their DRAM misses overlap this row's work
        if (p + 1 < phi) __builtin_prefetch(&indptr_ui[idx_iu[p + 1]], 0, 1);
        if (p + 4 < phi)
          __builtin_prefetch(&idx_ui[indptr_ui[idx_iu[p + 4]]], 0, 0);
        const int32_t u = idx_iu[p];
        const double viu = dat_iu[p];
        const int64_t qhi = indptr_ui[u + 1];
        for (int64_t q = indptr_ui[u]; q < qhi; ++q) {
          const int32_t j = idx_ui[q];
          if (stamp[j] != cur) {  // first touch this row
            stamp[j] = cur;
            acc[j] = viu * dat_ui[q];
            touched.push_back(j);
          } else {
            acc[j] += viu * dat_ui[q];
          }
        }
      }
      heap.clear();
      for (const int32_t j : touched) {
        const double v = acc[j];
        if (static_cast<int64_t>(heap.size()) < K) {
          heap.emplace_back(v, j);
          std::push_heap(heap.begin(), heap.end(), less);
        } else if (v > heap.front().first) {
          std::pop_heap(heap.begin(), heap.end(), less);
          heap.back() = {v, j};
          std::push_heap(heap.begin(), heap.end(), less);
        }
      }
      int32_t *oc = out_cols + (i - row_start) * K;
      double *ov = out_vals + (i - row_start) * K;
      out_cnt[i - row_start] = static_cast<int32_t>(heap.size());
      for (size_t s = 0; s < heap.size(); ++s) {
        oc[s] = heap[s].second;
        ov[s] = heap[s].first;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Cuckoo pair-table build (see ../ops/membership.py for the slot format).
// Placement strategy is free — only the stored slot encoding must match the
// device lookup — so this is a plain random-walk bucketized cuckoo insert.

static inline uint32_t ck_mix32(uint32_t x, uint32_t c) {
  x *= c;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  return x;
}

static const uint32_t kRoundKeys[4] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                       0x27D4EB2Fu};
static const uint32_t kAltMix = 0x165667B1u;

// Places every (u, i) pair into the (nbuckets, 4) uint32 table (0 = empty).
// Returns 0 on success, -1 if a key could not be placed.
int32_t cuckoo_build(const uint32_t *u, const uint32_t *i, int64_t nnz,
                     int32_t a_bits, int32_t b_bits, int32_t bucket_bits,
                     uint32_t *table) {
  const uint32_t bucket_mask = (1u << bucket_bits) - 1u;
  const int32_t rem_bits = a_bits + b_bits - bucket_bits;
  const uint32_t rem_mask = (1u << (rem_bits > 1 ? rem_bits : 1)) - 1u;
  uint32_t rng = 0x6D2B79F5u;

  for (int64_t k = 0; k < nnz; ++k) {
    // unbalanced Feistel identical to membership._feistel
    uint32_t L = u[k], R = i[k];
    int32_t l_bits = a_bits;
    for (int r = 0; r < 4; ++r) {
      uint32_t F = ck_mix32(R + kRoundKeys[r], 0x9E3779B1u);
      uint32_t newR = L ^ (F & ((1u << l_bits) - 1u));
      L = R;
      R = newR;
      l_bits = (r % 2 == 0) ? b_bits : a_bits;  // widths swap each round
    }
    const uint32_t p_lo = (L << b_bits) | R;
    const uint32_t p_hi = b_bits > 0 ? (L >> (32 - b_bits)) : 0u;
    const uint32_t bucket = p_lo & bucket_mask;
    const uint32_t rem =
        ((p_lo >> bucket_bits) | (p_hi << (32 - bucket_bits))) & rem_mask;

    uint32_t val = (rem << 2) | 1u;  // primary placement flag
    uint32_t b = bucket;
    bool placed = false;
    for (int depth = 0; depth < 1024; ++depth) {
      uint32_t *row = table + (static_cast<int64_t>(b) << 2);
      int empty = -1;
      for (int s = 0; s < 4; ++s) {
        if (row[s] == 0u) {
          empty = s;
          break;
        }
      }
      if (empty >= 0) {
        row[empty] = val;
        placed = true;
        break;
      }
      // evict a pseudo-random victim; move it toward its other bucket
      rng = rng * 1664525u + 1013904223u;
      const int s = static_cast<int>(rng >> 30);
      const uint32_t victim = row[s];
      row[s] = val;
      const uint32_t vrem = victim >> 2;
      b = b ^ (ck_mix32(vrem, kAltMix) & bucket_mask);
      val = victim ^ 2u;  // flip primary/alternate flag
    }
    if (!placed) return -1;
  }
  return 0;
}

}  // extern "C"
