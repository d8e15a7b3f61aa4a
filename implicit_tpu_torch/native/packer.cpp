// Host routines of implicit_tpu_torch: ragged CSR rows into padded blocks,
// and the placement of the BPR pair-membership table.
//
// pack_ragged is the one host routine the port's bucketed CSR needs
// (sparse.BucketedCSR); it packs exactly what the JAX package's packer
// (implicit_tpu/native/packer.cpp) packs, and what the numpy path of
// native/__init__.py packs. cuckoo_build is that packer's cuckoo placement,
// copied, so both packages build the same table from the same pairs. Built
// with g++ at first use and bound with ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// Fill padded index/data blocks for the selected rows.
// out_idx/out_dat are (count, L); the tail of each row past its length is
// zeroed here.
void pack_ragged(const int64_t *indptr, const int32_t *indices,
                 const float *data, const int32_t *row_sel, int64_t count,
                 int64_t L, int32_t *out_idx, float *out_dat) {
  for (int64_t r = 0; r < count; ++r) {
    const int64_t start = indptr[row_sel[r]];
    const int64_t len = indptr[row_sel[r] + 1] - start;
    int32_t *oi = out_idx + r * L;
    float *od = out_dat + r * L;
    std::memcpy(oi, indices + start, sizeof(int32_t) * len);
    std::memcpy(od, data + start, sizeof(float) * len);
    std::memset(oi + len, 0, sizeof(int32_t) * (L - len));
    std::memset(od + len, 0, sizeof(float) * (L - len));
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
