// Host packer of implicit_tpu_torch: ragged CSR rows into padded blocks.
//
// pack_ragged is the one host routine the port's bucketed CSR needs
// (sparse.BucketedCSR); it packs exactly what the JAX package's packer
// (implicit_tpu/native/packer.cpp) packs, and what the numpy path of
// native/__init__.py packs. Built with g++ at first use and bound with
// ctypes.

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

}  // extern "C"
