"""Bucketed, padded CSR tensors — the sparse substrate of the ALS solves.

The counterpart of ``implicit_tpu/sparse.py`` (host packing only). The
matrix is re-packed once, on the host, into a few fixed-shape dense tensors:

- rows are grouped into length classes ``L`` (>= 8) by their nnz;
- each class is split into chunks of ``C`` rows (C*L roughly constant);
- a class is stored as stacked arrays ``rows (n, C)``, ``indices (n, C, L)``
  and ``data (n, C, L)``, padded with the sentinel row id ``shape[0]`` and
  index 0 / value 0.

Padding entries carry confidence 0 and contribute nothing to the solves.
:meth:`BucketedCSR.to_device` uploads the tensors once per fit.
"""

import numpy as np
import torch


def length_class_grid(nnz_per_row, min_L=8, grid="fine"):
    """Padded length L per row on the shared bucketing grid.

    grid="fine": eighth-power-of-two steps (8, 16, 24, ..., 64, 80, ...), each
    a multiple of 8, <=1.17x ratio, ~7% average in-row padding.
    grid="pow2": powers of two only, ~4x fewer classes, ~30% padding.
    """
    n = np.asarray(nnz_per_row, dtype=np.int64)
    p = (1 << np.ceil(np.log2(np.maximum(n, 1))).astype(np.int64))
    L_per_row = np.maximum(min_L, p)
    if grid != "pow2":
        for eighths in (7, 6, 5):
            cand = (eighths * p) // 8
            ok = (n <= cand) & (cand % 8 == 0) & (cand >= min_L)
            L_per_row = np.where(ok, cand, L_per_row)
    return L_per_row


def als_chunk_target(factors, compute_dtype="float32", block_bytes=4 << 30):
    """The ALS fit's target C*L entries per chunk for a factor width.

    Bounds the (C, L, F) gathered block that the plain solves materialize to
    ``block_bytes`` (the CUDA kernels gather rows themselves and never write
    the block). The same policy as the JAX package, so both packages cut the
    same chunks.
    """
    itemsize = 2 if str(compute_dtype) in ("bfloat16", "float16", "torch.bfloat16") else 4
    return int(np.clip(block_bytes // (int(factors) * itemsize), 1 << 21, 1 << 24))


def chunk_pieces(count, L, target_entries, max_chunk_rows):
    """[(start, stop, n_chunks, C)] chunk layout for ``count`` rows of
    padded length L. C is a multiple of 8; a partially-filled final chunk
    becomes its own tightly-sized piece."""
    C = max(8, (min(max_chunk_rows, target_entries // L) // 8) * 8)
    full_chunks = count // C
    remainder = count - full_chunks * C
    pieces = []
    if full_chunks:
        pieces.append((0, full_chunks * C, full_chunks, C))
    if remainder:
        pieces.append((full_chunks * C, count, 1, max(8, -(-remainder // 8) * 8)))
    return pieces


class BucketClass:
    """All rows whose nnz fits one padded length L, stacked into chunks."""

    __slots__ = ("L", "C", "n_chunks", "rows", "indices", "data", "lengths")

    def __init__(self, L, C, rows, indices, data, lengths):
        self.L = L
        self.C = C
        self.n_chunks = rows.shape[0]
        self.rows = rows  # (n, C) int32, padded with sentinel (= n_rows)
        self.indices = indices  # (n, C, L) int32, padded with 0
        self.data = data  # (n, C, L) float, padded with 0
        self.lengths = lengths  # (n, C) int32 actual nnz per row


class BucketedCSR:
    """Host-side bucketed representation of a scipy CSR matrix.

    Parameters
    ----------
    csr : scipy.sparse.csr_matrix
    target_entries : int
        Rough upper bound on C*L per chunk.
    max_chunk_rows : int
        Upper bound on rows per chunk.
    """

    def __init__(self, csr, target_entries=1 << 23, max_chunk_rows=32768, min_L=8,
                 data_dtype=np.float32, grid="fine"):
        n_rows = csr.shape[0]
        self.data_dtype = np.dtype(data_dtype)
        self.shape = csr.shape
        self.n_rows = n_rows
        self.nnz = csr.nnz
        self.sentinel = n_rows

        indptr = np.asarray(csr.indptr)
        nnz_per_row = np.diff(indptr).astype(np.int64)
        self.empty_rows = np.where(nnz_per_row == 0)[0].astype(np.int32)

        csr_indices = np.asarray(csr.indices, dtype=np.int32)
        csr_data = np.asarray(csr.data, dtype=self.data_dtype)

        nonempty = np.where(nnz_per_row > 0)[0]
        self.classes = []
        if len(nonempty) == 0:
            return

        from . import native

        L_per_row = length_class_grid(nnz_per_row[nonempty], min_L, grid)
        for L in np.unique(L_per_row):
            L = int(L)
            sel = nonempty[L_per_row == L]
            # order rows by their first column id: consecutive rows then
            # gather nearby factor rows
            sel = sel[np.argsort(csr_indices[indptr[sel]], kind="stable")]
            lens = nnz_per_row[sel].astype(np.int32)
            count = len(sel)

            packed_idx, packed_dat = native.pack_ragged(
                indptr, csr_indices, csr_data, sel.astype(np.int32), L,
                dtype=self.data_dtype,
            )
            for start, stop, n_chunks, piece_C in chunk_pieces(
                    count, L, target_entries, max_chunk_rows):
                piece_count = stop - start
                padded_rows = n_chunks * piece_C
                rows = np.full(padded_rows, self.sentinel, dtype=np.int32)
                rows[:piece_count] = sel[start:stop]
                lengths = np.zeros(padded_rows, dtype=np.int32)
                lengths[:piece_count] = lens[start:stop]
                if padded_rows > piece_count:
                    idx = np.zeros((padded_rows, L), dtype=np.int32)
                    dat = np.zeros((padded_rows, L), dtype=self.data_dtype)
                    idx[:piece_count] = packed_idx[start:stop]
                    dat[:piece_count] = packed_dat[start:stop]
                else:
                    idx = packed_idx[start:stop]
                    dat = packed_dat[start:stop]
                self.classes.append(BucketClass(
                    L, piece_C,
                    rows.reshape(n_chunks, piece_C),
                    idx.reshape(n_chunks, piece_C, L),
                    dat.reshape(n_chunks, piece_C, L),
                    lengths.reshape(n_chunks, piece_C),
                ))

    @property
    def padded_entries(self):
        return sum(c.n_chunks * c.C * c.L for c in self.classes)

    def to_device(self, device):
        """Uploads the chunk tensors to ``device`` once (see DeviceBuckets)."""
        return DeviceBuckets(self, device)


class DeviceBuckets:
    """Device-resident mirror of a BucketedCSR on an explicit device."""

    def __init__(self, bucketed, device):
        self.device = torch.device(device)
        self.shape = bucketed.shape
        self.n_rows = bucketed.n_rows
        self.nnz = bucketed.nnz
        self.sentinel = bucketed.sentinel
        self.empty_rows = (
            torch.as_tensor(bucketed.empty_rows, dtype=torch.int64, device=self.device)
            if len(bucketed.empty_rows) else None
        )
        self.classes = [DeviceBucketClass(cls, self.device, bucketed.sentinel)
                        for cls in bucketed.classes]


class DeviceBucketClass:
    """One bucket class on the device, plus each chunk's count of real rows.

    Sentinel padding rows sit at the end of a chunk, so ``n_valid[i]`` lets
    a solve scatter chunk ``i``'s first rows back without a device sync.
    """

    __slots__ = ("L", "C", "n_chunks", "rows", "indices", "data", "lengths", "n_valid")

    def __init__(self, cls, device, sentinel):
        self.L = cls.L
        self.C = cls.C
        self.n_chunks = cls.n_chunks
        self.n_valid = [int(n) for n in (cls.rows != sentinel).sum(axis=1)]
        self.rows = torch.as_tensor(cls.rows, dtype=torch.int64, device=device)
        self.indices = torch.as_tensor(cls.indices, device=device)
        self.data = torch.as_tensor(cls.data, device=device)
        self.lengths = torch.as_tensor(cls.lengths, device=device)
