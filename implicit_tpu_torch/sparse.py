"""Bucketed, padded CSR tensors — the sparse substrate of the ALS solves.

The counterpart of ``implicit_tpu/sparse.py``. The matrix is re-packed once
per fit into a few fixed-shape dense tensors:

- rows are grouped into length classes ``L`` (>= 8) by their nnz;
- each class is split into chunks of ``C`` rows (C*L roughly constant);
- a class is stored as stacked arrays ``rows (n, C)``, ``indices (n, C, L)``
  and ``data (n, C, L)``, padded with the sentinel row id ``shape[0]`` and
  index 0 / value 0.

Padding entries carry confidence 0 and contribute nothing to the solves.
The host plans the classes (:class:`BucketedCSR`); one gather,
:func:`_pack_side`, writes the padded entry tensors on whatever device it
is given: the fit's device (:func:`pack_pair_on_device`, which also
derives the transposed side there, and :func:`pack_on_device`), or the CPU
for the host layout of the full :class:`BucketedCSR`.
"""

import numpy as np
import torch

from ._device import resolve_device
from .tracing import timed_step


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
        self.indices = indices  # (n, C, L) int32, padded with 0; None in a plan
        self.data = data  # (n, C, L) float, padded with 0; None in a plan
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
    metadata_only : bool
        Build the plan only (each class's ``rows`` and ``lengths``); the
        entry tensors stay None until :meth:`fill`, or are packed on the
        device (:func:`pack_pair_on_device`).
    """

    def __init__(self, csr, target_entries=1 << 23, max_chunk_rows=32768, min_L=8,
                 data_dtype=np.float32, grid="fine", metadata_only=False):
        indptr = np.asarray(csr.indptr)
        indices = np.asarray(csr.indices)
        first_cols = indices[np.minimum(indptr[:-1], len(indices) - 1)] if len(indices) else \
            np.zeros(csr.shape[0], dtype=np.int32)
        self._plan(csr.shape, indptr, first_cols, target_entries, max_chunk_rows, min_L,
                   data_dtype, grid)
        if not metadata_only:
            self.fill(csr)

    @classmethod
    def from_indptr(cls, shape, indptr, first_cols, target_entries=1 << 23,
                    max_chunk_rows=32768, min_L=8, data_dtype=np.float32, grid="fine"):
        """The ``metadata_only`` plan of a CSR matrix of ``shape`` from its
        ``indptr`` and each row's first stored column (``first_cols[r]`` is
        read only where row r has entries): what the device pack needs of
        the transposed side, without a host copy of its entries."""
        plan = cls.__new__(cls)
        plan._plan(shape, np.asarray(indptr), np.asarray(first_cols), target_entries,
                   max_chunk_rows, min_L, data_dtype, grid)
        return plan

    def _plan(self, shape, indptr, first_cols, target_entries, max_chunk_rows, min_L,
              data_dtype, grid):
        n_rows = shape[0]
        self.data_dtype = np.dtype(data_dtype)
        self.shape = tuple(int(s) for s in shape)
        self.n_rows = n_rows
        self.nnz = int(indptr[-1])
        self.sentinel = n_rows

        nnz_per_row = np.diff(indptr).astype(np.int64)
        self.empty_rows = np.where(nnz_per_row == 0)[0].astype(np.int32)

        nonempty = np.where(nnz_per_row > 0)[0]
        self.classes = []
        if len(nonempty) == 0:
            return

        L_per_row = length_class_grid(nnz_per_row[nonempty], min_L, grid)
        for L in np.unique(L_per_row):
            L = int(L)
            sel = nonempty[L_per_row == L]
            # order rows by their first column id: consecutive rows then
            # gather nearby factor rows
            sel = sel[np.argsort(first_cols[sel], kind="stable")]
            lens = nnz_per_row[sel].astype(np.int32)
            for start, stop, n_chunks, piece_C in chunk_pieces(
                    len(sel), L, target_entries, max_chunk_rows):
                padded_rows = n_chunks * piece_C
                rows = np.full(padded_rows, self.sentinel, dtype=np.int32)
                rows[:stop - start] = sel[start:stop]
                lengths = np.zeros(padded_rows, dtype=np.int32)
                lengths[:stop - start] = lens[start:stop]
                self.classes.append(BucketClass(
                    L, piece_C, rows.reshape(n_chunks, piece_C), None, None,
                    lengths.reshape(n_chunks, piece_C)))

    @property
    def padded_entries(self):
        return sum(c.n_chunks * c.C * c.L for c in self.classes)

    def fill(self, csr):
        """Packs the padded entry tensors of a plan as numpy arrays, through
        :func:`_pack_side` on the CPU; ``csr`` must be the matrix the plan
        was built from."""
        packed = _pack_side(self, *_upload(csr, self.data_dtype, "cpu"), "cpu")
        for cls, got in zip(self.classes, packed.classes):
            cls.indices, cls.data = got.indices.numpy(), got.data.numpy()
        return self

    def to_device(self, device):
        """Uploads the chunk tensors to ``device`` once (see DeviceBuckets)."""
        return DeviceBuckets(self, device)


class DeviceBuckets:
    """Device-resident mirror of a BucketedCSR on an explicit device.

    The plan's row ids, lengths and empty rows go up in one copy: a blocking
    copy to a CUDA device waits for the work queued there, so one copy per
    side lets the device pack queue all of its gathers behind it. A plan's
    entry tensors (None) stay None until :func:`_pack_side` gathers them.
    """

    def __init__(self, bucketed, device):
        self.device = torch.device(device)
        self.shape = bucketed.shape
        self.n_rows = bucketed.n_rows
        self.nnz = bucketed.nnz
        self.sentinel = bucketed.sentinel
        classes = bucketed.classes
        arrays = [bucketed.empty_rows] + [c.rows for c in classes] + [c.lengths for c in classes]
        flat = torch.as_tensor(np.concatenate([a.ravel() for a in arrays]).astype(np.int64),
                               device=self.device)
        empty, *parts = (t.view(a.shape) for t, a in
                         zip(flat.split([a.size for a in arrays]), arrays))
        self.empty_rows = empty if len(empty) else None
        self.classes = [DeviceBucketClass(cls, bucketed.sentinel, rows, lengths, self.device)
                        for cls, rows, lengths in zip(classes, parts, parts[len(classes):])]


class DeviceBucketClass:
    """One bucket class on the device, plus each chunk's count of real rows.

    Sentinel padding rows sit at the end of a chunk, so ``n_valid[i]`` lets
    a solve scatter chunk ``i``'s first rows back without a device sync.
    """

    __slots__ = ("L", "C", "n_chunks", "rows", "indices", "data", "lengths", "n_valid")

    def __init__(self, cls, sentinel, rows, lengths, device):
        self.L = cls.L
        self.C = cls.C
        self.n_chunks = cls.n_chunks
        self.n_valid = [int(n) for n in (cls.rows != sentinel).sum(axis=1)]
        self.rows = rows  # int64
        self.lengths = lengths.to(torch.int32)
        self.indices = None if cls.indices is None else torch.as_tensor(cls.indices,
                                                                       device=device)
        self.data = None if cls.data is None else torch.as_tensor(cls.data, device=device)


def _transpose(cols, data, indptr, n_cols):
    """The transposed matrix's flat (indices, data) and indptr, on the
    device of the inputs, without a sync.

    A stable sort by column keeps each column's entries in row-major order,
    so rows come out ascending within a column, duplicates and unsorted input
    rows included: exactly ``Cui.T.tocsr()``'s layout.
    """
    counts = indptr[1:] - indptr[:-1]
    rows = torch.repeat_interleave(
        torch.arange(len(counts), dtype=torch.int32, device=cols.device), counts,
        output_size=len(cols))
    sorted_cols, order = torch.sort(cols, stable=True)
    # searchsorted, not bincount: bincount on CUDA syncs to find its length
    t_indptr = torch.searchsorted(
        sorted_cols, torch.arange(n_cols + 1, dtype=cols.dtype, device=cols.device))
    return rows[order], data[order], t_indptr


def _pack_side(plan, flat_indices, flat_data, indptr, device):
    """DeviceBuckets for one side from its flat CSR arrays on the device:
    each class's padded (n, C, L) entries gathered at ``indptr[row] + l``,
    zero where ``l`` is past the row's length. The one code that writes the
    padded entry tensors. Positions are int64, so any nnz packs (the JAX
    package addresses in int32 and host-packs past 2**31 entries)."""
    buckets = DeviceBuckets(plan, device)
    for cls in buckets.classes:
        # sentinel rows (= n_rows) read indptr's last entry and mask out
        # through their length 0
        arange = torch.arange(cls.L, device=device)
        valid = arange[None, :] < cls.lengths.reshape(-1, 1)
        pos = torch.where(valid, indptr[cls.rows.reshape(-1)][:, None] + arange[None, :], 0)
        shape = (cls.n_chunks, cls.C, cls.L)
        cls.indices = flat_indices[pos].masked_fill_(~valid, 0).reshape(shape)
        cls.data = flat_data[pos].masked_fill_(~valid, 0).reshape(shape)
    return buckets


def _upload(csr, data_dtype, device):
    """``csr``'s flat column ids (int32), values (``data_dtype``) and indptr
    (int64) as tensors on ``device``."""
    return (torch.as_tensor(np.asarray(csr.indices, dtype=np.int32), device=device),
            torch.as_tensor(np.asarray(csr.data, dtype=data_dtype), device=device),
            torch.as_tensor(np.asarray(csr.indptr, dtype=np.int64), device=device))


def pack_on_device(csr, device, **plan_kw):
    """One side's DeviceBuckets on ``device``: the host plan of ``csr``
    (:class:`BucketedCSR` keywords), its entries gathered on the device from
    one upload of the raw CSR arrays."""
    plan = BucketedCSR(csr, metadata_only=True, **plan_kw)
    return _pack_side(plan, *_upload(csr, plan.data_dtype, device), device)


def pack_pair_on_device(Cui, Ciu=None, target_entries=1 << 23, max_chunk_rows=32768,
                        grid="fine", data_dtype=np.float32, device="cuda"):
    """Both training sides (user side of ``Cui``, item side of its
    transpose) as DeviceBuckets on ``device``, a CUDA device or the CPU.

    ``Cui``'s raw ``indices``, ``data`` and ``indptr`` go up once; the item
    side's flat arrays are derived on the device (COO row ids by
    ``repeat_interleave``, a stable sort by column) and every padded class
    tensor is gathered there (:func:`_pack_side`). The host builds only the
    two plans, the item plan from the item ``indptr`` and each item's first
    user, copied back once. ``Ciu`` (``Cui.T.tocsr()``), if given, is read
    only for its plan. A failure of the pack raises.
    """
    device = resolve_device(device)
    kw = dict(target_entries=target_entries, max_chunk_rows=max_chunk_rows, grid=grid,
              data_dtype=data_dtype)
    n_rows, n_cols = Cui.shape
    with timed_step("upload", device):
        cols, data, indptr = _upload(Cui, data_dtype, device)
    with timed_step("transpose", device):
        t_indices, t_data, t_indptr = _transpose(cols, data, indptr, n_cols)
    with timed_step("plan user side", device):
        plan_u = BucketedCSR(Cui, metadata_only=True, **kw)
    with timed_step("plan item side", device):
        if Ciu is not None:
            plan_i = BucketedCSR(Ciu, metadata_only=True, **kw)
        else:
            first = (t_indices[t_indptr[:-1].clamp(max=len(t_indices) - 1)] if len(t_indices)
                     else torch.zeros(n_cols, dtype=torch.int32, device=device))
            meta = torch.cat([t_indptr, first.long()]).cpu().numpy()  # the one copy back
            plan_i = BucketedCSR.from_indptr((n_cols, n_rows), meta[:n_cols + 1],
                                             meta[n_cols + 1:], **kw)
    with timed_step("pack user side", device):
        user = _pack_side(plan_u, cols, data, indptr, device)
    with timed_step("pack item side", device):
        item = _pack_side(plan_i, t_indices, t_data, t_indptr, device)
    return user, item
