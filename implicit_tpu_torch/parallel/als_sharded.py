"""Row-sharded ALS over a mesh: each shard owns a slice of the factor rows.

The counterpart of ``implicit_tpu/parallel/als_sharded.py``. Rows are dealt
to the shards round-robin: row ``u`` lives on shard ``u % D`` at local index
``u // D``, which keeps every shard's row-length distribution alike, so a
power-law catalog stays balanced. A half-iteration is then local to each
shard but for two collectives over the opposite side:

1. each shard computes its own gramian ``side_kᵀ side_k`` (full float32);
2. the gramians are summed in shard order 0..D-1 on every device, so every
   device holds the same bits, and ``reg·I`` is added (the psum);
3. the side is all-gathered in the compute dtype (``torch.cat`` of the
   shards copied to each device); with ``gather_quant`` each shard first
   quantizes its own rows (the scales are per row, so this is the
   quantized whole table) and the int8 rows and scales are gathered;
4. every shard runs the single-device ``ops.als._solve_side_core`` on its
   own rows, so the CUDA kernels launch per shard exactly as one device
   routes them.

The gathered table is in shard order, so class ``indices`` are stored
pre-permuted (column ``i`` -> ``(i % D) * col_block + i // D``) when the
layout is built. Nothing in a half-iteration waits for the host, so shards
on distinct cards overlap; each shard's work is queued on its own device.
"""

import numpy as np
import torch

from .._device import full_f32_matmul
from .._device import on_device as _on
from ..ops import als as als_ops
from ..sparse import BucketClass, _pack_side, chunk_pieces, length_class_grid


def _block(n_rows, D):
    """Rows per shard (ceil), at least 1 so every shard is non-empty."""
    return max(1, -(-n_rows // D))


def _shard_order(n_rows, D, block, device=None):
    """Row ``u``'s position in the shard-order layout, for every row."""
    u = torch.arange(n_rows, device=device)
    return (u % D) * block + u // D


def permute_rows(x, D, block):
    """A factor table (tensor or array) -> its shard-order layout, zero-padded
    to ``D * block`` rows, on the input's device."""
    x = torch.as_tensor(x)
    out = x.new_zeros((D * block,) + tuple(x.shape[1:]))
    out[_shard_order(x.shape[0], D, block, x.device)] = x
    return out


def unpermute_rows(xp, D, block, n_rows):
    """A shard-order table -> the rows in their own order."""
    xp = torch.as_tensor(xp)
    return xp[_shard_order(n_rows, D, block, xp.device)]


def shard_rows(x, mesh, block):
    """A factor table as the fit holds it: its shard-order layout cut into
    one (block, F) tensor per shard, each on its shard's device (a copy of
    its own, since the solves update it in place)."""
    xp = permute_rows(x, mesh.size, block)
    return [xp[k * block:(k + 1) * block].to(d, copy=True) for k, d in enumerate(mesh.devices)]


def gather_rows(shards, n_rows, device):
    """The per-shard tables back as one table of ``n_rows`` rows in their own
    order, on ``device``."""
    return unpermute_rows(torch.cat([s.to(device) for s in shards]), len(shards),
                          shards[0].shape[0], n_rows)


class _ShardPlan:
    """One shard's bucketed rows as ``DeviceBuckets`` reads a plan: local row
    ids (the sentinel is ``block``), the per-shard empty rows, no padding."""

    def __init__(self, shape, nnz, block, empty_rows, classes):
        self.shape = shape
        self.n_rows = block
        self.nnz = nnz
        self.sentinel = block
        self.empty_rows = empty_rows
        self.classes = classes


def _check_prefix(rows, block):
    """Every chunk's real rows come first (``DeviceBucketClass.n_valid``
    scatters the first ``n_valid`` rows of a chunk)."""
    real = rows != block
    if (real[:, 1:] & ~real[:, :-1]).any():
        raise AssertionError("a chunk's sentinel rows are not at its end")


class RowShardedBuckets:
    """One training side, bucketed per shard: ``shards[k]`` is a
    ``DeviceBuckets`` on ``mesh.devices[k]`` holding shard k's rows.

    Its classes hold LOCAL row ids (the sentinel is ``block``) and column
    ids mapped into the opposite side's shard-order layout; ``empty_rows``
    is each shard's own table of local ids, unpadded (None where it has
    none). The shards share every piece's chunk layout: a shard with fewer
    rows in a class pads its chunks with the sentinel.

    The host plans every shard's classes; the raw CSR arrays go up once per
    distinct device (the column ids permuted there), and each shard's padded
    entry tensors are gathered on its device by ``sparse._pack_side``.
    Positions are int64, so any nnz packs (the JAX package's device pack
    addresses in int32 and packs on the host from 2**31 entries).
    """

    def __init__(self, csr, mesh, target_entries=1 << 23, max_chunk_rows=65536, min_L=8,
                 grid="pow2", data_dtype=np.float32):
        D = mesh.size
        n_rows, n_cols = csr.shape
        self.shape = tuple(int(s) for s in csr.shape)
        self.n_rows = n_rows
        self.nnz = int(csr.nnz)
        self.block = block = _block(n_rows, D)
        self.col_block = col_block = _block(n_cols, D)

        indptr = np.asarray(csr.indptr, dtype=np.int64)
        nnz_per_row = np.diff(indptr)
        csr_indices = np.asarray(csr.indices, dtype=np.int32)
        csr_data = np.asarray(csr.data, dtype=np.dtype(data_dtype))

        empties = np.flatnonzero(nnz_per_row == 0)
        classes = [[] for _ in range(D)]  # per shard: BucketClass per piece
        nonempty = np.flatnonzero(nnz_per_row > 0)
        L_per_row = length_class_grid(nnz_per_row[nonempty], min_L, grid)
        for L in np.unique(L_per_row):
            L = int(L)
            in_class = nonempty[L_per_row == L]
            sels = []
            for k in range(D):
                sel = in_class[in_class % D == k]
                # order by the first column's position in the gathered
                # (shard-order) table, so consecutive rows of a chunk read
                # nearby factor rows
                first = csr_indices[indptr[sel]].astype(np.int64)
                sels.append(sel[np.argsort((first % D) * col_block + first // D,
                                           kind="stable")])
            count = max(len(s) for s in sels)
            for start, stop, n_chunks, C in chunk_pieces(count, L, target_entries,
                                                         max_chunk_rows):
                padded = n_chunks * C
                for k, sel in enumerate(sels):
                    here = max(0, min(stop, len(sel)) - start)
                    rows = np.full(padded, block, dtype=np.int32)
                    lens = np.zeros(padded, dtype=np.int32)
                    rows[:here] = sel[start:start + here] // D
                    lens[:here] = nnz_per_row[sel[start:start + here]]
                    rows = rows.reshape(n_chunks, C)
                    _check_prefix(rows, block)
                    classes[k].append(BucketClass(L, C, rows, None, None,
                                                  lens.reshape(n_chunks, C)))

        plans = [_ShardPlan((block, D * col_block), int(nnz_per_row[k::D].sum()), block,
                            (empties[empties % D == k] // D).astype(np.int32), classes[k])
                 for k in range(D)]
        flats = {}
        for d in mesh.distinct():
            cols = torch.as_tensor(csr_indices, device=d)
            flats[d] = ((cols % D) * col_block + cols // D,
                        torch.as_tensor(csr_data, device=d),
                        torch.as_tensor(indptr[:-1], device=d))
        self.shards = []
        for k, (plan, d) in enumerate(zip(plans, mesh.devices)):
            cols, data, starts = flats[d]
            # shard k's local row r is global row r * D + k; sentinel rows
            # (= block) read the padding start and mask out by length 0
            local = starts[k::D]
            local = torch.cat([local, local.new_zeros(block + 1 - len(local))])
            self.shards.append(_pack_side(plan, cols, data, local, d))


def _gramians(side, mesh, reg):
    """``sum_k side_kᵀ side_k + reg·I`` (float32) on each distinct device:
    each shard's own gramian on its device, then the sum in shard order
    0..D-1, so every device holds the same bits."""
    local = []
    for s, d in zip(side, mesh.devices):
        with _on(d), full_f32_matmul():
            s = s.float()
            local.append(s.T @ s)
    out = {}
    for d in mesh.distinct():
        g = local[0].to(d)
        for part in local[1:]:
            g = g + part.to(d)
        out[d] = g + reg * torch.eye(g.shape[0], dtype=torch.float32, device=d)
    return out


def _gathered(side, mesh, compute_dtype, quant):
    """The all-gather of ``side`` on each distinct device: the table in the
    compute dtype, or with ``quant`` the (int8 rows, scales) pair of
    ``ops.als._quantize_table``, each shard quantizing its own rows."""
    if quant:
        parts = []
        for s, d in zip(side, mesh.devices):
            with _on(d):
                parts.append(als_ops._quantize_table(s, compute_dtype))
        return {d: (torch.cat([q.to(d) for q, _ in parts]),
                    torch.cat([s.to(d) for _, s in parts])) for d in mesh.distinct()}
    cd = als_ops._torch_dtype(compute_dtype)
    parts = [s.to(cd) for s in side]
    return {d: torch.cat([p.to(d) for p in parts]) for d in mesh.distinct()}


def solve_side(X, Y, buckets, mesh, reg, use_cg=True, cg_steps=3, compute_dtype="float32",
               gather_quant=False):
    """One half-iteration: every shard of ``X`` (a list of per-shard tables)
    re-solved against the gathered ``Y``; updated in place and returned."""
    grams = _gramians(Y, mesh, reg)
    tables = _gathered(Y, mesh, compute_dtype, gather_quant)
    out = []
    for x, shard, d in zip(X, buckets.shards, mesh.devices):
        with _on(d):
            # through the module, so that a caller may wrap the core
            out.append(als_ops._solve_side_core(x, tables[d], grams[d], shard, use_cg,
                                                cg_steps, compute_dtype))
    return out


def fit(X, Y, user_sh, item_sh, mesh, reg, iterations, use_cg=True, cg_steps=3,
        compute_dtype="float32", gather_quant=False):
    """``iterations`` full ALS iterations over the row-sharded layout.

    ``X`` / ``Y`` are lists of per-shard tables (:func:`shard_rows`),
    updated in place and returned. ``gather_quant`` is a bool or a
    ``(user_side, item_side)`` pair. No call waits for the device.
    """
    if not isinstance(gather_quant, (tuple, list)):
        gather_quant = (gather_quant, gather_quant)
    gq_user, gq_item = (bool(g) for g in gather_quant)
    kw = dict(use_cg=use_cg, cg_steps=cg_steps, compute_dtype=compute_dtype)
    for _ in range(iterations):
        X = solve_side(X, Y, user_sh, mesh, reg, gather_quant=gq_user, **kw)
        Y = solve_side(Y, X, item_sh, mesh, reg, gather_quant=gq_item, **kw)
    return X, Y


def calculate_loss(user_sh, X, Y, reg, mesh):
    """Confidence-weighted MSE over the row-sharded layout, the loss of
    ``ops.als.calculate_loss_bucketed``: per-chunk float32 partials of every
    shard against the gathered ``Y``, summed in float64 on the host."""
    tables = {d: torch.cat([y.to(d) for y in Y]) for d in mesh.distinct()}
    grams = {}
    for d, Yf in tables.items():
        with _on(d), full_f32_matmul():
            grams[d] = Yf.T @ Yf
    loss = total_conf = 0.0
    for x, shard, d in zip(X, user_sh.shards, mesh.devices):
        with _on(d):
            for cls in shard.classes:
                terms = [als_ops._loss_chunk_terms(x, tables[d], grams[d], cls.rows[i],
                                                   cls.indices[i], cls.data[i])
                         for i in range(cls.n_chunks)]
                loss += float(torch.stack([t[0] for t in terms]).double().sum())
                total_conf += float(torch.stack([t[1] for t in terms]).double().sum())
    loss += total_conf
    loss += float(reg) * (sum(float((x * x).sum()) for x in X)
                          + sum(float((y * y).sum()) for y in Y))
    users, items = user_sh.shape
    return loss / (total_conf + users * items - user_sh.nnz)
