"""Batched brute-force scored top-k with filtering — the serving engine.

The counterpart of ``implicit_tpu/ops/topk.py``:

    scores = queries @ items.T        (float32 GEMM)
    scores /= item_norms              (optional)
    scores[filtered] = -FLT_MAX
    torch.topk(scores, k)

Filtered entries get ``-FLT_MAX`` (not -inf), so they can still round out
results when fewer than k candidates survive; if k exceeds the number of
items, the tail pads with id -1 / score -FLT_MAX. Queries run in chunks
whose score matrix fits a memory budget.

The entry points share that core:

- :func:`topk_async` scores a resident table and returns a
  :class:`TopkFuture`: each chunk's ids and scores are copied to pinned
  host buffers without blocking, and ``result()`` waits on each chunk's
  CUDA event before it reads the buffers. :func:`topk` is
  ``topk_async(...).result()``.
- :func:`topk_streaming` serves a table that stays on the host (numpy or a
  memmap): row blocks go through two pinned staging buffers and upload on a
  copy stream while the compute stream scores the previous block, and a
  running (Q, k) candidate set merges per block.

With ``mesh=`` (a ``parallel.Mesh``) the item table is sharded on its rows
over the mesh (:func:`shard_items_for_topk`): each shard scores and selects
on its own device, and one ``torch.topk`` merges the D·k candidates on the
mesh's first device (:func:`_topk_core_sharded`); a streamed block is cut
the same way (:func:`topk_streaming`).

The JAX package pads shapes to buckets (``_pad_dim``) to keep its jit cache
warm; nothing is compiled here, so the port scores the exact shapes. Only
the order among exactly tied scores can differ from the JAX package's
(``torch.topk`` promises no order among ties).
"""

import numpy as np
import torch

from .. import tracing
from .._device import full_f32_matmul, on_device, resolve_device

NEG_MAX = -float(np.finfo(np.float32).max)

# score-matrix elements per query chunk on the CPU (256 MB of float32)
_MAX_SCORE_ELEMENTS_CPU = 1 << 26

# chunks of one topk_async call whose results may still be in flight; older
# ones are drained into the output arrays, which bounds the device memory a
# huge query batch holds to a few chunks' results
_MAX_IN_FLIGHT = 4


def _score_budget_elements(device):
    """float32 elements available for one chunk's score matrix.

    On CUDA: half of the free device memory, capped at 4 GB; on the CPU a
    fixed 256 MB.
    """
    if device.type == "cuda":
        tracing.count("device.mem_queries")
        free, _ = torch.cuda.mem_get_info(device)
        return max(min(free // 2, 4 << 30) // 4, 1 << 22)
    return _MAX_SCORE_ELEMENTS_CPU


def _scoring_table(items):
    """The item table as the GEMM reads it: float32.

    16-bit tables (bfloat16 serving of 16-bit models) are widened here so
    that the product of bfloat16 values accumulates and returns in float32,
    as the JAX package's preferred_element_type=float32 GEMM does.
    """
    return items if items.dtype == torch.float32 else items.float()


def _upload(array, device):
    """A host array or tensor on ``device`` without waiting for the
    device's queue; a tensor already there is returned as it is.

    A plain copy from pageable memory synchronizes the stream, which would
    stall the host until every product already queued has run; a copy from
    pinned memory with ``non_blocking=True`` is queued behind them instead
    (PyTorch's pinned allocator keeps the buffer until the copy is done).
    """
    t = torch.as_tensor(array)
    if t.device == device:
        return t
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _topk_core(items, queries, norms, qf_rows, qf_cols, filter_items, k, n_valid=None):
    """Scores one query chunk and selects its top k.

    ``items`` (N, F) float32; ``queries`` (Q, F), already rounded to the
    table's serving dtype; ``norms`` (N,) or None; ``qf_rows``/``qf_cols``
    the (query row, item id) pairs to exclude, or None; ``filter_items``
    item ids to exclude for every query, or None. Ids outside [0, N) are
    ignored. Rows from ``n_valid`` on are padding and score -inf, below
    every filtered item's -FLT_MAX, so none is ever selected ahead of a real
    item. Returns (scores, ids) of shape (Q, k).
    """
    with full_f32_matmul():  # the JAX package's HIGHEST-precision scores
        scores = queries.float() @ items.T
    if norms is not None:
        scores = scores / norms[None, :]
    if n_valid is not None and n_valid < items.shape[0]:
        scores[:, n_valid:] = -float("inf")
    if filter_items is not None:
        scores[:, filter_items] = NEG_MAX
    if qf_rows is not None:
        scores[qf_rows, qf_cols] = NEG_MAX
    return torch.topk(scores, k, dim=1)


def shard_items_for_topk(items, item_norms, mesh, dtype=None):
    """An item table cut into row slices, one per shard of ``mesh``, each on
    its shard's device: ``(shards, norm shards or None, n_items)``.

    Rows are padded with zeros to a multiple of the mesh size (the sharded
    core masks them) and norms with 1. ``dtype`` is the scoring dtype of the
    table (default: bfloat16 for 16-bit tables, else float32). Callers that
    serve repeatedly cache the result: it is one upload of the whole table.
    """
    dtype = _table_dtype(items) if dtype is None else dtype
    n_items = items.shape[0]
    table = (items.to(dtype) if isinstance(items, torch.Tensor)
             else _host_block(items, 0, n_items, dtype))
    D = mesh.size
    n_local = max(1, -(-n_items // D))
    pad = n_local * D - n_items
    if pad:
        table = torch.cat([table, table.new_zeros((pad,) + tuple(table.shape[1:]))])
    shards = [_upload(table[k * n_local:(k + 1) * n_local], d)
              for k, d in enumerate(mesh.devices)]
    norms = None
    if item_norms is not None:
        padded = np.ones(n_local * D, dtype=np.float32)
        padded[:n_items] = torch.as_tensor(item_norms).cpu().numpy()
        norms = [_upload(padded[k * n_local:(k + 1) * n_local], d)
                 for k, d in enumerate(mesh.devices)]
    return shards, norms, n_items


def _local_ids(ids, lo, hi):
    """The positions in ``ids`` (host int64) that fall in [lo, hi)."""
    return np.flatnonzero((ids >= lo) & (ids < hi))


def _topk_core_sharded(shards, queries, norms, qf, filter_items, k, n_items):
    """The item-sharded top-k of one query chunk (the mesh's serving core).

    Shard ``s`` holds rows ``s * n_local`` on; it scores the queries on its
    own device, masks its padding rows (global id >= ``n_items``), applies
    its own filters (``qf[s]``: (rows, local cols) or None; ``filter_items
    [s]``: local ids or None) and selects its top ``min(k, n_local)``. The
    D·k candidates are then copied to the queries' device and merged by one
    ``torch.topk``. Shards past the catalog are skipped. Returns (scores,
    global ids), (Q, k).
    """
    n_local = shards[0].shape[0]
    merge = queries.device
    vals, ids = [], []
    for s, shard in enumerate(shards):
        offset = s * n_local
        real = min(n_items - offset, n_local)
        if real <= 0:
            continue
        d = shard.device
        rows, cols = qf[s] if qf is not None and qf[s] is not None else (None, None)
        with on_device(d):
            v, i = _topk_core(_scoring_table(shard), queries.to(d),
                              None if norms is None else norms[s], rows, cols,
                              None if filter_items is None else filter_items[s],
                              min(k, n_local), n_valid=real)
        vals.append(v.to(merge))
        ids.append((i + offset).to(merge))
    return _merge(vals, ids, k)


def _merge(vals, ids, k):
    """Merges candidate sets (Q, k_i) (lists of scores and ids) into the top k."""
    if len(vals) == 1 and vals[0].shape[1] == k:
        return vals[0], ids[0]
    top, pos = torch.topk(torch.cat(vals, dim=1), k, dim=1)
    return top, torch.gather(torch.cat(ids, dim=1), 1, pos)


def _pad_results(ids, scores, k):
    """Pads (Q, k_eff) results to k columns with id -1 / score -FLT_MAX."""
    pad = k - ids.shape[1]
    if pad <= 0:
        return ids, scores
    q_rows = ids.shape[0]
    return (np.concatenate([ids, np.full((q_rows, pad), -1, dtype=np.int32)], axis=1),
            np.concatenate([scores, np.full((q_rows, pad), NEG_MAX, dtype=np.float32)],
                           axis=1))


class TopkFuture:
    """A top-k result queued on the device and not yet read.

    Returned by :func:`topk_async`. Each pending chunk holds its device
    results, the pinned host buffers they are being copied into, and the
    CUDA event recorded after the copies; :meth:`result` waits on each
    event before it reads the buffers, and returns the ``(ids, scores)``
    numpy arrays :func:`topk` would have returned. Work queued by later
    calls runs on the device meanwhile: the building block of pipelined
    serving (``MatrixFactorizationBase.recommend_pipelined``).
    """

    def __init__(self, pending, ids_out, scores_out, k):
        self._pending = pending
        self._ids_out = ids_out
        self._scores_out = scores_out
        self._k = k
        self._result = None

    def _drain(self, limit):
        """Reads the oldest chunks into the output arrays until at most
        ``limit`` remain in flight."""
        while len(self._pending) > limit:
            start, stop, event, ids, vals, _ = self._pending.pop(0)
            if event is not None:
                event.synchronize()  # the copies into the pinned buffers are done
            self._ids_out[start:stop] = ids.numpy()
            self._scores_out[start:stop] = vals.numpy()

    def result(self):
        if self._result is None:
            self._drain(0)
            self._result = _pad_results(self._ids_out, self._scores_out, self._k)
        return self._result


def topk(items, query, k, item_norms=None, filter_query_items=None, filter_items=None,
         num_threads=0, mesh=None, n_items=None):
    """Return the top ``k`` scoring item (ids, scores) for each query row.

    Parameters
    ----------
    items : (N, F) torch tensor — item factors on the serving device
        (float32, or bfloat16 for 16-bit models). With ``mesh=`` also a
        host array, or the shard list of :func:`shard_items_for_topk`
        (then ``n_items`` gives the true row count).
    query : (Q, F) or (F,) tensor or array — query factors; rounded to the
        table's dtype before scoring. A tensor on the table's device stays
        there.
    k : int
    item_norms : (N,) tensor or array, optional — scores are divided by these
        (with pre-sharded ``items``: their norm shards)
    filter_query_items : csr_matrix, optional — per-query items to exclude
    filter_items : array_like, optional — items to exclude for all queries
    num_threads : ignored (API parity)
    mesh : parallel.Mesh, optional — serve the table sharded on its rows:
        each shard scores and selects on its device, the candidates merge on
        the mesh's first device (:func:`_topk_core_sharded`)
    n_items : int, optional — true item count of a pre-sharded table

    Returns
    -------
    (ids, scores) : (Q, k) int32 / float32 numpy arrays. If k exceeds the
    number of items, the tail is padded with id -1 / score -FLT_MAX.
    """
    return topk_async(items, query, k, item_norms=item_norms,
                      filter_query_items=filter_query_items,
                      filter_items=filter_items, num_threads=num_threads, mesh=mesh,
                      n_items=n_items).result()


def topk_async(items, query, k, item_norms=None, filter_query_items=None, filter_items=None,
               num_threads=0, mesh=None, n_items=None):
    """Like :func:`topk`, but returns a :class:`TopkFuture` without waiting.

    Every chunk's product, filters and selection are queued on the current
    stream, then its ids and scores are copied into pinned host buffers
    with ``non_blocking=True`` and an event is recorded. At most
    ``_MAX_IN_FLIGHT`` chunks stay in flight: older ones are read into the
    output arrays before the next is queued. On the CPU every step runs at
    once and the future only holds the arrays. With ``mesh=`` each chunk
    runs :func:`_topk_core_sharded`; its filters are cut per shard on the
    host.
    """
    shards = None
    if mesh is not None:
        if isinstance(items, (list, tuple)):
            if n_items is None:
                raise ValueError("a pre-sharded table needs n_items=")
            shards, norms = list(items), item_norms
        else:
            shards, norms, n_items = shard_items_for_topk(items, item_norms, mesh)
        device, table_dtype = mesh.devices[0], shards[0].dtype
        n_local = shards[0].shape[0]
    else:
        device, table_dtype, n_items = items.device, items.dtype, items.shape[0]
    query = torch.as_tensor(query)
    if query.dim() == 1:
        query = query.reshape(1, -1)
    q_rows = query.shape[0]
    if k <= 0:
        return TopkFuture([], np.empty((q_rows, 0), dtype=np.int32),
                          np.empty((q_rows, 0), dtype=np.float32), 0)
    k_eff = max(1, min(int(k), n_items))

    # queries on the host upload once, queries on the device stay there;
    # float32 first, then the table's dtype, as the JAX package rounds them
    query = _upload(query, device).float().to(table_dtype)
    fi = None
    if filter_items is not None and len(filter_items) > 0:
        fi = np.asarray(filter_items, dtype=np.int64)
        fi = fi[(fi >= 0) & (fi < n_items)]
    if shards is None:
        table = _scoring_table(items)
        norms = None
        if item_norms is not None:
            norms = _upload(torch.as_tensor(item_norms, dtype=torch.float32), device)
        if fi is not None:
            fi = _upload(fi, device)
        chunk_width = n_items
    else:
        if fi is not None:
            fi = [_upload(fi[_local_ids(fi, k0, k0 + n_local)] - k0, d)
                  for k0, d in zip(range(0, n_local * mesh.size, n_local), mesh.devices)]
        chunk_width = n_local * mesh.size

    chunk = max(1, min(q_rows, _score_budget_elements(device) // max(chunk_width, 1)))
    future = TopkFuture([], np.empty((q_rows, k_eff), dtype=np.int32),
                        np.empty((q_rows, k_eff), dtype=np.float32), k)
    for start in range(0, q_rows, chunk):
        stop = min(start + chunk, q_rows)
        rows = cols = None
        if filter_query_items is not None:
            sub = filter_query_items[start:stop]
            cols = np.asarray(sub.indices, dtype=np.int64)
            rows = np.repeat(np.arange(stop - start, dtype=np.int64), np.diff(sub.indptr))
            keep = (cols >= 0) & (cols < n_items)
            rows, cols = rows[keep], cols[keep]
        if shards is None:
            qf_rows = qf_cols = None
            if rows is not None:
                qf_rows, qf_cols = _upload(rows, device), _upload(cols, device)
            vals, idx = _topk_core(table, query[start:stop], norms, qf_rows, qf_cols, fi,
                                   k_eff)
        else:
            qf = None
            if rows is not None:
                qf = []
                for k0, d in zip(range(0, n_local * mesh.size, n_local), mesh.devices):
                    at = _local_ids(cols, k0, k0 + n_local)
                    qf.append((_upload(rows[at], d), _upload(cols[at] - k0, d))
                              if len(at) else None)
            vals, idx = _topk_core_sharded(shards, query[start:stop], norms, qf, fi, k_eff,
                                           n_items)
        idx = idx.to(torch.int32)
        if device.type == "cuda":
            ids_h = torch.empty(idx.shape, dtype=torch.int32, pin_memory=True)
            vals_h = torch.empty(vals.shape, dtype=torch.float32, pin_memory=True)
            ids_h.copy_(idx, non_blocking=True)
            vals_h.copy_(vals, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            # the device results ride along until the event has been waited on
            future._pending.append((start, stop, event, ids_h, vals_h, (idx, vals)))
        else:
            future._pending.append((start, stop, None, idx, vals, None))
        future._drain(_MAX_IN_FLIGHT - 1)
    return future


def _table_dtype(items):
    """Scoring dtype of a host table: 16-bit float tables (float16, or
    bfloat16 arrays) stream and score in bfloat16, everything else in
    float32 — the JAX package's ``_table_dtype``."""
    dtype = getattr(items, "dtype", None)
    if dtype in (torch.float16, torch.bfloat16):
        return torch.bfloat16
    if isinstance(dtype, np.dtype) and dtype.itemsize == 2 and dtype.kind in "fV":
        return torch.bfloat16
    return torch.float32


def _host_block(items, start, stop, dtype):
    """Rows ``start:stop`` of a host table as a CPU tensor of ``dtype``.

    A bfloat16 numpy array (an extension dtype numpy cannot convert) is
    reinterpreted through its 16-bit words; float16 rounds to bfloat16 to
    nearest even, as the JAX package's ``astype`` does. Rows of a read-only
    memmap are read into an array of their own.
    """
    block = items[start:stop]
    if isinstance(block, torch.Tensor):
        return block.to(dtype)
    block = np.asarray(block)
    if not block.flags.writeable:  # a read-only memmap: torch wants its own copy
        block = np.array(block)
    if block.dtype.itemsize == 2 and block.dtype.kind == "V":
        return torch.from_numpy(np.ascontiguousarray(block).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(block)).to(dtype)


class _BlockStream:
    """Uploads a host table's row blocks through two pinned staging buffers.

    On CUDA the copies run on a side stream: block ``b``'s copy waits for
    the event recorded after the products that read block ``b - 2`` (the
    device buffer it overwrites), and the compute stream waits for the
    copy's event before it scores the block, so block ``b + 1``'s upload
    overlaps block ``b``'s product. The host refills a staging buffer only
    after the copy that read it has finished. On the CPU a block is used
    where it lies.
    """

    def __init__(self, block_rows, F, dtype, with_norms, device):
        self.device = device
        self.cuda = device.type == "cuda"
        if not self.cuda:
            return
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        self.host = [torch.empty((block_rows, F), dtype=dtype, pin_memory=True)
                     for _ in range(2)]
        self.dev = [torch.empty((block_rows, F), dtype=dtype, device=device)
                    for _ in range(2)]
        self.host_norms = self.dev_norms = None
        if with_norms:
            self.host_norms = [torch.empty(block_rows, dtype=torch.float32, pin_memory=True)
                               for _ in range(2)]
            self.dev_norms = [torch.empty(block_rows, dtype=torch.float32, device=device)
                              for _ in range(2)]
        for t in self.dev + (self.dev_norms or []):
            t.record_stream(self.copy)  # written there, freed on the compute stream
        self.uploaded = [None, None]  # copy of the slot's last block done
        self.consumed = [None, None]  # products that read the slot's block done

    def upload(self, b, block, norms):
        """Block ``b`` (a CPU tensor) and its norms (or None) on the device."""
        if not self.cuda:
            return block, norms
        slot, rows = b % 2, block.shape[0]
        if self.uploaded[slot] is not None:
            self.uploaded[slot].synchronize()  # the staging buffer was read
        self.host[slot][:rows].copy_(block)
        if norms is not None:
            self.host_norms[slot][:rows].copy_(norms)
        with torch.cuda.stream(self.copy):
            if self.consumed[slot] is not None:
                self.copy.wait_event(self.consumed[slot])
            self.dev[slot][:rows].copy_(self.host[slot][:rows], non_blocking=True)
            if norms is not None:
                self.dev_norms[slot][:rows].copy_(self.host_norms[slot][:rows],
                                                  non_blocking=True)
            self.uploaded[slot] = torch.cuda.Event()
            self.uploaded[slot].record(self.copy)
        self.compute.wait_event(self.uploaded[slot])
        return (self.dev[slot][:rows],
                None if norms is None else self.dev_norms[slot][:rows])

    def scored(self, b):
        """Marks block ``b``'s products as queued: its device buffer may be
        refilled once they have run."""
        if self.cuda:
            self.consumed[b % 2] = torch.cuda.Event()
            self.consumed[b % 2].record(self.compute)


def topk_streaming(items, query, k, item_norms=None, filter_query_items=None,
                   filter_items=None, block_rows=None, num_threads=0, q_chunk_rows=None,
                   device="cuda", mesh=None):
    """Exact top-k over an item table that stays on the host.

    The serving path for catalogs whose factor table is too large to keep
    on the device: ``items`` is a numpy array or anything sliceable to one
    (a memmap), and its row blocks upload one after the other
    (:class:`_BlockStream`) while a running (Q, k) candidate set merges
    per block through ``torch.topk``. Results equal :func:`topk` on the
    resident table up to the order of exact ties: the same filters and
    -FLT_MAX sentinels, and the same padding past the item count.

    ``block_rows`` defaults from the score budget, bounding both the score
    matrix (queries x block) and the block itself (block x F), and is at
    least the number of results, so every block returns only real
    candidates. Queries run in chunks of ``q_chunk_rows`` (default: the
    budget over the block) inside each block, so a batch of any size
    passes over the table once. 16-bit tables stream in bfloat16 and score
    in float32. ``device`` is where the products run (CUDA unless the
    caller asks for the CPU).

    With ``mesh=`` each block is cut into one row slice per shard (the
    block rounded up to a multiple of the mesh size): every shard streams
    its slices through its own staging buffers to its own device, scores
    and selects there, and the shards' candidates merge on the mesh's first
    device, which holds the running set; ``device`` is not read.
    """
    if mesh is None:
        device = resolve_device(device)
        devices = [device]
    else:
        devices = list(mesh.devices)
        device = devices[0]
    query = torch.as_tensor(query)
    if query.dim() == 1:
        query = query.reshape(1, -1)
    q_rows, F = query.shape
    n_items = items.shape[0]
    if k <= 0:
        return (np.empty((q_rows, 0), dtype=np.int32),
                np.empty((q_rows, 0), dtype=np.float32))
    k_eff = max(1, min(int(k), n_items))

    table_dt = _table_dtype(items)
    budget = _score_budget_elements(device)
    if block_rows is None:
        block_rows = max(1024, min(budget // max(min(q_rows, 8192), 1), budget // max(F, 1)))
    block_rows = int(min(max(block_rows, k_eff), n_items))
    n_local = -(-block_rows // len(devices))  # rows of a block per shard
    block_rows = n_local * len(devices)
    if q_chunk_rows is None:
        q_chunk_rows = budget // block_rows
    q_chunk = max(1, min(q_rows, int(q_chunk_rows)))
    chunks = [(c0, min(c0 + q_chunk, q_rows)) for c0 in range(0, q_rows, q_chunk)]

    # the queries as the table's dtype scores them, uploaded once (and
    # copied once to each other device of the mesh)
    query = _upload(query, device).float().to(table_dt)
    queries = {d: query.to(d) for d in dict.fromkeys(devices)}

    fi = (np.asarray(filter_items, dtype=np.int64)
          if filter_items is not None and len(filter_items) > 0 else None)
    qf_row = qf_col = None
    if filter_query_items is not None:
        coo = filter_query_items.tocoo()
        # by column: each slice's pairs are one run
        order = np.argsort(coo.col, kind="stable")
        qf_row = coo.row[order].astype(np.int64)
        qf_col = coo.col[order].astype(np.int64)

    streams = [_BlockStream(n_local, F, table_dt, item_norms is not None, d) for d in devices]
    running = [None] * len(chunks)  # (vals, ids) per query chunk, on the device
    for b, start in enumerate(range(0, n_items, block_rows)):
        stop = min(start + block_rows, n_items)
        cands = [([], []) for _ in chunks]  # each chunk's candidates per shard
        for s, (stream, d) in enumerate(zip(streams, devices)):
            lo, hi = start + s * n_local, min(start + (s + 1) * n_local, stop)
            if hi <= lo:
                continue
            norms = None
            if item_norms is not None:
                norms = torch.from_numpy(np.asarray(item_norms[lo:hi], dtype=np.float32))
            block, norms = stream.upload(b, _host_block(items, lo, hi, table_dt), norms)
            block = _scoring_table(block)

            fi_dev = None
            if fi is not None:
                in_block = fi[(fi >= lo) & (fi < hi)] - lo
                if len(in_block):
                    fi_dev = _upload(in_block, d)
            blk_rows = blk_cols = None
            if qf_col is not None:
                at0, at1 = np.searchsorted(qf_col, [lo, hi])
                blk_rows, blk_cols = qf_row[at0:at1], qf_col[at0:at1] - lo
                # re-sort by row so each chunk's pairs are one run
                by_row = np.argsort(blk_rows, kind="stable")
                blk_rows, blk_cols = blk_rows[by_row], blk_cols[by_row]

            for ci, (c0, c1) in enumerate(chunks):
                qf_rows = qf_cols = None
                if blk_rows is not None:
                    at0, at1 = np.searchsorted(blk_rows, [c0, c1])
                    if at1 > at0:
                        qf_rows = _upload(blk_rows[at0:at1] - c0, d)
                        qf_cols = _upload(blk_cols[at0:at1], d)
                with on_device(d):
                    vals, idx = _topk_core(block, queries[d][c0:c1], norms, qf_rows, qf_cols,
                                           fi_dev, min(k_eff, hi - lo))
                cands[ci][0].append(vals.to(device))
                cands[ci][1].append((idx + lo).to(device))
            stream.scored(b)
        for ci, (vals, ids) in enumerate(cands):
            vals, ids = _merge(vals, ids, min(k_eff, stop - start))
            running[ci] = ((vals, ids) if running[ci] is None else
                           _merge([running[ci][0], vals], [running[ci][1], ids], k_eff))

    ids = np.empty((q_rows, k_eff), dtype=np.int32)
    vals = np.empty((q_rows, k_eff), dtype=np.float32)
    for (c0, c1), (v, i) in zip(chunks, running):
        ids[c0:c1] = i.to(torch.int32).cpu().numpy()
        vals[c0:c1] = v.cpu().numpy()
    return _pad_results(ids, vals, k)
