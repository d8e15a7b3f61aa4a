"""Batched brute-force scored top-k with filtering — the serving engine.

The counterpart of ``implicit_tpu/ops/topk.py`` (resident tables only):

    scores = queries @ items.T        (float32 GEMM)
    scores /= item_norms              (optional)
    scores[filtered] = -FLT_MAX
    torch.topk(scores, k)

Filtered entries get ``-FLT_MAX`` (not -inf), so they can still round out
results when fewer than k candidates survive; if k exceeds the number of
items, the tail pads with id -1 / score -FLT_MAX. Queries run in chunks
whose score matrix fits a memory budget.
"""

import numpy as np
import torch

from .._device import full_f32_matmul

NEG_MAX = -float(np.finfo(np.float32).max)

# score-matrix elements per query chunk on the CPU (256 MB of float32)
_MAX_SCORE_ELEMENTS_CPU = 1 << 26


def _score_budget_elements(device):
    """float32 elements available for one chunk's score matrix.

    On CUDA: half of the free device memory, capped at 4 GB; on the CPU a
    fixed 256 MB.
    """
    if device.type == "cuda":
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


def _topk_core(items, queries, norms, qf_rows, qf_cols, filter_items, k):
    """Scores one query chunk and selects its top k.

    ``items`` (N, F) float32; ``queries`` (Q, F), already rounded to the
    table's serving dtype; ``norms`` (N,) or None; ``qf_rows``/``qf_cols``
    the (query row, item id) pairs to exclude, or None; ``filter_items``
    item ids to exclude for every query, or None. Ids outside [0, N) are
    ignored. Returns (scores, ids) of shape (Q, k).
    """
    with full_f32_matmul():  # the JAX package's HIGHEST-precision scores
        scores = queries.float() @ items.T
    if norms is not None:
        scores = scores / norms[None, :]
    if filter_items is not None:
        scores[:, filter_items] = NEG_MAX
    if qf_rows is not None:
        scores[qf_rows, qf_cols] = NEG_MAX
    return torch.topk(scores, k, dim=1)


def topk(items, query, k, item_norms=None, filter_query_items=None, filter_items=None,
         num_threads=0):
    """Return the top ``k`` scoring item (ids, scores) for each query row.

    Parameters
    ----------
    items : (N, F) torch tensor — item factors on the serving device
        (float32, or bfloat16 for 16-bit models).
    query : (Q, F) or (F,) tensor or array — query factors; rounded to the
        table's dtype before scoring.
    k : int
    item_norms : (N,) tensor or array, optional — scores are divided by these
    filter_query_items : csr_matrix, optional — per-query items to exclude
    filter_items : array_like, optional — items to exclude for all queries
    num_threads : ignored (API parity)

    Returns
    -------
    (ids, scores) : (Q, k) int32 / float32 numpy arrays. If k exceeds the
    number of items, the tail is padded with id -1 / score -FLT_MAX.
    """
    device = items.device
    query = torch.as_tensor(query, device=device)
    if query.dim() == 1:
        query = query.reshape(1, -1)
    q_rows = query.shape[0]
    n_items = items.shape[0]
    if k <= 0:
        return (np.empty((q_rows, 0), dtype=np.int32),
                np.empty((q_rows, 0), dtype=np.float32))
    k_eff = max(1, min(int(k), n_items))

    query = query.to(items.dtype)
    table = _scoring_table(items)
    norms = None
    if item_norms is not None:
        norms = torch.as_tensor(item_norms, dtype=torch.float32, device=device)
    fi = None
    if filter_items is not None and len(filter_items) > 0:
        fi = np.asarray(filter_items, dtype=np.int64)
        fi = torch.as_tensor(fi[(fi >= 0) & (fi < n_items)], device=device)

    chunk = max(1, min(q_rows, _score_budget_elements(device) // max(n_items, 1)))
    ids_out = np.empty((q_rows, k_eff), dtype=np.int32)
    scores_out = np.empty((q_rows, k_eff), dtype=np.float32)
    for start in range(0, q_rows, chunk):
        stop = min(start + chunk, q_rows)
        qf_rows = qf_cols = None
        if filter_query_items is not None:
            sub = filter_query_items[start:stop]
            cols = np.asarray(sub.indices, dtype=np.int64)
            rows = np.repeat(np.arange(stop - start, dtype=np.int64), np.diff(sub.indptr))
            keep = (cols >= 0) & (cols < n_items)
            qf_rows = torch.as_tensor(rows[keep], device=device)
            qf_cols = torch.as_tensor(cols[keep], device=device)
        vals, idx = _topk_core(table, query[start:stop], norms, qf_rows, qf_cols, fi, k_eff)
        ids_out[start:stop] = idx.to(torch.int32).cpu().numpy()
        scores_out[start:stop] = vals.cpu().numpy()
    if k_eff < k:
        pad = k - k_eff
        ids_out = np.concatenate(
            [ids_out, np.full((q_rows, pad), -1, dtype=np.int32)], axis=1)
        scores_out = np.concatenate(
            [scores_out, np.full((q_rows, pad), NEG_MAX, dtype=np.float32)], axis=1)
    return ids_out, scores_out
