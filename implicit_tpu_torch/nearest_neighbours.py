"""Item-item nearest-neighbour models (Cosine / TF-IDF / BM25) on one card
or a mesh.

The counterpart of ``implicit_tpu/nearest_neighbours.py``, with the same
names. Fitting computes, for every item, the top-K most similar items under
the weighted inner product AᵀA; serving scores users' liked-items rows
against the stored similarity matrix.

The similarity build has two routes, picked per fit by an estimated-cost
rule (:func:`_device_knn_wins`, whose constants were measured on an H100):

- "host": the fused sparse product and top-K of the port's
  ``native/packer.cpp`` (OpenMP over item rows, float64), the JAX package's
  own C++ built with its flags, so both packages store the same similarity
  bit for bit;
- "device": a dense float32 item gramian built on the card from densified
  user chunks (``S += DᵀD``, cuBLAS in full float32), then ``torch.topk``
  over row blocks; with ``mesh=``, the gramian's rows shard over the mesh
  and each shard selects its own rows' top-K (``_dense_gramian_meshed``).

The JAX package composes this family from XLA ops and host C++; no Pallas
kernel lies on its path, so the port has no kernel of its own here. The
similarity stays a host scipy CSR of float64 (the public surface, and what
``save`` writes); ``recommend`` scores on the model's device against a
lazily uploaded copy, and ``similar_items`` reads the stored rows on the
host, as the JAX package does.
"""

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from . import tracing
from ._device import full_f32_matmul, resolve_device
from .models.bpr import _scatter_add
from .ops.topk import NEG_MAX, _score_budget_elements
from .parallel.mesh import check_mesh_arg, mesh_state, resolve_mesh
from .recommender_base import RecommenderBase, _loader
from .tracing import timed_step
from .utils import _batch_call, _filter_items_from_results, check_csr

_NEG_MAX64 = -np.finfo(np.float64).max

# the debug lines' prefix of the similarity build's steps, set-up and model
# steps alike (``tracing.timed_step``: "item-item fit <step> in <s> s")
_LINE = "item-item fit"


def _set_up_step(step, device):
    """A set-up step of the similarity build (span attr ``stage`` "fit
    set-up"): host work and copies."""
    return timed_step(step, device, line=_LINE)


def _model_step(step, device):
    """A model step of the similarity build (span attr ``stage`` "model
    step"): the card's arithmetic, with CUDA events on a CUDA ``device``."""
    return timed_step(step, device, stage="model step", line=_LINE)


# ---------------------------------------------------------------------------
# weighting transforms (host scipy, as in the JAX package)
# ---------------------------------------------------------------------------

def normalize(X):
    """L2-normalizes the rows of a sparse matrix."""
    X = sp.csr_matrix(X, copy=True)
    row_norm = np.sqrt(np.asarray(X.multiply(X).sum(axis=1)).ravel())
    scale = np.divide(1.0, row_norm, out=np.zeros_like(row_norm), where=row_norm > 0)
    return sp.diags(scale) @ X


def _idf(X):
    """log(N) - log1p(document frequency) per column, reference-compatible."""
    counts = np.bincount(X.tocoo().col, minlength=X.shape[1])
    return np.log(float(X.shape[0])) - np.log1p(counts)


def tfidf_weight(X):
    """Weights a sparse matrix by TF-IDF."""
    idf = _idf(X)
    X = sp.coo_matrix(X, copy=True)
    X.data = np.sqrt(X.data) * idf[X.col]
    return X


def bm25_weight(X, K1=100, B=0.8):
    """Weighs each row of a sparse matrix X by BM25 weighting."""
    idf = _idf(X)
    X = sp.coo_matrix(X, copy=True)

    row_sums = np.ravel(X.sum(axis=1))
    length_norm = (1.0 - B) + B * row_sums / row_sums.mean()

    X.data = X.data * (K1 + 1.0) / (K1 * length_norm[X.row] + X.data) * idf[X.col]
    return X


# ---------------------------------------------------------------------------
# similarity construction
# ---------------------------------------------------------------------------

def all_pairs_knn(
    user_items, K=100, show_progress=True, num_threads=0, method="auto", mesh=None,
    device="cuda",
):
    """Returns the top K nearest neighbours for every item, as a COO matrix.

    ``user_items`` is the (weighted) users×items matrix; similarity is the
    inner product of item columns (rows of AᵀA), K-sparsified per row.

    ``method``: "host" runs the fused native sparse product (cost ∝ the sum
    of squared user degrees); "device" builds the dense gramian on
    ``device`` (cost ∝ items² × users); "auto" picks by estimated cost
    (:func:`_device_knn_wins`; on a CPU ``device`` always the host).
    "device" never runs the host route: a catalog over
    ``_DEVICE_KNN_MAX_ITEMS`` items or a negative weight raises instead.
    ``device`` is only resolved where the device route may run, and naming
    CUDA without a card raises.

    ``mesh`` (a ``parallel.Mesh``, or an int n: ``parallel.create_mesh(n,
    device)``) runs the device route over the mesh: the gramian's rows
    shard over it (:func:`_dense_gramian_meshed`), dividing its flops and
    each device's share of it by the mesh size, so the item cap rises by
    √D (the JAX package's rules, counted in shards). The host route ignores
    it, and it is resolved only where the device route may run.
    """
    check_mesh_arg(mesh)
    if method not in ("auto", "host", "device"):
        raise ValueError(f"method must be 'auto', 'host' or 'device', got {method!r}")
    user_items = check_csr(user_items)
    if method != "host":
        mesh = resolve_mesh(mesh, device)
        device = resolve_device(device) if mesh is None else mesh.devices[0]
    n_shards = 1 if mesh is None else mesh.size
    item_cap = _device_knn_item_cap(n_shards)
    if method == "auto":
        method = ("device" if _device_knn_wins(user_items, device, num_threads, n_shards)
                  else "host")
    if method == "device":
        if user_items.shape[1] > item_cap:
            raise ValueError(
                f"method='device' holds a dense {user_items.shape[1]}^2 "
                f"similarity gramian in device memory; catalogs over "
                f"{item_cap} items must use method='host' "
                "(the output-sparsity-aware sparse product, which is also faster "
                "there: its cost scales with co-occurring pairs, not "
                "items^2 x users)"
            )
        if user_items.nnz and user_items.data.min() < 0:
            raise ValueError(
                "method='device' keeps only positive similarities (the dense "
                "gramian cannot distinguish no-co-occurrence from similarity "
                "0); matrices with negative weights must use method='host'"
            )
        return _all_pairs_knn_device(user_items, K, device, mesh)
    return _all_pairs_knn_host(user_items, K, num_threads)


def _all_pairs_knn_host(user_items, K, num_threads=0):
    """Fused AᵀA + top-K through the native sparse product.

    One pass per item row with a dense per-thread accumulator: the sparse
    product is never materialized (``native/packer.cpp:knn_all_pairs``).
    Falls back to blocked scipy products and the native per-row top-K when
    the native library isn't built.
    """
    from . import native

    n_items = user_items.shape[1]
    item_users = user_items.T.tocsr()
    item_users.sort_indices()

    fused = native.knn_all_pairs(item_users, user_items, K, num_threads)
    if fused is not None:
        rows, cols, vals = fused
        return sp.coo_matrix((vals, (rows, cols)), shape=(n_items, n_items))

    # block rows so the intermediate sparse product stays memory-bounded
    block = max(1, min(n_items, int(3.2e7 // max(n_items, 1)) or 1))

    triples = []
    for start in range(0, n_items, block):
        sim = (item_users[start : start + block] @ user_items).tocsr()
        r, c, v = native.topk_rows(
            sim.indptr, sim.indices, sim.data.astype(np.float64), K, row_offset=start
        )
        if len(r):
            triples.append((r, c, v))

    if not triples:
        return sp.coo_matrix((n_items, n_items), dtype=np.float64)

    rows = np.concatenate([t[0] for t in triples])
    cols = np.concatenate([t[1] for t in triples])
    vals = np.concatenate([t[2] for t in triples])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n_items, n_items))


# the dense device gramian holds an items x items float32 matrix: the JAX
# package's cap (36k^2 float32 = 5.2 GB), kept so both packages route alike
_DEVICE_KNN_MAX_ITEMS = 36_000
# float32 elements per densified user chunk (2 GB; tests shrink it)
_DEVICE_KNN_DENSE_BYTES = 1 << 29
# elements of one row block of a dense top-K selection (128 MiB of float32;
# tests shrink it)
_TOPK_BLOCK_ELEMENTS = 1 << 25

# The cost rule's constants, measured by chip_smoke.py phase 6 on an NVIDIA
# H100 80GB HBM3 at 700 W (its host: 8 cores) at the ML-20M shape (138k x
# 27k, 12.4M nnz): the device route's fixed cost per call (launches,
# allocations, copies back; its wall on a 1000 x 1000 slice), the float32
# gramian's rate (densify and S += DᵀD, the upload excluded), the pageable
# upload of the CSR arrays, the per-row top-K sweep, the host route's pair
# expansions per second per OpenMP thread (its transpose included: 1.13e9
# expansions in 1.44 s on 8 threads), and the blocked scipy fallback's on
# one thread. At that shape the rule gives the device 3.79 s and the host
# 1.44 s (3.81 s and 1.44 s measured), so "auto" takes the host there.
_DEVICE_CALL_S = 3.4e-3
_GRAMIAN_FLOPS = 5.37e13
_H2D_BYTES_PER_S = 7.3e9
_TOPK_ELEMENTS_PER_S = 2.9e10
_HOST_PAIRS_PER_S = 9.8e7
_SCIPY_PAIRS_PER_S = 4.6e7


def _device_knn_item_cap(n_shards=1):
    """The device route's catalog cap over ``n_shards`` shards: each holds
    1/D of the gramian, so the cap rises by √D (the JAX package's rule)."""
    return int(_DEVICE_KNN_MAX_ITEMS * np.sqrt(n_shards))


def _device_knn_wins(csr, device, num_threads=0, n_shards=1):
    """Estimated-cost choice between the host sparse product and the
    device gramian; False on a CPU ``device``.

    Host cost ∝ Σ d_u² (the pair expansions of the fused product, at
    ``_HOST_PAIRS_PER_S`` per thread over ``knn_effective_threads``
    threads). Device cost: a fixed cost per call, 2·items²·users gramian
    flops, the upload of the CSR arrays (8 bytes per entry and per user) and
    the top-K sweep over items² elements. A mesh of ``n_shards`` divides the
    gramian and top-K terms by its size and raises the item cap by √D, as
    in the JAX package (on a virtual mesh too: the rule counts shards, not
    cards). Catalogs over the item cap and negative weights stay on the
    host, whose sparse product keeps exact zero and negative similarities.
    """
    from . import native

    if device.type != "cuda":
        return False
    users, items = csr.shape
    if items > _DEVICE_KNN_MAX_ITEMS * np.sqrt(n_shards) or items < 2 or csr.nnz == 0:
        return False
    if csr.data.min() < 0:
        return False
    if native.get_lib() is not None:
        host_rate = _HOST_PAIRS_PER_S * native.knn_effective_threads(items, num_threads)
    else:
        host_rate = _SCIPY_PAIRS_PER_S
    degrees = np.diff(csr.indptr).astype(np.float64)
    host_s = float(degrees @ degrees) / host_rate
    device_s = (
        _DEVICE_CALL_S
        + 2.0 * float(items) ** 2 * users / (_GRAMIAN_FLOPS * n_shards)
        + 8.0 * (csr.nnz + users) / _H2D_BYTES_PER_S
        + float(items) ** 2 / (_TOPK_ELEMENTS_PER_S * n_shards)
    )
    return device_s < host_s


def _dense_gramian_device(user_items, device):
    """Dense item gramian ``AᵀA`` (float32) on ``device``.

    The CSR's arrays are uploaded once (the set-up step "upload",
    :func:`_upload_csr`); each chunk of ``_DEVICE_KNN_DENSE_BYTES // items``
    users is sliced from them by ``indptr`` (int64 offsets, so no 2**31
    limit), densified into one reused (chunk, items) buffer with an
    accumulating scatter (a CSR may hold duplicate entries, which add, as in
    the JAX package's scatter; the sum's order is fixed:
    ``models.bpr._scatter_add``), and accumulated as ``S += DᵀD`` in full
    float32 (the model step "gramian", which holds no copy). Shared by the
    device KNN route and EASE (:mod:`implicit_tpu_torch.ease`); logs
    ``"item-item fit upload in ... s"`` and ``"item-item fit gramian in ...
    s"`` at debug level.
    """
    items = user_items.shape[1]
    with _set_up_step("upload", device):
        csr = _upload_csr(user_items, device)
    with _model_step("gramian", device):
        S = torch.zeros((items, items), dtype=torch.float32, device=device)
        for block in _densified_chunks(csr, items):
            with full_f32_matmul():
                S.addmm_(block.T, block)
    return S


def _upload_csr(user_items, device):
    """The CSR on ``device`` for :func:`_densified_chunks`: (its shape, the
    host's int64 ``indptr``, and each entry's row, column and value on the
    device)."""
    users = user_items.shape[0]
    indptr = np.asarray(user_items.indptr, dtype=np.int64)
    counts = torch.as_tensor(np.diff(indptr), device=device)
    cols = torch.as_tensor(np.asarray(user_items.indices, dtype=np.int32), device=device)
    vals = torch.as_tensor(np.asarray(user_items.data, dtype=np.float32), device=device)
    rows = torch.repeat_interleave(torch.arange(users, device=device), counts,
                                   output_size=int(indptr[-1]))
    return user_items.shape, indptr, rows, cols, vals


def _densified_chunks(csr, width):
    """Yields the uploaded CSR's (:func:`_upload_csr`) user chunks
    (``_DEVICE_KNN_DENSE_BYTES // items`` rows each) densified on its
    device as (rows, ``width``) float32 views of one reused buffer; columns
    past the matrix's stay zero. Each chunk is sliced from the arrays by
    ``indptr`` (int64 offsets), its entries added in the order
    ``models.bpr._scatter_add`` fixes, duplicates included, and counted by
    ``gramian.dense_chunks``."""
    (users, items), indptr, rows, cols, vals = csr
    chunk = max(8, min(users, _DEVICE_KNN_DENSE_BYTES // max(items, 1)))
    D = torch.empty((min(chunk, users), width), dtype=torch.float32, device=rows.device)
    for start in range(0, users, chunk):
        stop = min(start + chunk, users)
        lo, hi = int(indptr[start]), int(indptr[stop])
        block = D[: stop - start]
        block.zero_()
        flat = (rows[lo:hi] - start) * width + cols[lo:hi]
        _scatter_add(block.view(-1), flat, vals[lo:hi])
        tracing.count("gramian.dense_chunks")
        yield block


def _dense_gramian_meshed(user_items, mesh):
    """The dense item gramian ``AᵀA`` (float32) row-sharded over ``mesh``.

    Shard k owns rows ``[k·block, (k+1)·block)`` of S, ``block = ceil(items
    / D)``, as a (block, items) tensor on its device. Each user chunk is
    densified once per distinct device (:func:`_densified_chunks`), its
    columns padded to ``D·block`` so the last block's slice runs into
    zeros, and each shard accumulates ``S_k += D[:, rows_k]ᵀ D`` in full
    float32: the flops divide by D, and no collective runs. Returns the
    shards in shard order and ``block``; rows past ``items`` (in the last
    shards) are zero. Logs the steps "upload" (the CSR to each distinct
    device) and "gramian".
    """
    items = user_items.shape[1]
    block = max(1, -(-items // mesh.size))
    devices = mesh.distinct()
    with _set_up_step("upload", devices):
        csrs = [_upload_csr(user_items, d) for d in devices]
    with _model_step("gramian", devices):
        S = [torch.zeros((block, items), dtype=torch.float32, device=d) for d in mesh.devices]
        for blocks in zip(*(_densified_chunks(csr, mesh.size * block) for csr in csrs)):
            dense = dict(zip(devices, blocks))
            for k, d in enumerate(mesh.devices):
                with full_f32_matmul():
                    S[k].addmm_(dense[d][:, k * block:(k + 1) * block].T, dense[d][:, :items])
    return S, block


def _dense_topk_to_coo(S, K, keep="positive", fmt="coo"):
    """K-sparsifies a dense (items x items) device matrix into COO triples.

    ``torch.topk`` over row blocks (the model step "top-k"); ``keep``
    selects which of the K values survive: "positive" (similarity gramians:
    only co-occurring pairs carry signal) or "nonzero" (signed weight
    matrices, e.g. EASE). One copy back at the end (the set-up step "copy
    back", which also builds the host matrix, in the scipy format ``fmt``);
    the values come back as float64, as in the JAX package. Exact ties at
    the K-th value may select other columns than JAX's ``lax.top_k``, which
    prefers the lower index.
    """
    items = S.shape[0]
    k = min(K, items)
    if k <= 0:
        return sp.coo_matrix((items, items), dtype=np.float64).asformat(fmt)
    with _model_step("top-k", S.device):
        vals, cols = _topk_rows(S, k)
    with _set_up_step("copy back", S.device):
        return _topk_coo(vals, cols, items, keep).asformat(fmt)


def _topk_rows(S, k):
    """``torch.topk`` of every row of the (rows, items) device matrix ``S``,
    over row blocks, each counted by ``topk.library_selects``: (values,
    columns) on S's device."""
    n_rows, items = S.shape
    row_block = max(8, min(n_rows, _TOPK_BLOCK_ELEMENTS // max(items, 1)))
    vals = torch.empty((n_rows, k), dtype=S.dtype, device=S.device)
    cols = torch.empty((n_rows, k), dtype=torch.int64, device=S.device)
    for start in range(0, n_rows, row_block):
        stop = min(start + row_block, n_rows)
        vals[start:stop], cols[start:stop] = torch.topk(S[start:stop], k, dim=1)
        tracing.count("topk.library_selects")
    return vals, cols


def _topk_coo(vals, cols, items, keep):
    """The (items, items) COO of per-row top-k values and columns (device
    tensors with at least ``items`` rows; later rows are dropped), the
    values as float64, only those ``keep`` selects."""
    vals = vals.cpu().numpy()[:items].astype(np.float64)
    cols = cols.cpu().numpy()[:items]
    r, c = np.nonzero(vals > 0 if keep == "positive" else vals != 0)
    return sp.coo_matrix(
        (vals[r, c], (r.astype(np.int32), cols[r, c].astype(np.int32))),
        shape=(items, items),
    )


def _dense_topk_to_coo_meshed(S, items, K, mesh, keep="positive", fmt="coo"):
    """K-sparsifies a row-sharded matrix (``S[k]`` shard k's (block, items)
    rows on its device, :func:`_dense_gramian_meshed`) into COO triples:
    ``torch.topk`` on each shard's rows (the model step "top-k"), the
    results gathered in shard order on the host and the padding rows (past
    ``items``) dropped (the step "copy back"), ``keep`` and ``fmt`` as in
    :func:`_dense_topk_to_coo`."""
    k = min(K, items)
    if k <= 0:
        return sp.coo_matrix((items, items), dtype=np.float64).asformat(fmt)
    devices = mesh.distinct()
    with _model_step("top-k", devices):
        parts = [_topk_rows(Sk, k) for Sk in S]
    with _set_up_step("copy back", devices):
        return _topk_coo(torch.cat([v.cpu() for v, _ in parts]),
                         torch.cat([c.cpu() for _, c in parts]), items, keep).asformat(fmt)


def _all_pairs_knn_device(user_items, K, device, mesh=None):
    """Exact AᵀA top-K on ``device``: the dense gramian over densified
    chunks (:func:`_dense_gramian_device`), then :func:`_dense_topk_to_coo`;
    over ``mesh``, their row-sharded twins."""
    if mesh is not None:
        S, _ = _dense_gramian_meshed(user_items, mesh)
        return _dense_topk_to_coo_meshed(S, user_items.shape[1], K, mesh, keep="positive")
    S = _dense_gramian_device(user_items, device)
    return _dense_topk_to_coo(S, K, keep="positive")


# ---------------------------------------------------------------------------
# host serving helpers (the JAX package's formulation)
# ---------------------------------------------------------------------------

class NearestNeighboursScorer:
    """Scores a single user's liked-items row against a similarity CSR, on
    the host (scipy), as the JAX package's scorer does."""

    def __init__(self, similarity):
        self.similarity = similarity.tocsr()

    def recommend(self, indptr, indices, data, K=10, remove_own_likes=True):
        likes = sp.csr_matrix((data, indices, indptr), shape=(1, self.similarity.shape[0]))
        scores = (likes @ self.similarity).toarray().ravel()
        if remove_own_likes:
            scores[indices] = 0

        candidates = np.flatnonzero(scores)
        if len(candidates) > K:
            keep = np.argpartition(scores[candidates], -K)[-K:]
            candidates = candidates[keep]
        best = candidates[np.argsort(scores[candidates])[::-1]]
        return best.astype(np.int32), scores[best]


def _topk_rows_sorted(scores_csr, k):
    """Per-row top-k of a sparse score matrix on the host, sorted
    descending, padded.

    Returns (B, k) int32 ids padded with -1 and (B, k) float64 scores padded
    with -FLT_MAX: the JAX package's batch formulation, which the card's
    ``recommend`` is checked against.
    """
    from . import native

    n_rows = scores_csr.shape[0]
    ids = np.full((n_rows, k), -1, dtype=np.int32)
    out = np.full((n_rows, k), NEG_MAX, dtype=np.float64)
    r, c, v = native.topk_rows(
        scores_csr.indptr, scores_csr.indices, scores_csr.data.astype(np.float64), k
    )
    if len(r):
        order = np.lexsort((-v, r))  # group by row, descending score inside
        r, c, v = r[order], c[order], v[order]
        starts = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(r, minlength=n_rows), out=starts[1:])
        within = np.arange(len(r), dtype=np.int64) - starts[r]
        ids[r, within] = c
        out[r, within] = v
    return ids, out


def _drop_filtered(ids, scores, filter_items, limit=None):
    keep = np.isin(ids, filter_items, invert=True)
    ids, scores = ids[keep], scores[keep]
    if limit is not None:
        ids, scores = ids[:limit], scores[:limit]
    return ids, scores


def _restrict_to(ids, scores, items):
    """Keep only ids in ``items``; absent ones come back with -DBL_MAX scores."""
    keep = np.isin(ids, items)
    ids, scores = ids[keep], scores[keep]

    missing = items[np.isin(items, ids, invert=True)]
    if missing.size:
        ids = np.append(ids, missing)
        scores = np.append(scores, np.full(missing.size, _NEG_MAX64))
    return ids, scores


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

class ItemItemRecommender(RecommenderBase):
    """Base class for item-item nearest-neighbour recommender models.

    Parameters
    ----------
    K : int, optional
        Neighbours stored per item in the similarity matrix
    num_threads : int, optional
        Threads for the native host similarity build (0 = all cores)
    mesh : parallel.Mesh or int, optional
        Run the device similarity build over a mesh (:func:`all_pairs_knn`):
        the gramian's rows shard over it, and the device route's item cap
        rises by √D. Only fits that take the device route use it; serving
        stays on ``device``. An int n is ``parallel.create_mesh(n,
        device)``, resolved when the fit runs (n cards on CUDA, raising
        where fewer are visible; n virtual shards on the CPU).
    device : str or torch.device, optional
        Where the device similarity build and ``recommend``'s scoring run
        (default ``"cuda"``; naming CUDA without a card raises).

    Attributes
    ----------
    similarity : scipy.sparse.csr_matrix (float64) — the stored top-K
        similarity, on the host; assigning it drops the device copy.
    """

    def __init__(self, K=20, num_threads=0, mesh=None, device="cuda"):
        check_mesh_arg(mesh)
        self.device = resolve_device(device)
        self._similarity = None
        self._similarity_dev = None
        self.K = K
        self.num_threads = num_threads
        self.mesh = mesh

    @property
    def similarity(self):
        return self._similarity

    @similarity.setter
    def similarity(self, value):
        self._similarity = value
        self._similarity_dev = None

    @property
    def scorer(self):
        """A host scorer over the stored similarity (the JAX package's
        attribute); ``recommend`` scores on the model's device instead."""
        return None if self._similarity is None else NearestNeighboursScorer(self._similarity)

    def _weighted(self, counts):
        """Weighting transform applied before the similarity build."""
        return counts

    def fit(self, counts, show_progress=True, callback=None):
        """Computes and stores the K-sparsified item-item similarity matrix.

        Traced as one ``fit`` span (attr ``family`` "item-item"): the set-up
        step ``prepare`` (the input check and the weighting transform), then
        the device route's steps (:func:`all_pairs_knn`)."""
        if callback:
            raise NotImplementedError("callback isn't supported on ItemItemRecommender.fit")

        with tracing.span("fit", family="item-item", K=self.K) as fit_span:
            with _set_up_step("prepare", self.device):
                # warn about the user's input format here, then convert the
                # weighting transform's own coo/csc output silently
                counts = check_csr(counts)
                weighted = sp.csr_matrix(self._weighted(counts))
            fit_span.set(users=weighted.shape[0], items=weighted.shape[1], nnz=weighted.nnz)
            self.similarity = all_pairs_knn(
                weighted, self.K, show_progress=show_progress,
                num_threads=self.num_threads, mesh=self._fit_mesh(), device=self.device,
            ).tocsr()

    def _fit_mesh(self):
        """The model's ``mesh`` resolved on its device (a virtual mesh where
        the model was pickled with one), or None."""
        return resolve_mesh(getattr(self, "mesh", None), self.device,
                            getattr(self, "_mesh_virtual", False))

    # -- serving ----------------------------------------------------------------

    def _similarity_on_device(self):
        """The stored similarity's transpose as a float64 sparse CSR tensor
        on the model's device, uploaded at first use."""
        if self._similarity_dev is None:
            sim_t = self._similarity.T.tocsr()
            t = lambda a, dtype: torch.as_tensor(  # noqa: E731
                np.asarray(a, dtype=dtype), device=self.device)
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
                warnings.filterwarnings("ignore", "Sparse invariant checks are implicitly")
                self._similarity_dev = torch.sparse_csr_tensor(
                    t(sim_t.indptr, np.int64), t(sim_t.indices, np.int64),
                    t(sim_t.data, np.float64), size=sim_t.shape, check_invariants=False)
        return self._similarity_dev

    def _device_scores(self, likes, filter_liked):
        """Dense float64 ``likes @ similarity`` (rows, items) on the model's
        device: one sparse × dense product of the similarity's transpose and
        the densified likes; the liked positions zeroed when
        ``filter_liked``."""
        dev = self.device
        n_rows, items = likes.shape[0], self._similarity.shape[0]
        rows = torch.as_tensor(np.repeat(np.arange(n_rows, dtype=np.int64),
                                         np.diff(likes.indptr)), device=dev)
        cols = torch.as_tensor(np.asarray(likes.indices, dtype=np.int64), device=dev)
        dense_t = torch.zeros((items, n_rows), dtype=torch.float64, device=dev)
        _scatter_add(dense_t.view(-1), cols * n_rows + rows,
                     torch.as_tensor(np.asarray(likes.data, dtype=np.float64), device=dev))
        scores = torch.sparse.mm(self._similarity_on_device(), dense_t).T.contiguous()
        if filter_liked:
            scores[rows, cols] = 0.0
        return scores

    def recommend(
        self,
        userid,
        user_items,
        N=10,
        filter_already_liked_items=True,
        filter_items=None,
        recalculate_user=False,
        items=None,
    ):
        if not isinstance(user_items, sp.csr_matrix):
            raise ValueError("user_items needs to be a CSR sparse matrix")

        scalar = np.isscalar(userid)
        if not scalar and user_items.shape[0] != len(userid):
            raise ValueError("user_items must contain 1 row for every user in userids")
        if filter_items is not None and items is not None:
            raise ValueError("Can't specify both filter_items and items")
        if user_items.shape[1] != self._similarity.shape[0]:
            raise ValueError(
                f"user_items has {user_items.shape[1]} columns, the model "
                f"{self._similarity.shape[0]} items")

        if items is not None:
            if scalar:
                return self._recommend_restricted(
                    user_items, filter_already_liked_items, np.array(items)
                )
            # items= subsetting stays on the scalar path (rare, small subsets)
            return _batch_call(
                self.recommend,
                userid,
                user_items=user_items,
                N=N,
                score_dtype=np.float64,
                filter_already_liked_items=filter_already_liked_items,
                recalculate_user=recalculate_user,
                items=items,
            )

        # one device product scores the whole batch; scalar queries run
        # through the same path as a 1-row batch so batch == scalar
        ids, scores = self._recommend_batch(
            userid if not scalar else np.zeros(1),
            user_items,
            N,
            filter_already_liked_items,
            filter_items,
        )
        if scalar:
            ids, scores = ids[0], scores[0]
            valid = ids >= 0
            return ids[valid], scores[valid]
        return ids, scores

    recommend.__doc__ = RecommenderBase.recommend.__doc__

    def _recommend_batch(self, userids, user_items, N, filter_already_liked_items, filter_items):
        """All users of the batch at once on the model's device: the float64
        score product, then ``torch.topk`` over the nonzero scores (the
        candidates of the JAX package's sparse formulation), padded with id
        -1 / score -FLT_MAX, over-fetched by ``len(filter_items)`` and
        filtered on the host. Users are chunked so the scores and the
        densified likes fit ``ops.topk``'s score budget."""
        n_rows, items = user_items.shape[0], self._similarity.shape[0]
        fetch = N + (len(filter_items) if filter_items is not None else 0)
        k = min(fetch, items)
        ids = np.full((n_rows, fetch), -1, dtype=np.int32)
        out = np.full((n_rows, fetch), NEG_MAX, dtype=np.float64)
        # float64 scores and likes, each two float32 elements per value
        chunk = max(1, min(n_rows, _score_budget_elements(self.device) // (4 * max(items, 1))))
        for start in range(0, n_rows if k > 0 else 0, chunk):
            stop = min(start + chunk, n_rows)
            scores = self._device_scores(user_items[start:stop], filter_already_liked_items)
            scores.masked_fill_(scores == 0, -np.inf)  # not a candidate
            vals, idx = torch.topk(scores, k, dim=1)
            absent = vals == -np.inf
            ids[start:stop, :k] = idx.masked_fill_(absent, -1).cpu().numpy()
            out[start:stop, :k] = vals.masked_fill_(absent, NEG_MAX).cpu().numpy()
        if filter_items is not None:
            ids, out = _filter_items_from_results(userids, ids, out, filter_items, N)
        return ids[:, :N], out[:, :N]

    def _recommend_restricted(self, user_items, filter_already_liked_items, items):
        """Scalar ``items=`` ranking: score on the device, sort the nonzero
        scores, then restrict and pad the absentees on the host."""
        if items.max() >= self._similarity.shape[0] or items.min() < 0:
            raise IndexError("Some of selected itemids are not in the model")

        scores = self._device_scores(user_items, filter_already_liked_items)[0]
        candidates = torch.nonzero(scores).squeeze(1)
        vals, order = torch.sort(scores[candidates], descending=True, stable=True)
        ids = candidates[order].cpu().numpy().astype(np.int32)
        return _restrict_to(ids, vals.cpu().numpy(), items)

    def similar_items(
        self, itemid, N=10, recalculate_item=False, item_users=None, filter_items=None, items=None
    ):
        if recalculate_item:
            raise NotImplementedError("Recalculate_item isn't implemented")

        if not np.isscalar(itemid):
            return _batch_call(
                self.similar_items,
                itemid,
                N=N,
                score_dtype=np.float64,
                filter_items=filter_items,
                items=items,
            )

        if filter_items is not None and items is not None:
            raise ValueError("Can't specify both filter_items and items")

        if itemid >= self.similarity.shape[0]:
            return np.array([]), np.array([])

        row = self.similarity[itemid]
        ids, scores = row.indices, row.data

        if filter_items is not None:
            ids, scores = _drop_filtered(ids, scores, filter_items)
        elif items is not None:
            ids, scores = _restrict_to(ids, scores, np.asarray(items))

        order = np.argsort(scores)[::-1][:N]
        return ids[order], scores[order]

    similar_items.__doc__ = RecommenderBase.similar_items.__doc__

    def similar_users(self, userid, N=10, filter_users=None, users=None):
        raise NotImplementedError("similar_users isn't implemented for item-item recommenders")

    # -- persistence --------------------------------------------------------

    def __getstate__(self):
        # the device copy stays out of pickles; it refills on use. A Mesh is
        # stored as its size (``parallel.mesh.mesh_state``), as the factor
        # models store theirs
        state = self.__dict__.copy()
        state["_similarity_dev"] = None
        return mesh_state(state)

    def _save_args(self):
        """Hyperparameters persisted alongside the similarity matrix (the JAX
        package's npz keys); subclasses with more extend this."""
        return {"K": self.K}

    def save(self, fileobj_or_path):
        args = self._save_args()
        if self.similarity is not None:
            args.update(
                shape=self.similarity.shape,
                data=self.similarity.data,
                indptr=self.similarity.indptr,
                indices=self.similarity.indices,
            )
        np.savez(fileobj_or_path, **args)

    _MATRIX_KEYS = ("shape", "data", "indptr", "indices")

    @classmethod
    def _from_params(cls, params, device):
        """A model on ``device`` from the npz layout: hyper-parameters by
        name, the similarity from its CSR arrays when they are there."""
        ret = cls(device=device)
        for key, val in params.items():
            if key in cls._MATRIX_KEYS:
                continue
            val = np.asarray(val)
            setattr(ret, key, val.item() if val.ndim == 0 else val)
        if params.get("data") is not None:
            ret.similarity = sp.csr_matrix(
                (params["data"], params["indices"], params["indptr"]),
                shape=tuple(np.asarray(params["shape"])),
            )
        return ret

    @_loader
    def load(cls, instance, fileobj_or_path, device=None):
        """Loads a model saved with :meth:`save` (by either package), built
        on ``device``: by default the calling instance's, or ``"cuda"`` when
        called on the class."""
        if device is None:
            device = instance.device if instance is not None else "cuda"
        if isinstance(fileobj_or_path, str) and not fileobj_or_path.endswith(".npz"):
            fileobj_or_path = fileobj_or_path + ".npz"
        with np.load(fileobj_or_path, allow_pickle=False) as data:
            return cls._from_params({key: data[key] for key in data.files}, device)


class CosineRecommender(ItemItemRecommender):
    """An Item-Item Recommender on Cosine distances between items."""

    def _weighted(self, counts):
        # cosine similarity = dot product of column-normalized vectors
        return normalize(counts.T).T


class TFIDFRecommender(ItemItemRecommender):
    """An Item-Item Recommender on TF-IDF distances between items."""

    def _weighted(self, counts):
        return normalize(tfidf_weight(counts.T)).T


class BM25Recommender(ItemItemRecommender):
    """An Item-Item Recommender on BM25 distance between items."""

    def __init__(self, K=20, K1=1.2, B=0.75, num_threads=0, mesh=None, device="cuda"):
        super().__init__(K, num_threads, mesh=mesh, device=device)
        self.K1 = K1
        self.B = B

    def _save_args(self):
        # K1/B are fit-relevant: a loaded model's refit must weight the same
        return {**super()._save_args(), "K1": self.K1, "B": self.B}

    def _weighted(self, counts):
        return bm25_weight(counts.T, self.K1, self.B).T
