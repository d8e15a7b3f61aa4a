"""On-device IVF approximate serving — no external ANN library.

The counterpart of ``implicit_tpu/ann/ivf.py``: an inverted-file flat
index built and served on the model's device, the drop-in for
``FaissAlternatingLeastSquares(use_gpu=True)``.

Build: spherical k-means over the (normalized or inner-product-augmented)
item factors, as torch ops (:func:`_kmeans_run`): full-float32 assignment
products over row blocks, centroid sums by the port's fixed-order scatter
(``models.bpr._scatter_add``), so two builds of one seed give the same
bits. The items are then laid out cluster-contiguously, padded by one
``cap`` (the largest cluster) of zero rows, so cluster ``c`` is the rows
``starts[c] + arange(cap)``.

Query: score the query against all centroids, take the top ``n_probe``
clusters, gather their ``cap`` rows each, score them exactly in one batched
product, mask the rows past each cluster's count to -inf, and
``torch.topk`` the candidates. Everything after the centroid top-k is
exact, so recall depends only on how many clusters are probed — the
contract of IVF-flat.

Both serving spaces use the same machinery: cosine for ``similar_items``
(points L2-normalized) and inner product for ``recommend`` (the "Xbox"
augmentation of ``utils.augment_inner_product_matrix`` turns maximum inner
product search into cosine search).

The initial centroids are ``k`` distinct rows drawn on the host with
``np.random.default_rng(seed).choice(n, k, replace=False)``: the JAX
package draws them with ``jax.random.choice``, which torch cannot
reproduce, so :func:`_kmeans_run` takes the rows as an argument (the tests
pass the JAX draw through it). The index arrays save in the JAX package's
npz layout, so an index built by either package serves in the other.
"""

import io
import logging

import numpy as np
import torch
from scipy.sparse import csr_matrix

from .._device import full_f32_matmul, resolve_device
from ..models.bpr import _scatter_add
from ..ops.topk import _score_budget_elements, _upload
from ..utils import augment_inner_product_matrix, check_random_state
from .base import ANNWrapperBase

log = logging.getLogger("implicit_tpu_torch")

# score elements per assignment block of the k-means: (1 << 27) // k rows,
# the JAX package's block (512 MB of float32 scores)
_ASSIGN_BLOCK_ELEMENTS = 1 << 27


def _inner_model_class(name):
    """Resolves a saved inner-model class name to the port's class."""
    from ..models.als import AlternatingLeastSquares
    from ..models.bpr import BayesianPersonalizedRanking
    from ..models.lmf import LogisticMatrixFactorization

    classes = {
        cls.__name__: cls
        for cls in (AlternatingLeastSquares, BayesianPersonalizedRanking,
                    LogisticMatrixFactorization)
    }
    if name not in classes:
        raise ValueError(f"unknown inner model class {name!r} in saved index")
    return classes[name]


def _trim_rows(ids, scores, row_filters, N):
    """Per-row filter + trim of over-fetched batch results.

    Rows shorter than N pad with id -1 / score -FLT_MAX (the
    ``utils._batch_call`` contract).
    """
    B = len(ids)
    out_i = np.full((B, N), -1, np.int32)
    out_s = np.full((B, N), -np.finfo(np.float32).max, np.float32)
    for r in range(B):
        keep = ids[r] >= 0
        f = row_filters[r]
        if f is not None and len(f):
            keep &= ~np.isin(ids[r], f)
        sel = np.nonzero(keep)[0][:N]
        out_i[r, : len(sel)] = ids[r][sel]
        out_s[r, : len(sel)] = scores[r][sel]
    return out_i, out_s


def _initial_rows(n, k, seed):
    """The k distinct rows that start the k-means, drawn on the host."""
    return np.random.default_rng(seed).choice(n, k, replace=False)


def _kmeans_run(X, init, k, iters):
    """Spherical k-means on ``X``'s device; returns (centroids, assignment).

    ``X`` (n, f) float32 L2-normalized rows; ``init`` the k rows that start
    the centroids. The assignment runs over row blocks of
    ``_ASSIGN_BLOCK_ELEMENTS // k`` rows, each an argmax of a full-float32
    product, so the (n, k) score matrix is never whole (the JAX package's
    block size). Centroid sums use
    the fixed-order scatter, not ``index_add_``, whose CUDA atomics would let
    two builds of one seed differ. An empty cluster keeps its centroid.
    """
    n = X.shape[0]
    C = X[torch.as_tensor(np.array(init, dtype=np.int64), device=X.device)]
    block = max(1, min(n, _ASSIGN_BLOCK_ELEMENTS // max(k, 1)))

    def assign(C):
        out = torch.empty(n, dtype=torch.int64, device=X.device)
        for s in range(0, n, block):
            with full_f32_matmul():
                out[s : s + block] = torch.argmax(X[s : s + block] @ C.T, dim=1)
        return out

    for _ in range(iters):
        sums = torch.zeros_like(C)
        _scatter_add(sums, assign(C), X)
        norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
        C = torch.where(norms > 1e-12, sums / torch.clamp(norms, min=1e-12), C)
    return C, assign(C)


class _IVFIndex:
    """One searchable space: reordered points, centroids, cluster extents.

    Scores are plain dot products against the stored points: callers pick
    the metric by transforming points and queries (L2-normalized for
    cosine; inner-product-augmented for MIP). Cluster assignment always
    uses the normalized directions (spherical k-means).
    """

    def __init__(self, points, n_clusters, kmeans_iters, seed, device, init=None):
        n, f = points.shape
        self.device = device
        norms = np.linalg.norm(points, axis=1)
        normalized = points / np.maximum(norms[:, None], 1e-12)
        if init is None:
            init = _initial_rows(n, n_clusters, seed)
        C, assign = _kmeans_run(torch.as_tensor(normalized, device=device), init,
                                n_clusters, kmeans_iters)
        assign = assign.cpu().numpy()

        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=n_clusters)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        cap = int(counts.max()) if n else 1
        # cluster-contiguous layout padded by one cap of zero rows, so every
        # cluster's window of cap rows is in bounds; the tail rows are masked
        self._set(
            points=np.concatenate([points[order], np.zeros((cap, f), np.float32)]),
            ids=np.concatenate([order.astype(np.int32), np.full(cap, -1, np.int32)]),
            centroids=C, starts=starts.astype(np.int32), counts=counts.astype(np.int32),
            n=n, cap=cap)

    def _set(self, points, ids, centroids, starts, counts, n, cap):
        dev = self.device
        self.points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        self.ids = torch.as_tensor(ids).to(dev)
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32).to(dev)
        self.starts = torch.as_tensor(starts).to(dev)
        self.counts = torch.as_tensor(counts).to(dev)
        self.n, self.cap = int(n), int(cap)

    def to_arrays(self, prefix):
        """The index as host arrays under ``prefix``, in the JAX package's
        npz layout: reordered points, id permutation, centroids, cluster
        extents, ``n`` and ``cap``."""
        return {
            prefix + "points": self.points.cpu().numpy(),
            prefix + "ids": self.ids.cpu().numpy(),
            prefix + "centroids": self.centroids.cpu().numpy(),
            prefix + "starts": self.starts.cpu().numpy(),
            prefix + "counts": self.counts.cpu().numpy(),
            prefix + "n": self.n,
            prefix + "cap": self.cap,
        }

    @classmethod
    def from_arrays(cls, data, prefix, device):
        """Rebuilds an index on ``device`` from :meth:`to_arrays` output (of
        either package)."""
        index = cls.__new__(cls)
        index.device = device
        index._set(*(np.asarray(data[prefix + key])
                     for key in ("points", "ids", "centroids", "starts", "counts", "n", "cap")))
        return index

    def _k(self, count, n_probe):
        """(result width, clusters probed): the width is at most the
        candidates the probed clusters hold."""
        n_probe = min(n_probe, self.centroids.shape[0])
        return min(count, self.n, n_probe * self.cap), n_probe

    def _search_chunk(self, Q, k, n_probe):
        """Probed-cluster search of the (B, F) queries ``Q`` on the device
        -> (ids, scores), each (B, k)."""
        cap = self.cap
        qn = Q / torch.clamp(torch.linalg.vector_norm(Q, dim=1, keepdim=True), min=1e-12)
        with full_f32_matmul():
            _, clusters = torch.topk(qn @ self.centroids.T, n_probe, dim=1)
        within = torch.arange(cap, device=Q.device)
        rows = self.starts[clusters].long()[..., None] + within  # (B, p, cap)
        block = self.points[rows].reshape(Q.shape[0], -1, Q.shape[1])
        with full_f32_matmul():
            scores = torch.bmm(block, Q[:, :, None])[..., 0]  # (B, p * cap)
        valid = (within < self.counts[clusters][..., None]).reshape(Q.shape[0], -1)
        scores = torch.where(valid, scores, -torch.inf)
        bids = torch.where(valid, self.ids[rows].reshape(Q.shape[0], -1), -1)
        vals, idx = torch.topk(scores, k, dim=1)
        return torch.gather(bids, 1, idx), vals

    def search(self, query, count, n_probe):
        """Exact scores within the ``n_probe`` best clusters -> (ids, scores).

        Returns at most ``min(count, n_probe * cap)`` results: like any IVF,
        candidates outside the probed clusters are unseen.
        """
        ids, vals = self.search_batch(np.asarray(query, dtype=np.float32)[None, :], count,
                                      n_probe)
        keep = ids[0] >= 0
        return ids[0][keep], vals[0][keep]

    def search_batch(self, queries, count, n_probe, chunk=None):
        """Batched search -> (B, k) ids / scores, short rows padded with -1.

        Each query gathers an (n_probe, cap, F) block, so ``chunk`` (the
        queries per product) defaults from the score budget, as the JAX
        package sizes it: the budget over n_probe * cap * F, rounded down to
        a power of two and at most 256.
        """
        queries = _upload(torch.as_tensor(queries, dtype=torch.float32), self.device)
        k, n_probe = self._k(count, n_probe)
        if chunk is None:
            per_query = max(n_probe * self.cap * self.points.shape[1], 1)
            chunk = max(_score_budget_elements(self.device) // per_query, 1)
            chunk = min(1 << int(np.log2(chunk)), 256)
        parts = [self._search_chunk(queries[s0 : s0 + chunk], k, n_probe)
                 for s0 in range(0, queries.shape[0], chunk)]
        ids = torch.cat([i for i, _ in parts]).cpu().numpy()
        vals = torch.cat([v for _, v in parts]).cpu().numpy()
        return ids.astype(np.int32), vals


class TPUIVFModel(ANNWrapperBase):
    """Approximate serving of a factorization model through the on-device
    IVF index (the name is the JAX package's: the public surface stays).

    The index lives on the inner model's device.

    Parameters
    ----------
    model : MatrixFactorizationBase
        The trained factorization model supplying the factors
    n_clusters : int, optional
        Inverted lists (default ~2*sqrt(items), the usual IVF sizing)
    n_probe : int, optional
        Clusters searched per query (default n_clusters/8; raise for recall)
    kmeans_iters : int, optional
    random_state : int or None, optional
    approximate_similar_items / approximate_recommend : bool, optional
    """

    def __init__(
        self,
        model,
        approximate_similar_items=True,
        approximate_recommend=True,
        n_clusters=None,
        n_probe=None,
        kmeans_iters=15,
        random_state=None,
    ):
        super().__init__(model, approximate_similar_items, approximate_recommend)
        self.n_clusters = n_clusters
        self.n_probe = n_probe
        self.kmeans_iters = kmeans_iters
        self.random_state = random_state

    def _build_indexes(self, item_factors):
        n = item_factors.shape[0]
        k = self.n_clusters or max(1, min(n, int(2 * np.sqrt(n))))
        k = min(k, n)
        self._probe = self.n_probe or max(1, k // 8)
        rs = check_random_state(self.random_state)
        seed = int(rs.integers(0, 2**31))

        log.debug("Building IVF indexes: %d clusters over %d items", k, n)
        factors = np.asarray(item_factors, dtype=np.float32)
        device = self.model.device
        # each index builds only when its flag asks for it: the k-means is the
        # dominant construction cost
        self.similar_items_index = None
        self.recommend_index = None
        if self.approximate_similar_items:
            # cosine space: normalized points and queries, so the scores are
            # the cosine similarities
            norms = np.maximum(np.linalg.norm(factors, axis=1, keepdims=True), 1e-12)
            self.similar_items_index = _IVFIndex(factors / norms, k, self.kmeans_iters, seed,
                                                 device)
        if self.approximate_recommend:
            # inner-product space: the augmentation's extra column makes all
            # rows equal-norm, so cosine clustering is MIP clustering, and a
            # (user, 0) query's dot with an augmented row is the inner product
            extra = augment_inner_product_matrix(factors)[1]
            self.recommend_index = _IVFIndex(extra, k, self.kmeans_iters, seed + 1, device)

    def save(self, fileobj_or_path):
        """Saves the wrapper and its indexes to one ``.npz`` in the JAX
        package's layout: the inner model's fields under ``model__``, the
        indexes under ``sim__`` / ``rec__``."""
        if (getattr(self, "similar_items_index", None) is None
                and getattr(self, "recommend_index", None) is None):
            raise ValueError("cannot save an unfitted index — call fit first")
        buf = io.BytesIO()
        self.model.save(buf)
        buf.seek(0)
        args = {}
        with np.load(buf, allow_pickle=True) as inner:
            for key, value in inner.items():
                if value.dtype == object:
                    # e.g. a Generator random_state: an object array would
                    # make the file unreadable under allow_pickle=False, and
                    # a fitted model does not need the seed
                    continue
                args["model__" + key] = value
        if self.similar_items_index is not None:
            args.update(self.similar_items_index.to_arrays("sim__"))
        if self.recommend_index is not None:
            args.update(self.recommend_index.to_arrays("rec__"))
        args["model_class"] = type(self.model).__name__
        args["approximate_similar_items"] = self.approximate_similar_items
        args["approximate_recommend"] = self.approximate_recommend
        args["kmeans_iters"] = self.kmeans_iters
        args["probe"] = self._probe
        for key in ("n_clusters", "n_probe"):
            value = getattr(self, key)
            if value is not None:
                args[key] = value
        # only an int random_state persists (the seed only mattered for the build)
        if isinstance(self.random_state, (int, np.integer)):
            args["random_state"] = int(self.random_state)
        np.savez(fileobj_or_path, **args)

    @classmethod
    def load(cls, fileobj_or_path, device="cuda"):
        """Loads a wrapper saved by either package's ``save`` onto ``device``."""
        if isinstance(fileobj_or_path, str) and not fileobj_or_path.endswith(".npz"):
            fileobj_or_path = fileobj_or_path + ".npz"
        with np.load(fileobj_or_path, allow_pickle=False) as data:
            return cls.from_arrays(dict(data.items()), device)

    @classmethod
    def from_arrays(cls, data, device="cuda"):
        """The wrapper from the dict of arrays its ``save`` writes, with the
        inner model and the indexes on ``device``."""
        device = resolve_device(device)
        inner = _inner_model_class(str(data["model_class"]))(device=device)
        for key, value in data.items():
            if not key.startswith("model__"):
                continue
            name = key[len("model__"):]
            value = np.asarray(value)
            if name == "dtype":
                value = np.dtype(str(value))
            elif value.shape == ():
                value = value.item()
            setattr(inner, name, value)

        ret = cls(
            inner,
            approximate_similar_items=bool(data["approximate_similar_items"]),
            approximate_recommend=bool(data["approximate_recommend"]),
            n_clusters=int(data["n_clusters"]) if "n_clusters" in data else None,
            n_probe=int(data["n_probe"]) if "n_probe" in data else None,
            kmeans_iters=int(data["kmeans_iters"]),
            random_state=int(data["random_state"]) if "random_state" in data else None,
        )
        ret._probe = int(data["probe"])
        ret.similar_items_index = (_IVFIndex.from_arrays(data, "sim__", device)
                                   if "sim__centroids" in data else None)
        ret.recommend_index = (_IVFIndex.from_arrays(data, "rec__", device)
                               if "rec__centroids" in data else None)
        return ret

    def _query_similar(self, factor, count):
        q = factor / max(float(np.linalg.norm(factor)), 1e-12)
        return self.similar_items_index.search(q, count, self._probe)

    def _query_recommend(self, user_factor, count):
        query = np.append(user_factor.astype(np.float32), 0.0)
        return self.recommend_index.search(query, count, self._probe)

    # ---- batched serving ----------------------------------------------------
    # The wrapper base runs one scalar query per id (utils._batch_call);
    # arrays run here through one batched search per chunk instead.

    def similar_items(
        self, itemid, N=10, recalculate_item=False, item_users=None,
        filter_items=None, items=None,
    ):
        if (
            np.isscalar(itemid) or not self.approximate_similar_items
            or recalculate_item or items is not None
        ):
            return super().similar_items(
                itemid, N, recalculate_item=recalculate_item,
                item_users=item_users, filter_items=filter_items, items=items,
            )
        itemids = np.asarray(itemid)
        factors = np.asarray(self.model.item_factors, dtype=np.float32)[itemids]
        norms = np.maximum(np.linalg.norm(factors, axis=1, keepdims=True), 1e-12)
        count = N + (len(filter_items) if filter_items is not None else 0)
        ids, scores = self.similar_items_index.search_batch(factors / norms, count,
                                                            self._probe)
        filters = None if filter_items is None else np.asarray(filter_items)
        return _trim_rows(ids, scores, [filters] * len(itemids), N)

    def recommend(
        self, userid, user_items, N=10, filter_already_liked_items=True,
        filter_items=None, recalculate_user=False, items=None,
    ):
        if (
            np.isscalar(userid) or not self.approximate_recommend
            or recalculate_user or items is not None
        ):
            return super().recommend(
                userid, user_items, N=N,
                filter_already_liked_items=filter_already_liked_items,
                filter_items=filter_items, recalculate_user=recalculate_user,
                items=items,
            )
        if filter_already_liked_items and not isinstance(user_items, csr_matrix):
            raise ValueError("user_items needs to be a CSR sparse matrix")

        userids = np.asarray(userid)
        base = np.asarray(filter_items) if filter_items is not None else None
        row_filters = []
        count = N
        for r in range(len(userids)):
            f = base
            if filter_already_liked_items:
                liked = user_items[r].indices
                f = liked if f is None else np.append(f, liked)
            row_filters.append(f)
            if f is not None:
                count = max(count, N + len(f))

        user = np.asarray(self.model.user_factors, dtype=np.float32)[userids]
        queries = np.concatenate([user, np.zeros((len(userids), 1), np.float32)], axis=1)
        ids, scores = self.recommend_index.search_batch(queries, count, self._probe)
        return _trim_rows(ids, scores, row_filters, N)
