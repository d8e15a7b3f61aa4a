"""Faiss-backed approximate serving: the counterpart of
``implicit_tpu/ann/faiss.py``, serving the port's models.

Requires the optional ``faiss`` package, imported when the indexes are
built. IVFFlat inner-product indexes: one over the raw item factors for
recommend, one over an L2-normalized copy for cosine similar-items.
"""

import logging

import numpy as np

from .base import ANNWrapperBase

log = logging.getLogger("implicit_tpu_torch")


class FaissModel(ANNWrapperBase):
    """Approximate serving of a factorization model through Faiss IVF indexes.

    Parameters
    ----------
    model : MatrixFactorizationBase
    nlist : int, optional — number of IVF cells
    nprobe : int, optional — cells to probe at query time
    use_gpu : bool, optional — use faiss GPU indexes if available
    approximate_similar_items / approximate_recommend : bool, optional
    """

    def __init__(
        self,
        model,
        approximate_similar_items=True,
        approximate_recommend=True,
        nlist=400,
        nprobe=20,
        use_gpu=False,
    ):
        super().__init__(model, approximate_similar_items, approximate_recommend)
        self.similar_items_index = None
        self.recommend_index = None
        self.nlist = nlist
        self.nprobe = nprobe
        self.use_gpu = use_gpu
        self._gpu_resources = None

    @property
    def _exact_fallback_count(self):
        # faiss GPU indexes can't return >=1024 results per query; serve
        # those exactly
        return 1024 if self.use_gpu else None

    def _build_indexes(self, item_factors):
        import faiss  # delayed: optional dependency

        item_factors = np.ascontiguousarray(item_factors, dtype=np.float32)
        n_items, factors = item_factors.shape
        nlist = min(self.nlist, max(1, n_items // 39))

        if self.use_gpu:
            if not hasattr(faiss, "StandardGpuResources"):
                raise ValueError(
                    "use_gpu=True requires the faiss GPU build (faiss-gpu); "
                    "the installed faiss has no StandardGpuResources"
                )
            self._gpu_resources = faiss.StandardGpuResources()

        def build(matrix):
            if self.use_gpu:
                index = faiss.GpuIndexIVFFlat(
                    self._gpu_resources, factors, nlist, faiss.METRIC_INNER_PRODUCT
                )
            else:
                quantizer = faiss.IndexFlat(factors)
                index = faiss.IndexIVFFlat(
                    quantizer, factors, nlist, faiss.METRIC_INNER_PRODUCT
                )
            index.train(matrix)
            index.add(matrix)
            index.nprobe = self.nprobe
            return index

        if self.approximate_recommend:
            log.debug("Building faiss recommendation index")
            self.recommend_index = build(item_factors)

        if self.approximate_similar_items:
            log.debug("Building faiss similar items index")
            norms = np.linalg.norm(item_factors, axis=1)
            norms[norms == 0] = 1e-10
            self.similar_items_index = build(
                np.ascontiguousarray((item_factors.T / norms).T, dtype=np.float32)
            )

    def _query_similar(self, factor, count):
        norm = np.linalg.norm(factor)
        norm = norm if norm != 0 else 1e-10
        query = np.ascontiguousarray(factor / norm, dtype=np.float32).reshape(1, -1)
        scores, ids = self.similar_items_index.search(query, count)
        return ids[0], scores[0]

    def _query_recommend(self, user_factor, count):
        query = np.ascontiguousarray(user_factor, dtype=np.float32).reshape(1, -1)
        scores, ids = self.recommend_index.search(query, count)
        return ids[0], scores[0]
