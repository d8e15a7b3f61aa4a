"""NMSLib-backed approximate serving: the counterpart of
``implicit_tpu/ann/nmslib.py``, serving the port's models.

Requires the optional ``nmslib`` package, imported when the indexes are
built. HNSW cosine indexes over the item factors (zero-norm rows dropped —
nmslib hangs on them) and over the inner-product-augmented factors.
"""

import logging

import numpy as np

from ..utils import augment_inner_product_matrix
from .base import ANNWrapperBase

log = logging.getLogger("implicit_tpu_torch")


class NMSLibModel(ANNWrapperBase):
    """Approximate serving of a factorization model through NMSLib indexes.

    Parameters
    ----------
    model : MatrixFactorizationBase
    method : str, optional — the NMSLib method ('hnsw' by default)
    index_params : dict, optional — passed to createIndex
    query_params : dict, optional — passed to setQueryTimeParams
    approximate_similar_items / approximate_recommend : bool, optional
    """

    def __init__(
        self,
        model,
        approximate_similar_items=True,
        approximate_recommend=True,
        method="hnsw",
        index_params=None,
        query_params=None,
    ):
        super().__init__(model, approximate_similar_items, approximate_recommend)
        self.similar_items_index = None
        self.recommend_index = None
        self.max_norm = None
        self.method = method
        self.index_params = index_params or {"M": 16, "post": 0, "efConstruction": 400}
        self.query_params = query_params or {"ef": 90}
        self._show_progress = True

    def fit(self, Cui, show_progress=True, callback=None):
        self._show_progress = show_progress
        super().fit(Cui, show_progress, callback)

    def _build_indexes(self, item_factors):
        import nmslib  # delayed: optional dependency

        def build(matrix, ids=None):
            index = nmslib.init(method=self.method, space="cosinesimil")
            if ids is not None:
                index.addDataPointBatch(matrix, ids=ids)
            else:
                index.addDataPointBatch(matrix)
            index.createIndex(self.index_params, print_progress=self._show_progress)
            index.setQueryTimeParams(self.query_params)
            return index

        if self.approximate_similar_items:
            log.debug("Building nmslib similar items index")
            norms = np.linalg.norm(item_factors, axis=1)
            nonzero = np.arange(item_factors.shape[0])[norms > 0]
            self.similar_items_index = build(item_factors[norms > 0], ids=nonzero)

        if self.approximate_recommend:
            log.debug("Building nmslib recommendation index")
            self.max_norm, augmented = augment_inner_product_matrix(item_factors)
            self.recommend_index = build(augmented)

    def _query_similar(self, factor, count):
        ids, dist = self.similar_items_index.knnQuery(factor, count)
        return np.array(ids), 1.0 - np.array(dist)

    def _query_recommend(self, user_factor, count):
        query = np.append(user_factor, 0)
        ids, dist = self.recommend_index.knnQuery(query, count)
        # cosine distance -> rescaled inner product
        scaling = self.max_norm * np.linalg.norm(query)
        return np.array(ids), scaling * (1.0 - np.array(dist))
