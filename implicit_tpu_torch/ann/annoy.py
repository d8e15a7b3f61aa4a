"""Annoy-backed approximate serving: the counterpart of
``implicit_tpu/ann/annoy.py``, serving the port's models.

Requires the optional ``annoy`` package, imported when the indexes are
built. Two angular indexes are built at fit time: one over the raw item
factors (cosine similar-items) and one over the inner-product-augmented
factors — the "Xbox" Euclidean transformation — for recommend.
"""

import logging

import numpy as np

from ..utils import augment_inner_product_matrix
from .base import ANNWrapperBase

log = logging.getLogger("implicit_tpu_torch")


class AnnoyModel(ANNWrapperBase):
    """Approximate serving of a factorization model through Annoy indexes.

    Parameters
    ----------
    model : MatrixFactorizationBase
        The trained factorization model supplying the factors
    n_trees : int, optional
        Trees in the Annoy index (more = higher precision)
    search_k : int, optional
        Nodes to inspect at query time (-1 = auto)
    approximate_similar_items / approximate_recommend : bool, optional
    """

    def __init__(
        self,
        model,
        approximate_similar_items=True,
        approximate_recommend=True,
        n_trees=50,
        search_k=-1,
    ):
        super().__init__(model, approximate_similar_items, approximate_recommend)
        self.similar_items_index = None
        self.recommend_index = None
        self.max_norm = None
        self.n_trees = n_trees
        self.search_k = search_k

    def _build_indexes(self, item_factors):
        import annoy  # delayed: optional dependency

        def build(matrix):
            index = annoy.AnnoyIndex(matrix.shape[1], "angular")
            for i, row in enumerate(matrix):
                index.add_item(i, row)
            index.build(self.n_trees)
            return index

        if self.approximate_similar_items:
            log.debug("Building annoy similar items index")
            self.similar_items_index = build(item_factors)

        if self.approximate_recommend:
            log.debug("Building annoy recommendation index")
            self.max_norm, augmented = augment_inner_product_matrix(item_factors)
            self.recommend_index = build(augmented)

    def _query_similar(self, factor, count):
        ids, dist = self.similar_items_index.get_nns_by_vector(
            factor, count, search_k=self.search_k, include_distances=True
        )
        # angular distance -> cosine similarity
        return np.array(ids), 1 - (np.array(dist) ** 2) / 2

    def _query_recommend(self, user_factor, count):
        query = np.append(user_factor, 0)
        ids, dist = self.recommend_index.get_nns_by_vector(
            query, count, include_distances=True, search_k=self.search_k
        )
        # euclidean -> cosine -> rescale back to inner product
        scaling = self.max_norm * np.linalg.norm(query)
        return np.array(ids), scaling * (1 - (np.array(dist) ** 2) / 2)
