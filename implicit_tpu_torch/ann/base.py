"""Shared skeleton for ANN serving wrappers.

The counterpart of ``implicit_tpu/ann/base.py``. Every wrapper (Annoy /
NMSLib / Faiss / the on-device IVF index) trains the inner factorization
model, builds one index for cosine similar-items and one for inner-product
recommend, then serves scalar queries with over-fetching to survive
post-filtering, falling back to the exact model when approximation is
disabled. Only the index construction and the raw query differ per
library: subclasses implement those hooks.
"""

import numpy as np
import torch
from scipy.sparse import csr_matrix

from ..recommender_base import RecommenderBase
from ..utils import _batch_call, _filter_items_from_results


def _host_rows(factors):
    """Query factors as a float32 host array (the port's models gather
    stored factors on their device)."""
    if isinstance(factors, torch.Tensor):
        return factors.float().cpu().numpy()
    return np.asarray(factors)


class ANNWrapperBase(RecommenderBase):
    """Approximate serving on top of a trained factorization model."""

    # search-size ceiling past which the wrapper serves exactly instead
    # (e.g. faiss GPU indexes can't return >=1024 results); None = no ceiling
    _exact_fallback_count = None

    def __init__(self, model, approximate_similar_items=True, approximate_recommend=True):
        self.model = model
        self.approximate_similar_items = approximate_similar_items
        self.approximate_recommend = approximate_recommend

    def _over_search_limit(self, count):
        return self._exact_fallback_count is not None and count >= self._exact_fallback_count

    # ---- subclass hooks -------------------------------------------------
    def _build_indexes(self, item_factors):
        raise NotImplementedError

    def _query_similar(self, factor, count):
        """Raw cosine-space query -> (ids, similarity_scores)."""
        raise NotImplementedError

    def _query_recommend(self, user_factor, count):
        """Raw inner-product-space query -> (ids, scores)."""
        raise NotImplementedError

    # ---- shared serving --------------------------------------------------
    def fit(self, Cui, show_progress=True, callback=None):
        self.model.fit(Cui, show_progress, callback)
        self._build_indexes(np.asarray(self.model.item_factors, dtype=np.float32))

    def similar_items(
        self, itemid, N=10, recalculate_item=False, item_users=None, filter_items=None, items=None
    ):
        if items is not None and self.approximate_similar_items:
            raise NotImplementedError("using an items filter isn't supported with ANN lookup")

        if not self.approximate_similar_items:
            return self.model.similar_items(
                itemid, N, recalculate_item=recalculate_item, item_users=item_users,
                filter_items=filter_items, items=items,
            )

        if not np.isscalar(itemid):
            return _batch_call(
                self.similar_items, itemid, N=N, recalculate_item=recalculate_item,
                item_users=item_users, filter_items=filter_items,
            )

        count = N + (len(filter_items) if filter_items is not None else 0)
        if self._over_search_limit(count):
            return self.model.similar_items(
                itemid, N, recalculate_item=recalculate_item, item_users=item_users,
                filter_items=filter_items,
            )

        factor = _host_rows(self.model._item_factor(itemid, item_users, recalculate_item))
        if factor.ndim != 1:
            factor = np.squeeze(factor)

        ids, scores = self._query_similar(factor, count)

        if filter_items is not None:
            ids, scores = _filter_items_from_results(itemid, ids, scores, filter_items, N)
        return ids, scores

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
        if (filter_already_liked_items or recalculate_user) and not isinstance(
            user_items, csr_matrix
        ):
            raise ValueError("user_items needs to be a CSR sparse matrix")

        if items is not None and self.approximate_recommend:
            raise NotImplementedError("using a 'items' list with ANN search isn't supported")

        if not self.approximate_recommend:
            return self.model.recommend(
                userid, user_items, N=N,
                filter_already_liked_items=filter_already_liked_items,
                filter_items=filter_items, recalculate_user=recalculate_user, items=items,
            )

        if not np.isscalar(userid):
            return _batch_call(
                self.recommend, userid, user_items=user_items, N=N,
                filter_already_liked_items=filter_already_liked_items,
                filter_items=filter_items, recalculate_user=recalculate_user, items=items,
            )

        # over-fetch so the post-filter still leaves N results
        count = N
        if filter_items is not None:
            count += len(filter_items)
            filter_items = np.array(filter_items)
        if filter_already_liked_items:
            liked = user_items[0].indices
            filter_items = np.append(filter_items, liked) if filter_items is not None else liked
            count += len(liked)

        if self._over_search_limit(count):
            # filter_items may already include the liked items here; the
            # exact model filters them again, which is harmless
            return self.model.recommend(
                userid, user_items, N=N,
                filter_already_liked_items=filter_already_liked_items,
                filter_items=filter_items,
                recalculate_user=recalculate_user,
            )

        user = _host_rows(self.model._user_factor(userid, user_items, recalculate_user))

        ids, scores = self._query_recommend(np.squeeze(user), count)

        if filter_items is not None:
            ids, scores = _filter_items_from_results(userid, ids, scores, filter_items, N)
        return ids, scores

    def similar_users(self, userid, N=10, filter_users=None, users=None):
        raise NotImplementedError(
            "similar_users isn't implemented for ANN wrappers "
            "(call self.model.similar_users for the exact path)"
        )

    def save(self, file):
        raise NotImplementedError(".save isn't implemented for ANN wrappers yet")

    @classmethod
    def load(cls, file):
        raise NotImplementedError(".load isn't implemented for ANN wrappers yet")
