"""Shared serving logic for matrix-factorization models.

The counterpart of ``implicit_tpu/models/mf_base.py`` for factor tables
resident on one device: recommend / recommend_all / similar_users /
similar_items with the filter_items / items= / filter_already_liked_items /
recalculate semantics, norm caches, and a device copy of each factor table
cached in the serving dtype (bfloat16 for 16-bit models, float32 otherwise).
Scalar queries are the batch path plus a squeeze at the edge, so batch and
scalar results agree by construction.

Factor matrices live on the host as numpy arrays (the public contract);
assigning ``user_factors`` / ``item_factors`` drops the device copy.
"""

import numpy as np
import torch
from scipy.sparse import csr_matrix

from .._device import resolve_device
from ..ops.topk import topk
from ..recommender_base import RecommenderBase


def _validate_subset(subset, total, what):
    """Normalize an items=/users= restriction array, bounds-checked."""
    subset = np.array(subset)
    if subset.max() >= total or subset.min() < 0:
        raise IndexError(f"Some {what} in the parameter are not in the model")
    return subset


def _validate_user_items(userid, user_items):
    """The recommend() contract checks on a per-user interaction matrix."""
    if not isinstance(user_items, csr_matrix):
        raise ValueError("user_items needs to be a CSR sparse matrix")
    count = 1 if np.isscalar(userid) else len(userid)
    if user_items.shape[0] != count:
        raise ValueError("user_items must contain 1 row for every user in userids")


def _positions_in_subset(items, query_items):
    """``query_items`` with its columns renumbered to positions in the sorted
    ``items`` subset; entries whose item is not in the subset are dropped."""
    coo = query_items.tocoo()
    pos = np.searchsorted(items, coo.col)
    inside = pos < len(items)
    inside[inside] = items[pos[inside]] == coo.col[inside]
    return csr_matrix(
        (coo.data[inside], (coo.row[inside], pos[inside])),
        shape=(query_items.shape[0], len(items)),
    )


class MatrixFactorizationBase(RecommenderBase):
    """Common recommend/similar_* functionality on top of factor matrices.

    Attributes
    ----------
    item_factors : ndarray — latent factors for each item
    user_factors : ndarray — latent factors for each user
    device : torch.device — where solves run and serving tables live
    """

    def __init__(self, num_threads=0, device="cuda"):
        self.device = resolve_device(device)
        self._item_factors = None
        self._user_factors = None
        self._user_norms, self._item_norms = None, None
        self._item_factors_dev = None
        self._user_factors_dev = None
        self.num_threads = num_threads

    # -- factor storage + device cache --------------------------------------

    @property
    def user_factors(self):
        return self._user_factors

    @user_factors.setter
    def user_factors(self, value):
        self._user_factors = value
        self._user_factors_dev = None

    @property
    def item_factors(self):
        return self._item_factors

    @item_factors.setter
    def item_factors(self, value):
        self._item_factors = value
        self._item_factors_dev = None

    def _serving_dtype(self):
        """bfloat16 for models with 16-bit factor storage, else float32.

        Scores are accumulated and returned in float32 either way.
        """
        dt = getattr(self, "dtype", None)
        if dt is not None and np.dtype(dt).itemsize == 2:
            return torch.bfloat16
        return torch.float32

    def _to_serving(self, factors):
        return torch.as_tensor(np.asarray(factors)).to(
            device=self.device, dtype=self._serving_dtype())

    def _user_factors_on_device(self):
        if self._user_factors_dev is None:
            self._user_factors_dev = self._to_serving(self._user_factors)
        return self._user_factors_dev

    def _item_factors_on_device(self):
        if self._item_factors_dev is None:
            self._item_factors_dev = self._to_serving(self._item_factors)
        return self._item_factors_dev

    def __getstate__(self):
        # device tensors stay out of pickles; the caches refill on use
        state = self.__dict__.copy()
        state["_item_factors_dev"] = None
        state["_user_factors_dev"] = None
        return state

    # -- norms ---------------------------------------------------------------

    def _norms_of(self, factors):
        # norms describe the table the GEMM scores: 16-bit models round
        # through bfloat16 first (so cosine self-similarity stays 1), then
        # accumulate in float32
        t = torch.as_tensor(np.asarray(factors))
        if t.dim() == 1:
            t = t.reshape(1, -1)
        t = t.to(self._serving_dtype()).float()
        norms = torch.linalg.vector_norm(t, dim=-1).numpy()
        norms[norms == 0] = 1e-10  # avoid divide-by-zero in similarity scoring
        return norms

    @property
    def user_norms(self):
        if self._user_norms is None:
            self._user_norms = self._norms_of(self.user_factors)
        return self._user_norms

    @property
    def item_norms(self):
        if self._item_norms is None:
            self._item_norms = self._norms_of(self.item_factors)
        return self._item_norms

    # -- recalculate hooks (overridden by models that support fold-in) -------

    def recalculate_user(self, userid, user_items):
        raise NotImplementedError("recalculate_user is not supported with this model")

    def recalculate_item(self, itemid, item_users):
        raise NotImplementedError("recalculate_item is not supported with this model")

    def _user_factor(self, userid, user_items, recalculate_user=False):
        if recalculate_user:
            return self.recalculate_user(userid, user_items)
        dev = self._user_factors_on_device()
        return dev[userid : userid + 1] if np.isscalar(userid) else dev[np.asarray(userid)]

    def _item_factor(self, itemid, item_users, recalculate_item=False):
        if recalculate_item:
            return self.recalculate_item(itemid, item_users)
        dev = self._item_factors_on_device()
        return dev[itemid : itemid + 1] if np.isscalar(itemid) else dev[np.asarray(itemid)]

    # -- recommend -------------------------------------------------------------

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
        if filter_already_liked_items or recalculate_user:
            _validate_user_items(userid, user_items)

        user = self._user_factor(userid, user_items, recalculate_user)

        if items is not None:
            if filter_items:
                raise ValueError("Can't set both items and filter_items in recommend call")
            N = min(N, len(items))
            items = _validate_subset(items, self.item_factors.shape[0], "itemids")
            items.sort()
            # subset tables score in the serving dtype, like the full table
            item_factors = self._to_serving(self.item_factors[items])
        else:
            item_factors = self._item_factors_on_device()

        filter_query_items = None
        if filter_already_liked_items:
            filter_query_items = user_items
            if items is not None:
                filter_query_items = _positions_in_subset(items, filter_query_items)

        ids, scores = topk(item_factors, user, N, filter_query_items=filter_query_items,
                           filter_items=filter_items)
        if np.isscalar(userid):
            ids, scores = ids[0], scores[0]
        if items is not None:
            ids = items[ids]
        return ids, scores

    recommend.__doc__ = RecommenderBase.recommend.__doc__

    def recommend_all(
        self,
        user_items,
        N=10,
        recalculate_user=False,
        filter_already_liked_items=True,
        filter_items=None,
        users_items_offset=0,
    ):
        """Deprecated: recommend for every user; use recommend with an array instead."""
        import warnings

        from scipy.sparse import lil_matrix

        warnings.warn(
            "recommend_all is deprecated. Use recommend with an array of userids instead",
            DeprecationWarning,
        )

        userids = np.arange(user_items.shape[0]) + users_items_offset
        if users_items_offset:
            adjusted = lil_matrix(
                (user_items.shape[0] + users_items_offset, user_items.shape[1]),
                dtype=user_items.dtype,
            )
            adjusted[users_items_offset:] = user_items
            user_items = adjusted.tocsr()

        ids, _ = self.recommend(
            userids,
            user_items,
            N=N,
            filter_already_liked_items=filter_already_liked_items,
            filter_items=filter_items,
            recalculate_user=recalculate_user,
        )
        return ids

    # -- similarity lookups ------------------------------------------------------

    def _similar(self, query_factor, query_norm, table, norms, N, filter_ids, subset,
                 host_factors):
        """Cosine top-N of ``query_factor`` against ``table`` (or its subset).

        ``table`` is the device copy of ``host_factors``; with ``subset``
        the candidates are ``host_factors[subset]`` in the serving dtype.
        """
        if subset is not None:
            table = self._to_serving(host_factors[subset])
            norms = norms[subset]
        ids, scores = topk(table, query_factor, N, item_norms=norms, filter_items=filter_ids)
        scalar = np.isscalar(query_norm)
        if scalar:
            ids, scores = ids[0], scores[0]
        # -FLT_MAX padding entries stay sentinels (dividing them overflows)
        np.divide(scores, query_norm if scalar else query_norm[:, None],
                  out=scores, where=ids >= 0)
        if subset is not None:
            # short rows pad with id -1: keep it rather than wrapping around
            ids = np.where(ids >= 0, subset[ids], -1)
        return ids, scores

    def similar_users(self, userid, N=10, filter_users=None, users=None):
        norms = self.user_norms
        if users is not None:
            if filter_users:
                raise ValueError("Can't set both users and filter_users in similar_users call")
            users = _validate_subset(users, self.user_factors.shape[0], "userids")
        return self._similar(
            self.user_factors[userid], norms[userid], self._user_factors_on_device(), norms,
            N, filter_users, users, self.user_factors)

    similar_users.__doc__ = RecommenderBase.similar_users.__doc__

    def similar_items(
        self, itemid, N=10, recalculate_item=False, item_users=None, filter_items=None, items=None
    ):
        factor = self._item_factor(itemid, item_users, recalculate_item)
        norms = self.item_norms

        if recalculate_item:
            # freshly solved factors aren't covered by the cached norms
            if np.isscalar(itemid):
                norm = np.linalg.norm(factor)
                norm = norm if norm != 0 else 1e-10
            else:
                norm = np.linalg.norm(factor, axis=1)
                norm[norm == 0] = 1e-10
        else:
            norm = norms[itemid]

        if items is not None:
            if filter_items:
                raise ValueError("Can't set both items and filter_items in similar_items call")
            items = _validate_subset(items, self.item_factors.shape[0], "itemids")

        return self._similar(factor, norm, self._item_factors_on_device(), norms, N,
                             filter_items, items, self.item_factors)

    similar_items.__doc__ = RecommenderBase.similar_items.__doc__

    def to_gpu(self):
        """API parity with the reference's CPU->GPU conversion: the identity."""
        return self

    def to_cpu(self):
        """API parity with the reference's GPU->CPU conversion: the identity."""
        return self

    def _check_fit_errors(self):
        self._check_factors(self.user_factors, self.item_factors)
