"""Abstract interface shared by every recommendation model.

The counterpart of ``implicit_tpu/recommender_base.py``: ``fit``,
``recommend``, ``similar_users``, ``similar_items``, ``save``/``load`` plus
the NaN guard that raises :class:`ModelFitError` after a diverged fit.
"""

import functools
import warnings
from abc import ABCMeta, abstractmethod

import numpy as np


class ModelFitError(Exception):
    """Raised when fitting produced invalid (NaN) factors."""


class _loader:
    """``load`` bound to the class, and to the instance when there is one.

    ``Model.load(path, device=...)`` builds a model on ``device`` (default
    ``"cuda"``); ``model.load(path)`` builds it on ``model``'s own device, so
    a round trip through ``save``/``load`` stays where the model was.
    """

    def __init__(self, func):
        self.func = func
        functools.update_wrapper(self, func)

    def __get__(self, obj, cls):
        return functools.partial(self.func, cls, obj)


class RecommenderBase(metaclass=ABCMeta):
    """Defines a common interface for all recommendation models."""

    @abstractmethod
    def fit(self, user_items, show_progress=True, callback=None):
        """Trains the model on a sparse matrix of user/item/confidence.

        Parameters
        ----------
        user_items : csr_matrix
            Sparse matrix of shape (number_of_users, number_of_items). Nonzero
            entries are items liked by each user, values are the confidence
            that the item is liked.
        show_progress : bool, optional
            Whether to show a progress bar during fitting.
        callback : Callable, optional
            Called every epoch with (epoch, elapsed, loss) arguments.
        """

    @abstractmethod
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
        """Recommends the top N items for a user or a batch of users.

        Parameters
        ----------
        userid : Union[int, array_like]
            The userid or array of userids to calculate recommendations for.
        user_items : csr_matrix
            Sparse matrix with one row per entry in ``userid`` holding the
            liked items for that user. Used for filtering already-liked items
            and for ``recalculate_user``.
        N : int, optional
            The number of results to return.
        filter_already_liked_items : bool, optional
            When true, don't return items present in ``user_items``.
        filter_items : array_like, optional
            Extra item ids to filter out of the output for every user.
        recalculate_user : bool, optional
            When true, recalculate the user representation from ``user_items``
            instead of using stored user factors.
        items : array_like, optional
            When set, rank only the items in this array. Cannot be combined
            with ``filter_items``.

        Returns
        -------
        tuple
            (itemids, scores). 1-D arrays of length N for a scalar userid,
            2-D arrays with one row per user for an array of userids.
        """

    @abstractmethod
    def similar_users(self, userid, N=10, filter_users=None, users=None):
        """Calculates the most similar users to a userid or array of userids.

        Returns a tuple of (userids, scores).
        """

    @abstractmethod
    def similar_items(
        self, itemid, N=10, recalculate_item=False, item_users=None, filter_items=None, items=None
    ):
        """Calculates the most similar items to an itemid or array of itemids.

        Returns a tuple of (itemids, scores).
        """

    @abstractmethod
    def save(self, file):
        """Saves the model to a file in numpy ``.npz`` format."""

    @_loader
    def load(cls, instance, fileobj_or_path, device=None) -> "RecommenderBase":
        """Loads a model saved with :meth:`save` (by either package).

        The model is built on ``device``; by default on the calling
        instance's device, or ``"cuda"`` when called on the class.
        """
        if device is None:
            device = instance.device if instance is not None else "cuda"
        if isinstance(fileobj_or_path, str) and not fileobj_or_path.endswith(".npz"):
            fileobj_or_path = fileobj_or_path + ".npz"
        with np.load(fileobj_or_path, allow_pickle=False) as data:
            ret = cls(device=device)
            for k, v in data.items():
                if k == "dtype":
                    v = np.dtype(str(v))
                elif v.shape == ():
                    v = v.item()
                setattr(ret, k, v)
            return ret

    def rank_items(self, userid, user_items, selected_items, recalculate_user=False):
        """Deprecated: use recommend with the ``items`` parameter instead."""
        warnings.warn(
            "rank_items is deprecated. Use recommend with the 'items' parameter instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.recommend(
            userid,
            user_items,
            recalculate_user=recalculate_user,
            items=selected_items,
            filter_already_liked_items=False,
        )

    @staticmethod
    def _check_factors(user_factors, item_factors):
        is_nan = np.any(np.isnan(user_factors), axis=None)
        is_nan |= np.any(np.isnan(item_factors), axis=None)
        if is_nan:
            raise ModelFitError("NaN encountered in factors")
