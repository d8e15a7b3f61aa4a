"""Carry model weights between the JAX package and the port.

Both packages save the same npz keys (factors or the similarity's CSR
arrays, and the hyper-parameters) per model family, so a file written by
``implicit_tpu``'s ``save`` loads with the port's ``load``, and the other
way round. These helpers do the same for in-memory parameters:
:func:`numpy_params` gives a model's weights and hyper-parameters as a dict
of numpy values, and :func:`als_from_numpy`, :func:`bpr_from_numpy`,
:func:`lmf_from_numpy` and :func:`item_item_from_numpy` build a port model
from such a dict (for example one read from a JAX model's attributes or
from its npz); :func:`ivf_from_numpy` builds the IVF wrapper, its indexes
and its inner model from the dict that ``TPUIVFModel.save`` writes.
"""

import numpy as np

from .ease import EASERecommender
from .models.als import AlternatingLeastSquares
from .models.bpr import BayesianPersonalizedRanking
from .models.lmf import LogisticMatrixFactorization
from .nearest_neighbours import BM25Recommender, CosineRecommender, TFIDFRecommender

# the npz layout both packages save (implicit_tpu/models/als.py:save); the
# BPR and LMF layouts are their classes' SAVE_KEYS
PARAM_KEYS = AlternatingLeastSquares.SAVE_KEYS

# by class name, which the two packages share
_KEYS = {cls.__name__: cls.SAVE_KEYS for cls in (
    AlternatingLeastSquares, BayesianPersonalizedRanking, LogisticMatrixFactorization)}

# the item-item family by class name: hyper-parameters from _save_args, the
# similarity as its CSR arrays (shape, data, indptr, indices)
_ITEM_ITEM = {cls.__name__: cls for cls in (
    CosineRecommender, TFIDFRecommender, BM25Recommender, EASERecommender)}


def numpy_params(model):
    """The model's save() contents as a dict (absent values left out).

    ``model`` may be either package's ALS, BPR, LMF, Cosine, TFIDF, BM25 or
    EASE model; factors and similarity arrays are copied.
    """
    if type(model).__name__ in _ITEM_ITEM:
        params = dict(model._save_args())
        sim = model.similarity
        if sim is not None:
            params.update(shape=np.array(sim.shape), data=np.array(sim.data),
                          indptr=np.array(sim.indptr), indices=np.array(sim.indices))
        return params
    params = {k: getattr(model, k, None) for k in _KEYS[type(model).__name__]}
    params["dtype"] = np.dtype(model.dtype).name
    for key in ("user_factors", "item_factors"):
        if params[key] is not None:
            params[key] = np.array(params[key])
    return {k: v for k, v in params.items() if v is not None}


def _from_numpy(cls, params, device):
    model = cls(device=device)
    for key, value in params.items():
        if key == "dtype":
            value = np.dtype(str(value))
        elif key.endswith("_factors"):
            value = np.array(value)
        elif isinstance(value, np.ndarray) and value.shape == ():
            value = value.item()
        setattr(model, key, value)
    return model


def als_from_numpy(params, device="cuda"):
    """A port AlternatingLeastSquares on ``device`` holding ``params``.

    ``params`` maps the npz keys to values; factors are copied.
    """
    return _from_numpy(AlternatingLeastSquares, params, device)


def bpr_from_numpy(params, device="cuda"):
    """A port BayesianPersonalizedRanking on ``device`` holding ``params``
    (the factors+1 layout, the user bias column pinned to 1)."""
    return _from_numpy(BayesianPersonalizedRanking, params, device)


def lmf_from_numpy(params, device="cuda"):
    """A port LogisticMatrixFactorization on ``device`` holding ``params``
    (the factors+2 layout)."""
    return _from_numpy(LogisticMatrixFactorization, params, device)


def item_item_from_numpy(cls_name, params, device="cuda"):
    """A port item-item model (``cls_name``: "CosineRecommender",
    "TFIDFRecommender", "BM25Recommender" or "EASERecommender") on
    ``device`` holding ``params``: its hyper-parameters and, when present,
    the similarity's ``shape``/``data``/``indptr``/``indices``."""
    return _ITEM_ITEM[cls_name]._from_params(params, device)


def ivf_from_numpy(arrays, device="cuda"):
    """A port ``TPUIVFModel`` on ``device`` from the dict that either
    package's ``TPUIVFModel.save`` writes: the inner model's fields under
    ``model__`` (its class by ``model_class``), the indexes under ``sim__``
    and ``rec__`` (reordered points, ids, centroids, starts, counts, n,
    cap), and the wrapper's settings."""
    from .ann.ivf import TPUIVFModel

    return TPUIVFModel.from_arrays(arrays, device)
