"""The port's item-item models: the shared contract suite, npz files and
``convert`` parameters carried across from the JAX package and back.

The behavioural contract of ``tests/test_models_common.py`` runs here with
the port's Cosine, TF-IDF, BM25 and EASE models at ``conftest.py``'s
settings (``device="cpu"``), through this module's own ``model_factory``
fixture; the three ``*_pipelined`` tests are left out (pipelined serving is
not ported). The contract's ``isinstance(model, ItemItemRecommender)``
names the JAX class, so the fixture widens it to both packages' classes.
"""

import io

import numpy as np
import pytest
import test_models_common
import torch
from conftest import get_checkerboard
from test_models_common import (  # noqa: F401  (collected here with the port's factories)
    test_dtype,
    test_evaluation,
    test_fit_callback,
    test_fit_non_csr_matrix,
    test_fit_ordering,
    test_invalid_user_items,
    test_pickle,
    test_pickle_unfitted_model,
    test_rank_items,
    test_rank_items_batch,
    test_recalculate_user,
    test_recommend,
    test_recommend_batch,
    test_serialization,
    test_serialization_without_fit,
    test_similar_items,
    test_similar_items_batch,
    test_similar_items_filter,
    test_similar_users,
    test_similar_users_batch,
    test_similar_users_filter,
    test_zero_length_row,
)

import implicit_tpu.ease as jease
import implicit_tpu.nearest_neighbours as jnn
from implicit_tpu_torch import convert, ease
from implicit_tpu_torch import nearest_neighbours as nn
from implicit_tpu_torch.utils import ParameterWarning

torch.set_num_threads(2)

# conftest.py's settings, on the CPU
PORT_FACTORIES = {
    "cosine": lambda: nn.CosineRecommender(K=50, device="cpu"),
    "tfidf": lambda: nn.TFIDFRecommender(K=50, device="cpu"),
    "bm25": lambda: nn.BM25Recommender(K=50, device="cpu"),
    "ease": lambda: ease.EASERecommender(K=50, regularization=1.0, device="cpu"),
}

# (port class, JAX class, non-default hyper-parameters) by family
FAMILIES = {
    "cosine": (nn.CosineRecommender, jnn.CosineRecommender, dict(K=7)),
    "tfidf": (nn.TFIDFRecommender, jnn.TFIDFRecommender, dict(K=7)),
    "bm25": (nn.BM25Recommender, jnn.BM25Recommender, dict(K=7, K1=2.0, B=0.5)),
    "ease": (ease.EASERecommender, jease.EASERecommender,
             dict(K=7, regularization=3.5, binarize=False)),
}


@pytest.fixture(params=sorted(PORT_FACTORIES))
def model_factory(request):
    return PORT_FACTORIES[request.param]


@pytest.fixture(autouse=True)
def _port_classes(monkeypatch):
    # the contract tests name the JAX package's warning and base classes
    monkeypatch.setattr(test_models_common, "ParameterWarning", ParameterWarning)
    monkeypatch.setattr(test_models_common, "ItemItemRecommender",
                        (jnn.ItemItemRecommender, nn.ItemItemRecommender))


def _plays():
    rng = np.random.default_rng(2)
    dense = (rng.random((80, 40)) < 0.2) * rng.integers(1, 5, (80, 40))
    from scipy.sparse import csr_matrix

    return csr_matrix(dense.astype(np.float64))


def _assert_same_model(got, want, plays):
    for key in want._save_args():
        assert getattr(got, key) == getattr(want, key), key
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got.similarity, field),
                                      getattr(want.similarity, field))
    users = np.arange(0, 80, 3)
    got_ids, got_scores = got.recommend(users, plays[users], N=5)
    want_ids, want_scores = want.recommend(users, plays[users], N=5)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-12)
    np.testing.assert_array_equal(got.similar_items(np.arange(40), N=5)[0],
                                  want.similar_items(np.arange(40), N=5)[0])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_saved_npz_loads_in_the_port(family):
    port_cls, jax_cls, kwargs = FAMILIES[family]
    plays = _plays()
    ref = jax_cls(**kwargs)
    ref.fit(plays, show_progress=False)
    buf = io.BytesIO()
    ref.save(buf)
    buf.seek(0)
    model = port_cls.load(buf, device="cpu")
    assert type(model) is port_cls and model.device == torch.device("cpu")
    _assert_same_model(model, ref, plays)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_saved_npz_loads_in_jax(family):
    port_cls, jax_cls, kwargs = FAMILIES[family]
    plays = _plays()
    model = port_cls(device="cpu", **kwargs)
    model.fit(plays, show_progress=False)
    buf = io.BytesIO()
    model.save(buf)
    buf.seek(0)
    _assert_same_model(jax_cls.load(buf), model, plays)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_convert_round_trip_and_back_to_jax(family):
    port_cls, jax_cls, kwargs = FAMILIES[family]
    plays = _plays()
    ref = jax_cls(**kwargs)
    ref.fit(plays, show_progress=False)
    params = convert.numpy_params(ref)
    assert set(params) == set(kwargs) | {"shape", "data", "indptr", "indices"}
    model = convert.item_item_from_numpy(port_cls.__name__, params, device="cpu")
    assert type(model) is port_cls
    _assert_same_model(model, ref, plays)
    back = convert.numpy_params(model)
    assert back.keys() == params.keys()
    for key in params:
        np.testing.assert_array_equal(back[key], params[key])
    # an unfitted model carries its hyper-parameters only
    empty = convert.item_item_from_numpy(port_cls.__name__, dict(kwargs), device="cpu")
    assert empty.similarity is None and convert.numpy_params(empty) == kwargs
    # the port's parameters build the JAX model's twin (its save/load layout)
    buf = io.BytesIO()
    np.savez(buf, **back)
    buf.seek(0)
    _assert_same_model(jax_cls.load(buf), model, plays)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cuda_without_a_card_raises(family, monkeypatch):
    port_cls = FAMILIES[family][0]
    buf = io.BytesIO()
    port_cls(device="cpu").save(buf)
    buf.seek(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_cls()
    with pytest.raises(RuntimeError, match="cuda"):
        port_cls.load(buf)  # on the class, load builds on "cuda" by default


def test_checkerboard_precision_at_1():
    from scipy.sparse import csr_matrix

    from implicit_tpu_torch.evaluation import precision_at_k

    user_items = get_checkerboard(50)
    for factory in PORT_FACTORIES.values():
        model = factory()
        model.fit(user_items, show_progress=False)
        assert precision_at_k(model, user_items, csr_matrix(np.eye(50)), K=1,
                              show_progress=False) == 1
