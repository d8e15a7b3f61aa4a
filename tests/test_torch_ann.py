"""The port's Annoy, NMSLib and Faiss wrappers (``implicit_tpu_torch/ann``)
with ``tests/test_ann.py``'s fake index libraries.

None of the three libraries is installed; the fakes return exact angular or
inner-product results, so the wrappers' own logic is what is tested: the
index inputs, over-fetching for filters, post-filter trimming, distance
rescaling and the exact fallbacks, on the port's models (``device="cpu"``),
and the port's wrappers against the JAX package's on the same factors
(ids equal, scores within 1e-5: the fakes compute in float64, the models'
exact paths in float32).
"""

import sys
import types

import numpy as np
import pytest
import torch
from conftest import get_checkerboard
from test_ann import _FakeAnnoyIndex, fake_annoy, fake_faiss  # noqa: F401  (fixtures)

from implicit_tpu_torch import convert
from implicit_tpu_torch.als import AlternatingLeastSquares

torch.set_num_threads(2)


def _als(**kw):
    return AlternatingLeastSquares(factors=16, random_state=3, device="cpu", **kw)


def _fitted_annoy_model():
    from implicit_tpu_torch.ann.annoy import AnnoyModel

    likes = get_checkerboard(50)
    model = AnnoyModel(_als(), n_trees=5)
    model.fit(likes, show_progress=False)
    return model, likes


def test_annoy_recommend_matches_exact(fake_annoy):
    model, likes = _fitted_annoy_model()
    assert isinstance(model.recommend_index, _FakeAnnoyIndex)
    for userid in range(10):
        ids, scores = model.recommend(userid, likes[userid], N=1)
        exact_ids, exact_scores = model.model.recommend(userid, likes[userid], N=1)
        assert ids[0] == exact_ids[0]
        assert scores[0] == pytest.approx(exact_scores[0], rel=0.05)


def test_annoy_similar_items(fake_annoy):
    model, _ = _fitted_annoy_model()
    ids, scores = model.similar_items(4, N=5)
    assert ids[0] == 4  # itself first in cosine space
    assert all(i % 2 == 0 for i in ids)  # checkerboard parity
    assert scores[0] == pytest.approx(1.0, abs=1e-4)


def test_annoy_filters(fake_annoy):
    model, likes = _fitted_annoy_model()
    ids, _ = model.recommend(0, likes[0], N=3, filter_items=[0, 2])
    assert not {0, 2}.intersection(ids)
    ids, _ = model.similar_items(4, N=3, filter_items=[4])
    assert 4 not in ids


def test_annoy_batch_falls_back_to_loop(fake_annoy):
    model, likes = _fitted_annoy_model()
    userids = np.arange(6)
    ids, _ = model.recommend(userids, likes[userids], N=2)
    assert ids.shape == (6, 2)
    for i, u in enumerate(userids):
        np.testing.assert_array_equal(ids[i], model.recommend(int(u), likes[int(u)], N=2)[0])
    sim, _ = model.similar_items(np.arange(4), N=3)
    for i in range(4):
        np.testing.assert_array_equal(sim[i], model.similar_items(i, N=3)[0])


def test_annoy_exact_fallback_paths(fake_annoy):
    from implicit_tpu_torch.ann.annoy import AnnoyModel

    likes = get_checkerboard(50)
    model = AnnoyModel(_als(), approximate_recommend=False, approximate_similar_items=False)
    model.fit(likes, show_progress=False)
    assert model.recommend_index is None and model.similar_items_index is None
    ids, _ = model.recommend(1, likes[1], N=1)
    assert ids[0] == 1
    np.testing.assert_array_equal(model.similar_items(3, N=4, items=np.arange(10))[0],
                                  model.model.similar_items(3, N=4, items=np.arange(10))[0])


def test_annoy_factory_constructs_wrapper(fake_annoy):
    from implicit_tpu_torch.ann.annoy import AnnoyModel
    from implicit_tpu_torch.approximate_als import AnnoyAlternatingLeastSquares

    model = AnnoyAlternatingLeastSquares(factors=8, random_state=0, n_trees=3, device="cpu")
    assert isinstance(model, AnnoyModel) and model.n_trees == 3
    likes = get_checkerboard(20)
    model.fit(likes, show_progress=False)
    assert len(model.recommend(2, likes[2], N=1)[0]) == 1


def test_annoy_matches_the_jax_wrapper(fake_annoy):
    from implicit_tpu.ann.annoy import AnnoyModel as JaxAnnoy
    from implicit_tpu.models.als import AlternatingLeastSquares as JaxALS
    from implicit_tpu_torch.ann.annoy import AnnoyModel

    likes = get_checkerboard(40)
    jax_inner = JaxALS(factors=16, random_state=3)
    jax_inner.fit(likes, show_progress=False)
    jmodel = JaxAnnoy(jax_inner, n_trees=5)
    model = AnnoyModel(convert.als_from_numpy(convert.numpy_params(jax_inner), device="cpu"),
                       n_trees=5)
    for wrapper in (jmodel, model):
        wrapper._build_indexes(np.asarray(wrapper.model.item_factors, dtype=np.float32))
    assert model.max_norm == jmodel.max_norm
    for u in range(0, 40, 7):
        got = model.recommend(u, likes[u], N=4, filter_items=[1])
        want = jmodel.recommend(u, likes[u], N=4, filter_items=[1])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    got, want = model.similar_items(np.arange(5), N=3), jmodel.similar_items(np.arange(5), N=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


class _FakeNMSLibIndex:
    """Exact cosine index with nmslib's API surface (distance 1 - cos)."""

    def __init__(self, method, space):
        assert space == "cosinesimil"
        self.method = method

    def addDataPointBatch(self, matrix, ids=None):
        self._mat = np.asarray(matrix, dtype=np.float64)
        self._ids = np.arange(len(matrix)) if ids is None else np.asarray(ids)

    def createIndex(self, params, print_progress=False):
        norms = np.linalg.norm(self._mat, axis=1)
        assert (norms > 0).all(), "nmslib hangs on zero rows"
        self._unit = self._mat / norms[:, None]
        self.index_params = params

    def setQueryTimeParams(self, params):
        self.query_params = params

    def knnQuery(self, vec, k):
        v = np.asarray(vec, dtype=np.float64)
        dist = 1.0 - self._unit @ (v / max(np.linalg.norm(v), 1e-12))
        order = np.argsort(dist, kind="stable")[:k]
        return self._ids[order], dist[order]


@pytest.fixture
def fake_nmslib(monkeypatch):
    mod = types.ModuleType("nmslib")
    mod.init = lambda method, space: _FakeNMSLibIndex(method, space)
    monkeypatch.setitem(sys.modules, "nmslib", mod)
    return mod


def test_nmslib_recommend_and_similar_items(fake_nmslib):
    from implicit_tpu_torch.ann.nmslib import NMSLibModel
    from implicit_tpu_torch.approximate_als import NMSLibAlternatingLeastSquares

    likes = get_checkerboard(50)
    model = NMSLibAlternatingLeastSquares(factors=16, random_state=3, device="cpu",
                                          index_params={"M": 8}, query_params={"ef": 10})
    assert isinstance(model, NMSLibModel)
    model.fit(likes, show_progress=False)
    assert model.recommend_index.index_params == {"M": 8}
    assert model.similar_items_index.query_params == {"ef": 10}
    for userid in range(0, 50, 9):
        ids, scores = model.recommend(userid, likes[userid], N=2)
        exact_ids, exact_scores = model.model.recommend(userid, likes[userid], N=2)
        assert ids[0] == exact_ids[0]
        assert scores[0] == pytest.approx(exact_scores[0], rel=0.05)
    ids, scores = model.similar_items(6, N=4, filter_items=[8])
    assert ids[0] == 6 and 8 not in ids and scores[0] == pytest.approx(1.0, abs=1e-4)


def test_nmslib_drops_zero_rows(fake_nmslib):
    from implicit_tpu_torch.ann.nmslib import NMSLibModel

    inner = _als()
    rng = np.random.default_rng(0)
    inner.user_factors = rng.standard_normal((10, 16)).astype(np.float32)
    inner.item_factors = rng.standard_normal((12, 16)).astype(np.float32)
    inner.item_factors[5] = 0
    model = NMSLibModel(inner)
    model._build_indexes(inner.item_factors)
    assert 5 not in model.similar_items_index._ids
    assert len(model.recommend_index._ids) == 12
    ids, _ = model.similar_items(2, N=11)
    assert 5 not in ids and ids[0] == 2


def test_faiss_recommend_matches_exact(fake_faiss):
    from implicit_tpu_torch.ann.faiss import FaissModel

    likes = get_checkerboard(50)
    model = FaissModel(_als())
    assert model._exact_fallback_count is None
    model.fit(likes, show_progress=False)
    ids, _ = model.recommend(7, likes[7], N=1)
    assert ids[0] == 7
    ids, scores = model.similar_items(10, N=3)
    assert ids[0] == 10 and scores[0] == pytest.approx(1.0, abs=1e-5)


def test_faiss_use_gpu_without_gpu_build_raises(fake_faiss):
    from implicit_tpu_torch.ann.faiss import FaissModel

    model = FaissModel(_als(), use_gpu=True)
    assert model._exact_fallback_count == 1024
    with pytest.raises(ValueError, match="faiss-gpu"):
        model.fit(get_checkerboard(20), show_progress=False)


def test_faiss_gpu_large_count_serves_exactly(fake_faiss):
    # faiss GPU indexes can't return >=1024 results: the wrapper serves
    # those from the exact model
    from implicit_tpu_torch.ann.faiss import FaissModel
    from implicit_tpu_torch.approximate_als import FaissAlternatingLeastSquares

    likes = get_checkerboard(40)
    model = FaissAlternatingLeastSquares(factors=8, random_state=1, device="cpu", nlist=3)
    assert isinstance(model, FaissModel) and model.nlist == 3
    model.fit(likes, show_progress=False)
    model.use_gpu = True  # a GPU wrapper, post-fit
    # broken indexes: if the fallback does not engage, these raise
    model.recommend_index = model.similar_items_index = None
    ids, _ = model.recommend(3, likes[3], N=1030)
    np.testing.assert_array_equal(ids, model.model.recommend(3, likes[3], N=1030)[0])
    ids, _ = model.similar_items(2, N=1500)
    np.testing.assert_array_equal(ids, model.model.similar_items(2, N=1500)[0])
