"""The port's host-side helpers against the JAX package's: splits, ranking
metrics and result utilities. All numpy on both sides, so results must be
exactly equal (metrics to float64 rounding)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from implicit_tpu import evaluation as jeval
from implicit_tpu import utils as jutils
from implicit_tpu_torch import evaluation as teval
from implicit_tpu_torch import utils as tutils
from implicit_tpu_torch.datasets import synthetic as tsynth

torch.set_num_threads(2)


def _ratings(seed=0):
    m = sp.random(120, 90, density=0.08, random_state=np.random.RandomState(seed),
                  format="csr", dtype=np.float32)
    m.data = (m.data * 5 + 1).astype(np.float32)
    m.data[::17] *= -1  # a few negative ("disliked") entries
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_test_split_matches_jax(seed):
    m = _ratings(seed)
    got = teval.train_test_split(m, 0.7, random_state=seed)
    want = jeval.train_test_split(m, 0.7, random_state=seed)
    for g, w in zip(got, want):
        assert (g != w).nnz == 0 and g.shape == w.shape


@pytest.mark.parametrize("K,train_only", [(1, 0.0), (2, 0.2)])
def test_leave_k_out_split_matches_jax(K, train_only):
    m = _ratings(3)
    got = teval.leave_k_out_split(m, K=K, train_only_size=train_only, random_state=7)
    want = jeval.leave_k_out_split(m, K=K, train_only_size=train_only, random_state=7)
    for g, w in zip(got, want):
        assert (g != w).nnz == 0


def test_ranking_metrics_match_jax():
    from implicit_tpu.models.als import AlternatingLeastSquares as JaxALS
    from implicit_tpu_torch.convert import als_from_numpy, numpy_params

    plays = tsynth.generate_synthetic(300, 200, 6000, seed=4)
    train, test = teval.train_test_split(plays, 0.8, random_state=1)
    jmodel = JaxALS(factors=16, iterations=3, random_state=5)
    jmodel.fit(train, show_progress=False)
    model = als_from_numpy(numpy_params(jmodel), device="cpu")
    got = teval.ranking_metrics_at_k(model, train, test, K=10, show_progress=False)
    want = jeval.ranking_metrics_at_k(jmodel, train, test, K=10, show_progress=False)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    for name in ("precision_at_k", "mean_average_precision_at_k", "ndcg_at_k", "AUC_at_k"):
        assert getattr(teval, name)(model, train, test, K=5, show_progress=False) == \
            pytest.approx(getattr(jeval, name)(jmodel, train, test, K=5, show_progress=False))


def test_synthetic_data_matches_jax():
    from implicit_tpu.datasets import synthetic as jsynth

    got = tsynth.generate_synthetic(500, 300, 8000, seed=3)
    want = jsynth.generate_synthetic(500, 300, 8000, seed=3)
    assert (got != want).nnz == 0
    assert (tsynth.get_synthetic_clustered() != jsynth.get_synthetic_clustered()).nnz == 0


def test_result_utilities_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 20, size=(6, 12)).astype(np.int32)
    scores = rng.random((6, 12)).astype(np.float32)
    for queryid, i, s in ((np.arange(6), ids, scores), (3, ids[3], scores[3])):
        got = tutils._filter_items_from_results(queryid, i, s, [1, 2, 5], 8)
        want = jutils._filter_items_from_results(queryid, i, s, [1, 2, 5], 8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def scalar(query, N=10, user_items=None):
        k = int(query) % 4 + 1  # short rows pad with -1 / -FLT_MAX
        return np.arange(k) + query, np.linspace(1, 0, k, dtype=np.float32)

    likes = sp.csr_matrix(np.eye(5, dtype=np.float32))
    for a, b in zip(tutils._batch_call(scalar, np.arange(5), N=3, user_items=likes),
                    jutils._batch_call(scalar, np.arange(5), N=3, user_items=likes)):
        np.testing.assert_array_equal(a, b)
    m = _ratings(5)
    assert list(tutils.nonzeros(m, 4)) == list(jutils.nonzeros(m, 4))
    for seed in (3, np.random.RandomState(2)):
        a = tutils.check_random_state(seed).random(4)
        b = jutils.check_random_state(seed if isinstance(seed, int) else np.random.RandomState(2))
        np.testing.assert_array_equal(a, b.random(4))
