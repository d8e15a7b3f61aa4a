"""The port's EASE (``implicit_tpu_torch/ease.py``) against the JAX
package's ``implicit_tpu/ease.py`` and the float64 closed form.

Both packages solve in float32 (a gramian, a Cholesky factorization and an
inverse from it), so the weights are held to the float64 oracle at atol
2e-4, the JAX package's own bar (``tests/test_ease.py``), and to each other
at the same bar. Where ``X^T X + lam I`` is not positive definite the port
raises ``ModelFitError`` and the JAX package returns NaN weights (ROADMAP
C17).
"""

import io

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

import implicit_tpu.ease as jease
from implicit_tpu_torch import ease
from implicit_tpu_torch.recommender_base import ModelFitError

torch.set_num_threads(2)


def _dense_ease_oracle(X, lam):
    """Direct float64 transcription of the closed form (Steck 2019, eq. 8)."""
    X = np.asarray(X, dtype=np.float64)
    G = X.T @ X + lam * np.eye(X.shape[1])
    P = np.linalg.inv(G)
    B = -P / np.diag(P)[None, :]
    np.fill_diagonal(B, 0.0)
    return B


def _ease_similarity_oracle(X, lam):
    B = _dense_ease_oracle(X, lam)
    np.fill_diagonal(B, np.maximum(B.max(axis=1), 0.0) + 1.0)
    return B


def _binary(users, items, p, seed):
    return (np.random.default_rng(seed).random((users, items)) < p).astype(np.float32)


@pytest.mark.parametrize("lam", [3.0, 50.0])
@pytest.mark.parametrize("weighted", [False, True], ids=["binary", "weighted"])
def test_weights_match_jax_and_oracle(lam, weighted):
    X = _binary(60, 25, 0.2, seed=0)
    if weighted:
        X *= np.random.default_rng(1).integers(1, 6, X.shape).astype(np.float32)
    got = ease.ease_weights(csr_matrix(X), lam, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    np.testing.assert_allclose(got, _dense_ease_oracle(X, lam), atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jease.ease_weights(csr_matrix(X), lam)),
                               atol=2e-4)
    np.testing.assert_array_equal(np.diag(got), 0.0)


def test_negative_weights_survive_sparsification():
    model = ease.EASERecommender(K=20, regularization=2.0, device="cpu")
    model.fit(csr_matrix(_binary(80, 20, 0.3, seed=1)), show_progress=False)
    assert (model.similarity.data < 0).any()


def test_self_affinity_diagonal():
    model = ease.EASERecommender(K=15, regularization=2.0, device="cpu")
    model.fit(csr_matrix(_binary(50, 15, 0.3, seed=2)), show_progress=False)
    sim = model.similarity.toarray()
    for i in range(15):
        assert sim[i, i] > np.delete(sim[i], i).max()


def test_binarize_flag():
    rng = np.random.default_rng(3)
    X = csr_matrix(((rng.random((40, 12)) < 0.3) * rng.integers(1, 9, (40, 12))).astype(np.float32))
    binary = ease.EASERecommender(K=12, regularization=2.0, device="cpu")
    binary.fit(X, show_progress=False)
    raw = ease.EASERecommender(K=12, regularization=2.0, binarize=False, device="cpu")
    raw.fit(X, show_progress=False)
    Xb = X.copy()
    Xb.data = np.ones_like(Xb.data)
    np.testing.assert_allclose(binary.similarity.toarray(),
                               _ease_similarity_oracle(Xb.toarray(), 2.0), atol=2e-4)
    np.testing.assert_allclose(raw.similarity.toarray(),
                               _ease_similarity_oracle(X.toarray(), 2.0), atol=2e-4)
    assert not np.allclose(binary.similarity.toarray(), raw.similarity.toarray())


@pytest.mark.parametrize("binarize", [True, False])
def test_similarity_and_recommend_match_jax(binarize):
    # K = items: the sparsification keeps every weight, so the stored
    # similarities compare entry by entry
    rng = np.random.default_rng(6)
    X = csr_matrix(((rng.random((90, 30)) < 0.25) * rng.integers(1, 4, (90, 30)))
                   .astype(np.float32))
    port = ease.EASERecommender(K=30, regularization=4.0, binarize=binarize, device="cpu")
    ref = jease.EASERecommender(K=30, regularization=4.0, binarize=binarize)
    port.fit(X, show_progress=False)
    ref.fit(X, show_progress=False)
    np.testing.assert_allclose(port.similarity.toarray(), ref.similarity.toarray(), atol=2e-4)
    users = np.arange(90)
    ids, scores = port.recommend(users, X[users], N=5)
    wids, wscores = ref.recommend(users, X[users], N=5)
    np.testing.assert_allclose(scores, wscores, atol=2e-3)
    # ids agree wherever a JAX score stands apart from its neighbours (the
    # last one's tie may run past N)
    gap = wscores[:, :-1] - wscores[:, 1:]
    apart = np.ones(wids.shape, bool)
    apart[:, :-1] &= gap > 4e-3
    apart[:, 1:] &= gap > 4e-3
    apart[:, -1] = False
    np.testing.assert_array_equal(ids[apart], wids[apart])


def test_catalog_cap():
    big = csr_matrix((np.ones(2), (np.zeros(2, int), [0, ease._EASE_MAX_ITEMS])),
                     shape=(1, ease._EASE_MAX_ITEMS + 1))
    with pytest.raises(ValueError, match="don't fit one chip"):
        ease.ease_weights(big, device="cpu")
    with pytest.raises(ValueError, match="don't fit one chip"):
        ease.EASERecommender(device="cpu").fit(big, show_progress=False)


def test_not_positive_definite_raises():
    # lam = 0 on a gramian with an empty item column: the port refuses, where
    # the JAX package's factorization returns NaN weights
    X = _binary(40, 10, 0.4, seed=5)
    X[:, 3] = 0.0
    with pytest.raises(ModelFitError, match="not positive definite"):
        ease.ease_weights(csr_matrix(X), 0.0, device="cpu")
    with pytest.raises(ModelFitError, match="not positive definite"):
        ease.EASERecommender(regularization=0.0, device="cpu").fit(csr_matrix(X),
                                                                     show_progress=False)
    assert np.isnan(np.asarray(jease.ease_weights(csr_matrix(X), 0.0))).any()
    # the same matrix with lam > 0 solves
    assert np.isfinite(ease.ease_weights(csr_matrix(X), 1.0, device="cpu").numpy()).all()


def test_save_load_roundtrip(tmp_path):
    X = csr_matrix(_binary(40, 12, 0.3, seed=4))
    model = ease.EASERecommender(K=8, regularization=7.5, binarize=False, device="cpu")
    model.fit(X, show_progress=False)

    path = str(tmp_path / "ease_model")
    model.save(path)
    loaded = ease.EASERecommender.load(path, device="cpu")
    assert (loaded.K, loaded.regularization, loaded.binarize) == (8, 7.5, False)
    assert loaded.device == torch.device("cpu")
    np.testing.assert_array_equal(loaded.similarity.toarray(), model.similarity.toarray())
    ids1, s1 = model.recommend(0, X[0], N=5)
    ids2, s2 = loaded.recommend(0, X[0], N=5)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(s1, s2)

    buf = io.BytesIO()
    model.save(buf)
    buf.seek(0)
    from_buf = model.load(buf)  # on the instance: its device
    np.testing.assert_array_equal(from_buf.similarity.toarray(), model.similarity.toarray())


def test_quality_clustered_within_jax():
    from implicit_tpu.datasets.synthetic import get_synthetic_clustered
    from implicit_tpu.evaluation import ranking_metrics_at_k as jax_metrics

    from implicit_tpu_torch.evaluation import ranking_metrics_at_k, train_test_split

    likes = get_synthetic_clustered(users=1500, items=400, groups=16, likes_per_user=20, seed=7)
    train, test = train_test_split(likes, train_percentage=0.8, random_state=19)
    port = ease.EASERecommender(K=100, regularization=50.0, device="cpu")
    ref = jease.EASERecommender(K=100, regularization=50.0)
    port.fit(train, show_progress=False)
    ref.fit(train, show_progress=False)
    p10 = ranking_metrics_at_k(port, train, test, K=10, show_progress=False)["precision"]
    want = jax_metrics(ref, train, test, K=10, show_progress=False)["precision"]
    assert p10 > 0.5 and abs(p10 - want) <= 0.005, (p10, want)


def test_unported_arguments_raise(monkeypatch):
    # one visible card: a 2-card mesh raises where it is resolved, and
    # nothing is fitted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    X = csr_matrix(_binary(10, 5, 0.5, seed=0))
    model = ease.EASERecommender(mesh=2, device="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        model.fit(X, show_progress=False)
    assert model.similarity is None
    with pytest.raises(ValueError, match="CUDA device"):
        ease.ease_weights(X, mesh=2, device="cuda")
