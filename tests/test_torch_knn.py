"""The port's item-item similarity build and serving
(``implicit_tpu_torch/nearest_neighbours.py`` and its ``native`` routines)
against the JAX package's, on the same seeded inputs.

The JAX functions run on the CPU (``method="device"`` runs its XLA device
route there), the port's with ``device="cpu"``. Tolerances:

- the weighting transforms, the native routines and the host route are the
  same code (host scipy, and the same C++ built with the same flags): bit
  for bit;
- the device route is a float32 gramian in both packages, summed in
  another order: values within rtol 1e-5 (the JAX package's own
  device-vs-host bar, ``tests/test_knn.py``), neighbour sets equal up to
  exact ties at the K-th score (``chip_smoke.knn_disagreement``);
- ``recommend`` scores are float64 products in another order: within 1e-9
  of the batch's largest |score|, ids equal where not tied.
"""

import types

import numpy as np
import pytest
import torch
from chip_smoke import knn_disagreement
from scipy import sparse
from scipy.sparse import csr_matrix
# autouse: the JAX package's native library, built and loaded under a lock
from test_torch_jax_native import jax_native_loaded  # noqa: F401

import implicit_tpu.nearest_neighbours as jnn
from implicit_tpu import native as jnative
from implicit_tpu_torch import native
from implicit_tpu_torch import nearest_neighbours as nn

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _counts(users=300, items=80, density=0.15, seed=3):
    counts = sparse.random(users, items, density=density, random_state=np.random.RandomState(seed),
                           format="csr")
    counts.data = np.ceil(counts.data * 5)
    return counts


def _signed(users=200, items=90, nnz=1800, seed=5):
    rng = np.random.default_rng(seed)
    m = csr_matrix((rng.standard_normal(nnz), (rng.integers(0, users, nnz),
                                               rng.integers(0, items, nnz))), shape=(users, items))
    m.sum_duplicates()
    return m


def _assert_same_csr(got, want):
    got, want = got.tocsr(), want.tocsr()
    assert got.shape == want.shape
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def _assert_agree(got, want, rtol=1e-5):
    err, bad = knn_disagreement(got.tocsr(), want.tocsr(), rtol)
    assert err <= rtol and not bad, (err, bad[:5])


def _assert_recommend_close(got, want, rel=1e-9):
    """Scores within ``rel`` of the batch's largest |score|; ids equal but
    where the JAX scores tie (within the row, or with its last score, whose
    tie may run past N), and every id above a row's last score in both."""
    ids, scores = (np.atleast_2d(a) for a in got)
    wids, wscores = (np.atleast_2d(a) for a in want)
    np.testing.assert_array_equal(ids >= 0, wids >= 0)
    valid = wids >= 0
    tol = rel * np.abs(wscores[valid]).max() if valid.any() else 0.0
    np.testing.assert_allclose(scores[valid], wscores[valid], rtol=0, atol=tol)
    for r in range(ids.shape[0]):
        v = valid[r]
        for p in np.flatnonzero(ids[r] != wids[r]):
            tied = np.abs(wscores[r][v] - wscores[r][p]) <= tol
            assert tied.sum() > 1 or tied[-1], (r, p)
        if v.any():
            above = wids[r][v][wscores[r][v] > wscores[r][v][-1] + tol]
            assert np.isin(above, ids[r]).all(), r


# -- weighting transforms --------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("normalize", ()), ("tfidf_weight", ()), ("bm25_weight", ()), ("bm25_weight", (1.2, 0.75)),
], ids=["normalize", "tfidf", "bm25-default", "bm25-model"])
def test_weighting_transforms_equal(name, args):
    counts = _counts()
    got = getattr(nn, name)(counts.T, *args).tocsr()
    want = getattr(jnn, name)(counts.T, *args).tocsr()
    _assert_same_csr(got, want)


# -- native routines ----------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 4, 50, 500])
def test_native_topk_rows_matches_jax(K):
    sim = _signed(seed=K)
    iu = sim.T.tocsr()
    prod = (iu @ sim).tocsr()
    got = native.topk_rows(prod.indptr, prod.indices, prod.data, K, row_offset=7)
    want = jnative.topk_rows(prod.indptr, prod.indices, prod.data, K, row_offset=7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("K", [1, 4, 50, 500])
def test_native_knn_all_pairs_matches_jax(K):
    m = _signed()
    iu = m.T.tocsr()
    iu.sort_indices()
    got = native.knn_all_pairs(iu, m, K)
    want = jnative.knn_all_pairs(iu, m, K)
    assert got is not None and want is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_native_knn_all_pairs_nan_weight_matches_jax():
    # a NaN interaction stays a value (tests/test_knn.py): same entries, the
    # NaNs in the same places, no duplicate columns, at most K per row
    rng = np.random.default_rng(11)
    U, I, N = 120, 60, 1200
    m = csr_matrix((rng.random(N) + 0.1, (rng.integers(0, U, N), rng.integers(0, I, N))),
                   shape=(U, I))
    m.sum_duplicates()
    m.data[0] = np.nan
    iu = m.T.tocsr()
    iu.sort_indices()
    got = native.knn_all_pairs(iu, m, 8)
    for a, b in zip(got, jnative.knn_all_pairs(iu, m, 8)):
        np.testing.assert_array_equal(a, b)
    rows, cols, _ = got
    assert len(set(zip(rows.tolist(), cols.tolist()))) == len(rows)
    assert np.bincount(rows, minlength=I).max() <= 8


def test_native_knn_all_pairs_row_chunking_is_invisible(monkeypatch):
    # a tiny output budget cuts the item rows into 7-row calls in both packages
    rng = np.random.default_rng(9)
    U, I, N = 150, 70, 1500
    m = csr_matrix((rng.random(N), (rng.integers(0, U, N), rng.integers(0, I, N))), shape=(U, I))
    m.sum_duplicates()
    iu = m.T.tocsr()
    iu.sort_indices()
    one = native.knn_all_pairs(iu, m, 10)
    monkeypatch.setenv("IMPLICIT_KNN_OUT_BUDGET", str(10 * 12 * 7))
    many = native.knn_all_pairs(iu, m, 10)
    want = jnative.knn_all_pairs(iu, m, 10)
    for a, b, c in zip(one, many, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("items,num_threads,budget", [
    (1000, 0, None), (1000, 3, None), (10**6, 0, str(13 * 10**6 * 2)), (10**6, 0, "1"),
])
def test_knn_effective_threads_matches_jax(monkeypatch, items, num_threads, budget):
    if budget is not None:
        monkeypatch.setenv("IMPLICIT_KNN_ACC_BUDGET", budget)
    assert native.knn_effective_threads(items, num_threads) == \
        jnative.knn_effective_threads(items, num_threads)


# -- the host route -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["bm25", "tfidf", "signed", "empty"])
@pytest.mark.parametrize("K", [5, 20])
def test_host_route_matches_jax_bit_for_bit(case, K):
    counts = _counts()
    m = {"bm25": lambda: nn.bm25_weight(counts.T, 1.2, 0.75).T,
         "tfidf": lambda: nn.normalize(nn.tfidf_weight(counts.T)).T,
         "signed": _signed,
         "empty": lambda: csr_matrix((4, 4), dtype=np.float64)}[case]()
    m = csr_matrix(m)
    got = nn.all_pairs_knn(m, K, method="host")
    _assert_same_csr(got, jnn.all_pairs_knn(m, K, method="host"))
    # "auto" on a CPU device is the host route
    _assert_same_csr(nn.all_pairs_knn(m, K, device="cpu"), got)


def test_host_route_scipy_fallback_matches_jax(monkeypatch):
    # without the fused native product both packages take blocked scipy
    # products and the native per-row top-K
    m = csr_matrix(nn.bm25_weight(_counts().T).T)
    monkeypatch.setattr(native, "knn_all_pairs", lambda *args: None)
    monkeypatch.setattr(jnative, "knn_all_pairs", lambda *args: None)
    got = nn.all_pairs_knn(m, 7, method="host")
    _assert_same_csr(got, jnn.all_pairs_knn(m, 7, method="host"))
    monkeypatch.undo()
    _assert_agree(got, nn.all_pairs_knn(m, 7, method="host"), rtol=1e-12)


# -- the device route ------------------------------------------------------------------


@pytest.mark.parametrize("dense_bytes", [None, 512], ids=["one-chunk", "chunks"])
@pytest.mark.parametrize("K", [5, 20])
def test_device_route_matches_jax_and_host(monkeypatch, dense_bytes, K):
    counts = _counts(users=200, items=50, density=0.2, seed=9)
    if dense_bytes is not None:
        # about 20 user chunks in both packages
        monkeypatch.setattr(nn, "_DEVICE_KNN_DENSE_BYTES", dense_bytes)
        monkeypatch.setattr(jnn, "_DEVICE_KNN_DENSE_BYTES", dense_bytes)
    got = nn.all_pairs_knn(counts, K, method="device", device="cpu")
    _assert_agree(got, jnn.all_pairs_knn(counts, K, method="device"))
    _assert_agree(got, nn.all_pairs_knn(counts, K, method="host"))


def test_device_route_sums_duplicate_entries():
    # a CSR that check_csr passes may repeat a (user, item) entry: the
    # scatter adds the repeats, as the JAX package's does
    rng = np.random.default_rng(4)
    U, I, N = 60, 30, 500
    rows = np.sort(rng.integers(0, U, N))
    cols = rng.integers(0, I, N)
    vals = rng.integers(1, 4, N).astype(np.float64)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=U))])
    dup = csr_matrix((vals, cols, indptr), shape=(U, I))
    assert not dup.has_canonical_format
    summed = dup.copy()
    summed.sum_duplicates()
    assert summed.nnz < dup.nnz
    got = nn.all_pairs_knn(dup, 6, method="device", device="cpu")
    _assert_agree(got, jnn.all_pairs_knn(dup, 6, method="device"))
    _assert_agree(got, nn.all_pairs_knn(summed, 6, method="host"))


def test_dense_gramian_matches_jax():
    counts = _counts(users=120, items=40, density=0.3, seed=2)
    got = nn._dense_gramian_device(counts, CPU).numpy()
    want = np.asarray(jnn._dense_gramian_device(counts))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, (counts.T @ counts).toarray(), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("keep", ["positive", "nonzero"])
def test_dense_topk_to_coo_matches_jax(keep):
    rng = np.random.default_rng(8)
    S = rng.standard_normal((70, 70)).astype(np.float32)  # no ties
    S[rng.random(S.shape) < 0.3] = 0.0
    got = nn._dense_topk_to_coo(torch.as_tensor(S), 9, keep=keep)
    want = jnn._dense_topk_to_coo(S, 9, keep=keep)
    _assert_same_csr(got, want)
    assert got.dtype == np.float64


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(method="device"), ValueError, "method='host'"),
    (dict(method="remote"), ValueError, "method"),
    (dict(mesh=2, device="cuda"), ValueError, "CUDA device"),
], ids=["cap", "method", "mesh"])
def test_all_pairs_knn_refuses(kwargs, error, match, monkeypatch):
    # one visible card: a 2-card mesh raises where it is resolved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    wide = sparse.random(10, nn._DEVICE_KNN_MAX_ITEMS + 1, density=0.01,
                         random_state=np.random.RandomState(0), format="csr")
    wide.data[:] = 1.0
    with pytest.raises(error, match=match):
        nn.all_pairs_knn(wide, 5, **{"device": "cpu", **kwargs})


def test_device_route_refuses_negative_weights():
    with pytest.raises(ValueError, match="negative"):
        nn.all_pairs_knn(_signed(), 5, method="device", device="cpu")


def test_device_method_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        nn.all_pairs_knn(_counts(), 5, method="device", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        nn.all_pairs_knn(_counts(), 5, device="cuda")  # "auto" resolves the device
    # the host route needs no device
    nn.all_pairs_knn(_counts(), 5, method="host", device="cuda")


# -- the cost rule ------------------------------------------------------------------------


def _shaped(users, items, per_user, data_min=1.0):
    """What _device_knn_wins reads of a CSR: shape, nnz, data, indptr."""
    return types.SimpleNamespace(shape=(users, items), nnz=users * per_user,
                                 data=np.array([data_min, 2.0]),
                                 indptr=np.arange(users + 1, dtype=np.int64) * per_user)


def test_device_knn_wins_is_false_on_the_cpu():
    assert not nn._device_knn_wins(_shaped(138_000, 27_000, 1000), CPU)
    assert not jnn._device_knn_wins(_counts())  # the JAX package without a TPU


@pytest.mark.parametrize("shape,wins", [
    ((138_000, 27_000, 1000), True),    # dense rows: pair expansions dominate
    ((1000, 1000, 10), False),          # small: the host is quicker
    ((360_000, 160_000, 1000), False),  # over the item cap
    ((100, 1, 1), False),               # fewer than 2 items
])
def test_device_knn_wins_rule_on_cuda(shape, wins):
    cuda = types.SimpleNamespace(type="cuda")
    assert nn._device_knn_wins(_shaped(*shape), cuda) is wins


def test_device_knn_wins_keeps_negative_weights_on_the_host():
    cuda = types.SimpleNamespace(type="cuda")
    assert not nn._device_knn_wins(_shaped(138_000, 27_000, 1000, data_min=-1.0), cuda)


# -- serving -------------------------------------------------------------------------------


def _fitted(name, **kwargs):
    counts = _counts(users=120, items=60, density=0.12, seed=7)
    port = getattr(nn, name)(K=10, device="cpu", **kwargs)
    ref = getattr(jnn, name)(K=10, **kwargs)
    port.fit(counts, show_progress=False)
    ref.fit(counts, show_progress=False)
    _assert_same_csr(port.similarity, ref.similarity)  # the host route
    return port, ref, counts


MODELS = ["CosineRecommender", "TFIDFRecommender", "BM25Recommender"]


@pytest.mark.parametrize("filter_items", [None, [1, 3, 8]], ids=["no-items", "filter-items"])
@pytest.mark.parametrize("filter_liked", [True, False], ids=["liked", "keep-liked"])
@pytest.mark.parametrize("name", MODELS)
def test_batch_recommend_matches_jax(name, filter_liked, filter_items):
    port, ref, counts = _fitted(name)
    users = np.arange(0, 120, 3)
    for N in (5, 70):  # 70: more than the candidates, so rows pad with -1
        got = port.recommend(users, counts[users], N=N, filter_items=filter_items,
                             filter_already_liked_items=filter_liked)
        want = ref.recommend(users, counts[users], N=N, filter_items=filter_items,
                             filter_already_liked_items=filter_liked)
        assert got[0].dtype == np.int32 and got[1].dtype == np.float64
        _assert_recommend_close(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_scalar_recommend_matches_jax_and_batch(name):
    port, ref, counts = _fitted(name)
    batch = port.recommend(np.arange(10), counts[:10], N=6, filter_items=[2])
    for u in range(10):
        got = port.recommend(u, counts[u], N=6, filter_items=[2])
        _assert_recommend_close(got, ref.recommend(u, counts[u], N=6, filter_items=[2]))
        n = len(got[0])
        np.testing.assert_array_equal(got[0], batch[0][u][:n])
        np.testing.assert_array_equal(got[1], batch[1][u][:n])


@pytest.mark.parametrize("filter_liked", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_recommend_items_matches_jax(name, filter_liked):
    port, ref, counts = _fitted(name)
    items = np.array([0, 4, 9, 17, 33, 59])
    for u in (0, 5, 11):
        ids, scores = port.recommend(u, counts[u], items=items,
                                     filter_already_liked_items=filter_liked)
        wids, wscores = ref.recommend(u, counts[u], items=items,
                                      filter_already_liked_items=filter_liked)
        assert sorted(ids) == sorted(wids) == sorted(items)
        order, worder = np.argsort(ids), np.argsort(wids)
        np.testing.assert_allclose(scores[order], wscores[worder], rtol=1e-12)
    got = port.recommend(np.arange(8), counts[:8], N=4, items=items)
    want = ref.recommend(np.arange(8), counts[:8], N=4, items=items)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)


def test_recommend_refuses_a_matrix_of_another_width():
    port, _, counts = _fitted("CosineRecommender")
    with pytest.raises(ValueError, match="columns"):
        port.recommend(0, csr_matrix((1, 61)))


@pytest.mark.parametrize("name", MODELS)
def test_similar_items_matches_jax(name):
    port, ref, _ = _fitted(name)
    for kwargs in ({}, {"filter_items": [0, 2]}, {"items": [1, 5, 6, 30]}):
        got = port.similar_items(np.arange(60), N=8, **kwargs)
        want = ref.similar_items(np.arange(60), N=8, **kwargs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_model_on_the_device_route_matches_jax(monkeypatch):
    # both packages forced onto their device route by the cost rule
    monkeypatch.setattr(nn, "_device_knn_wins", lambda *args, **kwargs: True)
    monkeypatch.setattr(jnn, "_device_knn_wins", lambda *args, **kwargs: True)
    counts = _counts(users=150, items=50, density=0.15, seed=12)
    port = nn.BM25Recommender(K=8, device="cpu")
    ref = jnn.BM25Recommender(K=8)
    port.fit(counts, show_progress=False)
    ref.fit(counts, show_progress=False)
    _assert_agree(port.similarity, ref.similarity)
    users = np.arange(150)
    _assert_recommend_close(port.recommend(users, counts[users], N=5),
                            ref.recommend(users, counts[users], N=5), rel=1e-5)


def test_device_copy_follows_the_similarity():
    port, _, counts = _fitted("CosineRecommender")
    before = port.recommend(np.arange(5), counts[:5], N=3)
    assert port._similarity_dev is not None
    assert port.__getstate__()["_similarity_dev"] is None
    scaled = port.similarity.copy()
    scaled.data *= 2.0
    port.similarity = scaled
    assert port._similarity_dev is None
    after = port.recommend(np.arange(5), counts[:5], N=3)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_allclose(after[1], 2.0 * before[1], rtol=1e-12)
    assert port.scorer.similarity.shape == (60, 60)


@pytest.mark.parametrize("name", MODELS)
def test_unported_arguments_raise(name, monkeypatch):
    with pytest.raises(ValueError):
        getattr(nn, name)(device="meta")
    with pytest.raises(ValueError, match="mesh must be"):
        getattr(nn, name)(mesh=0, device="cpu")
    # one visible card: a 2-card mesh raises when the fit resolves it, and
    # nothing is fitted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    model = getattr(nn, name)(mesh=2, device="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        model.fit(_counts(), show_progress=False)
    assert model.similarity is None
