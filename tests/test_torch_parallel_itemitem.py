"""The port's meshed item-item fits (``implicit_tpu_torch/nearest_neighbours.py``
and ``ease.py`` with ``mesh=``) against the JAX package's meshed paths and the
port's own unmeshed fits, on the same numpy inputs.

JAX runs on the 8 virtual CPU devices ``conftest.py`` sets up, with
``create_mesh(4)``; the port on ``parallel.create_mesh(4, "cpu")``. Tolerances:

- the row-sharded gramian: the unmeshed test's bar (rtol 1e-6, atol 1e-4;
  float32 sums in another order), its padding rows exactly zero;
- the sharded top-K: the same COO as JAX's, bit for bit, on a matrix
  without ties;
- meshed KNN fits against the unmeshed ones and against JAX's meshed fits:
  values within 1e-5, neighbours equal up to exact ties at the K-th score
  (``chip_smoke.knn_disagreement``, the device route's bar);
- EASE's meshed weights against JAX's at atol 2e-4, the bar of
  ``tests/test_torch_ease.py``'s ``ease_weights``; a mesh of one shard is
  the plain solve, bit for bit.
"""

import pickle

import jax
import numpy as np
import pytest
import torch
from chip_smoke import knn_disagreement
from jax.sharding import NamedSharding, PartitionSpec as P
from scipy import sparse
from scipy.sparse import csr_matrix
# autouse: the JAX package's native library, built and loaded under a lock
from test_torch_jax_native import jax_native_loaded  # noqa: F401

import implicit_tpu.ease as jease
import implicit_tpu.nearest_neighbours as jnn
from implicit_tpu.parallel import create_mesh as jmesh
from implicit_tpu_torch import ease
from implicit_tpu_torch import nearest_neighbours as nn
from implicit_tpu_torch.parallel import create_mesh, virtual_mesh
from implicit_tpu_torch.recommender_base import ModelFitError

torch.set_num_threads(2)

D = 4


def _counts(users=300, items=83, density=0.15, seed=3):
    counts = sparse.random(users, items, density=density, random_state=np.random.RandomState(seed),
                           format="csr")
    counts.data = np.ceil(counts.data * 5)
    return counts


def _assert_agree(got, want, rtol=1e-5):
    err, bad = knn_disagreement(got.tocsr(), want.tocsr(), rtol)
    assert err <= rtol and not bad, (err, bad[:5])


def _assert_same_csr(got, want):
    got, want = got.tocsr(), want.tocsr()
    assert got.shape == want.shape
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


# -- the item-item KNN family ----------------------------------------------------


@pytest.mark.parametrize("items", [83, 84], ids=["uneven", "even"])
def test_dense_gramian_meshed_matches_jax(items, monkeypatch):
    """An item count D does not divide (the last block runs past it) and one
    it does, over several user chunks."""
    counts = _counts(items=items)
    for mod in (nn, jnn):
        monkeypatch.setattr(mod, "_DEVICE_KNN_DENSE_BYTES", items * 40)  # 8 chunks
    S, block = nn._dense_gramian_meshed(counts, create_mesh(D, "cpu"))
    want, jblock = jnn._dense_gramian_meshed(counts, jmesh(D))
    want = np.asarray(want)
    assert block == jblock == -(-items // D) and len(S) == D
    assert all(s.shape == (block, items) and s.dtype == torch.float32 for s in S)
    got = torch.cat(S).numpy()
    np.testing.assert_array_equal(got[items:], 0.0)
    np.testing.assert_array_equal(want[items:], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[:items], (counts.T @ counts).toarray(), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("keep", ["positive", "nonzero"])
def test_dense_topk_to_coo_meshed_matches_jax(keep):
    rng = np.random.default_rng(8)
    items, block = 70, -(-70 // D)
    S = rng.standard_normal((D * block, items)).astype(np.float32)  # no ties
    S[rng.random(S.shape) < 0.3] = 0.0
    S[items:] = 0.0  # padding rows
    mesh, jm = create_mesh(D, "cpu"), jmesh(D)
    got = nn._dense_topk_to_coo_meshed(list(torch.as_tensor(S).split(block)), items, 9, mesh,
                                       keep=keep)
    jS = jax.device_put(S, NamedSharding(jm, P("d", None)))
    want = jnn._dense_topk_to_coo_meshed(jS, items, 9, jm, keep=keep)
    _assert_same_csr(got, want)
    assert got.dtype == np.float64
    # and the unmeshed selection of the same rows
    _assert_same_csr(got, nn._dense_topk_to_coo(torch.as_tensor(S[:items]), 9, keep=keep))


def test_item_cap_and_cost_rule_count_shards(monkeypatch):
    """The device route's item cap is √D times the single device's, as the
    JAX package's; the cost rule divides its gramian and top-K terms by D.
    Both are counted in shards, on a virtual mesh too."""
    for n in range(1, 9):
        assert nn._device_knn_item_cap(n) == int(jnn._DEVICE_KNN_MAX_ITEMS * np.sqrt(n))
    assert nn._DEVICE_KNN_MAX_ITEMS == jnn._DEVICE_KNN_MAX_ITEMS
    # a catalog between the caps of D = 1 and D = 4: refused, then built
    for mod in (nn, jnn):
        monkeypatch.setattr(mod, "_DEVICE_KNN_MAX_ITEMS", 50)
    counts = _counts(items=83)
    with pytest.raises(ValueError, match="over 50 items"):
        nn.all_pairs_knn(counts, 5, method="device", device="cpu")
    with pytest.raises(ValueError, match="over 50 items"):
        jnn.all_pairs_knn(counts, 5, method="device")
    _assert_agree(nn.all_pairs_knn(counts, 5, method="device", mesh=D, device="cpu"),
                  jnn.all_pairs_knn(counts, 5, method="device", mesh=D))
    cuda = torch.device("cuda", 0)  # the rule's route choice; nothing runs there
    assert not nn._device_knn_wins(counts, cuda, n_shards=1)  # over the cap
    # the cost rule: a host cost between the device's at D = 1 and at D = 4
    users, items = 3000, 40
    wide = sparse.random(users, items, density=0.5, random_state=np.random.RandomState(1),
                         format="csr")

    def device_s(n):
        return (nn._DEVICE_CALL_S + 2.0 * items ** 2 * users / (nn._GRAMIAN_FLOPS * n)
                + 8.0 * (wide.nnz + users) / nn._H2D_BYTES_PER_S
                + float(items) ** 2 / (nn._TOPK_ELEMENTS_PER_S * n))

    monkeypatch.setattr(nn, "_GRAMIAN_FLOPS", 1e6)  # a gramian-bound device
    deg = np.diff(wide.indptr).astype(np.float64)
    host_s = (device_s(1) + device_s(D)) / 2
    monkeypatch.setattr(nn, "_HOST_PAIRS_PER_S", float(deg @ deg) / host_s)
    monkeypatch.setattr(nn, "_SCIPY_PAIRS_PER_S", float(deg @ deg) / host_s)
    from implicit_tpu_torch import native

    monkeypatch.setattr(native, "knn_effective_threads", lambda *args: 1)
    assert device_s(D) < host_s < device_s(1)
    assert not nn._device_knn_wins(wide, cuda, n_shards=1)
    assert nn._device_knn_wins(wide, cuda, n_shards=D)
    assert not nn._device_knn_wins(wide, torch.device("cpu"), n_shards=D)


MODELS = ["CosineRecommender", "TFIDFRecommender", "BM25Recommender"]


@pytest.mark.parametrize("name", MODELS)
def test_meshed_fit_equals_unmeshed_and_jax(name, monkeypatch):
    """``mesh=4`` on the device route: the unmeshed fit's similarity and
    the JAX package's meshed fit's, each up to ties."""
    monkeypatch.setattr(nn, "_device_knn_wins", lambda *args, **kwargs: True)
    monkeypatch.setattr(jnn, "_device_knn_wins", lambda *args, **kwargs: True)
    counts = _counts(users=200, items=61, seed=12)
    meshed = getattr(nn, name)(K=8, mesh=D, device="cpu")
    plain = getattr(nn, name)(K=8, device="cpu")
    ref = getattr(jnn, name)(K=8, mesh=D)
    for m in (meshed, plain, ref):
        m.fit(counts, show_progress=False)
    _assert_agree(meshed.similarity, plain.similarity)
    _assert_agree(meshed.similarity, ref.similarity)
    users = np.arange(200)
    np.testing.assert_allclose(meshed.recommend(users, counts[users], N=5)[1],
                               plain.recommend(users, counts[users], N=5)[1], rtol=1e-5)


def test_pickle_stores_the_mesh_size():
    for mesh, virtual in ((D, False), (virtual_mesh(D, "cpu"), True)):
        model = nn.BM25Recommender(K=5, mesh=mesh, device="cpu")
        back = pickle.loads(pickle.dumps(model))
        assert back.mesh == D and getattr(back, "_mesh_virtual", False) is virtual
        assert back._fit_mesh() == create_mesh(D, "cpu")
    assert pickle.loads(pickle.dumps(nn.BM25Recommender(device="cpu"))).mesh is None


# -- EASE --------------------------------------------------------------------------


def _binary(users, items, p, seed):
    return (np.random.default_rng(seed).random((users, items)) < p).astype(np.float32)


@pytest.mark.parametrize("items", [25, 28], ids=["uneven", "even"])
def test_ease_weights_meshed_match_jax(items):
    X = csr_matrix(_binary(60, items, 0.2, seed=0))
    got = ease.ease_weights(X, 3.0, mesh=D, device="cpu")
    assert got.shape == (items, items) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(jease.ease_weights(X, 3.0, mesh=D)), atol=2e-4)
    np.testing.assert_allclose(got, ease.ease_weights(X, 3.0, device="cpu").numpy(), atol=2e-4)
    np.testing.assert_array_equal(np.diag(got), 0.0)


def test_mesh_of_one_is_the_plain_solve():
    X = csr_matrix(_binary(30, 12, 0.4, seed=3))
    plain = ease.ease_weights(X, 2.0, device="cpu")
    assert torch.equal(ease.ease_weights(X, 2.0, mesh=1, device="cpu"), plain)
    assert torch.equal(ease.ease_weights(X, 2.0, mesh=virtual_mesh(1, "cpu"), device="cpu"),
                       plain)


def test_ease_caps_and_mesh_resolution_equal_jax():
    for n in (None, 1, 2, 3, 4, 8):
        assert ease._ease_max_items(n) == jease._ease_max_items(n)
    assert ease._ease_max_items(None) > ease._ease_max_items(2)
    for arg in (None, 1):
        assert ease._resolve_ease_mesh(arg, "cpu") is None
        assert jease._resolve_ease_mesh(arg) is None
    assert ease._resolve_ease_mesh(D, "cpu").size == jease._resolve_ease_mesh(D).size == D
    big = csr_matrix((np.ones(1), ([0], [0])), shape=(1, ease._ease_max_items(2) + 1))
    with pytest.raises(ValueError, match="mesh devices"):
        ease.ease_weights(big, mesh=2, device="cpu")
    with pytest.raises(ValueError, match="mesh chips"):
        jease.ease_weights(big, mesh=2)


def test_ease_recommender_meshed_matches_jax():
    # K = items: every weight is kept, so the similarities compare entry by entry
    rng = np.random.default_rng(6)
    X = csr_matrix(((rng.random((90, 30)) < 0.25) * rng.integers(1, 4, (90, 30)))
                   .astype(np.float32))
    port = ease.EASERecommender(K=30, regularization=4.0, mesh=D, device="cpu")
    ref = jease.EASERecommender(K=30, regularization=4.0, mesh=D)
    plain = ease.EASERecommender(K=30, regularization=4.0, device="cpu")
    for m in (port, ref, plain):
        m.fit(X, show_progress=False)
    np.testing.assert_allclose(port.similarity.toarray(), ref.similarity.toarray(), atol=2e-4)
    np.testing.assert_allclose(port.similarity.toarray(), plain.similarity.toarray(), atol=2e-4)
    sim = port.similarity.toarray()
    for i in range(30):  # the serving self-affinity, above the row's other weights
        assert sim[i, i] > np.delete(sim[i], i).max()


def test_meshed_not_positive_definite_raises():
    X = _binary(40, 10, 0.4, seed=5)
    X[:, 3] = 0.0
    with pytest.raises(ModelFitError, match="not positive definite"):
        ease.ease_weights(csr_matrix(X), 0.0, mesh=D, device="cpu")
    model = ease.EASERecommender(regularization=0.0, mesh=D, device="cpu")
    with pytest.raises(ModelFitError, match="not positive definite"):
        model.fit(csr_matrix(X), show_progress=False)
    assert model.similarity is None


# -- chip_smoke.py phase 10's bars, at a small shape on the CPU ----------------------


def test_chip_smoke_meshed_knn_bar():
    """Phase 10's BM25 step: the meshed device route against the unmeshed
    one at phase 6's route bar, which must reject a meshed gramian missing
    its last shard's row block (the check raises otherwise), and a second
    build's bits."""
    import chip_smoke

    weighted = csr_matrix(nn.bm25_weight(_counts(users=400, items=90, seed=5).T, 1.2, 0.75).T)
    want = nn.all_pairs_knn(weighted, 6, method="device", device="cpu").tocsr()
    wall, steps = chip_smoke.mesh_knn_check(weighted, want, "cpu", virtual_mesh(D, "cpu"), K=6)
    assert wall > 0 and set(steps) == {"upload", "gramian", "top-k", "copy back"}


def test_chip_smoke_meshed_ease_bar():
    """Phase 10's EASE closed-form step: the meshed weights pass, weights
    solved with lam off by 10% are rejected (0.1 by construction)."""
    import chip_smoke

    binary = csr_matrix(_binary(300, 70, 0.1, seed=4))
    ok, off = chip_smoke.mesh_ease_closed_form(binary, "cpu", virtual_mesh(D, "cpu"), lam=25.0)
    assert ok <= chip_smoke.EASE_BAR < off
    np.testing.assert_allclose(off, 0.1, rtol=1e-3)
