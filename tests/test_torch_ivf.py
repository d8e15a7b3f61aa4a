"""The port's on-device IVF index (``implicit_tpu_torch/ann/ivf.py``) and
its factory against the JAX package's.

k-means starts from ``k`` distinct rows. The JAX package draws them with
``jax.random.choice`` (threefry), which torch cannot reproduce; the port
draws them with numpy and takes them as an argument, so these tests draw
the JAX rows themselves and pass them in (ROADMAP C21). On well-separated
clustered points the assignments must then be equal and the centroids
within 1e-5 (float32 sums in another order). Searches over one index (a
JAX build loaded from its npz) give scores within 1e-6 and ids equal
modulo ties. Everything runs on the CPU (``device="cpu"``).
"""

import io

import jax
import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse import random as sparse_random
from test_torch_topk_streaming import assert_same_topk

from implicit_tpu.ann import ivf as jivf
from implicit_tpu.approximate_als import TPUIVFAlternatingLeastSquares as JaxIVFALS
from implicit_tpu_torch import convert
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.ann import ivf
from implicit_tpu_torch.ann.ivf import TPUIVFModel, _IVFIndex
from implicit_tpu_torch.approximate_als import TPUIVFAlternatingLeastSquares

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _clustered_points(n, f, groups, rng):
    centers = rng.standard_normal((groups, f)).astype(np.float32) * 3
    pts = centers[rng.integers(0, groups, n)] + rng.standard_normal((n, f)).astype(np.float32) * 0.3
    return pts.astype(np.float32)


def _normalized(pts):
    return pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-12)


def _jax_rows(seed, n, k):
    """The rows the JAX package's _kmeans_run starts from."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False))


def _assert_well_separated(X, C, margin=1e-3):
    """The premise of the parity tests: every point's best centroid beats
    its second by ``margin``, so float32 sums in another order cannot flip
    an assignment."""
    s = np.sort(X @ np.asarray(C).T, axis=1)
    assert (s[:, -1] - s[:, -2]).min() > margin


# k at most the number of groups: no group is split between two centroids
@pytest.mark.parametrize("n,f,groups,k,iters,seed", [
    (2000, 12, 16, 8, 8, 5), (3000, 16, 24, 12, 8, 1), (1500, 8, 12, 6, 6, 0),
])
def test_kmeans_matches_jax(n, f, groups, k, iters, seed):
    X = _normalized(_clustered_points(n, f, groups, np.random.default_rng(seed)))
    C_j, a_j = jivf._kmeans_run(jax.numpy.asarray(X), jax.random.PRNGKey(seed), k, iters)
    _assert_well_separated(X, C_j)
    C, a = ivf._kmeans_run(torch.as_tensor(X), _jax_rows(seed, n, k), k, iters)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(C.numpy(), np.asarray(C_j), rtol=0, atol=1e-5)


def test_kmeans_blocks_and_repeats(monkeypatch):
    # the assignment over many row blocks equals one block, bit for bit; an
    # empty cluster keeps its centroid
    X = _normalized(_clustered_points(3000, 8, 6, np.random.default_rng(1)))
    rows = np.r_[np.arange(10), 0]  # row 0 twice: cluster 10 starts empty
    C1, a1 = ivf._kmeans_run(torch.as_tensor(X), rows, 11, 5)
    monkeypatch.setattr(ivf, "_ASSIGN_BLOCK_ELEMENTS", 11 * 256)  # 12 blocks
    C2, a2 = ivf._kmeans_run(torch.as_tensor(X), rows, 11, 5)
    assert torch.equal(a1, a2) and torch.equal(C1, C2)
    C, _ = ivf._kmeans_run(torch.as_tensor(X), rows, 11, 1)
    np.testing.assert_array_equal(C[10].numpy(), X[0])
    assert not np.array_equal(C[0].numpy(), X[0])


def test_index_matches_a_jax_build_from_the_same_rows():
    rng = np.random.default_rng(4)
    pts = _clustered_points(2000, 12, 16, rng)
    want = jivf._IVFIndex(pts, n_clusters=8, kmeans_iters=8, seed=5)
    _assert_well_separated(_normalized(pts), want.centroids)
    got = _IVFIndex(pts, 8, 8, 5, CPU, init=_jax_rows(5, 2000, 8))
    g, w = got.to_arrays("x"), want.to_arrays("x")
    assert g.keys() == w.keys()
    for key in g:
        if key == "xcentroids":
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g[key], w[key])
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key


def _jax_index_loaded():
    rng = np.random.default_rng(7)
    pts = _clustered_points(3000, 16, 24, rng)
    jindex = jivf._IVFIndex(_normalized(pts), n_clusters=48, kmeans_iters=8, seed=1)
    buf = io.BytesIO()
    np.savez(buf, **jindex.to_arrays("sim__"))
    buf.seek(0)
    with np.load(buf) as data:
        index = _IVFIndex.from_arrays(data, "sim__", CPU)
    return jindex, index, pts, rng


@pytest.mark.parametrize("count,n_probe", [(10, 6), (25, 48), (400, 2)])
def test_search_on_a_jax_built_index(count, n_probe):
    jindex, index, pts, rng = _jax_index_loaded()
    queries = _normalized(rng.standard_normal((20, 16)).astype(np.float32))
    for q in queries[:5]:
        assert_same_topk(index.search(q, count, n_probe), jindex.search(q, count, n_probe))
    got = index.search_batch(queries, count, n_probe)
    want = jindex.search_batch(queries, count, n_probe)
    k = got[0].shape[1]
    assert k == min(count, n_probe * index.cap)
    assert_same_topk(got, (want[0][:, :k], want[1][:, :k]))
    # a chunk of 3 queries per product gives the same rows
    np.testing.assert_array_equal(index.search_batch(queries, count, n_probe, chunk=3)[0],
                                  got[0])


def test_probing_everything_is_exact():
    rng = np.random.default_rng(1)
    pts = _clustered_points(500, 8, 10, rng)
    index = _IVFIndex(pts, 16, 10, 0, CPU)
    q = rng.standard_normal(8).astype(np.float32)
    ids, scores = index.search(q, 20, n_probe=16)
    exact = np.argsort(-pts @ q)[:20]
    np.testing.assert_allclose(scores, (pts @ q)[exact], rtol=1e-5, atol=1e-6)
    assert set(ids.tolist()) == set(exact.tolist())


def test_index_recall_vs_exact():
    # the JAX package's bar (tests/test_ivf.py)
    rng = np.random.default_rng(0)
    pts = _clustered_points(4000, 16, 32, rng)
    unit = _normalized(pts)
    index = _IVFIndex(unit, 64, 10, 3, CPU)
    hits = 0
    for qi in range(50):
        ids, scores = index.search(unit[qi], 10, n_probe=8)
        hits += len(set(ids.tolist()) & set(np.argsort(-unit @ unit[qi])[:10].tolist()))
        np.testing.assert_allclose(scores, unit[ids] @ unit[qi], rtol=1e-5, atol=1e-6)
    assert hits / 500 > 0.85, hits / 500


def test_search_count_exceeding_probed_candidates():
    rng = np.random.default_rng(2)
    pts = _clustered_points(500, 8, 10, rng)
    index = _IVFIndex(pts, 16, 5, 0, CPU)
    ids, scores = index.search(rng.standard_normal(8).astype(np.float32), 400, n_probe=2)
    assert len(ids) <= 2 * index.cap and len(ids) == len(scores)
    assert np.isfinite(scores).all()


def _likes():
    rng = np.random.RandomState(5)
    return csr_matrix((rng.rand(120, 80) < 0.2).astype(np.float32))


def _fitted(**kw):
    model = TPUIVFAlternatingLeastSquares(factors=16, iterations=5, random_state=2,
                                          device="cpu", **kw)
    model.fit(_likes(), show_progress=False)
    return model


def test_wrapper_end_to_end_probe_all_is_exact():
    likes = _likes()
    model = _fitted(n_probe=1000)
    assert model.model.device == CPU and model.recommend_index.points.device == CPU
    for u in (3, 11):
        assert_same_topk(model.recommend(u, likes[u], N=5),
                         model.model.recommend(u, likes[u], N=5), rtol=1e-5)
    sids, sscores = model.similar_items(7, N=5)
    assert_same_topk((sids, sscores), model.model.similar_items(7, N=5), rtol=1e-4)


def test_wrapper_filters_and_exact_fallback():
    likes = _likes()
    model = _fitted(n_probe=1000)
    ids, _ = model.recommend(0, likes[0], N=5, filter_items=[1, 2, 3])
    assert not {1, 2, 3} & set(ids.tolist())
    assert not set(likes[0].indices.tolist()) & set(ids.tolist())
    exact = _fitted(approximate_recommend=False, approximate_similar_items=False)
    assert exact.recommend_index is None and exact.similar_items_index is None
    np.testing.assert_array_equal(exact.recommend(1, likes[1], N=4)[0],
                                  exact.model.recommend(1, likes[1], N=4)[0])


def test_batched_serving_matches_scalar():
    likes = _likes()
    model = _fitted(n_probe=1000)
    userids = np.arange(20)
    bids, _ = model.recommend(userids, likes[userids], N=5, filter_items=[2, 4])
    assert bids.shape == (20, 5) and not {2, 4} & set(bids.ravel().tolist())
    for r, u in enumerate(userids):
        sids, _ = model.recommend(int(u), likes[[u]], N=5, filter_items=[2, 4])
        np.testing.assert_array_equal(bids[r][: len(sids)], sids)
    sim_b, _ = model.similar_items(np.arange(15), N=4, filter_items=[0])
    assert sim_b.shape == (15, 4)
    for it in range(15):
        sim_s, _ = model.similar_items(it, N=4, filter_items=[0])
        np.testing.assert_array_equal(sim_b[it][: len(sim_s)], sim_s)


def test_factory_is_deterministic_per_random_state():
    likes = _likes()
    builds = [TPUIVFAlternatingLeastSquares(factors=8, iterations=3, random_state=rs,
                                            n_probe=2, kmeans_iters=5, device="cpu")
              for rs in (9, 9)]
    for model in builds:
        model.fit(likes, show_progress=False)
    a, b = (m.recommend_index.to_arrays("") for m in builds)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(builds[0].recommend(2, likes[2], N=5)[0],
                                  builds[1].recommend(2, likes[2], N=5)[0])
    assert builds[0].random_state == 9 and builds[0].kmeans_iters == 5


def test_flags_gate_index_builds(tmp_path):
    rng = np.random.default_rng(5)
    inner = AlternatingLeastSquares(factors=8, device="cpu")
    inner.user_factors = rng.standard_normal((40, 8)).astype(np.float32)
    inner.item_factors = rng.standard_normal((30, 8)).astype(np.float32)
    wrapper = TPUIVFModel(inner, approximate_recommend=False, random_state=3, n_probe=16)
    wrapper._build_indexes(inner.item_factors)
    assert wrapper.similar_items_index is not None and wrapper.recommend_index is None
    likes = csr_matrix(np.ones((1, 30), dtype=np.float32))
    assert len(wrapper.recommend(0, likes, N=5, filter_already_liked_items=False)[0]) == 5
    sids, _ = wrapper.similar_items(3, N=4)
    assert len(sids) == 4
    path = str(tmp_path / "ivf_one_index")
    wrapper.save(path)
    loaded = TPUIVFModel.load(path, device="cpu")
    assert loaded.recommend_index is None
    np.testing.assert_array_equal(loaded.similar_items(3, N=4)[0], sids)


def test_save_before_fit_raises(tmp_path):
    with pytest.raises(ValueError, match="unfitted"):
        TPUIVFModel(AlternatingLeastSquares(factors=8, device="cpu")).save(str(tmp_path / "x"))


def _ratings():
    rng = np.random.default_rng(2)
    likes = sparse_random(150, 80, density=0.1, random_state=rng,
                          data_rvs=lambda n: rng.integers(1, 5, n).astype(np.float64))
    return likes.tocsr()


def _assert_same_serving(got, want, likes):
    for uid in (0, 3, 17):
        assert_same_topk(got.recommend(uid, likes[uid], N=5),
                         want.recommend(uid, likes[uid], N=5), rtol=1e-5)
    assert_same_topk(got.recommend(np.arange(12), likes[:12], N=5),
                     want.recommend(np.arange(12), likes[:12], N=5), rtol=1e-5)
    assert_same_topk(got.similar_items(4, N=5), want.similar_items(4, N=5), rtol=1e-5)
    np.testing.assert_array_equal(got.model.user_factors, want.model.user_factors)
    assert got._probe == want._probe and got.model.factors == want.model.factors


def test_npz_round_trip_port_to_port(tmp_path):
    likes = _ratings()
    model = TPUIVFModel(AlternatingLeastSquares(factors=16, iterations=4, random_state=7,
                                                device="cpu"),
                        n_clusters=8, n_probe=8, random_state=3)
    model.fit(likes, show_progress=False)
    path = str(tmp_path / "ivf_index")
    model.save(path)
    loaded = TPUIVFModel.load(path, device="cpu")
    for uid in (0, 3, 17):
        i1, s1 = model.recommend(uid, likes[uid], N=5)
        i2, s2 = loaded.recommend(uid, likes[uid], N=5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(s1, s2)
    _assert_same_serving(loaded, model, likes)


def test_npz_round_trips_between_the_packages(tmp_path):
    likes = _ratings()
    jmodel = JaxIVFALS(factors=16, iterations=4, random_state=7, n_clusters=8, n_probe=3)
    jmodel.fit(likes, show_progress=False)
    path = str(tmp_path / "jax_ivf.npz")
    jmodel.save(path)
    # JAX -> port, through load and through convert.ivf_from_numpy
    loaded = TPUIVFModel.load(path, device="cpu")
    with np.load(path) as data:
        converted = convert.ivf_from_numpy(dict(data.items()), device="cpu")
    for port in (loaded, converted):
        assert type(port.model) is type(AlternatingLeastSquares(device="cpu"))
        assert port.model.device == CPU and port.similar_items_index.points.device == CPU
        _assert_same_serving(port, jmodel, likes)
    # port -> JAX: the port's save reads back into the JAX package
    back = str(tmp_path / "port_ivf.npz")
    loaded.save(back)
    _assert_same_serving(loaded, jivf.TPUIVFModel.load(back), likes)
    # and a port build too
    model = TPUIVFAlternatingLeastSquares(factors=16, iterations=4, random_state=7,
                                          n_clusters=8, n_probe=3, device="cpu")
    model.fit(likes, show_progress=False)
    model.save(back)
    _assert_same_serving(model, jivf.TPUIVFModel.load(back), likes)
