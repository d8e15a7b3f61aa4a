"""The JAX package's contract cases that no other port test runs, against
the port on the CPU: ``tests/test_parity_gaps.py``'s five (small-NaN fits,
an almost empty matrix, recalculation after a pickle, N beyond the catalog,
the to_gpu / to_cpu shims), an ``items=`` subset that pads with -1, and a
long row solved with ``regularization=0`` staying finite."""

import pickle

import numpy as np
import scipy.sparse as sp
import torch
from conftest import get_checkerboard
from scipy.sparse import coo_matrix, csr_matrix

from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.bpr import BayesianPersonalizedRanking


def _checker(n):
    dense = np.indices((n, n)).sum(axis=0) % 2
    return csr_matrix(dense.astype(np.float32))


def test_small_nan():
    # factors larger than users/items must not produce NaNs
    likes = coo_matrix((np.ones(10), (np.arange(10), np.arange(10)))).tocsr()
    model = AlternatingLeastSquares(factors=15, random_state=0, device="cpu")
    model.fit(likes, show_progress=False)

    ids, scores = model.recommend(0, likes[0], N=10, filter_already_liked_items=False)
    assert not np.isnan(scores).any()
    assert ids[0] == 0  # the only liked item ranks first


def test_fit_almost_empty_matrix():
    raw = [[0, 0, 0], [0, 1, 0], [0, 0, 0]]
    BayesianPersonalizedRanking(random_state=1, device="cpu").fit(
        csr_matrix(np.array(raw, dtype=np.float32)), show_progress=False
    )


def test_recalculate_after_pickle():
    user_items = _checker(10)
    model = AlternatingLeastSquares(factors=2, regularization=0.1, random_state=3, device="cpu")
    model.fit(user_items, show_progress=False)

    original_ids, _ = model.recommend(0, user_items[0], recalculate_user=True)
    model = pickle.loads(pickle.dumps(model))
    ids, _ = model.recommend(0, user_items[0], recalculate_user=True)
    np.testing.assert_array_equal(ids, original_ids)


def test_large_recommend():
    # N beyond the catalog: results pad with id -1 / -FLT_MAX instead of failing
    plays = _checker(64)
    model = AlternatingLeastSquares(factors=8, random_state=5, device="cpu")
    model.fit(plays, show_progress=False)

    ids, scores = model.similar_items(0, N=100)
    assert ids.shape == (100,)
    assert ids[0] == 0
    assert (ids[64:] == -1).all()

    ids, scores = model.recommend(0, plays[0], N=100, filter_already_liked_items=False)
    assert ids.shape == (100,)
    valid = ids[ids >= 0]
    assert len(np.unique(valid)) == len(valid)


def test_to_gpu_to_cpu_shims():
    """The reference's conversion idioms work unchanged: with one
    implementation, whose device is ``device=``, they are the identity."""
    model = AlternatingLeastSquares(factors=8, iterations=2, random_state=0, device="cpu")
    likes = coo_matrix((np.ones(10), (np.arange(10), np.arange(10)))).tocsr()
    model.fit(likes, show_progress=False)

    gpu = model.to_gpu()
    assert gpu is model
    back = gpu.to_cpu()
    assert back is model
    ids, _ = back.recommend(0, likes[0], N=3, filter_already_liked_items=False)
    assert ids[0] == 0


def test_similar_items_small_subset_pads_with_sentinel():
    # items= subsets smaller than N pad with id -1, never duplicate a real id
    likes = csr_matrix(get_checkerboard(10))
    model = AlternatingLeastSquares(factors=4, iterations=5, random_state=3, device="cpu")
    model.fit(likes, show_progress=False)

    subset = [1, 2, 4]
    ids, scores = model.similar_items(1, N=10, items=subset)
    valid = ids[ids >= 0]
    assert set(valid) <= set(subset)
    assert len(valid) == len(set(valid))  # no duplicates
    assert (ids[len(subset):] == -1).all()

    # batch form keeps the same semantics
    ids_b, _ = model.similar_items(np.array([1, 3]), N=10, items=subset)
    for row in ids_b:
        v = row[row >= 0]
        assert set(v) <= set(subset)
        assert len(v) == len(set(v))


def test_long_row_solve_finite_without_regularization():
    # rows longer than the matrix-free CG limit route to the gramian CG;
    # with regularization=0 the normal matrix can be (nearly) rank-deficient,
    # which CG must tolerate (a Cholesky would produce NaNs)
    from implicit_tpu_torch.ops import als as als_ops
    from implicit_tpu_torch.sparse import BucketedCSR

    rng = np.random.default_rng(0)
    users, items, factors = 4, 600, 8
    dense = np.zeros((users, items), dtype=np.float32)
    dense[:, :550] = rng.random((users, 550)) + 1.0  # L > 512 per row
    Cui = sp.csr_matrix(dense)

    buckets = BucketedCSR(Cui)
    assert max(c.L for c in buckets.classes) > als_ops._full_cg_max_l(torch.float32, factors)

    X = torch.as_tensor(rng.random((users, factors), dtype=np.float32))
    # nearly rank-deficient: Cholesky of A breaks down in f32
    Yh = rng.random((items, factors), dtype=np.float32)
    Yh[:, factors // 2:] = Yh[:, : factors // 2] + 1e-5 * rng.standard_normal(
        (items, factors // 2)
    ).astype(np.float32)
    Y = torch.as_tensor(Yh)
    X = als_ops.solve_side(X, Y, buckets, reg=0.0)
    assert torch.isfinite(X).all()
