"""The port's meshed paths on a virtual 8-shard CPU mesh.

The port of ``tests/test_parallel.py``'s ALS and serving cases: ``mesh=8``
(or ``parallel.create_mesh(8, "cpu")``) is eight shards on the one host
device, driven from this process; the sharded paths must give the numbers
of the port's single-device paths, at the JAX tests' own bars: sharding is
a layout decision, not a semantic one. One bar differs, and says why
(``test_row_sharded_fit_matches_single_device``).
"""

import pickle

import numpy as np
import pytest
import torch
from conftest import get_checkerboard
from scipy.sparse import random as sparse_random

from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.models import mf_base
from implicit_tpu_torch.models.als import calculate_loss
from implicit_tpu_torch.ops import als as tals
from implicit_tpu_torch.ops.topk import topk, topk_streaming
from implicit_tpu_torch.parallel import (
    RowShardedBuckets, als_sharded, create_mesh, replicated, shard_buckets, sharded_topk,
)
from implicit_tpu_torch.sparse import BucketedCSR

torch.set_num_threads(2)


def _random_csr(users=64, items=48, seed=0):
    mat = sparse_random(
        users, items, density=0.2, random_state=np.random.RandomState(seed), format="csr"
    )
    mat.data = mat.data.astype(np.float32) * 10 + 1
    return mat


def _likes(users, items, density, seed):
    rng = np.random.default_rng(seed)
    return sparse_random(users, items, density=density, random_state=rng,
                         data_rvs=lambda n: rng.integers(1, 6, n).astype(np.float64)).tocsr()


def ALS(**kw):
    return AlternatingLeastSquares(device="cpu", **kw)


def test_sharded_solve_matches_single_device():
    # the replicated-factor layout: each shard solves its slice of every
    # chunk against its own replica; the solved rows are merged
    Cui = _random_csr()
    users, items = Cui.shape
    factors = 16
    rng = np.random.default_rng(0)
    X0 = rng.random((users, factors), dtype=np.float32) * 0.01
    Y0 = rng.random((items, factors), dtype=np.float32) * 0.01
    reg = 0.01

    buckets = BucketedCSR(Cui)
    X_single = tals.solve_side(torch.tensor(X0), torch.tensor(Y0), buckets.to_device("cpu"),
                               reg)

    mesh = create_mesh(8, "cpu")
    chunks = shard_buckets(buckets, mesh)
    Y = replicated(mesh, Y0)
    YtY = tals.gramian(Y[0], reg)
    X = torch.tensor(X0)
    for k in range(mesh.size):
        Xk = torch.tensor(X0)  # the shard's own replica
        for cls in chunks.classes:
            Xk = tals.cg_solve_scan(Xk, Y[k], YtY, cls.rows[k], cls.indices[k], cls.data[k],
                                    cg_steps=3)
            rows = cls.rows[k][cls.rows[k] < users]
            X[rows] = Xk[rows]
    if chunks.empty_rows is not None:
        X[chunks.empty_rows[0]] = 0.0

    np.testing.assert_allclose(X.numpy(), X_single.numpy(), atol=1e-5)


def test_model_fit_on_mesh():
    Cui = _random_csr(users=80, items=60, seed=3)
    single = ALS(factors=16, iterations=3, random_state=5)
    single.fit(Cui, show_progress=False)
    sharded = ALS(factors=16, iterations=3, random_state=5, mesh=8)
    sharded.fit(Cui, show_progress=False)

    # iterative-CG tolerance: the gramian is a sum of per-shard gramians
    np.testing.assert_allclose(sharded.user_factors, single.user_factors, atol=1e-3, rtol=2e-2)
    ids_a, _ = single.recommend(3, Cui[3])
    ids_b, _ = sharded.recommend(3, Cui[3])
    np.testing.assert_array_equal(ids_a, ids_b)


def _tie_swaps_only(ids_a, sc_a, ids_b, sc_b, rtol):
    """Every position where two top-k rows differ holds ids whose scores in
    ``sc_a`` tie another score of the row within ``rtol``."""
    for r, p in np.argwhere(ids_a != ids_b):
        tied = np.abs(sc_a[r] - sc_a[r][p]) <= rtol * np.abs(sc_a[r][p])
        assert tied.sum() > 1 or p == ids_a.shape[1] - 1, (r, p, sc_a[r], sc_b[r])


def test_row_sharded_fit_matches_single_device():
    """The row-sharded layout: factors, loss and served ids match the single
    device. Factors (atol 5e-3) and loss (1e-3) are held to the JAX test's
    bars. Its positional id bar (> 0.999) is not: this seed's fits differ by
    float32 summation order (the gramian is a sum of eight), which swaps two
    adjacent ids scoring 0.8743 / 0.8743 and 0.9566 / 0.9565 (0.992 of
    positions agree; the JAX package's own fits happened to tie-break
    alike). Held instead to > 0.99 of positions (the bar of the JAX
    package's sibling test) and every differing place a tie within 1e-3 of
    its score (the scores move by about 2e-4 of the factors' scale)."""
    Cui = _random_csr(users=500, items=300, seed=11)
    single = ALS(factors=32, iterations=5, random_state=7)
    single.fit(Cui, show_progress=False)
    meshed = ALS(factors=32, iterations=5, random_state=7, mesh=8)
    meshed.fit(Cui, show_progress=False)

    np.testing.assert_allclose(meshed.user_factors, single.user_factors, atol=5e-3)
    l1 = calculate_loss(Cui, single.user_factors, single.item_factors, 0.01, device="cpu")
    l2 = calculate_loss(Cui, meshed.user_factors, meshed.item_factors, 0.01, device="cpu")
    assert abs(l1 - l2) / l1 < 1e-3

    ids1, sc1 = single.recommend(np.arange(50), Cui[:50], N=10)
    ids2, sc2 = meshed.recommend(np.arange(50), Cui[:50], N=10)
    assert (ids1 == ids2).mean() > 0.99
    _tie_swaps_only(ids1, sc1, ids2, sc2, 1e-3)


def test_row_sharded_fit_matches_single_device_lower_level():
    """``als_sharded.fit`` on the row-sharded layout against ``ops.als.fit``
    on one device, from the same X0 / Y0: the same kernels' formulation per
    shard, so the factors agree to the JAX test's float32 layout noise
    (atol 5e-2), and serving through either agrees (> 0.99 of positions)."""
    mesh = create_mesh(8, "cpu")
    Cui = _random_csr(users=500, items=300, seed=9)
    Ciu = Cui.T.tocsr()
    rng = np.random.default_rng(5)
    X0 = rng.random((500, 32), dtype=np.float32) * 0.01
    Y0 = rng.random((300, 32), dtype=np.float32) * 0.01

    ub = BucketedCSR(Cui).to_device("cpu")
    ib = BucketedCSR(Ciu).to_device("cpu")
    X1, Y1 = tals.fit(torch.tensor(X0), torch.tensor(Y0), ub, ib, 0.01, 3)

    ush = RowShardedBuckets(Cui, mesh)
    ish = RowShardedBuckets(Ciu, mesh)
    Xs = als_sharded.shard_rows(torch.tensor(X0), mesh, ush.block)
    Ys = als_sharded.shard_rows(torch.tensor(Y0), mesh, ish.block)
    Xs, Ys = als_sharded.fit(Xs, Ys, ush, ish, mesh, 0.01, 3)

    X2 = als_sharded.gather_rows(Xs, 500, torch.device("cpu")).numpy()
    Y2 = als_sharded.gather_rows(Ys, 300, torch.device("cpu")).numpy()
    np.testing.assert_allclose(X2, X1.numpy(), atol=5e-2)
    np.testing.assert_allclose(Y2, Y1.numpy(), atol=5e-2)

    s1 = X1[:100].numpy() @ Y1.numpy().T
    s2 = X2[:100] @ Y2.T
    ids1 = np.argsort(-s1, axis=1)[:, :10]
    ids2 = np.argsort(-s2, axis=1)[:, :10]
    assert (ids1 == ids2).mean() > 0.99


def test_row_sharded_empty_rows_and_cholesky():
    """Empty rows are zeroed per shard; the dense normal-equation solve runs
    on the row-sharded layout; its loss equals the bucketed loss."""
    Cui = _random_csr(users=77, items=53, seed=4).tolil()
    Cui[5, :] = 0
    Cui[76, :] = 0
    Cui = Cui.tocsr()
    Cui.eliminate_zeros()

    model = ALS(factors=16, iterations=3, random_state=2, mesh=8, use_cg=False,
                calculate_training_loss=True)
    losses = []
    model.fit(Cui, show_progress=False, callback=lambda e, t, l: losses.append(l))
    assert np.all(model.user_factors[5] == 0)
    assert np.all(model.user_factors[76] == 0)
    assert losses[-1] <= losses[0]

    ref = tals.calculate_loss_bucketed(
        BucketedCSR(Cui), torch.tensor(model.user_factors), torch.tensor(model.item_factors),
        0.01)
    mesh = create_mesh(8, "cpu")
    sh = RowShardedBuckets(Cui, mesh)
    X = als_sharded.shard_rows(torch.tensor(model.user_factors), mesh, sh.block)
    Y = als_sharded.shard_rows(torch.tensor(model.item_factors), mesh,
                               als_sharded._block(Cui.shape[1], 8))
    got = als_sharded.calculate_loss(sh, X, Y, 0.01, mesh)
    assert abs(got - ref) / abs(ref) < 1e-4


def test_sharded_topk_matches_single_device():
    rng = np.random.default_rng(1)
    items = rng.standard_normal((512, 32), dtype=np.float32)
    queries = rng.standard_normal((16, 32), dtype=np.float32)

    mesh = create_mesh(8, "cpu")
    vals, ids = sharded_topk(torch.tensor(items), torch.tensor(queries), 10, mesh)

    scores = queries @ items.T
    oracle_ids = np.argsort(-scores, axis=1)[:, :10]
    oracle_vals = np.take_along_axis(scores, oracle_ids, axis=1)
    np.testing.assert_allclose(vals.numpy(), oracle_vals, atol=1e-5)
    # ids may differ on exact ties only
    assert (ids.numpy() == oracle_ids).mean() > 0.99


# 496 = 8 * 62, the JAX test's count; 497 leaves the last shard with 55
# rows and 7 padding rows, which must never surface
@pytest.mark.parametrize("n_items", [496, 497])
def test_sharded_topk_uneven_shards(n_items):
    rng = np.random.default_rng(2)
    items = rng.standard_normal((n_items, 16), dtype=np.float32)
    queries = rng.standard_normal((4, 16), dtype=np.float32)

    mesh = create_mesh(8, "cpu")
    vals, ids = sharded_topk(torch.tensor(items), torch.tensor(queries), 5, mesh)
    scores = queries @ items.T
    oracle = np.sort(scores, axis=1)[:, ::-1][:, :5]
    np.testing.assert_allclose(vals.numpy(), oracle, atol=1e-5)
    assert (ids.numpy() < n_items).all()


def test_mesh_recommend_matches_single_device():
    """recommend / similar_* on a mesh return single-device serving's results
    (ids identical; scores to float tolerance: each shard's product is a
    slice of the whole one)."""
    likes = _likes(120, 90, 0.08, 9)
    single = ALS(factors=16, iterations=5, random_state=3)
    single.fit(likes, show_progress=False)
    meshed = ALS(factors=16, iterations=5, random_state=3, mesh=8)
    meshed.user_factors = single.user_factors.copy()
    meshed.item_factors = single.item_factors.copy()

    userids = np.arange(120)
    for args, kw in (((userids, likes), dict(N=10)),
                     ((3, likes[3]), dict(N=5, filter_items=[1, 2, 3])),
                     ((5, likes[5]), dict(N=8, items=np.arange(0, 90, 3)))):
        i1, s1 = single.recommend(*args, **kw)
        i2, s2 = meshed.recommend(*args, **kw)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(s1, s2, atol=1e-5)

    i1, s1 = single.similar_items(np.arange(20), N=5)
    i2, s2 = meshed.similar_items(np.arange(20), N=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)

    i1, s1 = single.similar_users(7, N=5)
    i2, s2 = meshed.similar_users(7, N=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)


def test_mesh_recommend_over_ask_and_empty():
    """Over-asking N pads with -1 sentinels alike on the mesh path."""
    likes = get_checkerboard(40)
    single = ALS(factors=8, iterations=4, random_state=1)
    single.fit(likes, show_progress=False)
    meshed = ALS(factors=8, iterations=4, random_state=1, mesh=8)
    meshed.user_factors = single.user_factors.copy()
    meshed.item_factors = single.item_factors.copy()

    i1, s1 = single.recommend(0, likes[0], N=500, filter_already_liked_items=False)
    i2, s2 = meshed.recommend(0, likes[0], N=500, filter_already_liked_items=False)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)


def test_meshed_model_pickles():
    """A model holding a Mesh stores it as its size and still serves after
    the restore (a CPU mesh restores as create_mesh(8, "cpu"))."""
    likes = get_checkerboard(30)
    model = ALS(factors=8, iterations=4, random_state=1, mesh=create_mesh(8, "cpu"))
    model.fit(likes, show_progress=False)
    i1, s1 = model.recommend(1, likes[1], N=3)

    restored = pickle.loads(pickle.dumps(model))
    assert restored.mesh == 8
    assert restored._serving_mesh() == create_mesh(8, "cpu")
    i2, s2 = restored.recommend(1, likes[1], N=3)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)


def test_mesh_recommend_pipelined():
    """recommend_pipelined over a mesh equals per-batch meshed recommend."""
    likes = _likes(100, 70, 0.1, 21)
    model = ALS(factors=16, iterations=4, random_state=5, mesh=8)
    model.fit(likes, show_progress=False)

    batches = [np.arange(0, 40), np.arange(40, 100)]
    out = list(model.recommend_pipelined(((b, likes[b]) for b in batches), N=7))
    assert len(out) == 2
    for b, (ids, scores) in zip(batches, out):
        ref_ids, ref_scores = model.recommend(b, likes[b], N=7)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_allclose(scores, ref_scores, atol=1e-5)


def test_mesh_serving_bf16_table():
    """16-bit models serve through a bfloat16 sharded table; mesh and single
    device agree (both score the same rounded table)."""
    likes = _likes(100, 80, 0.1, 4)
    single = ALS(factors=16, iterations=4, random_state=5, dtype=np.float16)
    single.fit(likes, show_progress=False)
    meshed = ALS(factors=16, random_state=5, dtype=np.float16, mesh=8)
    meshed.user_factors = single.user_factors.copy()
    meshed.item_factors = single.item_factors.copy()

    table = meshed._factors_on_mesh("item", meshed._serving_mesh())
    assert all(s.dtype == torch.bfloat16 for s in table.shards)

    userids = np.arange(100)
    i1, s1 = single.recommend(userids, likes, N=8)
    i2, s2 = meshed.recommend(userids, likes, N=8)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)

    i1, s1 = single.similar_items(np.arange(20), N=5)
    i2, s2 = meshed.similar_items(np.arange(20), N=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-4)


def test_mesh_serving_bf16_subset_consistent():
    """items= / users= subsets on a mesh score the same bfloat16-rounded
    table as the full catalog: self-similarity stays 1, and subset results
    agree with the single-device subset path."""
    likes = _likes(80, 60, 0.12, 6)
    single = ALS(factors=16, iterations=4, random_state=2, dtype=np.float16)
    single.fit(likes, show_progress=False)
    meshed = ALS(factors=16, random_state=2, dtype=np.float16, mesh=8)
    meshed.user_factors = single.user_factors.copy()
    meshed.item_factors = single.item_factors.copy()

    subset = np.arange(0, 60, 2)
    for model in (single, meshed):
        ids, scores = model.similar_items(np.arange(0, 20, 2), N=5, items=subset)
        np.testing.assert_array_equal(ids[:, 0], np.arange(0, 20, 2))
        np.testing.assert_allclose(scores[:, 0], 1.0, atol=1e-5)

    i1, s1 = single.recommend(np.arange(10), likes[:10], N=5, items=subset)
    i2, s2 = meshed.recommend(np.arange(10), likes[:10], N=5, items=subset)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)


def test_row_sharded_on_device_pack_matches_host():
    """Every shard's tensors against a numpy reconstruction from the CSR,
    on rows stored out of column order: each real row's first ``lengths``
    entries are its CSR entries with the columns mapped to shard order,
    every other entry is 0; each non-empty row sits in exactly one chunk
    row of its shard, each empty row in its shard's ``empty_rows``."""
    D = 8
    mesh = create_mesh(D, "cpu")
    csr = _likes(150, 90, 0.15, 21)
    rng = np.random.default_rng(3)
    order = np.concatenate([lo + rng.permutation(hi - lo)
                            for lo, hi in zip(csr.indptr[:-1], csr.indptr[1:])])
    csr = csr.__class__((csr.data[order], csr.indices[order], csr.indptr), shape=csr.shape)
    sh = RowShardedBuckets(csr, mesh, grid="fine")
    block, col_block = sh.block, sh.col_block
    assert (block, col_block, sh.shape, sh.nnz) == (19, 12, csr.shape, csr.nnz)
    lengths = np.diff(csr.indptr)
    for k, shard in enumerate(sh.shards):
        seen = []
        for cls in shard.classes:
            rows, lens = cls.rows.numpy(), cls.lengths.numpy()
            idx, dat = cls.indices.numpy(), cls.data.numpy()
            assert (cls.indices.dtype, cls.data.dtype) == (torch.int32, torch.float32)
            assert cls.n_valid == [int(n) for n in (rows != block).sum(1)]
            want_idx, want_dat = np.zeros_like(idx), np.zeros_like(dat)
            for c, j in zip(*np.nonzero(rows != block)):
                g = rows[c, j] * D + k
                lo, hi = csr.indptr[g], csr.indptr[g + 1]
                cols = csr.indices[lo:hi]
                assert lens[c, j] == hi - lo <= cls.L
                want_idx[c, j, :hi - lo] = (cols % D) * col_block + cols // D
                want_dat[c, j, :hi - lo] = csr.data[lo:hi]
                seen.append(g)
            assert not lens[rows == block].any()
            np.testing.assert_array_equal(idx, want_idx)
            np.testing.assert_array_equal(dat, want_dat)
        own = np.arange(k, csr.shape[0], D)
        assert sorted(seen) == own[lengths[own] > 0].tolist()
        empty = [] if shard.empty_rows is None else shard.empty_rows.tolist()
        assert empty == (own[lengths[own] == 0] // D).tolist()


def test_row_sharded_fit_on_device_pack_end_to_end():
    """mesh= ALS through the device pack trains to the single device's
    factors (the JAX test's tightened bar, atol 2e-4)."""
    likes = _likes(90, 60, 0.12, 22)
    single = ALS(factors=16, iterations=6, random_state=4)
    single.fit(likes, show_progress=False)
    meshed = ALS(factors=16, iterations=6, random_state=4, mesh=8, ingest="device")
    meshed.fit(likes, show_progress=False)
    np.testing.assert_allclose(single.user_factors, meshed.user_factors, atol=2e-4)
    np.testing.assert_allclose(single.item_factors, meshed.item_factors, atol=2e-4)


@pytest.mark.parametrize("mesh", [7, 8])
def test_fit_callback_and_training_loss_with_and_without_a_mesh(mesh):
    """One fit loop serves both: the callback sees every iteration in order
    with its seconds and the training loss, and the meshed fit's losses are
    the unmeshed fit's (the factors agree to 2e-4, as above), on a mesh
    that divides neither side's rows (7) and one that divides the items'."""
    likes = _likes(90, 60, 0.12, 22)
    calls = {}
    for m in (None, mesh):
        model = ALS(factors=16, iterations=4, random_state=4, mesh=m,
                    calculate_training_loss=True)
        model.fit(likes, show_progress=False,
                  callback=lambda it, secs, loss, out=calls.setdefault(m, []):
                  out.append((it, secs, loss)))
        assert model.user_factors.shape == (90, 16) and model.item_factors.shape == (60, 16)
    for m in (None, mesh):
        assert [it for it, _, _ in calls[m]] == [0, 1, 2, 3]
        assert all(secs >= 0 and isinstance(loss, float) for _, secs, loss in calls[m])
    losses = np.array([[loss for _, _, loss in calls[m]] for m in (None, mesh)])
    assert losses[0, -1] < losses[0, 0]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_streaming_topk_on_mesh_matches_single_device():
    """topk_streaming(mesh=): each block cut over the shards, their
    candidates merged per block, gives the single-device streaming path's
    and the resident top-k's results across filters, norms, block
    boundaries and k > n_items."""
    mesh = create_mesh(8, "cpu")
    rng = np.random.default_rng(31)
    items = rng.standard_normal((700, 24)).astype(np.float32)
    queries = rng.standard_normal((33, 24)).astype(np.float32)
    qf = sparse_random(33, 700, density=0.05, random_state=np.random.RandomState(32),
                       format="csr")
    qf.data[:] = 1.0
    fi = rng.choice(700, size=40, replace=False)
    norms = np.linalg.norm(items, axis=1)

    kw = dict(item_norms=norms, filter_query_items=qf, filter_items=fi)
    ids_r, vals_r = topk(torch.tensor(items), queries, 10, **kw)
    ids_s, vals_s = topk_streaming(items, queries, 10, block_rows=256, device="cpu", **kw)
    ids_m, vals_m = topk_streaming(items, queries, 10, block_rows=256, mesh=mesh, **kw)
    np.testing.assert_array_equal(ids_r, ids_m)
    np.testing.assert_array_equal(ids_s, ids_m)
    np.testing.assert_allclose(vals_r, vals_m, rtol=1e-6)

    # no filters or norms; a block size that is no multiple of the mesh
    ids_r2, _ = topk(torch.tensor(items), queries, 7)
    ids_m2, _ = topk_streaming(items, queries, 7, block_rows=100, mesh=mesh)
    np.testing.assert_array_equal(ids_r2, ids_m2)

    # k past the catalog pads with -1 as on one device
    small = items[:7]
    ids_r3, _ = topk(torch.tensor(small), queries[:3], 12)
    ids_m3, _ = topk_streaming(small, queries[:3], 12, block_rows=128, mesh=mesh)
    np.testing.assert_array_equal(ids_r3, ids_m3)
    assert (ids_m3[:, 7:] == -1).all()


def test_meshed_model_streams_beyond_pooled_budget(monkeypatch):
    """A meshed model whose table is over the mesh's pooled budget serves by
    streaming, each block cut over the shards, with the resident single
    device's results; under the pooled budget, the sharded table serves."""
    rng = np.random.default_rng(33)
    users, items_n, f = 90, 120, 16
    uf = rng.standard_normal((users, f)).astype(np.float32)
    itf = rng.standard_normal((items_n, f)).astype(np.float32)
    likes = sparse_random(users, items_n, density=0.1, random_state=np.random.RandomState(34),
                          format="csr")
    likes.data[:] = 1.0

    resident = ALS(factors=f)
    resident.user_factors = uf.copy()
    resident.item_factors = itf.copy()
    userids = np.arange(40)
    r_ids, r_scores = resident.recommend(userids, likes[userids], N=8)
    r_sim, _ = resident.similar_items(np.arange(20), N=6)

    # a threshold under the table's bytes / 8: even the pooled budget overflows
    monkeypatch.setattr(mf_base, "_stream_threshold_bytes", lambda device: 128)
    meshed = ALS(factors=f, mesh=8)
    meshed.user_factors = uf.copy()
    meshed.item_factors = itf.copy()
    m_ids, m_scores = meshed.recommend(userids, likes[userids], N=8)
    m_sim, _ = meshed.similar_items(np.arange(20), N=6)

    np.testing.assert_array_equal(r_ids, m_ids)
    np.testing.assert_allclose(r_scores, m_scores, rtol=1e-6)
    np.testing.assert_array_equal(r_sim, m_sim)
    # the sharded tables were never built
    assert not any(k[0] in ("user", "item") for k in meshed._mesh_serving_cache)

    # over one device's budget but under the pooled one: sharded again
    table_bytes = items_n * f * 4
    monkeypatch.setattr(mf_base, "_stream_threshold_bytes", lambda device: table_bytes // 4)
    meshed2 = ALS(factors=f, mesh=8)
    meshed2.user_factors = uf.copy()
    meshed2.item_factors = itf.copy()
    m2_ids, _ = meshed2.recommend(userids, likes[userids], N=8)
    np.testing.assert_array_equal(r_ids, m2_ids)
    assert any(k[0] == "item" for k in meshed2._mesh_serving_cache)


def test_row_sharded_gather_quant_matches_single_device():
    """gather_quant over the mesh: each shard quantizes its own rows before
    the gather (per-row scales, so the quantized table is the whole one's).
    Held on behaviour, as the JAX test is: int8 rounding at .5 boundaries
    flips under summation-order noise, so the loss (within 2%) and the
    recommendation overlap (> 0.8)."""
    Cui = _random_csr(users=400, items=250, seed=13)
    single = ALS(factors=32, iterations=4, random_state=7, gather_quant=True)
    single.fit(Cui, show_progress=False)
    meshed = ALS(factors=32, iterations=4, random_state=7, mesh=8, gather_quant=True)
    meshed.fit(Cui, show_progress=False)

    l1 = calculate_loss(Cui, single.user_factors, single.item_factors, 0.01, device="cpu")
    l2 = calculate_loss(Cui, meshed.user_factors, meshed.item_factors, 0.01, device="cpu")
    assert abs(l1 - l2) / abs(l1) < 0.02
    ids1, _ = single.recommend(np.arange(40), Cui[:40], N=10)
    ids2, _ = meshed.recommend(np.arange(40), Cui[:40], N=10)
    overlap = np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(ids1, ids2)])
    assert overlap > 0.8, overlap


def test_mesh_of_one_equals_no_mesh():
    """At D = 1 the row-sharded layout is the single device's: the same
    rows, chunks and column ids, the sentinel n_rows, one gramian with no
    sum. The meshed fit gives the unmeshed factors bit for bit."""
    Cui = _random_csr(users=200, items=120, seed=2)
    single = ALS(factors=16, iterations=3, random_state=3)
    single.fit(Cui, show_progress=False)
    meshed = ALS(factors=16, iterations=3, random_state=3, mesh=1)
    meshed.fit(Cui, show_progress=False)
    np.testing.assert_array_equal(meshed.user_factors, single.user_factors)
    np.testing.assert_array_equal(meshed.item_factors, single.item_factors)


def test_float64_model_on_mesh_solves_float32():
    """A float64 model's meshed fit solves float32 (ROADMAP C23, the JAX
    meshed fit's rule) and stores float64: it equals the float32 model's
    meshed fit, widened."""
    Cui = _random_csr(users=120, items=80, seed=6)
    out = {}
    for dtype in (np.float32, np.float64):
        model = ALS(factors=8, iterations=2, random_state=1, dtype=dtype, mesh=4)
        model.fit(Cui, show_progress=False)
        assert model.user_factors.dtype == dtype
        out[dtype] = model.user_factors
    np.testing.assert_array_equal(out[np.float64], out[np.float32].astype(np.float64))


def test_partial_fit_drops_the_mesh_tables():
    likes = get_checkerboard(24)
    model = ALS(factors=8, iterations=2, random_state=1, mesh=4)
    model.fit(likes, show_progress=False)
    model.recommend(0, likes[0])
    model.similar_users(0)
    assert {k[0] for k in model._mesh_serving_cache} >= {"user", "item"}
    model.partial_fit_users([2], likes[[3]])
    assert not any(k[0] == "user" for k in model._mesh_serving_cache)
    model.partial_fit_items([2], likes.T.tocsr()[[3]])
    assert not any(k[0] == "item" for k in model._mesh_serving_cache)
    single = ALS(factors=8)
    single.user_factors, single.item_factors = model.user_factors, model.item_factors
    np.testing.assert_array_equal(model.recommend(2, likes[2])[0],
                                  single.recommend(2, likes[2])[0])
