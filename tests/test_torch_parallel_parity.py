"""The port's meshed paths against the JAX package's, on the same numpy inputs.

JAX runs on the 8 virtual CPU devices ``conftest.py`` sets up; the port on
a virtual CPU mesh of the same size (``parallel.create_mesh(D, "cpu")``).

- The row-sharded layout (``RowShardedBuckets``) must equal the JAX
  package's tensor for tensor, exactly: rows stored in column order and
  out of it, both grids, D in {1, 3, 8}, a matrix with empty rows and one
  whose row count D does not divide.
- The meshed fits start from the same numpy X0 / Y0. JAX runs
  ``als_sharded.fit(..., use_pallas=True)``, so its interpreted kernels
  route every class as the port does (ROADMAP C2). float32 is held to 2e-3
  of the factors' scale (C2's bar, as ``tests/test_torch_als.py`` holds the
  single-device fit); bfloat16 with ``gather_quant`` to 5% of the float32
  solution's scale (C5: the port keeps the CG vectors in float32); the
  dense normal-equation solve to rtol 1e-3, atol 1e-4 (float32 rounding of
  one direct solve per row); the loss to 1e-5 relative.
- Meshed serving gives the JAX meshed calls' ids up to exact ties (C15,
  C20) and scores within 1e-6 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from test_torch_topk_streaming import assert_same_topk

from implicit_tpu.als import AlternatingLeastSquares as JALS
from implicit_tpu.parallel import als_sharded as jsh
from implicit_tpu.parallel import create_mesh as jmesh
from implicit_tpu.parallel import sharded_topk as jsharded_topk
from implicit_tpu.parallel.mesh import replicated as jreplicated
from implicit_tpu_torch import convert
from implicit_tpu_torch.als import AlternatingLeastSquares as TALS
from implicit_tpu_torch.parallel import als_sharded as tsh
from implicit_tpu_torch.parallel import create_mesh as tmesh
from implicit_tpu_torch.parallel import sharded_topk as tsharded_topk

torch.set_num_threads(2)

F = 16


def _plays(seed=0, users=700, items=60, head=4):
    """Users x items with ``head`` items liked by ~90% of users (item rows
    longer than 512, so the item side routes to the gramian kernel) and a
    sparse tail."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(users, items) < 0.1).astype(np.float32)
    dense[:, :head] = rng.rand(users, head) < 0.9
    dense *= (rng.rand(users, items) * 10 + 1).astype(np.float32)
    dense[rng.rand(users, items) < 0.02] *= -1  # some "disliked" entries
    return sp.csr_matrix(dense)


def _matrix(kind, order="sorted"):
    """"empty": 203 x 97 with every 7th row and column empty; "uneven": 301 x
    59, no row count a multiple of 3 or 8, and long rows. ``order``
    "unsorted" stores every row's entries in a shuffled order, so a row's
    first stored column is not its smallest."""
    rng = np.random.RandomState(3)
    if kind == "empty":
        dense = (rng.rand(203, 97) < 0.15) * (rng.rand(203, 97) * 9 + 1)
        dense[::7] = 0
        dense[:, ::7] = 0
    else:
        dense = (rng.rand(301, 59) < 0.3) * (rng.rand(301, 59) * 9 + 1)
        dense[:, :3] = rng.rand(301, 3) * 9 + 1
    m = sp.csr_matrix(dense.astype(np.float32))
    if order == "unsorted":
        shuffle = np.random.default_rng(4)
        perm = np.concatenate([lo + shuffle.permutation(hi - lo)
                               for lo, hi in zip(m.indptr[:-1], m.indptr[1:])])
        m = sp.csr_matrix((m.data[perm], m.indices[perm], m.indptr), shape=m.shape)
    return m


@functools.lru_cache(maxsize=None)
def _jax_layout(kind, order, grid, D):
    sh = jsh.RowShardedBuckets(_matrix(kind, order), jmesh(D), grid=grid, on_device_pack=False,
                               target_entries=1024, max_chunk_rows=64)
    empty = None if sh.empty_rows is None else np.asarray(sh.empty_rows)
    return sh, empty, [(c.L, np.asarray(c.rows), np.asarray(c.indices), np.asarray(c.data))
                       for c in sh.classes]


@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("grid", ["pow2", "fine"])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("kind", ["empty", "uneven"])
def test_row_sharded_buckets_equal_jax(kind, order, grid, D):
    # small chunks (target 1024 entries, 64 rows) so classes cut into
    # several pieces, shorter shards padded with the sentinel
    jb, jempty, jclasses = _jax_layout(kind, order, grid, D)
    tb = tsh.RowShardedBuckets(_matrix(kind, order), tmesh(D, "cpu"), grid=grid,
                               target_entries=1024, max_chunk_rows=64)
    assert (tb.block, tb.col_block, tb.shape, tb.nnz) == \
        (jb.block, jb.col_block, jb.shape, jb.nnz)
    for k, shard in enumerate(tb.shards):
        want_empty = None if jempty is None else jempty[k][jempty[k] != jb.block]
        if want_empty is None or not len(want_empty):
            assert shard.empty_rows is None
        else:
            np.testing.assert_array_equal(shard.empty_rows.numpy(), want_empty)
        assert len(shard.classes) == len(jclasses)
        for cls, (L, rows, idx, dat) in zip(shard.classes, jclasses):
            assert cls.L == L
            np.testing.assert_array_equal(cls.rows.numpy(), rows[k])
            np.testing.assert_array_equal(cls.indices.numpy(), idx[k])
            np.testing.assert_array_equal(cls.data.numpy(), dat[k])
            assert cls.n_valid == [int(n) for n in (rows[k] != jb.block).sum(1)]


@pytest.mark.parametrize("D", [1, 3, 8])
def test_permute_rows_equal_jax(D):
    x = np.random.default_rng(D).standard_normal((101, 5)).astype(np.float32)
    block = tsh._block(101, D)
    assert block == jsh._block(101, D)
    got = tsh.permute_rows(x, D, block)
    want = jsh.permute_rows(x, D, block)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tsh.unpermute_rows(got, D, block, 101).numpy(),
                                  jsh.unpermute_rows(want, D, block, 101))
    np.testing.assert_array_equal(tsh.unpermute_rows(got, D, block, 101).numpy(), x)


def _start(users, items, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((users, F), dtype=np.float32) * 0.1,
            rng.random((items, F), dtype=np.float32) * 0.1)


def _fits(Cui, X0, Y0, iterations, reg=0.05, **kw):
    """JAX's and the port's meshed fits on D = 8 from X0 / Y0: (JAX's, the
    port's) (X, Y) as numpy, and the two layouts of the user side."""
    Ciu = Cui.T.tocsr()
    jm, tm = jmesh(8), tmesh(8, "cpu")
    jush, jish = jsh.RowShardedBuckets(Cui, jm), jsh.RowShardedBuckets(Ciu, jm)
    tush, tish = tsh.RowShardedBuckets(Cui, tm), tsh.RowShardedBuckets(Ciu, tm)
    shd = NamedSharding(jm, P("d", None))
    jX, jY = jsh.fit(jax.device_put(jsh.permute_rows(X0, 8, jush.block), shd),
                     jax.device_put(jsh.permute_rows(Y0, 8, jish.block), shd),
                     jush, jish, jm, reg, iterations, use_pallas=True, **kw)
    tX, tY = tsh.fit(tsh.shard_rows(torch.tensor(X0), tm, tush.block),
                     tsh.shard_rows(torch.tensor(Y0), tm, tish.block),
                     tush, tish, tm, reg, iterations, **kw)
    users, items = Cui.shape
    cpu = torch.device("cpu")
    jax_out = (jsh.unpermute_rows(jX, 8, jush.block, users),
               jsh.unpermute_rows(jY, 8, jish.block, items))
    port_out = (tsh.gather_rows(tX, users, cpu).numpy(), tsh.gather_rows(tY, items, cpu).numpy())
    return jax_out, port_out, (jush, jX, jY, jm), (tush, tX, tY, tm)


def test_meshed_fit_float32_matches_jax():
    Cui = _plays(seed=2)
    X0, Y0 = _start(*Cui.shape, seed=3)
    jout, tout, (jush, jX, jY, jm), (tush, tX, tY, tm) = _fits(Cui, X0, Y0, 2)
    for got, want in zip(tout, jout):
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    # the losses the two meshed layouts report for each package's result
    jl = jsh.calculate_loss(jush, jX, jY, 0.05, jm)
    tl = tsh.calculate_loss(tush, tX, tY, 0.05, tm)
    assert tl == pytest.approx(jl, rel=2e-3)
    # and for the same factors: the loss itself within 1e-5
    shd = NamedSharding(jm, P("d", None))
    jl_same = jsh.calculate_loss(
        jush, jax.device_put(jsh.permute_rows(tout[0], 8, jush.block), shd),
        jax.device_put(jsh.permute_rows(tout[1], 8, tsh._block(Cui.shape[1], 8)), shd), 0.05, jm)
    assert tl == pytest.approx(jl_same, rel=1e-5)


def test_meshed_fit_bfloat16_gather_quant_matches_jax():
    Cui = _plays(seed=4)
    X0, Y0 = _start(*Cui.shape, seed=5)
    _, f32, _, _ = _fits(Cui, X0, Y0, 1)
    jout, tout, _, _ = _fits(Cui, X0, Y0, 1, compute_dtype="bfloat16", gather_quant=True)
    for got, want, ref in zip(tout, jout, f32):
        scale = np.abs(ref).max()
        assert np.abs(got - want).max() < 0.05 * scale
        assert np.abs(got - ref).max() < 0.05 * scale


def test_meshed_fit_cholesky_matches_jax():
    Cui = _plays(seed=6, users=300)
    X0, Y0 = _start(*Cui.shape, seed=7)
    jout, tout, _, _ = _fits(Cui, X0, Y0, 1, reg=0.1, use_cg=False)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_sharded_topk_matches_jax():
    rng = np.random.default_rng(1)
    items = rng.standard_normal((512, 32), dtype=np.float32)
    queries = rng.standard_normal((16, 32), dtype=np.float32)
    jm = jmesh(8)
    jv, ji = jsharded_topk(jreplicated(jm, items), jreplicated(jm, queries), 10, jm)
    tv, ti = tsharded_topk(torch.tensor(items), torch.tensor(queries), 10, tmesh(8, "cpu"))
    assert_same_topk((ti.numpy().astype(np.int32), tv.numpy()),
                     (np.asarray(ji, dtype=np.int32), np.asarray(jv)))


def _models(dtype=np.float32):
    rng = np.random.default_rng(9)
    likes = sp.random(120, 90, density=0.08, random_state=rng,
                      data_rvs=lambda n: rng.integers(1, 6, n).astype(np.float64)).tocsr()
    uf = rng.standard_normal((120, F)).astype(dtype)
    itf = rng.standard_normal((90, F)).astype(dtype)
    jm = JALS(factors=F, dtype=dtype, mesh=8)
    tm = TALS(factors=F, dtype=dtype, mesh=8, device="cpu")
    for m in (jm, tm):
        m.user_factors, m.item_factors = uf.copy(), itf.copy()
    return likes, jm, tm


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_meshed_serving_matches_jax(dtype):
    # float16 models serve bfloat16 tables: JAX's CPU GEMM rounds the scores
    # to bfloat16 (C6), so those scores are held to bfloat16's step
    likes, jm, tm = _models(dtype)
    rtol = 1e-6 if dtype == np.float32 else 8e-3
    users = np.arange(120)
    calls = [
        lambda m: m.recommend(users, likes, N=10),
        lambda m: m.recommend(3, likes[3], N=5, filter_items=[1, 2, 3]),
        lambda m: m.recommend(users[:10], likes[:10], N=8, items=np.arange(0, 90, 3)),
        lambda m: m.similar_items(np.arange(20), N=5),
        lambda m: m.similar_users(np.arange(7), N=5),
    ]
    for call in calls:
        assert_same_topk(call(tm), call(jm), rtol=rtol)


def test_jax_meshed_model_serves_on_a_port_mesh():
    """A JAX meshed fit's factors, carried over through
    ``convert.als_from_numpy``, serve on a port mesh with JAX's ids."""
    Cui = _plays(seed=8, users=200)
    jmodel = JALS(factors=F, iterations=3, random_state=4, mesh=8)
    jmodel.fit(Cui, show_progress=False)
    tmodel = convert.als_from_numpy(convert.numpy_params(jmodel), device="cpu")
    tmodel.mesh = 8
    users = np.arange(200)
    assert_same_topk(tmodel.recommend(users, Cui, N=10), jmodel.recommend(users, Cui, N=10))
    assert_same_topk(tmodel.similar_items(np.arange(60), N=10),
                     jmodel.similar_items(np.arange(60), N=10))
    assert tmodel._serving_mesh() == tmesh(8, "cpu")
    assert {k[0] for k in tmodel._mesh_serving_cache} >= {"item"}
    # the same ids as the port's single device serving the same factors
    single = convert.als_from_numpy(convert.numpy_params(jmodel), device="cpu")
    assert_same_topk(tmodel.recommend(users, Cui, N=10), single.recommend(users, Cui, N=10))


def test_meshed_model_fit_matches_jax_model():
    """The model-level meshed fits, same random_state: the same starting
    factors (numpy's draws) and layout. JAX's model solves its composed
    formulation off the TPU, so the two differ by that route's float32
    rounding (C2): held to 2e-3 of the factors' scale at one iteration."""
    Cui = _plays(seed=10, users=300)
    jmodel = JALS(factors=F, iterations=1, random_state=6, mesh=8)
    jmodel.fit(Cui, show_progress=False)
    tmodel = TALS(factors=F, iterations=1, random_state=6, mesh=8, device="cpu")
    tmodel.fit(Cui, show_progress=False)
    for got, want in ((tmodel.user_factors, jmodel.user_factors),
                      (tmodel.item_factors, jmodel.item_factors)):
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
