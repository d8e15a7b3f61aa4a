"""The port's LMF (``implicit_tpu_torch/models/lmf.py``) against the JAX
package's, fed the same draws.

The row update takes its draws (window offsets, or legacy entry positions)
as tensors, so the JAX function's ``jax.random`` draws, replicated on the
host, go into the port's. Tolerances:

- ``_row_update`` and a whole class update against JAX's, in the split,
  glued and legacy branches, from a warm AdaGrad accumulator (a cold one
  divides by sqrt(1e-6) and turns any rounding into a full step,
  ``tests/test_lmf.py:104-108``): within 1e-4 of the output's scale. Both
  round the same operands to bfloat16 and sum in float32, in other orders;
- ``neg_prop=0`` (no bfloat16 term) against the sequential transcription of
  the reference's ``lmf_update``: rtol 1e-5, atol 1e-6; with negatives at
  the oracle test's bfloat16 bar (rtol 2e-2, atol 5e-3);
- starting factors, pools and arrangements bit for bit; quality within 0.03
  p@10 of the JAX package's (the draws differ: ROADMAP C4).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import get_checkerboard
from scipy.sparse import csr_matrix
from test_update_oracles import lmf_update_row_oracle

from implicit_tpu.models import lmf as jax_lmf
from implicit_tpu.sparse import pack_pair_on_device as jax_pack_pair
from implicit_tpu_torch.lmf import LogisticMatrixFactorization
from implicit_tpu_torch.models import lmf
from implicit_tpu_torch.sparse import pack_pair_on_device

torch.set_num_threads(2)


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a.astype(np.int64) if np.issubdtype(a.dtype, np.integer) else a)


def _within_scale(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _pool_pair(Y, arr, route):
    """(JAX neg_src, port neg_src) of a route: a split or glued window pool
    of Y through ``arr``, or the raw column array (legacy)."""
    if route == "legacy":
        return jnp.asarray(arr), _t(arr)
    split = route == "split"
    want = jax_lmf._build_pool(jnp.asarray(Y), jnp.asarray(arr), split)
    got = lmf._build_pool(torch.as_tensor(Y), _t(arr), split)
    for g, w in zip(*((got, want) if split else ((got,), (want,)))):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w).astype(np.float32))
    return want, got


def _draw(ckey, G, neg_count, span, route):
    """The draw JAX's _row_update makes from ``ckey``."""
    shape = (G,) if route != "legacy" else (G, neg_count)
    return jax.random.randint(ckey, shape, 0, span)


def _chunk(rng, C, L, F, items, n_rows):
    """One chunk's tensors: ragged lengths (padding data 0), the last row a
    sentinel (id n_rows), and warm starting rows."""
    X = rng.standard_normal((n_rows, F)).astype(np.float32) * 0.3
    dss = (0.5 + rng.random((n_rows, F))).astype(np.float32)  # warm AdaGrad
    Y = rng.standard_normal((items, F)).astype(np.float32) * 0.3
    crows = rng.choice(n_rows, size=C, replace=False).astype(np.int32)
    crows[-1] = n_rows
    clen = rng.integers(1, L + 1, size=C).astype(np.int32)
    clen[-1] = 0
    cidx = rng.integers(0, items, size=(C, L)).astype(np.int32)
    cdat = (rng.random((C, L)) * 4 + 1).astype(np.float32)
    pad = np.arange(L)[None, :] >= clen[:, None]
    cidx[pad], cdat[pad] = 0, 0.0
    return X, dss, Y, crows, cidx, cdat, clen


ROUTES = ["split", "glued", "legacy"]


@pytest.mark.parametrize("route", ROUTES)
def test_row_update_matches_jax(route):
    rng = np.random.default_rng(3)
    C, L, F, items, neg_prop = 21, 8, 10, 90, 3  # C not a multiple of 8: a padded group
    X, dss, Y, crows, cidx, cdat, clen = _chunk(rng, C, L, F, items, n_rows=40)
    arr = rng.integers(0, items, size=300).astype(np.int32)
    span, neg_count = len(arr) - L * neg_prop, min(items, L * neg_prop)
    jsrc, src = _pool_pair(Y, arr, route)
    ckey = jax.random.PRNGKey(5)
    lr, reg = 1.0, 0.6
    want = jax_lmf._row_update(
        jnp.asarray(X), jnp.asarray(dss), jnp.asarray(Y), jsrc, span, jnp.asarray(crows),
        jnp.asarray(cidx), jnp.asarray(cdat), jnp.asarray(clen), ckey, jnp.float32(lr),
        jnp.float32(reg), neg_prop, neg_count, window=route != "legacy")
    draw = _draw(ckey, -(-C // 8), neg_count, span, route)
    got = lmf._row_update(
        torch.as_tensor(X), torch.as_tensor(dss), torch.as_tensor(Y), src, _t(crows),
        _t(cidx), torch.as_tensor(cdat), torch.as_tensor(clen), _t(draw), lr, reg, neg_prop,
        neg_count, window=route != "legacy")
    for g, w in zip(got, want):
        _within_scale(g.numpy(), w, 1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_class_update_matches_jax(route):
    """A whole bucket class, several chunks and sentinel rows, with the pin:
    the JAX package's host pack and the port's pack cut the same chunks."""
    rng = np.random.default_rng(8)
    users, items, F, neg_prop = 70, 50, 10, 2
    dense = (rng.random((users, items)) < 0.25) * (rng.random((users, items)) * 4 + 1)
    ui = csr_matrix(dense.astype(np.float32))
    iu = ui.T.tocsr()
    kw = dict(target_entries=128, grid="pow2")
    jb, _ = jax_pack_pair(ui, iu, mode="host", **kw)
    pb, _ = pack_pair_on_device(ui, iu, device="cpu", **kw)
    X = rng.standard_normal((users, F)).astype(np.float32) * 0.3
    X[:, -2] = 1.0
    dss = (0.5 + rng.random((users, F))).astype(np.float32)
    Y = rng.standard_normal((items, F)).astype(np.float32) * 0.3
    arr = rng.permutation(ui.indices).astype(np.int32)
    span = ui.nnz
    Lmax = max(c.L for c in pb.classes)
    arr = np.concatenate([arr, arr[:Lmax * neg_prop]])
    jsrc, src = _pool_pair(Y, arr, route)
    window = route != "legacy"
    lr, reg = 1.0, 0.6
    Xg, dg = torch.as_tensor(X.copy()), torch.as_tensor(dss.copy())
    Xw, dw = jnp.asarray(X), jnp.asarray(dss)
    assert any(c.n_chunks > 1 for c in pb.classes)
    for ci, (jc, pc) in enumerate(zip(jb.classes, pb.classes)):
        np.testing.assert_array_equal(pc.rows.numpy(), np.asarray(jc.rows))
        np.testing.assert_array_equal(pc.indices.numpy(), np.asarray(jc.indices))
        neg_count = min(items, pc.L * neg_prop)
        keys = jax.random.split(jax.random.PRNGKey(ci), pc.n_chunks)
        Xw, dw = jax_lmf._lmf_class_update(
            Xw, dw, jnp.asarray(Y), jsrc, span, jc.rows, jc.indices, jc.data, jc.lengths, keys,
            jnp.float32(lr), jnp.float32(reg), jnp.int32(neg_prop), neg_count, -2, window)
        draws = [_t(_draw(k, -(-pc.C // 8), neg_count, span, route)) for k in keys]
        lmf._lmf_class_update(Xg, dg, torch.as_tensor(Y), src, pc, draws, lr, reg, neg_prop,
                              neg_count, -2, window)
    np.testing.assert_array_equal(Xg[:, -2].numpy(), 1.0)
    _within_scale(Xg.numpy(), Xw, 1e-4)
    _within_scale(dg.numpy(), dw, 1e-4)


def test_row_update_positives_and_adagrad_match_pyx_exactly():
    """neg_prop=0 removes the bfloat16 negative term."""
    rng = np.random.default_rng(9)
    items, F = 20, 10
    Y = (rng.standard_normal((items, F)) * 0.3).astype(np.float32)
    x0 = (rng.standard_normal(F) * 0.3).astype(np.float32)
    d0 = (rng.random(F) * 0.1).astype(np.float32)
    cols = np.array([2, 5, 11, 17], dtype=np.int64)
    cdat = np.array([3.0, 1.0, 2.0, 5.0], dtype=np.float32)
    neg_src = torch.as_tensor(np.repeat(np.arange(items), 3))
    x, d = lmf._row_update(
        torch.as_tensor(x0)[None], torch.as_tensor(d0)[None], torch.as_tensor(Y), neg_src,
        torch.tensor([0]), torch.as_tensor(cols)[None], torch.as_tensor(cdat)[None],
        torch.tensor([4], dtype=torch.int32), torch.zeros((1, 0), dtype=torch.int64), 1.0, 0.6,
        0, 0, window=False)
    x_o, d_o = lmf_update_row_oracle(x0, d0, Y, cols, cdat, [], 1.0, 0.6)
    np.testing.assert_allclose(x[0].numpy(), x_o, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d[0].numpy(), d_o, rtol=1e-5, atol=1e-6)


def test_row_update_with_negatives_matches_pyx_at_bf16_tolerance():
    rng = np.random.default_rng(12)
    items, F, neg_prop = 24, 10, 5
    Y = (rng.standard_normal((items, F)) * 0.3).astype(np.float32)
    x0 = (rng.standard_normal(F) * 0.3).astype(np.float32)
    d0 = (0.5 + rng.random(F)).astype(np.float32)
    cols = np.array([1, 4, 9], dtype=np.int64)
    cdat = np.array([2.0, 4.0, 1.0], dtype=np.float32)
    neg_src = np.concatenate([np.full(i // 4 + 1, i) for i in range(items)])
    neg_count = min(items, len(cols) * neg_prop)
    nidx = rng.integers(0, len(neg_src), size=(1, neg_count))
    x, d = lmf._row_update(
        torch.as_tensor(x0)[None], torch.as_tensor(d0)[None], torch.as_tensor(Y),
        torch.as_tensor(neg_src), torch.tensor([0]), torch.as_tensor(cols)[None],
        torch.as_tensor(cdat)[None], torch.tensor([3], dtype=torch.int32), torch.as_tensor(nidx),
        1.0, 0.6, neg_prop, neg_count, window=False)
    x_o, d_o = lmf_update_row_oracle(x0, d0, Y, cols, cdat, neg_src[nidx[0]], 1.0, 0.6)
    np.testing.assert_allclose(x[0].numpy(), x_o, rtol=2e-2, atol=5e-3)
    np.testing.assert_allclose(d[0].numpy(), d_o, rtol=5e-2, atol=5e-3)


# -- the model -------------------------------------------------------------------


@pytest.mark.parametrize("factors", [8, 128], ids=["glued", "split"])
def test_arrangements_and_start_equal_jax(factors, monkeypatch, caplog):
    """The same random_state gives the JAX package's starting factors and
    pool arrangements (read where each fit builds its first pools), and
    the same routes."""
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(150, 90, 2000, seed=2)
    seen = {"jax": [], "port": []}

    def spy(name, module):
        build = module._build_pool
        monkeypatch.setattr(module, "_build_pool", lambda Y, arr, split: (
            seen[name].append((np.asarray(arr), split)), build(Y, arr, split))[1])

    spy("jax", jax_lmf)
    spy("port", lmf)
    kw = dict(factors=factors, iterations=1, random_state=11, neg_prop=4)
    jmodel = jax_lmf.LogisticMatrixFactorization(**kw)
    model = LogisticMatrixFactorization(**kw, device="cpu")
    start = {}
    for m in (jmodel, model):
        m0 = type(m)(**{**kw, "iterations": 0}, **({} if m is jmodel else {"device": "cpu"}))
        m0.fit(plays, show_progress=False)
        start[m is jmodel] = (m0.user_factors, m0.item_factors)
    np.testing.assert_array_equal(start[True][0], start[False][0])
    np.testing.assert_array_equal(start[True][1], start[False][1])
    jmodel.fit(plays, show_progress=False)
    with caplog.at_level(logging.DEBUG, logger="implicit_tpu_torch"):
        model.fit(plays, show_progress=False)
    assert len(seen["jax"]) == len(seen["port"]) == 2  # user side, then item side
    for (a, sa), (b, sb) in zip(seen["jax"], seen["port"]):
        assert sa == sb == (factors == 128)
        np.testing.assert_array_equal(a, b.numpy() if hasattr(b, "numpy") else b)
    tails = "split" if factors == 128 else "glued"
    assert f"user side window, item side window, tails {tails}" in caplog.text


def test_reshuffle_keeps_multiset_and_wrap_pad():
    core = torch.as_tensor(np.repeat(np.arange(50), np.arange(1, 51)))
    gen = torch.Generator().manual_seed(0)
    out = lmf._reshuffle_arrangement(gen, core, 70)
    assert out.shape == (len(core) + 70,)
    np.testing.assert_array_equal(np.sort(out[: len(core)].numpy()), np.sort(core.numpy()))
    np.testing.assert_array_equal(out[len(core):].numpy(), out[:70].numpy())
    assert not torch.equal(out, lmf._reshuffle_arrangement(gen, core, 70))
    # pools wider than the multiset wrap more than once, as the host's _wrap_pad
    small = torch.arange(5)
    wide = lmf._reshuffle_arrangement(gen, small, 12)
    np.testing.assert_array_equal(wide.numpy(), lmf._wrap_pad(wide[:5].numpy(), 12))


def test_route_rules_are_jax_rules():
    for width in (10, 32, 34, 128, 129, 130, 131, 258, 259):
        assert lmf._pool_split(width) == jax_lmf._pool_split(width)
        for nnz, pmax in ((1000, 64), (17_500_000, 1 << 17)):
            assert lmf._pool_bytes(nnz, pmax, width) == jax_lmf._pool_bytes(nnz, pmax, width)
    assert lmf._POOL_BYTE_BUDGET == jax_lmf._POOL_BYTE_BUDGET


def test_factor_layout():
    likes = csr_matrix(np.ones((6, 5), dtype=np.float32))
    model = LogisticMatrixFactorization(factors=4, iterations=3, random_state=1, device="cpu")
    model.fit(likes, show_progress=False)
    assert model.user_factors.shape == (6, 6) and model.item_factors.shape == (5, 6)
    np.testing.assert_array_equal(model.user_factors[:, -2], 1.0)
    np.testing.assert_array_equal(model.item_factors[:, -1], 1.0)


def test_empty_matrix():
    model = LogisticMatrixFactorization(factors=2, iterations=2, random_state=0, device="cpu")
    model.fit(csr_matrix(np.zeros((3, 3), dtype=np.float32)), show_progress=False)


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_finite_factors(dtype):
    rng = np.random.RandomState(3)
    mat = (rng.rand(40, 30) < 0.2).astype(np.float32)
    model = LogisticMatrixFactorization(factors=8, iterations=10, random_state=3, dtype=dtype,
                                        device="cpu")
    model.fit(csr_matrix(mat), show_progress=False)
    assert model.user_factors.dtype == dtype
    assert np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all()


def test_window_pool_marginal_is_popularity_weighted():
    """A window of the shuffled multiset at a uniform offset gives every
    slot equal probability, so the marginal is the popularity distribution."""
    cols = np.array([0] * 4000 + [1] * 2000 + [2] * 1000)
    rng = np.random.default_rng(5)
    P = 512
    arr = torch.as_tensor(lmf._arrangement(rng, cols, P, True).astype(np.int64))
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(3)
    for _ in range(40):
        off = torch.randint(0, len(cols), (16,), generator=gen)
        counts += np.bincount(arr[off[:, None] + torch.arange(P)].numpy().ravel(), minlength=3)
    np.testing.assert_allclose(counts / counts.sum(), [4 / 7, 2 / 7, 1 / 7], atol=0.01)


def test_grouped_pools_decorrelate_rows():
    """Rows in different 8-row groups of a chunk see different pools; rows
    of one group the same."""
    rng = np.random.RandomState(0)
    C, L, F, items = 16, 4, 8, 50
    Y = torch.as_tensor(rng.rand(items, F).astype(np.float32))
    arr = torch.as_tensor(rng.randint(0, items, size=464))
    pool = lmf._build_pool(Y, arr, True)
    X = torch.as_tensor(np.tile(rng.rand(1, F).astype(np.float32), (C, 1)))
    cidx = torch.as_tensor(np.tile(rng.randint(0, items, size=(1, L)), (C, 1)))
    cdat = torch.as_tensor(np.tile(rng.rand(1, L).astype(np.float32) + 1, (C, 1)))
    dss = torch.full((C, F), 10.0)  # warm: the step follows the gradient
    x, _ = lmf._row_update(X, dss, Y, pool, torch.arange(C), cidx, cdat,
                           torch.full((C,), L, dtype=torch.int32), torch.tensor([3, 300]),
                           1.0, 0.0, 1, 8)
    np.testing.assert_allclose(x[0].numpy(), x[7].numpy())
    assert np.abs((x[0] - x[8]).numpy()).max() > 1e-3


def test_legacy_fallback_trains(monkeypatch, caplog):
    monkeypatch.setattr(lmf, "_POOL_BYTE_BUDGET", 0)
    rng = np.random.RandomState(5)
    mat = (rng.rand(50, 40) < 0.2).astype(np.float32)
    model = LogisticMatrixFactorization(factors=6, iterations=8, random_state=5, device="cpu")
    with caplog.at_level(logging.DEBUG, logger="implicit_tpu_torch"):
        model.fit(csr_matrix(mat), show_progress=False)
    assert "user side legacy, item side legacy" in caplog.text
    assert np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all()


def test_split_pool_scores_are_full_dot_products():
    rng = np.random.RandomState(4)
    S, F = 200, 10
    Y = torch.as_tensor(rng.rand(50, F).astype(np.float32))
    arr = torch.as_tensor(rng.randint(0, 50, size=S))
    pf, t0, t1 = lmf._build_pool(Y, arr, True)
    x = rng.rand(3, F).astype(np.float32)
    off, P = 17, 20
    block = pf[off:off + P].float().numpy()
    split = (x[:, :F - 2] @ block.T + x[:, F - 2:F - 1] * t0[off:off + P].float().numpy()
             + x[:, F - 1:F] * t1[off:off + P].float().numpy())
    full = x @ Y.numpy()[arr.numpy()[off:off + P]].T
    np.testing.assert_allclose(split, full, rtol=2e-2, atol=1e-2)  # bfloat16 pool


def test_long_fit_with_reshuffle_converges():
    likes = get_checkerboard(40)
    model = LogisticMatrixFactorization(factors=8, iterations=12, random_state=3, device="cpu")
    model.fit(likes * 3, show_progress=False)
    ids, _ = model.recommend(2, likes[2], N=1)
    assert ids[0] == 2


def test_neg_prop_zero_and_callback():
    likes = get_checkerboard(20)
    calls = []
    model = LogisticMatrixFactorization(factors=6, iterations=3, neg_prop=0, random_state=1,
                                        device="cpu")
    model.fit(likes, show_progress=False, callback=lambda e, t: calls.append(e))
    assert calls == [0, 1, 2] and np.isfinite(model.user_factors).all()


def test_precision_close_to_jax_on_clustered_set():
    """The mean p@10 over four seeds: one seed's p@10 moves by up to 0.03
    with the draws alone (in either package)."""
    from implicit_tpu.evaluation import precision_at_k as jax_precision_at_k
    from implicit_tpu_torch.datasets.synthetic import get_synthetic_clustered
    from implicit_tpu_torch.evaluation import precision_at_k, train_test_split

    likes = get_synthetic_clustered(users=600, items=240, groups=8, likes_per_user=16, seed=7)
    train, test = train_test_split(likes, train_percentage=0.8, random_state=19)
    kw = dict(factors=30, iterations=30)
    got, want = [], []
    for seed in range(4):
        jmodel = jax_lmf.LogisticMatrixFactorization(**kw, random_state=seed)
        jmodel.fit(train, show_progress=False)
        model = LogisticMatrixFactorization(**kw, random_state=seed, device="cpu")
        model.fit(train, show_progress=False)
        want.append(jax_precision_at_k(jmodel, train, test, K=10, show_progress=False))
        got.append(precision_at_k(model, train, test, K=10, show_progress=False))
    assert min(got) > 0.5 and abs(np.mean(got) - np.mean(want)) <= 0.03, (got, want)
