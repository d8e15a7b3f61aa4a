"""The port's BPR (``implicit_tpu_torch/models/bpr.py``) against the JAX
package's, fed the same draws.

The epochs take their index draws as tensors, so the JAX functions' draws
(``jax.random`` calls replicated on the host) go into the port's epochs:

- the sampled epoch at batch 1 against the sequential transcription of the
  reference's ``bpr_update`` (``tests/test_update_oracles.py``): rtol 1e-4,
  atol 2e-5 (the oracle test's own bar), counts exact;
- the sampled epoch at batches where rows collide, and the grouped epoch
  (also in its two pool modes), against JAX's ``_bpr_epoch`` and
  ``_bpr_epoch_grouped``: within 1e-5 of the output's scale (float32 sums
  in another order), counts exact;
- the starting factors, the pool modes' arrangement and the epochs' seed
  bit for bit; ``epoch_mode``, ``BPR_GROUPED`` and ``mesh`` route a fit to
  the JAX package's epoch; quality within 0.03 p@10 of the JAX package's
  (the draws differ, so that parity is statistical, ROADMAP C4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import get_checkerboard
from scipy import sparse
from scipy.sparse import csr_matrix
from test_update_oracles import _replicate_bpr_draws, bpr_update_oracle

from implicit_tpu.models import bpr as jax_bpr
from implicit_tpu.sparse import BucketedCSR as JaxBucketedCSR
from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
from implicit_tpu_torch.models import bpr
from implicit_tpu_torch.ops import membership

torch.set_num_threads(2)


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is None and np.issubdtype(a.dtype, np.integer):
        dtype = np.int64
    return torch.as_tensor(a.astype(dtype) if dtype else a)


def _within_scale(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _likes(users, items, density, seed):
    likes = sparse.random(users, items, density=density, random_state=seed, format="csr",
                          dtype=np.float32)
    likes.data[:] = 1.0
    likes.sort_indices()
    return likes


def _verifier(likes, verifier):
    """(port table, port bits, JAX table, JAX mh) of a verifier."""
    if verifier == "bisection":
        return None, None, jnp.zeros((1, 1), dtype=jnp.uint16), None
    pt = membership.build_pair_table(likes)
    return pt.to_device("cpu"), pt.bits, jnp.asarray(pt.table), pt.bits


def _bisect_iters(likes):
    return int(np.ceil(np.log2(max(int(np.ediff1d(likes.indptr).max()), 2)))) + 1


def _step_draws(key, steps, batch, n_samples):
    """The JAX sampled epoch's draws, as the port's per-step tensors."""
    pairs = np.asarray(_replicate_bpr_draws(key, steps, batch, n_samples)).reshape(steps, batch, 2)
    return [(_t(p[:, 0]), _t(p[:, 1])) for p in pairs]


# -- the sampled epoch ----------------------------------------------------------


@pytest.mark.parametrize("verify_neg,verifier", [
    (True, "cuckoo"), (True, "bisection"), (False, "bisection")])
def test_sampled_epoch_matches_pyx_transcription(verify_neg, verifier):
    rng = np.random.default_rng(5)
    users, items, factors = 40, 30, 8
    likes = _likes(users, items, 0.3, 7)
    userids = np.repeat(np.arange(users, dtype=np.int32), np.ediff1d(likes.indptr))
    itemids = likes.indices.astype(np.int32)
    X0 = (rng.standard_normal((users, factors + 1)) * 0.1).astype(np.float32)
    X0[:, factors] = 1.0
    Y0 = (rng.standard_normal((items, factors + 1)) * 0.1).astype(np.float32)
    lr, reg, steps = 0.05, 0.01, 48
    key = jax.random.PRNGKey(11)

    Xo, Yo = X0.copy(), Y0.copy()
    correct_o, skipped_o = bpr_update_oracle(
        _replicate_bpr_draws(key, steps, 1, len(itemids)), userids, itemids, likes.indptr,
        Xo, Yo, lr, reg, verify_neg)
    assert skipped_o > 0 if verify_neg else skipped_o == 0

    table, bits, _, _ = _verifier(likes, verifier)
    X, Y, yb = _t(X0[:, :factors]), _t(Y0[:, :factors]), _t(Y0[:, factors])
    correct, skipped = bpr._bpr_epoch(
        X, Y, yb, _t(userids), _t(itemids), _t(likes.indptr), table,
        _step_draws(key, steps, 1, len(itemids)), lr, reg, verify_neg,
        _bisect_iters(likes), bits)
    assert (int(correct), int(skipped)) == (correct_o, skipped_o)
    for got, want in ((X, Xo[:, :factors]), (Y, Yo[:, :factors]), (yb, Yo[:, factors])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("verifier", ["cuckoo", "bisection"])
@pytest.mark.parametrize("batch", [8, 64])
def test_sampled_epoch_matches_jax_epoch(batch, verifier):
    rng = np.random.default_rng(6)
    users, items, factors = 40, 30, 8
    likes = _likes(users, items, 0.3, 8)
    userids = np.repeat(np.arange(users, dtype=np.int32), np.ediff1d(likes.indptr))
    itemids = likes.indices.astype(np.int32)
    X0 = (rng.standard_normal((users, factors)) * 0.1).astype(np.float32)
    Y0 = (rng.standard_normal((items, factors)) * 0.1).astype(np.float32)
    yb0 = (rng.standard_normal(items) * 0.1).astype(np.float32)
    key, steps, lr, reg = jax.random.PRNGKey(3), 16, 0.05, 0.01
    table, bits, jtable, mh = _verifier(likes, verifier)

    want = jax_bpr._bpr_epoch(
        jnp.asarray(X0), jnp.asarray(Y0), jnp.asarray(yb0), jnp.asarray(userids),
        jnp.asarray(itemids), jnp.asarray(likes.indptr.astype(np.int32)), jtable, key,
        jnp.float32(lr), jnp.float32(reg), steps=steps, batch=batch, verify_neg=True,
        bisect_iters=_bisect_iters(likes), mh=mh)
    X, Y, yb = _t(X0), _t(Y0), _t(yb0)
    correct, skipped = bpr._bpr_epoch(
        X, Y, yb, _t(userids), _t(itemids), _t(likes.indptr), table,
        _step_draws(key, steps, batch, len(itemids)), lr, reg, True, _bisect_iters(likes), bits)
    assert (int(correct), int(skipped)) == (int(want[3]), int(want[4]))
    assert int(skipped) > 0
    for got, w in zip((X, Y, yb), want[:3]):
        _within_scale(got.numpy(), w, 1e-5)


# -- the grouped epoch -----------------------------------------------------------


def _grouped_matrix():
    """Rows for several length classes: a class of ~300-entry rows cut into
    two full chunks and a partial one (sentinel rows at its end), short
    rows (partial chunks of other classes), an empty row, a row longer than
    1/(lr reg) = 500, and stored explicit zeros."""
    rng = np.random.default_rng(21)
    users, items = 460, 700
    lengths = np.concatenate([rng.integers(290, 321, size=420), rng.integers(1, 30, size=38),
                              [0, 600]])
    dense = np.zeros((users, items), dtype=np.float32)
    for u, n in enumerate(lengths):
        dense[u, rng.choice(items, size=n, replace=False)] = rng.random(n) * 5 + 1
    M = csr_matrix(dense)
    M.data[::97] = 0.0  # stored explicit zeros: still positives
    return M


def _grouped_draws(key, classes, n_samples):
    """The JAX grouped epoch's draws (pool_mode=0), per chunk in order."""
    out = []
    for ci, (rows, idx, _) in enumerate(classes):
        keys = jax.random.split(jax.random.fold_in(key, ci), rows.shape[0])
        out += [_t(jax.random.randint(k, idx.shape[1:], 0, n_samples)) for k in keys]
    return out


@pytest.mark.parametrize("verifier", ["cuckoo", "bisection"])
def test_grouped_epoch_matches_jax_epoch(verifier):
    M = _grouped_matrix()
    assert M.nnz > (M.data != 0).sum()  # explicit zeros stored
    users, items = M.shape
    F, lr, reg = 16, 0.05, 0.04
    rng = np.random.default_rng(22)
    X0 = (rng.standard_normal((users, F)) * 0.1).astype(np.float32)
    Y0 = (rng.standard_normal((items, F)) * 0.1).astype(np.float32)
    yb0 = (rng.standard_normal(items) * 0.1).astype(np.float32)

    binary = M.copy()
    binary.data[:] = 1.0
    jclasses = tuple((c.rows, c.indices, c.data) for c in JaxBucketedCSR(
        binary, target_entries=1 << 16, max_chunk_rows=8192).to_device().classes)
    classes = bpr.grouped_classes(M, "cpu")
    # the same chunks, sentinel rows included
    assert len(classes) == len(jclasses) > 2
    for (rows, idx, dat, n_valid), (jrows, jidx, jdat) in zip(classes, jclasses):
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(dat.numpy(), np.asarray(jdat))
        assert n_valid == [int(n) for n in (np.asarray(jrows) != users).sum(1)]
    assert max(rows.shape[0] for rows, *_ in classes) >= 2  # a class of several chunks
    assert any((np.asarray(r) == users).any() for r, *_ in jclasses)

    table, bits, jtable, mh = _verifier(M, verifier)
    key = jax.random.PRNGKey(9)
    want = jax_bpr._bpr_epoch_grouped(
        jnp.asarray(X0), jnp.asarray(Y0), jnp.asarray(yb0), jclasses,
        jnp.asarray(M.indices.astype(np.int32)), jnp.asarray(M.indptr.astype(np.int32)),
        jtable, jnp.zeros((1,), jnp.int32), key, jnp.float32(lr), jnp.float32(reg),
        verify_neg=True, bisect_iters=_bisect_iters(M), mh=mh, pool_mode=0)
    X, Y, yb = _t(X0), _t(Y0), _t(yb0)
    correct, skipped = bpr._bpr_epoch_grouped(
        X, Y, yb, classes, _t(M.indices), _t(M.indptr), table,
        _grouped_draws(key, jclasses, M.nnz), lr, reg, True, _bisect_iters(M), bits)
    assert (int(correct), int(skipped)) == (int(want[3]), int(want[4]))
    assert int(skipped) > 0
    for got, w in zip((X, Y, yb), want[:3]):
        _within_scale(got.numpy(), w, 1e-5)
    np.testing.assert_array_equal(X[users - 2].numpy(), X0[users - 2])  # the empty row


def _pool_offsets(key, classes, n_arrangement):
    """The JAX grouped epoch's window offsets (pool modes), per chunk in
    order."""
    out = []
    for ci, (rows, idx, _) in enumerate(classes):
        keys = jax.random.split(jax.random.fold_in(key, ci), rows.shape[0])
        span = n_arrangement - idx.shape[2]
        out += [_t(jax.random.randint(k, (rows.shape[1],), 0, span)) for k in keys]
    return out


@pytest.mark.parametrize("verifier", ["cuckoo", "bisection"])
@pytest.mark.parametrize("pool_mode", [2, 1])
def test_grouped_pool_epoch_matches_jax_epoch(pool_mode, verifier):
    M = _grouped_matrix()
    users, items = M.shape
    F, lr, reg = 16, 0.05, 0.04
    rng = np.random.default_rng(23)
    X0 = (rng.standard_normal((users, F)) * 0.1).astype(np.float32)
    Y0 = (rng.standard_normal((items, F)) * 0.1).astype(np.float32)
    yb0 = (rng.standard_normal(items) * 0.1).astype(np.float32)
    binary = M.copy()
    binary.data[:] = 1.0
    jclasses = tuple((c.rows, c.indices, c.data) for c in JaxBucketedCSR(
        binary, target_entries=1 << 16, max_chunk_rows=8192).to_device().classes)
    classes = bpr.grouped_classes(M, "cpu")
    arr = bpr.pool_arrangement(rng, M, max(idx.shape[2] for _, idx, _, _ in classes))
    assert len(arr) == M.nnz + max(idx.shape[2] for _, idx, _, _ in classes)

    table, bits, jtable, mh = _verifier(M, verifier)
    key = jax.random.PRNGKey(10)
    want = jax_bpr._bpr_epoch_grouped(
        jnp.asarray(X0), jnp.asarray(Y0), jnp.asarray(yb0), jclasses,
        jnp.asarray(M.indices.astype(np.int32)), jnp.asarray(M.indptr.astype(np.int32)),
        jtable, jnp.asarray(arr), key, jnp.float32(lr), jnp.float32(reg),
        verify_neg=True, bisect_iters=_bisect_iters(M), mh=mh, pool_mode=pool_mode)
    X, Y, yb = _t(X0), _t(Y0), _t(yb0)
    correct, skipped = bpr._bpr_epoch_grouped(
        X, Y, yb, classes, _t(M.indices), _t(M.indptr), table,
        _pool_offsets(key, jclasses, len(arr)), lr, reg, True, _bisect_iters(M), bits,
        pool_mode=pool_mode, arrangement=_t(arr))
    assert (int(correct), int(skipped)) == (int(want[3]), int(want[4]))
    assert int(skipped) > 0
    for got, w in zip((X, Y, yb), want[:3]):
        _within_scale(got.numpy(), w, 1e-5)
    np.testing.assert_array_equal(X[users - 2].numpy(), X0[users - 2])  # the empty row


# -- the model -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
@pytest.mark.parametrize("epoch_mode", ["grouped", "sampled", "grouped_pool", "grouped_pool_ids"])
def test_starting_factors_equal_jax(epoch_mode, dtype):
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(300, 200, 6000, seed=4)
    jmodel = jax_bpr.BayesianPersonalizedRanking(factors=8, iterations=0, random_state=5,
                                                 epoch_mode=epoch_mode, dtype=dtype)
    jmodel.fit(plays, show_progress=False)
    model = BayesianPersonalizedRanking(factors=8, iterations=0, random_state=5,
                                        epoch_mode=epoch_mode, dtype=dtype, device="cpu")
    model.fit(plays, show_progress=False)
    assert model.user_factors.dtype == dtype
    np.testing.assert_array_equal(model.user_factors, jmodel.user_factors)
    np.testing.assert_array_equal(model.item_factors, jmodel.item_factors)


def test_empty_matrix():
    raw = [[0.0, 2.0, 1.5], [0.0, 0.0, 0.0]]
    model = BayesianPersonalizedRanking(factors=2, iterations=2, random_state=0, device="cpu")
    model.fit(csr_matrix(np.zeros((3, 3), dtype=np.float32)), show_progress=False)
    model = BayesianPersonalizedRanking(factors=2, iterations=2, random_state=0, device="cpu")
    model.fit(csr_matrix(np.array(raw, dtype=np.float32)), show_progress=False)
    assert np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all()


@pytest.mark.parametrize("epoch_mode", ["grouped", "sampled", "grouped_pool",
                                        "grouped_pool_ids"])
def test_factor_layout(epoch_mode):
    likes = csr_matrix(np.ones((6, 5), dtype=np.float32))
    model = BayesianPersonalizedRanking(factors=4, iterations=3, random_state=1,
                                        epoch_mode=epoch_mode, device="cpu")
    model.fit(likes, show_progress=False)
    assert model.user_factors.shape == (6, 5) and model.item_factors.shape == (5, 5)
    np.testing.assert_array_equal(model.user_factors[:, -1], 1.0)


@pytest.mark.parametrize("epoch_mode", ["grouped", "sampled", "grouped_pool",
                                        "grouped_pool_ids"])
def test_unliked_users_items_zeroed(epoch_mode):
    mat = np.zeros((5, 5), dtype=np.float32)
    mat[0, 0] = mat[1, 1] = mat[2, 2] = 1.0
    model = BayesianPersonalizedRanking(factors=3, iterations=2, random_state=2,
                                        epoch_mode=epoch_mode, device="cpu")
    model.fit(csr_matrix(mat), show_progress=False)
    np.testing.assert_array_equal(model.user_factors[4, :-1], 0.0)
    np.testing.assert_array_equal(model.user_factors[4, -1], 1.0)
    np.testing.assert_array_equal(model.item_factors[4], 0.0)


@pytest.mark.parametrize("verify", [True, False])
@pytest.mark.parametrize("epoch_mode", ["grouped", "sampled"])
def test_checkerboard_and_stats(epoch_mode, verify):
    cb = get_checkerboard(40)
    stats = []
    model = BayesianPersonalizedRanking(factors=31, learning_rate=0.01, regularization=0,
                                        random_state=42, epoch_mode=epoch_mode,
                                        verify_negative_samples=verify, device="cpu")
    model.fit(cb, show_progress=False, callback=lambda e, t, c, s: stats.append((c, s)))
    ids, _ = model.recommend(np.arange(40), cb, N=1)
    assert (ids[:, 0] == np.arange(40)).all()
    correct, skipped = stats[-1]
    total = cb.nnz if epoch_mode == "grouped" else 64 * -(-cb.nnz // 64)
    assert (skipped > 0) == verify
    assert correct / (total - skipped) > (0.85 if verify else 0.6)
    np.testing.assert_array_equal(model.user_factors[:, -1], 1.0)


@pytest.mark.parametrize("epoch_mode", ["grouped", "sampled"])
def test_explicit_zeros_and_empty_rows(epoch_mode):
    m = csr_matrix(np.array([[1.0, 0.0, 2.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                             [3.0, 1.0, 0.0, 0.0], [0.0, 1.0, 1.0, 1.0]]))
    m[0, 2] = 0.0  # explicit stored zero: still a positive
    model = BayesianPersonalizedRanking(factors=7, iterations=10, random_state=3,
                                        epoch_mode=epoch_mode, device="cpu")
    model.fit(m, show_progress=False)
    assert np.isfinite(model.user_factors).all()
    assert (model.user_factors[1, :-1] == 0).all()


def test_epoch_mode_values():
    cb = get_checkerboard(12)
    for mode, want in ((None, 1), ("grouped", 1), (1, 1), ("sampled", 0), (0, 0),
                       ("grouped_pool", 2), (2, 2), ("grouped_pool_ids", 3), (3, 3)):
        assert BayesianPersonalizedRanking(epoch_mode=mode, device="cpu")._resolve_epoch_mode() \
            == want
    for mode in ("hogwild", 4, [1]):
        with pytest.raises(ValueError, match="'grouped_pool_ids'"):
            BayesianPersonalizedRanking(epoch_mode=mode, device="cpu").fit(
                cb, show_progress=False)
    # 0 and "sampled" are one engine: the same bits from the same seed
    out = []
    for mode in (0, "sampled"):
        model = BayesianPersonalizedRanking(factors=7, iterations=3, random_state=5,
                                            epoch_mode=mode, device="cpu")
        model.fit(cb, show_progress=False)
        out.append(model.item_factors)
    np.testing.assert_array_equal(*out)


def test_long_row_regularization_stable():
    rng = np.random.default_rng(0)
    dense = np.zeros((8, 300), dtype=np.float32)
    dense[0, :250] = 1.0  # 250 > 1/(lr reg) = 200 at lr=0.2, reg=0.025
    for u in range(1, 8):
        dense[u, rng.choice(300, 20, replace=False)] = 1.0
    model = BayesianPersonalizedRanking(factors=15, learning_rate=0.2, regularization=0.025,
                                        iterations=5, random_state=1, device="cpu")
    model.fit(csr_matrix(dense), show_progress=False)
    assert np.isfinite(model.user_factors).all()
    assert np.abs(model.user_factors[0, :-1]).max() < 10.0


def test_same_seed_same_bits_and_pinned_user_bias(caplog):
    plays = _likes(80, 60, 0.1, 4)
    out = []
    for _ in range(2):
        model = BayesianPersonalizedRanking(factors=8, iterations=3, random_state=7,
                                            device="cpu")
        model.fit(plays, show_progress=False)
        out.append((model.user_factors, model.item_factors))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    # supplied user factors get their bias column pinned back to 1, with a warning
    model.user_factors[:, -1] = 3.0
    model.fit(plays, show_progress=False)
    np.testing.assert_array_equal(model.user_factors[:, -1], 1.0)
    assert "pins the user bias column" in caplog.text


def test_precision_close_to_jax_on_clustered_set():
    """The mean p@10 over four seeds: one seed's p@10 moves by up to 0.03
    with the draws alone (in either package)."""
    from implicit_tpu.evaluation import precision_at_k as jax_precision_at_k
    from implicit_tpu_torch.datasets.synthetic import get_synthetic_clustered
    from implicit_tpu_torch.evaluation import precision_at_k, train_test_split

    likes = get_synthetic_clustered(users=600, items=240, groups=8, likes_per_user=16, seed=7)
    train, test = train_test_split(likes, train_percentage=0.8, random_state=19)
    kw = dict(factors=31, iterations=60, learning_rate=0.05)
    got, want = [], []
    for seed in range(4):
        jmodel = jax_bpr.BayesianPersonalizedRanking(**kw, random_state=seed)
        jmodel.fit(train, show_progress=False)
        model = BayesianPersonalizedRanking(**kw, random_state=seed, device="cpu")
        model.fit(train, show_progress=False)
        want.append(jax_precision_at_k(jmodel, train, test, K=10, show_progress=False))
        got.append(precision_at_k(model, train, test, K=10, show_progress=False))
    assert min(got) > 0.5 and abs(np.mean(got) - np.mean(want)) <= 0.03, (got, want)


# -- the module flags and the epoch modes, as the JAX package's tests hold them ------


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_grouped_epoch_checkerboard_and_stats(mode, monkeypatch):
    """``BPR_GROUPED`` 1 (per-entry negatives), 2 (window-pool negatives)
    and 3 (pooled ids and biases, live factors): the checkerboard's top-1,
    verification rejecting liked negatives, high train accuracy, finite
    factors and the pinned user bias column (``tests/test_bpr.py``)."""
    monkeypatch.setattr(bpr, "BPR_GROUPED", mode)
    cb = get_checkerboard(40)
    stats = []
    model = BayesianPersonalizedRanking(factors=31, learning_rate=0.01, regularization=0,
                                        random_state=42, device="cpu")
    model.fit(cb, show_progress=False, callback=lambda e, t, c, s: stats.append((c, s)))
    ids, _ = model.recommend(np.arange(40), cb, N=1)
    assert (ids[:, 0] == np.arange(40)).all()
    correct, skipped = stats[-1]
    assert skipped > 0
    assert correct / (cb.nnz - skipped) > 0.85
    assert np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all()
    np.testing.assert_array_equal(model.user_factors[:, -1], 1.0)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_grouped_epoch_explicit_zeros_and_empty_rows(mode, monkeypatch):
    """Stored explicit zeros are positives and an empty row keeps zero
    factors, in every grouped mode (``tests/test_bpr.py``)."""
    monkeypatch.setattr(bpr, "BPR_GROUPED", mode)
    m = csr_matrix(np.array([[1.0, 0.0, 2.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                             [3.0, 1.0, 0.0, 0.0], [0.0, 1.0, 1.0, 1.0]]))
    m[0, 2] = 0.0  # explicit stored zero
    model = BayesianPersonalizedRanking(factors=7, iterations=10, random_state=3, device="cpu")
    model.fit(m, show_progress=False)
    assert np.isfinite(model.user_factors).all()
    assert (model.user_factors[1, :-1] == 0).all()


def test_epoch_mode_ctor_knob(monkeypatch):
    """``epoch_mode`` overrides the module default; "sampled" is the
    ``BPR_GROUPED = 0`` engine bit for bit; bad values raise
    (``tests/test_bpr.py``)."""
    cb = get_checkerboard(12)
    assert bpr.BPR_GROUPED == 1
    kw = dict(factors=7, iterations=3, random_state=5, device="cpu")
    assert BayesianPersonalizedRanking(**kw)._resolve_epoch_mode() == 1
    monkeypatch.setattr(bpr, "BPR_GROUPED", 0)
    assert BayesianPersonalizedRanking(**kw, epoch_mode="grouped")._resolve_epoch_mode() == 1
    classic = BayesianPersonalizedRanking(**kw)
    classic.fit(cb, show_progress=False)
    sampled = BayesianPersonalizedRanking(**kw, epoch_mode="sampled")
    sampled.fit(cb, show_progress=False)
    np.testing.assert_array_equal(classic.user_factors, sampled.user_factors)
    np.testing.assert_array_equal(classic.item_factors, sampled.item_factors)
    with pytest.raises(ValueError, match="epoch_mode"):
        BayesianPersonalizedRanking(epoch_mode="hogwild", device="cpu").fit(
            cb, show_progress=False)


def _record_epochs(monkeypatch, module):
    """Wraps ``module``'s BPR epoch functions; returns the list each call
    appends (name, pool_mode) to."""
    calls = []
    for name in ("_bpr_epoch", "_bpr_epoch_grouped", "_bpr_epoch_sharded"):
        def wrapped(*args, _fn=getattr(module, name), _name=name, **kwargs):
            calls.append((_name, kwargs.get("pool_mode", 0)))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("epoch_mode,grouped,mesh", [
    (None, 0, None), (None, 1, None), (None, 2, None), (None, 3, None),
    ("grouped_pool", 0, None), ("grouped_pool_ids", 2, None), ("sampled", 3, None),
    ("grouped_pool_ids", 1, 2), (None, 2, 2),
], ids=["grouped0", "grouped1", "grouped2", "grouped3", "pool-over-flag0",
        "pool-ids-over-flag2", "sampled-over-flag3", "mesh-over-pool-ids", "mesh-over-flag2"])
def test_flags_route_fits_as_jax(epoch_mode, grouped, mesh, monkeypatch):
    """``epoch_mode``, ``mesh`` and the module flag ``BPR_GROUPED`` send a
    fit to the JAX package's epoch, with its pool mode."""
    routes = []
    for module, factory, kw in ((jax_bpr, jax_bpr.BayesianPersonalizedRanking, {}),
                                (bpr, BayesianPersonalizedRanking, dict(device="cpu"))):
        monkeypatch.setattr(module, "BPR_GROUPED", grouped)
        calls = _record_epochs(monkeypatch, module)
        model = factory(factors=4, iterations=2, random_state=1, epoch_mode=epoch_mode,
                        mesh=mesh, **kw)
        model.fit(get_checkerboard(12), show_progress=False)
        assert np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all()
        routes.append(calls)
    assert len(routes[1]) == 2 and routes[1] == routes[0], routes


@pytest.mark.parametrize("epoch_mode", ["grouped_pool", "grouped_pool_ids"])
def test_pool_arrangement_and_epoch_seed_equal_jax(epoch_mode, monkeypatch):
    """A pool-mode fit draws the JAX fit's arrangement (the same numpy
    stream, in the same place) and so seeds its epochs with the JAX fit's
    seed; the starting factors stay the JAX fit's."""
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(300, 200, 6000, seed=4)
    seen = {"jax_seeds": [], "arr": [], "seed": []}
    prng_key, jax_epoch = jax.random.PRNGKey, jax_bpr._bpr_epoch_grouped
    monkeypatch.setattr(jax.random, "PRNGKey",
                        lambda seed, *a, **k: seen["jax_seeds"].append(seed)
                        or prng_key(seed, *a, **k))
    monkeypatch.setattr(jax_bpr, "_bpr_epoch_grouped",
                        lambda *a, **k: seen.__setitem__("jax_arr", np.asarray(a[7]))
                        or jax_epoch(*a, **k))
    epoch, draws = bpr._bpr_epoch_grouped, bpr._pool_draws
    monkeypatch.setattr(bpr, "_bpr_epoch_grouped", lambda *a, **k: seen["arr"].append(
        k["arrangement"].numpy()) or epoch(*a, **k))
    monkeypatch.setattr(bpr, "_pool_draws", lambda gen, *a: seen["seed"].append(
        gen.initial_seed()) or draws(gen, *a))

    kw = dict(factors=8, iterations=2, random_state=5, epoch_mode=epoch_mode)
    jmodel = jax_bpr.BayesianPersonalizedRanking(**kw)
    jmodel.fit(plays, show_progress=False)
    model = BayesianPersonalizedRanking(**kw, device="cpu")
    model.fit(plays, show_progress=False)
    assert len(seen["arr"]) == len(seen["seed"]) == 2
    np.testing.assert_array_equal(seen["arr"][0], seen["jax_arr"])
    np.testing.assert_array_equal(seen["arr"][1], seen["jax_arr"])
    assert seen["seed"] == [seen["jax_seeds"][0]] * 2
    start = [BayesianPersonalizedRanking(**{**kw, "iterations": 0}, device="cpu"),
             jax_bpr.BayesianPersonalizedRanking(**{**kw, "iterations": 0})]
    for m in start:
        m.fit(plays, show_progress=False)
    np.testing.assert_array_equal(start[0].item_factors, start[1].item_factors)
    np.testing.assert_array_equal(start[0].user_factors, start[1].user_factors)


@pytest.mark.parametrize("epoch_mode", ["grouped_pool", "grouped_pool_ids"])
def test_pool_arrangement_shorter_than_a_chunk(epoch_mode):
    """Where nnz is under the widest chunk width L, the port's snapshot
    repeats the permuted pool cyclically to nnz + L entries, so every window
    lies inside it. Its first 2 nnz entries are the JAX package's whole
    arrangement (``pool`` then ``pool[:L]``, only 2 nnz long there: its
    windows run past the end once 2 nnz <= L, and the two equal each other
    bit for bit only where nnz >= L). A fit trains at that shape."""
    m = csr_matrix(np.array([[1.0, 1.0, 1.0, 0.0, 1.0, 1.0], [0.0, 1.0, 0.0, 0.0, 0.0, 0.0]],
                            dtype=np.float32))
    L = max(idx.shape[2] for _, idx, _, _ in bpr.grouped_classes(m, "cpu"))
    assert m.nnz < L
    arr = bpr.pool_arrangement(np.random.default_rng(3), m, L)
    pool = np.random.default_rng(3).permutation(m.indices.astype(np.int32))
    assert len(arr) == m.nnz + L
    np.testing.assert_array_equal(arr, pool[np.arange(m.nnz + L) % m.nnz])
    np.testing.assert_array_equal(arr[:2 * m.nnz], np.concatenate([pool, pool[:L]]))
    model = BayesianPersonalizedRanking(factors=4, iterations=5, random_state=2,
                                        epoch_mode=epoch_mode, device="cpu")
    model.fit(m, show_progress=False)
    assert np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all()
    np.testing.assert_array_equal(model.user_factors[:, -1], 1.0)
