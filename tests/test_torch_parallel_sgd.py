"""The port's meshed BPR and LMF (``implicit_tpu_torch/models/bpr.py``,
``models/lmf.py`` with ``mesh=``) against the JAX package's meshed paths and
against the port's own single-device epochs, on the same numpy inputs.

JAX runs on the 8 virtual CPU devices ``conftest.py`` sets up, with
``create_mesh(4)``; the port on ``parallel.create_mesh(4, "cpu")``, four
virtual shards of the one host device. The epochs take their draws as
tensors, so the JAX functions' draws (``fold_in(key, shard)``, replicated on
the host) go into the port's. Tolerances:

- the meshed BPR epoch against JAX's ``_bpr_epoch_sharded``: within 1e-5 of
  each output's scale (float32 sums in another order, ROADMAP C4), correct
  and skipped exact; against the port's ``_bpr_epoch`` on the concatenated
  draws: bit for bit (the same ops on the same values);
- a BPR fit on a mesh of one shard against the unmeshed sampled fit: bit
  for bit;
- the meshed LMF class update against JAX's ``_build_sharded_class_update``
  on the glued, split and legacy routes: within 1e-4 of scale (the bar of
  ``tests/test_torch_lmf.py``'s class update; bfloat16 operands summed in
  float32 in other orders); the meshed fit's arrangements and re-shuffles:
  bit for bit (numpy's stream in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import get_checkerboard
from scipy import sparse
from scipy.sparse import csr_matrix

from implicit_tpu.models import bpr as jax_bpr
from implicit_tpu.models import lmf as jax_lmf
from implicit_tpu.parallel import create_mesh as jmesh
from implicit_tpu.parallel import shard_buckets as jshard_buckets
from implicit_tpu.parallel.mesh import replicated as jreplicated
from implicit_tpu.sparse import BucketedCSR as JaxBucketedCSR
from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
from implicit_tpu_torch.lmf import LogisticMatrixFactorization
from implicit_tpu_torch.models import bpr, lmf
from implicit_tpu_torch.ops import membership
from implicit_tpu_torch.parallel import create_mesh, shard_buckets, virtual_mesh
from implicit_tpu_torch.sparse import BucketedCSR

torch.set_num_threads(2)

D = 4
CPU = torch.device("cpu")


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a.astype(np.int64) if np.issubdtype(a.dtype, np.integer) else a)


def _within_scale(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- BPR ---------------------------------------------------------------------------


def _likes(users=40, items=30, density=0.3, seed=8):
    likes = sparse.random(users, items, density=density, random_state=seed, format="csr",
                          dtype=np.float32)
    likes.data[:] = 1.0
    likes.sort_indices()
    return likes


def _bpr_case(verifier, seed=6):
    """(likes, flats, starting X, Y, yb, port table and bits, JAX table and
    mh, bisection iterations)."""
    rng = np.random.default_rng(seed)
    likes = _likes()
    users, items, F = likes.shape[0], likes.shape[1], 8
    userids = np.repeat(np.arange(users, dtype=np.int32), np.ediff1d(likes.indptr))
    start = [(rng.standard_normal(shape) * 0.1).astype(np.float32)
             for shape in ((users, F), (items, F), (items,))]
    if verifier == "cuckoo":
        pt = membership.build_pair_table(likes)
        table, bits, jtable, mh = pt.to_device("cpu"), pt.bits, jnp.asarray(pt.table), pt.bits
    else:
        table, bits, jtable, mh = None, None, jnp.zeros((1, 1), dtype=jnp.uint16), None
    iters = int(np.ceil(np.log2(max(int(np.ediff1d(likes.indptr).max()), 2)))) + 1
    return likes, userids, start, (table, bits), (jtable, mh), iters


def _shard_step_draws(key, steps, local_batch, n_samples, n_shards):
    """The JAX meshed epoch's draws, per step and shard, as the port's
    tensors: ``split(fold_in(subkey, shard))``, then ``randint`` on each
    half."""
    out = []
    for sk in jax.random.split(key, steps):
        shards = []
        for dev in range(n_shards):
            k1, k2 = jax.random.split(jax.random.fold_in(sk, dev))
            shards.append(tuple(_t(jax.random.randint(k, (local_batch,), 0, n_samples))
                                for k in (k1, k2)))
        out.append(shards)
    return out


def _port_sharded_epoch(likes, userids, start, verify, iters, draws, lr, reg, mesh):
    X, Y, yb = (torch.as_tensor(a.copy()) for a in start)
    flats = {CPU: (_t(userids), _t(likes.indices), _t(likes.indptr), verify[0])}
    counts = bpr._bpr_epoch_sharded({CPU: (X, Y, yb)}, flats, draws, lr, reg, True, iters,
                                    verify[1], mesh)
    return (X, Y, yb), tuple(int(c) for c in counts)


@pytest.mark.parametrize("verifier", ["cuckoo", "bisection"])
def test_meshed_epoch_matches_jax(verifier):
    likes, userids, start, verify, jverify, iters = _bpr_case(verifier)
    key, steps, batch, lr, reg = jax.random.PRNGKey(3), 12, 64, 0.05, 0.01
    local = -(-batch // D)
    want = jax_bpr._bpr_epoch_sharded(
        *(jnp.asarray(a) for a in start), jnp.asarray(userids),
        jnp.asarray(likes.indices.astype(np.int32)), jnp.asarray(likes.indptr.astype(np.int32)),
        jverify[0], key, jnp.float32(lr), jnp.float32(reg), steps, batch, True, iters,
        jverify[1], jmesh(D))
    got, counts = _port_sharded_epoch(
        likes, userids, start, verify, iters,
        _shard_step_draws(key, steps, local, likes.nnz, D), lr, reg, create_mesh(D, "cpu"))
    assert counts == (int(want[3]), int(want[4]))
    assert counts[1] > 0
    for g, w in zip(got, want[:3]):
        _within_scale(g.numpy(), w, 1e-5)


@pytest.mark.parametrize("verifier", ["cuckoo", "bisection"])
def test_meshed_epoch_equals_concatenated_epoch(verifier):
    """D shards of local_batch draws compute what the single-device epoch
    computes on their concatenation, bit for bit."""
    likes, userids, start, verify, _, iters = _bpr_case(verifier, seed=7)
    draws = _shard_step_draws(jax.random.PRNGKey(9), 10, 16, likes.nnz, D)
    got, counts = _port_sharded_epoch(likes, userids, start, verify, iters, draws, 0.05, 0.01,
                                      create_mesh(D, "cpu"))
    X, Y, yb = (torch.as_tensor(a.copy()) for a in start)
    concat = [tuple(torch.cat([s[i] for s in step]) for i in range(2)) for step in draws]
    want = bpr._bpr_epoch(X, Y, yb, _t(userids), _t(likes.indices), _t(likes.indptr),
                          verify[0], concat, 0.05, 0.01, True, iters, verify[1])
    assert counts == tuple(int(c) for c in want)
    for g, w in zip(got, (X, Y, yb)):
        assert torch.equal(g, w)


def test_shard_draws_of_one_shard_are_the_sampled_draws():
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    one = list(bpr._shard_sample_draws(gens[0], 3, 7, 100, virtual_mesh(1, "cpu")))
    plain = list(bpr._sample_draws(gens[1], 3, 7, 100))
    for shards, pair in zip(one, plain):
        assert len(shards) == 1
        for a, b in zip(shards[0], pair):
            assert torch.equal(a, b)


@pytest.mark.parametrize("epoch_mode", ["sampled", "grouped"])
def test_one_shard_fit_equals_unmeshed_sampled_fit(epoch_mode):
    """A mesh of one shard trains the sampled epoch whatever epoch_mode says
    (as the JAX package's mesh path) and gives the unmeshed sampled fit's
    bits; the progress total counts local_batch x D per step."""
    likes = get_checkerboard(20)
    kw = dict(factors=7, iterations=4, random_state=3, device="cpu")
    plain = BayesianPersonalizedRanking(epoch_mode="sampled", **kw)
    plain.fit(likes, show_progress=False)
    calls = []
    meshed = BayesianPersonalizedRanking(epoch_mode=epoch_mode, mesh=virtual_mesh(1, "cpu"), **kw)
    meshed.fit(likes, show_progress=False, callback=lambda *args: calls.append(args))
    np.testing.assert_array_equal(meshed.user_factors, plain.user_factors)
    np.testing.assert_array_equal(meshed.item_factors, plain.item_factors)
    assert len(calls) == 4


def test_bpr_fit_on_mesh():
    """The JAX package's ``test_bpr_fit_on_mesh`` on the port's 4-shard CPU
    mesh: the checkerboard gate and the same bits for the same seed."""
    likes = get_checkerboard(50)
    models = []
    for _ in range(2):
        model = BayesianPersonalizedRanking(factors=31, learning_rate=0.01, regularization=0,
                                            random_state=42, mesh=D, device="cpu")
        model.fit(likes, show_progress=False)
        models.append(model)
    ok = sum(int(models[0].recommend(u, likes[u], N=1)[0][0] == u) for u in range(50))
    assert ok >= 48
    np.testing.assert_array_equal(models[0].user_factors, models[1].user_factors)
    np.testing.assert_array_equal(models[0].item_factors, models[1].item_factors)
    assert models[0]._serving_mesh().size == D  # serving runs over the same mesh


# -- LMF ---------------------------------------------------------------------------


def _lmf_case(route, seed=8):
    """A matrix, both packages' sharded host bucketing (pow2), warm starting
    rows and both packages' pools for ``route``."""
    rng = np.random.default_rng(seed)
    users, items, F, neg_prop = 70, 50, 10 if route != "split" else 130, 2
    dense = (rng.random((users, items)) < 0.25) * (rng.random((users, items)) * 4 + 1)
    ui = csr_matrix(dense.astype(np.float32))
    kw = dict(target_entries=128, grid="pow2")
    jb = jshard_buckets(JaxBucketedCSR(ui, **kw), jmesh(D))
    pb = shard_buckets(BucketedCSR(ui, **kw), create_mesh(D, "cpu"))
    X = rng.standard_normal((users, F)).astype(np.float32) * 0.3
    X[:, -2] = 1.0
    dss = (0.5 + rng.random((users, F))).astype(np.float32)
    Y = rng.standard_normal((items, F)).astype(np.float32) * 0.3
    Lmax = max(c.L for c in pb.classes)
    arr = rng.permutation(ui.indices).astype(np.int32)
    arr = np.concatenate([arr, arr[:Lmax * neg_prop]])
    if route == "legacy":
        jsrc, src = jnp.asarray(arr), _t(arr)
    else:
        jsrc = jax_lmf._build_pool(jnp.asarray(Y), jnp.asarray(arr), route == "split")
        src = lmf._build_pool(torch.as_tensor(Y), _t(arr), route == "split")
    return ui, jb, pb, X, dss, Y, jsrc, src, neg_prop


def _lmf_shard_draws(keys, G, neg_count, span, window):
    """The JAX meshed class update's draws, per chunk and shard:
    ``fold_in(chunk key, shard)``, then its ``_row_update`` draw."""
    shape = (G,) if window else (G, neg_count)
    return [[_t(jax.random.randint(jax.random.fold_in(k, dev), shape, 0, span))
             for dev in range(D)] for k in keys]


@pytest.mark.parametrize("route", ["glued", "split", "legacy"])
def test_meshed_class_update_matches_jax(route):
    ui, jb, pb, X, dss, Y, jsrc, src, neg_prop = _lmf_case(route)
    window, span, lr, reg = route != "legacy", ui.nnz, 1.0, 0.6
    mesh, jm = create_mesh(D, "cpu"), jmesh(D)
    Xg, dg = torch.as_tensor(X.copy()), torch.as_tensor(dss.copy())
    Xw, dw = jreplicated(jm, X), jreplicated(jm, dss)
    Yw = jreplicated(jm, Y)
    jsrc = (tuple(jreplicated(jm, np.asarray(a)) for a in jsrc) if route == "split"
            else jreplicated(jm, np.asarray(jsrc)))
    assert any(c.n_chunks > 1 for c in pb.classes)
    for ci, (jc, pc) in enumerate(zip(jb.classes, pb.classes)):
        neg_count = min(ui.shape[1], pc.L * neg_prop)
        keys = jax.random.split(jax.random.PRNGKey(ci), pc.n_chunks)
        update = jax_lmf._build_sharded_class_update(jm, "d", span, neg_count, -2, window,
                                                     route == "split")
        Xw, dw = update(Xw, dw, Yw, jsrc, jc.rows, jc.indices, jc.data, jc.lengths, keys,
                        jnp.float32(lr), jnp.float32(reg), jnp.int32(neg_prop))
        lmf._lmf_class_update_sharded(
            {CPU: (Xg, dg, torch.as_tensor(Y))}, {CPU: src}, pc,
            _lmf_shard_draws(keys, -(-pc.C // 8), neg_count, span, window), lr, reg, neg_prop,
            neg_count, -2, mesh, lmf._real_positions(pc, mesh, ui.shape[0]), window)
    np.testing.assert_array_equal(Xg[:, -2].numpy(), 1.0)
    _within_scale(Xg.numpy(), Xw, 1e-4)
    _within_scale(dg.numpy(), dw, 1e-4)


def test_meshed_update_never_writes_sentinel_rows():
    """Chunks end in sentinel rows (id n_rows), and ``shard_buckets`` pads
    each chunk with more to split it evenly, so whole shard slices can hold
    nothing else: the update writes exactly the real rows. A canary row at
    the sentinel's id stays as it was, and so does every row the class does
    not hold, while every row it holds moves."""
    ui, _, pb, X, dss, Y, _, src, neg_prop = _lmf_case("glued", seed=9)
    mesh, n = create_mesh(D, "cpu"), ui.shape[0]
    padded = [c for c in pb.classes if bool((torch.cat(c.rows, dim=1) == n).any())]
    cls = max(padded, key=lambda c: c.n_chunks)
    rows = torch.cat(cls.rows, dim=1)
    assert bool((rows < n).any())
    assert [len(p[CPU]) for p in lmf._real_positions(cls, mesh, n)] == \
        [int((r < n).sum()) for r in rows]
    X0 = np.concatenate([X, np.full((1, X.shape[1]), 7.0, np.float32)])
    d0 = np.concatenate([dss, np.full((1, X.shape[1]), 7.0, np.float32)])
    Xg, dg = torch.as_tensor(X0.copy()), torch.as_tensor(d0.copy())
    neg_count = min(ui.shape[1], cls.L * neg_prop)
    gen = torch.Generator().manual_seed(0)
    lmf._lmf_class_update_sharded(
        {CPU: (Xg, dg, torch.as_tensor(Y))}, {CPU: src}, cls,
        lmf._shard_pool_draws(gen, cls, neg_count, ui.nnz, True, mesh), 1.0, 0.6, neg_prop,
        neg_count, -2, mesh, lmf._real_positions(cls, mesh, n), True)
    held = np.unique(rows[rows < n].numpy())
    others = np.setdiff1d(np.arange(n), held)
    np.testing.assert_array_equal(np.delete(Xg[n].numpy(), -2), 7.0)  # -2: the pin
    np.testing.assert_array_equal(dg[n].numpy(), 7.0)
    np.testing.assert_array_equal(Xg[others].numpy(), X0[others])
    assert (dg[held].numpy() != d0[held]).any(axis=1).all()


@pytest.mark.parametrize("factors", [8, 128], ids=["glued", "split"])
def test_meshed_arrangements_equal_jax(factors, monkeypatch):
    """The meshed fit's pools read the JAX package's meshed fit's
    arrangements, bit for bit, through the re-shuffle of epoch 5 (numpy's
    ``rs.shuffle`` of the unpadded core in both), and its starting factors."""
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(150, 90, 2000, seed=2)
    seen = {"jax": [], "port": []}

    def spy(name, module):
        build = module._build_pool
        monkeypatch.setattr(module, "_build_pool", lambda Y, arr, split: (
            seen[name].append((np.asarray(arr), split)), build(Y, arr, split))[1])

    spy("jax", jax_lmf)
    spy("port", lmf)
    kw = dict(factors=factors, iterations=5, random_state=11, neg_prop=4)
    jmodel = jax_lmf.LogisticMatrixFactorization(**kw, mesh=D)
    model = LogisticMatrixFactorization(**kw, mesh=D, device="cpu")
    jmodel.fit(plays, show_progress=False)
    model.fit(plays, show_progress=False)
    assert len(seen["jax"]) == len(seen["port"]) == 10  # user side, item side, 5 epochs
    for (a, sa), (b, sb) in zip(seen["jax"], seen["port"]):
        assert sa == sb == (factors == 128)
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(seen["port"][0][0], seen["port"][8][0])  # re-shuffled


def test_lmf_fit_on_mesh():
    """The JAX package's ``test_lmf_fit_on_mesh`` on the port's 4-shard CPU
    mesh, and the same bits for the same seed."""
    likes = get_checkerboard(50)
    models = []
    for _ in range(2):
        model = LogisticMatrixFactorization(factors=30, random_state=23, mesh=D, device="cpu")
        model.fit(likes, show_progress=False)
        models.append(model)
    ok = sum(int(models[0].recommend(u, likes[u], N=1)[0][0] == u) for u in range(50))
    assert ok >= 48
    np.testing.assert_array_equal(models[0].user_factors, models[1].user_factors)
    np.testing.assert_array_equal(models[0].item_factors, models[1].item_factors)
    np.testing.assert_array_equal(models[0].user_factors[:, -2], 1.0)
    np.testing.assert_array_equal(models[0].item_factors[:, -1], 1.0)


# -- chip_smoke.py phase 10's bars, at a small shape on the CPU ----------------------


def _small_plays():
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    return generate_synthetic(2048, 300, 20_000, seed=3).astype(np.float32)


def test_chip_smoke_meshed_bpr_bars():
    """Phase 10's BPR steps: the meshed epoch fed host draws must give the
    concatenated epoch's bits and reject the epoch without the last shard's
    draws (the check raises otherwise); a mesh of one shard gives the
    unmeshed sampled fit's bits, two meshed fits the same bits, meshed
    recommend the resident call's answers."""
    import chip_smoke

    plays = _small_plays()
    mesh = virtual_mesh(D, "cpu")
    mesh_s, single_s = chip_smoke.mesh_bpr_epoch_check(plays, "cpu", mesh, factors=8)
    assert mesh_s > 0 and single_s > 0
    assert chip_smoke.mesh_bpr_fits(plays, "cpu", mesh, sampled_s=1.0) > 0


def test_chip_smoke_meshed_lmf_bars():
    """Phase 10's LMF steps: the arrangements against the host replay, and
    the class update's bar, which must reject the update missing the last
    shard's slice (the check raises otherwise)."""
    import chip_smoke

    plays = _small_plays()
    model, secs, reshuffle = chip_smoke.mesh_lmf_arrangements(
        plays, "cpu", virtual_mesh(D, "cpu"), factors=8, neg_prop=4)
    assert secs > 0 and len(reshuffle) == 1 and model.user_factors.shape == (2048, 10)
    err, wrong_err = chip_smoke.mesh_lmf_update_check("cpu", D, plays=plays)
    assert err == 0.0 and wrong_err > chip_smoke.TOL["bf16"]
