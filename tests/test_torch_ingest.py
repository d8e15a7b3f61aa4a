"""The port's pack against the JAX package's host and device packs, and the
fit's set-up.

Packing is integer bookkeeping and copies of stored values, so every
comparison is exact: the port's ``pack_pair_on_device`` (here on the CPU),
the JAX package's host ``BucketedCSR`` and its ``pack_pair_on_device(...,
mode="device")`` on JAX's CPU give the same tensors, field for field. Every
``ingest`` value fits the same bits, and both packages start a fit from the
same factors.
"""

import logging

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from implicit_tpu import sparse as jsparse
from implicit_tpu.als import AlternatingLeastSquares as JALS
from implicit_tpu.models import als as jals_model
from implicit_tpu_torch import sparse as tsparse
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.datasets.synthetic import generate_synthetic

torch.set_num_threads(2)


def _random(users, items, density, dtype=np.float32):
    m = sp.random(users, items, density=density, random_state=np.random.RandomState(1),
                  format="csr")
    m.data = np.random.default_rng(0).integers(1, 9, m.nnz).astype(dtype)
    return m


def _empty_rows_and_cols():
    """Empty rows in the middle and at the end, trailing empty columns, and a
    long row."""
    m = _random(120, 90, 0.1).tolil()
    m[5, :] = 0.0
    m[60:64, :] = 0.0
    m[110:, :] = 0.0
    m[:, 80:] = 0.0
    m[7, :80] = 3.0
    m = m.tocsr()
    m.eliminate_zeros()
    return m


def _unsorted():
    """Every row's entries in a shuffled order, so a row's first stored
    column is not its smallest."""
    m = _random(150, 70, 0.15)
    rng = np.random.default_rng(2)
    indices, data = m.indices.copy(), m.data.copy()
    for r in range(m.shape[0]):
        lo, hi = m.indptr[r], m.indptr[r + 1]
        perm = lo + rng.permutation(hi - lo)
        indices[lo:hi], data[lo:hi] = indices[perm], data[perm]
    out = sp.csr_matrix((data, indices, m.indptr.copy()), shape=m.shape)
    assert not out.has_sorted_indices
    return out


def _duplicates():
    """Entries stored twice under one (row, column), with different values,
    some out of column order."""
    m = _random(100, 60, 0.1)
    rng = np.random.default_rng(3)
    indices, data, indptr = [], [], [0]
    for r in range(m.shape[0]):
        cols = m.indices[m.indptr[r]:m.indptr[r + 1]]
        vals = m.data[m.indptr[r]:m.indptr[r + 1]]
        if len(cols) and r % 3 == 0:
            k = rng.integers(len(cols))
            cols, vals = np.append(cols, cols[k]), np.append(vals, vals[k] + 1)
        indices.extend(cols)
        data.extend(vals)
        indptr.append(len(indices))
    out = sp.csr_matrix((np.array(data, np.float32), np.array(indices, np.int32),
                         np.array(indptr)), shape=m.shape)
    assert out.nnz > m.nnz
    return out


# (matrix, grid, data dtype); the first three are tests/test_sparse.py's
CASES = {
    "300x200_fine": (lambda: _random(300, 200, 0.05), "fine", np.float32),
    "157x83_pow2": (lambda: _random(157, 83, 0.12), "pow2", np.float32),
    "64x400_fine": (lambda: _random(64, 400, 0.02), "fine", np.float32),
    "float64": (lambda: _random(200, 150, 0.06, np.float64), "pow2", np.float64),
    "empty_rows_and_cols": (_empty_rows_and_cols, "fine", np.float32),
    "unsorted_rows": (_unsorted, "pow2", np.float32),
    "duplicates": (_duplicates, "fine", np.float32),
}
KW = dict(target_entries=1 << 12, max_chunk_rows=256)


def _numpy(t):
    return None if t is None else np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


def _assert_same(got, want, exact_dtypes=True):
    """Two DeviceBuckets (either package's) hold the same plan and tensors;
    ``exact_dtypes`` also holds every dtype equal (the JAX package keeps row
    ids in int32, the port in int64)."""
    assert (tuple(got.shape), got.nnz, got.sentinel) == (tuple(want.shape), want.nnz,
                                                         want.sentinel)
    a, b = _numpy(got.empty_rows), _numpy(want.empty_rows)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)
    assert len(got.classes) == len(want.classes)
    for g, w in zip(got.classes, want.classes):
        assert (g.L, g.C, g.n_chunks) == (w.L, w.C, w.n_chunks)
        n_valid = [int(n) for n in (_numpy(w.rows) != want.sentinel).sum(axis=1)]
        assert g.n_valid == getattr(w, "n_valid", n_valid) == n_valid
        for name in ("rows", "indices", "data", "lengths"):
            x, y = getattr(g, name), getattr(w, name)
            np.testing.assert_array_equal(_numpy(x), _numpy(y), err_msg=name)
            if exact_dtypes:
                assert x.dtype == y.dtype, name
            elif name != "rows":
                assert _numpy(x).dtype == _numpy(y).dtype, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_pack_matches_host_pack_and_jax(case):
    make, grid, dtype = CASES[case]
    Cui = make()
    Ciu = Cui.T.tocsr()
    kw = dict(KW, grid=grid, data_dtype=dtype)
    got = tsparse.pack_pair_on_device(Cui, device="cpu", **kw)
    with jax.enable_x64(dtype == np.float64):
        host = (jsparse.BucketedCSR(Cui, **kw).to_device(),
                jsparse.BucketedCSR(Ciu, **kw).to_device())
        want = jsparse.pack_pair_on_device(Cui, Ciu, mode="device", **kw)
    assert got[0].classes and got[1].classes
    for g, h, w in zip(got, host, want):
        _assert_same(g, h, exact_dtypes=False)
        _assert_same(g, w, exact_dtypes=False)
        assert g.classes[0].data.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
        assert g.classes[0].rows.dtype == torch.int64


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_pack_without_transpose_matches_given_transpose(case):
    make, grid, dtype = CASES[case]
    Cui = make()
    kw = dict(KW, grid=grid, data_dtype=dtype, device="cpu")
    derived = tsparse.pack_pair_on_device(Cui, None, **kw)
    given = tsparse.pack_pair_on_device(Cui, Cui.T.tocsr(), **kw)
    for a, b in zip(derived, given):
        _assert_same(a, b)


@pytest.mark.parametrize("grid", ["fine", "pow2"])
def test_fill_matches_full_constructor(grid):
    m = _unsorted()
    full = tsparse.BucketedCSR(m, grid=grid, **KW)
    plan = tsparse.BucketedCSR(m, grid=grid, metadata_only=True, **KW)
    assert all(c.indices is None and c.data is None for c in plan.classes)
    filled = plan.fill(m)
    assert len(full.classes) == len(filled.classes)
    for a, b in zip(full.classes, filled.classes):
        assert (a.L, a.C, a.n_chunks) == (b.L, b.C, b.n_chunks)
        for name in ("rows", "indices", "data", "lengths"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("case", ["unsorted_rows", "empty_rows_and_cols", "duplicates"])
def test_plan_from_indptr_matches_host_transpose(case):
    """The item plan from the device transpose's indptr and first users
    equals the plan of the host transpose; the transpose's flat arrays are
    ``Cui.T.tocsr()``'s."""
    make, grid, _ = CASES[case]
    Cui = make()
    Ciu = Cui.T.tocsr()
    t_idx, t_dat, t_indptr = tsparse._transpose(
        torch.as_tensor(Cui.indices.astype(np.int32)), torch.as_tensor(Cui.data),
        torch.as_tensor(Cui.indptr.astype(np.int64)), Cui.shape[1])
    np.testing.assert_array_equal(t_indptr.numpy(), Ciu.indptr)
    np.testing.assert_array_equal(t_idx.numpy(), Ciu.indices)
    np.testing.assert_array_equal(t_dat.numpy(), Ciu.data)
    first = t_idx[t_indptr[:-1].clamp(max=Cui.nnz - 1)].numpy()
    got = tsparse.BucketedCSR.from_indptr(Ciu.shape, t_indptr.numpy(), first, grid=grid, **KW)
    want = tsparse.BucketedCSR(Ciu, grid=grid, metadata_only=True, **KW)
    assert (got.shape, got.nnz, got.sentinel) == (want.shape, want.nnz, want.sentinel)
    np.testing.assert_array_equal(got.empty_rows, want.empty_rows)
    assert len(got.classes) == len(want.classes)
    for a, b in zip(got.classes, want.classes):
        assert (a.L, a.C, a.n_chunks) == (b.L, b.C, b.n_chunks)
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.lengths, b.lengths)


def test_device_route_failure_raises(monkeypatch):
    """A failing pack raises; nothing packs in its place."""
    def fail(*args):
        raise RuntimeError("device pack failed")

    host = []
    monkeypatch.setattr(tsparse, "_pack_side", fail)
    monkeypatch.setattr(tsparse.BucketedCSR, "fill", lambda self, csr: host.append(1))
    with pytest.raises(RuntimeError, match="device pack failed"):
        tsparse.pack_pair_on_device(_random(30, 20, 0.2), device="cpu")
    with pytest.raises(RuntimeError, match="device pack failed"):
        tsparse.pack_on_device(_random(30, 20, 0.2), "cpu")
    assert host == []


@pytest.mark.parametrize("transpose", ["derived", "given"])
def test_empty_matrix(transpose):
    """No entries: no classes, every row and column empty, whether the item
    plan comes from the device transpose or from the given one."""
    Cui = sp.csr_matrix((5, 4), dtype=np.float32)
    Ciu = Cui.T.tocsr() if transpose == "given" else None
    user, item = tsparse.pack_pair_on_device(Cui, Ciu, device="cpu")
    assert user.classes == [] and item.classes == []
    assert user.nnz == item.nnz == 0
    assert user.empty_rows.tolist() == list(range(5))
    assert item.empty_rows.tolist() == list(range(4))
    assert (user.shape, item.shape) == ((5, 4), (4, 5))


def _fit(dtype, ingest, iterations=2, **kw):
    model = AlternatingLeastSquares(factors=16, iterations=iterations, random_state=4,
                                    dtype=dtype, ingest=ingest, device="cpu", **kw)
    model.fit(generate_synthetic(300, 200, 6000, seed=8), show_progress=False)
    return model


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
def test_fit_with_device_ingest_equals_host_ingest(dtype):
    """``ingest`` is accepted for API parity and selects nothing: every
    value fits the same bits."""
    auto, device, host = (_fit(dtype, ingest) for ingest in ("auto", "device", "host"))
    for model in (device, host):
        for a, b in ((model.user_factors, auto.user_factors),
                     (model.item_factors, auto.item_factors)):
            assert a.dtype == dtype
            np.testing.assert_array_equal(a, b)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_initial_factors_equal_jax(monkeypatch, dtype):
    """The JAX fit stopped right after it draws its factors, against a port
    fit of no iterations: the same bits, drawn from numpy's stream and
    scaled and cast on the device in the port."""
    plays = generate_synthetic(300, 200, 6000, seed=8)

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(jals_model, "pack_pair_on_device", stop)
    want = JALS(factors=24, random_state=11, dtype=dtype)
    with pytest.raises(_Stop):
        want.fit(plays, show_progress=False)
    got = AlternatingLeastSquares(factors=24, iterations=0, random_state=11, dtype=dtype,
                                  device="cpu")
    got.fit(plays, show_progress=False)
    for a, b in ((got.user_factors, want.user_factors), (got.item_factors, want.item_factors)):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)


def test_warm_refit_starts_from_the_set_factors():
    """Factors the model already has are the start, not a new draw; the fit
    leaves the caller's arrays unchanged, and both ingest routes refit alike."""
    plays = generate_synthetic(300, 200, 6000, seed=8)
    rng = np.random.default_rng(0)
    start = [rng.standard_normal((n, 16)).astype(np.float16) for n in plays.shape]
    kept = [s.copy() for s in start]
    fits = {}
    for iterations, ingest in ((0, "device"), (1, "device"), (1, "host")):
        model = AlternatingLeastSquares(factors=16, iterations=iterations, dtype=np.float16,
                                        ingest=ingest, device="cpu")
        model.user_factors, model.item_factors = start
        model.fit(plays, show_progress=False)
        fits[iterations, ingest] = (model.user_factors, model.item_factors)
    for s, k, unmoved in zip(start, kept, fits[0, "device"]):
        np.testing.assert_array_equal(s, k)
        np.testing.assert_array_equal(unmoved, k)
    for a, b in zip(fits[1, "device"], fits[1, "host"]):
        np.testing.assert_array_equal(a, b)


SET_UP_STEPS = ["prepare", "upload", "transpose", "plan user side", "plan item side",
                "pack user side", "pack item side", "factor draw", "factor init",
                "factor draw", "factor init", "copy back"]


@pytest.mark.parametrize("ingest", ["auto", "device", "host"])
def test_set_up_steps_are_logged(caplog, ingest):
    """With debug logging on, every set-up step logs its seconds once, in
    the order it runs (the split ``chip_smoke.py`` prints): the one pack,
    whatever ``ingest`` says."""
    with caplog.at_level(logging.DEBUG, logger="implicit_tpu_torch"):
        _fit(np.float32, ingest, iterations=1)
    logged = [r.args for r in caplog.records if r.msg.startswith("fit set-up")]
    assert [step for step, _ in logged] == SET_UP_STEPS
    assert all(secs >= 0 for _, secs in logged)


def test_nan_factors_raise_after_the_copy_back():
    """The NaN check runs on the fit's device tensors; the model keeps the
    factors it copied back, as the JAX package's does."""
    from implicit_tpu_torch.recommender_base import ModelFitError

    plays = generate_synthetic(300, 200, 6000, seed=8)
    model = AlternatingLeastSquares(factors=8, iterations=0, dtype=np.float16, device="cpu")
    model.user_factors = np.zeros((300, 8), dtype=np.float16)
    model.item_factors = np.zeros((200, 8), dtype=np.float16)
    model.item_factors[3, 1] = np.nan
    with pytest.raises(ModelFitError, match="NaN"):
        model.fit(plays, show_progress=False)
    assert model.item_factors.dtype == np.float16 and np.isnan(model.item_factors[3, 1])
