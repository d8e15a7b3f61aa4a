"""The port's ALS solver against the JAX package's, from the same start.

The same bucketed interactions (built by each package from one scipy
matrix) and the same numpy X0 / Y0 go through the port's ``solve_side`` /
``fit`` (on the CPU: the kernels' plain versions) and JAX's
``als_ops.fit(..., use_pallas=True)``, whose Pallas kernels run in the
interpreter, so that both route every class alike. The matrix has item rows
on both sides of ``_full_cg_max_l`` (512 in float32), so both kernels run.

Tolerances: float32 solves differ by summation order only, amplified by
the CG steps on long rows; they are held to rtol = atol = 1e-3, the JAX
package's own bar between its kernels and its composed solver
(``tests/test_als_solvers.py``). bfloat16 solves differ by more: the JAX
kernels also round the CG vectors to bfloat16 inside their products, the
port's kernels multiply the bfloat16 table by float32 vectors. Both are held
to 5% of the float32 solution's scale (the JAX package's bf16-vs-f32 bar),
and the port must be the closer of the two to float32.

The port updates X in place, so every call gets its own copy of X0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from implicit_tpu.ops import als as jals
from implicit_tpu.sparse import BucketedCSR as JBucketedCSR
from implicit_tpu_torch.models.als import least_squares, least_squares_cg
from implicit_tpu_torch.ops import als as tals
from implicit_tpu_torch.ops import cg_kernels
from implicit_tpu_torch.sparse import BucketedCSR as TBucketedCSR

torch.set_num_threads(2)

F = 16


def _plays(seed=0, users=700, items=60, head=4):
    """Users x items with ``head`` items liked by ~90% of users (item rows
    longer than 512) and a sparse tail."""
    rng = np.random.RandomState(seed)
    dense = (rng.rand(users, items) < 0.1).astype(np.float32)
    dense[:, :head] = rng.rand(users, head) < 0.9
    dense *= (rng.rand(users, items) * 10 + 1).astype(np.float32)
    dense[rng.rand(users, items) < 0.02] *= -1  # some "disliked" entries
    return sp.csr_matrix(dense)


def _start(users, items, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((users, F), dtype=np.float32) * 0.1,
            rng.random((items, F), dtype=np.float32) * 0.1)


def _buckets(csr, grid="fine"):
    return (JBucketedCSR(csr, grid=grid).to_device(),
            TBucketedCSR(csr, grid=grid).to_device("cpu"))


def test_matrix_routes_to_both_kernels():
    Ciu = _plays().T.tocsr()
    calls = {"cg_full": 0, "gramian_cg": 0}
    full, gram = cg_kernels.cg_solve_full, cg_kernels.gramian_cg_solve

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    cg_kernels.cg_solve_full = count("cg_full", full)
    cg_kernels.gramian_cg_solve = count("gramian_cg", gram)
    try:
        _, tb = _buckets(Ciu)
        X0, Y0 = _start(*Ciu.shape)
        tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.01)
    finally:
        cg_kernels.cg_solve_full, cg_kernels.gramian_cg_solve = full, gram
    max_l = tals._full_cg_max_l("float32", F)
    want_long = sum(c.n_chunks for c in tb.classes if c.L > max_l)
    assert calls["gramian_cg"] == want_long > 0
    assert calls["cg_full"] == sum(c.n_chunks for c in tb.classes) - want_long > 0


@pytest.mark.parametrize("dtype,factors", [
    ("float32", 16), ("float32", 128), ("float32", 200), ("bfloat16", 64),
    ("bfloat16", 128), ("bfloat16", 256), ("float32", 512)])
def test_full_cg_max_l_matches_jax(dtype, factors):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    assert tals._full_cg_max_l(dtype, factors) == jals._full_cg_max_l(jdt, factors)


@pytest.mark.parametrize("side", ["user", "item"])
def test_solve_side_matches_jax(side):
    Cui = _plays()
    csr = Cui if side == "user" else Cui.T.tocsr()
    X0, Y0 = _start(*csr.shape)
    jb, tb = _buckets(csr)
    got, want = {}, {}
    for dtype in ("float32", "bfloat16"):
        want[dtype] = np.asarray(jals.solve_side(
            jnp.asarray(X0), jnp.asarray(Y0), jb, 0.01, compute_dtype=dtype, use_pallas=True))
        got[dtype] = tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.01,
                                     compute_dtype=dtype).numpy()
    np.testing.assert_allclose(got["float32"], want["float32"], rtol=1e-3, atol=1e-3)
    scale = np.abs(want["float32"]).max()
    err_port = np.abs(got["bfloat16"] - want["float32"]).max()
    err_jax = np.abs(want["bfloat16"] - want["float32"]).max()
    assert err_port < 0.05 * scale and err_jax < 0.05 * scale
    assert err_port <= err_jax
    assert np.abs(got["bfloat16"] - want["bfloat16"]).max() < 0.05 * scale
    # rows with no interactions are zeroed
    empty = np.where(np.diff(csr.indptr) == 0)[0]
    assert not got["float32"][empty].any()


@pytest.mark.parametrize("grid", ["pow2", "fine"])
def test_fit_matches_jax(grid):
    Cui = _plays(seed=2)
    Ciu = Cui.T.tocsr()
    X0, Y0 = _start(*Cui.shape, seed=3)
    jub, tub = _buckets(Cui, grid)
    jib, tib = _buckets(Ciu, grid)
    jX, jY = jals.fit(jnp.asarray(X0), jnp.asarray(Y0), jub, jib, 0.05, 2, use_pallas=True)
    tX, tY = tals.fit(torch.tensor(X0), torch.tensor(Y0), tub, tib, 0.05, 2)
    # two full iterations grow the float32 noise on the poorly conditioned
    # head rows: JAX's own kernel and composed solvers differ by ~5e-4 of
    # the factors' scale here, the port is held to 2e-3 of it
    for got, want in ((tX.numpy(), np.asarray(jX)), (tY.numpy(), np.asarray(jY))):
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    # and the losses the two packages report for the result agree
    jl = jals.calculate_loss_bucketed(jub, jX, jY, 0.05)
    tl = tals.calculate_loss_bucketed(tub, tX, tY, 0.05)
    assert tl == pytest.approx(jl, rel=1e-4)


def test_cholesky_matches_jax():
    Cui = _plays(seed=4)
    X0, Y0 = _start(*Cui.shape, seed=5)
    jb, tb = _buckets(Cui)
    want = jals.solve_side(jnp.asarray(X0), jnp.asarray(Y0), jb, 0.1, use_cg=False)
    got = tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.1, use_cg=False)
    # direct solves of the same normal equations: float32 rounding only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_side_matches_numpy_cg_oracle(dtype):
    # the per-row numpy CG (models/als.py:least_squares_cg): same warm start,
    # same steps, same early exit
    Cui = _plays(seed=6)
    X0, Y0 = _start(*Cui.shape, seed=7)
    np_dt = np.float64 if dtype == "float64" else np.float32
    want = X0.astype(np.float64)
    least_squares_cg(Cui.astype(np.float64), want, Y0.astype(np.float64), 0.05)
    tb = TBucketedCSR(Cui, data_dtype=np_dt).to_device("cpu")
    got = tals.solve_side(torch.tensor(X0.astype(np_dt)), torch.tensor(Y0.astype(np_dt)),
                          tb, 0.05, compute_dtype=dtype)
    # float64 solves agree to rounding; float32 to its ~1e-7 steps, grown by
    # three CG steps on long rows
    tol = 1e-9 if dtype == "float64" else 2e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_cholesky_matches_numpy_oracle():
    Cui = _plays(seed=8, users=200)
    X0, Y0 = _start(*Cui.shape, seed=9)
    want = X0.astype(np.float64)
    least_squares(Cui.astype(np.float64), want, Y0.astype(np.float64), 0.1)
    tb = TBucketedCSR(Cui, data_dtype=np.float64).to_device("cpu")
    got = tals.solve_side(torch.tensor(X0.astype(np.float64)),
                          torch.tensor(Y0.astype(np.float64)), tb, 0.1,
                          use_cg=False, compute_dtype="float64")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-10)


def test_scan_entry_points_drop_sentinel_rows():
    Cui = _plays(seed=10, users=50)
    X0, Y0 = _start(*Cui.shape, seed=11)
    tb = TBucketedCSR(Cui, target_entries=256).to_device("cpu")
    Y = torch.as_tensor(Y0)
    yty = tals.gramian(Y, 0.05)
    X_scan = torch.tensor(X0)
    X_cho = torch.tensor(X0)
    for cls in tb.classes:
        X_scan = tals.cg_solve_scan(X_scan, Y, yty, cls.rows, cls.indices, cls.data)
        X_cho = tals.cho_solve_scan(X_cho, Y, yty, cls.rows, cls.indices, cls.data)
    ref = tals.solve_side(torch.tensor(X0), Y, tb, 0.05)
    np.testing.assert_allclose(X_scan.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    assert np.isfinite(X_cho.numpy()).all()


def test_calculate_loss_matches_jax():
    Cui = _plays(seed=12, users=120)
    X0, Y0 = _start(*Cui.shape, seed=13)
    want = jals.calculate_loss(Cui, X0, Y0, 0.05)
    got = tals.calculate_loss(Cui, X0, Y0, 0.05, device="cpu")
    assert got == pytest.approx(want, rel=1e-5)
