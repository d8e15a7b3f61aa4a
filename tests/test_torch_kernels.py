"""The solve kernels' plain PyTorch versions against the JAX Pallas kernels.

The same numpy inputs go to ``implicit_tpu_torch.ops.cg_kernels`` (on CPU
tensors the wrappers run their plain versions) and to
``implicit_tpu.ops.pallas_ops`` in the Pallas interpreter, on the shapes of
``tests/test_pallas.py``'s ``_cg_case``. The port takes the factor table
and indices and gathers ``Y[idx]`` itself; JAX is handed the same block,
gathered with numpy.

Tolerances: the bar of the JAX package's kernel tests, rtol = atol = 2e-3
(``test_pallas.py``); in float32 the two agree far closer (different
summation order only), so float32 is held to 1e-4. The CUDA kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from implicit_tpu.ops import pallas_ops
from implicit_tpu_torch.ops import cg_kernels

torch.set_num_threads(2)

F32_TOL = 1e-4
BF16_TOL = 2e-3


def _case(C, L, F, seed, n_table=64):
    """A chunk like ``test_pallas._cg_case``: padding tail, an all-padding row
    from a zero start, a factor table and indices into it."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n_table, F), dtype=np.float32) * 0.1
    idx = rng.integers(0, n_table, size=(C, L), dtype=np.int32)
    dat = rng.random((C, L), dtype=np.float32) * 5 + 1
    dat[:, -2:] = 0.0  # padding tail
    x0 = rng.standard_normal((C, F), dtype=np.float32) * 0.01
    dat[1] = 0.0  # all padding ...
    x0[1] = 0.0   # ... from a zero start: the solve leaves x at 0
    Ys = rng.standard_normal((64, F), dtype=np.float32) * 0.1
    yty = Ys.T @ Ys + 0.05 * np.eye(F, dtype=np.float32)
    return Y, idx, dat, x0, yty


def _both(kind, Y, idx, dat, x0, yty, bf16):
    port_fn = {"cg_full": cg_kernels.cg_solve_full,
               "gramian": cg_kernels.gramian_cg_solve}[kind]
    jax_fn = {"cg_full": pallas_ops.cg_solve_full,
              "gramian": pallas_ops.gramian_cg_solve}[kind]
    Yt = torch.as_tensor(Y)
    Yu = Y[idx]
    if bf16:
        Yt = Yt.to(torch.bfloat16)
        Yu = Yu.astype(ml_dtypes.bfloat16)
    before = dict(cg_kernels.LAUNCHES)
    got = port_fn(Yt, torch.as_tensor(idx), torch.as_tensor(dat), torch.as_tensor(x0),
                  torch.as_tensor(yty), cg_steps=3)
    # CPU tensors take the plain version: no kernel launch is counted
    assert cg_kernels.LAUNCHES == before
    want = jax_fn(jnp.asarray(Yu), jnp.asarray(dat), jnp.asarray(x0), jnp.asarray(yty),
                  cg_steps=3, interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 64, 128), (16, 96, 256), (8, 24, 64), (20, 16, 8)])
def test_cg_solve_full_matches_pallas(shape, bf16):
    Y, idx, dat, x0, yty = _case(*shape, seed=shape[1])
    got, want = _both("cg_full", Y, idx, dat, x0, yty, bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not got[1].any()  # the all-padding row stayed at x0 = 0


def _bf16_rows(Y):
    return torch.as_tensor(Y).bfloat16().float().numpy()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("F", [128, 256])
def test_cg_solve_full_freezing_rows_match_pallas(F, bf16):
    # rows that freeze at different CG steps side by side in the 8-row blocks
    # of the kernels (lockstep masking), rows already at their solution, an
    # all-padding row, and C = 45, no multiple of 8
    Y, idx, dat, x0, yty, steps = cg_kernels.freeze_case(
        45, 32, F, seed=F, seen=_bf16_rows if bf16 else None)
    got, want = _both("cg_full", Y, idx, dat, x0, yty, bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    at_start = steps == 0
    np.testing.assert_array_equal(got[at_start], x0[at_start])


@pytest.mark.parametrize("F", [10, 128, 256])
def test_freeze_case_rows_freeze_at_their_steps(F):
    # the plain solve leaves x of a frozen row exactly as it was: row c's x
    # after steps[c] CG steps is its x after 3, and it moved at steps[c]
    Y, idx, dat, x0, yty, steps = cg_kernels.freeze_case(45, 32, F, seed=F)
    args = [torch.as_tensor(a) for a in (Y, idx, dat, x0, yty)]
    xs = [cg_kernels.cg_solve_full(*args, cg_steps=s).numpy() for s in range(4)]
    assert set(steps) == {-1, 0, 1, 2, 3}
    for c, s in enumerate(steps):
        if s < 0:
            assert not np.array_equal(xs[2][c], xs[3][c])
            continue
        np.testing.assert_array_equal(xs[s][c], xs[3][c])
        if s > 0:
            assert not np.array_equal(xs[s - 1][c], xs[s][c])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 1536, 128), (16, 768, 256), (8, 2048, 64), (20, 16, 8)])
def test_gramian_cg_solve_matches_pallas(shape, bf16):
    Y, idx, dat, x0, yty = _case(*shape, seed=shape[2])
    got, want = _both("gramian", Y, idx, dat, x0, yty, bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not got[1].any()


def test_weighted_matvec_reference_matches_jax():
    rng = np.random.default_rng(3)
    C, L, F = 12, 40, 16
    Yu = rng.standard_normal((C, L, F), dtype=np.float32)
    w = rng.random((C, L), dtype=np.float32)
    bv = rng.random((C, L), dtype=np.float32)
    v = rng.standard_normal((C, F), dtype=np.float32)
    for alpha, beta in ((1.0, -1.0), (0.0, 1.0)):
        got = cg_kernels.weighted_matvec_reference(
            *(torch.as_tensor(a) for a in (Yu, w, bv, v)), alpha, beta)
        want = pallas_ops.weighted_matvec_reference(
            *(jnp.asarray(a) for a in (Yu, w, bv, v)), alpha, beta)
        # the same sums in float32, different order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_float64_plain_versions_solve_in_float64():
    Y, idx, dat, x0, yty = _case(8, 24, 16, seed=9)
    args = [torch.as_tensor(a).double() for a in (Y, idx, dat, x0, yty)]
    args[1] = torch.as_tensor(idx)
    for fn in (cg_kernels.cg_solve_full, cg_kernels.gramian_cg_solve):
        out = fn(*args, cg_steps=3)
        assert out.dtype == torch.float64
        f32 = fn(*(a.float() if a.is_floating_point() else a for a in args), cg_steps=3)
        np.testing.assert_allclose(out.numpy(), f32.numpy(), rtol=1e-4, atol=1e-5)


def test_wrappers_refuse_other_devices():
    # a tensor that is neither on the CPU nor launchable raises, never falls back
    Y, idx, dat, x0, yty = _case(8, 16, 8, seed=1)
    meta = [torch.empty(a.shape, dtype=torch.as_tensor(a).dtype, device="meta")
            for a in (Y, idx, dat, x0, yty)]
    for fn in (cg_kernels.cg_solve_full, cg_kernels.gramian_cg_solve):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*meta, cg_steps=3)


def test_reset_launches():
    # one count per C entry point: each kernel in each table type, and
    # cg_update, which reads no table
    assert set(cg_kernels.LAUNCHES) == {
        f"{k}_{v}" for k in ("cg_full", "gramian_cg", "weighted_matvec")
        for v in ("f32", "bf16", "i8")} | {"cg_update"}
    cg_kernels.LAUNCHES["cg_full_f32"] += 3
    cg_kernels.LAUNCHES["weighted_matvec_i8"] += 1
    cg_kernels.reset_launches()
    assert not any(cg_kernels.LAUNCHES.values())
