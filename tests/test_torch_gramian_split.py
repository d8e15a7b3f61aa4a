"""The precision design of the CUDA gramian build, modelled on the CPU.

``csrc/gramian_cg.cu`` builds each row's normal matrix on tensor cores,
whose operands are TF32 or bfloat16: a float32 table takes 3xTF32 (w y and
y each split into hi + lo TF32 parts), bfloat16 and int8 tables two
bfloat16 passes (w y split into hi + lo). The kernel cannot run here, so
``cg_kernels.normal_equations_split`` rounds the operands as the kernel
does, by masking float32 bits, and these tests hold the schemes' 3-step
solves to the float32 plain version: the split schemes within 1e-6 of the
solution's scale (the card's own check is the TF32 reference of
``chip_smoke.py``, phase 2), the single-pass schemes at least 10x farther.
The 3xTF32 model is also held to the JAX package's kernel (the Pallas
interpreter, float32 at ``Precision.HIGHEST``) at the float32 bar, 1e-4.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from implicit_tpu.ops import pallas_ops
from implicit_tpu_torch.ops import cg_kernels
from implicit_tpu_torch.ops.als import _quantize_table

torch.set_num_threads(2)

SPLIT = {"f32": "3xtf32", "bf16": "bf16x2", "i8": "bf16x2"}
SINGLE = {"f32": "tf32", "bf16": "bf16", "i8": "bf16"}


def _case(seed, C=4, L=2048, F=32, n_table=3000):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n_table, F), dtype=np.float32) * 0.1
    idx = rng.integers(0, n_table, size=(C, L), dtype=np.int32)
    dat = rng.random((C, L), dtype=np.float32) * 5 + 1
    dat[rng.random((C, L)) < 0.2] *= -1  # disliked entries
    dat[:, L - 100:] = 0.0  # padding tail
    x0 = rng.standard_normal((C, F), dtype=np.float32) * 0.01
    Ys = Y[:64]
    yty = Ys.T @ Ys + 0.05 * np.eye(F, dtype=np.float32)
    return Y, idx, dat, x0, yty


def _table(Y, variant):
    Yt = torch.as_tensor(Y)
    if variant == "bf16":
        return Yt.to(torch.bfloat16), None
    if variant == "i8":
        return _quantize_table(Yt, "bfloat16")
    return Yt, None


def test_round_tf32_is_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = torch.as_tensor((rng.standard_normal(10000) * 10.0 ** rng.integers(
        -20, 20, 10000)).astype(np.float32))
    r = cg_kernels.round_tf32(x)
    bits = r.view(torch.int32)
    assert not (bits & 0x1FFF).any()  # 10 mantissa bits left
    # nearest: within half a TF32 unit (2^-11 of the power of two below |x|)
    half_ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 12)
    assert ((r - x).abs() <= half_ulp).all()
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11])
    assert cg_kernels.round_tf32(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                                    1.0 + 2.0 ** -9]


def test_round_bf16_matches_torch():
    rng = np.random.default_rng(1)
    x = torch.as_tensor((rng.standard_normal(10000) * 10.0 ** rng.integers(
        -20, 20, 10000)).astype(np.float32))
    ties = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8)])
    for v in (x, ties):
        assert torch.equal(cg_kernels.round_bf16(v), v.to(torch.bfloat16).float())


@pytest.mark.parametrize("scheme,bits", [("3xtf32", 21), ("bf16x2", 15)])
def test_split_reproduces_operand(scheme, bits):
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.standard_normal((3, 50, 16), dtype=np.float32))
    y = cg_kernels.round_bf16(a)  # bf16-exact, as the bf16x2 scheme needs
    terms = cg_kernels._split_terms(a, y, scheme)
    # the hi + lo A operand (the last term's and the first's) against the
    # float32 value, relative
    a_split = terms[-1][0] + terms[0][0]
    assert ((a_split - a).abs() <= 2.0 ** -bits * a.abs()).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
def test_split_scheme_lands_on_plain(variant, seed):
    Y, idx, dat, x0, yty = _case(seed)
    Yt, scales = _table(Y, variant)
    args = (torch.as_tensor(idx), torch.as_tensor(dat), torch.as_tensor(x0),
            torch.as_tensor(yty))
    want = cg_kernels.gramian_cg_solve_plain(Yt, *args, cg_steps=3, scales=scales)
    scale = float(want.abs().max())
    split = cg_kernels.gramian_cg_solve_split(Yt, *args, SPLIT[variant], 3, scales=scales)
    single = cg_kernels.gramian_cg_solve_split(Yt, *args, SINGLE[variant], 3, scales=scales)
    split_err = float((split - want).abs().max())
    single_err = float((single - want).abs().max())
    assert split_err <= 1e-6 * scale
    assert single_err >= 10 * split_err
    if variant == "f32":
        # single-pass TF32 would still pass the float32 bar, rtol = atol =
        # 1e-4: the bar alone cannot tell it from float32
        assert single_err < 1e-4 * (1 + scale)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_split_model_matches_pallas(bf16):
    Y, idx, dat, x0, yty = _case(5, C=8, L=1024)
    Yt = torch.as_tensor(Y)
    Yu = Y[idx]
    if bf16:
        Yt = Yt.to(torch.bfloat16)
        Yu = Yu.astype(ml_dtypes.bfloat16)
    got = cg_kernels.gramian_cg_solve_split(
        Yt, torch.as_tensor(idx), torch.as_tensor(dat), torch.as_tensor(x0),
        torch.as_tensor(yty), "bf16x2" if bf16 else "3xtf32", 3)
    want = pallas_ops.gramian_cg_solve(jnp.asarray(Yu), jnp.asarray(dat), jnp.asarray(x0),
                                       jnp.asarray(yty), cg_steps=3, interpret=True)
    # bf16: the JAX kernel rounds its CG vectors to bf16 (ROADMAP C5), so the
    # JAX package's own kernel bar, 2e-3
    tol = 2e-3 if bf16 else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_split_rejects_an_unknown_scheme():
    Y, idx, dat, x0, yty = _case(0, C=2, L=64, F=8)
    with pytest.raises(ValueError, match="scheme"):
        cg_kernels.normal_equations_split(
            torch.as_tensor(Y), torch.as_tensor(idx), torch.as_tensor(dat),
            torch.as_tensor(yty), "fp8")
