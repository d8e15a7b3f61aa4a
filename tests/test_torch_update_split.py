"""The precision design of the CUDA ``cg_update`` kernel, modelled on the CPU.

``csrc/cg_update.cu`` takes each CG pass's dense term v YtY_reg on tensor
cores in 3xTF32: v and YtY_reg each split into a TF32 part and a TF32
residual, and hi hi + hi lo + lo hi summed in float32. The kernel cannot run
here, so ``cg_kernels.cg_update_split`` rounds the operands as the kernel
does (by masking float32 bits, ``round_tf32``) and runs the plain version's
update on that product. These tests hold the model to the float32 plain
version, ``cg_update_plain``, within 1e-5 of each output's scale on a
residual pass and a CG step at F = 320 and 512 (the wide fits); hold it to
the JAX package's interpreted ``cg_full`` kernel through a
``cg_solve_wide``-shaped loop at F = 320, at the bars of
``tests/test_torch_wide.py`` (float32 1e-3, bfloat16 and int8 5% of scale);
and show that a single TF32 pass lands at least 10x farther from the plain
version (the card's own check is ``chip_smoke.tf32_check``, phase 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wide import C5, _solve_case, _within

from implicit_tpu.ops import als as jals
from implicit_tpu.ops import pallas_ops
from implicit_tpu_torch.ops import als as tals
from implicit_tpu_torch.ops import cg_kernels

torch.set_num_threads(2)


def _inputs(C, F, seed):
    """YtY_reg, a warm start x0, the residual pass's sparse term b and a PSD
    B standing in for a step's sparse term (s = p B), as ``chip_smoke``'s
    ``update_inputs`` makes them; row 1 starts at its solution."""
    rng = np.random.default_rng(seed)
    Ys, Zs = (rng.standard_normal((256, F), dtype=np.float32) * 0.1 for _ in range(2))
    x0 = rng.standard_normal((C, F), dtype=np.float32) * 0.01
    b = rng.standard_normal((C, F), dtype=np.float32) * 0.1
    x0[1] = b[1] = 0.0
    t = torch.as_tensor
    return t(Ys.T @ Ys + 0.05 * np.eye(F, dtype=np.float32)), t(x0), t(b), t(Zs.T @ Zs)


def _pass(update, s, yty, v, state, first, **kw):
    """One pass of ``update`` on a copy of ``state`` (x, r, p, rs, act); on a
    step, v is the copy's p, as ``cg_solve_wide`` passes it."""
    x, r, p, rs, act = (t.clone() for t in state)
    update(s, yty, v if first else p, x, r, p, rs, act, first, **kw)
    return x, r, p, rs, act


def _passes(F, first, scheme="3xtf32", C=96):
    """(plain, split model) after the residual pass, or after a CG step from
    the plain version's residual pass."""
    yty, x0, b, B = _inputs(C, F, seed=F)
    state = [torch.zeros_like(x0) for _ in range(3)] + [
        torch.zeros(C), torch.zeros(C, dtype=torch.int32)]
    if not first:
        state = _pass(cg_kernels.cg_update_plain, b, yty, x0, state, True)
    with cg_kernels.full_f32_matmul():
        s = b if first else state[2] @ B
    want = _pass(cg_kernels.cg_update_plain, s, yty, x0, state, first)
    got = _pass(cg_kernels.cg_update_split, s, yty, x0, state, first, scheme=scheme)
    return want, got


@pytest.mark.parametrize("first", [True, False], ids=["residual", "step"])
@pytest.mark.parametrize("F", [320, 512])
def test_split_update_lands_on_plain(F, first):
    want, got = _passes(F, first)
    assert torch.equal(got[4], want[4])  # the same rows go on
    assert want[4][2:].all() and not want[4][1]  # row 1 at its solution freezes
    for name, g, w in zip(("x", "r", "p", "rs"), got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)
    assert not got[0][1].any()


@pytest.mark.parametrize("F", [320, 512])
def test_single_tf32_pass_lands_10x_farther(F):
    want, split = _passes(F, False)
    _, tf32 = _passes(F, False, scheme="tf32")
    flat = lambda out: torch.cat([t.reshape(-1) for t in out[:4]])  # noqa: E731
    split_err = float((flat(split) - flat(want)).abs().max())
    tf32_err = float((flat(tf32) - flat(want)).abs().max())
    assert tf32_err >= 10 * split_err, (tf32_err, split_err)


def _wide_solve_split(Y, idx, dat, x0, yty, cg_steps=3, scales=None):
    """``cg_kernels.cg_solve_wide``'s passes, with the kernel's model of the
    dense term: the plain sparse term, then ``cg_update_split``."""
    w, bv = tals._weights(dat)
    C = x0.shape[0]
    x, r, p = (torch.empty_like(x0) for _ in range(3))
    rs, act = torch.empty(C), torch.empty(C, dtype=torch.int32)
    s = cg_kernels.weighted_matvec_plain(Y, idx, w, bv, x0, 1.0, -1.0, scales)
    cg_kernels.cg_update_split(s, yty, x0, x, r, p, rs, act, True)
    for _ in range(cg_steps):
        s = cg_kernels.weighted_matvec_plain(Y, idx, w, bv, p, 0.0, 1.0, scales)
        cg_kernels.cg_update_split(s, yty, p, x, r, p, rs, act, False)
    return x


@pytest.mark.parametrize("table", ["f32", "bf16", "int8"])
def test_split_model_solve_matches_pallas_cg_full(table):
    F = 320
    Y, idx, dat, x0, yty = _solve_case(8, 64, F, seed=F + 1)
    t = torch.as_tensor
    jidx = jnp.asarray(idx)
    jargs = (jnp.asarray(dat), jnp.asarray(x0), jnp.asarray(yty), 3)
    if table == "int8":
        tq, ts = tals._quantize_table(t(Y), "bfloat16")
        jq, js = jals._quantize_table(jnp.asarray(Y), "bfloat16")
        got = _wide_solve_split(tq, t(idx), t(dat), t(x0), t(yty), scales=ts.float())
        want = pallas_ops.cg_solve_full(jq[jidx], *jargs, interpret=True, scales=js[jidx])
    else:
        tY, jY = t(Y), jnp.asarray(Y)
        if table == "bf16":
            tY, jY = tY.bfloat16(), jY.astype(jnp.bfloat16)
        got = _wide_solve_split(tY, t(idx), t(dat), t(x0), t(yty))
        want = pallas_ops.cg_solve_full(jY[jidx], *jargs, interpret=True)
    if table == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    else:
        _within(got.numpy(), want, C5)


# YtY_reg's split halves and diagonal by width, in float32 values: 2 halves x
# passes x k padded to 16 x 2 np columns, a pass per 256 columns and np the
# first of 32, 64, 80, 128 that covers F; then one diagonal value per column
# (csrc/cg_update.cu, update_layout). Past two passes (F > 512) the product
# goes through the scratch too.
SPLIT_FLOATS = {8: 2 * 16 * 64 + 64, 100: 2 * 112 * 128 + 128, 257: 2 * 272 * 320 + 320,
                320: 2 * 320 * 320 + 320, 512: 2 * 512 * 512 + 512,
                1000: 2 * 2 * 1008 * 512 + 2 * 512}


@pytest.mark.parametrize("F", sorted(SPLIT_FLOATS))
def test_update_scratch_holds_the_split_and_the_product(F):
    for C in (1, 37, 65536):
        want = SPLIT_FLOATS[F] + (C * F if F > 512 else 0)
        assert cg_kernels._update_scratch(C, F) == max(C * F, want)


def test_split_update_rejects_an_unknown_scheme():
    yty, x0, b, _ = _inputs(4, 8, seed=0)
    state = [torch.zeros_like(x0) for _ in range(3)] + [
        torch.zeros(4), torch.zeros(4, dtype=torch.int32)]
    with pytest.raises(ValueError, match="scheme"):
        _pass(cg_kernels.cg_update_split, b, yty, x0, state, True, scheme="bf16x2")
