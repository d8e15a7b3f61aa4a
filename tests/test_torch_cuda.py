"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs where JAX is not installed; there, skip the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: kernel and plain version read the same inputs and accumulate in
float32 in different orders; rtol = atol = 2e-3 is the JAX package's bar
for its kernels, and float32 is held to 1e-4. The int8 variants are held
to 1e-4 too: kernel and plain version dequantize to the same bfloat16
values and both accumulate in float32.
"""

import contextlib

import numpy as np
import pytest
import torch

from implicit_tpu_torch.ops import cg_kernels
from implicit_tpu_torch.ops.als import _quantize_table, _weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(C, L, F, seed, device, dtype, n_table=500):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n_table, F), dtype=np.float32) * 0.1
    idx = rng.integers(0, n_table, size=(C, L), dtype=np.int32)
    dat = rng.random((C, L), dtype=np.float32) * 5 + 1
    dat[rng.random((C, L)) < 0.2] *= -1  # disliked entries
    lengths = rng.integers(0, L + 1, size=C)
    dat[np.arange(L)[None, :] >= lengths[:, None]] = 0.0
    x0 = rng.standard_normal((C, F), dtype=np.float32) * 0.01
    x0[lengths == 0] = 0.0
    Ys = rng.standard_normal((64, F), dtype=np.float32) * 0.1
    yty = Ys.T @ Ys + 0.05 * np.eye(F, dtype=np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(Y).to(dtype), t(idx), t(dat), t(x0), t(yty)


KERNELS = {
    "cg_full": (cg_kernels.cg_solve_full, cg_kernels.cg_solve_full_plain),
    "gramian_cg": (cg_kernels.gramian_cg_solve, cg_kernels.gramian_cg_solve_plain),
}


# F = 10: an int8 row of 10 bytes is no whole number of 4-byte words, so
# cg_full loads it element by element; F = 136: 8 values per lane, the last
# lanes' chunks past F
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("F", [8, 10, 32, 64, 100, 128, 136, 200, 256])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_plain(cuda, name, F, dtype):
    kernel, plain = KERNELS[name]
    C, L = (37, 80) if name == "cg_full" else (13, 300)
    args = _case(C, L, F, seed=F, device=cuda, dtype=dtype)
    key = f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}"
    before = cg_kernels.LAUNCHES[key]
    got = kernel(*args, cg_steps=3)
    torch.cuda.synchronize()
    assert cg_kernels.LAUNCHES[key] == before + 1
    want = plain(*args, cg_steps=3)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [8, 10, 32, 64, 100, 128, 136, 200, 256])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_int8_kernel_matches_plain(cuda, name, F, compute):
    kernel, plain = KERNELS[name]
    C, L = (37, 80) if name == "cg_full" else (13, 300)
    Y, idx, dat, x0, yty = _case(C, L, F, seed=F + 1, device=cuda, dtype=torch.float32)
    q, s = _quantize_table(Y, compute)  # float32 or bfloat16 scales
    before = cg_kernels.LAUNCHES[f"{name}_i8"]
    got = kernel(q, idx, dat, x0, yty, cg_steps=3, scales=s)
    torch.cuda.synchronize()
    assert cg_kernels.LAUNCHES[f"{name}_i8"] == before + 1
    want = plain(q, idx, dat, x0, yty, cg_steps=3, scales=s)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)


def _table(Y, variant):
    """The float32 table ``Y`` as the variant takes it: (table, scales)."""
    if variant == "bf16":
        return Y.to(torch.bfloat16), None
    if variant == "i8":
        return _quantize_table(Y, "bfloat16")
    return Y, None


def _seen_rows(variant):
    """What the variant's solve reads of a float32 table, as numpy: for
    ``freeze_case``'s ``seen``."""
    def seen(Y):
        q, s = _table(torch.as_tensor(Y), variant)
        return (q.float() if s is None else cg_kernels.dequantize_rows(q, s).float()).numpy()
    return seen


@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("F", [10, 128, 256])
def test_cg_full_freezing_rows_match_plain(cuda, F, variant):
    """Rows that freeze at different CG steps solved in lockstep blocks: each
    frozen row keeps its x from the step it froze at (bit for bit), and the
    chunk matches the plain version; C = 45 is no multiple of the block's rows."""
    Y, idx, dat, x0, yty, steps = cg_kernels.freeze_case(45, 32, F, seed=F,
                                                         seen=_seen_rows(variant))
    Y, idx, dat, x0, yty = (torch.as_tensor(a, device=cuda) for a in (Y, idx, dat, x0, yty))
    Y, scales = _table(Y, variant)
    xs = [cg_kernels.cg_solve_full(Y, idx, dat, x0, yty, cg_steps=s, scales=scales).cpu()
          for s in range(4)]
    want = cg_kernels.cg_solve_full_plain(Y, idx, dat, x0, yty, cg_steps=3, scales=scales)
    tol = 2e-3 if variant == "bf16" else 1e-4
    np.testing.assert_allclose(xs[3].numpy(), want.cpu().numpy(), rtol=tol, atol=tol)
    for c, s in enumerate(steps):
        if s >= 0:
            assert torch.equal(xs[s][c], xs[3][c]), (c, s)
    assert torch.equal(xs[3][steps == 0], x0.cpu()[steps == 0])


@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("F", [128, 256])
def test_cg_full_is_deterministic(cuda, F, variant):
    Y, idx, dat, x0, yty = _case(301, 200, F, seed=F + 7, device=cuda, dtype=torch.float32)
    Y, scales = _table(Y, variant)
    runs = [cg_kernels.cg_solve_full(Y, idx, dat, x0, yty, cg_steps=3, scales=scales)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def _gramian_slices(C, L, F):
    from implicit_tpu_torch.ops import _build

    return _build.load("gramian_cg")["gramian_cg"].gramian_cg_slices(C, L, F)


# F = 10: an int8 row of 10 bytes is no whole number of 4-byte copies, so the
# build stages it with plain loads instead of cp.async
@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("F", [8, 10, 100, 128, 200, 256])
def test_gramian_split_rows_match_plain(cuda, F, variant):
    C, L = 3, 20000  # each row split over many L-slices, summed in order
    assert _gramian_slices(C, L, F) > 1
    Y, idx, dat, x0, yty = _case(C, L, F, seed=F + 3, device=cuda, dtype=torch.float32,
                                 n_table=5000)
    Y, scales = _table(Y, variant)
    before = cg_kernels.LAUNCHES[f"gramian_cg_{variant}"]
    got = cg_kernels.gramian_cg_solve(Y, idx, dat, x0, yty, cg_steps=3, scales=scales)
    torch.cuda.synchronize()
    assert cg_kernels.LAUNCHES[f"gramian_cg_{variant}"] == before + 1
    want = cg_kernels.gramian_cg_solve_plain(Y, idx, dat, x0, yty, cg_steps=3, scales=scales)
    tol = 2e-3 if variant == "bf16" else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("C,L", [(64, 4096), (8, 65536)])
def test_gramian_f32_is_not_tf32(cuda, monkeypatch, C, L):
    # single-pass TF32 would pass the 1e-4 bar; the float32 build (3xTF32)
    # must land at least 10x closer to the float32 plain version than the
    # plain version computed in TF32 does (its per-product full-float32 pin
    # lifted, TF32 on)
    Y, idx, dat, x0, yty = _case(C, L, 128, seed=C, device=cuda, dtype=torch.float32,
                                 n_table=20000)
    got = cg_kernels.gramian_cg_solve(Y, idx, dat, x0, yty, cg_steps=3)
    want = cg_kernels.gramian_cg_solve_plain(Y, idx, dat, x0, yty, cg_steps=3)
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        m.setattr(cg_kernels, "full_f32_matmul", contextlib.nullcontext)
        tf32 = cg_kernels.gramian_cg_solve_plain(Y, idx, dat, x0, yty, cg_steps=3)
    err = float((got - want).abs().max())
    tf32_err = float((tf32 - want).abs().max())
    assert tf32_err > 0
    assert err <= 0.1 * tf32_err, (err, tf32_err)


@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
def test_gramian_is_deterministic(cuda, variant):
    Y, idx, dat, x0, yty = _case(4, 20000, 128, seed=5, device=cuda, dtype=torch.float32,
                                 n_table=5000)
    Y, scales = _table(Y, variant)
    runs = [cg_kernels.gramian_cg_solve(Y, idx, dat, x0, yty, cg_steps=3, scales=scales)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
def test_gramian_padding_skip(cuda, variant):
    """Rows with all-zero entry groups before, between and after live ones,
    and an all-padding row, against the plain version (which sums them)."""
    C, L, F = 6, 8192, 128
    Y, idx, dat, x0, yty = _case(C, L, F, seed=11, device=cuda, dtype=torch.float32,
                                 n_table=5000)
    dat = torch.abs(dat) + 1.0
    dat[0, :4000] = 0.0             # live entries only after 125 empty groups
    dat[1, 64:4096] = 0.0           # an empty stretch between live groups
    dat[2, :] = 0.0                 # all padding, from x0 = 0: stays at 0
    x0[2] = 0.0
    dat[3, :8100] = 0.0
    dat[3, 8191] = 2.0              # one live entry, in the last group
    dat[4, 33::64] = 0.0            # isolated zeros inside live groups
    Y, scales = _table(Y, variant)
    got = cg_kernels.gramian_cg_solve(Y, idx, dat, x0, yty, cg_steps=3, scales=scales)
    want = cg_kernels.gramian_cg_solve_plain(Y, idx, dat, x0, yty, cg_steps=3, scales=scales)
    assert torch.equal(got[2], x0[2])
    tol = 2e-3 if variant == "bf16" else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


# F = 10 and (int8) 1000: rows of no whole number of 16-byte pieces, loaded
# element by element; 320 / 512: the wide fits' widths, held in registers;
# 1000, 2000: the two-sweep kernel of rows wider than 512 values
@pytest.mark.parametrize("alpha,beta", [(1.0, -1.0), (0.0, 1.0)])
@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("F", [8, 10, 32, 100, 128, 256, 320, 512, 1000, 2000])
def test_weighted_matvec_matches_plain(cuda, F, variant, alpha, beta):
    C, L = 37, 83  # L not a multiple of 32: the row loop ends mid-group
    Y, idx, dat, x0, _ = _case(C, L, F, seed=F + 2, device=cuda, dtype=torch.float32)
    w, bv = _weights(dat)
    v = x0 * 10
    scales = None
    if variant == "bf16":
        Y = Y.to(torch.bfloat16)
    elif variant == "i8":
        Y, scales = _quantize_table(Y, "bfloat16")
    before = cg_kernels.LAUNCHES[f"weighted_matvec_{variant}"]
    got = cg_kernels.weighted_matvec(Y, idx, w, bv, v, alpha, beta, scales=scales)
    torch.cuda.synchronize()
    assert cg_kernels.LAUNCHES[f"weighted_matvec_{variant}"] == before + 1
    want = cg_kernels.weighted_matvec_plain(Y, idx, w, bv, v, alpha, beta, scales=scales)
    tol = 2e-3 if variant == "bf16" else 1e-4
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


def _wmv_inputs(C, L, F, variant, seed, device, n_table=5000):
    """weighted_matvec's inputs (table, scales, idx, w, bv, v) for a chunk of
    C rows of L entries with padding tails."""
    Y, idx, dat, x0, _ = _case(C, L, F, seed=seed, device=device, dtype=torch.float32,
                               n_table=n_table)
    w, bv = _weights(dat)
    Y, scales = _table(Y, variant)
    return Y, scales, idx, w, bv, x0 * 10


@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("F", [128, 320, 512, 1000])
def test_weighted_matvec_long_rows_are_deterministic(cuda, F, variant):
    """The head class's shape: C = 8 rows, each cut into many L-slices whose
    partial sums add in slice order; against the plain version, and twice
    for the same bits."""
    Y, scales, idx, w, bv, v = _wmv_inputs(8, 20000, F, variant, seed=F, device=cuda)
    for alpha, beta in ((1.0, -1.0), (0.0, 1.0)):
        runs = [cg_kernels.weighted_matvec(Y, idx, w, bv, v, alpha, beta, scales=scales)
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        want = cg_kernels.weighted_matvec_plain(Y, idx, w, bv, v, alpha, beta, scales=scales)
        tol = 2e-3 if variant == "bf16" else 1e-4
        np.testing.assert_allclose(runs[0].cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


def test_weighted_matvec_edge_shapes(cuda):
    """No rows, no entries, all-padding rows, and one live entry per row at
    the end of a long row: each row's sum is exactly what the plain version
    gives (zeros where nothing is live)."""
    Y, scales, idx, w, bv, v = _wmv_inputs(5, 3000, 320, "f32", seed=1, device=cuda)
    w[:, :-1] = 0.0
    bv[:, :-1] = 0.0
    w[2] = bv[2] = 0.0
    got = cg_kernels.weighted_matvec(Y, idx, w, bv, v, 1.0, -1.0)
    want = cg_kernels.weighted_matvec_plain(Y, idx, w, bv, v, 1.0, -1.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert not got[2].any()
    empty = cg_kernels.weighted_matvec(Y, idx[:0], w[:0], bv[:0], v[:0], 1.0, -1.0)
    assert empty.shape == (0, 320)
    none = cg_kernels.weighted_matvec(Y, idx[:, :0].contiguous(), w[:, :0].contiguous(),
                                      bv[:, :0].contiguous(), v, 1.0, -1.0)
    assert not none.any()


def _update_state(C, F, device, seed):
    """YtY_reg, a warm start x0 and a PSD matrix B standing in for the
    sparse term, for cg_update; rows 0 and 1 start at their solution (x0 = 0
    and a zero sparse term), so they never move."""
    rng = np.random.default_rng(seed)
    Ys, Zs = (rng.standard_normal((64, F), dtype=np.float32) * 0.1 for _ in range(2))
    yty = torch.as_tensor(Ys.T @ Ys + 0.05 * np.eye(F, dtype=np.float32), device=device)
    x0 = torch.as_tensor(rng.standard_normal((C, F), dtype=np.float32) * 0.1, device=device)
    x0[:2] = 0.0
    return rng, yty, x0, torch.as_tensor(Zs.T @ Zs, device=device)


def _update_pass(update, b, B, yty, x0, state, first):
    """One pass of ``update`` (the kernel or its plain version) on a copy of
    ``state`` (x, r, p, rs, act). The sparse term is ``b`` on the first pass
    and p B on a step, so that A = B + YtY_reg is positive definite."""
    x, r, p, rs, act = (t.clone() for t in state)
    with cg_kernels.full_f32_matmul():
        s = b.clone() if first else p @ B
    update(s, yty, x0 if first else p, x, r, p, rs, act, first)
    torch.cuda.synchronize()
    return x, r, p, rs, act


# F = 8 and 100: one narrow panel per warpgroup, F not a multiple of 16
# (or, at 100, of 32); 257: F odd (no 16-byte loads), panels of 160; 320,
# 512: the wide fits; 1000: two passes of 512 columns, the product through
# the scratch
@pytest.mark.parametrize("F", [8, 100, 257, 320, 512, 1000])
def test_cg_update_matches_plain(cuda, F):
    """The residual pass and three CG steps, kernel and plain version each
    from the plain version's last state (v is p on a step, as in the
    solve), C = 165 rows (two blocks of 64 and a partial one): every output
    (x, r, p, rs) within 1e-4 and the active flags equal after each pass;
    the kernel twice from one state gives the same bits; rows 0 and 1, at
    their solution, never move, and row 2, frozen after the residual pass,
    keeps its x, r, p and rs bit for bit."""
    C = 165
    rng, yty, x0, B = _update_state(C, F, cuda, seed=F)
    b = torch.as_tensor(rng.standard_normal((C, F), dtype=np.float32), device=cuda)
    b[:2] = 0.0
    state = [torch.zeros_like(x0) for _ in range(3)] + [
        torch.zeros(C, device=cuda), torch.zeros(C, dtype=torch.int32, device=cuda)]
    for step in range(4):
        if step == 1:
            state[4][2] = 0  # row 2 frozen from here on
            frozen = [t[2].clone() for t in state]
        before = cg_kernels.LAUNCHES["cg_update"]
        out = {name: _update_pass(update, b, B, yty, x0, state, step == 0)
               for name, update in (("kernel", cg_kernels.cg_update),
                                    ("plain", cg_kernels.cg_update_plain))}
        again = _update_pass(cg_kernels.cg_update, b, B, yty, x0, state, step == 0)
        assert cg_kernels.LAUNCHES["cg_update"] == before + 2
        for got, rerun, want in zip(out["kernel"], again, out["plain"]):
            assert torch.equal(got, rerun)
            if got.dtype == torch.int32:
                assert torch.equal(got, want)
            else:
                np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                                           atol=1e-4)
        assert not out["kernel"][0][:2].any() and not out["kernel"][4][:2].any()
        assert out["kernel"][4][3:].all()  # every other row still active
        if step:
            assert all(torch.equal(t[2], f) for t, f in zip(out["kernel"], frozen))
        state = out["plain"]


@pytest.mark.parametrize("F", [320, 512])
def test_cg_update_is_not_tf32(cuda, monkeypatch, F):
    """The dense term is float32, not single-pass TF32 (which the 1e-4 bar
    would pass): a CG step lands at least 10x closer to the float32 plain
    version than the plain version computed in TF32 does (its per-product
    full-float32 pin lifted)."""
    C = 256
    rng, yty, x0, B = _update_state(C, F, cuda, seed=F + 1)
    b = torch.as_tensor(rng.standard_normal((C, F), dtype=np.float32), device=cuda)
    state = [torch.zeros_like(x0) for _ in range(3)] + [
        torch.zeros(C, device=cuda), torch.zeros(C, dtype=torch.int32, device=cuda)]
    state = _update_pass(cg_kernels.cg_update_plain, b, B, yty, x0, state, True)
    with cg_kernels.full_f32_matmul():
        s = state[2] @ B

    def step(update):
        x, r, p, rs, act = (t.clone() for t in state)
        update(s, yty, p, x, r, p, rs, act, False)
        return torch.cat([x, r, p], 1)

    got, want = step(cg_kernels.cg_update), step(cg_kernels.cg_update_plain)
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        m.setattr(cg_kernels, "full_f32_matmul", contextlib.nullcontext)
        tf32 = step(cg_kernels.cg_update_plain)
    err = float((got - want).abs().max())
    tf32_err = float((tf32 - want).abs().max())
    assert tf32_err > 0
    assert err <= 0.1 * tf32_err, (err, tf32_err)


@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
def test_cg_solve_wide_freezing_rows_match_plain(cuda, variant):
    """cg_kernels.freeze_case at F = 320: rows freezing at different CG
    steps in one chunk. The solve on the two kernels matches the plain
    version, and a row frozen at step s keeps that step's x bit for bit."""
    Y, idx, dat, x0, yty, steps = cg_kernels.freeze_case(101, 64, 320, seed=5,
                                                         seen=_seen_rows(variant))
    Y, idx, dat, x0, yty = (torch.as_tensor(a, device=cuda) for a in (Y, idx, dat, x0, yty))
    Y, scales = _table(Y, variant)
    xs = [cg_kernels.cg_solve_wide(Y, idx, dat, x0, yty, s, scales=scales) for s in range(4)]
    want = cg_kernels.cg_solve_full_plain(Y, idx, dat, x0, yty, 3, scales=scales)
    tol = 2e-3 if variant == "bf16" else 1e-4
    np.testing.assert_allclose(xs[3].cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)
    for s in range(4):
        rows = torch.as_tensor(steps == s, device=cuda)
        assert torch.equal(xs[s][rows], xs[3][rows])


def test_cg_update_refuses_what_it_does_not_take(cuda):
    _, yty, x0, _ = _update_state(8, 16, cuda, seed=0)
    x, r, p, s = (torch.zeros_like(x0) for _ in range(4))
    rs = torch.zeros(8, device=cuda)
    act = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cg_kernels.cg_update(s, yty, x0, x, r, p, rs, act.float(), True)
    with pytest.raises(TypeError):
        cg_kernels.cg_update(s.double(), yty, x0, x, r, p, rs, act, True)
    with pytest.raises(ValueError, match="shape"):
        cg_kernels.cg_update(s, yty[:8].contiguous(), x0, x, r, p, rs, act, True)
    with pytest.raises(ValueError, match="contiguous"):
        cg_kernels.cg_update(s, yty.T, x0, x, r, p, rs, act, True)
    with pytest.raises(ValueError):
        cg_kernels.cg_update(s, yty, x0, x.cpu(), r, p, rs, act, True)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_refuses_what_it_does_not_take(cuda, name):
    kernel, _ = KERNELS[name]
    Y, idx, dat, x0, yty = _case(8, 16, 16, seed=0, device=cuda, dtype=torch.float32)
    with pytest.raises(TypeError):
        kernel(Y.half(), idx, dat, x0, yty)
    with pytest.raises(TypeError):
        kernel(Y, idx.long(), dat, x0, yty)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(Y, idx, dat, x0.T.contiguous().T, yty)
    with pytest.raises(ValueError, match="shape"):
        kernel(Y, idx, dat[:, :8].contiguous(), x0, yty)
    with pytest.raises(ValueError):
        kernel(Y, idx, dat.cpu(), x0, yty)
    wide = _case(8, 16, 264, seed=0, device=cuda, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        kernel(*wide)


def test_fit_on_cuda_matches_cpu(cuda):
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(2000, 700, 60000, seed=3)
    factors = {}
    for dev in ("cpu", cuda):
        model = AlternatingLeastSquares(factors=32, iterations=1, random_state=0, device=dev)
        model.fit(plays, show_progress=False)
        factors[str(dev)] = model.item_factors
    # one iteration of float32 solves in two summation orders; each further
    # iteration of 3-step CG grows the drift of poorly conditioned rows. On
    # an H100 the item factors differ by at most 1.7e-5 elementwise
    # (relative Frobenius 1.4e-4) after one iteration, and by 3.2e-4 (1.4e-3)
    # after three, where rtol = 1e-3 / atol = 1e-4 no longer holds; the JAX
    # package and the port on the CPU differ by 2.4e-4 / 1.6e-3 (Frobenius)
    np.testing.assert_allclose(factors["cuda"], factors["cpu"], rtol=1e-3, atol=1e-4)
    diff = np.linalg.norm(factors["cuda"] - factors["cpu"])
    assert diff <= 1e-3 * np.linalg.norm(factors["cpu"])


def test_virtual_mesh_fit_on_cuda_matches_cpu(cuda):
    """A meshed fit on a virtual mesh of 4 shards on the card against the
    same on a virtual CPU mesh, at test_fit_on_cuda_matches_cpu's bar: the
    same layout and gramian order, the kernels against their plain
    versions; every shard launches its routed chunks. Served through both
    meshes, the ids agree up to ties."""
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic
    from implicit_tpu_torch.parallel import virtual_mesh

    plays = generate_synthetic(2000, 700, 60000, seed=3)
    models = {}
    for dev in ("cpu", cuda):
        model = AlternatingLeastSquares(factors=32, iterations=1, random_state=0,
                                        mesh=virtual_mesh(4, dev), device=dev)
        cg_kernels.reset_launches()
        model.fit(plays, show_progress=False)
        models[str(dev)] = model
    launched = {k: v for k, v in cg_kernels.LAUNCHES.items() if v}
    assert set(launched) == {"cg_full_f32", "gramian_cg_f32"}, launched
    got, want = models["cuda"].item_factors, models["cpu"].item_factors
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    users = np.arange(256)
    ids_c, sc_c = models["cuda"].recommend(users, plays[users], N=10)
    single = AlternatingLeastSquares(factors=32, device=cuda)
    single.user_factors, single.item_factors = (models["cuda"].user_factors,
                                                models["cuda"].item_factors)
    ids_s, sc_s = single.recommend(users, plays[users], N=10)
    np.testing.assert_allclose(sc_c, sc_s, rtol=1e-6)
    assert (ids_c == ids_s).mean() > 0.99


def test_virtual_mesh_pickles_as_virtual(cuda, monkeypatch):
    """A model on a virtual mesh of the card restores on a virtual mesh of
    its device; a model asking for two cards where one is visible raises
    when it serves, and never serves from the CPU."""
    import pickle

    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.parallel import virtual_mesh

    rng = np.random.default_rng(0)
    model = AlternatingLeastSquares(factors=16, mesh=virtual_mesh(4, cuda), device=cuda)
    model.user_factors = rng.standard_normal((50, 16), dtype=np.float32)
    model.item_factors = rng.standard_normal((300, 16), dtype=np.float32)
    want = model.recommend(np.arange(50), None, N=5, filter_already_liked_items=False)
    restored = pickle.loads(pickle.dumps(model))
    assert restored.mesh == 4 and restored._serving_mesh() == virtual_mesh(4, cuda)
    got = restored.recommend(np.arange(50), None, N=5, filter_already_liked_items=False)
    np.testing.assert_array_equal(got[0], want[0])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    restored.mesh = 2
    restored._mesh_virtual = False
    with pytest.raises(ValueError, match="CUDA device"):
        restored.recommend(np.arange(50), None, N=5, filter_already_liked_items=False)


def test_wide_fit_on_cuda_matches_cpu(cuda):
    """factors=320, past what cg_full and gramian_cg take: every class of the
    fit solves in the composed CG on weighted_matvec, on the card as on the
    CPU (where the wrapper takes the plain version), to the same bar as the
    factors=32 fit above. The fit starts from seeded factors of mixed sign:
    from the model's all-positive random start, whose gramian is nearly rank
    one, 3-step float32 CG grows summation order on a few rows past 1e-4
    (an H100 run: 111 of 224,000 item factors, up to 3.4e-4), kernel or not."""
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(2000, 700, 60000, seed=3)
    rng = np.random.default_rng(5)
    start = [rng.standard_normal((n, 320), dtype=np.float32) * 0.1 for n in plays.shape]
    factors = {}
    for dev in ("cpu", cuda):
        model = AlternatingLeastSquares(factors=320, iterations=1, random_state=0, device=dev)
        model.user_factors, model.item_factors = (f.copy() for f in start)
        cg_kernels.reset_launches()
        model.fit(plays, show_progress=False)
        factors[str(dev)] = model.item_factors
    launched = {k: v for k, v in cg_kernels.LAUNCHES.items() if v}
    assert set(launched) == {"weighted_matvec_f32", "cg_update"}
    assert launched["weighted_matvec_f32"] == launched["cg_update"]
    np.testing.assert_allclose(factors["cuda"], factors["cpu"], rtol=1e-3, atol=1e-4)
    diff = np.linalg.norm(factors["cuda"] - factors["cpu"])
    assert diff <= 1e-3 * np.linalg.norm(factors["cpu"])


@pytest.mark.parametrize("factors", [128, 320])
def test_tf32_does_not_move_fit_or_recommend(cuda, monkeypatch, factors):
    """The port pins full float32 around its own products: with TF32 turned
    on by the caller, a float32 fit and recommend give the same bits as with
    it off, and the caller's setting stays on."""
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(2000, 700, 60000, seed=4)
    users = np.arange(64)

    def run():
        model = AlternatingLeastSquares(factors=factors, iterations=2, random_state=0,
                                        device=cuda)
        model.fit(plays, show_progress=False)
        ids, scores = model.recommend(users, plays[users], N=10)
        return model.user_factors, model.item_factors, ids, scores

    off = run()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    on = run()
    assert torch.backends.cuda.matmul.allow_tf32
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def _shuffled_rows(m, seed):
    """``m`` with every row's entries stored in a shuffled order."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    order = np.concatenate([lo + rng.permutation(hi - lo)
                            for lo, hi in zip(m.indptr[:-1], m.indptr[1:])])
    return sp.csr_matrix((m.data[order], m.indices[order], m.indptr.copy()), shape=m.shape)


@pytest.mark.parametrize("grid", ["pow2", "fine"])
def _assert_same_pack(got, want):
    """Two (user, item) DeviceBuckets pairs hold the same plans and every
    class tensor bit for bit with its dtype; ``got`` lies on the card."""
    for g, w in zip(got, want):
        assert (g.shape, g.nnz, g.sentinel) == (w.shape, w.nnz, w.sentinel)
        assert (g.empty_rows is None) == (w.empty_rows is None)
        if w.empty_rows is not None:
            assert torch.equal(g.empty_rows.cpu(), w.empty_rows.cpu())
        assert [(c.L, c.C, c.n_chunks, c.n_valid) for c in g.classes] == \
            [(c.L, c.C, c.n_chunks, c.n_valid) for c in w.classes]
        for gc, wc in zip(g.classes, w.classes):
            for name in ("rows", "indices", "data", "lengths"):
                a, b = getattr(gc, name), getattr(wc, name)
                assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), name


@pytest.mark.parametrize("grid", ["pow2", "fine"])
def test_device_pack_on_cuda_matches_host_pack(cuda, monkeypatch, grid):
    """The pack on the card gives the same pack's tensors on the CPU, each
    equal with its dtype, on rows stored out of column order; every side of
    both goes through the one gather (``sparse._pack_side``)."""
    from implicit_tpu_torch import sparse
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = _shuffled_rows(generate_synthetic(2000, 700, 60000, seed=3).astype(np.float32), 1)
    kw = dict(target_entries=1 << 14, max_chunk_rows=512, grid=grid)
    calls = []
    real = sparse._pack_side
    monkeypatch.setattr(sparse, "_pack_side", lambda *a: calls.append(a[-1]) or real(*a))
    host = sparse.pack_pair_on_device(plays, device="cpu", **kw)
    got = sparse.pack_pair_on_device(plays, device=cuda, **kw)
    _assert_same_pack(got, host)
    assert [torch.device(d).type for d in calls] == ["cpu", "cpu", "cuda", "cuda"]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_fit_with_device_ingest_equals_host_ingest_on_cuda(cuda, dtype):
    """The pack of a factors=32 fit on the card equals the same pack on the
    CPU, every tensor bit for bit; every ``ingest`` value fits the same
    bits; a fit of no iterations returns numpy's start (float32 draw times
    0.01, cast to the storage dtype), scaled and cast on the card."""
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic
    from implicit_tpu_torch.sparse import als_chunk_target, pack_pair_on_device

    plays = generate_synthetic(2000, 700, 60000, seed=3)
    compute = "bfloat16" if dtype == np.float16 else "float32"
    kw = dict(target_entries=als_chunk_target(32, compute), max_chunk_rows=65536, grid="pow2",
              data_dtype=np.float32)
    _assert_same_pack(pack_pair_on_device(plays.astype(np.float32), device=cuda, **kw),
                      pack_pair_on_device(plays.astype(np.float32), device="cpu", **kw))
    fits = {}
    for ingest, iterations in (("auto", 2), ("device", 2), ("host", 2), ("auto", 0)):
        model = AlternatingLeastSquares(factors=32, iterations=iterations, random_state=0,
                                        dtype=dtype, ingest=ingest, device=cuda)
        model.fit(plays, show_progress=False)
        fits[ingest, iterations] = (model.user_factors, model.item_factors)
    for ingest in ("device", "host"):
        for a, b in zip(fits[ingest, 2], fits["auto", 2]):
            assert a.dtype == dtype
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for got, n in zip(fits["auto", 0], plays.shape):
        want = (rng.random((n, 32), dtype=np.float32) * 0.01).astype(dtype)
        np.testing.assert_array_equal(got, want)


# -- the SGD families (BPR, LMF): torch ops, no kernel of their own -------------


def _sgd_plays(seed=5):
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(3000, 1500, 90000, seed=seed).astype(np.float32)
    plays.sort_indices()
    return plays


@pytest.mark.parametrize("verifier", ["cuckoo", "bisection"])
@pytest.mark.parametrize("epoch", ["grouped", "sampled", "pool2", "pool1"])
def test_bpr_epoch_with_injected_draws_on_cuda_matches_cpu(cuda, epoch, verifier):
    """One BPR epoch with draws made on the host, on the card and on the CPU:
    within 1e-5 of each output's scale (the CPU tests' bar against the JAX
    package: float32 sums in another order), the counts exact. The grouped
    epoch also in its pool modes."""
    from implicit_tpu_torch.models import bpr
    from implicit_tpu_torch.ops import membership

    plays = _sgd_plays()
    rng = np.random.default_rng(6)
    users, items = plays.shape
    F, lr, reg = 32, 0.05, 0.01
    start = [rng.standard_normal(s, dtype=np.float32) * 0.1
             for s in ((users, F), (items, F), (items,))]
    pt = membership.build_pair_table(plays)
    iters = int(np.ceil(np.log2(np.diff(plays.indptr).max()))) + 1
    userids = np.repeat(np.arange(users), np.diff(plays.indptr))
    shapes = [idx.shape[1:] for _, idx, _, n in bpr.grouped_classes(plays, "cpu") for _ in n]
    arr = None
    if epoch == "grouped":
        draws = [rng.integers(0, plays.nnz, size=s) for s in shapes]
    elif epoch.startswith("pool"):
        arr = bpr.pool_arrangement(rng, plays, max(L for _, L in shapes)).astype(np.int64)
        draws = [rng.integers(0, len(arr) - L, size=C) for C, L in shapes]
    else:
        draws = [rng.integers(0, plays.nnz, size=(2, 4096)) for _ in range(8)]
    out = {}
    for name, dev in (("cpu", "cpu"), ("cuda", cuda)):
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
        X, Y, yb = (t(a).clone() for a in start)
        flat = (t(plays.indices.astype(np.int64)), t(plays.indptr.astype(np.int64)))
        table, bits = (pt.to_device(dev), pt.bits) if verifier == "cuckoo" else (None, None)
        if epoch == "grouped" or epoch.startswith("pool"):
            pool_mode = int(epoch[-1]) if epoch.startswith("pool") else 0
            counts = bpr._bpr_epoch_grouped(X, Y, yb, bpr.grouped_classes(plays, dev), *flat,
                                            table, [t(d) for d in draws], lr, reg, True, iters,
                                            bits, pool_mode=pool_mode,
                                            arrangement=None if arr is None else t(arr))
        else:
            counts = bpr._bpr_epoch(X, Y, yb, t(userids), *flat, table,
                                    [(t(d[0]), t(d[1])) for d in draws], lr, reg, True, iters,
                                    bits)
        out[name] = [T.cpu().numpy() for T in (X, Y, yb)], [int(c) for c in counts]
    assert out["cuda"][1] == out["cpu"][1] and out["cpu"][1][1] > 0
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("route", ["glued", "split", "legacy"])
def test_lmf_class_update_with_injected_draws_on_cuda_matches_cpu(cuda, route):
    """One LMF class update with draws made on the host, on the card and on
    the CPU, in each pool route: within 2e-3 of each output's scale, the
    port's bfloat16 bar (the scores are rounded to bfloat16; where the
    devices' float32 logits straddle a rounding boundary a score moves by
    2**-9 relative, and a row element with a gradient near 0 by about 1e-3:
    8.8e-4 of scale in an H100 run of chip_smoke.py); the pinned column
    exactly 1."""
    from implicit_tpu_torch.models import lmf
    from implicit_tpu_torch.sparse import pack_pair_on_device

    plays = _sgd_plays()
    rng = np.random.default_rng(7)
    width, window = (130, True) if route == "split" else (34, route != "legacy")
    neg_prop = 3
    X0 = rng.standard_normal((plays.shape[0], width), dtype=np.float32) * 0.3
    Y0 = rng.standard_normal((plays.shape[1], width), dtype=np.float32) * 0.3
    d0 = 0.5 + rng.random((plays.shape[0], width), dtype=np.float32)
    arr = rng.permutation(plays.indices).astype(np.int64)
    out, draws = {}, None
    for name, dev in (("cpu", "cpu"), ("cuda", cuda)):
        buckets = pack_pair_on_device(plays, target_entries=1 << 14, grid="pow2",
                                      device=dev)[0]
        cls = max(buckets.classes, key=lambda c: c.n_chunks)
        neg_count = min(plays.shape[1], cls.L * neg_prop)
        G = -(-cls.C // 8)
        if draws is None:
            draws = [rng.integers(0, plays.nnz, size=(G,) if window else (G, neg_count))
                     for _ in range(cls.n_chunks)]
        X, dss, Y = (torch.as_tensor(a, device=dev).clone() for a in (X0, d0, Y0))
        a = torch.as_tensor(np.concatenate([arr, arr[:neg_count]]), device=dev)
        src = lmf._build_pool(Y, a, lmf._pool_split(width)) if window else a
        lmf._lmf_class_update(X, dss, Y, src, cls, [torch.as_tensor(d, device=dev) for d in draws],
                              1.0, 0.6, neg_prop, neg_count, -2, window)
        out[name] = X.cpu().numpy(), dss.cpu().numpy()
    assert (out["cuda"][0][:, -2] == 1.0).all()
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


@pytest.mark.parametrize("family", ["bpr-grouped", "bpr-sampled", "bpr-grouped_pool",
                                    "bpr-grouped_pool_ids", "lmf"])
def test_sgd_fits_repeat_bit_for_bit_on_cuda(cuda, family):
    """Two fits with the same random_state give the same bits on the card
    (BPR accumulates colliding rows in a fixed order: the grouped epoch's
    item rows through the bpr_item_update kernel, every other update with
    index_put_(accumulate=True)), with the pinned columns intact, and
    serve."""
    from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
    from implicit_tpu_torch.lmf import LogisticMatrixFactorization

    plays = _sgd_plays(seed=8)
    fits = []
    for _ in range(2):
        if family == "lmf":
            model = LogisticMatrixFactorization(factors=32, iterations=5, random_state=3,
                                                device=cuda)
        else:
            model = BayesianPersonalizedRanking(factors=64, iterations=3, random_state=3,
                                                epoch_mode=family.split("-")[1], device=cuda)
        model.fit(plays, show_progress=False)
        fits.append((model.user_factors, model.item_factors))
    for a, b in zip(*fits):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
    if family == "lmf":
        assert (fits[0][0][:, -2] == 1).all() and (fits[0][1][:, -1] == 1).all()
    else:
        assert (fits[0][0][:, -1] == 1).all()
    ids, scores = model.recommend(np.arange(64), plays[:64], N=10)
    assert ids.shape == (64, 10) and np.isfinite(scores).all()
    assert not any(np.isin(ids[u], plays[u].indices).any() for u in range(64))


# BPR's grouped item update: csrc/bpr_item_update.cu against its plain version


def _bpr_item_chunks(cuda, F, seed):
    """Inputs of ``bpr_item_update`` at the chunk shapes ``grouped_classes``
    cuts from a power-law matrix (its item popularity ~ (rank + 20)^-0.8,
    the benchmark data's law): each class's first and last chunk (the last
    with its sentinel rows), negatives drawn by popularity as the epoch
    draws them (``itemids[r]``), 5% of the valid entries skipped."""
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic
    from implicit_tpu_torch.models import bpr

    plays = generate_synthetic(30000, 6000, 900000, seed=seed)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    itemids = t(plays.indices.astype(np.int64))
    Y = t(rng.standard_normal((plays.shape[1], F), dtype=np.float32) * 0.1)
    yb = t(rng.standard_normal(plays.shape[1], dtype=np.float32) * 0.1)
    chunks = []
    for _, idx, dat, _ in bpr.grouped_classes(plays, cuda):
        for c in sorted({0, idx.shape[0] - 1}):
            C, L = idx.shape[1:]
            keep = (dat[c] != 0) & t(rng.random((C, L)) >= 0.05)
            chunks.append((t(rng.standard_normal((C, F), dtype=np.float32) * 0.1),
                           t(rng.random((C, L), dtype=np.float32)), idx[c],
                           itemids[t(rng.integers(0, plays.nnz, (C, L)))], keep))
    return Y, yb, chunks


@pytest.mark.parametrize("F", [128, 100, 130, 512])
def test_bpr_item_update_matches_plain(cuda, F):
    """One launch pair a call. Against the plain version's arithmetic summed
    in float64 (``bpr_update.bpr_item_update_reference``), every element within
    the float32 bound of its row's sum in any order (n + 4) 2^-24 (|row| +
    sum |terms|), as the four ``index_put_(accumulate=True)`` calls it
    replaces and the plain version are: a hot row sums hundreds of terms,
    so any two float32 orders of it differ by about 1e-6 of the table's
    scale (on an H100, kernel and plain version 9.5e-7 apart where 1e-6 of
    scale was 7.4e-7), while one term dropped moves an element by
    thousands of bounds. The rows no kept
    entry names keep their bits. F = 130: the kernel's float route; 512:
    four column slabs."""
    from test_torch_bpr_item_update import _four_scatters

    from implicit_tpu_torch.ops import bpr_update

    Y, yb, chunks = _bpr_item_chunks(cuda, F, seed=F)
    assert len(chunks) > 2
    for x, z, cidx, negids, keep in chunks:
        args = (x, z, cidx, negids, keep, 0.05, 0.04)
        before = bpr_update.LAUNCHES["bpr_item_update"]
        got = [Y.clone(), yb.clone()]
        bpr_update.bpr_item_update(*got, *args)
        torch.cuda.synchronize()
        assert bpr_update.LAUNCHES["bpr_item_update"] == before + 1
        plain, old = [Y.clone(), yb.clone()], [Y.clone(), yb.clone()]
        bpr_update.bpr_item_update_plain(*plain, *args)
        _four_scatters(*old, *args)
        ref = bpr_update.bpr_item_update_reference(Y, yb, *args)
        shares = [bpr_update.bound_share(t, ref) for t in (got, plain, old)]
        assert max(shares) <= 1, shares
        kept = torch.zeros(Y.shape[0], dtype=torch.bool, device=cuda)
        kept[torch.cat((cidx[keep], negids[keep]))] = True
        for g, start in zip(got, (Y, yb)):
            assert torch.equal(g[~kept].view(torch.int32), start[~kept].view(torch.int32))
            assert not torch.equal(g, start)


def test_bpr_item_update_repeats_bit_for_bit(cuda):
    """Two calls on the same inputs give the same bits (no atomics)."""
    from implicit_tpu_torch.ops import bpr_update

    Y, yb, chunks = _bpr_item_chunks(cuda, 128, seed=3)
    for chunk in chunks:
        runs = []
        for _ in range(2):
            out = [Y.clone(), yb.clone()]
            bpr_update.bpr_item_update(*out, *chunk, 0.01, 0.01)
            runs.append(out)
        for a, b in zip(*runs):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_grouped_fit_on_cuda_updates_items_through_the_kernel(cuda):
    """A grouped fit on the card: one ``launches.bpr_item_update`` a chunk
    update (``bpr.chunk_steps``), no ``bpr.scatter_calls``; a pool mode
    keeps its four scatters a chunk and launches nothing."""
    from implicit_tpu_torch import tracing
    from implicit_tpu_torch.bpr import BayesianPersonalizedRanking

    plays = _sgd_plays(seed=8)
    for mode in ("grouped", "grouped_pool"):
        before = tracing.counters()
        BayesianPersonalizedRanking(factors=64, iterations=3, random_state=3, epoch_mode=mode,
                                    device=cuda).fit(plays, show_progress=False)
        moved = {k: v - before[k] for k, v in tracing.counters().items()
                 if k in ("bpr.chunk_steps", "bpr.scatter_calls", "launches.bpr_item_update")}
        steps = moved["bpr.chunk_steps"]
        assert steps > 0
        if mode == "grouped":
            assert moved == {"bpr.chunk_steps": steps, "bpr.scatter_calls": 0,
                             "launches.bpr_item_update": steps}
        else:
            assert moved == {"bpr.chunk_steps": steps, "bpr.scatter_calls": 4 * steps,
                             "launches.bpr_item_update": 0}


def test_bpr_item_update_refuses_what_it_does_not_take(cuda):
    from implicit_tpu_torch.ops import bpr_update

    Y, yb, chunks = _bpr_item_chunks(cuda, 128, seed=4)
    x, z, cidx, negids, keep = chunks[0]
    with pytest.raises(ValueError):
        bpr_update.bpr_item_update(Y[:, ::2], yb, x[:, ::2], z, cidx, negids, keep, 0.01, 0.01)
    with pytest.raises(ValueError):
        bpr_update.bpr_item_update(Y, yb, x, z, cidx.cpu(), negids, keep, 0.01, 0.01)


def test_membership_lookup_on_cuda_matches_numpy(cuda):
    """The pair-table lookup on the card equals the host lookup bit for bit,
    on the stored pairs, random pairs and the largest ids."""
    from implicit_tpu_torch.ops import membership

    plays = _sgd_plays()
    for M in (plays, plays[:, :1024]):  # 16-bit slots; a second id space
        pt = membership.build_pair_table(M)
        rng = np.random.default_rng(9)
        qu = np.concatenate([np.repeat(np.arange(M.shape[0]), np.diff(M.indptr)),
                             rng.integers(0, M.shape[0], 50000), [M.shape[0] - 1]])
        qi = np.concatenate([M.indices, rng.integers(0, M.shape[1], 50000), [M.shape[1] - 1]])
        want = pt.member(qu, qi)
        got = membership._member(pt.to_device(cuda), torch.as_tensor(qu, device=cuda),
                                 torch.as_tensor(qi, device=cuda), *pt.bits)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        assert want[:M.nnz].all()


# -- the item-item family: torch ops and host C++, no kernel of its own ------


def _item_item_plays():
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    return generate_synthetic(3000, 800, 60000, seed=7)


def _bm25(plays):
    import scipy.sparse as sp

    from implicit_tpu_torch import nearest_neighbours as nn

    return sp.csr_matrix(nn.bm25_weight(plays.T, 1.2, 0.75).T)


def _same_csr(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("indptr", "indices", "data"))


@pytest.mark.parametrize("dense_bytes", [None, 1 << 16], ids=["one-chunk", "chunks"])
def test_knn_device_route_on_cuda_matches_cpu(cuda, monkeypatch, dense_bytes):
    """The device route on the card against the same route on the CPU and
    the host route: values within rtol 1e-5, neighbours equal up to exact
    ties at the K-th score; a second build gives the same bits."""
    from chip_smoke import knn_disagreement

    from implicit_tpu_torch import nearest_neighbours as nn

    if dense_bytes is not None:  # 82 users per chunk: 37 chunks
        monkeypatch.setattr(nn, "_DEVICE_KNN_DENSE_BYTES", dense_bytes)
    weighted = _bm25(_item_item_plays())
    got = nn.all_pairs_knn(weighted, 20, method="device", device=cuda).tocsr()
    assert _same_csr(got, nn.all_pairs_knn(weighted, 20, method="device", device=cuda).tocsr())
    for want in (nn.all_pairs_knn(weighted, 20, method="device", device="cpu"),
                 nn.all_pairs_knn(weighted, 20, method="host")):
        err, bad = knn_disagreement(got, want.tocsr(), 1e-5)
        assert err <= 1e-5 and not bad, (err, bad[:5])


def test_ease_on_cuda_matches_cpu(cuda):
    """cuSOLVER's float32 solve against the CPU's and the float64 closed
    form, at the JAX package's bar (atol 2e-4); the same bits twice; a
    matrix that is not positive definite raises on the card too."""
    from scipy.sparse import csr_matrix

    from implicit_tpu_torch import ease
    from implicit_tpu_torch.recommender_base import ModelFitError

    X = _item_item_plays()
    X.data[:] = 1.0
    got = ease.ease_weights(X, 250.0, device=cuda)
    assert torch.equal(got, ease.ease_weights(X, 250.0, device=cuda))
    got = got.cpu().numpy()
    np.testing.assert_allclose(got, ease.ease_weights(X, 250.0, device="cpu").numpy(), atol=2e-4)
    G = (X.T @ X).toarray() + 250.0 * np.eye(X.shape[1])
    P = np.linalg.inv(G)
    oracle = -P / np.diag(P)[None, :]
    np.fill_diagonal(oracle, 0.0)
    np.testing.assert_allclose(got, oracle, atol=2e-4)
    singular = X[:, :50].toarray()
    singular[:, 7] = 0.0
    with pytest.raises(ModelFitError, match="not positive definite"):
        ease.ease_weights(csr_matrix(singular), 0.0, device=cuda)


def _recommend_close(got, want, rel=1e-9):
    """Scores within ``rel`` of the batch's largest |score|; ids equal but
    at ties of the wanted scores (a row's last score may tie past N)."""
    (ids, scores), (wids, wscores) = got, want
    np.testing.assert_array_equal(ids >= 0, wids >= 0)
    tol = rel * np.abs(wscores[wids >= 0]).max()
    np.testing.assert_allclose(scores, wscores, rtol=0, atol=tol)
    for r, p in zip(*np.nonzero(ids != wids)):
        tied = np.abs(wscores[r][wids[r] >= 0] - wscores[r][p]) <= tol
        assert tied.sum() > 1 or tied[-1], (r, p)


@pytest.mark.parametrize("family", ["bm25", "ease"])
def test_item_item_recommend_on_cuda_matches_cpu(cuda, family):
    """The card's float64 score product and top-k against the same model's
    on the CPU, with liked items and filter_items dropped, and items=."""
    from implicit_tpu_torch.ease import EASERecommender
    from implicit_tpu_torch.nearest_neighbours import BM25Recommender

    plays = _item_item_plays()
    cpu = (BM25Recommender(K=20, device="cpu") if family == "bm25"
           else EASERecommender(K=100, device="cpu"))
    cpu.fit(plays, show_progress=False)
    card = type(cpu)(K=cpu.K, device=cuda)
    card.similarity = cpu.similarity
    users = np.arange(0, 3000, 7)
    for kwargs in ({}, {"filter_items": [0, 5, 11]}, {"filter_already_liked_items": False}):
        _recommend_close(card.recommend(users, plays[users], N=10, **kwargs),
                         cpu.recommend(users, plays[users], N=10, **kwargs))
    items = np.array([1, 40, 77, 300, 799])
    got = card.recommend(3, plays[3], items=items)
    want = cpu.recommend(3, plays[3], items=items)
    assert sorted(got[0]) == sorted(want[0]) == sorted(items)
    np.testing.assert_allclose(got[1][np.argsort(got[0])], want[1][np.argsort(want[0])],
                               rtol=1e-12)


@pytest.mark.parametrize("family", ["bm25-device", "ease"])
def test_item_item_fits_repeat_bit_for_bit_on_cuda(cuda, monkeypatch, family):
    from implicit_tpu_torch import nearest_neighbours as nn
    from implicit_tpu_torch.ease import EASERecommender

    monkeypatch.setattr(nn, "_device_knn_wins", lambda *args, **kwargs: True)
    plays = _item_item_plays()
    fits = []
    for _ in range(2):
        model = (nn.BM25Recommender(K=20, device=cuda) if family == "bm25-device"
                 else EASERecommender(K=100, device=cuda))
        model.fit(plays, show_progress=False)
        fits.append(model.similarity)
    assert _same_csr(*fits)


def test_device_method_never_runs_the_host_route_on_cuda(cuda, monkeypatch):
    from implicit_tpu_torch import native
    from implicit_tpu_torch import nearest_neighbours as nn

    def refuse(*args, **kwargs):
        raise AssertionError("the host route ran")

    monkeypatch.setattr(nn, "_all_pairs_knn_host", refuse)
    monkeypatch.setattr(native, "knn_all_pairs", refuse)
    plays = _item_item_plays()
    weighted = _bm25(plays)
    assert nn.all_pairs_knn(weighted, 10, method="device", device=cuda).nnz
    # a fit that the cost rule sends to the device
    monkeypatch.setattr(nn, "_device_knn_wins", lambda *args, **kwargs: True)
    nn.BM25Recommender(K=10, device=cuda).fit(plays, show_progress=False)
    # what the device route cannot take raises instead of running the host
    weighted.data[0] = -1.0
    with pytest.raises(ValueError, match="negative"):
        nn.all_pairs_knn(weighted, 10, method="device", device=cuda)


# -- serving beyond the resident table: streams, events, pinned buffers, IVF ----


def _serving_case(n_items, F, q, seed):
    from scipy.sparse import random as sparse_random

    rng = np.random.default_rng(seed)
    items = rng.standard_normal((n_items, F), dtype=np.float32)
    queries = rng.standard_normal((q, F), dtype=np.float32)
    liked = sparse_random(q, n_items, density=20 / n_items, random_state=rng, format="csr")
    fi = rng.choice(n_items, 50, replace=False)
    return items, queries, liked, fi


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_topk_streaming_many_blocks_on_cuda_matches_resident(cuda, dtype):
    """69 blocks through the two staging buffers and the copy stream, three
    query chunks per block, both filters and norms: the resident top-k's ids
    up to ties and its scores within 1e-6; the same on the CPU path. A
    staging buffer refilled before its product ran would show here."""
    from chip_smoke import topk_disagreement

    from implicit_tpu_torch.ops import topk

    items, queries, liked, fi = _serving_case(70_000, 32, 300, seed=1)
    items = items.astype(dtype)
    norms = np.linalg.norm(items.astype(np.float32), axis=1)
    kw = dict(item_norms=norms, filter_query_items=liked, filter_items=fi)
    got = topk.topk_streaming(items, queries, 10, block_rows=1024, q_chunk_rows=128,
                              device=cuda, **kw)
    table = torch.as_tensor(items.astype(np.float32), device=cuda)
    resident = topk.topk(table.to(torch.bfloat16) if dtype == np.float16 else table,
                         queries, 10, **kw)
    cpu = topk.topk_streaming(items, queries, 10, block_rows=1024, q_chunk_rows=128,
                              device="cpu", **kw)
    for want in (resident, cpu):
        err, bad = topk_disagreement(got, want, 1e-6)
        assert err <= 1e-6 and not bad, (err, bad[:5])
    assert not np.isin(got[0], fi).any()
    # the same call again: the same bits
    again = topk.topk_streaming(items, queries, 10, block_rows=1024, q_chunk_rows=128,
                                device=cuda, **kw)
    assert np.array_equal(got[0], again[0]) and np.array_equal(got[1], again[1])


def test_topk_futures_in_flight_on_cuda(cuda, monkeypatch):
    """Several topk_async futures in flight at once, each of 25 chunks
    (more than _MAX_IN_FLIGHT), read in another order than queued: each
    equals topk's bits in one chunk, and the CPU's within 1e-5."""
    from chip_smoke import topk_disagreement

    from implicit_tpu_torch.ops import topk

    items, queries, liked, fi = _serving_case(20_000, 64, 400, seed=2)
    table = torch.as_tensor(items, device=cuda)
    kws = [dict(filter_query_items=liked), dict(filter_items=fi), {},
           dict(item_norms=np.linalg.norm(items, axis=1))]
    want = [topk.topk(table, queries, 10, **kw) for kw in kws]
    monkeypatch.setattr(topk, "_score_budget_elements", lambda device: 16 * 20_000)
    futures = [topk.topk_async(table, queries, 10, **kw) for kw in kws]
    for future, w, kw in reversed(list(zip(futures, want, kws))):
        got = future.result()
        err, bad = topk_disagreement(got, w, 1e-6)
        assert err <= 1e-6 and not bad
        err, bad = topk_disagreement(got, topk.topk(torch.as_tensor(items), queries, 10, **kw),
                                     1e-5)
        assert err <= 1e-5 and not bad


def test_pipelined_serving_on_cuda_equals_per_batch_calls(cuda):
    """recommend_pipelined and similar_items_pipelined with 3 batches in
    flight: the per-batch calls' bits, on a model whose tables live on the
    card."""
    from implicit_tpu_torch.als import AlternatingLeastSquares

    plays = _item_item_plays()
    model = AlternatingLeastSquares(factors=48, iterations=2, random_state=3, device=cuda)
    model.fit(plays, show_progress=False)
    batches = [np.arange(s, s + 250) for s in range(0, 3000, 250)]
    got = list(model.recommend_pipelined(((b, plays[b]) for b in batches), N=10,
                                         max_in_flight=3))
    for b, (ids, scores) in zip(batches, got, strict=True):
        want = model.recommend(b, plays[b], N=10)
        assert np.array_equal(ids, want[0]) and np.array_equal(scores, want[1])
    items = [np.arange(s, s + 100) for s in range(0, 800, 100)]
    got = list(model.similar_items_pipelined(items, N=5, max_in_flight=3))
    for b, (ids, scores) in zip(items, got, strict=True):
        want = model.similar_items(b, N=5)
        assert np.array_equal(ids, want[0]) and np.array_equal(scores, want[1])


def test_kmeans_on_cuda_repeats_and_matches_cpu(cuda):
    """Two k-means builds on the card give the same bits (the fixed-order
    scatter); a card build of one small index has the CPU build's layout
    (the same assignment) and centroids within 1e-5."""
    from implicit_tpu_torch.ann.ivf import _IVFIndex, _kmeans_run

    rng = np.random.default_rng(4)
    centers = rng.standard_normal((16, 12)).astype(np.float32) * 3
    pts = (centers[rng.integers(0, 16, 4000)]
           + rng.standard_normal((4000, 12)).astype(np.float32) * 0.3).astype(np.float32)
    unit = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    rows = np.random.default_rng(5).choice(4000, 8, replace=False)
    X = torch.as_tensor(unit, device=cuda)
    C1, a1 = _kmeans_run(X, rows, 8, 10)
    C2, a2 = _kmeans_run(X, rows, 8, 10)
    assert torch.equal(C1, C2) and torch.equal(a1, a2)
    card = _IVFIndex(pts, 8, 10, 5, cuda).to_arrays("")
    cpu = _IVFIndex(pts, 8, 10, 5, torch.device("cpu")).to_arrays("")
    for key in cpu:
        if key == "centroids":
            np.testing.assert_allclose(card[key], cpu[key], rtol=0, atol=1e-5)
        else:
            assert np.array_equal(card[key], cpu[key]), key


def test_ivf_model_on_cuda_probe_all_is_exact(cuda):
    from chip_smoke import topk_disagreement

    from implicit_tpu_torch.approximate_als import TPUIVFAlternatingLeastSquares

    plays = _item_item_plays()
    model = TPUIVFAlternatingLeastSquares(factors=32, iterations=3, random_state=2,
                                          n_probe=10_000, device=cuda)
    model.fit(plays, show_progress=False)
    assert model.recommend_index.points.device.type == cuda.type
    users = np.arange(0, 3000, 37)
    err, bad = topk_disagreement(model.recommend(users, plays[users], N=10),
                                 model.model.recommend(users, plays[users], N=10), 1e-5,
                                 row_scale=True)
    assert err <= 1e-5 and not bad


def test_spans_time_a_fit_and_count_a_request_on_cuda(cuda):
    """Under a profiler, a fit on the card: each iteration span's device
    seconds come from its CUDA events, and it counts its kernel launches; a
    recommend asks for free memory three times (two table checks, the
    top-k's budget)."""
    from torch.profiler import ProfilerActivity, profile

    from implicit_tpu_torch import tracing
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(2000, 1000, 60000, seed=3)

    def fit():
        model = AlternatingLeastSquares(factors=64, iterations=3, random_state=1, device=cuda)
        model.fit(plays, show_progress=False)
        return model

    fit()  # the kernels built and loaded outside the profile
    tracing.clear()
    users = np.arange(64)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fit().recommend(users, plays[users], N=10)
    spans = tracing.spans()
    tracing.clear()
    root, = [s for s in spans if s["name"] == "fit"]
    iterations = [s for s in spans if s["name"] == "iteration"]
    assert len(iterations) == 3
    for it in iterations:
        # the fit's copy back waits for the card: every iteration ran inside it
        assert 0 < it["device_s"] < (root["end_ns"] - root["start_ns"]) / 1e9
        assert sum(n for k, n in it["counts"].items() if k.startswith("launches.")) > 0
    request, = [s for s in spans if s["name"] == "recommend"]
    assert request["counts"]["device.mem_queries"] == 3


# the starting-factor draw: csrc/pcg64_uniform.cu against numpy's own draw


# (1031, 1024): 527,872 pairs over the grid's 262,144 threads, so each thread
# steps by the grid's jump twice or three times
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,F,drawn", [(1, 1, 0), (37, 9, 0), (1031, 1024, 0), (1031, 1023, 0),
                                       (1, 1, 1), (37, 9, 3), (1031, 1024, 1)])
def test_pcg64_draw_is_numpys(cuda, n, F, drawn, storage):
    """The kernel's table is ``rng.random((n, F), dtype=np.float32) *
    np.float32(0.01)`` cast to the storage dtype, bit for bit (from a kept
    half where ``drawn`` is odd), and the generator is left where numpy's
    draw leaves it."""
    from implicit_tpu_torch import tracing
    from implicit_tpu_torch.ops import pcg64

    rng, ref = np.random.default_rng(2**62 + 11), np.random.default_rng(2**62 + 11)
    rng.random(drawn, dtype=np.float32)
    ref.random(drawn, dtype=np.float32)
    before = tracing.counters()["init.device_draws"]
    got = pcg64.uniform_factors(rng, (n, F), storage, cuda)
    torch.cuda.synchronize()
    assert tracing.counters()["init.device_draws"] == before + 1
    want = torch.from_numpy(ref.random((n, F), dtype=np.float32) * np.float32(0.01))
    want = want.to(storage).float()
    assert got.dtype == torch.float32 and got.shape == (n, F)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert rng.bit_generator.state == ref.bit_generator.state


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
def test_fit_on_cuda_starts_from_the_cpu_fits_draw(cuda, dtype):
    """An ``iterations=0`` fit on the card draws both tables there and ends
    with the CPU fit's factors, bit for bit; the caller's generator reads on
    as after the CPU fit."""
    from implicit_tpu_torch import tracing
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(3001, 707, 20000, seed=4)  # n F odd on both sides
    fits, next_draws = {}, {}
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(9)
        before = tracing.counters()
        model = AlternatingLeastSquares(factors=33, iterations=0, random_state=rng, dtype=dtype,
                                        device=dev)
        model.fit(plays, show_progress=False)
        moved = {k: tracing.counters()[k] - before[k]
                 for k in ("init.device_draws", "init.host_draws")}
        on_card = dev == cuda
        assert moved == {"init.device_draws": 2 * on_card, "init.host_draws": 2 * (not on_card)}
        fits[str(dev)] = (model.user_factors, model.item_factors)
        next_draws[str(dev)] = rng.random(5)
    for a, b in zip(fits["cuda"], fits["cpu"]):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(next_draws["cuda"], next_draws["cpu"])


def test_fit_on_cuda_from_another_stream_takes_numpys_draw(cuda):
    """A ``Generator`` over MT19937 is drawn by numpy on the host and
    uploaded: the same tables as on the CPU, two host draws counted."""
    from implicit_tpu_torch import tracing
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(500, 300, 6000, seed=4)
    fits = {}
    for dev in ("cpu", cuda):
        before = tracing.counters()
        model = AlternatingLeastSquares(factors=16, iterations=0, device=dev,
                                        random_state=np.random.Generator(np.random.MT19937(5)))
        model.fit(plays, show_progress=False)
        assert tracing.counters()["init.host_draws"] == before["init.host_draws"] + 2
        assert tracing.counters()["init.device_draws"] == before["init.device_draws"]
        fits[str(dev)] = (model.user_factors, model.item_factors)
    for a, b in zip(fits["cuda"], fits["cpu"]):
        np.testing.assert_array_equal(a, b)


def test_profiled_fit_on_cuda_draws_in_its_factor_draw_steps(cuda):
    """Under a profiler, a fit on the card has one ``factor draw`` step per
    table and no ``factor init``; its ``fit`` span counts two device draws
    and holds its set-up steps, the iteration and the copy back in order."""
    from torch.profiler import ProfilerActivity, profile

    from implicit_tpu_torch import tracing
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(2000, 1000, 60000, seed=3)

    def fit():
        AlternatingLeastSquares(factors=64, iterations=1, random_state=1, device=cuda).fit(
            plays, show_progress=False)

    fit()  # the kernels built and loaded outside the profile
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fit()
    spans = tracing.spans()
    tracing.clear()
    root, = [s for s in spans if s["name"] == "fit"]
    steps = [s for s in spans if s["attrs"].get("stage") == "fit set-up"]
    names = [s["name"] for s in steps]
    assert names.count("factor draw") == 2 and "factor init" not in names
    assert all(s["device_s"] is not None for s in steps if s["name"] == "factor draw")
    assert root["counts"]["init.device_draws"] == 2 and "init.host_draws" not in root["counts"]
    assert [s["name"] for s in spans if s["parent"] == root["id"]] == [
        "prepare", "upload", "transpose", "plan user side", "plan item side", "pack user side",
        "pack item side", "factor draw", "factor draw", "iteration", "copy back"]


# the copy back: _device.to_host's pinned ring against the plain .cpu()


def _copy_routes():
    from implicit_tpu_torch import tracing

    c = tracing.counters()
    return c["copy_back.staged_bytes"], c["copy_back.plain_bytes"]


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    as_int = {2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize]
    np.testing.assert_array_equal(a.view(as_int), b.view(as_int))


# a table's size in slots: 0 rows, below two slots (the plain route), exactly
# two, and ragged row counts that wrap the ring more than once
@pytest.mark.parametrize("slots", [0, 1.5, 2, 2.375, 9.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.float64],
                         ids=["f32", "f16", "f64"])
def test_staged_copy_is_the_plain_copys(cuda, dtype, slots):
    """``to_host`` of a table that the card is still writing gives ``.cpu()``'s
    bits, NaN and infinities included; it stages a table of two slots' bytes
    or more and counts its bytes by route."""
    from implicit_tpu_torch import _device

    F = 128
    row = F * torch.empty(0, dtype=dtype).element_size()
    n = int(slots * _device.SLOT_BYTES) // row + (7 if slots not in (0, 2) else 0)
    T = torch.randn(n, F, device=cuda).to(dtype)
    T.view(-1)[::997] = float("nan")
    T.view(-1)[5::1009] = float("inf")
    torch.cuda._sleep(50_000_000)  # the last write lands after the call queues its copies
    T.mul_(3)
    before = _copy_routes()
    got, = _device.to_host([T])
    moved = tuple(a - b for a, b in zip(_copy_routes(), before))
    _same_bits(got, T.cpu().numpy())
    nbytes = n * row
    staged = nbytes >= 2 * _device.SLOT_BYTES
    assert moved == ((nbytes, 0) if staged else (0, nbytes))
    assert staged == (slots >= 2)


@pytest.mark.parametrize("mesh", [None, 2], ids=["single", "mesh2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_fit_copies_back_staged(cuda, monkeypatch, dtype, mesh):
    """A fit on the card, single or on a 2-shard virtual mesh, stages both
    tables: the model's factors are the plain copy of the fitted (gathered)
    tables, bit for bit."""
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic
    from implicit_tpu_torch.models import als as als_model
    from implicit_tpu_torch.parallel import virtual_mesh

    plays = generate_synthetic(40000, 36000, 400000, seed=5)
    kept = []
    copy_back = als_model.AlternatingLeastSquares._copy_back

    def keep(self, *args, **kwargs):
        X, Y = copy_back(self, *args, **kwargs)
        kept.append([T.to(torch.from_numpy(np.empty(0, dtype)).dtype).cpu().numpy()
                     for T in (X, Y)])
        return X, Y

    monkeypatch.setattr(als_model.AlternatingLeastSquares, "_copy_back", keep)
    before = _copy_routes()
    model = AlternatingLeastSquares(factors=256, iterations=1, random_state=2, dtype=dtype,
                                    device=cuda,
                                    mesh=None if mesh is None else virtual_mesh(mesh, cuda))
    model.fit(plays, show_progress=False)
    moved = tuple(a - b for a, b in zip(_copy_routes(), before))
    assert moved == (model.user_factors.nbytes + model.item_factors.nbytes, 0)
    (X, Y), = kept
    _same_bits(model.user_factors, X)
    _same_bits(model.item_factors, Y)


def test_two_threads_copy_back_at_once(cuda):
    """Two threads staging tables from one card at once, again and again:
    each gets its own tables' bits."""
    import threading

    from implicit_tpu_torch import _device

    rows = _device.SLOT_BYTES // (128 * 4)
    tables = [[torch.randn(int(rows * f), 128, device=cuda) for f in fs]
              for fs in ((2.5, 3.3), (4.1, 2.0))]
    want = [[t.cpu().numpy() for t in ts] for ts in tables]
    errors, rounds = [], []

    def work(k):
        try:
            for _ in range(8):
                for got, w in zip(_device.to_host(tables[k]), want[k]):
                    _same_bits(got, w)
                rounds.append(k)
        except Exception as err:  # reported below, in the test's thread
            errors.append(err)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(rounds) == [0] * 8 + [1] * 8


def test_ring_stays_within_its_bytes_across_fits(cuda):
    """Twenty fits on one card reuse one ring: the same pinned buffer, at
    most 128 MB, and the pinned allocator holds no more after them (where
    torch keeps its statistics: ``host_memory_stats`` is empty in some
    builds, and both readings are then None)."""
    from implicit_tpu_torch import _device
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(40000, 36000, 200000, seed=6)

    def fit(i):
        model = AlternatingLeastSquares(factors=128, iterations=1, random_state=i, device=cuda)
        model.fit(plays, show_progress=False)
        return model

    fit(0)
    device = _device.resolve_device(cuda)
    ring = _device._rings[device]
    pointer = ring.pinned.data_ptr()
    pinned = torch.cuda.host_memory_stats().get("allocated_bytes.current")
    before = _copy_routes()
    for i in range(1, 21):
        fit(i)
    assert _device._rings[device] is ring and ring.pinned.data_ptr() == pointer
    assert ring.pinned.numel() == _device.SLOTS * _device.SLOT_BYTES <= 128 * 10**6
    assert torch.cuda.host_memory_stats().get("allocated_bytes.current") == pinned
    staged = _copy_routes()[0] - before[0]
    assert staged == 20 * (40000 + 36000) * 128 * 4
