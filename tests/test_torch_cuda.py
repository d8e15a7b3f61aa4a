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
def test_gramian_f32_is_not_tf32(cuda, C, L):
    # single-pass TF32 would pass the 1e-4 bar; the float32 build (3xTF32)
    # must land at least 10x closer to the float32 plain version than the
    # plain version computed in TF32 does
    Y, idx, dat, x0, yty = _case(C, L, 128, seed=C, device=cuda, dtype=torch.float32,
                                 n_table=20000)
    got = cg_kernels.gramian_cg_solve(Y, idx, dat, x0, yty, cg_steps=3)
    want = cg_kernels.gramian_cg_solve_plain(Y, idx, dat, x0, yty, cg_steps=3)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = cg_kernels.gramian_cg_solve_plain(Y, idx, dat, x0, yty, cg_steps=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
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


@pytest.mark.parametrize("alpha,beta", [(1.0, -1.0), (0.0, 1.0)])
@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
@pytest.mark.parametrize("F", [8, 32, 100, 128, 256])
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
