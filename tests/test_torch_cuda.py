"""The CUDA solve kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs where JAX is not installed; there, skip the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: kernel and plain version read the same inputs and accumulate in
float32 in different orders; rtol = atol = 2e-3 is the JAX package's bar
for its kernels, and float32 is held to 1e-4.
"""

import numpy as np
import pytest
import torch

from implicit_tpu_torch.ops import cg_kernels

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("F", [8, 32, 64, 100, 128, 200, 256])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_plain(cuda, name, F, dtype):
    kernel, plain = KERNELS[name]
    C, L = (37, 80) if name == "cg_full" else (13, 300)
    args = _case(C, L, F, seed=F, device=cuda, dtype=dtype)
    before = cg_kernels.LAUNCHES[name]
    got = kernel(*args, cg_steps=3)
    torch.cuda.synchronize()
    assert cg_kernels.LAUNCHES[name] == before + 1
    want = plain(*args, cg_steps=3)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
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
