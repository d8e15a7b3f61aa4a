"""The port's compat surface: the reference's ``implicit.cpu.*`` /
``implicit.gpu.*`` layout, the device probe and the packaging.

``tests/test_compat_modules.py``'s five cases run here against
``implicit_tpu_torch`` on the CPU, beside cases that feed the same numpy
inputs to the JAX package's aliases and the port's: ``cpu.topk.topk`` (ids
exact, scores within 1e-6 relative) and the module-level ALS solvers (the
host-numpy ones bit for bit, ``calculate_loss`` within 1e-5 relative).
"""

import importlib
import os
import tomllib

import numpy as np
import pytest
import torch
from chip_smoke import ALIASES  # (alias module, name, module of the port's own object)
from scipy.sparse import csr_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(name):
    return importlib.import_module("implicit_tpu_torch." + name)


@pytest.mark.parametrize("alias,name,home", ALIASES,
                         ids=[f"{a}.{n}" for a, n, _ in ALIASES])
def test_cpu_gpu_submodules_are_unified_classes(alias, name, home):
    assert getattr(_port(alias), name) is getattr(_port(home), name)


def test_gpu_flags():
    import implicit_tpu_torch
    import implicit_tpu_torch.gpu as gpu

    # the reference's meaning: live CUDA availability, read on each access
    assert gpu.HAS_CUDA == torch.cuda.is_available()
    assert gpu.HAS_TPU is False
    assert implicit_tpu_torch.gpu is gpu and implicit_tpu_torch.cpu is _port("cpu")
    assert {"cpu", "gpu"} <= set(implicit_tpu_torch.__all__)


def test_cpu_topk_alias_matches_reference_signature():
    """implicit.cpu.topk.topk's calling convention works through the alias,
    a numpy table scored on ``device=``."""
    from implicit_tpu_torch.cpu.topk import topk

    rng = np.random.default_rng(0)
    items = rng.standard_normal((50, 8), dtype=np.float32)
    query = rng.standard_normal((4, 8), dtype=np.float32)
    filter_query_items = csr_matrix(
        (np.ones(2, np.float32), ([0, 1], [3, 7])), shape=(4, 50))
    ids, scores = topk(items, query, 5,
                       filter_query_items=filter_query_items,
                       filter_items=np.array([11, 12]), device="cpu")
    assert ids.shape == (4, 5) and scores.shape == (4, 5)
    assert 3 not in ids[0] and 7 not in ids[1]
    assert not np.isin(ids, [11, 12]).any()
    # agreement with a dense argsort oracle on the unfiltered query rows
    expected = np.argsort(-(query[2] @ items.T))
    expected = expected[~np.isin(expected, [11, 12])][:5]
    assert set(ids[2]) == set(expected)


def test_factory_consumes_gpu_flag():
    """The reference's own factory idiom, use_gpu=implicit.gpu.HAS_CUDA,
    runs end to end against the alias flag."""
    import implicit_tpu_torch.gpu as gpu
    from implicit_tpu_torch.als import AlternatingLeastSquares

    rng = np.random.default_rng(1)
    ui = csr_matrix((rng.random(60) + 0.5,
                     (rng.integers(0, 12, 60), rng.integers(0, 9, 60))),
                    shape=(12, 9))
    model = AlternatingLeastSquares(factors=4, iterations=2, use_gpu=gpu.HAS_CUDA,
                                    random_state=0, device="cpu")
    model.fit(ui, show_progress=False)
    ids, _ = model.recommend(0, ui[0], N=3)
    assert len(ids) == 3


def _solver_inputs():
    rng = np.random.default_rng(3)
    Cui = csr_matrix((rng.random(80).astype(np.float32) * 3 + 1,
                      (rng.integers(0, 20, 80), rng.integers(0, 15, 80))),
                     shape=(20, 15))
    Cui.sum_duplicates()
    X = rng.standard_normal((20, 6)).astype(np.float64) * 0.01
    Y = rng.standard_normal((15, 6)).astype(np.float64) * 0.01
    return Cui, X, Y


def test_cpu_als_solver_function_aliases():
    """The module-level solvers of implicit.cpu.als and implicit.cpu._als
    resolve to working callables."""
    import implicit_tpu_torch.cpu._als as _als
    import implicit_tpu_torch.cpu.als as cpu_als

    Cui, X, Y = _solver_inputs()
    for mod in (cpu_als, _als):
        Xs, Ys = X.copy(), Y.copy()
        mod.least_squares(Cui, Xs, Ys.copy(), 0.1)
        assert np.isfinite(Xs).all() and not np.allclose(Xs, X)
        Xc = X.copy()
        mod.least_squares_cg(Cui, Xc, Y.copy(), 0.1, cg_steps=3)
        assert np.isfinite(Xc).all()
        loss = mod.calculate_loss(Cui, X, Y, 0.1, device="cpu")
        assert np.isfinite(loss) and loss > 0

    # per-row surface only on cpu.als (matching the reference layout)
    A, b = cpu_als.user_linear_equation(Y, Y.T @ Y, Cui, 0, 0.1, 6)
    x = cpu_als.user_factor(Y, Y.T @ Y, Cui, 0, 0.1, 6)
    assert np.allclose(A @ x, b, atol=1e-8)
    xi = cpu_als.item_factor(X, X.T @ X, Cui, 1, 0.1, 6)
    assert np.isfinite(xi).all()


# -- against the JAX package's aliases, on the same numpy inputs ---------------

TOPK_CASES = {
    "plain": {},
    "filters": {"filter_query_items": True, "filter_items": np.array([2, 11, 12, 90])},
    "norms": {"item_norms": True},
    "k_beyond_items": {"k": 70},
    "one_query": {"one_query": True},
    "float64_table": {"table_dtype": np.float64},
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_cpu_topk_matches_jax_alias(case):
    from implicit_tpu.cpu.topk import topk as jax_topk

    from implicit_tpu_torch.cpu.topk import topk

    spec = TOPK_CASES[case]
    rng = np.random.default_rng(11)
    items = rng.standard_normal((60, 16)).astype(spec.get("table_dtype", np.float32))
    query = rng.standard_normal((9, 16), dtype=np.float32)
    if spec.get("one_query"):
        query = query[0]
    kwargs = {}
    if spec.get("filter_query_items"):
        rows = np.repeat(np.arange(9), 3)
        cols = rng.integers(0, 60, 27)
        kwargs["filter_query_items"] = csr_matrix(
            (np.ones(27, np.float32), (rows, cols)), shape=(9, 60))
    if "filter_items" in spec:
        kwargs["filter_items"] = spec["filter_items"]
    if spec.get("item_norms"):
        kwargs["item_norms"] = np.linalg.norm(items, axis=1).astype(np.float32)
    k = spec.get("k", 7)

    want_ids, want_scores = jax_topk(items, query, k, **kwargs)
    got_ids, got_scores = topk(items, query, k, device="cpu", **kwargs)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-6)


SOLVERS = [("als", "least_squares"), ("als", "least_squares_cg"),
           ("als", "user_linear_equation"), ("als", "user_factor"), ("als", "item_factor"),
           ("als", "calculate_loss"), ("_als", "least_squares"),
           ("_als", "least_squares_cg"), ("_als", "calculate_loss")]


@pytest.mark.parametrize("module,solver", SOLVERS, ids=[f"{m}.{s}" for m, s in SOLVERS])
def test_solver_alias_matches_jax(module, solver):
    jax_mod = importlib.import_module("implicit_tpu.cpu." + module)
    port_mod = _port("cpu." + module)
    Cui, X, Y = _solver_inputs()

    def run(mod):
        fn = getattr(mod, solver)
        Xc, Yc = X.copy(), Y.copy()
        if solver in ("least_squares", "least_squares_cg"):
            fn(Cui, Xc, Yc, 0.1)
            return (Xc,)
        if solver == "calculate_loss":
            extra = {"device": "cpu"} if mod is port_mod else {}
            return (float(fn(Cui, Xc, Yc, 0.1, **extra)),)
        if solver == "item_factor":
            CiuT = Cui.T.tocsr()
            return (fn(Xc, Xc.T @ Xc, CiuT, 2, 0.1, 6),)
        out = fn(Yc, Yc.T @ Yc, Cui, 3, 0.1, 6)
        return out if isinstance(out, tuple) else (out,)

    want, got = run(jax_mod), run(port_mod)
    for g, w in zip(got, want):
        if solver == "calculate_loss":
            assert g == pytest.approx(w, rel=1e-5)
        else:  # the same numpy code in both packages
            np.testing.assert_array_equal(g, w)


# -- the device probe, the BLAS check and the factories -------------------------


def test_tpu_module():
    from implicit_tpu_torch import tpu

    assert tpu.HAS_TPU is False
    assert tpu.device_count() == torch.cuda.device_count()


def test_check_blas_config_runs():
    from implicit_tpu_torch.utils import check_blas_config

    # idempotent and must not raise regardless of the BLAS environment
    check_blas_config()
    check_blas_config()


@pytest.mark.parametrize("factory", ["als.AlternatingLeastSquares",
                                     "bpr.BayesianPersonalizedRanking",
                                     "lmf.LogisticMatrixFactorization"])
def test_factories_ignore_use_gpu(factory):
    """use_gpu is accepted and ignored: device= alone picks the device, and
    use_gpu=False does not mean the CPU."""
    module, name = factory.split(".")
    make = getattr(_port(module), name)
    for use_gpu in (None, False, True):
        assert make(use_gpu=use_gpu, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert make(use_gpu=False).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make(use_gpu=False)


def test_pyproject_lists_every_port_package():
    """Every directory of implicit_tpu_torch holding an __init__.py is a
    package of the distribution, so an installed wheel imports."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        listed = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    found = set()
    for dirpath, dirnames, names in os.walk(os.path.join(ROOT, "implicit_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        if "__init__.py" in names:
            found.add(os.path.relpath(dirpath, ROOT).replace(os.sep, "."))
    assert {"implicit_tpu_torch", "implicit_tpu_torch.ann", "implicit_tpu_torch.cpu",
            "implicit_tpu_torch.gpu"} <= found
    assert sorted(found - listed) == []
