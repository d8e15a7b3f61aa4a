"""The port's ALS model: the shared contract suite, quality gates, and
weights carried across from the JAX package.

The behavioural contract of ``tests/test_models_common.py`` runs here with
the port's factories (``device="cpu"``), through this module's own
``model_factory`` fixture; the three ``*_pipelined`` tests are left out
(pipelined serving is not ported yet).
"""

import ast
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import test_models_common
import torch
from conftest import get_checkerboard
from scipy.sparse import csr_matrix
from test_models_common import (  # noqa: F401  (collected here with the port's factories)
    test_dtype,
    test_evaluation,
    test_fit_callback,
    test_fit_non_csr_matrix,
    test_fit_ordering,
    test_invalid_user_items,
    test_pickle,
    test_pickle_unfitted_model,
    test_rank_items,
    test_rank_items_batch,
    test_recalculate_user,
    test_recommend,
    test_recommend_batch,
    test_serialization,
    test_serialization_without_fit,
    test_similar_items,
    test_similar_items_batch,
    test_similar_items_filter,
    test_similar_users,
    test_similar_users_batch,
    test_similar_users_filter,
    test_zero_length_row,
)

from implicit_tpu_torch import convert
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.datasets.synthetic import generate_synthetic
from implicit_tpu_torch.evaluation import precision_at_k, train_test_split
from implicit_tpu_torch.models.als import AlternatingLeastSquares as ALSModel
from implicit_tpu_torch.utils import ParameterWarning

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_als():
    return AlternatingLeastSquares(factors=32, regularization=0, random_state=23, device="cpu")


def make_als_cholesky():
    return AlternatingLeastSquares(factors=32, regularization=0, use_cg=False,
                                   random_state=23, device="cpu")


def make_als_f16():
    return AlternatingLeastSquares(factors=32, regularization=0, dtype=np.float16,
                                   random_state=23, device="cpu")


PORT_FACTORIES = {"als": make_als, "als_cholesky": make_als_cholesky, "als_f16": make_als_f16}


@pytest.fixture(params=sorted(PORT_FACTORIES))
def model_factory(request):
    return PORT_FACTORIES[request.param]


@pytest.fixture(autouse=True)
def _port_parameter_warning(monkeypatch):
    # the contract tests expect the warning class of the package under test
    monkeypatch.setattr(test_models_common, "ParameterWarning", ParameterWarning)


# -- quality gates -------------------------------------------------------------


def test_checkerboard_precision_at_1():
    user_items = get_checkerboard(50)
    model = make_als()
    model.fit(user_items, show_progress=False)
    p = precision_at_k(model, user_items, csr_matrix(np.eye(50)), K=1, show_progress=False)
    assert p == 1


def test_stdlib_corpus_precision_gate():
    # the JAX package's real-data gate (bench.py:bench_quality_real)
    with np.load(os.path.join(ROOT, "implicit_tpu", "datasets", "_data",
                              "stdlib_corpus.npz"), allow_pickle=False) as f:
        counts = csr_matrix((f["data"], f["indices"], f["indptr"]), shape=tuple(f["shape"]))
    train, test = train_test_split(counts, train_percentage=0.8, random_state=42)
    model = AlternatingLeastSquares(factors=64, regularization=0.05, random_state=3,
                                    device="cpu")
    model.fit(train, show_progress=False)
    assert precision_at_k(model, train, test, K=10, show_progress=False) > 0.2


# -- weights carried across from the JAX package -------------------------------


def _jax_model(dtype=np.float32):
    from implicit_tpu.models.als import AlternatingLeastSquares as JaxALS

    plays = generate_synthetic(300, 200, 6000, seed=4)
    model = JaxALS(factors=16, iterations=3, random_state=5, dtype=dtype)
    model.fit(plays, show_progress=False)
    return model, plays


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_load_jax_saved_npz(dtype):
    jmodel, plays = _jax_model(dtype)
    buf = io.BytesIO()
    jmodel.save(buf)
    buf.seek(0)
    model = ALSModel.load(buf, device="cpu")
    assert model.device == torch.device("cpu") and model.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(model.item_factors, jmodel.item_factors)
    users = np.arange(0, 300, 7)
    got = model.recommend(users, plays[users], N=10)
    want = jmodel.recommend(users, plays[users], N=10)
    np.testing.assert_array_equal(got[0], want[0])
    tol = 1e-5 if dtype == np.float32 else 2e-2  # 16-bit: bf16 serving GEMMs
    np.testing.assert_allclose(got[1], want[1], rtol=tol, atol=tol)
    got = model.similar_items(np.arange(20), N=5)
    want = jmodel.similar_items(np.arange(20), N=5)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])


def test_load_reference_shaped_npz():
    # the reference's own ALS checkpoint layout (no random_state key),
    # as tests/test_reference_npz_compat.py writes it for the JAX package
    from test_reference_npz_compat import _reference_als_npz

    model = ALSModel.load(_reference_als_npz(), device="cpu")
    assert model.factors == 8 and model.dtype == np.float32
    ids, scores = model.recommend(np.arange(5), csr_matrix((5, 20), dtype=np.float32), N=4)
    assert ids.shape == (5, 4) and np.isfinite(scores).all()
    assert set(model.save_params()) >= {"user_factors", "item_factors", "factors",
                                        "regularization", "cg_steps", "dtype", "alpha"}


def test_convert_round_trip_and_back_to_jax():
    from implicit_tpu.models.als import AlternatingLeastSquares as JaxALS

    jmodel, plays = _jax_model()
    params = {k: getattr(jmodel, k) for k in convert.PARAM_KEYS}
    model = convert.als_from_numpy(params, device="cpu")
    assert convert.numpy_params(model).keys() == {
        k for k, v in params.items() if v is not None}
    users = np.arange(40)
    np.testing.assert_array_equal(model.recommend(users, plays[users])[0],
                                  jmodel.recommend(users, plays[users])[0])
    # the port's save loads back into the JAX package
    buf = io.BytesIO()
    model.save(buf)
    buf.seek(0)
    back = JaxALS.load(buf)
    np.testing.assert_array_equal(back.user_factors, jmodel.user_factors)
    assert back.regularization == jmodel.regularization
    # explain reads the same host factors in both packages
    got = model.explain(3, plays, itemid=7)
    want = jmodel.explain(3, plays, itemid=7)
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    assert [i for i, _ in got[1]] == [i for i, _ in want[1]]


def test_fit_matches_jax_model():
    # same seed -> same numpy initial factors; the JAX model off-TPU solves
    # with its composed CG, the port with its kernels' plain versions: the
    # same steps, float32 summation order apart (see test_torch_als.py)
    from implicit_tpu.models.als import AlternatingLeastSquares as JaxALS

    plays = generate_synthetic(400, 300, 12000, seed=6)
    jmodel = JaxALS(factors=16, iterations=3, random_state=7)
    jmodel.fit(plays, show_progress=False)
    model = AlternatingLeastSquares(factors=16, iterations=3, random_state=7, device="cpu")
    model.fit(plays, show_progress=False)
    for got, want in ((model.user_factors, jmodel.user_factors),
                      (model.item_factors, jmodel.item_factors)):
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


# -- device handling and unported options --------------------------------------


def test_cuda_without_a_card_raises(monkeypatch):
    buf = io.BytesIO()
    make_als().save(buf)
    buf.seek(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        AlternatingLeastSquares()
    with pytest.raises(RuntimeError, match="cuda"):
        ALSModel.load(buf)  # on the class, load builds on "cuda" by default


@pytest.mark.parametrize("kwargs,error", [
    (dict(device="meta"), ValueError),
    (dict(gather_quant=True), NotImplementedError),
    (dict(mesh=2), NotImplementedError),
    (dict(grid="coarse"), ValueError),
    (dict(ingest="remote"), ValueError),
])
def test_unsupported_arguments_raise(kwargs, error):
    with pytest.raises(error):
        AlternatingLeastSquares(**{"device": "cpu", **kwargs})


def test_accepted_parity_arguments():
    model = AlternatingLeastSquares(factors=8, iterations=1, gather_quant="auto",
                                    ingest="device", grid="fine", device="cpu")
    model.fit(get_checkerboard(20), show_progress=False)
    assert model.user_factors.shape == (20, 8)


def test_pickle_drops_device_tables():
    model = make_als()
    user_items = get_checkerboard(20)
    model.fit(user_items, show_progress=False)
    model.recommend(0, user_items[0])
    assert isinstance(model._item_factors_dev, torch.Tensor)
    state = model.__getstate__()
    assert state["_item_factors_dev"] is None and state["_user_factors_dev"] is None
    reloaded = pickle.loads(pickle.dumps(model))
    np.testing.assert_array_equal(reloaded.recommend(0, user_items[0])[0],
                                  model.recommend(0, user_items[0])[0])


def test_float64_model_close_to_float32():
    plays = generate_synthetic(300, 200, 6000, seed=8)
    out = {}
    for dtype in (np.float32, np.float64):
        model = AlternatingLeastSquares(factors=16, iterations=3, random_state=1,
                                        dtype=dtype, device="cpu")
        model.fit(plays, show_progress=False)
        assert model.user_factors.dtype == dtype
        out[dtype] = model.item_factors
    scale = np.abs(out[np.float64]).max()
    assert np.abs(out[np.float32] - out[np.float64]).max() <= 2e-3 * scale


def test_partial_fit_grows_and_loss_callback():
    plays = generate_synthetic(100, 80, 1500, seed=9)
    losses = []
    model = AlternatingLeastSquares(factors=8, iterations=2, random_state=2,
                                    calculate_training_loss=True, device="cpu")
    model.fit(plays, show_progress=False, callback=lambda it, t, loss: losses.append(loss))
    assert len(losses) == 2 and all(np.isfinite(losses))
    model.partial_fit_users([3, 120], plays[[3, 4]])
    assert model.user_factors.shape == (121, 8)
    np.testing.assert_allclose(model.user_factors[120], model.recalculate_user(0, plays[4]),
                               rtol=1e-5, atol=1e-6)
    model.partial_fit_items([90], plays.T.tocsr()[[5]])
    assert model.item_factors.shape == (91, 8)


# -- the port stands alone ------------------------------------------------------


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "implicit_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "implicit_tpu"), (path, mod)


def test_port_imports_without_jax():
    code = (
        "import sys, implicit_tpu_torch, implicit_tpu_torch.convert, "
        "implicit_tpu_torch.evaluation, implicit_tpu_torch.ops.cg_kernels, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'implicit_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
