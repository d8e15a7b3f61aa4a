"""The port's EASE fit against the benchmark's plain EASE reference.

``cfbench/reference/ease.py`` is the plain reference that decides
``correct`` in the benchmark's EASE cell: the paper's closed form in
float32 with TF32 off, its inverse an LU one. Here, on the CPU at small
sizes (300-500 users x 64-128 items, lambda 1 and 250, binarized and
weighted), ``EASERecommender.fit`` is followed through the reference's
recorder, as the cell's checked fit is, and judged: its dense B (the
``_ease_solve`` hook's return) and its stored similarity. The judge must
reject a faulty fit. Both are plain torch; nothing of JAX runs.

Tolerances, each with its reason:

- the dense B and the stored values agree to TOL = 1e-5 of max |B_ref|
  (Frobenius and entrywise), as do the stored rows' K-th values: both
  solve a small, well conditioned system in float32 (a Cholesky inverse
  against an LU one), which leaves them about 1e-6 apart; the TF32 control
  reads about 3e-4 here and must fail;
- the stored rows are exact: their counts, their own item first and their
  ids (``count_gap``, ``diag_gap``, ``bad_ids`` 0);
- each fault reads above TOL and above the cell's limit
  (``cfbench/limits/ease_ml20m_k100.fit.json``) of the number that should
  catch it: the weights solved with lambda off by 10% and from a gramian
  missing its last user chunk (``weights_rel_fro``), and a similarity
  without its diagonal (``diag_gap``).
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

from cfbench.lib import trace
from cfbench.reference import ease as ref
from implicit_tpu_torch import nearest_neighbours as nn
from implicit_tpu_torch.ease import EASERecommender

torch.set_num_threads(2)

CPU = torch.device("cpu")
HOOK = "implicit_tpu_torch.ease:_ease_solve"
LIMITS = json.load(open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                     "cfbench", "limits", "ease_ml20m_k100.fit.json")))["limits"]
TOL = 1e-5
GAPS = ("weights_rel_fro", "weights_max_gap", "value_gap", "rank_gap")
EXACT = ("count_gap", "diag_gap", "bad_ids")
SHAPES = [(300, 64, 0.1, 20), (500, 128, 0.05, 100)]


def _matrix(users, items, p, seed):
    """Counts 1-5 at density ``p``, one item left without entries (its B
    row and column are zero, its stored row its own item alone)."""
    rng = np.random.default_rng(seed)
    X = (rng.random((users, items)) < p) * rng.integers(1, 6, (users, items))
    X[:, items // 2] = 0
    return csr_matrix(X.astype(np.float32))


def _fit(X, params, fit_params=None):
    """A fit followed through the reference's recorder, as the cell's
    checked fit is; returns its answers."""
    recorder = ref.fit_recorder(params)
    model = EASERecommender(**(fit_params or params), device="cpu")
    with trace.patched([HOOK], recorder.wrap):
        model.fit(X, show_progress=False)
    return recorder.answers(model, None)


@pytest.mark.parametrize("binarize", [True, False], ids=["binarized", "weighted"])
@pytest.mark.parametrize("lam", [1.0, 250.0])
@pytest.mark.parametrize("shape", SHAPES, ids=["300x64", "500x128"])
def test_port_fit_matches_reference(shape, lam, binarize):
    users, items, p, K = shape
    X = _matrix(users, items, p, seed=users + items)
    params = dict(K=K, regularization=lam, binarize=binarize)
    got = ref.judge_fit_answers(X, params, None, _fit(X, params), CPU)
    assert all(got[k] <= TOL for k in GAPS), got
    assert all(got[k] == 0 for k in EXACT), got
    # the stored similarity against the reference's own, row by row
    answers = _fit(X, params)
    want = ref.similarity(ref.weights(X, params, CPU), K)
    sim = answers["similarity"]
    np.testing.assert_array_equal(np.diff(sim.indptr), np.diff(want.indptr))
    for r in range(items):
        a, b = sim[r].toarray().ravel(), want[r].toarray().ravel()
        scale = np.abs(b).max()
        np.testing.assert_allclose(np.sort(a[a != 0]), np.sort(b[b != 0]), rtol=0,
                                   atol=TOL * scale)


@pytest.mark.parametrize("shape", SHAPES, ids=["300x64", "500x128"])
def test_the_tf32_control_fails(shape):
    users, items, p, K = shape
    X = _matrix(users, items, p, seed=users + items)
    params = dict(K=K, regularization=250.0, binarize=True)
    got = ref.judge_fit_answers(X, params, None,
                                ref.fit_answers(X, params, None, CPU, "tf32"), CPU)
    assert got["weights_rel_fro"] > 10 * TOL and got["weights_max_gap"] > 10 * TOL, got


def _rejected(got, number):
    assert got[number] > TOL and got[number] > LIMITS[number], got


@pytest.mark.parametrize("lam", [1.0, 250.0])
def test_judge_rejects_lambda_off_by_ten_percent(lam):
    X = _matrix(300, 64, 0.1, seed=3)
    params = dict(K=20, regularization=lam, binarize=True)
    answers = _fit(X, params, dict(params, regularization=1.1 * lam))
    _rejected(ref.judge_fit_answers(X, params, None, answers, CPU), "weights_rel_fro")


def test_judge_rejects_a_gramian_missing_its_last_user_chunk(monkeypatch):
    X = _matrix(300, 64, 0.1, seed=4)
    users, items = X.shape
    monkeypatch.setattr(nn, "_DEVICE_KNN_DENSE_BYTES", 64 * items)  # chunks of 64 users
    n_chunks = -(-users // 64)
    chunks = nn._densified_chunks
    monkeypatch.setattr(nn, "_densified_chunks",
                        lambda csr, width: itertools.islice(chunks(csr, width), n_chunks - 1))
    params = dict(K=20, regularization=250.0, binarize=True)
    _rejected(ref.judge_fit_answers(X, params, None, _fit(X, params), CPU), "weights_rel_fro")


def test_judge_rejects_a_similarity_without_its_diagonal():
    X = _matrix(300, 64, 0.1, seed=5)
    params = dict(K=20, regularization=250.0, binarize=True)
    answers = _fit(X, params)
    sim = answers["similarity"].tolil()
    sim.setdiag(0)
    answers["similarity"] = csr_matrix(sim)
    answers["similarity"].eliminate_zeros()
    got = ref.judge_fit_answers(X, params, None, answers, CPU)
    _rejected(got, "diag_gap")
    assert got["diag_gap"] == 64
