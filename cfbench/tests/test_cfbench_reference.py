"""The plain references at a tiny size: against each other's definitions
and against the port on the CPU (the references themselves import
nothing of the port)."""

import numpy as np
import pytest
import torch

from cfbench.lib import data, trace
from cfbench.reference import als as ref
from cfbench.tests.tiny import CPU

SPEC = dict(users=600, items=300, draws=12000, structure_seed=0, popularity_offset=20.0,
            popularity_exponent=0.8, mean_confidence=40.0)
PARAMS = dict(factors=16, regularization=0.01, iterations=3, cg_steps=3, alpha=1.0)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -2.5], dtype=torch.float32)
    assert ref.to_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -2.5]


def test_half_iteration_solves_the_normal_equations():
    # with enough CG steps the reference's rows solve A x = b (F = 8; CG in
    # floating point needs more than F steps to settle)
    C = data.interactions(SPEC, 1, CPU).astype(np.float64)
    side = ref.SideCSR(C, CPU)
    side.conf = side.conf.double()
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.random((600, 8)))
    Y = torch.as_tensor(rng.random((300, 8)))
    x = ref.half_iteration(side, X, Y, 0.1, 20, ref.Products("float32"))
    for u in (0, 17, 599):
        lo, hi = C.indptr[u], C.indptr[u + 1]
        Yu, c = Y.numpy()[C.indices[lo:hi]], C.data[lo:hi]
        A = Y.numpy().T @ Y.numpy() + 0.1 * np.eye(8) + (Yu * (c - 1)[:, None]).T @ Yu
        b = c @ Yu
        assert np.abs(A @ x[u].numpy() - b).max() < 1e-10 * np.abs(b).max()


def test_reference_follows_the_port():
    from implicit_tpu_torch.als import AlternatingLeastSquares

    C = data.interactions(SPEC, 3, CPU)
    rec = ref.fit_recorder(PARAMS)
    with trace.patched(["implicit_tpu_torch.ops.als:solve_side"], rec.wrap):
        m = AlternatingLeastSquares(factors=16, iterations=3, random_state=11, device="cpu")
        m.fit(C, show_progress=False)
    got = ref.judge_fit_answers(C, PARAMS, 11, rec.answers(m, 11), CPU)
    assert got["start_gap"] == 0.0
    assert got["first_rel_fro"] < 1e-3 and got["last_rel_fro"] < 1e-4


def test_recommend_reference_and_judge():
    rng = np.random.default_rng(0)
    U = torch.as_tensor(rng.standard_normal((50, 8), dtype=np.float32))
    I = torch.as_tensor(rng.standard_normal((40, 8), dtype=np.float32))
    C = data.interactions(dict(SPEC, users=50, items=40, draws=300), 2, CPU)
    users = np.array([3, 7, 11])
    liked = C[users]
    ids, scores, _ = ref.recommend(U, I, torch.as_tensor(users), liked, 5)
    S = (U[users] @ I.T).numpy()
    for r, u in enumerate(users):
        S[r, liked[r].indices] = -np.inf
        assert set(ids[r].tolist()) == set(np.argsort(-S[r])[:5].tolist())
    ok = ref.judge_recommend(U, I, torch.as_tensor(users), liked, ids.numpy(), scores.numpy(), 5)
    assert ok == dict(rank_gap=0.0, score_gap=0.0, bad_ids=0)
    bad = ids.numpy().copy()
    bad[0, 0] = liked[0].indices[0] if liked[0].nnz else bad[0, 1]
    assert ref.judge_recommend(U, I, torch.as_tensor(users), liked, bad, scores.numpy(),
                               5)["bad_ids"] >= 1


def test_port_recommend_passes_the_judge():
    from implicit_tpu_torch.als import AlternatingLeastSquares

    C = data.interactions(dict(SPEC, users=200, items=120, draws=2000), 4, CPU)
    U = data.factor_table(200, 16, 0.1, 4, 0, CPU)
    I = data.factor_table(120, 16, 0.1, 4, 1, CPU)
    m = AlternatingLeastSquares(factors=16, device="cpu")
    m.user_factors, m.item_factors = U, I
    users = np.arange(0, 200, 7)
    ids, scores = m.recommend(users, C[users], N=10)
    got = ref.judge_recommend(torch.as_tensor(U), torch.as_tensor(I), torch.as_tensor(users),
                              C[users], ids, scores, 10)
    assert got["bad_ids"] == 0 and got["rank_gap"] < 1e-6 and got["score_gap"] < 1e-5
