"""A test-only fit family: the BM25 item-item fit, which takes no
``random_state`` and has no state to follow (no hook), judged on the fitted
similarity: each stored value against the plain inner product of the BM25
weighted item columns, and each row's entries against its top K."""

import numpy as np


class Recorder:
    wrap = None

    def answers(self, model, random_state):
        return dict(similarity=model.similarity)


def fit_recorder(params):
    return Recorder()


def fit_answers(user_items, params, random_state, device, precision):
    raise NotImplementedError("the probe has no reference fit")


def similarity(user_items, K1, B):
    """Dense items x items inner products of the BM25 weighted item rows."""
    X = user_items.T.tocoo().astype(np.float64)
    idf = np.log(float(X.shape[0])) - np.log1p(np.bincount(X.col, minlength=X.shape[1]))
    row_sums = np.bincount(X.row, weights=X.data, minlength=X.shape[0])
    norm = (1.0 - B) + B * row_sums / row_sums.mean()
    W = np.zeros(X.shape)
    W[X.row, X.col] = X.data * (K1 + 1.0) / (K1 * norm[X.row] + X.data) * idf[X.col]
    return W @ W.T


def judge_fit_answers(user_items, params, random_state, answers, device):
    """``value_gap``: the widest gap of a stored value from the reference's,
    over the largest |value|; ``rank_gap``: how far a row's smallest stored
    value lies below the reference's K-th largest positive value of that row,
    over the same; ``count_gap``: rows whose count is not min(K, positives)."""
    S = similarity(user_items, float(params["K1"]), float(params["B"]))
    K = int(params["K"])
    sim = answers["similarity"].tocsr()
    scale = np.abs(S).max()
    rows = np.repeat(np.arange(sim.shape[0]), np.diff(sim.indptr))
    value_gap = float(np.abs(sim.data - S[rows, sim.indices]).max()) / scale
    rank_gap, count_gap = 0.0, 0
    for r in range(S.shape[0]):
        pos = np.sort(S[r][S[r] > 0])[::-1]
        stored = sim.data[sim.indptr[r]:sim.indptr[r + 1]]
        count_gap += int(len(stored) != min(K, len(pos)))
        if len(stored):
            rank_gap = max(rank_gap, (pos[min(K, len(pos)) - 1] - stored.min()) / scale)
    return dict(value_gap=value_gap, rank_gap=rank_gap, count_gap=count_gap)
