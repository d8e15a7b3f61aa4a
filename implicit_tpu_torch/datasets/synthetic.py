"""Synthetic implicit-feedback datasets for benchmarking and air-gapped testing.

The same generators as ``implicit_tpu/datasets/synthetic.py`` (the same
seed gives the same matrix): shape statistics of the standard benchmarks
(user/item counts, nnz, power-law item popularity), which set the cost.
"""

import numpy as np
from scipy.sparse import coo_matrix


def generate_synthetic(users, items, nnz, pop_exponent=0.8, mean_confidence=40.0, seed=0):
    """Random users x items play-count CSR with power-law item popularity.

    Item ranks are drawn with probability proportional to (rank + 20)^-a via
    inverse-CDF sampling; duplicate (user, item) draws are summed, so the
    result has approximately ``nnz`` entries.
    """
    rng = np.random.default_rng(seed)
    weights = (np.arange(items, dtype=np.float64) + 20.0) ** -pop_exponent
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]

    draws = int(nnz * 1.05)
    cols = np.searchsorted(cdf, rng.random(draws)).astype(np.int32)
    rows = rng.integers(0, users, size=draws, dtype=np.int32)
    vals = rng.exponential(mean_confidence, size=draws).astype(np.float32) + 1.0
    mat = coo_matrix((vals, (rows, cols)), shape=(users, items)).tocsr()
    mat.sum_duplicates()
    return mat


def get_synthetic_lastfm(seed=0):
    """last.fm-360k shaped synthetic data: 360k x 160k, ~17M nonzeros."""
    return generate_synthetic(360_000, 160_000, 17_500_000, seed=seed)


def get_synthetic_movielens20m(seed=0):
    """MovieLens-20M shaped synthetic data (4+ star filtered): ~12M nonzeros."""
    return generate_synthetic(138_000, 27_000, 12_000_000, seed=seed)


def get_synthetic_clustered(users=300, items=120, groups=6, likes_per_user=12, seed=7):
    """Clustered preferences: users in group g like items in group g.

    Useful for quality gates: a good model recovers the block structure.
    """
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for u in range(users):
        g = u % groups
        group_items = np.arange(g, items, groups)
        liked = rng.choice(group_items, size=likes_per_user, replace=False)
        rows.extend([u] * len(liked))
        cols.extend(liked)
    return coo_matrix(
        (np.ones(len(rows), dtype=np.float32), (rows, cols)), shape=(users, items)
    ).tocsr()
