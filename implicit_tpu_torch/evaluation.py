"""Train/test splitting and ranking metrics (p@k, MAP, NDCG, AUC).

The counterpart of ``implicit_tpu/evaluation.py``: host-side numpy, so the
port does not import jax for it. Metric definitions follow the reference
(implicit/evaluation.pyx); the membership tests are a vectorized broadcast
compare against the padded test rows of each batch.
"""

import numpy as np
from scipy.sparse import csr_matrix
from tqdm.auto import tqdm

from .utils import check_random_state


def train_test_split(ratings, train_percentage=0.8, random_state=None):
    """Randomly splits ratings into train/test matrices.

    Returns (train, test) csr matrices where each nonzero lands in train with
    probability ``train_percentage``. Negative entries are removed from test.
    """
    rng = check_random_state(random_state)
    coo = ratings.tocoo()
    in_train = rng.random(coo.nnz) < train_percentage

    def take(keep):
        return csr_matrix(
            (coo.data[keep], (coo.row[keep], coo.col[keep])),
            shape=coo.shape,
            dtype=coo.dtype,
        )

    train, test = take(in_train), take(~in_train)
    # negative confidences mean "disliked" — those never belong in a test set
    test.data[test.data < 0] = 0
    test.eliminate_zeros()
    return train, test


def _choose(rng, n, frac):
    """Sample approximately ``frac`` of range(n) without replacement."""
    size = max(1, int(n * frac))
    return rng.choice(n, size=size, replace=False)


def _take_tails(arr, n, return_complement=False, shuffled=False, rng=None):
    """Indices of ``n`` occurrences of each integer in ``arr``.

    Picks the last ``n`` per group in input order, or ``n`` random ones per
    group with ``shuffled=True`` (drawn from ``rng`` when given, so seeded
    splits are reproducible — the reference draws these from the global
    stream). Groups must cover a consecutive integer
    range so ``bincount`` indexes line up.
    """
    if shuffled:
        tiebreak = (rng or np.random).random(len(arr))
    else:
        tiebreak = np.arange(len(arr))
    order = np.lexsort((tiebreak, arr))
    sorted_arr = arr[order]

    # distance from each element to the end of its (contiguous, ascending) group
    group_ends = np.cumsum(np.bincount(sorted_arr))[sorted_arr]
    pos_from_end = group_ends - 1 - np.arange(len(arr))
    tails_mask = pos_from_end < n

    if return_complement:
        return order[tails_mask], order[~tails_mask]
    return order[tails_mask]


def leave_k_out_split(ratings, K=1, train_only_size=0.0, random_state=None):
    """Leave-K-out split: each eligible user has K interactions held out.

    Users need more than K+1 interactions to be eligible; ``train_only_size``
    reserves a fraction of users to appear only in the train matrix.
    Returns (train, test) csr matrices.
    """
    if K < 1:
        raise ValueError("The 'K' must be >= 1.")
    if not 0.0 <= train_only_size < 1.0:
        raise ValueError("The 'train_only_size' must be in the range (0.0 <= x < 1.0).")

    ratings = ratings.tocoo()
    random_state = check_random_state(random_state)

    users = ratings.row
    items = ratings.col
    data = ratings.data

    unique_users, counts = np.unique(users, return_counts=True)

    candidate_mask = counts > K + 1

    if train_only_size > 0.0:
        train_only_mask = ~np.isin(
            unique_users, _choose(random_state, len(unique_users), train_only_size)
        )
        candidate_mask = train_only_mask & candidate_mask

    unique_candidate_users = unique_users[candidate_mask]
    full_candidate_mask = np.isin(users, unique_candidate_users)

    candidate_users = users[full_candidate_mask]
    candidate_items = items[full_candidate_mask]
    candidate_data = data[full_candidate_mask]

    # the complement from _take_tails is positional and already exact (the
    # reference needed a setdiff1d workaround for its by-value variant)
    test_idx, train_idx = _take_tails(candidate_users, K, shuffled=True,
                                      return_complement=True,
                                      rng=random_state)

    test_mat = csr_matrix(
        (candidate_data[test_idx], (candidate_users[test_idx], candidate_items[test_idx])),
        shape=ratings.shape,
        dtype=ratings.dtype,
    )

    train_users = np.r_[users[~full_candidate_mask], candidate_users[train_idx]]
    train_items = np.r_[items[~full_candidate_mask], candidate_items[train_idx]]
    train_data = np.r_[data[~full_candidate_mask], candidate_data[train_idx]]
    train_mat = csr_matrix(
        (train_data, (train_users, train_items)), shape=ratings.shape, dtype=ratings.dtype
    )

    return train_mat, test_mat


def ranking_metrics_at_k(
    model, train_user_items, test_user_items, K=10, show_progress=True, num_threads=1
):
    """Calculates precision@K, MAP@K, NDCG@K and AUC@K for a trained model.

    Models with ``recommend_pipelined`` stream their batches through it
    with ``max(2, num_threads)`` batches in flight; the metric math is
    vectorized numpy.
    """
    if not isinstance(train_user_items, csr_matrix):
        train_user_items = train_user_items.tocsr()
    if not isinstance(test_user_items, csr_matrix):
        test_user_items = test_user_items.tocsr()

    users, items = test_user_items.shape

    # cumulative-gain tables for NDCG
    cg = 1.0 / np.log2(np.arange(2, K + 2))
    cg_sum = np.cumsum(cg)

    test_indptr = test_user_items.indptr
    test_indices = test_user_items.indices

    relevant = 0.0
    pr_div = 0.0
    total = 0.0
    mean_ap = 0.0
    ndcg = 0.0
    mean_auc = 0.0

    to_generate = np.arange(users, dtype="int32")
    to_generate = to_generate[np.ediff1d(test_user_items.indptr) > 0]

    # large batches amortize the per-call launch and copy overhead (top-k
    # chunks internally by device memory, so big batches are safe)
    batch_size = 8192

    progress = tqdm(total=len(to_generate), disable=not show_progress)

    # host-side metric math runs on sub-slices so the (B, K, Lmax)
    # membership broadcast stays bounded even when one user in the large
    # recommend batch carries a very long test row
    sub = 1024

    batches = [
        to_generate[i : i + batch_size]
        for i in range(0, len(to_generate), batch_size)
    ]
    if hasattr(model, "recommend_pipelined"):
        # matrix-factorization models stream: the host metric math of one
        # batch overlaps the device work and copies of the next
        stream = model.recommend_pipelined(
            ((b, train_user_items[b]) for b in batches), N=K,
            max_in_flight=max(2, int(num_threads)),
        )
    else:
        stream = (model.recommend(b, train_user_items[b], N=K) for b in batches)

    for batch, (all_ids, _) in zip(batches, stream):
        for s0 in range(0, len(batch), sub):
            sb = batch[s0 : s0 + sub]
            ids = all_ids[s0 : s0 + sub]
            B = len(sb)

            # pad each user's test row to the slice max for broadcast membership
            likes_count = (test_indptr[sb + 1] - test_indptr[sb]).astype(np.int64)
            Lmax = int(likes_count.max())
            # pad with -2: recommend() pads short results with -1, which must
            # not collide with the padding sentinel here
            padded = np.full((B, Lmax), -2, dtype=np.int64)
            within = np.arange(likes_count.sum(), dtype=np.int64) - np.repeat(
                np.cumsum(likes_count) - likes_count, likes_count
            )
            rows = np.repeat(np.arange(B, dtype=np.int64), likes_count)
            src = np.repeat(test_indptr[sb].astype(np.int64), likes_count) + within
            padded[rows, within] = test_indices[src]

            hits = (ids[:, :, None] == padded[:, None, :]).any(axis=2)  # (B, K)

            num_pos = likes_count.astype(np.float64)
            num_neg = items - num_pos
            k_eff = np.minimum(K, num_pos)

            relevant += hits.sum()
            pr_div += k_eff.sum()

            hit_cum = np.cumsum(hits, axis=1)  # inclusive cumulative hits
            ranks = np.arange(1, ids.shape[1] + 1, dtype=np.float64)
            ap = (hits * hit_cum / ranks).sum(axis=1)
            mean_ap += (ap / k_eff).sum()

            idcg = cg_sum[(k_eff - 1).astype(np.int64)]
            ndcg += (hits * (cg[None, : ids.shape[1]] / idcg[:, None])).sum()

            # AUC: each miss at rank i contributes the hits seen so far
            miss = ~hits
            auc = (miss * hit_cum).sum(axis=1).astype(np.float64)
            miss_total = miss.sum(axis=1)
            hit_total = hits.sum(axis=1)
            auc += ((hit_total + num_pos) / 2.0) * (num_neg - miss_total)
            mean_auc += (auc / (num_pos * num_neg)).sum()

            total += B
            progress.update(B)

    progress.close()
    return {
        "precision": relevant / pr_div,
        "map": mean_ap / total,
        "ndcg": ndcg / total,
        "auc": mean_auc / total,
    }


def precision_at_k(model, train_user_items, test_user_items, K=10, show_progress=True,
                   num_threads=1):
    """Calculates P@K for a given trained model."""
    return ranking_metrics_at_k(
        model, train_user_items, test_user_items, K, show_progress, num_threads
    )["precision"]


def mean_average_precision_at_k(model, train_user_items, test_user_items, K=10,
                                show_progress=True, num_threads=1):
    """Calculates MAP@K for a given trained model."""
    return ranking_metrics_at_k(
        model, train_user_items, test_user_items, K, show_progress, num_threads
    )["map"]


def ndcg_at_k(model, train_user_items, test_user_items, K=10, show_progress=True,
              num_threads=1):
    """Calculates NDCG@K for a given trained model."""
    return ranking_metrics_at_k(
        model, train_user_items, test_user_items, K, show_progress, num_threads
    )["ndcg"]


def AUC_at_k(model, train_user_items, test_user_items, K=10, show_progress=True,
             num_threads=1):
    """Calculates limited AUC for a given trained model."""
    return ranking_metrics_at_k(
        model, train_user_items, test_user_items, K, show_progress, num_threads
    )["auc"]
