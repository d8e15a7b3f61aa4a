"""The port's top-k serving against the JAX package's ``ops.topk.topk``.

Scores come from Gaussian factors, so real scores have no near-ties and
their ids must match exactly; scores are float32 GEMM outputs that differ
by summation order only (rtol 1e-5). Filtered entries all score -FLT_MAX,
a tie whose order neither engine promises, so among them only the set of
ids is compared.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

from implicit_tpu.ops import topk as jtopk
from implicit_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)

NEG_MAX = -np.finfo(np.float32).max


def _case(seed, n_items=300, q=40, F=16):
    rng = np.random.default_rng(seed)
    items = rng.standard_normal((n_items, F), dtype=np.float32)
    query = rng.standard_normal((q, F), dtype=np.float32)
    norms = np.linalg.norm(items, axis=1).astype(np.float32)
    liked = csr_matrix((rng.random((q, n_items)) < 0.1).astype(np.float32))
    return items, query, norms, liked


def _compare(got, want):
    gids, gsc = got
    wids, wsc = want
    assert gids.shape == wids.shape and gids.dtype == np.int32
    np.testing.assert_allclose(gsc, wsc, rtol=1e-5, atol=1e-6)
    real = wsc > NEG_MAX
    np.testing.assert_array_equal(gids[real], wids[real])
    for g, w, r in zip(gids, wids, real):
        assert sorted(g[~r]) == sorted(w[~r])


KWARGS = {
    "plain": lambda n, l: {},
    "norms": lambda n, l: {"item_norms": n},
    "filter_items": lambda n, l: {"filter_items": [3, 7, 11, 299]},
    "liked": lambda n, l: {"filter_query_items": l},
    "all": lambda n, l: {"item_norms": n, "filter_items": np.arange(0, 300, 7),
                         "filter_query_items": l},
}


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("kind", sorted(KWARGS))
def test_topk_matches_jax(kind, k):
    items, query, norms, liked = _case(k)
    kw = KWARGS[kind](norms, liked)
    got = ttopk.topk(torch.as_tensor(items), query, k, **kw)
    want = jtopk.topk(items, query, k, **kw)
    _compare(got, want)


def test_bf16_table_matches_rounded_oracle_and_jax():
    # the port rounds table and queries to bfloat16 and accumulates the
    # exact products in float32: it matches a float64 product of the rounded
    # values to float32 precision. JAX's CPU backend rounds its bf16 dot's
    # result to bfloat16, so against JAX the scores agree to one bfloat16
    # step (2^-7 relative) only.
    import ml_dtypes

    items, query, norms, liked = _case(5)
    got = ttopk.topk(torch.as_tensor(items).to(torch.bfloat16), query, 10,
                     filter_query_items=liked)
    bf = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)  # noqa: E731
    ref = bf(query) @ bf(items).T
    ref[liked.toarray() > 0] = NEG_MAX
    order = np.argsort(-ref, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(got[0], order)
    np.testing.assert_allclose(got[1], np.take_along_axis(ref, order, 1), rtol=1e-5)
    want = jtopk.topk(items.astype(np.float16), query, 10, filter_query_items=liked)
    np.testing.assert_allclose(got[1], want[1], rtol=2**-7)


def test_more_results_than_items_pad_with_sentinels():
    items, query, _, liked = _case(6, n_items=12, q=5)
    ids, scores = ttopk.topk(torch.as_tensor(items), query, 20, filter_query_items=liked)
    assert ids.shape == (5, 20)
    assert (ids[:, 12:] == -1).all() and (scores[:, 12:] == NEG_MAX).all()
    # every item still appears once per row: filtered ones with -FLT_MAX
    for row in ids:
        assert sorted(row[:12]) == list(range(12))
    want = jtopk.topk(items, query, 20, filter_query_items=liked)
    _compare((ids, scores), want)


def test_fully_filtered_row_and_out_of_range_filters():
    items, query, _, _ = _case(7, n_items=8, q=3)
    liked = csr_matrix(np.array([[1] * 8, [0] * 8, [1, 0, 0, 0, 0, 0, 0, 0]], dtype=np.float32))
    # filter ids outside the catalog are ignored, as JAX's dropped scatters
    ids, scores = ttopk.topk(torch.as_tensor(items), query, 8, filter_query_items=liked,
                             filter_items=[2, 50])
    assert (scores[0] == NEG_MAX).all() and sorted(ids[0]) == list(range(8))
    assert (scores[1] == NEG_MAX).sum() == 1 and 2 not in ids[1][:7]
    _compare((ids, scores), jtopk.topk(items, query, 8, filter_query_items=liked,
                                       filter_items=[2, 50]))


def test_scalar_query_and_empty_k():
    items, query, _, _ = _case(8)
    ids, scores = ttopk.topk(torch.as_tensor(items), query[0], 5)
    assert ids.shape == (1, 5)
    _compare((ids, scores), jtopk.topk(items, query[0], 5))
    ids, scores = ttopk.topk(torch.as_tensor(items), query, 0)
    assert ids.shape == (40, 0) and scores.shape == (40, 0)


def test_query_chunking_gives_the_same_result(monkeypatch):
    items, query, norms, liked = _case(9, q=100)
    whole = ttopk.topk(torch.as_tensor(items), query, 10, item_norms=norms,
                       filter_query_items=liked)
    # a budget of 7 rows' scores per chunk
    monkeypatch.setattr(ttopk, "_MAX_SCORE_ELEMENTS_CPU", 7 * 300)
    chunked = ttopk.topk(torch.as_tensor(items), query, 10, item_norms=norms,
                         filter_query_items=liked)
    np.testing.assert_array_equal(whole[0], chunked[0])
    np.testing.assert_array_equal(whole[1], chunked[1])
