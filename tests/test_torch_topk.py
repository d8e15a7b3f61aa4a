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


# -- the selection: per-query exclusions as a CSR, the kernel's routing --------

def _scatter_path(items, query, k, liked):
    """The scatter the port applied before its selection took a CSR: every
    liked (row, id) pair inside the catalog set to -FLT_MAX, then
    ``torch.topk``."""
    scores = torch.as_tensor(query) @ torch.as_tensor(items).T
    coo = liked.tocoo()
    keep = coo.col < items.shape[0]
    scores[coo.row[keep], coo.col[keep]] = float(NEG_MAX)
    vals, ids = torch.topk(scores, k, dim=1)
    return ids.to(torch.int32).numpy(), vals.numpy()


def _awkward_liked(seed, q, n_items):
    """Liked items with rows in no order, ids past the catalog and, in row
    1, every item of the catalog."""
    rng = np.random.default_rng(seed)
    rows, data = [], []
    indptr = [0]
    for r in range(q):
        ids = rng.choice(n_items + 20, size=rng.integers(0, 40), replace=False)
        if r == 1:
            ids = np.arange(n_items)
        ids = rng.permutation(ids)
        rows.append(ids)
        indptr.append(indptr[-1] + len(ids))
    indices = np.concatenate(rows).astype(np.int32)
    liked = csr_matrix((np.ones(len(indices), dtype=np.float32), indices, indptr),
                       shape=(q, n_items + 20))
    assert not liked.has_sorted_indices
    return liked


def _paths():
    from implicit_tpu_torch.parallel import create_mesh

    return {
        "resident": lambda it, q, k, liked: ttopk.topk(torch.as_tensor(it), q, k,
                                                       filter_query_items=liked),
        "mesh": lambda it, q, k, liked: ttopk.topk(it, q, k, filter_query_items=liked,
                                                   mesh=create_mesh(3, "cpu")),
        "streaming": lambda it, q, k, liked: ttopk.topk_streaming(
            it, q, k, filter_query_items=liked, block_rows=128, device="cpu"),
    }


@pytest.mark.parametrize("k", [1, 10, 32, 64, 65])
@pytest.mark.parametrize("path", ["resident", "mesh", "streaming"])
def test_csr_exclusions_match_the_scatter_path(path, k):
    from test_torch_topk_streaming import assert_same_topk

    from implicit_tpu_torch import tracing

    items, query, _, _ = _case(20 + k, n_items=300, q=12)
    liked = _awkward_liked(k, 12, 300)
    before = tracing.counters()["topk.library_selects"]
    ids, scores = _paths()[path](items, query, k, liked)
    assert tracing.counters()["topk.library_selects"] > before  # the CPU: torch.topk
    assert_same_topk((ids, scores), _scatter_path(items, query, k, liked))
    liked_dense = liked.toarray()[:, :300] > 0
    for r in range(12):
        assert len(set(ids[r])) == k
        assert (liked_dense[r, ids[r]] == (scores[r] == NEG_MAX)).all(), r
    assert (scores[1] == NEG_MAX).all()


@pytest.mark.parametrize("k", [1, 10, 32, 64, 65])
def test_plain_selection_is_the_scatter_and_torch_topk(k):
    """``select_topk_plain`` with a CSR (unsorted rows, ids outside the row)
    writes -FLT_MAX where the scatter did and selects with ``torch.topk``:
    the same bits; merged candidates keep their own ids."""
    rng = np.random.default_rng(k)
    scores = torch.as_tensor(rng.standard_normal((6, 90), dtype=np.float32))
    liked = _awkward_liked(k + 1, 6, 70)
    sub = liked.sorted_indices()
    excl = (torch.as_tensor(sub.indptr, dtype=torch.int32),
            torch.as_tensor(np.clip(sub.indices, -1, 90), dtype=torch.int32))
    got = ttopk.select_topk(scores.clone(), k, excl)
    want = scores.clone()
    coo = liked.tocoo()
    keep = coo.col < 90
    want[coo.row[keep], coo.col[keep]] = float(NEG_MAX)
    want = torch.topk(want, k, dim=1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cand_ids = torch.as_tensor(rng.permutation(1000)[:90]).repeat(6, 1)
    vals, ids = ttopk.select_topk(scores.clone(), k, ids=cand_ids)
    assert torch.equal(ids, torch.gather(cand_ids, 1, torch.topk(scores, k, dim=1)[1]))


@pytest.mark.parametrize("k", [1, 10, 32, 64, 65, 256])
def test_the_kernel_takes_cuda_selections_up_to_its_limit(k):
    assert ttopk._kernel_selects(torch.device("cuda", 0), k) == (k <= ttopk.MAX_SELECT_K)
    assert not ttopk._kernel_selects(torch.device("cpu"), k)


@pytest.mark.parametrize("q_rows,n", [(1024, 292_385), (64, 292_385), (3, 292_385),
                                      (1, 292_385), (1, 33), (1, 4096), (1, 8191),
                                      (1, 8192), (5, 1_000_003), (1, 64 * 4096 + 1)])
def test_segments_fill_the_card_and_hold_k(monkeypatch, q_rows, n):
    """The kernel's segments a row (132 SMs faked): one at a bulk batch,
    several for a small one, each at least the kernel's largest k long, as
    the C entry point demands."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setitem(ttopk._SMS, cuda, 132)
    segs = ttopk._segments(q_rows, n, cuda)
    seg_len = -(-n // segs)
    assert segs >= 1 and seg_len >= min(n, ttopk.MAX_SELECT_K)
    assert n - (segs - 1) * seg_len >= min(n, ttopk.MAX_SELECT_K)
    assert q_rows * segs <= ttopk._BLOCKS_PER_SM * 132 or segs == 1
    if q_rows == 1024:
        assert segs == 1
    if q_rows == 1 and n >= 2 * ttopk._MIN_SEGMENT:
        assert segs > 1
