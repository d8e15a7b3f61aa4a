"""The top-k selection kernel (``csrc/topk_select.cu``) against its plain
version and the exact order, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX; run it on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_topk_select.py

The kernel's order is total: torch.topk's order-preserving key of each
float (NaN above +inf, -0 below +0), ties to the lower id. The exact
reference here is ``torch.topk`` over a composite int64 of that key and the
id, which has no ties; the plain version (a scatter and ``torch.topk`` on
the floats) must give the same values, its ids differing only among ties.
"""

import numpy as np
import pytest
import torch

from implicit_tpu_torch import tracing
from implicit_tpu_torch.ops import topk

pytestmark = pytest.mark.cuda

NEG_MAX = -np.finfo(np.float32).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(scores):
    """torch.topk's order-preserving key of each float, as int64 in [0, 2^32)."""
    x = scores.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(x >= 1 << 31, 0xFFFFFFFF - x, x + (1 << 31))
    return torch.where(torch.isnan(scores), torch.full_like(key, 0xFFFFFFFF), key)


def _excluded(scores, exclusions):
    """``scores`` with each in-range excluded id set to -FLT_MAX."""
    out = scores.clone()
    if exclusions is not None:
        indptr, ids = (t.cpu().numpy() for t in exclusions)
        rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        keep = (ids >= 0) & (ids < scores.shape[1])
        out[torch.as_tensor(rows[keep]), torch.as_tensor(ids[keep].astype(np.int64))] = float(
            NEG_MAX)
    return out


def _exact(scores, k, exclusions=None, ids=None):
    """The exact top k: the key above the id's complement, one int64."""
    s = _excluded(scores, exclusions)
    col = (torch.arange(s.shape[1], device=s.device).expand_as(s) if ids is None else ids)
    comp = (_keys(s) - (1 << 31)) * (1 << 32) + (0xFFFFFFFF - col)
    _, pos = torch.topk(comp, k, dim=1)
    return torch.gather(s, 1, pos), torch.gather(col, 1, pos)


def _scores(Q, n, seed, device, offset=0):
    """Gaussian scores with NaN, +-inf, -FLT_MAX, signed zeros and ties
    planted (about 8 a row), 100 ties above every other score in row 0 and
    a row of zeros (row 2); rows start unaligned wherever n is not a
    multiple of 4, and the block itself ``offset`` floats past an aligned
    address."""
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(Q * n + offset, generator=g, device=device)
    s = buf[offset:].view(Q, n)
    rng = np.random.default_rng(seed)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), float(NEG_MAX), 0.0,
                            -0.0, 1.5, 1.5], device=device)
    at = torch.as_tensor(rng.integers(Q * n, size=max(1, Q * min(n, 400) // 50)), device=device)
    s.view(-1)[at] = special[torch.as_tensor(rng.integers(len(special), size=len(at)),
                                             device=device)]
    s[0, torch.as_tensor(rng.integers(n, size=min(n, 100)), device=device)] = 9.0
    if Q > 2 and n > 1:
        s[2] = 0.0
    return s


def _exclusions(Q, n, seed, device, fully=1):
    """Sorted per-row ids with ids outside [0, n) mixed in; row ``fully``
    excludes every item."""
    rng = np.random.default_rng(seed + 1)
    rows, indptr = [], [0]
    for r in range(Q):
        if r == fully:
            ids = np.arange(-1, n + 2)
        else:
            ids = np.unique(rng.integers(-2, n + 3, size=rng.integers(0, min(n, 60) + 1)))
        rows.append(ids)
        indptr.append(indptr[-1] + len(ids))
    return topk._upload_exclusions(np.array(indptr), np.concatenate(rows), device)


def _check(got, want, plain):
    gv, gi = (t.cpu().numpy() for t in got)
    wv, wi = (t.cpu().numpy() for t in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, plain[0].cpu().numpy())
    assert got[1].dtype == torch.int64


CASES = [(Q, n, k) for Q in (1, 3, 1024) for n in (1, 33, 292_385) for k in (1, 10, 32, 64)
         if k <= n]


@pytest.mark.parametrize("Q,n,k", CASES)
def test_kernel_matches_the_exact_order_and_plain(cuda, Q, n, k):
    scores = _scores(Q, n, Q * 7 + n + k, cuda)
    excl = _exclusions(Q, n, Q + n + k, cuda)
    before = topk.LAUNCHES["topk_select"]
    got = topk.select_topk(scores, k, excl)
    torch.cuda.synchronize()
    segs = topk._segments(Q, n, cuda)
    assert topk.LAUNCHES["topk_select"] == before + (1 if segs == 1 else 2)
    _check(got, _exact(scores, k, excl), topk.select_topk_plain(scores.clone(), k, excl))
    # without exclusions, and from an unaligned block
    shifted = _scores(Q, n, Q * 7 + n + k, cuda, offset=1)
    _check(topk.select_topk(shifted, k), _exact(shifted, k),
           topk.select_topk_plain(shifted.clone(), k))


@pytest.mark.parametrize("k", [1, 10, 64])
def test_merging_candidates_orders_ties_by_their_ids(cuda, k):
    """Candidate sets with ids of their own (the sharded and streamed
    merges): ties go to the lower id, not the lower position."""
    Q, n = 5, 3 * 64
    scores = torch.round(_scores(Q, n, k, cuda) * 2) / 2  # many ties
    ids = torch.stack([torch.randperm(10_000, device=cuda)[:n] for _ in range(Q)])
    got = topk.select_topk(scores, k, ids=ids)
    _check(got, _exact(scores, k, ids=ids), topk.select_topk_plain(scores.clone(), k, ids=ids))


def test_segmented_rows_give_the_bits_of_one_segment(cuda, monkeypatch):
    scores = _scores(4, 292_385, 3, cuda)
    excl = _exclusions(4, 292_385, 3, cuda)
    one = topk.select_topk(scores, 10, excl)
    monkeypatch.setattr(topk, "_segments", lambda q, n, d: 9)
    before = topk.LAUNCHES["topk_select"]
    nine = topk.select_topk(scores, 10, excl)
    assert topk.LAUNCHES["topk_select"] == before + 2
    assert torch.equal(one[0].view(torch.int32), nine[0].view(torch.int32))  # NaN too
    assert torch.equal(one[1], nine[1])


def test_large_k_and_bad_input(cuda):
    scores = _scores(3, 500, 4, cuda)
    before = tracing.counters()
    vals, ids = topk.select_topk(scores.clone(), 65)
    after = tracing.counters()
    assert after["topk.library_selects"] == before["topk.library_selects"] + 1
    assert after["launches.topk_select"] == before["launches.topk_select"]
    assert torch.equal(vals, torch.topk(scores, 65, dim=1)[0])
    with pytest.raises(ValueError):
        topk.select_topk(scores[:, :5], 10)
    with pytest.raises(ValueError):
        topk.select_topk(scores.double(), 10)
    indptr, ids = _exclusions(3, 500, 4, cuda)
    with pytest.raises(ValueError):
        topk.select_topk(scores, 10, (indptr[:-1], ids))
    with pytest.raises(ValueError):
        topk.select_topk(scores, 10, (indptr, ids.long()))


def test_one_bulk_recommend_is_one_launch(cuda):
    """One 1024-user ``recommend`` with the liked filter: exactly one kernel
    launch and no selection left to ``torch.topk``; no liked item returned."""
    from scipy.sparse import csr_matrix

    from implicit_tpu_torch.als import AlternatingLeastSquares

    rng = np.random.default_rng(5)
    n_users, n_items = 1100, 20_000
    dense = rng.random((n_users, n_items)) < 0.003
    user_items = csr_matrix(dense.astype(np.float32))
    model = AlternatingLeastSquares(factors=32, iterations=1, random_state=1, device="cuda")
    model.fit(user_items, show_progress=False)
    users = np.arange(1024)
    model.recommend(users, user_items[users], N=10)  # warm
    before = tracing.counters()
    ids, scores = model.recommend(users, user_items[users], N=10)
    after = tracing.counters()
    assert after["launches.topk_select"] - before["launches.topk_select"] == 1
    assert after["topk.library_selects"] == before["topk.library_selects"]
    assert not dense[users[:, None], ids].any()
    want = topk.topk(model._serving_table("item").cpu(),
                     torch.as_tensor(model.user_factors)[users].cpu(), 10,
                     filter_query_items=user_items[users])
    np.testing.assert_allclose(scores, want[1], rtol=1e-5, atol=1e-6)
