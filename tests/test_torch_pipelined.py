"""The port's asynchronous top-k and pipelined serving against per-batch
calls and the JAX package's pipelined serving.

``topk_async`` must give ``topk``'s arrays with several futures in flight;
``recommend_pipelined``, ``similar_items_pipelined`` and
``similar_users_pipelined`` must give the per-batch calls' results bit for
bit, and the JAX package's pipelined results (the same factors, carried
across with ``convert.als_from_numpy``) with scores within rtol 1e-5 and
ids equal modulo ties (``test_torch_topk_streaming.assert_same_topk``).
All on the CPU; the CUDA events and pinned buffers are exercised in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import random as sparse_random
from test_torch_topk_streaming import assert_same_topk

from implicit_tpu.evaluation import ranking_metrics_at_k as jax_metrics
from implicit_tpu.models.als import AlternatingLeastSquares as JaxALS
from implicit_tpu_torch import convert
from implicit_tpu_torch.datasets.synthetic import generate_synthetic
from implicit_tpu_torch.evaluation import ranking_metrics_at_k, train_test_split
from implicit_tpu_torch.models import mf_base
from implicit_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)


def _case(seed=0, n_items=300, q=50, F=16):
    rng = np.random.default_rng(seed)
    items = rng.standard_normal((n_items, F), dtype=np.float32)
    queries = rng.standard_normal((q, F), dtype=np.float32)
    liked = sparse_random(q, n_items, density=0.05, random_state=rng, format="csr")
    return items, queries, liked


def test_topk_async_futures_in_flight_equal_topk(monkeypatch):
    items, queries, liked = _case()
    table = torch.as_tensor(items)
    norms = np.linalg.norm(items, axis=1)
    kws = [{}, {"filter_query_items": liked, "filter_items": [1, 5, 299, 400]},
           {"item_norms": norms}, {}]
    ks = [10, 7, 3, 400]  # the last one pads past the item count
    want = [ttopk.topk(table, queries, k, **kw) for k, kw in zip(ks, kws)]
    # chunks of 3 queries: 17 chunks per call, more than _MAX_IN_FLIGHT
    monkeypatch.setattr(ttopk, "_MAX_SCORE_ELEMENTS_CPU", 3 * items.shape[0])
    futures = [ttopk.topk_async(table, queries, k, **kw) for k, kw in zip(ks, kws)]
    for future, w in reversed(list(zip(futures, want))):  # read in another order
        got = future.result()
        assert got[0] is future.result()[0]  # one result, read once
        np.testing.assert_array_equal(got[0], w[0])
        np.testing.assert_array_equal(got[1], w[1])
    assert (futures[3].result()[0][:, 300:] == -1).all()
    # a query tensor on the table's device is used where it lies
    got = ttopk.topk_async(table, torch.as_tensor(queries[:5]), 4).result()
    np.testing.assert_array_equal(got[0], want[0][0][:5, :4])
    empty = ttopk.topk_async(table, queries, 0).result()
    assert empty[0].shape == (50, 0)


def _models(dtype=np.float32, users=80, items=120, f=16, seed=3):
    plays = generate_synthetic(users, items, 1500, seed=seed)
    jmodel = JaxALS(factors=f, iterations=3, random_state=seed, dtype=dtype)
    jmodel.fit(plays, show_progress=False)
    model = convert.als_from_numpy(convert.numpy_params(jmodel), device="cpu")
    return jmodel, model, plays


BATCHES = [np.arange(0, 23), np.arange(23, 50), np.arange(50, 51), np.arange(51, 80)]


def _same_bits(got, want):
    for (gi, gs), (wi, ws) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)


RECOMMEND_KWARGS = {
    "liked": dict(),
    "filter_items": dict(filter_items=[0, 3, 17]),
    "items": dict(items=np.arange(5, 110, 2)),
    "unfiltered": dict(filter_already_liked_items=False),
}


@pytest.mark.parametrize("kind", sorted(RECOMMEND_KWARGS))
@pytest.mark.parametrize("max_in_flight", [1, 3])
def test_recommend_pipelined_matches_batches_and_jax(kind, max_in_flight):
    jmodel, model, plays = _models()
    kw = RECOMMEND_KWARGS[kind]
    unfiltered = kind == "unfiltered"
    entries = [b if unfiltered else (b, plays[b]) for b in BATCHES]
    got = list(model.recommend_pipelined(iter(entries), N=6, max_in_flight=max_in_flight,
                                         **kw))
    _same_bits(got, [model.recommend(b, plays[b], N=6, **kw) for b in BATCHES])
    want = list(jmodel.recommend_pipelined(iter(entries), N=6, **kw))
    for g, w in zip(got, want, strict=True):
        assert_same_topk(g, w, rtol=1e-5)


def test_recommend_pipelined_scalar_and_recalculate():
    jmodel, model, plays = _models()
    got = list(model.recommend_pipelined(((u, plays[u]) for u in (3, 9)), N=5,
                                         recalculate_user=True))
    for u, g in zip((3, 9), got):
        assert g[0].shape == (5,)
        _same_bits([g], [model.recommend(u, plays[u], N=5, recalculate_user=True)])


@pytest.mark.parametrize("kind", ["plain", "items", "filter_items"])
def test_similar_items_pipelined_matches_batches_and_jax(kind):
    jmodel, model, _ = _models()
    kw = {"plain": {}, "items": {"items": np.arange(10, 90)},
          "filter_items": {"filter_items": [1, 2, 50]}}[kind]
    batches = [np.arange(0, 30), np.arange(30, 31), np.arange(31, 120)]
    got = list(model.similar_items_pipelined(batches, N=5, max_in_flight=2, **kw))
    _same_bits(got, [model.similar_items(b, N=5, **kw) for b in batches])
    for g, w in zip(got, jmodel.similar_items_pipelined(batches, N=5, **kw), strict=True):
        assert_same_topk(g, w, rtol=1e-5)


@pytest.mark.parametrize("kind", ["plain", "users", "filter_users"])
def test_similar_users_pipelined_matches_batches_and_jax(kind):
    jmodel, model, _ = _models()
    kw = {"plain": {}, "users": {"users": np.arange(0, 60)},
          "filter_users": {"filter_users": [4, 5]}}[kind]
    got = list(model.similar_users_pipelined(BATCHES, N=4, **kw))
    _same_bits(got, [model.similar_users(b, N=4, **kw) for b in BATCHES])
    for g, w in zip(got, jmodel.similar_users_pipelined(BATCHES, N=4, **kw), strict=True):
        assert_same_topk(g, w, rtol=1e-5)


def test_pipelined_16bit_model_matches_batches():
    # bfloat16 serving: the per-batch calls' bits (the JAX package's CPU
    # bf16 GEMM rounds its scores, ROADMAP C6)
    _, model, plays = _models(dtype=np.float16)
    got = list(model.recommend_pipelined(((b, plays[b]) for b in BATCHES), N=6))
    _same_bits(got, [model.recommend(b, plays[b], N=6) for b in BATCHES])
    got = list(model.similar_items_pipelined(BATCHES, N=6))
    _same_bits(got, [model.similar_items(b, N=6) for b in BATCHES])


def test_pipelined_argument_errors_are_eager():
    # raised at the call, before any batch is drawn, as in the per-batch calls
    _, model, _ = _models()
    never = (b for b in ())
    with pytest.raises(ValueError, match="both items and filter_items"):
        model.recommend_pipelined(never, items=[1, 2], filter_items=[3])
    with pytest.raises(IndexError):
        model.recommend_pipelined(never, items=[1, 1000])
    with pytest.raises(ValueError, match="both items and filter_items"):
        model.similar_items_pipelined(never, items=[1, 2], filter_items=[3])
    with pytest.raises(IndexError):
        model.similar_items_pipelined(never, items=[-1])
    with pytest.raises(ValueError, match="both users and filter_users"):
        model.similar_users_pipelined(never, users=[1, 2], filter_users=[3])
    with pytest.raises(IndexError):
        model.similar_users_pipelined(never, users=[500])
    # a batch's own contract checks raise when it is drawn
    with pytest.raises(ValueError, match="CSR"):
        next(model.recommend_pipelined(iter([(np.arange(3), np.zeros((3, 120)))])))


def test_subclass_with_its_own_serving_is_not_bypassed():
    _, model, plays = _models()

    class Custom(type(model)):
        def recommend(self, userid, user_items, N=10, **kw):
            ids, scores = super().recommend(userid, user_items, N=N, **kw)
            return ids[..., ::-1], scores[..., ::-1]

        def similar_items(self, itemid, N=10, **kw):
            return super().similar_items(itemid, N=N, **kw)[0] * 0, None

        def similar_users(self, userid, N=10, **kw):
            return super().similar_users(userid, N=N, **kw)[0] + 1, None

    custom = Custom(factors=model.factors, device="cpu")
    custom.user_factors, custom.item_factors = model.user_factors, model.item_factors
    got = list(custom.recommend_pipelined(((b, plays[b]) for b in BATCHES[:2]), N=4))
    want = model.recommend(BATCHES[0], plays[BATCHES[0]], N=4)
    np.testing.assert_array_equal(got[0][0], want[0][:, ::-1])
    assert (next(custom.similar_items_pipelined(BATCHES))[0] == 0).all()
    np.testing.assert_array_equal(next(custom.similar_users_pipelined(BATCHES, N=3))[0],
                                  model.similar_users(BATCHES[0], N=3)[0] + 1)


@pytest.mark.parametrize("num_threads", [1, 4])
def test_ranking_metrics_stream_through_pipelined_and_match_jax(monkeypatch, num_threads):
    plays = generate_synthetic(300, 200, 6000, seed=4)
    train, test = train_test_split(plays, 0.8, random_state=1)
    jmodel = JaxALS(factors=16, iterations=3, random_state=5)
    jmodel.fit(train, show_progress=False)
    model = convert.als_from_numpy(convert.numpy_params(jmodel), device="cpu")
    seen = []
    real = mf_base.MatrixFactorizationBase.recommend_pipelined

    def spy(self, batches, **kw):
        seen.append(kw["max_in_flight"])
        return real(self, batches, **kw)

    monkeypatch.setattr(mf_base.MatrixFactorizationBase, "recommend_pipelined", spy)
    got = ranking_metrics_at_k(model, train, test, K=10, show_progress=False,
                               num_threads=num_threads)
    want = jax_metrics(jmodel, train, test, K=10, show_progress=False,
                       num_threads=num_threads)
    assert seen == [max(2, num_threads)]
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-12)
