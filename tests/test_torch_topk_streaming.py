"""The port's ``topk_streaming`` (a table that stays on the host) against the
JAX package's ``topk_streaming`` and the port's resident ``topk``.

Every case of ``tests/test_topk_streaming.py`` runs on the port's CPU path
(``device="cpu"``), where blocks are used where they lie; the CUDA path's
staging buffers and copy stream are held to the resident top-k in
``tests/test_torch_cuda.py``. Tolerances: scores within rtol 1e-6 (float32
products in another order), ids equal modulo ties at a row's scores
(``torch.topk`` promises no order among ties, and the port does not bucket
shapes, ROADMAP C20).
"""

import numpy as np
import pytest
import torch
from scipy.sparse import random as sparse_random

from implicit_tpu.ops import topk as jtopk
from implicit_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)

NEG_MAX = -np.finfo(np.float32).max


def _data(n_items=700, factors=24, q=33, seed=0):
    rng = np.random.default_rng(seed)
    items = rng.standard_normal((n_items, factors)).astype(np.float32)
    queries = rng.standard_normal((q, factors)).astype(np.float32)
    return items, queries


def assert_same_topk(got, want, rtol=1e-6):
    """Scores within ``rtol``; ids equal but where ``want``'s score at that
    place ties (within ``rtol``) another score of its row or the row's last
    one (whose tie may run past k); every id scoring above the row's last
    score is in both."""
    gids, gsc = (np.atleast_2d(a) for a in got)
    wids, wsc = (np.atleast_2d(a) for a in want)
    assert gids.shape == wids.shape and gids.dtype == wids.dtype
    np.testing.assert_allclose(gsc, wsc, rtol=rtol, atol=0)
    np.testing.assert_array_equal(gids < 0, wids < 0)
    for r in range(gids.shape[0]):
        tol = rtol * np.abs(np.where(np.isfinite(wsc[r]), wsc[r], 0))  # -inf: IVF padding
        for p in np.flatnonzero(gids[r] != wids[r]):
            tied = np.abs(wsc[r] - wsc[r][p]) <= tol[p]
            assert tied.sum() > 1 or tied[-1], (r, p)
        above = wids[r][wsc[r] > wsc[r][-1] + tol[-1]]
        assert np.isin(above, gids[r]).all(), r


def _stream(items, queries, k, **kw):
    return ttopk.topk_streaming(items, queries, k, device="cpu", **kw)


def _resident(items, queries, k, **kw):
    return ttopk.topk(torch.as_tensor(items), queries, k, **kw)


@pytest.mark.parametrize("block_rows", [128, 256, 1024])
def test_matches_resident(block_rows):
    items, queries = _data()
    got = _stream(items, queries, 10, block_rows=block_rows)
    assert_same_topk(got, _resident(items, queries, 10))
    assert_same_topk(got, jtopk.topk_streaming(items, queries, 10, block_rows=block_rows))


def test_matches_with_filters():
    items, queries = _data(seed=1)
    rng = np.random.default_rng(2)
    qf = sparse_random(queries.shape[0], items.shape[0], density=0.05,
                       random_state=rng, format="csr")
    qf.data[:] = 1.0
    fi = rng.choice(items.shape[0], size=40, replace=False)
    norms = np.linalg.norm(items, axis=1)

    kw = dict(item_norms=norms, filter_query_items=qf, filter_items=fi)
    got = _stream(items, queries, 10, block_rows=256, **kw)
    assert_same_topk(got, _resident(items, queries, 10, **kw))
    assert_same_topk(got, jtopk.topk_streaming(items, queries, 10, block_rows=256, **kw))
    assert not np.isin(got[0], fi).any()
    for r in range(queries.shape[0]):
        assert not np.isin(got[0][r], qf[r].indices).any()


def test_k_exceeds_items():
    items, queries = _data(n_items=7, q=3, seed=3)
    got = _stream(items, queries, 12, block_rows=128)
    assert_same_topk(got, _resident(items, queries, 12))
    assert_same_topk(got, jtopk.topk_streaming(items, queries, 12, block_rows=128))
    assert (got[0][:, 7:] == -1).all() and (got[1][:, 7:] == NEG_MAX).all()


def test_block_not_dividing_items():
    items, queries = _data(n_items=777, seed=4)
    got = _stream(items, queries, 5, block_rows=256)
    assert_same_topk(got, _resident(items, queries, 5))
    assert_same_topk(got, jtopk.topk_streaming(items, queries, 5, block_rows=256))


def test_scalar_query_and_k0():
    items, queries = _data(seed=5)
    got = _stream(items, queries[0], 4, block_rows=256)
    assert got[0].shape == (1, 4)
    assert_same_topk(got, _resident(items, queries[0].reshape(1, -1), 4))
    assert_same_topk(got, jtopk.topk_streaming(items, queries[0], 4, block_rows=256))
    ids0, vals0 = _stream(items, queries, 0)
    assert ids0.shape == (queries.shape[0], 0) and vals0.shape == (queries.shape[0], 0)


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
def test_16bit_table_streams_bf16(kind):
    # 16-bit tables stream in bfloat16 and score in float32: equal to the
    # resident bfloat16 table and to a float64 product of the rounded values
    # (the JAX package's CPU bf16 GEMM rounds its scores to bfloat16, C6)
    import ml_dtypes

    items, queries = _data(seed=6)
    items16 = items.astype(ml_dtypes.bfloat16 if kind == "bfloat16" else np.float16)
    got = _stream(items16, queries, 10, block_rows=256)
    table = torch.as_tensor(items16.astype(np.float32)).to(torch.bfloat16)
    want = ttopk.topk(table, queries, 10)
    assert_same_topk(got, want)
    bf = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)  # noqa: E731
    ref = bf(queries) @ bf(items16.astype(np.float32)).T
    order = np.argsort(-ref, axis=1, kind="stable")[:, :10]
    assert_same_topk(got, (order.astype(np.int32), np.take_along_axis(ref, order, 1)),
                     rtol=1e-5)


def test_memmap_table(tmp_path):
    # a memmap: the table never materializes whole in RAM
    items, queries = _data(seed=7)
    path = str(tmp_path / "table.npy")
    np.save(path, items)
    mm = np.load(path, mmap_mode="r")
    got = _stream(mm, queries, 10, block_rows=256)
    assert_same_topk(got, _resident(items, queries, 10))
    assert_same_topk(got, jtopk.topk_streaming(mm, queries, 10, block_rows=256))


def test_default_block_sizing_bounds_table_dim(monkeypatch):
    # the default block bounds the (block, F) upload too: one query over a
    # large catalog does not take the table in one block
    items, _ = _data(n_items=5000, q=1, seed=8)
    monkeypatch.setattr(ttopk, "_MAX_SCORE_ELEMENTS_CPU", 2048 * items.shape[1])
    blocks = []
    real = ttopk._host_block
    monkeypatch.setattr(ttopk, "_host_block",
                        lambda *a: blocks.append(a[2] - a[1]) or real(*a))
    got = _stream(items, items[0], 10)
    assert max(blocks) == 2048 and sum(blocks) == 5000
    assert_same_topk(got, _resident(items, items[:1], 10))
    assert_same_topk(got, jtopk.topk_streaming(items, items[0], 10))


def test_query_chunking_matches():
    # several query chunks against several blocks, with both filter kinds
    # crossing chunk and block boundaries
    items, queries = _data(n_items=500, q=70, seed=9)
    rng = np.random.default_rng(10)
    qf = sparse_random(70, 500, density=0.04, random_state=rng, format="csr")
    qf.data[:] = 1.0
    fi = rng.choice(500, size=25, replace=False)
    kw = dict(filter_query_items=qf, filter_items=fi)
    got = _stream(items, queries, 7, block_rows=128, q_chunk_rows=16, **kw)
    assert_same_topk(got, _resident(items, queries, 7, **kw))
    assert_same_topk(got, jtopk.topk_streaming(items, queries, 7, block_rows=128,
                                               q_chunk_rows=16, **kw))


def test_all_items_filtered_parity_semantics():
    # every candidate filtered: like the resident top-k, filtered real ids
    # still round out the results at -FLT_MAX (never -1 pad sentinels); each
    # block returns k real candidates even when it is smaller than k
    items, queries = _data(n_items=60, q=4, seed=11)
    fi = np.arange(60)
    ids, vals = _stream(items, queries, 10, block_rows=8, filter_items=fi)
    assert (ids >= 0).all() and (vals == NEG_MAX).all()
    for row in ids:
        assert len(set(row.tolist())) == 10
    jids, jvals = jtopk.topk_streaming(items, queries, 10, block_rows=16, filter_items=fi)
    assert (jids >= 0).all() and (jvals == vals).all()


def _models(users=90, items_n=120, f=16, seed=12):
    """The same factors in a JAX, a resident port and a port ALS model."""
    from implicit_tpu.als import AlternatingLeastSquares as JaxALS
    from implicit_tpu_torch.als import AlternatingLeastSquares

    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((users, f)).astype(np.float32)
    itf = rng.standard_normal((items_n, f)).astype(np.float32)
    likes = sparse_random(users, items_n, density=0.1, random_state=rng, format="csr")
    likes.data[:] = 1.0
    out = []
    for model in (JaxALS(factors=f), AlternatingLeastSquares(factors=f, device="cpu"),
                  AlternatingLeastSquares(factors=f, device="cpu")):
        model.user_factors, model.item_factors = uf.copy(), itf.copy()
        out.append(model)
    return out, likes


def test_model_auto_streams_beyond_budget(monkeypatch):
    """A model whose factor tables are over the residency threshold serves
    through topk_streaming: the resident results, the JAX package's, and
    the device copies never made."""
    from implicit_tpu_torch.models import mf_base

    (jax_model, resident, streaming), likes = _models()
    userids = np.arange(40)
    calls = [
        lambda m: m.recommend(userids, likes[userids], N=8),
        lambda m: m.similar_items(np.arange(20), N=6),
        lambda m: m.similar_users(np.arange(15), N=5),
        lambda m: m.recommend(userids[:5], likes[userids[:5]], N=4,
                              items=np.arange(0, 120, 3)),
        lambda m: m.similar_items(7, N=6, filter_items=[1, 2]),
    ]
    want = [call(resident) for call in calls]
    want_jax = [call(jax_model) for call in calls]
    monkeypatch.setattr(mf_base, "_stream_threshold_bytes", lambda device: 1024)
    streams = []
    real = mf_base.topk_streaming
    monkeypatch.setattr(mf_base, "topk_streaming",
                        lambda *a, **kw: streams.append(1) or real(*a, **kw))
    for call, w, wj in zip(calls, want, want_jax):
        got = call(streaming)
        assert_same_topk(got, w, rtol=1e-5)
        assert_same_topk(got, wj, rtol=1e-5)
    assert len(streams) == len(calls)
    assert streaming._item_factors_dev is None and streaming._user_factors_dev is None

    # the pipelined generator takes the streaming path too
    batches = [np.arange(0, 20), np.arange(20, 40)]
    out = list(streaming.recommend_pipelined(((b, likes[b]) for b in batches), N=8))
    np.testing.assert_array_equal(np.concatenate([i for i, _ in out]), want[0][0])
    assert streaming._item_factors_dev is None


def _count_passes(monkeypatch, mf_base):
    """Counts topk_streaming calls and the blocks they read from the host."""
    calls, blocks = [], []
    real_stream, real_block = mf_base.topk_streaming, ttopk._host_block
    monkeypatch.setattr(mf_base, "topk_streaming",
                        lambda *a, **kw: calls.append(1) or real_stream(*a, **kw))
    monkeypatch.setattr(ttopk, "_host_block",
                        lambda *a: blocks.append(a[1]) or real_block(*a))
    return calls, blocks


def test_streaming_pipelined_one_pass(monkeypatch):
    """Over a streaming table the pipelined generators serve the whole
    stream in one pass: one topk_streaming call that reads each block of
    the table once (not one pass per batch), with the per-batch results and
    the JAX package's."""
    from implicit_tpu.als import AlternatingLeastSquares as JaxALS
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.models import mf_base

    rng = np.random.default_rng(13)
    users, items_n, f = 60, 5000, 8
    likes = sparse_random(users, items_n, density=0.01, random_state=rng, format="csr")
    likes.data[:] = 1.0
    model = AlternatingLeastSquares(factors=f, device="cpu")
    jmodel = JaxALS(factors=f)
    model.user_factors = jmodel.user_factors = rng.standard_normal((users, f)).astype(
        np.float32)
    model.item_factors = jmodel.item_factors = rng.standard_normal((items_n, f)).astype(
        np.float32)

    # blocks of 1024 rows: 5 per pass over the 5000 items
    monkeypatch.setattr(ttopk, "_MAX_SCORE_ELEMENTS_CPU", 1024 * f)
    monkeypatch.setattr(mf_base, "_stream_threshold_bytes", lambda device: 512)
    calls, blocks = _count_passes(monkeypatch, mf_base)

    batches = [np.arange(0, 20), np.arange(20, 40), np.arange(40, 60)]
    out = list(model.recommend_pipelined(((b, likes[b]) for b in batches), N=6))
    assert len(calls) == 1, "the pipelined stream must make one table pass"
    assert sorted(blocks) == [0, 1024, 2048, 3072, 4096]
    want = jmodel.recommend_pipelined(((b, likes[b]) for b in batches), N=6)
    for b, got, w in zip(batches, out, want):
        assert_same_topk(got, model.recommend(b, likes[b], N=6))
        assert_same_topk(got, w, rtol=1e-5)

    calls.clear(), blocks.clear()
    sim_batches = [np.arange(0, 10), np.arange(10, 20)]
    sim_out = list(model.similar_items_pipelined(sim_batches, N=5))
    assert len(calls) == 1 and len(blocks) == 5
    want = jmodel.similar_items_pipelined(sim_batches, N=5)
    for b, got, w in zip(sim_batches, sim_out, want):
        assert_same_topk(got, model.similar_items(b, N=5), rtol=1e-5)
        assert_same_topk(got, w, rtol=1e-5)

    calls.clear(), blocks.clear()
    su_out = list(model.similar_users_pipelined([np.arange(0, 8)], N=4))
    assert len(calls) == 1  # the user table (60 rows) is one block
    assert_same_topk(su_out[0], model.similar_users(np.arange(8), N=4), rtol=1e-5)


def test_streaming_pipelined_bounded_passes(monkeypatch):
    """Big streams buffer in bounded groups: more than one table pass, far
    fewer than one per batch; scalar userids with recalculate_user work."""
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.models import mf_base

    rng = np.random.default_rng(14)
    users, items_n, f = 48, 64, 8
    likes = sparse_random(users, items_n, density=0.2, random_state=rng, format="csr")
    likes.data[:] = 1.0
    model = AlternatingLeastSquares(factors=f, regularization=0.1, random_state=3,
                                    device="cpu")
    model.fit(likes, show_progress=False)

    monkeypatch.setattr(mf_base, "_stream_threshold_bytes", lambda device: 256)
    monkeypatch.setattr(mf_base, "_STREAM_PASS_ROWS", 20)
    calls, _ = _count_passes(monkeypatch, mf_base)

    batches = [np.arange(s, s + 8) for s in range(0, 48, 8)]  # 6 batches
    out = list(model.recommend_pipelined(((b, likes[b]) for b in batches), N=6))
    assert len(calls) == 2  # two groups of 24 rows (3 batches each)
    for b, got in zip(batches, out):
        assert_same_topk(got, model.recommend(b, likes[b], N=6))

    out2 = list(model.recommend_pipelined(((int(u), likes[u]) for u in range(5)), N=4,
                                          recalculate_user=True))
    for u, (ids, scores) in enumerate(out2):
        assert ids.shape == (4,)
        assert_same_topk((ids, scores), model.recommend(int(u), likes[u], N=4,
                                                        recalculate_user=True), rtol=1e-5)
