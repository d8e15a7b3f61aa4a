"""The port's spans and counters (``implicit_tpu_torch.tracing``) on the CPU.

Spans are recorded only while a ``torch.profiler`` session records: the
trees of an ALS fit, a BPR fit and ``recommend`` under a CPU profiler,
their place on the profiler's clock, nothing with the profiler off, the
bounded buffer. Counters always count: kernel launches
(``ops.cg_kernels.LAUNCHES``), BPR's grouped chunks and scatters and the
free-memory queries of the top-k's budget.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from implicit_tpu_torch import tracing
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
from implicit_tpu_torch.datasets.synthetic import generate_synthetic
from implicit_tpu_torch.models import bpr
from implicit_tpu_torch.ops import bpr_update, cg_kernels, topk
from implicit_tpu_torch.ops.topk import _score_budget_elements

torch.set_num_threads(2)

PLAYS = generate_synthetic(300, 200, 6000, seed=8)


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _fit(iterations=2, **kw):
    model = AlternatingLeastSquares(factors=8, iterations=iterations, random_state=4,
                                    device="cpu", **kw)
    model.fit(PLAYS, show_progress=False)
    return model


def _under(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


FIT_STEPS = ["prepare", "upload", "transpose", "plan user side", "plan item side",
             "pack user side", "pack item side", "factor draw", "factor init",
             "factor draw", "factor init", "copy back"]


@pytest.mark.parametrize("ingest", ["auto", "device", "host"])
def test_fit_span_tree(ingest):
    """One root ``fit``; its set-up steps in the order they run (the order
    ``test_set_up_steps_are_logged`` reads from the debug lines), the same
    whatever ``ingest`` says, one ``iteration`` span per iteration between
    them and the copy back; every span carries the root's id."""
    steps = FIT_STEPS
    with _profiled():
        _fit(iterations=3, ingest=ingest)
    spans = tracing.spans()
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["fit"]
    root = roots[0]
    assert root["attrs"] == dict(factors=8, iterations=3, users=300, items=200, nnz=PLAYS.nnz)
    assert all(s["root"] == root["id"] for s in spans)
    children = _under(spans, root)
    assert [c["name"] for c in children] == steps[:-1] + ["iteration"] * 3 + steps[-1:]
    assert all(c["attrs"] == {"stage": "fit set-up"} for c in children
               if c["name"] != "iteration")
    iterations = [c for c in children if c["name"] == "iteration"]
    assert [c["attrs"]["iteration"] for c in iterations] == [0, 1, 2]
    assert all(not _under(spans, it) for it in iterations)
    starts = [c["start_ns"] for c in children]
    assert starts == sorted(starts)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(children, children[1:]))
    assert all(s["start_ns"] <= s["end_ns"] and s["device_s"] is None for s in spans)


def test_meshed_fit_span_tree():
    """The meshed loop: its set-up steps and its iterations over the
    shards, under one root."""
    with _profiled():
        _fit(iterations=2, mesh=2)
    spans = tracing.spans()
    root, = [s for s in spans if s["parent"] is None]
    names = [c["name"] for c in _under(spans, root)]
    assert names == ["prepare", "transpose", "sharded pack user side", "sharded pack item side",
                     "factor draw", "factor init", "factor draw", "factor init",
                     "permute and upload", "iteration", "iteration", "copy back"]
    assert all(s["root"] == root["id"] for s in spans)
    its = [c for c in _under(spans, root) if c["name"] == "iteration"]
    assert [c["attrs"]["iteration"] for c in its] == [0, 1]


BPR_STEPS = ["prepare", "factor draw", "pair table", "upload"]


@pytest.mark.parametrize("epoch_mode", ["grouped", "sampled"])
def test_bpr_fit_span_tree(epoch_mode):
    """BPR's fit: one root ``fit``, its set-up steps, one ``iteration`` per
    epoch (CPU: no device seconds) and the copy back; a grouped epoch holds
    one ``scatter`` per chunk and counts ``bpr.chunk_steps`` (chunks x
    epochs) and no ``bpr.scatter_calls`` (its item updates go through
    ``ops.bpr_update``; on the CPU its plain version, no launch), the
    sampled epoch neither. With the profiler off the counters still count
    and no span is recorded."""
    grouped = epoch_mode == "grouped"
    n_chunks = sum(rows.shape[0] for rows, *_ in bpr.grouped_classes(PLAYS, "cpu"))

    def fit():
        BayesianPersonalizedRanking(factors=8, iterations=3, random_state=4, device="cpu",
                                    epoch_mode=epoch_mode).fit(PLAYS, show_progress=False)

    before = tracing.counters()
    with _profiled():
        fit()
    moved = {k: v - before[k] for k, v in tracing.counters().items() if k.startswith("bpr.")}
    assert moved == ({"bpr.chunk_steps": 3 * n_chunks, "bpr.scatter_calls": 0}
                     if grouped else {"bpr.chunk_steps": 0, "bpr.scatter_calls": 0})
    assert tracing.counters()["launches.bpr_item_update"] == before["launches.bpr_item_update"]
    spans = tracing.spans()
    root, = [s for s in spans if s["parent"] is None]
    assert root["name"] == "fit" and root["counts"] == {k: v for k, v in moved.items() if v}
    assert root["attrs"] == dict(family="bpr", factors=8, iterations=3, users=300, items=200,
                                 nnz=PLAYS.nnz)
    assert all(s["root"] == root["id"] for s in spans)
    children = _under(spans, root)
    assert [c["name"] for c in children] == (
        BPR_STEPS + ["chunks"] * grouped + ["iteration"] * 3 + ["copy back"])
    assert all(c["attrs"] == {"stage": "fit set-up"} for c in children
               if c["name"] != "iteration")
    its = [c for c in children if c["name"] == "iteration"]
    for k, it in enumerate(its):
        attrs = it["attrs"]
        if grouped:
            assert attrs == dict(iteration=k, chunks=n_chunks, entries=PLAYS.nnz)
        else:  # equal minibatches, at least nnz samples
            assert attrs["iteration"] == k and attrs["entries"] >= PLAYS.nnz
            assert attrs["entries"] % attrs["chunks"] == 0
        scatters = _under(spans, it)
        assert [s["name"] for s in scatters] == ["scatter"] * (n_chunks if grouped else 0)
        assert all(s["counts"] == {} for s in scatters)
    tracing.clear()
    fit()
    assert tracing.spans() == []
    assert tracing.counters()["bpr.chunk_steps"] - before["bpr.chunk_steps"] == (
        6 * n_chunks if grouped else 0)


def test_nothing_is_recorded_with_the_profiler_off():
    model = _fit()
    model.recommend(np.arange(5), PLAYS[np.arange(5)], N=3)
    assert tracing.spans() == []
    assert tracing.span("x", torch.device("cpu"), a=1) is tracing.OFF
    with tracing.span("x") as s:
        s.set(b=2)  # the off span takes attrs and keeps none
    assert tracing.spans() == []


def test_spans_lie_on_the_profilers_clock():
    """A program span lies inside a ``record_function`` opened around the
    call, on the profiler's own event times, within 1 ms at each end."""
    with _profiled() as prof:
        with record_function("outer"):
            _fit(iterations=1)
    outer, = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    spans = tracing.spans()
    assert spans
    for s in spans:
        assert s["start_ns"] >= outer.start_ns() - 1_000_000
        assert s["end_ns"] <= outer.end_ns() + 1_000_000


def test_recommend_span_tree():
    model = _fit()
    users = np.arange(10)
    with _profiled():
        model.recommend(users, PLAYS[users], N=5)
    spans = tracing.spans()
    root, = [s for s in spans if s["parent"] is None]
    assert root["name"] == "recommend" and root["attrs"] == dict(users=10, N=5)
    children = _under(spans, root)
    assert [c["name"] for c in children] == ["validate", "user rows", "dispatch", "wait", "post"]
    dispatch = children[2]
    topk, = _under(spans, dispatch)
    assert topk["name"] == "topk"
    assert dispatch["start_ns"] <= topk["start_ns"] <= topk["end_ns"] <= dispatch["end_ns"]
    assert all(s["root"] == root["id"] for s in spans)


def test_pipelined_batches_each_have_a_root():
    """recommend_pipelined: each batch's own root holds its checks and
    dispatch, and its wait and post, which run after later batches were
    dispatched."""
    model = _fit()
    batches = [np.arange(4), np.arange(4, 8), np.arange(8, 12)]
    with _profiled():
        got = list(model.recommend_pipelined([(b, PLAYS[b]) for b in batches], N=3,
                                             max_in_flight=3))
    assert len(got) == 3
    spans = tracing.spans()
    roots = [s for s in spans if s["parent"] is None]
    assert [(r["name"], r["attrs"]["users"]) for r in roots] == [("recommend", 4)] * 3
    for root in roots:
        assert [c["name"] for c in _under(spans, root)] == [
            "validate", "user rows", "dispatch", "wait", "post"]
        assert all(s["root"] == root["id"] for s in spans if s["parent"] == root["id"])
    first_wait, = [s for s in _under(spans, roots[0]) if s["name"] == "wait"]
    last_dispatch, = [s for s in _under(spans, roots[2]) if s["name"] == "dispatch"]
    assert first_wait["start_ns"] >= last_dispatch["end_ns"]
    assert first_wait["start_ns"] >= roots[0]["end_ns"]


def test_launches_are_the_kernels_own_counts(monkeypatch):
    """``launches.<entry>`` reads ``cg_kernels.LAUNCHES``, the top-k's
    ``topk.LAUNCHES`` and BPR's item update's ``bpr_update.LAUNCHES``
    themselves, reset and all, and a span counts the launches inside it."""
    for group in (cg_kernels.LAUNCHES, topk.LAUNCHES, bpr_update.LAUNCHES):
        for name in group:
            monkeypatch.setitem(group, name, group[name])
    cg_kernels.reset_launches()
    topk.LAUNCHES["topk_select"] = 0
    bpr_update.LAUNCHES["bpr_item_update"] = 0
    counts = tracing.counters()
    assert {k for k in counts if k.startswith("launches.")} == {
        f"launches.{k}" for k in (*cg_kernels.LAUNCHES, "topk_select", "bpr_item_update")}
    assert not any(counts[k] for k in counts if k.startswith("launches."))
    with _profiled():
        with tracing.span("solves"):
            cg_kernels.LAUNCHES["cg_full_f32"] += 3
            cg_kernels.LAUNCHES["cg_update"] += 1
            topk.LAUNCHES["topk_select"] += 2
            bpr_update.LAUNCHES["bpr_item_update"] += 4
    assert tracing.counters()["launches.cg_full_f32"] == 3
    span, = tracing.spans()
    assert span["counts"] == {"launches.cg_full_f32": 3, "launches.cg_update": 1,
                              "launches.topk_select": 2, "launches.bpr_item_update": 4}


def test_each_free_memory_query_is_counted(monkeypatch):
    """One ``device.mem_queries`` per ``torch.cuda.mem_get_info`` call of the
    top-k's budget (a CUDA device faked), none for the CPU."""
    asked = []

    def mem_get_info(device):
        asked.append(device)
        return 16 << 30, 80 << 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    cuda = torch.device("cuda", 0)
    before = tracing.counters()["device.mem_queries"]
    with _profiled():
        with tracing.span("budget"):
            for _ in range(3):
                assert _score_budget_elements(cuda) == (4 << 30) // 4
    _score_budget_elements(torch.device("cpu"))
    assert len(asked) == 3
    assert tracing.counters()["device.mem_queries"] == before + 3
    span, = tracing.spans()
    assert span["counts"] == {"device.mem_queries": 3}


def test_the_buffer_is_bounded(monkeypatch):
    """A full buffer drops its oldest spans, so a second profile in the same
    process still records; ``tracing.dropped`` counts them."""
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    for session in range(2):
        with _profiled():
            for k in range(5):
                with tracing.span(f"{session}.{k}"):
                    pass
    assert [s["name"] for s in tracing.spans()] == ["1.2", "1.3", "1.4"]
    assert tracing.counters()["tracing.dropped"] == 7
    tracing.clear()
    assert tracing.spans() == [] and tracing.counters()["tracing.dropped"] == 0


def test_explicit_parent_and_late_attrs():
    """``parent=`` hangs a span under one already closed; ``set`` adds attrs
    inside the block."""
    with _profiled():
        with tracing.span("batch", users=2) as batch:
            batch.set(N=4)
        with tracing.span("other"):
            with tracing.span("wait", parent=batch):
                pass
    batch_s, other, wait = tracing.spans()
    assert batch_s["attrs"] == dict(users=2, N=4)
    assert (wait["parent"], wait["root"]) == (batch_s["id"], batch_s["id"])
    assert other["parent"] is None and other["root"] == other["id"]
