"""The readers of the program's own spans and counters, on spans made by hand
(``implicit_tpu_torch.tracing.spans`` replaced) and a trace made by hand
(nanoseconds on one clock); each finds nothing on a program without the
tracing module."""

import sys

import pytest
import torch

import implicit_tpu_torch
from cfbench.lib import harness
from cfbench.lib.trace import PREFIX, Trace
from cfbench.tests.tiny import REPO
from implicit_tpu_torch import tracing

FIT_READERS = ("fit.setup_host_s", "fit.setup_idle_s", "fit.iter_device_s",
               "solve.launches_per_iter")
SERVE_READERS = ("serve.dispatch_ms", "serve.mem_queries")


def _span(id, name, start, end, parent=None, root=None, device_s=None, counts=None, **attrs):
    return dict(name=name, id=id, parent=parent, root=root or (id if parent is None else None),
                attrs=attrs, start_ns=start, end_ns=end, device_s=device_s, counts=counts or {})


def _fit_spans():
    stage = {"stage": "fit set-up"}
    kids = [
        _span(2, "prepare", 110, 150, 1, 1, **stage),
        _span(3, "upload", 150, 200, 1, 1, **stage),
        _span(4, "factor draw", 200, 400, 1, 1, **stage),
        _span(5, "iteration", 400, 600, 1, 1, device_s=1.5e-4, iteration=0,
              counts={"launches.cg_full_f32": 10, "launches.gramian_cg_f32": 2}),
        _span(7, "iteration", 600, 800, 1, 1, device_s=1.7e-4, iteration=1,
              counts={"launches.cg_full_f32": 9, "launches.gramian_cg_f32": 3,
                      "device.mem_queries": 1}),
        _span(8, "copy back", 800, 1000, 1, 1, **stage),
    ]
    # a fit of an earlier window in the same process, outside this one's
    stale = [_span(20, "fit", -5 * 10**9, -4 * 10**9),
             _span(21, "prepare", -5 * 10**9, -4 * 10**9, 20, 20, **stage)]
    return stale + [_span(1, "fit", 100, 1100, counts={"launches.cg_full_f32": 19})] + kids


FIT_HOST = [(90, 1110, PREFIX + "fit")]
# busy: 20 ns in prepare, 30 in upload and the draw, the iterations, 50 in the copy back
FIT_DEVICE = [(120, 140, "k"), (180, 210, "copy"), (420, 780, "cg"), (800, 850, "copy")]


def _serve_spans():
    out = []
    for j, (start, topk, dispatch_end, queries) in enumerate([(100, 300, 400, 3),
                                                               (1100, 1250, 1300, 3)]):
        root = 10 * (j + 1)
        out += [_span(root, "recommend", start, start + 800, users=1024, N=10,
                      counts={"device.mem_queries": queries}),
                _span(root + 1, "validate", start + 10, start + 20, root, root),
                _span(root + 2, "user rows", start + 20, start + 90, root, root),
                _span(root + 3, "dispatch", start + 90, dispatch_end, root, root),
                _span(root + 4, "topk", topk, dispatch_end, root + 3, root),
                _span(root + 5, "wait", dispatch_end, start + 700, root, root),
                _span(root + 6, "post", start + 700, start + 790, root, root)]
    return out


SERVE_HOST = [(95, 905, PREFIX + "request"), (1095, 1905, PREFIX + "request")]


def _run(spans, host, device, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [dict(s) for s in spans])
    run = harness.Run("cell", {}, {}, 1, 1.0, True, torch.device("cpu"), lambda msg: None)
    run.trace = Trace.from_events(device, host)
    return run


def _read(name, run):
    return harness.Spec(REPO).reader(name)(run)


def test_fit_readers(monkeypatch):
    run = _run(_fit_spans(), FIT_HOST, FIT_DEVICE, monkeypatch)
    assert _read("fit.setup_host_s", run) == pytest.approx((40 + 50 + 200 + 200) / 1e9)
    # the steps cover 110-400 and 800-1000: 490 ns, 20 + 30 + 50 of them busy
    assert _read("fit.setup_idle_s", run) == pytest.approx(390 / 1e9)
    assert _read("fit.iter_device_s", run) == pytest.approx(3.2e-4)
    assert _read("solve.launches_per_iter", run) == (12 + 12) / 2
    for name in SERVE_READERS:
        assert _read(name, run) is None


def test_serve_readers(monkeypatch):
    run = _run(_serve_spans(), SERVE_HOST, [(150, 300, "gemm")], monkeypatch)
    # the serving layer's part: each request's start to its top-k's start
    assert _read("serve.dispatch_ms", run) == pytest.approx((200 + 150) / 2 / 1e6)
    assert _read("serve.mem_queries", run) == 3.0
    for name in FIT_READERS:
        assert _read(name, run) is None


def test_device_seconds_need_every_iteration_timed(monkeypatch):
    spans = _fit_spans()
    spans[-2]["device_s"] = None  # a fit on the CPU: no CUDA events
    assert _read("fit.iter_device_s", _run(spans, FIT_HOST, FIT_DEVICE, monkeypatch)) is None


@pytest.mark.parametrize("name", FIT_READERS + SERVE_READERS)
def test_nothing_to_read_without_the_tracing_module(name, monkeypatch):
    """On a program without ``implicit_tpu_torch.tracing`` each reader gives
    None and raises nothing."""
    spans, host = (_fit_spans(), FIT_HOST) if name in FIT_READERS else (_serve_spans(),
                                                                         SERVE_HOST)
    run = _run(spans, host, FIT_DEVICE, monkeypatch)
    assert _read(name, run) is not None
    monkeypatch.delattr(implicit_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "implicit_tpu_torch.tracing", None)
    assert _read(name, run) is None


@pytest.mark.parametrize("name", FIT_READERS + SERVE_READERS)
def test_nothing_to_read_in_an_untraced_run(name, monkeypatch):
    run = _run(_fit_spans() + _serve_spans(), FIT_HOST, FIT_DEVICE, monkeypatch)
    run.trace = None
    assert _read(name, run) is None


def test_each_reader_has_its_entry():
    bench = harness.Spec(REPO).bench
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {"fit_s": ["als_lastfm360k_f128.fit", "als_ml20m_f256.fit"],
             "recommend_users_per_s": ["als_lastfm360k_f128.serve_bulk"]}
    for name in FIT_READERS + SERVE_READERS:
        m = entries[name]
        assert m["workloads"] == cells[m["moves"]]
