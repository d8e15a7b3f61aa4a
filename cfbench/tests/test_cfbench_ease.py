"""The EASE cell's pieces: its counts against shapes worked by hand, the
cell found by name and judged correct at the tiny size, and its per-layer
readers on spans made by hand (``implicit_tpu_torch.tracing.spans``
replaced), each finding nothing on a program without the fit's steps."""

import sys

import pytest
import torch

import implicit_tpu_torch
from cfbench.lib import counts_ease, harness, peaks
from cfbench.lib.trace import PREFIX, Trace
from cfbench.tests.tiny import REPO, run, tiny_spec
from implicit_tpu_torch import tracing

CELL = "ease_ml20m_k100.fit"
READERS = ("ease.gramian_roofline", "ease.solve_roofline", "ease.topk_roofline")
H100 = peaks.PEAKS["H100"]


def test_counts_by_hand():
    sh = dict(users=10, users_nonempty=8, items=5, nnz=20)
    assert counts_ease.gramian_ops(sh) == 2 * 20 * 20 / 8
    # int32 row pointers, int32 ids and float32 values, S in float32
    assert counts_ease.gramian_bytes(sh) == 11 * 4 + 20 * 8 + 25 * 4
    assert counts_ease.solve_ops(sh) == 125
    assert counts_ease.solve_bytes(sh) == 100
    assert counts_ease.topk_bytes(sh, 3) == 100 + 5 * 3 * 8
    assert counts_ease.topk_bytes(sh, 9) == 100 + 5 * 5 * 8  # K past the items


def test_counts_at_the_cells_shape():
    """At ML-20M's shape (about 10.0M entries) the gramian's bytes, 2.94e9,
    bound it far above its products; the solve is bound by its n^3."""
    sh = dict(users=138_493, users_nonempty=138_493, items=26_744, nnz=10_000_000)
    assert counts_ease.gramian_bytes(sh) == pytest.approx(2.9416e9, rel=1e-4)
    least = counts_ease.least_times(H100, sh, 100)
    assert least["gramian"] == counts_ease.gramian_bytes(sh) / 3.35e12
    assert least["solve"] == 26_744 ** 3 / 495e12
    assert least["topk"] == (26_744 ** 2 * 4 + 26_744 * 100 * 8) / 3.35e12


def test_the_cell_runs_and_is_correct(tmp_path):
    spec = tiny_spec(tmp_path)
    assert spec.config(spec.cell(CELL)["config"])["family"] == "ease"
    res = run(spec, CELL, seed=2**40 + 3, seconds=0.3)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"weights_rel_fro", "weights_max_gap", "value_gap", "rank_gap",
                                  "count_gap", "diag_gap", "bad_ids"}
    assert {"fit_s", "setup_s"} <= set(res["metrics"])
    res = run(spec, CELL, seed=5, seconds=0.3, trace=True)
    assert res["correct"], res["checks"]
    assert {"fit.setup_host_s", "fit.setup_idle_s", "device_idle.fit"} <= set(res["metrics"])


def _span(id, name, start, end, parent=None, device_s=None, **attrs):
    return dict(name=name, id=id, parent=parent, root=1 if parent else id, attrs=attrs,
                start_ns=start, end_ns=end, device_s=device_s, counts={})


def _fit_spans():
    set_up, model = {"stage": "fit set-up"}, {"stage": "model step"}
    return [_span(1, "fit", 100, 1100, family="ease"),
            _span(2, "prepare", 110, 150, 1, **set_up),
            _span(3, "upload", 150, 200, 1, **set_up),
            _span(4, "gramian", 200, 300, 1, device_s=3.7, **model),
            _span(5, "cholesky", 300, 400, 1, device_s=0.25, **model),
            _span(6, "inverse", 400, 500, 1, device_s=1.0, **model),
            _span(7, "weights", 500, 600, 1, device_s=0.05, **model),
            _span(8, "top-k", 600, 700, 1, device_s=0.25, **model),
            _span(9, "copy back", 700, 1000, 1, **set_up)]


def _parents_spans():
    """The parent program's EASE fit: each step a root of its own."""
    out = []
    for k, name in enumerate(("gramian", "cholesky", "inverse", "weights", "top-k")):
        out.append(_span(k + 1, name, 100 + 100 * k, 200 + 100 * k, device_s=0.5,
                         stage="item-item fit"))
    return out


SHAPE = dict(users=138_493, users_nonempty=138_493, items=26_744, nnz=10_000_000,
             factors=0, iterations=1, dtype="float32")


def _run(spans, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [dict(s) for s in spans])
    r = harness.Run(CELL, {"params": {"K": 100}}, {}, 1, 1.0, True, torch.device("cpu"),
                    lambda msg: None)
    r.peaks, r.shape = H100, SHAPE
    r.record = dict(kind="fit", walls=[5.0, 5.5], window_s=10.5, iter_secs=[[], []])
    r.trace = Trace.from_events([(210, 290, "gemm")], [(90, 1110, PREFIX + "fit")])
    return r


def _read(name, r):
    return harness.Spec(REPO).reader(name)(r)


def test_readers(monkeypatch):
    r = _run(_fit_spans(), monkeypatch)
    least = counts_ease.least_times(H100, SHAPE, 100)
    assert _read("ease.gramian_roofline", r) == pytest.approx(100 * least["gramian"] / 3.7)
    assert _read("ease.solve_roofline", r) == pytest.approx(100 * least["solve"] / 1.3)
    assert _read("ease.topk_roofline", r) == pytest.approx(100 * least["topk"] / 0.25)
    assert _read("mfu.ease_fit", r) == pytest.approx(100 * sum(least.values()) / 5.25)
    # the set-up steps' host seconds, and the card idle in all of them
    assert _read("fit.setup_host_s", r) == pytest.approx((40 + 50 + 300) / 1e9)
    assert _read("fit.setup_idle_s", r) == pytest.approx((40 + 50 + 300) / 1e9)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_on_the_parents_program(name, monkeypatch):
    """The steps as roots of their own (no ``fit`` root), a step without
    device seconds, no tracing module, an untraced run: None each time,
    and nothing raised."""
    assert _read(name, _run(_parents_spans(), monkeypatch)) is None
    spans = _fit_spans()
    for s in spans:
        s["device_s"] = None  # a fit on the CPU: no CUDA events
    assert _read(name, _run(spans, monkeypatch)) is None
    r = _run(_fit_spans(), monkeypatch)
    assert _read(name, r) is not None
    r.trace = None
    assert _read(name, r) is None
    r = _run(_fit_spans(), monkeypatch)
    monkeypatch.delattr(implicit_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "implicit_tpu_torch.tracing", None)
    assert _read(name, r) is None


def test_the_fit_share_needs_only_walls(monkeypatch):
    """``mfu.ease_fit`` reads the window's walls and the shapes: it reads
    the parent's fits too, and nothing on a card the peaks table lacks."""
    r = _run(_parents_spans(), monkeypatch)
    assert _read("mfu.ease_fit", r) is not None
    r.peaks = None
    assert _read("mfu.ease_fit", r) is None
