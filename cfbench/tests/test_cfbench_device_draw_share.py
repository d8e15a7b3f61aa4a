"""``fit.device_draw_share`` on spans made by hand: the device draws over
all draws in the profiled fits' ``fit`` roots; None on a program whose
fits count neither (one without the counters)."""

import pytest

from cfbench.tests.test_cfbench_program_spans import (FIT_DEVICE, FIT_HOST, _fit_spans, _read,
                                                      _run, _span)


def _with_root_counts(counts):
    spans = _fit_spans()
    root = next(s for s in spans if s["id"] == 1)
    root["counts"] = dict(root["counts"], **counts)
    return spans


@pytest.mark.parametrize("counts,share", [
    ({"init.device_draws": 2}, 1.0),
    ({"init.device_draws": 1, "init.host_draws": 1}, 0.5),
    ({"init.host_draws": 2}, 0.0),
    ({}, None),
])
def test_device_draw_share(monkeypatch, counts, share):
    run = _run(_with_root_counts(counts), FIT_HOST, FIT_DEVICE, monkeypatch)
    assert _read("fit.device_draw_share", run) == share


def test_fits_outside_the_window_do_not_count(monkeypatch):
    spans = _with_root_counts({"init.device_draws": 2})
    spans.append(_span(30, "fit", -3 * 10**9, -2 * 10**9, counts={"init.host_draws": 2}))
    run = _run(spans, FIT_HOST, FIT_DEVICE, monkeypatch)
    assert _read("fit.device_draw_share", run) == 1.0
