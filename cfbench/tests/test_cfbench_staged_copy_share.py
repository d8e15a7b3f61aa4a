"""``fit.staged_copy_share`` on spans made by hand: the staged bytes over
all bytes copied back in the profiled fits' ``fit`` roots; None on a program
whose fits count neither (one without the counters)."""

import pytest

from cfbench.tests.test_cfbench_program_spans import (FIT_DEVICE, FIT_HOST, _fit_spans, _read,
                                                      _run, _span)


def _with_root_counts(counts):
    spans = _fit_spans()
    root = next(s for s in spans if s["id"] == 1)
    root["counts"] = dict(root["counts"], **counts)
    return spans


@pytest.mark.parametrize("counts,share", [
    ({"copy_back.staged_bytes": 333_426_944}, 1.0),
    ({"copy_back.staged_bytes": 300, "copy_back.plain_bytes": 100}, 0.75),
    ({"copy_back.plain_bytes": 4096}, 0.0),
    ({}, None),
])
def test_staged_copy_share(monkeypatch, counts, share):
    run = _run(_with_root_counts(counts), FIT_HOST, FIT_DEVICE, monkeypatch)
    assert _read("fit.staged_copy_share", run) == share


def test_fits_outside_the_window_do_not_count(monkeypatch):
    spans = _with_root_counts({"copy_back.staged_bytes": 1000})
    spans.append(_span(30, "fit", -3 * 10**9, -2 * 10**9, counts={"copy_back.plain_bytes": 1000}))
    run = _run(spans, FIT_HOST, FIT_DEVICE, monkeypatch)
    assert _read("fit.staged_copy_share", run) == 1.0
