"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (one card: no exchange between cards to
leave out). The harness's look for a card is skipped; the rest of a run
is driven on the CPU at a tiny size, against each cell's own limits."""

import contextlib

import numpy as np
import pytest

import implicit_tpu_torch.models.mf_base as mf_base
import implicit_tpu_torch.ops.als as ops_als
from cfbench.tests.tiny import FIT_CELLS, SERVE_CELLS, run, tiny_spec


@contextlib.contextmanager
def patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def unchanged(orig):
    """A solve that returns its state unchanged."""
    return lambda X, *args, **kw: X


def half_rows(orig):
    """A solve that leaves half of the rows out."""
    def solve(X, *args, **kw):
        keep = X[X.shape[0] // 2:].clone()
        out = orig(X, *args, **kw)
        out[out.shape[0] // 2:] = keep
        return out
    return solve


def altered_answer(orig):
    """Every solve's first row altered where it is produced."""
    def solve(X, *args, **kw):
        out = orig(X, *args, **kw)
        out[0] += 0.5
        return out
    return solve


class _Altered:
    def __init__(self, future, how):
        self.future, self.how = future, how

    def result(self):
        ids, scores = self.future.result()
        ids, scores = ids.copy(), scores.copy()
        self.how(ids, scores)
        return ids, scores


def serve_fault(how):
    def make(orig):
        def topk_async(*args, **kwargs):
            return _Altered(orig(*args, **kwargs), how)
        return topk_async
    return make


def one_id(ids, scores):
    """One answer altered where it is produced: the first id moved on."""
    ids[0, 0] = (ids[0, 0] + 1) % 1500


def half_batch(ids, scores):
    """Half of the batch left out: its rows answered with the first row's."""
    n = ids.shape[0]
    if n > 1:
        ids[n // 2:] = ids[0]
        scores[n // 2:] = scores[0]
    else:
        ids[0] = ids[0, ::-1]


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_sound_fit_is_correct(tmp_path, cell):
    assert run(tiny_spec(tmp_path), cell)["correct"]


@pytest.mark.parametrize("fault", [unchanged, half_rows, altered_answer])
@pytest.mark.parametrize("cell", FIT_CELLS)
def test_fit_fault_is_caught(tmp_path, cell, fault):
    spec = tiny_spec(tmp_path)
    with patched(ops_als, "solve_side", fault):
        res = run(spec, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_sound_serve_is_correct(tmp_path, cell):
    assert run(tiny_spec(tmp_path), cell)["correct"]


@pytest.mark.parametrize("how", [one_id, half_batch])
@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serve_fault_is_caught(tmp_path, cell, how):
    spec = tiny_spec(tmp_path)
    with patched(mf_base, "topk_async", serve_fault(how)):
        res = run(spec, cell)
    assert not res["correct"], res["checks"]


def test_failed_request_is_not_correct(tmp_path):
    def make(orig):
        calls = []

        def topk_async(*args, **kwargs):
            calls.append(1)
            if len(calls) == 3:  # the warm-up call, then the window's second
                raise RuntimeError("lost")
            return orig(*args, **kwargs)
        return topk_async

    spec = tiny_spec(tmp_path)
    with patched(mf_base, "topk_async", make):
        res = run(spec, SERVE_CELLS[0])
    assert res["failed"] == 1 and not res["correct"]
