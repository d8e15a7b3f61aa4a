"""The span ``wide solve`` of the wide solve route on the CPU.

Past ``cg_kernels.MAX_FACTORS`` factors every class of a half-iteration
solves in the composed CG (``ops/als.py:_solve_side_core``), inside one
``wide solve`` span under the fit's ``iteration``. Its attrs come from the
host-side plan: the factors, the classes, the rows with entries, the live
entries and the passes per row. Like every span it is recorded only while
a profiler records.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from implicit_tpu_torch import tracing
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.datasets.synthetic import generate_synthetic
from implicit_tpu_torch.sparse import BucketedCSR, als_chunk_target

torch.set_num_threads(2)

PLAYS = generate_synthetic(300, 200, 6000, seed=8)


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _fit(factors, iterations=2, profiled=True, **kw):
    model = AlternatingLeastSquares(factors=factors, iterations=iterations, random_state=4,
                                    device="cpu", **kw)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            model.fit(PLAYS, show_progress=False)
    else:
        model.fit(PLAYS, show_progress=False)
    return model


def _plan(csr, factors, compute_dtype):
    """The side's plan as the fit cuts it."""
    return BucketedCSR(csr, target_entries=als_chunk_target(factors, compute_dtype),
                       max_chunk_rows=65536, grid="pow2")


@pytest.mark.parametrize("factors, dtype, compute", [(320, np.float32, "float32"),
                                                     (512, np.float16, "bfloat16")])
def test_one_wide_solve_under_each_iteration(factors, dtype, compute):
    _fit(factors, iterations=3, dtype=dtype)
    spans = tracing.spans()
    iterations = [s for s in spans if s["name"] == "iteration"]
    assert len(iterations) == 3
    Cui = PLAYS.astype(np.float32).tocsr()
    sides = [Cui, Cui.T.tocsr()]
    for it in iterations:
        wide = [s for s in spans if s["parent"] == it["id"]]
        assert [s["name"] for s in wide] == ["wide solve", "wide solve"]
        for span, csr in zip(wide, sides):
            classes = len(_plan(csr, factors, compute).classes)
            assert span["attrs"] == dict(
                stage="model step", factors=factors, classes=classes,
                rows=int((np.diff(csr.indptr) > 0).sum()), entries=csr.nnz, passes=4)
            assert it["start_ns"] <= span["start_ns"] <= span["end_ns"] <= it["end_ns"]
            assert span["device_s"] is None  # no CUDA device, no events
    assert len([s for s in spans if s["name"] == "wide solve"]) == 6


def test_nothing_recorded_without_a_profiler():
    _fit(320, profiled=False)
    assert tracing.spans() == []


@pytest.mark.parametrize("factors, kw", [(64, {}), (256, {"dtype": np.float16}),
                                         (320, {"dtype": np.float64})])
def test_no_wide_solve_off_the_wide_route(factors, kw):
    """Fits of up to ``cg_kernels.MAX_FACTORS`` factors and float64's plain
    composed CG take other routes: no ``wide solve``."""
    _fit(factors, **kw)
    names = {s["name"] for s in tracing.spans()}
    assert "iteration" in names and "wide solve" not in names
