"""The cell of the wide solve route, ``als_lastfm360k_f512_bf16.fit``, on the
CPU: its run at a tiny size against its own limits (the program correct,
the TF32 control and two faults not), its plain reference importing nothing
of the program, the counts of ``lib/counts_wide.py`` against hand counts,
and its four readers on spans and a trace made by hand."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import implicit_tpu_torch
import implicit_tpu_torch.models.als as models_als
import implicit_tpu_torch.ops.cg_kernels as cg_kernels
from cfbench.lib import counts_wide, harness, peaks
from cfbench.lib.trace import PREFIX, Trace
from cfbench.tests.tiny import REPO, run, tiny_spec
from implicit_tpu_torch import tracing

CELL = "als_lastfm360k_f512_bf16.fit"
READERS = ("wide.solve_device_s", "wide.solve_roofline", "wide.matvec_roofline",
           "wide.update_roofline")


@pytest.fixture
def spec(tmp_path):
    """The tiny spec with this cell's data cut further, to 600 x 400 with
    8000 draws: its 512 factors and 15 iterations stay, and a run takes a few
    seconds on the CPU."""
    spec = tiny_spec(tmp_path)
    path = os.path.join(tmp_path, "cfbench", "configs", "als_lastfm360k_f512_bf16.json")
    with open(path) as fh:
        cfg = json.load(fh)
    cfg["data"].update(users=600, items=400, draws=8000)
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return spec


def test_sound_fit_is_correct(spec):
    res = run(spec, CELL, seconds=0.1)
    assert res["correct"], res["checks"]
    assert res["checks"]["start_gap"]["value"] == 0.0


def test_control_fails(spec):
    res = run(spec, CELL, seconds=0.1, control=True)
    assert not res["correct"], res["checks"]


def _single_pass_tf32(*args):
    """The dense term p YtY_reg taken in one pass of TF32 operands."""
    return cg_kernels.cg_update_split(*args, scheme="tf32")


def test_single_pass_tf32_dense_term_is_caught(spec, monkeypatch):
    monkeypatch.setattr(cg_kernels, "cg_update", _single_pass_tf32)
    res = run(spec, CELL, seconds=0.1)
    assert not res["correct"], res["checks"]


def test_start_not_rounded_to_float16_is_caught(spec, monkeypatch):
    """The starting tables drawn and kept in float32, not rounded to the
    float16 storage."""
    draw = models_als.AlternatingLeastSquares._initial_factors

    def unrounded(self, *args, **kwargs):
        saved, self.dtype = self.dtype, np.dtype(np.float32)
        try:
            return draw(self, *args, **kwargs)
        finally:
            self.dtype = saved

    monkeypatch.setattr(models_als.AlternatingLeastSquares, "_initial_factors", unrounded)
    res = run(spec, CELL, seconds=0.1)
    assert res["checks"]["start_gap"]["value"] > 0 and not res["correct"], res["checks"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import cfbench.reference.als_f16; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'implicit_tpu', 'implicit_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


# a hand-worked shape: 3 of 4 users and 2 of 3 items with entries, 5 entries,
# F = 2, one CG step (two passes), 16-bit tables
SHAPE = dict(users=4, items=3, nnz=5, users_nonempty=3, items_nonempty=2, factors=2, cg_steps=1,
             table_bytes=2, iterations=2, dtype="bfloat16")


def test_matvec_counts_hand_count():
    # 2 passes of 5 entries x (2 F dot + 2 F add) = 2 * 5 * 8
    assert counts_wide.matvec_ops(nnz=5, factors=2, cg_steps=1) == 80
    # a pass: 5 entries x (index 4 + weight 4) = 40, the 3-row table 3*2*2 = 12,
    # v read and the term written 2*3*2*4 = 48: 100; two passes and the b-values 5*4
    assert counts_wide.matvec_bytes(rows=3, nnz=5, other_rows=3, factors=2, table_bytes=2,
                                    cg_steps=1) == 220


def test_update_counts_hand_count():
    # 2 passes of 2 F^2 per row over 3 rows = 48; 3 rows x (3 + 10) F = 78
    assert counts_wide.update_ops(rows=3, factors=2, cg_steps=1) == 126
    # YtY_reg 2*2*4 a pass, twice = 32; the first pass reads s and x0 (2*3*2*4 =
    # 48) and writes x, r, p (72); the step reads s, p, x, r (96) and writes 72
    assert counts_wide.update_bytes(rows=3, factors=2, cg_steps=1) == 32 + 120 + 168


def test_solve_counts_hand_count():
    assert counts_wide.solve_ops(rows=3, nnz=5, factors=2, cg_steps=1) == 80 + 126
    # 5 entries x (index, weight, b-value) = 60, the table 12, YtY_reg 16, x0 read
    # and x written 2*3*2*4 = 48
    assert counts_wide.solve_bytes(rows=3, nnz=5, other_rows=3, factors=2,
                                   table_bytes=2) == 136


def test_iteration_sums_both_sides():
    ops, nbytes = counts_wide.iteration(SHAPE, "matvec")
    assert ops == 80 + 80
    # the item side: 2 rows against the 4-row user table
    assert nbytes == 220 + counts_wide.matvec_bytes(2, 5, 4, 2, 2, 1)
    for part in ("update", "solve"):
        assert counts_wide.iteration(SHAPE, part)[0] > 0
    with pytest.raises(ValueError):
        counts_wide.iteration(SHAPE, "gramian")


def _span(id, name, start, end, parent=None, root=None, device_s=None, **attrs):
    return dict(name=name, id=id, parent=parent, root=root or (id if parent is None else None),
                attrs=attrs, start_ns=start, end_ns=end, device_s=device_s, counts={})


WIDE = dict(stage="model step", factors=2, classes=1, passes=2)
SPANS = [
    _span(1, "fit", 100, 1100),
    _span(2, "prepare", 110, 150, 1, 1, stage="fit set-up"),
    _span(3, "iteration", 400, 600, 1, 1, device_s=2.0e-7, iteration=0),
    _span(4, "wide solve", 410, 490, 3, 1, device_s=0.8e-7, rows=3, entries=5, **WIDE),
    _span(5, "wide solve", 500, 590, 3, 1, device_s=0.9e-7, rows=2, entries=5, **WIDE),
    _span(6, "iteration", 600, 800, 1, 1, device_s=2.0e-7, iteration=1),
    _span(7, "wide solve", 610, 690, 6, 1, device_s=0.7e-7, rows=3, entries=5, **WIDE),
    _span(8, "wide solve", 700, 790, 6, 1, device_s=0.6e-7, rows=2, entries=5, **WIDE),
]
HOST = [(90, 1110, PREFIX + "fit")]
DEVICE = [
    (420, 470, "void als::wmv::wmv_narrow<als::TableRows<__nv_bfloat16>, 8, 32, 2>(...)"),
    (470, 480, "void als::wmv::wmv_sum_slices(float const*, float*, long, int)"),
    (480, 520, "void als::cgu::cg_update_kernel<128>(float const*, ...)"),
    (520, 530, "als::cgu::yty_split_kernel(float const*, float*, float*, int)"),
    (620, 660, "void als::wmv::wmv_narrow<als::TableRows<__nv_bfloat16>, 8, 32, 2>(...)"),
    (660, 700, "void als::cgu::cg_update_kernel<128>(float const*, ...)"),
    (700, 720, "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nt_align1>(...)"),
    (2000, 2100, "void als::wmv::wmv_narrow<...>(...)"),  # after the profiled fit
]
# 1 operation or 1 byte a second, so a least time is its larger count in s
PEAKS = {"flops": {"float32": 1.0, "bfloat16": 1.0}, "bytes_per_s": 1.0}


def _run(monkeypatch, spans=SPANS, device=DEVICE):
    monkeypatch.setattr(tracing, "spans", lambda: [dict(s) for s in spans])
    run = harness.Run(CELL, {}, {}, 1, 1.0, True, torch.device("cpu"), lambda msg: None)
    run.trace = Trace.from_events(device, HOST)
    run.record, run.shape, run.peaks = dict(kind="fit"), dict(SHAPE), PEAKS
    return run


def _read(name, run):
    return harness.Spec(REPO).reader(name)(run)


def _least(part):
    return SHAPE["iterations"] * max(counts_wide.iteration(SHAPE, part))


def test_wide_readers(monkeypatch):
    run = _run(monkeypatch)
    secs = (0.8 + 0.9 + 0.7 + 0.6) * 1e-7
    assert _read("wide.solve_device_s", run) == pytest.approx(secs)
    assert _read("wide.solve_roofline", run) == pytest.approx(100 * _least("solve") / secs)
    # weighted_matvec's kernels inside the fit: 50 + 10 + 40 ns
    assert _read("wide.matvec_roofline", run) == pytest.approx(100 * _least("matvec") / 100e-9)
    # cg_update's and the split's: 40 + 10 + 40 ns
    assert _read("wide.update_roofline", run) == pytest.approx(100 * _least("update") / 90e-9)


def test_least_time_is_the_larger_bound():
    p = peaks.for_card("NVIDIA H100 80GB HBM3")
    ops, nbytes = counts_wide.iteration(dict(SHAPE, factors=512, nnz=10**6), "update")
    assert peaks.least_time(p, ops, nbytes, "bfloat16") == max(ops / 989e12, nbytes / 3.35e12)


def test_span_seconds_need_every_span_timed(monkeypatch):
    spans = [dict(s) for s in SPANS]
    spans[-1]["device_s"] = None  # a fit on the CPU: no CUDA events
    run = _run(monkeypatch, spans)
    assert _read("wide.solve_device_s", run) is None
    assert _read("wide.solve_roofline", run) is None


def test_kernel_rooflines_need_the_kernels(monkeypatch):
    """A fit that ran neither kernel (a narrow one) gives nothing to read."""
    run = _run(monkeypatch, device=[e for e in DEVICE if "als::" not in e[2]])
    assert _read("wide.matvec_roofline", run) is None
    assert _read("wide.update_roofline", run) is None


@pytest.mark.parametrize("name", READERS[:2])
def test_nothing_to_read_without_the_span(name, monkeypatch):
    """On a program without the span, or without the tracing module, the
    span's readers give None and raise nothing."""
    run = _run(monkeypatch, [s for s in SPANS if s["name"] != "wide solve"])
    assert _read(name, run) is None
    run = _run(monkeypatch)
    assert _read(name, run) is not None
    monkeypatch.delattr(implicit_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "implicit_tpu_torch.tracing", None)
    assert _read(name, run) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_in_an_untraced_run(name, monkeypatch):
    run = _run(monkeypatch)
    run.trace = None
    assert _read(name, run) is None


def test_the_cell_and_its_metrics_are_entered():
    bench = harness.Spec(REPO).bench
    cell, = [c for c in bench["workloads"] if c["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("als_lastfm360k_f512_bf16",
                                                                 "fit", 1)
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in ("fit_s", "fit.prep_s", "fit.iter_s", "mfu.fit", "solve_roofline",
                 "device_idle.fit"):
        assert CELL in metrics[name]["workloads"]
    for name in READERS:
        assert metrics[name]["workloads"] == [CELL] and metrics[name]["moves"] == "fit_s"
