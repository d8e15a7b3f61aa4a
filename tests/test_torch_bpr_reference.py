"""The port's grouped BPR epoch against the benchmark's plain BPR reference.

``cfbench/reference/bpr.py`` is the plain reference that decides
``correct`` in the benchmark's BPR cell. Here, on the CPU at a small size
(300 x 200, F=16), the port's ``_bpr_epoch_grouped`` and the reference's
``epoch`` are fed the same tables, chunks and draws for 3 epochs, with the
cuckoo pair table and with the bisection; a whole CPU fit is followed
through the reference's recorder and judged; and the judge rejects a
faulty port. Both are plain torch; nothing of JAX runs.

Tolerances, each with its reason:

- an epoch's update agrees to 1e-5 of its largest entry: the two sum the
  same float32 terms (the port adds zeros for dropped entries, the
  reference leaves them out), so only the order of a few additions
  differs; the skipped counts are equal (both look the same pairs up);
- the whole fit's exact numbers (``start_gap``, ``cover_gap``,
  ``skipped_gap``) are 0, and its update gaps lie under the cell's limits
  (``cfbench/limits/bpr_lastfm360k_f128.fit.json``); ``draw_bias`` lies
  within 5 standard deviations of the mean of its draws, since this size
  draws a few thousand;
- each fault reads above the cell's limit of the number that should catch
  it.
"""

import inspect
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from cfbench.lib import trace
from cfbench.reference import bpr as ref
from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
from implicit_tpu_torch.datasets.synthetic import generate_synthetic
from implicit_tpu_torch.models import bpr
from implicit_tpu_torch.ops import bpr_update, membership

torch.set_num_threads(2)

CPU = torch.device("cpu")
PLAYS = generate_synthetic(300, 200, 6000, seed=8).astype(np.float32).tocsr()
HOOK = "implicit_tpu_torch.models.bpr:_bpr_epoch_grouped"
LIMITS = json.load(open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                     "cfbench", "limits", "bpr_lastfm360k_f128.fit.json")))["limits"]
PARAMS = dict(factors=16, iterations=3, learning_rate=0.01, regularization=0.01,
              epoch_mode="grouped", verify_negative_samples=True)


def _chunks(classes):
    return [(rows[c], idx[c], dat[c]) for rows, idx, dat, _ in classes
            for c in range(rows.shape[0])]


@pytest.mark.parametrize("verifier", ["cuckoo", "bisection"])
def test_port_epoch_matches_reference(verifier):
    M = PLAYS
    users, items = M.shape
    F, lr, reg = 16, 0.05, 0.04
    rng = np.random.default_rng(3)
    tables = tuple(torch.as_tensor((rng.standard_normal(shape) * 0.1).astype(np.float32))
                   for shape in ((users, F), (items, F), (items,)))
    classes = bpr.grouped_classes(M, "cpu")
    chunks = _chunks(classes)
    assert len(chunks) > 1
    if verifier == "cuckoo":
        pt = membership.build_pair_table(M)
        table, bits = pt.to_device("cpu"), pt.bits
    else:
        table, bits = None, None
    bisect = int(np.ceil(np.log2(max(int(np.diff(M.indptr).max()), 2)))) + 1
    likes = ref.Likes(M, CPU)
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        draws = [torch.randint(0, M.nnz, idx.shape, generator=gen) for _, idx, _ in chunks]
        X, Y, yb = (t.clone() for t in tables)
        _, skipped = bpr._bpr_epoch_grouped(
            X, Y, yb, classes, torch.as_tensor(M.indices.astype(np.int64)),
            torch.as_tensor(M.indptr.astype(np.int64)), table, draws, lr, reg, True, bisect, bits)
        want, want_skipped = ref.epoch(tables, chunks, draws, likes, lr, reg)
        assert int(skipped) == want_skipped > 0
        rel_fro, max_gap = ref._update_gaps(tables, (X, Y, yb), want)
        assert max_gap <= 1e-5 and rel_fro <= 1e-5, (max_gap, rel_fro)
        tables = (X, Y, yb)


def _fit_answers(random_state=11, **fit_kw):
    recorder = ref.fit_recorder(PARAMS)
    with trace.patched([HOOK], recorder.wrap):
        model = BayesianPersonalizedRanking(random_state=random_state, device="cpu",
                                            **PARAMS, **fit_kw)
        model.fit(PLAYS, show_progress=False)
    return recorder.answers(model, random_state)


def _judge(answers, random_state=11):
    return ref.judge_fit_answers(PLAYS, PARAMS, random_state, answers, CPU)


def test_whole_cpu_fit_through_the_recorder():
    numbers = _judge(_fit_answers())
    assert numbers["start_gap"] == numbers["cover_gap"] == numbers["skipped_gap"] == 0
    for name in ("first_rel_fro", "first_max_gap", "last_rel_fro"):
        assert numbers[name] <= LIMITS[name], (name, numbers[name])
    n_draws = sum(idx.numel() for _, idx, _, _ in bpr.grouped_classes(PLAYS, "cpu"))
    assert numbers["draw_bias"] <= 5 / np.sqrt(12 * n_draws)


def test_control_in_tf32_misses_an_update_limit():
    """The reference with TF32 operands in the program's place reads above
    an update limit, and at 0 on the exact numbers."""
    numbers = _judge(ref.fit_answers(PLAYS, PARAMS, 11, CPU, "tf32"))
    assert numbers["start_gap"] == numbers["cover_gap"] == numbers["skipped_gap"] == 0
    assert any(numbers[k] > LIMITS[k] for k in ("first_rel_fro", "first_max_gap",
                                                "last_rel_fro")), numbers


def _edited(*edits, fn=None, **names):
    """``fn`` (``_bpr_epoch_grouped`` by default) with each (old, new) of
    ``edits`` made to its source, compiled in its module's namespace plus
    ``names``."""
    fn = fn or bpr._bpr_epoch_grouped
    module = inspect.getmodule(fn)
    src = textwrap.dedent(inspect.getsource(fn))
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    ns = {**vars(module), **names}
    exec(compile(src, module.__file__, "exec"), ns)
    return ns[fn.__name__]


def _bf16(t):
    return t.bfloat16().float()


def _dropped_chunk():
    epoch = bpr._bpr_epoch_grouped

    def dropped(X, Y, yb, classes, *args, **kwargs):
        rows, idx, dat, n_valid = classes[-1]
        return epoch(X, Y, yb, classes[:-1] + [(rows[:-1], idx[:-1], dat[:-1], n_valid[:-1])],
                     *args, **kwargs)
    return dropped


def _shifted_start(monkeypatch):
    draw = bpr.check_random_state

    def shifted(random_state):
        rs = draw(random_state)
        rs.random(1, dtype=np.float32)
        return rs
    monkeypatch.setattr(bpr, "check_random_state", shifted)


FAULTS = {
    "dropped_chunk": ("first_rel_fro", lambda mp: mp.setattr(bpr, "_bpr_epoch_grouped",
                                                            _dropped_chunk())),
    "no_shrink": ("first_rel_fro", lambda mp: mp.setattr(bpr, "_bpr_epoch_grouped", _edited(
        ("(gamma ** n_keep)[:, None] * x + step", "x + step")))),
    # the grouped epoch's item updates (pool mode 0) go through the op; on
    # the CPU its plain version
    "flipped_negative_sign": ("first_rel_fro", lambda mp: mp.setattr(
        bpr_update, "_kept_entries", _edited(("-z[keep]", "z[keep]"),
                                             fn=bpr_update._kept_entries))),
    "bf16_products": ("first_rel_fro", lambda mp: mp.setattr(bpr, "_bpr_epoch_grouped", _edited(
        ("torch.bmm(diff, x[:, :, None])", "torch.bmm(_bf16(diff), _bf16(x[:, :, None]))"),
        ("torch.bmm(sz[:, None, :], diff)", "torch.bmm(_bf16(sz[:, None, :]), _bf16(diff))"),
        _bf16=_bf16))),
    "shifted_start": ("start_gap", _shifted_start),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_judge_rejects_a_faulty_port(fault, monkeypatch):
    catcher, install = FAULTS[fault]
    install(monkeypatch)
    numbers = _judge(_fit_answers())
    assert numbers[catcher] > LIMITS[catcher], (fault, numbers)
