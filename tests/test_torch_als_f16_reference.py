"""The port's 16-bit wide fit against the benchmark's plain 16-bit reference.

``cfbench/reference/als_f16.py`` is the plain reference that decides
``correct`` in the benchmark's cell of ALS at 512 factors with float16
tables. Here the port's CPU path (every class on the wide route, past
``cg_kernels.MAX_FACTORS``, in its plain versions) fits factors 320 and 512
with ``dtype=np.float16`` for 2 iterations, and the reference's judge
reads how far it lies. Both are plain torch; nothing of JAX runs.

Tolerances, each with its reason (regularization 0.01, the benchmark
configuration's):

- the starting tables are equal bit for bit: both round numpy's draw times
  0.01 to float16;
- ``first_rel_fro`` (the scores after iteration 1, over all users x items)
  within 4e-3: the port and the reference sum the same float32 products in
  other orders (chunked classes against a blocked CSR product), and three CG
  steps from the start on normal equations this ill conditioned (300 items
  at 512 factors) amplify that, to 1.4e-3-1.8e-3 here;
- ``last_rel_fro`` (the final float16 tables against one reference
  iteration from the port's own state, rounded to float16) within 5e-4:
  one iteration's reordering, and the float16 roundings it tips, read
  1.4e-4-1.8e-4 here.

``cfbench/reference/als.py``, which starts from the unrounded float32 draw
and gathers float32 rows, misses them: its start lies a float16 rounding
away, and its last iteration about 4.5e-3 away; the reference with TF32
operands misses the last by 2.5e-3-4.8e-3.
"""

import numpy as np
import pytest
import torch

from cfbench.lib import generators, trace
from cfbench.reference import als as ref_f32
from cfbench.reference import als_f16 as ref_f16
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.datasets.synthetic import generate_synthetic

torch.set_num_threads(2)

CPU = torch.device("cpu")
PLAYS = generate_synthetic(400, 300, 8000, seed=5).astype(np.float32).tocsr()
REG = 0.01
FIRST_REL_FRO = 4e-3
LAST_REL_FRO = 5e-4


def _params(factors):
    return dict(factors=factors, regularization=REG, iterations=2, cg_steps=3, alpha=1.0)


def _port_answers(factors, random_state=11):
    """The port's start, its state after iteration 1 and its final tables."""
    rec = generators._StateRecorder({0, 1})
    with trace.patched(["implicit_tpu_torch.ops.als:solve_side"], rec.wrap):
        model = AlternatingLeastSquares(factors=factors, iterations=2, regularization=REG,
                                        dtype=np.float16, random_state=random_state,
                                        device="cpu")
        model.fit(PLAYS, show_progress=False)
    kept = rec.kept
    return dict(start=kept["start"], first=(kept[0], kept[1]), before_last=(kept[0], kept[1]),
                final=(model.user_factors, model.item_factors))


@pytest.fixture(scope="module", params=[320, 512])
def fitted(request):
    return request.param, _port_answers(request.param)


def test_start_is_equal_bit_for_bit(fitted):
    factors, answers = fitted
    want = ref_f16.Fit(PLAYS, _params(factors), CPU).start(11)
    for got, ref in zip(answers["start"], want):
        assert got.dtype == torch.float32 and torch.equal(got, ref)
    assert ref_f16.judge_fit_answers(PLAYS, _params(factors), 11, answers, CPU)["start_gap"] == 0


def test_port_within_the_reference_tolerances(fitted):
    factors, answers = fitted
    assert answers["final"][0].dtype == np.float16
    got = ref_f16.judge_fit_answers(PLAYS, _params(factors), 11, answers, CPU)
    assert got["first_rel_fro"] < FIRST_REL_FRO, got
    assert got["last_rel_fro"] < LAST_REL_FRO, got


def test_float32_gather_reference_misses(fitted):
    """The float32 semantics of ``reference/als.py`` miss the tolerances
    that the 16-bit reference holds the port to: it cannot decide."""
    factors, answers = fitted
    got = ref_f32.judge_fit_answers(PLAYS, _params(factors), 11, answers, CPU)
    assert got["start_gap"] > 0, got
    assert got["last_rel_fro"] > 4 * LAST_REL_FRO, got


def test_control_misses(fitted):
    """The reference with its products' operands rounded to TF32 in the
    port's place misses too: the tolerances tell the two precisions apart."""
    factors, _ = fitted
    control = ref_f16.fit_answers(PLAYS, _params(factors), 11, CPU, "tf32")
    got = ref_f16.judge_fit_answers(PLAYS, _params(factors), 11, control, CPU)
    assert got["start_gap"] == 0
    assert got["first_rel_fro"] > FIRST_REL_FRO or got["last_rel_fro"] > LAST_REL_FRO, got
