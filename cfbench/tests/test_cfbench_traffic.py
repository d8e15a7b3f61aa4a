"""The generators: the same seed gives the same inputs and requests, and
every seed the same sizes in another order."""

import numpy as np
import pytest

from cfbench.lib import data, generators, harness
from cfbench.tests.tiny import CPU, SERVE_CELLS, tiny_spec

SPEC = dict(users=3000, items=1500, draws=90000, structure_seed=0, popularity_offset=20.0,
            popularity_exponent=0.8, mean_confidence=40.0)


def test_interactions_repeat_per_seed():
    a, b = data.interactions(SPEC, 2**33 + 5, CPU), data.interactions(SPEC, 2**33 + 5, CPU)
    assert (a != b).nnz == 0 and np.array_equal(a.indptr, b.indptr)
    assert a.dtype == np.float32 and a.has_canonical_format


def test_every_seed_has_the_same_sizes():
    a, b = data.interactions(SPEC, 1, CPU), data.interactions(SPEC, -12345, CPU)
    assert (a != b).nnz > 0
    assert sorted(a.getnnz(1)) == sorted(b.getnnz(1))
    assert sorted(a.getnnz(0)) == sorted(b.getnnz(0))


def test_factor_tables_repeat_per_seed():
    a = data.factor_table(50, 8, 0.1, 9, 0, CPU)
    assert np.array_equal(a, data.factor_table(50, 8, 0.1, 9, 0, CPU))
    assert not np.array_equal(a, data.factor_table(50, 8, 0.1, 9, 1, CPU))


def _requests(spec, cell, seed, **traffic):
    cfg = spec.config(spec.cell(cell)["config"])
    tr = {**spec.traffic(spec.cell(cell)["traffic"]), **traffic}
    run = harness.Run(cell, cfg, tr, seed, 2.0, False, CPU, lambda m: None)
    d = generators.ServeGenerator(run)
    d.setup()
    return d


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_requests_repeat_per_seed(tmp_path, cell):
    spec = tiny_spec(tmp_path)
    a, b, c = (_requests(spec, cell, s) for s in (3, 3, 4))
    assert a.sizes == b.sizes and all(np.array_equal(x, y) for x, y in zip(a.users, b.users))
    assert sorted(a.sizes) == sorted(c.sizes)

