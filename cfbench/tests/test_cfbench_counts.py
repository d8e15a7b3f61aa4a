"""The operation and byte counts against hand counts at a tiny shape."""

import pytest

from cfbench.lib import counts, peaks


def test_als_side_ops_hand_count():
    # 2 rows with entries, 3 entries, 4 rows on the other side, F = 2, 1 CG step:
    # gramian 2*4*2*2 = 32; b 2*3*2 = 12; 2 products with A, each
    # 2*2*2*2 + 4*3*2 = 40; vector updates 2*(10 + 3)*2 = 52
    assert counts.als_side_ops(rows=2, nnz=3, other_rows=4, factors=2, cg_steps=1) == 176


def test_als_iteration_sums_both_sides():
    shape = dict(users=4, items=3, nnz=5, users_nonempty=3, items_nonempty=2, factors=2,
                 cg_steps=3, table_bytes=4)
    want = (counts.als_side_ops(3, 5, 3, 2, 3) + counts.als_side_ops(2, 5, 4, 2, 3))
    assert counts.als_iteration_ops(shape) == want


def test_als_iteration_bytes_hand_count():
    shape = dict(users=4, items=3, nnz=5, factors=2, table_bytes=4)
    # CSRs 2*8*5 + 8*(4+3+2) = 152; tables 2*(4+3)*2*4 = 112; gramians 2*2*2*2*4 = 64
    assert counts.als_iteration_bytes(shape) == 328


def test_topk_counts_hand_count():
    assert counts.topk_ops(batch=3, items=5, factors=2) == 60
    # (5 + 3)*2*4 table and queries, 7 liked pairs * 16, 3*10*8 outputs
    assert counts.topk_bytes(3, 5, 2, liked=7, N=10, table_bytes=4) == 64 + 112 + 240


@pytest.mark.parametrize("name, dtype, flops", [
    ("NVIDIA H100 80GB HBM3", "float32", 495e12),
    ("NVIDIA H100 80GB HBM3", "bfloat16", 989e12),
])
def test_peaks_and_least_time(name, dtype, flops):
    p = peaks.for_card(name)
    assert p["flops"][dtype] == flops
    # operations bound, then bytes bound
    assert peaks.least_time(p, flops, 1.0, dtype) == pytest.approx(1.0)
    assert peaks.least_time(p, 1.0, 3.35e12, dtype) == pytest.approx(1.0)


def test_unknown_card_has_no_peaks():
    assert peaks.for_card("cpu") is None
