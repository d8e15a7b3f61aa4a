"""The port's bucketed CSR against the JAX package's, array for array.

The same scipy matrix goes to both ``BucketedCSR`` classes; the host packing
is integer bookkeeping, so every array must be exactly equal (no tolerance).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from implicit_tpu import sparse as jsparse
from implicit_tpu_torch import native as tnative
from implicit_tpu_torch import sparse as tsparse

torch.set_num_threads(2)


def _matrix(seed, users=300, items=120, density=0.05, heavy_rows=3, empty_rows=4):
    """Random CSR with a few long rows and a few empty rows."""
    rng = np.random.RandomState(seed)
    m = sp.random(users, items, density=density, random_state=rng, format="lil",
                  dtype=np.float32)
    for r in range(heavy_rows):
        m[r, : int(items * 0.9)] = 1.0 + r
    for r in range(users - empty_rows, users):
        m[r, :] = 0.0
    m = m.tocsr()
    m.data = (m.data * 10 + 1).astype(np.float32)
    m.eliminate_zeros()
    return m


CASES = [
    dict(seed=0),
    dict(seed=1, users=500, items=40, density=0.2, empty_rows=0),
    dict(seed=2, users=64, items=700, density=0.01, heavy_rows=5),
]


@pytest.mark.parametrize("grid", ["pow2", "fine"])
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("target", [1 << 23, 2048])
def test_bucketed_csr_matches_jax(grid, case, target):
    m = _matrix(**CASES[case])
    want = jsparse.BucketedCSR(m, target_entries=target, max_chunk_rows=256, grid=grid)
    got = tsparse.BucketedCSR(m, target_entries=target, max_chunk_rows=256, grid=grid)
    assert got.shape == want.shape and got.nnz == want.nnz
    assert got.sentinel == want.sentinel
    np.testing.assert_array_equal(got.empty_rows, want.empty_rows)
    assert len(got.classes) == len(want.classes)
    for g, w in zip(got.classes, want.classes):
        assert (g.L, g.C, g.n_chunks) == (w.L, w.C, w.n_chunks)
        for name in ("rows", "indices", "data", "lengths"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("grid", ["pow2", "fine"])
def test_length_grid_and_chunk_policy_match_jax(grid):
    n = np.arange(0, 5000)
    np.testing.assert_array_equal(tsparse.length_class_grid(n, 8, grid),
                                  jsparse.length_class_grid(n, 8, grid))
    for factors in (16, 64, 128, 256):
        for dt in ("float32", "bfloat16"):
            assert tsparse.als_chunk_target(factors, dt) == jsparse.als_chunk_target(factors, dt)
    for count, L in ((1, 8), (1000, 64), (70000, 16), (9, 4096)):
        assert tsparse.chunk_pieces(count, L, 1 << 20, 4096) == \
            jsparse.chunk_pieces(count, L, 1 << 20, 4096)


def test_numpy_packer_matches_native():
    # the numpy path must pack exactly what the compiled packer packs
    m = _matrix(3)
    sel = np.array([0, 5, 7, 1, 299], dtype=np.int32)
    native = tnative.pack_ragged(m.indptr, m.indices, m.data, sel, 128)
    lib, tnative._lib = tnative._lib, None
    tried, tnative._tried = tnative._tried, True  # force the numpy path
    try:
        plain = tnative.pack_ragged(m.indptr, m.indices, m.data, sel, 128)
    finally:
        tnative._lib, tnative._tried = lib, tried
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)


def test_device_buckets_on_cpu():
    m = _matrix(4)
    host = tsparse.BucketedCSR(m, target_entries=512, max_chunk_rows=64)
    dev = host.to_device("cpu")
    assert dev.device == torch.device("cpu")
    np.testing.assert_array_equal(dev.empty_rows.numpy(), host.empty_rows)
    for h, d in zip(host.classes, dev.classes):
        assert d.rows.dtype == torch.int64 and d.indices.dtype == torch.int32
        np.testing.assert_array_equal(d.indices.numpy(), h.indices)
        np.testing.assert_array_equal(d.data.numpy(), h.data)
        # n_valid: a chunk's real rows are its first n_valid rows
        for i, nv in enumerate(d.n_valid):
            real = h.rows[i] != host.sentinel
            assert real[:nv].all() and not real[nv:].any()


def test_empty_matrix_has_no_classes():
    m = sp.csr_matrix((5, 7), dtype=np.float32)
    got = tsparse.BucketedCSR(m)
    assert got.classes == [] and list(got.empty_rows) == list(range(5))
    assert got.to_device("cpu").empty_rows.tolist() == list(range(5))
