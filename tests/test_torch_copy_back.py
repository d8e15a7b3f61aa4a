"""The ALS copy back on the CPU (``_device.to_host``): the plain route a CPU
fit takes and the counters of both routes, the staged route's chunk plan and
its host arrays. The staged copy itself needs a card:
``tests/test_torch_cuda.py -k "staged or copy_back"``."""

import mmap
import pickle

import numpy as np
import pytest
import torch

from implicit_tpu_torch import _device, tracing
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.datasets.synthetic import generate_synthetic

PLAYS = generate_synthetic(300, 200, 6000, seed=8)
ROUTES = ("copy_back.staged_bytes", "copy_back.plain_bytes")


def _moved(before):
    after = tracing.counters()
    return {k: after[k] - before[k] for k in ROUTES}


@pytest.mark.parametrize("mesh", [None, 2], ids=["single", "mesh2"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_cpu_fit_copies_back_plain(dtype, mesh):
    """A CPU fit, single or meshed, copies both tables the plain way: its
    plain bytes are both tables' in the storage dtype, it stages none and
    makes no ring."""
    rings = dict(_device._rings)
    before = tracing.counters()
    model = AlternatingLeastSquares(factors=8, iterations=1, random_state=4, dtype=dtype,
                                    device="cpu", mesh=mesh)
    model.fit(PLAYS, show_progress=False)
    assert model.user_factors.dtype == model.item_factors.dtype == dtype
    assert model.user_factors.shape == (300, 8) and model.item_factors.shape == (200, 8)
    nbytes = (300 + 200) * 8 * np.dtype(dtype).itemsize
    assert _moved(before) == {"copy_back.staged_bytes": 0, "copy_back.plain_bytes": nbytes}
    assert _device._rings == rings


def test_cpu_tables_stay_where_they_lie():
    """On the CPU every table, however large, is its own ``.numpy()``: the
    same memory, counted as plain bytes."""
    big = torch.arange(3 * _device.SLOT_BYTES // 8, dtype=torch.float64)
    tables = [torch.arange(12, dtype=torch.float32).reshape(3, 4),
              torch.zeros((0, 4), dtype=torch.float16), big.reshape(-1, 64)]
    before = tracing.counters()
    arrays = _device.to_host(tables)
    for t, a in zip(tables, arrays):
        assert isinstance(a, np.ndarray) and a.shape == tuple(t.shape)
        np.testing.assert_array_equal(a, t.numpy())
    assert np.shares_memory(arrays[0], tables[0].numpy())
    assert np.shares_memory(arrays[2], tables[2].numpy())
    nbytes = sum(t.numel() * t.element_size() for t in tables)
    assert _moved(before) == {"copy_back.staged_bytes": 0, "copy_back.plain_bytes": nbytes}


# a table's size in slots: below one, between one and two (both plain on the
# card), exactly two, and ragged ones past the ring's SLOTS chunks
@pytest.mark.parametrize("slots", [0, 0.3, 1.5, 2, 2.375, 9.1])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64])
def test_chunks_cover_each_table_once(dtype, slots):
    """The chunk plan: each table's elements once, in order, in chunks of
    one slot's bytes but the table's last; tables one after the other."""
    item = torch.empty(0, dtype=dtype).element_size()
    n = int(slots * _device.SLOT_BYTES) // item + (7 if slots not in (0, 2) else 0)
    flats = [torch.empty(n, dtype=dtype, device="meta"),
             torch.empty(_device.SLOT_BYTES // item + 3, dtype=dtype, device="meta")]
    chunks = _device._chunks(flats)
    per = _device.SLOT_BYTES // item
    for k, flat in enumerate(flats):
        mine = [(a, b) for j, a, b in chunks if j == k]
        assert [a for a, _ in mine] == list(range(0, flat.numel(), per))
        assert all(b - a == per for a, b in mine[:-1])
        assert (mine[-1][1] if mine else 0) == flat.numel()
        assert all(0 < (b - a) * item <= _device.SLOT_BYTES for a, b in mine)
    assert [j for j, _, _ in chunks] == sorted(j for j, _, _ in chunks)
    if slots == 2:
        assert len([j for j, _, _ in chunks if j == 0]) == 2


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_host_array_is_a_plain_numpy_array(dtype):
    """The staged route's destination: a writable C-ordered array of the
    shape and dtype asked for, on a mapping the kernel populated (its fresh
    pages read zero); it lives on without its mapping's name, pickles and
    shares its memory with ``torch``."""
    a = _device._host_array((1001, 33), np.dtype(dtype))
    assert a.shape == (1001, 33) and a.dtype == dtype
    assert a.flags.writeable and a.flags.c_contiguous
    owner = a
    while isinstance(owner, (np.ndarray, memoryview)):
        owner = owner.obj if isinstance(owner, memoryview) else owner.base
    assert isinstance(owner, mmap.mmap) and not a.any()
    a[...] = np.arange(a.size).reshape(a.shape) % 251
    t = torch.from_numpy(a).reshape(-1)
    t[5] = 7
    assert a[0, 5] == 7
    b = pickle.loads(pickle.dumps(a))
    np.testing.assert_array_equal(a, b)
