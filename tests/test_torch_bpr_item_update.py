"""BPR's grouped item update (``implicit_tpu_torch/ops/bpr_update.py``) on the
CPU.

The grouped epoch's item rows in pool mode 0 take one
``bpr_item_update`` a chunk in place of four ``_scatter_add`` calls over
(C L, F) update rows. Here, on crafted chunks (a hot item whose entries
fill several of the kernel's tiles of 32, runs across tile edges, an item
liked by one row and drawn as another's negative, a row whose entries are
all skipped, sentinel rows and padding):

- the plain version against the four scatters it replaces: within 1e-6 of
  each output's scale and, on the CPU, the same values
  (both round each term alike and add a row's terms from its value in
  entry order; they differ only by the zeros the scatters add for dropped
  entries); rows no kept entry names keep their bits;
- the kernel's two passes (``csrc/bpr_item_update.cu``) emulated in numpy
  float32, as the kernel orders and rounds them (tiles, runs, head and
  tail partials, the owner's sum in tile order), against the plain
  version: the same bits in every row whose run lies inside one tile,
  within 1e-6 of scale in the rows cut by a tile's edge.

The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from implicit_tpu_torch.models import bpr
from implicit_tpu_torch.ops import bpr_update

torch.set_num_threads(2)

LR, REG = 0.05, 0.04
TILE = bpr_update.TILE


def _chunk(C, L, n_items, F, seed):
    """One chunk's inputs, as the grouped epoch hands them over: tables,
    the chunk's user rows, z, the liked ids (distinct in a row, padding id
    0), the negatives' ids and which entries are kept. Item 0 is hot: the
    negative of about a third of the entries and liked by every fourth row.
    Item 3 is liked by row 1 and drawn as row 2's negative. Row 5's entries
    are all skipped; the last 3 rows are sentinels (padding only); each row
    has a ragged end of padding."""
    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((n_items, F)) * 0.1).astype(np.float32)
    yb = (rng.standard_normal(n_items) * 0.1).astype(np.float32)
    x = (rng.standard_normal((C, F)) * 0.1).astype(np.float32)
    z = rng.random((C, L), dtype=np.float32)
    cidx = np.stack([rng.choice(np.arange(4, n_items), L, replace=False) for _ in range(C)])
    cidx[::4, 0] = 0
    negids = rng.integers(0, n_items, (C, L))
    negids[rng.random((C, L)) < 0.35] = 0
    cidx[1, 1], negids[2, 3] = 3, 3
    lengths = rng.integers(1, L + 1, C)
    lengths[1], lengths[2] = max(lengths[1], 2), max(lengths[2], 4)
    keep = (np.arange(L)[None, :] < lengths[:, None]) & (rng.random((C, L)) < 0.9)
    keep[1, 1] = keep[2, 3] = True
    keep[5] = False
    keep[-3:] = False
    cidx[np.arange(L)[None, :] >= lengths[:, None]] = 0
    cidx[-3:] = 0
    t = torch.as_tensor
    return (t(Y), t(yb), t(x), t(z), t(cidx.astype(np.int64)), t(negids.astype(np.int64)),
            t(keep))


CASES = {  # (C, L, n_items, F, seed)
    "dense": (40, 8, 60, 16, 1),     # few items: long runs, most cut by tile edges
    "sparse": (64, 24, 5000, 24, 2),  # many items: short runs, the hot one long
    "wide": (48, 12, 300, 130, 3),    # F no multiple of 4 (the kernel's float route)
}


def _four_scatters(Y, yb, x, z, cidx, negids, keep, lr, reg):
    """The grouped epoch's item update before the op (pool mode 0): four
    ``_scatter_add`` calls over the (C L, F) update rows, dropped entries
    adding zeros."""
    F = Y.shape[1]
    Yu, bl, Yn, bn = Y[cidx], yb[cidx], Y[negids], yb[negids]
    scale = torch.where(keep, lr, 0.0)
    sz = scale * z
    szx = sz[:, :, None] * x[:, None, :]
    sreg = (scale * reg)[:, :, None]
    bpr._scatter_add(Y, cidx.reshape(-1), (szx - sreg * Yu).reshape(-1, F))
    bpr._scatter_add(Y, negids.reshape(-1), (-szx - sreg * Yn).reshape(-1, F))
    bpr._scatter_add(yb, cidx.reshape(-1), (scale * (z - reg * bl)).reshape(-1))
    bpr._scatter_add(yb, negids.reshape(-1), (scale * (-z - reg * bn)).reshape(-1))


def _emulated_kernel(Y, yb, x, z, cidx, negids, keep, lr, reg):
    """The kernel's two passes in numpy float32, each product and sum
    rounded as the kernel rounds it (no fused multiply-add), on numpy
    copies of the tables. Returns the updated (Y, yb), the keys of the runs
    the second pass wrote, and the most tiles one run spans."""
    Y, yb = Y.numpy().copy(), yb.numpy().copy()
    x, z, f = x.numpy(), z.numpy().reshape(-1), np.float32
    n_items, F = Y.shape
    CL, L = z.size, cidx.shape[1]
    keys = np.where(keep.numpy(), np.stack([cidx.numpy(), negids.numpy()]),
                    n_items).astype(np.int32).reshape(-1)
    perm = np.argsort(keys, kind="stable")
    keys = keys[perm]
    n = keys.size
    n_tiles = -(-n // TILE)
    lr, reg = f(lr), f(reg)
    sreg = lr * reg
    part = np.zeros((2, n_tiles, F), np.float32)
    part_b = np.zeros((2, n_tiles), np.float32)

    def key(p):
        return keys[p] if 0 <= p < n else (n_items if p >= n else -1)

    for t in range(n_tiles):  # the tiles: a warp each
        base = t * TILE
        ks = [key(base + j) for j in range(TILE)]
        prev, nxt = key(base - 1), (key(base + TILE) if base + TILE < n else -1)
        m = sum(k < n_items for k in ks)
        ends = False
        for j in range(m):
            e = perm[base + j]
            q = e if e < CL else e - CL
            w = z[q] if e < CL else -z[q]
            starts = ks[j] != (prev if j == 0 else ks[j - 1])
            ends = ks[j] != (nxt if j == TILE - 1 else ks[j + 1])
            if j == 0 or starts:
                y, b, head = Y[ks[j]].copy(), yb[ks[j]], not starts
                acc, accb = (np.zeros(F, np.float32), f(0)) if head else (y.copy(), b)
            acc = acc + ((lr * w) * x[q // L] - sreg * y)
            accb = accb + lr * (w - reg * b)
            if ends and head:
                part[0, t], part_b[0, t] = acc, accb
            elif ends:
                Y[ks[j]], yb[ks[j]] = acc, accb
        if m == TILE and not ends:  # runs on into the next tile
            part[0 if head else 1, t], part_b[0 if head else 1, t] = acc, accb

    cut, widest = set(), 1
    for t in range(n_tiles - 1):  # the runs cut by tile edges: their owners
        base = t * TILE
        k = keys[base + TILE - 1]
        if k >= n_items or keys[base + TILE] != k or (t > 0 and keys[base - 1] == k):
            continue
        last = t + 1
        while last + 1 < n_tiles and keys[(last + 1) * TILE] == k:
            last += 1
        acc, accb = part[1, t].copy(), part_b[1, t]
        for h in range(t + 1, last + 1):
            acc, accb = acc + part[0, h], accb + part_b[0, h]
        Y[k], yb[k] = acc, accb
        cut.add(int(k))
        widest = max(widest, last - t + 1)
    return Y, yb, cut, widest


def _within_scale(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_the_four_scatters(case):
    Y, yb, x, z, cidx, negids, keep = _chunk(*CASES[case])
    kept_ids = torch.cat((cidx[keep], negids[keep])).unique()
    untouched = np.setdiff1d(np.arange(Y.shape[0]), kept_ids.numpy())
    # rows only dropped entries name (row 5's items, the padding id 0 unless kept)
    dropped_only = np.setdiff1d(torch.cat((cidx[~keep], negids[~keep])).unique().numpy(),
                                kept_ids.numpy())
    assert len(untouched) and len(dropped_only)
    want = [Y.clone(), yb.clone()]
    _four_scatters(*want, x, z, cidx, negids, keep, LR, REG)
    got = [Y.clone(), yb.clone()]
    bpr_update.bpr_item_update_plain(*got, x, z, cidx, negids, keep, LR, REG)
    for g, w, start in zip(got, want, (Y, yb)):
        _within_scale(g, w)
        assert torch.equal(g, w)
        bits = (t.numpy()[untouched].view(np.int32) for t in (g, start))
        assert (next(bits) == next(bits)).all()
        assert not torch.equal(g, start)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_the_plain_version(case):
    Y, yb, x, z, cidx, negids, keep = _chunk(*CASES[case])
    got_Y, got_yb, cut, widest = _emulated_kernel(Y, yb, x, z, cidx, negids, keep, LR, REG)
    want = [Y.clone(), yb.clone()]
    bpr_update.bpr_item_update_plain(*want, x, z, cidx, negids, keep, LR, REG)
    want_Y, want_yb = (t.numpy() for t in want)
    # the hot item's run spans several tiles; other runs cross tile edges too
    assert 0 in cut and widest >= 3 and len(cut) >= 2
    _within_scale(got_Y, want_Y)
    _within_scale(got_yb, want_yb)
    inside = np.setdiff1d(np.arange(Y.shape[0]), sorted(cut))
    assert (got_Y[inside].view(np.int32) == want_Y[inside].view(np.int32)).all()
    assert (got_yb[inside].view(np.int32) == want_yb[inside].view(np.int32)).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_reference_bounds_every_float32_order(case):
    """The card's bar (``bpr_item_update_reference``, ``bound_share``): the
    plain version, the four scatters and the emulated kernel, three float32
    orders and groupings of each row's sum, lie within every element's
    bound of the float64 sum; the tables left as they were and one kept
    entry dropped do not; an untouched row's room is its own value's
    rounding alone."""
    Y, yb, x, z, cidx, negids, keep = _chunk(*CASES[case])
    args = (x, z, cidx, negids, keep, LR, REG)
    ref = bpr_update.bpr_item_update_reference(Y, yb, *args)
    assert all(t.dtype == torch.float64 for t in ref)
    plain, old = [Y.clone(), yb.clone()], [Y.clone(), yb.clone()]
    bpr_update.bpr_item_update_plain(*plain, *args)
    _four_scatters(*old, *args)
    emulated = [torch.as_tensor(t) for t in _emulated_kernel(Y, yb, *args)[:2]]
    assert max(bpr_update.bound_share(t, ref) for t in (plain, old, emulated)) <= 1
    assert bpr_update.bound_share([Y.double(), yb.double()], ref) > 1
    short = keep.clone().view(-1)
    short[int(torch.nonzero(short)[-1])] = False
    wrong = [Y.clone(), yb.clone()]
    bpr_update.bpr_item_update_plain(*wrong, x, z, cidx, negids, short.view(keep.shape), LR, REG)
    assert bpr_update.bound_share(wrong, ref) > 1
    kept_ids = torch.cat((cidx[keep], negids[keep])).unique()
    untouched = torch.ones(Y.shape[0], dtype=torch.bool)
    untouched[kept_ids] = False
    assert torch.equal(ref[2][untouched], (Y.double().abs() * 4 * 2.0 ** -24)[untouched])


def test_cpu_route_takes_the_plain_version_and_counts_no_launch():
    Y, yb, x, z, cidx, negids, keep = _chunk(*CASES["dense"])
    want = [Y.clone(), yb.clone()]
    bpr_update.bpr_item_update_plain(*want, x, z, cidx, negids, keep, LR, REG)
    before = bpr_update.LAUNCHES["bpr_item_update"]
    bpr_update.bpr_item_update(Y, yb, x, z, cidx, negids, keep, LR, REG)
    assert bpr_update.LAUNCHES["bpr_item_update"] == before
    assert torch.equal(Y, want[0]) and torch.equal(yb, want[1])


def test_nothing_kept_changes_nothing():
    Y, yb, x, z, cidx, negids, keep = _chunk(*CASES["sparse"])
    start = Y.clone(), yb.clone()
    bpr_update.bpr_item_update(Y, yb, x, z, cidx, negids, torch.zeros_like(keep), LR, REG)
    assert torch.equal(Y, start[0]) and torch.equal(yb, start[1])


@pytest.mark.parametrize("bad", ["x_shape", "ids_shape", "dtype", "keep_dtype"])
def test_refuses_what_it_does_not_take(bad):
    Y, yb, x, z, cidx, negids, keep = _chunk(*CASES["dense"])
    if bad == "x_shape":
        x = x[:-1]
    elif bad == "ids_shape":
        negids = negids[:, :-1]
    elif bad == "dtype":
        Y = Y.double()
    else:
        keep = keep.to(torch.uint8)
    with pytest.raises(ValueError):
        bpr_update.bpr_item_update(Y, yb, x, z, cidx, negids, keep, LR, REG)


@pytest.mark.parametrize("CL,F,want", [(1, 128, 2 * 1 * 129), (16, 4, 2 * 1 * 5),
                                       (17, 4, 2 * 2 * 5), (32768, 128, 2 * 2048 * 129)])
def test_scratch_holds_every_tiles_partials(CL, F, want):
    """Two partials (a row and a bias) a tile of 32 of the 2 CL entries:
    the size the kernel checks (csrc/bpr_item_update.cu)."""
    assert bpr_update._scratch_floats(CL, F) == want
