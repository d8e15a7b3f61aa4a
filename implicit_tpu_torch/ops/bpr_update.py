"""One chunk's item-row updates in BPR's grouped epoch, summed per row in a
fixed order.

In the grouped epoch (``models/bpr.py:_bpr_epoch_grouped``, pool mode 0)
every kept entry of a chunk reads its item row, liked or negative, as the
chunk found it (y, b). So each kept entry e adds

    (lr w_e) x[c(e)] - (lr reg) y   to its row of Y,
    lr (w_e - reg b)                to its item bias,

with w = +z for the liked entries (``cidx``) and -z for the negatives
(``negids``), c(e) its row of the chunk: no per-entry row of F floats is
needed, only the chunk's user rows ``x`` and one coefficient an entry.

:func:`bpr_item_update` takes that update: on CUDA through the kernel
``csrc/bpr_item_update.cu`` (notes at its head) over the entries sorted by
row, two launches a call, counted once in ``launches.bpr_item_update``;
for CPU tensors through its plain version :func:`bpr_item_update_plain`.
Both round each term as the four ``index_put_`` / ``index_add_`` calls
over (C L, F) update tensors that they replace rounded it, and add a row's
terms from the row's value in entry order (liked, then negatives, each
row-major); the kernel groups the sum otherwise only where a row's entries
straddle its tiles of 32, adding the tiles' partial sums in tile order. Two
runs give the same bits. Rows no kept entry names keep theirs.
:func:`bpr_item_update_reference` and :func:`bound_share` hold a result to
each element's float32 summation bound against a float64 sum of the same
terms, the bar of the card tests and ``chip_smoke.py``.
"""

import numpy as np
import torch

from .. import tracing
from . import _build

# the tracing counter launches.bpr_item_update: one per chunk update taken
# by the kernel (its two launches)
LAUNCHES = tracing.register("launches", {"bpr_item_update": 0})

# sorted positions a warp of the kernel walks (kTile in the source)
TILE = 32


def _scratch_floats(CL, F):
    """The kernel's scratch for 2 CL entries: each tile's head and tail
    partial sums, a row and a bias each."""
    return 2 * -(-2 * CL // TILE) * (F + 1)


def _check(Y, yb, x, z, cidx, negids, keep):
    C, L = z.shape
    if not (Y.dim() == 2 and yb.shape == Y.shape[:1] and x.shape == (C, Y.shape[1])
            and cidx.shape == negids.shape == keep.shape == (C, L)):
        raise ValueError(f"bpr_item_update: shapes Y {tuple(Y.shape)}, yb {tuple(yb.shape)}, x "
                         f"{tuple(x.shape)}, z {tuple(z.shape)}, cidx {tuple(cidx.shape)}, "
                         f"negids {tuple(negids.shape)}, keep {tuple(keep.shape)} do not agree")
    if any(t.dtype != torch.float32 for t in (Y, yb, x, z)) or keep.dtype != torch.bool:
        raise ValueError("bpr_item_update takes float32 tables, rows and logits and a bool keep")
    if any(t.device != Y.device for t in (yb, x, z, cidx, negids, keep)):
        raise ValueError("bpr_item_update: every tensor must be on the tables' device")


def bpr_item_update(Y, yb, x, z, cidx, negids, keep, lr, reg):
    """One chunk's item updates, in place on ``Y`` (n_items, F) and ``yb``
    (n_items,): for each entry where ``keep`` (C, L) is True, the row
    ``cidx`` (C, L) names takes lr (z x - reg y) and its bias lr (z - reg
    b), the row ``negids`` (C, L) names lr (-z x - reg y) and lr (-z - reg
    b), y and b the rows as they were; ``x`` (C, F) is the chunk's user
    rows, ``z`` (C, L) the entries' 1 - sigmoid(score). On CUDA the kernel
    (launching on the current stream, no sync); for CPU tensors
    :func:`bpr_item_update_plain`.
    """
    _check(Y, yb, x, z, cidx, negids, keep)
    if Y.device.type != "cuda":
        return bpr_item_update_plain(Y, yb, x, z, cidx, negids, keep, lr, reg)
    n_items = Y.shape[0]
    C, L = z.shape
    if not (Y.is_contiguous() and yb.is_contiguous()):
        raise ValueError("bpr_item_update updates contiguous tables in place")
    if n_items >= (1 << 31) - 1 or 2 * C * L >= 1 << 31:
        raise ValueError(f"bpr_item_update takes fewer than 2^31 - 1 rows and 2^31 entries, "
                         f"got {n_items} rows and {2 * C * L} entries")
    # dropped entries sort last under the key n_items; the stable sort keeps
    # each row's entries in entry order
    keys = torch.where(keep, torch.stack((cidx, negids)), n_items).to(torch.int32).view(-1)
    keys, perm = torch.sort(keys, stable=True)
    _launch(Y, yb, x.contiguous(), z.contiguous(), keys, perm, lr, reg)


def _launch(Y, yb, x, z, keys, perm, lr, reg):
    """The kernel's two launches over the sorted ``keys`` (int32) and their
    ``perm`` (int64), with its scratch; raises on a launch error, else
    counts one."""
    lib = _build.load("bpr_item_update")["bpr_item_update"]
    C, L = z.shape
    F = Y.shape[1]
    part = torch.empty(_scratch_floats(C * L, F), dtype=torch.float32, device=Y.device)
    index = Y.device.index
    with torch.cuda.device(index):
        rc = lib.bpr_item_update(keys.data_ptr(), perm.data_ptr(), z.data_ptr(), x.data_ptr(),
                                 Y.data_ptr(), yb.data_ptr(), part.data_ptr(), part.numel(),
                                 C * L, L, F, Y.shape[0], lr, reg,
                                 torch.cuda.current_stream(index).cuda_stream)
    _build.check(lib, rc, "bpr_item_update launch")
    LAUNCHES["bpr_item_update"] += 1


def _kept_entries(z, cidx, negids, keep):
    """The kept entries in entry order (liked, then negatives, each
    row-major): each one's row of the chunk, its item row and its w (+z,
    -z)."""
    C, L = z.shape
    rows = torch.arange(C, device=z.device)[:, None].expand(C, L)[keep].repeat(2)
    return rows, torch.cat((cidx[keep], negids[keep])), torch.cat((z[keep], -z[keep]))


def bpr_item_update_plain(Y, yb, x, z, cidx, negids, keep, lr, reg):
    """:func:`bpr_item_update` in plain PyTorch: the kept entries' update
    rows, each term rounded as the kernel rounds it, added with
    ``index_add_`` in entry order (liked, then negatives, each row-major).
    On the CPU that adds each row's terms one by one from its value, the
    kernel's order; on the card ``index_add_`` adds them with atomics, so
    there it is the kernel's reference within rounding."""
    rows, ids, w = _kept_entries(z, cidx, negids, keep)
    sreg = float(np.float32(lr) * np.float32(reg))  # lr reg, rounded as float32 rounds it
    y, b = Y[ids], yb[ids]
    Y.index_add_(0, ids, (lr * w)[:, None] * x[rows] - sreg * y)
    yb.index_add_(0, ids, lr * (w - reg * b))


def bpr_item_update_reference(Y, yb, x, z, cidx, negids, keep, lr, reg):
    """The card's bar for :func:`bpr_item_update`: its result summed in
    float64 from the same float32 inputs (the plain version on float64
    copies, lr and reg rounded to float32 as the float32 arithmetic takes
    them), and per element the float32 bound of any order and grouping of
    its row's sum, (n + 4) 2^-24 (|row| + the sum of its terms' parts'
    |.|), n the row's kept entries (a sum of n + 1 values, each term
    rounded up to three times). Returns (Y, yb, Y bound, yb bound), all
    float64; :func:`bound_share` reads a result against them."""
    lr, reg = float(np.float32(lr)), float(np.float32(reg))
    ref = [Y.to(torch.float64, copy=True), yb.to(torch.float64, copy=True)]
    bpr_item_update_plain(*ref, x.double(), z.double(), cidx, negids, keep, lr, reg)
    rows, ids, w = _kept_entries(z, cidx, negids, keep)
    w, xr, y, b = (t.double().abs() for t in (w, x[rows], Y[ids], yb[ids]))
    sreg = float(np.float32(lr) * np.float32(reg))
    parts = (Y.double().abs().index_add_(0, ids, (lr * w)[:, None] * xr + sreg * y),
             yb.double().abs().index_add_(0, ids, lr * (w + reg * b)))
    n = torch.bincount(ids, minlength=Y.shape[0]).double() + 4
    return (*ref, n[:, None] * 2.0 ** -24 * parts[0], n * 2.0 ** -24 * parts[1])


def bound_share(got, ref):
    """The largest |got - ref| over its element's bound, over both tables
    (``got`` the updated Y and yb, ``ref`` as
    :func:`bpr_item_update_reference` gives it): at most 1 where ``got``
    summed the same terms in some float32 order; 0 where they agree, inf
    where an element with no room differs."""
    return max(float(((g.double() - r).abs() / b).nan_to_num(0.0, float("inf")).max())
               for g, r, b in zip(got, ref[:2], ref[2:]))
