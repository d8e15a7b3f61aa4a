"""Plain reference of the BPR family: the grouped epoch, a whole fit in it,
and the comparisons that judge the program's recorded epochs against them.

BPR (Rendle, Freudenthaler, Gantner and Schmidt-Thieme, "BPR: Bayesian
Personalized Ranking from Implicit Feedback", UAI 2009, arXiv:1205.2618)
ascends ln sigma(x_uij) - reg ||theta||^2 by SGD on triples (u, i, j), i
liked by u and j not, with x_uij = x_u . (y_i - y_j) + b_i - b_j. Written
here from that update and the inputs alone (the user x item CSR, the seed
of ``random_state``, the configuration's parameters); it imports nothing
of the program. For each chunk of entries, in order, every right-hand
side at the chunk's starting values:

- each valid entry (u, i) (data != 0, u a real row) takes the negative
  j = ``itemids[r]``, r the entry's draw, uniform over the nnz stored
  entries: j is drawn by popularity;
- the entry is skipped where u liked j, looked up in the CSR (with
  ``verify_negative_samples``);
- s = x_u . (y_i - y_j) + b_i - b_j and z = 1 / (1 + e^s) = sigma(-s);
- x_u <- max(1 - lr reg, 0)^(n kept) x_u + lr sum z (y_i - y_j);
- y_i, y_j, b_i and b_j take lr (z x_u - reg y_i), lr (-z x_u - reg y_j),
  lr (z - reg b_i) and lr (-z - reg b_j); rows that collide in a chunk are
  summed.

Departures from Rendle's per-sample SGD, each the configuration's
schedule: the update is chunk-synchronous (a chunk's entries read the
tables as the chunk found them, and colliding rows add their updates), an
epoch visits every stored entry once in place of drawing triples with
replacement, and the user row's n regularization steps in a chunk are
applied as the exact shrink (1 - lr reg)^n (n first-order steps, 1 - n lr
reg, turn negative past 1 / (lr reg) entries). The user's bias column is
pinned at 1, so b_i - b_j is the whole bias term, and the item bias is
regularized like a factor.

The fit starts from numpy's float32 draw of ``np.random.default_rng(
random_state)``: the item table first, then the user table, each (rows,
factors + 1) of (u - 0.5) / factors, rows with no entries zeroed, the user
bias column set to 1. The products (the two batched products of a chunk)
run in float32 with TF32 off, or, for the control, with both operands
rounded to TF32 first.
"""

import numpy as np
import torch

from cfbench.reference.als import Products, float32_products

# the control's chunker: rows in order, a chunk closed before its padded
# rows x longest row would pass ENTRIES, or at ROWS rows
ENTRIES = 1 << 16
ROWS = 8192


class Likes:
    """The user x item CSR on the device: its column ids in stored order and
    the sorted keys ``u * items + i`` that the membership test searches."""

    def __init__(self, user_items, device):
        self.shape = user_items.shape
        self.nnz = int(user_items.nnz)
        indptr = np.asarray(user_items.indptr, dtype=np.int64)
        rows = np.repeat(np.arange(self.shape[0], dtype=np.int64), np.diff(indptr))
        cols = np.asarray(user_items.indices, dtype=np.int64)
        self.itemids = torch.as_tensor(cols, device=device)
        self.keys = torch.sort(torch.as_tensor(rows * self.shape[1] + cols, device=device))[0]
        self.user_counts = np.diff(indptr)
        self.item_counts = np.bincount(cols, minlength=self.shape[1])

    def contains(self, u, j):
        """Whether user u liked item j, elementwise."""
        key = u * self.shape[1] + j
        pos = torch.searchsorted(self.keys, key).clamp(max=self.keys.numel() - 1)
        return self.keys[pos] == key


def start(random_state, likes, factors):
    """The documented start as (X, Y, yb) float32 numpy arrays: the user
    table, the item table and the item biases."""
    users, items = likes.shape
    F = factors
    rng = np.random.default_rng(random_state)
    item_f = (rng.random((items, F + 1), dtype=np.float32) - 0.5) / F
    item_f[likes.item_counts == 0] = 0.0
    user_f = (rng.random((users, F + 1), dtype=np.float32) - 0.5) / F
    user_f[likes.user_counts == 0] = 0.0
    return user_f[:, :F], item_f[:, :F], item_f[:, F]


def epoch(tables, chunks, draws, likes, lr, reg, verify=True, precision="float32"):
    """One grouped epoch from ``tables`` (X, Y, yb), left as they are, over
    ``chunks`` [(rows (C,), indices (C, L), data (C, L))] with ``draws`` [r
    (C, L)]; returns the new (X, Y, yb) and the count of skipped entries."""
    rnd = Products(precision).round  # operands as the products read them
    X, Y, yb = (t.detach().float().clone() for t in tables)
    users = X.shape[0]
    shrink = torch.tensor(max(1.0 - lr * reg, 0.0), dtype=torch.float32, device=X.device)
    skipped = 0
    with float32_products():
        for (rows, idx, dat), r in zip(chunks, draws):
            real = rows < users
            u = rows.clamp(max=users - 1)
            valid = (dat != 0) & real[:, None]
            j = likes.itemids[r]
            skip = (likes.contains(u[:, None].expand_as(idx), j) if verify
                    else torch.zeros_like(valid))
            keep = valid & ~skip
            skipped += int((valid & skip).sum())
            x = X[u]
            yi, yj, bi, bj = Y[idx], Y[j], yb[idx], yb[j]
            d = yi - yj
            s = torch.bmm(rnd(d), rnd(x[:, :, None]))[:, :, 0] + bi - bj
            z = 1.0 / (1.0 + torch.exp(s))
            w = torch.where(keep, lr * z, 0.0)
            n = keep.sum(1).float()
            x_new = shrink ** n[:, None] * x + torch.bmm(rnd(w[:, None, :]), rnd(d))[:, 0]
            X[u[real]] = x_new[real]
            zk, xk = z[keep][:, None], x[:, None, :].expand_as(yi)[keep]
            Y.index_add_(0, idx[keep], lr * (zk * xk - reg * yi[keep]))
            Y.index_add_(0, j[keep], lr * (-zk * xk - reg * yj[keep]))
            yb.index_add_(0, idx[keep], lr * (z[keep] - reg * bi[keep]))
            yb.index_add_(0, j[keep], lr * (-z[keep] - reg * bj[keep]))
    return (X, Y, yb), skipped


def chunk_rows(likes, device):
    """The control's chunks: the rows with entries in order, each chunk
    padded to its longest row (column 0, data 0)."""
    counts = likes.user_counts
    itemids = likes.itemids.cpu().numpy()
    indptr = np.concatenate([[0], np.cumsum(counts)])
    chunks, rows, longest = [], [], 0
    for u in np.flatnonzero(counts):
        wider = max(longest, int(counts[u]))
        if rows and ((len(rows) + 1) * wider > ENTRIES or len(rows) == ROWS):
            chunks.append(_pad(rows, longest, itemids, indptr, device))
            rows, wider = [], int(counts[u])
        rows.append(u)
        longest = wider
    if rows:
        chunks.append(_pad(rows, longest, itemids, indptr, device))
    return chunks


def _pad(rows, L, itemids, indptr, device):
    idx = np.zeros((len(rows), L), dtype=np.int64)
    dat = np.zeros((len(rows), L), dtype=np.float32)
    for c, u in enumerate(rows):
        n = indptr[u + 1] - indptr[u]
        idx[c, :n] = itemids[indptr[u]:indptr[u + 1]]
        dat[c, :n] = 1.0
    return tuple(torch.as_tensor(a, device=device) for a in (np.asarray(rows, np.int64), idx, dat))


def _clone(tables):
    return tuple(t.detach().clone() for t in tables)


def _record(before, chunks, draws, returned, after=None):
    rec = dict(before=before, chunks=chunks, draws=draws, returned=returned)
    if after is not None:
        rec["after"] = after
    return rec


class FitRecorder:
    """What the checked fit keeps, through the configuration's
    ``state_hook`` (``models/bpr.py:_bpr_epoch_grouped``, one epoch a call,
    in place on its first three arguments): for the first and the last
    epoch the tables before it, the chunks it was handed, its draws
    (materialised and passed on unchanged) and its returned (correct,
    skipped); for the first also the tables after it. The tables are cloned
    on the device; the chunks are the program's own tensors."""

    def __init__(self, params):
        if params.get("epoch_mode") not in ("grouped", 1):
            raise ValueError("the BPR check follows the grouped epoch (epoch_mode 'grouped')")
        self.n = int(params["iterations"])
        self.calls, self.kept = 0, {}

    def wrap(self, fn, name):
        def recorded(X, Y, yb, classes, itemids, indptr, table, draws, *args, **kwargs):
            k = self.calls
            self.calls += 1
            if k not in (0, self.n - 1):
                return fn(X, Y, yb, classes, itemids, indptr, table, draws, *args, **kwargs)
            if kwargs.get("pool_mode", 0):
                raise ValueError("the BPR check follows pool_mode 0 only")
            before = _clone((X, Y, yb))
            draws = list(draws)
            chunks = [(rows[c], idx[c], dat[c]) for rows, idx, dat, _ in classes
                      for c in range(rows.shape[0])]
            out = fn(X, Y, yb, classes, itemids, indptr, table, draws, *args, **kwargs)
            self.kept[k] = _record(before, chunks, draws, (int(out[0]), int(out[1])),
                                   _clone((X, Y, yb)) if k == 0 else None)
            return out
        return recorded

    def answers(self, model, random_state):
        """The dict ``judge_fit_answers`` reads: the kept epochs and the
        model's public factors+1 tables."""
        return dict(first=self.kept[0], last=self.kept[self.n - 1],
                    final=(model.user_factors, model.item_factors), random_state=random_state)


def fit_recorder(params):
    """The checked fit's recorder (``lib/generators.py`` says what it gives)."""
    return FitRecorder(params)


def _rates(params):
    """lr and reg rounded to float32, as a float32 program takes them."""
    return (float(np.float32(params["learning_rate"])),
            float(np.float32(params["regularization"])))


def fit_answers(user_items, params, random_state, device, precision):
    """A whole reference fit in ``precision``, with its own chunks
    (:func:`chunk_rows`) and draws (a generator seeded from
    ``random_state``), in the recorder's format: the control."""
    likes = Likes(user_items, device)
    F, n = int(params["factors"]), int(params["iterations"])
    lr, reg = _rates(params)
    verify = bool(params.get("verify_negative_samples", True))
    tables = tuple(torch.as_tensor(t, device=device) for t in start(random_state, likes, F))
    chunks = chunk_rows(likes, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(random_state) % 2**63)
    kept = {}
    for k in range(n):
        draws = [torch.randint(0, likes.nnz, idx.shape, generator=gen, device=device)
                 for _, idx, _ in chunks]
        after, skipped = epoch(tables, chunks, draws, likes, lr, reg, verify, precision)
        if k in (0, n - 1):
            kept[k] = _record(tables, chunks, draws, (None, skipped), after if k == 0 else None)
        tables = after
    X, Y, yb = (t.cpu().numpy() for t in tables)
    user_f = np.concatenate([X, np.ones((X.shape[0], 1), np.float32)], 1)
    item_f = np.concatenate([Y, yb[:, None]], 1)
    return dict(first=kept[0], last=kept[n - 1], final=(user_f, item_f),
                random_state=random_state)


def cover_gap(chunks, likes):
    """The stored entries that ``chunks`` miss, plus the valid chunk entries
    beyond one per stored entry (repeats, padding marked valid, entries not
    stored), plus valid entries in rows past the last user."""
    users, items = likes.shape
    keys, sentinel_valid = [], 0
    for rows, idx, dat in chunks:
        valid = dat != 0
        real = (rows >= 0) & (rows < users)
        sentinel_valid += int((valid & ~real[:, None]).sum())
        keys.append((rows[:, None] * items + idx)[valid & real[:, None]])
    got = torch.cat(keys) if keys else likes.keys[:0]
    covered = int(torch.unique(got[likes.contains(got // items, got % items)]).numel())
    return (likes.nnz - covered) + (got.numel() - covered) + sentinel_valid


def _update_gaps(before, after, ref_after):
    """The program's update (``after`` less ``before``) against the
    reference's (``ref_after`` less ``before``): the Frobenius norm of the
    difference over the three tables, over the reference update's; and, per
    table, the widest entry of the difference over the widest entry of the
    reference's update, the largest of the three. Per table, because the
    item biases' updates, about lr a positive and one entry each, outweigh
    the factor tables' in any sum over the three, and only the user table's
    update runs through the two products."""
    diff2 = ref2 = 0.0
    gap = 0.0
    for b, p, r in zip(before, after, ref_after):
        b, p, r = (t.double() for t in (b, p, r))
        dr, dd = r - b, (p - b) - (r - b)
        diff2 += float((dd * dd).sum())
        ref2 += float((dr * dr).sum())
        gap = max(gap, float(dd.abs().max()) / max(float(dr.abs().max()), 1e-300))
    if not np.isfinite(diff2) or not np.isfinite(gap):
        return float("inf"), float("inf")
    return float(np.sqrt(diff2 / max(ref2, 1e-300))), gap


def judge_fit_answers(user_items, params, random_state, answers, device):
    """The fit's numbers. ``start_gap``: the tables before the first epoch
    against the documented start (exact). ``cover_gap``: what each kept
    epoch's chunks miss or repeat of the stored entries (:func:`cover_gap`,
    exact). ``skipped_gap``: the kept epochs' skipped counts against the
    reference's on the same chunks and draws (exact). ``draw_bias``:
    |mean((r + 1/2) / nnz) - 1/2| over the first epoch's draws, inf where a
    draw lies outside [0, nnz). ``first_rel_fro``, ``first_max_gap``: the
    first epoch's update against the reference's from the same start,
    chunks and draws (:func:`_update_gaps`: over the three tables, and the
    widest gap per table). ``last_rel_fro``: the same for
    the last epoch, from the program's own state before it, against the
    model's returned tables (the item bias their trailing column, the user
    column all 1; inf where it is not).

    Updates are compared, not tables: an epoch at lr 0.01 moves tables of
    order 1 / factors by a few percent, and a wrong update would hide under
    the unchanged rest."""
    likes = Likes(user_items, device)
    F = int(params["factors"])
    lr, reg = _rates(params)
    verify = bool(params.get("verify_negative_samples", True))
    first, last = answers["first"], answers["last"]

    def dev(t):
        return torch.as_tensor(t, device=device).float()

    numbers = dict(start_gap=max(float((dev(p) - dev(r)).abs().max()) for p, r in
                                 zip(first["before"], start(random_state, likes, F))))
    numbers["cover_gap"] = sum(cover_gap(rec["chunks"], likes) for rec in (first, last))
    r = torch.cat([t.reshape(-1) for t in first["draws"]]).double()
    numbers["draw_bias"] = (abs(float(((r + 0.5) / likes.nnz).mean()) - 0.5)
                            if r.numel() and 0 <= float(r.min()) and float(r.max()) < likes.nnz
                            else float("inf"))
    skipped_gap = 0
    for name, rec in (("first", first), ("last", last)):
        before = tuple(dev(t) for t in rec["before"])
        ref_after, skipped = epoch(before, rec["chunks"], rec["draws"], likes, lr, reg, verify)
        skipped_gap += abs(int(rec["returned"][1]) - skipped)
        if name == "first":
            after = tuple(dev(t) for t in rec["after"])
            numbers["first_rel_fro"], numbers["first_max_gap"] = _update_gaps(
                before, after, ref_after)
        else:
            user_f, item_f = (dev(t) for t in answers["final"])
            after = (user_f[:, :F], item_f[:, :F], item_f[:, F])
            pinned = bool((user_f[:, F] == 1.0).all())
            numbers["last_rel_fro"] = (_update_gaps(before, after, ref_after)[0] if pinned
                                       else float("inf"))
        del ref_after
    numbers["skipped_gap"] = skipped_gap
    return numbers
