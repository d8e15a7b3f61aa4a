"""Bayesian Personalized Ranking on one device or a mesh.

The counterpart of ``implicit_tpu/models/bpr.py``: pairwise sigmoid ranking
SGD over (user, liked, disliked) triples, with an extra trailing column on
the factors holding the item bias (the matching user column is pinned to
1.0). As in the JAX package, training is synchronous minibatch SGD with a
deterministic schedule, in one of these epochs:

- grouped (``epoch_mode`` 1, the default): every positive once per epoch,
  streamed out of the padded chunks of a
  :class:`~implicit_tpu_torch.sparse.BucketedCSR` (``_bpr_epoch_grouped``);
  each entry's negative drawn from the interaction multiset (the exact
  popularity draw);
- the grouped pool modes (``epoch_mode`` 2 and 3, the epoch's
  ``pool_mode`` 2 and 1): each chunk row's negatives are a window of a
  shuffled popularity snapshot (``arrangement``) at a drawn offset; mode 2
  takes their factors and biases from the snapshot's epoch-start copy,
  mode 3 only their biases (the factors stay live gathers);
- sampled (``epoch_mode`` 0): nnz uniform positives with replacement, in
  minibatches (``_bpr_epoch``); over a mesh, each shard samples its slice
  of every minibatch and every device's replica applies the gathered batch
  (``_bpr_epoch_sharded``, always this epoch, as in the JAX package).

All skip negatives the user liked, checked against the cuckoo pair table of
:mod:`~implicit_tpu_torch.ops.membership` or, where none fits, by bisection
over the CSR row.

Draws: each step's index draws come from a draw function on the model's
``torch.Generator`` (``_sample_draws``, ``_group_draws``, ``_pool_draws``),
apart from the update, so the epochs can be fed any draws (the tests feed
the JAX package's); ``_shard_sample_draws`` draws a meshed epoch's per
shard.

``BPR_GROUPED``, the mode ``epoch_mode=None`` takes, is read at fit time,
as the JAX package reads its own. The JAX package's ``BPR_FUSED_BUFFER``
and ``BPR_SORT_SAMPLES`` (a stacked-table and a sorted-sample sampled
epoch, measurement points it keeps off) are not ported (ROADMAP C29).

Accumulation: rows that collide within a step sum their updates in an
order fixed by the inputs (``_scatter_add``), so two fits with the same
``random_state`` give the same bits. Each device needs its own op for that:
on CUDA ``index_put_(accumulate=True)`` sorts the indices and sums each
row's updates in order, where ``index_add_`` adds them with atomics; on the
CPU ``index_add_`` adds the updates one by one in order, where
``index_put_(accumulate=True)`` adds them with atomics from several threads.
"""

import logging
import time

import numpy as np
import torch
from tqdm.auto import tqdm

from .._device import full_f32_matmul
from ..ops import membership
from ..parallel.mesh import check_mesh_arg
from ..sparse import pack_on_device
from ..tracing import timed_step
from ..utils import check_csr, check_random_state
from .mf_base import MatrixFactorizationBase

log = logging.getLogger("implicit_tpu_torch")

# minibatch cap of the sampled epoch (the JAX package's): fewer, bigger
# steps train faster, while batches past this size slow convergence per
# sample (more collisions on hot rows within a batch)
_MAX_BATCH = 65536

# the epoch mode of epoch_mode=None: 0 sampled, 1 grouped, 2 grouped with
# pooled negative ids, factors and biases, 3 grouped with pooled ids and
# biases and live factors
BPR_GROUPED = 1

_EPOCH_MODES = {"sampled": 0, "grouped": 1, "grouped_pool": 2, "grouped_pool_ids": 3,
                0: 0, 1: 1, 2: 2, 3: 3}
# each grouped epoch mode's pool_mode in _bpr_epoch_grouped
_POOL_MODES = {1: 0, 2: 2, 3: 1}
# the largest popularity snapshot the pool modes draw windows from
_MAX_POOL = 1 << 21


def _scatter_add(table, idx, values):
    """``table[idx] += values`` in place, rows that repeat in ``idx``
    summed in an order fixed by the inputs (the same bits every run)."""
    if table.is_cuda:
        table.index_put_((idx,), values, accumulate=True)
    else:
        table.index_add_(0, idx, values)


def _segment_member(indptr, indices, u, col, n_iters):
    """Vectorized binary search: is ``col`` present in CSR row ``u``?

    ``n_iters`` must be >= ceil(log2(max_row_length)) + 1. A row id past the
    last row (a chunk's sentinel) reads ``indptr``'s last entry as its end,
    as the JAX package's clamped gather does.
    """
    n = indices.shape[0]
    end = indptr[(u + 1).clamp(max=indptr.shape[0] - 1)]
    lo, hi = indptr[u.clamp(max=indptr.shape[0] - 1)], end
    for _ in range(n_iters):
        mid = (lo + hi) // 2
        go_right = indices[mid.clamp(0, n - 1)] < col
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return (lo < end) & (indices[lo.clamp(0, n - 1)] == col)


def _verify_skip(indptr, itemids, table, u, cols, verify_neg, bisect_iters, bits):
    """Which sampled negatives the user actually liked (and must be skipped):
    the cuckoo pair table where one was built (``bits`` not None), else the
    bisection over the CSR row."""
    if not verify_neg:
        return torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    if bits is not None:
        return membership._member(table, u, cols, *bits)
    return _segment_member(indptr, itemids, u, cols, bisect_iters)


def _sample_draws(gen, steps, batch, n_samples):
    """The sampled epoch's draws: per step, (liked_idx, disliked_idx), each
    ``batch`` uniform positions in [0, n_samples)."""
    for _ in range(steps):
        yield tuple(torch.randint(0, n_samples, (batch,), generator=gen, device=gen.device)
                    for _ in range(2))


def _shard_sample_draws(gen, steps, local_batch, n_samples, mesh):
    """The meshed sampled epoch's draws: per step, a list over the shards in
    order of each shard's (liked_idx, disliked_idx), ``local_batch``
    uniform positions in [0, n_samples) each, drawn on ``gen``'s device
    (liked, then disliked, shard by shard) and moved to the shard's device.
    With one shard this is :func:`_sample_draws`'s sequence."""
    for _ in range(steps):
        yield [tuple(torch.randint(0, n_samples, (local_batch,), generator=gen,
                                   device=gen.device).to(d) for _ in range(2))
               for d in mesh.devices]


def _group_draws(gen, classes, n_samples):
    """The grouped epoch's draws: per chunk, in class and chunk order, a
    (C, L) tensor ``r`` of uniform positions in [0, n_samples) (each entry's
    negative is ``itemids[r]``)."""
    for rows, idx, _, _ in classes:
        for _ in range(rows.shape[0]):
            yield torch.randint(0, n_samples, idx.shape[1:], generator=gen, device=gen.device)


def _pool_draws(gen, classes, n_arrangement):
    """The grouped pool modes' draws: per chunk, in class and chunk order, a
    (C,) tensor of window offsets, uniform in [0, n_arrangement - L) (row
    c's negatives are ``arrangement[off[c]:off[c] + L]``)."""
    for rows, idx, _, _ in classes:
        C, L = idx.shape[1:]
        for _ in range(rows.shape[0]):
            yield torch.randint(0, n_arrangement - L, (C,), generator=gen, device=gen.device)


def pool_arrangement(rs, user_items, max_l):
    """The pool modes' popularity snapshot, drawn as the JAX package draws
    it: a permutation of the interaction column array on numpy's ``rs``,
    its first ``_MAX_POOL`` entries, wrap-padded by ``max_l`` (the widest
    chunk) so a window can start anywhere in the snapshot."""
    pool = rs.permutation(user_items.indices.astype(np.int32))[:min(user_items.nnz, _MAX_POOL)]
    return np.concatenate([pool, np.resize(pool, max_l)])


def _bpr_epoch(X, Y, yb, userids, itemids, indptr, table, draws, lr, reg,
               verify_neg, bisect_iters, bits):
    """One sampled BPR epoch, updating X, Y and yb in place.

    ``draws`` yields each step's (liked_idx, disliked_idx) positions into the
    (userids, itemids) flats. The item bias lives in its own vector ``yb``;
    the user bias column is 1.0, so it adds (bl - bd) to the score. Returns
    (correct, skipped) as device scalars.
    """
    correct = torch.zeros((), dtype=torch.int64, device=X.device)
    skipped = torch.zeros((), dtype=torch.int64, device=X.device)
    for liked_idx, disliked_idx in draws:
        u, liked, disliked, skip = _sample(userids, itemids, indptr, table, liked_idx,
                                           disliked_idx, verify_neg, bisect_iters, bits)
        rows = _gather_rows(X, Y, yb, u, liked, disliked)
        z = _logits(rows)
        keep = ~skip
        correct += ((z < 0.5) & keep).sum()
        skipped += skip.sum()
        _apply_update(X, Y, yb, u, liked, disliked, rows, z, keep, lr, reg)
    return correct, skipped


def _sample(userids, itemids, indptr, table, liked_idx, disliked_idx, verify_neg,
            bisect_iters, bits):
    """A step's (user, liked, disliked) triples from its draws into the
    (userids, itemids) flats, and which negatives the user liked (skip)."""
    u = userids[liked_idx]
    liked = itemids[liked_idx]
    disliked = itemids[disliked_idx]
    skip = _verify_skip(indptr, itemids, table, u, disliked, verify_neg, bisect_iters, bits)
    return u, liked, disliked, skip


def _gather_rows(X, Y, yb, u, liked, disliked):
    """The rows a step reads: (x_u, y_liked, y_disliked, b_liked, b_disliked)."""
    return X[u], Y[liked], Y[disliked], yb[liked], yb[disliked]


def _logits(rows):
    """z = 1 - sigmoid(score) of each triple, from its gathered rows."""
    xu, yl, yd, bl, bd = rows
    return 1.0 / (1.0 + torch.exp((xu * (yl - yd)).sum(1) + bl - bd))


def _apply_update(X, Y, yb, u, liked, disliked, rows, z, keep, lr, reg):
    """One step's SGD update of X, Y and yb in place, from the triples'
    gathered ``rows`` and logits ``z``; dropped triples (``keep`` False)
    add zero."""
    xu, yl, yd, bl, bd = rows
    scale = torch.where(keep, lr, 0.0)
    zc = z[:, None]
    _scatter_add(X, u, scale[:, None] * (zc * (yl - yd) - reg * xu))
    _scatter_add(Y, liked, scale[:, None] * (zc * xu - reg * yl))
    _scatter_add(Y, disliked, scale[:, None] * (-zc * xu - reg * yd))
    _scatter_add(yb, liked, scale * (z - reg * bl))
    _scatter_add(yb, disliked, scale * (-z - reg * bd))


def _bpr_epoch_sharded(replicas, flats, draws, lr, reg, verify_neg, bisect_iters, bits, mesh):
    """One sampled BPR epoch over ``mesh``, updating every replica in place.

    ``replicas`` and ``flats`` map each distinct device of the mesh to its
    (X, Y, yb) and its (userids, itemids, indptr, table); ``draws`` yields
    each step's per-shard (liked_idx, disliked_idx) on the shards' devices
    (:func:`_shard_sample_draws`). Per step, as the JAX package's
    ``_build_sharded_epoch``: each shard samples, verifies and scores its
    slice against its device's replica as it stands at the start of the
    step; (u, liked, disliked, z, keep) are gathered in shard order (a
    ``torch.cat``) on every distinct device, which applies the full batch's
    update once (shards that share a device share its replica). So the
    epoch computes what :func:`_bpr_epoch` computes on the concatenated
    draws, and replicas on different devices stay equal. Returns (correct,
    skipped) as scalars on the mesh's first device.
    """
    first = mesh.devices[0]
    correct = torch.zeros((), dtype=torch.int64, device=first)
    skipped = torch.zeros((), dtype=torch.int64, device=first)
    for shard_draws in draws:
        parts = []
        for d, (liked_idx, disliked_idx) in zip(mesh.devices, shard_draws):
            u, liked, disliked, skip = _sample(*flats[d], liked_idx, disliked_idx, verify_neg,
                                               bisect_iters, bits)
            z = _logits(_gather_rows(*replicas[d], u, liked, disliked))
            parts.append((u, liked, disliked, z, ~skip))
        for d in mesh.distinct():
            u, liked, disliked, z, keep = (torch.cat([p[i].to(d) for p in parts])
                                           for i in range(5))
            if d == first:
                correct += ((z < 0.5) & keep).sum()
                skipped += (~keep).sum()
            X, Y, yb = replicas[d]
            _apply_update(X, Y, yb, u, liked, disliked, _gather_rows(X, Y, yb, u, liked, disliked),
                          z, keep, lr, reg)
    return correct, skipped


def _bpr_epoch_grouped(X, Y, yb, classes, itemids, indptr, table, draws, lr, reg,
                       verify_neg, bisect_iters, bits, pool_mode=0, arrangement=None):
    """One user-grouped BPR epoch over bucketed CSR chunks, in place.

    ``classes`` holds each class's (rows (n, C), indices (n, C, L), data (n,
    C, L), n_valid) with binarized data (padding is data == 0) and sentinel
    rows (id n_users) at the end of a chunk. Per chunk, as the JAX
    package's epoch: the C user rows gathered once, one negative per entry,
    gradients at chunk-start values; the user row shrinks by the exact
    ``(1 - lr reg) ** n_kept`` (the first-order ``1 - n lr reg`` goes
    negative past 1/(lr reg) entries) and is set back once; item rows take
    the first-order update, colliding rows summed. A sentinel row reads the
    last user's row and writes nothing. Returns (correct, skipped) as device
    scalars.

    ``pool_mode`` 0: ``draws`` yields each chunk's (C, L) negative positions
    into ``itemids``. 1 and 2: it yields each chunk's (C,) window offsets
    into ``arrangement`` (:func:`pool_arrangement`, :func:`_pool_draws`),
    whose windows are the rows' negatives; their biases come from the
    epoch-start snapshot ``yb[arrangement]``, and in mode 2 their factors
    too from ``Y[arrangement]`` (in mode 1 they stay live gathers). The
    updates land on the live Y and yb at the negatives' ids.
    """
    n_users, F = X.shape
    correct = torch.zeros((), dtype=torch.int64, device=X.device)
    skipped = torch.zeros((), dtype=torch.int64, device=X.device)
    gamma = float(max(np.float32(1.0) - np.float32(lr) * np.float32(reg), np.float32(0.0)))
    if pool_mode:
        ybpop = yb[arrangement]
        Ypop = Y[arrangement] if pool_mode == 2 else None
    draws = iter(draws)
    for rows, idx, dat, n_valid in classes:
        for crows, cidx, cdat, nv in zip(rows, idx, dat, n_valid):
            r = next(draws)
            x = X[crows.clamp(max=n_users - 1)]
            Yu, bl = Y[cidx], yb[cidx]
            if pool_mode:
                window = r[:, None] + torch.arange(cidx.shape[1], device=r.device)
                negids, bn = arrangement[window], ybpop[window]
                Yn = Ypop[window] if pool_mode == 2 else Y[negids]
            else:
                negids = itemids[r]
                Yn, bn = Y[negids], yb[negids]
            skip = _verify_skip(indptr, itemids, table, crows[:, None].expand_as(cidx), negids,
                                verify_neg, bisect_iters, bits)
            diff = Yu - Yn
            with full_f32_matmul():
                score = torch.bmm(diff, x[:, :, None])[:, :, 0]
            z = 1.0 / (1.0 + torch.exp(score + bl - bn))
            valid = cdat != 0
            keep = valid & ~skip
            correct += ((z < 0.5) & keep).sum()
            skipped += (valid & skip).sum()
            scale = torch.where(keep, lr, 0.0)
            sz = scale * z
            n_keep = keep.sum(1).to(torch.float32)
            with full_f32_matmul():
                step = torch.bmm(sz[:, None, :], diff)[:, 0]
            X[crows[:nv]] = ((gamma ** n_keep)[:, None] * x + step)[:nv]
            szx = sz[:, :, None] * x[:, None, :]
            sreg = (scale * reg)[:, :, None]
            _scatter_add(Y, cidx.reshape(-1), (szx - sreg * Yu).reshape(-1, F))
            _scatter_add(Y, negids.reshape(-1), (-szx - sreg * Yn).reshape(-1, F))
            _scatter_add(yb, cidx.reshape(-1), (scale * (z - reg * bl)).reshape(-1))
            _scatter_add(yb, negids.reshape(-1), (scale * (-z - reg * bn)).reshape(-1))
    return correct, skipped


def grouped_classes(user_items, device):
    """The grouped epoch's chunks of ``user_items``: each class's (rows,
    indices, data, n_valid) on ``device``, cut as the JAX package cuts them
    (``target_entries=1 << 16``, ``max_chunk_rows=8192``: about the sampled
    epoch's minibatch, so hot items collide per chunk no more than per
    batch), with the values binarized so that padding (0) is the only
    invalid marker even where the matrix stores explicit zeros."""
    binary = user_items.copy()
    binary.data = np.ones(len(binary.data), dtype=np.float32)
    buckets = pack_on_device(binary, device, target_entries=1 << 16, max_chunk_rows=8192)
    return [(c.rows, c.indices.long(), c.data, c.n_valid) for c in buckets.classes]


class BayesianPersonalizedRanking(MatrixFactorizationBase):
    """Bayesian Personalized Ranking.

    Learns a matrix factorization by minimizing the pairwise ranking loss of
    'BPR: Bayesian Personalized Ranking from Implicit Feedback' (Rendle et
    al.). Nonzero entries are treated as binary positive signals.

    Parameters
    ----------
    factors : int, optional
        The number of latent factors (one extra bias column is stored)
    learning_rate : float, optional
    regularization : float, optional
    dtype : data-type, optional
        Storage dtype of the factors; training runs in float32
    iterations : int, optional
        The number of training epochs
    num_threads : int, optional
        Accepted for API parity
    verify_negative_samples : bool, optional
        Check that sampled negatives aren't actually liked by the user
    random_state : int, RandomState, Generator or None, optional
        Seeds numpy's draw of the starting factors (so the same seed gives
        the JAX package's), then the device generator of the epochs' draws
    mesh : parallel.Mesh or int, optional
        Train and serve over a mesh of devices, from this one process: each
        shard draws, verifies and scores its slice of every minibatch, the
        samples and logits are gathered in shard order, and every device's
        factor replica applies the same full-batch update (deterministic
        for any mesh size); serving shards the item table, as
        ``AlternatingLeastSquares(mesh=)`` does. The mesh path always
        trains ``"sampled"``, whatever ``epoch_mode`` says, as the JAX
        package's. An int n is ``parallel.create_mesh(n, device)``: n cards
        on CUDA (raising where fewer are visible), n virtual shards on the
        CPU. None (default) trains on ``device``.
    epoch_mode : {None, "sampled", "grouped", "grouped_pool", "grouped_pool_ids", 0, 1, 2, 3}
        How an epoch visits the training pairs. ``"grouped"`` (1) streams
        every positive exactly once per epoch out of bucketed CSR chunks,
        each entry's negative drawn from the interaction multiset;
        ``"sampled"`` (0) draws nnz uniform positives with replacement (the
        reference's schedule). ``"grouped_pool"`` (2) is grouped with each
        row's negatives, their factors and their biases taken from a window
        of a shuffled epoch-start popularity snapshot; ``"grouped_pool_ids"``
        (3) takes only the ids and biases from the window and gathers the
        live factors. None (default) follows the module's ``BPR_GROUPED``
        (1). The mesh path always trains ``"sampled"``.
    device : str or torch.device, optional
        Where the epochs run and the serving tables live; default "cuda".
        Asking for CUDA where there is none raises.
    """

    def __init__(
        self,
        factors=100,
        learning_rate=0.01,
        regularization=0.01,
        dtype=np.float32,
        iterations=100,
        num_threads=0,
        verify_negative_samples=True,
        random_state=None,
        mesh=None,
        epoch_mode=None,
        device="cuda",
    ):
        super().__init__(num_threads=num_threads, device=device)
        self.factors = factors
        self.learning_rate = learning_rate
        self.iterations = iterations
        self.regularization = regularization
        self.dtype = np.dtype(dtype)
        self.verify_negative_samples = verify_negative_samples
        self.random_state = random_state
        check_mesh_arg(mesh)
        self.mesh = mesh
        self.epoch_mode = epoch_mode
        self._resolve_epoch_mode()

    def _resolve_epoch_mode(self):
        """0 (sampled), 1 (grouped), 2 (grouped_pool) or 3
        (grouped_pool_ids) for ``epoch_mode``; None is ``BPR_GROUPED``."""
        if self.epoch_mode is None:
            return BPR_GROUPED
        try:
            return _EPOCH_MODES[self.epoch_mode]
        except (KeyError, TypeError):
            raise ValueError(f"epoch_mode must be 'sampled', 'grouped', 'grouped_pool' or "
                             f"'grouped_pool_ids', got {self.epoch_mode!r}") from None

    def fit(self, user_items, show_progress=True, callback=None):
        """Factorizes the user_items matrix (values treated as binary likes).

        ``callback``, if given, is called after every epoch with (epoch,
        seconds, correct, skipped).
        """
        rs = check_random_state(self.random_state)
        mesh = self._serving_mesh()  # resolved (and refused) before anything is fitted
        epoch_mode = self._resolve_epoch_mode()  # BPR_GROUPED read now, as in JAX
        grouped = bool(epoch_mode) and mesh is None
        pool_mode = _POOL_MODES[epoch_mode] if grouped else 0
        dev = self.device if mesh is None else mesh.devices[0]
        devices = [dev] if mesh is None else mesh.distinct()

        with timed_step("prepare", dev):
            if user_items.dtype != np.float32:
                user_items = user_items.astype(np.float32)
            user_items = check_csr(user_items)
            if self.verify_negative_samples and not user_items.has_sorted_indices:
                user_items.sort_indices()
            users, items = user_items.shape
            user_counts = np.ediff1d(user_items.indptr)
            userids = np.repeat(np.arange(users, dtype=np.int32), user_counts)

        # factors+1 layout, drawn as the JAX package draws them (items
        # first): last column the item bias, the user column pinned to 1
        F = self.factors
        with timed_step("factor draw", dev):
            if self.item_factors is None:
                self.item_factors = (rs.random((items, F + 1), dtype=np.float32) - 0.5) / F
                item_counts = np.bincount(user_items.indices, minlength=items)
                self.item_factors[item_counts == 0] = np.zeros(F + 1)
            if self.user_factors is None:
                self.user_factors = (rs.random((users, F + 1), dtype=np.float32) - 0.5) / F
                self.user_factors[user_counts == 0] = np.zeros(F + 1)
                self.user_factors[:, F] = 1.0
        if not np.allclose(self.user_factors[:, F], 1.0):
            # the split-bias device layout scores with the user bias column
            # fixed at its pinned value
            log.warning("BPR pins the user bias column (user_factors[:, factors]) "
                        "to 1.0 during training; overwriting supplied values")
            self.user_factors[:, F] = 1.0

        self._user_norms = self._item_norms = None

        samples = len(user_items.data)
        if samples == 0:
            self._check_factors(torch.as_tensor(self.user_factors),
                                torch.as_tensor(self.item_factors))
            return

        batch = int(min(_MAX_BATCH, max(64, 1 << int(np.ceil(np.log2(max(samples // 64, 1)))))))
        steps = max(1, -(-samples // batch))
        bisect_iters = int(np.ceil(np.log2(max(int(user_counts.max()), 2)))) + 1

        # exact O(1) negative verification via the cuckoo pair table; the
        # bisection handles shapes the table can't
        bits, pt = None, None
        if self.verify_negative_samples:
            with timed_step("pair table", dev):
                pt = membership.build_pair_table(user_items, row_ids=userids)
                if pt is not None:
                    bits = pt.bits

        # device layout: (.., factors) blocks + a separate item-bias vector,
        # one replica (and one copy of the flats) per distinct device
        replicas, flats = {}, {}
        with timed_step("upload", devices):
            for d in devices:
                replicas[d] = tuple(torch.tensor(a, dtype=torch.float32, device=d) for a in (
                    self.user_factors[:, :F], self.item_factors[:, :F], self.item_factors[:, F]))
                flats[d] = (None if grouped else torch.as_tensor(userids.astype(np.int64), device=d),
                            torch.as_tensor(user_items.indices.astype(np.int64), device=d),
                            torch.as_tensor(user_items.indptr.astype(np.int64), device=d),
                            None if pt is None else pt.to_device(d))
        X, Y, yb = replicas[dev]
        uids, itemids, indptr, table = flats[dev]
        if grouped:
            with timed_step("chunks", dev):
                classes = grouped_classes(user_items, dev)
        arrangement = None
        if pool_mode:
            # drawn where the JAX package draws it: after the starting
            # factors, before the epochs' seed
            with timed_step("arrangement", dev):
                arrangement = torch.as_tensor(pool_arrangement(
                    rs, user_items, max(idx.shape[2] for _, idx, _, _ in classes)
                ).astype(np.int64), device=dev)

        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rs.integers(0, 2**31)))
        # float32 rates, as the JAX package passes them
        lr, reg = float(np.float32(self.learning_rate)), float(np.float32(self.regularization))
        verify = dict(verify_neg=self.verify_negative_samples, bisect_iters=bisect_iters,
                      bits=bits)

        log.debug("Running %i BPR training epochs", self.iterations)
        with tqdm(total=self.iterations, disable=not show_progress) as progress:
            for epoch in range(self.iterations):
                s = time.time()
                if grouped:
                    draws = (_pool_draws(gen, classes, arrangement.shape[0]) if pool_mode
                             else _group_draws(gen, classes, samples))
                    correct, skipped = _bpr_epoch_grouped(
                        X, Y, yb, classes, itemids, indptr, table, draws, lr, reg,
                        pool_mode=pool_mode, arrangement=arrangement, **verify)
                    total = samples  # every positive visited exactly once
                elif mesh is not None:
                    # each shard draws ceil(batch / D) samples per step
                    local_batch = -(-batch // mesh.size)
                    correct, skipped = _bpr_epoch_sharded(
                        replicas, flats,
                        _shard_sample_draws(gen, steps, local_batch, samples, mesh), lr, reg,
                        mesh=mesh, **verify)
                    total = steps * local_batch * mesh.size
                else:
                    correct, skipped = _bpr_epoch(
                        X, Y, yb, uids, itemids, indptr, table,
                        _sample_draws(gen, steps, batch, samples), lr, reg, **verify)
                    total = steps * batch
                correct, skipped = int(correct), int(skipped)  # waits for the epoch
                progress.update(1)
                if total != skipped:
                    progress.set_postfix({
                        "train_auc": f"{100.0 * correct / (total - skipped):0.2f}%",
                        "skipped": f"{100.0 * skipped / total:0.2f}%",
                    })
                if callback:
                    callback(epoch, time.time() - s, correct, skipped)

        # the public factors+1 layout: the bias as trailing column, the user
        # bias column pinned to 1.0
        with timed_step("copy back", dev):
            users_f = np.empty((users, F + 1), dtype=self.dtype)
            users_f[:, :F] = X.cpu().numpy()
            users_f[:, F] = self.user_factors[:, F]
            items_f = np.empty((items, F + 1), dtype=self.dtype)
            items_f[:, :F] = Y.cpu().numpy()
            items_f[:, F] = yb.cpu().numpy()
        self.user_factors, self.item_factors = users_f, items_f
        self._check_factors(torch.from_numpy(users_f), torch.from_numpy(items_f))

    # the npz layout both packages save and load
    SAVE_KEYS = ("user_factors", "item_factors", "regularization", "factors",
                 "learning_rate", "verify_negative_samples", "num_threads", "iterations",
                 "dtype", "random_state")
