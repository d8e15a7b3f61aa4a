"""Logistic Matrix Factorization on one device or a mesh.

The counterpart of ``implicit_tpu/models/lmf.py``: Johnson's 'Logistic
Matrix Factorization for Implicit Feedback Data', trained with per-row
AdaGrad, alternating user and item updates each epoch. The factor layout is
the reference's: two extra columns, with ``user[:, -2] == 1`` (so
``item[:, -2]`` acts as the item bias) and ``item[:, -1] == 1`` (so
``user[:, -1]`` acts as the user bias).

Each chunk of C rows of a bucket class is updated at once: positives as a
(C, L, F) block; negatives drawn popularity-weighted as one shared pool of
P = min(I, L * neg_prop) rows per 8-row group, of which each row uses its
own first ``len * neg_prop``. A pool is a window of a pre-shuffled bfloat16
snapshot of the other side's factors (``_build_pool``): one contiguous
slice at a random offset per group, gathered here as ``off + arange(P)``.
Where the snapshot would not fit the JAX package's budget, each pool entry
is drawn from the interaction column array instead (the legacy path). The
route rules, window against legacy and the two tail columns split out or
glued on, are the JAX package's, set by the TPU's 128-lane padding, so both
packages take the same route on the same data.

Negatives are scored and combined from bfloat16 operands with float32
results, as the JAX package's einsums with ``preferred_element_type=float32``
are: the operands are rounded to bfloat16 and the products run in float32
(``_bf16_bmm``); no result is rounded to bfloat16.

Draws: each chunk's window offsets (or legacy entry draws) come from the
model's ``torch.Generator`` (``_pool_draws``), apart from the update, so the
update can be fed any draws. The arrangements are shuffled with numpy's
stream, so they are the JAX package's for the same ``random_state``.

Over a mesh (``mesh=``, :meth:`LogisticMatrixFactorization._fit_sharded`),
the factors are replicated on every device and each chunk's rows split over
the shards (``_lmf_class_update_sharded``, ``_shard_pool_draws``), as the
JAX package's meshed fit; its periodic re-shuffle is numpy's there too.
"""

import logging
import time

import numpy as np
import torch
import torch.nn.functional as nnf
from tqdm.auto import tqdm

from .._device import full_f32_matmul
from ..parallel.mesh import check_mesh_arg, replicated, shard_buckets
from ..sparse import BucketedCSR, pack_pair_on_device
from ..tracing import timed_step
from ..utils import check_csr, check_random_state
from .mf_base import MatrixFactorizationBase

log = logging.getLogger("implicit_tpu_torch")

# epochs between window-pool permutation refreshes: a fixed arrangement over
# a long fit would make every epoch draw windows of the same permutation
_POOL_RESHUFFLE_EPOCHS = 4

# window pools beyond this (in the JAX package's TPU layout, _pool_bytes)
# fall back to the legacy per-entry draws
_POOL_BYTE_BUDGET = 5 << 30


def _bf16_bmm(a, b):
    """``a @ b`` (batched) in float32, ``a`` rounded to bfloat16 first;
    ``b`` is float32 holding bfloat16 values (a pool block). The products of
    two bfloat16 values are exact in float32, so this is the JAX package's
    bfloat16 einsum with a float32 result, up to the summation order."""
    with full_f32_matmul():
        return torch.bmm(a.to(torch.bfloat16).float(), b)


def _row_update(X, dss, Y, neg_src, crows, cidx, cdat, clen, draw, lr, reg, neg_prop,
                neg_count, window=True):
    """AdaGrad-updated (x, d) for one chunk's rows.

    X, dss : (U, F) factors and AdaGrad squared-gradient accumulators
    Y : (I, F) fixed factors of the other side
    neg_src : with ``window``, the pool of :func:`_build_pool` (a tuple when
        split); else the (span,) interaction column array
    crows/cidx/cdat/clen : (C,) / (C, L) chunk tensors (padding: cdat == 0)
    draw : with ``window``, (G,) window offsets, one per 8-row group; else
        (G, neg_count) positions into ``neg_src`` (``_pool_draws``)
    neg_count : the shared pool size min(I, L * neg_prop); row c uses its
        first min(I, clen[c] * neg_prop) entries
    """
    n_rows = X.shape[0]
    safe_rows = crows.clamp(max=n_rows - 1)
    x, d = X[safe_rows], dss[safe_rows]
    Yu = Y[cidx]  # (C, L, F)

    # positives: sum_i c_i y_i - sum_i sigmoid(x.y_i) c_i y_i (padding
    # entries carry c == 0 and vanish from both terms)
    with full_f32_matmul():
        s_pos = torch.sigmoid(torch.bmm(Yu, x[:, :, None])[:, :, 0]) * cdat
        pos = torch.bmm((cdat - s_pos)[:, None, :], Yu)[:, 0]

    # negatives: one popularity-weighted pool per 8-row group
    C, F = x.shape
    G = -(-C // 8)
    xg = nnf.pad(x, (0, 0, 0, G * 8 - C)).reshape(G, 8, F)
    ncount = torch.clamp(clen.to(torch.int64) * neg_prop, max=Y.shape[0])
    nmask = torch.arange(neg_count, device=x.device)[None, :] < ncount[:, None]

    def by_group(s):  # (G, 8, P) -> (C, P), the pad rows dropped
        return s.reshape(G * 8, neg_count)[:C]

    def pad_groups(s):  # (C, P) -> (G, 8, P)
        return nnf.pad(s, (0, 0, 0, G * 8 - C)).reshape(G, 8, neg_count)

    if window:  # G window slices of the pool at the drawn offsets
        pos_w = draw[:, None] + torch.arange(neg_count, device=x.device)
    if window and isinstance(neg_src, tuple):
        # split pool: the factor block plus the two tail columns; score =
        # f-dot + u0 t0 + u1 t1 covers both sides (user rows end [1, b_u],
        # item rows [b_i, 1])
        Yn, tn0, tn1 = (a[pos_w].float() for a in neg_src)  # (G, P, F-2), (G, P), (G, P)
        logits = (_bf16_bmm(xg[:, :, : F - 2], Yn.transpose(1, 2))
                  + xg[:, :, F - 2, None] * tn0[:, None, :]
                  + xg[:, :, F - 1, None] * tn1[:, None, :])
        s_pad = pad_groups(by_group(torch.sigmoid(logits)) * nmask)
        neg = torch.cat([_bf16_bmm(s_pad, Yn), _bf16_bmm(s_pad, tn0[:, :, None]),
                         _bf16_bmm(s_pad, tn1[:, :, None])], dim=-1).reshape(G * 8, F)[:C]
    else:
        if window:  # glued full-width pool
            Yn = neg_src[pos_w].float()
        else:  # legacy per-entry draws from the interaction column array
            Yn = Y[neg_src[draw]].to(torch.bfloat16).float()
        s_neg = by_group(torch.sigmoid(_bf16_bmm(xg, Yn.transpose(1, 2)))) * nmask
        neg = _bf16_bmm(pad_groups(s_neg), Yn).reshape(G * 8, F)[:C]

    deriv = pos - neg - reg * x
    d = d + deriv * deriv
    x = x + (lr / torch.sqrt(1e-6 + d)) * deriv
    return x, d


def _reshuffle_arrangement(gen, core, pmax):
    """A fresh device-side permutation of the popularity multiset ``core``,
    wrap-padded by the largest pool width (the layout ``_arrangement``
    builds)."""
    p = core[torch.randperm(core.shape[0], generator=gen, device=core.device)]
    segments = [p]
    pad = pmax
    while pad > 0:
        take = min(pad, core.shape[0])
        segments.append(p[:take])
        pad -= take
    return torch.cat(segments) if len(segments) > 1 else p


def _build_pool(Y, arrangement, split):
    """The other side's factors gathered through the popularity shuffle, in
    bfloat16: glued full-width rows, or with ``split`` the factor block plus
    the two tail columns (bias / pinned one, their roles mirrored between
    the sides) as 1-D arrays (:func:`_pool_split`)."""
    rows = Y.to(torch.bfloat16)[arrangement]
    if not split:
        return rows
    return rows[:, :-2].contiguous(), rows[:, -2].contiguous(), rows[:, -1].contiguous()


def _pool_split(width):
    """Split the tails out only when they would force an extra 128-lane tile
    (the JAX package's rule, kept so both packages route alike)."""
    return -(-width // 128) > -(-(width - 2) // 128)


def _pool_bytes(nnz, pmax, width):
    """The JAX package's TPU footprint of a window pool (width = factors + 2,
    rows padded to 128 lanes): the budget rule's input."""
    if _pool_split(width):
        f_pad = -(-(width - 2) // 128) * 128
        return (nnz + pmax) * (f_pad * 2 + 4)
    return (nnz + pmax) * (-(-width // 128) * 128) * 2


def _wrap_pad(arr, pmax):
    """``arr`` followed by its first ``pmax`` entries, repeated as needed,
    so a window of up to ``pmax`` can start at any offset in [0, len)."""
    reps = [arr]
    pad = pmax
    while pad > 0:
        reps.append(arr[:pad])
        pad -= len(reps[-1])
    return np.concatenate(reps) if len(reps) > 1 else arr


def _arrangement(rs, cols, pmax, window):
    """The pool's popularity arrangement: ``cols`` shuffled with numpy's
    stream and wrap-padded (window), or ``cols`` itself (legacy)."""
    arr = cols.astype(np.int32)  # a fresh copy
    if not window:
        return arr
    rs.shuffle(arr)
    return _wrap_pad(arr, pmax)


def _pool_draws(gen, cls, neg_count, span, window):
    """Each chunk's draws, in chunk order: (G,) window offsets in [0, span),
    or (G, neg_count) legacy positions in [0, span)."""
    G = -(-cls.C // 8)
    shape = (G,) if window else (G, neg_count)
    for _ in range(cls.n_chunks):
        yield torch.randint(0, span, shape, generator=gen, device=gen.device)


def _lmf_class_update(X, dss, Y, neg_src, cls, draws, lr, reg, neg_prop, neg_count, pin_col,
                      window=True):
    """AdaGrad update, in place, of the X rows of every chunk of one bucket
    class, then the pinned column set back to 1. ``cls`` holds (rows,
    indices, data, lengths, n_valid); sentinel rows sit at each chunk's end
    and are not written."""
    draws = iter(draws)
    for crows, cidx, cdat, clen, nv in zip(cls.rows, cls.indices, cls.data, cls.lengths,
                                            cls.n_valid):
        x, d = _row_update(X, dss, Y, neg_src, crows, cidx, cdat, clen, next(draws), lr, reg,
                           neg_prop, neg_count, window)
        X[crows[:nv]] = x[:nv]
        dss[crows[:nv]] = d[:nv]
    X[:, pin_col] = 1.0


def _shard_pool_draws(gen, cls, neg_count, span, window, mesh):
    """The meshed class update's draws: per chunk, in chunk order, a list
    over the shards of each shard's (G,) window offsets or (G, neg_count)
    legacy positions in [0, span), G = ceil(C / 8) of the shard's C rows of
    a chunk; drawn on ``gen``'s device shard by shard and moved to the
    shard's device."""
    G = -(-cls.C // 8)
    shape = (G,) if window else (G, neg_count)
    for _ in range(cls.n_chunks):
        yield [torch.randint(0, span, shape, generator=gen, device=gen.device).to(d)
               for d in mesh.devices]


def _real_positions(cls, mesh, n_rows):
    """Per chunk of a ``parallel.ShardedBucketClass``, {device: the positions
    of the chunk's real rows in its shard-order concatenation}, on each
    distinct device: the rows a meshed update writes. The sentinel rows (id
    ``n_rows``) that end a chunk and pad it to a multiple of the mesh size,
    filling the last shards' slices, are left out."""
    rows = torch.cat([r.cpu() for r in cls.rows], dim=1)
    pos = [torch.nonzero(r < n_rows).squeeze(1) for r in rows]
    return [{d: p.to(d) for d in mesh.distinct()} for p in pos]


def _lmf_class_update_sharded(replicas, pools, cls, draws, lr, reg, neg_prop, neg_count,
                              pin_col, mesh, real, window=True):
    """The meshed AdaGrad update, in place, of every chunk of one bucket
    class (the JAX package's ``_build_sharded_class_update``).

    ``replicas`` maps each distinct device to its (X, dss, Y), ``pools`` to
    its pool (or column array); ``cls`` is a ``parallel.ShardedBucketClass``,
    ``draws`` yields each chunk's per-shard draws
    (:func:`_shard_pool_draws`) and ``real`` each chunk's real-row positions
    (:func:`_real_positions`). Per chunk, every shard runs ``_row_update``
    on its row slice against its device's replica; the solved rows and
    their AdaGrad state, gathered in shard order, are written on every
    distinct device, sentinel rows left out. Then the pinned column is set
    back to 1.
    """
    draws = iter(draws)
    for j in range(cls.n_chunks):
        parts = []
        for k, (d, draw) in enumerate(zip(mesh.devices, next(draws))):
            X, dss, Y = replicas[d]
            x, dd = _row_update(X, dss, Y, pools[d], cls.rows[k][j], cls.indices[k][j],
                                cls.data[k][j], cls.lengths[k][j], draw, lr, reg, neg_prop,
                                neg_count, window)
            parts.append((cls.rows[k][j], x, dd))
        for d in mesh.distinct():
            rows, x, dd = (torch.cat([p[i].to(d) for p in parts]) for i in range(3))
            X, dss, _ = replicas[d]
            keep = real[j][d]
            X[rows[keep]] = x[keep]
            dss[rows[keep]] = dd[keep]
    for d in mesh.distinct():
        replicas[d][0][:, pin_col] = 1.0


class LogisticMatrixFactorization(MatrixFactorizationBase):
    """Logistic Matrix Factorization.

    Learns a probabilistic like/not-like factorization per 'Logistic Matrix
    Factorization for Implicit Feedback Data'.

    Parameters
    ----------
    factors : int, optional
        The number of latent factors (two extra bias columns are stored)
    learning_rate : float, optional
    regularization : float, optional
    dtype : data-type, optional
        Storage dtype of the factors; training runs in float32
    iterations : int, optional
        The number of training epochs
    neg_prop : int, optional
        Negative samples drawn per observed interaction
    num_threads : int, optional
        Accepted for API parity
    random_state : int, RandomState, Generator or None, optional
        Seeds numpy's draws of the starting factors and the pool
        arrangements (so the same seed gives the JAX package's), then the
        device generator of the epochs' draws
    mesh : parallel.Mesh or int, optional
        Train and serve over a mesh of devices, from this one process: each
        chunk's rows split over the shards (``parallel.shard_buckets`` of
        the host bucketing), every shard updates its slice against its own
        negative pools, and the updated rows are gathered and written into
        every device's factor replica; serving shards the item table, as
        ``AlternatingLeastSquares(mesh=)`` does. The pools re-shuffle with
        numpy's stream, as the JAX package's meshed fit does, so the
        arrangements are its. An int n is ``parallel.create_mesh(n,
        device)``: n cards on CUDA (raising where fewer are visible), n
        virtual shards on the CPU. None (default) trains on ``device``.
    ingest : {"auto", "host", "device"}, optional
        Accepted for API parity; the port packs on the model's device
        (:func:`~implicit_tpu_torch.sparse.pack_pair_on_device`).
    device : str or torch.device, optional
        Where the epochs run and the serving tables live; default "cuda".
        Asking for CUDA where there is none raises.
    """

    def __init__(
        self,
        factors=30,
        learning_rate=1.00,
        regularization=0.6,
        dtype=np.float32,
        iterations=30,
        neg_prop=30,
        num_threads=0,
        random_state=None,
        mesh=None,
        ingest="auto",
        device="cuda",
    ):
        super().__init__(num_threads=num_threads, device=device)
        self.factors = factors
        self.learning_rate = learning_rate
        self.iterations = iterations
        self.regularization = regularization
        self.dtype = np.dtype(dtype)
        self.neg_prop = neg_prop
        self.random_state = random_state
        check_mesh_arg(mesh)
        self.mesh = mesh
        if ingest not in ("auto", "host", "device"):
            raise ValueError(f"ingest must be 'auto', 'host' or 'device', got {ingest!r}")
        self.ingest = ingest

    def fit(self, user_items, show_progress=True, callback=None):
        """Factorizes the user_items matrix (values treated as confidences).

        ``callback``, if given, is called after every epoch with (epoch,
        seconds), the device synchronized first.
        """
        rs = check_random_state(self.random_state)
        mesh = self._serving_mesh()  # resolved (and refused) before anything is fitted
        dev = self.device if mesh is None else mesh.devices[0]

        with timed_step("prepare", dev):
            if user_items.dtype != np.float32:
                user_items = user_items.astype(np.float32)
            user_items = check_csr(user_items)
            users, items = user_items.shape
            # the item side's column array orders its arrangement's shuffle,
            # so it is the host transpose's, as in the JAX package
            item_users = user_items.T.tocsr()
            if not item_users.has_sorted_indices:
                item_users.sort_indices()
            if not user_items.has_sorted_indices:
                user_items.sort_indices()
            user_counts = np.ediff1d(user_items.indptr)
            item_counts = np.bincount(user_items.indices, minlength=items)

        # factors+2 layout, drawn as the JAX package draws them (items first)
        with timed_step("factor draw", dev):
            if self.item_factors is None:
                self.item_factors = rs.standard_normal(size=(items, self.factors + 2),
                                                       dtype=np.float32)
                self.item_factors[:, -1] = 1.0
                self.item_factors[item_counts == 0] = np.zeros(self.factors + 2)
            if self.user_factors is None:
                self.user_factors = rs.standard_normal(size=(users, self.factors + 2),
                                                       dtype=np.float32)
                self.user_factors[:, -2] = 1.0
                self.user_factors[user_counts == 0] = np.zeros(self.factors + 2)

        self._user_norms = self._item_norms = None

        if user_items.nnz == 0:
            self._check_factors(torch.as_tensor(self.user_factors),
                                torch.as_tensor(self.item_factors))
            return

        # chunk sizing (the JAX package's): the (C, L * neg_prop) negative
        # score matrix and its sigmoid are the big live intermediates, so
        # C * L is bounded to keep ~3 float32 copies of them within 768 MB
        target = max(1 << 14, (768 << 20) // (max(1, self.neg_prop) * 12))
        if mesh is not None:
            return self._fit_sharded(user_items, item_users, rs, target, mesh, show_progress,
                                     callback)
        user_buckets, item_buckets = pack_pair_on_device(
            user_items, item_users, target_entries=target, grid="pow2", device=dev)
        with timed_step("factor upload", dev):
            X = torch.tensor(self.user_factors, dtype=torch.float32, device=dev)
            Y = torch.tensor(self.item_factors, dtype=torch.float32, device=dev)
            dssX, dssY = torch.zeros_like(X), torch.zeros_like(Y)

        # popularity arrangements for the window pools: the interaction
        # column multiset, shuffled once per fit, wrap-padded by the largest
        # pool so every offset in [0, nnz) has a full window
        span = user_items.nnz
        neg_counts, pmax, window, split = self._pool_routes(user_buckets, item_buckets, span,
                                                            users, items)
        (pmax_u, pmax_i), (window_u, window_i) = (
            (d["user"], d["item"]) for d in (pmax, window))
        with timed_step("arrangements", dev):
            arr_u, arr_i = (
                torch.as_tensor(_arrangement(rs, cols, pmax, window).astype(np.int64), device=dev)
                for cols, pmax, window in ((user_items.indices, pmax_u, window_u),
                                           (item_users.indices, pmax_i, window_i)))

        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rs.integers(0, 2**31)))
        # float32 rates, as the JAX package passes them
        kw = dict(lr=float(np.float32(self.learning_rate)),
                  reg=float(np.float32(self.regularization)), neg_prop=self.neg_prop)

        log.debug("Running %i LMF training epochs", self.iterations)
        with tqdm(total=self.iterations, disable=not show_progress) as progress:
            for epoch in range(self.iterations):
                s = time.time()
                if epoch and epoch % _POOL_RESHUFFLE_EPOCHS == 0:
                    if window_u:
                        arr_u = _reshuffle_arrangement(gen, arr_u[:span], pmax_u)
                    if window_i:
                        arr_i = _reshuffle_arrangement(gen, arr_i[:span], pmax_i)
                # each half-epoch's pool snapshots the fixed side's factors
                for side, (T, dss, other, arr, window, pin) in (
                        ("user", (X, dssX, Y, arr_u, window_u, -2)),
                        ("item", (Y, dssY, X, arr_i, window_i, -1))):
                    buckets = user_buckets if side == "user" else item_buckets
                    pool = _build_pool(other, arr, split) if window else arr
                    for cls, neg_count in zip(buckets.classes, neg_counts[side]):
                        _lmf_class_update(T, dss, other, pool, cls,
                                          _pool_draws(gen, cls, neg_count, span, window),
                                          neg_count=neg_count, pin_col=pin, window=window, **kw)
                    del pool
                progress.update(1)
                if callback:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)  # the callback reports wall time
                    callback(epoch, time.time() - s)

        with timed_step("copy back", dev):
            self.user_factors = X.cpu().numpy().astype(self.dtype)
            self.item_factors = Y.cpu().numpy().astype(self.dtype)
        self._check_factors(X, Y)

    def _pool_routes(self, user_buckets, item_buckets, span, users, items):
        """Each side's pool sizes per class, its largest, whether its pool is
        a window (else legacy draws), and whether the tails split out."""
        neg_counts = {
            side: [int(min(n_other, cls.L * self.neg_prop)) for cls in buckets.classes]
            for side, buckets, n_other in (("user", user_buckets, items),
                                           ("item", item_buckets, users))}
        pmax = {side: max(neg_counts[side], default=1) for side in neg_counts}
        width = self.factors + 2
        window = {side: _pool_bytes(span, pmax[side], width) <= _POOL_BYTE_BUDGET
                  for side in neg_counts}
        split = _pool_split(width)
        log.debug("LMF negative pools: user side %s, item side %s, tails %s",
                  "window" if window["user"] else "legacy",
                  "window" if window["item"] else "legacy", "split" if split else "glued")
        return neg_counts, pmax, window, split

    def _fit_sharded(self, user_items, item_users, rs, target, mesh, show_progress, callback):
        """The fit over ``mesh`` on the replicated-factor layout, as the JAX
        package's meshed fit: the host bucketing (pow2 grid) with every
        chunk's rows split over the shards (``parallel.shard_buckets``),
        the factors, AdaGrad state and pools replicated on every distinct
        device, and the periodic re-shuffle made with numpy's stream on the
        host (``rs.shuffle`` of the unpadded arrangement), so the
        arrangements equal the JAX package's meshed fit's."""
        devices, first = mesh.distinct(), mesh.devices[0]
        users, items = user_items.shape
        with timed_step("sharded pack", devices):
            user_buckets, item_buckets = (
                shard_buckets(BucketedCSR(m, target_entries=target, grid="pow2"), mesh)
                for m in (user_items, item_users))
            real = {side: [_real_positions(cls, mesh, b.n_rows) for cls in b.classes]
                    for side, b in (("user", user_buckets), ("item", item_buckets))}
        with timed_step("factor upload", devices):
            replicas = {}
            for d, X, Y in zip(mesh.devices,
                               replicated(mesh, np.asarray(self.user_factors, np.float32)),
                               replicated(mesh, np.asarray(self.item_factors, np.float32))):
                replicas[d] = (X, torch.zeros_like(X), Y, torch.zeros_like(Y))

        span = user_items.nnz
        neg_counts, pmax, window, split = self._pool_routes(user_buckets, item_buckets, span,
                                                            users, items)
        with timed_step("arrangements", devices):
            host = {side: _arrangement(rs, cols, pmax[side], window[side]).astype(np.int64)
                    for side, cols in (("user", user_items.indices),
                                       ("item", item_users.indices))}
            # the unpadded cores, re-shuffled on the host every few epochs
            core = {side: host[side][:span].copy() for side in host if window[side]}
            arr = {side: dict(zip(mesh.devices, replicated(mesh, host[side]))) for side in host}
            del host

        gen = torch.Generator(device=first)
        gen.manual_seed(int(rs.integers(0, 2**31)))
        kw = dict(lr=float(np.float32(self.learning_rate)),
                  reg=float(np.float32(self.regularization)), neg_prop=self.neg_prop)

        log.debug("Running %i LMF training epochs over %r", self.iterations, mesh)
        with tqdm(total=self.iterations, disable=not show_progress) as progress:
            for epoch in range(self.iterations):
                s = time.time()
                if epoch and epoch % _POOL_RESHUFFLE_EPOCHS == 0:
                    for side in core:
                        rs.shuffle(core[side])
                        arr[side] = dict(zip(mesh.devices, replicated(
                            mesh, _wrap_pad(core[side], pmax[side]))))
                for side, buckets, (t, o), pin in (("user", user_buckets, (0, 2), -2),
                                                   ("item", item_buckets, (2, 0), -1)):
                    # each device's pool snapshots its replica of the fixed side
                    pools = {d: _build_pool(replicas[d][o], arr[side][d], split)
                             if window[side] else arr[side][d] for d in devices}
                    views = {d: (r[t], r[t + 1], r[o]) for d, r in replicas.items()}
                    for cls, neg_count, cls_real in zip(buckets.classes, neg_counts[side],
                                                        real[side]):
                        _lmf_class_update_sharded(
                            views, pools, cls,
                            _shard_pool_draws(gen, cls, neg_count, span, window[side], mesh),
                            neg_count=neg_count, pin_col=pin, mesh=mesh, real=cls_real,
                            window=window[side], **kw)
                    del pools
                progress.update(1)
                if callback:
                    for d in devices:
                        if d.type == "cuda":
                            torch.cuda.synchronize(d)  # the callback reports wall time
                    callback(epoch, time.time() - s)

        X, _, Y, _ = replicas[first]
        with timed_step("copy back", devices):
            self.user_factors = X.cpu().numpy().astype(self.dtype)
            self.item_factors = Y.cpu().numpy().astype(self.dtype)
        self._check_factors(X, Y)

    # the npz layout both packages save and load
    SAVE_KEYS = ("user_factors", "item_factors", "regularization", "factors",
                 "learning_rate", "neg_prop", "num_threads", "iterations", "dtype",
                 "random_state")
