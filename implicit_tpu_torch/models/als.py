"""Implicit-feedback Alternating Least Squares on one device or a mesh.

The counterpart of ``implicit_tpu/models/als.py``: the Hu/Koren/Volinsky
implicit ALS objective with the Takács et al. conjugate-gradient speedup.
Each half-iteration re-solves whole chunks of rows of a
:class:`~implicit_tpu_torch.sparse.BucketedCSR` in the CUDA solve kernels
(see :mod:`implicit_tpu_torch.ops.als`); with ``mesh=`` every shard of the
row-sharded layout does so for its own rows
(:mod:`implicit_tpu_torch.parallel.als_sharded`).
"""

import logging
import time

import numpy as np
import scipy
import scipy.linalg
import scipy.sparse
import torch
from tqdm.auto import tqdm

from .. import tracing
from ..ops import als as als_ops
from ..ops import pcg64
from ..parallel import als_sharded
from ..parallel.mesh import check_mesh_arg
from ..sparse import als_chunk_target, pack_on_device, pack_pair_on_device
from ..tracing import timed_step
from ..utils import check_csr, check_random_state
from .mf_base import MatrixFactorizationBase

log = logging.getLogger("implicit_tpu_torch")


def _drop_stored_zeros(csr):
    """Removes explicitly stored zero entries before bucketing.

    The solves read data == 0 as padding, so a stored zero is made explicit
    as "unobserved" (P = 0, background C = 1), as in the JAX package.
    """
    if csr.nnz and not csr.data.all():
        csr = csr.copy()
        csr.eliminate_zeros()
    return csr


def _as_torch_dtype(dtype):
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class AlternatingLeastSquares(MatrixFactorizationBase):
    """Alternating Least Squares.

    A recommendation model based on the algorithms described in
    'Collaborative Filtering for Implicit Feedback Datasets' with performance
    optimizations from 'Applications of the Conjugate Gradient Method for
    Implicit Feedback Collaborative Filtering.'

    Parameters
    ----------
    factors : int, optional
        The number of latent factors to compute
    regularization : float, optional
        The regularization factor to use
    alpha : float, optional
        The weight to give to positive examples
    dtype : data-type, optional
        Storage dtype of the factors. 16-bit dtypes solve and serve in
        bfloat16 (float32 accumulation); float64 solves in float64 through
        the plain composed CG; everything else in float32.
    use_native : bool, optional
        Accepted for API parity
    use_cg : bool, optional
        Use the conjugate-gradient solver (3 steps) instead of batched dense
        normal-equation solves
    iterations : int, optional
        The number of ALS iterations to run when fitting
    calculate_training_loss : bool, optional
        Whether to compute the training loss each iteration
    num_threads : int, optional
        Accepted for API parity
    random_state : int, RandomState, Generator or None, optional
        Seeding for the initial factor matrices (numpy, so the same seed
        gives the JAX package's initial factors)
    mesh : parallel.Mesh or int, optional
        Train and serve over a mesh of devices, from this one process: both
        factor tables are sharded on their rows (row u on shard u % D), every
        shard solves its own rows in the CUDA kernels, and serving shards the
        item table (``parallel.als_sharded``, ``ops.topk``). An int n is
        ``parallel.create_mesh(n, device)``: n cards on CUDA (raising where
        fewer are visible; it never moves to the CPU), n virtual shards on
        the CPU; ``parallel.virtual_mesh(n, "cuda:0")`` runs n shards on one
        card. A meshed fit solves float32 for a float64 model, as the JAX
        package's does. None (default) trains on ``device``.
    grid : {"auto", "pow2", "fine"}, optional
        Row-length bucketing grid; "auto" means "pow2".
    ingest : {"auto", "host", "device"}, optional
        Accepted for API parity; the port packs on the model's device
        (:func:`~implicit_tpu_torch.sparse.pack_pair_on_device`).
    gather_quant : {False, True, "auto"}, optional
        Solve against an int8 per-row-scaled copy of the fixed-side factor
        table, dequantized inside the CUDA kernels (to bfloat16, as the JAX
        package's TPU kernels do). "auto" enables it per side by the JAX
        package's rule: only for 16-bit compute, and only for a side whose
        gather table (the item table for the user side and vice versa) is
        larger than ``ops.als.VMEM_PROMO_BYTES`` (100 MiB) in bfloat16.
    device : str or torch.device, optional
        Where the solves run and the serving tables live; default "cuda".
        Asking for CUDA where there is none raises.
    """

    def __init__(
        self,
        factors=100,
        regularization=0.01,
        alpha=1.0,
        dtype=np.float32,
        use_native=True,
        use_cg=True,
        iterations=15,
        calculate_training_loss=False,
        num_threads=0,
        random_state=None,
        mesh=None,
        grid="auto",
        ingest="auto",
        gather_quant=False,
        device="cuda",
    ):
        super().__init__(num_threads=num_threads, device=device)

        self.factors = factors
        self.regularization = regularization
        self.alpha = alpha

        self.dtype = np.dtype(dtype)
        self.use_native = use_native
        self.use_cg = use_cg
        self.iterations = iterations
        self.calculate_training_loss = calculate_training_loss
        self.fit_callback = None
        self.cg_steps = 3
        self.random_state = random_state
        check_mesh_arg(mesh)
        self.mesh = mesh
        if grid not in ("auto", "pow2", "fine"):
            raise ValueError(f"grid must be 'auto', 'pow2' or 'fine', got {grid!r}")
        self.grid = grid
        if ingest not in ("auto", "host", "device"):
            raise ValueError(f"ingest must be 'auto', 'host' or 'device', got {ingest!r}")
        self.ingest = ingest
        if gather_quant not in ("auto", True, False):
            raise ValueError(
                f"gather_quant must be 'auto', True or False, got {gather_quant!r}")
        self.gather_quant = gather_quant

        # cached f x f gramians
        self._YtY = None
        self._XtX = None

    def _gather_quant_sides(self, n_users, n_items):
        """gather_quant as per-side flags (user side, item side).

        The user half-iteration gathers from the item table and the item
        half from the user table. "auto" quantizes a side only for 16-bit
        compute and only when that side's gather table is larger than
        ``VMEM_PROMO_BYTES`` in bfloat16: the JAX package's rule
        (``implicit_tpu/models/als.py:_gather_quant_sides``), so both
        packages fit the same model from the same arguments. float32 models
        are never quantized by "auto".
        """
        if self.gather_quant == "auto":
            if self._compute_dtype != "bfloat16":
                return (False, False)
            lim = als_ops.VMEM_PROMO_BYTES
            return (n_items * self.factors * 2 > lim, n_users * self.factors * 2 > lim)
        return (bool(self.gather_quant),) * 2

    @property
    def _compute_dtype(self):
        """'bfloat16' for 16-bit storage, 'float64' for float64, else 'float32'."""
        if self.dtype.itemsize == 2:
            return "bfloat16"
        if self.dtype == np.float64:
            return "float64"
        return "float32"

    def fit(self, user_items, show_progress=True, callback=None):
        """Factorizes the user_items matrix.

        user_items defines both which items each user liked (P_ui) and the
        confidence (C_ui). Unset entries mean P=0, C=1; negative values mean
        "disliked" with confidence |value|.
        """
        with tracing.span("fit", factors=self.factors, iterations=self.iterations) as fit_span:
            random_state = check_random_state(self.random_state)
            solve_np = np.float64 if self._compute_dtype == "float64" else np.float32

            with timed_step("prepare", self.device):
                Cui = check_csr(user_items)
                if Cui.dtype != solve_np:
                    Cui = Cui.astype(solve_np)
                Cui = _drop_stored_zeros(Cui)
                if self.alpha != 1.0:
                    Cui = self.alpha * Cui

            users, items = Cui.shape
            fit_span.set(users=users, items=items, nnz=Cui.nnz)
            target = als_chunk_target(self.factors, self._compute_dtype)
            grid = "pow2" if self.grid == "auto" else self.grid
            if self.mesh is not None:
                step, loss_of, X, Y, devices, gather = self._set_up_sharded(
                    Cui, random_state, target, grid)
            else:
                user_buckets, item_buckets = pack_pair_on_device(
                    Cui, target_entries=target, max_chunk_rows=65536, grid=grid,
                    data_dtype=solve_np, device=self.device)
                # user table first: the JAX package's stream
                X = self._initial_factors(self.user_factors, users, random_state)
                Y = self._initial_factors(self.item_factors, items, random_state)
                kw = dict(use_cg=self.use_cg, cg_steps=self.cg_steps,
                          compute_dtype=self._compute_dtype,
                          gather_quant=self._gather_quant_sides(users, items))

                def step(X, Y):
                    return als_ops.fit(X, Y, user_buckets, item_buckets, self.regularization,
                                       1, **kw)

                def loss_of(X, Y):
                    return als_ops.calculate_loss_bucketed(user_buckets, X, Y,
                                                           self.regularization)

                devices, gather = [self.device], None

            self._item_norms = self._user_norms = None
            self._YtY = None
            self._XtX = None
            X, Y, loss = self._iterate(step, X, Y, devices, loss_of, show_progress,
                                       callback or self.fit_callback)
            X, Y = self._copy_back(X, Y, devices, gather)
            if self.calculate_training_loss:
                log.info("Final training loss %.4f", loss)
            self._check_factors(X, Y)

    def _set_up_sharded(self, Cui, random_state, target, grid):
        """The meshed fit's set-up, on the row-sharded layout
        (``parallel.als_sharded``): the layout of both sides and the
        starting factors (numpy's draws, as without a mesh) cut into the
        shards. Returns what :meth:`_iterate` and :meth:`_copy_back` take:
        the step, the loss, the shards of both tables, the mesh's distinct
        devices and the gather of the shards into row order. Solves float32
        for a float64 model, as the JAX package's meshed fit."""
        mesh = self._serving_mesh()
        devices, first = mesh.distinct(), mesh.devices[0]
        users, items = Cui.shape
        with timed_step("transpose", devices):
            Ciu = Cui.T.tocsr()
        kw = dict(target_entries=target, max_chunk_rows=65536, grid=grid)
        with timed_step("sharded pack user side", devices):
            user_sh = als_sharded.RowShardedBuckets(Cui, mesh, **kw)
        with timed_step("sharded pack item side", devices):
            item_sh = als_sharded.RowShardedBuckets(Ciu, mesh, **kw)
        # user table first: the JAX package's stream
        X = self._initial_factors(self.user_factors, users, random_state, first, torch.float32)
        Y = self._initial_factors(self.item_factors, items, random_state, first, torch.float32)
        with timed_step("permute and upload", devices):
            Xs = als_sharded.shard_rows(X, mesh, user_sh.block)
            Ys = als_sharded.shard_rows(Y, mesh, item_sh.block)
        del X, Y

        compute_dtype = "float32" if self._compute_dtype == "float64" else self._compute_dtype
        kw = dict(use_cg=self.use_cg, cg_steps=self.cg_steps, compute_dtype=compute_dtype,
                  gather_quant=self._gather_quant_sides(users, items))

        def step(Xs, Ys):
            return als_sharded.fit(Xs, Ys, user_sh, item_sh, mesh, self.regularization, 1,
                                   **kw)

        def loss_of(Xs, Ys):
            return als_sharded.calculate_loss(user_sh, Xs, Ys, self.regularization, mesh)

        def gather(Xs, Ys):
            return (als_sharded.gather_rows(Xs, users, first),
                    als_sharded.gather_rows(Ys, items, first))

        return step, loss_of, Xs, Ys, devices, gather

    def _iterate(self, step, X, Y, devices, loss_of, show_progress, callback):
        """The fit's iterations, one ``step(X, Y) -> (X, Y)`` each, on one
        device or over a mesh's ``devices``; returns X, Y and the last loss.
        The CUDA devices are synchronized after an iteration only where the
        callback or the training loss reads it."""
        loss = None
        log.debug("Running %i ALS iterations on %s", self.iterations, devices)
        with tqdm(total=self.iterations, disable=not show_progress) as progress:
            for iteration in range(self.iterations):
                s = time.perf_counter()
                with tracing.span("iteration", devices, iteration=iteration):
                    X, Y = step(X, Y)
                    if callback or self.calculate_training_loss:
                        for d in devices:
                            if d.type == "cuda":
                                torch.cuda.synchronize(d)
                progress.update(1)

                if self.calculate_training_loss:
                    loss = loss_of(X, Y)
                    progress.set_postfix({"loss": loss})
                    if not show_progress:
                        log.info("loss %.4f", loss)

                if callback:
                    callback(iteration, time.perf_counter() - s, loss)
        return X, Y, loss

    def _copy_back(self, X, Y, devices, gather=None):
        """Copies the fitted tables to the host in the storage dtype, as the
        model's factors; a meshed fit's shards are first gathered into row
        order (``gather``). Returns the device tables."""
        with timed_step("copy back", devices):
            if gather is not None:
                X, Y = gather(X, Y)
            storage = _as_torch_dtype(self.dtype)
            self.user_factors, self.item_factors = (T.to(storage).cpu().numpy() for T in (X, Y))
        return X, Y

    def _initial_factors(self, factors, n, random_state, device=None, solve=None):
        """The fit's starting (n, factors) table on ``device`` (default the
        model's), in the solve dtype (default the model's): a copy of
        ``factors`` where the model has them (the solves update it in
        place), else the JAX package's start, numpy's float32 draw times
        0.01 rounded to the storage dtype. On a CUDA device a PCG64 stream
        (any int, None or RandomState seed) is drawn there, scaled and
        rounded in one kernel (``ops.pcg64``); any other stream, or the CPU,
        takes numpy's draw, scaled and cast on the device. Both give numpy's
        bits and leave ``random_state`` where numpy's draw does."""
        device = self.device if device is None else device
        if solve is None:
            solve = torch.float64 if self._compute_dtype == "float64" else torch.float32
        if factors is not None:
            with timed_step("factor copy", device):
                return torch.tensor(np.asarray(factors), device=device).to(solve)
        storage = _as_torch_dtype(self.dtype)
        if device.type == "cuda" and type(random_state.bit_generator) is np.random.PCG64:
            with timed_step("factor draw", device):
                return pcg64.uniform_factors(random_state, (n, self.factors), storage,
                                             device).to(solve)
        tracing.count("init.host_draws")
        with timed_step("factor draw", device):
            draw = random_state.random((n, self.factors), dtype=np.float32)
        with timed_step("factor init", device):
            return (torch.as_tensor(draw, device=device) * 0.01).to(storage).to(solve)

    def _solve_rows(self, row_items, other_factors, gram):
        """Dense normal-equation solves for the rows of ``row_items``."""
        buckets = pack_on_device(_drop_stored_zeros(row_items), self.device)
        X = torch.zeros((row_items.shape[0], self.factors), dtype=torch.float32,
                        device=self.device)
        Y = torch.as_tensor(np.asarray(other_factors, dtype=np.float32), device=self.device)
        YtY_reg = torch.as_tensor(np.asarray(gram, dtype=np.float32), device=self.device) \
            + self.regularization * torch.eye(self.factors, device=self.device)
        for cls in buckets.classes:
            X = als_ops.cho_solve_scan(X, Y, YtY_reg, cls.rows, cls.indices, cls.data)
        return X.cpu().numpy().astype(self.dtype)

    def recalculate_user(self, userid, user_items):
        """Recalculates factors for a batch of users from their liked items."""
        user_items = check_csr(user_items)
        users = 1 if np.isscalar(userid) else len(userid)
        if user_items.shape[0] != users:
            raise ValueError("user_items should have one row for every item in user")
        if self.alpha != 1.0:
            user_items = self.alpha * user_items

        user_factors = self._solve_rows(user_items, self.item_factors, self.YtY)
        return user_factors[0] if np.isscalar(userid) else user_factors

    def recalculate_item(self, itemid, item_users):
        """Recalculates factors for a batch of items from their liking users."""
        item_users = check_csr(item_users)
        if self.alpha != 1.0:
            item_users = self.alpha * item_users

        item_factors = self._solve_rows(item_users, self.user_factors, self.XtX)
        return item_factors[0] if np.isscalar(itemid) else item_factors

    def partial_fit_users(self, userids, user_items):
        """Incrementally recalculates factors for the given users, growing storage."""
        if len(userids) != user_items.shape[0]:
            raise ValueError("user_items must contain 1 row for every user in userids")

        user_factors = self.recalculate_user(userids, user_items)

        users, factors = self.user_factors.shape
        max_userid = max(userids)
        if max_userid >= users:
            self.user_factors = np.concatenate(
                [self.user_factors, np.zeros((max_userid - users + 1, factors), dtype=self.dtype)]
            )

        self.user_factors[userids] = user_factors
        self._user_norms = None
        self._XtX = None
        self._user_factors_dev = None  # in-place update: refresh the device copy
        self._drop_mesh_cache("user")  # and the mesh's shards

    def partial_fit_items(self, itemids, item_users):
        """Incrementally recalculates factors for the given items, growing storage."""
        if len(itemids) != item_users.shape[0]:
            raise ValueError("item_users must contain 1 row for every user in itemids")

        item_factors = self.recalculate_item(itemids, item_users)

        items, factors = self.item_factors.shape
        max_itemid = max(itemids)
        if max_itemid >= items:
            self.item_factors = np.concatenate(
                [self.item_factors, np.zeros((max_itemid - items + 1, factors), dtype=self.dtype)]
            )

        self.item_factors[itemids] = item_factors
        self._item_norms = None
        self._YtY = None
        self._item_factors_dev = None  # in-place update: refresh the device copy
        self._drop_mesh_cache("item")  # and the mesh's shards

    def explain(self, userid, user_items, itemid, user_weights=None, N=10):
        """Explains why ``itemid`` is recommended to ``userid``.

        Returns (total_score, top N (itemid, contribution) pairs, user_weights)
        where user_weights is the Cholesky factorization of the user's weighted
        normal-equation matrix, reusable for repeated calls.
        """
        user_items = check_csr(user_items)
        if self.alpha != 1.0:
            user_items = self.alpha * user_items

        if user_weights is None:
            A, _ = user_linear_equation(
                self.item_factors, self.YtY, user_items, userid, self.regularization, self.factors
            )
            user_weights = scipy.linalg.cho_factor(A)

        # each liked item j contributes c_uj * (y_i^T A_u^-1 y_j) to item i
        kernel_row = scipy.linalg.cho_solve(user_weights, self.item_factors[itemid])

        row = user_items[userid]
        positive = row.data > 0  # disliked items explain nothing
        liked = row.indices[positive]
        contributions = (self.item_factors[liked] @ kernel_row) * row.data[positive]

        total_score = float(contributions.sum())
        best = np.argsort(contributions)[::-1][:N]
        top_contributions = [(int(liked[j]), float(contributions[j])) for j in best]
        return total_score, top_contributions, user_weights

    @property
    def solver(self):
        """Name of the active solver (informational)."""
        return "cg" if self.use_cg else "cholesky"

    @property
    def YtY(self):
        if self._YtY is None:
            # float32 accumulation even for 16-bit storage: 16-bit partial
            # sums can break the gram's positive-definiteness
            Y = np.asarray(self.item_factors, dtype=np.float32)
            self._YtY = Y.T.dot(Y)
        return self._YtY

    @property
    def XtX(self):
        if self._XtX is None:
            X = np.asarray(self.user_factors, dtype=np.float32)
            self._XtX = X.T.dot(X)
        return self._XtX

    # the npz layout both packages save and load
    SAVE_KEYS = (
        "user_factors", "item_factors", "regularization", "factors", "num_threads",
        "iterations", "use_native", "use_cg", "cg_steps", "calculate_training_loss",
        "dtype", "random_state", "alpha",
    )


def _user_row(Cui, u):
    """One CSR row of Cui as (item indices, A-weights |c|-1, b-values c^+)."""
    lo, hi = Cui.indptr[u], Cui.indptr[u + 1]
    conf = Cui.data[lo:hi]
    return Cui.indices[lo:hi], np.abs(conf) - 1.0, np.maximum(conf, 0.0)


def user_linear_equation(Y, YtY, Cui, u, regularization, n_factors):
    """Per-user normal equations ``A x = b``, vectorized over the row.

    A = YtY + reg*I + Yu^T diag(|c|-1) Yu, b = (c^+)^T Yu.
    """
    idx, w, bv = _user_row(Cui, u)
    Yu = Y[idx]
    A = YtY + regularization * np.eye(n_factors) + (Yu * w[:, None]).T @ Yu
    b = bv.astype(np.float64) @ Yu
    return A, b


def user_factor(Y, YtY, Cui, u, regularization, n_factors):
    """Solves a single user's factor (host-side reference path)."""
    A, b = user_linear_equation(Y, YtY, Cui, u, regularization, n_factors)
    return np.linalg.solve(A, b)


def item_factor(X, XtX, Cui, u, regularization, n_factors):
    """Solves a single item's factor against its liking users' factors."""
    return user_factor(X, XtX, Cui, u, regularization, n_factors)


def least_squares(Cui, X, Y, regularization, num_threads=0):
    """Pure-numpy row-by-row normal-equation solver (slow oracle)."""
    users, n_factors = X.shape
    YtY = Y.T @ Y
    for u in range(users):
        X[u] = user_factor(Y, YtY, Cui, u, regularization, n_factors)


def least_squares_cg(Cui, X, Y, regularization, num_threads=0, cg_steps=3):
    """Pure-numpy per-row conjugate-gradient solver (slow oracle).

    Same math as the device kernels: warm start from the current row, A
    applied implicitly as ``YtY v + Yu^T diag(|c|-1) (Yu v)``, per-row
    rs < 1e-20 early exit, ``cg_steps`` iterations.
    """
    users, factors = X.shape
    YtY = Y.T @ Y + regularization * np.eye(factors, dtype=Y.dtype)

    for u in range(users):
        idx, w, bv = _user_row(Cui, u)
        Yu = Y[idx]

        def apply_A(v):
            return YtY @ v + ((Yu @ v) * w) @ Yu

        x = X[u].copy()
        r = bv.astype(Y.dtype) @ Yu - apply_A(x)
        p = r.copy()
        rsold = r @ r
        if rsold < 1e-20:
            continue

        for _ in range(cg_steps):
            Ap = apply_A(p)
            alpha = rsold / (p @ Ap)
            x += alpha * p
            r -= alpha * Ap
            rsnew = r @ r
            if rsnew < 1e-20:
                break
            p = r + (rsnew / rsold) * p
            rsold = rsnew

        X[u] = x


calculate_loss = als_ops.calculate_loss
