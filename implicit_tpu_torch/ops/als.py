"""Batched ALS solvers over bucketed CSR chunks.

The counterpart of ``implicit_tpu/ops/als.py``. A half-iteration re-solves
every row of one side against the fixed other side, a chunk of C rows at a
time, class by class (see :mod:`implicit_tpu_torch.sparse`):

- rows of length L <= :func:`_full_cg_max_l` solve in the matrix-free CG
  kernel (:func:`cg_kernels.cg_solve_full`);
- longer rows solve in the explicit-normal-matrix kernel
  (:func:`cg_kernels.gramian_cg_solve`);
- ``use_cg=False`` solves the dense normal equations (the Cholesky/`posv`
  path of the reference) with batched ``torch.linalg.solve``.

The kernels take float32 or bfloat16 factor tables. A float64 model solves
through the plain composed CG (:func:`_cg_class`), as the JAX package sends
float64 through its composed path: a dtype route, not a fallback.

Confidences follow the reference: a negative value means "disliked"
(P = 0, C = |c|); padding carries c == 0 and contributes nothing.
"""

import numpy as np
import torch

from . import cg_kernels

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64,
}


def _torch_dtype(compute_dtype):
    """'float32' / 'bfloat16' / 'float64' (or a torch dtype) as a torch dtype."""
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return _DTYPES[str(compute_dtype)]


def gramian(Y, reg):
    """YtY + reg*I in the solve precision: float64 for float64, else float32."""
    dt = torch.float64 if Y.dtype == torch.float64 else torch.float32
    Y = Y.to(dt)
    return Y.T @ Y + reg * torch.eye(Y.shape[1], dtype=dt, device=Y.device)


def _weights(dat):
    """Split raw confidences into (A-weights, b-values), masking padding.

    w  = |c| - 1 for nonzero entries, 0 for padding
    bv = c for c > 0 else 0
    """
    zero = torch.zeros((), dtype=dat.dtype, device=dat.device)
    w = torch.where(dat != 0, dat.abs() - 1.0, zero)
    bv = torch.where(dat > 0, dat, zero)
    return w, bv


def _masked_cg(x, r, apply_a, cg_steps):
    """``cg_steps`` masked conjugate-gradient iterations from residual ``r``.

    Rows whose squared residual drops below 1e-20 freeze; every other row
    advances in lockstep. ``apply_a`` applies each row's normal matrix.
    """
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    p = r
    rsold = (r * r).sum(1)
    active = rsold >= 1e-20
    for _ in range(cg_steps):
        Ap = apply_a(p)
        pAp = (p * Ap).sum(1)
        alpha = torch.where(active, rsold / torch.where(pAp == 0, one, pAp), zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rsnew = (r * r).sum(1)
        still = active & (rsnew >= 1e-20)
        beta = torch.where(active, rsnew / torch.where(active, rsold, one), zero)
        p = torch.where(still[:, None], r + beta[:, None] * p, p)
        rsold = torch.where(still, rsnew, rsold)
        active = still
    return x


def _class_chunks(cls):
    """(rows, idx, dat, n_valid) per chunk of a DeviceBucketClass."""
    return [(cls.rows[i], cls.indices[i], cls.data[i], cls.n_valid[i])
            for i in range(cls.n_chunks)]


def _stacked_chunks(n_rows, rows, idx, dat):
    """(rows, idx, dat, n_valid) per chunk of stacked (n, C[, L]) tensors."""
    n_valid = (rows < n_rows).sum(1).tolist()
    return [(rows[i], idx[i], dat[i], n_valid[i]) for i in range(rows.shape[0])]


def _solve_class(X, chunks, solve_chunk):
    """Solves each chunk from X and writes its real rows back into X.

    In place: chunks of one side hold disjoint rows, and each solve reads
    only its own rows' warm starts, so updating X as the chunks go gives
    the result of solving all of them from the old X, without a copy.
    """
    n_rows = X.shape[0]
    for rows, idx, dat, nv in chunks:
        if nv == 0:
            continue
        x0 = X[rows.clamp(max=n_rows - 1)]
        sol = solve_chunk(x0, idx, dat)
        X.index_copy_(0, rows[:nv], sol[:nv].to(X.dtype))
    return X


def _cg_class(X, Yc, YtY_reg, chunks, cg_steps):
    """Composed (plain PyTorch) CG for one class; the float64 route."""
    return _solve_class(X, chunks, lambda x0, idx, dat: cg_kernels.cg_solve_full_plain(
        Yc, idx, dat, x0, YtY_reg, cg_steps))


def _cho_class(X, Yc, YtY_reg, chunks):
    """Batched dense normal-equation solves (the Cholesky/`posv` path).

    LU (``torch.linalg.solve``) tolerates the rank-deficient A of tiny or
    unregularized problems, as the JAX package's default does.
    """

    def solve_chunk(x0, idx, dat):
        A, b = cg_kernels.normal_equations(Yc, idx, dat, YtY_reg)
        return torch.linalg.solve(A, b[..., None])[..., 0]

    return _solve_class(X, chunks, solve_chunk)


def _cg_full_class(X, Yc, YtY_reg, chunks, cg_steps):
    """Matrix-free CG kernel for one class of short rows."""
    return _solve_class(X, chunks, lambda x0, idx, dat: cg_kernels.cg_solve_full(
        Yc, idx, dat, x0, YtY_reg, cg_steps))


def _long_row_class(X, Yc, YtY_reg, chunks, cg_steps):
    """Explicit-normal-matrix CG kernel for one class of long rows."""
    return _solve_class(X, chunks, lambda x0, idx, dat: cg_kernels.gramian_cg_solve(
        Yc, idx, dat, x0, YtY_reg, cg_steps))


def _full_cg_max_l(compute_dtype, factors=128):
    """Longest row length routed to the matrix-free CG kernel.

    Longer rows go to the explicit-normal-matrix kernel. The rule is the JAX
    package's (1024 entries for 16-bit tables and 512 for float32 at F <=
    128, shrinking with wider F), kept so that both packages route every
    class alike; the H100's own crossover is not measured yet.
    """
    f_pad = -(-int(factors) // 128) * 128
    base = 1024 if _torch_dtype(compute_dtype).itemsize == 2 else 512
    return max(8, base * 128 // f_pad)


def _solve_side_core(X, Yc, YtY_reg, buckets, use_cg, cg_steps, compute_dtype):
    """Half-iteration with the gather table and gramian precomputed."""
    factors = X.shape[1]
    max_l = _full_cg_max_l(compute_dtype, factors)
    f64 = _torch_dtype(compute_dtype) == torch.float64
    for cls in buckets.classes:
        chunks = _class_chunks(cls)
        if not use_cg:
            X = _cho_class(X, Yc, YtY_reg, chunks)
        elif f64:
            X = _cg_class(X, Yc, YtY_reg, chunks, cg_steps)
        elif cls.L <= max_l:
            X = _cg_full_class(X, Yc, YtY_reg, chunks, cg_steps)
        else:
            X = _long_row_class(X, Yc, YtY_reg, chunks, cg_steps)
    if buckets.empty_rows is not None:
        X[buckets.empty_rows] = 0.0
    return X


def solve_side(X, Y, buckets, reg, use_cg=True, cg_steps=3, compute_dtype="float32"):
    """One ALS half-iteration: re-solve X given Y over bucketed chunks.

    ``buckets`` is a DeviceBuckets on X's device (or a BucketedCSR, uploaded
    here). Rows with no interactions are zeroed, every other row re-solved.
    X is updated in place and returned.
    """
    from ..sparse import BucketedCSR

    if isinstance(buckets, BucketedCSR):
        buckets = buckets.to_device(X.device)
    YtY_reg = gramian(Y, reg)
    Yc = Y.to(_torch_dtype(compute_dtype))
    return _solve_side_core(X, Yc, YtY_reg, buckets, use_cg, cg_steps, compute_dtype)


def fit(X, Y, user_buckets, item_buckets, reg, iterations, use_cg=True, cg_steps=3,
        compute_dtype="float32"):
    """Runs ``iterations`` full ALS iterations; X and Y are updated in place."""
    for _ in range(iterations):
        X = solve_side(X, Y, user_buckets, reg, use_cg, cg_steps, compute_dtype)
        Y = solve_side(Y, X, item_buckets, reg, use_cg, cg_steps, compute_dtype)
    return X, Y


def cg_solve_scan(X, Y, YtY_reg, rows, idx, dat, cg_steps=3):
    """Composed CG over stacked chunks ``rows (n, C)``, ``idx/dat (n, C, L)``."""
    chunks = _stacked_chunks(X.shape[0], rows, idx, dat)
    return _cg_class(X, Y.to(X.dtype), YtY_reg, chunks, cg_steps)


def cho_solve_scan(X, Y, YtY_reg, rows, idx, dat):
    """Dense normal-equation solves over stacked chunks (see cg_solve_scan)."""
    chunks = _stacked_chunks(X.shape[0], rows, idx, dat)
    return _cho_class(X, Y.to(X.dtype), YtY_reg, chunks)


def _loss_chunk_terms(X, Y, YtY, rows, idx, dat):
    """float32 sums of r.x and of |c| over one chunk, as 0-d tensors.

    Per row r = YtY x + sum_i [(-2 c_i^+) + (|c_i| - 1)(y_i . x)] y_i;
    padding rows (sentinel ids) contribute 0.
    """
    n_rows = X.shape[0]
    valid = rows < n_rows
    x = X[rows.clamp(max=n_rows - 1)]
    x = torch.where(valid[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    Yu = Y[idx.long()]
    yx = torch.einsum("clf,cf->cl", Yu, x)
    zero = torch.zeros((), dtype=dat.dtype, device=dat.device)
    mask = dat != 0
    conf = dat.abs()
    temp = torch.where(dat > 0, -2.0 * dat, zero) + torch.where(mask, conf - 1.0, zero) * yx
    r = x @ YtY + torch.einsum("cl,clf->cf", temp, Yu)
    return (r * x).sum(), torch.where(mask, conf, zero).sum()


def calculate_loss_bucketed(buckets, X, Y, reg):
    """Confidence-weighted MSE of an ALS model over bucketed chunks of Cui.

    Per-chunk float32 partials, summed in float64 on the host (the
    reference's double accumulators).
    """
    from ..sparse import BucketedCSR

    if isinstance(buckets, BucketedCSR):
        buckets = buckets.to_device(X.device)
    YtY = Y.T @ Y
    loss = 0.0
    total_conf = 0.0
    for cls in buckets.classes:
        terms = [_loss_chunk_terms(X, Y, YtY, cls.rows[i], cls.indices[i], cls.data[i])
                 for i in range(cls.n_chunks)]
        loss += float(torch.stack([t[0] for t in terms]).double().sum())
        total_conf += float(torch.stack([t[1] for t in terms]).double().sum())
    loss += total_conf  # the sum-of-confidences term (P_ui^2 * C_ui)
    loss += float(reg) * (float((X * X).sum()) + float((Y * Y).sum()))
    users, items = buckets.shape
    return loss / (total_conf + users * items - buckets.nnz)


def calculate_loss(Cui, X, Y, regularization, num_threads=0, device="cuda"):
    """Loss entry point taking a scipy CSR and numpy factors."""
    from .._device import resolve_device
    from ..sparse import BucketedCSR

    dev = resolve_device(device)
    return calculate_loss_bucketed(
        BucketedCSR(Cui).to_device(dev),
        torch.as_tensor(np.asarray(X, dtype=np.float32), device=dev),
        torch.as_tensor(np.asarray(Y, dtype=np.float32), device=dev), regularization,
    )
