"""Batched ALS solvers over bucketed CSR chunks.

The counterpart of ``implicit_tpu/ops/als.py``. A half-iteration re-solves
every row of one side against the fixed other side, a chunk of C rows at a
time, class by class (see :mod:`implicit_tpu_torch.sparse`):

- rows of length L <= :func:`_full_cg_max_l` solve in the matrix-free CG
  kernel (:func:`cg_kernels.cg_solve_full`);
- longer rows solve in the explicit-normal-matrix kernel
  (:func:`cg_kernels.gramian_cg_solve`);
- at more than ``cg_kernels.MAX_FACTORS`` factors, which those two kernels
  do not take, every class solves in the composed CG on two kernels,
  ``weighted_matvec`` (the sparse term of each pass) and ``cg_update`` (its
  dense term and the CG update): :func:`_cg_class` with ``use_pallas=True``;
- ``use_cg=False`` solves the dense normal equations (the Cholesky/`posv`
  path of the reference) with batched ``torch.linalg.solve``.

The kernels take float32 or bfloat16 factor tables, or the int8 table of
``gather_quant`` (:func:`_quantize_table`), which travels as a ``(q, s)``
pair and is dequantized inside them. A float64 model solves through the
plain composed CG (:func:`_cg_class`), as the JAX package sends float64
through its composed path: a dtype route, not a fallback. The composed
routes (``_cho_class``, float64, ``_cg_class(use_pallas=False)``) read a
``(q, s)`` pair dequantized at the scale dtype (:func:`_dequantize_table`),
as the JAX package's do; the kernel routes dequantize to bfloat16 whatever
the compute dtype, as the TPU kernels do.

float32 products run in full float32 (``_device.full_f32_matmul``), as the
JAX package's ``Precision.HIGHEST`` dots, whatever the caller's setting.

Confidences follow the reference: a negative value means "disliked"
(P = 0, C = |c|); padding carries c == 0 and contributes nothing.
"""

import numpy as np
import torch

from .. import tracing
from .._device import full_f32_matmul
from . import cg_kernels

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64,
}


def _torch_dtype(compute_dtype):
    """'float32' / 'bfloat16' / 'float64' (or a torch dtype) as a torch dtype."""
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return _DTYPES[str(compute_dtype)]


# The JAX package's gather_quant="auto" threshold on a gather table's bytes
# (implicit_tpu/ops/als.py:VMEM_PROMO_BYTES): the TPU's alternate-memory
# promotion boundary. Kept as that package's rule, so that both packages
# resolve "auto" alike; it is not a property of the H100.
VMEM_PROMO_BYTES = 100 * (1 << 20)


def gramian(Y, reg):
    """YtY + reg*I in the solve precision: float64 for float64, else float32."""
    dt = torch.float64 if Y.dtype == torch.float64 else torch.float32
    Y = Y.to(dt)
    with full_f32_matmul():
        return Y.T @ Y + reg * torch.eye(Y.shape[1], dtype=dt, device=Y.device)


def _quantize_table(Y, compute_dtype):
    """(N, F) factors -> (int8 rows, per-row scales): the gather_quant table.

    Symmetric per-row quantization, scale = max|row| / 127 (1 for an
    all-zero row), q = round(y / scale) half to even, in float32: the same
    math as ``implicit_tpu.ops.als._quantize_table``. The scales are
    bfloat16 for 16-bit compute and float32 otherwise.
    """
    Yf = Y.float()
    amax = Yf.abs().amax(1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(Yf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    sd = torch.bfloat16 if _torch_dtype(compute_dtype).itemsize == 2 else torch.float32
    return q, scale.to(sd)


def _dequantize_table(Yc):
    """A ``(q, s)`` pair as a table at the scale dtype, the dequant of the
    JAX package's composed routes (``ops/als.py:_gather_rows``); a plain
    table is returned as it is."""
    if not isinstance(Yc, tuple):
        return Yc
    q, s = Yc
    return q.to(s.dtype) * s[:, None]


def _weights(dat):
    """Split raw confidences into (A-weights, b-values), masking padding.

    w  = |c| - 1 for nonzero entries, 0 for padding
    bv = c for c > 0 else 0
    """
    zero = torch.zeros((), dtype=dat.dtype, device=dat.device)
    w = torch.where(dat != 0, dat.abs() - 1.0, zero)
    bv = torch.where(dat > 0, dat, zero)
    return w, bv


def _cg_step(x, r, p, rsold, active, Ap):
    """One masked conjugate-gradient step from Ap = A p; returns the new
    (x, r, p, rsold, active).

    Rows whose squared residual drops below 1e-20 freeze; every other row
    advances in lockstep.
    """
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    pAp = (p * Ap).sum(1)
    alpha = torch.where(active, rsold / torch.where(pAp == 0, one, pAp), zero)
    x = x + alpha[:, None] * p
    r = r - alpha[:, None] * Ap
    rsnew = (r * r).sum(1)
    still = active & (rsnew >= 1e-20)
    beta = torch.where(active, rsnew / torch.where(active, rsold, one), zero)
    p = torch.where(still[:, None], r + beta[:, None] * p, p)
    return x, r, p, torch.where(still, rsnew, rsold), still


def _masked_cg(x, r, apply_a, cg_steps):
    """``cg_steps`` masked conjugate-gradient steps (:func:`_cg_step`) from
    residual ``r``; ``apply_a`` applies each row's normal matrix."""
    p = r
    rsold = (r * r).sum(1)
    active = rsold >= 1e-20
    for _ in range(cg_steps):
        x, r, p, rsold, active = _cg_step(x, r, p, rsold, active, apply_a(p))
    return x


def _composed_cg(x0, YtY_reg, sparse_term, cg_steps):
    """Masked CG from ``x0`` with A v = sparse_term(v, 0, 1) + v YtY_reg.

    ``sparse_term(v, alpha, beta)`` is sum_l (alpha bv + beta w (y_l . v)) y_l
    over each row's entries (a weighted matvec); the residual is
    sparse_term(x0, 1, -1) - x0 YtY_reg.
    """
    with full_f32_matmul():
        r = sparse_term(x0, 1.0, -1.0) - x0 @ YtY_reg
        return _masked_cg(x0, r, lambda v: sparse_term(v, 0.0, 1.0) + v @ YtY_reg, cg_steps)


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


def _table_and_scales(Yc):
    """(table, scales) of a gather table: a ``(q, s)`` pair, or (Y, None)."""
    return Yc if isinstance(Yc, tuple) else (Yc, None)


def _cg_class(X, Yc, YtY_reg, chunks, cg_steps, use_pallas=False):
    """Composed CG for the chunks of one class.

    ``use_pallas=False`` (the float64 route and ``cg_solve_scan``) runs the
    plain composed CG on the table, a ``(q, s)`` pair dequantized at the
    scale dtype. ``use_pallas=True`` solves each chunk in
    :func:`cg_kernels.cg_solve_wide`, with the pair's scales: every pass's
    sparse term in the ``weighted_matvec`` kernel, as the JAX package's
    ``_cg_class(..., use_pallas=True)`` takes its Pallas kernel, and its
    dense term and CG update in the ``cg_update`` kernel.
    """
    if not use_pallas:
        Yd = _dequantize_table(Yc)
        return _solve_class(X, chunks, lambda x0, idx, dat: cg_kernels.cg_solve_full_plain(
            Yd, idx, dat, x0, YtY_reg, cg_steps))
    Y, scales = _table_and_scales(Yc)
    return _solve_class(X, chunks, lambda x0, idx, dat: cg_kernels.cg_solve_wide(
        Y, idx, dat, x0, YtY_reg, cg_steps, scales=scales))


def _cho_class(X, Yc, YtY_reg, chunks):
    """Batched dense normal-equation solves (the Cholesky/`posv` path).

    LU (``torch.linalg.solve``) tolerates the rank-deficient A of tiny or
    unregularized problems, as the JAX package's default does. A ``(q, s)``
    pair is dequantized at the scale dtype.
    """
    Yd = _dequantize_table(Yc)

    def solve_chunk(x0, idx, dat):
        A, b = cg_kernels.normal_equations(Yd, idx, dat, YtY_reg)
        with full_f32_matmul():
            return torch.linalg.solve(A, b[..., None])[..., 0]

    return _solve_class(X, chunks, solve_chunk)


def _cg_full_class(X, Yc, YtY_reg, chunks, cg_steps):
    """Matrix-free CG kernel for one class of short rows."""
    Y, scales = _table_and_scales(Yc)
    return _solve_class(X, chunks, lambda x0, idx, dat: cg_kernels.cg_solve_full(
        Y, idx, dat, x0, YtY_reg, cg_steps, scales=scales))


def _long_row_class(X, Yc, YtY_reg, chunks, cg_steps):
    """Explicit-normal-matrix CG kernel for one class of long rows."""
    Y, scales = _table_and_scales(Yc)
    return _solve_class(X, chunks, lambda x0, idx, dat: cg_kernels.gramian_cg_solve(
        Y, idx, dat, x0, YtY_reg, cg_steps, scales=scales))


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
    """Half-iteration with the gather table (a tensor or a ``(q, s)`` pair)
    and the gramian precomputed.

    The route of a class depends on the dtype, F and L only. Past
    ``cg_kernels.MAX_FACTORS`` every class takes the composed CG on the
    ``weighted_matvec`` and ``cg_update`` kernels (the JAX package runs its
    cg_full and gramian_cg kernels there, or its composed CG where
    ``gramian_tile_l`` finds no tile); it is a route, not a fallback: on
    CUDA it launches the kernels. Its classes run inside the span ``wide
    solve`` (``tracing``; attrs ``stage``, ``factors``, ``classes``,
    ``rows`` with entries, ``entries`` and ``passes`` per row, all from the
    host-side plan), recorded only under a profiler.
    """
    factors = X.shape[1]
    f64 = _torch_dtype(compute_dtype) == torch.float64
    if use_cg and not f64 and factors > cg_kernels.MAX_FACTORS:
        with tracing.span("wide solve", X.device, stage="model step") as span:
            if span.id is not None:  # recorded: the plan's numbers, read on the host
                span.set(factors=factors, classes=len(buckets.classes),
                         rows=sum(sum(cls.n_valid) for cls in buckets.classes),
                         entries=buckets.nnz, passes=cg_steps + 1)
            for cls in buckets.classes:
                X = _cg_class(X, Yc, YtY_reg, _class_chunks(cls), cg_steps, use_pallas=True)
    else:
        max_l = _full_cg_max_l(compute_dtype, factors)
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


def solve_side(X, Y, buckets, reg, use_cg=True, cg_steps=3, compute_dtype="float32",
               gather_quant=False):
    """One ALS half-iteration: re-solve X given Y over bucketed chunks.

    ``buckets`` is a DeviceBuckets on X's device (or a BucketedCSR, uploaded
    here). Rows with no interactions are zeroed, every other row re-solved.
    ``gather_quant=True`` gathers from an int8 per-row-scaled copy of ``Y``
    (:func:`_quantize_table`); the gramian stays on the unquantized ``Y``.
    X is updated in place and returned.
    """
    from ..sparse import BucketedCSR

    if isinstance(buckets, BucketedCSR):
        buckets = buckets.to_device(X.device)
    YtY_reg = gramian(Y, reg)
    if gather_quant:
        Yc = _quantize_table(Y, compute_dtype)
    else:
        Yc = Y.to(_torch_dtype(compute_dtype))
    return _solve_side_core(X, Yc, YtY_reg, buckets, use_cg, cg_steps, compute_dtype)


def fit(X, Y, user_buckets, item_buckets, reg, iterations, use_cg=True, cg_steps=3,
        compute_dtype="float32", gather_quant=False):
    """Runs ``iterations`` full ALS iterations; X and Y are updated in place.

    ``gather_quant`` is a bool (both half-iterations) or a ``(user_side,
    item_side)`` pair: the user side gathers from the item table, the item
    side from the user table.
    """
    if not isinstance(gather_quant, (tuple, list)):
        gather_quant = (gather_quant, gather_quant)
    gq_user, gq_item = (bool(g) for g in gather_quant)
    for _ in range(iterations):
        X = solve_side(X, Y, user_buckets, reg, use_cg, cg_steps, compute_dtype, gq_user)
        Y = solve_side(Y, X, item_buckets, reg, use_cg, cg_steps, compute_dtype, gq_item)
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
    zero = torch.zeros((), dtype=dat.dtype, device=dat.device)
    mask = dat != 0
    conf = dat.abs()
    with full_f32_matmul():
        yx = torch.einsum("clf,cf->cl", Yu, x)
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
    with full_f32_matmul():
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
    from ..sparse import pack_on_device

    dev = resolve_device(device)
    return calculate_loss_bucketed(
        pack_on_device(Cui, dev),
        torch.as_tensor(np.asarray(X, dtype=np.float32), device=dev),
        torch.as_tensor(np.asarray(Y, dtype=np.float32), device=dev), regularization,
    )
