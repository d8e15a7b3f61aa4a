"""Operations and bytes of one EASE fit's three kinds of work, counted from
the inputs' shapes for the reference algorithm (``reference/ease.py``),
whatever kernels the program runs. Frozen, as ``lib/counts.py``: a change
of kernels changes the time, never these counts. Each is a least work, so
no exact method can read over its roofline: a sparse or 16-bit gramian
exact on binary data included.

- The gramian X^T X: the CSR read once (int32 row pointers and column ids,
  float32 values) and the items x items float32 S written once. Its
  products, 2 sum_u d_u^2 (a multiply and an add for each pair of one
  user's entries), are at least 2 nnz^2 / (users with entries) (Cauchy and
  Schwarz): the shapes give only that bound, far below the bytes' time at
  the cells' sparsity.
- The solve: items^3 operations, items^3 / 3 for the Cholesky
  factorization and 2 items^3 / 3 for the inverse from it, at the float32
  peak (``lib/peaks.py``: the TF32 rate); B, items^2 float32, written once.
- The top K: B read once, and each row's K float32 values and int32 ids
  written.
"""

from cfbench.lib import peaks

F32 = 4
INDEX = 4


def gramian_ops(shape):
    """The lower bound of the gramian's products, 2 nnz^2 / users with
    entries."""
    return 2.0 * float(shape["nnz"]) ** 2 / max(shape["users_nonempty"], 1)


def gramian_bytes(shape):
    """The CSR read once and S written once."""
    return ((shape["users"] + 1) * INDEX + shape["nnz"] * (INDEX + F32)
            + shape["items"] ** 2 * F32)


def solve_ops(shape):
    """The factorization and the inverse from it."""
    return float(shape["items"]) ** 3


def solve_bytes(shape):
    """B formed once."""
    return shape["items"] ** 2 * F32


def topk_bytes(shape, K):
    """B read once, each row's top K values and ids written."""
    items = shape["items"]
    return items ** 2 * F32 + items * min(K, items) * (F32 + INDEX)


def least_times(card, shape, K):
    """The least seconds of each part on the card with peaks ``card``: the
    larger of its operations over the float32 peak and its bytes over the
    memory bandwidth."""
    return dict(gramian=peaks.least_time(card, gramian_ops(shape), gramian_bytes(shape),
                                         "float32"),
                solve=peaks.least_time(card, solve_ops(shape), solve_bytes(shape), "float32"),
                topk=peaks.least_time(card, 0, topk_bytes(shape, K), "float32"))
