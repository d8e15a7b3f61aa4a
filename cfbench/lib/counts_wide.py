"""Operations and bytes of the wide solve route, counted from the inputs'
shapes for the reference algorithm, whatever kernels the program runs.
Frozen, as ``lib/counts.py``: a change of kernels changes the time, never
these counts.

The route solves each half-iteration in ``cg_steps + 1`` passes: the first
gives the residual from the warm start, each other is one CG step. A pass
is the sparse term (``weighted_matvec``), then the dense term ``v
YtY_reg`` and the masked update (``cg_update``). Per side, ``rows`` counts
the rows with entries (empty rows are zeroed, not solved), ``nnz`` the live
entries and ``other_rows`` the rows of the fixed table.

Bytes follow ``lib/counts.py``: each byte that the work must read or
write is counted once, as if every cache missed once and hit ever after,
so a table is read once (not once per entry that gathers its row); vectors
are float32, an entry's index and weight 4 bytes each. The per-kernel
counts are per pass, as a kernel that runs one pass must move them: the
sparse term is written by the first kernel and read by the second. The
whole solve (:func:`solve_bytes`) counts each byte once over all of its
passes, as a kernel holding a row's CG on the chip would move them, so its
least time holds whatever kernels run the solve.
"""

F32 = 4
INDEX = 4


def matvec_ops(nnz, factors, cg_steps):
    """The sparse term, every pass of a half-iteration: per live entry the
    dot y . v (2 F) and the product's row added (2 F)."""
    return (cg_steps + 1) * 4 * nnz * factors


def matvec_bytes(rows, nnz, other_rows, factors, table_bytes, cg_steps):
    """The sparse term, every pass of a half-iteration: each live entry's
    index and weight (and on the first pass its b-value), the fixed table
    once, v read and the term written, per row."""
    per_pass = (nnz * (INDEX + F32) + other_rows * factors * table_bytes
                + 2 * rows * factors * F32)
    return (cg_steps + 1) * per_pass + nnz * F32


def update_ops(rows, factors, cg_steps):
    """The dense term and the update, every pass of a half-iteration: the
    product v YtY_reg (2 F^2 per row) each pass; the residual and its norm
    on the first (3 F per row), the step's dots and updates on each other
    (10 F per row), as ``lib/counts.py`` counts them."""
    F = factors
    return (cg_steps + 1) * 2 * rows * F * F + rows * (3 + 10 * cg_steps) * F


def update_bytes(rows, factors, cg_steps):
    """The dense term and the update, every pass of a half-iteration:
    YtY_reg once a pass; the first pass reads the sparse term and v = x0 and
    writes x, r and p; each step reads the sparse term, v = p, x and r and
    writes x, r and p (p read once, being v)."""
    F = factors
    first = 2 * rows * F * F32 + 3 * rows * F * F32
    step = 4 * rows * F * F32 + 3 * rows * F * F32
    return (cg_steps + 1) * F * F * F32 + first + cg_steps * step


def solve_ops(rows, nnz, factors, cg_steps):
    """The whole wide solve of a half-iteration: the sparse term, the dense
    term and the update."""
    return matvec_ops(nnz, factors, cg_steps) + update_ops(rows, factors, cg_steps)


def solve_bytes(rows, nnz, other_rows, factors, table_bytes):
    """The whole wide solve of a half-iteration, each byte once: each live
    entry's index, weight and b-value, the fixed table and YtY_reg read,
    x0 read and x written, per row."""
    F = factors
    return (nnz * (INDEX + 2 * F32) + other_rows * F * table_bytes + F * F * F32
            + 2 * rows * F * F32)


def _sides(shape):
    """(rows, other_rows) of the user side, then the item side."""
    return ((shape["users_nonempty"], shape["items"]), (shape["items_nonempty"], shape["users"]))


def iteration(shape, part):
    """(operations, bytes) of one iteration, both sides, of ``part``:
    "matvec", "update" or "solve"."""
    F, s, t, nnz = shape["factors"], shape["cg_steps"], shape["table_bytes"], shape["nnz"]
    ops = nbytes = 0
    for rows, other in _sides(shape):
        if part == "matvec":
            ops += matvec_ops(nnz, F, s)
            nbytes += matvec_bytes(rows, nnz, other, F, t, s)
        elif part == "update":
            ops += update_ops(rows, F, s)
            nbytes += update_bytes(rows, F, s)
        elif part == "solve":
            ops += solve_ops(rows, nnz, F, s)
            nbytes += solve_bytes(rows, nnz, other, F, t)
        else:
            raise ValueError(f"part must be matvec, update or solve, got {part!r}")
    return ops, nbytes
