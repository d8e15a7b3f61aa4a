"""Operations and bytes the work needs, counted from the inputs' shapes for
the reference algorithm, whatever kernels the program runs. Frozen: a
change of kernels changes the time, never these counts.
"""


def als_side_ops(rows, nnz, other_rows, factors, cg_steps):
    """Operations of one half-iteration of ``least_squares_cg``: the
    gramian YtY (2 m F^2), b = Yu^T c+ (2 nnz F), cg_steps + 1 products
    with A, each 2 F^2 per row for YtY v and 4 F per entry for
    Yu^T (w (Yu v)), and 10 F per row per step plus 3 F per row of vector
    updates. ``rows`` counts the rows with entries (empty rows are zeroed)."""
    F = factors
    return (2 * other_rows * F * F + 2 * nnz * F
            + (cg_steps + 1) * (2 * rows * F * F + 4 * nnz * F)
            + rows * (10 * cg_steps + 3) * F)


def als_iteration_ops(shape):
    """Operations of one ALS iteration, both sides."""
    F, s = shape["factors"], shape["cg_steps"]
    return (als_side_ops(shape["users_nonempty"], shape["nnz"], shape["items"], F, s)
            + als_side_ops(shape["items_nonempty"], shape["nnz"], shape["users"], F, s))


def als_iteration_bytes(shape):
    """Bytes of one ALS iteration, each read or written once: both CSRs
    (int32 index and float32 value per entry, int64 row pointer per row),
    both tables read and written, both F x F float32 gramians written and
    read."""
    F, t = shape["factors"], shape["table_bytes"]
    csr = 2 * 8 * shape["nnz"] + 8 * (shape["users"] + shape["items"] + 2)
    tables = 2 * (shape["users"] + shape["items"]) * F * t
    return csr + tables + 2 * 2 * F * F * 4


def topk_ops(batch, items, factors):
    """Operations of scoring ``batch`` queries against ``items`` rows."""
    return 2 * batch * items * factors


def topk_bytes(batch, items, factors, liked, N, table_bytes):
    """Bytes of one top-k request: the item table and the batch's query rows
    read, the liked entries read as (row, item) int64 pairs, the (ids,
    scores) written as int32 and float32."""
    return ((items + batch) * factors * table_bytes + 16 * liked + 8 * batch * N)
