"""Operations and bytes of one grouped BPR epoch, counted from the inputs'
shapes for the reference algorithm (``reference/bpr.py``), whatever
kernels the program runs. Frozen, as ``lib/counts.py``: a change of
kernels changes the time, never these counts.

An epoch visits every stored entry (u, i) once with one drawn negative j.
The chunks run in order and each reads the tables as the chunks before it
left them, so an item row cannot stay on the chip from one chunk to the
next: each entry's two item rows are gathered and written back. Each byte
the epoch must move is counted once:

- per entry: the liked and the negative row, F float32 each, read and
  written back (read-modify-write): 16 F bytes; their biases, read and
  written: 16 bytes; the liked item's id, the draw r and the negative's id
  ``itemids[r]``, 4 bytes each: 12 bytes;
- per user row with entries: its F float32 read once and written once:
  8 F bytes.

Operations, per entry: y_i - y_j (F), the score x_u . (y_i - y_j) (2 F),
the user's step z (y_i - y_j) summed (2 F), each item row's
(1 - lr reg) y + lr z x_u (3 F each, 6 F), and the logit, its sigmoid and
the two biases' updates (10); per user row with entries the shrink (F).
"""

F32 = 4
INDEX = 4


def epoch_ops(shape):
    """Operations of one grouped epoch."""
    F = shape["factors"]
    return shape["nnz"] * (11 * F + 10) + shape["users_nonempty"] * F


def epoch_bytes(shape):
    """Bytes of one grouped epoch, each once."""
    F = shape["factors"]
    per_entry = 2 * 2 * F * F32 + 2 * 2 * F32 + 3 * INDEX
    return shape["nnz"] * per_entry + shape["users_nonempty"] * 2 * F * F32

