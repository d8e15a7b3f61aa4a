"""Alias of the reference's compiled ``implicit.cpu._als`` module, whose
public surface is ``least_squares``, ``least_squares_cg`` and
``calculate_loss``.

``least_squares`` and ``least_squares_cg`` are host-numpy solvers of the
same equations as the port's kernels; ``calculate_loss`` runs on
``device=`` (default ``"cuda"``).
"""

from ..models.als import (  # noqa: F401
    calculate_loss,
    least_squares,
    least_squares_cg,
)
