"""Alias of the reference's ``implicit.cpu.als``: the port's model class and
its host-numpy solvers (``least_squares``, ``least_squares_cg``, the per-row
``user_linear_equation`` / ``user_factor`` / ``item_factor``) and
``calculate_loss``.

The model accepts the reference CPU class's constructor arguments, plus the
port's ``device=`` (default ``"cuda"``).
"""

from ..models.als import (  # noqa: F401
    AlternatingLeastSquares,
    calculate_loss,
    item_factor,
    least_squares,
    least_squares_cg,
    user_factor,
    user_linear_equation,
)
