"""Alias of the reference's ``implicit.gpu.matrix_factorization_base``."""

from ..models.mf_base import MatrixFactorizationBase  # noqa: F401
