"""Alias of the reference's ``implicit.cpu.lmf`` module."""

from ..models.lmf import LogisticMatrixFactorization  # noqa: F401
