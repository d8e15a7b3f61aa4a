"""Alias of the reference's ``implicit.gpu.bpr``."""

from ..models.bpr import BayesianPersonalizedRanking  # noqa: F401
