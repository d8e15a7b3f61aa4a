"""Alias of the reference's ``implicit.cpu.bpr`` module."""

from ..models.bpr import BayesianPersonalizedRanking  # noqa: F401
