"""Datasets of the port (synthetic generators)."""
