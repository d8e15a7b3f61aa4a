"""Approximate-nearest-neighbour serving wrappers.

Each wrapper takes a trained matrix-factorization model of the port and
swaps the brute-force top-k serving path for an index: Annoy, NMSLib or
Faiss (optional packages, imported when an index is built), or the on-device
IVF index of :mod:`.ivf`. The counterpart of ``implicit_tpu/ann``.
"""
