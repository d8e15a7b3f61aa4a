"""EASE's solve against its roofline: items^3 operations (the Cholesky
factorization and the inverse from it) at the float32 peak, or B's bytes
formed once, the larger (``lib/counts_ease.py``), over the device seconds
of the program's ``cholesky``, ``inverse`` and ``weights`` steps summed,
per profiled fit, averaged over them, in %. None on a program without the
steps."""

from cfbench.lib import ease_fit


def read(run):
    return ease_fit.share(run, "solve")
