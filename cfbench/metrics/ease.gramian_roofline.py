"""EASE's gramian against its roofline: the least time of X^T X (the CSR
read once and S written once in float32, above the product term at this
sparsity, ``lib/counts_ease.py``) over the program's ``gramian`` step's
device seconds (CUDA events), per profiled fit, averaged over them, in %.
None on a program without the step."""

from cfbench.lib import ease_fit


def read(run):
    return ease_fit.share(run, "gramian")
