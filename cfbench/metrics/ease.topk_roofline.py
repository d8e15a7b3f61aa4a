"""EASE's top-K selection against its roofline: B read once and each row's
K values and ids written (``lib/counts_ease.py``), over the device seconds
of the program's ``top-k`` step (the selection on the card, not the copy
back), per profiled fit, averaged over them, in %. None on a program
without the step."""

from cfbench.lib import ease_fit


def read(run):
    return ease_fit.share(run, "topk")
