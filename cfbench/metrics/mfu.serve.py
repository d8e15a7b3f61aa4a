"""The requests' share of the card's peak: the score products'
operations (``lib/counts.py``) over the profiled requests' walls times the
peak of the tables' type, in %."""

from cfbench.lib import layers


def read(run):
    reqs = layers.requests(run)
    if not reqs or run.peaks is None:
        return None
    sh = run.shape
    ops = sum(run.counts.topk_ops(b, sh["items"], sh["factors"]) for _, _, b, _ in reqs)
    wall = layers.request_busy(run)[0] / 1e9
    return 100.0 * ops / (wall * run.peaks["flops"][sh["dtype"]])
