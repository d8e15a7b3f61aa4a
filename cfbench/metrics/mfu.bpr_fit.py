"""The whole BPR fit's share of the card's peak: the least time of the
fit's epochs (one epoch's operations over the peak of the tables' type or
its bytes over the memory bandwidth, the larger, ``lib/counts_bpr.py``,
times the epochs) over the mean fit wall of the traced window, in %."""

from cfbench.lib import counts_bpr, peaks


def read(run):
    rec = run.record
    if rec["kind"] != "fit" or run.peaks is None or not rec["walls"]:
        return None
    sh = run.shape
    least = sh["iterations"] * peaks.least_time(run.peaks, counts_bpr.epoch_ops(sh),
                                                counts_bpr.epoch_bytes(sh), sh["dtype"])
    wall = sum(rec["walls"]) / len(rec["walls"])
    return 100.0 * least / wall
