"""The whole EASE fit's share of the card's peak: the least times of its
gramian, solve and top K (``lib/counts_ease.py``) summed, over the mean fit
wall of the traced window, in %."""

from cfbench.lib import counts_ease


def read(run):
    rec = run.record
    if rec["kind"] != "fit" or run.peaks is None or not rec["walls"]:
        return None
    least = sum(counts_ease.least_times(run.peaks, run.shape,
                                        int(run.config["params"]["K"])).values())
    wall = sum(rec["walls"]) / len(rec["walls"])
    return 100.0 * least / wall
