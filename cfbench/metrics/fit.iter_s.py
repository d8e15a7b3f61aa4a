"""The fit's iterations: the sum of one fit's iteration times (its
callback's, after a sync of the card), averaged over the traced window's
fits."""


def read(run):
    rec = run.record
    if rec["kind"] != "fit" or not all(rec["iter_secs"]):
        return None
    return sum(sum(s) for s in rec["iter_secs"]) / len(rec["iter_secs"])
