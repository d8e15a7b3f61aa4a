"""The fit's own set-up: each traced fit's wall less its iterations (the
fit's callback times each iteration after a sync of the card), averaged
over the traced window's fits."""


def read(run):
    rec = run.record
    if rec["kind"] != "fit" or not all(rec["iter_secs"]):
        return None
    preps = [w - sum(s) for w, s in zip(rec["walls"], rec["iter_secs"])]
    return sum(preps) / len(preps)
