"""The wall of one whole fit: the window's length over the fits it held,
the fit in progress at ``--seconds`` finished inside it."""


def read(run):
    rec = run.record
    if rec["kind"] != "fit" or not rec["walls"]:
        return None
    return rec["window_s"] / len(rec["walls"])
