"""Users answered in the window over the window's length."""


def read(run):
    rec = run.record
    if rec["kind"] != "serve" or not len(rec["users"]):
        return None
    return float(rec["users"].sum()) / rec["window_s"]
