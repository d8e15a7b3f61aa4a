"""The 95th percentile of the latency of every request in the window, from
when it was sent to when its answer was back on the host, in ms."""

import statistics


def read(run):
    rec = run.record
    if rec["kind"] != "serve" or len(rec["end"]) < 20:
        return None
    latency = (rec["end"] - rec["start"]) * 1e3
    return statistics.quantiles(latency.tolist(), n=20)[-1]
