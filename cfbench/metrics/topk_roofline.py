"""The top-k against its roofline: each profiled request's least time (the
larger of its score product's operations over the peak and its bytes over
the memory bandwidth, ``lib/counts.py``) summed, over the device's busy
time inside the requests, in %."""

from cfbench.lib import layers, peaks


def read(run):
    reqs = layers.requests(run)
    if not reqs or run.peaks is None:
        return None
    sh, N = run.shape, run.record["N"]
    least = sum(peaks.least_time(
        run.peaks, run.counts.topk_ops(b, sh["items"], sh["factors"]),
        run.counts.topk_bytes(b, sh["items"], sh["factors"], liked, N, sh["table_bytes"]),
        sh["dtype"]) for _, _, b, liked in reqs)
    busy = layers.request_busy(run)[1] / 1e9
    return 100.0 * least / busy if busy > 0 else None
