"""The iteration's solves against their roofline: the least time of one
iteration (the larger of its operations over the peak and its bytes over
the memory bandwidth, ``lib/counts.py``) over the device's busy time per
iteration of the profiled fit (iterations after the first), in %."""

from cfbench.lib import layers, peaks


def read(run):
    windows = layers.iteration_windows(run)
    if not windows or run.peaks is None:
        return None
    busy = sum(run.trace.busy_ns(s, e) for s, e in windows) / 1e9
    if busy <= 0:
        return None
    least = peaks.least_time(run.peaks, run.counts.als_iteration_ops(run.shape),
                             run.counts.als_iteration_bytes(run.shape), run.shape["dtype"])
    return 100.0 * least * len(windows) / busy
