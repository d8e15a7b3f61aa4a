"""The device's idle share of the profiled fit's wall, in %."""

from cfbench.lib import layers


def read(run):
    span = layers.fit_span(run)
    if span is None or span[1] <= span[0]:
        return None
    s, e = span
    return 100.0 * (1.0 - run.trace.busy_ns(s, e) / (e - s))
