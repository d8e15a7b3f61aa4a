"""The device's idle share of the profiled requests' walls, in %."""

from cfbench.lib import layers


def read(run):
    return layers.idle_share(run)
