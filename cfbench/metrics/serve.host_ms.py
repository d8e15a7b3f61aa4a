"""Requests' host time: each profiled request's wall less the device's busy
time inside it, averaged, in ms."""

from cfbench.lib import layers


def read(run):
    return layers.host_ms(run)
