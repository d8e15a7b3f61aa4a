"""The share of the starting factor tables drawn on the card: the
program's ``init.device_draws`` counter over it and ``init.host_draws``,
summed over the profiled fits' ``fit`` spans. None where neither counter
moved (a program without them)."""

from cfbench.lib import program


def read(run):
    counts = [root["counts"] for root, _ in program.trees(run, "fit")]
    device = sum(c.get("init.device_draws", 0) for c in counts)
    host = sum(c.get("init.host_draws", 0) for c in counts)
    return device / (device + host) if device + host else None
