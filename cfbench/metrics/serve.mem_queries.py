"""Free-memory queries per request: the program's ``device.mem_queries``
counter's increase over the profiled ``recommend`` spans, over their
count."""

from cfbench.lib import program


def read(run):
    return program.mean([root["counts"].get("device.mem_queries", 0)
                         for root, _ in program.trees(run, "recommend")])
