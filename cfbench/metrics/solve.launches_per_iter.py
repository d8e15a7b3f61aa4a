"""Kernel launches per iteration: the program's ``launches.*`` counters'
increase over the profiled fits' ``iteration`` spans, over their count."""

from cfbench.lib import program


def read(run):
    its = [s for root, spans in program.trees(run, "fit")
           for s in program.children(root, spans, "iteration")]
    if not its:
        return None
    return sum(n for s in its for k, n in s["counts"].items()
               if k.startswith("launches.")) / len(its)
