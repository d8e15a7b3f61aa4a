"""The item updates' share of the grouped BPR epochs on the device: the
program's ``scatter`` spans' device seconds (one a chunk, under its
``iteration``: the updates' arithmetic and the four accumulating scatters)
over the ``iteration`` spans', per profiled fit, averaged over them, in %.
None on a program without the spans."""

from cfbench.lib import program


def read(run):
    shares = []
    for root, spans in program.trees(run, "fit"):
        its = program.children(root, spans, "iteration")
        its_s = [s["device_s"] for s in its]
        scatter_s = [s["device_s"] for it in its for s in program.children(it, spans, "scatter")]
        if not its_s or not scatter_s or None in its_s + scatter_s:
            return None
        shares.append(100.0 * sum(scatter_s) / sum(its_s))
    return program.mean(shares)
