"""The share of the fitted tables' bytes that the copy back staged through
the program's pinned ring: the ``copy_back.staged_bytes`` counter over it
and ``copy_back.plain_bytes``, summed over the profiled fits' ``fit`` spans.
None where neither counter moved (a program without them)."""

from cfbench.lib import program


def read(run):
    counts = [root["counts"] for root, _ in program.trees(run, "fit")]
    staged = sum(c.get("copy_back.staged_bytes", 0) for c in counts)
    plain = sum(c.get("copy_back.plain_bytes", 0) for c in counts)
    return staged / (staged + plain) if staged + plain else None
