"""The wide solve route against its roofline: the least time of the
profiled fit's wide CG (the sparse term, the dense term and the update,
``cg_steps + 1`` passes on both sides of every iteration; the larger of its
operations over the peak of the tables' type and its bytes, each once,
over the memory bandwidth, ``lib/counts_wide.py``) over the ``wide solve``
spans' device seconds in that fit, averaged over the profiled fits, in %.
None on a program without the span."""

from cfbench.lib import program, wide


def read(run):
    return program.mean([wide.share(run, "solve", s) for s in wide.solve_seconds(run)])
