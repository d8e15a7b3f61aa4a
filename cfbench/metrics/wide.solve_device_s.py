"""The wide solve route on the device: the program's ``wide solve`` spans'
CUDA-event seconds (each half-iteration's classes of the composed CG, under
its ``iteration``), summed per profiled fit, averaged over them. None on a
program without the span."""

from cfbench.lib import program, wide


def read(run):
    return program.mean(wide.solve_seconds(run))
