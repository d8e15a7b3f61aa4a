"""``weighted_matvec`` against its roofline: the least time of the profiled
fit's sparse terms (every pass, both sides, every iteration;
``lib/counts_wide.py``) over the device time of the kernels of
``csrc/weighted_matvec.cu`` in that fit, in %."""

from cfbench.lib import wide


def read(run):
    return wide.share(run, "matvec", wide.kernel_seconds(run, wide.MATVEC))
