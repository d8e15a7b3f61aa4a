"""``cg_update`` against its roofline: the least time of the profiled fit's
dense terms ``p YtY_reg`` and masked updates (every pass, both sides, every
iteration; ``lib/counts_wide.py``) over the device time of the kernels of
``csrc/cg_update.cu`` (``cg_update_kernel`` and ``yty_split_kernel``) in
that fit, in %."""

from cfbench.lib import wide


def read(run):
    return wide.share(run, "update", wide.kernel_seconds(run, wide.UPDATE))
