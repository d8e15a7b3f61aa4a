"""The grouped BPR epochs against their roofline: one epoch's least time
(``lib/counts_bpr.py``, as ``mfu.bpr_fit`` takes it) times the profiled
fit's epochs, over the program's ``iteration`` spans' device seconds
(CUDA events) summed, per profiled fit, averaged over them, in %. None on
a program without the spans."""

from cfbench.lib import counts_bpr, peaks, program


def read(run):
    if run.peaks is None:
        return None
    sh = run.shape
    least = peaks.least_time(run.peaks, counts_bpr.epoch_ops(sh), counts_bpr.epoch_bytes(sh),
                             sh["dtype"])
    shares = []
    for root, spans in program.trees(run, "fit"):
        secs = [s["device_s"] for s in program.children(root, spans, "iteration")]
        if not secs or None in secs:
            return None
        shares.append(100.0 * least * len(secs) / sum(secs))
    return program.mean(shares)
