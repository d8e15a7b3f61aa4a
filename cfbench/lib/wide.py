"""What the readers of the wide solve route share: the program's ``wide
solve`` spans of a traced run, and the device time of the route's kernels
in the profiled fit.

The kernels are found by their C++ namespace in the trace's names:
``als::wmv::`` for ``csrc/weighted_matvec.cu`` (``wmv_narrow``,
``wmv_wide`` and the slices' sum ``wmv_sum_slices``) and ``als::cgu::``
for ``csrc/cg_update.cu`` (``yty_split_kernel`` and ``cg_update_kernel``).
"""

from cfbench.lib import counts_wide, layers, peaks, program

MATVEC = "als::wmv::"
UPDATE = "als::cgu::"


def solve_seconds(run):
    """[the ``wide solve`` spans' device seconds summed] per profiled fit,
    each span under one of the fit's ``iteration`` spans; [] where the
    program recorded none, or any span lacks its CUDA events."""
    fits = []
    for root, spans in program.trees(run, "fit"):
        wide = [w for it in program.children(root, spans, "iteration")
                for w in program.children(it, spans, "wide solve")]
        secs = [w["device_s"] for w in wide]
        if not secs or None in secs:
            return []
        fits.append(sum(secs))
    return fits


def kernel_seconds(run, namespace):
    """Device seconds of the kernels whose name holds ``namespace`` inside
    the profiled fit, or None where none ran."""
    span = layers.fit_span(run)
    if span is None:
        return None
    t0, t1 = span
    ns = sum(e - s for s, e, name in run.trace.device_events
             if namespace in name and s >= t0 and e <= t1)
    return ns / 1e9 if ns > 0 else None


def share(run, part, seconds):
    """The least time of ``part`` of the profiled fit's iterations
    (``counts_wide.iteration``) over ``seconds``, in %; None where the card
    has no peaks or nothing was timed."""
    if not seconds or run.peaks is None:
        return None
    ops, nbytes = counts_wide.iteration(run.shape, part)
    least = run.shape["iterations"] * peaks.least_time(run.peaks, ops, nbytes,
                                                       run.shape["dtype"])
    return 100.0 * least / seconds
