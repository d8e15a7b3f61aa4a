"""The fit's iterations on the device: the sum of the program's
``iteration`` spans' device seconds (CUDA events on the fit's stream, no
sync), per profiled fit, averaged over them."""

from cfbench.lib import program


def read(run):
    fits = []
    for root, spans in program.trees(run, "fit"):
        secs = [s["device_s"] for s in program.children(root, spans, "iteration")]
        if not secs or None in secs:
            return None
        fits.append(sum(secs))
    return program.mean(fits)
