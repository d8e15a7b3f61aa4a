"""The EASE readers' shared arithmetic: the device seconds of an EASE fit's
model steps (the program's ``fit`` span's children, CUDA events) and each
part's share of its roofline (``lib/counts_ease.py``)."""

from cfbench.lib import counts_ease, program

# each part's model steps, as ``implicit_tpu_torch/ease.py`` names them
PARTS = {"gramian": ("gramian",), "solve": ("cholesky", "inverse", "weights"),
         "topk": ("top-k",)}


def step_seconds(run, part):
    """Per profiled fit, the device seconds of ``part``'s steps summed; []
    on a program without the steps or their device seconds."""
    names = PARTS[part]
    out = []
    for root, spans in program.trees(run, "fit"):
        steps = [s for s in program.children(root, spans) if s["name"] in names]
        secs = [s["device_s"] for s in steps]
        if sorted(s["name"] for s in steps) != sorted(names) or None in secs:
            return []
        out.append(sum(secs))
    return out


def share(run, part):
    """``part``'s least time over its steps' device seconds, per profiled
    fit, averaged over them, in %; None where nothing was read."""
    if run.peaks is None:
        return None
    least = counts_ease.least_times(run.peaks, run.shape, int(run.config["params"]["K"]))[part]
    return program.mean([100.0 * least / s for s in step_seconds(run, part) if s > 0])
