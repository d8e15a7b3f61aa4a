"""The device's idle time inside the fit's set-up: over the union of the
program's set-up steps' host intervals, their length less the device's
busy time inside them (the profile, on the same clock), per profiled fit,
averaged over them, in s."""

from cfbench.lib import program


def read(run):
    idle = []
    for root, spans in program.trees(run, "fit"):
        steps = program.setup_steps(root, spans)
        covered = program.union((s["start_ns"], s["end_ns"]) for s in steps)
        idle.append(sum(e - s - run.trace.busy_ns(s, e) for s, e in covered) / 1e9)
    return program.mean(idle)
