"""Process start to the first timed operation: imports, the card, the
inputs made from the seed, the kernels loaded (built on a checkout's first
run) and one warm pass over every shape of the window."""


def read(run):
    return run.setup_s
