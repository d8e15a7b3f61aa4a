"""The fit's set-up on the host: the seconds of the program's set-up steps
(the ``fit`` span's children of the stage ``fit set-up``: prepare, upload,
transpose, plan and pack of both sides, factor draw and init, copy back),
summed per profiled fit, averaged over them."""

from cfbench.lib import program


def read(run):
    return program.mean([sum(program.seconds(s) for s in program.setup_steps(root, spans))
                         for root, spans in program.trees(run, "fit")])
