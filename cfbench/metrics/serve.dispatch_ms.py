"""A request's host time in the serving layer before it hands off to the
top-k: from the program's ``recommend`` span's start to the start of the
``topk`` span inside its ``dispatch`` (checks, the user rows, the table and
the liked filter), averaged over the profiled requests, in ms. The top-k's
own dispatch, and any wait on the card inside it, is left out."""

from cfbench.lib import program


def read(run):
    ms = []
    for root, spans in program.trees(run, "recommend"):
        topk = [s for d in program.children(root, spans, "dispatch")
                for s in program.children(d, spans, "topk")]
        if topk:
            ms.append((topk[0]["start_ns"] - root["start_ns"]) / 1e6)
    return program.mean(ms)
