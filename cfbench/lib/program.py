"""The program's own spans and counters, as a traced run leaves them.

``implicit_tpu_torch.tracing`` records the program's spans while a
profiler records, with the change of each program counter over each span;
its host clock is the profiler's. The per-layer readers of those spans use
this module: each finds nothing, and gives None, where the program has no
such module (an older commit) or recorded no span of the run's kind.
"""

# slack for the profiler's clock against the program's at the profiled
# window's edges, in ns
SLACK_NS = 1_000_000


def trees(run, name):
    """[(root, its descendants)] of the program's spans whose root is named
    ``name`` and lies in the run's profiled window, in order of start; each
    span a dict of ``tracing.spans()``. [] where there are none."""
    try:
        from implicit_tpu_torch import tracing
    except ImportError:
        return []
    if run.trace is None:
        return []
    t0, t1 = run.profiled_window()
    spans = tracing.spans()
    under = {}
    for s in spans:
        if s["parent"] is not None:
            under.setdefault(s["root"], []).append(s)
    return [(s, under.get(s["id"], [])) for s in spans
            if s["parent"] is None and s["name"] == name
            and s["start_ns"] >= t0 - SLACK_NS and s["end_ns"] <= t1 + SLACK_NS]


def children(root, spans, name=None):
    """The spans of ``spans`` directly under ``root`` (named ``name``)."""
    return [s for s in spans if s["parent"] == root["id"] and name in (None, s["name"])]


def setup_steps(root, spans):
    """The fit's set-up steps: ``root``'s children of the stage ``fit
    set-up`` (the program's ``timed_step`` blocks)."""
    return [s for s in children(root, spans) if s["attrs"].get("stage") == "fit set-up"]


def seconds(span):
    return (span["end_ns"] - span["start_ns"]) / 1e9


def union(intervals):
    """Disjoint (start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def mean(values):
    return sum(values) / len(values) if values else None
