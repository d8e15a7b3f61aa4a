"""Arithmetic the per-layer readers share: the profiled spans of a traced
run and the device time inside them."""


def fit_span(run):
    """(start, end) of the profiled fit, or None."""
    if run.trace is None or run.record["kind"] != "fit":
        return None
    spans = run.trace.spans("fit")
    return spans[0] if spans else None


def iteration_windows(run):
    """(start, end) of the profiled fit's iterations after the first: from
    one iteration's end to the next's (the fit syncs the card before its
    callback marks each end, so each window holds its iteration's device
    work and nothing else)."""
    if fit_span(run) is None:
        return []
    ends = run.trace.spans("iteration_end")
    return [(ends[i - 1][1], ends[i][0]) for i in range(1, len(ends))]


def requests(run):
    """[(start, end, users, liked entries)] of the profiled requests."""
    if run.trace is None or run.record["kind"] != "serve":
        return []
    spans = run.trace.spans("request")
    rec = run.record
    return [(s, e, int(rec["users"][j]), int(rec["liked"][j]))
            for j, (s, e) in enumerate(spans[:rec["profiled"]])]


def request_busy(run):
    """(request ns, device-busy ns inside them) summed over the profiled
    requests, or None."""
    reqs = requests(run)
    if not reqs:
        return None
    return (sum(e - s for s, e, _, _ in reqs),
            sum(run.trace.busy_ns(s, e) for s, e, _, _ in reqs))


def host_ms(run):
    """Mean over the profiled requests of the wall less the device's busy
    time inside it, in ms."""
    reqs = requests(run)
    if not reqs:
        return None
    total, busy = request_busy(run)
    return (total - busy) / len(reqs) / 1e6


def idle_share(run):
    """The device's idle share of the profiled requests' walls, in %."""
    tb = request_busy(run)
    if tb is None or tb[0] <= 0:
        return None
    return 100.0 * (1.0 - tb[1] / tb[0])
