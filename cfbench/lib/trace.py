"""The traced run's instrumentation and its reduction to intervals.

Spans come from the benchmark's own side: ``record_function`` labels around
each fit, request and iteration end, and around the program calls that the
configuration names in ``trace_spans`` (``module:attribute``, wrapped for
the run and restored after it). Device activity comes from
``torch.profiler``'s raw events (kernels, copies, sets), summed straight
from ``kineto_results``: ``key_averages`` parses every host op into a tree
first, which is slow for long windows.
"""

import contextlib
import functools
import importlib

import numpy as np
import torch

PREFIX = "cfbench."


def span(name):
    """A labelled host span, seen by the profiler when it runs."""
    return torch.profiler.record_function(PREFIX + name)


def _resolve(target):
    module, attr = target.split(":")
    owner = importlib.import_module(module)
    *path, leaf = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, leaf


class _LabelledContext:
    """A context manager entered inside a span of its own."""

    def __init__(self, cm, label):
        self.cm, self.label = cm, label

    def __enter__(self):
        self.rf = span(self.label)
        self.rf.__enter__()
        return self.cm.__enter__()

    def __exit__(self, *exc):
        try:
            return self.cm.__exit__(*exc)
        finally:
            self.rf.__exit__(*exc)


def _labelled(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        label = f"{name} {args[0]}" if args and isinstance(args[0], str) else name
        with span(label):
            out = fn(*args, **kwargs)
        # a context-manager factory (the program's timed steps): label the block
        if hasattr(out, "__enter__") and hasattr(out, "__exit__"):
            return _LabelledContext(out, label)
        return out
    return wrapper


@contextlib.contextmanager
def patched(targets, wrap):
    """Each ``module:attribute`` of ``targets`` replaced by ``wrap(fn, name)``
    inside the block, restored after it."""
    saved = []
    try:
        for target in targets:
            owner, leaf = _resolve(target)
            fn = getattr(owner, leaf)
            saved.append((owner, leaf, fn))
            setattr(owner, leaf, wrap(fn, leaf))
        yield
    finally:
        for owner, leaf, fn in reversed(saved):
            setattr(owner, leaf, fn)


def spans_on(targets):
    """The configuration's ``trace_spans`` labelled for the block."""
    return patched(targets, _labelled)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


class Trace:
    """A finished profile as intervals (nanoseconds on one clock): device
    activity merged into disjoint busy intervals, and host events."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            item = (e.start_ns(), e.end_ns(), e.name())
            if e.device_type() != DeviceType.CUDA:
                host.append(item)
            elif not item[2].startswith(PREFIX):
                # the benchmark's own labels also appear on the device's timeline,
                # spanning the work launched inside them: they are not device work
                dev.append(item)
        self.device_events = dev
        self.host_events = host
        self._merge(sorted((s, e) for s, e, _ in dev if e > s))

    @classmethod
    def from_events(cls, device_events, host_events):
        """A trace built from (start_ns, end_ns, name) lists (tests)."""
        self = cls.__new__(cls)
        self.device_events, self.host_events = list(device_events), list(host_events)
        self._merge(sorted((s, e) for s, e, _ in self.device_events if e > s))
        return self

    def _merge(self, ivs):
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        arr = np.array(merged, dtype=np.int64).reshape(-1, 2)
        self.starts, self.ends = arr[:, 0], arr[:, 1]
        self.cum = np.concatenate([[0], np.cumsum(self.ends - self.starts)])

    def spans(self, name):
        """(start, end) of the benchmark's spans labelled ``name``, in order."""
        return sorted((s, e) for s, e, n in self.host_events if n == PREFIX + name)

    def busy_ns(self, t0, t1):
        """Nanoseconds in [t0, t1] in which the device ran something."""
        i = int(np.searchsorted(self.ends, t0, "right"))
        j = int(np.searchsorted(self.starts, t1, "left"))
        if j <= i:
            return 0
        total = int(self.cum[j] - self.cum[i])
        total -= max(0, t0 - int(self.starts[i]))
        total -= max(0, int(self.ends[j - 1]) - t1)
        return max(total, 0)

    def device_ops(self, top=10):
        """[name, seconds] of the device operations with the most time."""
        totals = {}
        for s, e, n in self.device_events:
            totals[n] = totals.get(n, 0) + e - s
        best = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in best]

    def idle_gaps(self, t0, t1, top=10, labelled=200):
        """[label, seconds] of the device's idle time in [t0, t1], summed by
        what the host was doing: the innermost benchmark span and the
        innermost other host event at the middle of each gap. The
        ``labelled`` longest gaps are labelled; the rest are summed as
        "shorter gaps"."""
        edges_s = np.concatenate([[t0], np.clip(self.ends, t0, t1)])
        edges_e = np.concatenate([np.clip(self.starts, t0, t1), [t1]])
        length = edges_e - edges_s
        keep = length > 0
        gs, ge, gl = edges_s[keep], edges_e[keep], length[keep]
        order = np.argsort(-gl)
        hs = np.array([s for s, _, _ in self.host_events], dtype=np.int64)
        he = np.array([e for _, e, _ in self.host_events], dtype=np.int64)
        names = [n for _, _, n in self.host_events]
        ours = np.array([n.startswith(PREFIX) for n in names], dtype=bool)
        totals = {}
        for k in order[:labelled]:
            mid = (gs[k] + ge[k]) // 2
            cover = (hs <= mid) & (he >= mid)
            label = []
            for mask in (cover & ours, cover & ~ours):
                idx = np.flatnonzero(mask)
                if len(idx):
                    label.append(names[idx[np.argmax(hs[idx])]].removeprefix(PREFIX))
            key = " / ".join(label) or "host, no traced call"
            totals[key] = totals.get(key, 0) + int(gl[k])
        rest = int(gl[order[labelled:]].sum())
        if rest:
            totals["shorter gaps"] = rest
        best = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns / 1e9] for n, ns in best]
