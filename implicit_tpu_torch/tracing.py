"""The port's spans and counters.

A span is a block of the program with a name: ``span(name, device=None,
parent=None, **attrs)``. Spans are recorded only while a ``torch.profiler``
session records (``torch.autograd._profiler_enabled()``); otherwise a span
costs that one check and nothing else: no clock read, no CUDA event, no
sync. A recorded span keeps:

- its name and attrs;
- its id, its parent's id (``parent=``, a span entered earlier, or else the
  innermost span open in its thread) and its root's id, so that the spans
  of one fit or one request share an identifier;
- its host start and end, ``time.time_ns()``: the clock of the profiler's
  ``kineto_results`` events (Unix-epoch nanoseconds), so a span can be laid
  over a profile;
- on a CUDA ``device`` (or each CUDA device of a list, a mesh's), timing
  events recorded on the device's current stream at entry and exit: the
  span's device seconds, resolved only when :func:`spans` is read;
- the change of every counter over the span.

Spans are kept in memory, the newest ``MAX_SPANS``: the oldest are dropped
to make room, and counted by the counter ``tracing.dropped``, so a
long-lived process that profiles again still records. Nothing here opens a profiler
annotation: the profiler copies a user annotation onto the device's
timeline, where it would be counted as device work.

The program's spans: ``fit`` (a root) holds its set-up steps
(:func:`timed_step`) and an ``iteration`` per iteration, with a CUDA
device; past ``ops.cg_kernels.MAX_FACTORS`` factors an ``iteration`` holds
a ``wide solve`` per half-iteration (``ops/als.py:_solve_side_core``, the
classes of the composed CG, attr ``stage`` "model step"), with a CUDA
device. BPR's ``fit`` (``models/bpr.py``, attr ``family`` "bpr") holds its
set-up steps and an ``iteration`` per epoch (attrs ``chunks``, the epoch's
update steps, and ``entries``, the positives visited), with a CUDA device;
the grouped epoch's ``iteration`` holds a ``scatter`` per chunk (its item
updates: in pool mode 0 the keys, their sort and the ``bpr_item_update``
kernel; in the pool modes four ``_scatter_add`` calls), with a CUDA device.
The item-item fits' ``fit`` (``ease.py``, attr ``family`` "ease";
``nearest_neighbours.py``, ``family`` "item-item") holds the similarity
build's steps: set-up steps (``prepare``, ``upload``, ``copy back``) and
model steps (attr ``stage`` "model step", with a CUDA device: ``gramian``,
EASE's ``cholesky``, ``inverse`` or ``column solves``, ``weights``, and
``top-k``). ``recommend`` (a root) holds ``validate``,
``user rows``, ``dispatch`` (with its ``topk``), ``wait`` and ``post``.

Counters always count, a plain integer add each: ``device.mem_queries``
(one per ``torch.cuda.mem_get_info`` call), ``init.device_draws`` and
``init.host_draws`` (one per starting factor table drawn on the card,
``ops.pcg64``, or by numpy on the host), ``copy_back.staged_bytes`` and
``copy_back.plain_bytes`` (each fitted ALS table's bytes, by the route
``_device.to_host`` copied it to the host: through the pinned ring, or
plain), ``topk.library_selects`` (one per
selection left to ``torch.topk``: ``ops.topk.select_topk_plain``, and each
row block of an item-item similarity's top-K,
``nearest_neighbours._topk_rows``), ``gramian.dense_chunks`` (one per user
chunk densified for an item-item gramian on one device,
``nearest_neighbours._densified_chunks``) and the
groups that modules register, such as ``launches.<entry>``
(``ops.cg_kernels.LAUNCHES``, ``ops.topk.LAUNCHES``, and
``ops.bpr_update.LAUNCHES``: ``launches.bpr_item_update``, one per chunk
update of BPR's grouped epoch taken by its kernel) and ``bpr.chunk_steps``
and ``bpr.scatter_calls`` (``models.bpr.COUNTS``: one per chunk update of
the grouped epoch, one per ``_scatter_add`` call there, which only its pool
modes make).

:func:`timed_step` is the set-up steps' block: a span, and the debug line of
its seconds.
"""

import collections
import contextlib
import itertools
import logging
import threading
import time

import torch

log = logging.getLogger("implicit_tpu_torch")

# spans kept, the newest; a profiled ALS fit records about 30, a grouped
# BPR fit at the last.fm shape about 1,400, an EASE fit 9, a profiled
# request 7
MAX_SPANS = 50_000

_COUNTS = {"copy_back.plain_bytes": 0, "copy_back.staged_bytes": 0, "device.mem_queries": 0,
           "gramian.dense_chunks": 0, "init.device_draws": 0, "init.host_draws": 0,
           "topk.library_selects": 0, "tracing.dropped": 0}
_GROUPS = []  # (prefix, counts)
_spans = collections.deque()
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


def count(name, n=1):
    """Adds ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def register(prefix, counts):
    """Registers the dict ``counts`` (name -> int), which its module keeps
    counting, as the counters ``<prefix>.<name>``; returns it. Several
    modules may register under one prefix."""
    _GROUPS.append((prefix, counts))
    return counts


def counters():
    """Every counter's value, by name."""
    out = dict(_COUNTS)
    for prefix, group in _GROUPS:
        for name, value in group.items():
            out[f"{prefix}.{name}"] = value
    return out


def _cuda_devices(device):
    """The distinct CUDA devices of ``device``: None, a device or a list."""
    devices = device if isinstance(device, (list, tuple)) else [device]
    return list(dict.fromkeys(d for d in devices if d is not None and d.type == "cuda"))


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The span that records nothing."""

    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns", "end_ns", "device_s",
                 "counts", "_devices", "_up", "_events", "_before")

    def __init__(self, name, device, parent, attrs):
        self.name, self.attrs, self._up = name, attrs, parent
        self._devices = _cuda_devices(device)
        self.id = self.end_ns = self.device_s = self._events = None

    def set(self, **attrs):
        """Adds attrs known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        with _lock:
            while len(_spans) >= MAX_SPANS:
                _spans.popleft()
                _COUNTS["tracing.dropped"] += 1
            self.id = next(_ids)
            _spans.append(self)
        stack = _stack()
        up = self._up if self._up is not None else (stack[-1] if stack else None)
        if up is None or up.id is None:
            self.parent, self.root = None, self.id
        else:
            self.parent, self.root = up.id, up.root
        stack.append(self)
        self._before = counters()
        self.start_ns = time.time_ns()
        if self._devices:
            self._events = []
            for d in self._devices:
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(d))
                self._events.append((d, start))
        return self

    def __exit__(self, *exc):
        if self._events:
            for k, (d, start) in enumerate(self._events):
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(d))
                self._events[k] = (d, start, end)
        self.end_ns = time.time_ns()
        before = self._before
        self.counts = {k: v - before.get(k, 0) for k, v in counters().items()
                       if v != before.get(k, 0)}
        self._before = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        return False

    def as_dict(self):
        return dict(name=self.name, id=self.id, parent=self.parent, root=self.root,
                    attrs=dict(self.attrs), start_ns=self.start_ns, end_ns=self.end_ns,
                    device_s=self.device_s, counts=dict(self.counts))


def span(name, device=None, parent=None, **attrs):
    """A span named ``name`` around the ``with`` block; it is entered as the
    recorded span, or as ``OFF`` where nothing records. ``parent`` is an
    entered span to hang it under (a pipelined batch's span, closed before
    its wait opens), else the innermost open span of the thread."""
    if not torch.autograd._profiler_enabled():
        return OFF
    return _Span(name, device, parent, attrs)


def spans():
    """The finished spans, in the order they started, as dicts: ``name``,
    ``id``, ``parent``, ``root``, ``attrs``, ``start_ns``, ``end_ns``,
    ``device_s`` (None without a CUDA device) and ``counts`` (the counters
    that moved over the span). The CUDA events are resolved here: each
    device they were recorded on is synchronized once."""
    with _lock:
        done = [s for s in _spans if s.end_ns is not None]
    pending = [s for s in done if s._events]
    for d in dict.fromkeys(e[0] for s in pending for e in s._events):
        torch.cuda.synchronize(d)
    for s in pending:
        s.device_s = max(start.elapsed_time(end) for _, start, end in s._events) / 1e3
        s._events = None
    return [s.as_dict() for s in done]


def clear():
    """Drops the recorded spans and zeroes ``tracing.dropped``; the other
    counters keep counting."""
    with _lock:
        _spans.clear()
        _COUNTS["tracing.dropped"] = 0


@contextlib.contextmanager
def timed_step(step, device, stage="fit set-up", line=None):
    """A step of a fit: the span ``step`` (attr ``stage``) on ``device``, and
    a debug line of the block's seconds, ``"<line> %s in %.4f s"`` (args: the
    step's name, the seconds; ``line`` defaults to ``stage``): ``"fit set-up
    %s in %.4f s"`` for the factor models' set-up, ``"item-item fit ..."``
    for every step of an item-item similarity build, whatever its stage.

    With debug logging on, a CUDA ``device`` (or each of a list of devices,
    a mesh's) is synchronized before the clock starts and before it stops,
    so each step counts the device work it queued and none of the steps
    before; that gives up the overlap of host and device work across steps.
    With it off, the block runs untimed.
    """
    with span(step, device, stage=stage):
        if not log.isEnabledFor(logging.DEBUG):
            yield
            return
        devices = _cuda_devices(device)

        def sync():
            for d in devices:
                torch.cuda.synchronize(d)

        sync()
        start = time.perf_counter()
        yield
        sync()
        log.debug((line or stage) + " %s in %.4f s", step, time.perf_counter() - start)
