"""Device resolution (an explicit ``torch.device``, never a silent fallback),
the float32 matmul precision of the port's products, and the copy of fitted
tables to the host through a pinned staging ring."""

import contextlib
import mmap
import threading

import numpy as np
import torch

from . import tracing

# the copy back's pinned staging ring (:func:`to_host`): SLOTS slots of
# SLOT_BYTES, one allocation per CUDA device and process; a CUDA table of at
# least two slots' bytes is staged through it. 8 MiB a slot: the H100's
# pinned copies run at 51-54 GB/s from 4 MiB up, and two slots stay under
# the smallest fitted table of the benchmark (ML-20M's items, 27.4 MB)
SLOT_BYTES = 8 << 20
SLOTS = 4

_rings = {}
_rings_lock = threading.Lock()


def resolve_device(device):
    """``device`` as a ``torch.device``; raises if it names CUDA without one.

    Only ``cpu`` and ``cuda`` devices are accepted: the solve kernels exist
    for CUDA, and their plain PyTorch versions serve CPU tensors.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """float32 products inside the block run in full float32, as the JAX
    package's ``Precision.HIGHEST`` dots; the caller's setting is restored on
    exit, also on an exception.

    TF32 keeps about three decimal digits and would move the solves and the
    scores. The pin covers the port's products only, not the caller's: the
    setting is restored when the block ends, and cuDNN's is never touched.
    It is not thread-safe: PyTorch keeps the setting per process, so while
    a thread is inside the block, products that other threads run meanwhile
    are in full float32 too, and a setting they make meanwhile is undone
    when the block ends. Where the caller set the
    precision through the per-backend ``fp32_precision`` API, which cannot be
    read back through ``torch.get_float32_matmul_precision`` (PyTorch raises
    on the mix), ``torch.backends.cuda.matmul.fp32_precision`` is pinned
    instead.
    """
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError:
        matmul = torch.backends.cuda.matmul
        saved = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = saved
        return
    if saved == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def on_device(device):
    """Work queued inside the block goes to ``device``'s current stream: a
    ``torch.cuda.device`` switch for a CUDA device, nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def to_host(tables):
    """The tensors ``tables`` as numpy arrays on the host, in order.

    A CUDA table of at least two slots' bytes is copied in SLOT_BYTES chunks
    through its device's pinned ring (:class:`_Ring`), into a host array
    whose pages are faulted in while the device still runs the work queued
    before the call; any other table is ``t.cpu().numpy()``. Each table's
    bytes are counted by route in ``copy_back.staged_bytes`` or
    ``copy_back.plain_bytes``. The staged arrays hold the same bits as the
    plain copy's.
    """
    out = [None] * len(tables)
    staged = {}
    for k, t in enumerate(tables):
        nbytes = t.numel() * t.element_size()
        if t.device.type == "cuda" and nbytes >= 2 * SLOT_BYTES:
            staged.setdefault(t.device, []).append(k)
            tracing.count("copy_back.staged_bytes", nbytes)
        else:
            out[k] = t.cpu().numpy()
            tracing.count("copy_back.plain_bytes", nbytes)
    for device, ks in staged.items():
        for k, array in zip(ks, _ring(device).copy([tables[k] for k in ks])):
            out[k] = array
    return out


def _ring(device):
    """``device``'s staging ring, made on first use."""
    with _rings_lock:
        ring = _rings.get(device)
        if ring is None:
            ring = _rings[device] = _Ring(device)
        return ring


def _host_array(shape, dtype):
    """A new host array whose pages are already faulted in: an anonymous
    mapping the kernel populates (MAP_POPULATE, Linux): on an H100's host
    about twice the rate of writing a byte of each page from Python."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    m = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE)
    return np.frombuffer(m, dtype=dtype).reshape(shape)


def _chunks(flats):
    """The chunks of the 1-D tensors ``flats``, in order: (table, start,
    end) element ranges of at most SLOT_BYTES each."""
    out = []
    for k, flat in enumerate(flats):
        per = SLOT_BYTES // flat.element_size()
        out += [(k, a, min(a + per, flat.numel())) for a in range(0, flat.numel(), per)]
    return out


class _Ring:
    """SLOTS pinned staging slots and a copy stream on one CUDA device.

    :meth:`copy` holds the lock from its first chunk to its last, so two
    threads copying from one device never share a slot.
    """

    def __init__(self, device):
        self.device, self.lock = device, threading.Lock()
        self.stream = torch.cuda.Stream(device)
        self.pinned = torch.empty(SLOTS * SLOT_BYTES, dtype=torch.uint8, pin_memory=True)
        self.done = [torch.cuda.Event() for _ in range(SLOTS)]

    def copy(self, tables):
        """Host arrays of the CUDA tensors ``tables`` (all on the ring's
        device, each non-empty).

        Chunk ``c`` goes into slot ``c % SLOTS`` on the copy stream, behind
        everything queued on the caller's stream before the call, and records
        the slot's event; the host waits for that event, copies the slot into
        the chunk's place with torch's threads, and only then queues chunk
        ``c + SLOTS`` into the slot. The first SLOTS chunks are queued before
        the host arrays are made, so the device finishes its queue and fills
        them while the host faults in the arrays' pages.
        """
        with self.lock:
            flats = [t.contiguous().reshape(-1) for t in tables]
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            for flat in flats:
                flat.record_stream(self.stream)
            chunks = _chunks(flats)

            def slot_view(c):
                k, a, b = chunks[c]
                start = (c % SLOTS) * SLOT_BYTES
                return self.pinned[start:start + (b - a) * flats[k].element_size()].view(
                    flats[k].dtype)

            def queue(c):
                k, a, b = chunks[c]
                with torch.cuda.stream(self.stream):
                    slot_view(c).copy_(flats[k][a:b], non_blocking=True)
                    self.done[c % SLOTS].record(self.stream)

            for c in range(min(SLOTS, len(chunks))):
                queue(c)
            out = [_host_array(t.shape, torch.empty(0, dtype=t.dtype).numpy().dtype)
                   for t in tables]
            dests = [torch.from_numpy(a).reshape(-1) for a in out]
            for c, (k, a, b) in enumerate(chunks):
                self.done[c % SLOTS].synchronize()
                dests[k][a:b].copy_(slot_view(c))
                if c + SLOTS < len(chunks):
                    queue(c + SLOTS)
            return out
