"""Device resolution (an explicit ``torch.device``, never a silent fallback),
the float32 matmul precision of the port's products, and the timing of the
fit's set-up steps."""

import contextlib
import logging
import time

import torch

log = logging.getLogger("implicit_tpu_torch")


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


@contextlib.contextmanager
def timed_step(step, device, stage="fit set-up"):
    """Logs the block's seconds at debug level as ``"<stage> %s in %.4f
    s"`` (args: the step's name, the seconds): ``"fit set-up %s in %.4f s"``
    for the factor models' set-up, ``"item-item fit ..."`` for the steps of
    an item-item similarity build.

    With debug logging on, a CUDA ``device`` (or each of a list of devices,
    a mesh's) is synchronized before the clock starts and before it stops,
    so each step counts the device work it queued and none of the steps
    before; that gives up the overlap of host and device work across steps.
    With it off, the block runs untimed.
    """
    if not log.isEnabledFor(logging.DEBUG):
        yield
        return
    devices = [d for d in (device if isinstance(device, (list, tuple)) else [device])
               if d.type == "cuda"]

    def sync():
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)

    sync()
    start = time.perf_counter()
    yield
    sync()
    log.debug(stage + " %s in %.4f s", step, time.perf_counter() - start)
