"""Device resolution (an explicit ``torch.device``, never a silent fallback)
and the float32 matmul precision of the port's products."""

import contextlib

import torch


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

