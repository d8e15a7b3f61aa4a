"""Device resolution: an explicit ``torch.device``, never a silent fallback."""

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

