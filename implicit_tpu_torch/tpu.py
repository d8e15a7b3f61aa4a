"""Device availability, the counterpart of ``implicit_tpu/tpu.py``.

The port runs on CUDA cards, so ``HAS_TPU`` is ``False`` and
``device_count()`` counts the CUDA devices torch sees (0 without one).
"""

import torch

HAS_TPU = False


def device_count():
    """Number of CUDA devices visible to torch."""
    return torch.cuda.device_count()
