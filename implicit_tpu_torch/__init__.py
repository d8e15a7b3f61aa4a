"""implicit_tpu_torch — the PyTorch/CUDA port of implicit_tpu.

Collaborative filtering for implicit feedback on one NVIDIA H100: an
implicit-ALS fit whose per-row conjugate-gradient solves run in hand-written
CUDA kernels (``ops/csrc``), followed by batched top-k serving. The package
mirrors ``implicit_tpu``'s module layout and public surface; it imports
``torch`` and never ``jax``.

Models take ``device=`` (default ``"cuda"``); asking for CUDA where there is
none raises instead of falling back to the CPU.
"""

import torch

# float32 products in full float32, as the JAX package's Precision.HIGHEST
# dots: TF32 keeps ~3 decimal digits and would move the solves and scores
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import als  # noqa: E402

__version__ = "0.1.0"

__all__ = ["als", "__version__"]
