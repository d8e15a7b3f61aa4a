"""Drop-in alias of the reference's ``implicit.gpu`` package layout.

``HAS_CUDA`` is the reference's availability flag: user code commonly
passes ``use_gpu=implicit.gpu.HAS_CUDA`` into the factories. Here it is
``torch.cuda.is_available()``, read on each access. The factories accept
``use_gpu`` and ignore it, as ``implicit_tpu``'s do: the device is chosen by
``device=`` (default ``"cuda"``), and ``use_gpu=False`` does not move a
model to the CPU. ``HAS_TPU`` is ``False``.

The model submodules (``als``, ``bpr``, ``matrix_factorization_base``)
re-export the same classes as :mod:`implicit_tpu_torch.cpu`.
"""

import torch

from . import als, bpr, matrix_factorization_base  # noqa: F401

HAS_TPU = False


def __getattr__(name):
    if name == "HAS_CUDA":
        return torch.cuda.is_available()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
