"""implicit_tpu_torch — the PyTorch/CUDA port of implicit_tpu.

Collaborative filtering for implicit feedback on one NVIDIA H100: an
implicit-ALS fit whose per-row conjugate-gradient solves run in hand-written
CUDA kernels (``ops/csrc``), the SGD families BPR and LMF as torch ops, the
item-item family (``nearest_neighbours``: Cosine, TF-IDF and BM25 KNN; and
``ease``: EASE), whose similarity builds on the card with torch ops or on
the host with the port's C++, and batched top-k serving: resident,
pipelined (``*_pipelined`` on CUDA streams) or streamed from the host for
tables over the residency threshold, and approximate through ``ann`` (the
on-device IVF index, ``approximate_als``'s factories). The package
mirrors ``implicit_tpu``'s module layout and public surface, the
reference's ``cpu`` / ``gpu`` alias packages and the dataset loaders
included; it imports ``torch`` and never ``jax``.

Models take ``device=`` (default ``"cuda"``); asking for CUDA where there is
none raises instead of falling back to the CPU. Importing the package sets
no global torch flag: the port's float32 products pin full float32 each
(``_device.full_f32_matmul``).
"""

from . import als, ann, approximate_als, bpr, ease, lmf, nearest_neighbours
# user code reads e.g. ``implicit.gpu.HAS_CUDA`` after a bare ``import
# implicit``, so the alias packages are bound on import, as in implicit_tpu
from . import cpu, gpu

__version__ = "0.1.0"

__all__ = ["als", "ann", "approximate_als", "bpr", "cpu", "ease", "gpu", "lmf",
           "nearest_neighbours", "__version__"]
