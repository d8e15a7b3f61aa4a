"""Drop-in alias of the reference's ``implicit.cpu`` package layout.

The reference splits every model into per-device implementations,
``implicit.cpu.*`` (Cython and OpenMP) and ``implicit.gpu.*`` (CUDA), and
user code often imports the concrete classes from those paths directly
(the reference's own factories do). The port has one implementation of
each model, whose device is chosen by ``device=``, so this package and
:mod:`implicit_tpu_torch.gpu` re-export the same classes under the
reference's module layout, as ``implicit_tpu.cpu`` does:
``implicit_tpu_torch.cpu.als.AlternatingLeastSquares`` is
``implicit_tpu_torch.models.als.AlternatingLeastSquares``.
"""

from . import als, bpr, lmf, matrix_factorization_base, topk  # noqa: F401
