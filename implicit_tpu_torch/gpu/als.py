"""Alias of the reference's ``implicit.gpu.als``: the same class as
:mod:`implicit_tpu_torch.cpu.als`. ``dtype=np.float16`` (bfloat16 factors
and solves) is the analogue of the reference GPU's fp16 factors."""

from ..models.als import AlternatingLeastSquares  # noqa: F401
