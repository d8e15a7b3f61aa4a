"""Factory for Logistic Matrix Factorization models.

The counterpart of ``implicit_tpu/lmf.py``: one implementation, so the
factory forwards. ``use_gpu`` is accepted for drop-in compatibility and
ignored, as in ``implicit_tpu``: the device is chosen by ``device=``.
"""

import numpy as np

from .models.lmf import LogisticMatrixFactorization as _LogisticMatrixFactorization


def LogisticMatrixFactorization(
    factors=30,
    learning_rate=1.00,
    regularization=0.6,
    dtype=np.float32,
    iterations=30,
    neg_prop=30,
    use_gpu=None,
    num_threads=0,
    random_state=None,
    mesh=None,
    ingest="auto",
    device="cuda",
):
    """Logistic Matrix Factorization.

    Parameters are those of
    :class:`implicit_tpu_torch.models.lmf.LogisticMatrixFactorization`;
    ``use_gpu`` is accepted for API parity and ignored: the device is
    ``device=`` (default ``"cuda"``), so ``use_gpu=False`` does not move the
    model to the CPU; pass ``device="cpu"`` for that.

    Returns
    -------
    LogisticMatrixFactorization
    """
    return _LogisticMatrixFactorization(
        factors=factors,
        learning_rate=learning_rate,
        regularization=regularization,
        dtype=dtype,
        iterations=iterations,
        neg_prop=neg_prop,
        num_threads=num_threads,
        random_state=random_state,
        mesh=mesh,
        ingest=ingest,
        device=device,
    )
