"""Factory for Bayesian Personalized Ranking models.

The counterpart of ``implicit_tpu/bpr.py``: one implementation, so the
factory forwards. ``use_gpu`` is accepted for drop-in compatibility and
ignored, as in ``implicit_tpu``: the device is chosen by ``device=``.
"""

import numpy as np

from .models.bpr import BayesianPersonalizedRanking as _BayesianPersonalizedRanking


def BayesianPersonalizedRanking(
    factors=100,
    learning_rate=0.01,
    regularization=0.01,
    dtype=np.float32,
    iterations=100,
    use_gpu=None,
    num_threads=0,
    verify_negative_samples=True,
    random_state=None,
    mesh=None,
    epoch_mode=None,
    device="cuda",
):
    """Bayesian Personalized Ranking.

    Parameters are those of
    :class:`implicit_tpu_torch.models.bpr.BayesianPersonalizedRanking`;
    ``use_gpu`` is accepted for API parity and ignored: the device is
    ``device=`` (default ``"cuda"``), so ``use_gpu=False`` does not move the
    model to the CPU; pass ``device="cpu"`` for that.

    Returns
    -------
    BayesianPersonalizedRanking
    """
    return _BayesianPersonalizedRanking(
        factors=factors,
        learning_rate=learning_rate,
        regularization=regularization,
        dtype=dtype,
        iterations=iterations,
        num_threads=num_threads,
        verify_negative_samples=verify_negative_samples,
        random_state=random_state,
        mesh=mesh,
        epoch_mode=epoch_mode,
        device=device,
    )
