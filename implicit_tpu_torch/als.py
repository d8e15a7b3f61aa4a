"""Factory for Alternating Least Squares models.

The counterpart of ``implicit_tpu/als.py``: one implementation, so the
factory forwards (``use_gpu`` is accepted for drop-in compatibility; the
device is chosen by ``device=``).
"""

import numpy as np

from .models.als import AlternatingLeastSquares as _AlternatingLeastSquares


def AlternatingLeastSquares(
    factors=100,
    regularization=0.01,
    alpha=1.0,
    dtype=np.float32,
    use_native=True,
    use_cg=True,
    use_gpu=None,
    iterations=15,
    calculate_training_loss=False,
    num_threads=0,
    random_state=None,
    mesh=None,
    grid="auto",
    ingest="auto",
    gather_quant=False,
    device="cuda",
):
    """Alternating Least Squares.

    Parameters are those of
    :class:`implicit_tpu_torch.models.als.AlternatingLeastSquares`;
    ``use_gpu`` is accepted for API parity and ignored.

    Returns
    -------
    AlternatingLeastSquares
    """
    return _AlternatingLeastSquares(
        factors=factors,
        regularization=regularization,
        alpha=alpha,
        dtype=dtype,
        use_native=use_native,
        use_cg=use_cg,
        iterations=iterations,
        calculate_training_loss=calculate_training_loss,
        num_threads=num_threads,
        random_state=random_state,
        mesh=mesh,
        grid=grid,
        ingest=ingest,
        gather_quant=gather_quant,
        device=device,
    )
