"""Carry ALS weights between the JAX package and the port.

Both packages save the same npz keys (factors, hyper-parameters), so a
file written by ``implicit_tpu``'s ``save`` loads with
``AlternatingLeastSquares.load``. These helpers do the same for in-memory
parameters: :func:`numpy_params` gives a model's factors and
hyper-parameters as a dict of numpy values, and :func:`als_from_numpy` builds
a port model from such a dict (for example one read from a JAX model's
attributes or from its npz).
"""

import numpy as np

from .models.als import AlternatingLeastSquares

# the npz layout both packages save (implicit_tpu/models/als.py:save)
PARAM_KEYS = AlternatingLeastSquares.SAVE_KEYS


def numpy_params(model):
    """The model's save() contents as a dict (absent values left out).

    ``model`` may be either package's ALS model; factors are copied.
    """
    params = {k: getattr(model, k, None) for k in PARAM_KEYS}
    params["dtype"] = np.dtype(model.dtype).name
    for key in ("user_factors", "item_factors"):
        if params[key] is not None:
            params[key] = np.array(params[key])
    return {k: v for k, v in params.items() if v is not None}


def als_from_numpy(params, device="cuda"):
    """A port AlternatingLeastSquares on ``device`` holding ``params``.

    ``params`` maps the npz keys to values; factors are copied.
    """
    model = AlternatingLeastSquares(device=device)
    for key, value in params.items():
        if key == "dtype":
            value = np.dtype(str(value))
        elif key.endswith("_factors"):
            value = np.array(value)
        elif isinstance(value, np.ndarray) and value.shape == ():
            value = value.item()
        setattr(model, key, value)
    return model
