"""Shared utilities: CSR coercion, RNG plumbing, result post-processing.

Host-side numpy, the counterpart of ``implicit_tpu/utils.py``.
"""

import time
import warnings

import numpy as np
import scipy.sparse


class ParameterWarning(Warning):
    pass


_checked_blas_config = False


def check_blas_config():
    """Warn once if a host BLAS threadpool runs more than one thread.

    The port's solves run on the card, but host-side preprocessing still
    touches BLAS, and a multi-threaded pool under this library's
    single-threaded call pattern only adds oversubscription. Idempotent;
    returns quietly where ``threadpoolctl`` is not installed.
    """
    global _checked_blas_config
    if _checked_blas_config:
        return
    _checked_blas_config = True

    try:
        import threadpoolctl
    except ImportError:
        return

    for api in threadpoolctl.threadpool_info():
        if api.get("user_api") != "blas" or api.get("num_threads") == 1:
            continue
        warnings.warn(
            f"BLAS library {api.get('internal_api')} is configured to use "
            f"{api.get('num_threads')} threads. Host-side preprocessing in this "
            "library is single-threaded per call; consider setting "
            "OPENBLAS_NUM_THREADS=1 / MKL_NUM_THREADS=1 to avoid oversubscription.",
            RuntimeWarning,
            stacklevel=2,
        )


def nonzeros(m, row):
    """Iterates over the (index, value) nonzeros of one row of a CSR matrix."""
    for index in range(m.indptr[row], m.indptr[row + 1]):
        yield m.indices[index], m.data[index]


def check_csr(user_items):
    """Coerce input to csr_matrix, warning about the conversion cost."""
    if not isinstance(user_items, scipy.sparse.csr_matrix):
        class_name = user_items.__class__.__name__
        start = time.time()
        user_items = user_items.tocsr()
        warnings.warn(
            f"Method expects CSR input, and was passed {class_name} instead. "
            f"Converting to CSR took {time.time() - start} seconds",
            ParameterWarning,
        )
    return user_items


def check_random_state(random_state):
    """Normalize an int / None / RandomState / Generator into a numpy Generator."""
    if isinstance(random_state, np.random.RandomState):
        # legacy RandomState: derive a Generator seed from it
        return np.random.default_rng(random_state.randint(2**31))
    return np.random.default_rng(random_state)


def augment_inner_product_matrix(factors):
    """Transform factors so angular NN search over the result ranks by inner product.

    Appends one dimension per row so every row has the same L2 norm (the
    "Xbox" Euclidean transformation). Returns (max_norm, augmented_factors).
    """
    norms = np.linalg.norm(factors, axis=1)
    max_norm = norms.max()
    extra_dimension = np.sqrt(np.maximum(max_norm**2 - norms**2, 0))
    return max_norm, np.append(factors, extra_dimension.reshape(norms.shape[0], 1), axis=1)


def _batch_call(func, ids, *args, N=10, id_dtype=np.int32, score_dtype=np.float32, **kwargs):
    """Runs a scalar-only query function once per id and stacks the results.

    Result rows shorter than N come back padded with id -1 / score -FLT_MAX.
    """
    out_ids = np.full((len(ids), N), -1, dtype=id_dtype)
    out_scores = np.full((len(ids), N), -np.finfo(np.float32).max, dtype=score_dtype)

    # sparse per-query state is passed as one matrix for the whole batch;
    # each scalar call gets its own row
    per_query = {
        name: kwargs.pop(name)
        for name in ("user_items", "item_users")
        if kwargs.get(name) is not None
    }
    kwargs.pop("user_items", None)
    kwargs.pop("item_users", None)

    for row, query in enumerate(ids):
        call_kwargs = {name: mat[row] for name, mat in per_query.items()}
        call_kwargs.update(kwargs)
        got_ids, got_scores = func(query, *args, N=N, **call_kwargs)
        n = min(N, len(got_ids))
        out_ids[row, :n] = got_ids[:n]
        out_scores[row, :n] = got_scores[:n]

    return out_ids, out_scores


def _filter_items_from_results(queryid, ids, scores, filter_items, N):
    """Drops ``filter_items`` from over-fetched results and trims to N.

    Callers request ``N + len(filter_items)`` candidates, so at least N
    survivors always remain per row.
    """
    keep = ~np.isin(ids, filter_items)
    if np.isscalar(queryid):
        return ids[keep][:N], scores[keep][:N]
    # batch: stable-partition each row so survivors come first, take N
    order = np.argsort(~keep, axis=1, kind="stable")[:, :N]
    rows = np.arange(ids.shape[0])[:, None]
    return ids[rows, order], scores[rows, order]
