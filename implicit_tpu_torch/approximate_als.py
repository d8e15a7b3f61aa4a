"""Factories combining ALS training with ANN serving.

The counterpart of ``implicit_tpu/approximate_als.py``: the port's ALS
model (on ``device=``, CUDA by default) wrapped by an ANN index. The exact
top-k (one GEMM and ``torch.topk``) is usually fast enough to serve without
one; these exist for drop-in compatibility, and the IVF index for catalogs
where probing a few clusters beats scoring them all.
"""

from . import als


def NMSLibAlternatingLeastSquares(
    *args,
    approximate_similar_items=True,
    approximate_recommend=True,
    method="hnsw",
    index_params=None,
    query_params=None,
    use_gpu=None,
    **kwargs,
):
    """ALS model whose serving is accelerated by an NMSLib HNSW index."""
    # import lazily: the ann extras are optional dependencies
    from .ann.nmslib import NMSLibModel

    als_model = als.AlternatingLeastSquares(*args, **kwargs)
    return NMSLibModel(
        als_model,
        approximate_similar_items=approximate_similar_items,
        approximate_recommend=approximate_recommend,
        method=method,
        index_params=index_params,
        query_params=query_params,
    )


def AnnoyAlternatingLeastSquares(
    *args,
    approximate_similar_items=True,
    approximate_recommend=True,
    n_trees=50,
    search_k=-1,
    use_gpu=None,
    **kwargs,
):
    """ALS model whose serving is accelerated by Annoy indexes."""
    from .ann.annoy import AnnoyModel

    als_model = als.AlternatingLeastSquares(*args, **kwargs)
    return AnnoyModel(
        als_model,
        approximate_similar_items=approximate_similar_items,
        approximate_recommend=approximate_recommend,
        n_trees=n_trees,
        search_k=search_k,
    )


def FaissAlternatingLeastSquares(
    *args,
    approximate_similar_items=True,
    approximate_recommend=True,
    nlist=400,
    nprobe=20,
    use_gpu=False,
    **kwargs,
):
    """ALS model whose serving is accelerated by Faiss IVF indexes."""
    from .ann.faiss import FaissModel

    als_model = als.AlternatingLeastSquares(*args, **kwargs)
    return FaissModel(
        als_model,
        approximate_similar_items=approximate_similar_items,
        approximate_recommend=approximate_recommend,
        nlist=nlist,
        nprobe=nprobe,
        use_gpu=use_gpu,
    )


def TPUIVFAlternatingLeastSquares(
    *args,
    approximate_similar_items=True,
    approximate_recommend=True,
    n_clusters=None,
    n_probe=None,
    kmeans_iters=15,
    **kwargs,
):
    """ALS model served by an on-device IVF index — no external ANN library.

    The counterpart of ``FaissAlternatingLeastSquares(use_gpu=True)``:
    inverted lists are built by spherical k-means on the model's device and
    queried as probed-cluster batched products (see
    implicit_tpu_torch.ann.ivf). The index build is seeded from
    ``random_state``, so a refit with one seed builds the same index.
    """
    from .ann.ivf import TPUIVFModel

    als_model = als.AlternatingLeastSquares(*args, **kwargs)
    return TPUIVFModel(
        als_model,
        approximate_similar_items=approximate_similar_items,
        approximate_recommend=approximate_recommend,
        n_clusters=n_clusters,
        n_probe=n_probe,
        kmeans_iters=kmeans_iters,
        # seed the index build alongside the model (deterministic refits)
        random_state=kwargs.get("random_state"),
    )
