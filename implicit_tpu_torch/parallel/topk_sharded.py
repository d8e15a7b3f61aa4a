"""Item-sharded top-k: per-shard selection, then one merge.

The counterpart of ``implicit_tpu/parallel/topk_sharded.py``: each shard
scores its row slice of the items and selects its top k, the D·k candidates
per query are copied to one device, and a final ``ops.topk.select_topk``
merges them, so a query moves D·k values instead of the whole catalog's
scores.
"""

import torch

from ..ops.topk import _topk_core_sharded, shard_items_for_topk


def sharded_topk(items, queries, k, mesh):
    """Top-k of ``queries @ items.T`` with ``items`` sharded on its rows.

    Parameters
    ----------
    items : (N, F) tensor or array, cut here into one slice of ceil(N / D)
        rows per shard of ``mesh`` (the last padded, and masked)
    queries : (Q, F) tensor or array
    k : int
    mesh : parallel.Mesh

    Returns
    -------
    (values, ids) : (Q, min(k, N)) tensors on the mesh's first device
    """
    shards, _, n_items = shard_items_for_topk(items, None, mesh)
    queries = torch.as_tensor(queries).to(mesh.devices[0]).float().to(shards[0].dtype)
    return _topk_core_sharded(shards, queries, None, None, None, min(k, n_items), n_items)
