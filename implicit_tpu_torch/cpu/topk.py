"""Alias of the reference's ``implicit.cpu.topk`` module, with its calling
convention: the item table may be a numpy array.

The port's :func:`implicit_tpu_torch.ops.topk.topk` scores a table that is
already a tensor on the serving device. This alias uploads a host table to
``device=`` first and leaves a tensor where it is; either way it returns the
numpy ids and scores of ``ops.topk.topk``.
"""

import torch

from .._device import resolve_device
from ..ops import topk as _topk


def topk(items, query, k, item_norms=None, filter_query_items=None, filter_items=None,
         num_threads=0, device="cuda"):
    """Return the top ``k`` scoring item (ids, scores) for each query row.

    Parameters
    ----------
    items : (N, F) numpy array or torch tensor — item factors. An array is
        uploaded to ``device`` (float32; 16-bit float tables as bfloat16, as
        ``ops.topk`` streams them); a tensor is scored where it lies.
    query, k, item_norms, filter_query_items, filter_items, num_threads :
        as :func:`implicit_tpu_torch.ops.topk.topk`.
    device : str or torch.device — where a numpy table is scored (default
        ``"cuda"``; raises where CUDA is absent, never falls back).

    Returns
    -------
    (ids, scores) : (Q, k) int32 / float32 numpy arrays.
    """
    if not isinstance(items, torch.Tensor):
        dev = resolve_device(device)
        table = _topk._host_block(items, 0, len(items), _topk._table_dtype(items))
        items = _topk._upload(table, dev)
    return _topk.topk(items, query, k, item_norms=item_norms,
                      filter_query_items=filter_query_items, filter_items=filter_items,
                      num_threads=num_threads)
