"""Shared serving logic for matrix-factorization models.

The counterpart of ``implicit_tpu/models/mf_base.py``: recommend /
recommend_all / similar_users / similar_items with the filter_items /
items= / filter_already_liked_items / recalculate semantics, norm caches,
and a device copy of each factor table cached in the serving dtype
(bfloat16 for 16-bit models, float32 otherwise). Scalar queries are the
batch path plus a squeeze at the edge, so batch and scalar results agree
by construction.

Every call is a dispatch that returns a future and a post-processing step
(``_recommend_async``, ``_similar_async``); the synchronous calls wait on
it at once, and the ``*_pipelined`` generators keep several batches in
flight, so one batch's host work and copies overlap the others' products.
A factor table larger than the residency threshold
(:func:`_stream_threshold_bytes`) stays on the host and serves through
``ops.topk.topk_streaming``; its pipelined generators serve every
``_STREAM_PASS_ROWS`` buffered query rows in one pass over the table.

A model with a ``mesh`` (an int, or a ``parallel.Mesh``) serves through it:
the table is sharded on its rows over the mesh once and cached
(:meth:`MatrixFactorizationBase._factors_on_mesh`), each shard scores and
selects on its device, and the candidates merge on the mesh's first device
(``ops.topk`` with ``mesh=``); the threshold then applies to one shard's
rows, and a table over it streams with each block cut over the mesh.

Factor matrices live on the host as numpy arrays (the public contract);
assigning ``user_factors`` / ``item_factors`` drops the device copy.
"""

from collections import deque

import numpy as np
import torch
from scipy.sparse import csr_matrix

from .. import tracing
from .._device import resolve_device
from ..ops.topk import (
    _score_budget_elements, _upload, shard_items_for_topk, topk_async, topk_streaming,
)
from ..parallel.mesh import Mesh, mesh_state, resolve_mesh
from ..recommender_base import RecommenderBase

# bound on the buffered query rows of one table pass of the streaming
# pipelined path: memory stays about rows x (F + k) while the passes drop to
# ceil(total rows / this) instead of one per batch
_STREAM_PASS_ROWS = 65536


class _StreamTable:
    """A factor table served through ``ops.topk.topk_streaming``: the host
    array stays on the host and its row blocks upload per call, each cut
    over ``mesh`` where there is one. Chosen when the table is over the
    residency threshold."""

    def __init__(self, array, mesh=None):
        self.array = array
        self.mesh = mesh


class _MeshTable:
    """A factor table sharded on its rows over a mesh
    (``ops.topk.shard_items_for_topk``): its shards, their norms (or None)
    and the true row count."""

    def __init__(self, shards, norms, n_items, mesh):
        self.shards = shards
        self.norms = norms
        self.n_items = n_items
        self.mesh = mesh


class _ReadyFuture:
    """A TopkFuture-shaped wrapper of results already on the host."""

    def __init__(self, ids, scores):
        self._out = (ids, scores)

    def result(self):
        return self._out


def _stream_threshold_bytes(device):
    """Tables above this byte size stream from the host instead of being
    resident on ``device``: 4 x the score budget (half of the free device
    memory, capped at 4 GB: 4 GiB on an 80 GB card), the JAX package's rule,
    so both packages route a table alike."""
    return 4 * _score_budget_elements(device)


def _validate_subset(subset, total, what):
    """Normalize an items=/users= restriction array, bounds-checked."""
    subset = np.array(subset)
    if subset.max() >= total or subset.min() < 0:
        raise IndexError(f"Some {what} in the parameter are not in the model")
    return subset


def _validate_user_items(userid, user_items):
    """The recommend() contract checks on a per-user interaction matrix."""
    if not isinstance(user_items, csr_matrix):
        raise ValueError("user_items needs to be a CSR sparse matrix")
    if user_items.shape[0] != _batch_size(userid):
        raise ValueError("user_items must contain 1 row for every user in userids")


def _positions_in_subset(items, query_items):
    """``query_items`` with its columns renumbered to positions in the sorted
    ``items`` subset; entries whose item is not in the subset are dropped."""
    coo = query_items.tocoo()
    pos = np.searchsorted(items, coo.col)
    inside = pos < len(items)
    inside[inside] = items[pos[inside]] == coo.col[inside]
    return csr_matrix(
        (coo.data[inside], (coo.row[inside], pos[inside])),
        shape=(query_items.shape[0], len(items)),
    )


def _post_recommend(ids, scores, scalar, items):
    """recommend's post-processing: the scalar squeeze and the items= remap
    (shared by every route, so their results agree by construction)."""
    if scalar:
        ids, scores = ids[0], scores[0]
    if items is not None:
        ids = items[ids]
    return ids, scores


def _post_similar(ids, scores, query_norm, scalar, subset):
    """similar_*'s post-processing: the scalar squeeze, the division by the
    query's norm (sentinels kept) and the subset remap (-1 kept)."""
    if scalar:
        ids, scores = ids[0], scores[0]
        norm = query_norm
    else:
        norm = query_norm[:, None]
    # -FLT_MAX padding entries stay sentinels (dividing them overflows)
    np.divide(scores, norm, out=scores, where=ids >= 0)
    if subset is not None:
        # short rows pad with id -1: keep it rather than wrapping around
        ids = np.where(ids >= 0, subset[ids], -1)
    return ids, scores


def _finish(future, post, root=None):
    """``post(*future.result())``: the spans ``wait`` and ``post``, under
    ``root`` (a batch's span) where it is given, else under the innermost
    open span."""
    with tracing.span("wait", parent=root):
        out = future.result()
    with tracing.span("post", parent=root):
        return post(*out)


def _pipeline(dispatches, max_in_flight):
    """Drains an iterator of ``(future, post)`` pairs, or ``(future, post,
    root)`` with the batch's span, through a window of at most
    ``max_in_flight`` dispatched batches, yielding ``post(*future.
    result())`` in input order (:func:`_finish`): the engine of every
    ``*_pipelined`` method."""
    window = deque()
    for batch in dispatches:
        window.append(batch)
        if len(window) >= max_in_flight:
            yield _finish(*window.popleft())
    while window:
        yield _finish(*window.popleft())


def _batch_size(userid):
    """The users of a recommend call: 1 for a scalar id."""
    return 1 if np.isscalar(userid) else len(userid)


def _entry(entry):
    """A recommend_pipelined batch: ``userids`` or ``(userids, user_items)``."""
    return entry if isinstance(entry, tuple) else (entry, None)


class MatrixFactorizationBase(RecommenderBase):
    """Common recommend/similar_* functionality on top of factor matrices.

    Attributes
    ----------
    item_factors : ndarray — latent factors for each item
    user_factors : ndarray — latent factors for each user
    device : torch.device — where solves run and serving tables live
    """

    def __init__(self, num_threads=0, device="cuda"):
        self.device = resolve_device(device)
        self._item_factors = None
        self._user_factors = None
        self._user_norms, self._item_norms = None, None
        self._item_factors_dev = None
        self._user_factors_dev = None
        self._mesh_serving_cache = {}
        self.num_threads = num_threads

    # -- factor storage + device cache --------------------------------------

    @property
    def user_factors(self):
        return self._user_factors

    @user_factors.setter
    def user_factors(self, value):
        self._user_factors = value
        self._user_factors_dev = None
        self._drop_mesh_cache("user")

    @property
    def item_factors(self):
        return self._item_factors

    @item_factors.setter
    def item_factors(self, value):
        self._item_factors = value
        self._item_factors_dev = None
        self._drop_mesh_cache("item")

    def _serving_dtype(self):
        """bfloat16 for models with 16-bit factor storage, else float32.

        Scores are accumulated and returned in float32 either way.
        """
        dt = getattr(self, "dtype", None)
        if dt is not None and np.dtype(dt).itemsize == 2:
            return torch.bfloat16
        return torch.float32

    def _to_serving(self, factors):
        return torch.as_tensor(np.asarray(factors)).to(
            device=self.device, dtype=self._serving_dtype())

    def _table_streams(self, factors, n_shards=1):
        """True when ``factors`` is over the residency threshold, in the
        serving dtype's bytes. A table sharded over ``n_shards`` needs 1/n
        of its bytes on each device, so a mesh pools the budget."""
        if factors is None:
            return False
        itemsize = 2 if self._serving_dtype() == torch.bfloat16 else 4
        nbytes = factors.shape[0] * factors.shape[1] * itemsize // max(n_shards, 1)
        return nbytes > _stream_threshold_bytes(self.device)

    def _user_factors_on_device(self):
        if self._user_factors_dev is None:
            self._user_factors_dev = self._to_serving(self._user_factors)
        return self._user_factors_dev

    def _item_factors_on_device(self):
        if self._item_factors_dev is None:
            self._item_factors_dev = self._to_serving(self._item_factors)
        return self._item_factors_dev

    def _serving_table(self, which):
        """The full user or item table as the top-k reads it: the cached
        device copy, the cached :class:`_MeshTable` of a meshed model, or a
        :class:`_StreamTable` over the host array."""
        host = self.user_factors if which == "user" else self.item_factors
        mesh = self._serving_mesh()
        if mesh is not None:
            if self._table_streams(host, n_shards=mesh.size):
                return _StreamTable(host, mesh)
            return self._factors_on_mesh(which, mesh)
        if self._table_streams(host):
            return _StreamTable(host)
        return (self._user_factors_on_device() if which == "user"
                else self._item_factors_on_device())

    def __getstate__(self):
        # device tensors stay out of pickles; the caches refill on use. A
        # Mesh is stored as its size, and rebuilt on the model's device when
        # it is next used (:meth:`_serving_mesh`): a mesh over several cards
        # then raises where fewer are visible, a virtual mesh stays virtual
        state = self.__dict__.copy()
        state["_item_factors_dev"] = None
        state["_user_factors_dev"] = None
        state["_mesh_serving_cache"] = {}
        return mesh_state(state)

    # -- serving over a mesh -----------------------------------------------------

    def _serving_mesh(self):
        """The model's ``Mesh``, or None: a Mesh as it is; an int n as
        ``parallel.create_mesh(n, device)`` on the model's device (n cards on
        CUDA, raising where fewer are visible; n virtual shards on the CPU),
        or as a virtual mesh where the model was pickled with one. Cached."""
        mesh = getattr(self, "mesh", None)
        if mesh is None or isinstance(mesh, Mesh):
            return mesh
        virtual = getattr(self, "_mesh_virtual", False)
        cache = self._mesh_cache_dict()
        key = ("mesh", int(mesh), virtual)
        if key not in cache:
            cache[key] = resolve_mesh(mesh, self.device, virtual)
        return cache[key]

    def _mesh_cache_dict(self):
        # a model loaded through __new__ has no cache yet
        cache = getattr(self, "_mesh_serving_cache", None)
        if cache is None:
            cache = self._mesh_serving_cache = {}
        return cache

    def _drop_mesh_cache(self, which):
        cache = getattr(self, "_mesh_serving_cache", None)
        if cache:
            for key in [k for k in cache if k[0] == which]:
                del cache[key]

    def _factors_on_mesh(self, which, mesh):
        """The user or item table sharded over ``mesh`` in the serving dtype,
        with its norms (similar_* divides by them, recommend does not read
        them), as a cached :class:`_MeshTable`."""
        cache = self._mesh_cache_dict()
        key = (which, mesh)
        if key not in cache:
            host = self.user_factors if which == "user" else self.item_factors
            norms = self.user_norms if which == "user" else self.item_norms
            cache[key] = _MeshTable(*shard_items_for_topk(host, norms, mesh,
                                                          dtype=self._serving_dtype()), mesh)
        return cache[key]

    # -- norms ---------------------------------------------------------------

    def _norms_of(self, factors):
        # norms describe the table the GEMM scores: 16-bit models round
        # through bfloat16 first (so cosine self-similarity stays 1), then
        # accumulate in float32. Blockwise, so a memmapped table never
        # materializes whole
        if factors.ndim == 1:
            factors = factors.reshape(1, -1)
        n = factors.shape[0]
        norms = np.empty(n, dtype=np.float32)
        block = max(1, (1 << 26) // max(factors.shape[1], 1))
        for s in range(0, n, block):
            t = torch.as_tensor(np.array(factors[s : s + block]))
            t = t.to(self._serving_dtype()).float()
            norms[s : s + block] = torch.linalg.vector_norm(t, dim=-1).numpy()
        norms[norms == 0] = 1e-10  # avoid divide-by-zero in similarity scoring
        return norms

    @property
    def user_norms(self):
        if self._user_norms is None:
            self._user_norms = self._norms_of(self.user_factors)
        return self._user_norms

    @property
    def item_norms(self):
        if self._item_norms is None:
            self._item_norms = self._norms_of(self.item_factors)
        return self._item_norms

    # -- recalculate hooks (overridden by models that support fold-in) -------

    def recalculate_user(self, userid, user_items):
        raise NotImplementedError("recalculate_user is not supported with this model")

    def recalculate_item(self, itemid, item_users):
        raise NotImplementedError("recalculate_item is not supported with this model")

    def _rows(self, which, ids):
        """Rows ``ids`` of the user or item table: gathered on the device
        from the cached copy, or on the host when the table streams (it
        must never upload whole) or is sharded over a mesh."""
        table = self._serving_table(which)
        if isinstance(table, (_StreamTable, _MeshTable)):
            table = self.user_factors if which == "user" else self.item_factors
        return table[ids : ids + 1] if np.isscalar(ids) else table[np.asarray(ids)]

    def _user_factor(self, userid, user_items, recalculate_user=False):
        if recalculate_user:
            return self.recalculate_user(userid, user_items)
        return self._rows("user", userid)

    def _item_factor(self, itemid, item_users, recalculate_item=False):
        if recalculate_item:
            return self.recalculate_item(itemid, item_users)
        return self._rows("item", itemid)

    # -- recommend -------------------------------------------------------------

    def _prep_recommend_items(self, items, filter_items, N):
        """Validates ``items=`` and resolves the scoring table.

        Returns ``(N, items, table)``: the subset's rows on the device in
        the serving dtype (sharded over the mesh of a meshed model), or the
        full table (:meth:`_serving_table`); a table over the threshold is
        a :class:`_StreamTable`. The pipelined generators call it once for
        the whole stream.
        """
        if items is None:
            return N, None, self._serving_table("item")
        if filter_items:
            raise ValueError("Can't set both items and filter_items in recommend call")
        N = min(N, len(items))
        items = _validate_subset(items, self.item_factors.shape[0], "itemids")
        items.sort()
        subset = self.item_factors[items]
        mesh = self._serving_mesh()
        if mesh is not None:
            if self._table_streams(subset, n_shards=mesh.size):
                return N, items, _StreamTable(subset, mesh)
            return N, items, _MeshTable(*shard_items_for_topk(
                subset, None, mesh, dtype=self._serving_dtype()), mesh)
        if self._table_streams(subset):
            return N, items, _StreamTable(subset)
        # subset tables score in the serving dtype, like the full table
        return N, items, self._to_serving(subset)

    def _recommend_async(self, userid, user_items, N, filter_already_liked_items,
                         filter_items, recalculate_user, items, prep=None):
        """Dispatches one recommend batch; returns ``(future, post)``.

        The host work and the device queueing happen here; ``post(ids,
        scores)`` applies the scalar squeeze and the items= remap once the
        future is read, so recommend is ``post(*future.result())``. ``prep``
        is a :meth:`_prep_recommend_items` result made once per stream.
        """
        with tracing.span("validate"):
            if filter_already_liked_items or recalculate_user:
                _validate_user_items(userid, user_items)

        with tracing.span("user rows"):
            user = self._user_factor(userid, user_items, recalculate_user)

        with tracing.span("dispatch"):
            if prep is None:
                prep = self._prep_recommend_items(items, filter_items, N)
            N, items, table = prep

            filter_query_items = None
            if filter_already_liked_items:
                filter_query_items = user_items
                if items is not None:
                    filter_query_items = _positions_in_subset(items, filter_query_items)

            with tracing.span("topk"):
                if isinstance(table, _StreamTable):
                    future = _ReadyFuture(*topk_streaming(
                        table.array, user, N, filter_query_items=filter_query_items,
                        filter_items=filter_items, device=self.device, mesh=table.mesh))
                elif isinstance(table, _MeshTable):
                    future = topk_async(table.shards, user, N,
                                        filter_query_items=filter_query_items,
                                        filter_items=filter_items, mesh=table.mesh,
                                        n_items=table.n_items)
                else:
                    future = topk_async(table, user, N, filter_query_items=filter_query_items,
                                        filter_items=filter_items)

        def post(ids, scores):
            return _post_recommend(ids, scores, np.isscalar(userid), items)

        return future, post

    def recommend(
        self,
        userid,
        user_items,
        N=10,
        filter_already_liked_items=True,
        filter_items=None,
        recalculate_user=False,
        items=None,
    ):
        with tracing.span("recommend", users=_batch_size(userid), N=N):
            future, post = self._recommend_async(userid, user_items, N,
                                                 filter_already_liked_items, filter_items,
                                                 recalculate_user, items)
            return _finish(future, post)

    recommend.__doc__ = RecommenderBase.recommend.__doc__

    def recommend_pipelined(
        self,
        batches,
        N=10,
        filter_already_liked_items=True,
        filter_items=None,
        recalculate_user=False,
        items=None,
        max_in_flight=3,
    ):
        """Batched recommend as a generator: up to ``max_in_flight`` batches
        are dispatched to the device at once, and each batch's ``(ids,
        scores)`` is yielded in input order.

        Results equal :meth:`recommend` per batch; the host work, the
        uploads and the result copies of one batch overlap the others'
        products. A table over the residency threshold serves every
        ``_STREAM_PASS_ROWS`` buffered query rows in one pass over it.

        Parameters
        ----------
        batches : iterable of userid arrays, or of (userids, user_items)
            pairs where ``filter_already_liked_items`` / ``recalculate_user``
            need each batch's interaction rows. Consumed lazily.
        max_in_flight : int, optional
            Bound on the batches dispatched at once (device memory grows
            with it).
        Other parameters are as in :meth:`recommend`.

        Yields
        ------
        (ids, scores) per input batch, in order.
        """
        if type(self).recommend is not MatrixFactorizationBase.recommend:
            # a subclass with its own recommend is not bypassed: serve each
            # batch through it, with the same results and no pipelining
            def fallback():
                for entry in batches:
                    userid, user_items = _entry(entry)
                    yield self.recommend(
                        userid, user_items, N=N,
                        filter_already_liked_items=filter_already_liked_items,
                        filter_items=filter_items, recalculate_user=recalculate_user,
                        items=items)

            return fallback()

        # arguments are checked and the table resolved now, not at the first
        # next(): bad arguments raise at the call, as in recommend
        prep = self._prep_recommend_items(items, filter_items, N)
        if isinstance(prep[2], _StreamTable):
            return self._recommend_stream_once(batches, prep, filter_already_liked_items,
                                               filter_items, recalculate_user)

        def dispatches():
            # each batch's span closes once the batch is queued: its wait and
            # post come later, between other batches', under it by parent=
            for entry in batches:
                userid, user_items = _entry(entry)
                with tracing.span("recommend", users=_batch_size(userid), N=N) as root:
                    future, post = self._recommend_async(
                        userid, user_items, N, filter_already_liked_items, filter_items,
                        recalculate_user, items, prep=prep)
                yield future, post, root

        return _pipeline(dispatches(), max_in_flight)

    def _recommend_stream_once(self, batches, prep, filter_already_liked_items, filter_items,
                               recalculate_user):
        """recommend_pipelined over a streaming table: batches are buffered
        up to ``_STREAM_PASS_ROWS`` query rows, and each buffered group is
        served in one ``topk_streaming`` pass over the host table. Yields
        per-batch results equal to per-batch recommend."""
        N, items, table = prep
        n_cols = len(items) if items is not None else table.array.shape[0]

        def flush(group):
            # entries: (queries, filter rows, filter cols, rows, scalar)
            queries = torch.cat([g[0] for g in group])
            fqi = None
            if filter_already_liked_items:
                offsets = np.cumsum([0] + [g[3] for g in group])
                rows = np.concatenate([g[1] + off for g, off in zip(group, offsets)])
                cols = np.concatenate([g[2] for g in group])
                fqi = csr_matrix((np.ones(len(rows), dtype=np.float32), (rows, cols)),
                                 shape=(offsets[-1], n_cols))
            all_ids, all_scores = topk_streaming(table.array, queries, N,
                                                 filter_query_items=fqi,
                                                 filter_items=filter_items, device=self.device,
                                                 mesh=table.mesh)
            offset = 0
            for _, _, _, n_rows, scalar in group:
                yield _post_recommend(all_ids[offset : offset + n_rows],
                                      all_scores[offset : offset + n_rows], scalar, items)
                offset += n_rows

        def gen():
            group, rows = [], 0
            for entry in batches:
                userid, user_items = _entry(entry)
                if filter_already_liked_items or recalculate_user:
                    _validate_user_items(userid, user_items)
                u = _upload(self._user_factor(userid, user_items, recalculate_user),
                            self.device).float()
                if u.dim() == 1:  # a scalar recalculate returns one row
                    u = u.reshape(1, -1)
                fr = fc = None
                if filter_already_liked_items:
                    fq = user_items
                    if items is not None:
                        fq = _positions_in_subset(items, fq)
                    coo = fq.tocoo()
                    # batches may carry matrices of other widths: ids past
                    # the catalog filter nothing
                    keep = coo.col < n_cols
                    fr = coo.row[keep].astype(np.int64)
                    fc = coo.col[keep].astype(np.int64)
                group.append((u, fr, fc, u.shape[0], np.isscalar(userid)))
                rows += u.shape[0]
                if rows >= _STREAM_PASS_ROWS:
                    yield from flush(group)
                    group, rows = [], 0
            if group:
                yield from flush(group)

        return gen()

    def recommend_all(
        self,
        user_items,
        N=10,
        recalculate_user=False,
        filter_already_liked_items=True,
        filter_items=None,
        users_items_offset=0,
    ):
        """Deprecated: recommend for every user; use recommend with an array instead."""
        import warnings

        from scipy.sparse import lil_matrix

        warnings.warn(
            "recommend_all is deprecated. Use recommend with an array of userids instead",
            DeprecationWarning,
        )

        userids = np.arange(user_items.shape[0]) + users_items_offset
        if users_items_offset:
            adjusted = lil_matrix(
                (user_items.shape[0] + users_items_offset, user_items.shape[1]),
                dtype=user_items.dtype,
            )
            adjusted[users_items_offset:] = user_items
            user_items = adjusted.tocsr()

        ids, _ = self.recommend(
            userids,
            user_items,
            N=N,
            filter_already_liked_items=filter_already_liked_items,
            filter_items=filter_items,
            recalculate_user=recalculate_user,
        )
        return ids

    # -- similarity lookups ------------------------------------------------------

    def _prep_similar_table(self, which, subset):
        """The candidate table of similar_* and its norms, ``(table,
        norms)``: the subset's rows on the device (norms beside them), the
        full device table with its norms uploaded, a :class:`_MeshTable`
        (its norm shards inside), or a :class:`_StreamTable` with the host
        norms. Made once per pipelined stream."""
        host = self.user_factors if which == "user" else self.item_factors
        norms = self.user_norms if which == "user" else self.item_norms
        mesh = self._serving_mesh()
        if subset is not None:
            host, norms = host[subset], norms[subset]
            if mesh is not None:
                if self._table_streams(host, n_shards=mesh.size):
                    return _StreamTable(host, mesh), norms
                return _MeshTable(*shard_items_for_topk(host, norms, mesh,
                                                        dtype=self._serving_dtype()), mesh), None
            if self._table_streams(host):
                return _StreamTable(host), norms
            # in the serving dtype: the norms were taken of the rounded table
            return self._to_serving(host), _upload(norms, self.device)
        table = self._serving_table(which)
        if isinstance(table, _StreamTable):
            return table, norms
        if isinstance(table, _MeshTable):
            return table, None
        return table, _upload(norms, self.device)

    def _similar_async(self, query_factor, query_norm, N, filter_ids, subset, prep):
        """Dispatches one similar_* batch against ``prep`` (a
        :meth:`_prep_similar_table` result); returns ``(future, post)``.

        Scores are the cosine against the candidates: the product divided
        by the candidates' norms on the device, then by the query's own
        norm in ``post``, which also remaps subset ids.
        """
        table, norms = prep
        if isinstance(table, _StreamTable):
            future = _ReadyFuture(*topk_streaming(table.array, query_factor, N,
                                                  item_norms=norms, filter_items=filter_ids,
                                                  device=self.device, mesh=table.mesh))
        elif isinstance(table, _MeshTable):
            future = topk_async(table.shards, query_factor, N, item_norms=table.norms,
                                filter_items=filter_ids, mesh=table.mesh,
                                n_items=table.n_items)
        else:
            future = topk_async(table, query_factor, N, item_norms=norms,
                                filter_items=filter_ids)

        def post(ids, scores):
            return _post_similar(ids, scores, query_norm, np.isscalar(query_norm), subset)

        return future, post

    def _similar_stream_once(self, batches, prep, N, filter_ids, subset, get_query):
        """similar_*_pipelined over a streaming table: batches are buffered
        up to ``_STREAM_PASS_ROWS`` query rows, each group served in one
        ``topk_streaming`` pass (see :meth:`_recommend_stream_once`)."""
        table, norms = prep

        def flush(group):
            queries = torch.cat([g[0] for g in group])
            all_ids, all_scores = topk_streaming(table.array, queries, N, item_norms=norms,
                                                 filter_items=filter_ids, device=self.device,
                                                 mesh=table.mesh)
            offset = 0
            for _, qn, n_rows, scalar in group:
                yield _post_similar(all_ids[offset : offset + n_rows],
                                    all_scores[offset : offset + n_rows],
                                    float(qn[0]) if scalar else qn, scalar, subset)
                offset += n_rows

        def gen():
            group, rows = [], 0
            for b in batches:
                q, qn = get_query(b)
                q = _upload(q, self.device).float()
                scalar = q.dim() == 1
                if scalar:
                    q = q.reshape(1, -1)
                group.append((q, np.atleast_1d(qn), q.shape[0], scalar))
                rows += q.shape[0]
                if rows >= _STREAM_PASS_ROWS:
                    yield from flush(group)
                    group, rows = [], 0
            if group:
                yield from flush(group)

        return gen()

    def _similar(self, which, query_factor, query_norm, N, filter_ids, subset):
        """Shared core of similar_users / similar_items."""
        future, post = self._similar_async(query_factor, query_norm, N, filter_ids, subset,
                                           self._prep_similar_table(which, subset))
        return post(*future.result())

    def similar_users(self, userid, N=10, filter_users=None, users=None):
        if users is not None:
            if filter_users:
                raise ValueError("Can't set both users and filter_users in similar_users call")
            users = _validate_subset(users, self.user_factors.shape[0], "userids")
        return self._similar("user", self.user_factors[userid], self.user_norms[userid], N,
                             filter_users, users)

    similar_users.__doc__ = RecommenderBase.similar_users.__doc__

    def similar_users_pipelined(self, batches, N=10, filter_users=None, users=None,
                                max_in_flight=3):
        """Batched similar_users as a generator over userid batches: the
        user-side twin of :meth:`similar_items_pipelined`; results equal
        per-batch calls."""
        if type(self).similar_users is not MatrixFactorizationBase.similar_users:
            def fallback():
                for userid in batches:
                    yield self.similar_users(userid, N=N, filter_users=filter_users,
                                             users=users)

            return fallback()

        # arguments checked and the table resolved now (see recommend_pipelined)
        if users is not None:
            if filter_users:
                raise ValueError("Can't set both users and filter_users in similar_users call")
            users = _validate_subset(users, self.user_factors.shape[0], "userids")
        norms = self.user_norms
        prep = self._prep_similar_table("user", users)
        if isinstance(prep[0], _StreamTable):
            return self._similar_stream_once(batches, prep, N, filter_users, users,
                                             lambda b: (self.user_factors[b], norms[b]))

        def dispatches():
            for userid in batches:
                yield self._similar_async(self.user_factors[userid], norms[userid], N,
                                          filter_users, users, prep)

        return _pipeline(dispatches(), max_in_flight)

    def similar_items(
        self, itemid, N=10, recalculate_item=False, item_users=None, filter_items=None, items=None
    ):
        factor = self._item_factor(itemid, item_users, recalculate_item)

        if recalculate_item:
            # freshly solved factors aren't covered by the cached norms
            if np.isscalar(itemid):
                norm = np.linalg.norm(factor)
                norm = norm if norm != 0 else 1e-10
            else:
                norm = np.linalg.norm(factor, axis=1)
                norm[norm == 0] = 1e-10
        else:
            norm = self.item_norms[itemid]

        if items is not None:
            if filter_items:
                raise ValueError("Can't set both items and filter_items in similar_items call")
            items = _validate_subset(items, self.item_factors.shape[0], "itemids")

        return self._similar("item", factor, norm, N, filter_items, items)

    similar_items.__doc__ = RecommenderBase.similar_items.__doc__

    def similar_items_pipelined(self, batches, N=10, filter_items=None, items=None,
                                max_in_flight=3):
        """Batched similar_items as a generator over itemid batches: up to
        ``max_in_flight`` batches dispatched at once, each batch's ``(ids,
        scores)`` yielded in input order, equal to per-batch
        :meth:`similar_items` (see :meth:`recommend_pipelined`). The bulk
        export of similar items over a whole catalog is its intended use.
        ``recalculate_item`` is not supported here; use the synchronous
        call.
        """
        if type(self).similar_items is not MatrixFactorizationBase.similar_items:
            def fallback():
                for itemid in batches:
                    yield self.similar_items(itemid, N=N, filter_items=filter_items,
                                             items=items)

            return fallback()

        # arguments checked and the table resolved now (see recommend_pipelined)
        if items is not None:
            if filter_items:
                raise ValueError("Can't set both items and filter_items in similar_items call")
            items = _validate_subset(items, self.item_factors.shape[0], "itemids")
        norms = self.item_norms
        prep = self._prep_similar_table("item", items)
        if isinstance(prep[0], _StreamTable):
            return self._similar_stream_once(batches, prep, N, filter_items, items,
                                             lambda b: (self.item_factors[b], norms[b]))

        def dispatches():
            for itemid in batches:
                yield self._similar_async(self._item_factor(itemid, None), norms[itemid], N,
                                          filter_items, items, prep)

        return _pipeline(dispatches(), max_in_flight)

    # -- persistence -------------------------------------------------------------

    def save_params(self):
        """What :meth:`save` writes, as a dict (values that are None left out):
        the model class's ``SAVE_KEYS``, the npz layout both packages save."""
        args = {k: getattr(self, k, None) for k in self.SAVE_KEYS}
        args["dtype"] = self.dtype.name
        return {k: v for k, v in args.items() if v is not None}

    def save(self, fileobj_or_path):
        np.savez(fileobj_or_path, **self.save_params())

    def to_gpu(self):
        """API parity with the reference's CPU->GPU conversion: the identity."""
        return self

    def to_cpu(self):
        """API parity with the reference's GPU->CPU conversion: the identity."""
        return self
