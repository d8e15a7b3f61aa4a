"""EASE — a closed-form item-item model, on one card or a mesh.

The counterpart of ``implicit_tpu/ease.py``: the "Embarrassingly Shallow
Autoencoder" of Steck (WWW 2019),

    B = argmin ||X - X B||_F^2 + lam ||B||_F^2   s.t.  diag(B) = 0

whose exact solution is one (items x items) inverse:

    P = (X^T X + lam I)^{-1}
    B_{ij} = -P_{ij} / P_{jj}  (i != j),   diag(B) = 0

Training is the device KNN route's dense gramian
(:func:`~implicit_tpu_torch.nearest_neighbours._dense_gramian_device`), a
Cholesky factorization (``torch.linalg.cholesky_ex``) and the inverse from
it (``torch.cholesky_inverse``), cuSOLVER on CUDA, all in float32 on the
model's device; each (items x items) buffer is dropped once the next one
exists and B is formed in place of P. The weights are top-K sparsified per
row into the ``ItemItemRecommender`` similarity CSR, so EASE serves, saves,
loads and pickles through the same code as Cosine/TFIDF/BM25.

With ``mesh=`` the solve is the JAX package's sharded one
(:func:`_ease_B_meshed`): a row-sharded gramian, one factorization per
distinct device, each shard's block of identity columns solved against it,
and the weights left in row shards for the top-K.

Where ``X^T X + lam I`` is not positive definite (``lam = 0`` on a singular
gramian), the fit raises :class:`~implicit_tpu_torch.recommender_base.ModelFitError`;
the JAX package's factorization returns NaN weights there instead.

A traced fit is one ``fit`` span (attrs ``family`` "ease", users, items,
nnz, K, regularization) over its steps, in order: the set-up steps
``prepare`` (the input check and the binarizing copy) and ``upload`` (the
CSR to the card); the model steps (attr ``stage`` "model step", with CUDA
events) ``gramian``, ``cholesky``, ``inverse`` (meshed: ``column solves``),
``weights`` and ``top-k`` (the selection on the card); the set-up step
``copy back`` (the selection to the host, and its CSR). Each logs
``"item-item fit <step> in <s> s"`` at debug level.
"""

import numpy as np
import torch

from . import tracing
from ._device import resolve_device
from .nearest_neighbours import (
    ItemItemRecommender,
    _dense_gramian_device,
    _dense_topk_to_coo,
    _dense_topk_to_coo_meshed,
    _model_step,
    _set_up_step,
)
from .parallel.mesh import check_mesh_arg, resolve_mesh
from .recommender_base import ModelFitError
from .utils import check_csr

# the solve holds about 3 (items x items) float32 buffers (gramian, factor,
# inverse); the JAX package's cap, kept so both packages accept the same
# catalogs (27k items: 2.9 GB each)
_EASE_MAX_ITEMS = 32_000


def _ease_max_items(n_shards=None):
    """The catalog cap, the JAX package's rule. The plain solve
    (``n_shards=None``) holds 3 (items²) buffers; a meshed device holds the
    gathered gramian and its factor plus 1/D-sized column and row blocks,
    about (2 + 3/D) items², so the cap scales by √(3 / (2 + 3/D)): higher
    for D >= 3, lower for a mesh of 1 or 2. On a virtual mesh this counts
    shards, not cards."""
    if n_shards is None:
        return _EASE_MAX_ITEMS
    return int(_EASE_MAX_ITEMS * np.sqrt(3.0 / (2.0 + 3.0 / n_shards)))


def _resolve_ease_mesh(mesh, device="cuda"):
    """The ``mesh=`` argument resolved on ``device``
    (``parallel.mesh.resolve_mesh``), a mesh of one shard as None: one
    device gains nothing from the sharded solve and would pay its larger
    footprint, so it runs the plain solve (and keeps the plain cap)."""
    mesh = resolve_mesh(mesh, device)
    if mesh is not None and mesh.size <= 1:
        return None
    return mesh


def _check_ease_cap(items, mesh=None):
    """Refuses catalogs whose dense solve the cap rules out (the plain and
    meshed entry points share it)."""
    cap = _ease_max_items(mesh.size if mesh is not None else None)
    if items > cap:
        where = "the mesh devices'" if mesh is not None else "one chip's"
        raise ValueError(
            f"EASE inverts a dense {items}^2 matrix on device; catalogs over "
            f"{cap} items don't fit {where} memory. Restrict the "
            "catalog (items with interactions) or use the KNN/ALS families."
        )


def ease_weights(user_items, regularization=250.0, mesh=None, device="cuda"):
    """Returns the dense EASE weight matrix ``B`` as a float32 tensor on
    ``device`` (on the mesh's first device with ``mesh``).

    ``B[j, v]`` is liked-item ``j``'s contribution to candidate ``v``'s
    score; rows of ``B`` are the item-item "similarity" in the serving
    formulation ``scores = user_likes @ B``. ``diag(B)`` is zero (the EASE
    constraint). ``mesh`` (a ``parallel.Mesh``, or an int n:
    ``parallel.create_mesh(n, device)``) runs the gramian build and the
    column solves sharded over it (:func:`_ease_B_meshed`); a mesh of one
    shard runs the plain solve. Raises ``ModelFitError`` where ``X^T X +
    regularization I`` is not positive definite. Its steps log at debug
    level (``"item-item fit cholesky in ... s"``).
    """
    check_mesh_arg(mesh)
    user_items = check_csr(user_items)
    items = user_items.shape[1]
    mesh = _resolve_ease_mesh(mesh, device)
    _check_ease_cap(items, mesh)
    if mesh is not None:
        first = mesh.devices[0]
        return torch.cat([b.to(first) for b in _ease_B_meshed(
            user_items, regularization, mesh)])[:items]
    device = resolve_device(device)

    # the gramian's one reference moves into the solve, which drops it
    return _ease_solve(_dense_gramian_device(user_items, device), regularization)


def _factor(A, regularization):
    """The Cholesky factor of ``A + regularization I`` (adding to ``A`` in
    place); raises ``ModelFitError`` where it is not positive definite."""
    A.diagonal().add_(regularization)
    L, info = torch.linalg.cholesky_ex(A)
    info = int(info)
    if info:
        raise ModelFitError(
            f"EASE: X^T X + {regularization} I is not positive definite (its "
            f"leading minor of order {info} is not); use regularization > 0")
    return L


def _ease_B_meshed(user_items, regularization, mesh, serve_diag=False):
    """The EASE weights solved over ``mesh``, as row blocks: shard k's
    (block, items) rows of B on its device, ``block = ceil(items / D)``
    (rows past ``items`` are padding).

    The JAX package's sharded solve: the gramian arrives row-sharded
    (:func:`~implicit_tpu_torch.nearest_neighbours._dense_gramian_meshed`);
    each distinct device gathers it whole in shard order and factors ``S +
    lam I`` once, for all the shards it holds (the step "cholesky", the
    gather included); each shard solves its block of identity columns
    against the factor, its columns of P (``torch.cholesky_solve``, the
    step "column solves"); diag(P) is gathered in shard order, and by P's
    symmetry a shard's columns of P, divided in place, are its rows of B,
    ``B_k = -P_colsᵀ / diag`` (the step "weights"), their diagonal entries
    zeroed, or with ``serve_diag`` set to the serving self-affinity (above
    the row's largest weight). Each buffer is dropped once the next exists.
    """
    from .nearest_neighbours import _dense_gramian_meshed

    items = user_items.shape[1]
    devices = mesh.distinct()
    S, block = _dense_gramian_meshed(user_items, mesh)
    own = [torch.arange(k * block, (k + 1) * block, device=d) for k, d in enumerate(mesh.devices)]
    with _model_step("cholesky", devices):
        gathered = {d: torch.cat([s.to(d) for s in S])[:items] for d in devices}
        del S
        L = {d: _factor(gathered.pop(d), regularization) for d in devices}
    with _model_step("column solves", devices):
        P = []
        for j, d in zip(own, mesh.devices):
            eye = (torch.arange(items, device=d)[:, None] == j[None, :]).to(torch.float32)
            P.append(torch.cholesky_solve(eye, L[d]))  # (items, block): P[:, j]
            del eye
        del L
    with _model_step("weights", devices):
        cols = [j.clamp(max=items - 1) for j in own]  # padding rows read the last column
        diag = [torch.where(j < items, Pk[c, torch.arange(block, device=j.device)], 1.0)
                for j, c, Pk in zip(own, cols, P)]
        diag = {d: torch.cat([x.to(d) for x in diag])[:items] for d in devices}
        B = []
        for c, Pk, d in zip(cols, P, mesh.devices):
            Bk = Pk.div_(diag[d][:, None]).neg_().T  # (block, items), in P's memory
            r = torch.arange(block, device=d)
            Bk[r, c] = 0.0
            if serve_diag:
                Bk[r, c] = torch.clamp(Bk.max(dim=1).values, min=0.0) + 1.0
            B.append(Bk)
        del P
    return B


def _ease_solve(S, regularization):
    """The EASE weights from the float32 gramian ``S``, which the solve
    overwrites: ``S + regularization I`` is factored, inverted, and B formed
    in place of the inverse. Pass the only reference to ``S``, so that each
    (items x items) buffer is freed once the next exists."""
    device = S.device
    with _model_step("cholesky", device):
        L = _factor(S, regularization)
        del S
    with _model_step("inverse", device):
        P = torch.cholesky_inverse(L)
        del L
    with _model_step("weights", device):
        B = P.div_(P.diagonal().clone()).neg_()  # -P_ij / P_jj, in place
        B.diagonal().zero_()
    return B


class EASERecommender(ItemItemRecommender):
    """Item-item recommender with exact closed-form EASE weights.

    Parameters
    ----------
    K : int, optional
        Neighbours stored per item after top-K sparsifying the learned
        dense weights (EASE-topK; serving costs what the KNN models' does).
    regularization : float, optional
        The L2 term ``lam``. Larger values shrink the weights toward
        pure popularity; the EASE paper uses 100-1000 on binarized data.
    binarize : bool, optional
        Treat any interaction as 1.0 (the paper's setting, default). Set
        False to use the matrix values (e.g. bm25-weighted) as-is.
    num_threads : int, optional
        API parity; ignored.
    mesh : parallel.Mesh or int, optional
        Fit over a mesh: the gramian build and the column solves shard over
        it (:func:`_ease_B_meshed`), and each shard selects its own rows'
        top-K; a mesh of one shard runs the plain solve. An int n is
        ``parallel.create_mesh(n, device)``, resolved when the fit runs.
        Serving stays on ``device``.
    device : str or torch.device, optional
        Where the solve and ``recommend``'s scoring run (default ``"cuda"``).
    """

    def __init__(
        self, K=100, regularization=250.0, binarize=True, num_threads=0, mesh=None,
        device="cuda",
    ):
        super().__init__(K=K, num_threads=num_threads, mesh=mesh, device=device)
        self.regularization = regularization
        self.binarize = binarize

    def fit(self, user_items, show_progress=True, callback=None):
        """Solves the EASE weights and stores the K-sparsified similarity."""
        if callback:
            raise NotImplementedError("callback isn't supported on EASERecommender.fit")

        with tracing.span("fit", family="ease", K=self.K,
                          regularization=self.regularization) as fit_span:
            with _set_up_step("prepare", self.device):
                user_items = check_csr(user_items)
                if self.binarize:
                    user_items = user_items.copy()
                    user_items.data = np.ones_like(user_items.data)
            users, items = user_items.shape
            fit_span.set(users=users, items=items, nnz=user_items.nnz)

            mesh = _resolve_ease_mesh(self._fit_mesh(), self.device)
            if mesh is not None:
                _check_ease_cap(items, mesh)
                # the diagonal (serve_diag) and the top-K run in the row shards;
                # negatives are meaningful in EASE: keep all the top-K selects
                B = _ease_B_meshed(user_items, self.regularization, mesh, serve_diag=True)
                self.similarity = _dense_topk_to_coo_meshed(
                    B, items, int(self.K), mesh, keep="nonzero", fmt="csr")
                return

            B = ease_weights(user_items, self.regularization, device=self.device)

            # serving parity with the KNN family: the stored similarity's
            # diagonal is the item's self-affinity (strictly above its row max,
            # so similar_items ranks the item itself first). It only affects
            # already-liked candidates, which recommend() filters by default.
            B.diagonal().copy_(torch.clamp(B.max(dim=1).values, min=0.0) + 1.0)

            # negatives are meaningful in EASE: keep everything the top-K selects
            self.similarity = _dense_topk_to_coo(B, int(self.K), keep="nonzero", fmt="csr")

    def _save_args(self):
        return {
            "K": self.K,
            "regularization": self.regularization,
            "binarize": self.binarize,
        }
