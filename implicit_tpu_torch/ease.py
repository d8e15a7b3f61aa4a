"""EASE — a closed-form item-item model, on one card.

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

Where ``X^T X + lam I`` is not positive definite (``lam = 0`` on a singular
gramian), the fit raises :class:`~implicit_tpu_torch.recommender_base.ModelFitError`;
the JAX package's factorization returns NaN weights there instead.
"""

import numpy as np
import torch

from ._device import resolve_device, timed_step
from .nearest_neighbours import (
    _STAGE,
    ItemItemRecommender,
    _dense_gramian_device,
    _dense_topk_to_coo,
)
from .recommender_base import ModelFitError
from .utils import check_csr

# the solve holds about 3 (items x items) float32 buffers (gramian, factor,
# inverse); the JAX package's cap, kept so both packages accept the same
# catalogs (27k items: 2.9 GB each)
_EASE_MAX_ITEMS = 32_000


def _check_ease_cap(items):
    """Refuses catalogs whose dense solve the cap rules out."""
    if items > _EASE_MAX_ITEMS:
        raise ValueError(
            f"EASE inverts a dense {items}^2 matrix on device; catalogs over "
            f"{_EASE_MAX_ITEMS} items don't fit one chip's memory. Restrict the "
            "catalog (items with interactions) or use the KNN/ALS families."
        )


def ease_weights(user_items, regularization=250.0, mesh=None, device="cuda"):
    """Returns the dense EASE weight matrix ``B`` as a float32 tensor on
    ``device``.

    ``B[j, v]`` is liked-item ``j``'s contribution to candidate ``v``'s
    score; rows of ``B`` are the item-item "similarity" in the serving
    formulation ``scores = user_likes @ B``. ``diag(B)`` is zero (the EASE
    constraint). ``mesh`` is not ported and must be None. Raises
    ``ModelFitError`` where ``X^T X + regularization I`` is not positive
    definite. Its steps log at debug level (``"item-item fit cholesky in
    ... s"``).
    """
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device EASE solves) is not ported yet")
    user_items = check_csr(user_items)
    _check_ease_cap(user_items.shape[1])
    device = resolve_device(device)

    # the gramian's one reference moves into the solve, which drops it
    return _ease_solve(_dense_gramian_device(user_items, device), regularization)


def _ease_solve(S, regularization):
    """The EASE weights from the float32 gramian ``S``, which the solve
    overwrites: ``S + regularization I`` is factored, inverted, and B formed
    in place of the inverse. Pass the only reference to ``S``, so that each
    (items x items) buffer is freed once the next exists."""
    device = S.device
    with timed_step("cholesky", device, stage=_STAGE):
        S.diagonal().add_(regularization)
        L, info = torch.linalg.cholesky_ex(S)
        del S
        info = int(info)
    if info:
        raise ModelFitError(
            f"EASE: X^T X + {regularization} I is not positive definite (its "
            f"leading minor of order {info} is not); use regularization > 0")
    with timed_step("inverse", device, stage=_STAGE):
        P = torch.cholesky_inverse(L)
        del L
    with timed_step("weights", device, stage=_STAGE):
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
    mesh : None
        Multi-device solves are not ported; anything but None raises.
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

        user_items = check_csr(user_items)
        if self.binarize:
            user_items = user_items.copy()
            user_items.data = np.ones_like(user_items.data)

        B = ease_weights(user_items, self.regularization, device=self.device)

        # serving parity with the KNN family: the stored similarity's
        # diagonal is the item's self-affinity (strictly above its row max,
        # so similar_items ranks the item itself first). It only affects
        # already-liked candidates, which recommend() filters by default.
        B.diagonal().copy_(torch.clamp(B.max(dim=1).values, min=0.0) + 1.0)

        # negatives are meaningful in EASE: keep everything the top-K selects
        with timed_step("top-k", self.device, stage=_STAGE):
            self.similarity = _dense_topk_to_coo(B, int(self.K), keep="nonzero").tocsr()

    def _save_args(self):
        return {
            "K": self.K,
            "regularization": self.regularization,
            "binarize": self.binarize,
        }
