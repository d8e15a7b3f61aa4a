"""Plain reference of the EASE family: the closed-form weights, their top K
as the model serves them, and the comparisons that judge the program's fit
against them.

EASE (Steck, "Embarrassingly Shallow Autoencoders for Sparse Data", WWW
2019, arXiv:1905.03375) solves min ||X - X B||_F^2 + lam ||B||_F^2 with
diag(B) = 0 in closed form, the listing of the paper's section 3:

    G = X^T X;  G[diag] += lam;  P = G^-1;  B = P / (-diag(P));  B[diag] = 0

that is B_ij = -P_ij / P_jj off the diagonal. Written here from that listing
and the inputs alone (the user x item CSR, the configuration's parameters);
it imports nothing of the program. X is binarized (every stored entry 1)
where the configuration says ``binarize``, the paper's setting. The
gramian is built in blocks of users, each densified from the CSR and
multiplied out in a plain product. No departure from the paper; one from
the program's route: the inverse is ``torch.linalg.inv`` (LU with partial
pivoting), not a Cholesky factorization and the inverse from it.

The model stores each item's top K of B's row with the item itself first:
its diagonal set to the row's largest weight (at least 0) plus 1, the K
largest values kept, zeros dropped. The products run in float32 with TF32
off; the control (``precision`` "tf32") rounds the products' operands to
TF32, and, since binary data leave the gramian exact even then, also
G + lam I before the inverse and P after it, the library call's input and
output.
"""

import numpy as np
import scipy.sparse
import torch

from cfbench.reference.als import Products, float32_products, to_tf32

# float32 elements of one densified block of users (1 GiB)
BLOCK_ELEMENTS = 1 << 28
# float32 elements of one block of rows of B in the comparisons
ROW_ELEMENTS = 1 << 26


def gramian(user_items, binarize, device, precision="float32"):
    """X^T X (float32, items x items) on ``device``, from blocks of users:
    each densified (stored entries added where the CSR repeats one) and
    multiplied out."""
    users, items = user_items.shape
    prod = Products(precision)
    indptr = np.asarray(user_items.indptr, dtype=np.int64)
    block = max(1, BLOCK_ELEMENTS // max(items, 1))
    G = torch.zeros((items, items), dtype=torch.float32, device=device)
    with float32_products():
        for start in range(0, users, block):
            stop = min(start + block, users)
            lo, hi = int(indptr[start]), int(indptr[stop])
            rows = np.repeat(np.arange(stop - start), np.diff(indptr[start:stop + 1]))
            cols = np.asarray(user_items.indices[lo:hi], dtype=np.int64)
            vals = (np.ones(hi - lo, np.float32) if binarize
                    else np.asarray(user_items.data[lo:hi], dtype=np.float32))
            D = torch.zeros((stop - start, items), dtype=torch.float32, device=device)
            D.index_put_((torch.as_tensor(rows, device=device),
                          torch.as_tensor(cols, device=device)),
                         torch.as_tensor(vals, device=device), accumulate=True)
            G += prod.mm(D.T, D)
            del D
    return G


def weights(user_items, params, device, precision="float32"):
    """The dense EASE weights B (float32, items x items) on ``device``."""
    rnd = to_tf32 if precision == "tf32" else (lambda t: t)
    G = gramian(user_items, bool(params.get("binarize", True)), device, precision)
    G.diagonal().add_(float(params["regularization"]))
    with float32_products():
        P = rnd(torch.linalg.inv(rnd(G)))
    del G
    B = P.div_(-P.diagonal().clone())  # column j over -P_jj
    B.diagonal().zero_()
    return B


def _blocks(n, width):
    step = max(1, ROW_ELEMENTS // max(width, 1))
    for start in range(0, n, step):
        yield start, min(start + step, n)


def served(B, start, stop):
    """Rows [start, stop) of B as the model serves them: each row's
    diagonal set to its largest weight, at least 0, plus 1."""
    rows = B[start:stop].clone()
    r = torch.arange(stop - start, device=B.device)
    rows[r, start + r] = torch.clamp(rows.max(dim=1).values, min=0.0) + 1.0
    return rows


def similarity(B, K):
    """The served top K of every row of B, zeros dropped, as the host CSR of
    float64 values the model stores."""
    items = B.shape[0]
    k = min(int(K), items)
    rows, cols, vals = [], [], []
    for start, stop in _blocks(items, items):
        v, c = torch.topk(served(B, start, stop), k, dim=1)
        v, c = v.cpu().numpy().astype(np.float64), c.cpu().numpy()
        r, j = np.nonzero(v)
        rows.append(r + start)
        cols.append(c[r, j])
        vals.append(v[r, j])
    return scipy.sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                           np.concatenate(cols))),
                                   shape=(items, items))


class FitRecorder:
    """What the checked fit keeps, through the configuration's
    ``state_hook`` (``ease.py:_ease_solve``, which returns the dense B with
    its diagonal zero, before the fit writes the serving diagonal into it):
    a clone of that B on the device."""

    def __init__(self):
        self.kept = None

    def wrap(self, fn, name):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.kept = out.detach().clone()
            return out
        return recorded

    def answers(self, model, random_state):
        """The dict ``judge_fit_answers`` reads: the kept weights and the
        model's stored similarity."""
        if self.kept is None:
            raise RuntimeError("the checked fit never called the state hook")
        return dict(weights=self.kept, similarity=model.similarity)


def fit_recorder(params):
    """The checked fit's recorder (``lib/generators.py`` says what it gives)."""
    return FitRecorder()


def fit_answers(user_items, params, random_state, device, precision):
    """The reference's weights and stored similarity in ``precision``, in
    the recorder's format: the control. EASE draws nothing, so
    ``random_state`` is unused."""
    B = weights(user_items, params, device, precision)
    return dict(weights=B, similarity=similarity(B, params["K"]))


def judge_fit_answers(user_items, params, random_state, answers, device):
    """The fit's numbers against the reference's weights B_ref (float32,
    computed once here), each gap over max |B_ref|:

    - ``weights_rel_fro``: ||B - B_ref||_F / ||B_ref||_F over the dense B;
    - ``weights_max_gap``: max |B - B_ref|;
    - ``value_gap``: the stored off-diagonal values against B_ref at their
      places;
    - ``rank_gap``: how far a row's smallest stored off-diagonal value lies
      below the K-1-th largest off-diagonal weight of B_ref's row (the K-th
      of the served row, whose own item comes first);
    - ``count_gap`` (exact): rows that store other than min(K, the served
      reference row's nonzeros) entries;
    - ``diag_gap`` (exact): rows whose own item is missing, or not stored
      above the row's largest reference weight;
    - ``bad_ids`` (exact): stored ids out of range, or repeated in a row.
    """
    K = int(params["K"])
    B_ref = weights(user_items, params, device)
    items = B_ref.shape[0]
    B = torch.as_tensor(answers["weights"], device=device)
    sim = answers["similarity"].tocsr()
    if tuple(B.shape) != (items, items) or sim.shape != (items, items):
        return dict(weights_rel_fro=float("inf"), weights_max_gap=float("inf"),
                    value_gap=float("inf"), rank_gap=float("inf"), count_gap=items,
                    diag_gap=items, bad_ids=items)
    k = min(K, items)
    diff2 = ref2 = gap = scale = 0.0
    top = torch.empty(items, dtype=torch.float64, device=device)  # largest off-diagonal
    kth = torch.full((items,), -float("inf"), dtype=torch.float64, device=device)
    want = torch.empty(items, dtype=torch.int64, device=device)
    for start, stop in _blocks(items, items):
        ref = B_ref[start:stop].double()
        d = B[start:stop].double() - ref
        diff2 += float((d * d).sum())
        ref2 += float((ref * ref).sum())
        gap = max(gap, float(d.abs().max()))
        scale = max(scale, float(ref.abs().max()))
        del d
        r = torch.arange(stop - start, device=device)
        ref[r, start + r] = -float("inf")
        top[start:stop] = ref.max(dim=1).values
        if k > 1:
            kth[start:stop] = torch.topk(ref, k - 1, dim=1).values[:, -1]
        want[start:stop] = torch.topk(served(B_ref, start, stop), k, dim=1).values.ne(0).sum(1)
        del ref
    if not (np.isfinite(diff2) and np.isfinite(gap)):
        diff2 = gap = float("inf")
    scale = max(scale, 1e-300)
    numbers = dict(weights_rel_fro=float(np.sqrt(diff2 / max(ref2, 1e-300))),
                   weights_max_gap=gap / scale)

    counts = torch.as_tensor(np.diff(sim.indptr), device=device)
    rows = torch.repeat_interleave(torch.arange(items, device=device), counts)
    cols = torch.as_tensor(sim.indices.astype(np.int64), device=device)
    vals = torch.as_tensor(sim.data, dtype=torch.float64, device=device)
    ok = (cols >= 0) & (cols < items)
    rows, cols, vals = rows[ok], cols[ok], vals[ok]
    keys = torch.sort(rows * items + cols)[0]
    numbers["bad_ids"] = int((~ok).sum()) + int((keys[1:] == keys[:-1]).sum())
    numbers["count_gap"] = int((torch.bincount(rows, minlength=items) != want).sum())
    own = rows == cols
    at = torch.full((items,), -float("inf"), dtype=torch.float64, device=device)
    at[rows[own]] = vals[own]
    numbers["diag_gap"] = int((~(at > top)).sum())
    r, c, v = rows[~own], cols[~own], vals[~own]
    if v.numel():
        numbers["value_gap"] = float((v - B_ref[r, c].double()).abs().max()) / scale
        low = torch.full((items,), float("inf"), dtype=torch.float64, device=device)
        low.scatter_reduce_(0, r, v, "amin")
        stored = torch.isfinite(low)
        numbers["rank_gap"] = float(torch.clamp(kth[stored] - low[stored], min=0).max()) / scale
    else:
        numbers["value_gap"] = numbers["rank_gap"] = 0.0
    if not (np.isfinite(numbers["value_gap"]) and np.isfinite(numbers["rank_gap"])):
        numbers["value_gap"] = numbers["rank_gap"] = float("inf")
    return numbers
