"""Plain reference of the ALS family: the fit and ``recommend``, and the
comparisons that judge the program's answers against them.

The fit is the reference algorithm of ``least_squares_cg`` (Hu, Koren and
Volinsky's implicit objective, Takacs et al.'s conjugate gradient): every
row warm-starts from its current factors and takes ``cg_steps`` CG steps on
A = YtY + reg I + Yu^T diag(|c| - 1) Yu against b = Yu^T c+, a row
whose squared residual falls under 1e-20 stops, and a row with no entries
is zero. It is written here from the inputs alone: the user x item CSR, the
seed of ``random_state`` and the configuration's parameters. The starting
factors are numpy's float32 draw times 0.01 (user table first), the
documented start of the fit. The products run in float32 with TF32 off,
or, for the control, with every operand rounded to TF32 first.

Sparse terms are gathered in blocks of entries and summed back with a CSR
product, so memory stays a few GB at any size.
"""

import contextlib

import numpy as np
import torch

from cfbench.lib.generators import _StateRecorder

ENTRY_BLOCK = 1 << 21


@contextlib.contextmanager
def float32_products():
    """float32 products in full float32 (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def to_tf32(t):
    """float32 values rounded to TF32 (10 explicit mantissa bits), to
    nearest even, as the tensor cores read their operands."""
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


class Products:
    """The reference's products in one precision: "float32" or "tf32"."""

    def __init__(self, precision):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.round = to_tf32 if precision == "tf32" else (lambda t: t)

    def mm(self, a, b):
        return self.round(a) @ self.round(b)

    def rowdot(self, a, b):
        return (self.round(a) * self.round(b)).sum(1)

    def spmm(self, crow, col, values, shape, Y):
        sp = torch.sparse_csr_tensor(crow, col, self.round(values), shape)
        return sp @ self.round(Y)


class SideCSR:
    """One side's rows on the device: CSR arrays and each entry's row."""

    def __init__(self, csr, device):
        self.shape = csr.shape
        self.crow = torch.as_tensor(csr.indptr.astype(np.int64), device=device)
        self.col = torch.as_tensor(csr.indices.astype(np.int64), device=device)
        self.conf = torch.as_tensor(csr.data.astype(np.float32), device=device)
        counts = torch.diff(self.crow)
        self.row = torch.repeat_interleave(
            torch.arange(self.shape[0], device=device), counts)
        self.empty = counts == 0


def _sparse_term(side, Y, V, weights, prod):
    """sum_l weights_l (y_l . v_u) y_l for every row u (V's rows)."""
    e = torch.empty_like(weights)
    for s in range(0, e.numel(), ENTRY_BLOCK):
        sl = slice(s, s + ENTRY_BLOCK)
        e[sl] = prod.rowdot(Y[side.col[sl]], V[side.row[sl]])
    return prod.spmm(side.crow, side.col, weights * e, side.shape, Y)


def half_iteration(side, X, Y, reg, cg_steps, prod):
    """X re-solved against the fixed Y: least_squares_cg's row solves."""
    F = X.shape[1]
    YtY = prod.mm(Y.T, Y) + reg * torch.eye(F, dtype=Y.dtype, device=Y.device)
    w = side.conf.abs() - 1.0
    b = prod.spmm(side.crow, side.col, side.conf.clamp(min=0.0), side.shape, Y)

    def apply_a(V):
        return prod.mm(V, YtY) + _sparse_term(side, Y, V, w, prod)

    x = X.clone()
    r = b - apply_a(x)
    p = r
    rs = (r * r).sum(1)
    active = rs >= 1e-20
    for _ in range(cg_steps):
        Ap = apply_a(p)
        pAp = (p * Ap).sum(1)
        alpha = torch.where(active, rs / torch.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rsnew = (r * r).sum(1)
        still = active & (rsnew >= 1e-20)
        p = torch.where(still[:, None], r + (rsnew / torch.where(active, rs, 1.0))[:, None] * p, p)
        rs = torch.where(still, rsnew, rs)
        active = still
    x[side.empty] = 0.0
    return x


def initial_factors(random_state, users, items, factors):
    """The fit's documented start: numpy's float32 uniform draw times 0.01,
    the user table first, from ``np.random.default_rng(random_state)``."""
    rng = np.random.default_rng(random_state)
    X = rng.random((users, factors), dtype=np.float32) * np.float32(0.01)
    Y = rng.random((items, factors), dtype=np.float32) * np.float32(0.01)
    return X, Y


class Fit:
    """The reference fit of ``params`` (factors, regularization, iterations,
    cg_steps, alpha) on the user x item CSR, on ``device``."""

    def __init__(self, user_items, params, device, precision="float32"):
        alpha = float(params.get("alpha", 1.0))
        Cui = user_items if alpha == 1.0 else alpha * user_items
        self.shape = Cui.shape
        self.factors = int(params["factors"])
        self.reg = float(params["regularization"])
        self.cg_steps = int(params["cg_steps"])
        self.iterations = int(params["iterations"])
        self.device = device
        self.user_side = SideCSR(Cui, device)
        self.item_side = SideCSR(Cui.T.tocsr(), device)
        self.prod = Products(precision)

    def start(self, random_state):
        X0, Y0 = initial_factors(random_state, *self.shape, self.factors)
        return torch.as_tensor(X0, device=self.device), torch.as_tensor(Y0, device=self.device)

    def iteration(self, X, Y):
        """One iteration from (X, Y): the user side, then the item side."""
        with float32_products():
            X = half_iteration(self.user_side, X, Y, self.reg, self.cg_steps, self.prod)
            Y = half_iteration(self.item_side, Y, X, self.reg, self.cg_steps, self.prod)
        return X, Y

    def run(self, random_state, keep=()):
        """The whole fit; returns the final (X, Y) and ``{k: (X_k, Y_k)}``,
        the state after iteration k for each k in ``keep``."""
        X, Y = self.start(random_state)
        states = {}
        for k in range(1, self.iterations + 1):
            X, Y = self.iteration(X, Y)
            if k in keep:
                states[k] = (X, Y)
        return (X, Y), states


class FitRecorder:
    """What the checked fit keeps, through the configuration's
    ``state_hook`` (``solve_side``, one half-iteration a call): the first
    call's table and fixed table (the start), and the outputs of calls 0, 1,
    2n-4 and 2n-3 (iterations 1 and n-1), each copied on the device."""

    def __init__(self, params):
        self.n = int(params["iterations"])
        if self.n < 2:
            raise ValueError("the fit check follows iterations 1 and n: it needs n >= 2")
        self.states = _StateRecorder({0, 1, 2 * self.n - 4, 2 * self.n - 3})
        self.wrap = self.states.wrap

    def answers(self, model, random_state):
        """The dict ``judge_fit_answers`` reads."""
        k, n = self.states.kept, self.n
        return dict(start=k["start"], first=(k[0], k[1]),
                    before_last=(k[2 * n - 4], k[2 * n - 3]),
                    final=(model.user_factors, model.item_factors), random_state=random_state)


def fit_recorder(params):
    """The checked fit's recorder (``lib/generators.py`` says what it gives)."""
    return FitRecorder(params)


def fit_answers(user_items, params, random_state, device, precision):
    """The reference fit's answers in the program's place (the control):
    the states after the first and the next-to-last iteration, and the
    final tables."""
    fit = Fit(user_items, params, device, precision)
    n = fit.iterations
    final, states = fit.run(random_state, keep={1, n - 1})
    return dict(start=fit.start(random_state), first=states[1], before_last=states[n - 1],
                final=final)


def judge_fit_answers(user_items, params, random_state, answers, device):
    """The fit's numbers. ``start_gap``: the largest difference between the
    program's starting tables and the documented start (exact). ``first_*``:
    the state after iteration 1 against the reference's first iteration
    from the start. ``last_*``: the final tables against the reference's
    last iteration from the program's own state before it (the iterations
    between repeat the same solves). A whole fit is not compared end to
    end: float32 rounding alone moves a 15-iteration fit's scores by about
    3e-3, within a factor 3 of what TF32 moves them, while one iteration
    from a shared state separates the two far more."""
    ref = Fit(user_items, params, device)
    X0, Y0 = ref.start(random_state)
    numbers = dict(start_gap=max(
        float((torch.as_tensor(p, device=device).float() - r).abs().max())
        for p, r in zip(answers["start"], (X0, Y0))))
    X1, Y1 = ref.iteration(X0, Y0)
    for k, v in judge_fit(*answers["first"], X1, Y1).items():
        numbers["first_" + k] = v
    del X1, Y1
    Xn, Yn = ref.iteration(*(t.float() for t in answers["before_last"]))
    for k, v in judge_fit(*answers["final"], Xn, Yn).items():
        numbers["last_" + k] = v
    return numbers


def judge_fit(X, Y, X_ref, Y_ref, block=4096):
    """How far the predictions X Y^T lie from the reference's X_ref Y_ref^T,
    over every user and item: the widest gap relative to the reference's
    largest |score| (``max_gap``), and the Frobenius norm of the difference
    relative to the reference's (``rel_fro``).

    Factors are compared through the scores they give: the objective barely
    moves under a joint change of basis of both tables, so two sound fits
    can drift apart in the factors while they agree on every score.
    """
    X, Y = (torch.as_tensor(t, device=X_ref.device).float() for t in (X, Y))
    gap, scale, diff2, ref2 = 0.0, 0.0, 0.0, 0.0
    with float32_products():
        for s in range(0, X.shape[0], block):
            S = X[s:s + block] @ Y.T
            R = X_ref[s:s + block] @ Y_ref.T
            D = S - R
            gap = max(gap, float(D.abs().max()))
            scale = max(scale, float(R.abs().max()))
            diff2 += float((D * D).sum(1, dtype=torch.float64).sum())
            ref2 += float((R * R).sum(1, dtype=torch.float64).sum())
    if not np.isfinite(gap) or not np.isfinite(diff2):
        return dict(max_gap=float("inf"), rel_fro=float("inf"))
    return dict(max_gap=gap / max(scale, 1e-30), rel_fro=float(np.sqrt(diff2 / max(ref2, 1e-300))))


def recommend(U, I, users, liked, N, precision="float32"):
    """Top-N items by U[users] . I with each user's liked items removed;
    returns (ids, scores, scale) tensors, ``scale`` each row's largest
    |score| before the filter. ``liked`` is the users' CSR rows (host)."""
    prod = Products(precision)
    with float32_products():
        S = prod.mm(U[users], I.T)
    scale = S.abs().amax(1)
    rows = np.repeat(np.arange(len(users)), np.diff(liked.indptr))
    S[torch.as_tensor(rows, device=S.device),
      torch.as_tensor(liked.indices.astype(np.int64), device=S.device)] = -float("inf")
    scores, ids = torch.topk(S, N, dim=1)
    return ids, scores, scale


def judge_recommend(U, I, users, liked, ids, scores, N):
    """How far the returned (ids, scores) of one request lie from the
    reference's top N: ``rank_gap``, the largest amount by which a returned
    item's reference score lies below the reference's score at that rank;
    ``score_gap``, the largest |returned score - reference score of that
    item|; both relative to the row's largest |score|. ``bad_ids`` counts
    ids that are out of range, liked (filtered) or repeated in a row."""
    ids = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=U.device)
    scores = torch.as_tensor(np.asarray(scores, dtype=np.float32), device=U.device)
    if ids.dim() == 1:
        ids, scores = ids[None], scores[None]
    n_items = I.shape[0]
    with float32_products():
        S = U[users] @ I.T
    scale = S.abs().amax(1).clamp(min=1e-30)
    liked_mask = torch.zeros_like(S, dtype=torch.bool)
    rows = np.repeat(np.arange(len(users)), np.diff(liked.indptr))
    liked_mask[torch.as_tensor(rows, device=S.device),
               torch.as_tensor(liked.indices.astype(np.int64), device=S.device)] = True
    valid = (ids >= 0) & (ids < n_items)
    safe = ids.clamp(0, n_items - 1)
    bad = ~valid | liked_mask.gather(1, safe)
    srt = safe.sort(1).values
    bad[:, 1:] |= srt[:, 1:] == srt[:, :-1]
    top = S.masked_fill(liked_mask, -float("inf")).topk(N, dim=1).values
    at = S.gather(1, safe)
    ok = ~bad
    rank_gap = torch.where(ok, (top - at) / scale[:, None], 0.0)
    score_gap = torch.where(ok, (scores - at).abs() / scale[:, None], 0.0)
    return dict(rank_gap=float(rank_gap.max()), score_gap=float(score_gap.max()),
                bad_ids=int(bad.sum()))
