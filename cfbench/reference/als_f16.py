"""Plain reference of the ALS family with 16-bit tables (``dtype`` float16):
the fit, and the comparisons that judge the program's answers against it.

The algorithm is ``reference/als.py``'s (``least_squares_cg`` on Hu, Koren
and Volinsky's objective, ``cg_steps`` masked CG steps per row from its
current factors). What 16-bit storage changes is written out here, each the
program's semantics:

- **Start.** numpy's float32 draw times 0.01 (``reference/als.py``'s
  ``initial_factors``), rounded to float16 to nearest even and widened to
  float32: the fit draws its starting tables in the storage dtype. So the
  start is exact, and ``start_gap`` is 0.
- **Each half-iteration**, X re-solved against the fixed Y, both float32:
  YtY + reg I from the float32 Y (the program's gramian); b and the sparse
  term gather bfloat16(Y), the program's gather table, against float32
  vectors with float32 accumulation; the masked CG of ``least_squares_cg``
  in float32; rows with no entries zero. The solved tables stay float32
  from one half-iteration to the next.
- **Final tables** rounded to float16, as the fit returns them, before
  ``last_*`` compares them.

Products run in float32 with TF32 off, or, for the control, with every
float32 operand rounded to TF32 first; the gathered bfloat16 values are
TF32 numbers, so that rounding leaves them as they are. Sparse terms are
gathered in blocks of ``ENTRY_BLOCK`` entries (a block of 512-wide rows is
1 GiB in float32), so memory stays a few GB at any size. It imports nothing
of the program.
"""

import torch

from cfbench.reference.als import (Products, SideCSR, float32_products, initial_factors,
                                   judge_fit)
# the checked fit keeps the states the 32-bit family's keeps
from cfbench.reference.als import fit_recorder  # noqa: F401

ENTRY_BLOCK = 1 << 19


def to_f16(t):
    """float32 values rounded to float16 and widened back."""
    return t.to(torch.float16).float()


def to_bf16(t):
    """float32 values rounded to bfloat16 and widened back."""
    return t.to(torch.bfloat16).float()


def _sparse_term(side, Yg, V, weights, prod):
    """sum_l weights_l (y_l . v_u) y_l for every row u, y_l the gather
    table's rows."""
    e = torch.empty_like(weights)
    for s in range(0, e.numel(), ENTRY_BLOCK):
        sl = slice(s, s + ENTRY_BLOCK)
        e[sl] = prod.rowdot(Yg[side.col[sl]], V[side.row[sl]])
    return prod.spmm(side.crow, side.col, weights * e, side.shape, Yg)


def half_iteration(side, X, Y, reg, cg_steps, prod):
    """X re-solved against the fixed float32 Y: the gramian from Y, the
    sparse terms from bfloat16(Y)."""
    F = X.shape[1]
    YtY = prod.mm(Y.T, Y) + reg * torch.eye(F, dtype=Y.dtype, device=Y.device)
    Yg = to_bf16(Y)
    w = side.conf.abs() - 1.0
    b = prod.spmm(side.crow, side.col, side.conf.clamp(min=0.0), side.shape, Yg)

    def apply_a(V):
        return prod.mm(V, YtY) + _sparse_term(side, Yg, V, w, prod)

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


class Fit:
    """The reference fit of ``params`` (factors, regularization, iterations,
    cg_steps, alpha) with 16-bit tables on the user x item CSR, on
    ``device``."""

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
        """numpy's draw times 0.01, rounded to float16 and widened."""
        X0, Y0 = initial_factors(random_state, *self.shape, self.factors)
        return tuple(to_f16(torch.as_tensor(t, device=self.device)) for t in (X0, Y0))

    def iteration(self, X, Y):
        """One iteration from float32 (X, Y): the user side, then the item side."""
        with float32_products():
            X = half_iteration(self.user_side, X, Y, self.reg, self.cg_steps, self.prod)
            Y = half_iteration(self.item_side, Y, X, self.reg, self.cg_steps, self.prod)
        return X, Y

    def run(self, random_state, keep=()):
        """The whole fit; returns the final float32 (X, Y), before the
        rounding to float16, and ``{k: (X_k, Y_k)}`` for each k in ``keep``."""
        X, Y = self.start(random_state)
        states = {}
        for k in range(1, self.iterations + 1):
            X, Y = self.iteration(X, Y)
            if k in keep:
                states[k] = (X, Y)
        return (X, Y), states


def fit_answers(user_items, params, random_state, device, precision):
    """The reference fit's answers in the program's place (the control):
    the start, the states after the first and the next-to-last iteration,
    and the final tables rounded to float16."""
    fit = Fit(user_items, params, device, precision)
    n = fit.iterations
    final, states = fit.run(random_state, keep={1, n - 1})
    return dict(start=fit.start(random_state), first=states[1], before_last=states[n - 1],
                final=tuple(to_f16(t) for t in final))


def judge_fit_answers(user_items, params, random_state, answers, device):
    """The fit's numbers, as ``reference/als.py`` names them. ``start_gap``:
    the largest difference between the program's starting tables and the
    float16-rounded start (exact). ``first_*``: the state after iteration 1
    against the reference's first iteration from that start. ``last_*``: the
    final tables against the reference's last iteration from the program's
    own state before it, rounded to float16 as the program's are."""
    ref = Fit(user_items, params, device)
    X0, Y0 = ref.start(random_state)
    numbers = dict(start_gap=max(
        float((torch.as_tensor(p, device=device).float() - r).abs().max())
        for p, r in zip(answers["start"], (X0, Y0))))
    X1, Y1 = ref.iteration(X0, Y0)
    for k, v in judge_fit(*answers["first"], X1, Y1).items():
        numbers["first_" + k] = v
    del X1, Y1
    before = (torch.as_tensor(t, device=device).float() for t in answers["before_last"])
    Xn, Yn = ref.iteration(*before)
    for k, v in judge_fit(*answers["final"], to_f16(Xn), to_f16(Yn)).items():
        numbers["last_" + k] = v
    return numbers
