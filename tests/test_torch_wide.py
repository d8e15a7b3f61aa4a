"""Fits wider than the register-resident kernels, against the JAX package.

Past ``cg_kernels.MAX_FACTORS`` (256) factors the port solves every class
in the composed CG on two kernels, ``weighted_matvec`` for each pass's
sparse term and ``cg_update`` for its dense term and the CG update
(``cg_kernels.cg_solve_wide``, through ``_cg_class(use_pallas=True)``);
the JAX package, run with ``use_pallas=True`` as its own kernel tests run
it, takes its interpreted ``cg_full`` kernel on short rows and
``gramian_cg`` (or its composed CG where ``gramian_tile_l`` finds no tile)
on long ones. Both solve the same normal equations with the same 3-step
masked CG from the same start.

Tolerances (ROADMAP C1, C5): float32 differs by summation order only, held
to the bars of ``tests/test_torch_als.py`` (rtol = atol = 1e-3 for one
half-iteration, 2e-3 of the factors' scale for a fit); bfloat16 and int8
to 5% of scale, since the JAX kernels round the CG vectors to bfloat16
inside their products. ``weighted_matvec`` alone: float32 1e-4, bfloat16
and int8 5% of scale (the same rounding of v in the JAX kernel).

Also here: the port pins full float32 per product (ROADMAP C8), so
importing it, fitting and serving leave the caller's precision setting as
it was.
"""

import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_als import _buckets, _plays

from implicit_tpu.ops import als as jals
from implicit_tpu.ops import pallas_ops
from implicit_tpu_torch.ops import als as tals
from implicit_tpu_torch.ops import cg_kernels

torch.set_num_threads(2)

WIDE = 320  # > MAX_FACTORS: every class takes the composed CG
C5 = 0.05


def _start(rows, cols, factors, seed):
    """Warm start and fixed factors of mixed sign, as after a first iteration."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, factors), dtype=np.float32) * 0.1,
            rng.standard_normal((cols, factors), dtype=np.float32) * 0.1)


def _within(got, want, frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


def _count_routes(monkeypatch):
    """Wraps the three kernel wrappers; returns {name: [table dtype per call]}."""
    calls = {"cg_full": [], "gramian_cg": [], "weighted_matvec": []}
    for name, attr in (("cg_full", "cg_solve_full"), ("gramian_cg", "gramian_cg_solve"),
                       ("weighted_matvec", "weighted_matvec")):
        fn = getattr(cg_kernels, attr)

        def wrapped(Y, *a, _fn=fn, _name=name, scales=None, **k):
            calls[_name].append(Y.dtype if scales is None else (Y.dtype, scales.dtype))
            return _fn(Y, *a, scales=scales, **k)

        monkeypatch.setattr(cg_kernels, attr, wrapped)
    calls["cg_update"] = []
    update = cg_kernels.cg_update

    def wrapped_update(*a):
        calls["cg_update"].append(a[-1])  # first: the residual pass
        return update(*a)

    monkeypatch.setattr(cg_kernels, "cg_update", wrapped_update)
    return calls


@pytest.mark.parametrize("gather_quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("factors", [256, WIDE])
def test_wide_fits_route_every_class_to_weighted_matvec(monkeypatch, factors, gather_quant):
    Ciu = _plays().T.tocsr()  # item rows on both sides of _full_cg_max_l
    _, tb = _buckets(Ciu)
    X0, Y0 = _start(*Ciu.shape, factors, seed=1)
    calls = _count_routes(monkeypatch)
    tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.01, gather_quant=gather_quant)
    table = (torch.int8, torch.float32) if gather_quant else torch.float32
    chunks = sum(c.n_chunks for c in tb.classes)
    if factors > cg_kernels.MAX_FACTORS:
        # every pass of every chunk's composed CG: the residual and 3 steps,
        # with the pair's scales for the int8 table, each pass's sparse term
        # then its dense term and update
        assert calls == {"cg_full": [], "gramian_cg": [],
                         "weighted_matvec": [table] * (3 + 1) * chunks,
                         "cg_update": [True, False, False, False] * chunks}
    else:  # unchanged: the two solve kernels by row length
        max_l = tals._full_cg_max_l("float32", factors)
        n_long = sum(c.n_chunks for c in tb.classes if c.L > max_l)
        assert calls == {"cg_full": [table] * (chunks - n_long),
                         "gramian_cg": [table] * n_long, "weighted_matvec": [],
                         "cg_update": []}
        assert 0 < n_long < chunks


def test_wide_route_is_the_plain_composed_cg_on_the_cpu():
    # on CPU tensors weighted_matvec is weighted_matvec_plain: the same
    # arithmetic as cg_solve_full_plain, pass for pass
    Ciu = _plays(seed=3).T.tocsr()
    _, tb = _buckets(Ciu)
    X0, Y0 = _start(*Ciu.shape, WIDE, seed=4)
    Y = torch.tensor(Y0)
    yty = tals.gramian(Y, 0.05)
    chunks = [c for cls in tb.classes for c in tals._class_chunks(cls)]
    got = tals._cg_class(torch.tensor(X0), Y, yty, chunks, 3, use_pallas=True)
    want = tals._cg_class(torch.tensor(X0), Y, yty, chunks, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("variant", ["f32", "bf16", "i8"])
def test_cg_solve_wide_is_the_plain_cg_on_the_cpu(variant):
    # rows freezing at different steps (cg_kernels.freeze_case): on CPU
    # tensors both kernels' plain versions give cg_solve_full_plain's bits
    Y, idx, dat, x0, yty, steps = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                   for a in cg_kernels.freeze_case(40, 24, WIDE, seed=9))
    scales = None
    if variant == "bf16":
        Y = Y.bfloat16()
    elif variant == "i8":
        Y, scales = tals._quantize_table(Y, "bfloat16")
    args = (Y, idx, dat, x0, yty)
    for cg_steps in range(4):
        got = cg_kernels.cg_solve_wide(*args, cg_steps, scales=scales)
        assert torch.equal(got, cg_kernels.cg_solve_full_plain(*args, cg_steps, scales=scales))
    assert torch.equal(got[steps == 0], x0[steps == 0])


def _solve_case(C, L, F, seed, n_table=300):
    """One chunk's solve inputs as numpy: table, idx, dat with padding tails
    and disliked entries, a mixed-sign warm start and YtY_reg."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n_table, F), dtype=np.float32) * 0.1
    idx = rng.integers(0, n_table, size=(C, L), dtype=np.int32)
    dat = rng.random((C, L), dtype=np.float32) * 5 + 1
    dat[rng.random((C, L)) < 0.2] *= -1
    dat[np.arange(L)[None, :] >= rng.integers(1, L + 1, size=C)[:, None]] = 0.0
    x0 = rng.standard_normal((C, F), dtype=np.float32) * 0.1
    Ys = rng.standard_normal((64, F), dtype=np.float32) * 0.1
    return Y, idx, dat, x0, Ys.T @ Ys + 0.05 * np.eye(F, dtype=np.float32)


@pytest.mark.parametrize("table", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("F", [WIDE, 512])
def test_cg_solve_wide_matches_pallas_cg_full(F, table):
    # the JAX package's interpreted cg_full kernel solves the same chunk
    Y, idx, dat, x0, yty = _solve_case(8, 64, F, seed=F)
    t = torch.as_tensor
    jidx = jnp.asarray(idx)
    jargs = (jnp.asarray(dat), jnp.asarray(x0), jnp.asarray(yty), 3)
    if table == "int8":
        tq, ts = tals._quantize_table(t(Y), "bfloat16")
        jq, js = jals._quantize_table(jnp.asarray(Y), "bfloat16")
        got = cg_kernels.cg_solve_wide(tq, t(idx), t(dat), t(x0), t(yty), 3, scales=ts)
        want = pallas_ops.cg_solve_full(jq[jidx], *jargs, interpret=True, scales=js[jidx])
    else:
        tY, jY = t(Y), jnp.asarray(Y)
        if table == "bf16":
            tY, jY = tY.bfloat16(), jY.astype(jnp.bfloat16)
        got = cg_kernels.cg_solve_wide(tY, t(idx), t(dat), t(x0), t(yty), 3)
        want = pallas_ops.cg_solve_full(jY[jidx], *jargs, interpret=True)
    if table == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    else:
        _within(got.numpy(), want, C5)


@pytest.mark.parametrize("side", ["user", "item"])
def test_wide_solve_side_matches_jax(side):
    Cui = _plays()
    csr = Cui if side == "user" else Cui.T.tocsr()
    X0, Y0 = _start(*csr.shape, WIDE, seed=5)
    jb, tb = _buckets(csr)
    got, want = {}, {}
    for dtype, quant in (("float32", False), ("bfloat16", False), ("bfloat16", True)):
        want[dtype, quant] = np.asarray(jals.solve_side(
            jnp.asarray(X0), jnp.asarray(Y0), jb, 0.01, compute_dtype=dtype, use_pallas=True,
            gather_quant=quant))
        got[dtype, quant] = tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.01,
                                            compute_dtype=dtype, gather_quant=quant).numpy()
    np.testing.assert_allclose(got["float32", False], want["float32", False], rtol=1e-3,
                               atol=1e-3)
    _within(got["bfloat16", False], want["bfloat16", False], C5)
    _within(got["bfloat16", True], want["bfloat16", True], C5)
    empty = np.where(np.diff(csr.indptr) == 0)[0]
    assert not got["float32", False][empty].any()


@pytest.mark.parametrize("dtype,quant", [("float32", False), ("bfloat16", False),
                                         ("bfloat16", True)], ids=["f32", "bf16", "int8"])
def test_wide_fit_matches_jax(dtype, quant):
    Cui = _plays(seed=2)
    Ciu = Cui.T.tocsr()
    X0, Y0 = _start(*Cui.shape, WIDE, seed=3)
    jub, tub = _buckets(Cui, "pow2")
    jib, tib = _buckets(Ciu, "pow2")
    jX, jY = jals.fit(jnp.asarray(X0), jnp.asarray(Y0), jub, jib, 0.05, 2,
                      compute_dtype=dtype, use_pallas=True, gather_quant=quant)
    tX, tY = tals.fit(torch.tensor(X0), torch.tensor(Y0), tub, tib, 0.05, 2,
                      compute_dtype=dtype, gather_quant=quant)
    frac = 2e-3 if dtype == "float32" else C5
    for got, want in ((tX.numpy(), np.asarray(jX)), (tY.numpy(), np.asarray(jY))):
        _within(got, want, frac)


@pytest.mark.parametrize("alpha,beta", [(1.0, -1.0), (0.0, 1.0)])
@pytest.mark.parametrize("table", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("F", [320, 512, 1000])
def test_weighted_matvec_plain_matches_pallas_wide(F, table, alpha, beta):
    # L = 600: no multiple of 32, and a partial last L-tile in the TPU kernel
    rng = np.random.default_rng(F)
    C, L, n_table = 8, 600, 300
    Y = rng.standard_normal((n_table, F), dtype=np.float32) * 0.1
    idx = rng.integers(0, n_table, size=(C, L), dtype=np.int32)
    dat = rng.random((C, L), dtype=np.float32) * 5 + 1
    dat[np.arange(L)[None, :] >= rng.integers(1, L + 1, size=C)[:, None]] = 0.0
    w = np.where(dat != 0, dat - 1, 0).astype(np.float32)
    bv = dat.copy()
    v = rng.standard_normal((C, F), dtype=np.float32)
    t = torch.as_tensor
    jidx = jnp.asarray(idx)
    if table == "int8":
        tq, ts = tals._quantize_table(t(Y), "bfloat16")
        jq, js = jals._quantize_table(jnp.asarray(Y), "bfloat16")
        got = cg_kernels.weighted_matvec(tq, t(idx), t(w), t(bv), t(v), alpha, beta, scales=ts)
        want = pallas_ops.weighted_matvec(jq[jidx], jnp.asarray(w), jnp.asarray(bv),
                                          jnp.asarray(v), alpha, beta, interpret=True,
                                          scales=js[jidx])
    else:
        tY, jY = t(Y), jnp.asarray(Y)
        if table == "bf16":
            tY, jY = tY.bfloat16(), jY.astype(jnp.bfloat16)
        got = cg_kernels.weighted_matvec(tY, t(idx), t(w), t(bv), t(v), alpha, beta)
        want = pallas_ops.weighted_matvec(jY[jidx], jnp.asarray(w), jnp.asarray(bv),
                                          jnp.asarray(v), alpha, beta, interpret=True)
    if table == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    else:
        _within(got.numpy(), want, C5)


def _run(code):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_import_sets_no_global_torch_flag():
    flags = """print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())"""
    got = _run(f"""
        import torch
        {flags}
        import implicit_tpu_torch
        {flags}
    """)
    assert got[:3] == got[3:] == ["False", "True", "highest"]


@pytest.mark.parametrize("factors", [16, WIDE])
def test_fit_and_recommend_keep_the_callers_precision(factors):
    got = _run(f"""
        import numpy as np, torch
        torch.set_float32_matmul_precision("high")
        from implicit_tpu_torch.als import AlternatingLeastSquares
        from implicit_tpu_torch.datasets.synthetic import generate_synthetic
        inside = set()
        for owner, name in ((torch.Tensor, "__matmul__"), (torch, "einsum")):
            def spy(*a, _fn=getattr(owner, name), **k):  # every product, in the port's pin
                inside.add(torch.get_float32_matmul_precision())
                return _fn(*a, **k)
            setattr(owner, name, spy)
        plays = generate_synthetic(200, 80, 2000, seed=1)
        model = AlternatingLeastSquares(factors={factors}, iterations=1, random_state=0,
                                        device="cpu")
        model.fit(plays, show_progress=False)
        print(torch.get_float32_matmul_precision())
        model.recommend(np.arange(5), plays[:5], N=3)
        print(torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
        print(*sorted(inside))
    """)
    # the caller's "high" before and after, full float32 inside the solves
    assert got == ["high", "high", "True", "highest"]
