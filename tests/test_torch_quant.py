"""The port's int8 gather path (``gather_quant``) and ``weighted_matvec``
against the JAX package, on the CPU.

The same numpy inputs go through both packages. Where JAX reaches a Pallas
kernel it runs in the interpreter (``interpret=True``, or ``use_pallas=True``
on the solve entry points); the port's wrappers take their plain versions
for CPU tensors.

Tolerances (ROADMAP C1, C5):

- ``_quantize_table`` and ``dequantize_rows`` are the same float32 / bfloat16
  arithmetic in both packages: bitwise.
- A plain version with ``scales`` against the same plain version on the
  explicitly dequantized bfloat16 table: the same values summed in the same
  order, 1e-6.
- Against JAX's int8 kernels: both see the same bfloat16-rounded table, but
  the JAX kernels also round the CG vectors to bfloat16 inside their
  products (C5) where the port multiplies by float32 vectors; held to 5% of
  the largest magnitude, the JAX package's bf16-vs-f32 bar.
- float32 ``weighted_matvec`` and the composed CG on it: summation order
  only, rtol = atol = 1e-4.
- The composed routes dequantize at the scale dtype in both packages (C1):
  float32 compute is the same math as the unquantized float32 route, 1e-4.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import get_checkerboard
from test_torch_als import F, _buckets, _plays, _start
from test_torch_kernels import _case

from implicit_tpu.models.als import AlternatingLeastSquares as JaxALS
from implicit_tpu.ops import als as jals
from implicit_tpu.ops import pallas_ops
from implicit_tpu.sparse import BucketedCSR as JBucketedCSR
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.models.als import AlternatingLeastSquares as ALSModel
from implicit_tpu_torch.ops import als as tals
from implicit_tpu_torch.ops import cg_kernels
from implicit_tpu_torch.sparse import BucketedCSR as TBucketedCSR

torch.set_num_threads(2)

C5 = 0.05  # of the largest magnitude: bf16 CG vectors in the JAX kernels
F32_TOL = 1e-4


def _f32(a):
    """A torch or JAX array of any float dtype as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _within_c5(got, want):
    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= C5 * np.abs(want).max()


def _quant_inputs(C, L, F, seed, compute="bfloat16"):
    """A chunk's inputs with the table quantized by both packages: (numpy
    table, idx, dat, x0, yty), the port's (q, s) and JAX's (q, s)."""
    Y, idx, dat, x0, yty = _case(C, L, F, seed)
    tq = tals._quantize_table(torch.as_tensor(Y), compute)
    jq = jals._quantize_table(jnp.asarray(Y), compute)
    return (Y, idx, dat, x0, yty), tq, jq


def _weights_and_v(dat, F, seed):
    rng = np.random.default_rng(seed)
    w = np.where(dat != 0, np.abs(dat) - 1, 0).astype(np.float32)
    bv = np.maximum(dat, 0).astype(np.float32)
    v = rng.standard_normal((dat.shape[0], F), dtype=np.float32) * 0.1
    return w, bv, v


# -- the table: quantize and dequantize ------------------------------------------


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_quantize_table_matches_jax(compute):
    rng = np.random.default_rng(0)
    Y = (rng.standard_normal((200, 48)) * rng.random((200, 1)) * 3).astype(np.float32)
    Y[5] = 0.0  # all-zero row: zeros with a unit scale
    # y / scale on exact halves (scale 0.5): round half to even, as jnp.round
    Y[7, :6] = [63.5, 0.25, 0.75, -0.25, -1.25, 2.25]
    tq, ts = tals._quantize_table(torch.as_tensor(Y), compute)
    jq, js = jals._quantize_table(jnp.asarray(Y), compute)
    assert tq.dtype == torch.int8
    assert ts.dtype == (torch.bfloat16 if compute == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_f32(ts), _f32(js))
    assert not tq[5].any() and float(ts[5]) == 1.0
    assert tq[7, :6].tolist() == [127, 0, 2, 0, -2, 4]


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dequantize_rows_is_dequant_tile(scale_dtype):
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, size=(64, 40)).astype(np.int8)
    s = (rng.random(64) * 0.05 + 1e-4).astype(np.float32)
    tq, ts = torch.as_tensor(q), torch.as_tensor(s).to(scale_dtype)
    table = cg_kernels.dequantize_rows(tq, ts)
    assert table.dtype == torch.bfloat16
    jdt = jnp.bfloat16 if scale_dtype == torch.bfloat16 else jnp.float32
    want = jnp.asarray(q).astype(jnp.bfloat16) * jnp.asarray(s).astype(jdt).astype(
        jnp.bfloat16)[:, None]
    np.testing.assert_array_equal(_f32(table), _f32(want))
    # a gathered (C, L, F) block with (C, L) scales: the TPU kernels' own
    # _dequant_tile, fed float32 scales as the kernels are
    idx = rng.integers(0, 64, size=(5, 7))
    block = cg_kernels.dequantize_rows(tq[idx], ts[idx])
    tile = pallas_ops._dequant_tile(
        jnp.asarray(q[idx]), jnp.asarray(_f32(ts)[idx]), jnp.bfloat16)
    np.testing.assert_array_equal(_f32(block), _f32(tile))
    assert torch.equal(block, table[idx])


# -- plain versions with scales --------------------------------------------------


def _port_call(kind, Y, idx, dat, x0, yty, scales, seed=0):
    t = torch.as_tensor
    if kind == "weighted_matvec":
        w, bv, v = _weights_and_v(dat, Y.shape[1], seed)
        return cg_kernels.weighted_matvec(Y, t(idx), t(w), t(bv), t(v), 1.0, -1.0, scales=scales)
    fn = {"cg_full": cg_kernels.cg_solve_full, "gramian": cg_kernels.gramian_cg_solve}[kind]
    return fn(Y, t(idx), t(dat), t(x0), t(yty), cg_steps=3, scales=scales)


SHAPES = {"cg_full": (16, 64, 32), "gramian": (8, 600, 32), "weighted_matvec": (12, 576, 32)}


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_plain_with_scales_is_plain_on_dequantized_table(kind):
    (Y, idx, dat, x0, yty), (q, s), _ = _quant_inputs(*SHAPES[kind], seed=2)
    before = dict(cg_kernels.LAUNCHES)
    got = _port_call(kind, q, idx, dat, x0, yty, s)
    assert cg_kernels.LAUNCHES == before  # CPU tensors: the plain version
    want = _port_call(kind, cg_kernels.dequantize_rows(q, s), idx, dat, x0, yty, None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind,shape", [
    ("cg_full", (16, 64, 128)), ("cg_full", (8, 24, 64)), ("gramian", (16, 768, 128)),
    ("gramian", (20, 16, 8)), ("weighted_matvec", (16, 576, 32))])
def test_plain_with_scales_matches_interpreted_int8_kernels(kind, shape):
    (Y, idx, dat, x0, yty), (q, s), (jq, js) = _quant_inputs(*shape, seed=shape[1])
    got = _port_call(kind, q, idx, dat, x0, yty, s, seed=3)
    Yu, S = jnp.asarray(np.asarray(jq)[idx]), jnp.asarray(js)[jnp.asarray(idx)]
    if kind == "weighted_matvec":
        w, bv, v = (jnp.asarray(a) for a in _weights_and_v(dat, shape[2], 3))
        want = pallas_ops.weighted_matvec(Yu, w, bv, v, 1.0, -1.0, interpret=True, scales=S)
    else:
        fn = {"cg_full": pallas_ops.cg_solve_full, "gramian": pallas_ops.gramian_cg_solve}[kind]
        want = fn(Yu, jnp.asarray(dat), jnp.asarray(x0), jnp.asarray(yty), cg_steps=3,
                  interpret=True, scales=S)
    _within_c5(got, want)
    if kind != "weighted_matvec":
        assert not got[1].any()  # the all-padding row stayed at x0 = 0


# -- weighted_matvec -------------------------------------------------------------


@pytest.mark.parametrize("L", [40, 576])  # 576: a partial last L-tile in the TPU kernel
@pytest.mark.parametrize("alpha,beta", [(1.0, -1.0), (0.0, 1.0)])
def test_weighted_matvec_matches_pallas(alpha, beta, L):
    # the inputs of tests/test_pallas.py's partial-tile case, as a table + idx
    rng = np.random.default_rng(L)
    C, F, n_table = 16, 32, 100
    Y = rng.standard_normal((n_table, F)).astype(np.float32)
    idx = rng.integers(0, n_table, size=(C, L), dtype=np.int32)
    w = rng.standard_normal((C, L)).astype(np.float32)
    bv = rng.standard_normal((C, L)).astype(np.float32)
    v = rng.standard_normal((C, F)).astype(np.float32)
    w[:, -5:] = bv[:, -5:] = 0.0  # padding
    t = torch.as_tensor
    got = cg_kernels.weighted_matvec(t(Y), t(idx), t(w), t(bv), t(v), alpha, beta)
    want = pallas_ops.weighted_matvec(*(jnp.asarray(a) for a in (Y[idx], w, bv, v)),
                                      alpha, beta, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def _normal_start(rows, cols, seed):
    """Warm start and fixed factors of mixed sign, as after a first iteration.

    ``test_torch_als._start`` draws all-positive factors, whose nearly
    rank-one gramian leaves 3-step CG on poorly conditioned rows; there the
    JAX kernels' bfloat16 CG vectors (C5) alone move the int8 solve by more
    than 5% (see test_int8_solve_side_closer_to_float32_than_jax).
    """
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, F), dtype=np.float32) * 0.3,
            rng.standard_normal((cols, F), dtype=np.float32) * 0.3)


def _one_class(side="user", seed=0):
    """(JAX class, port class, X0, Y0) for the largest class of one side."""
    Cui = _plays(seed=seed)
    csr = Cui if side == "user" else Cui.T.tocsr()
    X0, Y0 = _normal_start(*csr.shape, seed=seed + 1)
    jb, tb = _buckets(csr)
    jcls = max(jb.classes, key=lambda c: c.indices.size)
    n, C, L = jcls.indices.shape
    tcls = next(c for c in tb.classes if (c.n_chunks, c.C, c.L) == (n, C, L))
    return jcls, tcls, X0, Y0


@pytest.mark.parametrize("table", ["f32", "int8"])
def test_cg_class_with_kernel_route_matches_jax(monkeypatch, table):
    jcls, tcls, X0, Y0 = _one_class()
    jY, tY = jnp.asarray(Y0), torch.as_tensor(Y0)
    jyty, tyty = jals.gramian(jY, 0.05), tals.gramian(tY, 0.05)
    jtab, ttab = jY, tY
    if table == "int8":
        jtab, ttab = jals._quantize_table(jY, "float32"), tals._quantize_table(tY, "float32")
    calls = []
    wm = cg_kernels.weighted_matvec

    def counted(*a, **k):
        calls.append(k.get("scales") is not None)
        return wm(*a, **k)

    monkeypatch.setattr(cg_kernels, "weighted_matvec", counted)
    got = tals._cg_class(torch.tensor(X0), ttab, tyty, tals._class_chunks(tcls), 3,
                         use_pallas=True)
    want = jals._cg_class(jnp.asarray(X0), jtab, jyty, jcls.rows, jcls.indices, jcls.data, 3,
                          use_pallas=True)
    # the sparse term of every pass went through weighted_matvec, with the
    # pair's scales for the int8 table
    assert calls == [table == "int8"] * (3 + 1) * tcls.n_chunks
    if table == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    else:
        _within_c5(got, want)


def test_composed_cg_dequantizes_at_the_scale_dtype():
    # C1: _cg_class(use_pallas=False) reads q * s in float32 for float32
    # scales, as the JAX package's composed route does, not the kernels' bf16
    jcls, tcls, X0, Y0 = _one_class(seed=2)
    jY, tY = jnp.asarray(Y0), torch.as_tensor(Y0)
    jyty, tyty = jals.gramian(jY, 0.05), tals.gramian(tY, 0.05)
    q, s = tals._quantize_table(tY, "float32")
    chunks = tals._class_chunks(tcls)
    got = tals._cg_class(torch.tensor(X0), (q, s), tyty, chunks, 3)
    same = tals._cg_class(torch.tensor(X0), q.float() * s[:, None], tyty, chunks, 3)
    assert torch.equal(got, same)
    want = jals._cg_class(jnp.asarray(X0), jals._quantize_table(jY, "float32"), jyty,
                          jcls.rows, jcls.indices, jcls.data, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


# -- the half-iteration and the fit ----------------------------------------------


def test_gather_quant_routes_the_int8_table_to_both_kernels(monkeypatch):
    Ciu = _plays().T.tocsr()
    _, tb = _buckets(Ciu)
    X0, Y0 = _start(*Ciu.shape)
    calls = {"cg_full": [], "gramian_cg": []}

    def count(name, fn):
        def wrapped(Y, *a, scales=None, **k):
            calls[name].append((Y.dtype, None if scales is None else scales.dtype))
            return fn(Y, *a, scales=scales, **k)
        return wrapped

    monkeypatch.setattr(cg_kernels, "cg_solve_full", count("cg_full", cg_kernels.cg_solve_full))
    monkeypatch.setattr(cg_kernels, "gramian_cg_solve",
                        count("gramian_cg", cg_kernels.gramian_cg_solve))
    tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.01, gather_quant=True)
    max_l = tals._full_cg_max_l("float32", Y0.shape[1])
    n_long = sum(c.n_chunks for c in tb.classes if c.L > max_l)
    # float32 compute: float32 scales (the kernels round them to bfloat16)
    assert calls["gramian_cg"] == [(torch.int8, torch.float32)] * n_long and n_long > 0
    n_short = sum(c.n_chunks for c in tb.classes) - n_long
    assert calls["cg_full"] == [(torch.int8, torch.float32)] * n_short and n_short > 0


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["user", "item"])
def test_solve_side_gather_quant_matches_jax(side, compute):
    Cui = _plays()
    csr = Cui if side == "user" else Cui.T.tocsr()
    X0, Y0 = _normal_start(*csr.shape, seed=1)
    jb, tb = _buckets(csr)
    want = np.asarray(jals.solve_side(jnp.asarray(X0), jnp.asarray(Y0), jb, 0.01,
                                      compute_dtype=compute, use_pallas=True, gather_quant=True))
    got = tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.01, compute_dtype=compute,
                          gather_quant=True).numpy()
    _within_c5(got, want)
    empty = np.where(np.diff(csr.indptr) == 0)[0]
    assert not got[empty].any()


@pytest.mark.parametrize("side", ["user", "item"])
def test_int8_solve_side_closer_to_float32_than_jax(side):
    # on test_torch_als's all-positive start the JAX int8 kernels land 3-6%
    # of scale from the float32 solve, mostly from their bfloat16 CG vectors
    # (C5); the port's int8 solve, on the same bfloat16 table, must be the
    # closer of the two
    Cui = _plays()
    csr = Cui if side == "user" else Cui.T.tocsr()
    X0, Y0 = _start(*csr.shape)
    jb, tb = _buckets(csr)
    f32 = np.asarray(jals.solve_side(jnp.asarray(X0), jnp.asarray(Y0), jb, 0.01,
                                     use_pallas=True))
    jax_q = np.asarray(jals.solve_side(jnp.asarray(X0), jnp.asarray(Y0), jb, 0.01,
                                       compute_dtype="bfloat16", use_pallas=True,
                                       gather_quant=True))
    port_q = tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.01,
                             compute_dtype="bfloat16", gather_quant=True).numpy()
    scale = np.abs(f32).max()
    err_port, err_jax = np.abs(port_q - f32).max(), np.abs(jax_q - f32).max()
    assert err_port <= err_jax and err_port < C5 * scale


@pytest.mark.parametrize("side", ["user", "item"])
def test_cholesky_gather_quant_matches_jax(side):
    # use_cg=False dequantizes at the scale dtype in both packages: float32
    # here, the same math as the unquantized float32 solve
    Cui = _plays(seed=4)
    csr = Cui if side == "user" else Cui.T.tocsr()
    X0, Y0 = _start(*csr.shape, seed=5)
    jb, tb = _buckets(csr)
    want = jals.solve_side(jnp.asarray(X0), jnp.asarray(Y0), jb, 0.1, use_cg=False,
                           use_pallas=False, gather_quant=True)
    got = tals.solve_side(torch.tensor(X0), torch.tensor(Y0), tb, 0.1, use_cg=False,
                          gather_quant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_int8_fit_loss_close_to_bf16_and_composed():
    # tests/test_als_solvers.py::test_int8_gather_quant_pallas_kernels_converge
    # on the port: gate on the converged loss of a four-iteration fit
    rng = np.random.RandomState(4)
    Cui = sp.random(300, 200, density=0.08, random_state=rng, format="csr")
    Cui.data = (Cui.data * 10 + 1).astype(np.float32)
    Ciu = Cui.T.tocsr()
    X0 = (rng.rand(300, 32) * 0.1).astype(np.float32)
    Y0 = (rng.rand(200, 32) * 0.1).astype(np.float32)
    ub, ib = TBucketedCSR(Cui).to_device("cpu"), TBucketedCSR(Ciu).to_device("cpu")

    def run(gather_quant):
        X, Y = tals.fit(torch.tensor(X0), torch.tensor(Y0), ub, ib, 0.01, 4,
                        compute_dtype="bfloat16", gather_quant=gather_quant)
        return tals.calculate_loss_bucketed(ub, X, Y, 0.01)

    def composed_side(X, Y, buckets):
        chunks = [c for cls in buckets.classes for c in tals._class_chunks(cls)]
        X = tals._cg_class(X, tals._quantize_table(Y, "bfloat16"), tals.gramian(Y, 0.01),
                           chunks, 3)
        if buckets.empty_rows is not None:
            X[buckets.empty_rows] = 0.0
        return X

    X, Y = torch.tensor(X0), torch.tensor(Y0)
    for _ in range(4):
        X = composed_side(X, Y, ub)
        Y = composed_side(Y, X, ib)
    l_qx = tals.calculate_loss_bucketed(ub, X, Y, 0.01)
    # the JAX package's composed-quant fit from the same start
    jub, jib = JBucketedCSR(Cui).to_device(), JBucketedCSR(Ciu).to_device()
    jX, jY = jnp.asarray(X0), jnp.asarray(Y0)
    for _ in range(4):
        jX = jals.solve_side(jX, jY, jub, 0.01, compute_dtype="bfloat16", use_pallas=False,
                             gather_quant=True)
        jY = jals.solve_side(jY, jX, jib, 0.01, compute_dtype="bfloat16", use_pallas=False,
                             gather_quant=True)
    l_qx_jax = jals.calculate_loss_bucketed(jub, jX, jY, 0.01)

    l_bf = run(False)
    l_q = run(True)
    assert l_q != l_bf  # the int8 table was used
    assert abs(l_q - l_bf) / abs(l_bf) < 0.02
    assert abs(l_qx - l_q) / abs(l_bf) < 0.01
    assert abs(l_qx_jax - l_q) / abs(l_bf) < 0.01


# -- the model: "auto" as in the JAX package, and gather_quant=True -------------


@pytest.mark.parametrize("factors", [32, 128, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_gather_quant_sides_match_jax(dtype, factors):
    assert tals.VMEM_PROMO_BYTES == jals.VMEM_PROMO_BYTES
    lim_rows = jals.VMEM_PROMO_BYTES // (factors * 2)
    counts = (10, lim_rows - 1, lim_rows, lim_rows + 1, 4 * lim_rows, 360_000, 160_000)
    for gq in ("auto", True, False):
        jm = JaxALS(factors=factors, dtype=dtype, gather_quant=gq)
        tm = AlternatingLeastSquares(factors=factors, dtype=dtype, gather_quant=gq,
                                     device="cpu")
        for n_users in counts:
            for n_items in counts:
                assert (tm._gather_quant_sides(n_users, n_items)
                        == jm._gather_quant_sides(n_users, n_items)), (gq, n_users, n_items)


def test_gather_quant_auto_at_the_lastfm_shape():
    # 360k users x 160k items in bf16: the user table is 184 MB, the item
    # table 82 MB at factors=256; at 128 both are under 100 MiB
    def sides(factors, dtype):
        model = AlternatingLeastSquares(factors=factors, dtype=dtype, gather_quant="auto",
                                        device="cpu")
        return model._gather_quant_sides(360_000, 160_000)

    assert sides(256, np.float16) == (False, True)
    assert sides(128, np.float16) == (False, False)
    assert sides(256, np.float32) == (False, False)


def test_gather_quant_model_fits_recommends_and_round_trips():
    likes = get_checkerboard(50)
    model = AlternatingLeastSquares(factors=16, iterations=5, random_state=3,
                                    gather_quant=True, device="cpu")
    model.fit(likes, show_progress=False)
    ids, _ = model.recommend(0, likes[0], N=5)
    base = AlternatingLeastSquares(factors=16, iterations=5, random_state=3, device="cpu")
    base.fit(likes, show_progress=False)
    base_ids, _ = base.recommend(0, likes[0], N=5)
    # the same checkerboard structure recovered through the quantized gathers
    assert set(ids) & set(base_ids)
    assert not np.array_equal(model.item_factors, base.item_factors)
    buf = io.BytesIO()
    model.save(buf)
    buf.seek(0)
    back = ALSModel.load(buf, device="cpu")
    np.testing.assert_array_equal(back.user_factors, model.user_factors)
    np.testing.assert_array_equal(back.item_factors, model.item_factors)
    users = np.arange(10)
    np.testing.assert_array_equal(back.recommend(users, likes[users], N=5)[0],
                                  model.recommend(users, likes[users], N=5)[0])


# -- what the wrappers refuse ----------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kind", ["cg_full", "gramian", "weighted_matvec"])
def test_wrappers_take_int8_only_with_row_scales(kind):
    # meta tensors pass every check of the argument types and shapes and then
    # raise for not being CUDA tensors: the order lets the CPU test the rules
    N, C, L, F = 30, 8, 16, 24
    idx = _meta((C, L), torch.int32)
    if kind == "weighted_matvec":
        def call(Y, scales):
            return cg_kernels.weighted_matvec(
                Y, idx, _meta((C, L), torch.float32), _meta((C, L), torch.float32),
                _meta((C, F), torch.float32), 1.0, -1.0, scales=scales)
    else:
        fn = {"cg_full": cg_kernels.cg_solve_full, "gramian": cg_kernels.gramian_cg_solve}[kind]

        def call(Y, scales):
            return fn(Y, idx, _meta((C, L), torch.float32), _meta((C, F), torch.float32),
                      _meta((F, F), torch.float32), scales=scales)

    q = _meta((N, F), torch.int8)
    for scale_dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(q, _meta((N,), scale_dtype))
    with pytest.raises(TypeError, match="int8 with scales"):
        call(q, None)
    with pytest.raises(TypeError, match="must be int8"):
        call(_meta((N, F), torch.bfloat16), _meta((N,), torch.float32))
    with pytest.raises(TypeError, match="scales must be"):
        call(q, _meta((N,), torch.float16))
    with pytest.raises(ValueError, match="scales is"):
        call(q, _meta((N, 1), torch.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(_meta((N, F), torch.bfloat16), None)
