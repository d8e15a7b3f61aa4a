"""Wrappers of the CUDA solve kernels, with their plain PyTorch versions.

Four kernels carry the ALS solves (sources in ``csrc/``, notes at their
heads), for the three TPU kernels of ``implicit_tpu/ops/pallas_ops.py``:

- :func:`cg_solve_full` (``csrc/cg_full.cu``) replaces ``_cg_full_kernel``:
  the whole warm-started masked CG solve of each row, matrix-free.
- :func:`gramian_cg_solve` (``csrc/gramian_cg.cu``) replaces
  ``_gramian_cg_kernel``: explicit per-row normal matrix, then the same CG
  on it, for long rows.
- :func:`weighted_matvec` (``csrc/weighted_matvec.cu``) replaces
  ``_weighted_matvec_kernel``: one pass of the CG's sparse term.
- :func:`cg_update` (``csrc/cg_update.cu``): one pass's dense term (on
  the tensor cores, 3xTF32) and masked CG update. With
  :func:`weighted_matvec` it makes :func:`cg_solve_wide`, the solve of
  every class of a fit wider than
  :data:`MAX_FACTORS` (``ops/als.py:_cg_class``), where it replaces the CG
  arithmetic of ``_cg_full_kernel`` and ``_gramian_cg_kernel``.

The first three take the factor table and the chunk's indices, ``Y (N,
F)`` and ``idx (C, L) int32``, and gather ``Y[idx]`` inside the kernel. ``Y`` is
float32 or bfloat16, or int8 with ``scales (N,)``: one scale per row (the
``gather_quant`` table of ``ops/als.py:_quantize_table``), dequantized as
the TPU kernels' ``_dequant_tile`` does, to ``bf16(q * bf16(s))``
(:func:`dequantize_rows`). A wrapper runs its kernel for CUDA tensors and
raises on anything the kernel does not take; it uses the plain version only
for tensors on the CPU. ``LAUNCHES`` counts kernel launches per C entry
point (kernel and table type; ``cg_update`` reads no table and has one), so
a run can show that it went through the kernels.

``idx`` must index rows of ``Y`` (the bucketed CSR guarantees it); the
kernels do not bounds-check it.
"""

import contextlib

import numpy as np
import torch

from .. import tracing
from .._device import full_f32_matmul
from . import _build

KERNELS = ("cg_full", "gramian_cg", "weighted_matvec")
VARIANTS = ("f32", "bf16", "i8")
# the tracing counters launches.<entry>
LAUNCHES = tracing.register(
    "launches", {**{f"{k}_{v}": 0 for k in KERNELS for v in VARIANTS}, "cg_update": 0})

# widest factor vector cg_full and gramian_cg hold in registers (8 values
# per lane); weighted_matvec and cg_update take any width
MAX_FACTORS = 256

# the float32 operands of the kernels, by argument name, and their shapes
_SHAPES = {"dat": "CL", "w": "CL", "bv": "CL", "x0": "CF", "v": "CF", "YtY_reg": "FF"}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def dequantize_rows(q, s):
    """int8 rows ``q (..., F)`` times their scales ``s (...)``, as bfloat16.

    ``bf16(q * bf16(s))``: the TPU kernels' ``_dequant_tile``, and what the
    CUDA kernels' row loader computes.
    """
    return q.to(torch.bfloat16) * s.to(torch.bfloat16)[..., None]


def weighted_matvec_reference(Yu, w, bv, v, alpha, beta):
    """sum_l (alpha * bv + beta * w * (Yu . v)) * Yu over a gathered block.

    Plain PyTorch; f32 accumulation (f64 for an f64 block). The counterpart
    of ``implicit_tpu.ops.pallas_ops.weighted_matvec_reference``.
    """
    acc = torch.float64 if Yu.dtype == torch.float64 else torch.float32
    Yf = Yu.to(acc)
    with full_f32_matmul():
        t = torch.einsum("clf,cf->cl", Yf, v.to(acc))
        coeff = alpha * bv.to(acc) + beta * (w.to(acc) * t)
        return torch.einsum("cl,clf->cf", coeff, Yf)


def _gather(Y, idx, scales=None):
    """The block ``Y[idx] (C, L, F)`` in its accumulation dtype: float64 for
    a float64 table, else float32; an int8 table is dequantized first."""
    idx = idx.long()
    if scales is not None:
        return dequantize_rows(Y[idx], scales[idx]).float()
    return Y[idx].to(torch.float64 if Y.dtype == torch.float64 else torch.float32)


def weighted_matvec_plain(Y, idx, w, bv, v, alpha, beta, scales=None):
    """Plain PyTorch version of :func:`weighted_matvec` (same arguments)."""
    return weighted_matvec_reference(_gather(Y, idx, scales), w, bv, v, alpha, beta)


def cg_solve_full_plain(Y, idx, dat, x0, YtY_reg, cg_steps=3, scales=None):
    """Plain PyTorch version of :func:`cg_solve_full` (same arguments)."""
    from .als import _composed_cg, _weights

    Yu = _gather(Y, idx, scales)
    w, bv = _weights(dat.to(Yu.dtype))
    return _composed_cg(
        x0.to(Yu.dtype), YtY_reg.to(Yu.dtype),
        lambda v, alpha, beta: weighted_matvec_reference(Yu, w, bv, v, alpha, beta), cg_steps)


def normal_equations(Y, idx, dat, YtY_reg, scales=None):
    """Each row's A = YtY_reg + sum_l w y y^T and b = sum_l bv y, plain PyTorch."""
    from .als import _weights

    Yu = _gather(Y, idx, scales)
    w, bv = _weights(dat.to(Yu.dtype))
    with full_f32_matmul():
        A = YtY_reg.to(Yu.dtype) + torch.einsum("clf,clg->cfg", Yu * w[..., None], Yu)
        return A, torch.einsum("cl,clf->cf", bv, Yu)


def _explicit_cg(A, b, x0, cg_steps):
    """The masked CG on explicit per-row normal matrices A (C, F, F)."""
    from .als import _masked_cg

    x0 = x0.to(A.dtype)
    with full_f32_matmul():
        r = b - torch.einsum("cfg,cg->cf", A, x0)
        return _masked_cg(x0, r, lambda v: torch.einsum("cfg,cg->cf", A, v), cg_steps)


def gramian_cg_solve_plain(Y, idx, dat, x0, YtY_reg, cg_steps=3, scales=None):
    """Plain PyTorch version of :func:`gramian_cg_solve` (same arguments)."""
    A, b = normal_equations(Y, idx, dat, YtY_reg, scales)
    return _explicit_cg(A, b, x0, cg_steps)


# A model of the CUDA gramian build's operand precision, for the tests only:
# the kernel runs A += (w y)^T y on tensor cores, whose operands are TF32 or
# bfloat16. It cannot run on the CPU, so these functions round the operands
# as it does (by masking float32 bits) and let a CPU test show how far each
# scheme's solve lands from the float32 one. The float32 table takes 3xTF32,
# bfloat16 and int8 tables "bf16x2"; "tf32" and "bf16" are the single-pass
# schemes the kernel does not use.
SPLIT_SCHEMES = ("3xtf32", "tf32", "bf16x2", "bf16")


def round_tf32(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``; returned as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_bf16(x):
    """float32 ``x`` rounded to bfloat16 (7 mantissa bits), to nearest with
    ties to even, as ``__float2bfloat16_rn``; returned as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) & -0x10000).view(torch.float32)


def _split_terms(a, y, scheme):
    """The (A operand, B operand) pairs whose products the scheme sums for
    a = w y and y (float32): hi + lo splits for "3xtf32" and "bf16x2", the
    lo * lo term dropped."""
    if scheme == "3xtf32":
        a_hi, y_hi = round_tf32(a), round_tf32(y)
        return [(round_tf32(a - a_hi), y_hi), (a_hi, round_tf32(y - y_hi)), (a_hi, y_hi)]
    if scheme == "tf32":
        return [(round_tf32(a), round_tf32(y))]
    y = round_bf16(y)  # exact for bfloat16 and dequantized int8 tables
    if scheme == "bf16x2":
        a_hi = round_bf16(a)
        return [(round_bf16(a - a_hi), y), (a_hi, y)]
    if scheme == "bf16":
        return [(round_bf16(a), y)]
    raise ValueError(f"scheme must be one of {SPLIT_SCHEMES}, got {scheme!r}")


def normal_equations_split(Y, idx, dat, YtY_reg, scheme, scales=None):
    """:func:`normal_equations` with A's products taken at the operand
    precision of ``scheme`` (float32 sums); b as in the kernel, in float32."""
    from .als import _weights

    Yu = _gather(Y, idx, scales).float()
    w, bv = _weights(dat.float())
    terms = _split_terms(Yu * w[..., None], Yu, scheme)
    with full_f32_matmul():
        A = YtY_reg.float() + sum(torch.einsum("clf,clg->cfg", p, q) for p, q in terms)
        return A, torch.einsum("cl,clf->cf", bv, Yu)


def gramian_cg_solve_split(Y, idx, dat, x0, YtY_reg, scheme, cg_steps=3, scales=None):
    """:func:`gramian_cg_solve_plain` on :func:`normal_equations_split`."""
    A, b = normal_equations_split(Y, idx, dat, YtY_reg, scheme, scales)
    return _explicit_cg(A, b, x0, cg_steps)


def freeze_case(C, L, F, seed, n_table=4096, seen=None):
    """Inputs of one chunk whose rows freeze at different CG steps, as numpy
    arrays ``(Y, idx, dat, x0, YtY_reg, steps)``: the check of the lockstep
    masking in ``cg_full`` (tests and ``chip_smoke.py``).

    YtY_reg is 0.5 I. Row kinds, by row number: general rows (random entries
    and padding tails; they never freeze); rows whose entries are all
    negative (b = 0) from x0 = 0, already at their solution; and rows of
    k = 1, 2, 3 negative entries from an x0 that is 1e-5 away from 0 inside
    the span of their k table rows, so that the CG converges in k steps and
    the squared residual falls below 1e-20 there. ``steps[c]`` is the step
    after which row c freezes (0: at the start; -1: never). Row 1 is all
    padding from x0 = 0, and the last 24 rows freeze by step 2, so that whole
    blocks of rows freeze before the last step. ``seen`` maps the float32
    table to the values the solve reads (bfloat16 rounding, int8
    dequantization), so that x0 lies in the span of those rows.
    """
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n_table, F), dtype=np.float32) * 0.1
    idx = rng.integers(0, n_table, size=(C, L), dtype=np.int32)
    dat = rng.random((C, L), dtype=np.float32) * 5 + 1
    x0 = rng.standard_normal((C, F), dtype=np.float32) * 0.01
    lengths = rng.integers(1, L + 1, size=C)
    kind = np.arange(C) % 5  # 0 general, 1 at its solution, 2-4: 1-3 entries
    kind[-24:] = 1 + np.arange(min(C, 24)) % 3
    steps = np.where(kind == 0, -1, kind - 1)
    rows = Y if seen is None else np.asarray(seen(Y), dtype=np.float32)
    for c in np.nonzero(kind)[0]:
        n = lengths[c] if kind[c] == 1 else kind[c] - 1
        dat[c] = 0.0
        dat[c, :n] = -(rng.random(n, dtype=np.float32) * 3 + 2)  # w = 1..4, bv = 0
        x0[c] = 0.0
        if kind[c] > 1:
            x0[c] = (rng.standard_normal(n).astype(np.float32) * 1e-5) @ rows[idx[c, :n]]
    general = kind == 0
    dat[general[:, None] & (np.arange(L)[None, :] >= lengths[:, None])] = 0.0
    dat[1], x0[1], steps[1] = 0.0, 0.0, 0
    idx[dat == 0] = 0
    yty = 0.5 * np.eye(F, dtype=np.float32)
    return Y, idx, dat, x0, yty, steps


def _check_args(Y, idx, scales, max_factors=MAX_FACTORS, **operands):
    """Raises on any argument the CUDA kernels do not take; returns (C, L, F).

    ``Y`` is float32 or bfloat16 with ``scales=None``, or int8 with float32
    or bfloat16 ``scales (N,)``; ``operands`` are the float32 arguments by
    name (shapes in ``_SHAPES``). Everything lies on one CUDA device,
    contiguous. ``max_factors`` is the kernel's widest F (None: any).
    """
    if scales is None:
        if Y.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"Y must be float32 or bfloat16 (or int8 with scales), got {Y.dtype}")
    else:
        if Y.dtype != torch.int8:
            raise TypeError(f"with scales, Y must be int8, got {Y.dtype}")
        if scales.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"scales must be float32 or bfloat16, got {scales.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be torch.int32, got {idx.dtype}")
    for name, t in operands.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    tensors = dict(Y=Y, idx=idx, **operands)
    if scales is not None:
        tensors["scales"] = scales
    dev = Y.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Y on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Y.dim() != 2 or idx.dim() != 2:
        raise ValueError("Y must be (N, F) and idx (C, L)")
    (C, L), F = idx.shape, Y.shape[1]
    wants = {"CL": (C, L), "CF": (C, F), "FF": (F, F)}
    for name, t in operands.items():
        want = wants[_SHAPES[name]]
        if t.shape != want:
            raise ValueError(f"shape mismatch: {name} is {tuple(t.shape)}, want {want} "
                             f"for Y {tuple(Y.shape)}, idx {tuple(idx.shape)}")
    if scales is not None and tuple(scales.shape) != (Y.shape[0],):
        raise ValueError(f"shape mismatch: scales is {tuple(scales.shape)}, want ({Y.shape[0]},)")
    if max_factors is not None and F > max_factors:
        raise NotImplementedError(
            f"the CUDA solve kernels cg_full and gramian_cg take factors <= {max_factors}, "
            f"got {F}; wider fits solve through the composed CG on weighted_matvec")
    if dev.type != "cuda":
        raise ValueError(f"the solve kernels run on CUDA tensors, got {dev}")
    return C, L, F


def _run(library, entry, device, args):
    """Calls the C entry point ``entry`` of ``library`` on ``device`` and its
    current stream: tensors pass as pointers, Python numbers as they are.
    Raises on a launch error, else counts the launch."""
    lib = _build.load(library)[library]
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # the C side launches on the current device; switching costs host time
    # that a short launch would wait for, so only where it must
    index = device.index
    switch = (contextlib.nullcontext() if index == torch.cuda.current_device()
              else torch.cuda.device(index))
    with switch:
        rc = getattr(lib, entry)(*ptrs, torch._C._cuda_getCurrentRawStream(index))
    _build.check(lib, rc, f"{entry} launch")
    LAUNCHES[entry] += 1


def _launch(kernel, Y, idx, scales, args):
    """Launches ``<kernel>_<variant>`` for the table ``Y`` (and its scales);
    ``args`` follow the table and idx in the C signature."""
    variant = "i8" if scales is not None else ("bf16" if Y.dtype == torch.bfloat16 else "f32")
    # the kernels read float32 scales; a bfloat16 scale converts exactly
    table = (Y,) if scales is None else (Y, scales.float())
    _run(kernel, f"{kernel}_{variant}", Y.device, (*table, idx, *args))


def cg_solve_full(Y, idx, dat, x0, YtY_reg, cg_steps=3, scales=None):
    """Warm-started masked CG solve of one chunk; returns (C, F) float32 x.

    CUDA tensors launch ``csrc/cg_full.cu``; CPU tensors take the plain
    version.
    """
    if Y.device.type == "cpu":
        return cg_solve_full_plain(Y, idx, dat, x0, YtY_reg, cg_steps, scales)
    C, L, F = _check_args(Y, idx, scales, dat=dat, x0=x0, YtY_reg=YtY_reg)
    out = torch.empty_like(x0)
    _launch("cg_full", Y, idx, scales, (dat, x0, YtY_reg, out, C, L, F, int(cg_steps)))
    return out


def gramian_cg_solve(Y, idx, dat, x0, YtY_reg, cg_steps=3, scales=None):
    """Long-row solve of one chunk: explicit A + masked CG; (C, F) float32.

    CUDA tensors launch ``csrc/gramian_cg.cu`` with float32 scratch allocated
    here: A (C, F, F) and b (C, F), and where the build splits each row over
    S > 1 L-slices, their partial sums (C, S, F, F) + (C, S, F). CPU tensors
    take the plain version.
    """
    if Y.device.type == "cpu":
        return gramian_cg_solve_plain(Y, idx, dat, x0, YtY_reg, cg_steps, scales)
    C, L, F = _check_args(Y, idx, scales, dat=dat, x0=x0, YtY_reg=YtY_reg)
    lib = _build.load("gramian_cg")["gramian_cg"]
    with torch.cuda.device(Y.device):  # the slice count depends on the device's SMs
        slices = lib.gramian_cg_slices(C, L, F)
    out = torch.empty_like(x0)
    A = torch.empty((C, F, F), dtype=torch.float32, device=Y.device)
    b = torch.empty((C, F), dtype=torch.float32, device=Y.device)
    part = (torch.empty(C * slices * (F * F + F), dtype=torch.float32, device=Y.device)
            if slices > 1 else None)
    _launch("gramian_cg", Y, idx, scales,
            (dat, x0, YtY_reg, A, b, part, out, C, L, F, int(cg_steps)))
    return out


# weighted_matvec's L-slice count per (device, table type, 16-byte aligned
# table, C, L, F): a fit's chunks repeat a few shapes, and the count costs a
# call into the library
_WMV_SLICES = {}


def weighted_matvec(Y, idx, w, bv, v, alpha, beta, scales=None):
    """sum_l (alpha * bv + beta * w * (y_l . v)) * y_l per row, y_l = Y[idx];
    returns (C, F) float32. Any F.

    CUDA tensors launch ``csrc/weighted_matvec.cu``, with a (C, S, F)
    float32 scratch of per-slice partial sums where the kernel cuts each row
    into S > 1 L-slices (few long rows); CPU tensors take the plain version.
    """
    if Y.device.type == "cpu":
        return weighted_matvec_plain(Y, idx, w, bv, v, alpha, beta, scales)
    C, L, F = _check_args(Y, idx, scales, max_factors=None, w=w, bv=bv, v=v)
    table = 2 if scales is not None else (1 if Y.dtype == torch.bfloat16 else 0)
    key = (Y.device, table, Y.data_ptr() % 16 == 0, C, L, F)
    slices = _WMV_SLICES.get(key)
    if slices is None:
        lib = _build.load("weighted_matvec")["weighted_matvec"]
        with torch.cuda.device(Y.device):  # the slice count depends on the device's SMs
            slices = _WMV_SLICES[key] = lib.weighted_matvec_slices(table, Y.data_ptr(), C, L, F)
    out = torch.empty_like(v)
    part = (torch.empty((C, slices, F), dtype=torch.float32, device=Y.device)
            if slices > 1 else None)
    _launch("weighted_matvec", Y, idx, scales,
            (w, bv, v, out, part, C, L, F, slices, float(alpha), float(beta)))
    return out


def _update_from(dense, s, v, x, r, p, rs, act, first):
    """:func:`cg_update`'s steps from its dense term ``dense`` = v YtY_reg."""
    from .als import _cg_step

    t = s - dense if first else s + dense
    if first:
        x.copy_(v)
        r.copy_(t)
        p.copy_(t)
        rs.copy_((t * t).sum(1))
        act.copy_(rs >= 1e-20)
        return
    for buf, new in zip((x, r, p, rs, act), _cg_step(x, r, p, rs, act.bool(), t)):
        buf.copy_(new)


def cg_update_plain(s, YtY_reg, v, x, r, p, rs, act, first):
    """Plain PyTorch version of :func:`cg_update` (same arguments, in place):
    the steps of ``ops/als.py:_masked_cg``."""
    with full_f32_matmul():
        _update_from(v @ YtY_reg, s, v, x, r, p, rs, act, first)


def cg_update_split(s, YtY_reg, v, x, r, p, rs, act, first, scheme="3xtf32"):
    """:func:`cg_update_plain` with the dense term v YtY_reg taken at the
    operand precision of ``scheme``, for the tests: a model of the CUDA
    kernel's precision on the CPU. "3xtf32" is the kernel's: hi hi + hi lo +
    lo hi of TF32-rounded halves of v and of YtY_reg without its diagonal,
    summed in float32, plus v times the diagonal in float32; "tf32" one pass
    of the whole product, hi hi alone."""
    if scheme not in ("3xtf32", "tf32"):
        raise ValueError(f"scheme must be 3xtf32 or tf32, got {scheme!r}")
    v, m = v.float(), YtY_reg.float()
    with full_f32_matmul():
        if scheme == "3xtf32":
            d = torch.diagonal(m)
            dense = sum(a @ b for a, b in _split_terms(v, m - torch.diag(d), scheme)) + v * d
        else:
            dense = sum(a @ b for a, b in _split_terms(v, m, scheme))
        _update_from(dense, s, v, x, r, p, rs, act, first)


def _check_update_args(YtY_reg, rs, act, **rows):
    """Raises on any argument ``cg_update`` does not take; returns (C, F)."""
    C, F = rows["v"].shape if rows["v"].dim() == 2 else (-1, -1)
    want = {"YtY_reg": (F, F), "rs": (C,), "act": (C,), **{k: (C, F) for k in rows}}
    tensors = dict(YtY_reg=YtY_reg, rs=rs, act=act, **rows)
    for name, t in tensors.items():
        dtype = torch.int32 if name == "act" else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"shape mismatch: {name} is {tuple(t.shape)}, want {want[name]}")
        if t.device != YtY_reg.device:
            raise ValueError(f"{name} is on {t.device}, YtY_reg on {YtY_reg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if YtY_reg.device.type != "cuda":
        raise ValueError(f"cg_update runs on CUDA tensors, got {YtY_reg.device}")
    return C, F


def _update_scratch(C, F):
    """float32 values of ``cg_update``'s scratch: YtY_reg's split halves,
    laid out for its ring, and its diagonal (``update_layout`` in
    ``csrc/cg_update.cu``, computed the same way), and past F = 512 the
    (C, F) product; never under C F, so that a build of the kernel that
    keeps its product there fits."""
    passes = -(-F // 256)  # of 2 np columns each
    np_ = next((n for n in (32, 64, 80, 128) if 2 * n * passes >= F), 128)
    kp = -(-F // 16) * 16  # k in chunks of 16
    split = 2 * passes * kp * 2 * np_ + passes * 2 * np_  # hi and lo halves, diagonal
    return max(C * F, split + (C * F if passes > 2 else 0))


def cg_update(s, YtY_reg, v, x, r, p, rs, act, first):
    """One CG pass's dense term and masked update over a chunk's rows, in
    place. ``s`` (C, F) is the pass's sparse term from :func:`weighted_matvec`.

    ``first``: the residual pass from ``v`` = x0: r = s - x0 YtY_reg, x =
    x0, p = r, rs = r . r, act = rs >= 1e-20. Else a masked CG step from
    ``v`` = p (the same tensor): Ap = s + p YtY_reg, then x, r, p, rs and act
    as ``ops/als.py:_masked_cg`` updates them. ``s`` is not written.
    float32 tensors but ``act`` (C,) int32; ``rs`` (C,).

    CUDA tensors launch ``csrc/cg_update.cu`` (YtY_reg split for the
    tensor cores, then the product and the update), with a float32 scratch
    of :func:`_update_scratch` values allocated here; CPU tensors take the
    plain version.
    """
    if s.device.type == "cpu":
        return cg_update_plain(s, YtY_reg, v, x, r, p, rs, act, first)
    C, F = _check_update_args(YtY_reg, rs, act, v=v, s=s, x=x, r=r, p=p)
    scratch = torch.empty(_update_scratch(C, F), dtype=torch.float32, device=s.device)
    _run("cg_update", "cg_update", s.device,
         (YtY_reg, v, s, scratch, x, r, p, rs, act, C, F, int(bool(first))))


def cg_solve_wide(Y, idx, dat, x0, YtY_reg, cg_steps=3, scales=None):
    """Warm-started masked CG solve of one chunk at any F; returns (C, F)
    float32 x, as :func:`cg_solve_full` (same arguments).

    Each pass is two kernels: :func:`weighted_matvec` for the sparse term
    and :func:`cg_update` for the dense term and the update, cg_steps + 1
    launches of each. CPU tensors take both plain versions, the arithmetic
    of :func:`cg_solve_full_plain`.
    """
    from .als import _weights

    w, bv = _weights(dat)
    if scales is not None:
        scales = scales.float()  # once, not in every pass
    C = x0.shape[0]
    x, r, p = (torch.empty_like(x0) for _ in range(3))
    rs = torch.empty(C, dtype=torch.float32, device=x0.device)
    act = torch.empty(C, dtype=torch.int32, device=x0.device)
    s = weighted_matvec(Y, idx, w, bv, x0, 1.0, -1.0, scales=scales)
    cg_update(s, YtY_reg, x0, x, r, p, rs, act, True)
    for _ in range(cg_steps):
        s = weighted_matvec(Y, idx, w, bv, p, 0.0, 1.0, scales=scales)
        cg_update(s, YtY_reg, p, x, r, p, rs, act, False)
    return x
