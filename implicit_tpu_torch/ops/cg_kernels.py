"""Wrappers of the CUDA solve kernels, with their plain PyTorch versions.

Two kernels carry the ALS fit (sources in ``csrc/``, notes at their heads):

- :func:`cg_solve_full` (``csrc/cg_full.cu``) replaces
  ``implicit_tpu/ops/pallas_ops.py:_cg_full_kernel``: the whole warm-started
  masked CG solve of each row, matrix-free.
- :func:`gramian_cg_solve` (``csrc/gramian_cg.cu``) replaces
  ``implicit_tpu/ops/pallas_ops.py:_gramian_cg_kernel``: explicit per-row
  normal matrix, then the same CG on it, for long rows.

Both take the factor table and the chunk's indices, ``(Y (N, F), idx (C, L)
int32, dat (C, L), x0 (C, F), YtY_reg (F, F), cg_steps)``, and gather
``Y[idx]`` inside the kernel. A wrapper runs its kernel for CUDA tensors and
raises on anything the kernel does not take; it uses the plain version only
for tensors on the CPU. ``LAUNCHES`` counts kernel launches, so a run can
show that it went through the kernels.

``idx`` must index rows of ``Y`` (the bucketed CSR guarantees it); the
kernels do not bounds-check it.
"""

import torch

from . import _build

LAUNCHES = {"cg_full": 0, "gramian_cg": 0}

# widest factor vector the kernels hold in registers (8 values per lane)
MAX_FACTORS = 256


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def weighted_matvec_reference(Yu, w, bv, v, alpha, beta):
    """sum_l (alpha * bv + beta * w * (Yu . v)) * Yu over a gathered block.

    Plain PyTorch; f32 accumulation (f64 for an f64 block). The counterpart
    of ``implicit_tpu.ops.pallas_ops.weighted_matvec_reference``.
    """
    acc = torch.float64 if Yu.dtype == torch.float64 else torch.float32
    Yf = Yu.to(acc)
    t = torch.einsum("clf,cf->cl", Yf, v.to(acc))
    coeff = alpha * bv.to(acc) + beta * (w.to(acc) * t)
    return torch.einsum("cl,clf->cf", coeff, Yf)


def _acc_dtype(Y):
    return torch.float64 if Y.dtype == torch.float64 else torch.float32


def cg_solve_full_plain(Y, idx, dat, x0, YtY_reg, cg_steps=3):
    """Plain PyTorch version of :func:`cg_solve_full` (same arguments)."""
    from .als import _masked_cg, _weights

    acc = _acc_dtype(Y)
    Yu = Y[idx.long()].to(acc)  # (C, L, F)
    w, bv = _weights(dat.to(acc))
    yty = YtY_reg.to(acc)
    x0 = x0.to(acc)
    r = weighted_matvec_reference(Yu, w, bv, x0, 1.0, -1.0) - x0 @ yty
    return _masked_cg(
        x0, r, lambda v: weighted_matvec_reference(Yu, w, bv, v, 0.0, 1.0) + v @ yty,
        cg_steps)


def normal_equations(Y, idx, dat, YtY_reg):
    """Each row's A = YtY_reg + sum_l w y y^T and b = sum_l bv y, plain PyTorch."""
    from .als import _weights

    acc = _acc_dtype(Y)
    Yu = Y[idx.long()].to(acc)  # (C, L, F)
    w, bv = _weights(dat.to(acc))
    A = YtY_reg.to(acc) + torch.einsum("clf,clg->cfg", Yu * w[..., None], Yu)
    return A, torch.einsum("cl,clf->cf", bv, Yu)


def gramian_cg_solve_plain(Y, idx, dat, x0, YtY_reg, cg_steps=3):
    """Plain PyTorch version of :func:`gramian_cg_solve` (same arguments)."""
    from .als import _masked_cg

    A, b = normal_equations(Y, idx, dat, YtY_reg)
    x0 = x0.to(A.dtype)
    r = b - torch.einsum("cfg,cg->cf", A, x0)
    return _masked_cg(x0, r, lambda v: torch.einsum("cfg,cg->cf", A, v), cg_steps)


def _check_args(Y, idx, dat, x0, YtY_reg):
    """Raises on any argument the CUDA kernels do not take."""
    dev = Y.device
    if dev.type != "cuda":
        raise ValueError(f"the solve kernels run on CUDA tensors, got {dev}")
    if Y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Y must be float32 or bfloat16, got {Y.dtype}")
    want = {"idx": (idx, torch.int32), "dat": (dat, torch.float32),
            "x0": (x0, torch.float32), "YtY_reg": (YtY_reg, torch.float32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in dict(Y=Y, **{k: v[0] for k, v in want.items()}).items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Y on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Y.dim() != 2 or idx.dim() != 2:
        raise ValueError("Y must be (N, F) and idx (C, L)")
    F = Y.shape[1]
    C, L = idx.shape
    if dat.shape != (C, L) or x0.shape != (C, F) or YtY_reg.shape != (F, F):
        raise ValueError(
            f"shape mismatch: Y {tuple(Y.shape)}, idx {tuple(idx.shape)}, dat "
            f"{tuple(dat.shape)}, x0 {tuple(x0.shape)}, YtY_reg {tuple(YtY_reg.shape)}")
    if F > MAX_FACTORS:
        raise NotImplementedError(
            f"the CUDA solve kernels take factors <= {MAX_FACTORS}, got {F}")
    return C, L, F


def _suffix(Y):
    return "bf16" if Y.dtype == torch.bfloat16 else "f32"


def cg_solve_full(Y, idx, dat, x0, YtY_reg, cg_steps=3):
    """Warm-started masked CG solve of one chunk; returns (C, F) float32 x.

    CUDA tensors launch ``csrc/cg_full.cu``; CPU tensors take the plain
    version.
    """
    if Y.device.type == "cpu":
        return cg_solve_full_plain(Y, idx, dat, x0, YtY_reg, cg_steps)
    C, L, F = _check_args(Y, idx, dat, x0, YtY_reg)
    lib = _build.load("cg_full")["cg_full"]
    out = torch.empty_like(x0)
    fn = getattr(lib, f"cg_full_{_suffix(Y)}")
    with torch.cuda.device(Y.device):  # the C side launches on the current device
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        rc = fn(Y.data_ptr(), idx.data_ptr(), dat.data_ptr(), x0.data_ptr(),
                YtY_reg.data_ptr(), out.data_ptr(), C, L, F, int(cg_steps), stream)
    _build.check(lib, rc, "cg_full launch")
    LAUNCHES["cg_full"] += 1
    return out


def gramian_cg_solve(Y, idx, dat, x0, YtY_reg, cg_steps=3):
    """Long-row solve of one chunk: explicit A + masked CG; (C, F) float32.

    CUDA tensors launch ``csrc/gramian_cg.cu`` (with a (C, F, F) + (C, F)
    float32 scratch allocated here); CPU tensors take the plain version.
    """
    if Y.device.type == "cpu":
        return gramian_cg_solve_plain(Y, idx, dat, x0, YtY_reg, cg_steps)
    C, L, F = _check_args(Y, idx, dat, x0, YtY_reg)
    lib = _build.load("gramian_cg")["gramian_cg"]
    out = torch.empty_like(x0)
    A = torch.empty((C, F, F), dtype=torch.float32, device=Y.device)
    b = torch.empty((C, F), dtype=torch.float32, device=Y.device)
    fn = getattr(lib, f"gramian_cg_{_suffix(Y)}")
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        rc = fn(Y.data_ptr(), idx.data_ptr(), dat.data_ptr(), x0.data_ptr(),
                YtY_reg.data_ptr(), A.data_ptr(), b.data_ptr(), out.data_ptr(),
                C, L, F, int(cg_steps), stream)
    _build.check(lib, rc, "gramian_cg launch")
    LAUNCHES["gramian_cg"] += 1
    return out
