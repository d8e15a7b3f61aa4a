#!/usr/bin/env python3
"""Smoke test of implicit_tpu_torch on one CUDA card: build, check, drive.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

0. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
   no CUDA device is a failure;
1. build the CUDA solve kernels from ``implicit_tpu_torch/ops/csrc`` (nvcc);
2. each kernel against its plain PyTorch version on the card, in float32
   and bfloat16, at the fit's own class shapes, with times; the same bar
   must reject a plain version one CG step short;
3. the main path: ``AlternatingLeastSquares.fit`` at the last.fm-360k shape
   (360k users x 160k items, 17.5M nnz, factors=128) in float32 and
   bfloat16, then batched ``recommend`` and ``similar_items``; the kernels'
   launch counters must show every routed chunk;
4. quality: p@10 > 0.2 on the committed stdlib corpus.

The second-to-last lines are one JSON object of per-kernel results and the
card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "implicit_tpu", "datasets", "_data", "stdlib_corpus.npz")

# kernel vs plain: same inputs, same f32 accumulation, different summation
# order. rtol = atol: 1e-4 in float32; in bfloat16 2e-3, the bar of the JAX
# package's own kernel-vs-composed tests (tests/test_torch_cuda.py holds the
# same two)
TOL = {"f32": 1e-4, "bf16": 2e-3}

KERNELS = {
    "cg_full": dict(
        source="implicit_tpu_torch/ops/csrc/cg_full.cu",
        replaces="implicit_tpu/ops/pallas_ops.py:173",
        shape=(4096, 64, 128)),  # (C, L, F): a short-row class of the fit
    "gramian_cg": dict(
        source="implicit_tpu_torch/ops/csrc/gramian_cg.cu",
        replaces="implicit_tpu/ops/pallas_ops.py:292",
        shape=(256, 8192, 128)),  # a long-row (head item) class
}


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_case(C, L, F, dtype, seed, device):
    """One chunk's kernel inputs from a numpy seed, as the fit builds them."""
    import torch

    rng = np.random.default_rng(seed)
    n_table = 160_000
    Y = rng.standard_normal((n_table, F), dtype=np.float32) * 0.1
    idx = rng.integers(0, n_table, size=(C, L), dtype=np.int32)
    dat = rng.random((C, L), dtype=np.float32) * 5 + 1
    lengths = rng.integers(1, L + 1, size=C)
    lengths[0] = L
    dat[np.arange(L)[None, :] >= lengths[:, None]] = 0.0  # padding tails
    idx[dat == 0] = 0
    x0 = rng.standard_normal((C, F), dtype=np.float32) * 0.01
    dat[1] = 0.0  # an all-padding row from a zero start: x stays 0
    x0[1] = 0.0
    Ys = Y[:4096]
    yty = Ys.T @ Ys + 0.05 * np.eye(F, dtype=np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(Y).to(dtype), t(idx), t(dat), t(x0), t(yty)


def phase_kernels(device):
    import torch

    from implicit_tpu_torch.ops import cg_kernels

    wrappers = {"cg_full": (cg_kernels.cg_solve_full, cg_kernels.cg_solve_full_plain),
                "gramian_cg": (cg_kernels.gramian_cg_solve, cg_kernels.gramian_cg_solve_plain)}
    results = {}
    for name, spec in KERNELS.items():
        kernel, plain = wrappers[name]
        res = results[name] = {"max_abs_err": 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            C, L, F = spec["shape"]
            args = kernel_case(C, L, F, dtype, seed=C + L, device=device)
            tag = "f32" if dtype == torch.float32 else "bf16"
            tol = TOL[tag]
            got = kernel(*args, cg_steps=3)
            want = plain(*args, cg_steps=3)
            # a deliberately wrong reference (one CG step short): the bar
            # must reject it, or it could not catch a real slip either
            wrong = plain(*args, cg_steps=2)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {tag}: non-finite kernel output")
            err = float((got - want).abs().max())
            wrong_err = float((got - wrong).abs().max())
            bar = tol + tol * float(want.abs().max())
            if not torch.equal(got[1], args[3][1]):
                raise AssertionError(f"{name} {tag}: all-padding row moved")
            reps = 20 if name == "cg_full" else 5
            ms = cuda_ms(lambda: kernel(*args, cg_steps=3), reps)
            plain_ms = cuda_ms(lambda: plain(*args, cg_steps=3), reps)
            say(2, f"{name} {tag} C={C} L={L} F={F}: max_abs_err={err:.3e} "
                   f"(bar rtol=atol={tol}: {bar:.3e}; against cg_steps=2: "
                   f"{wrong_err:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                raise AssertionError(f"{name} {tag}: kernel disagrees with plain version")
            if torch.allclose(got, wrong, rtol=tol, atol=tol):
                raise AssertionError(f"{name} {tag}: the bar does not tell cg_steps 3 from 2")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res[f"ms_{tag}"] = ms
            res[f"plain_ms_{tag}"] = plain_ms
            del args, got, want, wrong
            torch.cuda.empty_cache()
    return results


def expected_launches(csr, factors, compute_dtype, iterations, grid="pow2"):
    """Chunks the fit routes to each kernel: both sides, every iteration."""
    from implicit_tpu_torch.ops.als import _full_cg_max_l
    from implicit_tpu_torch.sparse import als_chunk_target, chunk_pieces, length_class_grid

    target = als_chunk_target(factors, compute_dtype)
    max_l = _full_cg_max_l(compute_dtype, factors)
    out = {"cg_full": 0, "gramian_cg": 0}
    for m in (csr, csr.T.tocsr()):
        nnz = np.diff(m.indptr)
        Ls, counts = np.unique(length_class_grid(nnz[nnz > 0], 8, grid), return_counts=True)
        for L, count in zip(Ls, counts):
            chunks = sum(p[2] for p in chunk_pieces(int(count), int(L), target, 65536))
            out["cg_full" if L <= max_l else "gramian_cg"] += chunks * iterations
    return out


def phase_main_path(device):
    import torch

    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic
    from implicit_tpu_torch.ops import cg_kernels

    t0 = time.perf_counter()
    plays = generate_synthetic(360_000, 160_000, 17_500_000, seed=0)
    say(3, f"last.fm-shaped data {plays.shape} nnz={plays.nnz} in "
           f"{time.perf_counter() - t0:.1f} s")
    iterations = 3
    want = {name: 0 for name in cg_kernels.LAUNCHES}
    per_dtype, models = {}, {}
    cg_kernels.reset_launches()
    for dtype, cdt in ((np.float32, "float32"), (np.float16, "bfloat16")):
        for name, n in expected_launches(plays, 128, cdt, iterations).items():
            want[name] += n
        times = []
        model = AlternatingLeastSquares(factors=128, iterations=iterations, random_state=0,
                                        dtype=dtype, device=device)
        t0 = time.perf_counter()
        model.fit(plays, show_progress=False,
                  callback=lambda it, elapsed, loss: times.append(elapsed))
        wall = time.perf_counter() - t0
        for f in (model.user_factors, model.item_factors):
            if not np.isfinite(np.asarray(f, dtype=np.float32)).all():
                raise AssertionError(f"{cdt} fit: non-finite factors")
        per_dtype[cdt] = times
        models[cdt] = model
        say(3, f"fit {cdt}: s/iter {[round(t, 4) for t in times]} "
               f"(fit wall incl. host packing {wall:.2f} s)")

    model = models["float32"]
    users = np.arange(0, 360_000, 360_000 // 1024)[:1024]
    liked = plays[users]
    ids, scores = model.recommend(users, liked, N=10, filter_already_liked_items=True)
    if ids.shape != (1024, 10) or not np.isfinite(scores).all():
        raise AssertionError(f"recommend: bad result shape {ids.shape} or scores")
    if (ids < 0).any() or (ids >= plays.shape[1]).any():
        raise AssertionError("recommend: id out of range")
    for row, u in enumerate(users):
        if np.isin(ids[row], liked[row].indices).any():
            raise AssertionError(f"recommend: user {u} got an already-liked item")
    sim_ids, sim_scores = model.similar_items(np.arange(1024), N=10)
    if sim_ids.shape != (1024, 10) or (sim_ids[:, 0] != np.arange(1024)).mean() > 0.01:
        raise AssertionError("similar_items: items are not their own nearest neighbour")
    launches = dict(cg_kernels.LAUNCHES)
    say(3, f"launches {launches}, chunks routed {want}")
    for name in launches:
        if launches[name] != want[name] or launches[name] == 0:
            raise AssertionError(f"{name}: {launches[name]} launches, {want[name]} chunks routed")
    serve_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.recommend(users, liked, N=10)
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    say(3, f"recommend 1024 users N=10 filtered (f32 model): ms {[round(t, 2) for t in serve_ms]}")
    del model, models
    torch.cuda.empty_cache()
    return launches, per_dtype


def phase_quality(device):
    from scipy.sparse import csr_matrix

    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.evaluation import precision_at_k, train_test_split

    with np.load(CORPUS, allow_pickle=False) as f:
        counts = csr_matrix((f["data"], f["indices"], f["indptr"]), shape=tuple(f["shape"]))
    train, test = train_test_split(counts, train_percentage=0.8, random_state=42)
    model = AlternatingLeastSquares(factors=64, regularization=0.05, random_state=3,
                                    device=device)
    model.fit(train, show_progress=False)
    p10 = float(precision_at_k(model, train, test, K=10, show_progress=False))
    say(4, f"stdlib corpus {counts.shape} p@10 = {p10:.4f} (gate > 0.2)")
    if not p10 > 0.2:
        raise AssertionError(f"p@10 {p10} <= 0.2")
    return p10


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = gpu_line()
    say(0, f"{card} | torch {torch.__version__} cuda {torch.version.cuda} "
           f"python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    from implicit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    say(1, f"kernels built+loaded in {time.perf_counter() - t0:.1f} s "
           f"(nvcc per library, s: {json.dumps(_build.BUILD_SECONDS)})")

    kernels = phase_kernels(device)
    launches, _ = phase_main_path(device)
    phase_quality(device)

    rows = []
    for name, spec in KERNELS.items():
        res = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms_f32"],
            "plain_ms": res["plain_ms_f32"], "ms_bf16": res["ms_bf16"],
            "plain_ms_bf16": res["plain_ms_bf16"], "shape_CLF": list(spec["shape"]),
        })
    print(json.dumps({"kernels": rows}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
