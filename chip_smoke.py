#!/usr/bin/env python3
"""Smoke test of implicit_tpu_torch on one CUDA card: build, check, drive.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

0. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
   no CUDA device is a failure;
1. build the CUDA kernels from ``implicit_tpu_torch/ops/csrc`` (nvcc, one
   process per library, all at once, always from the sources), and print
   ptxas's registers and spills of every ``cg_full``, ``weighted_matvec``,
   ``cg_update``, ``pcg64_uniform``, ``topk_select`` and
   ``bpr_item_update`` instantiation, which must not spill;
2. each kernel against its plain PyTorch version on the card, in float32,
   bfloat16 and int8 (per-row scales), at the fit's own class shapes, with
   times and the least time the card could take (``bound``); the same bar
   must reject a deliberately wrong plain version (one CG step short; for
   weighted_matvec each row's last entry dropped), and the solves must give
   the same bits twice. ``cg_full`` also runs at the f=256 fit's short
   class (bf16, int8) and on ``cg_kernels.freeze_case`` (rows freezing at
   different CG steps in one block; each frozen row must keep its x bit
   for bit). ``gramian_cg`` also runs at the fit's head-class shape, where
   each row is split over many blocks, and in float32 must land 10x closer
   to the plain version than the plain version run in TF32.
   ``weighted_matvec`` also runs at F=320 and at the wide fits' own short
   and long classes and head class (f=512 bf16 and int8, f=320 f32), each
   case twice for the same bits; ``cg_update`` (the dense term, on wgmma in
   3xTF32, and masked update of the wide fits' CG) at both wide fits' short
   class, the residual pass and a CG step, twice for the same bits, against
   a wrong reference whose dense term drops YtY_reg's last row, with
   cuBLAS's float32 p YtY_reg alone beside it (``dense_product_library_ms``).
   Times are means over a host
   loop of launches (``cuda_ms``), as a caller sees them; the kernels whose
   launches are short (``weighted_matvec``, ``cg_update``) also give the
   device time of the same launches replayed from a CUDA graph
   (``cuda_graph_ms``) beside it. The starting-factor draw
   (``ops/pcg64.py``, ``csrc/pcg64_uniform.cu``) at the fit cells' tables
   (358,868 x 128, 138,493 x 256, float32): numpy's draw times 0.01 bit
   for bit at the first, the generator left where numpy leaves it, and ms
   over 100 launches beside numpy's host draw and upload, which it replaces.
   The top-k selection (``ops/topk.py:select_topk``, ``csrc/topk_select.cu``)
   at the bulk serving request (1024 x 292,385, k=10), 64 users and one, with
   49 liked items a row excluded: the plain version's ids and scores (the
   bar must reject the plain version without the exclusions), and ms beside
   its bytes bound, the plain version and ``torch.topk`` alone. BPR's
   grouped item update (``ops/bpr_update.py``, ``csrc/bpr_item_update.cu``)
   at the largest class of the grouped epoch on phase 3's last.fm-shaped
   data (F = 128; the BPR cell's data is generated otherwise): every element
   within the float32 bound of its row's sum against a float64 sum of the
   same terms (``bpr_update.bpr_item_update_reference``), as the four
   ``index_put_(accumulate=True)`` calls it replaces must be too (the plain
   version with a kept entry dropped must be rejected), the same bits twice,
   and ms beside its bytes bound, the plain version and the four
   ``index_put_`` calls;
3. the ingest at the last.fm-360k shape (360k users x 160k items, 17.5M
   nnz): ``pack_pair_on_device``'s pack on the card against the same pack
   on the CPU, as the f=128 float32 fit packs, on the pow2 and fine grids,
   every tensor equal and one altered entry rejected, with both times; then the
   main paths, each with the launch counters set to 0 just before it and
   read just after, which must show every routed chunk and both starting
   tables drawn on the card (``init.device_draws``), and each fit's
   set-up (wall minus the iterations) split by step from the port's debug
   lines: ``AlternatingLeastSquares.fit`` at that shape at factors=128 in
   float32, bfloat16 and bfloat16
   with ``gather_quant=True``; at factors=256 with ``gather_quant="auto"``
   (int8 on the item side only) and ``False``; the wide fits, factors=512
   bfloat16 and factors=320 float32 (2 iterations), whose every class solves
   in the composed CG on ``weighted_matvec`` and ``cg_update``; one
   user-side half-iteration of that composed CG
   (``_cg_class(use_pallas=True)``) at f=128 with the float32, bfloat16 and
   int8 tables against the plain CG; then batched ``recommend`` and
   ``similar_items``;
4. quality: p@10 > 0.2 on the committed stdlib corpus, read through the
   port's loader (``datasets.stdlib_corpus.get_stdlib_corpus``),
   unquantized and with ``gather_quant=True``;
5. the SGD families (torch ops, no kernel of their own) on phase 3's data:
   BPR f=128 grouped and sampled (s/epoch, samples/s, correct and skipped
   per epoch, set-up by step; a second grouped fit of the same seed must
   give the same bits), LMF f=32 ``neg_prop=30`` (its pool routes and
   s/epoch), one ``torch.profiler`` epoch of each (top kernels and ops,
   busy share), ``recommend`` from both; one grouped BPR epoch and LMF
   class updates with draws made on the host, card against CPU, whose bar
   must reject a result missing one chunk; p@10 >= 0.85 for BPR and LMF on
   ``bench_quality``'s clustered set;
6. the item-item family (torch ops and host C++, no kernel of its own) at
   the ML-20M shape (138k x 27k, 12M nnz): BM25 K=20's similarity through
   the device route and the host route, which must agree (values within
   1e-5, neighbours equal up to ties at the K-th score; the same bar must
   reject a gramian missing its last user chunk, and a second device build
   give the same bits), with both routes' times, the gramian's TFLOP/s and
   what "auto" picks; BM25 K=20 at the last.fm shape (the host route);
   ``EASERecommender(K=100)``'s steps and peak device memory, its closed
   form checked on 64 columns (weights solved with lam off by 10% must
   fail); batched ``recommend`` from both models against the host
   formulation; clustered p@10 >= 0.85 for BM25 and EASE; the cost rule's
   measured rates;
7. serving beyond the resident table (torch ops on CUDA streams, events
   and pinned memory, no kernel of its own): phase 3's f=128 float32 fit
   serves 64 batches of 1024 users through ``recommend_pipelined`` and 32
   batches of 1024 items through ``similar_items_pipelined``, which must
   give the per-batch calls' bits (walls and rows/s of both); a 10M x 128
   float32 table (5.12 GB, over the 4 GiB residency threshold) drawn on the
   card and copied to the host serves 1024 filtered queries through
   ``topk_streaming``, which must equal the resident top-k on the card's
   copy (ids up to ties at the 10th score, scores within 1e-6 relative)
   while the same bar rejects the streamed result with its last block
   dropped; an ALS model holding it routes to the streaming table and
   serves 8 batches in one pass (walls, GB/s); ``TPUIVFAlternatingLeastSquares
   (factors=128)`` at the last.fm shape (800 clusters, probe 100): its fit's
   launches, the k-means build wall, a second build with the same bits,
   every cluster probed giving the exact model's answer for 64 users,
   recall@10 at probe 100 over 1024 users, ms per 1024 users approximate and
   exact; recall@10 > 0.85 on 200,000 x 128 clustered points;
8. the reference's idioms on the card (the ``cpu`` / ``gpu`` / ``tpu`` alias
   modules and the dataset loaders, no kernel of their own):
   ``gpu.HAS_CUDA`` is True, ``tpu.HAS_TPU`` False, ``tpu.device_count()``
   torch's count, and every alias the port's own object; the factory with
   ``use_gpu=gpu.HAS_CUDA`` at phase 3's f=128 float32 arguments on its
   data gives a ``gpu.als.AlternatingLeastSquares`` whose launches are the
   chunks routed (``cg_full`` and ``gramian_cg``) and whose factors are
   phase 3's, bit for bit (s/iter, set-up); ``cpu.topk.topk`` on a numpy
   copy of its item factors (160k x 128) gives ``ops.topk.topk``'s bits on
   the card's table for 1024 filtered users (both walls);
   ``get_stdlib_corpus()`` equals the committed npz; in an empty
   ``IMPLICIT_DATASETS_PATH`` the probes find nothing and nothing is
   fetched; where h5py and pandas import, phase 6's ML-20M-shaped matrix
   goes through a MovieLens-20M dump, ``movielens.generate_dataset`` and
   ``get_movielens`` and must come back as its transpose (walls), and
   where they do not, one line says so;
9. the meshed paths (``implicit_tpu_torch.parallel``; the kernels launched
   per shard) on ``virtual_mesh(4, cuda:0)``, four shards on the one card,
   at phase 3's shape: ``RowShardedBuckets`` on the card against the same
   layout on a CPU mesh of four shards (both sides, every tensor of every
   shard, an altered entry rejected, both seconds); the sharded loss on phase 3's f=128
   float32 factors against the single device's; the f=128 float32 meshed
   fit (3 iterations) against phase 3's (factors, loss, recommend ids of
   1024 users; the same bar must reject a fit whose last shard skipped its
   last solve), its launches the routed chunks summed over the shards,
   s/iter beside phase 3's and its set-up by step; a D=1 mesh against no
   mesh, bit for bit; f=128 bfloat16 with ``gather_quant=True`` and f=512
   bfloat16 (1 iteration) against the unmeshed fits at 5% of scale; meshed
   ``recommend`` (1024 users), ``similar_items`` (1024 items) and
   ``recommend_pipelined`` (8 x 1024 users) against the resident calls
   (ids up to ties, scores within 1e-6; the same bar must reject a merge
   without the shard holding most answers), with walls; and meshed
   ``topk_streaming`` of phase 7's 10M x 128 table against the resident
   top-k (phase 7's bar, a dropped last slice rejected), with walls;
10. the meshed SGD and item-item fits (torch ops, no kernel of their own) on
   the same ``virtual_mesh(4, cuda:0)``: one meshed BPR f=128 sampled epoch
   fed draws made on the host (last.fm shape, batch 65536 = 4 x 16384, 280
   steps) must give ``_bpr_epoch``'s bits on their concatenation, and the
   same bar must reject the epoch without the last shard's draws; BPR on
   ``virtual_mesh(1)`` the unmeshed sampled fit's bits (1 epoch); two
   meshed BPR fits of one seed the same bits (2 epochs, s/epoch beside
   phase 5's, set-up by step); LMF f=32 ``neg_prop=30`` meshed for 5
   epochs, every pool's arrangement (the re-shuffle in epoch 5) equal to a
   host replay of numpy's stream; meshed ``recommend`` of both against the
   resident call (phase 9's bar); one meshed LMF class update with draws
   made on the host, card against CPU at phase 5's bar, which must reject
   the update missing the last shard's slice; clustered p@10 >= 0.85 for
   meshed BPR and LMF; BM25 K=20 at phase 6's ML-20M shape through the
   meshed device route against phase 6's unmeshed similarity (phase 6's
   route bar; a gramian missing its last shard's row block rejected; a
   second build the same bits; wall and TFLOP/s beside phase 6's); EASE's
   meshed weights by phase 6's closed form (lam off by 10% rejected) and
   ``EASERecommender(K=100, mesh=)`` against phase 6's similarity, with its
   steps and peak device memory. Each step prints its wall (``grep "phase
   10"``);
11. BPR's grouped pool modes (torch ops, no kernel of their own) at phase
   5's shape and arguments (f=128, ``random_state=1``): one epoch of each
   of ``pool_mode`` 2 and 1 fed draws made on the host at phase 5's
   injected-draw shape, card against CPU at phase 5's BPR bar (1e-5 of
   scale, counts exact), which must reject the result with one chunk left
   out; ``epoch_mode="grouped_pool"`` and ``"grouped_pool_ids"``, 4 epochs
   each, the fourth under ``torch.profiler`` (s/epoch, samples/s, busy
   share, launches per epoch, set-up by step, beside phase 5's grouped and
   sampled s/epoch); the pool mode 2 fit again through the module flag
   ``BPR_GROUPED = 2``, which must give the same bits; ``recommend`` for
   1024 users from each; clustered p@10 >= 0.85 for both
   (``grep "phase 11"``).

The second-to-last lines are one JSON object of per-kernel results and the
card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

import contextlib
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "implicit_tpu_torch", "datasets", "_data", "stdlib_corpus.npz")


# kernel vs plain: same inputs, same f32 accumulation, different summation
# order. rtol = atol: 1e-4 in float32; in bfloat16 2e-3, the bar of the JAX
# package's own kernel-vs-composed tests; int8 1e-4, since kernel and plain
# version dequantize to the same bfloat16 values and both accumulate in
# float32 (tests/test_torch_cuda.py holds the same three)
TOL = {"f32": 1e-4, "bf16": 2e-3, "i8": 1e-4}
VARIANTS = ("f32", "bf16", "i8")

# each kernel's phase-2 cases: {case: ((C, L, F), variants)}; "shape" is the
# one whose float32 times and bound stand in the kernels line
KERNELS = {
    "cg_full": dict(
        source="implicit_tpu_torch/ops/csrc/cg_full.cu",
        replaces="implicit_tpu/ops/pallas_ops.py:173",
        cases={
            "shape": ((4096, 64, 128), VARIANTS),  # a short-row class of the f=128 fit
            # the f=256 fit's short class, in the table types that fit runs
            "f256_shape": ((4096, 64, 256), ("bf16", "i8")),
            # cg_kernels.freeze_case: rows freezing at different CG steps side
            # by side in the lockstep blocks; C no multiple of 8
            "freeze_case": ((4101, 64, 128), VARIANTS),
        }),
    "gramian_cg": dict(
        source="implicit_tpu_torch/ops/csrc/gramian_cg.cu",
        replaces="implicit_tpu/ops/pallas_ops.py:292",
        cases={
            "shape": ((256, 8192, 128), VARIANTS),  # a long-row (head item) class
            # the fit's head class at f=128 (L=65536, C=8): few rows, each
            # split over many L-slices
            "head_class": ((8, 65536, 128), VARIANTS),
        }),
    "weighted_matvec": dict(
        source="implicit_tpu_torch/ops/csrc/weighted_matvec.cu",
        replaces="implicit_tpu/ops/pallas_ops.py:46",
        cases={
            "shape": ((1024, 600, 128), VARIANTS),  # L not a multiple of 32
            "f320_shape": ((1024, 600, 320), VARIANTS),
            # the wide fits' classes, which they solve in the composed CG:
            # short rows and long rows, C as the fit cuts them (checked
            # against wide_class_shape), and the head class (its 8 rows, each
            # cut into many L-slices)
            "f512_short": ((65536, 64, 512), ("bf16", "i8")),
            "f512_long": ((512, 8192, 512), ("bf16", "i8")),
            "f512_head_class": ((8, 65536, 512), ("bf16",)),
            "f320_short": ((52424, 64, 320), ("f32",)),
            "f320_long": ((408, 8192, 320), ("f32",)),
            "f320_head_class": ((8, 65536, 320), ("f32",)),
        }),
    # reads no table: one entry point, float32 vectors ("f32"); L unused
    "cg_update": dict(
        source="implicit_tpu_torch/ops/csrc/cg_update.cu",
        # the CG arithmetic of _cg_full_kernel (and of _gramian_cg_kernel,
        # :292) past F = 256
        replaces="implicit_tpu/ops/pallas_ops.py:173",
        cases={
            "shape": ((65536, 64, 512), ("f32",)),  # the f=512 fit's short class
            "f320_short": ((52424, 64, 320), ("f32",)),
        }),
}

# cases whose float32 sums run over tens of thousands of entries: the same
# sum in another order moves by up to about n eps sum |terms| (4.3e-4 at the
# f=320 head class, 32,768 live entries per row, outputs up to ~40; an H100
# run), which no elementwise 1e-4 bar holds where an output is near 0. Their
# bar is relative to the output's scale, as the tests' _within holds solves.
SCALE_BAR = {("weighted_matvec", "f320_head_class")}

# the wide fits' classes in KERNELS, as (factors, compute dtype) by case
WIDE_CASES = {"f512_short": (512, "bfloat16"), "f512_long": (512, "bfloat16"),
              "f320_short": (320, "float32"), "f320_long": (320, "float32")}

# the starting-factor draw's cases, (n, F) float32: the fit cells' user
# tables; "shape" is also checked bit for bit against numpy's draw
DRAW_CASES = {"shape": (358868, 128), "ml20m_user_table": (138493, 256)}

# the top-k selection's cases, (Q, n, k): the bulk serving cell's request
# ("shape"), an online batch and a single user, over last.fm's catalog; each
# row excludes TOPK_LIKED liked items, about last.fm's mean
TOPK_CASES = {"shape": (1024, 292385, 10), "batch_64": (64, 292385, 10),
              "single": (1, 292385, 10)}
TOPK_LIKED = 49

# BPR's grouped item update: the benchmark cell's width (bpr_lastfm360k_f128)
BPR_UPDATE_F = 128

# the card's peaks for bound_ms (H100 SXM data sheet, dense, at 700 W): HBM,
# float32 on the CUDA cores, and the tensor cores in TF32 and bfloat16
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

# launches per phase-2 timing: a mean over 10 moved by up to 3% with the
# work run just before it, one over hundreds by under 0.5%
# (scripts/phase2_context.py)
REPS = 100


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


def cuda_graph_ms(fn, reps):
    """Mean device milliseconds per call over ``reps`` calls captured in one
    CUDA graph and replayed, after a warm-up: the launches back to back,
    without the host's time between them (the wrapper's Python), which
    ``cuda_ms`` also counts when a launch is shorter than it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
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


def as_variant(Y, variant):
    """The float32 table as the variant has it: (table, scales or None)."""
    import torch

    from implicit_tpu_torch.ops.als import _quantize_table

    if variant == "bf16":
        return Y.to(torch.bfloat16), None
    if variant == "i8":
        return _quantize_table(Y, "bfloat16")
    return Y, None


def variant_case(shape, variant, device, freeze=False):
    """``kernel_case`` at ``shape`` (or ``cg_kernels.freeze_case`` with x0 in
    the span of the rows the variant reads), with the table as the variant
    has it: float32, bfloat16, or int8 + scales quantized from it. Returns
    (Y, scales, idx, dat, x0, yty, steps); steps is None but for freeze."""
    import torch

    from implicit_tpu_torch.ops import cg_kernels

    C, L, F = shape
    if not freeze:
        Y, idx, dat, x0, yty = kernel_case(C, L, F, torch.float32, seed=C + L, device=device)
        return (*as_variant(Y, variant), idx, dat, x0, yty, None)

    def seen(Y):
        q, s = as_variant(torch.as_tensor(Y), variant)
        return (q.float() if s is None else cg_kernels.dequantize_rows(q, s).float()).numpy()

    *arrays, steps = cg_kernels.freeze_case(C, L, F, seed=C, seen=seen)
    Y, idx, dat, x0, yty = (torch.as_tensor(a, device=device) for a in arrays)
    return (*as_variant(Y, variant), idx, dat, x0, yty, steps)


def drop_last_entry(w, bv):
    """(w, bv) with each row's last nonzero entry set to 0: a wrong reference."""
    import torch

    live = (w != 0) | (bv != 0)
    L = w.shape[1]
    last = L - 1 - torch.flip(live, (1,)).int().argmax(1)
    rows = torch.nonzero(live.any(1))[:, 0]
    w, bv = w.clone(), bv.clone()
    w[rows, last[rows]] = 0.0
    bv[rows, last[rows]] = 0.0
    return w, bv


def check_against(tag, got, want, wrong, tol, what_wrong, scaled=False):
    """max |got - want|, with the bar rtol = atol = tol elementwise, or with
    ``scaled`` relative to the output's scale, |got - want| <= tol (1 + max
    |want|) (``SCALE_BAR``); the bar must hold against ``want`` and reject
    ``wrong``."""
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: non-finite kernel output")
    err = float((got - want).abs().max())
    wrong_err = float((got - wrong).abs().max())
    bar = tol + tol * float(want.abs().max())
    close = (lambda ref: float((got - ref).abs().max()) <= bar) if scaled else (
        lambda ref: torch.allclose(got, ref, rtol=tol, atol=tol))
    if not close(want):
        raise AssertionError(f"{tag}: kernel disagrees with plain version ({err:.3e})")
    if close(wrong):
        raise AssertionError(f"{tag}: the bar does not tell the plain version from {what_wrong}")
    return dict(max_abs_err=err, bar=bar, wrong_ref_err=wrong_err)


def tf32_check(tag, got, ref):
    """The float32 kernel against the float32 plain version must land at
    least 10x closer than the same plain version run in TF32 does: the 1e-4
    bar alone would pass a single-pass TF32 kernel. The plain versions pin
    full float32 per product (``full_f32_matmul``); the TF32 run lifts that
    pin and turns TF32 on."""
    import contextlib

    import torch

    from implicit_tpu_torch.ops import cg_kernels

    want = ref()
    saved, pin = torch.backends.cuda.matmul.allow_tf32, cg_kernels.full_f32_matmul
    torch.backends.cuda.matmul.allow_tf32 = True
    cg_kernels.full_f32_matmul = contextlib.nullcontext
    try:
        tf32 = ref()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
        cg_kernels.full_f32_matmul = pin
    err = float((got - want).abs().max())
    tf32_err = float((tf32 - want).abs().max())
    if not err <= 0.1 * tf32_err:
        raise AssertionError(f"{tag}: error {err:.3e} is not 10x under the TF32 plain "
                             f"version's {tf32_err:.3e}")
    return tf32_err


def solve_passes(plain, Y, scales, idx, dat, x0, yty, cg_steps=3):
    """Passes over each row's entries that the solve needs (the residual and
    each CG step the row is still active for), from the plain version: a
    row active at step s moves its x there."""
    import torch

    xs = [plain(Y, idx, dat, x0, yty, cg_steps=s, scales=scales) for s in range(cg_steps + 1)]
    moved = [(xs[s] != xs[s - 1]).any(1) for s in range(1, cg_steps + 1)]
    return 1 + torch.stack(moved, 1).sum(1)


def bound(name, Y, scales, idx, dat, passes=None):
    """(bound_ms, bound_by, flops, bytes) of one call on these inputs: the
    larger of its bytes (each table row a live entry reads, once; idx and
    the entry weights; the (C, F) vectors in and out; YtY_reg) over the
    card's memory rate and its flops over the peak of the unit and type
    they need. On the CUDA cores in float32: per pass a row costs 2 F^2 (the
    dense term) + 4 F per live entry (y . v, then coeff * y); the gramian's
    b 2 F per live entry and its CG 2 F^2 per pass; weighted_matvec's A p
    pass 4 F per live entry. The gramian build's symmetric A is F (F + 1)
    per live entry (the upper triangle), a product over the entry axis for
    the tensor cores: in bfloat16 for bf16 and int8 tables, and for float32
    tables in 3xTF32 (a third of the TF32 peak), the fastest way to float32
    accuracy there (phase 2 rejects a single TF32 pass). The build must end
    before the CG starts, so the two times add."""
    C, L = idx.shape
    F = Y.shape[1]
    live = (dat != 0).sum(1).double()
    rows = int(idx[dat != 0].unique().numel())
    row_bytes = F * Y.element_size() + (4 if scales is not None else 0)
    weights = 12 if name == "weighted_matvec" else 8  # idx + dat, or idx + w + bv
    nbytes = rows * row_bytes + C * L * weights + 2 * C * F * 4
    mma_flops = 0.0  # on the tensor cores
    if name == "weighted_matvec":
        flops = float(4 * F * live.sum())
    else:
        nbytes += F * F * 4
        passes = passes.double()
        if name == "cg_full":
            flops = float((passes * (2 * F * F + 4 * F * live)).sum())
        else:
            flops = float((2 * F * live + passes * 2 * F * F).sum())
            mma_flops = float(F * (F + 1) * live.sum())
    mma_peak = PEAK_TF32_FLOPS / 3 if Y.element_size() == 4 else PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_flops = flops / PEAK_F32_FLOPS + mma_flops / mma_peak
    by = "bytes" if t_bytes >= t_flops else "operations"
    return 1e3 * max(t_bytes, t_flops), by, flops + mma_flops, nbytes


def update_bound(C, F):
    """(bound_ms, bound_by, flops, bytes) of one cg_update step on (C, F):
    the dense term's 2 F^2 flops per row at float32 accuracy on the tensor
    cores (3xTF32, a third of the TF32 peak, as ``bound`` takes the gramian
    build) and the update's 10 F on the CUDA cores, against YtY_reg and the
    row vectors read once (p, s, x, r and rs, act) and written once (x, r, p
    and rs, act)."""
    flops = 2.0 * C * F * F + 10.0 * C * F
    nbytes = 4.0 * F * F + 7 * 4.0 * C * F + 4 * 4.0 * C
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_flops = 2.0 * C * F * F / (PEAK_TF32_FLOPS / 3) + 10.0 * C * F / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations", \
        flops, nbytes


def update_inputs(C, F, device, seed):
    """cg_update's inputs at (C, F) from a numpy seed: YtY_reg, x0, the
    residual pass's sparse term b, and a positive semidefinite B standing in
    for the sparse term of a step (s = p B). Row 1 starts at its solution
    (x0 = b = 0) and must never move."""
    import torch

    rng = np.random.default_rng(seed)
    Ys, Zs = (rng.standard_normal((4096, F), dtype=np.float32) * 0.1 for _ in range(2))
    x0 = rng.standard_normal((C, F), dtype=np.float32) * 0.01
    b = rng.standard_normal((C, F), dtype=np.float32) * 0.1
    x0[1] = b[1] = 0.0
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(Ys.T @ Ys + 0.05 * np.eye(F, dtype=np.float32)), t(x0), t(b), t(Zs.T @ Zs)


def update_case(tag, shape, device, tol):
    """cg_update against its plain version at (C, F): the residual pass,
    then a CG step from the plain version's state, each twice for the same
    bits and against a wrong reference (the dense term without YtY_reg's
    last row); the step must also land 10x closer to the plain version
    than the plain version run in TF32 (``tf32_check``). Returns (results,
    run, ref, dense): run and ref time a step, dense its dense term alone as
    one cuBLAS float32 product, p YtY_reg (the yardstick of the kernel's
    product; no single PyTorch call computes the whole pass)."""
    import torch

    from implicit_tpu_torch.ops import cg_kernels

    C, _, F = shape
    yty, x0, b, B = update_inputs(C, F, device, seed=C + F)
    wrong_yty = yty.clone()
    wrong_yty[-1] = 0.0

    def one_pass(update, state, s, first, m=yty):
        x, r, p, rs, act = (t.clone() for t in state)
        update(s, m, x0 if first else p, x, r, p, rs, act, first)
        return x, r, p, rs, act

    flat = lambda out: torch.cat([t.reshape(-1) for t in out[:4]])  # noqa: E731
    state = [torch.zeros_like(x0) for _ in range(3)] + [
        torch.zeros(C, device=device), torch.zeros(C, dtype=torch.int32, device=device)]
    res = None
    for first in (True, False):
        with cg_kernels.full_f32_matmul():
            s = b if first else state[2] @ B  # the sparse term
        got = one_pass(cg_kernels.cg_update, state, s, first)
        want = one_pass(cg_kernels.cg_update_plain, state, s, first)
        wrong = one_pass(cg_kernels.cg_update_plain, state, s, first, wrong_yty)
        again = one_pass(cg_kernels.cg_update, state, s, first)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{tag}: two runs on the same inputs differ")
        if not torch.equal(got[4], want[4]) or got[0][1].any():
            raise AssertionError(f"{tag}: active rows differ, or the row at its solution moved")
        r = check_against(f"{tag} {'residual pass' if first else 'CG step'}", flat(got),
                          flat(want), flat(wrong), tol, "YtY_reg's last row dropped")
        res = r if res is None else {k: max(res[k], r[k]) for k in r}
        if not first:
            res["tf32_ref_err"] = tf32_check(f"{tag} CG step", flat(got), lambda: flat(
                one_pass(cg_kernels.cg_update_plain, state, s, first)))
        state = want
    with cg_kernels.full_f32_matmul():
        s = state[2] @ B
    bufs = [t.clone() for t in state]
    plain_bufs = [t.clone() for t in state]
    # timed on the CG step, cg_steps of the cg_steps + 1 passes per solve
    run = lambda: cg_kernels.cg_update(s, yty, bufs[2], *bufs, False)  # noqa: E731
    ref = lambda: cg_kernels.cg_update_plain(  # noqa: E731
        s, yty, plain_bufs[2], *plain_bufs, False)

    def dense():
        with cg_kernels.full_f32_matmul():
            return plain_bufs[2] @ yty

    return res, run, ref, dense


def wide_class_shape(factors, L, compute_dtype="bfloat16"):
    """(C, L, F) of a full chunk of a class of row length L in a fit at this
    width: C as the fit cuts it (``als_chunk_target``, ``chunk_pieces``)."""
    from implicit_tpu_torch.sparse import als_chunk_target, chunk_pieces

    target = als_chunk_target(factors, compute_dtype)
    return chunk_pieces(1 << 30, L, target, 65536)[0][3], L, factors


def phase_kernels(device):
    import torch

    from implicit_tpu_torch.ops import cg_kernels
    from implicit_tpu_torch.ops.als import _weights

    for name, spec in KERNELS.items():
        for which, (shape, _) in spec["cases"].items():
            fit = WIDE_CASES.get("f512_short" if name == "cg_update" and which == "shape"
                                 else which)
            if fit and shape != wide_class_shape(fit[0], shape[1], fit[1]):
                raise AssertionError(f"{name} {which}: {shape} is not the fit's chunk "
                                     f"{wide_class_shape(fit[0], shape[1], fit[1])}")

    solves = {"cg_full": (cg_kernels.cg_solve_full, cg_kernels.cg_solve_full_plain),
              "gramian_cg": (cg_kernels.gramian_cg_solve, cg_kernels.gramian_cg_solve_plain)}
    results = {name: {} for name in KERNELS}
    for name, spec in KERNELS.items():
        for which, (shape, variants) in spec["cases"].items():
            C, L, F = shape
            for variant in variants:
                tol = TOL[variant]
                if name == "cg_update":
                    tag = f"cg_update C={C} F={F}"
                    res, run, ref, dense = update_case(tag, shape, device, tol)
                    res["ms"] = cuda_ms(run, REPS)
                    res["graph_ms"] = cuda_graph_ms(run, REPS)
                    res["plain_ms"] = cuda_ms(ref, REPS)
                    res["dense_product_library_ms"] = cuda_ms(dense, REPS)
                    res["bound_ms"], res["bound_by"], flops, nbytes = update_bound(C, F)
                    say(2, f"{tag}: max_abs_err={res['max_abs_err']:.3e} (bar rtol=atol={tol}: "
                           f"{res['bar']:.3e}; against the wrong reference: "
                           f"{res['wrong_ref_err']:.3e}; the TF32 plain version is "
                           f"{res['tf32_ref_err']:.3e} off; twice for the same bits) kernel "
                           f"{res['ms']:.4f} ms (graph {res['graph_ms']:.4f}), plain "
                           f"{res['plain_ms']:.4f} ms; dense_product_library_ms="
                           f"{res['dense_product_library_ms']:.4f} (cuBLAS p YtY_reg alone); "
                           f"bound {res['bound_ms']:.4f} ms by "
                           f"{res['bound_by']} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} "
                           f"MB), {100 * res['bound_ms'] / res['ms']:.1f}% of it")
                    results[name].setdefault(which, {})[variant] = res
                    del run, ref, dense
                    torch.cuda.empty_cache()
                    continue
                Y, scales, idx, dat, x0, yty, steps = variant_case(
                    shape, variant, device, freeze=which == "freeze_case")
                tag = f"{name} {variant} C={C} L={L} F={F}" + (
                    " freeze case" if steps is not None else "")
                if name in solves:
                    kernel, plain = solves[name]
                    run = lambda steps=3: kernel(  # noqa: E731
                        Y, idx, dat, x0, yty, cg_steps=steps, scales=scales)
                    ref = lambda steps=3: plain(  # noqa: E731
                        Y, idx, dat, x0, yty, cg_steps=steps, scales=scales)
                    got = run()
                    # a deliberately wrong reference (one CG step short): the
                    # bar must reject it, or it could not catch a real slip either
                    res = check_against(tag, got, ref(), ref(2), tol, "cg_steps=2")
                    if not torch.equal(got[1], x0[1]):
                        raise AssertionError(f"{tag}: all-padding row moved")
                    if steps is not None:
                        # a frozen row keeps the x of the step it froze at, bit for bit
                        xs = [run(s) for s in range(3)] + [got]
                        for s in range(4):
                            rows = torch.as_tensor(steps == s, device=device)
                            if not torch.equal(xs[s][rows], got[rows]):
                                raise AssertionError(f"{tag}: a row frozen at step {s} moved")
                        res["rows_by_freeze_step"] = np.bincount(steps + 1).tolist()
                    if name == "gramian_cg" and variant == "f32":
                        res["tf32_ref_err"] = tf32_check(tag, got, ref)
                    again = run()
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"{tag}: two runs on the same inputs differ")
                    passes = solve_passes(plain, Y, scales, idx, dat, x0, yty)
                else:
                    if scales is not None:  # float32 scales, as the wide solve passes them
                        scales = scales.float()
                    w, bv = _weights(dat)
                    w_short, bv_short = drop_last_entry(w, bv)
                    v = x0 * 10
                    for alpha, beta in ((1.0, -1.0), (0.0, 1.0)):
                        got = cg_kernels.weighted_matvec(Y, idx, w, bv, v, alpha, beta, scales)
                        want = cg_kernels.weighted_matvec_plain(
                            Y, idx, w, bv, v, alpha, beta, scales)
                        wrong = cg_kernels.weighted_matvec_plain(
                            Y, idx, w_short, bv_short, v, alpha, beta, scales)
                        r = check_against(f"{tag} (alpha, beta)=({alpha:g}, {beta:g})", got,
                                          want, wrong, tol, "each row's last entry dropped",
                                          scaled=(name, which) in SCALE_BAR)
                        res = r if alpha == 1.0 else {k: max(res[k], r[k]) for k in r}
                        again = cg_kernels.weighted_matvec(Y, idx, w, bv, v, alpha, beta, scales)
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"{tag}: two runs on the same inputs differ")
                    # timed on the A p pass, cg_steps of the cg_steps + 1 per solve
                    run = lambda: cg_kernels.weighted_matvec(  # noqa: E731
                        Y, idx, w, bv, v, 0.0, 1.0, scales)
                    ref = lambda: cg_kernels.weighted_matvec_plain(  # noqa: E731
                        Y, idx, w, bv, v, 0.0, 1.0, scales)
                    passes = None
                res["ms"] = cuda_ms(run, REPS)
                if name == "weighted_matvec":  # the device time of the same launches
                    res["graph_ms"] = cuda_graph_ms(run, REPS)
                res["plain_ms"] = cuda_ms(ref, REPS)
                res["bound_ms"], res["bound_by"], flops, nbytes = bound(
                    name, Y, scales, idx, dat, passes)
                tf32 = (f"; the TF32 plain version is {res['tf32_ref_err']:.3e} off"
                        if "tf32_ref_err" in res else "")
                if "graph_ms" in res:
                    tf32 += f"; twice for the same bits; graph {res['graph_ms']:.4f} ms"
                scale = " of scale" if (name, which) in SCALE_BAR else ""
                say(2, f"{tag}: max_abs_err={res['max_abs_err']:.3e} (bar rtol=atol={tol}{scale}: "
                       f"{res['bar']:.3e}; against the wrong reference: "
                       f"{res['wrong_ref_err']:.3e}{tf32}) kernel {res['ms']:.4f} ms, plain "
                       f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms by "
                       f"{res['bound_by']} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB), "
                       f"{100 * res['bound_ms'] / res['ms']:.1f}% of it")
                results[name].setdefault(which, {})[variant] = res
                del Y, scales, idx, dat, x0, yty, got, run, ref
                torch.cuda.empty_cache()
    return results


def phase_draw(device):
    """The starting-factor draw on the card at ``DRAW_CASES``: bit for bit
    numpy's at "shape", where a draw one float late must differ; ms over
    ``REPS`` launches (and from a CUDA graph), the bound (the table's
    bytes written over 3.35 TB/s) and the host route it replaces (numpy's
    draw, the scaling, the upload), as a row of the kernels line."""
    import torch

    from implicit_tpu_torch.ops import pcg64

    row = {"name": "pcg64_uniform", "route": "cuda",
           "source": "implicit_tpu_torch/ops/csrc/pcg64_uniform.cu",
           "replaces": "numpy's host draw (models/als.py:_initial_factors)", "library_ms": None}
    for which, (n, F) in DRAW_CASES.items():
        tag = f"pcg64_uniform f32 {n} x {F}"
        rng = np.random.default_rng(8400000001)
        res = {"shape_nF": [n, F]}
        if which == "shape":
            got = pcg64.uniform_factors(rng, (n, F), torch.float32, device).cpu().numpy()
            host = np.random.default_rng(8400000001)
            want = host.random((n, F), dtype=np.float32) * np.float32(0.01)
            late = np.random.default_rng(8400000001)
            late.random(1, dtype=np.float32)
            late = late.random((n, F), dtype=np.float32) * np.float32(0.01)
            res["bits_differing"] = int((got.view(np.uint32) != want.view(np.uint32)).sum())
            res["late_draw_differing"] = int((got.view(np.uint32) != late.view(np.uint32)).sum())
            if res["bits_differing"] or rng.bit_generator.state != host.bit_generator.state:
                raise AssertionError(f"{tag}: {res['bits_differing']} values differ from numpy's "
                                     "draw, or the generator was left elsewhere")
            if not res["late_draw_differing"]:
                raise AssertionError(f"{tag}: the check does not tell a late draw apart")
            del got, want, late

        def run():
            pcg64.uniform_factors(rng, (n, F), torch.float32, device)

        def host_route():
            draw = rng.random((n, F), dtype=np.float32)
            return torch.as_tensor(draw, device=device) * 0.01

        res["ms"] = cuda_ms(run, REPS)
        res["graph_ms"] = cuda_graph_ms(run, REPS)
        res["host_route_ms"] = cuda_ms(host_route, 3)
        res["bound_ms"] = n * F * 4 / PEAK_BYTES_PER_S * 1e3
        say(2, f"{tag}: " + (f"numpy's bits in every value ({res['late_draw_differing']} differ "
                             "from a draw one float late); " if which == "shape" else "")
            + f"kernel {res['ms']:.4f} ms (graph {res['graph_ms']:.4f}), numpy's draw and "
              f"upload {res['host_route_ms']:.1f} ms; bound {res['bound_ms']:.4f} ms by bytes "
              f"({n * F * 4 / 1e6:.1f} MB), {100 * res['bound_ms'] / res['graph_ms']:.1f}% of it")
        if which == "shape":
            row.update(ms=res["ms"], plain_ms=res["host_route_ms"], bound_ms=res["bound_ms"],
                       bound_by="bytes", max_abs_err=0.0)
        row[which] = res
        torch.cuda.empty_cache()
    return row


def phase_topk(device):
    """The top-k selection kernel (``ops/topk.py:select_topk``,
    ``csrc/topk_select.cu``) at ``TOPK_CASES`` on N(0, 0.1^2) scores with
    ``TOPK_LIKED`` exclusions a row, its 4 best scores among them: the
    plain version's values and ids (no ties at these scores), which the bar
    must tell from the plain version without the exclusions; ms over
    ``REPS`` selections (and from a CUDA graph), the bound (the score
    block's bytes read once over 3.35 TB/s), the plain version (the scatter
    and ``torch.topk``) and ``torch.topk`` alone (``library_ms``), as a row
    of the kernels line."""
    import torch

    from implicit_tpu_torch.ops import topk

    row = {"name": "topk_select", "route": "cuda",
           "source": "implicit_tpu_torch/ops/csrc/topk_select.cu",
           "replaces": "none: torch.topk and the liked scatter (the JAX package's lax.top_k)"}
    for which, (Q, n, k) in TOPK_CASES.items():
        tag = f"topk_select {Q} x {n} k={k}"
        gen = torch.Generator(device=device).manual_seed(8400000001 + Q)
        scores = torch.randn((Q, n), generator=gen, device=device) * 0.1
        # each row's 4 best scores among its liked items, as a fitted model's
        rng = np.random.default_rng(Q)
        best = torch.topk(scores, 4, dim=1)[1].cpu().numpy()
        liked = [np.unique(np.concatenate([rng.choice(n, TOPK_LIKED - 4, replace=False), b]))
                 for b in best]
        excl = topk._upload_exclusions(np.cumsum([0] + [len(r) for r in liked]),
                                       np.concatenate(liked), device)
        before = topk.LAUNCHES["topk_select"]
        got = topk.select_topk(scores, k, excl)
        launches = topk.LAUNCHES["topk_select"] - before
        want = topk.select_topk_plain(scores.clone(), k, excl)
        wrong = topk.select_topk_plain(scores.clone(), k)
        res = {"shape_Qnk": [Q, n, k], "launches_a_selection": launches,
               "segments": topk._segments(Q, n, device)}
        res["ids_differing"] = int((got[1] != want[1]).sum())
        res["max_abs_err"] = float((got[0] - want[0]).abs().max())
        wrong_ids = int((got[1] != wrong[1]).sum())
        if res["ids_differing"] or res["max_abs_err"]:
            raise AssertionError(f"{tag}: {res['ids_differing']} ids differ from the plain "
                                 f"version, scores by {res['max_abs_err']}")
        if not wrong_ids:
            raise AssertionError(f"{tag}: the check does not tell missing exclusions apart")
        plain_scores = scores.clone()
        res["ms"] = cuda_ms(lambda: topk.select_topk(scores, k, excl), REPS)
        res["graph_ms"] = cuda_graph_ms(lambda: topk.select_topk(scores, k, excl), REPS)
        res["plain_ms"] = cuda_ms(lambda: topk.select_topk_plain(plain_scores, k, excl), 10)
        res["library_ms"] = cuda_ms(lambda: torch.topk(scores, k, dim=1), 10)
        res["bound_ms"] = Q * n * 4 / PEAK_BYTES_PER_S * 1e3
        say(2, f"{tag}: the plain version's ids and scores ({wrong_ids} ids differ without "
               f"the exclusions); {launches} launch(es), {res['segments']} segment(s) a row; "
               f"kernel {res['ms']:.4f} ms (graph {res['graph_ms']:.4f}), plain "
               f"{res['plain_ms']:.4f}, torch.topk {res['library_ms']:.4f}; bound "
               f"{res['bound_ms']:.4f} ms by bytes ({Q * n * 4 / 1e6:.1f} MB), "
               f"{100 * res['bound_ms'] / res['graph_ms']:.1f}% of it")
        if which == "shape":
            row.update(ms=res["ms"], plain_ms=res["plain_ms"], library_ms=res["library_ms"],
                       bound_ms=res["bound_ms"], bound_by="bytes", max_abs_err=0.0)
        row[which] = res
        del scores, plain_scores, got, want, wrong, excl
        torch.cuda.empty_cache()
    return row


def bpr_update_inputs(plays, device, F=BPR_UPDATE_F, seed=8400000001):
    """One chunk of the grouped BPR epoch at the largest class of
    ``grouped_classes(plays)`` (most entries over its chunks): its first
    chunk's liked ids and valid entries, negatives drawn by popularity as
    the epoch draws them (``itemids[r]``), 1% of the valid entries skipped,
    N(0, 0.1^2) tables and user rows, z uniform; with the class's (n, C,
    L) and the rows the chunk touches."""
    import torch

    from implicit_tpu_torch.models import bpr as bpr_mod

    classes = bpr_mod.grouped_classes(plays, device)
    _, idx, dat, _ = max(classes, key=lambda c: c[1].numel())
    n, C, L = idx.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    itemids = torch.as_tensor(plays.indices.astype(np.int64), device=device)
    n_items = plays.shape[1]
    Y = torch.randn((n_items, F), generator=gen, device=device) * 0.1
    yb = torch.randn(n_items, generator=gen, device=device) * 0.1
    x = torch.randn((C, F), generator=gen, device=device) * 0.1
    z = torch.rand((C, L), generator=gen, device=device)
    negids = itemids[torch.randint(0, plays.nnz, (C, L), generator=gen, device=device)]
    keep = (dat[0] != 0) & (torch.rand((C, L), generator=gen, device=device) >= 0.01)
    cidx = idx[0]
    touched = int(torch.cat((cidx[keep], negids[keep])).unique().numel())
    del classes, idx, dat
    return (Y, yb, x, z, cidx, negids, keep), (n, C, L), touched


def phase_bpr_update(device, plays):
    """BPR's grouped item update (``ops/bpr_update.py:bpr_item_update``,
    ``csrc/bpr_item_update.cu``) at the largest class of ``plays`` (phase
    3's last.fm-shaped data; ``bpr_update_inputs``) at F = 128: within the
    float32 bound of every row's sum of a float64 reference
    (``bpr_update.bpr_item_update_reference``), as the four
    ``index_put_(accumulate=True)`` calls it replaces must be too, which
    the same bar must tell from the plain version with one kept entry
    dropped; the same bits twice; ms of
    the whole call (keys, sort, two launches) over ``REPS`` calls and from
    a CUDA graph, the two launches alone from a graph, the bound (each
    entry's key, position and z, x, and the touched rows read and written
    once, over 3.35 TB/s), the plain version and, as the yardstick, the four
    ``index_put_`` calls on prebuilt update rows (``library_ms``) and with
    the arithmetic that builds them (``old_route_ms``); a row of the kernels
    line."""
    import torch

    from implicit_tpu_torch.ops import bpr_update

    lr, reg = 0.01, 0.01
    inputs, (n, C, L), touched = bpr_update_inputs(plays, device)
    Y, yb, x, z, cidx, negids, keep = inputs
    F = BPR_UPDATE_F
    tag = f"bpr_item_update C={C} L={L} F={F} (class of {n} chunks)"
    scale = torch.where(keep, lr, 0.0)
    sz = scale * z
    sreg = (scale * reg)[:, :, None]
    ids = (cidx.reshape(-1), negids.reshape(-1)) * 2

    def run(out):
        bpr_update.bpr_item_update(*out, x, z, cidx, negids, keep, lr, reg)
        return out

    def old_route(out):
        Yu, bl, Yn, bn = out[0][cidx], out[1][cidx], out[0][negids], out[1][negids]
        szx = sz[:, :, None] * x[:, None, :]
        out[0].index_put_((ids[0],), (szx - sreg * Yu).reshape(-1, F), accumulate=True)
        out[0].index_put_((ids[1],), (-szx - sreg * Yn).reshape(-1, F), accumulate=True)
        out[1].index_put_((ids[0],), (scale * (z - reg * bl)).reshape(-1), accumulate=True)
        out[1].index_put_((ids[1],), (scale * (-z - reg * bn)).reshape(-1), accumulate=True)
        return out

    got, again = run([Y.clone(), yb.clone()]), run([Y.clone(), yb.clone()])
    old = old_route([Y.clone(), yb.clone()])
    short = keep.clone().view(-1)
    short[int(torch.nonzero(short)[-1])] = False  # the last kept entry dropped
    wrong = [Y.clone(), yb.clone()]
    bpr_update.bpr_item_update_plain(*wrong, x, z, cidx, negids, short.view(C, L), lr, reg)
    ref = bpr_update.bpr_item_update_reference(Y, yb, x, z, cidx, negids, keep, lr, reg)
    share, old_share, wrong_share = (bpr_update.bound_share(t, ref) for t in (got, old, wrong))
    err, old_err = (max(float((t.double() - r).abs().max() / r.abs().max())
                        for t, r in zip(out, ref[:2])) for out in (got, old))
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, again))
    touched_rows = torch.zeros(Y.shape[0], dtype=torch.bool, device=device)
    touched_rows[torch.cat((cidx[keep], negids[keep]))] = True
    rows_as_old = int(((got[0].view(torch.int32) == old[0].view(torch.int32)).all(1)
                       & touched_rows).sum())
    if not (share <= 1 and old_share <= 1 and same):
        raise AssertionError(f"{tag}: {share:.3g} / {old_share:.3g} of the float32 bound "
                             f"(kernel / four index_put_), same bits twice: {same}")
    if not wrong_share > 1:
        raise AssertionError(f"{tag}: the bar does not tell a dropped entry apart")
    del got, again, old, wrong, ref
    res = {"shape_nCLF": [n, C, L, F], "entries": 2 * C * L, "kept": int(keep.sum()) * 2,
           "touched_rows": touched, "bound_share": share, "index_put_bound_share": old_share,
           "dropped_entry_bound_share": wrong_share, "err_of_scale": err,
           "index_put_err_of_scale": old_err, "rows_as_index_put": rows_as_old}
    out = [Y.clone(), yb.clone()]
    res["ms"] = cuda_ms(lambda: run(out), REPS)
    res["graph_ms"] = cuda_graph_ms(lambda: run(out), REPS)
    keys = torch.where(keep, torch.stack((cidx, negids)), Y.shape[0]).to(torch.int32).view(-1)
    keys, perm = torch.sort(keys, stable=True)
    res["launch_graph_ms"] = cuda_graph_ms(
        lambda: bpr_update._launch(*out, x, z, keys, perm, lr, reg), REPS)
    res["plain_ms"] = cuda_ms(
        lambda: bpr_update.bpr_item_update_plain(*out, x, z, cidx, negids, keep, lr, reg), 10)
    szx = sz[:, :, None] * x[:, None, :]
    rows = ((szx - sreg * out[0][cidx]).reshape(-1, F), (-szx - sreg * out[0][negids])
            .reshape(-1, F), (scale * (z - reg * out[1][cidx])).reshape(-1),
            (scale * (-z - reg * out[1][negids])).reshape(-1))

    def library():
        for table, i, v in zip((out[0], out[0], out[1], out[1]), ids, rows):
            table.index_put_((i,), v, accumulate=True)

    res["library_ms"] = cuda_ms(library, 10)
    res["old_route_ms"] = cuda_ms(lambda: old_route(out), 10)
    del rows, szx
    nbytes = 2 * C * L * (4 + 8) + C * L * 4 + C * F * 4 + 2 * touched * (F + 1) * 4
    res["bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
    say(2, f"{tag}: {res['kept']} of {2 * C * L} entries kept, {touched} rows touched; against "
           f"a float64 sum, {share:.3f} of each element's float32 bound at most ({err:.3e} of "
           f"scale; the four index_put_ {old_share:.3f}, {old_err:.3e}; one kept entry dropped "
           f"{wrong_share:.3g}, rejected), {rows_as_old} of the touched rows bit for bit "
           f"the index_put_ route's, the same bits twice; call {res['ms']:.4f} ms (graph "
           f"{res['graph_ms']:.4f}; the two launches alone {res['launch_graph_ms']:.4f}), plain "
           f"{res['plain_ms']:.4f}, four index_put_ {res['library_ms']:.4f} (with their "
           f"arithmetic {res['old_route_ms']:.4f}); bound {res['bound_ms']:.4f} ms by bytes "
           f"({nbytes / 1e6:.1f} MB), {100 * res['bound_ms'] / res['graph_ms']:.1f}% of it "
           f"({100 * res['bound_ms'] / res['launch_graph_ms']:.1f}% of the launches alone)")
    del inputs, Y, yb, out, keys, perm
    torch.cuda.empty_cache()
    return {"name": "bpr_item_update", "route": "cuda",
            "source": "implicit_tpu_torch/ops/csrc/bpr_item_update.cu",
            "replaces": "none: the grouped BPR epoch's four index_put_(accumulate=True) item "
                        "scatters (models/bpr.py; the JAX package's epoch is plain XLA)",
            "ms": res["ms"], "plain_ms": res["plain_ms"], "library_ms": res["library_ms"],
            "bound_ms": res["bound_ms"], "bound_by": "bytes", "max_abs_err": err, "shape": res}


def expected_launches(csr, factors, compute_dtype, iterations, gather_quant=(False, False),
                      grid="pow2", cg_steps=3):
    """Launches of each kernel entry point the fit's routing asks for: both
    sides, every iteration, one per chunk, and cg_steps + 1 of
    weighted_matvec and of cg_update per chunk where the width (more than
    ``cg_kernels.MAX_FACTORS``) sends every class to the composed CG; a side
    with gather_quant runs the int8 variants."""
    from implicit_tpu_torch.ops import cg_kernels
    from implicit_tpu_torch.ops.als import _full_cg_max_l
    from implicit_tpu_torch.sparse import als_chunk_target, chunk_pieces, length_class_grid

    target = als_chunk_target(factors, compute_dtype)
    max_l = _full_cg_max_l(compute_dtype, factors)
    out = dict.fromkeys(cg_kernels.LAUNCHES, 0)
    for m, quant in ((csr, gather_quant[0]), (csr.T.tocsr(), gather_quant[1])):
        variant = "i8" if quant else ("bf16" if compute_dtype == "bfloat16" else "f32")
        nnz = np.diff(m.indptr)
        Ls, counts = np.unique(length_class_grid(nnz[nnz > 0], 8, grid), return_counts=True)
        for L, count in zip(Ls, counts):
            chunks = sum(p[2] for p in chunk_pieces(int(count), int(L), target, 65536))
            if factors > cg_kernels.MAX_FACTORS:
                out[f"weighted_matvec_{variant}"] += (cg_steps + 1) * chunks * iterations
                out["cg_update"] += (cg_steps + 1) * chunks * iterations
                continue
            kernel = "cg_full" if L <= max_l else "gramian_cg"
            out[f"{kernel}_{variant}"] += chunks * iterations
    return out


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


class SetupSplit(logging.Handler):
    """Collects a fit's set-up steps, (step, seconds) in order, from the
    port's debug lines ``"fit set-up %s in %.4f s"``
    (``implicit_tpu_torch.tracing.timed_step``, which synchronizes the card
    around each step while debug logging is on), an item-item fit's steps
    (``"item-item fit %s in %.4f s"``), and LMF's pool routes."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.steps = []
        self.item_steps = []
        self.routes = []

    def emit(self, record):
        if record.msg.startswith("fit set-up"):
            self.steps.append(record.args)
        elif record.msg.startswith("item-item fit"):
            self.item_steps.append(record.args)
        elif record.msg.startswith("LMF negative pools"):
            self.routes.append(record.getMessage())


@contextlib.contextmanager
def port_debug_log():
    """The port's logger at debug level inside the block, read by a
    SetupSplit."""
    log, split = logging.getLogger("implicit_tpu_torch"), SetupSplit()
    level = log.level
    log.addHandler(split)
    log.setLevel(logging.DEBUG)
    try:
        yield split
    finally:
        log.removeHandler(split)
        log.setLevel(level)


def device_draws():
    """Starting factor tables drawn on the card so far (``ops.pcg64``)."""
    from implicit_tpu_torch import tracing

    return tracing.counters()["init.device_draws"]


def fit_path(tag, plays, device, factors, dtype, gather_quant, iterations=3, phase=3,
             **factory_kwargs):
    """One fit at the full shape, its launches read against the chunks
    routed (and ``pcg64_uniform`` against the two starting tables, which a
    fresh fit from an int seed draws on the card), and its set-up (fit wall
    minus the iterations) split by step. ``factory_kwargs`` go to the
    factory as they are (phase 8's ``use_gpu``)."""
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.ops import cg_kernels

    model = AlternatingLeastSquares(factors=factors, iterations=iterations, random_state=0,
                                    dtype=dtype, gather_quant=gather_quant,
                                    device=device, **factory_kwargs)
    sides = model._gather_quant_sides(*plays.shape)
    want = expected_launches(plays, factors, model._compute_dtype, iterations, sides,
                             cg_steps=model.cg_steps)
    want["pcg64_uniform"] = 2
    times = []
    with port_debug_log() as split:
        cg_kernels.reset_launches()
        draws = device_draws()
        t0 = time.perf_counter()
        model.fit(plays, show_progress=False,
                  callback=lambda it, elapsed, loss: times.append(elapsed))
        wall = time.perf_counter() - t0
        launches = dict(cg_kernels.LAUNCHES, pcg64_uniform=device_draws() - draws)
    for f in (model.user_factors, model.item_factors):
        if not np.isfinite(np.asarray(f, dtype=np.float32)).all():
            raise AssertionError(f"fit {tag}: non-finite factors")
    setup = wall - sum(times)
    say(phase, f"fit {tag}: gather_quant={gather_quant!r} -> (user, item) sides {sides}; "
               f"s/iter {[round(t, 4) for t in times]} (fit wall {wall:.3f} s, "
               f"set-up {setup:.3f} s)")
    say(phase, f"fit {tag}: set-up {setup:.4f} s = fit wall {wall:.4f} - iterations "
               f"{sum(times):.4f}; split (s): "
               + ", ".join(f"{step} {secs:.4f}" for step, secs in split.steps)
               + f"; steps sum {sum(secs for _, secs in split.steps):.4f}")
    say(phase, f"fit {tag}: launches {nonzero(launches)}, chunks routed {nonzero(want)}")
    if launches != want:
        raise AssertionError(f"fit {tag}: launches {launches} != chunks routed {want}")
    return model, sides, times, launches


def pack_differences(got, want, names=("user", "item")):
    """What differs between two (user, item) DeviceBuckets pairs (or two
    lists of them, one per ``names``), on any two devices: plans, empty
    rows, and every class tensor (``torch.equal`` on the CPU, and the
    dtype)."""
    import torch

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())

    out = []
    for side, g, w in zip(names, got, want):
        if (g.shape, g.nnz, g.sentinel) != (w.shape, w.nnz, w.sentinel):
            out.append(f"{side} shape, nnz or sentinel")
        if (g.empty_rows is None) != (w.empty_rows is None) or (
                g.empty_rows is not None and not same(g.empty_rows, w.empty_rows)):
            out.append(f"{side} empty rows")
        if [(c.L, c.C, c.n_chunks, c.n_valid) for c in g.classes] != \
                [(c.L, c.C, c.n_chunks, c.n_valid) for c in w.classes]:
            out.append(f"{side} class layout")
            continue
        for gc, wc in zip(g.classes, w.classes):
            for name in ("rows", "indices", "data", "lengths"):
                if not same(getattr(gc, name), getattr(wc, name)):
                    out.append(f"{side} L={gc.L} C={gc.C} {name}")
    return out


def ingest_check(plays, device):
    """The pack on the card against the same pack on the CPU at the full
    shape, as the f=128 float32 fit packs (``pack_pair_on_device``), on the
    pow2 and fine grids: every tensor equal, with each device's time (the
    card twice, its first call first); a copy of the card's pack with one
    entry of the item side's longest class altered must be told apart."""
    import torch

    from implicit_tpu_torch.sparse import als_chunk_target, pack_pair_on_device

    Cui = plays.astype(np.float32)
    kw = dict(target_entries=als_chunk_target(128, "float32"), max_chunk_rows=65536,
              data_dtype=np.float32)
    for grid in ("pow2", "fine"):
        secs, packs = {}, {}
        for where in (device, "cpu", device):
            name = "card" if where == device else "cpu"
            packs[name], t = synced(lambda: pack_pair_on_device(Cui, grid=grid, device=where,
                                                                **kw))
            secs.setdefault(name, []).append(t)
        differ = pack_differences(packs["card"], packs["cpu"])
        if differ:
            raise AssertionError(f"ingest {grid}: the card's pack differs from the CPU's: "
                                 f"{differ[:8]}")
        head = packs["card"][1].classes[-1]
        head.data[0, 0, 0] += 1.0
        altered = pack_differences(packs["card"], packs["cpu"])
        if altered != [f"item L={head.L} C={head.C} data"]:
            raise AssertionError(f"ingest {grid}: one altered entry gave {altered}")
        entries = [sum(c.n_chunks * c.C * c.L for c in side.classes) for side in packs["cpu"]]
        say(3, f"ingest {grid} grid: card pack == CPU pack, every tensor of "
               f"{sum(len(side.classes) for side in packs['cpu'])} classes (user/item padded "
               f"entries {entries[0]}/{entries[1]}); an altered entry is rejected ({altered[0]}); "
               f"card {', '.join(f'{t:.4f}' for t in secs['card'])} s, CPU "
               f"{secs['cpu'][0]:.4f} s")
        del packs, head
        torch.cuda.empty_cache()


def composed_cg_path(plays, device):
    """One user-side half-iteration of the composed CG on weighted_matvec (the
    sparse term) and cg_update (the dense term and update),
    ``_cg_class(use_pallas=True)``, over every class, for the float32 /
    bfloat16 / int8 tables; each held to the plain CG, with the same
    bfloat16 dequant for int8 (``cg_solve_full_plain`` with scales).

    The factors are drawn from a seed, mixed in sign as ``kernel_case``'s:
    from a fitted model's factors, 3-step float32 CG amplifies summation
    order on a few ill-conditioned rows past any 1e-4 bar, kernel or not
    (PERF.md, section 6)."""
    import torch

    from implicit_tpu_torch.ops import als as als_ops
    from implicit_tpu_torch.ops import cg_kernels
    from implicit_tpu_torch.sparse import BucketedCSR, als_chunk_target

    F = 128
    buckets = BucketedCSR(plays, target_entries=als_chunk_target(F, "float32"),
                          max_chunk_rows=65536, grid="pow2").to_device(device)
    chunks = [c for cls in buckets.classes for c in als_ops._class_chunks(cls)]
    rng = np.random.default_rng(7)
    n_users, n_items = plays.shape
    Y = torch.as_tensor(rng.standard_normal((n_items, F), dtype=np.float32) * 0.1,
                        device=device)
    X0 = torch.as_tensor(rng.standard_normal((n_users, F), dtype=np.float32) * 0.01,
                         device=device)
    yty = als_ops.gramian(Y, 0.01)
    all_launches = {}
    for variant, table in (("f32", Y), ("bf16", Y.to(torch.bfloat16)),
                           ("i8", als_ops._quantize_table(Y, "float32"))):
        q, s = table if isinstance(table, tuple) else (table, None)
        cg_kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = als_ops._cg_class(X0.clone(), table, yty, chunks, 3, use_pallas=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(cg_kernels.LAUNCHES)
        want = als_ops._solve_class(X0.clone(), chunks, lambda x0, idx, dat: (
            cg_kernels.cg_solve_full_plain(q, idx, dat, x0, yty, 3, scales=s)))
        tol = TOL[variant]
        err = float((got - want).abs().max())
        routed = dict.fromkeys(launches, 0)
        routed[f"weighted_matvec_{variant}"] = routed["cg_update"] = (3 + 1) * len(chunks)
        say(3, f"composed CG on weighted_matvec and cg_update, user side, {variant} table: "
               f"{len(chunks)} chunks, {secs:.4f} s; max_abs_err against the plain CG {err:.3e} "
               f"(rtol=atol={tol}, |x| <= {float(want.abs().max()):.3f}); "
               f"launches {nonzero(launches)}")
        if not torch.isfinite(got).all() or not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"composed CG {variant}: disagrees with the plain CG")
        if launches != routed:
            raise AssertionError(f"composed CG {variant}: launches {launches} != {routed}")
        for k, v in nonzero(launches).items():
            all_launches[k] = all_launches.get(k, 0) + v
        del got, want
        torch.cuda.empty_cache()
    return all_launches


def serve_checks(tag, model, plays, phase=3):
    """Batched recommend and similar_items on a fitted model: shapes, finite
    scores, ids in range, no liked item returned, every item its own
    nearest neighbour."""
    users = np.arange(0, plays.shape[0], plays.shape[0] // 1024)[:1024]
    liked = plays[users]
    ids, scores = model.recommend(users, liked, N=10, filter_already_liked_items=True)
    if ids.shape != (1024, 10) or not np.isfinite(scores).all():
        raise AssertionError(f"recommend {tag}: bad result shape {ids.shape} or scores")
    if (ids < 0).any() or (ids >= plays.shape[1]).any():
        raise AssertionError(f"recommend {tag}: id out of range")
    for row, u in enumerate(users):
        if np.isin(ids[row], liked[row].indices).any():
            raise AssertionError(f"recommend {tag}: user {u} got an already-liked item")
    sim_ids, sim_scores = model.similar_items(np.arange(1024), N=10)
    if sim_ids.shape != (1024, 10) or (sim_ids[:, 0] != np.arange(1024)).mean() > 0.01:
        raise AssertionError(f"similar_items {tag}: items are not their own nearest neighbour")
    serve_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.recommend(users, liked, N=10)
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    say(phase, f"recommend 1024 users N=10 filtered ({tag} model): "
           f"ms {[round(t, 2) for t in serve_ms]}")


def lastfm_plays():
    """The last.fm-360k shape (360k users x 160k items, 17.5M nnz) from seed 0."""
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    t0 = time.perf_counter()
    plays = generate_synthetic(360_000, 160_000, 17_500_000, seed=0)
    say(3, f"last.fm-shaped data {plays.shape} nnz={plays.nnz} in "
           f"{time.perf_counter() - t0:.1f} s")
    return plays


def phase_main_path(device, plays):
    import torch

    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    ingest_check(plays, device)
    f32, _, f32_times, launches = fit_path("f=128 float32", plays, device, 128, np.float32,
                                           False)
    add(launches)
    _, _, _, launches = fit_path("f=128 bfloat16", plays, device, 128, np.float16, False)
    add(launches)
    quant, _, _, launches = fit_path("f=128 bfloat16 int8", plays, device, 128, np.float16, True)
    add(launches)
    # F=256: "auto" resolves by the JAX package's rule; the user table (184
    # MB in bf16) is over 100 MiB, the item table (82 MB) under it, so only
    # the item half, which gathers from the user table, runs int8
    for gather_quant in ("auto", False):
        model, sides, _, launches = fit_path(f"f=256 bfloat16 gather_quant={gather_quant}",
                                             plays, device, 256, np.float16, gather_quant)
        if gather_quant == "auto" and sides != (False, True):
            raise AssertionError(f'gather_quant="auto" resolved to {sides}, not (False, True)')
        add(launches)
        del model
    # wider than cg_full and gramian_cg take: every class in the composed CG
    # on weighted_matvec and cg_update
    for tag, factors, dtype in (("f=512 bfloat16", 512, np.float16),
                                ("f=320 float32", 320, np.float32)):
        model, _, _, launches = fit_path(tag, plays, device, factors, dtype, False,
                                         iterations=2)
        add(launches)
        del model
        torch.cuda.empty_cache()
    add(composed_cg_path(plays, device))
    serve_checks("f=128 float32", f32, plays)
    serve_checks("f=128 bfloat16 int8", quant, plays)
    # phases 7 and 9 serve from the f=128 float32 factors, and phase 9 holds
    # its meshed fits to them and to the int8 fit's (host arrays: no device
    # memory is held through phases 4-8)
    factors = (f32.user_factors, f32.item_factors)
    reference = dict(f32_times=f32_times, int8=(quant.user_factors, quant.item_factors))
    del f32, quant
    torch.cuda.empty_cache()
    say(3, f"launches over the main paths {totals}")
    missing = [k for k, v in totals.items() if not v]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    return totals, factors, reference


def phase_quality(device, **kwargs):
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.datasets.stdlib_corpus import get_stdlib_corpus
    from implicit_tpu_torch.evaluation import precision_at_k, train_test_split

    _, _, counts = get_stdlib_corpus()
    train, test = train_test_split(counts, train_percentage=0.8, random_state=42)
    model = AlternatingLeastSquares(factors=64, regularization=0.05, random_state=3,
                                    device=device, **kwargs)
    model.fit(train, show_progress=False)
    p10 = float(precision_at_k(model, train, test, K=10, show_progress=False))
    desc = "".join(f", {k}={getattr(v, '__name__', v)}" for k, v in kwargs.items())
    say(4, f"stdlib corpus {counts.shape}{desc}: p@10 = {p10:.4f} (gate > 0.2)")
    if not p10 > 0.2:
        raise AssertionError(f"p@10 {p10} <= 0.2 ({kwargs})")
    return p10


class EpochProfile:
    """A fit callback's hook that profiles one epoch under ``torch.profiler``:
    it starts after epoch ``at - 1`` ends and stops after epoch ``at`` (the
    fits synchronize the card before their callback)."""

    def __init__(self, at):
        self.at, self.prof, self.wall = at, None, None
        self.overhead = 0.0  # seconds spent starting and stopping the profiler

    def __call__(self, epoch, secs):
        import torch

        t0 = time.perf_counter()
        if epoch == self.at - 1:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        elif epoch == self.at:
            self.prof.stop()
            self.wall = secs
        self.overhead += time.perf_counter() - t0

    def report(self, tag, steady, phase=5):
        """Prints the five kernels with the most device time in the profiled
        epoch, the five aten ops with the most (their kernels included),
        and the device's busy share: kernel time over the profiled epoch's
        wall, and over ``steady``, the unprofiled s/epoch (the profiler's
        own host time slows a launch-bound epoch). Returns the kernel
        seconds, the launches and the busy share of the unprofiled epoch."""
        from torch.autograd import DeviceType

        def device_us(e, self_time):
            name = ("self_" if self_time else "") + "device_time_total"
            old = ("self_" if self_time else "") + "cuda_time_total"
            return getattr(e, name, None) or getattr(e, old, 0.0)

        events = self.prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        ops = sorted((e for e in events if e.key.startswith("aten::")),
                     key=lambda e: -device_us(e, False))[:5]
        out = self._kernel_lines(tag, steady, phase, {
            e.key: (device_us(e, True) * 1e3, e.count) for e in kernels})
        say(phase, f"profile {tag}: top ops (device ms incl. their kernels, calls): " + "; ".join(
            f"{e.key} {device_us(e, False) / 1e3:.2f} ({e.count})" for e in ops))
        return out

    def report_kernels(self, tag, steady, phase):
        """``report``'s kernel lines, summed straight from the profiler's raw
        device events: ``key_averages`` first parses every host op into a
        tree, about 30 s for a sampled BPR epoch's 400k events. Returns what
        ``report`` returns."""
        from torch.autograd import DeviceType

        totals = {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ns, n = totals.get(e.name(), (0, 0))
                totals[e.name()] = (ns + e.end_ns() - e.start_ns(), n + 1)
        return self._kernel_lines(tag, steady, phase, totals)

    def _kernel_lines(self, tag, steady, phase, totals):
        """Prints the profiled epoch's kernel time, launches and busy share
        (kernel time over the profiled epoch's wall, and over ``steady``)
        and the five kernels with the most device time, from ``totals``
        {kernel name: (device ns, launches)}. Returns the kernel seconds,
        the launches and the busy share of the unprofiled epoch."""
        kernel_s = sum(ns for ns, _ in totals.values()) / 1e9
        launches = sum(n for _, n in totals.values())
        say(phase, f"profile {tag}: epoch wall {self.wall:.4f} s with the profiler on, "
                   f"{steady:.4f} s off; kernel time {kernel_s:.4f} s in {launches} "
                   f"launches; busy share {kernel_s / self.wall:.3f} of the profiled epoch, "
                   f"{kernel_s / steady:.3f} of the unprofiled one")
        say(phase, f"profile {tag}: top kernels (device ms, launches): " + "; ".join(
            f"{name[:90]} {ns / 1e6:.2f} ({n})"
            for name, (ns, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])[:5]))
        return dict(kernel_s=kernel_s, launches=launches, busy=kernel_s / steady)


def bpr_fit(tag, plays, device, epoch_mode, iterations, profile_at=None, phase=5, factors=128):
    """BPR f=128 random_state=1 (``bench.py:651-663``) at the full shape:
    per-epoch seconds, correct and skipped; finite factors, the user bias
    column exactly 1.0. ``profile_at`` profiles that epoch; the steady
    s/epoch is the mean of the epochs from the second to the profiled one
    (or the third), exclusive."""
    from implicit_tpu_torch.bpr import BayesianPersonalizedRanking

    stats, prof = [], EpochProfile(profile_at) if profile_at is not None else None

    def callback(epoch, secs, correct, skipped):
        stats.append((secs, correct, skipped))
        if prof:
            prof(epoch, secs)

    model = BayesianPersonalizedRanking(factors=factors, iterations=iterations, random_state=1,
                                        epoch_mode=epoch_mode, device=device)
    with port_debug_log() as split:
        t0 = time.perf_counter()
        model.fit(plays, show_progress=False, callback=callback)
        wall = time.perf_counter() - t0
    if not (np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all()):
        raise AssertionError(f"bpr {tag}: non-finite factors")
    if not (model.user_factors[:, -1] == 1.0).all():
        raise AssertionError(f"bpr {tag}: the user bias column is not 1.0")
    secs = [s for s, _, _ in stats]
    last = min(3 if profile_at is None else profile_at, len(secs))
    steady = float(np.mean(secs[1:last]))
    say(phase, f"bpr {tag}: s/epoch {[round(s, 4) for s in secs]}"
               + (f" (epoch {profile_at + 1} profiled)" if prof else "")
               + f"; epochs 2-{last} mean {steady:.4f} s, {plays.nnz / steady:.0f} samples/s "
               f"(nnz / s/epoch); correct/skipped per epoch {[(c, s) for _, c, s in stats]}; fit "
               f"wall {wall:.3f} s, set-up {wall - sum(secs) - (prof.overhead if prof else 0):.3f} "
               f"s (wall minus epochs and profiler start/stop): "
               + ", ".join(f"{step} {t:.4f}" for step, t in split.steps))
    return model, steady, prof


def lmf_fit(plays, device, iterations, profile_at):
    """LMF f=32 neg_prop=30 random_state=1 (``bench.py:667-668``) at the full
    shape: per-epoch seconds (the pool reshuffle runs at epoch 5), the
    routes (from the model's debug line), finite factors and pinned
    columns; ``profile_at`` profiles that epoch."""
    from implicit_tpu_torch.lmf import LogisticMatrixFactorization

    secs, prof = [], EpochProfile(profile_at)
    model = LogisticMatrixFactorization(factors=32, neg_prop=30, iterations=iterations,
                                        random_state=1, device=device)
    with port_debug_log() as split:
        t0 = time.perf_counter()
        model.fit(plays, show_progress=False,
                  callback=lambda epoch, s: (secs.append(s), prof(epoch, s)))
        wall = time.perf_counter() - t0
    U, V = model.user_factors, model.item_factors
    if not (np.isfinite(U).all() and np.isfinite(V).all()):
        raise AssertionError("lmf: non-finite factors")
    if not ((U[:, -2] == 1.0).all() and (V[:, -1] == 1.0).all()):
        raise AssertionError("lmf: a pinned column is not 1.0")
    timed = secs[:profile_at]
    steady = float(np.mean(timed[1:]))
    say(5, f"lmf f=32 neg_prop=30: {split.routes[0]}; s/epoch {[round(s, 4) for s in secs]} (epoch "
           f"{profile_at + 1} profiled; the reshuffle runs in epoch 5); epochs 2-{len(timed)} "
           f"mean {steady:.4f} s; fit wall {wall:.3f} s, set-up "
           f"{wall - sum(secs) - prof.overhead:.3f} s (wall minus epochs and profiler start/stop): "
           + ", ".join(f"{step} {t:.4f}" for step, t in split.steps))
    return model, steady, prof


def scale_bar(tag, got, want, wrong, tol, what="the dropped chunk"):
    """Each output tensor's max |got - want| against ``tol`` times that
    tensor's scale (max |want|): must hold for ``want`` in every tensor and
    fail for ``wrong`` (``what`` names it) in at least one. Returns the
    largest error and the wrong result's, each over its tensor's scale."""
    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    err = max(rel(g, w) for g, w in zip(got, want))
    wrong_err = max(rel(g, w) for g, w in zip(got, wrong))
    if not err <= tol:
        raise AssertionError(f"{tag}: card and CPU differ by {err:.3e} of scale > {tol}")
    if wrong_err <= tol:
        raise AssertionError(f"{tag}: the bar does not reject {what} "
                             f"({wrong_err:.3e} of scale <= {tol})")
    return err, wrong_err


def drop_chunk(classes, draws, ci):
    """``classes`` and ``draws`` with the first chunk of class ``ci`` left out."""
    first = sum(c[0].shape[0] for c in classes[:ci])
    cut = [(rows[1:], idx[1:], dat[1:], nv[1:]) if k == ci else (rows, idx, dat, nv)
           for k, (rows, idx, dat, nv) in enumerate(classes)]
    return cut, draws[:first] + draws[first + 1:]


def injected_plays():
    """The injected-draw checks' matrix: 3000 x 1500, 92,119 nnz, sorted."""
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    plays = generate_synthetic(3000, 1500, 90_000, seed=5).astype(np.float32)
    plays.sort_indices()
    return plays


def injected_inputs():
    """The injected-draw check's inputs, made on the host from seeds: the
    matrix, one grouped BPR epoch's starting factors and draws, and per LMF
    pool route (glued F=34, split F=130, legacy F=34) the starting rows and
    draws of one class update over the largest user-side class."""
    from types import SimpleNamespace

    from implicit_tpu_torch.models import bpr as bpr_mod
    from implicit_tpu_torch.models import lmf as lmf_mod
    from implicit_tpu_torch.sparse import pack_pair_on_device

    plays = injected_plays()
    rng = np.random.default_rng(6)
    F = 32
    bpr = SimpleNamespace(F=F, lr=0.05, reg=0.01, start=[
        rng.standard_normal(shape, dtype=np.float32) * 0.1
        for shape in ((plays.shape[0], F), (plays.shape[1], F), (plays.shape[1],))])
    host_classes = bpr_mod.grouped_classes(plays, "cpu")
    bpr.draws = [rng.integers(0, plays.nnz, size=idx.shape[1:])
                 for _, idx, _, n in host_classes for _ in n]
    bpr.drop = max(range(len(host_classes)), key=lambda c: host_classes[c][0].shape[0])

    pack = pack_pair_on_device(plays, target_entries=1 << 14, grid="pow2", device="cpu")[0]
    ci = max(range(len(pack.classes)), key=lambda c: pack.classes[c].n_chunks)
    cls = pack.classes[ci]
    lmf = SimpleNamespace(ci=ci, L=cls.L, C=cls.C, n_chunks=cls.n_chunks, neg_prop=3, lr=1.0,
                          reg=0.6, neg_count=min(plays.shape[1], cls.L * 3), cases=[])
    arr = rng.permutation(plays.indices).astype(np.int64)
    lmf.arr = np.concatenate([arr, arr[:lmf.neg_count]])
    G = -(-cls.C // 8)
    for factors, window in ((32, True), (128, True), (32, False)):
        width = factors + 2
        lmf.cases.append(SimpleNamespace(
            width=width, window=window,
            route=("split" if lmf_mod._pool_split(width) else "glued") if window else "legacy",
            X0=rng.standard_normal((plays.shape[0], width), dtype=np.float32) * 0.3,
            Y0=rng.standard_normal((plays.shape[1], width), dtype=np.float32) * 0.3,
            d0=0.5 + rng.random((plays.shape[0], width), dtype=np.float32),
            draws=[rng.integers(0, plays.nnz, size=(G,) if window else (G, lmf.neg_count))
                   for _ in range(cls.n_chunks)]))
    return plays, bpr, lmf


def lmf_injected_update(plays, lmf, case, dev, drop=False):
    """One class update of an ``injected_inputs`` LMF case on ``dev``: the
    updated (X, dss) on the host; ``drop`` leaves the first chunk out."""
    from types import SimpleNamespace

    import torch

    from implicit_tpu_torch.models import lmf as lmf_mod
    from implicit_tpu_torch.sparse import pack_pair_on_device

    c = pack_pair_on_device(plays, target_entries=1 << 14, grid="pow2",
                            device=dev)[0].classes[lmf.ci]
    dev_draws = [torch.as_tensor(d, device=dev) for d in case.draws]
    if drop:  # what _lmf_class_update reads of a class, less its first chunk
        c = SimpleNamespace(rows=c.rows[1:], indices=c.indices[1:], data=c.data[1:],
                            lengths=c.lengths[1:], n_valid=c.n_valid[1:])
        dev_draws = dev_draws[1:]
    X, dss, Y = (torch.as_tensor(a, device=dev).clone() for a in (case.X0, case.d0, case.Y0))
    arr = torch.as_tensor(lmf.arr, device=dev)
    src = lmf_mod._build_pool(Y, arr, lmf_mod._pool_split(case.width)) if case.window else arr
    lmf_mod._lmf_class_update(X, dss, Y, src, c, dev_draws, lmf.lr, lmf.reg, lmf.neg_prop,
                              lmf.neg_count, -2, case.window)
    return X.cpu(), dss.cpu()


def injected_draw_check(device):
    """One grouped BPR epoch and one LMF class update per pool route, with
    draws made on the host (``injected_inputs``), on the card and on the
    CPU, and the same bar must reject the CPU result with one chunk's update
    left out. BPR is held to 1e-5 of each output's scale (the CPU tests' bar
    against the JAX package), the counts exact. LMF to 2e-3 of scale, the
    port's bfloat16 bar (``TOL``): its scores are rounded to bfloat16, and
    where the two devices' float32 logits (sums in other orders) straddle a
    rounding boundary, a score moves by one bfloat16 step (2**-9 relative),
    which moves a row element whose gradient is near 0 by about 1e-3 (an
    H100 run: 8.8e-4 of scale at F=130, over 1e-4; on the CPU alone the same
    case moves as much when the products sum in float64,
    ``scripts/lmf_order_sensitivity.py``)."""
    import torch

    from implicit_tpu_torch.models import bpr as bpr_mod
    from implicit_tpu_torch.ops import membership

    plays, bpr, lmf = injected_inputs()
    cpu = torch.device("cpu")
    pt = membership.build_pair_table(plays)
    iters = int(np.ceil(np.log2(np.diff(plays.indptr).max()))) + 1

    def bpr_epoch(dev, drop=None):
        classes = bpr_mod.grouped_classes(plays, dev)
        dev_draws = [torch.as_tensor(d, device=dev) for d in bpr.draws]
        if drop is not None:
            classes, dev_draws = drop_chunk(classes, dev_draws, drop)
        X, Y, yb = (torch.as_tensor(a, device=dev).clone() for a in bpr.start)
        flat = [torch.as_tensor(a.astype(np.int64), device=dev)
                for a in (plays.indices, plays.indptr)]
        counts = bpr_mod._bpr_epoch_grouped(X, Y, yb, classes, *flat, pt.to_device(dev),
                                            dev_draws, bpr.lr, bpr.reg, True, iters, pt.bits)
        return (X.cpu(), Y.cpu(), yb.cpu()), tuple(int(c) for c in counts)

    got, got_counts = bpr_epoch(device)
    want, want_counts = bpr_epoch(cpu)
    wrong, _ = bpr_epoch(cpu, bpr.drop)
    if got_counts != want_counts:
        raise AssertionError(f"bpr injected draws: counts {got_counts} != {want_counts}")
    err, wrong_err = scale_bar("bpr injected draws", got, want, wrong, 1e-5)
    say(5, f"bpr grouped epoch, draws from the host, {plays.shape} nnz={plays.nnz} F={bpr.F}: "
           f"card vs CPU max err {err:.3e} of scale (X, Y, yb each; bar 1e-5), (correct, "
           f"skipped) {got_counts} on both; a chunk dropped: {wrong_err:.3e}, rejected")

    for case in lmf.cases:
        err, wrong_err = scale_bar(
            f"lmf injected draws {case.route}", lmf_injected_update(plays, lmf, case, device),
            lmf_injected_update(plays, lmf, case, cpu),
            lmf_injected_update(plays, lmf, case, cpu, drop=True), TOL["bf16"])
        say(5, f"lmf class update ({case.route} pool, F={case.width}, L={lmf.L}, "
               f"{lmf.n_chunks} chunks of C={lmf.C}), draws from the host: card vs CPU max err "
               f"{err:.3e} of scale (X, dss each; bar {TOL['bf16']}); a chunk dropped: "
               f"{wrong_err:.3e}, rejected")


def clustered_set():
    """``bench_quality``'s clustered set (``bench.py:404-437``): the matrix
    and its 0.8 train / test split."""
    from implicit_tpu_torch.datasets.synthetic import get_synthetic_clustered
    from implicit_tpu_torch.evaluation import train_test_split

    likes = get_synthetic_clustered(users=3000, items=600, groups=20, likes_per_user=24, seed=7)
    return (likes, *train_test_split(likes, train_percentage=0.8, random_state=19))


def sgd_quality(device, mesh=None, phase=5):
    """p@10 on ``bench_quality``'s clustered set (``bench.py:404-437``): BPR
    factors=63 iterations=200 and LMF factors=30, random_state=42, trained
    over ``mesh`` where one is given; each at least 0.85 (the JAX package
    recorded 0.8708 and 0.8639)."""
    from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
    from implicit_tpu_torch.evaluation import precision_at_k
    from implicit_tpu_torch.lmf import LogisticMatrixFactorization

    likes, train, test = clustered_set()
    out = {}
    for name, model in (
            ("bpr", BayesianPersonalizedRanking(factors=63, iterations=200, random_state=42,
                                                mesh=mesh, device=device)),
            ("lmf", LogisticMatrixFactorization(factors=30, random_state=42, mesh=mesh,
                                                device=device))):
        t0 = time.perf_counter()
        model.fit(train, show_progress=False)
        out[name] = float(precision_at_k(model, train, test, K=10, show_progress=False))
        say(phase, f"clustered set {likes.shape}: {'meshed ' if mesh else ''}{name} p@10 = "
                   f"{out[name]:.4f} (gate >= 0.85), fit {time.perf_counter() - t0:.2f} s")
    low = {k: v for k, v in out.items() if not v >= 0.85}
    if low:
        raise AssertionError(f"clustered p@10 under 0.85: {low}")
    return out


def phase_sgd(device, plays):
    """The SGD families at the last.fm shape: BPR grouped (the same seed
    twice for the same bits) and sampled, LMF, each with one profiled epoch;
    recommend from both; the injected-draw check; clustered p@10. The
    first grouped fit's counters, set to 0 just before it and read just
    after: one ``launches.bpr_item_update`` per ``bpr.chunk_steps`` and no
    ``bpr.scatter_calls`` (its count is the kernels line's)."""
    import torch

    from implicit_tpu_torch.models import bpr
    from implicit_tpu_torch.ops import bpr_update

    bpr_update.LAUNCHES["bpr_item_update"] = 0
    bpr.COUNTS.update(chunk_steps=0, scatter_calls=0)
    grouped, g_s, g_prof = bpr_fit("grouped", plays, device, "grouped", 4, profile_at=3)
    launches, counts = bpr_update.LAUNCHES["bpr_item_update"], dict(bpr.COUNTS)
    if not (launches == counts["chunk_steps"] > 0 and counts["scatter_calls"] == 0):
        raise AssertionError(f"bpr grouped: {launches} bpr_item_update launches, counts {counts}: "
                             f"not one launch a chunk update with no scatter calls")
    say(5, f"bpr grouped: {launches} bpr_item_update launches in {counts['chunk_steps']} chunk "
           f"updates, 0 scatter calls")
    again, _, _ = bpr_fit("grouped, the same seed again", plays, device, "grouped", 4)
    if not (np.array_equal(grouped.user_factors, again.user_factors)
            and np.array_equal(grouped.item_factors, again.item_factors)):
        raise AssertionError("bpr grouped: two fits with the same random_state differ")
    say(5, "bpr grouped: two fits with random_state=1 give the same bits")
    del again
    serve_checks("bpr f=128 grouped", grouped, plays, phase=5)
    del grouped
    g_prof.report("bpr grouped", g_s)
    sampled, s_s, s_prof = bpr_fit("sampled", plays, device, "sampled", 4, profile_at=3)
    del sampled
    s_prof.report("bpr sampled", s_s)
    torch.cuda.empty_cache()

    model, l_s, l_prof = lmf_fit(plays, device, iterations=6, profile_at=5)
    serve_checks("lmf f=32", model, plays, phase=5)
    del model
    l_prof.report("lmf", l_s)
    torch.cuda.empty_cache()

    injected_draw_check(device)
    sgd_quality(device)
    return dict(bpr_grouped=g_s, bpr_sampled=s_s, lmf=l_s, bpr_item_update_launches=launches)


# ---------------------------------------------------------------------------
# phase 6: the item-item family (torch ops and host C++; no kernel)
# ---------------------------------------------------------------------------

# device route against host route (tests/test_knn.py's bar): values within
# KNN_RTOL, neighbour sets equal up to exact ties at the K-th score
KNN_RTOL = 1e-5
# recommend on the card against the host formulation: scores within this
# share of the batch's largest |score|, ids equal up to ties
SERVE_TOL = 1e-9
# EASE's closed form on 64 columns J: the off-diagonal entries of
# (S + lam I) B[:, J] - S[:, J], computed in float64, within EASE_BAR of
# max |lam B[:, J]|; a B solved with lam off by 10% gives 0.1 by construction
EASE_BAR = 1e-2


def knn_disagreement(a, b, rtol):
    """Row by row, two K-sparse similarity CSRs: the largest relative
    difference of their sorted values, and the rows whose neighbour sets
    differ beyond exact ties at the K-th score (a column whose value clears
    the other row's smallest value by more than ``rtol`` missing from it)."""
    err, bad = 0.0, []
    for r in range(a.shape[0]):
        sa, sb = slice(a.indptr[r], a.indptr[r + 1]), slice(b.indptr[r], b.indptr[r + 1])
        va, vb = a.data[sa], b.data[sb]
        if len(va) != len(vb):
            bad.append(r)
            continue
        if not len(va):
            continue
        da, db = np.sort(va)[::-1], np.sort(vb)[::-1]
        err = max(err, float(np.max(np.abs(da - db) / np.abs(db))))
        for cols, vals, other, kth in ((a.indices[sa], va, b.indices[sb], db[-1]),
                                       (b.indices[sb], vb, a.indices[sa], da[-1])):
            clear = cols[vals > kth + rtol * abs(kth)]
            if not np.isin(clear, other).all():
                bad.append(r)
                break
    return err, bad


def knn_routes(ml, device):
    """Step 1: BM25 K=20 weights at the ML-20M shape through the device and
    the host route; their agreement, a gramian missing its last user chunk
    rejected by the same bar, a second device build bit for bit; times and
    what "auto" picks. Returns the BM25 weights and the measured rates."""
    import torch
    from scipy.sparse import csr_matrix

    from implicit_tpu_torch import native
    from implicit_tpu_torch import nearest_neighbours as nn

    weighted = csr_matrix(nn.bm25_weight(ml.T, 1.2, 0.75).T)  # BM25Recommender's defaults
    nn.all_pairs_knn(weighted[:2000], 20, method="device", device=device)  # cuBLAS warm-up
    small = weighted[:1000, :1000]
    t0 = time.perf_counter()
    nn.all_pairs_knn(small, 20, method="device", device=device)
    call_s = time.perf_counter() - t0  # the route's fixed cost: its flops take microseconds

    def device_build():
        with port_debug_log() as split:
            t0 = time.perf_counter()
            sim = nn.all_pairs_knn(weighted, 20, method="device", device=device).tocsr()
            wall = time.perf_counter() - t0
        return sim, wall, dict(split.item_steps)

    dev, dev_s, steps = device_build()
    native.get_lib()  # built (g++) before the host route is timed
    t0 = time.perf_counter()
    host = nn.all_pairs_knn(weighted, 20, method="host").tocsr()
    host_s = time.perf_counter() - t0
    users, items = weighted.shape
    threads = native.knn_effective_threads(items)
    flops = 2.0 * items * items * users
    say(6, f"bm25 K=20 {weighted.shape} nnz={weighted.nnz}: device route {dev_s:.3f} s "
           f"(upload {steps['upload']:.3f} s, gramian {steps['gramian']:.3f} s = "
           f"{flops / steps['gramian'] / 1e12:.2f} TFLOP/s, top-k {steps['top-k']:.3f} s, copy "
           f"back {steps['copy back']:.3f} s), host route {host_s:.3f} s on {threads} threads")
    err, bad = knn_disagreement(dev, host, KNN_RTOL)
    if err > KNN_RTOL or bad:
        raise AssertionError(f"knn device vs host route: values {err:.3e} (bar {KNN_RTOL}), "
                             f"{len(bad)} rows with other neighbours beyond ties: {bad[:5]}")
    ties = int(sum(not np.array_equal(np.sort(dev.indices[dev.indptr[r]:dev.indptr[r + 1]]),
                                      np.sort(host.indices[host.indptr[r]:host.indptr[r + 1]]))
                   for r in range(items)))
    say(6, f"knn device vs host route: values within {err:.3e} (bar {KNN_RTOL}); "
           f"{ties} of {items} rows pick other columns at exact ties of the K-th score")

    # the same bar against a gramian missing its last user chunk
    chunk = max(8, min(users, nn._DEVICE_KNN_DENSE_BYTES // items))
    last = (users - 1) // chunk * chunk
    wrong = nn.all_pairs_knn(weighted[:last], 20, method="device", device=device).tocsr()
    wrong_err, wrong_bad = knn_disagreement(wrong, host, KNN_RTOL)
    if not (wrong_err > KNN_RTOL or wrong_bad):
        raise AssertionError("knn: the route bar does not reject a gramian missing its last "
                             "user chunk")
    say(6, f"knn: a gramian missing its last user chunk ({users - last} users): values "
           f"{wrong_err:.3e}, {len(wrong_bad)} rows with other neighbours; rejected")
    del wrong
    again, again_s, _ = device_build()
    if not all(np.array_equal(getattr(dev, f), getattr(again, f))
               for f in ("indptr", "indices", "data")):
        raise AssertionError("knn: two device builds differ")
    say(6, f"knn: a second device build ({again_s:.3f} s) gives the same bits")

    # the cost rule's rates: the upload alone (pageable, as the route's step
    # copies), the gramian step (no copy in it), the top-k with its copy back
    arrays = (np.diff(weighted.indptr).astype(np.int64), weighted.indices.astype(np.int32),
              weighted.data.astype(np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in arrays:
        torch.as_tensor(a).to(device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    degrees = np.diff(weighted.indptr).astype(np.float64)
    pairs = float(degrees @ degrees)
    saved = native.knn_all_pairs
    native.knn_all_pairs = lambda *args: None  # the blocked scipy fallback
    try:
        part = weighted[: users // 10]
        t0 = time.perf_counter()
        nn._all_pairs_knn_host(part, 20)
        scipy_s = time.perf_counter() - t0
    finally:
        native.knn_all_pairs = saved
    part_deg = np.diff(part.indptr).astype(np.float64)
    rates = {
        "device_call_s": call_s,
        "gramian_flops": flops / steps["gramian"],
        "h2d_bytes_per_s": sum(a.nbytes for a in arrays) / upload_s,
        "topk_elements_per_s": float(items) ** 2 / (steps["top-k"] + steps["copy back"]),
        "host_pairs_per_s_per_thread": pairs / host_s / threads,
        "scipy_pairs_per_s": float(part_deg @ part_deg) / scipy_s,
    }
    auto = nn._device_knn_wins(weighted, device)
    say(6, f"knn auto picks the {'device' if auto else 'host'} route here "
           f"(sum d_u^2 = {pairs:.4g} pair expansions)")
    return weighted, rates, auto, dict(sim=dev, wall=dev_s, gramian=steps["gramian"])


def lastfm_bm25(plays, device):
    """Step 2: bench.py's KNN cell, BM25 K=20 at the last.fm shape (over the
    device item cap: the host route)."""
    from implicit_tpu_torch import native
    from implicit_tpu_torch.nearest_neighbours import BM25Recommender

    model = BM25Recommender(K=20, device=device)
    t0 = time.perf_counter()
    model.fit(plays, show_progress=False)
    wall = time.perf_counter() - t0
    if not model.similarity.nnz or not np.isfinite(model.similarity.data).all():
        raise AssertionError("bm25 last.fm: empty or non-finite similarity")
    say(6, f"bm25 K=20 last.fm shape {plays.shape}: fit {wall:.3f} s on the host route, "
           f"{native.knn_effective_threads(plays.shape[1])} threads, similarity nnz "
           f"{model.similarity.nnz}")


def ease_closed_form(S, B, lam, J):
    """The off-diagonal entries of (S + lam I) B[:, J] - S[:, J] in float64,
    over max |lam B[:, J]|: 0 for exact weights."""
    import torch

    BJ = B[:, J].double()
    R = S.double() @ BJ + lam * BJ - S[:, J].double()
    R[J, torch.arange(len(J), device=R.device)] = 0.0
    return float(R.abs().max() / (lam * BJ).abs().max())


def ease_check(ml, device):
    """Step 3: EASERecommender(K=100) (lam = 250) at the ML-20M shape, its
    steps and peak memory; the closed form on 64 random columns, which must
    reject weights solved with lam off by 10%."""
    import torch

    from implicit_tpu_torch import ease
    from implicit_tpu_torch.nearest_neighbours import _dense_gramian_device

    model = ease.EASERecommender(K=100, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    with port_debug_log() as split:
        t0 = time.perf_counter()
        model.fit(ml, show_progress=False)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    say(6, f"ease K=100 lam=250 {ml.shape}: fit {wall:.3f} s: " + ", ".join(
        f"{step} {secs:.4f}" for step, secs in split.item_steps)
        + f" s; peak device memory {peak / 2**30:.2f} GiB")
    if not np.isfinite(model.similarity.data).all():
        raise AssertionError("ease: non-finite similarity")

    binary = ml.copy()
    binary.data = np.ones_like(binary.data)
    S = _dense_gramian_device(binary, device)  # integer counts: exact in float32
    J = torch.as_tensor(np.random.default_rng(3).choice(ml.shape[1], 64, replace=False),
                        device=device)
    errs = {}
    for lam in (250.0, 275.0):
        B = ease._ease_solve(S.clone(), lam)
        errs[lam] = ease_closed_form(S, B, 250.0, J)
        del B
    del S
    torch.cuda.empty_cache()
    if not errs[250.0] <= EASE_BAR:
        raise AssertionError(f"ease closed form: {errs[250.0]:.3e} > {EASE_BAR}")
    if errs[275.0] <= EASE_BAR:
        raise AssertionError(f"ease closed form: weights with lam=275 pass ({errs[275.0]:.3e})")
    say(6, f"ease closed form on 64 columns: (S + lam I) B[:, J] - S[:, J] off the diagonal "
           f"{errs[250.0]:.3e} of max |lam B[:, J]| (bar {EASE_BAR}); lam off by 10%: "
           f"{errs[275.0]:.3e}, rejected")
    return model, dict(wall=wall, peak=peak)


def serve_item_item(tag, model, plays):
    """Step 4: batched recommend for 1024 users (N=10, liked filtered) on
    the card against the host formulation (a scipy product and the port's
    ``native.topk_rows``); ms per batch."""
    from implicit_tpu_torch.nearest_neighbours import _topk_rows_sorted

    users = np.arange(0, plays.shape[0], plays.shape[0] // 1024)[:1024]
    liked = plays[users]
    serve_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        ids, scores = model.recommend(users, liked, N=10)
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    host = (liked @ model.similarity).tocsr()
    mask = liked.copy()
    mask.data = np.ones_like(mask.data)
    host = (host - host.multiply(mask)).tocsr()
    host.eliminate_zeros()
    want_ids, want = _topk_rows_sorted(host, 10)
    tol = SERVE_TOL * np.abs(want[want_ids >= 0]).max()
    err = float(np.abs(scores - want).max())
    mismatched = [r for r in range(len(users)) if not np.array_equal(ids[r], want_ids[r])]
    beyond = [r for r in mismatched
              if not np.isin(want_ids[r][want[r] > want[r][-1] + tol], ids[r]).all()]
    if err > tol or beyond or (ids < -1).any():
        raise AssertionError(f"recommend {tag}: scores {err:.3e} (bar {tol:.3e}), "
                             f"{len(beyond)} rows with other ids beyond ties")
    say(6, f"recommend 1024 users N=10 filtered ({tag} model): card vs host scores within "
           f"{err:.3e} (bar {tol:.3e}), ids equal but {len(mismatched)} rows at ties; "
           f"ms {[round(t, 2) for t in serve_ms]}")


def item_item_quality(device):
    """Step 5: p@10 on ``bench_quality``'s clustered set: BM25 K=60 and EASE
    K=100 lam=50, each at least 0.85 (the JAX package recorded 0.8656 and
    0.8678, ``BENCH_r03.json``)."""
    from implicit_tpu_torch.datasets.synthetic import get_synthetic_clustered
    from implicit_tpu_torch.ease import EASERecommender
    from implicit_tpu_torch.evaluation import ranking_metrics_at_k, train_test_split
    from implicit_tpu_torch.nearest_neighbours import BM25Recommender

    likes = get_synthetic_clustered(users=3000, items=600, groups=20, likes_per_user=24, seed=7)
    train, test = train_test_split(likes, train_percentage=0.8, random_state=19)
    out = {}
    for name, model, jax_p10 in (
            ("bm25", BM25Recommender(K=60, device=device), 0.8656),
            ("ease", EASERecommender(K=100, regularization=50.0, device=device), 0.8678)):
        model.fit(train, show_progress=False)
        out[name] = float(ranking_metrics_at_k(model, train, test, K=10,
                                               show_progress=False)["precision"])
        say(6, f"clustered set {likes.shape}: {name} p@10 = {out[name]:.4f} (gate >= 0.85; "
               f"the JAX package {jax_p10})")
    low = {k: v for k, v in out.items() if not v >= 0.85}
    if low:
        raise AssertionError(f"clustered p@10 under 0.85: {low}")


def phase_item_item(device, lastfm):
    """Phase 6: the item-item family at the ML-20M shape (the JAX bench's,
    ``generate_synthetic(138_000, 27_000, 12_000_000, seed=1)``) and
    bench.py's last.fm KNN cell; ``lastfm`` is phase 3's data."""
    import torch

    from implicit_tpu_torch.datasets.synthetic import generate_synthetic
    from implicit_tpu_torch.nearest_neighbours import BM25Recommender

    t_phase = time.perf_counter()
    ml = generate_synthetic(138_000, 27_000, 12_000_000, seed=1)
    say(6, f"ML-20M-shaped data {ml.shape} nnz={ml.nnz} in {time.perf_counter() - t_phase:.1f} s")
    weighted, rates, auto, knn = knn_routes(ml, device)
    torch.cuda.empty_cache()
    lastfm_bm25(lastfm, device)
    ease_model, ease_stats = ease_check(ml, device)
    bm25 = BM25Recommender(K=20, device=device)
    t0 = time.perf_counter()
    bm25.fit(ml, show_progress=False)
    say(6, f"bm25 K=20 {ml.shape} fit through auto ({'device' if auto else 'host'} route) "
           f"{time.perf_counter() - t0:.3f} s")
    serve_item_item("bm25 K=20", bm25, ml)
    serve_item_item("ease K=100", ease_model, ml)
    ease_sim = ease_model.similarity
    del bm25, ease_model
    torch.cuda.empty_cache()
    item_item_quality(device)
    say(6, f"cost-rule rates measured here ({gpu_line()}): " + ", ".join(
        f"{k} {v:.4g}" for k, v in rates.items()))
    say(6, f"phase 6 wall {time.perf_counter() - t_phase:.1f} s")
    return dict(ml=ml, weighted=weighted, knn=knn, ease_sim=ease_sim, ease=ease_stats)


# ---------------------------------------------------------------------------
# phase 7: serving beyond the resident table (torch ops on CUDA streams,
# events and pinned memory; no kernel: the JAX package composes this path
# from XLA ops)
# ---------------------------------------------------------------------------

# streamed or pipelined top-k against the resident one: scores within
# TOPK_RTOL relative, ids equal up to exact ties at the k-th score
TOPK_RTOL = 1e-6
# the IVF index probing every cluster against the exact model: scores within
# this share of the row's largest |score| (float32 sums in another order)
IVF_ROW_TOL = 1e-5
# recall@10 of the IVF index on clustered points: the JAX package's bar
# (tests/test_ivf.py)
RECALL_BAR = 0.85
# the streamed catalog: 10M x 128 float32 (5.12 GB), over the 4 GiB
# residency threshold on an 80 GB card
STREAM_ITEMS, STREAM_F = 10_000_000, 128
# the clustered points of the IVF recall gate: 200,000 x 128, 64 groups
CLUSTERED_N = 200_000


def topk_disagreement(got, want, rtol, row_scale=False):
    """Row by row, two (Q, k) top-k results ``(ids, scores)``: the largest
    score difference (relative to each score, or with ``row_scale`` to the
    row's largest |score|), and the rows whose ids differ beyond ties (an id
    scoring above the row's k-th score by more than the tolerance missing
    from the other row)."""
    gi, gs = (np.atleast_2d(np.asarray(a)) for a in got)
    wi, ws = (np.atleast_2d(np.asarray(a)) for a in want)
    if gi.shape != wi.shape:
        return float("inf"), list(range(wi.shape[0]))
    if row_scale:
        scale = np.repeat(np.abs(ws).max(axis=1, keepdims=True), ws.shape[1], axis=1)
    else:
        scale = np.abs(ws)
    scale = np.maximum(scale, np.finfo(np.float32).tiny)
    err = float(np.max(np.abs(gs.astype(np.float64) - ws) / scale)) if ws.size else 0.0
    bad = []
    for r in range(wi.shape[0]):
        for ids, sc, other in ((gi[r], gs[r], wi[r]), (wi[r], ws[r], gi[r])):
            kth = sc[-1]
            clear = ids[sc > kth + rtol * scale[r][-1]]
            if not np.isin(clear, other).all():
                bad.append(r)
                break
    return err, bad


def synced(fn):
    """``fn()`` and its host-clock seconds, the card synchronized before and
    after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bit_differences(got, want):
    """(batch, rows) of two lists of per-batch (ids, scores) that differ."""
    if len(got) != len(want):
        return [("count", len(got), len(want))]
    out = []
    for b, ((gi, gs), (wi, ws)) in enumerate(zip(got, want)):
        rows = np.flatnonzero((np.atleast_2d(gi) != np.atleast_2d(wi)).any(1)
                              | (np.atleast_2d(gs) != np.atleast_2d(ws)).any(1))
        if len(rows):
            out.append((b, rows[:8].tolist()))
    return out


def pipelined_serving(model, plays):
    """Step 1: phase 3's f=128 float32 model, ``recommend_pipelined`` over 64
    batches of 1024 users (N=10, liked filtered, max_in_flight=3) and
    ``similar_items_pipelined`` over 32 batches of 1024 items against a loop
    of the per-batch calls: the same bits; walls in turns (loop, pipelined,
    pipelined, loop) and users (items) per second."""
    users = np.arange(0, plays.shape[0], plays.shape[0] // 65536)[:65536]
    batches = [users[i : i + 1024] for i in range(0, 65536, 1024)]
    items = [np.arange(i, i + 1024) for i in range(0, 32 * 1024, 1024)]
    runs = {
        "recommend": (
            lambda: [model.recommend(b, plays[b], N=10) for b in batches],
            lambda: list(model.recommend_pipelined(((b, plays[b]) for b in batches), N=10,
                                                   max_in_flight=3)), 65536),
        "similar_items": (
            lambda: [model.similar_items(b, N=10) for b in items],
            lambda: list(model.similar_items_pipelined(items, N=10, max_in_flight=3)),
            32 * 1024),
    }
    out = {}
    for name, (loop, pipelined, rows) in runs.items():
        loop()  # warm: the device tables and norms are cached
        walls = {"loop": [], "pipelined": []}
        results = {}
        for which in ("loop", "pipelined", "pipelined", "loop"):
            res, secs = synced(loop if which == "loop" else pipelined)
            walls[which].append(secs)
            results.setdefault(which, res)
        diff = bit_differences(results["pipelined"], results["loop"])
        if diff:
            raise AssertionError(f"{name}_pipelined differs from the per-batch calls: "
                                 f"(batch, rows) {diff[:4]}")
        rate = {k: [rows / s for s in v] for k, v in walls.items()}
        say(7, f"{name}_pipelined, {len(results['loop'])} batches of 1024 (N=10"
               f"{', liked filtered' if name == 'recommend' else ''}, max_in_flight=3): "
               f"the per-batch calls' bits; wall s loop {[round(s, 4) for s in walls['loop']]}"
               f", pipelined {[round(s, 4) for s in walls['pipelined']]}; rows/s loop "
               f"{[round(r) for r in rate['loop']]}, pipelined "
               f"{[round(r) for r in rate['pipelined']]}")
        out[name] = walls
    return out


class PassCounter:
    """Counts ``topk_streaming`` calls through ``models.mf_base`` and the
    blocks they read from the host (``ops.topk._host_block``), inside the
    block only."""

    def __enter__(self):
        from implicit_tpu_torch.models import mf_base
        from implicit_tpu_torch.ops import topk

        self.calls, self.blocks = 0, []
        self._saved = (mf_base.topk_streaming, topk._host_block)
        stream, block = self._saved

        def counted_stream(*a, **kw):
            self.calls += 1
            return stream(*a, **kw)

        def counted_block(items, start, stop, dtype):
            self.blocks.append((start, stop))
            return block(items, start, stop, dtype)

        mf_base.topk_streaming, topk._host_block = counted_stream, counted_block
        return self

    def __exit__(self, *exc):
        from implicit_tpu_torch.models import mf_base
        from implicit_tpu_torch.ops import topk

        mf_base.topk_streaming, topk._host_block = self._saved


def stream_case(device, phase):
    """The streamed catalog and its queries: a 10M x 128 float32 table drawn
    on the card (``torch.Generator`` seed 7) and copied to the host once;
    1024 queries, each liking its own 25 best items and 25 at random;
    ``filter_items`` holds the 26th best of the first 50 queries (their best
    once the liked are out) and 50 at random. Returns (card table, host
    table, queries, liked ids, filter_items, the filter kwargs, the rng)."""
    import torch
    from scipy.sparse import csr_matrix

    from implicit_tpu_torch.models import mf_base
    from implicit_tpu_torch.ops import topk

    gen = torch.Generator(device=device).manual_seed(7)
    table_dev = torch.randn((STREAM_ITEMS, STREAM_F), generator=gen, device=device)
    queries = torch.randn((1024, STREAM_F), generator=gen, device=device).cpu().numpy()
    (table, secs) = synced(lambda: table_dev.cpu().numpy())
    say(phase, f"stream table {table.shape} float32, {table.nbytes / 1e9:.2f} GB, drawn on "
               f"the card, copied to the host in {secs:.2f} s; residency threshold "
               f"{mf_base._stream_threshold_bytes(device) / 2**30:.2f} GiB")
    rng = np.random.default_rng(7)
    best = topk.topk(table_dev, queries, 26)[0]
    liked_cols = np.concatenate([best[:, :25], rng.integers(0, STREAM_ITEMS, (1024, 25))],
                                axis=1)
    liked = csr_matrix((np.ones(liked_cols.size, np.float32),
                        (np.repeat(np.arange(1024), 50), liked_cols.ravel())),
                       shape=(1024, STREAM_ITEMS))
    fi = np.concatenate([best[:50, 25], rng.integers(0, STREAM_ITEMS, 50)])
    return (table_dev, table, queries, liked_cols, fi,
            dict(filter_query_items=liked, filter_items=fi), rng)


def streaming_serving(device):
    """Step 2: a 10M x 128 float32 table (5.12 GB, over the 4 GiB residency
    threshold) drawn on the card and copied to the host once; 1024 queries,
    N=10, 100 ``filter_items`` and 50 liked items each (half of them among
    the query's own best items, so the filters change the answer):
    ``topk_streaming`` against the resident ``topk`` on the card's copy,
    the same bar rejecting the streamed result with its last block dropped;
    an ALS model holding the table serves through ``_StreamTable``, and
    ``recommend_pipelined`` serves 8 batches of 1024 users in one pass."""
    import torch
    from scipy.sparse import csr_matrix

    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.models import mf_base
    from implicit_tpu_torch.ops import topk

    table_dev, table, queries, liked_cols, fi, kw, rng = stream_case(device, 7)
    nbytes = table.nbytes

    topk.topk(table_dev, queries[:8], 10, **kw)  # warm
    resident, res_s = synced(lambda: topk.topk(table_dev, queries, 10, **kw))
    with PassCounter() as count:
        streamed, str_s = synced(
            lambda: topk.topk_streaming(table, queries, 10, device=device, **kw))
    err, bad = topk_disagreement(streamed, resident, TOPK_RTOL)
    if err > TOPK_RTOL or bad:
        raise AssertionError(f"topk_streaming vs resident: scores {err:.3e}, {len(bad)} rows")
    for r in range(1024):
        if np.isin(streamed[0][r], liked_cols[r]).any() or np.isin(streamed[0][r], fi).any():
            raise AssertionError(f"topk_streaming returned a filtered item in row {r}")
    last = max(start for start, _ in count.blocks)
    dropped = topk.topk_streaming(table[:last], queries, 10, device=device, **kw)
    d_err, d_bad = topk_disagreement(dropped, resident, TOPK_RTOL)
    if not (d_err > TOPK_RTOL or d_bad):
        raise AssertionError("the streaming bar passed a result missing its last block")
    say(7, f"topk_streaming 1024 queries N=10 (100 filter_items, 50 liked each) over "
           f"{len(count.blocks)} blocks of {count.blocks[0][1]} rows: resident's ids but at "
           f"ties, scores within {err:.3e} (bar {TOPK_RTOL}); the last block dropped "
           f"({STREAM_ITEMS - last} rows): {len(d_bad)} rows differ, scores {d_err:.3e}: "
           f"rejected; wall resident {res_s:.4f} s (table on the card), streamed "
           f"{str_s:.4f} s, {nbytes / str_s / 1e9:.2f} GB/s of table")
    del table_dev
    torch.cuda.empty_cache()

    model = AlternatingLeastSquares(factors=STREAM_F, device=device)
    model.user_factors = rng.standard_normal((8192, STREAM_F), dtype=np.float32)
    model.item_factors = table
    route = model._prep_recommend_items(None, None, 10)[2]
    if not isinstance(route, mf_base._StreamTable) or model._item_factors_dev is not None:
        raise AssertionError("the ALS model over the 5.12 GB table did not route to streaming")
    user_liked = csr_matrix((np.ones(8192 * 50, np.float32),
                             (np.repeat(np.arange(8192), 50),
                              rng.integers(0, STREAM_ITEMS, 8192 * 50))),
                            shape=(8192, STREAM_ITEMS))
    batches = [np.arange(i, i + 1024) for i in range(0, 8192, 1024)]
    with PassCounter() as count:
        served, pipe_s = synced(lambda: list(model.recommend_pipelined(
            ((b, user_liked[b]) for b in batches), N=10)))
    starts = sorted(start for start, _ in count.blocks)
    if count.calls != 1 or len(starts) != len(set(starts)) or \
            sum(stop - start for start, stop in count.blocks) != STREAM_ITEMS:
        raise AssertionError(f"recommend_pipelined made {count.calls} passes over "
                             f"{len(starts)} blocks, not one pass")
    one, one_s = synced(lambda: model.recommend(batches[0], user_liked[batches[0]], N=10))
    err, bad = topk_disagreement(served[0], one, TOPK_RTOL)
    if err > TOPK_RTOL or bad or model._item_factors_dev is not None:
        raise AssertionError(f"recommend_pipelined's first batch vs recommend: {err:.3e}, "
                             f"{len(bad)} rows")
    say(7, f"ALS over the streamed table: recommend routes to _StreamTable; "
           f"recommend_pipelined 8 batches of 1024 users in {count.calls} pass of "
           f"{len(starts)} blocks, {pipe_s:.4f} s ({8192 / pipe_s:.0f} users/s, "
           f"{nbytes / pipe_s / 1e9:.2f} GB/s); recommend of its first batch alone "
           f"{one_s:.4f} s, the same ids but at ties, scores within {err:.3e}")
    return dict(resident_s=res_s, streamed_s=str_s, pipelined_s=pipe_s)


def clustered_points(n, f, groups, rng):
    """tests/test_ivf.py's clustered points: ``groups`` Gaussian centres (x3)
    with noise 0.3."""
    centers = rng.standard_normal((groups, f)).astype(np.float32) * 3
    pts = centers[rng.integers(0, groups, n)] + rng.standard_normal((n, f)).astype(
        np.float32) * 0.3
    return pts.astype(np.float32)


def ivf_serving(device, plays):
    """Step 3: ``TPUIVFAlternatingLeastSquares(factors=128)`` at the last.fm
    shape (800 clusters, n_probe 100): its fit's kernel launches, the k-means
    build wall, a second build of the same random_state bit for bit, every
    cluster probed against the exact model for 64 users, recall@10 at the
    default probes over 1024 users, ms per 1024 users approximate and exact;
    then recall@10 > 0.85 on 200,000 x 128 clustered points (64 groups)."""
    import torch

    from implicit_tpu_torch.ann.ivf import _IVFIndex
    from implicit_tpu_torch.approximate_als import TPUIVFAlternatingLeastSquares
    from implicit_tpu_torch.ops import cg_kernels

    model = TPUIVFAlternatingLeastSquares(factors=128, random_state=0, device=device)
    cg_kernels.reset_launches()
    _, fit_s = synced(lambda: model.fit(plays, show_progress=False))
    launches = nonzero(cg_kernels.LAUNCHES)
    if not launches.get("cg_full_f32") or not launches.get("gramian_cg_f32"):
        raise AssertionError(f"the IVF model's fit launched {launches}")
    k, probe = model.recommend_index.centroids.shape[0], model._probe
    if (k, probe) != (int(2 * np.sqrt(plays.shape[1])), k // 8):  # 800, 100 at last.fm
        raise AssertionError(f"IVF sized {k} clusters, probe {probe}")
    first = {**model.similar_items_index.to_arrays("sim__"),
             **model.recommend_index.to_arrays("rec__")}
    factors = np.asarray(model.model.item_factors, dtype=np.float32)
    _, build_s = synced(lambda: model._build_indexes(factors))
    second = {**model.similar_items_index.to_arrays("sim__"),
              **model.recommend_index.to_arrays("rec__")}
    if not all(np.array_equal(first[key], second[key]) for key in first):
        raise AssertionError("two IVF builds of one random_state differ")
    say(7, f"IVF ALS f=128 at {plays.shape}: fit (15 iterations + both indexes) {fit_s:.3f} "
           f"s, launches {launches}; k-means build of both indexes ({k} clusters, 15 "
           f"iterations) {build_s:.3f} s; a second build of random_state 0 gives the same "
           f"bits; cap sim {model.similar_items_index.cap}, rec {model.recommend_index.cap}")

    users = np.arange(0, plays.shape[0], plays.shape[0] // 1024)[:1024]
    liked = plays[users]
    model._probe = k
    full, full_s = synced(lambda: model.recommend(users[:64], liked[:64], N=10))
    model._probe = probe
    exact64 = model.model.recommend(users[:64], liked[:64], N=10)
    err, bad = topk_disagreement(full, exact64, IVF_ROW_TOL, row_scale=True)
    if err > IVF_ROW_TOL or bad:
        raise AssertionError(f"IVF probing every cluster vs exact: {err:.3e}, {len(bad)} rows")
    ann_ms, exact_ms = [], []
    for _ in range(3):
        approx, secs = synced(lambda: model.recommend(users, liked, N=10))
        ann_ms.append(secs * 1e3)
        exact, secs = synced(lambda: model.model.recommend(users, liked, N=10))
        exact_ms.append(secs * 1e3)
    recall = np.mean([len(np.intersect1d(a, e)) / 10 for a, e in zip(approx[0], exact[0])])
    say(7, f"IVF recommend: every cluster probed (64 users) gives the exact ids but at ties, "
           f"scores within {err:.3e} of the row's largest (bar {IVF_ROW_TOL}), "
           f"{full_s * 1e3:.1f} ms; n_probe {probe}: recall@10 {recall:.4f} over 1024 users; "
           f"ms per 1024 users approximate {[round(t, 2) for t in ann_ms]}, exact "
           f"{[round(t, 2) for t in exact_ms]}")

    pts = clustered_points(CLUSTERED_N, 128, 64, np.random.default_rng(0))
    unit = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-12)
    n_clusters = int(2 * np.sqrt(len(unit)))
    (index, build_s) = synced(lambda: _IVFIndex(unit, n_clusters, 15, 3, device))
    queries = unit[:1024]
    from implicit_tpu_torch._device import full_f32_matmul

    with full_f32_matmul():
        U = torch.as_tensor(unit, device=device)
        exact_ids = torch.topk(U[:1024] @ U.T, 10, dim=1)[1].cpu().numpy()
    del U
    (ids, _), search_s = synced(lambda: index.search_batch(queries, 10, n_clusters // 8))
    c_recall = np.mean([len(np.intersect1d(a, e)) / 10 for a, e in zip(ids, exact_ids)])
    say(7, f"IVF on clustered points {unit.shape} (64 groups, {n_clusters} clusters, probe "
           f"{n_clusters // 8}): build {build_s:.3f} s, 1024 queries {search_s * 1e3:.1f} ms, "
           f"recall@10 {c_recall:.4f} (gate > {RECALL_BAR})")
    if not c_recall > RECALL_BAR:
        raise AssertionError(f"IVF recall@10 {c_recall} <= {RECALL_BAR}")
    del model, index
    torch.cuda.empty_cache()
    return dict(recall=recall, clustered_recall=c_recall, launches=launches)


def phase_serving(device, plays, factors):
    """Phase 7: serving beyond the resident table. ``factors`` are phase 3's
    f=128 float32 fit's (user, item) factors, ``plays`` its data."""
    from implicit_tpu_torch.als import AlternatingLeastSquares

    t_phase = time.perf_counter()
    model = AlternatingLeastSquares(factors=128, random_state=0, device=device)
    model.user_factors, model.item_factors = factors
    pipelined_serving(model, plays)
    del model
    streaming_serving(device)
    ivf_serving(device, plays)
    say(7, f"phase 7 wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 8: the reference's idioms on the card (the cpu / gpu / tpu alias
# modules and the dataset loaders; no kernel of their own: the alias fit
# launches phase 3's kernels)
# ---------------------------------------------------------------------------

# (alias module, name, module of the port's own object it must be)
ALIASES = [
    ("cpu.als", "AlternatingLeastSquares", "models.als"),
    ("cpu.als", "calculate_loss", "models.als"),
    ("cpu.als", "item_factor", "models.als"),
    ("cpu.als", "least_squares", "models.als"),
    ("cpu.als", "least_squares_cg", "models.als"),
    ("cpu.als", "user_factor", "models.als"),
    ("cpu.als", "user_linear_equation", "models.als"),
    ("cpu._als", "calculate_loss", "models.als"),
    ("cpu._als", "least_squares", "models.als"),
    ("cpu._als", "least_squares_cg", "models.als"),
    ("cpu.bpr", "BayesianPersonalizedRanking", "models.bpr"),
    ("cpu.lmf", "LogisticMatrixFactorization", "models.lmf"),
    ("cpu.matrix_factorization_base", "MatrixFactorizationBase", "models.mf_base"),
    ("gpu.als", "AlternatingLeastSquares", "models.als"),
    ("gpu.bpr", "BayesianPersonalizedRanking", "models.bpr"),
    ("gpu.matrix_factorization_base", "MatrixFactorizationBase", "models.mf_base"),
]


def alias_surface():
    """Step 1: the flags (``gpu.HAS_CUDA`` True on the card, ``tpu.HAS_TPU``
    False, ``tpu.device_count()`` torch's count) and every alias the port's
    own object."""
    import importlib

    import torch

    from implicit_tpu_torch import gpu, tpu

    if gpu.HAS_CUDA is not True or tpu.HAS_TPU is not False:
        raise AssertionError(f"gpu.HAS_CUDA {gpu.HAS_CUDA!r}, tpu.HAS_TPU {tpu.HAS_TPU!r}")
    if tpu.device_count() != torch.cuda.device_count():
        raise AssertionError(f"tpu.device_count() {tpu.device_count()} != "
                             f"torch.cuda.device_count() {torch.cuda.device_count()}")
    for alias, name, home in ALIASES:
        got = getattr(importlib.import_module("implicit_tpu_torch." + alias), name)
        if got is not getattr(importlib.import_module("implicit_tpu_torch." + home), name):
            raise AssertionError(f"implicit_tpu_torch.{alias}.{name} is not the port's "
                                 f"implicit_tpu_torch.{home}.{name}")
    say(8, f"gpu.HAS_CUDA {gpu.HAS_CUDA}, gpu.HAS_TPU {gpu.HAS_TPU}, tpu.HAS_TPU "
           f"{tpu.HAS_TPU}, tpu.device_count() {tpu.device_count()}; {len(ALIASES)} aliases "
           "are the port's own objects")


def alias_fit(device, plays, factors):
    """Step 2: the reference's factory idiom, ``AlternatingLeastSquares(...,
    use_gpu=implicit.gpu.HAS_CUDA)``, at phase 3's f=128 float32 arguments
    on its data: a ``gpu.als.AlternatingLeastSquares`` whose launches are
    the chunks routed (``cg_full`` and ``gramian_cg`` among them) and whose
    factors are phase 3's (``factors``) bit for bit."""
    from implicit_tpu_torch import gpu

    model, _, _, launches = fit_path("f=128 float32 use_gpu=gpu.HAS_CUDA", plays, device, 128,
                                     np.float32, False, phase=8, use_gpu=gpu.HAS_CUDA)
    if type(model) is not gpu.als.AlternatingLeastSquares:
        raise AssertionError(f"the factory gave a {type(model)}, not gpu.als's class")
    idle = [k for k in ("cg_full_f32", "gramian_cg_f32") if not launches.get(k)]
    if idle:
        raise AssertionError(f"alias fit: {idle} never launched")
    for side, got, want in zip(("user", "item"), (model.user_factors, model.item_factors),
                               factors):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            rows = np.flatnonzero((got != want).any(axis=1)) if got.shape == want.shape else []
            raise AssertionError(f"alias fit: {side} factors differ from phase 3's "
                                 f"({len(rows)} rows, first {list(rows[:8])})")
    say(8, "alias fit: user and item factors equal phase 3's f=128 float32 fit's, bit for bit")
    return model


def cpu_topk_check(device, plays, model):
    """Step 3: ``cpu.topk.topk`` on a numpy copy of the item factors (the
    reference's calling convention; the table uploads in the call) against
    ``ops.topk.topk`` on the card's table, 1024 users with their liked items
    as ``filter_query_items`` and 100 ``filter_items``: the same bits;
    walls in turns."""
    import torch

    from implicit_tpu_torch.cpu.topk import topk as cpu_topk
    from implicit_tpu_torch.ops.topk import topk

    users = np.arange(0, plays.shape[0], plays.shape[0] // 1024)[:1024]
    liked = plays[users]
    query = np.ascontiguousarray(model.user_factors[users])
    items = np.array(model.item_factors, dtype=np.float32)
    table = torch.as_tensor(items, device=device)
    kwargs = dict(filter_query_items=liked,
                  filter_items=np.random.default_rng(8).choice(plays.shape[1], 100,
                                                               replace=False))
    walls = {"numpy table": [], "resident table": []}
    for _ in range(3):
        got, secs = synced(lambda: cpu_topk(items, query, 10, device=device, **kwargs))
        walls["numpy table"].append(secs)
        want, secs = synced(lambda: topk(table, query, 10, **kwargs))
        walls["resident table"].append(secs)
        diff = bit_differences([got], [want])
        if diff:
            raise AssertionError(f"cpu.topk.topk differs from ops.topk.topk: {diff}")
    say(8, f"cpu.topk.topk on a numpy {items.shape} float32 table ({items.nbytes / 1e6:.1f} "
           "MB) gives ops.topk.topk's ids and scores on the card's table, bit for bit; "
           "1024 users N=10 filtered, ms in turns: " + "; ".join(
               f"{k} {[round(t * 1e3, 3) for t in v]}" for k, v in walls.items()))


def movielens_round_trip(plays):
    """``plays`` (users x movies) written as a MovieLens-20M dump
    (``ratings.csv``, ``movies.csv``) in a temporary directory, converted by
    ``movielens.generate_dataset`` and read back by ``get_movielens("20m")``
    from the cache there: the CSR must be ``plays``' transpose (shape,
    indptr, indices and data exact) and the titles the dump's. Returns the
    walls (dump, conversion, read) in seconds."""
    import tempfile
    from unittest import mock

    import pandas

    from implicit_tpu_torch.datasets import movielens

    coo = plays.tocoo()
    titles = np.array([f"movie {i}" for i in range(plays.shape[1])], dtype=object)
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(
            os.environ, {"IMPLICIT_DATASETS_PATH": tmp}):
        raw = os.path.join(tmp, "ml-20m")
        os.makedirs(raw)
        t0 = time.perf_counter()
        pandas.DataFrame({"userId": coo.row, "movieId": coo.col, "rating": coo.data,
                          "timestamp": np.zeros(coo.nnz, np.int64)}).to_csv(
            os.path.join(raw, "ratings.csv"), index=False)
        pandas.DataFrame({"movieId": np.arange(plays.shape[1]), "title": titles,
                          "genres": "Drama"}).to_csv(os.path.join(raw, "movies.csv"), index=False)
        t1 = time.perf_counter()
        movielens.generate_dataset(raw, "20m", tmp)
        t2 = time.perf_counter()
        got_titles, got = movielens.get_movielens("20m")
        t3 = time.perf_counter()
    want = plays.T.tocsr()
    bad = [k for k in ("indptr", "indices", "data")
           if got.shape != want.shape or not np.array_equal(getattr(got, k), getattr(want, k))]
    if bad or not np.array_equal(got_titles, titles):
        raise AssertionError(f"MovieLens round trip: {bad or ['titles']} differ "
                             f"(shape {got.shape}, want {want.shape})")
    walls = (t1 - t0, t2 - t1, t3 - t2)
    say(8, f"MovieLens-20M round trip of a {plays.shape} matrix, nnz {plays.nnz}: "
           f"dump {walls[0]:.3f} s, generate_dataset {walls[1]:.3f} s, get_movielens "
           f"{walls[2]:.3f} s; the CSR is the source's transpose, exactly")
    return walls


def loader_checks(ml_shape=(138_000, 27_000, 12_000_000)):
    """Step 4: ``get_stdlib_corpus()`` against the committed npz; with
    ``IMPLICIT_DATASETS_PATH`` at an empty directory the probes find nothing
    and nothing is fetched; where h5py and pandas import, phase 6's ML-20M
    shape (``ml_shape``, seed 1) through :func:`movielens_round_trip`."""
    import importlib.util
    import tempfile
    from unittest import mock

    from implicit_tpu_torch.datasets import _download, movielens
    from implicit_tpu_torch.datasets.stdlib_corpus import get_stdlib_corpus

    t0 = time.perf_counter()
    files, tokens, counts = get_stdlib_corpus()
    t_read = time.perf_counter() - t0
    with np.load(CORPUS, allow_pickle=False) as f:
        same = (np.array_equal(files, f["files"]) and np.array_equal(tokens, f["tokens"])
                and counts.shape == tuple(f["shape"])
                and all(np.array_equal(getattr(counts, k), f[k])
                        for k in ("data", "indices", "indptr")))
    if not same:
        raise AssertionError("get_stdlib_corpus() differs from the committed npz")
    with tempfile.TemporaryDirectory() as cache, mock.patch.dict(
            os.environ, {"IMPLICIT_DATASETS_PATH": cache}):
        t0 = time.perf_counter()
        found = (movielens.probe_movielens("20m"), _download.probe_cached("lastfm_360k.hdf5"))
        t_probe = time.perf_counter() - t0
        if found != (None, None) or os.listdir(cache):
            raise AssertionError(f"probes in an empty cache found {found}, "
                                 f"cache holds {os.listdir(cache)}")
    say(8, f"get_stdlib_corpus() {counts.shape} nnz {counts.nnz} in {t_read * 1e3:.3f} ms "
           "equals the committed npz; in an empty IMPLICIT_DATASETS_PATH "
           f"probe_movielens('20m') and probe_cached return None in {t_probe * 1e3:.3f} ms "
           "and nothing is fetched")
    missing = [m for m in ("h5py", "pandas") if importlib.util.find_spec(m) is None]
    if missing:
        say(8, f"{' and '.join(missing)} not importable on this machine: no MovieLens "
               "conversion here (tests/test_torch_datasets.py converts every loader on the CPU)")
        return None
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    return movielens_round_trip(generate_synthetic(*ml_shape, seed=1))


def phase_idioms(device, plays, factors):
    """Phase 8: the reference's idioms on the card. ``factors`` are phase 3's
    f=128 float32 fit's (user, item) factors, ``plays`` its data."""
    import torch

    t_phase = time.perf_counter()
    alias_surface()
    model = alias_fit(device, plays, factors)
    cpu_topk_check(device, plays, model)
    del model
    torch.cuda.empty_cache()
    loader_checks()
    say(8, f"phase 8 wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: the meshed paths (parallel/) on a virtual mesh of MESH_D shards on
# the one card: every shard launches the kernels as one device routes them
# ---------------------------------------------------------------------------

MESH_D = 4
# meshed fit (f=128 float32, 3 iterations) against phase 3's unmeshed fit:
# the largest factor difference over the table's largest |factor|. The
# gramian is a sum of MESH_D per-shard gramians and the chunks hold other
# rows, so the fits differ by float32 rounding, which 3-step CG grows on a
# few ill-conditioned rows: the first run on the card read 1.474e-02
# (NVIDIA H100 80GB HBM3, 700.00 W), with the losses 4.6e-08 apart; the bar
# is set from it (1e-3 did not hold)
MESH_FACTOR_BAR = 5e-2
# and the larger over both tables of |got - want|_F / |want|_F, which a few
# rows cannot dominate: the first run on the card read 4.838e-04, and a fit
# whose last shard skipped its last solve 4.877e-02
MESH_FROB_BAR = 5e-3
# training loss of both fits, relative
MESH_LOSS_RTOL = 1e-3
# recommend ids for 1024 users: share of positions that agree. The first
# run on the card read 0.9963 (adjacent near-tie swaps; the same card),
# under tests/test_parallel.py:115-137's 0.999; the gate is the JAX
# package's looser one of tests/test_parallel.py:183
MESH_AGREE = 0.99
# the sharded loss against the single-device bucketed loss on the same factors
MESH_SAME_LOSS_RTOL = 1e-5
# bfloat16 meshed fits against the unmeshed ones: 5% of the factors' scale
# (phase 2's bfloat16 bar on fits, ROADMAP C5)
MESH_BF16_BAR = 0.05


def mesh_launches(csr, n_shards, factors, compute_dtype, iterations, gather_quant,
                  grid="pow2", cg_steps=3):
    """Launches per kernel entry point a meshed fit's routing asks for,
    counted from the layout's rule alone: rows dealt to shard u % D; each
    class cut into the pieces of its largest shard's row count; a chunk
    launches where it holds a row of its shard (all-sentinel chunks are
    skipped); the kernel by L as ``expected_launches``."""
    from implicit_tpu_torch.ops import cg_kernels
    from implicit_tpu_torch.ops.als import _full_cg_max_l
    from implicit_tpu_torch.sparse import als_chunk_target, chunk_pieces, length_class_grid

    target = als_chunk_target(factors, compute_dtype)
    max_l = _full_cg_max_l(compute_dtype, factors)
    out = dict.fromkeys(cg_kernels.LAUNCHES, 0)
    for m, quant in ((csr, gather_quant[0]), (csr.T.tocsr(), gather_quant[1])):
        variant = "i8" if quant else ("bf16" if compute_dtype == "bfloat16" else "f32")
        nnz = np.diff(m.indptr)
        rows = np.flatnonzero(nnz > 0)
        L_per_row = length_class_grid(nnz[rows], 8, grid)
        for L in np.unique(L_per_row):
            in_class = rows[L_per_row == L]
            counts = np.bincount(in_class % n_shards, minlength=n_shards)
            chunks = 0
            for start, stop, n_chunks, C in chunk_pieces(int(counts.max()), int(L), target,
                                                         65536):
                here = np.clip(np.minimum(stop, counts) - start, 0, None)
                chunks += int((-(-here // C)).sum())
            if factors > cg_kernels.MAX_FACTORS:
                out[f"weighted_matvec_{variant}"] += (cg_steps + 1) * chunks * iterations
                out["cg_update"] += (cg_steps + 1) * chunks * iterations
                continue
            kernel = "cg_full" if L <= max_l else "gramian_cg"
            out[f"{kernel}_{variant}"] += chunks * iterations
    return out


def mesh_fit(tag, plays, device, mesh, factors, dtype, gather_quant, iterations=3):
    """A meshed fit through the factory at the full shape: launches against
    the chunks routed per shard, s/iter, and the set-up by step."""
    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.ops import cg_kernels

    model = AlternatingLeastSquares(factors=factors, iterations=iterations, random_state=0,
                                    dtype=dtype, gather_quant=gather_quant, mesh=mesh,
                                    device=device)
    sides = model._gather_quant_sides(*plays.shape)
    want = mesh_launches(plays, mesh.size, factors, model._compute_dtype, iterations, sides,
                         cg_steps=model.cg_steps)
    want["pcg64_uniform"] = 2  # both starting tables, on the mesh's first device
    times = []
    with port_debug_log() as split:
        cg_kernels.reset_launches()
        draws = device_draws()
        t0 = time.perf_counter()
        model.fit(plays, show_progress=False,
                  callback=lambda it, elapsed, loss: times.append(elapsed))
        wall = time.perf_counter() - t0
        launches = dict(cg_kernels.LAUNCHES, pcg64_uniform=device_draws() - draws)
    for f in (model.user_factors, model.item_factors):
        if not np.isfinite(np.asarray(f, dtype=np.float32)).all():
            raise AssertionError(f"meshed fit {tag}: non-finite factors")
    setup = wall - sum(times)
    say(9, f"meshed fit {tag}: D={mesh.size}, s/iter {[round(t, 4) for t in times]}; set-up "
           f"{setup:.4f} s = fit wall {wall:.4f} - iterations {sum(times):.4f}; split (s): "
           + ", ".join(f"{step} {secs:.4f}" for step, secs in split.steps)
           + f"; steps sum {sum(secs for _, secs in split.steps):.4f}")
    say(9, f"meshed fit {tag}: launches {nonzero(launches)}, chunks routed over the shards "
           f"{nonzero(want)}")
    if launches != want:
        raise AssertionError(f"meshed fit {tag}: launches {launches} != chunks routed {want}")
    return model, times, launches


def factor_gap(got, want):
    """The larger over the user and item tables of max |got - want| over the
    table's largest |want|."""
    return max(float(np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32)).max())
               / float(np.abs(np.asarray(w, np.float32)).max()) for g, w in zip(got, want))


def served_users(plays):
    users = np.arange(0, plays.shape[0], plays.shape[0] // 1024)[:1024]
    return users, plays[users]


def fit_against(tag, model, want, plays, user_sh, mesh, bar, resident):
    """The meshed model's factors against the unmeshed ``want``: the factor
    gap, both training losses (the sharded loss on ``user_sh``) and the
    recommend ids of 1024 users (``resident`` serves ``want``). Returns the
    checks out of their bar."""
    from implicit_tpu_torch.parallel import als_sharded

    got = (model.user_factors, model.item_factors)
    gap = factor_gap(got, want)
    frob = max(float(np.linalg.norm(np.asarray(g, np.float32) - w) / np.linalg.norm(w))
               for g, w in zip(got, want))
    wide = sum(int((np.abs(np.asarray(g, np.float32) - w).max(1)
                    > 1e-3 * np.abs(w).max()).sum()) for g, w in zip(got, want))
    losses = []
    for uf, itf in (got, want):
        X, Y = (als_sharded.shard_rows(np.asarray(t, np.float32), mesh,
                                       als_sharded._block(t.shape[0], mesh.size))
                for t in (uf, itf))
        losses.append(als_sharded.calculate_loss(user_sh, X, Y, 0.01, mesh))
    loss_gap = abs(losses[0] - losses[1]) / abs(losses[1])
    users, liked = served_users(plays)
    ids = model.recommend(users, liked, N=10)[0]
    agree = float((ids == resident.recommend(users, liked, N=10)[0]).mean())
    failed = [name for name, ok in (("factors", gap <= bar and frob <= MESH_FROB_BAR),
                                    ("loss", loss_gap <= MESH_LOSS_RTOL),
                                    ("recommend", agree > MESH_AGREE)) if not ok]
    say(9, f"{tag}: factors {gap:.3e} of scale (bar {bar}), Frobenius {frob:.3e} (bar "
           f"{MESH_FROB_BAR}), {wide} rows over 1e-3 of scale; loss {losses[0]:.6f} vs "
           f"{losses[1]:.6f} ({loss_gap:.3e}, bar {MESH_LOSS_RTOL}), recommend ids agree in "
           f"{agree:.4f} of positions (gate > {MESH_AGREE}); failed: {failed or 'none'}")
    return failed


def mesh_pack_check(plays, device, mesh):
    """Step 1: ``RowShardedBuckets`` on the card's mesh against the same
    layout on a CPU mesh of as many shards, both sides, as the f=128 float32
    meshed fit packs (pow2): every tensor of every shard ``torch.equal``
    with the same dtype, an altered entry of the last shard rejected; both
    seconds. Returns the user side's pack on the card (the loss checks read
    it)."""
    import torch

    from implicit_tpu_torch.parallel import RowShardedBuckets, create_mesh
    from implicit_tpu_torch.sparse import als_chunk_target

    Cui = plays.astype(np.float32)
    (Ciu, t_s) = synced(lambda: Cui.T.tocsr())
    kw = dict(target_entries=als_chunk_target(128, "float32"), max_chunk_rows=65536,
              grid="pow2")
    names = [f"shard {k}" for k in range(mesh.size)]
    cpu_mesh = create_mesh(mesh.size, "cpu")
    keep = None
    for side, csr in (("user", Cui), ("item", Ciu)):
        dev, dev_s = synced(lambda: RowShardedBuckets(csr, mesh, **kw))
        host, host_s = synced(lambda: RowShardedBuckets(csr, cpu_mesh, **kw))
        differ = pack_differences(dev.shards, host.shards, names)
        if differ:
            raise AssertionError(f"sharded pack {side}: the card's layout differs from the "
                                 f"CPU's: {differ[:8]}")
        cls = dev.shards[-1].classes[-1]
        saved = cls.data.clone()
        cls.data[0, 0, 0] += 1.0
        altered = pack_differences(dev.shards, host.shards, names)
        cls.data = saved
        if altered != [f"shard {mesh.size - 1} L={cls.L} C={cls.C} data"]:
            raise AssertionError(f"sharded pack {side}: one altered entry gave {altered}")
        chunks = sum(c.n_chunks for sh in dev.shards for c in sh.classes)
        say(9, f"sharded pack {side} side (D={mesh.size}, pow2): card == CPU, "
               f"every tensor of {len(dev.shards[0].classes)} classes x {mesh.size} shards "
               f"({chunks} chunks); an altered entry is rejected ({altered[0]}); card "
               f"{dev_s:.4f} s, CPU {host_s:.4f} s" + (f"; transpose {t_s:.4f} s"
                                                         if side == "item" else ""))
        if side == "user":
            keep = dev
        del dev, host
        torch.cuda.empty_cache()
    return keep


class SkipLastShardSolve:
    """Inside the block, the last call of ``ops.als._solve_side_core`` (the
    last shard's item half of the last iteration) returns its X unsolved."""

    def __init__(self, total_calls):
        self.total, self.calls = total_calls, 0

    def __enter__(self):
        from implicit_tpu_torch.ops import als as als_ops

        self.saved = core = als_ops._solve_side_core

        def skipping(X, *args, **kw):
            self.calls += 1
            return X if self.calls == self.total else core(X, *args, **kw)

        als_ops._solve_side_core = skipping
        return self

    def __exit__(self, *exc):
        from implicit_tpu_torch.ops import als as als_ops

        als_ops._solve_side_core = self.saved


def mesh_fits(device, plays, f32_factors, phase3, mesh, add):
    """Steps 1-4: the sharded pack; the sharded loss on phase 3's factors
    against the single device's; the meshed fits against the unmeshed ones
    (f=128 float32 D=MESH_D, a fit whose last shard skipped its last solve
    rejected; D=1 bit for bit; f=128 bfloat16 int8; f=512 bfloat16)."""
    import torch

    from implicit_tpu_torch.als import AlternatingLeastSquares
    from implicit_tpu_torch.ops import als as als_ops
    from implicit_tpu_torch.parallel import als_sharded, virtual_mesh
    from implicit_tpu_torch.sparse import BucketedCSR

    user_sh = mesh_pack_check(plays, device, mesh)
    resident = AlternatingLeastSquares(factors=128, device=device)
    resident.user_factors, resident.item_factors = f32_factors

    X, Y = (torch.as_tensor(f, device=device) for f in f32_factors)
    single_loss = als_ops.calculate_loss_bucketed(
        BucketedCSR(plays.astype(np.float32), grid="pow2").to_device(device), X, Y, 0.01)
    mesh_loss = als_sharded.calculate_loss(
        user_sh, als_sharded.shard_rows(X, mesh, user_sh.block),
        als_sharded.shard_rows(Y, mesh, als_sharded._block(Y.shape[0], mesh.size)), 0.01, mesh)
    gap = abs(mesh_loss - single_loss) / abs(single_loss)
    say(9, f"sharded loss on phase 3's f=128 float32 factors {mesh_loss:.8f}, the single "
           f"device's {single_loss:.8f}: {gap:.3e} apart (bar {MESH_SAME_LOSS_RTOL})")
    if gap > MESH_SAME_LOSS_RTOL:
        raise AssertionError(f"sharded loss {mesh_loss} vs the single device's {single_loss}")
    del X, Y

    model, times, launches = mesh_fit("f=128 float32", plays, device, mesh, 128, np.float32,
                                      False)
    add(launches)
    say(9, f"s/iter meshed (D={mesh.size} on one card) {[round(t, 4) for t in times]}, "
           f"phase 3's unmeshed {[round(t, 4) for t in phase3['f32_times']]}")
    failed = fit_against("f=128 float32 meshed vs phase 3's fit", model, f32_factors, plays,
                         user_sh, mesh, MESH_FACTOR_BAR, resident)
    if failed:
        raise AssertionError(f"meshed fit f=128 float32 vs unmeshed: {failed} out of bar")
    del model
    with SkipLastShardSolve(2 * mesh.size * 3) as skip:
        wrong = AlternatingLeastSquares(factors=128, iterations=3, random_state=0, mesh=mesh,
                                        device=device)
        wrong.fit(plays, show_progress=False)
    if skip.calls != 2 * mesh.size * 3:
        raise AssertionError(f"the meshed fit made {skip.calls} shard solves, not "
                             f"{2 * mesh.size * 3}")
    failed = fit_against("f=128 float32 meshed, the last shard's last solve skipped", wrong,
                         f32_factors, plays, user_sh, mesh, MESH_FACTOR_BAR, resident)
    if not failed:
        raise AssertionError("the meshed-fit bar passed a fit whose last shard skipped its "
                             "last solve")
    del wrong, user_sh
    torch.cuda.empty_cache()

    one, _, launches = mesh_fit("f=128 float32 D=1", plays, device, virtual_mesh(1, device),
                                128, np.float32, False)
    add(launches)
    same = [np.array_equal(a, b) for a, b in zip((one.user_factors, one.item_factors),
                                                  f32_factors)]
    say(9, f"D=1 mesh against no mesh, f=128 float32: user / item factors equal bit for bit: "
           f"{same} (the same layout, chunks, column ids and one gramian without a sum)")
    if not all(same):
        raise AssertionError("a D=1 meshed fit differs from the unmeshed fit")
    del one

    quant, _, launches = mesh_fit("f=128 bfloat16 int8", plays, device, mesh, 128, np.float16,
                                  True)
    add(launches)
    gap = factor_gap((quant.user_factors, quant.item_factors), phase3["int8"])
    say(9, f"f=128 bfloat16 int8 meshed vs phase 3's unmeshed: {gap:.3e} of scale "
           f"(bar {MESH_BF16_BAR})")
    if gap > MESH_BF16_BAR:
        raise AssertionError(f"meshed bfloat16 int8 fit {gap} of scale from the unmeshed")
    del quant
    torch.cuda.empty_cache()
    wide, _, _, launches = fit_path("f=512 bfloat16 1 iteration (unmeshed reference)", plays,
                                    device, 512, np.float16, False, iterations=1, phase=9)
    add(launches)
    wide_m, _, launches = mesh_fit("f=512 bfloat16", plays, device, mesh, 512, np.float16,
                                   False, iterations=1)
    add(launches)
    gap = factor_gap((wide_m.user_factors, wide_m.item_factors),
                     (wide.user_factors, wide.item_factors))
    say(9, f"f=512 bfloat16 meshed vs unmeshed, 1 iteration: {gap:.3e} of scale "
           f"(bar {MESH_BF16_BAR})")
    if gap > MESH_BF16_BAR:
        raise AssertionError(f"meshed f=512 bfloat16 fit {gap} of scale from the unmeshed")
    del wide, wide_m
    torch.cuda.empty_cache()


def merge_without(table, skip, queries, liked, k=10):
    """The item-sharded top-k of ``queries`` (liked items filtered) with
    shard ``skip``'s candidates left out of the merge: each other shard's
    own top-k (``ops.topk.topk`` on the shard alone, its liked columns
    sliced), merged on the host."""
    from implicit_tpu_torch.ops import topk

    n_local = table.shards[0].shape[0]
    ids, scores = [], []
    for s, shard in enumerate(table.shards):
        if s == skip:
            continue
        i, v = topk.topk(shard, queries, k, filter_query_items=liked[:, s * n_local:
                                                                     (s + 1) * n_local])
        ids.append(np.where(i >= 0, i + s * n_local, -1))
        scores.append(v)
    ids, scores = np.concatenate(ids, axis=1), np.concatenate(scores, axis=1)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(ids, order, 1), np.take_along_axis(scores, order, 1)


def mesh_serving(device, plays, f32_factors, mesh):
    """Step 5: phase 3's f=128 float32 factors served through the mesh
    against the resident single-device calls: ``recommend`` for 1024 users
    (N=10, liked filtered), ``similar_items`` for 1024 items and
    ``recommend_pipelined`` over 8 x 1024 users; ids equal up to ties at
    the 10th score, scores within TOPK_RTOL relative; the same bar rejects
    the merge without the candidates of the shard that holds most of the
    resident answers (with power-law popularity, the first: the last shard
    holds the tail, and a merge without it is printed too); walls."""
    import torch

    from implicit_tpu_torch.als import AlternatingLeastSquares

    model = AlternatingLeastSquares(factors=128, mesh=mesh, device=device)
    resident = AlternatingLeastSquares(factors=128, device=device)
    for m in (model, resident):
        m.user_factors, m.item_factors = f32_factors
    users, liked = served_users(plays)
    items = np.arange(1024)
    calls = {
        "recommend 1024 users N=10 liked filtered": lambda m: m.recommend(users, liked, N=10),
        "similar_items 1024 items N=10": lambda m: m.similar_items(items, N=10),
    }
    wants = {}
    for name, call in calls.items():
        call(model), call(resident)  # warm: the shards, tables and norms are cached
        walls = {"mesh": [], "resident": []}
        for which in ("mesh", "resident", "resident", "mesh"):
            out, secs = synced(lambda: call(model if which == "mesh" else resident))
            walls[which].append(secs * 1e3)
            (wants if which == "resident" else {}).setdefault(name, out)
            got = out if which == "mesh" else None
            if got is not None and name in wants:
                err, bad = topk_disagreement(got, wants[name], TOPK_RTOL)
                if err > TOPK_RTOL or bad:
                    raise AssertionError(f"meshed {name}: scores {err:.3e}, {len(bad)} rows")
        say(9, f"meshed {name}: the resident call's ids but at ties, scores within "
               f"{err:.3e} (bar {TOPK_RTOL}); ms mesh {[round(t, 2) for t in walls['mesh']]}, "
               f"resident {[round(t, 2) for t in walls['resident']]}")

    step = plays.shape[0] // 8192
    batches = [np.arange(i, i + 1024 * step, step) for i in range(0, 8192 * step, 1024 * step)]
    got, mesh_s = synced(lambda: list(model.recommend_pipelined(
        ((b, plays[b]) for b in batches), N=10)))
    want, res_s = synced(lambda: [resident.recommend(b, plays[b], N=10) for b in batches])
    for b, (g, w) in enumerate(zip(got, want)):
        err, bad = topk_disagreement(g, w, TOPK_RTOL)
        if err > TOPK_RTOL or bad:
            raise AssertionError(f"meshed recommend_pipelined batch {b}: {err:.3e}, "
                                 f"{len(bad)} rows")
    say(9, f"meshed recommend_pipelined 8 x 1024 users (N=10, liked filtered): the resident "
           f"per-batch calls' ids but at ties; wall mesh pipelined {mesh_s:.4f} s, resident "
           f"loop {res_s:.4f} s")

    table = model._factors_on_mesh("item", mesh)
    want = wants["recommend 1024 users N=10 liked filtered"]
    n_local = table.shards[0].shape[0]
    held = np.bincount(want[0].ravel() // n_local, minlength=mesh.size)
    for skip in dict.fromkeys((mesh.size - 1, int(held.argmax()))):
        d_err, d_bad = topk_disagreement(
            merge_without(table, skip, f32_factors[0][users], liked), want, TOPK_RTOL)
        say(9, f"the merge without shard {skip}'s candidates (items {skip * n_local}-"
               f"{(skip + 1) * n_local - 1}, which hold {held[skip]} of the resident answers): "
               f"{len(d_bad)} rows differ, scores {d_err:.3e}")
    if not (d_err > TOPK_RTOL or d_bad):
        raise AssertionError(f"the meshed serving bar passed a merge without shard {skip}")
    del model, resident, table
    torch.cuda.empty_cache()


def mesh_streaming(device, mesh):
    """Step 6: ``topk_streaming(..., mesh=)`` on phase 7's 10M x 128 table:
    each block cut over the shards; against the resident top-k on the
    card's copy at phase 7's bar, the same bar rejecting the result with
    the last shard slice dropped; walls."""
    import torch

    from implicit_tpu_torch.ops import topk

    table_dev, table, queries, liked_cols, fi, kw, _ = stream_case(device, 9)
    topk.topk(table_dev, queries[:8], 10, **kw)  # warm
    resident, res_s = synced(lambda: topk.topk(table_dev, queries, 10, **kw))
    del table_dev
    torch.cuda.empty_cache()
    with PassCounter() as count:
        streamed, str_s = synced(lambda: topk.topk_streaming(table, queries, 10, mesh=mesh,
                                                             **kw))
    err, bad = topk_disagreement(streamed, resident, TOPK_RTOL)
    if err > TOPK_RTOL or bad:
        raise AssertionError(f"meshed topk_streaming vs resident: {err:.3e}, {len(bad)} rows")
    for r in range(1024):
        if np.isin(streamed[0][r], liked_cols[r]).any() or np.isin(streamed[0][r], fi).any():
            raise AssertionError(f"meshed topk_streaming returned a filtered item in row {r}")
    last = max(start for start, _ in count.blocks)
    dropped = topk.topk_streaming(table[:last], queries, 10, mesh=mesh, **kw)
    d_err, d_bad = topk_disagreement(dropped, resident, TOPK_RTOL)
    if not (d_err > TOPK_RTOL or d_bad):
        raise AssertionError("the meshed streaming bar passed a result missing its last slice")
    say(9, f"meshed topk_streaming 1024 queries N=10 (D={mesh.size}, {len(count.blocks)} "
           f"shard slices of up to {max(b - a for a, b in count.blocks)} rows): the resident "
           f"ids but at ties, scores within {err:.3e} (bar {TOPK_RTOL}); the last slice "
           f"dropped ({STREAM_ITEMS - last} rows): {len(d_bad)} rows differ, scores "
           f"{d_err:.3e}: rejected; wall resident {res_s:.4f} s, streamed {str_s:.4f} s, "
           f"{table.nbytes / str_s / 1e9:.2f} GB/s of table")


def phase_mesh(device, plays, f32_factors, phase3):
    """Phase 9: the meshed paths on ``virtual_mesh(MESH_D, device)``, MESH_D
    shards on the one card. ``f32_factors`` and ``phase3`` are phase 3's.
    Returns the kernel launches of its fits."""
    from implicit_tpu_torch.parallel import virtual_mesh

    t_phase = time.perf_counter()
    mesh = virtual_mesh(MESH_D, device)
    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    mesh_fits(device, plays, f32_factors, phase3, mesh, add)
    mesh_serving(device, plays, f32_factors, mesh)
    mesh_streaming(device, mesh)
    say(9, f"launches over the meshed fits {nonzero(totals)}")
    say(9, f"phase 9 wall {time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# phase 10: the meshed SGD and item-item fits (models/bpr.py, models/lmf.py,
# nearest_neighbours.py and ease.py with mesh=) on a virtual mesh of MESH_D
# shards on the one card; torch ops, no kernel of their own
# ---------------------------------------------------------------------------

# the meshed EASE similarity against phase 6's unmeshed one: each row's sorted
# values relative to each other (the column solves against the identity and
# cholesky_inverse round differently); neighbours equal up to ties at the
# K-th score within the same share
MESH_EASE_RTOL = 1e-3


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def mesh_bpr_epoch_check(plays, device, mesh, factors=128, steps=None, seed=11):
    """Step 1a: one meshed sampled BPR epoch (``_bpr_epoch_sharded``) fed
    draws made on the host, against ``_bpr_epoch`` fed their concatenation,
    bit for bit (the same ops on the same values), counts equal; the same
    bar must reject the epoch with the last shard's draws left out (D - 1
    shards). ``steps`` cuts the epoch (default: the fit's, nnz over the
    batch). Returns the meshed and the single-device epoch's seconds."""
    import torch

    from implicit_tpu_torch.models import bpr as bpr_mod
    from implicit_tpu_torch.ops import membership
    from implicit_tpu_torch.parallel import virtual_mesh

    device = torch.device(device)
    users, items = plays.shape
    nnz, D = plays.nnz, mesh.size
    batch = int(min(bpr_mod._MAX_BATCH, max(64, 1 << int(np.ceil(np.log2(max(nnz // 64, 1)))))))
    steps = steps or max(1, -(-nnz // batch))
    local = -(-batch // D)
    rng = np.random.default_rng(seed)
    start = [rng.standard_normal(shape, dtype=np.float32) * 0.1
             for shape in ((users, factors), (items, factors), (items,))]
    draws = torch.as_tensor(rng.integers(0, nnz, size=(steps, D, 2, local))).to(device)
    userids = np.repeat(np.arange(users, dtype=np.int64), np.diff(plays.indptr))
    pt = membership.build_pair_table(plays, row_ids=userids)
    table = None if pt is None else pt.to_device(device)
    flats = tuple(torch.as_tensor(a.astype(np.int64), device=device)
                  for a in (userids, plays.indices, plays.indptr)) + (table,)
    kw = dict(lr=0.05, reg=0.01, verify_neg=True, bits=None if pt is None else pt.bits,
              bisect_iters=int(np.ceil(np.log2(max(np.diff(plays.indptr).max(), 2)))) + 1)

    def meshed(m):
        rep = tuple(torch.as_tensor(a, device=device).clone() for a in start)
        shard_draws = ([(draws[st, k, 0], draws[st, k, 1]) for k in range(m.size)]
                       for st in range(steps))
        _sync(device)
        t0 = time.perf_counter()
        counts = bpr_mod._bpr_epoch_sharded({device: rep}, {device: flats}, shard_draws,
                                            mesh=m, **kw)
        counts = tuple(int(c) for c in counts)
        return rep, counts, time.perf_counter() - t0

    got, got_counts, mesh_s = meshed(mesh)
    want = tuple(torch.as_tensor(a, device=device).clone() for a in start)
    _sync(device)
    t0 = time.perf_counter()
    counts = bpr_mod._bpr_epoch(*want, *flats, (
        (draws[st, :, 0].reshape(-1), draws[st, :, 1].reshape(-1)) for st in range(steps)),
        **kw)
    want_counts = tuple(int(c) for c in counts)
    single_s = time.perf_counter() - t0
    same = got_counts == want_counts and all(torch.equal(g, w) for g, w in zip(got, want))
    wrong, wrong_counts, _ = meshed(virtual_mesh(D - 1, device))
    wrong_same = wrong_counts == want_counts and all(torch.equal(g, w)
                                                     for g, w in zip(wrong, want))
    if not same:
        raise AssertionError(f"bpr meshed epoch: not the concatenated epoch's bits (counts "
                             f"{got_counts} vs {want_counts})")
    if wrong_same:
        raise AssertionError("bpr meshed epoch: the bar passes the epoch without the last "
                             "shard's draws")
    say(10, f"bpr meshed epoch, draws from the host ({plays.shape} nnz={nnz} F={factors}, "
            f"D={D}, batch {batch} = {D} x local_batch {local}, {steps} steps): the "
            f"concatenated single-device epoch's bits, (correct, skipped) {got_counts}; the "
            f"last shard's draws left out: {'the same bits' if wrong_same else 'other bits'}, "
            f"counts {wrong_counts}: rejected; {mesh_s:.3f} s meshed, {single_s:.3f} s on one "
            f"device")
    return mesh_s, single_s


def mesh_bpr_fits(plays, device, mesh, sampled_s):
    """Steps 1b-1d: BPR f=128 on ``virtual_mesh(1)`` against the unmeshed
    sampled fit (1 epoch), bit for bit; two fits of one seed on ``mesh``
    (2 epochs), the same bits, s/epoch beside phase 5's sampled epoch
    (``sampled_s``) and the set-up by step; meshed ``recommend`` for 1024
    users against the resident call at phase 9's bar. Returns the meshed
    s/epoch."""
    from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
    from implicit_tpu_torch.parallel import virtual_mesh

    kw = dict(factors=128, random_state=1, device=device)
    one, plain = (BayesianPersonalizedRanking(iterations=1, mesh=m, epoch_mode="sampled", **kw)
                  for m in (virtual_mesh(1, device), None))
    for m in (one, plain):
        m.fit(plays, show_progress=False)
    if not (np.array_equal(one.user_factors, plain.user_factors)
            and np.array_equal(one.item_factors, plain.item_factors)):
        raise AssertionError("bpr: a mesh of one shard differs from the unmeshed sampled fit")
    say(10, "bpr f=128 on virtual_mesh(1) vs the unmeshed sampled fit (1 epoch): the same bits")
    del one

    fits = []
    for k in (1, 2):
        secs = []
        model = BayesianPersonalizedRanking(iterations=2, mesh=mesh, **kw)
        with port_debug_log() as split:
            t0 = time.perf_counter()
            model.fit(plays, show_progress=False,
                      callback=lambda epoch, s, correct, skipped: secs.append((s, correct,
                                                                               skipped)))
            wall = time.perf_counter() - t0
        fits.append(model)
        say(10, f"bpr f=128 meshed (D={mesh.size}, fit {k}): s/epoch "
                f"{[round(s, 4) for s, _, _ in secs]}, correct/skipped per epoch "
                f"{[(c, sk) for _, c, sk in secs]} (phase 5's unmeshed sampled epoch "
                f"{sampled_s:.4f} s); fit wall {wall:.3f} s, set-up "
                f"{wall - sum(s for s, _, _ in secs):.3f} s: "
                + ", ".join(f"{step} {t:.4f}" for step, t in split.steps))
    a, b = fits
    if not (np.array_equal(a.user_factors, b.user_factors)
            and np.array_equal(a.item_factors, b.item_factors)):
        raise AssertionError("bpr meshed: two fits with the same random_state differ")
    if not (np.isfinite(a.user_factors).all() and (a.user_factors[:, -1] == 1.0).all()):
        raise AssertionError("bpr meshed: non-finite factors or a user bias column not 1.0")
    say(10, "bpr meshed: two fits with random_state=1 give the same bits")
    mesh_recommend("bpr f=128 meshed", a, plays)
    return float(np.mean([sec for sec, _, _ in secs]))


def mesh_recommend(tag, model, plays):
    """A meshed model's ``recommend`` for 1024 users (N=10, liked filtered)
    against the same factors served resident, at phase 9's bar; both
    walls."""
    resident = type(model)(factors=model.factors, device=model.device)
    resident.user_factors, resident.item_factors = model.user_factors, model.item_factors
    users, liked = served_users(plays)
    out, walls = {}, {}
    for which, m in (("mesh", model), ("resident", resident)) * 2:  # round 1 warms the caches
        _sync(model.device)
        t0 = time.perf_counter()
        out[which] = m.recommend(users, liked, N=10)  # host arrays: the call has ended
        walls[which] = time.perf_counter() - t0
    err, bad = topk_disagreement(out["mesh"], out["resident"], TOPK_RTOL)
    if err > TOPK_RTOL or bad:
        raise AssertionError(f"{tag} recommend: scores {err:.3e}, {len(bad)} rows")
    say(10, f"{tag} recommend 1024 users N=10 liked filtered: the resident call's ids but at "
            f"ties, scores within {err:.3e} (bar {TOPK_RTOL}); ms mesh "
            f"{walls['mesh'] * 1e3:.2f}, resident {walls['resident'] * 1e3:.2f}")


def mesh_lmf_arrangements(plays, device, mesh, iterations=5, factors=32, neg_prop=30, seed=1):
    """Step 2a: LMF over ``mesh`` for ``iterations`` epochs (the re-shuffle
    at epoch 5): every pool's arrangement, as the card reads it, against a
    host replay of numpy's stream (the factor draws, the shuffles, the
    re-shuffle of the unpadded cores), bit for bit. Returns the model, its
    mean s/epoch over epochs 2-4 (no re-shuffle) and the re-shuffle
    epoch's seconds."""
    import torch

    from implicit_tpu_torch.lmf import LogisticMatrixFactorization
    from implicit_tpu_torch.models import lmf as lmf_mod
    from implicit_tpu_torch.sparse import BucketedCSR
    from implicit_tpu_torch.utils import check_random_state

    ui = plays.astype(np.float32).tocsr()
    ui.sort_indices()
    iu = ui.T.tocsr()
    iu.sort_indices()
    users, items = ui.shape
    target = max(1 << 14, (768 << 20) // (max(1, neg_prop) * 12))
    pmax = [max((min(n, c.L * neg_prop) for c in BucketedCSR(m, target_entries=target,
                                                             grid="pow2").classes), default=1)
            for m, n in ((ui, items), (iu, users))]
    rs = check_random_state(seed)
    rs.standard_normal(size=(items, factors + 2), dtype=np.float32)
    rs.standard_normal(size=(users, factors + 2), dtype=np.float32)
    first = [lmf_mod._arrangement(rs, m.indices, p, True) for m, p in zip((ui, iu), pmax)]
    rs.integers(0, 2**31)
    cores = [a[:ui.nnz].copy() for a in first]
    later = []
    for core, p in zip(cores, pmax):
        rs.shuffle(core)
        later.append(lmf_mod._wrap_pad(core, p))
    expected = [torch.as_tensor(a.astype(np.int64), device=device)
                for epoch in range(iterations)
                for a in (first if epoch < lmf_mod._POOL_RESHUFFLE_EPOCHS else later)]
    seen = []
    build = lmf_mod._build_pool

    def spy(Y, arr, split):
        seen.append(len(seen) < len(expected) and torch.equal(arr, expected[len(seen)]))
        return build(Y, arr, split)

    secs = []
    model = LogisticMatrixFactorization(factors=factors, neg_prop=neg_prop,
                                        iterations=iterations, random_state=seed, mesh=mesh,
                                        device=device)
    lmf_mod._build_pool = spy
    try:
        with port_debug_log() as split:
            t0 = time.perf_counter()
            model.fit(plays, show_progress=False, callback=lambda epoch, s: secs.append(s))
            wall = time.perf_counter() - t0
    finally:
        lmf_mod._build_pool = build
    del expected
    if len(seen) != 2 * iterations or not all(seen):
        raise AssertionError(f"lmf meshed: arrangements read {seen} against the host replay")
    if not split.routes or "window" not in split.routes[0]:
        raise AssertionError(f"lmf meshed: no window pools ({split.routes})")
    U, V = model.user_factors, model.item_factors
    if not (np.isfinite(U).all() and (U[:, -2] == 1.0).all() and (V[:, -1] == 1.0).all()):
        raise AssertionError("lmf meshed: non-finite factors or a pinned column not 1.0")
    say(10, f"lmf f={factors} neg_prop={neg_prop} meshed (D={mesh.size}), {iterations} epochs: "
            f"{split.routes[0]}; all {len(seen)} pools read the host replay's arrangements "
            f"(the re-shuffle in epoch {lmf_mod._POOL_RESHUFFLE_EPOCHS + 1}), bit for bit; "
            f"s/epoch {[round(s, 4) for s in secs]} (the numpy re-shuffle of both cores and "
            f"their upload in epoch {lmf_mod._POOL_RESHUFFLE_EPOCHS + 1}); fit wall {wall:.3f} s, "
            f"set-up {wall - sum(secs):.3f} s: "
            + ", ".join(f"{st} {t:.4f}" for st, t in split.steps))
    steady = secs[1:lmf_mod._POOL_RESHUFFLE_EPOCHS] or secs
    return model, float(np.mean(steady)), secs[lmf_mod._POOL_RESHUFFLE_EPOCHS:][:1]


def mesh_lmf_update_check(device, D, plays=None, seed=6, factors=32, neg_prop=3):
    """Step 2b: one meshed LMF class update (glued pool) of the class with
    the most chunks, with draws made on the host, on ``device`` and on the
    CPU, each over ``virtual_mesh(D)``, at phase 5's LMF bar (2e-3 of
    scale); the same bar must reject the CPU result with the last shard's
    slice of every chunk left unwritten. Returns the error and the wrong
    result's."""
    import torch

    from implicit_tpu_torch.datasets.synthetic import generate_synthetic
    from implicit_tpu_torch.models import lmf as lmf_mod
    from implicit_tpu_torch.parallel import shard_buckets, virtual_mesh
    from implicit_tpu_torch.sparse import BucketedCSR

    if plays is None:
        plays = generate_synthetic(3000, 1500, 90_000, seed=5).astype(np.float32)
    plays.sort_indices()
    bucketed = BucketedCSR(plays, target_entries=1 << 14, grid="pow2")
    rng = np.random.default_rng(seed)
    users, items = plays.shape
    width = factors + 2
    X0, Y0 = (rng.standard_normal((n, width), dtype=np.float32) * 0.3 for n in (users, items))
    d0 = 0.5 + rng.random((users, width), dtype=np.float32)
    ci = max(range(len(bucketed.classes)), key=lambda c: bucketed.classes[c].n_chunks)
    host_cls = shard_buckets(bucketed, virtual_mesh(D, "cpu")).classes[ci]
    neg_count = min(items, host_cls.L * neg_prop)
    arr = rng.permutation(plays.indices).astype(np.int64)
    arr = np.concatenate([arr, arr[:neg_count]])
    G = -(-host_cls.C // 8)
    draws = rng.integers(0, plays.nnz, size=(host_cls.n_chunks, D, G))

    def run(dev, drop_last=False):
        mesh = virtual_mesh(D, dev)
        dev = mesh.devices[0]
        cls = shard_buckets(bucketed, mesh).classes[ci]
        X, dss, Y = (torch.as_tensor(a, device=dev).clone() for a in (X0, d0, Y0))
        real = lmf_mod._real_positions(cls, mesh, users)
        if drop_last:  # the positions of the last shard's slice left unwritten
            real = [{d: p[p < (D - 1) * cls.C] for d, p in r.items()} for r in real]
        lmf_mod._lmf_class_update_sharded(
            {dev: (X, dss, Y)},
            {dev: lmf_mod._build_pool(Y, torch.as_tensor(arr, device=dev), False)}, cls,
            [[torch.as_tensor(x, device=dev) for x in chunk] for chunk in draws], 1.0, 0.6,
            neg_prop, neg_count, -2, mesh, real, True)
        return X.cpu(), dss.cpu()

    err, wrong_err = scale_bar("lmf meshed injected draws", run(device), run("cpu"),
                               run("cpu", drop_last=True), TOL["bf16"],
                               what="the update missing the last shard's slice")
    say(10, f"lmf meshed class update (glued pool, F={width}, L={host_cls.L}, "
            f"{host_cls.n_chunks} chunks of {D} x {host_cls.C} rows), draws from the host: "
            f"card vs CPU max err {err:.3e} of scale (X, dss each; bar {TOL['bf16']}); the last "
            f"shard's slice unwritten: {wrong_err:.3e}, rejected")
    return err, wrong_err


class DropLastRowBlock:
    """A stand-in for ``nearest_neighbours._dense_gramian_meshed`` that
    zeroes the last shard's row block of the gramian it returns: what the
    meshed route bar must reject."""

    def __init__(self, nn):
        self.nn, self.build = nn, nn._dense_gramian_meshed

    def __enter__(self):
        def build(user_items, mesh):
            S, block = self.build(user_items, mesh)
            S[-1].zero_()
            return S, block

        self.nn._dense_gramian_meshed = build
        return self

    def __exit__(self, *exc):
        self.nn._dense_gramian_meshed = self.build


def mesh_knn_check(weighted, want, device, mesh, K=20):
    """Step 4: BM25 K=20 weights through the device route over ``mesh``
    against ``want``, the unmeshed device route's similarity, at phase 6's
    route bar (values within 1e-5, neighbours equal up to ties at the K-th
    score); the same bar must reject a meshed gramian missing its last
    shard's row block; a second build gives the same bits. Returns the
    first build's wall and gramian seconds."""
    from implicit_tpu_torch import nearest_neighbours as nn

    def build():
        with port_debug_log() as split:
            _sync(device)
            t0 = time.perf_counter()
            sim = nn.all_pairs_knn(weighted, K, method="device", mesh=mesh,
                                   device=device).tocsr()
            wall = time.perf_counter() - t0
        return sim, wall, dict(split.item_steps)

    sim, wall, steps = build()
    err, bad = knn_disagreement(sim, want, KNN_RTOL)
    if err > KNN_RTOL or bad:
        raise AssertionError(f"knn meshed vs unmeshed device route: values {err:.3e} (bar "
                             f"{KNN_RTOL}), {len(bad)} rows with other neighbours: {bad[:5]}")
    with DropLastRowBlock(nn):
        wrong = nn.all_pairs_knn(weighted, K, method="device", mesh=mesh, device=device).tocsr()
    wrong_err, wrong_bad = knn_disagreement(wrong, want, KNN_RTOL)
    if not (wrong_err > KNN_RTOL or wrong_bad):
        raise AssertionError("knn meshed: the route bar passes a gramian missing its last "
                             "shard's row block")
    again, again_s, _ = build()
    if not all(np.array_equal(getattr(sim, f), getattr(again, f))
               for f in ("indptr", "indices", "data")):
        raise AssertionError("knn meshed: two builds differ")
    users, items = weighted.shape
    say(10, f"bm25 K={K} meshed device route {weighted.shape} nnz={weighted.nnz} (D={mesh.size}, "
            f"row blocks of {-(-items // mesh.size)}): values within {err:.3e} of the unmeshed "
            f"route's (bar {KNN_RTOL}), neighbours equal but at ties; the last row block "
            f"missing: {len(wrong_bad)} rows with other neighbours, rejected; a second build "
            f"({again_s:.3f} s) the same bits")
    return wall, steps


def mesh_ease_closed_form(binary, device, mesh, lam=250.0, n_cols=64):
    """Step 5a: ``ease_weights(mesh=)`` checked by phase 6's closed form on
    ``n_cols`` random columns; weights solved with lam off by 10% must
    fail. Returns both residuals."""
    import torch

    from implicit_tpu_torch import ease
    from implicit_tpu_torch.nearest_neighbours import _dense_gramian_device

    items = binary.shape[1]
    S = _dense_gramian_device(binary, device)  # integer counts: exact in float32
    J = torch.as_tensor(np.random.default_rng(3).choice(items, min(n_cols, items), replace=False),
                        device=device)
    errs = {}
    for used in (lam, 1.1 * lam):
        B = ease.ease_weights(binary, used, mesh=mesh, device=device)
        errs[used] = ease_closed_form(S, B, lam, J)
        del B
    del S
    ok, off = errs[lam], errs[1.1 * lam]
    if not ok <= EASE_BAR:
        raise AssertionError(f"ease meshed closed form: {ok:.3e} > {EASE_BAR}")
    if off <= EASE_BAR:
        raise AssertionError(f"ease meshed closed form: weights with lam off by 10% pass "
                             f"({off:.3e})")
    say(10, f"ease meshed (D={mesh.size}) closed form on {len(J)} columns: {ok:.3e} of max "
            f"|lam B[:, J]| (bar {EASE_BAR}); lam off by 10%: {off:.3e}, rejected")
    return ok, off


def mesh_ease_fit(ml, device, mesh, want, phase6):
    """Step 5b: ``EASERecommender(K=100, mesh=)`` at the ML-20M shape: its
    steps and peak device memory, and its similarity against phase 6's
    unmeshed one (``want``): neighbour ids equal up to ties, values within
    MESH_EASE_RTOL."""
    import torch

    from implicit_tpu_torch import ease

    model = ease.EASERecommender(K=100, mesh=mesh, device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    with port_debug_log() as split:
        t0 = time.perf_counter()
        model.fit(ml, show_progress=False)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    err, bad = knn_disagreement(model.similarity, want, MESH_EASE_RTOL)
    say(10, f"ease K=100 lam=250 meshed (D={mesh.size}) {ml.shape}: fit {wall:.3f} s "
            f"(phase 6 unmeshed {phase6['wall']:.3f} s): " + ", ".join(
                f"{step} {secs:.4f}" for step, secs in split.item_steps)
            + f" s; peak device memory {peak / 2**30:.2f} GiB (phase 6 "
              f"{phase6['peak'] / 2**30:.2f}); against the unmeshed similarity: values within "
              f"{err:.3e} (bar {MESH_EASE_RTOL}), {len(bad)} rows with other neighbours beyond "
              f"ties")
    if err > MESH_EASE_RTOL or bad:
        raise AssertionError(f"ease meshed vs unmeshed: values {err:.3e}, {len(bad)} rows "
                             f"{bad[:5]}")


def phase_mesh_fits(device, plays, sgd, item_item):
    """Phase 10: the meshed BPR, LMF, BM25 and EASE fits on
    ``virtual_mesh(MESH_D, device)``. ``plays`` is phase 3's data, ``sgd``
    phase 5's s/epoch, ``item_item`` phase 6's matrix and results."""
    import torch

    from implicit_tpu_torch.parallel import virtual_mesh

    t_phase = time.perf_counter()
    mesh = virtual_mesh(MESH_D, device)

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say(10, f"step {name}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        return out

    step("bpr epoch, draws from the host", mesh_bpr_epoch_check, plays, device, mesh)
    bpr_s = step("bpr fits", mesh_bpr_fits, plays, device, mesh, sgd["bpr_sampled"])
    model, lmf_s, reshuffle_s = step("lmf arrangements", mesh_lmf_arrangements, plays, device,
                                     mesh)
    mesh_recommend("lmf f=32 meshed", model, plays)
    del model
    step("lmf class update, draws from the host", mesh_lmf_update_check, device, MESH_D)
    say(10, f"meshed s/epoch (D={MESH_D}): bpr f=128 sampled {bpr_s:.4f} (both epochs of the "
            f"second fit) against phase 5's {sgd['bpr_sampled']:.4f} "
            f"({bpr_s / sgd['bpr_sampled']:.2f}x); lmf f=32 {lmf_s:.4f} (epochs 2-4) against "
            f"phase 5's {sgd['lmf']:.4f} ({lmf_s / sgd['lmf']:.2f}x), the re-shuffle epoch "
            f"{[round(t, 4) for t in reshuffle_s]}")
    step("clustered quality", sgd_quality, device, mesh, 10)

    knn = item_item["knn"]
    wall, steps = step("bm25 meshed", mesh_knn_check, item_item["weighted"], knn["sim"], device,
                       mesh)
    users, items = item_item["weighted"].shape
    flops = 2.0 * items * items * users
    say(10, f"bm25 K=20 meshed: wall {wall:.3f} s (gramian {steps['gramian']:.3f} s = "
            f"{flops / steps['gramian'] / 1e12:.2f} TFLOP/s, top-k "
            f"{steps['top-k']:.3f} s) against phase 6's unmeshed {knn['wall']:.3f} s (gramian "
            f"{knn['gramian']:.3f} s = {flops / knn['gramian'] / 1e12:.2f} TFLOP/s)")
    binary = item_item["ml"].copy()
    binary.data = np.ones_like(binary.data)
    step("ease closed form", mesh_ease_closed_form, binary, device, mesh)
    del binary
    step("ease fit", mesh_ease_fit, item_item["ml"], device, mesh, item_item["ease_sim"],
         item_item["ease"])
    say(10, f"phase 10 wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: BPR's grouped pool modes (models/bpr.py); torch ops, no kernel of
# their own
# ---------------------------------------------------------------------------

# (tag, epoch_mode), each fitted at phase 5's arguments
BPR_VARIANTS = (("grouped_pool", "grouped_pool"), ("grouped_pool_ids", "grouped_pool_ids"))
# the variant fitted again through BPR_GROUPED (epoch_mode None), for the
# same bits, and that flag's value
BPR_REPEATED = ("grouped_pool", 2)


@contextlib.contextmanager
def bpr_flags(flags):
    """``models.bpr``'s module flags set to ``flags`` inside the block and
    restored after it, whatever happens."""
    from implicit_tpu_torch.models import bpr as bpr_mod

    saved = {k: getattr(bpr_mod, k) for k in flags}
    try:
        for k, v in flags.items():
            setattr(bpr_mod, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(bpr_mod, k, v)


def variant_inputs(seed=12, F=32):
    """The pool epochs' inputs at ``injected_plays``' shape, made on the
    host from ``seed``: starting factors, a popularity arrangement (as the
    fit draws it) and per chunk (C,) window offsets."""
    from types import SimpleNamespace

    from implicit_tpu_torch.models import bpr as bpr_mod

    plays = injected_plays()
    rng = np.random.default_rng(seed)
    users, items = plays.shape
    classes = bpr_mod.grouped_classes(plays, "cpu")
    arr = bpr_mod.pool_arrangement(rng, plays, max(idx.shape[2] for _, idx, _, _ in classes))
    return plays, SimpleNamespace(
        F=F, lr=0.05, reg=0.01, arr=arr.astype(np.int64),
        start=[rng.standard_normal(shape, dtype=np.float32) * 0.1
               for shape in ((users, F), (items, F), (items,))],
        offsets=[rng.integers(0, len(arr) - idx.shape[2], size=idx.shape[1])
                 for _, idx, _, n in classes for _ in n],
        drop=max(range(len(classes)), key=lambda c: classes[c][0].shape[0]))


def variant_epoch(plays, inp, pool_mode, dev, drop=False):
    """One grouped epoch in ``pool_mode`` on ``dev`` from ``variant_inputs``:
    the (X, Y, yb) it leaves on the host and its (correct, skipped).
    ``drop`` leaves out the largest class's first chunk."""
    import torch

    from implicit_tpu_torch.models import bpr as bpr_mod
    from implicit_tpu_torch.ops import membership

    pt = membership.build_pair_table(plays)
    iters = int(np.ceil(np.log2(np.diff(plays.indptr).max()))) + 1
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    X, Y, yb = (t(a).clone() for a in inp.start)
    flat = [t(a.astype(np.int64)) for a in (plays.indices, plays.indptr)] + [pt.to_device(dev)]
    classes = bpr_mod.grouped_classes(plays, dev)
    draws = [t(o) for o in inp.offsets]
    if drop:
        classes, draws = drop_chunk(classes, draws, inp.drop)
    counts = bpr_mod._bpr_epoch_grouped(X, Y, yb, classes, *flat, draws, inp.lr, inp.reg, True,
                                        iters, pt.bits, pool_mode=pool_mode,
                                        arrangement=t(inp.arr))
    return (X.cpu(), Y.cpu(), yb.cpu()), tuple(int(c) for c in counts)


def variant_epoch_check(device):
    """Step 1: a grouped epoch in each pool mode with draws made on the
    host (``variant_inputs``), on the card and on the CPU, at phase 5's BPR
    bar (1e-5 of each output's scale, the counts exact), which must reject
    the CPU result with one chunk left out. Returns {"pool m": (err,
    wrong_err)}."""
    import torch

    plays, inp = variant_inputs()
    cpu = torch.device("cpu")
    out = {}
    for pool_mode in (2, 1):
        tag = f"bpr pool {pool_mode} epoch, draws from the host"
        got, got_counts = variant_epoch(plays, inp, pool_mode, device)
        want, want_counts = variant_epoch(plays, inp, pool_mode, cpu)
        wrong, _ = variant_epoch(plays, inp, pool_mode, cpu, drop=True)
        if got_counts != want_counts:
            raise AssertionError(f"{tag}: counts {got_counts} != {want_counts}")
        err = out[f"pool {pool_mode}"] = scale_bar(tag, got, want, wrong, 1e-5)
        say(11, f"{tag}, {plays.shape} nnz={plays.nnz} F={inp.F}: card vs CPU max err "
                f"{err[0]:.3e} of scale (X, Y, yb each; bar 1e-5), (correct, skipped) "
                f"{got_counts} on both; dropped chunk: {err[1]:.3e}, rejected")
    return out


def variant_fits(plays, device, sgd, factors=128, iterations=4):
    """Step 2: each of ``BPR_VARIANTS`` fitted at phase 5's arguments for
    ``iterations`` epochs, the last under ``torch.profiler`` (the steady
    s/epoch is the mean of the second to the one before it); the
    ``BPR_REPEATED`` variant fitted again through the module flag, which
    must give the same bits; ``recommend`` for 1024 users from each. Prints
    s/epoch, samples/s, busy share and launches per epoch beside phase 5's
    grouped and sampled s/epoch (``sgd``). Returns {tag: steady s/epoch}."""
    import torch

    out = {}
    for tag, epoch_mode in BPR_VARIANTS:
        model, steady, prof = bpr_fit(tag, plays, device, epoch_mode, iterations,
                                      iterations - 1, 11, factors)
        if tag == BPR_REPEATED[0]:
            with bpr_flags({"BPR_GROUPED": BPR_REPEATED[1]}):
                again = bpr_fit(f"{tag}, the same seed again through BPR_GROUPED = "
                                f"{BPR_REPEATED[1]}", plays, device, None, iterations, None,
                                11, factors)[0]
            if not (np.array_equal(model.user_factors, again.user_factors)
                    and np.array_equal(model.item_factors, again.item_factors)):
                raise AssertionError(f"bpr {tag}: two fits with the same random_state differ")
            say(11, f"bpr {tag}: two fits with random_state=1 give the same bits")
            del again
        serve_checks(f"bpr f={factors} {tag}", model, plays, phase=11)
        del model
        profiled = prof.report_kernels(f"bpr {tag}", steady, 11)
        out[tag] = steady
        say(11, f"bpr {tag}: {steady:.4f} s/epoch, {plays.nnz / steady:.0f} samples/s; "
                f"{steady / sgd['bpr_grouped']:.2f}x phase 5's grouped {sgd['bpr_grouped']:.4f}, "
                f"{steady / sgd['bpr_sampled']:.2f}x its sampled {sgd['bpr_sampled']:.4f}; busy "
                f"share {profiled['busy']:.3f}, {profiled['launches']} launches per epoch")
        torch.cuda.empty_cache()
    return out


def variant_quality(device):
    """Step 3: p@10 on ``clustered_set`` for each of ``BPR_VARIANTS``, BPR
    factors=63 iterations=200 random_state=42 (``sgd_quality``'s), at least
    0.85 each."""
    from implicit_tpu_torch.bpr import BayesianPersonalizedRanking
    from implicit_tpu_torch.evaluation import precision_at_k

    likes, train, test = clustered_set()
    out = {}
    for tag, epoch_mode in BPR_VARIANTS:
        model = BayesianPersonalizedRanking(factors=63, iterations=200, random_state=42,
                                            epoch_mode=epoch_mode, device=device)
        t0 = time.perf_counter()
        model.fit(train, show_progress=False)
        out[tag] = float(precision_at_k(model, train, test, K=10, show_progress=False))
        say(11, f"clustered set {likes.shape}: bpr {tag} p@10 = {out[tag]:.4f} (gate >= 0.85), "
                f"fit {time.perf_counter() - t0:.2f} s")
    low = {k: v for k, v in out.items() if not v >= 0.85}
    if low:
        raise AssertionError(f"clustered p@10 under 0.85: {low}")
    return out


def phase_bpr_variants(device, plays, sgd):
    """Phase 11: BPR's grouped pool modes at phase 5's shape and arguments.
    ``sgd`` is phase 5's s/epoch."""
    t_phase = time.perf_counter()
    for name, fn, args in (("epochs, draws from the host", variant_epoch_check, (device,)),
                           ("fits", variant_fits, (plays, device, sgd)),
                           ("clustered quality", variant_quality, (device,))):
        t0 = time.perf_counter()
        fn(*args)
        say(11, f"step {name}: {time.perf_counter() - t0:.1f} s")
    say(11, f"phase 11 wall {time.perf_counter() - t_phase:.1f} s")


def kernel_rows(kernels, launches):
    """One row per kernel for the ``{"kernels": [...]}`` line: the main paths'
    launches (all variants), the largest error over every case, the float32
    times and bound at the kernel's "shape" case, and each case's numbers by
    variant. No single PyTorch call computes any of these functions (whole
    per-row CG solves; two dependent contractions; a product followed by
    row-wise reductions and updates), so library_ms is null."""
    rows = []
    for name, spec in KERNELS.items():
        res = kernels[name]["shape"]
        variants = {v: dict(launches=launches.get(f"{name}_{v}", launches.get(name, 0)),
                            **res[v]) for v in res}
        f32 = res["f32"]
        row = {
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(r["launches"] for r in variants.values()),
            "max_abs_err": max(r["max_abs_err"] for case in kernels[name].values()
                               for r in case.values()),
            "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": None,
            "shape_CLF": list(spec["cases"]["shape"][0]), "variants": variants,
        }
        for which, (shape, _) in spec["cases"].items():
            if which != "shape":
                row[which] = {"shape_CLF": list(shape), "variants": kernels[name][which]}
        rows.append(row)
    return rows


# each library's kernels, by the name in their mangled symbol, and the names
# of their integer template parameters in order
PTXAS_KERNELS = {
    "cg_full": {"cg_full_kernel": ("VPT", "W")},
    "weighted_matvec": {"wmv_narrow": ("CH", "G", "NCH"), "wmv_wide": ("CH",),
                        "wmv_sum_slices": ()},
    "cg_update": {"cg_update_kernel": ("NP",), "yty_split_kernel": ()},
    "pcg64_uniform": {"pcg64_uniform_kernel": ("storage",)},
    "topk_select": {"topk_select_kernel": ("K",)},
    "bpr_item_update": {"tiles_kernel": ("VEC",), "runs_kernel": ("VEC",)},
}


def ptxas_report(log, kernels):
    """(instantiation, registers, spill stores, spill loads) per compiled
    instantiation of the ``kernels`` ({name: template parameter names}),
    from nvcc's ``-Xptxas -v`` output."""
    import re

    tables = (("QuantRows", "i8"), ("bfloat16", "bf16"), ("TableRowsIf", "f32"))
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            kernel = next((k for k in kernels if k in name), None)
            name = name if kernel else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table = [t for key, t in tables if key in name][:1]
            args = re.findall(r"Li(\d+)E", name)
            params = [f"{p}={a}" for p, a in zip(kernels[kernel], args)]
            out.append((" ".join([kernel, *table, *params]), int(m.group(1)), *spills))
            name = None
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = gpu_line()
    say(0, f"{card} | torch {torch.__version__} cuda {torch.version.cuda} "
           f"python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    from implicit_tpu_torch.ops import _build, topk

    t0 = time.perf_counter()
    for name in _build.SIGNATURES:  # build from the checkout's sources, every run
        if os.path.exists(_build.library_path(name)):
            os.unlink(_build.library_path(name))
    _build.load()
    say(1, f"kernels built+loaded in {time.perf_counter() - t0:.1f} s "
           f"(nvcc per library, s: {json.dumps(_build.BUILD_SECONDS)})")
    for lib, kernels in PTXAS_KERNELS.items():
        report = ptxas_report(_build.BUILD_LOGS[lib], kernels)
        say(1, f"{lib} ptxas (registers, spill stores/loads bytes): " + "; ".join(
            f"{inst}: {regs} regs, {st}/{ld}" for inst, regs, st, ld in report))
        if not report or any(st or ld for _, _, st, ld in report):
            raise AssertionError(f"{lib}: no ptxas report, or an instantiation spills")
        for line in _build.BUILD_LOGS[lib].splitlines():  # wgmma notes (C75xx): e.g. serialized
            if "(C75" in line:
                say(1, f"{lib} ptxas: {line.strip()}")

    kernels = phase_kernels(device)
    draw = phase_draw(device)
    selection = phase_topk(device)
    plays = lastfm_plays()
    item_update = phase_bpr_update(device, plays)
    selects = topk.LAUNCHES["topk_select"]
    launches, f32_factors, phase3 = phase_main_path(device, plays)
    selection["launches"] = topk.LAUNCHES["topk_select"] - selects  # phase 3's serving
    phase_quality(device)
    phase_quality(device, gather_quant=True, dtype=np.float16)
    sgd = phase_sgd(device, plays)
    item_update["launches"] = sgd["bpr_item_update_launches"]  # phase 5's first grouped fit
    item_item = phase_item_item(device, plays)
    phase_serving(device, plays, f32_factors)
    phase_idioms(device, plays, f32_factors)
    for k, v in phase_mesh(device, plays, f32_factors, phase3).items():
        launches[k] = launches.get(k, 0) + v
    phase_mesh_fits(device, plays, sgd, item_item)
    phase_bpr_variants(device, plays, sgd)

    draw["launches"] = launches["pcg64_uniform"]  # phase 3's and phase 9's fits
    print(json.dumps({"kernels": kernel_rows(kernels, launches) + [draw, selection,
                                                                   item_update]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
