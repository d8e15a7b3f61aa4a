#!/usr/bin/env python3
"""Times this tree's source of one CUDA kernel against other sources of it, on one card.

KERNEL is a library of ``implicit_tpu_torch/ops/csrc`` (``cg_full``,
``gramian_cg``, ``weighted_matvec``, ``cg_update``). Each ``--other`` is
another checkout (e.g. the parent commit's, unpacked with ``git archive``)
or an edited copy of ``csrc/<KERNEL>.cu`` with the same C entry points,
built with the package's nvcc flags next to this tree's ``csrc/`` headers
(a checkout's own source sees its own headers first). The script prints each
build's ptxas registers and spills, then, per case of ``chip_smoke.py``
phase 2 for that kernel, every build's time per launch (``cuda_ms``, the
host loop, and ``cuda_graph_ms``, the same launches replayed from a CUDA
graph; the builds in turns, then in reverse) and its error against the
plain version. For ``weighted_matvec`` it adds a gather yardstick:
``index_select`` of the table rows the live entries read, as 32-bit words
(and of their scales, for int8), in the same order. ``--fits`` also runs
the last.fm-360k fits of ``chip_smoke.py`` phase 3 that launch the kernel,
with each build, and prints s/iter.

    python3 scripts/kernel_sweep.py KERNEL [--other DIR_OR_CU ...] [--fits]
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 50

# the phase-3 fits that launch each kernel: (factors, dtype name, iterations)
FITS = {
    "cg_full": ((128, "float32", 3), (128, "float16", 3), (256, "float16", 3)),
    "weighted_matvec": ((512, "float16", 2), (320, "float32", 2)),
}
FITS["gramian_cg"] = FITS["cg_full"]
FITS["cg_update"] = FITS["weighted_matvec"]


def build(kernel, tag, src):
    """The library of one source of ``kernel``, or None if it does not build."""
    from implicit_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"sweep_{kernel}_{tag}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", out, src]
    log = subprocess.run(cmd, capture_output=True, text=True)
    text = log.stdout + log.stderr
    if log.returncode:
        print(f"{tag} ({src}): build failed, left out\n{text}", flush=True)
        return None
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build.SIGNATURES[kernel].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.als_error_string.argtypes = [ctypes.c_int]
    lib.als_error_string.restype = ctypes.c_char_p
    print(f"{tag} ({src}): registers {min(regs)}-{max(regs)}, "
          f"spill stores up to {max(spills)} bytes", flush=True)
    return lib


def case(kernel, which, shape, table, device):
    """(run, error, note) of one phase-2 case: ``run`` launches the kernel
    through its wrapper, ``error()`` is its max abs error against the plain
    version (cg_update: the phase-2 check of the build in use, which raises
    on a miss; ``main`` prints the miss beside the build's times, so that a
    copy that computes only part of the pass can still be timed)."""
    import torch

    import chip_smoke
    from implicit_tpu_torch.ops import cg_kernels
    from implicit_tpu_torch.ops.als import _weights

    if kernel == "cg_update":
        check = lambda: chip_smoke.update_case(  # noqa: E731
            f"cg_update {which}", shape, device, chip_smoke.TOL[table])
        _, run, _, dense = check()
        bound_ms, by, _, _ = chip_smoke.update_bound(shape[0], shape[2])
        note = (f" (bound {bound_ms:.4f} ms by {by}; cuBLAS p YtY_reg alone "
                f"{chip_smoke.cuda_graph_ms(dense, REPS):.4f} ms)")
        return run, lambda: check()[0]["max_abs_err"], note
    Y, scales, idx, dat, x0, yty, _ = chip_smoke.variant_case(shape, table, device)
    if kernel != "weighted_matvec":
        solve, plain = {"cg_full": (cg_kernels.cg_solve_full, cg_kernels.cg_solve_full_plain),
                        "gramian_cg": (cg_kernels.gramian_cg_solve,
                                       cg_kernels.gramian_cg_solve_plain)}[kernel]
        want = plain(Y, idx, dat, x0, yty, 3, scales=scales)
        run = lambda: solve(Y, idx, dat, x0, yty, 3, scales=scales)  # noqa: E731
        return run, lambda: float((run() - want).abs().max()), ""
    w, bv = _weights(dat)
    v = x0 * 10
    want = cg_kernels.weighted_matvec_plain(Y, idx, w, bv, v, 0.0, 1.0, scales)
    run = lambda: cg_kernels.weighted_matvec(Y, idx, w, bv, v, 0.0, 1.0, scales)  # noqa: E731
    rows = idx[dat != 0].long()
    words = Y.view(torch.int32)  # each table row as 32-bit words

    def gather():
        out = words.index_select(0, rows)
        return out if scales is None else (out, scales.index_select(0, rows))

    bound_ms, by, _, _ = chip_smoke.bound("weighted_matvec", Y, scales, idx, dat)
    note = (f" (bound {bound_ms:.4f} ms by {by}; {rows.numel()} live entries, index_select "
            f"of their rows {chip_smoke.cuda_graph_ms(gather, REPS):.4f} ms)")
    return run, lambda: float((run() - want).abs().max()), note


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("cg_full", "gramian_cg", "weighted_matvec", "cg_update"))
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout, or an edited source of the kernel, to time against")
    ap.add_argument("--fits", action="store_true",
                    help="also time the last.fm-360k fits that launch the kernel")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from implicit_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: needs a CUDA card")
    print(chip_smoke.gpu_line(), flush=True)
    device = torch.device("cuda", 0)
    src = os.path.join("implicit_tpu_torch", "ops", "csrc", f"{args.kernel}.cu")
    sources = {"this": os.path.join(ROOT, src)}
    for i, other in enumerate(args.other):
        sources[f"other{i}"] = os.path.join(other, src) if os.path.isdir(other) else other
    libs = {tag: build(args.kernel, tag, path) for tag, path in sources.items()}
    tags = [tag for tag, lib in libs.items() if lib is not None]

    def use(tag):
        _build._libs[args.kernel] = libs[tag]  # what the wrapper launches

    for which, (shape, tables) in chip_smoke.KERNELS[args.kernel]["cases"].items():
        for table in tables:
            run, error, note = case(args.kernel, which, shape, table, device)
            ms = {tag: [] for tag in tags}
            err = {}
            for tag in tags + tags[::-1]:
                use(tag)
                try:
                    err[tag] = f"{error():.1e}"
                except AssertionError as e:  # a partial copy, timed for attribution
                    err[tag] = f"check failed: {e}"
                ms[tag].append((chip_smoke.cuda_ms(run, REPS), chip_smoke.cuda_graph_ms(run, REPS)))
            print(f"{which} {table} C, L, F = {shape}{note}: " + "; ".join(
                f"{tag} host loop {ms[tag][0][0]:.4f}/{ms[tag][1][0]:.4f} ms, graph "
                f"{ms[tag][0][1]:.4f}/{ms[tag][1][1]:.4f} ms (err {err[tag]})"
                for tag in tags), flush=True)
            del run, error
            torch.cuda.empty_cache()

    if args.fits:
        from implicit_tpu_torch.datasets.synthetic import generate_synthetic

        plays = generate_synthetic(360_000, 160_000, 17_500_000, seed=0)
        for factors, dtype, iterations in FITS[args.kernel]:
            for tag in tags + tags[::-1]:
                use(tag)
                name = f"f={factors} {dtype} {tag}"
                t0 = time.perf_counter()
                _, _, times, _ = chip_smoke.fit_path(name, plays, device, factors,
                                                     np.dtype(dtype).type, False, iterations)
                print(f"fit {name}: s/iter {[round(t, 4) for t in times]} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
