#!/usr/bin/env python3
"""Times this tree's csrc/cg_full.cu against other sources of it, on one card.

Each ``--other`` is another checkout (e.g. the parent commit's, unpacked
with ``git archive``) or a ``cg_full.cu`` file with the same C entry points,
built as it is with the package's nvcc flags next to the headers of its own
directory. The script prints each build's ptxas registers and spills, then,
per case, every build's time (CUDA events, mean of 20 launches after a
warm-up; the builds in turns, then in reverse) and its error against the
plain version. With ``--fits`` it also runs the last.fm-360k fits of
``chip_smoke.py`` phase 3 (f=128 float32 and bfloat16, f=256 bfloat16) with
each build and prints s/iter.

    python3 scripts/cg_full_sweep.py --other DIR_OR_CU [--other ...] [--fits]
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

CASES = (  # (C, L, F), table types
    ((4096, 64, 128), ("f32", "bf16", "i8")),
    ((4096, 64, 256), ("bf16", "i8")),
    ((1024, 512, 128), ("f32", "bf16")),
)
SRC = os.path.join("implicit_tpu_torch", "ops", "csrc", "cg_full.cu")


def build(tag, src):
    """The library of one cg_full.cu source, or None if it does not build."""
    from implicit_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"cg_full_sweep_{tag}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src]
    log = subprocess.run(cmd, capture_output=True, text=True)
    text = log.stdout + log.stderr
    if log.returncode:
        print(f"{tag} ({src}): build failed, left out\n{text}", flush=True)
        return None
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build.SIGNATURES["cg_full"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.als_error_string.argtypes = [ctypes.c_int]
    lib.als_error_string.restype = ctypes.c_char_p
    print(f"{tag} ({src}): registers {min(regs)}-{max(regs)}, "
          f"spill stores up to {max(spills)} bytes", flush=True)
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", required=True,
                    help="another checkout, or a cg_full.cu file, to time against this tree's")
    ap.add_argument("--fits", action="store_true", help="also time the last.fm-360k fits")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from implicit_tpu_torch.ops import cg_kernels

    if not torch.cuda.is_available():
        raise SystemExit("cg_full_sweep: needs a CUDA card")
    print(chip_smoke.gpu_line(), flush=True)
    device = torch.device("cuda", 0)
    sources = {"this": os.path.join(ROOT, SRC)}
    for i, other in enumerate(args.other):
        sources[f"other{i}"] = os.path.join(other, SRC) if os.path.isdir(other) else other
    libs = {tag: build(tag, src) for tag, src in sources.items()}
    tags = [tag for tag, lib in libs.items() if lib is not None]

    def use(tag):
        from implicit_tpu_torch.ops import _build

        _build._libs["cg_full"] = libs[tag]  # what cg_kernels.cg_solve_full launches

    for shape, tables in CASES:
        for table in tables:
            Y, scales, idx, dat, x0, yty, _ = chip_smoke.variant_case(shape, table, device)
            want = cg_kernels.cg_solve_full_plain(Y, idx, dat, x0, yty, 3, scales=scales)
            run = lambda: cg_kernels.cg_solve_full(  # noqa: E731
                Y, idx, dat, x0, yty, 3, scales=scales)
            ms = {tag: [] for tag in tags}
            err = {}
            for tag in tags + tags[::-1]:
                use(tag)
                err[tag] = float((run() - want).abs().max())
                ms[tag].append(chip_smoke.cuda_ms(run, 20))
            print(f"{table} C, L, F = {shape}: " + "; ".join(
                f"{tag} {ms[tag][0]:.4f}/{ms[tag][1]:.4f} ms (err {err[tag]:.1e})"
                for tag in tags), flush=True)
            del Y, scales, idx, dat, x0, yty, want
            torch.cuda.empty_cache()

    if args.fits:
        from implicit_tpu_torch.datasets.synthetic import generate_synthetic

        plays = generate_synthetic(360_000, 160_000, 17_500_000, seed=0)
        for factors, dtype in ((128, np.float32), (128, np.float16), (256, np.float16)):
            for tag in tags + tags[::-1]:
                use(tag)
                name = f"f={factors} {np.dtype(dtype).name} {tag}"
                t0 = time.perf_counter()
                _, _, times, _ = chip_smoke.fit_path(name, plays, device, factors, dtype, False)
                print(f"fit {name}: s/iter "
                      f"{[round(t, 4) for t in times]} ({time.perf_counter() - t0:.1f} s)",
                      flush=True)


if __name__ == "__main__":
    main()
