#!/usr/bin/env python3
"""Times gramian_cg's phase-2 cases of chip_smoke.py in four contexts, on one card.

Phase 2 times each kernel after the cases before it, right after the plain
version ran on the same inputs. This script holds the gramian_cg cases'
inputs fixed and times the kernel (CUDA events after a warm-up: the mean of
10 launches, then of a sustained run of about a second):

1. ``first``: right after the build, before any other work;
2. ``after_plain``: right after the plain version ran 4 times on the same
   inputs (what phase 2's ``solve_passes`` does just before it times);
3. ``after_cg_full``: after phase 2's ``cg_full`` cases
   (``chip_smoke.phase_kernels`` with ``cg_full`` alone);
4. ``after_idle``: after 30 s with the card idle.

``nvidia-smi`` samples the SM clock, temperature and power every 50 ms
meanwhile; each line gives the samples' mean over its sustained run.

    python3 scripts/phase2_context.py
"""

import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class Sampler:
    """nvidia-smi's SM clock (MHz), temperature (C) and power (W) every 50 ms."""

    def __init__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                vals = [float(v) for v in line.split(",")]
            except ValueError:
                continue
            self.samples.append((time.monotonic(), *vals))

    def mean(self, t0, t1):
        window = [s[1:] for s in self.samples if t0 <= s[0] <= t1]
        if not window:
            return "no nvidia-smi sample"
        clk, temp, watts = (sum(col) / len(window) for col in zip(*window))
        return f"SM {clk:.0f} MHz, {temp:.1f} C, {watts:.0f} W ({len(window)} samples)"

    def stop(self):
        self.proc.terminate()
        self.proc.wait()


def main():
    import torch

    import chip_smoke
    from implicit_tpu_torch.ops import _build, cg_kernels

    if not torch.cuda.is_available():
        raise SystemExit("phase2_context: needs a CUDA card")
    print(chip_smoke.gpu_line(), flush=True)
    device = torch.device("cuda", 0)
    _build.load()
    spec = chip_smoke.KERNELS["gramian_cg"]
    cases = {}
    for which, (shape, variants) in spec["cases"].items():
        for variant in variants:
            cases[f"{which} {variant} {shape}"] = chip_smoke.variant_case(shape, variant, device)
    sampler = Sampler()
    try:
        time.sleep(1)

        def time_all(context, plain_first=False):
            for tag, (Y, scales, idx, dat, x0, yty, _) in cases.items():
                run = lambda: cg_kernels.gramian_cg_solve(  # noqa: E731
                    Y, idx, dat, x0, yty, cg_steps=3, scales=scales)
                if plain_first:
                    chip_smoke.solve_passes(cg_kernels.gramian_cg_solve_plain,
                                            Y, scales, idx, dat, x0, yty)
                ms10 = chip_smoke.cuda_ms(run, 10)
                reps = max(10, int(1000 / ms10))
                t0 = time.monotonic()
                ms = chip_smoke.cuda_ms(run, reps)
                t1 = time.monotonic()
                print(f"{context}: gramian_cg {tag}: {ms10:.4f} ms (mean of 10), {ms:.4f} ms "
                      f"(mean of {reps}); {sampler.mean(t0, t1)}", flush=True)

        time_all("first")
        time_all("after_plain", plain_first=True)
        saved, chip_smoke.KERNELS = chip_smoke.KERNELS, {"cg_full": chip_smoke.KERNELS["cg_full"]}
        t0 = time.monotonic()
        try:
            chip_smoke.phase_kernels(device)
        finally:
            chip_smoke.KERNELS = saved
        print(f"phase 2's cg_full cases: {time.monotonic() - t0:.1f} s; "
              f"{sampler.mean(t0, time.monotonic())}", flush=True)
        time_all("after_cg_full")
        time.sleep(30)
        time_all("after_idle")
    finally:
        sampler.stop()


if __name__ == "__main__":
    main()
