#!/usr/bin/env python3
"""One ALS iteration of implicit_tpu_torch under torch.profiler, on one card.

At the last.fm-360k shape (``generate_synthetic(360_000, 160_000,
17_500_000, seed=0)``, as ``chip_smoke.py`` phase 3), for f=128 float32,
bfloat16 and bfloat16 with int8 gathers, f=256 bfloat16 with
``gather_quant`` off and "auto", and the wide fits, f=512 bfloat16 and
f=320 float32 (the composed CG on weighted_matvec and cg_update): one ``AlternatingLeastSquares.fit`` each,
whose first iteration warms up, the next three give s/iter, and the last
runs under the profiler. It prints, per configuration, the profiled
iteration's wall (as the fit's callback reads it), each solve
kernel's device time and launches, the rest of the device time, and the
device busy share (kernel time over wall), and with ``--out`` writes them
to that file as JSON.

    python3 scripts/profile_als_iteration.py [--root DIR] [--out FILE]

``--root`` imports ``implicit_tpu_torch`` from another checkout (a parent
tree), so two trees can be profiled by one script in one call; a
configuration that tree does not fit (it raises NotImplementedError) is
reported and skipped.
"""

import argparse
import json
import os
import sys

import numpy as np

KERNELS = ("cg_full_kernel", "gramian_build_kernel", "gramian_reduce_kernel",
           "gramian_cg_kernel", "wmv_narrow", "wmv_wide", "wmv_sum_slices",
           "cg_update_kernel", "gemm")
CONFIGS = (  # (tag, factors, dtype, gather_quant)
    ("f=128 float32", 128, np.float32, False),
    ("f=128 bfloat16", 128, np.float16, False),
    ("f=128 bfloat16 int8", 128, np.float16, True),
    ("f=256 bfloat16", 256, np.float16, False),
    ('f=256 bfloat16 "auto"', 256, np.float16, "auto"),
    ("f=512 bfloat16", 512, np.float16, False),
    ("f=320 float32", 320, np.float32, False),
)


def profile_config(plays, factors, dtype, gather_quant, device):
    """One ``AlternatingLeastSquares.fit`` of 5 iterations: the first warms
    up, the next three give s/iter (the fit's callback: host clock after a
    device sync), the last runs under the profiler, which the callback
    starts after iteration 4 and stops after iteration 5."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from implicit_tpu_torch.als import AlternatingLeastSquares

    model = AlternatingLeastSquares(factors=factors, iterations=5, random_state=0, dtype=dtype,
                                    gather_quant=gather_quant, device=device)
    sides = model._gather_quant_sides(*plays.shape)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    secs = []

    def callback(iteration, elapsed, loss):
        secs.append(elapsed)
        if iteration == 3:
            prof.start()
        elif iteration == 4:
            prof.stop()

    model.fit(plays, show_progress=False, callback=callback)
    wall = secs.pop()
    secs = secs[1:]
    ms = dict.fromkeys(KERNELS, 0.0)
    launches = dict.fromkeys(KERNELS, 0)
    other = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or not evt.self_device_time_total:
            continue
        t = evt.self_device_time_total / 1e3
        name = next((k for k in KERNELS if k in evt.key), None)
        if name is None:
            other += t
        else:
            ms[name] += t
            launches[name] += evt.count
    busy = sum(ms.values()) + other
    return dict(sides=list(sides), s_per_iter=secs, profiled_wall_ms=wall * 1e3,
                kernel_ms=ms, kernel_launches=launches, other_device_ms=other,
                busy_share=busy / (wall * 1e3))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--root", default=here, help="checkout whose implicit_tpu_torch to profile")
    ap.add_argument("--out", help="JSON file for the results")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_als_iteration: needs a CUDA card")
    from implicit_tpu_torch.datasets.synthetic import generate_synthetic

    device = torch.device("cuda", 0)
    plays = generate_synthetic(360_000, 160_000, 17_500_000, seed=0)
    results = {"device": torch.cuda.get_device_name(0), "root": os.path.abspath(args.root)}
    for tag, factors, dtype, gather_quant in CONFIGS:
        try:
            res = profile_config(plays, factors, dtype, gather_quant, device)
        except NotImplementedError as err:
            print(f"{tag}: not fitted by this tree ({err})", flush=True)
            continue
        results[tag] = res
        kern = ", ".join(f"{k} {v:.2f} ms ({res['kernel_launches'][k]})"
                         for k, v in res["kernel_ms"].items() if v)
        print(f"{tag}: s/iter {[round(s, 4) for s in res['s_per_iter']]}; profiled "
              f"{res['profiled_wall_ms']:.1f} ms: {kern}, other {res['other_device_ms']:.2f} ms; "
              f"busy {res['busy_share']:.2f}", flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
