#!/usr/bin/env python3
"""How far LMF's class update moves when only the summation order of its
products changes, on the CPU.

Runs ``chip_smoke.py``'s injected-draw LMF cases (``injected_inputs``: the
glued, split and legacy pool routes) twice on the CPU: once as the port
computes them (float32 products of bfloat16-rounded operands,
``models.lmf._bf16_bmm``), once with the same products summed in float64.
It prints, per route, the largest difference of X and of the AdaGrad
accumulator over each tensor's scale (max |value|): what the card-vs-CPU
check of ``chip_smoke.py`` phase 5 must allow, since the card sums in yet
another order.

    python3 scripts/lmf_order_sensitivity.py
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from implicit_tpu_torch.models import lmf  # noqa: E402


def float64_sums(a, b):
    """``lmf._bf16_bmm`` with its products summed in float64."""
    return torch.bmm(a.to(torch.bfloat16).double(), b.double()).float()


def main():
    plays, _, inputs = chip_smoke.injected_inputs()
    port = lmf._bf16_bmm
    for case in inputs.cases:
        want = chip_smoke.lmf_injected_update(plays, inputs, case, "cpu")
        lmf._bf16_bmm = float64_sums
        try:
            got = chip_smoke.lmf_injected_update(plays, inputs, case, "cpu")
        finally:
            lmf._bf16_bmm = port
        errs = [float((g.double() - w.double()).abs().max() / w.double().abs().max())
                for g, w in zip(got, want)]
        print(f"{case.route} pool, F={case.width}: float32 against float64 sums, max "
              f"difference over scale: X {errs[0]:.3e}, dss {errs[1]:.3e}")


if __name__ == "__main__":
    main()
