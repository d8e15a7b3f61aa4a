"""Published peaks of the cards the benchmark knows (NVIDIA's data sheets,
dense rates, at the card's full power limit)."""

# the H100 SXM5: 989 TFLOP/s bf16, 495 TFLOP/s TF32 (the fastest unit that
# takes float32 operands, so no float32-exact kernel can read over 100%),
# 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3
PEAKS = {
    "H100": {"flops": {"float32": 495e12, "bfloat16": 989e12}, "bytes_per_s": 3.35e12},
}


def for_card(name):
    """The peaks of the card named ``name`` (torch.cuda.get_device_name), or
    None for a card not in the table: the readers then report nothing."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return None


def least_time(peaks, ops, nbytes, dtype):
    """The least time of ``ops`` operations moving ``nbytes`` bytes: the
    larger of the two bounds."""
    return max(ops / peaks["flops"][dtype], nbytes / peaks["bytes_per_s"])
