"""numpy's float32 uniform draw from a PCG64 stream, made on the card.

:func:`uniform_factors` gives the ALS fit's starting table,
``random_state.random(shape, dtype=np.float32) * np.float32(0.01)`` rounded
to the model's storage dtype, bit for bit, from the CUDA kernel
``csrc/pcg64_uniform.cu`` (notes at its head), and leaves ``random_state``
in the state numpy's own draw leaves it in: the next draw (the item table
after the user table) continues the stream, and a caller's ``Generator``
reads on as it would have. Only a ``Generator`` over ``np.random.PCG64``
is drawn here; that is what ``utils.check_random_state`` makes of an int,
None or a ``RandomState``.

The rest is the host's part, on Python integers: the LCG's jump maps
(:func:`jump`), its output (:func:`output`), the kernel's grid
(:func:`blocks`) and the generator's state after a draw
(:func:`state_after`), which the CPU tests hold against numpy.
"""

import math

import numpy as np
import torch

from .. import tracing
from . import _build

# numpy's PCG64 multiplier (PCG_DEFAULT_MULTIPLIER_128)
MULT = 2549297995355413924 << 64 | 4865540595714422341
_M128 = (1 << 128) - 1
_M64 = (1 << 64) - 1

# the kernel's threads a block (kThreads), and its most blocks
THREADS = 256
MAX_BLOCKS = 1024

# the kernel's storage codes, by the model's storage dtype: a float64 table
# holds the float32 value exactly
STORAGE = {torch.float32: 0, torch.float64: 0, torch.bfloat16: 1, torch.float16: 2}


def jump(k, inc):
    """``(mult, plus)``: ``k`` steps of the LCG ``s <- MULT s + inc`` take
    ``s`` to ``mult s + plus`` (mod 2^128)."""
    mult, plus, a, c = 1, 0, MULT, inc
    while k:
        if k & 1:
            mult, plus = mult * a & _M128, (plus * a + c) & _M128
        a, c = a * a & _M128, (a + 1) * c & _M128
        k >>= 1
    return mult, plus


def output(s):
    """The 64-bit output of the state ``s`` (XSL-RR)."""
    hi = s >> 64
    x, r = hi ^ (s & _M64), hi >> 58
    return (x >> r | x << (64 - r)) & _M64


def blocks(n):
    """The kernel's blocks for ``n`` elements: a thread a pair of them, at
    most ``MAX_BLOCKS`` blocks of ``THREADS``."""
    return max(1, min(MAX_BLOCKS, -(-((n + 1) // 2) // THREADS)))


def state_after(state, n):
    """The state dict numpy's PCG64 has after drawing ``n`` float32 from the
    state dict ``state``: the LCG advanced by the outputs used, and the
    high half of the last one kept (``uinteger``), to be read next where
    ``has_uint32`` is 1."""
    out = dict(state, state=dict(state["state"]))
    if n == 0:
        return out
    fresh = n - state["has_uint32"]  # the elements drawn from new outputs
    out["has_uint32"] = fresh % 2
    if fresh == 0:
        return out
    mult, plus = jump((fresh + 1) // 2, state["state"]["inc"])
    s = (mult * state["state"]["state"] + plus) & _M128
    out["state"]["state"], out["uinteger"] = s, output(s) >> 32
    return out


def uniform_factors(random_state, shape, storage, device):
    """``random_state.random(shape, dtype=np.float32) * np.float32(0.01)``
    rounded to ``storage`` (a dtype of ``STORAGE``), as a float32 tensor on
    the CUDA ``device``, from the kernel; ``random_state``, a ``Generator``
    over ``np.random.PCG64``, is left where numpy's draw leaves it. Counts
    ``init.device_draws``."""
    bitgen = random_state.bit_generator
    if type(bitgen) is not np.random.PCG64:
        raise TypeError(f"the device draw takes a PCG64 stream, got {type(bitgen).__name__}")
    if device.type != "cuda":
        raise ValueError(f"the device draw runs on a CUDA device, got {device}")
    if storage not in STORAGE:
        raise TypeError(f"storage must be one of {sorted(map(str, STORAGE))}, got {storage}")
    n = math.prod(shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    lib = _build.load("pcg64_uniform")["pcg64_uniform"]
    with bitgen.lock, torch.cuda.device(device):
        state = bitgen.state
        s, inc = state["state"]["state"], state["state"]["inc"]
        rc = lib.pcg64_uniform(s >> 64, s & _M64, inc >> 64, inc & _M64, n,
                               state["has_uint32"], state["uinteger"], out.data_ptr(),
                               STORAGE[storage], blocks(n),
                               torch.cuda.current_stream(device).cuda_stream)
        _build.check(lib, rc, "pcg64_uniform launch")
        bitgen.state = state_after(state, n)
    tracing.count("init.device_draws")
    return out
