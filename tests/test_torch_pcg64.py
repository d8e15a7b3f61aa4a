"""The host part of the starting-factor draw on the card (``ops/pcg64.py``)
against numpy itself, and the fit's routing between the two draws.

The kernel (``csrc/pcg64_uniform.cu``) runs only on a card
(``tests/test_torch_cuda.py``); what it computes is numpy's PCG64 stream,
which these tests hold the host's pieces to exactly: the LCG's jump maps
against ``PCG64.advance``, the kernel's per-thread indexing
(``_emulate``, thread counts small enough that each thread takes
several pairs) against ``Generator.random``, and the state left behind
against the generator's own after the same draw.
"""

import numpy as np
import pytest
import torch

from implicit_tpu_torch import tracing
from implicit_tpu_torch.als import AlternatingLeastSquares
from implicit_tpu_torch.datasets.synthetic import generate_synthetic
from implicit_tpu_torch.ops import pcg64


def _emulate(state, n, threads):
    """The 32-bit words the kernel makes ``n`` floats of from the state dict
    ``state``, by its own indexing on ``threads`` threads: thread t takes the
    element pairs p = t, t + threads, ..., from the state t steps on, and
    steps by the jump of ``threads``."""
    s0, inc = state["state"]["state"], state["state"]["inc"]
    buffered, kept = state["has_uint32"], state["uinteger"]
    words = np.zeros(n, dtype=np.uint32)
    pairs = (n + 1) // 2
    step_mult, step_plus = pcg64.jump(threads, inc)
    for t in range(min(threads, pairs)):
        mult, plus = pcg64.jump(t, inc)
        s = (mult * s0 + plus) % 2**128
        for p in range(t, pairs, threads):
            x = pcg64.output((pcg64.MULT * s + inc) % 2**128)
            u0, u1 = x & 0xFFFFFFFF, x >> 32
            if buffered:
                u0, u1 = kept if p == 0 else pcg64.output(s) >> 32, u0
            words[2 * p] = u0
            if 2 * p + 1 < n:
                words[2 * p + 1] = u1
            s = (step_mult * s + step_plus) % 2**128
    return words


def _uniform_from_words(words):
    """numpy's float32 of 32-bit words: ``(u >> 8) * 2^-24``."""
    return (words >> 8).astype(np.float32) * np.float32(2.0**-24)


def _state(seed, drawn):
    """A fresh generator's state dict after ``drawn`` float32 draws (an odd
    count leaves a kept half)."""
    rng = np.random.default_rng(seed)
    rng.random(drawn, dtype=np.float32)
    return rng.bit_generator.state


@pytest.mark.parametrize("k", [0, 1, 2, 1023, 2**20 + 7])
def test_jump_is_advance(k):
    state = _state(5, 0)["state"]
    mult, plus = pcg64.jump(k, state["inc"])
    bitgen = np.random.PCG64(5)
    bitgen.advance(k)
    assert (mult * state["state"] + plus) % 2**128 == bitgen.state["state"]["state"]


@pytest.mark.parametrize("n,F,drawn,threads", [
    (1, 1, 0, 1),       # one element
    (37, 8, 0, 7),      # even n F, 148 pairs over 7 threads
    (37, 9, 0, 7),      # odd n F: the last pair is one element
    (37, 9, 3, 7),      # from a kept half, odd n F
    (36, 8, 1, 64),     # from a kept half, even n F
    (1, 1, 1, 1),       # only the kept half
    (5, 3, 0, pcg64.THREADS),  # fewer pairs than threads
])
def test_emulated_kernel_draws_numpys_bits(n, F, drawn, threads):
    """The kernel's indexing, emulated, gives ``rng.random((n, F),
    dtype=np.float32)`` bit for bit, and the state after the draw is the
    generator's own after it."""
    state = _state(2**40 + 3, drawn)
    rng = np.random.default_rng(2**40 + 3)
    rng.random(drawn, dtype=np.float32)
    want = rng.random((n, F), dtype=np.float32)
    got = _uniform_from_words(_emulate(state, n * F, threads)).reshape(n, F)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert pcg64.state_after(state, n * F) == rng.bit_generator.state


def test_state_after_no_draw_is_the_state():
    state = _state(3, 1)
    assert pcg64.state_after(state, 0) == state


@pytest.mark.parametrize("n,expect", [(1, 1), (512, 1), (513, 2), (2 * 256 * 1024, 1024),
                                      (10**9, pcg64.MAX_BLOCKS)])
def test_blocks_cover_the_pairs(n, expect):
    assert pcg64.blocks(n) == expect


def _emulated_device_draw(random_state, shape, storage, device):
    """``pcg64.uniform_factors`` on the CPU: the emulated kernel's words,
    scaled and rounded as the kernel does, and the state set after."""
    bitgen = random_state.bit_generator
    state = bitgen.state
    n = int(np.prod(shape))
    words = _emulate(state, n, 64)
    table = torch.from_numpy(_uniform_from_words(words).reshape(shape) * np.float32(0.01))
    bitgen.state = pcg64.state_after(state, n)
    tracing.count("init.device_draws")
    return table.to(storage).float()


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
@pytest.mark.parametrize("random_state", ["int", "pcg64", "mt19937"])
def test_routing_by_stream_and_device(monkeypatch, dtype, random_state):
    """On a CUDA device a PCG64 stream takes the device draw and any other
    stream numpy's; on the CPU both take numpy's. Either way the starting
    tables are numpy's bits, and the caller's generator is left where
    numpy leaves it."""
    monkeypatch.setattr(pcg64, "uniform_factors", _emulated_device_draw)
    # numpy's route uploads its draw: to the CPU here, whatever the device
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda data, device=None: as_tensor(data))

    def stream():
        return {"int": 19, "pcg64": np.random.Generator(np.random.PCG64(19)),
                "mt19937": np.random.Generator(np.random.MT19937(19))}[random_state]

    tables, after = {}, {}
    for device in ("cuda", "cpu"):
        model = AlternatingLeastSquares(factors=10, dtype=dtype, device="cpu")
        rs = np.random.default_rng(stream())
        before = tracing.counters()
        X = model._initial_factors(None, 41, rs, torch.device(device))
        Y = model._initial_factors(None, 23, rs, torch.device(device))
        counts = {k: tracing.counters()[k] - before[k]
                  for k in ("init.device_draws", "init.host_draws")}
        on_card = device == "cuda" and random_state != "mt19937"
        assert counts == {"init.device_draws": 2 * on_card, "init.host_draws": 2 * (not on_card)}
        tables[device] = (X, Y)
        after[device] = rs.random(3)
    for a, b in zip(tables["cuda"], tables["cpu"]):
        assert a.dtype == b.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
        assert torch.equal(a, b)
    np.testing.assert_array_equal(after["cuda"], after["cpu"])


def test_a_cpu_fit_draws_on_the_host():
    plays = generate_synthetic(60, 40, 600, seed=1)
    before = tracing.counters()
    AlternatingLeastSquares(factors=8, iterations=1, random_state=3, device="cpu").fit(
        plays, show_progress=False)
    after = tracing.counters()
    assert after["init.host_draws"] - before["init.host_draws"] == 2
    assert after["init.device_draws"] == before["init.device_draws"]


@pytest.mark.parametrize("bitgen", [np.random.MT19937, np.random.Philox, np.random.SFC64,
                                    np.random.PCG64DXSM])
def test_device_draw_refuses_other_streams(bitgen):
    with pytest.raises(TypeError, match="PCG64"):
        pcg64.uniform_factors(np.random.Generator(bitgen(1)), (4, 4), torch.float32,
                              torch.device("cuda"))


def test_device_draw_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        pcg64.uniform_factors(np.random.default_rng(1), (4, 4), torch.float32,
                              torch.device("cpu"))
