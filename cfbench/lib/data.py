"""Inputs made on the device from the run's seed: the interaction matrix the
fit and the liked-item filter read, and the factor tables serving reads.

The matrix follows the recipe of the synthetic benchmark data (item
popularity proportional to (rank + offset)^-exponent by inverse-CDF draws,
users uniform, confidences 1 + Exp(mean), duplicate draws summed). Its
pattern comes from the configuration's fixed ``structure_seed``; the run's
seed relabels users and items and draws the confidences. So every seed has
the same row lengths and item degrees, in another order, and the work of a
fit does not move with the seed.
"""

import numpy as np
import scipy.sparse
import torch


def seed_int(seed, *stream):
    """A 63-bit seed for stream ``stream`` of run seed ``seed`` (any int)."""
    words = np.random.SeedSequence([int(seed) % 2**64, *stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(device, seed, *stream):
    g = torch.Generator(device=device)
    g.manual_seed(seed_int(seed, *stream))
    return g


def interactions(spec, seed, device):
    """The users x items confidence matrix as the host scipy CSR users pass
    to ``fit`` (sorted indices, no duplicates, float32 data)."""
    users, items, draws = int(spec["users"]), int(spec["items"]), int(spec["draws"])
    pattern = generator(device, spec["structure_seed"], 0)
    relabel = generator(device, seed, 1)
    rank = torch.arange(items, dtype=torch.float64, device=device)
    cdf = torch.cumsum((rank + spec["popularity_offset"]) ** -spec["popularity_exponent"], 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(draws, dtype=torch.float64, generator=pattern, device=device)
    cols = torch.searchsorted(cdf, u).clamp_(max=items - 1)
    rows = torch.randint(0, users, (draws,), generator=pattern, device=device)
    del u
    rows = torch.randperm(users, generator=relabel, device=device)[rows]
    cols = torch.randperm(items, generator=relabel, device=device)[cols]
    vals = torch.empty(draws, dtype=torch.float64, device=device).exponential_(
        1.0 / spec["mean_confidence"], generator=relabel) + 1.0
    key, order = torch.sort(rows * items + cols, stable=True)
    del rows, cols
    key, counts = torch.unique_consecutive(key, return_counts=True)
    # duplicate draws summed in a fixed order: differences of a float64 prefix sum
    ends = torch.cumsum(counts, 0) - 1
    csum = torch.cumsum(vals[order], 0)[ends]
    data = torch.diff(csum, prepend=csum.new_zeros(1)).to(torch.float32)
    row = key // items
    indptr = torch.zeros(users + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(row, minlength=users), 0)
    mat = scipy.sparse.csr_matrix(
        (data.cpu().numpy(), (key % items).to(torch.int32).cpu().numpy(), indptr.cpu().numpy()),
        shape=(users, items))
    mat.has_sorted_indices = True
    return mat


def factor_table(n, factors, scale, seed, stream, device):
    """An (n, factors) float32 host table of N(0, scale^2) entries, drawn on
    the device."""
    g = generator(device, seed, 2, stream)
    t = torch.randn((n, factors), generator=g, device=device, dtype=torch.float32) * scale
    return t.cpu().numpy()
