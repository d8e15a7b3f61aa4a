"""Exact O(1) membership tests for (user, item) interaction pairs.

The counterpart of ``implicit_tpu/ops/membership.py``. BPR verifies every
sampled negative against the user's liked set; a quotiented bucketized
cuckoo table answers that with two independent 4-slot bucket gathers per
sample, where the bisection over the CSR row needs about log2(row length)
dependent gathers:

- an unbalanced Feistel network permutes the (user, item) pair bijectively
  within [0, 2^a) x [0, 2^b), so the permuted key ``p`` determines the pair
  exactly (no false positives);
- ``p``'s low bits pick the bucket and only the rest (the remainder) is
  stored, with a flag saying whether the key sits in its primary bucket or
  the alternate ``B ^ mix(remainder)``.

The table is built once per fit on the host (the port's native
``cuckoo_build``, else a vectorized numpy placement) and looked up on the
device. Both packages build the same table from the same matrix, bit for
bit, and their lookups agree bit for bit.

Integer arithmetic: the hash is defined in uint32 with wraparound, which
torch supports only in part. Here every word is an int64 holding a value in
[0, 2**32): a product with a constant is formed from the constant's 16-bit
halves (so no int64 product overflows) and masked to 32 bits, and a left
shift is masked before any right shift reads its high bits. The same
functions run on numpy int64 arrays (the host build) and on torch int64
tensors (the lookup) and give the uint32 results.
"""

import numpy as np
import torch

# Feistel round constants (odd murmur-style multipliers) and the
# alternate-bucket mixer: the JAX package's, since build and lookup of both
# packages must agree
_ROUND_KEYS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
_ALT_MIX = 0x165667B1
_SLOTS = 4  # slots per bucket
_MAX_REM_BITS = 29  # remainder + flag bits must fit an int32 slot
_M32 = 0xFFFFFFFF


def _words(x):
    """``x`` as int64 words: a torch tensor stays on its device, anything
    else becomes a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return np.asarray(x).astype(np.int64)


def _mul32(x, c):
    """``x * c`` mod 2**32 for words ``x`` and a constant ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x, c):
    """32-bit avalanche mix (uint32 wraparound)."""
    x = _mul32(x, c)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x2C1B3C6D)
    return x ^ (x >> 12)


def _feistel(u, i, a_bits, b_bits):
    """Bijective scramble of (u, i) within [0, 2^a) x [0, 2^b).

    Each round swaps the halves and XORs a masked mix of one half into the
    other; an even number of rounds leaves (L, R) a_bits and b_bits wide.
    """
    L, R = u, i
    l_bits, r_bits = a_bits, b_bits
    for rk in _ROUND_KEYS:
        F = _mix32((R + rk) & _M32, 0x9E3779B1)
        L, R = R, L ^ (F & ((1 << l_bits) - 1))
        l_bits, r_bits = r_bits, l_bits
    return L, R


def _bucket_rem(u, i, a_bits, b_bits, bucket_bits):
    """(bucket, remainder) of the permuted pair key p = (L << b_bits) | R:
    the bucket is its low ``bucket_bits`` bits, the remainder the rest,
    computed in 32-bit pieces (p_lo, p_hi) as the JAX package does."""
    L, R = _feistel(_words(u), _words(i), a_bits, b_bits)
    p_lo = ((L << b_bits) | R) & _M32
    p_hi = L >> (32 - b_bits) if b_bits > 0 else L * 0
    bucket = p_lo & ((1 << bucket_bits) - 1)
    rem = ((p_lo >> bucket_bits) | ((p_hi << (32 - bucket_bits)) & _M32))
    rem_bits = a_bits + b_bits - bucket_bits
    return bucket, rem & ((1 << max(rem_bits, 1)) - 1)


def _alt_bucket(bucket, rem, bucket_bits):
    return bucket ^ (_mix32(rem, _ALT_MIX) & ((1 << bucket_bits) - 1))


class PairTable:
    """Host-built cuckoo table over a CSR matrix's (row, col) pairs."""

    def __init__(self, table, a_bits, b_bits, bucket_bits):
        self.table = table  # (nbuckets, _SLOTS) uint16 or uint32; 0 = empty
        self.a_bits = a_bits
        self.b_bits = b_bits
        self.bucket_bits = bucket_bits

    @property
    def bits(self):
        """(a_bits, b_bits, bucket_bits), the lookup's static arguments."""
        return self.a_bits, self.b_bits, self.bucket_bits

    def to_device(self, device):
        """The table as an int32 tensor on ``device``: every slot value is
        under 2**31 (remainder and flag take at most 31 bits), so the
        uint16 and uint32 tables upload unchanged."""
        return torch.as_tensor(self.table.astype(np.int32), device=device)

    def member(self, u, i):
        """Vectorized membership test on the host (numpy)."""
        return _member(self.table.astype(np.int64), u, i, *self.bits)


def _member(table, u, i, a_bits, b_bits, bucket_bits):
    """Which (u[k], i[k]) pairs the table holds.

    ``table`` is a torch tensor (the lookup on its device, ids as tensors
    there) or a numpy array (ids as arrays). The slot values compared need
    no cast to the table's width: ``build_pair_table`` picks 16-bit slots
    only where the remainder and its two flag bits fit 16 bits.
    """
    bucket, rem = _bucket_rem(u, i, a_bits, b_bits, bucket_bits)
    v_primary = (rem << 2) | 1
    v_alt = (rem << 2) | 3
    alt = _alt_bucket(bucket, rem, bucket_bits)
    # two independent 4-slot row gathers
    hit_p = (table[bucket] == v_primary[..., None]).any(-1)
    hit_a = (table[alt] == v_alt[..., None]).any(-1)
    return hit_p | hit_a


def _id_bits(n):
    return max(1, int(np.ceil(np.log2(max(int(n), 2)))))


def build_pair_table(user_items, max_load=0.85, row_ids=None):
    """Builds a PairTable for a CSR matrix, or None if the shape won't fit.

    Sizing: a power-of-two bucket count targeting ``max_load`` occupancy of
    the 4-slot buckets; 16-bit slots where remainder and flags fit them.
    ``row_ids`` optionally supplies the per-entry row ids of the CSR.
    """
    users, items = user_items.shape
    nnz = user_items.nnz
    if nnz == 0:
        return None
    a_bits, b_bits = _id_bits(users), _id_bits(items)
    if b_bits >= 32 or a_bits >= 32:
        return None
    # float division: int(_SLOTS * max_load) would truncate the target load
    bucket_bits = max(3, _id_bits(int(np.ceil(nnz / (_SLOTS * max_load)))))
    rem_bits = a_bits + b_bits - bucket_bits
    if rem_bits > _MAX_REM_BITS:
        return None  # id space too large for 32-bit slots; caller falls back
    dtype = np.uint16 if rem_bits + 2 <= 16 else np.uint32
    nbuckets = 1 << bucket_bits

    if row_ids is not None:
        u = np.asarray(row_ids).astype(np.uint32, copy=False)
    else:
        u = np.repeat(np.arange(users, dtype=np.uint32), np.ediff1d(user_items.indptr))
    i = user_items.indices.astype(np.uint32)

    # native placement when the C++ runtime is available (the numpy build
    # below is the fallback; its straggler walk is a Python loop)
    from .. import native

    nat = native.cuckoo_build(u, i, a_bits, b_bits, bucket_bits)
    if nat is not None:
        return PairTable(nat.astype(dtype) if dtype != np.uint32 else nat,
                         a_bits, b_bits, bucket_bits)

    bucket, rem = _bucket_rem(u, i, a_bits, b_bits, bucket_bits)
    v1 = ((rem << 2) | 1).astype(dtype)
    v2 = ((rem << 2) | 3).astype(dtype)
    alt = _alt_bucket(bucket, rem, bucket_bits)

    table = np.zeros((nbuckets, _SLOTS), dtype=dtype)
    used = np.zeros(nbuckets, dtype=np.int32)

    pending = np.arange(nnz)
    choice = np.zeros(nnz, dtype=bool)  # False: primary bucket, True: alt
    # vectorized rounds: sort pending by target bucket, place as many per
    # bucket as fit, flip the rest to their other bucket and repeat
    for _ in range(24):
        if not len(pending):
            break
        b = np.where(choice[pending], alt[pending], bucket[pending])
        order = np.argsort(b, kind="stable")
        pending = pending[order]
        b = b[order]
        first = np.searchsorted(b, b, side="left")
        rank = np.arange(len(b)) - first  # rank within its bucket this round
        slot = used[b] + rank
        place = slot < _SLOTS
        pb = b[place]
        pk = pending[place]
        table[pb, slot[place]] = np.where(choice[pk], v2[pk], v1[pk])
        used += np.bincount(pb, minlength=nbuckets).astype(np.int32)
        pending = pending[~place]
        choice[pending] = ~choice[pending]

    # stragglers: bounded per-key cuckoo eviction walk (rare at this load)
    for k in pending:
        cur_v, cur_b = int(v1[k]), int(bucket[k])
        placed = False
        for _ in range(512):
            row = table[cur_b]
            empty = np.nonzero(row == 0)[0]
            if len(empty):
                table[cur_b, empty[0]] = cur_v
                placed = True
                break
            # evict a pseudo-random victim and move it to its other bucket
            s = int(_mix32(np.array([cur_v], np.int64), 0x61C88647)[0]) % _SLOTS
            victim = int(row[s])
            table[cur_b, s] = cur_v
            cur_b = int(_alt_bucket(np.array([cur_b], np.int64),
                                    np.array([victim >> 2], np.int64), bucket_bits)[0])
            cur_v = victim ^ 2  # flip primary/alternate flag
        if not placed:
            return None  # pathological; caller falls back to bisection

    return PairTable(table, a_bits, b_bits, bucket_bits)
