"""The port's cuckoo pair table (``implicit_tpu_torch/ops/membership.py``)
against the JAX package's, bit for bit.

The table is built on the host (the port's native ``cuckoo_build``, or its
numpy placement) and looked up with torch ops; the hash is uint32 arithmetic
carried in int64 words. Tolerance: none. Every comparison is exact: the
bucket and remainder of each pair, the lookup's answer, the table itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix, csr_matrix
from scipy.sparse import random as sprandom
# autouse: the JAX package's native library, built and loaded under a lock
from test_torch_jax_native import jax_native_loaded  # noqa: F401

from implicit_tpu import native as jax_native
from implicit_tpu.ops import membership as jax_membership
from implicit_tpu_torch import native
from implicit_tpu_torch.ops import membership

torch.set_num_threads(2)


def _random_csr(users, items, density, seed):
    rng = np.random.RandomState(seed)
    return csr_matrix(sprandom(users, items, density=density, random_state=rng, format="csr"))


def _huge_id_space(seed, n=1 << 19, count=5000):
    # sparse but a huge id space: the remainder outgrows 16-bit slots
    rng = np.random.RandomState(seed)
    ru, ri = rng.randint(0, n, size=count), rng.randint(0, n, size=count)
    return coo_matrix((np.ones(count, np.float32), (ru, ri)), shape=(n, n)).tocsr()


# (matrix, slot dtype): 16-bit slots where remainder + flags fit, else 32
CASES = {
    "500x300": (lambda: _random_csr(500, 300, 0.05, 1), np.uint16),
    "5000x2000": (lambda: _random_csr(5000, 2000, 0.01, 2), np.uint16),
    "3x2": (lambda: _random_csr(3, 2, 0.5, 3), np.uint16),
    "2^19 ids": (lambda: _huge_id_space(4), np.uint32),
    # 2**k rows and columns: the largest ids are 2**a_bits - 1, 2**b_bits - 1
    "1024x512 pow2": (lambda: _random_csr(1024, 512, 0.02, 5), np.uint16),
}


def _queries(M, seed, n=20000):
    """Random pairs, the largest ids among them, and every stored pair."""
    users, items = M.shape
    rng = np.random.RandomState(seed)
    qu = rng.randint(0, users, size=n).astype(np.uint32)
    qi = rng.randint(0, items, size=n).astype(np.uint32)
    qu[:8], qi[:8] = users - 1, items - 1
    qi[8:16] = items - 1
    stored_u = np.repeat(np.arange(users, dtype=np.uint32), np.ediff1d(M.indptr))
    return (np.concatenate([qu, stored_u]),
            np.concatenate([qi, M.indices.astype(np.uint32)]))


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_equals_jax_table(case):
    make, dtype = CASES[case]
    M = make()
    want = jax_membership.build_pair_table(M)
    got = membership.build_pair_table(M)
    assert got.table.dtype == want.table.dtype == dtype
    assert got.bits == (want.a_bits, want.b_bits, want.bucket_bits)
    np.testing.assert_array_equal(got.table, want.table)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bucket_and_remainder_bit_for_bit(case):
    M = CASES[case][0]()
    bits = membership.build_pair_table(M).bits
    qu, qi = _queries(M, seed=7)
    want = jax_membership._bucket_rem(qu, qi, *bits, np)
    for got in (membership._bucket_rem(qu, qi, *bits),  # numpy int64 words
                [t.numpy() for t in membership._bucket_rem(_t(qu), _t(qi), *bits)]):
        np.testing.assert_array_equal(got[0], want[0].astype(np.int64))
        np.testing.assert_array_equal(got[1], want[1].astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_bit_for_bit_with_jnp_and_numpy(case):
    M = CASES[case][0]()
    pt = jax_membership.build_pair_table(M)
    bits = (pt.a_bits, pt.b_bits, pt.bucket_bits)
    qu, qi = _queries(M, seed=11)
    got = membership._member(torch.as_tensor(pt.table.astype(np.int32)), _t(qu), _t(qi),
                             *bits).numpy()
    with_np = jax_membership._member(pt.table, qu, qi, *bits, np)
    with_jnp = np.asarray(jax_membership._member(jnp.asarray(pt.table), jnp.asarray(qu),
                                                 jnp.asarray(qi), *bits, jnp))
    np.testing.assert_array_equal(got, with_np)
    np.testing.assert_array_equal(got, with_jnp)
    # every stored pair is found, and the random pairs agree with the truth
    n_stored = M.nnz
    assert got[-n_stored:].all()
    truth = set(zip(*M.nonzero()))
    np.testing.assert_array_equal(
        got[:-n_stored], [(u, i) in truth for u, i in zip(qu[:-n_stored], qi[:-n_stored])])


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_fallback_placement_exact(case, monkeypatch):
    """Without the native library the numpy placement builds the JAX
    package's numpy table, and it is just as exact."""
    M = CASES[case][0]()
    monkeypatch.setattr(native, "cuckoo_build", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "cuckoo_build", lambda *a, **k: None)
    got = membership.build_pair_table(M)
    want = jax_membership.build_pair_table(M)
    np.testing.assert_array_equal(got.table, want.table)
    qu, qi = _queries(M, seed=13)
    np.testing.assert_array_equal(got.member(qu, qi),
                                  jax_membership._member(want.table, qu, qi, *got.bits, np))
    assert got.member(*_queries(M, seed=13, n=0)).all()


def test_native_library_builds_the_table():
    M = CASES["5000x2000"][0]()
    pt = membership.build_pair_table(M)
    u = np.repeat(np.arange(M.shape[0], dtype=np.uint32), np.ediff1d(M.indptr))
    nat = native.cuckoo_build(u, M.indices, *pt.bits)
    assert nat is not None and nat.dtype == np.uint32
    np.testing.assert_array_equal(nat.astype(np.uint16), pt.table)


def test_row_ids_argument_and_empty_matrix():
    M = CASES["500x300"][0]()
    u = np.repeat(np.arange(500, dtype=np.int32), np.ediff1d(M.indptr))
    np.testing.assert_array_equal(membership.build_pair_table(M, row_ids=u).table,
                                  membership.build_pair_table(M).table)
    assert membership.build_pair_table(csr_matrix((5, 5), dtype=np.float32)) is None


def test_device_table_upload_keeps_values():
    for case in ("500x300", "2^19 ids"):
        pt = membership.build_pair_table(CASES[case][0]())
        dev = pt.to_device("cpu")
        assert dev.dtype == torch.int32
        np.testing.assert_array_equal(dev.numpy().astype(np.int64), pt.table.astype(np.int64))
