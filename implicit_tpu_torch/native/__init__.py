"""ctypes binding for the host routines (``cuckoo_build``, ``topk_rows``,
``knn_all_pairs``).

The C++ source is the port's own ``native/packer.cpp`` (those routines of
the JAX package's packer, copied so that the port reads nothing of that
package). It is built with g++ on first use, with the JAX package's flags
(so the item-item similarity comes out bit for bit the same), into
``implicit_tpu_torch/build/`` under a name that carries the hash of the
source and the flags. Without a compiler, or without the source, the numpy
paths build the same arrays (``knn_all_pairs`` returns None and its caller
takes the blocked scipy product): this is host code, not a device kernel.
The bucketed CSR is packed by torch ops (``sparse._pack_side``), not here.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile

import numpy as np

log = logging.getLogger("implicit_tpu_torch")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "packer.cpp")
BUILD_DIR = os.path.join(_PKG, "build")

# the JAX package's packer flags: -march=native decides whether the KNN
# accumulation contracts to FMAs, so both builds must share it
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-fopenmp"]

_lib = None
_tried = False


def _build(src, out):
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a temporary name and rename: concurrent processes (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *_FLAGS, src, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded packer library, building it if needed, else None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
        out = os.path.join(BUILD_DIR, f"packer-{digest}.so")
        if not os.path.exists(out):
            _build(_SRC, out)
        lib = ctypes.CDLL(out)
        lib.cuckoo_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.cuckoo_build.restype = ctypes.c_int32
        lib.topk_rows.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.topk_rows.restype = ctypes.c_int64
        lib.knn_all_pairs.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.knn_all_pairs.restype = None
        lib.knn_max_threads.argtypes = []
        lib.knn_max_threads.restype = ctypes.c_int32
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as exc:
        log.debug("host library unavailable, taking the numpy paths: %s", exc)
        _lib = None
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def topk_rows(indptr, indices, data, K, row_offset=0):
    """Per-row top-K of a CSR block -> (rows, cols, vals) COO triples."""
    if K <= 0:
        empty = np.array([], dtype=np.int32)
        return empty, empty.copy(), np.array([], dtype=np.float64)
    lib = get_lib()
    rows = len(indptr) - 1
    if lib is not None:
        indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
        indices32 = np.ascontiguousarray(indices, dtype=np.int32)
        data64 = np.ascontiguousarray(data, dtype=np.float64)
        cap = rows * K
        out_r = np.empty(cap, dtype=np.int32)
        out_c = np.empty(cap, dtype=np.int32)
        out_v = np.empty(cap, dtype=np.float64)
        written = lib.topk_rows(
            rows, K, _ptr(indptr64, ctypes.c_int64), _ptr(indices32, ctypes.c_int32),
            _ptr(data64, ctypes.c_double), row_offset,
            _ptr(out_r, ctypes.c_int32), _ptr(out_c, ctypes.c_int32),
            _ptr(out_v, ctypes.c_double),
        )
        return out_r[:written], out_c[:written], out_v[:written]

    # numpy fallback: per-row argpartition
    out_r, out_c, out_v = [], [], []
    indices = np.asarray(indices)
    data = np.asarray(data)
    for r in range(rows):
        lo, hi = indptr[r], indptr[r + 1]
        if lo == hi:
            continue
        vals = data[lo:hi]
        cols = indices[lo:hi]
        if len(vals) > K:
            sel = np.argpartition(vals, -K)[-K:]
            vals, cols = vals[sel], cols[sel]
        out_r.append(np.full(len(cols), row_offset + r, dtype=np.int32))
        out_c.append(cols.astype(np.int32))
        out_v.append(vals.astype(np.float64))
    if not out_r:
        empty = np.array([], dtype=np.int32)
        return empty, empty.copy(), np.array([], dtype=np.float64)
    return np.concatenate(out_r), np.concatenate(out_c), np.concatenate(out_v)


def knn_effective_threads(items, num_threads=0):
    """Worker count the fused KNN kernel will actually run with.

    Each worker thread owns a dense ``items``-sized stamped accumulator
    (~13B/item incl. the stamp and touched arrays), so the auto count
    (``num_threads=0``) is capped to keep total accumulator memory inside
    a fixed budget — the fused kernel stays as memory-bounded as the
    blocked-scipy path it replaced (one thread is always allowed: the
    dense accumulator IS the algorithm). Both the request and the auto
    count are clamped by ``knn_max_threads`` — 1 when the shared object
    was built without OpenMP, where the kernel runs single-threaded no
    matter what was asked. Shared with the
    host-vs-device dispatch cost model
    (:func:`~implicit_tpu_torch.nearest_neighbours._device_knn_wins`) so
    the estimate and the execution agree.
    """
    lib = get_lib()
    hw = int(lib.knn_max_threads()) if lib is not None else (os.cpu_count() or 1)
    if num_threads > 0:
        return min(num_threads, hw)
    budget = int(os.environ.get("IMPLICIT_KNN_ACC_BUDGET", 2 << 30))
    return min(hw, max(1, budget // max(1, items * 13)))


def knn_all_pairs(item_users, user_items, K, num_threads=0):
    """Fused AᵀA + per-row top-K over CSR inputs -> (rows, cols, vals) COO.

    ``item_users`` is (items x users), ``user_items`` its transpose; the
    similarity row i is item_users[i] @ user_items, K-sparsified in place by
    a dense-accumulator SMMP (the sparse product is never materialized).
    Returns None when the native library is unavailable — callers fall back
    to the blocked scipy formulation.

    Thread count is budgeted per :func:`knn_effective_threads`; the
    ``(rows, K)`` output scratch is likewise bounded by chunking the row
    range (``IMPLICIT_KNN_OUT_BUDGET``, default 512MB) so memory scales
    with the real output, not ``items * K``, at huge-catalog sizes.
    """
    lib = get_lib()
    if lib is None:
        return None
    items = item_users.shape[0]
    if K <= 0:
        empty32 = np.array([], dtype=np.int32)
        return empty32, empty32.copy(), np.array([], dtype=np.float64)
    num_threads = knn_effective_threads(items, num_threads)
    ip_iu = np.ascontiguousarray(item_users.indptr, dtype=np.int64)
    ix_iu = np.ascontiguousarray(item_users.indices, dtype=np.int32)
    dt_iu = np.ascontiguousarray(item_users.data, dtype=np.float64)
    ip_ui = np.ascontiguousarray(user_items.indptr, dtype=np.int64)
    ix_ui = np.ascontiguousarray(user_items.indices, dtype=np.int32)
    dt_ui = np.ascontiguousarray(user_items.data, dtype=np.float64)
    out_budget = int(os.environ.get("IMPLICIT_KNN_OUT_BUDGET", 1 << 29))
    block = max(1, min(items, out_budget // max(1, K * 12)))
    out_c = np.empty(block * K, dtype=np.int32)
    out_v = np.empty(block * K, dtype=np.float64)
    out_n = np.zeros(block, dtype=np.int32)
    arange_k = np.arange(K, dtype=np.int32)[None, :]
    triples = []
    for start in range(0, items, block):
        stop = min(start + block, items)
        n = stop - start
        lib.knn_all_pairs(
            items, K, start, stop,
            _ptr(ip_iu, ctypes.c_int64), _ptr(ix_iu, ctypes.c_int32),
            _ptr(dt_iu, ctypes.c_double),
            _ptr(ip_ui, ctypes.c_int64), _ptr(ix_ui, ctypes.c_int32),
            _ptr(dt_ui, ctypes.c_double), int(num_threads),
            _ptr(out_c, ctypes.c_int32), _ptr(out_v, ctypes.c_double),
            _ptr(out_n, ctypes.c_int32),
        )
        cnt = out_n[:n]
        rows = np.repeat(np.arange(start, stop, dtype=np.int32), cnt)
        keep = (arange_k < cnt[:, None]).reshape(-1)
        triples.append((rows, out_c[: n * K][keep], out_v[: n * K][keep]))
    if len(triples) == 1:
        return triples[0]
    return tuple(np.concatenate([t[i] for t in triples]) for i in range(3))


def cuckoo_build(u, i, a_bits, b_bits, bucket_bits):
    """Native bucketized-cuckoo placement for the pair-membership table.

    Returns the (nbuckets, 4) uint32 table, or None when the native library
    is unavailable or placement failed (the caller uses the numpy build).
    """
    lib = get_lib()
    if lib is None:
        return None
    u32 = np.ascontiguousarray(u, dtype=np.uint32)
    i32 = np.ascontiguousarray(i, dtype=np.uint32)
    table = np.zeros(((1 << bucket_bits), 4), dtype=np.uint32)
    rc = lib.cuckoo_build(
        _ptr(u32, ctypes.c_uint32), _ptr(i32, ctypes.c_uint32),
        len(u32), a_bits, b_bits, bucket_bits, _ptr(table, ctypes.c_uint32),
    )
    return table if rc == 0 else None
