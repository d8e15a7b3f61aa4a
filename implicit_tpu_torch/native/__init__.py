"""ctypes binding for the host routines (``pack_ragged``, ``cuckoo_build``).

The C++ source is the port's own ``native/packer.cpp`` (the ``pack_ragged``
and ``cuckoo_build`` routines of the JAX package's packer, copied so that
the port reads nothing of that package). It is built with g++ on first use
into ``implicit_tpu_torch/build/`` under a name that carries the source's
hash. Without a compiler, or without the source, the numpy paths build the
same arrays: this is host code, not a device kernel.
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

_lib = None
_tried = False


def _build(src, out):
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a temporary name and rename: concurrent processes (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp", src, "-o", tmp]
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
            digest = hashlib.sha256(fh.read()).hexdigest()[:12]
        out = os.path.join(BUILD_DIR, f"packer-{digest}.so")
        if not os.path.exists(out):
            _build(_SRC, out)
        lib = ctypes.CDLL(out)
        lib.pack_ragged.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.pack_ragged.restype = None
        lib.cuckoo_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.cuckoo_build.restype = ctypes.c_int32
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as exc:
        log.debug("host packer unavailable, packing with numpy: %s", exc)
        _lib = None
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_ragged(indptr, indices, data, row_sel, L, dtype=np.float32):
    """Padded (len(row_sel), L) index/data blocks for the selected CSR rows."""
    dtype = np.dtype(dtype)
    count = len(row_sel)
    lib = get_lib() if dtype == np.float32 else None  # the C packer is f32-only
    if lib is not None:
        indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
        indices32 = np.ascontiguousarray(indices, dtype=np.int32)
        data32 = np.ascontiguousarray(data, dtype=np.float32)
        sel32 = np.ascontiguousarray(row_sel, dtype=np.int32)
        out_idx = np.empty((count, L), dtype=np.int32)
        out_dat = np.empty((count, L), dtype=np.float32)
        lib.pack_ragged(
            _ptr(indptr64, ctypes.c_int64), _ptr(indices32, ctypes.c_int32),
            _ptr(data32, ctypes.c_float), _ptr(sel32, ctypes.c_int32),
            count, L, _ptr(out_idx, ctypes.c_int32), _ptr(out_dat, ctypes.c_float),
        )
        return out_idx, out_dat

    # vectorized ragged -> padded scatter
    indptr = np.asarray(indptr, dtype=np.int64)
    sel = np.asarray(row_sel)
    lens = (indptr[sel + 1] - indptr[sel]).astype(np.int64)
    out_idx = np.zeros((count, L), dtype=np.int32)
    out_dat = np.zeros((count, L), dtype=dtype)
    total = int(lens.sum())
    if total:
        within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
        src = np.repeat(indptr[sel], lens) + within
        flat = np.repeat(np.arange(count, dtype=np.int64) * L, lens) + within
        out_idx.reshape(-1)[flat] = np.asarray(indices, dtype=np.int32)[src]
        out_dat.reshape(-1)[flat] = np.asarray(data, dtype=dtype)[src]
    return out_idx, out_dat


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
