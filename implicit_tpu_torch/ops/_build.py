"""nvcc build and ctypes load of the hand-written CUDA kernels (ops/csrc).

Each ``csrc/<name>.cu`` is compiled for Hopper (``sm_90a``) into a shared
library with a plain C interface, ``build/<name>-<hash>.so`` in the package
directory, where the hash covers the source, every header in ``csrc/`` and
the flags: a library is rebuilt when any of them changes. Builds happen on first
use, never at import, and a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_OPS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_OPS, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_OPS), "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, in BUILD_LOGS
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_uint64


def _variants(name, args):
    """The f32 / bf16 / i8 entry points of one kernel: the int8 one takes
    the per-row scales right after the table."""
    return {f"{name}_f32": [_P, *args], f"{name}_bf16": [_P, *args],
            f"{name}_i8": [_P, _P, *args]}


# C signatures of every entry point, by library
SIGNATURES = {
    # (table, idx, dat, x0, yty, out, C, L, F, cg_steps, stream)
    "cg_full": _variants("cg_full", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # (table, idx, dat, x0, yty, A, b, part, out, C, L, F, cg_steps, stream), and
    # the partial scratch's slice count (C, L, F)
    "gramian_cg": {**_variants("gramian_cg",
                               [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
                   "gramian_cg_slices": [_I, _I, _I]},
    # (table, idx, w, bv, v, out, part, C, L, F, slices, alpha, beta, stream), and
    # the slice count (table type 0 f32 / 1 bf16 / 2 int8, table, C, L, F)
    "weighted_matvec": {**_variants("weighted_matvec",
                                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P]),
                        "weighted_matvec_slices": [_I, _P, _I, _I, _I]},
    # (yty, v, s, t, x, r, p, rs, act, C, F, first, stream)
    "cg_update": {"cg_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    # (state_hi, state_lo, inc_hi, inc_lo, n, buffered, kept, out, storage, blocks, stream)
    "pcg64_uniform": {"pcg64_uniform": [_U64, _U64, _U64, _U64, ctypes.c_longlong, _I,
                                        ctypes.c_uint32, _P, _I, _I, _P]},
}

_libs = {}
BUILD_SECONDS = {}
BUILD_LOGS = {}  # nvcc's output per library built by this process


def nvcc_path():
    """The nvcc to build with: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def _digest(name):
    """Hash of the flags, ``<name>.cu`` and every header in ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path(name):
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def _start_build(name, out):
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, cmd


def _finish_build(name, out, proc, tmp, cmd, t0):
    log, _ = proc.communicate()
    try:
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} ({' '.join(cmd)}):\n{log.decode(errors='replace')}")
        # rename into place: a concurrent loader never sees a partial file
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOGS[name] = log.decode(errors="replace")


def load(*names):
    """Builds (where needed, concurrently) and loads the named libraries.

    Returns ``{name: ctypes.CDLL}`` with every entry point's argtypes set.
    """
    names = names or tuple(SIGNATURES)
    pending = []
    for name in names:
        if name in _libs:
            continue
        out = library_path(name)
        if not os.path.exists(out):
            t0 = time.perf_counter()
            pending.append((name, out, *_start_build(name, out), t0))
    try:
        for name, out, proc, tmp, cmd, t0 in pending:
            _finish_build(name, out, proc, tmp, cmd, t0)
    finally:
        for _, _, proc, tmp, _, _ in pending:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    for name in names:
        if name in _libs:
            continue
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.als_error_string.argtypes = [ctypes.c_int]
        lib.als_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return {name: _libs[name] for name in names}


def check(lib, code, what):
    """Raises if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.als_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
