"""The JAX package's native library, loaded for the tests that hold the
port's host routines to it bit for bit (``tests/test_torch_knn.py``,
``tests/test_torch_membership.py``).

``implicit_tpu/native`` builds ``_native.so`` in place at first use: g++
writes the final path. Under pytest-xdist every worker that finds the file
missing (a fresh checkout has none: ``*.so`` is gitignored) starts its own
build, and a worker that loads the file while another is still writing it
gets an ``OSError``; the package then keeps ``_lib = None`` for the rest of
that worker's life, so ``knn_all_pairs`` returns None and
``knn_effective_threads`` falls back to ``os.cpu_count()``.

:func:`jax_native_lib` repairs that from the outside. Under an exclusive
``fcntl.flock`` it builds the library with the package's own command into a
temporary name and renames it into place, then resets the package's
``_tried`` flag and loads the finished file. The two test modules call it
while they are imported, so with ``-n 6`` the first worker that collects
them builds, the others wait on the lock and then load, and every worker
has finished collecting, and so holds a complete library, before any test
runs: the JAX package's own tests (``tests/test_knn.py``) find it too. A
library that still cannot be loaded is an error with its reason, never a
skip.
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile
import time

import pytest

from implicit_tpu import native as jnative
from implicit_tpu_torch import native

# the port's build directory (gitignored): the lock file lives there, so
# nothing is written into the JAX package's tree but the library itself
LOCK = os.path.join(native.BUILD_DIR, "jax_native.lock")

_ERROR = None


def _stale():
    so, src = jnative._SO, jnative._SRC
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def _build_and_rename():
    """The package's ``_build`` (its g++ command and flags) into a temporary
    name in the same directory, renamed over ``_SO``: a reader sees the old
    file or the finished one, never a half-written one."""
    final = jnative._SO
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(final))
    os.close(fd)
    try:
        jnative._SO = tmp
        jnative._build()
        os.replace(tmp, final)
    finally:
        jnative._SO = final
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(attempts=50, pause=0.1):
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    with open(LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if _stale():
                _build_and_rename()
            reason = None
            for _ in range(attempts):
                jnative._lib, jnative._tried = None, False
                if jnative.get_lib() is not None:
                    return None
                try:  # get_lib swallows the reason: ask the loader for it
                    ctypes.CDLL(jnative._SO)
                    reason = "the library loads but get_lib() returned None"
                except OSError as exc:
                    reason = f"{type(exc).__name__}: {exc}"
                time.sleep(pause)
            return reason
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def jax_native_lib():
    """The JAX package's loaded native library; raises with the reason when
    it cannot be built or loaded."""
    global _ERROR
    if jnative._lib is None and _ERROR is None:
        try:
            _ERROR = _load()
        except (OSError, subprocess.CalledProcessError) as exc:
            _ERROR = f"building {jnative._SO} failed: {exc}"
    if jnative._lib is None:
        raise RuntimeError(f"the JAX package's native library is not loaded: {_ERROR}")
    return jnative._lib


@pytest.fixture(autouse=True)
def jax_native_loaded():
    """Fails the test, with the reason, when the library is not loaded; the
    modules that compare with it import this fixture (it is autouse there)."""
    return jax_native_lib()


# build and load while the importing module is collected, before any test of
# any worker runs; a failure is kept and reported by the fixture
try:
    jax_native_lib()
except RuntimeError:
    pass


def test_jax_native_library_loads_and_agrees_on_threads():
    """Both libraries load in one process, and both read the OpenMP runtime
    that torch loaded first (``torch.set_num_threads`` moves them alike): so
    the two ``knn_effective_threads`` agree, as the KNN parity tests need."""
    lib = jax_native_lib()
    port = native.get_lib()
    assert port is not None
    assert int(lib.knn_max_threads()) == int(port.knn_max_threads())
    for items, threads in ((80, 0), (5_000_000, 0), (1000, 3)):
        assert (native.knn_effective_threads(items, threads)
                == jnative.knn_effective_threads(items, threads))
