"""Download helper with a local cache directory and a progress bar."""

import os
import tempfile
from urllib.request import urlopen

from tqdm.auto import tqdm

LOCAL_CACHE_DIR = os.environ.get(
    "IMPLICIT_DATASETS_PATH",
    os.path.join(os.path.expanduser("~"), "implicit_datasets"),
)

_CHUNK_BYTES = 1 << 18


def download_file(url, local_filename):
    """Streams ``url`` into ``local_filename``, showing a progress bar.

    The stream is written through a temporary file in the target directory
    and renamed into place on completion, so an interrupted download never
    leaves a truncated file behind for :func:`fetch_cached` to mistake for a
    finished one.
    """
    local_filename = os.path.abspath(local_filename)
    directory = os.path.dirname(local_filename)
    os.makedirs(directory, exist_ok=True)

    fd, partial = tempfile.mkstemp(dir=directory, suffix=".part")
    try:
        with urlopen(url) as response, os.fdopen(fd, "wb") as out:
            length = response.headers.get("Content-Length")
            bar = tqdm(
                total=int(length) if length else None,
                unit="B",
                unit_scale=True,
                desc=os.path.basename(local_filename),
            )
            with bar:
                while True:
                    chunk = response.read(_CHUNK_BYTES)
                    if not chunk:
                        break
                    out.write(chunk)
                    bar.update(len(chunk))
        os.replace(partial, local_filename)
    except BaseException:
        if os.path.exists(partial):
            os.unlink(partial)
        raise
    return local_filename


def fetch_cached(url, filename):
    """Returns the local path of ``filename``, downloading from ``url`` if absent."""
    local = probe_cached(filename)
    if local is None:
        local = os.path.join(_cache_dir(), filename)
        download_file(url, local)
    return local


def _cache_dir():
    """The live cache directory (re-reads the env var so tests can point it)."""
    return os.environ.get("IMPLICIT_DATASETS_PATH", LOCAL_CACHE_DIR)


def probe_cached(filename):
    """Path of ``filename`` in the cache dir if it already exists, else None.

    Never touches the network: the hook that lets quality gates switch from
    synthetic data to the real dataset once a file is provided (through
    ``IMPLICIT_DATASETS_PATH`` or the default ``~/implicit_datasets``).
    """
    local = os.path.join(_cache_dir(), filename)
    return local if os.path.isfile(local) else None
