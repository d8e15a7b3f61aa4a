"""MovieLens rating datasets (100k / 1m / 10m / 20m).

Same hosted HDF5 files as the reference's ``implicit/datasets/movielens.py``.
"""

import logging
import os

import numpy as np
from scipy.sparse import coo_matrix, csr_matrix

from . import _download

log = logging.getLogger("implicit_tpu_torch")

URL_BASE = "https://github.com/benfred/recommender_data/releases/download/v1.0/"


def get_movielens(variant="20m"):
    """Gets a MovieLens dataset.

    Parameters
    ----------
    variant : string — one of '20m', '10m', '1m' or '100k'

    Returns
    -------
    (movies, ratings) : movie title array and a movies x users CSR of ratings.
    """
    import h5py  # delayed: optional dependency

    filename = f"movielens_{variant}.hdf5"
    path = _download.fetch_cached(URL_BASE + filename, filename)

    with h5py.File(path, "r") as f:
        m = f.get("movie_user_ratings")
        ratings = csr_matrix((m.get("data"), m.get("indices"), m.get("indptr")))
        return np.array(f["movie"].asstr()[:]), ratings


def probe_movielens(variant="20m"):
    """Local HDF5 path for ``variant`` if already cached, else None.

    Never downloads. Quality gates use this to run the reference's real
    MovieLens protocol (its ``tests/evaluation_test.py``) automatically
    whenever the data file is present (``IMPLICIT_DATASETS_PATH``
    or ``~/implicit_datasets``), falling back to synthetic data otherwise.
    """
    return _download.probe_cached(f"movielens_{variant}.hdf5")


def generate_dataset(path, variant="20m", outputpath="."):
    """Converts raw grouplens.org dumps into the HDF5 format used here."""
    import pandas

    filename = os.path.join(outputpath, f"movielens_{variant}.hdf5")

    if variant == "20m":
        ratings = pandas.read_csv(os.path.join(path, "ratings.csv"))
        movies = pandas.read_csv(os.path.join(path, "movies.csv"))
    elif variant == "100k":
        ratings = pandas.read_table(
            os.path.join(path, "u.data"),
            names=["userId", "movieId", "rating", "timestamp"],
        )
        movies = pandas.read_csv(
            os.path.join(path, "u.item"),
            names=["movieId", "title"],
            usecols=[0, 1],
            delimiter="|",
            encoding="ISO-8859-1",
        )
    else:
        ratings = pandas.read_csv(
            os.path.join(path, "ratings.dat"),
            delimiter="::",
            names=["userId", "movieId", "rating", "timestamp"],
            engine="python",
        )
        movies = pandas.read_csv(
            os.path.join(path, "movies.dat"),
            delimiter="::",
            names=["movieId", "title", "genres"],
            engine="python",
            encoding="ISO-8859-1",
        )

    _hfd5_from_dataframe(ratings, movies, filename)


def _hfd5_from_dataframe(ratings, movies, outputfilename):
    import h5py

    # transform ratings into a sparse movies x users matrix
    m = coo_matrix(
        (ratings["rating"].astype(np.float32), (ratings["movieId"], ratings["userId"]))
    ).tocsr()

    with h5py.File(outputfilename, "w") as f:
        g = f.create_group("movie_user_ratings")
        g.create_dataset("data", data=m.data)
        g.create_dataset("indptr", data=m.indptr)
        g.create_dataset("indices", data=m.indices)

        titles = np.empty(m.shape[0], dtype=object)
        titles[movies["movieId"]] = movies["title"]
        dt = h5py.special_dtype(vlen=str)
        dset = f.create_dataset("movie", (len(titles),), dtype=dt)
        dset[:] = [t if t is not None else "" for t in titles]
