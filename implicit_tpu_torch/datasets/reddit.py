"""The reddit link up/down-vote dataset.

Same hosted HDF5 as the reference's ``implicit/datasets/reddit.py``.
"""

import numpy as np
from scipy.sparse import coo_matrix, csr_matrix

from . import _download

URL = "https://github.com/benfred/recommender_data/releases/download/v1.0/reddit.hdf5"


def get_reddit():
    """Returns an items x users CSR of reddit votes (+1 up / -1 down)."""
    import h5py  # delayed: optional dependency

    filename = _download.fetch_cached(URL, "reddit.hdf5")
    with h5py.File(filename, "r") as f:
        m = f.get("item_user_ratings")
        return csr_matrix((m.get("data"), m.get("indices"), m.get("indptr")))


def generate_dataset(filename, outputfilename):
    """Converts the raw reddit voting CSV into HDF5.

    Raw data: https://www.reddit.com/r/redditdev/comments/dtg4j/
    """
    import h5py
    import pandas

    data = pandas.read_table(filename, names=["user", "item", "rating"], na_filter=False)
    data["user"] = data["user"].astype("category")
    data["item"] = data["item"].astype("category")

    ratings = coo_matrix(
        (
            data["rating"].astype(np.float32),
            (data["item"].cat.codes.copy(), data["user"].cat.codes.copy()),
        )
    ).tocsr()

    with h5py.File(outputfilename, "w") as f:
        g = f.create_group("item_user_ratings")
        g.create_dataset("data", data=ratings.data)
        g.create_dataset("indptr", data=ratings.indptr)
        g.create_dataset("indices", data=ratings.indices)
