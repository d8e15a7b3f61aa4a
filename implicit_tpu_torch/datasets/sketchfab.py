"""The sketchfab model-likes dataset.

Same hosted HDF5 as the reference's ``implicit/datasets/sketchfab.py``.
"""

import numpy as np
from scipy.sparse import coo_matrix, csr_matrix

from . import _download

URL = "https://github.com/benfred/recommender_data/releases/download/v1.0/sketchfab.hdf5"


def get_sketchfab():
    """Returns (items, users, likes) — likes is an items x users CSR."""
    import h5py  # delayed: optional dependency

    filename = _download.fetch_cached(URL, "sketchfab.hdf5")
    with h5py.File(filename, "r") as f:
        m = f.get("item_user_likes")
        likes = csr_matrix((m.get("data"), m.get("indices"), m.get("indptr")))
        return np.array(f["item"]), np.array(f["user"]), likes


def generate_dataset(filename, outputfilename):
    """Converts the raw sketchfab likes PSV into HDF5.

    Raw data: https://github.com/EthanRosenthal/rec-a-sketch
    """
    import h5py
    import pandas

    data = pandas.read_csv(filename, delimiter="|", quotechar="\\")
    data["uid"] = data["uid"].astype("category")
    data["mid"] = data["mid"].astype("category")

    likes = coo_matrix(
        (
            np.ones(len(data), dtype=np.float32),
            (data["mid"].cat.codes.copy(), data["uid"].cat.codes.copy()),
        )
    ).tocsr()

    with h5py.File(outputfilename, "w") as f:
        g = f.create_group("item_user_likes")
        g.create_dataset("data", data=likes.data)
        g.create_dataset("indptr", data=likes.indptr)
        g.create_dataset("indices", data=likes.indices)

        dt = h5py.special_dtype(vlen=str)
        item = list(data["mid"].cat.categories)
        dset = f.create_dataset("item", (len(item),), dtype=dt)
        dset[:] = item
        user = list(data["uid"].cat.categories)
        dset = f.create_dataset("user", (len(user),), dtype=dt)
        dset[:] = user
