"""The last.fm-360k artist play-count dataset.

Same hosted HDF5 as the reference's ``implicit/datasets/lastfm.py``.
"""

import logging

import numpy as np
from scipy.sparse import coo_matrix, csr_matrix

from . import _download

log = logging.getLogger("implicit_tpu_torch")

URL = "https://github.com/benfred/recommender_data/releases/download/v1.0/lastfm_360k.hdf5"


def get_lastfm():
    """Returns (artistids, userids, plays) — plays is an artists x users CSR."""
    import h5py  # delayed: optional dependency

    filename = _download.fetch_cached(URL, "lastfm_360k.hdf5")
    with h5py.File(filename, "r") as f:
        m = f.get("artist_user_plays")
        plays = csr_matrix((m.get("data"), m.get("indices"), m.get("indptr")))
        return np.array(f["artist"].asstr()[:]), np.array(f["user"].asstr()[:]), plays


def generate_dataset(filename, outputfilename):
    """Converts the raw usersha1-artmbid-artname-plays.tsv dump into HDF5.

    Raw data: http://ocelma.net/MusicRecommendationDataset/lastfm-360K.html
    """
    import pandas

    data = pandas.read_table(
        filename, usecols=[0, 2, 3], names=["user", "artist", "plays"], na_filter=False
    )
    data["user"] = data["user"].astype("category")
    data["artist"] = data["artist"].astype("category")
    plays = coo_matrix(
        (
            data["plays"].astype(np.float32),
            (data["artist"].cat.codes.copy(), data["user"].cat.codes.copy()),
        )
    ).tocsr()
    _write_hdf5(
        outputfilename,
        plays,
        "artist_user_plays",
        artist=data["artist"].cat.categories,
        user=data["user"].cat.categories,
    )


def _write_hdf5(outputfilename, csr, groupname, **labels):
    import h5py

    with h5py.File(outputfilename, "w") as f:
        g = f.create_group(groupname)
        g.create_dataset("data", data=csr.data)
        g.create_dataset("indptr", data=csr.indptr)
        g.create_dataset("indices", data=csr.indices)
        dt = h5py.special_dtype(vlen=str)
        for name, values in labels.items():
            dset = f.create_dataset(name, (len(values),), dtype=dt)
            dset[:] = values
