"""The Million Song Dataset taste-profile play counts.

Same hosted HDF5 as the reference's ``implicit/datasets/million_song_dataset.py``.
"""

import numpy as np
from scipy.sparse import coo_matrix, csr_matrix

from . import _download

URL = (
    "https://github.com/benfred/recommender_data/releases/download/v1.0/"
    "msd_taste_profile.hdf5"
)


def get_msd_taste_profile():
    """Returns (trackinfo, users, plays) — plays is a tracks x users CSR."""
    import h5py  # delayed: optional dependency

    filename = _download.fetch_cached(URL, "msd_taste_profile.hdf5")
    with h5py.File(filename, "r") as f:
        m = f.get("track_user_plays")
        plays = csr_matrix((m.get("data"), m.get("indices"), m.get("indptr")))
        return np.array(f["track"]), np.array(f["user"]), plays


def generate_dataset(triplets_filename, summary_filename, outputfilename):
    """Converts the raw MSD taste-profile triplets + track summary into HDF5.

    Raw data: https://labrosa.ee.columbia.edu/millionsong/tasteprofile
    """
    import h5py
    import pandas

    data = pandas.read_table(
        triplets_filename, names=["user", "track", "plays"], na_filter=False
    )
    data["user"] = data["user"].astype("category")
    data["track"] = data["track"].astype("category")

    plays = coo_matrix(
        (
            data["plays"].astype(np.float32),
            (data["track"].cat.codes.copy(), data["user"].cat.codes.copy()),
        )
    ).tocsr()

    track_ids = data["track"].cat.categories

    # map track metadata (id, artist, title) from the summary file
    track_info = np.empty(shape=(len(track_ids), 3), dtype=object)
    with h5py.File(summary_filename, "r") as summary:
        songs = summary["metadata"]["songs"]
        lookup = {row["song_id"].decode(): row for row in songs}
        for i, track_id in enumerate(track_ids):
            row = lookup.get(track_id)
            if row is not None:
                track_info[i] = [
                    track_id,
                    row["artist_name"].decode(),
                    row["title"].decode(),
                ]
            else:
                track_info[i] = [track_id, "", ""]

    with h5py.File(outputfilename, "w") as f:
        g = f.create_group("track_user_plays")
        g.create_dataset("data", data=plays.data)
        g.create_dataset("indptr", data=plays.indptr)
        g.create_dataset("indices", data=plays.indices)

        dt = h5py.special_dtype(vlen=str)
        dset = f.create_dataset("track", track_info.shape, dtype=dt)
        dset[:] = track_info
        user = list(data["user"].cat.categories)
        dset = f.create_dataset("user", (len(user),), dtype=dt)
        dset[:] = user
