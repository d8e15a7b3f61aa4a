"""Dataset loaders of the port: cached HDF5 downloads of the standard
implicit-feedback sets, the counterpart of ``implicit_tpu/datasets/``.

last.fm-360k (``lastfm``), MovieLens 100k / 1m / 10m / 20m (``movielens``),
the Million Song Dataset (``million_song_dataset``), reddit and sketchfab,
each with a ``get_*()`` reader returning (labels..., csr_matrix) and a
``generate_dataset`` converter from the raw dump; ``_download`` keeps the
cache (``IMPLICIT_DATASETS_PATH``, else ``~/implicit_datasets``, read on
each call) and ``probe_cached`` / ``movielens.probe_movielens`` look for a
file there without downloading. A ``get_*`` reader downloads only where its
file is missing. ``stdlib_corpus`` reads the real interaction matrix
committed with the package (``_data/stdlib_corpus.npz``), and ``synthetic``
generates matrices of the benchmarks' shapes.

The loaders are host numpy and scipy; ``h5py`` and ``pandas`` (the
``datasets`` extra) are imported inside the functions that need them.
"""
