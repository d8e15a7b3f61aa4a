"""The port's dataset loaders against the JAX package's, downloading nothing.

Each loader's case writes a small raw dump under ``tmp_path``, converts it
with both packages' ``generate_dataset`` and compares the two HDF5 files
dataset by dataset; then, with ``IMPLICIT_DATASETS_PATH`` pointed at each
package's output in turn, both packages' ``get_*`` results: labels equal,
CSR ``indptr``, ``indices`` and ``data`` exact. ``download_file`` reads a
``file://`` URL; the stdlib corpus is rebuilt from a small tree of ``.py``
files.
"""

import importlib
import os

import numpy as np
import pytest

PACKAGES = ("implicit_tpu", "implicit_tpu_torch")


def _module(package, name):
    return importlib.import_module(f"{package}.datasets.{name}")


# -- raw dumps, small, in each dataset's own format ----------------------------


def _raw_lastfm(raw, rng):
    path = raw / "usersha1-artmbid-artname-plays.tsv"
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(60):
            u, a = rng.integers(0, 12), rng.integers(0, 9)
            name = ["björk", "the beatles", "sigur rós", "ac/dc", "n'sync", "a", "b",
                    "c", "d"][a]
            f.write(f"user{u:02d}\tmbid{a}\t{name}\t{rng.integers(1, 500)}\n")
    return lambda mod, out: mod.generate_dataset(str(path), str(out / "lastfm_360k.hdf5"))


def _movielens_frames(rng):
    n = 80
    ratings = {
        "userId": rng.integers(1, 15, n),
        "movieId": rng.integers(1, 25, n),
        "rating": rng.integers(1, 11, n) / 2.0,
        "timestamp": rng.integers(10**9, 2 * 10**9, n),
    }
    # movie 7 has no title; one title holds the dumps' delimiters
    titles = {m: f"Movie {m}, The ({1990 + m})" for m in range(1, 25) if m != 7}
    titles[3] = "Léon: the Professional | 1994"
    return ratings, titles


def _raw_movielens(variant):
    def write(raw, rng):
        import pandas

        ratings, titles = _movielens_frames(rng)
        movies = pandas.DataFrame({"movieId": list(titles), "title": list(titles.values()),
                                   "genres": "Drama|Comedy"})
        if variant == "20m":
            pandas.DataFrame(ratings).to_csv(raw / "ratings.csv", index=False)
            movies.to_csv(raw / "movies.csv", index=False)
        elif variant == "100k":
            with open(raw / "u.data", "w") as f:
                for row in zip(*ratings.values()):
                    f.write("\t".join(str(v) for v in row) + "\n")
            with open(raw / "u.item", "w", encoding="ISO-8859-1") as f:
                for m, t in titles.items():
                    f.write(f"{m}|{t.replace('|', '/')}|01-Jan-1995||http://x|0|1\n")
        else:
            with open(raw / "ratings.dat", "w") as f:
                for row in zip(*ratings.values()):
                    f.write("::".join(str(v) for v in row) + "\n")
            with open(raw / "movies.dat", "w", encoding="ISO-8859-1") as f:
                for m, t in titles.items():
                    f.write(f"{m}::{t}::Drama|Comedy\n")
        return lambda mod, out: mod.generate_dataset(str(raw), variant, str(out))
    return write


def _raw_msd(raw, rng):
    import h5py

    triplets = raw / "train_triplets.txt"
    with open(triplets, "w") as f:
        for _ in range(70):
            f.write(f"u{rng.integers(0, 10):03x}\tSO{rng.integers(0, 8):04d}\t"
                    f"{rng.integers(1, 40)}\n")
    songs = np.array(
        # SO0005 is missing from the summary: its artist and title stay empty
        [(f"SO{i:04d}".encode(), f"artist {i}".encode(), f"title {i}".encode())
         for i in range(8) if i != 5],
        dtype=[("song_id", "S18"), ("artist_name", "S64"), ("title", "S64")])
    summary = raw / "msd_summary_file.h5"
    with h5py.File(summary, "w") as f:
        f.create_group("metadata").create_dataset("songs", data=songs)
    return lambda mod, out: mod.generate_dataset(
        str(triplets), str(summary), str(out / "msd_taste_profile.hdf5"))


def _raw_reddit(raw, rng):
    path = raw / "reddit_votes.tsv"
    with open(path, "w") as f:
        for _ in range(60):
            f.write(f"user{rng.integers(0, 11)}\tt3_{rng.integers(0, 13):x}\t"
                    f"{rng.choice([-1, 1])}\n")
    return lambda mod, out: mod.generate_dataset(str(path), str(out / "reddit.hdf5"))


def _raw_sketchfab(raw, rng):
    path = raw / "model_likes_anon.psv"
    with open(path, "w") as f:
        f.write("modelname|mid|uid\n")
        for _ in range(50):
            m = rng.integers(0, 9)
            f.write(f"model \\|{m}\\||mid{m:03d}|uid{rng.integers(0, 14):03d}\n")
    return lambda mod, out: mod.generate_dataset(str(path), str(out / "sketchfab.hdf5"))


# case: (module, cache file, reader, reader args, raw-dump writer)
LOADERS = {
    "lastfm": ("lastfm", "lastfm_360k.hdf5", "get_lastfm", (), _raw_lastfm),
    **{f"movielens-{v}": ("movielens", f"movielens_{v}.hdf5", "get_movielens", (v,),
                          _raw_movielens(v)) for v in ("100k", "1m", "10m", "20m")},
    "msd": ("million_song_dataset", "msd_taste_profile.hdf5", "get_msd_taste_profile", (),
            _raw_msd),
    "reddit": ("reddit", "reddit.hdf5", "get_reddit", (), _raw_reddit),
    "sketchfab": ("sketchfab", "sketchfab.hdf5", "get_sketchfab", (), _raw_sketchfab),
}


def _convert_both(case, tmp_path):
    """Writes ``case``'s raw dump and converts it with both packages; returns
    {package: the directory holding its HDF5 file}."""
    module, filename, _, _, write = LOADERS[case]
    raw = tmp_path / "raw"
    raw.mkdir()
    convert = write(raw, np.random.default_rng(sorted(LOADERS).index(case)))
    outs = {}
    for package in PACKAGES:
        out = tmp_path / package
        out.mkdir()
        convert(_module(package, module), out)
        assert (out / filename).is_file()
        outs[package] = out
    return outs


def _hdf5_contents(path):
    import h5py

    contents = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                contents[name] = (obj.dtype.str, obj.shape, obj[()])
            else:
                contents[name] = "group"
        f.visititems(visit)
    return contents


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_generate_dataset_matches_jax(case, tmp_path):
    pytest.importorskip("h5py")
    pytest.importorskip("pandas")
    outs = _convert_both(case, tmp_path)
    filename = LOADERS[case][1]
    want, got = (_hdf5_contents(outs[p] / filename) for p in PACKAGES)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if w == "group":
            assert g == "group", name
            continue
        assert g[:2] == w[:2], name
        assert np.array_equal(g[2], w[2]), name
    if case == "msd":
        track = want["track"][2]
        missing = [row for row in track if row[0] == b"SO0005"]
        assert [list(r) for r in missing] == [[b"SO0005", b"", b""]]


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_get_dataset_matches_jax(case, tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    pytest.importorskip("pandas")
    outs = _convert_both(case, tmp_path)
    module, _, reader, args, _ = LOADERS[case]
    results = {}
    for package in PACKAGES:
        # the cache directory is read on each call
        monkeypatch.setenv("IMPLICIT_DATASETS_PATH", str(outs[package]))
        result = getattr(_module(package, module), reader)(*args)
        results[package] = result if isinstance(result, tuple) else (result,)
    want, got = (results[p] for p in PACKAGES)
    assert len(got) == len(want)
    *want_labels, want_m = want
    *got_labels, got_m = got
    for g, w in zip(got_labels, want_labels):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got_m.shape == want_m.shape and got_m.nnz > 0
    for attr in ("indptr", "indices", "data"):
        g, w = getattr(got_m, attr), getattr(want_m, attr)
        assert g.dtype == w.dtype and np.array_equal(g, w), attr


def test_dataset_probe_honors_env_path(tmp_path, monkeypatch):
    """probe_cached / probe_movielens find files through IMPLICIT_DATASETS_PATH
    without touching the network."""
    from implicit_tpu_torch.datasets import _download
    from implicit_tpu_torch.datasets.movielens import probe_movielens

    monkeypatch.setenv("IMPLICIT_DATASETS_PATH", str(tmp_path))
    assert probe_movielens("100k") is None
    target = tmp_path / "movielens_100k.hdf5"
    target.write_bytes(b"\x89HDF")
    assert probe_movielens("100k") == str(target)
    assert _download.probe_cached("movielens_100k.hdf5") == str(target)
    # fetch_cached returns the cached file without any network call
    assert _download.fetch_cached("http://invalid.invalid/x",
                                  "movielens_100k.hdf5") == str(target)


def test_download_file_matches_jax(tmp_path):
    payload = np.random.default_rng(5).bytes(600_000)  # more than two read chunks
    source = tmp_path / "source.bin"
    source.write_bytes(payload)
    for package in PACKAGES:
        out = tmp_path / package / "nested" / "copy.bin"
        got = _module(package, "_download").download_file(source.as_uri(), str(out))
        assert got == str(out) and out.read_bytes() == payload
        assert not [n for n in os.listdir(out.parent) if n.endswith(".part")]


def _py_tree(root):
    """A few .py files sharing identifiers, one of them unreadable source."""
    shared = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
    for i in range(6):
        d = root / ("pkg" if i % 2 else "") / ("__pycache__" if i == 5 else "")
        d.mkdir(parents=True, exist_ok=True)
        names = shared[: 4 + i] + [f"only_{i}"]
        body = "\n".join(f"{n} = {k}\n{n} += {n}" for k, n in enumerate(names))
        (d / f"mod{i}.py").write_text(f"def f{i}(x):\n    return x\n{body}\n")
    (root / "broken.py").write_bytes(b"\xff\xfe def (\n")


def test_stdlib_generate_dataset_matches_jax(tmp_path):
    _py_tree(tmp_path / "src")
    arrays = {}
    for package in PACKAGES:
        out = tmp_path / package / "corpus.npz"
        _module(package, "stdlib_corpus").generate_dataset(
            str(tmp_path / "src"), str(out), min_df=2, min_tokens=3)
        with np.load(out, allow_pickle=False) as f:
            arrays[package] = {k: f[k] for k in f.files}
    want, got = (arrays[p] for p in PACKAGES)
    assert sorted(got) == sorted(want) and len(want["files"]) >= 3
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_get_stdlib_corpus_matches_jax():
    (wf, wt, wm), (gf, gt, gm) = (_module(p, "stdlib_corpus").get_stdlib_corpus()
                                  for p in PACKAGES)
    assert np.array_equal(gf, wf) and np.array_equal(gt, wt)
    assert gm.shape == wm.shape == (637, 3739)
    for attr in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(gm, attr), getattr(wm, attr)), attr


def test_chip_smoke_loader_checks():
    """chip_smoke.py phase 8's loader step at a small shape on the CPU: the
    committed corpus, the empty-cache probes and the MovieLens-20M round
    trip (a dump of the matrix converted and read back as its transpose)."""
    pytest.importorskip("h5py")
    pytest.importorskip("pandas")
    import chip_smoke

    walls = chip_smoke.loader_checks(ml_shape=(300, 80, 3000))
    assert walls is not None and len(walls) == 3
