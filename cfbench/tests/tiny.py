"""A copy of the benchmark's spec at a size the CPU tests can run: every
configuration's data cut to 3000 x 1500 with 90k draws, its widths and
parameters as they are."""

import json
import os
import shutil
import time

import torch

from cfbench.lib import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")


def tiny_spec(tmp, folder=None):
    """A Spec over ``tmp``: BENCHMARK.json copied, each configuration file
    rewritten at the tiny size; traffic, limits, metrics and references are
    read from ``folder`` (the benchmark's own by default)."""
    bench = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    for entry in bench["configs"]:
        cfg = harness.load_json(os.path.join(REPO, entry["file"]))
        cfg["data"].update(users=3000, items=1500, draws=90000)
        path = os.path.join(tmp, entry["file"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return harness.Spec(str(tmp), folder or harness.HERE)


def copy_folder(tmp):
    """The benchmark's folder copied under ``tmp``; returns the copy's path."""
    dst = os.path.join(tmp, "cfbench_copy")
    shutil.copytree(harness.HERE, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def run(spec, cell, seed=7, seconds=0.5, trace=False, **kw):
    kw.setdefault("log", lambda msg: None)
    return harness.run_cell(spec, cell, seed, seconds, trace, CPU, time.perf_counter(), **kw)


FIT_CELLS = ("als_lastfm360k_f128.fit", "als_ml20m_f256.fit")
SERVE_CELLS = ("als_lastfm360k_f128.serve_bulk",)
