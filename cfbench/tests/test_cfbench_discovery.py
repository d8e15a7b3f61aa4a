"""The harness finds a configuration, a traffic mix, limits and a per-layer
metric added as new files, with no edit to a file it already has: only
BENCHMARK.json gains entries."""

import hashlib
import json
import os

from cfbench.tests.tiny import copy_folder, run, tiny_spec


def _digests(folder):
    out = {}
    for root, _, files in os.walk(folder):
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, folder)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_from_new_files_only(tmp_path):
    folder = copy_folder(tmp_path)
    spec = tiny_spec(tmp_path, folder)
    before = _digests(folder)
    base = json.load(open(os.path.join(folder, "configs", "als_ml20m_f256.json")))
    base["params"]["factors"] = 24
    base["data"].update(users=400, items=200, draws=6000)
    new = {
        "configs/als_tiny_f24.json": base,
        "traffic/serve_pairs.json": {
            "kind": "serve", "N": 5, "filter_already_liked_items": True,
            "sizes": {"2": 1}, "users": "uniform", "distinct_requests": 64,
            "check_requests": 16, "trace_seconds": 0.2, "why": "pairs of users"},
        "limits/als_tiny_f24.serve_pairs.json": {
            "limits": {"rank_gap": 1e-5, "score_gap": 2e-5, "bad_ids": 0}},
    }
    for rel, body in new.items():
        with open(os.path.join(folder, rel), "w") as fh:
            json.dump(body, fh)
    with open(os.path.join(folder, "metrics", "serve.requests.py"), "w") as fh:
        fh.write("def read(run):\n    return float(len(run.record['users']))\n")
    bench = spec.bench
    bench["configs"].append(dict(name="als_tiny_f24", source="test", file="cfbench/configs/x.json",
                                 reduced=[], why="test"))
    os.makedirs(os.path.join(tmp_path, "cfbench", "configs"), exist_ok=True)
    with open(os.path.join(tmp_path, "cfbench", "configs", "x.json"), "w") as fh:
        json.dump(base, fh)
    cell = "als_tiny_f24.serve_pairs"
    bench["workloads"].append(dict(name=cell, config="als_tiny_f24", traffic="serve_pairs",
                                   chips=1, why="test"))
    for m in bench["end_to_end"]:
        if m["name"] == "recommend_users_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append(dict(name="serve.requests", unit="requests", better="higher",
                                   source="program_counter", layer="serving",
                                   moves="recommend_users_per_s", workloads=[cell]))
    old = {k: v for k, v in before.items()}
    res = run(spec, cell, seconds=0.3, trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["serve.requests"]["value"] == res["attempted"]
    res = run(spec, cell, seconds=0.3)
    assert "recommend_users_per_s" in res["metrics"]
    after = _digests(folder)
    assert {k: after[k] for k in old} == old  # no file it had was edited
