"""The harness finds a configuration, a traffic mix, limits, a per-layer
metric and a fit family's plain reference added as new files, with no edit
to a file it already has: only BENCHMARK.json gains entries."""

import hashlib
import json
import os
import shutil

import pytest

from cfbench.tests.tiny import copy_folder, run, tiny_spec

PROBES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probe_families")


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


# a tiny fit cell of each family, and the limits of its probe's numbers (its
# record against the fitted model: exact)
FIT_FAMILIES = {
    "bpr": dict(model="implicit_tpu_torch.bpr:BayesianPersonalizedRanking",
                params=dict(factors=16, iterations=3, learning_rate=0.05, regularization=0.01,
                            epoch_mode="grouped"),
                state_hook="implicit_tpu_torch.models.bpr:_bpr_epoch_grouped",
                limits=dict(epochs_missing=0, final_gap=0.0)),
    "lmf": dict(model="implicit_tpu_torch.lmf:LogisticMatrixFactorization",
                params=dict(factors=8, iterations=3, neg_prop=5),
                state_hook="implicit_tpu_torch.models.lmf:_lmf_class_update",
                limits=dict(epochs_missing=0, final_gap=0.0)),
    # no hook, no random_state, and a fit that refuses a callback
    "bm25": dict(model="implicit_tpu_torch.nearest_neighbours:BM25Recommender",
                 params=dict(K=10, K1=1.2, B=0.75), fit_callback=False,
                 limits=dict(value_gap=1e-6, rank_gap=1e-6, count_gap=0)),
}


@pytest.mark.parametrize("family", sorted(FIT_FAMILIES))
def test_new_fit_family_from_new_files_only(tmp_path, family):
    folder = copy_folder(tmp_path)
    spec = tiny_spec(tmp_path, folder)
    before = _digests(folder)
    case = dict(FIT_FAMILIES[family])
    name = f"{family}_probe"
    cell = f"{name}.fit"
    cfg = dict(name=name, family=name, model=case.pop("model"), params=case.pop("params"),
               data=dict(users=400, items=200, draws=6000, structure_seed=0,
                         popularity_offset=20.0, popularity_exponent=0.8, mean_confidence=40.0))
    limits = case.pop("limits")
    cfg.update(case)
    shutil.copy(os.path.join(PROBES, f"{name}.py"), os.path.join(folder, "reference"))
    for rel, body in {f"configs/{name}.json": cfg,
                      f"limits/{cell}.json": dict(limits=limits)}.items():
        with open(os.path.join(folder, rel), "w") as fh:
            json.dump(body, fh)
    bench = spec.bench
    bench["configs"].append(dict(name=name, source="test", reduced=[], why="test",
                                 file=os.path.relpath(os.path.join(folder, "configs",
                                                                   f"{name}.json"), tmp_path)))
    bench["workloads"].append(dict(name=cell, config=name, traffic="fit", chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("fit_s", "fit.iter_s"):
            m["workloads"].append(cell)

    for traced in (False, True):
        details = {}
        res = run(spec, cell, seconds=0.3, trace=traced, details=details)
        assert res["failed"] == 0 and res["correct"], (traced, res["checks"])
        assert {k: v["value"] for k, v in res["checks"].items()} == details["numbers"]
        if traced:  # the callback's seconds, where the fit takes one
            assert ("fit.iter_s" in res["metrics"]) == ("fit_callback" not in cfg)
        else:
            assert res["metrics"]["fit_s"]["value"] > 0
    after = _digests(folder)
    assert {k: after[k] for k in before} == before  # no file it had was edited
