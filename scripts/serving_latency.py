"""Synchronous recommend and similar_items latency of the tree in the
current directory, on the card: random f=128 float32 factors at the
last.fm-360k shape, 1024 users with their liked items filtered, N=10; 60
calls each after a warm-up, the host clock's quartiles with the card
synchronized after each call. Run it from a tree's root with a label,
``python scripts/serving_latency.py change``; to compare two trees, run
it in each in turns (parent, change, change, parent) within one chip call.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

from implicit_tpu_torch.als import AlternatingLeastSquares  # noqa: E402
from implicit_tpu_torch.datasets.synthetic import generate_synthetic  # noqa: E402

dev = torch.device("cuda", 0)
plays = generate_synthetic(360_000, 160_000, 17_500_000, seed=0)
rng = np.random.default_rng(0)
m = AlternatingLeastSquares(factors=128, device=dev)
m.user_factors = rng.standard_normal((360_000, 128), dtype=np.float32) * 0.1
m.item_factors = rng.standard_normal((160_000, 128), dtype=np.float32) * 0.1
users = np.arange(0, 360_000, 351)[:1024]
liked = plays[users]


def timed(fn, n=60):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(out, [25, 50, 75]).round(3).tolist()


print(json.dumps({"tree": sys.argv[1],
                  "recommend_ms_q25_50_75": timed(lambda: m.recommend(users, liked, N=10)),
                  "similar_items_ms_q25_50_75": timed(lambda: m.similar_items(np.arange(1024),
                                                                              N=10))}))
