"""The general generators: one per traffic ``kind``, each reading its
parameters from the traffic file.

- ``fit``: whole fits back to back, each a new model of the configuration
  with a seed-derived ``random_state``, until ``--seconds`` have passed; the
  fit in progress then finishes inside the window.
- ``serve``: ``recommend`` requests of the configuration's model over factor
  tables made from the seed, in a closed loop with one caller: the next
  request is sent when the last returns. Request sizes are drawn per block
  of requests: every block holds the same sizes, in an order drawn from the
  seed.
"""

import importlib
import math
import random
import time

import numpy as np
import scipy.sparse
import torch

from . import data, trace


def _model_class(config):
    module, name = config["model"].split(":")
    return getattr(importlib.import_module(module), name)


def _params(config):
    params = dict(config["params"])
    if "dtype" in params:
        params["dtype"] = np.dtype(params["dtype"])
    return params


def check_model(model, config):
    """The model as the configuration states it, or an error: a run that
    departs from the configuration is no run of it."""
    for key, want in {**config["params"], **config.get("fixed", {})}.items():
        have = getattr(model, key)
        if key == "dtype":
            have, want = np.dtype(have), np.dtype(want)
        if have != want:
            raise RuntimeError(f"the model's {key} is {have!r}, the configuration's {want!r}")


def _shape(config, C):
    params = config["params"]
    return dict(users=C.shape[0], items=C.shape[1], nnz=C.nnz,
                users_nonempty=int((np.diff(C.indptr) > 0).sum()),
                items_nonempty=int((np.bincount(C.indices, minlength=C.shape[1]) > 0).sum()),
                factors=int(params["factors"]), iterations=int(params.get("iterations", 1)),
                cg_steps=int(config.get("fixed", {}).get("cg_steps", 0)),
                dtype="bfloat16" if np.dtype(params.get("dtype", "float32")).itemsize == 2
                else "float32",
                table_bytes=np.dtype(params.get("dtype", "float32")).itemsize)


class _StateRecorder:
    """Keeps the states a fit passes through: the outputs of the call named
    by the configuration's ``state_hook`` (one ALS half-iteration each),
    copied on the device at the half-iterations asked for."""

    def __init__(self, keep_calls):
        self.keep_calls, self.calls, self.kept = set(keep_calls), 0, {}

    def wrap(self, fn, name):
        def recorded(*args, **kwargs):
            if self.calls == 0:  # the start: the first call's table and fixed table
                self.kept["start"] = (args[0].detach().clone(), args[1].detach().clone())
            out = fn(*args, **kwargs)
            if self.calls in self.keep_calls:
                self.kept[self.calls] = out.detach().clone()
            self.calls += 1
            return out
        return recorded


class FitGenerator:
    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.config, run.traffic

    def setup(self):
        run = self.run
        self.C = data.interactions(self.cfg["data"], run.seed, run.device)
        run.shape = _shape(self.cfg, self.C)
        self.cls, self.params = _model_class(self.cfg), _params(self.cfg)
        self.rs_base = data.seed_int(run.seed, 3)
        # the checked fit, drawn from the seed among the window's first fits
        self.checked = random.Random(data.seed_int(run.seed, 4)).randrange(
            int(self.tr["check_fits"]))
        self._fit(-1, None)  # every shape of the window, built and loaded once
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

    def random_state(self, i):
        return (self.rs_base + i) % 2**63

    def _fit(self, i, callback):
        model = self.cls(**self.params, random_state=self.random_state(i),
                         device=self.run.device)
        check_model(model, self.cfg)
        model.fit(self.C, show_progress=False, callback=callback)
        return model

    def window(self, seconds):
        run = self.run
        traced = run.trace_on
        n_iter = int(self.params["iterations"])
        if n_iter < 2:
            raise ValueError("the fit check follows iterations 1 and n: it needs n >= 2")
        keep = {0, 1, 2 * n_iter - 4, 2 * n_iter - 3}
        walls, iter_secs = [], []
        attempted = failed = 0
        self.answers = None
        prof = None
        t0 = time.perf_counter()
        i = 0
        while True:
            secs = []
            if traced and i == int(self.tr.get("profile_fit", 0)):
                prof = trace.profiler()
                prof.start()

            def callback(iteration, elapsed, loss, secs=secs,
                         profiled=(prof is not None and run.profile is None)):
                secs.append(elapsed)
                if profiled:
                    with trace.span("iteration_end"):
                        pass

            recorder = _StateRecorder(keep) if i == self.checked else None
            s = time.perf_counter()
            attempted += 1
            try:
                with trace.patched([self.cfg["state_hook"]] if recorder else [],
                                   recorder.wrap if recorder else None), \
                        trace.span("fit"):
                    model = self._fit(i, callback if traced else None)
            except Exception as err:  # counted, and the window goes on
                failed += 1
                run.log(f"fit {i} failed: {err!r}")
                model = None
            e = time.perf_counter()
            if prof is not None and run.profile is None:
                prof.stop()
                run.profile = prof
            walls.append(e - s)
            iter_secs.append(secs)
            if recorder is not None and model is not None:
                k = recorder.kept
                self.answers = dict(start=k["start"], first=(k[0], k[1]),
                                    before_last=(k[2 * n_iter - 4], k[2 * n_iter - 3]),
                                    final=(model.user_factors, model.item_factors),
                                    random_state=self.random_state(i))
            del model
            i += 1
            if e - t0 >= seconds and i > self.checked:
                break
        run.record = dict(kind="fit", walls=walls, window_s=e - t0, iter_secs=iter_secs)
        run.attempted, run.failed = attempted, failed

    def check(self, ref, control):
        """The reference's numbers for the checked fit; with ``control`` the
        reference in the nearest lower precision stands in the program's
        place."""
        run = self.run
        if self.answers is None:
            return None
        rs = self.answers["random_state"]
        params = {**self.cfg["params"], **self.cfg.get("fixed", {})}
        answers = (ref.fit_answers(self.C, params, rs, run.device, "tf32") if control
                   else self.answers)
        return ref.judge_fit_answers(self.C, params, rs, answers, run.device)

    def release(self):
        pass


def worst(a, b):
    """The larger of two readings; NaN where either is NaN."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _blocks(rng, block, count):
    """``count`` items from repeated shuffles of the list ``block``."""
    out = []
    while len(out) < count:
        out.extend(rng.permutation(np.asarray(block)).tolist())
    return out[:count]


class ServeGenerator:
    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.config, run.traffic

    def setup(self):
        run, cfg, tr = self.run, self.cfg, self.tr
        self.C = data.interactions(cfg["data"], run.seed, run.device)
        run.shape = _shape(cfg, self.C)
        users, items = self.C.shape
        F = int(cfg["params"]["factors"])
        scale = float(cfg["serving"]["factor_scale"])
        self.U = data.factor_table(users, F, scale, run.seed, 0, run.device)
        self.I = data.factor_table(items, F, scale, run.seed, 1, run.device)
        self.model = _model_class(cfg)(**_params(cfg), device=run.device)
        check_model(self.model, cfg)
        self.model.user_factors, self.model.item_factors = self.U, self.I
        self.N = int(tr["N"])
        self.filter = bool(tr["filter_already_liked_items"])
        rng = np.random.default_rng(data.seed_int(run.seed, 5))
        sizes = [int(k) for k, n in tr["sizes"].items() for _ in range(int(n))]
        # whole blocks, so every seed cycles through the same sizes
        count = -(-int(tr["distinct_requests"]) // len(sizes)) * len(sizes)
        self.sizes = _blocks(rng, sizes, count)
        if tr["users"] == "permutation":
            perm = rng.permutation(users)
            total = sum(self.sizes)
            seq = np.concatenate([perm] * (-(-total // users)))[:total]
            self.users = np.split(seq, np.cumsum(self.sizes)[:-1])
        else:
            self.users = [rng.integers(0, users, size=n) for n in self.sizes]
        self.liked = [self.C[u] for u in self.users]
        # every request size once, so nothing is first met inside the window
        for n in sorted(set(self.sizes)):
            k = self.sizes.index(n)
            self._request(k)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

    def _request(self, k):
        return self.model.recommend(self.users[k], self.liked[k], N=self.N,
                                    filter_already_liked_items=self.filter)

    def window(self, seconds):
        run, tr = self.run, self.tr
        traced = run.trace_on
        trace_s = float(tr.get("trace_seconds", seconds))
        n_check = int(tr["check_requests"])
        pick = random.Random(data.seed_int(run.seed, 6))
        self.checked = []  # (request, ids, scores): a reservoir sample
        start, end, size = [], [], []
        failed = 0
        prof = trace.profiler() if traced else None
        profiled = 0
        if prof is not None:
            prof.start()  # before the clock: starting it can take seconds
        t0 = time.perf_counter()
        j = 0
        while True:
            k = j % len(self.sizes)
            s = time.perf_counter()
            try:
                with trace.span("request"):
                    ids, scores = self._request(k)
            except Exception as err:  # counted, and the window goes on
                failed += 1
                run.log(f"request {j} failed: {err!r}")
                ids = None
            e = time.perf_counter()
            start.append(s - t0)
            end.append(e - t0)
            size.append(len(self.users[k]))
            if ids is not None:
                if len(self.checked) < n_check:
                    self.checked.append((k, ids, scores))
                else:
                    r = pick.randrange(j + 1)
                    if r < n_check:
                        self.checked[r] = (k, ids, scores)
            j += 1
            if prof is not None and run.profile is None and e - t0 >= trace_s:
                prof.stop()
                run.profile = prof
                profiled = j
            if e - t0 >= seconds:
                break
        if prof is not None and run.profile is None:
            prof.stop()
            run.profile = prof
            profiled = j
        run.record = dict(kind="serve", start=np.array(start), end=np.array(end),
                          users=np.array(size), window_s=end[-1], profiled=profiled, N=self.N,
                          liked=np.array([self.liked[j % len(self.sizes)].nnz
                                          for j in range(len(size))]))
        run.attempted, run.failed = j, failed

    def check(self, ref, control, block=8192):
        """The reference's numbers for the sampled requests; with
        ``control`` the reference's top N in the nearest lower precision
        stands in for the program's answers."""
        run = self.run
        if not self.checked:
            return None
        dev = run.device
        U = torch.as_tensor(self.U, device=dev)
        I = torch.as_tensor(self.I, device=dev)
        rows = [(self.users[k], self.liked[k], ids, scores) for k, ids, scores in self.checked]
        out = dict(rank_gap=0.0, score_gap=0.0, bad_ids=0)
        batch = []
        for i, row in enumerate(rows):
            batch.append(row)
            if sum(len(b[0]) for b in batch) >= block or i == len(rows) - 1:
                users = np.concatenate([b[0] for b in batch])
                liked = scipy.sparse.vstack([b[1] for b in batch]).tocsr()
                ids = np.concatenate([np.atleast_2d(b[2]) for b in batch])
                scores = np.concatenate([np.atleast_2d(b[3]) for b in batch])
                if control:
                    cid, csc, _ = ref.recommend(U, I, torch.as_tensor(users, device=dev), liked,
                                                self.N, precision="tf32")
                    ids, scores = cid.cpu().numpy(), csc.cpu().numpy()
                got = ref.judge_recommend(U, I, torch.as_tensor(users, device=dev), liked, ids,
                                          scores, self.N)
                out["rank_gap"] = worst(out["rank_gap"], got["rank_gap"])
                out["score_gap"] = worst(out["score_gap"], got["score_gap"])
                out["bad_ids"] += got["bad_ids"]
                batch = []
        return out

    def release(self):
        self.model = None


GENERATORS = {"fit": FitGenerator, "serve": ServeGenerator}
