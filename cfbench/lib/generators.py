"""The general generators: one per traffic ``kind``, each reading its
parameters from the traffic file.

- ``fit``: whole fits back to back, each a new model of the configuration
  (with a seed-derived ``random_state`` where its constructor takes one),
  until ``--seconds`` have passed; the fit in progress then finishes inside
  the window. It knows no model family: ``reference/<family>.py`` gives
  ``fit_recorder(params)``, whose ``wrap`` goes around the configuration's
  ``state_hook`` in the checked fit (None: no hook) and whose
  ``answers(model, random_state)`` are what ``judge_fit_answers`` reads. A
  traced fit's callback keeps its second positional argument, the seconds;
  ``"fit_callback": false`` where the model's fit refuses a callback
  (``cfbench/README.md``, "A fit family").
- ``serve``: ``recommend`` requests of the configuration's model over factor
  tables made from the seed, in a closed loop with one caller: the next
  request is sent when the last returns. Request sizes are drawn per block
  of requests: every block holds the same sizes, in an order drawn from the
  seed.
"""

import importlib
import inspect
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
    """The inputs' sizes, and the model's where the configuration states
    them (the defaults stand for a model without factors or iterations)."""
    params = config["params"]
    dtype = np.dtype(params.get("dtype", "float32"))
    return dict(users=C.shape[0], items=C.shape[1], nnz=C.nnz,
                users_nonempty=int((np.diff(C.indptr) > 0).sum()),
                items_nonempty=int((np.bincount(C.indices, minlength=C.shape[1]) > 0).sum()),
                factors=int(params.get("factors", 0)), iterations=int(params.get("iterations", 1)),
                cg_steps=int(config.get("fixed", {}).get("cg_steps", 0)),
                dtype="bfloat16" if dtype.itemsize == 2 else "float32",
                table_bytes=dtype.itemsize)


class _StateRecorder:
    """Keeps the states a fit passes through, for a family's recorder: the
    first call's first two arguments and the outputs of the calls numbered
    in ``keep_calls`` (from 0) of the function it wraps, each copied on the
    device."""

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
        run, cfg = self.run, self.cfg
        self.C = data.interactions(cfg["data"], run.seed, run.device)
        run.shape = _shape(cfg, self.C)
        self.cls, self.params = _model_class(cfg), _params(cfg)
        self.seeded = "random_state" in inspect.signature(self.cls).parameters
        self.takes_callback = bool(cfg.get("fit_callback", True))
        self.rs_base = data.seed_int(run.seed, 3)
        # the checked fit, drawn from the seed among the window's first fits
        self.checked = random.Random(data.seed_int(run.seed, 4)).randrange(
            int(self.tr["check_fits"]))
        # its recorder, from the family: made now, so that a configuration the
        # family cannot follow fails before the window
        self.recorder = run.reference.fit_recorder({**cfg["params"], **cfg.get("fixed", {})})
        self.hooks = [cfg["state_hook"]] if "state_hook" in cfg else []
        if self.hooks and self.recorder.wrap is None:
            raise ValueError(f"the family {cfg['family']!r} records through no state_hook; "
                             f"the configuration names {cfg['state_hook']!r}")
        self._fit(-1, None)  # every shape of the window, built and loaded once
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

    def random_state(self, i):
        return (self.rs_base + i) % 2**63

    def _fit(self, i, callback):
        seed = dict(random_state=self.random_state(i)) if self.seeded else {}
        model = self.cls(**self.params, **seed, device=self.run.device)
        check_model(model, self.cfg)
        model.fit(self.C, show_progress=False, callback=callback)
        return model

    def window(self, seconds):
        run = self.run
        traced = run.trace_on
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

            def callback(*args, secs=secs,
                         profiled=(prof is not None and run.profile is None)):
                secs.append(args[1])  # every family's fit passes the seconds second
                if profiled:
                    with trace.span("iteration_end"):
                        pass

            checked = i == self.checked
            s = time.perf_counter()
            attempted += 1
            try:
                with trace.patched(self.hooks if checked else [], self.recorder.wrap), \
                        trace.span("fit"):
                    model = self._fit(i, callback if traced and self.takes_callback else None)
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
            if checked and model is not None:
                try:
                    self.answers = self.recorder.answers(model, self.random_state(i))
                except Exception as err:  # a record the check cannot read: not correct
                    failed += 1
                    run.log(f"fit {i}: no answers for the check: {err!r}")
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
        rs = self.random_state(self.checked)
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
