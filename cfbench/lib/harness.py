"""One run of one cell: the spec read from BENCHMARK.json, the cell's
configuration, traffic and limits found by name, set-up, the measured
window, the check against the plain reference, the metrics and the
result's line.

Files are found by name under the benchmark's folder:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json``, ``metrics/<metric>.py`` (a ``read(run)`` that returns
a number, or None where it finds nothing to read) and
``reference/<family>.py``. A cell, a traffic mix or a metric is added as
files of its own and an entry in BENCHMARK.json.
"""

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from . import counts, generators, guard, peaks, trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json and the files it names, under ``root`` (the checkout)
    and ``folder`` (the benchmark's own directory)."""

    def __init__(self, root, folder=HERE):
        self.root, self.folder = root, folder
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name):
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        return load_json(os.path.join(self.root, entry["file"]))

    def traffic(self, name):
        return load_json(os.path.join(self.folder, "traffic", f"{name}.json"))

    def limits(self, cell):
        return load_json(os.path.join(self.folder, "limits", f"{cell}.json"))["limits"]

    def reader(self, metric):
        path = os.path.join(self.folder, "metrics", f"{metric}.py")
        return _module(path, "cfbench_metric_" + metric.replace(".", "_")).read

    def reference(self, family):
        path = os.path.join(self.folder, "reference", f"{family}.py")
        return _module(path, "cfbench_reference_" + family)

    def metrics(self, cell, traced):
        """The metric entries the cell reports: its end-to-end metrics in an
        untraced run, its per-layer metrics in a traced one."""
        def applies(m, e2e_names):
            if "workloads" in m:
                return cell in m["workloads"]
            return m.get("moves") in e2e_names if e2e_names is not None else True

        e2e = [m for m in self.bench["end_to_end"] if applies(m, None)]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"] if applies(m, names)]


class Run:
    """What one run knows; the metric readers read it."""

    def __init__(self, cell, config, traffic, seed, seconds, trace_on, device, log):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace_on, self.device = seed, seconds, trace_on, device
        self.log = log
        self.profile = self.trace = None
        self.record = self.shape = None
        self.reference = None  # the family's plain reference module, loaded at set-up
        self.attempted = self.failed = 0
        self.setup_s = None
        self.counts = counts
        self.peaks = (peaks.for_card(torch.cuda.get_device_name(device))
                      if device.type == "cuda" else None)

    def profiled_window(self):
        """(start, end) in the trace's nanoseconds of the profiled fits or
        requests."""
        spans = self.trace.spans("fit") + self.trace.spans("request")
        return min(s for s, _ in spans), max(e for _, e in spans)


def _say(msg):
    print(msg, file=sys.stderr, flush=True)


def run_cell(spec, cell_name, seed, seconds, trace_on, device, t_start, control=False,
             log=_say, details=None):
    """One run of ``cell_name``; returns the result's dict (its ``checks``
    last). With ``control`` the reference in the nearest lower precision
    stands in the program's place for the check. ``details``, a dict, gets
    the run and every number the check computed."""
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell_name)
    run = Run(cell_name, config, traffic, seed, seconds, trace_on, device, log)
    gen = generators.GENERATORS[traffic["kind"]](run)
    spans = trace.spans_on(config.get("trace_spans", [])) if trace_on else contextlib.nullcontext()
    with spans:
        run.reference = spec.reference(config["family"])
        gen.setup()
        run.setup_s = time.perf_counter() - t_start
        # the harness's own objects out of the collector's way in the window
        gc.collect()
        gc.freeze()
        try:
            gen.window(seconds)
        finally:
            gc.unfreeze()
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=1,
               memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0))
    breakdown = None
    if run.profile is not None:
        run.trace = trace.Trace(run.profile)
        run.profile = None
        t0, t1 = run.profiled_window()
        dev["busy_s"] = run.trace.busy_ns(t0, t1) / 1e9
        dev["window_s"] = (t1 - t0) / 1e9
        breakdown = dict(device_ops=run.trace.device_ops(),
                         idle_gaps=run.trace.idle_gaps(t0, t1))
    metrics = {}
    for m in spec.metrics(cell_name, trace_on):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    gen.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = gen.check(run.reference, control) or {}
    log(f"cfbench: reference check {time.perf_counter() - t_check:.1f} s")
    if details is not None:
        details.update(run=run, numbers=numbers)
    checks = {}
    correct = run.failed == 0 and run.attempted > 0
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = dict(value=value, limit=limit)
        correct = correct and value <= limit  # NaN or a missing number fails
    result = dict(correct=bool(correct), attempted=run.attempted, failed=run.failed,
                  metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err!r}"


def main(argv, t_start, root):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one host thread for the process's CPU work: the card's host is shared,
    # and a pool of threads waking on it spreads host-bound runs (measured
    # on an H100 host: fit_s 3.3% against 4.5-10.4%, bulk serving 5.7%
    # against 13-16%)
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        _say("cfbench: no CUDA card (torch.cuda.is_available() is False); no result")
        return 2
    spec = Spec(root)
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        _say(f"cfbench: the cell needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} visible; no result")
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                      t_start)
    bad = guard.forbidden_modules()
    if bad:
        _say(f"cfbench: the run loaded JAX or the JAX package: {', '.join(bad)}; no result")
        return 3
    _say(f"cfbench: card {_power_limit()}")
    for name, c in result["checks"].items():
        _say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
