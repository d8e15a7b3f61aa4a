"""The check that a run loaded nothing of JAX or the JAX package, by whole
top-level names; and the references' imports."""

import ast
import os
import subprocess
import sys

import pytest

from cfbench.lib import guard
from cfbench.tests.tiny import REPO


@pytest.mark.parametrize("name, flagged", [
    ("implicit_tpu", True), ("implicit_tpu.models.als", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax.linen", True),
    ("implicit_tpu_torch", False), ("implicit_tpu_torch.ops.als", False),
    ("jaxtyping", False), ("cfbench.lib.harness", False),
])
def test_forbidden_by_whole_top_level_name(name, flagged):
    assert guard.forbidden_modules([name]) == ([name] if flagged else [])


def test_a_run_loads_no_jax():
    code = ("import cfbench.lib.harness, implicit_tpu_torch.als, implicit_tpu_torch.models.mf_base;"
            "from cfbench.lib import guard; print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_references_import_nothing_of_the_program_or_jax():
    folder = os.path.join(REPO, "cfbench", "reference")
    for fname in os.listdir(folder):
        if not fname.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, fname)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("implicit_tpu_torch", *guard.FORBIDDEN), (fname, n)


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "cfbench/run.py", "--workload", "als_lastfm360k_f128.fit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
