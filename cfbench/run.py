"""One run of one benchmark cell on the CUDA card:

    python3 cfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It prints the result as one JSON line, last on standard output, and the
numbers compared with their limits as the last lines of standard error. It
exits with another code than 0, printing no result, where no card is
visible or the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel caches at fixed paths inside the checkout (the port builds its
# own CUDA libraries under implicit_tpu_torch/build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "cfbench", sub)
sys.path.insert(0, ROOT)

from cfbench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
