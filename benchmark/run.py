"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` beside ``benchmark/``).  Prints the card on an
earlier line and one JSON result as the last line of standard output; see ``lib/harness.py``.
Every build and kernel cache lies inside the checkout: the port's own build directory
(``deepphysinet_tpu_torch/csrc/build/``), and ``benchmark/.cache/`` for PyTorch's extensions,
Triton and CUDA's compiled-kernel cache.
"""

import os
import sys
import time

START = time.time()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path[0] = ROOT  # the checkout, not this folder: benchmark.* by package name

if __name__ == "__main__":
    from benchmark.lib import harness, timing

    sys.exit(harness.main(sys.argv[1:], start_epoch=min(START, timing.process_start_epoch())))
