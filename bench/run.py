"""The benchmark of the PyTorch and CUDA port: one cell of BENCHMARK.json
per run, on the card.

    python3 bench/run.py --workload qwen2.5-3b.qwentrace --seed 7 \
        --seconds 51 --trace 0

Run from the root of a checkout; the last line of standard output is the
result (bench/README.md). Kernel builds stay in the checkout's build/.
"""
import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# caches at fixed paths inside the checkout: only a checkout's first run
# builds; a library that would load JAX through transformers is kept off
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
