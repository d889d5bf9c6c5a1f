"""Entry point of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds ``src/repro_torch``. The
kernels' build and every cache stay inside the checkout, at fixed paths,
so only a checkout's first run builds.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# this directory first on the path would let its modules shadow others
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
CACHE = ROOT / "build" / "portbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
