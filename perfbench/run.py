"""The benchmark of the PyTorch port, one run of one cell:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with a CUDA card.  The cells,
configurations and metrics are named in ``BENCHMARK.json``; see
``perfbench/harness/runner.py`` for what a run does.  The last line of
standard output is the result (JSON); the last lines of standard error are
the numbers the check compared, each beside its limit.  The program's
kernels build into ``build/`` inside the checkout, and so does any other
cache the run's libraries keep."""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def fixed_caches():
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds and compiles."""
    base = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(base / "kernels")


if __name__ == "__main__":
    fixed_caches()
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from harness.runner import main
    sys.exit(main(sys.argv[1:], T_START))
