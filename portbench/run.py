"""Run one cell of the benchmark of ``tpu_ray_torch``:

    python3 portbench/run.py --workload nextweek.queue --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout on a machine with the cell's CUDA cards.  The
last line of standard output is the result (``harness.py``); the compared
numbers and their limits end standard error.  Without the cards it exits
3 and prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cell measures the default path: no switch of the environment
for _k in ("TPU_RAY_SORT", "TPU_RAY_SWEEP_MXU", "TPU_RAY_CULL_STYLE",
           "TPU_RAY_CRASH_AFTER_WAVE"):
    os.environ.pop(_k, None)
# the kernel libraries' cache, at a fixed path inside the checkout
os.environ["TPU_RAY_TORCH_BUILD_DIR"] = os.path.join(ROOT, "tpu_ray_torch",
                                                     "_build")
# the checkout's root, not this folder: the harness's modules are
# imported as portbench.*, and none shadows a module of the library
sys.path[0] = ROOT

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
