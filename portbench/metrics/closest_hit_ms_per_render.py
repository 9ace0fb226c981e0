"""Layer: the closest hit (``integrator.SceneKernels.intersect`` ->
``ops/bvh.py``, ``ops/sweep.py``, ``ops/intersect.py``; ``csrc/bvh.cu``,
``sweep*.cu``, ``media.cu``).  Device milliseconds of its kernels in the
traced stretch, per render.  Moves ``msamples_per_s``."""

PATTERNS = ("bvh_kernel", "sweep_kernel", "sweep_tiles_kernel",
            "tile_lists_kernel", "sweep_mxu_kernel", "media_kernel")


def read(run):
    tr = run.trace
    us = tr.kernel_us(PATTERNS) if tr is not None else 0.0
    return us / 1e3 / tr.n_renders if us else None
