"""Layer: the shading step (``ops/shade.pool_step`` ->
``csrc/pool_step.cu``).  Device milliseconds of its kernels in the traced
stretch, per render.  Moves ``msamples_per_s``."""

PATTERNS = ("pool_step_kernel", "hit_scatter_kernel")


def read(run):
    tr = run.trace
    us = tr.kernel_us(PATTERNS) if tr is not None else 0.0
    return us / 1e3 / tr.n_renders if us else None
