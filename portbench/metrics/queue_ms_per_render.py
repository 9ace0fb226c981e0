"""Layer: the work queue (``ops/queue.py`` -> ``csrc/queue.cu``: the path
ids, the count pass and the inject).  Device milliseconds of its kernels
in the traced stretch, per render.  Moves ``msamples_per_s``."""

PATTERNS = ("path_ids_kernel", "count_kernel", "inject_kernel")


def read(run):
    tr = run.trace
    us = tr.kernel_us(PATTERNS) if tr is not None else 0.0
    return us / 1e3 / tr.n_renders if us else None
