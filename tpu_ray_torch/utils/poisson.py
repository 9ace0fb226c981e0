"""Bridson Poisson-disk (blue-noise) sample positions.

The port's own copy of ``tpu_ray/utils/poisson.py`` (pure numpy, the same
operations and the same ``numpy.random.default_rng`` draws, so both give
the same points for a seed).  ``poisson_disk(n, seed)`` returns a maximal
blue-noise point set in the unit square; like the JAX package, the
renderer does not route its jitter through it: it is a standalone utility.
"""
from __future__ import annotations

import numpy as np

K_CANDIDATES = 30  # candidates per active point


def poisson_disk(n: int, seed: int = 0) -> np.ndarray:
    """Maximal Poisson-disk point set in [0, 1)^2 with radius sqrt(2)/sqrt(n),
    (M, 2) float32.

    Bridson's algorithm with a background grid of cell size 1/sqrt(n).  The
    radius admits only about n/2 points, so M is below ``n``.
    """
    rng = np.random.default_rng(seed)
    a = 1.0 / np.sqrt(max(n, 1))
    r = np.sqrt(2.0) * a
    r2 = r * r
    cell = a
    gw = int(np.ceil(1.0 / cell))
    grid = -np.ones((gw, gw), np.int64)

    points = [rng.random(2)]
    gx, gy = (points[0] // cell).astype(int)
    grid[min(gx, gw - 1), min(gy, gw - 1)] = 0
    active = [0]

    def fits(p):
        cx, cy = int(p[0] / cell), int(p[1] / cell)
        x0, x1 = max(cx - 2, 0), min(cx + 3, gw)
        y0, y1 = max(cy - 2, 0), min(cy + 3, gw)
        for i in range(x0, x1):
            for j in range(y0, y1):
                q = grid[i, j]
                if q >= 0:
                    d = points[q] - p
                    if d[0] * d[0] + d[1] * d[1] < r2:
                        return False
        return True

    while active:
        idx = active[-1]
        base = points[idx]
        for _ in range(K_CANDIDATES):
            rho = rng.uniform(r, 2.0 * r)
            theta = rng.uniform(0.0, 2.0 * np.pi)
            p = base + rho * np.array([np.cos(theta), np.sin(theta)])
            if 0.0 <= p[0] < 1.0 and 0.0 <= p[1] < 1.0 and fits(p):
                grid[int(p[0] / cell), int(p[1] / cell)] = len(points)
                active.append(len(points))
                points.append(p)
                break
        else:
            active.pop()

    return np.asarray(points, np.float32)
