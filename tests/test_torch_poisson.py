"""The port's Poisson-disk sampler (tpu_ray_torch/utils/poisson.py) against
tpu_ray.utils.poisson: the same points for every seed, and the blue-noise
property of tests/test_render.py::test_poisson_disk_blue_noise."""
from __future__ import annotations

import numpy as np
import pytest

from tpu_ray.utils.poisson import poisson_disk as jax_poisson_disk
from tpu_ray_torch.utils.poisson import poisson_disk


@pytest.mark.parametrize("n,seed", [(64, 3), (64, 0), (200, 7), (1, 5)])
def test_poisson_disk_equals_jax(n, seed):
    pts = poisson_disk(n, seed=seed)
    np.testing.assert_array_equal(pts, jax_poisson_disk(n, seed=seed))
    assert pts.dtype == np.float32 and pts.shape[1] == 2


def test_poisson_disk_blue_noise():
    n = 64
    pts = poisson_disk(n, seed=3)
    assert pts.shape[0] >= n // 4
    assert np.all((pts >= 0) & (pts < 1))
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, 1.0)
    assert d2.min() >= (2.0 / n) * 0.999
