"""``engine="mxu"`` on the port: the static spheres through the
matrix-product sweep (its plain version on the CPU), held to the JAX
package's ``engine="mxu"`` at the criteria of tests/test_intersect.py:
300-350 (winners equal on more than 99.9% of rays, t within rtol 2e-4 /
atol 1e-3; renders with more than 95% of pixels close and the mean within
2%)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_common import jax_scene_arrays

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops.intersect import intersect_ti as jintersect_ti
from tpu_ray.renderer import render as jrender
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import rng
from tpu_ray_torch.integrator import SceneKernels
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import sweep as sw
from tpu_ray_torch.ops.intersect import pack_rays
from tpu_ray_torch.renderer import render


def test_mxu_intersect_matches_jax_mxu_engine():
    """tests/test_intersect.py::test_mxu_sphere_sweep_matches_classic's
    4096 book1-final camera rays through SceneKernels(engine="mxu")."""
    spec = JSCENES["book1-final"]
    js = spec.build(seed=1024, earth=None)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    cam = spec.camera(160, 120)
    key = jax.random.PRNGKey(3)
    n = 4096
    xs = jnp.tile(jnp.linspace(0.02, 0.98, 64), n // 64)
    ys = jnp.repeat(jnp.linspace(0.02, 0.98, n // 64), 64)
    ro, rd, rt = cam.get_rays(key, xs, ys)
    rec = jintersect_ti(js, ro, rd, rt, key, engine="mxu")
    jt, ji = np.asarray(rec[0]), np.asarray(rec[1])
    kern = SceneKernels.create(ps, engine="mxu")
    assert kern.mxu is not None and kern.mxu.hi == ps.n_sphere_static
    rays = pack_rays(*(torch.from_numpy(np.array(a)) for a in (ro, rd, rt)))
    calls = sw.sweep_sphere_mxu_plain.calls
    t, i = kern.intersect(ps, rays, rng.prng_key(3),
                          torch.arange(n, dtype=torch.int32))
    assert sw.sweep_sphere_mxu_plain.calls == calls + 1
    t, i = t.numpy(), i.numpy()
    hit = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    same = (i == ji) | ~hit
    assert same.mean() > 0.999, f"{(~same).sum()} winner flips"
    np.testing.assert_allclose(t[hit & same], jt[hit & same], rtol=2e-4,
                               atol=1e-3)


def test_mxu_render_matches_jax_mxu_render():
    """tests/test_intersect.py::test_mxu_render_statistically_identical:
    book1-final 32x24, 8 spp, depth 8, both packages with engine="mxu"."""
    kw = dict(spp=8, max_depth=8, seed=5, engine="mxu")
    jspec, spec = JSCENES["book1-final"], SCENES["book1-final"]
    a = np.asarray(jrender(jspec.build(seed=1024, earth=None),
                           jspec.camera(32, 24), 32, 24, **kw))
    calls = sw.sweep_sphere_mxu_plain.calls
    b = render(spec.build(seed=1024, earth=None), spec.camera(32, 24), 32,
               24, device="cpu", **kw)
    assert sw.sweep_sphere_mxu_plain.calls > calls
    close = np.isclose(a, b, rtol=2e-3, atol=2e-3)
    assert close.mean() > 0.95
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.02)


def test_moving_spheres_keep_the_dense_sweep():
    """The JAX package's mxu engine needs a static scene
    (tpu_ray/ops/intersect.py:358): with moving spheres every range keeps
    the dense sweep; a static scene without spheres has no pack either."""
    moving = SCENES["random-moving"].build(seed=1024)
    assert moving.has_moving and moving.n_sphere_static > 0
    assert SceneKernels.create(moving, engine="mxu").mxu is None
    cornell = SCENES["cornell"].build(seed=1024)
    assert SceneKernels.create(cornell, engine="mxu").mxu is not None
    assert SceneKernels.create(cornell).mxu is None
