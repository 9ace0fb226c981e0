"""Wave mode (the plain wavefront): tpu_ray_torch.render(mode="wave")
against tpu_ray.render(mode="wave") under the cross-engine criterion, and
the jax.random streams that mode draws its camera samples from."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch_port_common import cross_engine

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.renderer import render as jrender
from tpu_ray_torch import integrator
from tpu_ray_torch.core import rng
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import hit_scatter as hs
from tpu_ray_torch.ops.intersect import pack_rays
from tpu_ray_torch.ops.shade import StepConfig
from tpu_ray_torch.renderer import render


def test_split_and_uniform_bit_equal_to_jax_random():
    key = jax.random.fold_in(jax.random.PRNGKey(77), 3)
    kn = rng.fold_in(rng.prng_key(77), 3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jax.random.split(key, 3))),
        rng.split(kn, 3))
    for shape in ((1000, 2), (333, 3), (7,)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(key, shape)),
            rng.uniform(kn, shape).numpy())


@pytest.mark.parametrize("name,rr_depth", [("cornell", 0), ("cornell", 3),
                                           ("two-spheres", 0),
                                           ("cornell-smoke", 0),
                                           ("random-moving", 0)])
def test_wave_render_matches_jax_wave_render(name, rr_depth):
    """Two waves of four samples per pixel, with and without roulette."""
    kw = dict(spp=8, max_depth=6, seed=11, mode="wave",
              rays_per_wave=1 << 10, rr_depth=rr_depth)
    a = np.asarray(jrender(JSCENES[name].build(seed=1024, earth=None),
                           JSCENES[name].camera(16, 12), 16, 12, **kw))
    before = hs.hit_scatter_plain.calls
    b = render(SCENES[name].build(seed=1024, earth=None),
               SCENES[name].camera(16, 12), 16, 12, device="cpu", **kw)
    assert hs.hit_scatter_plain.calls > before
    assert b.shape == (12, 16, 3) and b.dtype == np.float32
    cross_engine(a, b)


def test_wave_depth_zero_is_black():
    spec = SCENES["two-spheres"]
    img = render(spec.build(), spec.camera(8, 6), 8, 6, spp=2, max_depth=0,
                 mode="wave", device="cpu")
    assert img.shape == (6, 8, 3) and not img.any()


def test_wave_alive_check_interval_leaves_image_unchanged():
    """The host reads 'any lane alive' every CHECK_EVERY bounces; a bounce
    with every lane dead adds nothing."""
    spec = SCENES["cornell"]
    args = (spec.build(), spec.camera(16, 12), 16, 12)
    kw = dict(spp=2, max_depth=9, seed=5, mode="wave", device="cpu")
    a = render(*args, **kw)
    old = integrator.CHECK_EVERY
    try:
        integrator.CHECK_EVERY = 1
        b = render(*args, **kw)
    finally:
        integrator.CHECK_EVERY = old
    np.testing.assert_array_equal(a, b)


def test_trace_keys_draws_by_lane_id_not_position():
    """Reversing the lanes (with their ids) reverses the radiance."""
    spec = SCENES["cornell"]
    ps = spec.build()
    cam = spec.camera(8, 8)
    cfg = StepConfig.create(ps, cam, 8, 8, 6)
    u = rng.uniform(rng.prng_key(1), (64, 5))
    rays = pack_rays(*cam.rays_from_uniforms(u[:, 0], u[:, 1], u[:, 2:5]))
    ids = torch.arange(64, dtype=torch.int32)
    key = rng.prng_key(9)
    a = integrator.trace(ps, cfg, rays, key, lane_ids=ids)
    b = integrator.trace(ps, cfg, rays.flip(1).contiguous(), key,
                         lane_ids=ids.flip(0).contiguous())
    assert a.shape == (3, 64) and float(a.sum()) > 0
    torch.testing.assert_close(a, b.flip(1), rtol=0, atol=0)
