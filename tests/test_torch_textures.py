"""The shade core's two texture cases that earlier slices refused: checkers
whose children are textures (``checker_fancy``) and image textures on
lights (``image_on_emissive``), in the pool, queue and wave modes and the
strict estimator, against the JAX package on the CPU.

The textured-checker scene is held to the JAX package run op by op
(``jax.disable_jit``): its jitted program rounds the marble of the ground's
Noise child differently from its own op-by-op run (the ground's hit points
lie tens of units from the origin, where the marble's 10 |turbulence| term
turns an ulp of the point into a visible step), so the jitted render and
the op-by-op one diverge on 7-18% of pixels, and the port equals the
op-by-op one (``python tools/torch_branch_study.py``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (cross_engine, emissive_image_scene,
                               seeded_image, textured_checker_scene)

from tpu_ray.models import objects as job
from tpu_ray.models.compile import build_scene as jbuild_scene
from tpu_ray.models.scenes import two_spheres_camera as jcamera
from tpu_ray.ops.textures import texture_value
from tpu_ray.renderer import render as jrender
from tpu_ray_torch.models import objects as ob
from tpu_ray_torch.models.compile import build_scene
from tpu_ray_torch.models.scenes import two_spheres_camera
from tpu_ray_torch.ops import megakernel
from tpu_ray_torch.ops.shade import StepConfig, albedo_plain
from tpu_ray_torch.renderer import render

IMG = seeded_image()


def _scenes(make):
    return make(job, jbuild_scene, IMG), make(ob, build_scene, IMG)


def test_flags():
    js, ps = _scenes(textured_checker_scene)
    assert js.checker_fancy and ps.checker_fancy and ps.has_image
    assert not megakernel.supported(ps)
    js, ps = _scenes(emissive_image_scene)
    assert js.image_on_emissive and ps.image_on_emissive


@pytest.mark.parametrize("prim", [0, 1])
def test_albedo_matches_jax_texture_value(prim):
    """The plain shade core's texture value of each textured checker (the
    ground: Checker(SolidColor, Noise); the sphere: Checker(Noise,
    ImageTexture)) against ``textures.texture_value`` by texture id, at
    random points and uv: every lane within 1e-6 (one ulp of the marble's
    last sine)."""
    js, ps = _scenes(textured_checker_scene)
    cfg = StepConfig.create(ps, two_spheres_camera(8, 8), 8, 8, 4)
    r = np.random.default_rng(prim)
    n = 4096
    p = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    u, v = (r.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    tex = int(js.mats.tex[int(ps.prims.mat[prim])])
    want = np.asarray(texture_value(js, jnp.full((n,), tex, jnp.int32),
                                    jnp.asarray(u), jnp.asarray(v),
                                    jnp.asarray(p)))
    idx = torch.full((n,), prim, dtype=torch.int32)
    got = albedo_plain(cfg, cfg.tab[idx.long()], idx,
                       tuple(torch.from_numpy(p[:, i].copy())
                             for i in range(3)),
                       torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(torch.stack(got).T.numpy(), want, rtol=0,
                               atol=1e-6)
    assert len(np.unique(want)) > 1000


@pytest.mark.parametrize("mode,strict", [("pool", False), ("queue", False),
                                         ("wave", False), ("pool", True)])
def test_textured_checker_matches_jax_op_by_op(mode, strict):
    """12x8, 4 spp, depth 6: the cross-engine criterion against the JAX
    package's op-by-op render."""
    js, ps = _scenes(textured_checker_scene)
    kw = dict(spp=4, max_depth=6, seed=3, mode=mode)
    with jax.disable_jit():
        a = np.asarray(jrender(js.replace(strict=strict), jcamera(12, 8), 12,
                               8, **kw))
    b = render(ps.replace(strict=strict), two_spheres_camera(12, 8), 12, 8,
               device="cpu", **kw)
    cross_engine(a, b)
    assert a.mean() > 0.05


@pytest.mark.parametrize("mode,strict", [("pool", False), ("queue", False),
                                         ("wave", False), ("pool", True)])
def test_emissive_image_matches_jax(mode, strict):
    """16x12, 8 spp, depth 6 against the JAX package's jitted render."""
    js, ps = _scenes(emissive_image_scene)
    kw = dict(spp=8, max_depth=6, seed=3, mode=mode)
    a = np.asarray(jrender(js.replace(strict=strict), jcamera(16, 12), 16, 12,
                           **kw))
    b = render(ps.replace(strict=strict), two_spheres_camera(16, 12), 16, 12,
               device="cpu", **kw)
    cross_engine(a, b)
    assert a.std() > 0.05     # the image reaches the render


@pytest.mark.parametrize("make", [textured_checker_scene,
                                  emissive_image_scene])
def test_engine_mega_falls_back_with_its_line(make, capsys):
    """The megakernel refuses both cases, as the JAX package's does: with
    ``engine="mega"`` the render runs on the wavefront pool, bit-equal to
    the pool render, and says so on stderr."""
    _, ps = _scenes(make)
    args = (ps, two_spheres_camera(8, 6), 8, 6)
    kw = dict(spp=2, max_depth=3, seed=1, device="cpu")
    calls = megakernel.trace_pool_mega_plain.calls
    capsys.readouterr()
    a = render(*args, engine="mega", **kw)
    assert "engine=mega does not cover this scene" in capsys.readouterr().err
    assert megakernel.trace_pool_mega_plain.calls == calls
    np.testing.assert_array_equal(a, render(*args, **kw))
