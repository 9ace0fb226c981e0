"""Whole renders: tpu_ray_torch.render on the CPU against tpu_ray.render and
the committed goldens (tests/goldens, CPU renders of the JAX package),
under the cross-engine criterion of tests/test_shade_pallas.py:109-113:
at most 2% of pixels diverge, the rest within rtol 2e-4 / atol 1e-4."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from torch_port_common import GOLDEN_CONFIGS, SCENE_NAMES, cross_engine

from tpu_ray_torch import integrator
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.renderer import plan_pool, render

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_render_matches_golden(name):
    spp, depth, w, h = GOLDEN_CONFIGS[name]
    spec = SCENES[name]
    img = render(spec.build(seed=1024, earth=None), spec.camera(w, h), w, h,
                 spp=spp, max_depth=depth, seed=1024, device="cpu")
    assert img.shape == (h, w, 3) and img.dtype == np.float32
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    cross_engine(golden, img)


@pytest.mark.parametrize("rr_depth", [0, 3])
def test_render_matches_jax_render(rr_depth):
    """A live tpu_ray render (XLA pool path, two waves, compaction off)
    against the port, with and without Russian roulette."""
    from tpu_ray.models.scenes import SCENES as JSCENES
    from tpu_ray.renderer import render as jrender

    jspec, spec = JSCENES["cornell"], SCENES["cornell"]
    kw = dict(spp=8, max_depth=6, seed=11, samples_per_wave=1,
              rays_per_wave=1 << 10, rr_depth=rr_depth)
    a = np.asarray(jrender(jspec.build(seed=1024), jspec.camera(16, 12), 16,
                           12, **kw))
    b = render(spec.build(seed=1024), spec.camera(16, 12), 16, 12,
               device="cpu", **kw)
    assert plan_pool(spec.build(), 16, 12, 8, 1 << 10, 1) == (4, 1, 2)
    cross_engine(a, b)


def test_compaction_ladder_and_check_interval_leave_image_unchanged():
    """The port's host loop checks the active count every CHECK_EVERY
    iterations and compacts at the ladder levels: neither decides any
    draw, so the image matches the every-iteration schedule to float
    reassociation of the accumulator."""
    spec = SCENES["cornell"]
    args = (spec.build(), spec.camera(128, 128), 128, 128)
    kw = dict(spp=2, max_depth=4, seed=5, device="cpu")
    assert integrator.pool_levels(128 * 128 * 2, 13) == [4096]
    a = render(*args, **kw)
    old = integrator.CHECK_EVERY
    try:
        integrator.CHECK_EVERY = 1
        b = render(*args, **kw)
    finally:
        integrator.CHECK_EVERY = old
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_depth_zero_is_black():
    spec = SCENES["two-spheres"]
    img = render(spec.build(), spec.camera(8, 6), 8, 6, spp=2, max_depth=0,
                 device="cpu")
    assert not img.any()


def test_plan_pool_matches_jax():
    from tpu_ray.models.scenes import SCENES as JSCENES
    from tpu_ray.renderer import plan_pool as jplan

    for name, w, h, spp in [("cornell", 500, 500, 1000),
                            ("cornell", 500, 500, 64),
                            ("book1-final", 600, 400, 100),
                            ("two-spheres", 32, 24, 16)]:
        assert plan_pool(SCENES[name].build(), w, h, spp) == \
            jplan(JSCENES[name].build(), w, h, spp)


def test_render_without_device_needs_a_card():
    spec = SCENES["two-spheres"]
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        render(spec.build(), spec.camera(8, 6), 8, 6, spp=1, max_depth=2)


# what later slices of the port brought into scope renders now: the queue
# slice's big scenes, image textures and queue mode, the strict estimator
# and the Sobol' sampler of the seventh, adaptive sampling of the eighth,
# checkers with textured children and images on lights of the ninth, BVH
# traversal, checkpoints and progressive output of the tenth, device
# meshes of the eleventh
NOW_RENDERED = ("next-week-final", "image", "queue", "strict", "sobol",
                "adaptive", "checker-fancy", "image-on-emissive", "bvh",
                "checkpoint", "progressive", "mesh")


@pytest.mark.parametrize("what", ["next-week-final", "image", "strict",
                                  "sobol", "bvh", "mesh", "queue",
                                  "adaptive", "checkpoint", "progressive",
                                  "checker-fancy", "image-on-emissive"])
def test_out_of_slice_inputs_raise(what, tmp_path):
    """Inputs outside the port would raise NotImplementedError; the ones
    later slices took in (a scene over 512 prims, image textures, queue
    mode, the strict estimator, the Sobol' sampler, adaptive sampling,
    checkers with textured children, an image on a light, BVH traversal, a
    checkpoint path, an on_partial callback, a device mesh) render a
    finite image instead."""
    from tpu_ray_torch.models import objects as ob
    from tpu_ray_torch.models.compile import build_scene
    from tpu_ray_torch.parallel.mesh import make_mesh

    spec = SCENES["cornell"]
    scene, cam, kw = spec.build(), spec.camera(8, 6), {}
    img = np.random.default_rng(0).integers(0, 256, (8, 16, 3), np.uint8)
    if what == "next-week-final":
        scene = SCENES[what].build(earth=None)
    elif what == "image":
        scene = SCENES["earth"].build(earth=img)
    elif what == "strict":
        scene = scene.replace(strict=True)
    elif what == "sobol":
        cam = cam.replace(sampler="sobol")
    elif what == "checker-fancy":
        # in front of cornell's camera, under a sky
        tex = ob.Checker(ob.ImageTexture(img),
                         ob.SolidColor((0.9, 0.9, 0.9)))
        scene = build_scene([ob.Sphere((278, 278, 0), 200.0,
                                       ob.Lambertian(tex))],
                            background=(0.5, 0.6, 0.7))
        assert scene.checker_fancy
    elif what == "image-on-emissive":
        # a dome around cornell's camera: a light emits on its back face
        scene = build_scene([ob.Sphere((278, 278, 0), 2000.0, ob.DiffuseLight(
            ob.ImageTexture(img)))])
        assert scene.image_on_emissive
    else:
        kw = {"bvh": dict(bvh=True), "mesh": dict(mesh=make_mesh(2, "cpu")),
              "queue": dict(mode="queue"), "adaptive": dict(adaptive=0.01),
              "checkpoint": dict(checkpoint_path=str(tmp_path / "x.npz")),
              "progressive": dict(on_partial=print)}[what]
    if what in NOW_RENDERED:
        out = render(scene, cam, 8, 6, spp=1, max_depth=2, device="cpu", **kw)
        assert out.shape == (6, 8, 3) and np.isfinite(out).all() and out.any()
        return
    with pytest.raises(NotImplementedError):
        render(scene, cam, 8, 6, spp=1, max_depth=2, device="cpu", **kw)
