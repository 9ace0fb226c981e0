"""Image textures in the port: the atlas lookup against the JAX package's,
the image scenes against their goldens, and a seeded-image render against
tpu_ray's XLA shading (where a path on an exactly black texel dies at
once, as it does in the port's kernels)."""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import cross_engine, jax_scene_arrays

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops.textures import image_value_from
from tpu_ray_torch.convert import scene_from_jax_arrays, scene_to_arrays
from tpu_ray_torch.models import objects as ob
from tpu_ray_torch.models.compile import build_scene
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops.shade import StepConfig, image_value
from tpu_ray_torch.renderer import render

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
IMAGE_GOLDENS = {"earth": (4, 4, 24, 16), "random-moving": (4, 4, 24, 16)}


def _image(seed=3, shape=(32, 64, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("name", sorted(IMAGE_GOLDENS))
def test_image_scene_matches_golden(name):
    """The goldens were rendered with earth=None (the cyan stand-in)."""
    spp, depth, w, h = IMAGE_GOLDENS[name]
    spec = SCENES[name]
    img = render(spec.build(seed=1024, earth=None), spec.camera(w, h), w, h,
                 spp=spp, max_depth=depth, seed=1024, device="cpu")
    cross_engine(np.load(os.path.join(GOLDEN_DIR, f"{name}.npy")), img)


def test_image_value_bit_equal_to_jax():
    """Two images of different sizes in one padded atlas; uv inside, on and
    beyond the edges."""
    imgs = [_image(1, (8, 16, 3)), _image(2, (5, 7, 3))]
    objs = [ob.Sphere((3.0 * i, 0, 0), 1.0,
                      ob.Lambertian(ob.ImageTexture(im)))
            for i, im in enumerate(imgs)]
    ps = build_scene(objs)
    cfg = StepConfig.create(ps, SCENES["earth"].camera(8, 8), 8, 8, 4)
    js = type("S", (), {})()
    js.texs = type("T", (), {})()
    js.texs.img_atlas = jnp.asarray(ps.texs.img_atlas.numpy())
    js.texs.img_size = jnp.asarray(ps.texs.img_size.numpy())
    r = np.random.default_rng(0)
    n = 4096
    u = r.uniform(-0.1, 1.1, n).astype(np.float32)
    v = r.uniform(-0.1, 1.1, n).astype(np.float32)
    u[:4], v[:4] = (0.0, 1.0, 0.5, 1.0), (0.0, 1.0, 1.0, 0.0)
    iid = r.integers(0, 2, n).astype(np.int32)
    ref = np.asarray(image_value_from(js, jnp.asarray(iid), jnp.asarray(u),
                                      jnp.asarray(v)))
    got = torch.stack(image_value(cfg, torch.from_numpy(iid),
                                  torch.from_numpy(u), torch.from_numpy(v)))
    np.testing.assert_array_equal(got.numpy().T, ref)
    assert len(np.unique(ref)) > 100


def test_seeded_image_render_matches_jax_xla_shading():
    from tpu_ray import integrator
    from tpu_ray.renderer import render as jrender

    img = _image()
    kw = dict(spp=8, max_depth=6, seed=2)
    old = integrator.FUSED_SHADING
    try:
        integrator.FUSED_SHADING = "off"
        a = np.asarray(jrender(JSCENES["earth"].build(seed=1024, earth=img),
                               JSCENES["earth"].camera(24, 16), 24, 16,
                               engine="xla", **kw))
    finally:
        integrator.FUSED_SHADING = old
    b = render(SCENES["earth"].build(seed=1024, earth=img),
               SCENES["earth"].camera(24, 16), 24, 16, device="cpu", **kw)
    cross_engine(a, b)
    cyan = render(SCENES["earth"].build(seed=1024, earth=None),
                  SCENES["earth"].camera(24, 16), 24, 16, device="cpu", **kw)
    assert np.abs(b - cyan).max() > 0.05, "the image did not reach the render"


def test_black_texel_kills_the_path_at_once():
    """An all-black image: every path that hits the sphere ends there, as
    in the XLA body (zero throughput), so the sphere renders black."""
    black = np.zeros((4, 8, 3), np.uint8)
    spec = SCENES["earth"]
    img = render(spec.build(seed=1024, earth=black), spec.camera(16, 12), 16,
                 12, spp=2, max_depth=6, seed=1, device="cpu")
    assert img[8, 7:9].max() == 0.0 and img[0, 0].min() > 0.1


@pytest.mark.parametrize("name", ["earth", "next-week-final"])
def test_convert_carries_the_atlas(name):
    """A JAX-built image scene (next-week-final built by JAX on the CPU)
    crosses over with its atlas and renders like the port's own build."""
    img = _image(5, (16, 32, 3))
    js = JSCENES[name].build(seed=1024, earth=img)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    assert ps.has_image and ps.texs.img_atlas.dtype == torch.uint32
    assert tuple(ps.texs.img_atlas.shape) == (1, 16, 32)
    own = scene_to_arrays(SCENES[name].build(seed=1024, earth=img))
    for k, v in scene_to_arrays(ps).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v.view(np.uint8),
                                          own[k].view(np.uint8), err_msg=k)
        else:
            assert v == own[k], k
    kw = dict(spp=2, max_depth=4, seed=3, device="cpu")
    cam = SCENES[name].camera(12, 8)
    np.testing.assert_array_equal(
        render(ps, cam, 12, 8, **kw),
        render(SCENES[name].build(seed=1024, earth=img), cam, 12, 8, **kw))


def test_image_on_emissive_is_refused():
    """The megakernel refuses an image on a light (as it refuses every image
    scene, like the JAX package's): ``engine="mega"`` renders on the
    wavefront pool instead, which shades it, and says so on stderr."""
    from tpu_ray_torch.ops import megakernel as mega

    light = ob.DiffuseLight(ob.ImageTexture(_image(1, (4, 4, 3))))
    # a dome around the camera: a light emits on its back face
    scene = build_scene([ob.Sphere((0, 0, 0), 100.0, light)])
    assert scene.image_on_emissive and not mega.supported(scene)
    args = (scene, SCENES["earth"].camera(8, 6), 8, 6)
    kw = dict(spp=1, max_depth=2, device="cpu")
    img = render(*args, engine="mega", **kw)
    assert np.isfinite(img).all() and img.max() > 0.0
    np.testing.assert_array_equal(img, render(*args, **kw))
