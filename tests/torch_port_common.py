"""Shared helpers of the tests that hold tpu_ray_torch against tpu_ray."""
from __future__ import annotations

import dataclasses

import numpy as np

# the six golden configs without image textures (tests/test_golden.py)
GOLDEN_CONFIGS = {
    "two-spheres": (16, 8, 32, 24),
    "cornell": (32, 12, 32, 24),
    "book1-final": (8, 8, 32, 24),
    "cornell-smoke": (16, 8, 24, 16),
    "simple-light": (16, 8, 24, 16),
    "two-perlin-spheres": (4, 4, 24, 16),
}
SCENE_NAMES = sorted(GOLDEN_CONFIGS)


def jax_scene_arrays(scene) -> dict:
    """A JAX SceneData as the dict tpu_ray_torch.convert takes: its
    array leaves keyed "<group>.<field>" plus its static fields."""
    from tpu_ray_torch.models.scene_data import STATIC_FIELDS

    out = {}
    for g in ("prims", "mats", "texs", "lights"):
        sub = getattr(scene, g)
        for f in dataclasses.fields(sub):
            out[f"{g}.{f.name}"] = np.asarray(getattr(sub, f.name))
    for k in ("background", "prim_payload", "mat_payload"):
        out[k] = np.asarray(getattr(scene, k))
    for k in STATIC_FIELDS:
        out[k] = getattr(scene, k)
    return out


def cross_engine(a, b, share=0.02):
    """The cross-engine criterion of tests/test_shade_pallas.py:109-113:
    at most ``share`` of pixels diverge, the rest agree within rtol 2e-4 /
    atol 1e-4.  Returns the divergent share."""
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    div = 1.0 - close.mean()
    assert div <= share, f"{div:.2%} pixels diverged (max {err.max():.2e})"
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)
    return div


def mixed_scene():
    """Every kind range of the sweep non-empty, the sphere and box ranges
    longer than one 128-row block: 300 static and 40 moving spheres, 150
    boxes, 30 quads."""
    from tpu_ray_torch.models import objects as ob
    from tpu_ray_torch.models.compile import build_scene

    r = np.random.default_rng(31)
    white = ob.Lambertian((1, 1, 1))
    objs = [ob.Sphere(tuple(r.uniform(-20, 20, 3)), r.uniform(0.3, 1.5),
                      white) for _ in range(300)]
    for _ in range(40):
        c = r.uniform(-20, 20, 3)
        objs.append(ob.MovingSphere(tuple(c), tuple(c + r.uniform(-2, 2, 3)),
                                    0.0, 1.0, r.uniform(0.3, 1.5), white))
    for _ in range(150):
        lo3 = r.uniform(-20, 20, 3)
        objs.append(ob.Box(tuple(lo3), tuple(lo3 + r.uniform(0.5, 4.0, 3)),
                           white))
    for plane in ("xy", "xz", "yz"):
        for _ in range(10):
            a = np.sort(r.uniform(-20, 20, 2))
            b = np.sort(r.uniform(-20, 20, 2))
            objs.append(ob.Rect(plane, a[0], a[1], b[0], b[1],
                                r.uniform(-20, 20), white))
    return build_scene(objs)


def seeded_image(seed=3, shape=(32, 64, 3)):
    """An 8-bit RGB image from a numpy seed (the earth map is not in the
    repository)."""
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def textured_checker_scene(ob, build_scene, img, seed=1024):
    """Checkers whose children are textures (``SceneData.checker_fancy``):
    simple-light's layout with a Checker(SolidColor, Noise) ground and a
    Checker(Noise, ImageTexture) sphere, under a dim sky.  ``ob`` and
    ``build_scene`` are either package's object API; seen through
    ``two_spheres_camera``."""
    ground = ob.Lambertian(ob.Checker(ob.SolidColor((0.2, 0.3, 0.1)),
                                      ob.Noise(scale=4.0, seed=seed)))
    ball = ob.Lambertian(ob.Checker(ob.Noise(scale=2.0, seed=seed + 1),
                                    ob.ImageTexture(img)))
    light = ob.DiffuseLight((4.0, 4.0, 4.0))
    sphere_light = ob.Sphere((0, 7, 0), 2, light)
    rect_light = ob.Rect("xy", 3, 5, 1, 3, -2, light)
    world = [ob.Sphere((0, -1000, 0), 1000, ground),
             ob.Sphere((0, 2, 0), 2, ball), sphere_light, rect_light]
    return build_scene(world, lights=[sphere_light, rect_light],
                       background=(0.2, 0.25, 0.3))


def emissive_image_scene(ob, build_scene, img):
    """An image texture on a light (``SceneData.image_on_emissive``): an
    emissive image dome of radius 500 around a Lambertian sphere and a
    metal one; seen through ``two_spheres_camera``."""
    dome = ob.Sphere((0, 0, 0), 500, ob.DiffuseLight(ob.ImageTexture(img)))
    return build_scene([dome,
                        ob.Sphere((0, 2, 0), 2, ob.Lambertian((0.7, 0.6, 0.5))),
                        ob.Sphere((0, 0.5, 3), 0.5, ob.Metal((0.8, 0.8, 0.8),
                                                            0.1))])
