"""The reference scene library, scene for scene.

Port of ``tpu_ray/models/scenes.py``: the same builders and cameras, so a
scene built here is bit-equal to the JAX package's at the same seed.

Each builder mirrors its counterpart in the reference (src/Scenes.hs) -
same geometry, materials, lights and backgrounds; procedural content
(book-1/2 covers, next-week final) is generated with a seeded numpy
Generator following the same sampling procedure (the raw bitstream differs
from Haskell's splitmix, so per-sphere placements match in distribution,
not bit-for-bit).

Registry: ``SCENES`` maps CLI names to (build, camera) pairs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..core.camera import Camera
from ..utils.assets import load_earth_image
from . import objects as ob
from .compile import build_scene
from .scene_data import SceneData

SKY = (0.7, 0.8, 0.9)
BLACK = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class SceneSpec:
    name: str
    build: Callable[..., SceneData]
    camera: Callable[[int, int], Camera]
    description: str = ""


# ---------------------------------------------------------------------------
# Cameras (src/Scenes.hs:120-131, 181-192, 239-250, 401-412)
# ---------------------------------------------------------------------------
def random_scene_camera(w: int, h: int) -> Camera:
    return Camera.create((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, w / h, 0.1, 10.0, 0.0, 1.0)


def two_spheres_camera(w: int, h: int) -> Camera:
    return Camera.create((26, 4, 6), (0, 2, 0), (0, 1, 0), 20.0, w / h, 0.1, 20.0, 0.0, 1.0)


def cornell_camera(w: int, h: int) -> Camera:
    return Camera.create((278, 278, -800), (278, 278, 0), (0, 1, 0), 40.0, w / h, 0.0, 10.0, 0.0, 1.0)


def next_week_camera(w: int, h: int) -> Camera:
    return Camera.create((575, 278, -525), (320, 278, 0), (0, 1, 0), 40.0, w / h, 0.1, 580.0, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Book-1 cover (src/Scenes.hs:252-317)
# ---------------------------------------------------------------------------
def _random_small_spheres(rng: np.random.Generator, moving: bool):
    objs = []
    for a in range(-11, 11):
        for b in range(-11, 11):
            mat_p = rng.random()
            px, py = rng.random(), rng.random()
            center = np.array([a + 0.9 * px, 0.2, b + 0.9 * py])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if mat_p < 0.8:  # diffuse
                alb = tuple(rng.random(3) * rng.random(3))
                mat = ob.Lambertian(alb)
                if moving:
                    # book-2 variant: jitter +-0.25 in x,z over t in [0,1]
                    # (src/Scenes.hs:373-388)
                    dx, dz = rng.uniform(-0.25, 0.25, 2)
                    objs.append(ob.MovingSphere(
                        tuple(center), tuple(center + np.array([dx, 0, dz])),
                        0.0, 1.0, 0.2, mat))
                else:
                    objs.append(ob.Sphere(tuple(center), 0.2, mat))
            elif mat_p < 0.95:  # metal
                alb = tuple(rng.uniform(0.5, 1.0, 3))
                fuzz = rng.uniform(0.0, 0.5)
                objs.append(ob.Sphere(tuple(center), 0.2, ob.Metal(alb, fuzz)))
            else:  # glass
                objs.append(ob.Sphere(tuple(center), 0.2, ob.Dielectric(1.5)))
    return objs


def build_book1_final(seed: int = 1024, **_) -> SceneData:
    rng = np.random.default_rng(seed)
    world = [
        ob.Sphere((0, -1000, 0), 1000, ob.Lambertian((0.5, 0.5, 0.5))),
        ob.Sphere((0, 1, 0), 1.0, ob.Dielectric(1.5)),
        ob.Sphere((-4, 1, 0), 1.0, ob.Lambertian((0.4, 0.2, 0.1))),
        ob.Sphere((4, 1, 0), 1.0, ob.Metal((0.7, 0.6, 0.5), 0.0)),
    ] + _random_small_spheres(rng, moving=False)
    return build_scene(world, background=SKY)


def build_random_moving(seed: int = 1024, earth: Optional[np.ndarray] = "auto", **_) -> SceneData:
    """Book-2 cover variant (src/Scenes.hs:319-399): checker ground, glass
    cuboid hero, earth-textured sphere, moving diffuse spheres."""
    rng = np.random.default_rng(seed)
    if isinstance(earth, str):
        earth = load_earth_image()
    world = [
        ob.Sphere((0, -1000, 0), 1000, ob.Lambertian(
            ob.Checker(ob.SolidColor((0.2, 0.3, 0.1)), ob.SolidColor((0.9, 0.9, 0.9))))),
        ob.Box((-0.75, 0.0, -0.75), (0.75, 1.5, 0.75), ob.Dielectric(1.5)),
        ob.Sphere((-4, 1, 0), 1.0, ob.Lambertian(ob.ImageTexture(earth))),
        ob.Sphere((4, 1, 0), 1.0, ob.Metal((0.7, 0.6, 0.5), 0.0)),
    ] + _random_small_spheres(rng, moving=True)
    return build_scene(world, background=SKY)


# ---------------------------------------------------------------------------
# Two spheres (src/Scenes.hs:213-237)
# ---------------------------------------------------------------------------
def build_two_spheres(**_) -> SceneData:
    checker = ob.Checker(ob.SolidColor((0.2, 0.3, 0.1)), ob.SolidColor((0.9, 0.9, 0.9)))
    world = [
        ob.Sphere((0, -10, 0), 10, ob.Metal(checker, 0.0)),
        ob.Sphere((0, 10, 0), 10, ob.Lambertian((0.6, 0.2, 0.1))),
    ]
    return build_scene(world, background=(0.8, 0.8, 0.9))


# ---------------------------------------------------------------------------
# Two perlin spheres (src/Scenes.hs:194-211)
# ---------------------------------------------------------------------------
def build_two_perlin_spheres(seed: int = 1024, **_) -> SceneData:
    per = ob.Noise(scale=1.5, seed=seed)
    world = [
        ob.Sphere((0, -1000, 0), 1000, ob.Lambertian(per)),
        ob.Sphere((0, 2, 0), 2, ob.Lambertian(per)),
    ]
    # the reference ships this scene with a black background (Scenes.hs:211)
    return build_scene(world, background=BLACK)


# ---------------------------------------------------------------------------
# Earth (src/Scenes.hs:167-179)
# ---------------------------------------------------------------------------
def build_earth(earth: Optional[np.ndarray] = "auto", **_) -> SceneData:
    if isinstance(earth, str):
        earth = load_earth_image()
    world = [ob.Sphere((0, 0, 0), 2, ob.Lambertian(ob.ImageTexture(earth)))]
    return build_scene(world, background=(1.0, 1.0, 1.0))


# ---------------------------------------------------------------------------
# Simple light (src/Scenes.hs:133-155)
# ---------------------------------------------------------------------------
def build_simple_light(seed: int = 1024, **_) -> SceneData:
    per = ob.Noise(scale=1.0, seed=seed)
    difflight = ob.DiffuseLight((4.0, 4.0, 4.0))
    sphere_light = ob.Sphere((0, 7, 0), 2, difflight)
    rect_light = ob.Rect("xy", 3, 5, 1, 3, -2, difflight)
    world = [
        ob.Sphere((0, -1000, 0), 1000, ob.Lambertian(per)),
        ob.Sphere((0, 2, 0), 2, ob.Lambertian(per)),
        sphere_light,
        rect_light,
    ]
    return build_scene(world, lights=[sphere_light, rect_light], background=BLACK)


# ---------------------------------------------------------------------------
# Cornell box (src/Scenes.hs:32-73)
# ---------------------------------------------------------------------------
def build_cornell(**_) -> SceneData:
    red = ob.Lambertian((0.65, 0.05, 0.05))
    white = ob.Lambertian((0.73, 0.73, 0.73))
    green = ob.Lambertian((0.12, 0.45, 0.15))
    light = ob.DiffuseLight((15.0, 15.0, 15.0))
    light_rect = ob.Rect("xz", 213, 343, 227, 332, 554, light)
    box1 = ob.Translate((265, 0, 295), ob.Rotate("y", 15, ob.Box((0, 0, 0), (165, 330, 165), white)))
    glass = ob.Sphere((190, 90, 190), 90, ob.Dielectric(1.5))
    world = [
        ob.Rect("yz", 0, 555, 0, 555, 555, green),
        ob.Rect("yz", 0, 555, 0, 555, 0, red),
        light_rect,
        ob.Rect("xz", 0, 555, 0, 555, 0, white),
        ob.Rect("xz", 0, 555, 0, 555, 555, white),
        ob.Rect("xy", 0, 555, 0, 555, 555, white),
        box1,
        glass,
        # note: the reference builds a second (short) box but never adds it
        # to the world (src/Scenes.hs:48-66)
    ]
    # lights list = light rect + glass sphere (src/Scenes.hs:68-71)
    return build_scene(world, lights=[light_rect, glass], background=BLACK, t_min=1e-2)


# ---------------------------------------------------------------------------
# Cornell smoke (src/Scenes.hs:75-118)
# ---------------------------------------------------------------------------
def build_cornell_smoke(**_) -> SceneData:
    red = ob.Lambertian((0.65, 0.05, 0.05))
    white = ob.Lambertian((0.73, 0.73, 0.73))
    green = ob.Lambertian((0.12, 0.45, 0.15))
    light = ob.DiffuseLight((7.0, 7.0, 7.0))
    light_rect = ob.Rect("xz", 113, 443, 127, 432, 554, light)
    box1 = ob.Translate((265, 0, 295), ob.Rotate("y", 15, ob.Box((0, 0, 0), (165, 330, 165), white)))
    box2 = ob.Translate((130, 0, 65), ob.Rotate("y", -18, ob.Box((0, 0, 0), (165, 165, 165), white)))
    world = [
        ob.Rect("yz", 0, 555, 0, 555, 555, green),
        ob.Rect("yz", 0, 555, 0, 555, 0, red),
        light_rect,
        ob.Rect("xz", 0, 555, 0, 555, 0, white),
        ob.Rect("xz", 0, 555, 0, 555, 555, white),
        ob.Rect("xy", 0, 555, 0, 555, 555, white),
        ob.ConstantMedium(0.01, (0.0, 0.0, 0.0), box1),
        ob.ConstantMedium(0.01, (1.0, 1.0, 1.0), box2),
    ]
    return build_scene(world, lights=[light_rect], background=BLACK, t_min=1e-2)


# ---------------------------------------------------------------------------
# Next-week final (src/Scenes.hs:414-466)
# ---------------------------------------------------------------------------
def build_next_week_final(seed: int = 1024, earth: Optional[np.ndarray] = "auto",
                          t0: float = 0.0, t1: float = 1.0, **_) -> SceneData:
    rng = np.random.default_rng(seed)
    if isinstance(earth, str):
        earth = load_earth_image()
    ground = ob.Lambertian((0.48, 0.83, 0.53))
    white = ob.Lambertian((0.73, 0.73, 0.73))
    boxes1 = []
    for i in range(20):
        for j in range(20):
            x0, z0 = i * 100.0 - 1000.0, j * 100.0 - 1000.0
            y1 = rng.uniform(1.0, 101.0)
            boxes1.append(ob.Box((x0, 0.0, z0), (x0 + 100.0, y1, z0 + 100.0), ground))
    light = ob.DiffuseLight((7.0, 7.0, 7.0))
    boundary1 = ob.Sphere((360, 150, 145), 70, ob.Dielectric(1.5))
    boundary2 = ob.Sphere((0, 0, 0), 5000, ob.Dielectric(1.5))
    per = ob.Noise(scale=0.1, seed=seed)
    boxes2 = [
        ob.Sphere(tuple(rng.uniform(0.0, 165.0, 3)), 10, white) for _ in range(1000)
    ]
    world = boxes1 + [
        ob.Rect("xz", 113, 443, 127, 432, 554, light),
        ob.MovingSphere((400, 400, 200), (430, 400, 200), t0, t1, 50,
                        ob.Lambertian((0.7, 0.3, 0.1))),
        ob.Sphere((260, 150, 45), 50, ob.Dielectric(1.5)),
        ob.Sphere((0, 150, 145), 50, ob.Metal((0.8, 0.8, 0.9), 10.0)),
        boundary1,
        ob.ConstantMedium(0.2, (0.2, 0.4, 0.9), boundary1),
        ob.ConstantMedium(0.0001, (1.0, 1.0, 1.0), boundary2),
        ob.Sphere((400, 200, 400), 100, ob.Lambertian(ob.ImageTexture(earth))),
        ob.Sphere((220, 280, 300), 80, ob.Lambertian(per)),
        ob.Translate((-100, 270, 395), ob.Rotate("y", 15, ob.Group(boxes2))),
    ]
    # the reference ships this scene with NO light list (Unhittable,
    # src/Scenes.hs:420) - pure cosine sampling
    return build_scene(world, background=BLACK, t_min=1e-2)


SCENES: dict[str, SceneSpec] = {
    "book1-final": SceneSpec(
        "book1-final", build_book1_final, random_scene_camera,
        "book-1 cover: ~480 random spheres (Scenes.hs:252-317)"),
    "random-moving": SceneSpec(
        "random-moving", build_random_moving, random_scene_camera,
        "book-2 cover variant: moving spheres, checker, earth, glass box (Scenes.hs:319-399)"),
    "two-spheres": SceneSpec(
        "two-spheres", build_two_spheres, two_spheres_camera,
        "checker-metal + flat lambertian spheres (Scenes.hs:213-237)"),
    "two-perlin-spheres": SceneSpec(
        "two-perlin-spheres", build_two_perlin_spheres, two_spheres_camera,
        "perlin-marble spheres (Scenes.hs:194-211)"),
    "earth": SceneSpec(
        "earth", build_earth, two_spheres_camera,
        "earth image-textured sphere (Scenes.hs:167-179)"),
    "simple-light": SceneSpec(
        "simple-light", build_simple_light, two_spheres_camera,
        "perlin spheres + sphere/rect lights (Scenes.hs:133-155)"),
    "cornell": SceneSpec(
        "cornell", build_cornell, cornell_camera,
        "book-3 Cornell box with rotated box + glass sphere (Scenes.hs:32-73)"),
    "cornell-smoke": SceneSpec(
        "cornell-smoke", build_cornell_smoke, cornell_camera,
        "Cornell box with smoke boxes (Scenes.hs:75-118)"),
    "next-week-final": SceneSpec(
        "next-week-final", build_next_week_final, next_week_camera,
        "book-2 final: box grid, media, instancing, 1000 spheres (Scenes.hs:414-466)"),
}
