"""User-facing scene object model.

Mirrors the reference's constructors one-for-one so a scene written against
the Haskell API (src/Lib.hs:339-419, 521-660, 726-791) translates directly:

===========================  ==========================================
reference                    here
===========================  ==========================================
``ConstantColor``            :class:`SolidColor`
``CheckerTexture``           :class:`Checker`
``Perlin`` (via makePerlin)  :class:`Noise`
``ImageTexture``             :class:`ImageTexture`
``Lambertian/Metal/...``     same names
``sphere``                   :class:`Sphere`
``movingSphere``             :class:`MovingSphere`
``rect``                     :class:`Rect` (plane 'xy' | 'xz' | 'yz')
``cuboid``                   :class:`Box`
``translate``                :class:`Translate`
``rotate``                   :class:`Rotate` (axis 'x' | 'y' | 'z')
``constantMedium``           :class:`ConstantMedium`
===========================  ==========================================

These are plain host-side descriptions; ``tpu_ray_torch.models.compile.
build_scene`` flattens them into :class:`~tpu_ray_torch.models.scene_data.
SceneData` tensors.  (A copy of ``tpu_ray/models/objects.py``: the port
imports nothing of the JAX package.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

Vec = Tuple[float, float, float]


# --------------------------------------------------------------------------
# Textures
# --------------------------------------------------------------------------
class Texture:
    pass


@dataclass(frozen=True)
class SolidColor(Texture):
    color: Vec


@dataclass(frozen=True)
class Checker(Texture):
    """3D checker via sign of sin(10x)sin(10y)sin(10z) (reference: src/Lib.hs:498-501)."""

    odd: Texture
    even: Texture


@dataclass(frozen=True)
class Noise(Texture):
    """Perlin noise, always rendered as marble (reference: src/Lib.hs:502-513).

    ``seed`` determines the gradient vectors and permutation tables
    (reference generates them from the threaded RNG, src/Lib.hs:424-439).
    """

    scale: float
    seed: int = 0


@dataclass(frozen=True)
class ImageTexture(Texture):
    """UV-mapped image; ``image=None`` degrades to cyan (reference: src/Lib.hs:504-510)."""

    image: Optional[np.ndarray]  # (H, W, 3) uint8 or None

    def __hash__(self):
        return id(self.image)

    def __eq__(self, other):
        return self is other


def as_texture(t: Union[Texture, Vec]) -> Texture:
    if isinstance(t, Texture):
        return t
    return SolidColor(tuple(float(x) for x in t))


# --------------------------------------------------------------------------
# Materials (reference: src/Lib.hs:339-345)
# --------------------------------------------------------------------------
class Material:
    pass


@dataclass(frozen=True)
class Lambertian(Material):
    texture: Texture

    def __init__(self, texture):
        object.__setattr__(self, "texture", as_texture(texture))


@dataclass(frozen=True)
class Metal(Material):
    texture: Texture
    fuzz: float = 0.0

    def __init__(self, texture, fuzz: float = 0.0):
        object.__setattr__(self, "texture", as_texture(texture))
        object.__setattr__(self, "fuzz", float(fuzz))


@dataclass(frozen=True)
class Dielectric(Material):
    ref_idx: float


@dataclass(frozen=True)
class DiffuseLight(Material):
    texture: Texture

    def __init__(self, texture):
        object.__setattr__(self, "texture", as_texture(texture))


@dataclass(frozen=True)
class Isotropic(Material):
    texture: Texture

    def __init__(self, texture):
        object.__setattr__(self, "texture", as_texture(texture))


# --------------------------------------------------------------------------
# Objects (reference Hittable ADT, src/Lib.hs:521-585)
# --------------------------------------------------------------------------
class Object:
    pass


@dataclass(frozen=True)
class Sphere(Object):
    center: Vec
    radius: float
    material: Material


@dataclass(frozen=True)
class MovingSphere(Object):
    """Sphere whose center lerps c0 -> c1 over [t0, t1] (reference: src/Lib.hs:529-543, 1106-1108)."""

    center0: Vec
    center1: Vec
    time0: float
    time1: float
    radius: float
    material: Material


@dataclass(frozen=True)
class Rect(Object):
    """Axis-aligned rectangle.

    ``plane``: 'xy' -> (i, j) = (x, y), normal z; 'xz' -> (x, z), normal y;
    'yz' -> (y, z), normal x (reference: src/Lib.hs:607-660).
    """

    plane: str
    i0: float
    i1: float
    j0: float
    j1: float
    k: float
    material: Material


@dataclass(frozen=True)
class Box(Object):
    """Axis-aligned box = 6 rects (reference ``cuboid``, src/Lib.hs:594-605)."""

    pmin: Vec
    pmax: Vec
    material: Material


@dataclass(frozen=True)
class Translate(Object):
    offset: Vec
    obj: "Object"


@dataclass(frozen=True)
class Rotate(Object):
    """Rotation about a coordinate axis by ``angle`` degrees (reference: src/Lib.hs:732-787)."""

    axis: str  # 'x' | 'y' | 'z'
    angle: float
    obj: "Object"


@dataclass(frozen=True)
class ConstantMedium(Object):
    """Constant-density participating medium inside a convex boundary
    (reference: src/Lib.hs:789-791, 1053-1080).

    The boundary must reduce to a sphere or a box (possibly under
    translate/rotate), which covers every use in the reference scenes.
    """

    density: float
    texture: Texture
    boundary: "Object"

    def __init__(self, density, texture, boundary):
        object.__setattr__(self, "density", float(density))
        object.__setattr__(self, "texture", as_texture(texture))
        object.__setattr__(self, "boundary", boundary)


@dataclass(frozen=True)
class Group(Object):
    """A flat list of objects (stands in for the reference's BVH nodes -
    acceleration structure is orthogonal to scene description here)."""

    objects: Tuple[Object, ...]

    def __init__(self, objects: Sequence[Object]):
        object.__setattr__(self, "objects", tuple(objects))
