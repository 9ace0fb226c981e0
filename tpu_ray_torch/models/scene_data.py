"""Scene representation: structure-of-arrays dataclasses of tensors.

Port of ``tpu_ray/models/scene_data.py``.  The flax structs become frozen
dataclasses of torch tensors with a ``.to(device)``; the static metadata
(counts, feature flags, ``t_min``) stays plain Python and picks which
code each render runs.  Field names, dtypes and layouts are the JAX
package's, so :mod:`tpu_ray_torch.convert` can carry a scene across as a
dict of numpy arrays.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# Primitive kinds (solids < PRIM_MEDIUM_SPHERE <= media)
PRIM_SPHERE = 0
PRIM_BOX = 1
PRIM_QUAD = 2
PRIM_MEDIUM_SPHERE = 3
PRIM_MEDIUM_BOX = 4

# Material kinds
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture kinds
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_PERLIN = 2
TEX_IMAGE = 3

# Light kinds
LIGHT_QUAD = 0
LIGHT_SPHERE = 1


class _Tensors:
    """``.to(device)`` and ``.replace`` for a dataclass whose tensor
    fields move together and whose other fields are static."""

    def to(self, device):
        """The copy on ``device``; the object itself when every tensor is
        already there, so a scene keeps its identity through a render's
        bands and the server's requests (``integrator.SceneKernels``
        keeps the route's tables by scene)."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _Tensors)):
                moved = v.to(device)
                if moved is not v:
                    kw[f.name] = moved
        return dataclasses.replace(self, **kw) if kw else self

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PrimArrays(_Tensors):
    """All primitives, one row each (layout: tpu_ray's PrimArrays)."""

    kind: torch.Tensor          # (N,) int32
    mat: torch.Tensor           # (N,) int32 material index
    center: torch.Tensor        # (N, 3) sphere center at time0
    velocity: torch.Tensor      # (N, 3)
    time0: torch.Tensor         # (N,)
    radius: torch.Tensor        # (N,)
    quad_p0: torch.Tensor       # (N, 3)
    quad_e1: torch.Tensor       # (N, 3)
    quad_e2: torch.Tensor       # (N, 3)
    quad_n: torch.Tensor        # (N, 3) unit normal
    quad_d: torch.Tensor        # (N,) dot(p0, n)
    quad_inv1: torch.Tensor     # (N, 3) e1 / |e1|^2
    quad_inv2: torch.Tensor     # (N, 3) e2 / |e2|^2
    box_min: torch.Tensor       # (N, 3)
    box_max: torch.Tensor       # (N, 3)
    neg_inv_density: torch.Tensor  # (N,)
    medium_slot: torch.Tensor      # (N,) int32
    xf_rot: torch.Tensor        # (N, 3, 3) world_from_object
    xf_off: torch.Tensor        # (N, 3)


@dataclass(frozen=True)
class MaterialArrays(_Tensors):
    kind: torch.Tensor     # (M,) int32
    tex: torch.Tensor      # (M,) int32
    fuzz: torch.Tensor     # (M,)
    ref_idx: torch.Tensor  # (M,)


@dataclass(frozen=True)
class TextureArrays(_Tensors):
    kind: torch.Tensor        # (T,) int32
    color: torch.Tensor       # (T, 3)
    odd: torch.Tensor         # (T,) int32
    even: torch.Tensor        # (T,) int32
    scale: torch.Tensor       # (T,)
    perlin_id: torch.Tensor   # (T,) int32
    image_id: torch.Tensor    # (T,) int32
    perlin_salt: torch.Tensor     # (P,) uint32 hash-noise salt
    perlin_ranvec: torch.Tensor   # (P, 256, 3) strict-mode table noise
    perlin_perm: torch.Tensor     # (P, 3, 256) int32
    img_atlas: torch.Tensor   # (I, Hmax, Wmax) uint32 packed 8-bit RGB
    img_size: torch.Tensor    # (I, 2) int32 (width, height)


@dataclass(frozen=True)
class LightArrays(_Tensors):
    """Flat light list (uniform pick, mean density)."""

    kind: torch.Tensor       # (L,) int32
    quad_p0: torch.Tensor    # (L, 3)
    quad_e1: torch.Tensor    # (L, 3)
    quad_e2: torch.Tensor    # (L, 3)
    quad_n: torch.Tensor     # (L, 3)
    quad_d: torch.Tensor     # (L,)
    quad_inv1: torch.Tensor  # (L, 3)
    quad_inv2: torch.Tensor  # (L, 3)
    quad_area: torch.Tensor  # (L,)
    center: torch.Tensor     # (L, 3)
    radius: torch.Tensor     # (L,)


# SceneData's static fields, in declaration order (convert.py carries them)
STATIC_FIELDS = (
    "n_prims", "n_lights", "has_media", "n_media", "n_solid", "n_sphere",
    "n_sphere_static", "n_box", "has_box_media", "has_moving", "has_quads",
    "has_spheres", "has_solid_box", "any_transform", "has_lambertian",
    "has_metal", "has_dielectric", "has_isotropic", "has_emissive",
    "has_checker", "checker_fancy", "has_perlin", "has_image",
    "image_on_emissive", "t_min", "strict",
)


@dataclass(frozen=True)
class SceneData(_Tensors):
    """Complete scene: tensors plus static feature flags.

    Row layout: spheres [0, n_sphere) with the static ones first, solid
    boxes [n_sphere, n_sphere+n_box), quads up to n_solid, media after.
    """

    prims: PrimArrays
    mats: MaterialArrays
    texs: TextureArrays
    lights: LightArrays
    background: torch.Tensor    # (3,)
    prim_payload: torch.Tensor  # (N, 22) float32
    mat_payload: torch.Tensor   # (M, 16) float32

    n_prims: int = 0
    n_lights: int = 0
    has_media: bool = False
    n_media: int = 0
    n_solid: int = 0
    n_sphere: int = 0
    n_sphere_static: int = 0
    n_box: int = 0
    has_box_media: bool = False
    has_moving: bool = False
    has_quads: bool = False
    has_spheres: bool = True
    has_solid_box: bool = False
    any_transform: bool = False
    has_lambertian: bool = True
    has_metal: bool = True
    has_dielectric: bool = True
    has_isotropic: bool = True
    has_emissive: bool = True
    has_checker: bool = False
    checker_fancy: bool = False
    has_perlin: bool = False
    has_image: bool = False
    image_on_emissive: bool = False
    t_min: float = 1e-3
    strict: bool = False

    @property
    def device(self) -> torch.device:
        return self.background.device
