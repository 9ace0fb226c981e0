"""Scene compiler: object tree -> flat scene tensors.

Port of ``tpu_ray/models/compile.py``: the same host numpy flattening, op
for op, so every array is bit-equal to the JAX package's; only the last
step differs - the arrays become torch tensors on the CPU (move them with
``SceneData.to(device)``).

Replaces the reference's scene-construction path (``makeBVH`` over a
``Hittable`` tree, src/Lib.hs:941-968) with a host-side flattening pass:

* ``Box`` explodes into its 6 rects (reference ``cuboid``, src/Lib.hs:594-605).
* ``Translate``/``Rotate`` chains compose into one rigid transform per
  primitive (reference keeps them as tree nodes and re-transforms rays
  recursively, src/Lib.hs:1029-1052).  Transforms on spheres are baked
  directly into world-space centers/velocities (spheres are rotation
  invariant), so only rects and medium boxes carry a live transform.
* ``ConstantMedium`` boundaries reduce to a (possibly transformed) sphere or
  box - exactly the shapes the reference scenes use.
* Materials and textures are deduplicated into small tables; Perlin
  instances get a per-instance hash salt (the TPU-native stand-in for the
  reference's shuffled gradient/permutation tables, src/Lib.hs:424-439);
  images are stacked into a padded atlas.

The "BVH" of the reference is an acceleration concern, not a semantic one:
the wavefront intersector tests all primitives in lockstep (optionally in
chunks), which is the TPU-native equivalent; the light list keeps the
uniform-over-leaves weighting that the reference's count-weighted light BVH
produces (src/Lib.hs:694-724).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import objects as ob
from .scene_data import (
    LIGHT_QUAD,
    LIGHT_SPHERE,
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    PRIM_MEDIUM_BOX,
    PRIM_BOX,
    PRIM_MEDIUM_SPHERE,
    PRIM_QUAD,
    PRIM_SPHERE,
    TEX_CHECKER,
    TEX_CONSTANT,
    TEX_IMAGE,
    TEX_PERLIN,
    LightArrays,
    MaterialArrays,
    PrimArrays,
    SceneData,
    TextureArrays,
)


# plane -> (i_axis, j_axis, k_axis); reference rect orientations
# (src/Lib.hs:1005-1012)
_PLANE_AXES = {"xy": (0, 1, 2), "xz": (0, 2, 1), "yz": (1, 2, 0)}


def rotation_matrix(axis: str, angle_deg: float) -> np.ndarray:
    """World-from-object rotation matching ``rotatePoint`` (src/Lib.hs:763-774)."""
    rad = math.radians(angle_deg)
    c, s = math.cos(rad), math.sin(rad)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    if axis == "y":
        # reference YAxis: (c*x + s*z, y, -s*x + c*z)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
    raise ValueError(f"bad axis {axis!r}")


class _Tables:
    """Accumulates deduplicated material/texture/perlin/image tables."""

    def __init__(self):
        self.mat_rows: List[tuple] = []
        self._mat_index: dict = {}
        self.tex_rows: List[tuple] = []
        self._tex_index: dict = {}
        self.perlins: List[np.uint32] = []  # per-instance hash salt
        self.images: List[Optional[np.ndarray]] = []
        self._image_index: dict = {}

    # -- textures --
    def texture(self, tex: ob.Texture) -> int:
        key = tex
        if key in self._tex_index:
            return self._tex_index[key]
        if isinstance(tex, ob.SolidColor):
            row = (TEX_CONSTANT, tuple(tex.color), 0, 0, 0.0, 0, 0)
        elif isinstance(tex, ob.Checker):
            if isinstance(tex.odd, ob.Checker) or isinstance(tex.even, ob.Checker):
                raise ValueError("nested Checker textures are not supported")
            odd = self.texture(tex.odd)
            even = self.texture(tex.even)
            row = (TEX_CHECKER, (0.0, 0.0, 0.0), odd, even, 0.0, 0, 0)
        elif isinstance(tex, ob.Noise):
            pid = len(self.perlins)
            # per-instance stream key for the hash-gradient noise
            # (ops/textures.py); plays the role of the reference's shuffled
            # permutation tables (src/Lib.hs:424-439)
            salt = 0x9E3779B9 ^ (int(tex.seed) & 0xFFFFFFFF)
            salt ^= salt >> 16
            salt = (salt * 0x85EBCA6B) & 0xFFFFFFFF
            salt ^= salt >> 13
            self.perlins.append(np.uint32(salt))
            row = (TEX_PERLIN, (0.0, 0.0, 0.0), 0, 0, float(tex.scale), pid, 0)
        elif isinstance(tex, ob.ImageTexture):
            if tex.image is None:
                # missing image -> cyan, matching src/Lib.hs:510
                row = (TEX_CONSTANT, (0.0, 1.0, 1.0), 0, 0, 0.0, 0, 0)
            else:
                iid = self._image_index.get(id(tex.image))
                if iid is None:
                    iid = len(self.images)
                    self.images.append(np.asarray(tex.image))
                    self._image_index[id(tex.image)] = iid
                row = (TEX_IMAGE, (0.0, 0.0, 0.0), 0, 0, 0.0, 0, iid)
        else:
            raise TypeError(f"unknown texture {tex!r}")
        idx = len(self.tex_rows)
        self.tex_rows.append(row)
        self._tex_index[key] = idx
        return idx

    # -- materials --
    def material(self, mat: ob.Material) -> int:
        key = mat
        if key in self._mat_index:
            return self._mat_index[key]
        if isinstance(mat, ob.Lambertian):
            row = (MAT_LAMBERTIAN, self.texture(mat.texture), 0.0, 1.0)
        elif isinstance(mat, ob.Metal):
            row = (MAT_METAL, self.texture(mat.texture), float(mat.fuzz), 1.0)
        elif isinstance(mat, ob.Dielectric):
            row = (MAT_DIELECTRIC, 0, 0.0, float(mat.ref_idx))
        elif isinstance(mat, ob.DiffuseLight):
            row = (MAT_DIFFUSE_LIGHT, self.texture(mat.texture), 0.0, 1.0)
        elif isinstance(mat, ob.Isotropic):
            row = (MAT_ISOTROPIC, self.texture(mat.texture), 0.0, 1.0)
        else:
            raise TypeError(f"unknown material {mat!r}")
        idx = len(self.mat_rows)
        self.mat_rows.append(row)
        self._mat_index[key] = idx
        return idx


class _Prim:
    """One flattened primitive row (host-side, float64 until device upload)."""

    __slots__ = (
        "kind", "mat", "center", "velocity", "time0", "radius",
        "p0", "e1", "e2", "n", "box_min", "box_max", "neg_inv_density",
        "rot", "off",
    )

    def __init__(self, kind, mat):
        self.kind = kind
        self.mat = mat
        self.center = np.zeros(3)
        self.velocity = np.zeros(3)
        self.time0 = 0.0
        self.radius = 0.0
        self.p0 = np.zeros(3)
        self.e1 = np.zeros(3)
        self.e2 = np.zeros(3)
        self.n = np.zeros(3)
        self.box_min = np.zeros(3)
        self.box_max = np.zeros(3)
        self.neg_inv_density = 0.0
        self.rot = np.eye(3)
        self.off = np.zeros(3)


_EYE3 = np.eye(3)


def _is_identity(rot: np.ndarray, off: np.ndarray) -> bool:
    # exact comparison: transforms are either untouched (identity) or the
    # product of real rotations/offsets; np.allclose here cost ~0.2s of the
    # 3409-prim scene build (PERFLOG.md)
    return rot is _EYE3 or (
        (rot == _EYE3).all() and not off.any()
    )


def _flatten(
    obj: ob.Object,
    rot: np.ndarray,
    off: np.ndarray,
    tables: _Tables,
    out: List[_Prim],
) -> None:
    if isinstance(obj, ob.Group):
        for o in obj.objects:
            _flatten(o, rot, off, tables, out)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _flatten(o, rot, off, tables, out)
    elif isinstance(obj, ob.Translate):
        # world = rot @ (x + t) + off = rot @ x + (rot @ t + off)
        t = np.asarray(obj.offset, np.float64)
        _flatten(obj.obj, rot, off + rot @ t, tables, out)
    elif isinstance(obj, ob.Rotate):
        _flatten(obj.obj, rot @ rotation_matrix(obj.axis, obj.angle), off, tables, out)
    elif isinstance(obj, ob.Sphere):
        p = _Prim(PRIM_SPHERE, tables.material(obj.material))
        # spheres are rotation-invariant: bake the transform (UV of a
        # rotated image-textured sphere would differ from the reference's
        # object-space UV; no reference scene exercises that).
        p.center = rot @ np.asarray(obj.center, np.float64) + off
        p.radius = float(obj.radius)
        out.append(p)
    elif isinstance(obj, ob.MovingSphere):
        p = _Prim(PRIM_SPHERE, tables.material(obj.material))
        c0 = rot @ np.asarray(obj.center0, np.float64) + off
        c1 = rot @ np.asarray(obj.center1, np.float64) + off
        duration = float(obj.time1) - float(obj.time0)
        p.center = c0
        p.velocity = (c1 - c0) / duration if duration != 0.0 else np.zeros(3)
        p.time0 = float(obj.time0)
        p.radius = float(obj.radius)
        out.append(p)
    elif isinstance(obj, ob.Rect):
        # compile the axis-aligned rect + accumulated rigid transform into a
        # world-space parallelogram: corner + two edges + normal
        p = _Prim(PRIM_QUAD, tables.material(obj.material))
        ia, ja, ka = _PLANE_AXES[obj.plane]
        p0 = np.zeros(3); p0[ia], p0[ja], p0[ka] = obj.i0, obj.j0, obj.k
        e1 = np.zeros(3); e1[ia] = obj.i1 - obj.i0
        e2 = np.zeros(3); e2[ja] = obj.j1 - obj.j0
        n = np.zeros(3); n[ka] = 1.0  # outward normal = +k axis
        # (src/Lib.hs:1005-1012); NOT e1 x e2, whose sign flips for XZ
        p.p0 = rot @ p0 + off
        p.e1 = rot @ e1
        p.e2 = rot @ e2
        p.n = rot @ n
        out.append(p)
    elif isinstance(obj, ob.Box):
        if np.allclose(rot, _EYE3):
            # axis-aligned: one slab-test prim instead of 6 rect tests
            # (reference cuboid, src/Lib.hs:594-605; 2400 of next-week's
            # 3409 prims were box faces - PERFLOG.md round 2)
            p = _Prim(PRIM_BOX, tables.material(obj.material))
            p.box_min = np.asarray(obj.pmin, np.float64) + off
            p.box_max = np.asarray(obj.pmax, np.float64) + off
            out.append(p)
        else:
            for r in _box_rects(obj):
                _flatten(r, rot, off, tables, out)
    elif isinstance(obj, ob.ConstantMedium):
        mat_id = tables.material(ob.Isotropic(obj.texture))
        base, brot, boff = _reduce_boundary(obj.boundary, rot, off)
        if isinstance(base, ob.Sphere):
            p = _Prim(PRIM_MEDIUM_SPHERE, mat_id)
            p.center = brot @ np.asarray(base.center, np.float64) + boff
            p.radius = float(base.radius)
        else:  # Box
            p = _Prim(PRIM_MEDIUM_BOX, mat_id)
            p.box_min = np.asarray(base.pmin, np.float64)
            p.box_max = np.asarray(base.pmax, np.float64)
            p.rot, p.off = brot, boff
        p.neg_inv_density = -1.0 / float(obj.density)
        out.append(p)
    else:
        raise TypeError(f"cannot flatten {obj!r}")


def _box_rects(b: ob.Box) -> List[ob.Rect]:
    """Six faces, mirroring ``cuboid`` (src/Lib.hs:594-605)."""
    (x0, y0, z0), (x1, y1, z1) = b.pmin, b.pmax
    m = b.material
    return [
        ob.Rect("xy", x0, x1, y0, y1, z1, m),
        ob.Rect("xy", x0, x1, y0, y1, z0, m),
        ob.Rect("xz", x0, x1, z0, z1, y1, m),
        ob.Rect("xz", x0, x1, z0, z1, y0, m),
        ob.Rect("yz", y0, y1, z0, z1, x1, m),
        ob.Rect("yz", y0, y1, z0, z1, x0, m),
    ]


def _reduce_boundary(obj: ob.Object, rot, off):
    """Strip Translate/Rotate wrappers down to a Sphere or Box."""
    while True:
        if isinstance(obj, ob.Translate):
            t = np.asarray(obj.offset, np.float64)
            off = off + rot @ t
            obj = obj.obj
        elif isinstance(obj, ob.Rotate):
            rot = rot @ rotation_matrix(obj.axis, obj.angle)
            obj = obj.obj
        elif isinstance(obj, (ob.Sphere, ob.Box)):
            return obj, rot, off
        else:
            raise TypeError(
                "ConstantMedium boundary must reduce to a Sphere or Box, "
                f"got {obj!r}"
            )


def _perlin_tables(salts):
    """Reference-construction Perlin tables, one set per Noise instance.

    ``makePerlin`` (reference src/Lib.hs:421-439): 256 gradient vectors
    with components uniform in [-1, 1] (raw, not normalized), and three
    independent permutations of 0..255 built by the classic downward
    Fisher-Yates (``perlinGeneratePerm``: for i = 255..1 swap p[i] with
    p[randomIntRM 0 i], both ends inclusive).  The reference draws from
    its seeded splitmix stream mid-scene-build; replicating Haskell's
    generator is out of scope, so each instance's stream here is PCG64
    seeded by its perlin_salt - same construction, reproducible tables,
    different (but statistically identical) field.  Used by the
    strict-mode marble only (ops/textures.py::_perlin_noise_table)."""
    if not salts:
        return (np.zeros((1, 1, 3), np.float32),
                np.zeros((1, 3, 1), np.int32))
    ranvecs, perms = [], []
    for salt in salts:
        rng = np.random.Generator(np.random.PCG64(int(salt)))
        ranvecs.append(rng.uniform(-1.0, 1.0, (256, 3)).astype(np.float32))
        ps = []
        for _ in range(3):
            p = np.arange(256)
            for i in range(255, 0, -1):
                t = int(rng.integers(0, i + 1))
                p[i], p[t] = p[t], p[i]
            ps.append(p)
        perms.append(np.stack(ps))
    return (np.stack(ranvecs),
            np.stack(perms).astype(np.int32))


def _one_hot(axis: int) -> np.ndarray:
    v = np.zeros(3, np.float32)
    v[axis] = 1.0
    return v


def _part1by2(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each value 2 apart (Morton interleave)."""
    v = v.astype(np.uint32) & np.uint32(0x3FF)
    v = (v | (v << 16)) & np.uint32(0x030000FF)
    v = (v | (v << 8)) & np.uint32(0x0300F00F)
    v = (v | (v << 4)) & np.uint32(0x030C30C3)
    v = (v | (v << 2)) & np.uint32(0x09249249)
    return v


def _morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton code per centroid (N, 3) -> (N,) uint32.

    Spatially-close primitives get close codes, so the intersector's
    128/512-prim blocks stay spatially coherent and the optional chunk-AABB
    culling in the scanned XLA sweep (ops/intersect.py) stays exact and
    cheap.  (Per-tile culling in the Pallas kernel was measured a loss on
    real TPU - bounced-ray tiles never agree to skip - see PERFLOG.md.)
    """
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / span) * 1023.0, 0.0, 1023.0).astype(np.uint32)
    return (
        (_part1by2(q[:, 2]) << 2)
        | (_part1by2(q[:, 1]) << 1)
        | _part1by2(q[:, 0])
    )


def _prim_centroid(p: "_Prim") -> np.ndarray:
    """World-space AABB centroid (motion: union over t in [0, 1])."""
    if p.kind == PRIM_QUAD:
        return p.p0 + 0.5 * (p.e1 + p.e2)
    if p.kind == PRIM_BOX:
        return 0.5 * (p.box_min + p.box_max)
    # spheres (all reference scenes move within t in [0, 1])
    c0 = p.center + p.velocity * (0.0 - p.time0)
    c1 = p.center + p.velocity * (1.0 - p.time0)
    return 0.5 * (c0 + c1)


def _quad_derived(p0, e1, e2, n):
    """Derived quad quantities: plane offset, uv projectors, area."""
    d = np.sum(p0 * n, -1)
    inv1 = e1 / np.maximum(np.sum(e1 * e1, -1), 1e-30)[:, None]
    inv2 = e2 / np.maximum(np.sum(e2 * e2, -1), 1e-30)[:, None]
    area = np.linalg.norm(np.cross(e1, e2), axis=-1)
    return d.astype(np.float32), inv1.astype(np.float32), \
        inv2.astype(np.float32), area.astype(np.float32)


def build_scene(
    world: Union[ob.Object, Sequence[ob.Object]],
    lights: Sequence[ob.Object] = (),
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    t_min: float = 1e-3,
) -> SceneData:
    """Compile an object tree (+ light list) to :class:`SceneData`.

    ``lights`` mirrors the reference's lights BVH (src/Lib.hs:82-84): the
    hittables importance-sampled by Lambertian scatter.  Only untransformed
    Rect and Sphere lights are supported (all the reference scenes use).
    """
    tables = _Tables()
    prims: List[_Prim] = []
    _flatten(world if isinstance(world, ob.Object) else ob.Group(world),
             np.eye(3), np.zeros(3), tables, prims)
    if not prims:
        raise ValueError("scene has no primitives")

    # order: spheres, then solid boxes, then quads, then media.  Kind-
    # homogeneous regions let each intersect sweep (and each per-kind
    # Pallas kernel launch) run only the math that kind needs.  Within each
    # solid kind, order by Morton code so prim blocks are spatially
    # coherent; media keep insertion order (their free-flight uniforms are
    # drawn per medium slot).
    solid_centroids = np.array(
        [_prim_centroid(p) for p in prims if p.kind < PRIM_MEDIUM_SPHERE]
    )
    if len(solid_centroids):
        codes = iter(_morton_codes(solid_centroids))
        morton = [
            int(next(codes)) if p.kind < PRIM_MEDIUM_SPHERE else 0
            for p in prims
        ]
    else:
        morton = [0] * len(prims)
    # within the sphere range, static spheres come first: the Pallas sweep
    # then runs the center-lerp math only over the moving suffix (exact:
    # a zero-velocity lerp is the identity, so the split changes nothing
    # but the op count - ops/intersect_pallas.py)
    def _is_moving(p):
        return p.kind == PRIM_SPHERE and bool(np.any(np.abs(p.velocity) > 0))

    order = sorted(
        range(len(prims)),
        key=lambda i: (prims[i].kind >= PRIM_MEDIUM_SPHERE, prims[i].kind,
                       _is_moving(prims[i]), morton[i]),
    )
    prims = [prims[i] for i in order]
    n = len(prims)
    kind = np.array([p.kind for p in prims], np.int32)
    mat = np.array([p.mat for p in prims], np.int32)
    center = np.stack([p.center for p in prims]).astype(np.float32)
    velocity = np.stack([p.velocity for p in prims]).astype(np.float32)
    time0 = np.array([p.time0 for p in prims], np.float32)
    radius = np.array([p.radius for p in prims], np.float32)
    quad_p0 = np.stack([p.p0 for p in prims]).astype(np.float32)
    quad_e1 = np.stack([p.e1 for p in prims]).astype(np.float32)
    quad_e2 = np.stack([p.e2 for p in prims]).astype(np.float32)
    quad_n = np.stack([p.n for p in prims]).astype(np.float32)
    quad_d, quad_inv1, quad_inv2, _ = _quad_derived(quad_p0, quad_e1, quad_e2, quad_n)
    box_min = np.stack([p.box_min for p in prims]).astype(np.float32)
    box_max = np.stack([p.box_max for p in prims]).astype(np.float32)
    neg_inv_density = np.array([p.neg_inv_density for p in prims], np.float32)
    medium_slot = np.zeros(n, np.int32)
    is_medium = (kind == PRIM_MEDIUM_SPHERE) | (kind == PRIM_MEDIUM_BOX)
    medium_slot[is_medium] = np.arange(int(is_medium.sum()), dtype=np.int32)
    n_media = int(is_medium.sum())
    xf_rot = np.stack([p.rot for p in prims]).astype(np.float32)
    xf_off = np.stack([p.off for p in prims]).astype(np.float32)

    box_media = kind == PRIM_MEDIUM_BOX
    live_transform = np.array(
        [not _is_identity(p.rot, p.off) for p in prims], bool
    ) & box_media

    prim_arrays = PrimArrays(
        kind=np.asarray(kind),
        mat=np.asarray(mat),
        center=np.asarray(center),
        velocity=np.asarray(velocity),
        time0=np.asarray(time0),
        radius=np.asarray(radius),
        quad_p0=np.asarray(quad_p0),
        quad_e1=np.asarray(quad_e1),
        quad_e2=np.asarray(quad_e2),
        quad_n=np.asarray(quad_n),
        quad_d=np.asarray(quad_d),
        quad_inv1=np.asarray(quad_inv1),
        quad_inv2=np.asarray(quad_inv2),
        box_min=np.asarray(box_min),
        box_max=np.asarray(box_max),
        neg_inv_density=np.asarray(neg_inv_density),
        medium_slot=np.asarray(medium_slot),
        xf_rot=np.asarray(xf_rot),
        xf_off=np.asarray(xf_off),
    )

    # --- materials / textures ---
    if not tables.mat_rows:
        tables.mat_rows.append((MAT_LAMBERTIAN, 0, 0.0, 1.0))
    if not tables.tex_rows:
        tables.tex_rows.append((TEX_CONSTANT, (0.0, 0.0, 0.0), 0, 0, 0.0, 0, 0))
    mk, mt, mf, mr = zip(*tables.mat_rows)
    mats = MaterialArrays(
        kind=np.asarray(np.array(mk, np.int32)),
        tex=np.asarray(np.array(mt, np.int32)),
        fuzz=np.asarray(np.array(mf, np.float32)),
        ref_idx=np.asarray(np.array(mr, np.float32)),
    )
    tk, tc, to, te, ts, tp, ti = zip(*tables.tex_rows)
    perlin_salt = (np.array(tables.perlins, np.uint32)
                   if tables.perlins else np.zeros(1, np.uint32))
    perlin_ranvec, perlin_perm = _perlin_tables(
        tables.perlins if tables.perlins else None)
    if tables.images:
        hmax = max(im.shape[0] for im in tables.images)
        wmax = max(im.shape[1] for im in tables.images)
        # one packed R|G<<8|B<<16 word per texel: the per-lane texture fetch
        # is then ONE uint32 gather + VPU unpack instead of a 3-wide f32 row
        # gather (5.2 -> 3.5 ms per 390k-lane wave, PERFLOG.md round 2).
        # colorToAlbedo applies /255 with no gamma decode at sample time
        # (src/Lib.hs:294-297); sources are 8-bit so packing is lossless.
        atlas = np.zeros((len(tables.images), hmax, wmax), np.uint32)
        sizes = np.zeros((len(tables.images), 2), np.int32)
        for idx, im in enumerate(tables.images):
            h, w = im.shape[:2]
            rgb = im[..., :3].astype(np.uint32)
            atlas[idx, :h, :w] = (rgb[..., 0] | (rgb[..., 1] << 8)
                                  | (rgb[..., 2] << 16))
            sizes[idx] = (w, h)
    else:
        atlas = np.zeros((1, 1, 1), np.uint32)
        sizes = np.ones((1, 2), np.int32)
    texs = TextureArrays(
        kind=np.asarray(np.array(tk, np.int32)),
        color=np.asarray(np.array(tc, np.float32)),
        odd=np.asarray(np.array(to, np.int32)),
        even=np.asarray(np.array(te, np.int32)),
        scale=np.asarray(np.array(ts, np.float32)),
        perlin_id=np.asarray(np.array(tp, np.int32)),
        image_id=np.asarray(np.array(ti, np.int32)),
        perlin_salt=np.asarray(perlin_salt),
        perlin_ranvec=np.asarray(perlin_ranvec),
        perlin_perm=np.asarray(perlin_perm),
        img_atlas=np.asarray(atlas),
        img_size=np.asarray(sizes),
    )

    # --- lights ---
    lrows = []
    for lt in lights:
        if isinstance(lt, ob.Rect):
            ia, ja, ka = _PLANE_AXES[lt.plane]
            p0 = np.zeros(3); p0[ia], p0[ja], p0[ka] = lt.i0, lt.j0, lt.k
            e1 = np.zeros(3); e1[ia] = lt.i1 - lt.i0
            e2 = np.zeros(3); e2[ja] = lt.j1 - lt.j0
            nrm = np.zeros(3); nrm[ka] = 1.0
            lrows.append((LIGHT_QUAD, p0, e1, e2, nrm, np.zeros(3), 0.0))
        elif isinstance(lt, ob.Sphere):
            lrows.append((LIGHT_SPHERE, np.zeros(3), np.zeros(3), np.zeros(3),
                          np.zeros(3), np.asarray(lt.center, np.float64),
                          float(lt.radius)))
        else:
            raise TypeError(f"unsupported light {lt!r} (Rect or Sphere only)")
    n_lights = len(lrows)
    if not lrows:  # dummy row so the arrays are non-empty
        lrows.append((LIGHT_QUAD, np.zeros(3), np.ones(3), np.ones(3),
                      np.array([0.0, 0.0, 1.0]), np.zeros(3), 0.0))
    lk, lp0, le1, le2, ln, lc, lr = zip(*lrows)
    lp0 = np.stack(lp0).astype(np.float32)
    le1 = np.stack(le1).astype(np.float32)
    le2 = np.stack(le2).astype(np.float32)
    ln = np.stack(ln).astype(np.float32)
    ld, linv1, linv2, larea = _quad_derived(lp0, le1, le2, ln)
    light_arrays = LightArrays(
        kind=np.asarray(np.array(lk, np.int32)),
        quad_p0=np.asarray(lp0),
        quad_e1=np.asarray(le1),
        quad_e2=np.asarray(le2),
        quad_n=np.asarray(ln),
        quad_d=np.asarray(ld),
        quad_inv1=np.asarray(linv1),
        quad_inv2=np.asarray(linv2),
        quad_area=np.asarray(larea),
        center=np.asarray(np.stack(lc).astype(np.float32)),
        radius=np.asarray(np.array(lr, np.float32)),
    )

    tex_kinds = set(int(k) for k in tk)

    # --- packed payloads (one wide gather instead of many scalar ones) ---
    # prim payload: 0 kind | 1 mat | 2:5 center | 5:8 velocity | 8 time0
    # | 9 radius | 10:13 quad_p0 | 13:16 quad_inv1 | 16:19 quad_inv2
    # | 19:22 quad_n.  Solid-box rows reuse the quad slots: 10:13 box_min,
    # 13:16 box_max (a box never needs the quad fields and vice versa).
    prim_payload = np.concatenate([
        kind[:, None].astype(np.float32),
        mat[:, None].astype(np.float32),
        center, velocity, time0[:, None], radius[:, None],
        quad_p0, quad_inv1, quad_inv2, quad_n,
    ], axis=1).astype(np.float32)
    is_solid_box = kind == PRIM_BOX
    if is_solid_box.any():
        prim_payload[is_solid_box, 10:13] = box_min[is_solid_box]
        prim_payload[is_solid_box, 13:16] = box_max[is_solid_box]

    # material payload: 0 mkind | 1 fuzz | 2 ref_idx | 3 tex_kind
    # | 4:7 color | 7:10 odd color | 10:13 even color | 13 perlin scale
    # | 14 perlin_id | 15 image_id
    tk_a = np.array(tk, np.int32)
    tc_a = np.array(tc, np.float32)
    to_a = np.array(to, np.int32)
    te_a = np.array(te, np.int32)
    ts_a = np.array(ts, np.float32)
    tp_a = np.array(tp, np.int32)
    ti_a = np.array(ti, np.int32)
    mt_a = np.array(mt, np.int32)
    checker_fancy = bool(np.any(
        (tk_a == TEX_CHECKER)
        & ((tk_a[to_a] != TEX_CONSTANT) | (tk_a[te_a] != TEX_CONSTANT))
    ))
    mat_payload = np.concatenate([
        np.array(mk, np.float32)[:, None],
        np.array(mf, np.float32)[:, None],
        np.array(mr, np.float32)[:, None],
        tk_a[mt_a][:, None].astype(np.float32),
        tc_a[mt_a],
        tc_a[to_a[mt_a]],
        tc_a[te_a[mt_a]],
        ts_a[mt_a][:, None],
        tp_a[mt_a][:, None].astype(np.float32),
        ti_a[mt_a][:, None].astype(np.float32),
    ], axis=1).astype(np.float32)

    scene = SceneData(
        prims=prim_arrays,
        mats=mats,
        texs=texs,
        lights=light_arrays,
        background=np.asarray(np.array(background, np.float32)),
        prim_payload=np.asarray(prim_payload),
        mat_payload=np.asarray(mat_payload),
        n_prims=n,
        n_lights=n_lights,
        has_media=n_media > 0,
        n_media=n_media,
        has_box_media=bool(np.any(box_media)),
        has_moving=bool(np.any(np.abs(velocity) > 0)),
        has_quads=bool(np.any(kind == PRIM_QUAD)),
        has_spheres=bool(np.any((kind == PRIM_SPHERE) | (kind == PRIM_MEDIUM_SPHERE))),
        has_solid_box=bool(is_solid_box.any()),
        n_solid=int(np.sum(~is_medium)),
        n_sphere=int(np.sum(kind == PRIM_SPHERE)),
        n_sphere_static=int(np.sum(
            (kind == PRIM_SPHERE) & ~np.any(np.abs(velocity) > 0, axis=1))),
        n_box=int(is_solid_box.sum()),
        any_transform=bool(np.any(live_transform)),
        has_lambertian=MAT_LAMBERTIAN in mk,
        has_metal=MAT_METAL in mk,
        has_dielectric=MAT_DIELECTRIC in mk,
        has_isotropic=MAT_ISOTROPIC in mk,
        has_emissive=MAT_DIFFUSE_LIGHT in mk,
        has_checker=TEX_CHECKER in tex_kinds,
        checker_fancy=checker_fancy,
        has_perlin=TEX_PERLIN in tex_kinds,
        has_image=TEX_IMAGE in tex_kinds,
        # static: an image texture on an emissive material would break the
        # fused shading kernel's deferred-albedo linearity
        # (ops/shade_pallas.py::supported)
        image_on_emissive=bool(np.any(
            (np.array(mk) == MAT_DIFFUSE_LIGHT)
            & (tk_a[mt_a] == TEX_IMAGE))),
        t_min=float(t_min),
    )
    return _to_torch(scene)


def _to_torch(obj):
    """Replace every numpy field of a (nested) scene dataclass by a torch
    tensor sharing its dtype."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            kw[f.name] = torch.from_numpy(np.ascontiguousarray(v))
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _to_torch(v)
    return dataclasses.replace(obj, **kw)
