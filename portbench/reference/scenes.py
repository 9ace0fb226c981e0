"""The benchmark's scenes and their cameras, built again from the
reference's scene descriptions (``src/Scenes.hs``), as flat tables.

A scene is a builder ``build(seed)`` and a camera ``camera(w, h)``: the two
below, or those of a module ``scene_<name>.py`` beside this one (found by
:func:`scene_fns`).  The builder returns ``(solids, media, background,
t_min)``, or ``(solids, media, background, t_min, lights)`` for a scene
with a light list: ``lights`` is the reference's list of hittables that a
Lambertian scatter samples toward (its ``MixturePdf (HittablePdf lights)
(CosinePdf onb)``), in the reference's order, each an untransformed quad or
sphere :class:`Prim`, usually the same object as one of the solids.  A
builder of four elements has no light list: its Lambertian scatters by the
cosine lobe alone.  :func:`rect` and :func:`box_faces` build the
reference's axis-aligned rects and its boxes under a rigid transform.

The procedural content is drawn from ``numpy.random.default_rng(seed)`` in
the builders' order: book 1's 22 x 22 grid (material draw, two position
draws, then the material's own draws), next week's 400 box heights and
then the 1000 sphere centres.  The flattening keeps the estimator's prim
order, which decides the closest hit on equal distances and the media
draws: static spheres, moving spheres, solid boxes and quads, each kind in
Morton order of its centroid over all solids (ties in insertion order),
then the media in insertion order.  Every geometric value is computed in
float64 and rounded once to float32.
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import numpy as np
import torch

SPHERE, BOX, QUAD, MEDIUM_SPHERE = 0, 1, 2, 3
LAMBERTIAN, METAL, DIELECTRIC, LIGHT, ISOTROPIC = 0, 1, 2, 3, 4
TEX_CONSTANT, TEX_PERLIN = 0, 2
# the light table's columns: a quad's corner, first and second edge, normal,
# plane offset, area, u and v projectors; a sphere's centre (the corner's
# columns) and radius
L_CORNER, L_E1, L_E2, L_NORMAL = 0, 3, 6, 9
L_OFFSET, L_AREA, L_U, L_V, L_RADIUS = 12, 13, 14, 17, 20
LIGHT_COLS = 21
SKY = (0.7, 0.8, 0.9)
BLACK = (0.0, 0.0, 0.0)
f32 = np.float32


@dataclass
class Camera:
    """The 21 camera words: origin, lower left, horizontal, vertical, u, v,
    (lens radius, shutter open, shutter close), as python floats of the
    float32 values."""

    words: list


def camera(lookfrom, lookat, vup, vfov, aspect, aperture, focus, t0=0.0,
           t1=1.0) -> Camera:
    """Thin-lens camera frame, each step a float32 operation; the tangent
    in float64 rounded once."""
    lf, la, vu = (np.asarray(v, f32) for v in (lookfrom, lookat, vup))
    hh = f32(np.tan(float(vfov) * float(np.pi) / 180.0 / 2.0))
    hw = f32(aspect) * hh

    def norm(x):
        return x / f32(np.sqrt(f32(x @ x)))

    w = norm(lf - la)
    u = norm(np.cross(vu, w).astype(f32))
    v = np.cross(w, u).astype(f32)
    fd = f32(focus)
    lower_left = lf - (hw * fd) * u - (hh * fd) * v - fd * w
    parts = [lf, lower_left, (f32(2.0) * hw * fd) * u,
             (f32(2.0) * hh * fd) * v, u, v,
             np.array([f32(aperture / 2.0), f32(t0), f32(t1)], f32)]
    return Camera([float(x) for p in parts for x in np.asarray(p, f32)])


@dataclass
class Prim:
    kind: int
    mkind: int
    color: tuple = (0.0, 0.0, 0.0)
    fuzz: float = 0.0
    ref_idx: float = 1.0
    tex: int = TEX_CONSTANT
    scale: float = 0.0
    salt: int = 0
    center: tuple = (0.0, 0.0, 0.0)
    velocity: tuple = (0.0, 0.0, 0.0)
    time0: float = 0.0
    radius: float = 0.0
    p0: tuple = (0.0, 0.0, 0.0)
    e1: tuple = (0.0, 0.0, 0.0)
    e2: tuple = (0.0, 0.0, 0.0)
    normal: tuple = (0.0, 0.0, 0.0)
    box_min: tuple = (0.0, 0.0, 0.0)
    box_max: tuple = (0.0, 0.0, 0.0)
    density: float = 0.0


def lambertian(color):
    return dict(mkind=LAMBERTIAN, color=tuple(color))


def metal(color, fuzz):
    return dict(mkind=METAL, color=tuple(color), fuzz=float(fuzz))


def diffuse_light(color):
    return dict(mkind=LIGHT, color=tuple(color))


def dielectric(ref_idx):
    # its texture value is never read: the weight of a refraction is 1
    return dict(mkind=DIELECTRIC, ref_idx=float(ref_idx))


def sphere(center, radius, mat):
    return Prim(SPHERE, center=tuple(float(c) for c in center),
                radius=float(radius), **mat)


def perlin_salt(seed: int) -> int:
    """The hash salt of a Perlin instance made with ``seed``."""
    s = 0x9E3779B9 ^ (int(seed) & 0xFFFFFFFF)
    s ^= s >> 16
    s = (s * 0x85EBCA6B) & 0xFFFFFFFF
    return s ^ (s >> 13)


def book1_final(seed: int):
    """Book 1's cover (``src/Scenes.hs:252-317``): the ground, three large
    spheres and the random grid of small ones."""
    rng = np.random.default_rng(seed)
    world = [sphere((0, -1000, 0), 1000, lambertian((0.5, 0.5, 0.5))),
             sphere((0, 1, 0), 1.0, dielectric(1.5)),
             sphere((-4, 1, 0), 1.0, lambertian((0.4, 0.2, 0.1))),
             sphere((4, 1, 0), 1.0, metal((0.7, 0.6, 0.5), 0.0))]
    for a in range(-11, 11):
        for b in range(-11, 11):
            mat_p = rng.random()
            px, py = rng.random(), rng.random()
            c = np.array([a + 0.9 * px, 0.2, b + 0.9 * py])
            if np.linalg.norm(c - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if mat_p < 0.8:
                mat = lambertian(rng.random(3) * rng.random(3))
            elif mat_p < 0.95:
                alb = rng.uniform(0.5, 1.0, 3)
                mat = metal(alb, rng.uniform(0.0, 0.5))
            else:
                mat = dielectric(1.5)
            world.append(sphere(c, 0.2, mat))
    return world, [], SKY, 1e-3


def rect(plane: str, i0, i1, j0, j1, k, mat, rot=None, off=None) -> Prim:
    """The reference's axis-aligned rect (``XYRect``, ``XZRect``,
    ``YZRect``: (i, j) = (x, y), (x, z) or (y, z) at the third axis = k)
    as a quad: corner (i0, j0, k), edges along i and j, normal +k; under
    the rigid transform ``rot @ x + off`` (float64) when given."""
    ia, ja, ka = {"xy": (0, 1, 2), "xz": (0, 2, 1), "yz": (1, 2, 0)}[plane]
    p0, e1, e2, nrm = (np.zeros(3) for _ in range(4))
    p0[ia], p0[ja], p0[ka] = i0, j0, k
    e1[ia], e2[ja], nrm[ka] = i1 - i0, j1 - j0, 1.0
    if rot is not None:
        p0, e1, e2, nrm = rot @ p0 + off, rot @ e1, rot @ e2, rot @ nrm
    return Prim(QUAD, p0=tuple(p0), e1=tuple(e1), e2=tuple(e2),
                normal=tuple(nrm), **mat)


def box_faces(pmin, pmax, mat, rot, off) -> list:
    """The reference's ``cuboid`` (``src/Lib.hs:594-605``) as its six rects
    in its order, under the rigid transform ``rot @ x + off``."""
    (x0, y0, z0), (x1, y1, z1) = pmin, pmax
    return [rect("xy", x0, x1, y0, y1, z1, mat, rot, off),
            rect("xy", x0, x1, y0, y1, z0, mat, rot, off),
            rect("xz", x0, x1, z0, z1, y1, mat, rot, off),
            rect("xz", x0, x1, z0, z1, y0, mat, rot, off),
            rect("yz", y0, y1, z0, z1, x1, mat, rot, off),
            rect("yz", y0, y1, z0, z1, x0, mat, rot, off)]


def rot_y(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def next_week_final(seed: int):
    """The Next Week's final scene (``src/Scenes.hs:414-466``) with the
    earth texture's cyan fallback; no light list (cosine sampling only)."""
    rng = np.random.default_rng(seed)
    world = []
    for i in range(20):
        for j in range(20):
            x0, z0 = i * 100.0 - 1000.0, j * 100.0 - 1000.0
            y1 = rng.uniform(1.0, 101.0)
            world.append(Prim(BOX, box_min=(x0, 0.0, z0),
                              box_max=(x0 + 100.0, y1, z0 + 100.0),
                              **lambertian((0.48, 0.83, 0.53))))
    world.append(rect("xz", 113, 443, 127, 432, 554,
                      diffuse_light((7.0, 7.0, 7.0))))
    world.append(Prim(SPHERE, center=(400.0, 400.0, 200.0),
                      velocity=(30.0, 0.0, 0.0), time0=0.0, radius=50.0,
                      **lambertian((0.7, 0.3, 0.1))))
    world.append(sphere((260, 150, 45), 50, dielectric(1.5)))
    world.append(sphere((0, 150, 145), 50, metal((0.8, 0.8, 0.9), 10.0)))
    world.append(sphere((360, 150, 145), 70, dielectric(1.5)))
    media = [Prim(MEDIUM_SPHERE, center=(360.0, 150.0, 145.0), radius=70.0,
                  density=0.2, mkind=ISOTROPIC, color=(0.2, 0.4, 0.9)),
             Prim(MEDIUM_SPHERE, center=(0.0, 0.0, 0.0), radius=5000.0,
                  density=0.0001, mkind=ISOTROPIC, color=(1.0, 1.0, 1.0))]
    world.append(sphere((400, 200, 400), 100, lambertian((0.0, 1.0, 1.0))))
    world.append(Prim(SPHERE, center=(220.0, 280.0, 300.0), radius=80.0,
                      mkind=LAMBERTIAN, tex=TEX_PERLIN, scale=0.1,
                      salt=perlin_salt(seed)))
    rot, off = rot_y(15.0), np.array([-100.0, 270.0, 395.0])
    for _ in range(1000):
        c = rot @ rng.uniform(0.0, 165.0, 3) + off
        world.append(sphere(c, 10, lambertian((0.73, 0.73, 0.73))))
    return world, media, BLACK, 1e-2


SCENES = {"book1-final": book1_final, "next-week-final": next_week_final}
CAMERAS = {
    "book1-final": lambda w, h: camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0,
                                       w / h, 0.1, 10.0),
    "next-week-final": lambda w, h: camera((575, 278, -525), (320, 278, 0),
                                           (0, 1, 0), 40.0, w / h, 0.1,
                                           580.0),
}


def scene_fns(name: str):
    """(builder, camera) of a scene: the two above, or those of the module
    ``scene_<name with '-' as '_'>.py`` beside this one (``build(seed)``
    returning (solids, media, background, t_min) or (solids, media,
    background, t_min, lights), and ``camera(w, h)``), so that a scene, its
    light list with it, is added as a file of its own."""
    if name in SCENES:
        return SCENES[name], CAMERAS[name]
    mod = importlib.import_module(f".scene_{name.replace('-', '_')}",
                                  __package__)
    return mod.build, mod.camera


def _part1by2(v):
    v = v.astype(np.uint32) & np.uint32(0x3FF)
    v = (v | (v << 16)) & np.uint32(0x030000FF)
    v = (v | (v << 8)) & np.uint32(0x0300F00F)
    v = (v | (v << 4)) & np.uint32(0x030C30C3)
    return (v | (v << 2)) & np.uint32(0x09249249)


def _centroid(p: Prim) -> np.ndarray:
    if p.kind == QUAD:
        return np.array(p.p0) + 0.5 * (np.array(p.e1) + np.array(p.e2))
    if p.kind == BOX:
        return 0.5 * (np.array(p.box_min) + np.array(p.box_max))
    c, v = np.array(p.center), np.array(p.velocity)
    return 0.5 * ((c + v * (0.0 - p.time0)) + (c + v * (1.0 - p.time0)))


def _order(solids):
    """Solids sorted by (kind, moving, Morton code of the centroid)."""
    cen = np.array([_centroid(p) for p in solids])
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, 1e-12)
    q = np.clip(((cen - lo) / span) * 1023.0, 0.0, 1023.0).astype(np.uint32)
    code = (_part1by2(q[:, 2]) << 2) | (_part1by2(q[:, 1]) << 1) \
        | _part1by2(q[:, 0])
    moving = [p.kind == SPHERE and any(abs(x) > 0 for x in p.velocity)
              for p in solids]
    return sorted(range(len(solids)),
                  key=lambda i: (solids[i].kind, moving[i], int(code[i])))


@dataclass
class Scene:
    """Flat tables of one scene on one device, in one float type.

    Prim columns (all prims, solids then media): ``kind``, ``mkind``,
    ``tex``, ``A`` (centre, quad corner or box minimum), ``B`` (velocity,
    quad normal or box maximum), ``C`` (shutter start, quad plane offset
    or -1/density), ``D`` (radius), ``color``, ``fuzz``, ``ref_idx``,
    ``scale``, ``salt`` (int64).  Sweep tables by kind: ``sph`` (n_s, 8)
    centre, velocity, time0, radius^2 with ``n_ss`` static rows first;
    ``box`` (n_b, 6); ``quad`` (n_q, 13) corner, normal, plane offset and
    the two uv projectors.  ``media``: one dict of python floats each.
    ``lights`` (L, LIGHT_COLS), the light list in its order: a quad's
    corner, edges, normal, plane offset, area and uv projectors, a
    sphere's centre and radius (columns ``L_*``); ``light_kind`` each
    light's ``QUAD`` or ``SPHERE``; ``flags["n_lights"]`` = L (0: the
    Lambertian scatters by its cosine lobe alone)."""

    n_prims: int
    n_solid: int
    n_ss: int
    sph: torch.Tensor
    box: torch.Tensor
    quad: torch.Tensor
    media: list
    kind: torch.Tensor
    mkind: torch.Tensor
    tex: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    D: torch.Tensor
    color: torch.Tensor
    fuzz: torch.Tensor
    ref_idx: torch.Tensor
    scale: torch.Tensor
    salt: torch.Tensor
    flags: dict
    t_min: float
    background: tuple
    lights: torch.Tensor
    light_kind: tuple


def build(name: str, seed: int, device="cpu", dt=torch.float32) -> Scene:
    """The named scene drawn from ``seed``, flattened, on ``device``."""
    solids, media, bg, t_min, *rest = scene_fns(name)[0](seed)
    lights = rest[0] if rest else []
    solids = [solids[i] for i in _order(solids)]
    prims = solids + media
    n, ns = len(prims), len(solids)
    a32 = lambda rows: np.array(rows, np.float64).astype(f32)
    kind = np.array([p.kind for p in prims])
    is_q, is_b = kind == QUAD, kind == BOX
    is_m = kind >= MEDIUM_SPHERE
    center, vel = a32([p.center for p in prims]), a32([p.velocity for p in prims])
    p0, nrm = a32([p.p0 for p in prims]), a32([p.normal for p in prims])
    e1, e2 = a32([p.e1 for p in prims]), a32([p.e2 for p in prims])
    bmin, bmax = a32([p.box_min for p in prims]), a32([p.box_max for p in prims])
    radius = a32([p.radius for p in prims])
    time0 = a32([p.time0 for p in prims])
    nid = np.array([-1.0 / p.density if p.density else 0.0 for p in prims],
                   np.float64).astype(f32)
    qd = np.sum(p0 * nrm, -1)
    inv1 = e1 / np.maximum(np.sum(e1 * e1, -1), f32(1e-30))[:, None]
    inv2 = e2 / np.maximum(np.sum(e2 * e2, -1), f32(1e-30))[:, None]
    A = np.where(is_q[:, None], p0, np.where(is_b[:, None], bmin, center))
    B = np.where(is_q[:, None], nrm, np.where(is_b[:, None], bmax, vel))
    C = np.where(is_m, nid, np.where(is_q, qd, time0))
    moving = np.any(np.abs(vel) > 0, axis=1) & (kind == SPHERE)
    n_s = int(np.sum(kind == SPHERE))
    n_b = int(np.sum(is_b))
    sph = np.concatenate([center, vel, time0[:, None],
                          (radius * radius)[:, None]], axis=1)[:n_s]
    quad = np.concatenate([p0, nrm, qd[:, None], inv1, inv2],
                          axis=1)[n_s + n_b:ns]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, f32)).to(device, dt)
    i64 = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(device)
    med = []
    for j, p in enumerate(media):
        r = f32(p.radius)
        med.append(dict(center=[float(c) for c in center[ns + j]],
                        r2=float(r * r), nid=float(nid[ns + j]), slot=j))
    mk = [p.mkind for p in prims]
    flags = dict(has_moving=bool(moving.any()), has_quads=bool(is_q.any()),
                 has_solid_box=bool(is_b.any()), has_media=bool(is_m.any()),
                 has_perlin=any(p.tex == TEX_PERLIN for p in prims),
                 has_emissive=LIGHT in mk, has_lambertian=LAMBERTIAN in mk,
                 has_metal=METAL in mk, has_dielectric=DIELECTRIC in mk,
                 has_isotropic=ISOTROPIC in mk, n_lights=len(lights))
    return Scene(
        n_prims=n, n_solid=ns, n_ss=int(n_s - moving.sum()),
        sph=t(sph), box=t(np.concatenate([bmin, bmax], axis=1)[n_s:n_s + n_b]),
        quad=t(quad), media=med, kind=i64(kind), mkind=i64(mk),
        tex=i64([p.tex for p in prims]), A=t(A), B=t(B), C=t(C), D=t(radius),
        color=t(a32([p.color for p in prims])),
        fuzz=t(a32([p.fuzz for p in prims])),
        ref_idx=t(a32([p.ref_idx for p in prims])),
        scale=t(a32([p.scale for p in prims])),
        salt=i64([p.salt for p in prims]), flags=flags,
        t_min=float(f32(t_min)), background=tuple(float(x) for x in a32(bg)),
        lights=t(light_table(lights)),
        light_kind=tuple(p.kind for p in lights))


def light_table(lights) -> np.ndarray:
    """(L, LIGHT_COLS) float32 rows of the light list: each quad's plane
    offset and uv projectors as the quad table's (float32 from the float32
    corner, edges and normal), its area |e1 x e2| in float64 rounded once;
    each sphere's centre and radius."""
    rows = np.zeros((len(lights), LIGHT_COLS), f32)
    for j, p in enumerate(lights):
        if p.kind == QUAD:
            c, e1, e2, nrm = (np.array(v, np.float64).astype(f32)
                              for v in (p.p0, p.e1, p.e2, p.normal))
            rows[j, L_CORNER:L_CORNER + 3] = c
            rows[j, L_E1:L_E1 + 3] = e1
            rows[j, L_E2:L_E2 + 3] = e2
            rows[j, L_NORMAL:L_NORMAL + 3] = nrm
            rows[j, L_OFFSET] = np.sum(c * nrm)
            rows[j, L_AREA] = np.linalg.norm(np.cross(
                np.array(p.e1, np.float64), np.array(p.e2, np.float64)))
            rows[j, L_U:L_U + 3] = e1 / max(np.sum(e1 * e1), f32(1e-30))
            rows[j, L_V:L_V + 3] = e2 / max(np.sum(e2 * e2), f32(1e-30))
        elif p.kind == SPHERE and not any(p.velocity):
            rows[j, L_CORNER:L_CORNER + 3] = p.center
            rows[j, L_RADIUS] = p.radius
        else:
            raise ValueError("a light is an untransformed quad or a static "
                             "sphere")
    return rows
