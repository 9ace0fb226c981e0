"""The fused pool step: the CUDA kernel and its plain twin.

``csrc/pool_step.cu`` replaces the TPU kernel ``tpu_ray/ops/shade_pallas.py::
_step_kernel`` (with ``_shade_core``): one whole pool iteration per lane -
hit-record rebuild from the sweep's (best_t, best_i), constant / checker /
hash-Perlin / image textures (a checker's textured children by their
texture rows, ``textures.texture_value``, where the scene has such a
checker), scatter for the five materials with 50/50 light /
cosine MIS, optional Russian roulette, estimator accumulation, path death
and camera regeneration, hashed or from the scrambled Sobol' point of
``core/qmc.py`` (``Camera.sampler``).  On the work queue with the
``sobol-b0`` sampler a lane's first-bounce light and cosine draws come from
Sobol' dims 7-10 of its (pixel, global sample) (``StepConfig.b0``; the
JAX XLA queue's override).  With ``scene.strict`` it shades the
strict reference estimator, which the JAX package computes in XLA outside
its kernels (``ops/scatter.py``, ``ops/textures.py``): the reference's
table-noise Perlin octaves, the Lambertian's mixture with an unhittable
light in scenes without lights, and the ball-radius isotropic phase.
:func:`pool_step` launches it for CUDA tensors; :func:`pool_step_plain` is
the same step in plain PyTorch (the CPU path and the reference the kernel
is held to).

Pool state layout (one column per lane, so every access is coalesced):

* ``fstate`` (13, R) float32: origin xyz, direction xyz, time,
  throughput rgb, accumulated radiance rgb;
* ``istate`` (3, R) int32: bounce, next sample index, active (0/1);
* per lane, constant over a wave: ``xy`` (2, R) pixel-fraction base and
  ``slot`` (R,) int32 holding the uint32 global slot id.

The prim + material rows are the JAX megakernel's (N, 40) table
(``megakernel._build_tables``), row-major so each lane's winner row is one
indexed load; the (L, 25) light rows sit beside it, and the camera and
scalars are kernel arguments.  All draws are the
murmur3 streams of ``core/rng.py`` keyed by (key words, slot id), so the
kernel, the plain version and the JAX package draw identical numbers.

``init=True`` runs only the camera regeneration for every lane: the pool's
first sample (``regen(_init_pool_state(R), all)`` in the JAX integrator).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..core import qmc, rng
from ..core.rng import M32, as_u32, fmix, hash_col
from ..core.vec import cbrt_rn, sqrt_rn
from ..models.scene_data import (
    LIGHT_QUAD,
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    PRIM_BOX,
    PRIM_MEDIUM_BOX,
    PRIM_MEDIUM_SPHERE,
    PRIM_QUAD,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_PERLIN,
    SceneData,
)
from .build import load_fn

f32 = np.float32
TWO_PI = float(f32(2.0 * np.pi))
INV_PI = float(f32(1.0 / np.pi))
RR_PMIN = float(f32(0.05))
RR_COL = 14
PI = float(f32(np.pi))
HALF_PI = float(f32(np.pi / 2.0))
IMG_EPS = float(f32(1e-4))      # the reference's epsilon in image clamping
N_FSTATE, N_ISTATE = 13, 3
# roofline numerators per lane: bytes read once + written once (xy 8, slot
# 4, float state 52, int state 12, best_t 4, best_i 4 in; 52 + 12 out), and
# an estimate of the fp32 operations of a Lambertian bounce with light MIS
# over two lights plus the camera regeneration
BYTES_PER_LANE = 148
OPS_PER_LANE = 400

# --- prim/material row table (megakernel._build_tables layout) --------------
# f32 cols: 0 kind | 1 mat | 2:5 A | 5:8 B | 8 C | 9 D | 10:13 E | 13:16 F
#   sphere: A center, B velocity, C time0, D radius
#   quad:   A p0, B n, C plane d, E inv1, F inv2
#   box:    A box_min, B box_max
#   medium: A center / object-frame box_min, B box_max, C -1/density,
#           D radius, E xf_off, 30:39 xf_rot row-major
# material: 16 mkind | 17 fuzz | 18 ref_idx | 19 tex_kind | 20:23 color
#   | 23:26 odd | 26:29 even | 29 perlin scale | 39 image_id
PRIM_COLS = 40

# scene feature bits of the kernel's ``flags`` argument
FLAG_BITS = ("has_moving", "has_quads", "has_solid_box", "has_media",
             "has_checker", "has_perlin", "has_emissive", "has_lambertian",
             "has_metal", "has_dielectric", "has_isotropic", "has_image",
             "any_transform", "checker_fancy")
# the render-wide bits above them (csrc/shade_core.cuh)
SAMPLER_SOBOL_BIT = 1 << 14
STRICT_BIT = 1 << 15
SAMPLER_B0_BIT = 1 << 16
# camera samplers: "sobol-b0" is "sobol" plus, on the work queue only (as
# in the JAX package), the first bounce's light and cosine scatter draws
# from Sobol' dims 7-10 of (pixel, global sample); the pool and the
# megakernel keep the hashed scatter draws
SAMPLERS = ("uniform", "sobol", "sobol-b0")
# the scatter columns the sobol-b0 first bounce takes from dims 7-10: the
# light's (u, v) and the cosine lobe's (the coin, column 0, stays hashed)
B0_COLS = (2, 3, 6, 7)
# per-texture rows (csrc/shade_core.cuh TEX_COLS): 0 kind | 1:4 colour
# | 4 Perlin scale | 5 image id | 6 Perlin instance | 7 hash salt (bits)
TEX_COLS = 8


def build_tables(scene: SceneData):
    """(tab (N, 40) f32, salt (N,) uint32 Perlin salt per prim,
    lights (L, 25) f32) as numpy - ``megakernel._build_tables``."""
    t = lambda a: a.cpu().numpy()
    p = scene.prims
    n = scene.n_prims
    kind = t(p.kind)[:n]
    is_q = kind == PRIM_QUAD
    is_b = (kind == PRIM_BOX) | (kind == PRIM_MEDIUM_BOX)
    is_m = kind >= PRIM_MEDIUM_SPHERE
    geo = np.zeros((n, PRIM_COLS), np.float32)
    A = np.where(is_q[:, None], t(p.quad_p0)[:n],
                 np.where(is_b[:, None], t(p.box_min)[:n], t(p.center)[:n]))
    B = np.where(is_q[:, None], t(p.quad_n)[:n],
                 np.where(is_b[:, None], t(p.box_max)[:n], t(p.velocity)[:n]))
    C = np.where(is_m, t(p.neg_inv_density)[:n],
                 np.where(is_q, t(p.quad_d)[:n], t(p.time0)[:n]))
    E = np.where(is_m[:, None], t(p.xf_off)[:n], t(p.quad_inv1)[:n])
    geo[:, 0] = kind.astype(np.float32)
    geo[:, 1] = t(p.mat)[:n].astype(np.float32)
    geo[:, 2:5] = A
    geo[:, 5:8] = B
    geo[:, 8] = C
    geo[:, 9] = t(p.radius)[:n]
    geo[:, 10:13] = E
    geo[:, 13:16] = t(p.quad_inv2)[:n]
    geo[:, 30:39] = np.where(is_m[:, None], t(p.xf_rot)[:n].reshape(n, 9),
                             0.0)
    mp = t(scene.mat_payload)[t(p.mat)[:n]]
    geo[:, 16:30] = mp[:, 0:14]
    geo[:, 39] = mp[:, 15]
    if scene.has_perlin:
        salt = t(scene.texs.perlin_salt)[mp[:, 14].astype(np.int32)]
    else:
        salt = np.zeros((n,), np.uint32)
    if scene.n_lights > 0:
        L = scene.n_lights
        lt = scene.lights
        lights = np.concatenate([
            t(lt.quad_p0)[:L], t(lt.quad_e1)[:L], t(lt.quad_e2)[:L],
            t(lt.center)[:L], t(lt.radius)[:L, None],
            (t(lt.kind)[:L] == LIGHT_QUAD).astype(np.float32)[:, None],
            t(lt.quad_n)[:L], t(lt.quad_d)[:L, None], t(lt.quad_inv1)[:L],
            t(lt.quad_inv2)[:L], t(lt.quad_area)[:L, None],
        ], axis=1).astype(np.float32)
    else:
        lights = np.zeros((1, 25), np.float32)
    return geo, salt.astype(np.uint32), lights


def texture_table(scene: SceneData):
    """(texrow (T, 8) f32, kids (M, 2) int32) as numpy: every texture's own
    row and each material's checker children (odd, even texture ids), which
    the shade core reads for a checker whose children are not constant."""
    t = lambda a: a.cpu().numpy()
    tx = scene.texs
    pid = t(tx.perlin_id).astype(np.int64)
    rows = np.zeros((t(tx.kind).shape[0], TEX_COLS), np.float32)
    rows[:, 0] = t(tx.kind)
    rows[:, 1:4] = t(tx.color)
    rows[:, 4] = t(tx.scale)
    rows[:, 5] = t(tx.image_id)
    rows[:, 6] = pid
    salts = t(tx.perlin_salt).astype(np.uint32)
    rows[:, 7] = salts[np.clip(pid, 0, max(salts.shape[0] - 1, 0))].view(
        np.float32) if salts.size else 0.0
    mt = t(scene.mats.tex).astype(np.int64)
    kids = np.stack([t(tx.odd)[mt], t(tx.even)[mt]], axis=1).astype(np.int32)
    return rows, np.ascontiguousarray(kids)


def perlin_ids(scene: SceneData) -> np.ndarray:
    """(N,) int32 Perlin instance of each prim's material texture: the row
    of the strict mode's noise tables (``textures.marble_from``'s pid)."""
    n = scene.n_prims
    mp = scene.mat_payload.cpu().numpy()[scene.prims.mat.cpu().numpy()[:n]]
    return mp[:, 14].astype(np.int32)


@dataclass
class StepConfig:
    """Everything the pool step reads besides the lane state: scene tables
    (on the state's device), camera words, and the render's constants."""

    tab: torch.Tensor         # (N, 40) float32
    salt: torch.Tensor        # (N,) int32 holding uint32 bits
    lights: np.ndarray        # (L, 25) float32 (host copy, plain version)
    lights_t: torch.Tensor    # the same on the state's device (kernel)
    n_lights: int
    flags: dict               # FLAG_BITS -> bool
    atlas: torch.Tensor       # (I, Hmax, Wmax) int32: packed 8-bit RGB texels
    img_size: torch.Tensor    # (I, 2) int32 (width, height)
    perlin_id: torch.Tensor   # (N,) int32 Perlin instance per prim
    perm: torch.Tensor        # (P, 3, 256) int32 strict-mode noise tables
    ranvec: torch.Tensor      # (P, 256, 3) float32
    texrow: torch.Tensor      # (T, 8) float32 texture rows (texture_table)
    kids: torch.Tensor        # (M, 2) int32 checker children per material
    t_min: float
    background: np.ndarray    # (3,) float32
    cam: np.ndarray           # (21,) float32 (Camera.vec)
    inv_w: float
    inv_h: float
    max_depth: int
    rr_depth: int
    n_samples: int
    sample0: int
    cam_salt: int
    sobol: bool               # Sobol' camera sample (Camera.sampler)
    strict: bool              # the strict reference estimator
    b0: bool = False          # sobol-b0 first-bounce draws (the queue)

    @classmethod
    def create(cls, scene: SceneData, camera, width: int, height: int,
               max_depth: int, rr_depth: int = 0, n_samples: int = 1,
               sample0: int = 0, cam_salt: int = 0,
               queue: bool = False) -> "StepConfig":
        """The step's configuration for ``scene`` seen through ``camera``:
        the sampler comes from ``camera.sampler``, the estimator from
        ``scene.strict``.  ``queue``: the step runs on the work queue,
        where ``"sobol-b0"`` also takes each lane's first-bounce scatter
        draws from its (pixel, global sample) under ``cam_salt``."""
        if camera.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {camera.sampler!r}")
        geo, salt, lights = build_tables(scene)
        texrow, kids = texture_table(scene)
        dev = scene.device
        texs = scene.texs
        return cls(
            tab=torch.from_numpy(geo).to(dev),
            salt=torch.from_numpy(salt.view(np.int32)).to(dev),
            lights=lights, lights_t=torch.from_numpy(lights).to(dev),
            n_lights=int(scene.n_lights),
            flags={k: bool(getattr(scene, k)) for k in FLAG_BITS},
            atlas=torch.from_numpy(np.ascontiguousarray(
                texs.img_atlas.cpu().numpy()).view(np.int32)).to(dev),
            img_size=texs.img_size.to(torch.int32).contiguous(),
            perlin_id=torch.from_numpy(perlin_ids(scene)).to(dev),
            perm=texs.perlin_perm.to(torch.int32).contiguous(),
            ranvec=texs.perlin_ranvec.to(torch.float32).contiguous(),
            texrow=torch.from_numpy(texrow).to(dev),
            kids=torch.from_numpy(kids).to(dev),
            t_min=float(f32(scene.t_min)),
            background=scene.background.cpu().numpy().astype(np.float32),
            cam=camera.vec(), inv_w=float(f32(1.0 / width)),
            inv_h=float(f32(1.0 / height)), max_depth=int(max_depth),
            rr_depth=int(rr_depth), n_samples=int(n_samples),
            sample0=int(sample0) & M32, cam_salt=int(cam_salt) & M32,
            sobol=camera.sampler != "uniform", strict=bool(scene.strict),
            b0=bool(queue) and camera.sampler == "sobol-b0")


# --- plain helpers on component triples (megakernel.py:112-240) -------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _where3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _normalize(a):
    n2 = _dot(a, a)
    inv = torch.where(n2 > 0.0, 1.0 / sqrt_rn(torch.clamp(n2, min=1e-30)),
                      0.0)
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def _reflect(v, n):
    d = _dot(v, n)
    return tuple(v[i] - 2.0 * d * n[i] for i in range(3))


def _refract(uv, n, ratio):
    cos_theta = _dot((-uv[0], -uv[1], -uv[2]), n)
    rp = tuple(ratio * (uv[i] + cos_theta * n[i]) for i in range(3))
    s = -sqrt_rn(torch.clamp(1.0 - _dot(rp, rp), min=0.0))
    return tuple(rp[i] + s * n[i] for i in range(3))


def _onb_from_w(n):
    w = _normalize(n)
    pick = torch.abs(w[0]) > 0.9
    zero = torch.zeros_like(w[0])
    a = (torch.where(pick, 0.0, 1.0), torch.where(pick, 1.0, 0.0), zero)
    v = _normalize(_cross(w, a))
    return _cross(w, v), v, w


def _onb_local(uvw, x):
    u, v, w = uvw
    return tuple(x[0] * u[i] + x[1] * v[i] + x[2] * w[i] for i in range(3))


def _unit_vector_from(u0, u1):
    a = TWO_PI * u0
    z = 2.0 * u1 - 1.0
    r = sqrt_rn(torch.clamp(1.0 - z * z, min=0.0))
    return (r * torch.cos(a), r * torch.sin(a), z)


def _cosine_direction_from(u0, u1):
    z = sqrt_rn(torch.clamp(1.0 - u1, min=0.0))
    phi = TWO_PI * u0
    sq = sqrt_rn(u1)
    return (torch.cos(phi) * sq, torch.sin(phi) * sq, z)


def _to_sphere_from(u0, u1, radius, dist_squared):
    ctm = sqrt_rn(torch.clamp(1.0 - radius * radius / dist_squared,
                                 min=0.0))
    z = 1.0 + u1 * (ctm - 1.0)
    phi = TWO_PI * u0
    sq = sqrt_rn(torch.clamp(1.0 - z * z, min=0.0))
    return (torch.cos(phi) * sq, torch.sin(phi) * sq, z)


def _ipow5(x):
    # lax.integer_pow(x, 5) multiplies as x * ((x * x) * (x * x))
    x2 = x * x
    return x * (x2 * x2)


_PX, _PY, _PZ = 0x8DA6B343, 0xD8163841, 0xCB1AB31F


def _perlin_noise(salt, qx, qy, qz):
    """Hash-gradient Perlin octave (megakernel._perlin_noise)."""
    ix, iy, iz = torch.floor(qx), torch.floor(qy), torch.floor(qz)
    ux, uy, uz = qx - ix, qy - iy, qz - iz
    hx_ = ux * ux * (3.0 - 2.0 * ux)
    hy_ = uy * uy * (3.0 - 2.0 * uy)
    hz_ = uz * uz * (3.0 - 2.0 * uz)
    mul = rng._mul32
    cx0 = mul(ix.to(torch.int64) & M32, _PX)
    cy0 = mul(iy.to(torch.int64) & M32, _PY)
    cz0 = mul(iz.to(torch.int64) & M32, _PZ)
    hx = (cx0, (cx0 + _PX) & M32)
    hy = (cy0, (cy0 + _PY) & M32)
    hz = (cz0, (cz0 + _PZ) & M32)
    acc = torch.zeros_like(qx)
    to_signed = float(f32(2.0 / (1 << 24)))
    for di in (0, 1):
        w0 = hx_ if di else 1.0 - hx_
        ox = ux - di
        for dj in (0, 1):
            w1 = hy_ if dj else 1.0 - hy_
            oy = uy - dj
            for dk in (0, 1):
                w2 = hz_ if dk else 1.0 - hz_
                oz = uz - dk
                h1 = fmix(hx[di] ^ hy[dj] ^ hz[dk] ^ salt)
                h2 = fmix(h1 ^ 0x68E31DA4)
                h3 = fmix(h2 ^ 0xB5297A4D)
                gx = (h1 >> 8).to(torch.float32) * to_signed - 1.0
                gy = (h2 >> 8).to(torch.float32) * to_signed - 1.0
                gz = (h3 >> 8).to(torch.float32) * to_signed - 1.0
                acc = acc + (w0 * w1 * w2) * (gx * ox + gy * oy + gz * oz)
    return acc


def _perlin_noise_table(cfg: "StepConfig", pid, qx, qy, qz):
    """The reference's table-noise octave (strict mode,
    ``textures._perlin_noise_table``): gradient ``ranvec[permX[(i+di) &
    255] ^ permY[..] ^ permZ[..]]`` of Perlin instance ``pid``; ``& 255`` on
    the two's-complement lattice coordinate is the mathematical mod."""
    ix, iy, iz = torch.floor(qx), torch.floor(qy), torch.floor(qz)
    ux, uy, uz = qx - ix, qy - iy, qz - iz
    hx_ = ux * ux * (3.0 - 2.0 * ux)
    hy_ = uy * uy * (3.0 - 2.0 * uy)
    hz_ = uz * uz * (3.0 - 2.0 * uz)
    perm = cfg.perm.reshape(-1).to(torch.int64)
    ranvec = cfg.ranvec.reshape(-1, 3)
    base = pid.to(torch.int64) * 768
    i0, j0, k0 = (c.to(torch.int64) for c in (ix, iy, iz))
    px = [perm[base + ((i0 + d) & 255)] for d in (0, 1)]
    py = [perm[base + 256 + ((j0 + d) & 255)] for d in (0, 1)]
    pz = [perm[base + 512 + ((k0 + d) & 255)] for d in (0, 1)]
    vbase = pid.to(torch.int64) * 256
    acc = torch.zeros_like(qx)
    for di in (0, 1):
        w0 = hx_ if di else 1.0 - hx_
        ox = ux - di
        for dj in (0, 1):
            w1 = hy_ if dj else 1.0 - hy_
            oy = uy - dj
            for dk in (0, 1):
                w2 = hz_ if dk else 1.0 - hz_
                oz = uz - dk
                g = ranvec[vbase + (px[di] ^ py[dj] ^ pz[dk])]
                acc = acc + (w0 * w1 * w2) * (g[:, 0] * ox + g[:, 1] * oy
                                              + g[:, 2] * oz)
    return acc


def _marble(octave, scale, px, py, pz):
    """7-octave turbulence marble, 0.5 * (1 + sin(z + 10 |turb|)), with
    ``octave(qx, qy, qz)`` one octave of noise at the scaled point."""
    acc = torch.zeros_like(px)
    ppx, ppy, ppz = px, py, pz
    weight = 1.0
    for _ in range(7):
        acc = acc + weight * octave(scale * ppx, scale * ppy, scale * ppz)
        ppx, ppy, ppz = 2.0 * ppx, 2.0 * ppy, 2.0 * ppz
        weight = weight * 0.5
    return 0.5 * (1.0 + torch.sin(pz + 10.0 * torch.abs(acc)))


def image_value(cfg: StepConfig, iid, u, v):
    """Image-texture lookup (``textures.image_value_from``): clamp, v-flip,
    one gather of the packed texel, ``byte * (1/255)`` per channel."""
    size = cfg.img_size[iid.to(torch.int64)].to(torch.float32)
    nx, ny = size[:, 0], size[:, 1]
    i = torch.floor(torch.minimum(torch.clamp(u * nx, min=0.0),
                                  nx - IMG_EPS)).to(torch.int64)
    j = torch.floor(torch.minimum(
        torch.clamp((1.0 - v) * ny - IMG_EPS, min=0.0),
        ny - IMG_EPS)).to(torch.int64)
    _, H, W = cfg.atlas.shape
    w = cfg.atlas.reshape(-1)[(iid.to(torch.int64) * H + j) * W + i]
    w = w.to(torch.int64) & M32
    s = float(f32(1.0 / 255.0))
    return tuple(((w >> sh) & 0xFF).to(torch.float32) * s for sh in (0, 8, 16))


def hit_record_plain(cfg: StepConfig, o, d, tm, t, idx) -> dict:
    """The hit record of every lane's sweep result (``ops/intersect.py::
    _hit_record``; ``csrc/shade_core.cuh::hit_record``): ``rows`` the
    winner's (R, 40) prim rows, ``hit``, ``point``, the face-flipped
    ``normal``, ``front`` and the texture ``u``, ``v``."""
    fl = cfg.flags
    t_min = cfg.t_min
    zero = torch.zeros_like(t)
    rows = cfg.tab[idx.to(torch.int64)]               # (R, 40)
    pull = lambda c: rows[:, c]

    hit = torch.isfinite(t)
    ts = torch.where(hit, t, 1.0)
    px, py, pz = o[0] + ts * d[0], o[1] + ts * d[1], o[2] + ts * d[2]
    kind = pull(0).to(torch.int32)

    cx, cy, cz = pull(2), pull(3), pull(4)
    if fl["has_moving"]:
        dt = tm - pull(8)
        cx = cx + pull(5) * dt
        cy = cy + pull(6) * dt
        cz = cz + pull(7) * dt
    rr = torch.clamp(pull(9), min=1e-12)
    n_vec = ((px - cx) / rr, (py - cy) / rr, (pz - cz) / rr)
    uu = vv = zero
    if fl["has_image"]:
        # spherical uv of the outward sphere normal
        phi = torch.atan2(n_vec[2], n_vec[0])
        theta = torch.asin(torch.clamp(n_vec[1], min=-1.0, max=1.0))
        uu = 1.0 - (phi + PI) / TWO_PI
        vv = (theta + HALF_PI) / PI
    if fl["has_quads"]:
        is_quad = kind == PRIM_QUAD
        n_vec = _where3(is_quad, (pull(5), pull(6), pull(7)), n_vec)
        if fl["has_image"]:
            q = (px - pull(2), py - pull(3), pz - pull(4))
            uu = torch.where(is_quad, _dot(q, (pull(10), pull(11), pull(12))),
                             uu)
            vv = torch.where(is_quad, _dot(q, (pull(13), pull(14), pull(15))),
                             vv)
    if fl["has_solid_box"]:
        ix, iy, iz = 1.0 / d[0], 1.0 / d[1], 1.0 / d[2]
        tax, tbx = (pull(2) - o[0]) * ix, (pull(5) - o[0]) * ix
        tay, tby = (pull(3) - o[1]) * iy, (pull(6) - o[1]) * iy
        taz, tbz = (pull(4) - o[2]) * iz, (pull(7) - o[2]) * iz
        t3n = (torch.minimum(tax, tbx), torch.minimum(tay, tby),
               torch.minimum(taz, tbz))
        t3f = (torch.maximum(tax, tbx), torch.maximum(tay, tby),
               torch.maximum(taz, tbz))
        tn_b = torch.maximum(torch.maximum(t3n[0], t3n[1]), t3n[2])
        ax_n = torch.where(t3n[1] > t3n[0], 1, 0)
        ax_n = torch.where(t3n[2] > torch.maximum(t3n[0], t3n[1]), 2, ax_n)
        ax_f = torch.where(t3f[1] < t3f[0], 1, 0)
        ax_f = torch.where(t3f[2] < torch.minimum(t3f[0], t3f[1]), 2, ax_f)
        axis = torch.where(tn_b > t_min, ax_n, ax_f)
        is_box = kind == PRIM_BOX
        n_vec = _where3(is_box,
                        tuple((axis == a).to(torch.float32) for a in range(3)),
                        n_vec)
        if fl["has_image"]:
            # face uv: z-face -> (x, y), y-face -> (x, z), x-face -> (y, z)
            fx = (px - pull(2)) / torch.clamp(pull(5) - pull(2), min=1e-30)
            fy = (py - pull(3)) / torch.clamp(pull(6) - pull(3), min=1e-30)
            fz = (pz - pull(4)) / torch.clamp(pull(7) - pull(4), min=1e-30)
            uu = torch.where(is_box, torch.where(axis == 0, fy, fx), uu)
            vv = torch.where(is_box, torch.where(axis == 2, fy, fz), vv)
    front = _dot(d, n_vec) < 0.0
    n_vec = _where3(front, n_vec, (-n_vec[0], -n_vec[1], -n_vec[2]))
    if fl["has_media"]:
        is_med = kind >= PRIM_MEDIUM_SPHERE
        n_vec = _where3(is_med, (torch.ones_like(zero), zero, zero), n_vec)
        front = front | is_med
        if fl["has_image"]:
            uu = torch.where(is_med, 0.0, uu)
            vv = torch.where(is_med, 0.0, vv)
    return dict(rows=rows, hit=hit, point=(px, py, pz), normal=n_vec,
                front=front, u=uu, v=vv)


def _child_texture(cfg: StepConfig, tex, p, uu, vv):
    """``textures._base_value`` of each lane's texture id ``tex``: a
    checker's child, evaluated as a texture that is not a checker
    (``csrc/shade_core.cuh::child_texture``)."""
    tr = cfg.texrow[tex.to(torch.int64)]               # (R, 8)
    kind = tr[:, 0].to(torch.int32)
    val = (tr[:, 1], tr[:, 2], tr[:, 3])
    px, py, pz = p
    if cfg.flags["has_perlin"]:
        pid = tr[:, 6].to(torch.int32)
        if cfg.strict:
            octave = lambda qx, qy, qz: _perlin_noise_table(cfg, pid, qx, qy,
                                                            qz)
        else:
            psalt = as_u32(tr[:, 7].contiguous().view(torch.int32))
            octave = lambda qx, qy, qz: _perlin_noise(psalt, qx, qy, qz)
        m = _marble(octave, tr[:, 4], px, py, pz)
        val = _where3(kind == TEX_PERLIN, (m, m, m), val)
    if cfg.flags["has_image"]:
        val = _where3(kind == TEX_IMAGE,
                      image_value(cfg, tr[:, 5].to(torch.int32), uu, vv), val)
    return val


def albedo_plain(cfg: StepConfig, rows, idx, p, uu, vv):
    """The texture value at each lane's hit (``textures.
    texture_value_packed`` from the prim rows' material columns, or where
    the scene has a checker with textured children, that checker's
    children by their texture rows as ``textures.texture_value`` does;
    ``csrc/shade_core.cuh::albedo``)."""
    fl = cfg.flags
    pull = lambda c: rows[:, c]
    px, py, pz = p
    att = (pull(20), pull(21), pull(22))
    tex_kind = pull(19).to(torch.int32)
    if fl["has_checker"]:
        sines = (torch.sin(10.0 * px) * torch.sin(10.0 * py)
                 * torch.sin(10.0 * pz))
        if fl["checker_fancy"]:
            kid = cfg.kids[pull(1).to(torch.int64)]
            checker = _child_texture(cfg, torch.where(sines < 0.0, kid[:, 0],
                                                      kid[:, 1]), p, uu, vv)
        else:
            checker = _where3(sines < 0.0, (pull(23), pull(24), pull(25)),
                              (pull(26), pull(27), pull(28)))
        att = _where3(tex_kind == TEX_CHECKER, checker, att)
    if fl["has_perlin"]:
        if cfg.strict:
            pid = cfg.perlin_id[idx.to(torch.int64)]
            octave = lambda qx, qy, qz: _perlin_noise_table(cfg, pid, qx, qy,
                                                            qz)
        else:
            psalt = as_u32(cfg.salt[idx.to(torch.int64)])
            octave = lambda qx, qy, qz: _perlin_noise(psalt, qx, qy, qz)
        m = _marble(octave, pull(29), px, py, pz)
        att = _where3(tex_kind == TEX_PERLIN, (m, m, m), att)
    if fl["has_image"]:
        att = _where3(tex_kind == TEX_IMAGE,
                      image_value(cfg, pull(39).to(torch.int32), uu, vv), att)
    return att


def _shade(cfg: StepConfig, o, d, tm, t, idx, slot, kd, b0=None):
    """Record rebuild + textures + scatter for every lane
    (``shade_pallas._shade_core``, with the image fetch done in place as
    ``ops/intersect.py::_hit_record`` + ``textures.image_value_from`` do it,
    not deferred).  ``b0``: (the four Sobol' draws of dims 7-10, the lanes
    at their first bounce) of the queue's sobol-b0, which replace scatter
    columns ``B0_COLS`` on those lanes."""
    fl = cfg.flags
    t_min = cfg.t_min
    zero = torch.zeros_like(t)
    h = hit_record_plain(cfg, o, d, tm, t, idx)
    rows, hit, front, n_vec = h["rows"], h["hit"], h["front"], h["normal"]
    pull = lambda c: rows[:, c]
    px, py, pz = h["point"]

    mkind = pull(16).to(torch.int32)
    base = fmix((as_u32(slot) + kd[0]) & M32) ^ kd[1]

    def u(i):
        if b0 is not None and i in B0_COLS:
            q, first = b0
            return torch.where(first, q[B0_COLS.index(i)], hash_col(base, i))
        return hash_col(base, i)

    att = albedo_plain(cfg, rows, idx, h["point"], h["u"], h["v"])

    unit_d = _normalize(d)
    if fl["has_emissive"]:
        emitted = _where3((mkind == MAT_DIFFUSE_LIGHT) & ~front, att,
                          (zero, zero, zero))
    else:
        emitted = (zero, zero, zero)

    branches = []
    if fl["has_lambertian"]:
        cos_dir = _onb_local(_onb_from_w(n_vec),
                             _cosine_direction_from(u(6), u(7)))
        L = cfg.n_lights
        if L > 0:
            lt = cfg.lights
            pick = torch.clamp((u(1) * L).to(torch.int32), max=L - 1)
            lrow = [torch.full_like(zero, float(lt[0, c])) for c in range(14)]
            for li in range(1, L):
                m_ = pick == li
                for c in range(14):
                    lrow[c] = torch.where(m_, float(lt[li, c]), lrow[c])
            pq = tuple(lrow[i] + u(2) * lrow[3 + i] + u(3) * lrow[6 + i]
                       for i in range(3))
            dir_quad = (pq[0] - px, pq[1] - py, pq[2] - pz)
            dc = (lrow[9] - px, lrow[10] - py, lrow[11] - pz)
            d2 = _dot(dc, dc)
            loc = _to_sphere_from(u(4), u(5), lrow[12],
                                  torch.clamp(d2, min=1e-12))
            dir_sph = _onb_local(_onb_from_w(dc), loc)
            light_dir = _where3(lrow[13] > 0.5, dir_quad, dir_sph)
            dir_lam = _normalize(_where3(u(0) < 0.5, light_dir, cos_dir))
            cos_pdf = torch.clamp(_dot(dir_lam, n_vec), min=0.0) * INV_PI
            pdf_sum = zero
            for li in range(L):
                lr = lambda c: float(lt[li, c])
                nl = (lr(14), lr(15), lr(16))
                dn_ = _dot(dir_lam, nl)
                t_ = (lr(17) - (px * nl[0] + py * nl[1] + pz * nl[2])) / dn_
                xq = (px + t_ * dir_lam[0] - lr(0), py + t_ * dir_lam[1] - lr(1),
                      pz + t_ * dir_lam[2] - lr(2))
                uq_ = xq[0] * lr(18) + xq[1] * lr(19) + xq[2] * lr(20)
                vq_ = xq[0] * lr(21) + xq[1] * lr(22) + xq[2] * lr(23)
                hit_q = ((t_ > t_min) & (uq_ >= 0.0) & (uq_ <= 1.0)
                         & (vq_ >= 0.0) & (vq_ <= 1.0))
                pdf_q = torch.where(
                    hit_q, t_ * t_ / torch.clamp(torch.abs(dn_) * lr(24),
                                                 min=1e-12), 0.0)
                oc = (px - lr(9), py - lr(10), pz - lr(11))
                bq = oc[0] * dir_lam[0] + oc[1] * dir_lam[1] \
                    + oc[2] * dir_lam[2]
                oc2 = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]
                r2 = float(f32(lr(12)) * f32(lr(12)))
                disc_ = bq * bq - (oc2 - r2)
                sd_ = sqrt_rn(torch.clamp(disc_, min=0.0))
                hit_s = (disc_ > 0.0) & ((-bq - sd_ > t_min)
                                         | (-bq + sd_ > t_min))
                ctm = sqrt_rn(torch.clamp(
                    1.0 - r2 / torch.clamp(oc2, min=1e-12), min=0.0))
                solid = TWO_PI * (1.0 - ctm)
                pdf_s = torch.where(hit_s,
                                    1.0 / torch.clamp(solid, min=1e-12), 0.0)
                pdf_sum = pdf_sum + (pdf_q if lr(13) > 0.5 else pdf_s)
            pdf_val = 0.5 * (pdf_sum / L + cos_pdf)
            w_mis = torch.where(pdf_val > 0.0,
                                cos_pdf / torch.clamp(pdf_val, min=1e-12),
                                0.0)
            w_lam = (att[0] * w_mis, att[1] * w_mis, att[2] * w_mis)
        elif cfg.strict:
            # the reference's mixture with an unhittable light: (1,0,0) on
            # half the draws at light density 0, weight 2 att above the
            # surface, its 0/0 sample below floored to black
            one_x = (torch.ones_like(zero), zero, zero)
            dir_lam = _normalize(_where3(u(0) < 0.5, one_x, cos_dir))
            f = torch.where(_dot(dir_lam, n_vec) > 0.0, 2.0, 0.0)
            w_lam = (att[0] * f, att[1] * f, att[2] * f)
        else:
            dir_lam = _normalize(cos_dir)
            w_lam = att
        branches.append((MAT_LAMBERTIAN, dir_lam, w_lam))
    if fl["has_metal"]:
        fuzz = pull(17)
        refl = _reflect(unit_d, n_vec)
        fv = _unit_vector_from(u(8), u(9))
        branches.append((MAT_METAL, tuple(refl[i] + fuzz * fv[i]
                                          for i in range(3)), att))
    if fl["has_dielectric"]:
        ri = pull(18)
        ratio = torch.where(front, 1.0 / ri, ri)
        cos_theta = torch.clamp(
            _dot((-unit_d[0], -unit_d[1], -unit_d[2]), n_vec), max=1.0)
        sin_theta = sqrt_rn(torch.clamp(1.0 - cos_theta * cos_theta,
                                           min=0.0))
        q = (1.0 - ratio) / (1.0 + ratio)
        r0 = q * q
        refl_prob = r0 + (1.0 - r0) * _ipow5(1.0 - cos_theta)
        do_reflect = (ratio * sin_theta > 1.0) | (u(10) < refl_prob)
        dir_diel = _where3(do_reflect, _reflect(unit_d, n_vec),
                           _refract(unit_d, n_vec, ratio))
        branches.append((MAT_DIELECTRIC, dir_diel,
                         (torch.ones_like(zero),) * 3))
    if fl["has_isotropic"]:
        dir_iso, w_iso = _unit_vector_from(u(11), u(12)), att
        if cfg.strict:
            # the reference's non-unit ball direction, weighed by cos/pi
            # against the medium's fixed (1,0,0) normal
            rad = cbrt_rn(torch.clamp(u(13), min=1e-6))
            dir_iso = tuple(c * rad for c in dir_iso)
            c = torch.clamp(_dot(n_vec, dir_iso), min=0.0) * INV_PI
            w_iso = (att[0] * c, att[1] * c, att[2] * c)
        branches.append((MAT_ISOTROPIC, dir_iso, w_iso))
    if not branches:
        branches.append((MAT_DIFFUSE_LIGHT, unit_d, (zero, zero, zero)))
    _, direction, weight = branches[0]
    for mk_, d_, w_ in branches[1:]:
        is_mk = mkind == mk_
        direction = _where3(is_mk, d_, direction)
        weight = _where3(is_mk, w_, weight)
    scattered = (mkind != MAT_DIFFUSE_LIGHT if fl["has_emissive"]
                 else torch.ones_like(hit))
    return dict(hit=hit, point=(px, py, pz), normal=n_vec, front=front,
                u=h["u"], v=h["v"], mat=pull(1).to(torch.int32),
                direction=direction,
                weight=weight, emitted=emitted, scattered=scattered,
                base=base)


def pool_step_plain(cfg: StepConfig, xy, slot, fstate, istate, best_t,
                    best_i, kd, init: bool = False, lane_b0=None):
    """One pool iteration in plain PyTorch; returns new (fstate, istate).
    ``lane_b0``: with ``cfg.b0``, each lane's (pixel, global sample) as a
    (2, R) int32 tensor of uint32 bits."""
    _check(cfg, xy, slot, fstate, istate, best_t, best_i, lane_b0)
    pool_step_plain.calls += 1
    kd = (int(kd[0]) & M32, int(kd[1]) & M32)
    xs, ys = xy[0], xy[1]
    o = (fstate[0], fstate[1], fstate[2])
    d = (fstate[3], fstate[4], fstate[5])
    tm = fstate[6]
    tp = (fstate[7], fstate[8], fstate[9])
    ac = (fstate[10], fstate[11], fstate[12])
    bounce, sample, active = istate[0], istate[1], istate[2]
    if init:
        act = torch.zeros_like(active, dtype=torch.bool)
        dead_now = torch.ones_like(act)
    else:
        b0 = None
        if cfg.b0:
            q = qmc.bounce0_uniforms(as_u32(lane_b0[0]), as_u32(lane_b0[1]),
                                     cfg.cam_salt)[1:5]
            b0 = (q, bounce == 0)
        s = _shade(cfg, o, d, tm, best_t, best_i, slot, kd, b0)
        act = active > 0
        hit, scattered = s["hit"], s["scattered"]
        miss = act & ~hit
        emit = act & hit & ~scattered
        cont = act & hit & scattered
        bg, em = cfg.background, s["emitted"]
        ac = tuple(ac[i] + torch.where(miss, tp[i] * float(bg[i]), 0.0)
                   + torch.where(emit, tp[i] * em[i], 0.0) for i in range(3))
        w = s["weight"]
        kill = torch.zeros_like(cont)
        if cfg.rr_depth:
            tp_in = torch.maximum(torch.maximum(tp[0], tp[1]), tp[2])
            p_rr = torch.clamp(torch.clamp(tp_in, min=RR_PMIN), max=1.0)
            do_rr = cont & (bounce >= cfg.rr_depth)
            kill = do_rr & (hash_col(s["base"], RR_COL) >= p_rr)
        tp = _where3(cont, (tp[0] * w[0], tp[1] * w[1], tp[2] * w[2]), tp)
        bounce = torch.where(cont, bounce + 1, bounce)
        if cfg.rr_depth:
            tp = _where3(do_rr & ~kill, (tp[0] / p_rr, tp[1] / p_rr,
                                         tp[2] / p_rr), tp)
        tp_max = torch.maximum(torch.maximum(tp[0], tp[1]), tp[2])
        dead_now = act & (miss | emit | kill
                          | (cont & (bounce >= cfg.max_depth))
                          | (cont & (tp_max <= 0.0)))
        o = _where3(cont, s["point"], o)
        d = _where3(cont, s["direction"], d)

    # camera regeneration (rng.hash_uniforms2, or the Sobol' point of the
    # plain global sample, + camera.rays_from_uniforms)
    cam = [float(c) for c in cfg.cam]
    want = dead_now & (sample < cfg.n_samples)
    u0, u1, u2, u3, u4 = camera_uniforms(
        cfg.sobol, slot, (cfg.sample0 + as_u32(sample)) & M32, cfg.cam_salt)
    sx = xs + u0 * cfg.inv_w
    sy = ys + u1 * cfg.inv_h
    r = cam[18] * sqrt_rn(u2)
    phi = TWO_PI * u3
    rc, rs = r * torch.cos(phi), r * torch.sin(phi)
    off = tuple(rc * cam[12 + i] + rs * cam[15 + i] for i in range(3))
    t_new = cam[19] + float(f32(cam[20]) - f32(cam[19])) * u4
    ro = tuple(cam[i] + off[i] for i in range(3))
    rd = tuple(cam[3 + i] + sx * cam[6 + i] + sy * cam[9 + i] - cam[i]
               - off[i] for i in range(3))
    o = _where3(want, ro, o)
    d = _where3(want, rd, d)
    tm = torch.where(want, t_new, tm)
    one = torch.ones_like(tm)
    tp = _where3(want, (one, one, one), tp)
    bounce = torch.where(want, 0, bounce)
    sample = torch.where(want, sample + 1, sample)
    active = ((act & ~dead_now) | want).to(torch.int32)
    f_out = torch.stack([*o, *d, tm, *tp, *ac])
    i_out = torch.stack([bounce.to(torch.int32), sample.to(torch.int32),
                         active])
    return f_out, i_out


pool_step_plain.calls = 0


def camera_uniforms(sobol: bool, slot, gs, salt: int) -> tuple:
    """The five camera uniforms (pixel jitter x, y, lens radius, lens angle,
    shutter time) of each slot's global sample ``gs`` (int64 in [0, 2^32))
    under the camera salt: the murmur3 pair hash of (slot, gs ^ salt), or
    with a Sobol' sampler the scrambled Sobol' point of (slot, plain gs)."""
    if sobol:
        return (qmc.pixel_uniforms(slot, gs, salt)
                + qmc.lens_time_uniforms(slot, gs, salt))
    base = rng.hash2_base(slot, gs ^ salt)
    return tuple(hash_col(base, i) for i in range(5))


def _check(cfg, xy, slot, fstate, istate, best_t, best_i, lane_b0=None):
    R = fstate.shape[1]
    want = ((xy, (2, R), torch.float32), (slot, (R,), torch.int32),
            (fstate, (N_FSTATE, R), torch.float32),
            (istate, (N_ISTATE, R), torch.int32),
            (best_t, (R,), torch.float32), (best_i, (R,), torch.int32))
    if cfg.b0:
        if lane_b0 is None:
            raise ValueError("pool step: the sobol-b0 queue step needs each "
                             "lane's (pixel, global sample)")
        want += ((lane_b0, (2, R), torch.int32),)
    for x, shape, dtype in want:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"pool step: expected {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous() or x.device != fstate.device:
            raise ValueError("pool step: inputs must be contiguous and on "
                             "one device")
    if cfg.tab.device != fstate.device:
        raise ValueError("pool step: scene tables are on another device")


def _params(cfg: StepConfig, kd, init: bool) -> np.ndarray:
    """The kernel's by-value parameter block as 32-bit words (layout of
    ``StepParams`` in csrc/shade_core.cuh)."""
    w = np.zeros(24 + 15, np.uint32)
    fv = w.view(np.float32)
    fv[0:21] = cfg.cam
    fv[21:24] = cfg.background
    k = 24
    fv[k:k + 3] = (cfg.inv_w, cfg.inv_h, cfg.t_min)
    w[k + 3:k + 7] = (int(kd[0]) & M32, int(kd[1]) & M32, cfg.sample0,
                      cfg.cam_salt)
    flags = sum(1 << i for i, n in enumerate(FLAG_BITS) if cfg.flags[n])
    flags |= (SAMPLER_SOBOL_BIT if cfg.sobol else 0) | \
        (STRICT_BIT if cfg.strict else 0) | (SAMPLER_B0_BIT if cfg.b0 else 0)
    w[k + 7:k + 13] = np.array([cfg.n_samples, cfg.max_depth, cfg.rr_depth,
                                cfg.n_lights, flags, int(init)],
                               np.int64) & M32
    w[k + 13:k + 15] = cfg.atlas.shape[1:]
    return w


def table_ptrs(cfg: StepConfig):
    """Device pointers of the scene tables, in the kernels' argument order."""
    return (cfg.tab.data_ptr(), cfg.salt.data_ptr(), cfg.lights_t.data_ptr(),
            cfg.atlas.data_ptr(), cfg.img_size.data_ptr(),
            cfg.perlin_id.data_ptr(), cfg.perm.data_ptr(),
            cfg.ranvec.data_ptr())


def texture_ptrs(cfg: StepConfig):
    """Device pointers of the texture rows and the checker children (read
    by the kernels only for a checker with textured children)."""
    return cfg.texrow.data_ptr(), cfg.kids.data_ptr()


def pool_step(cfg: StepConfig, xy, slot, fstate, istate, best_t, best_i,
              kd, init: bool = False, lane_b0=None, out=None, words=None):
    """One fused pool iteration: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns new (fstate, istate).
    ``lane_b0`` as :func:`pool_step_plain`'s.  ``out``: (fstate, istate)
    buffers, other than the inputs, that take the kernel's result instead
    of fresh tensors (the plain version returns fresh ones); ``words``: a
    work-queue render's block (``ops/queue.py::render_words``) on the
    card, whose scatter key words the kernel reads instead of ``kd`` and
    whose camera salt it reads in the sobol-b0 first-bounce draws instead
    of ``cfg.cam_salt`` (the queue's step regenerates no camera ray; the
    plain version takes ``kd`` and ``cfg``)."""
    if not fstate.is_cuda:
        return pool_step_plain(cfg, xy, slot, fstate, istate, best_t, best_i,
                               kd, init, lane_b0)
    _check(cfg, xy, slot, fstate, istate, best_t, best_i, lane_b0)
    fn = load_fn("pool_step", "tr_pool_step",
                 [ctypes.c_void_p] * 21 + [ctypes.c_longlong, ctypes.c_void_p])
    R = fstate.shape[1]
    if out is None:
        f_out = torch.empty_like(fstate)
        i_out = torch.empty_like(istate)
    else:
        f_out, i_out = out
        if f_out.shape != fstate.shape or i_out.shape != istate.shape \
                or f_out.dtype != fstate.dtype or i_out.dtype != istate.dtype \
                or not (f_out.is_contiguous() and i_out.is_contiguous()) \
                or f_out.device != fstate.device \
                or i_out.device != fstate.device:
            raise ValueError("pool step: the output buffers must be "
                             "contiguous and like the state")
        if f_out.data_ptr() == fstate.data_ptr() \
                or i_out.data_ptr() == istate.data_ptr():
            raise ValueError("pool step: an output buffer is its input")
    if words is not None and (words.shape != (4,) or words.dtype !=
                              torch.int64 or words.device != fstate.device):
        raise ValueError("pool step: the render words must be a (4,) int64 "
                         "tensor on the state's device")
    params = _params(cfg, kd, init)
    err = fn(xy.data_ptr(), slot.data_ptr(), fstate.data_ptr(),
             istate.data_ptr(), best_t.data_ptr(), best_i.data_ptr(),
             *table_ptrs(cfg), *texture_ptrs(cfg),
             lane_b0.data_ptr() if cfg.b0 else None,
             params.ctypes.data,
             None if words is None else words.data_ptr(), f_out.data_ptr(),
             i_out.data_ptr(), R,
             torch.cuda.current_stream(fstate.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pool-step kernel launch failed (cudaError {err})")
    pool_step.launches += 1
    return f_out, i_out


pool_step.launches = 0
