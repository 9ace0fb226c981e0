"""The estimator, pixel by pixel: the plain reference the benchmark holds
the port's images to.

It renders any chosen set of pixels of a frame, because every draw of the
estimator is keyed by the pixel's own ids and never by where its work ran:

* **pool** (scenes of at most 512 prims): each pixel owns ``k`` slots
  (global slot id ``k * W * H + pixel``), and each slot renders its
  ``s`` samples in turn.  Iteration ``it`` of wave ``w`` draws its
  closest-hit key and its scatter key from ``fold_in(fold_in(fold_in(
  PRNGKey(seed), w), it), 0 / 1)``, each lane's numbers from (key, slot);
  a slot whose path ends takes its next camera sample in the same step.
  The plan (k, s, waves) is the renderer's.
* **queue** (above 512 prims): work item ``s * W * H + pixel`` is one path;
  bounce ``b`` draws from the render's two constant keys (``fold_in(
  fold_in(PRNGKey(seed), 0x5EED), 0 / 1)``) under the path id of (item,
  b).  The camera draws come from (pixel, sample ^ seed).

A bounce: the closest solid (each kind's first nearest prim, kinds in
table order, strict '<'), the free flight through each constant medium,
the hit record, the texture (constant, or a 7-octave hash-Perlin marble),
emission from the back of a light, the scatter of the five materials,
path death at a miss, a light, zero throughput or the depth limit.

The scatter draws from the lane's scatter stream (``rng.col(base, i)``),
each column with one purpose: 0 the mixture's coin, 1 the light's pick,
2-3 a point on a rect light, 4-5 a direction in the cone toward a sphere
light, 6-7 the cosine lobe, 8-9 a metal's fuzz, 10 a dielectric's
reflection, 11-12 an isotropic medium's direction.  (The media's free
flights draw from the closest-hit key's stream, one column a medium.)

A Lambertian scatters by its cosine lobe alone in a scene with no light
list.  With a light list (``flags["n_lights"]`` = L > 0) it scatters by
book 3's ``MixturePdf (HittablePdf lights) (CosinePdf onb)``
(``src/Lib.hs:362-382, 673-724, 829-836``), each step one float32
operation in this order (:func:`mixture_scatter`):

1. light j = min(floor(u1 * L), L - 1); toward it: for a rect,
   (corner + u2 * e1) + u3 * e2 - p; for a sphere of centre c and radius
   r, in the basis about c - p, the cone direction of ``htblRandom``:
   d2 = |c - p|^2, cos_max = sqrt(max(1 - (r * r) / d2, 0)),
   z = 1 + u5 * (cos_max - 1), phi = 2 pi u4, s = sqrt(max(1 - z * z, 0)),
   (cos(phi) s, sin(phi) s, z);
2. the direction: the unit vector of (u0 < 0.5 ? toward the light : the
   cosine lobe's, unnormalised);
3. each light's density of that unit direction d from p
   (``htblPdfValue``): a rect's, where t = (offset - p.n) / (d.n) is above
   ``t_min`` and x = (p + t d) - corner has u = x.pu and v = x.pv in
   [0, 1], t * t / (|d.n| * area); a sphere's, where b = (p - c).d and
   disc = b * b - (|p - c|^2 - r * r) > 0 and -b - sqrt(disc) or
   -b + sqrt(disc) is above ``t_min``, 1 / (2 pi (1 - cos_max)) with
   cos_max = sqrt(max(1 - (r * r) / |p - c|^2, 0)); else 0.  Their sum in
   list order, / L;
4. cos/pi = max(d.n, 0) * (1/pi); the mixture 0.5 * (lights' + cos/pi);
5. the weight: albedo * ((cos/pi) / mixture), 0 where the mixture is 0.

All float work is in ``dt``: float32 is the estimator, bfloat16 the control
that ``correct`` must refuse.  Square roots are correctly rounded, as the
estimator states (the float64 root rounded once, on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .scenes import (BOX, DIELECTRIC, ISOTROPIC, L_AREA, L_CORNER, L_E1, L_E2,
                     L_NORMAL, L_OFFSET, L_RADIUS, L_U, L_V, LAMBERTIAN, LIGHT,
                     MEDIUM_SPHERE, METAL, QUAD, TEX_PERLIN, Scene)

f32 = np.float32
INF = float("inf")
TWO_PI = float(f32(2.0 * np.pi))
INV_PI = float(f32(1.0 / np.pi))
MED_EPS = 1e-4
RAY_CHUNK = 1 << 15
CHECK = 8          # iterations between the looks at the active count


def sqrt_rn(x):
    if x.dtype == torch.float32 and not x.is_cuda:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def where3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def normalize(a):
    n2 = dot(a, a)
    inv = torch.where(n2 > 0.0, 1.0 / sqrt_rn(torch.clamp(n2, min=1e-30)),
                      0.0)
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def reflect(v, n):
    d = dot(v, n)
    return tuple(v[i] - 2.0 * d * n[i] for i in range(3))


def refract(uv, n, ratio):
    cos_theta = dot((-uv[0], -uv[1], -uv[2]), n)
    rp = tuple(ratio * (uv[i] + cos_theta * n[i]) for i in range(3))
    s = -sqrt_rn(torch.clamp(1.0 - dot(rp, rp), min=0.0))
    return tuple(rp[i] + s * n[i] for i in range(3))


def onb_from_w(n):
    w = normalize(n)
    pick = torch.abs(w[0]) > 0.9
    zero = torch.zeros_like(w[0])
    a = ((~pick).to(w[0].dtype), pick.to(w[0].dtype), zero)
    v = normalize(cross(w, a))
    return cross(w, v), v, w


def onb_local(uvw, x):
    u, v, w = uvw
    return tuple(x[0] * u[i] + x[1] * v[i] + x[2] * w[i] for i in range(3))


def unit_vector(u0, u1):
    a = TWO_PI * u0
    z = 2.0 * u1 - 1.0
    r = sqrt_rn(torch.clamp(1.0 - z * z, min=0.0))
    return (r * torch.cos(a), r * torch.sin(a), z)


def cosine_direction(u0, u1):
    z = sqrt_rn(torch.clamp(1.0 - u1, min=0.0))
    phi = TWO_PI * u0
    sq = sqrt_rn(u1)
    return (torch.cos(phi) * sq, torch.sin(phi) * sq, z)


def to_sphere(u0, u1, r, d2):
    """A direction in the cone that a sphere of radius ``r`` at squared
    distance ``d2`` fills, in its local basis (``randomToSphere``)."""
    cos_max = sqrt_rn(torch.clamp(1.0 - r * r / d2, min=0.0))
    z = 1.0 + u1 * (cos_max - 1.0)
    phi = TWO_PI * u0
    s = sqrt_rn(torch.clamp(1.0 - z * z, min=0.0))
    return (torch.cos(phi) * s, torch.sin(phi) * s, z)


_PX, _PY, _PZ = 0x8DA6B343, 0xD8163841, 0xCB1AB31F


def perlin(salt, qx, qy, qz):
    """One octave of hash-gradient Perlin noise at (qx, qy, qz)."""
    ix, iy, iz = torch.floor(qx), torch.floor(qy), torch.floor(qz)
    ux, uy, uz = qx - ix, qy - iy, qz - iz
    hx_ = ux * ux * (3.0 - 2.0 * ux)
    hy_ = uy * uy * (3.0 - 2.0 * uy)
    hz_ = uz * uz * (3.0 - 2.0 * uz)
    cx0 = rng.mul32(ix.to(torch.int64) & rng.M32, _PX)
    cy0 = rng.mul32(iy.to(torch.int64) & rng.M32, _PY)
    cz0 = rng.mul32(iz.to(torch.int64) & rng.M32, _PZ)
    hx = (cx0, (cx0 + _PX) & rng.M32)
    hy = (cy0, (cy0 + _PY) & rng.M32)
    hz = (cz0, (cz0 + _PZ) & rng.M32)
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
                h1 = rng.fmix(hx[di] ^ hy[dj] ^ hz[dk] ^ salt)
                h2 = rng.fmix(h1 ^ 0x68E31DA4)
                h3 = rng.fmix(h2 ^ 0xB5297A4D)
                gx = (h1 >> 8).to(qx.dtype) * to_signed - 1.0
                gy = (h2 >> 8).to(qx.dtype) * to_signed - 1.0
                gz = (h3 >> 8).to(qx.dtype) * to_signed - 1.0
                acc = acc + (w0 * w1 * w2) * (gx * ox + gy * oy + gz * oz)
    return acc


def marble(salt, scale, px, py, pz):
    """7 octaves of turbulence, 0.5 * (1 + sin(z + 10 |turbulence|))."""
    acc = torch.zeros_like(px)
    qx, qy, qz = px, py, pz
    weight = 1.0
    for _ in range(7):
        acc = acc + weight * perlin(salt, scale * qx, scale * qy, scale * qz)
        qx, qy, qz = 2.0 * qx, 2.0 * qy, 2.0 * qz
        weight = weight * 0.5
    return 0.5 * (1.0 + torch.sin(pz + 10.0 * torch.abs(acc)))


# --- the closest hit ---------------------------------------------------------

def _pair_t(r, g, kind, t_min):
    """(rays, prims) hit distances of one kind; ``r`` the seven ray rows
    as (n, 1) columns, ``g`` the table's columns as (1, m) rows."""
    ox, oy, oz, dx, dy, dz, rt = r
    if kind in ("sphere", "moving"):
        a = dx * dx + dy * dy + dz * dz
        cx, cy, cz = g[0], g[1], g[2]
        if kind == "moving":
            dt = rt - g[6]
            cx = cx + g[3] * dt
            cy = cy + g[4] * dt
            cz = cz + g[5] * dt
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - g[7]
        disc = b * b - a * c
        ok = disc > 0.0
        sd = sqrt_rn(torch.clamp(disc, min=0.0))
        inv_a = 1.0 / a
        t1 = (-b - sd) * inv_a
        t2 = (-b + sd) * inv_a
        return torch.where(ok & (t1 > t_min) & (t1 < INF), t1,
                           torch.where(ok & (t2 > t_min) & (t2 < INF), t2,
                                       INF))
    if kind == "box":
        ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
        tax, tbx = (g[0] - ox) * ix, (g[3] - ox) * ix
        tay, tby = (g[1] - oy) * iy, (g[4] - oy) * iy
        taz, tbz = (g[2] - oz) * iz, (g[5] - oz) * iz
        tn = torch.maximum(torch.maximum(torch.minimum(tax, tbx),
                                         torch.minimum(tay, tby)),
                           torch.minimum(taz, tbz))
        tf = torch.minimum(torch.minimum(torch.maximum(tax, tbx),
                                         torch.maximum(tay, tby)),
                           torch.maximum(taz, tbz))
        ok = tf > tn
        return torch.where(ok & (tn > t_min) & (tn < INF), tn,
                           torch.where(ok & (tf > t_min) & (tf < INF), tf,
                                       INF))
    dn = dx * g[3] + dy * g[4] + dz * g[5]
    tq = (g[6] - (ox * g[3] + oy * g[4] + oz * g[5])) / dn
    xx = ox + tq * dx - g[0]
    xy = oy + tq * dy - g[1]
    xz = oz + tq * dz - g[2]
    uq = xx * g[7] + xy * g[8] + xz * g[9]
    vq = xx * g[10] + xy * g[11] + xz * g[12]
    ok = ((tq > t_min) & (tq < INF) & (uq >= 0.0) & (uq <= 1.0)
          & (vq >= 0.0) & (vq <= 1.0))
    return torch.where(ok, tq, INF)


def closest_solid(sc: Scene, rays):
    """(best_t, best_i) over the solids; +inf and 0 where none is hit."""
    R = rays[0].shape[0]
    n_s, n_b = sc.sph.shape[0], sc.box.shape[0]
    spans = ((sc.sph[:sc.n_ss], 0, "sphere"), (sc.sph[sc.n_ss:], sc.n_ss,
                                               "moving"),
             (sc.box, n_s, "box"), (sc.quad, n_s + n_b, "quad"))
    best_t = torch.full((R,), INF, dtype=rays[0].dtype, device=rays[0].device)
    best_i = torch.zeros((R,), dtype=torch.int64, device=rays[0].device)
    for r0 in range(0, R, RAY_CHUNK):
        blk = [x[r0:r0 + RAY_CHUNK, None] for x in rays]
        bt, bi = best_t[r0:r0 + RAY_CHUNK], best_i[r0:r0 + RAY_CHUNK]
        for tab, lo, kind in spans:
            if tab.shape[0] == 0:
                continue
            t = _pair_t(blk, tab.T[:, None, :], kind, sc.t_min)
            ct, ci = torch.min(t, dim=1)
            closer = ct < bt
            bt.copy_(torch.where(closer, ct, bt))
            bi.copy_(torch.where(closer, ci + lo, bi))
    return best_t, best_i


def merge_media(sc: Scene, rays, kd, ids, best_t, best_i):
    """Each medium's free-flight distance (one uniform per (ray, medium)
    from the lane stream of (key, id)), taken where strictly nearer."""
    ox, oy, oz, dx, dy, dz = rays[:6]
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    dlen = sqrt_rn(a)
    base = rng.lane_base(kd, ids)
    for j, m in enumerate(sc.media):
        c = m["center"]
        ocx, ocy, ocz = ox - c[0], oy - c[1], oz - c[2]
        b = ocx * dx + ocy * dy + ocz * dz
        cq = ocx * ocx + ocy * ocy + ocz * ocz - m["r2"]
        disc = b * b - a * cq
        sd = sqrt_rn(torch.clamp(disc, min=0.0))
        te = (-b - sd) * inv_a
        tx = (-b + sd) * inv_a
        exists = (disc > 0.0) & (tx > te + MED_EPS)
        rec1 = torch.clamp(te, min=sc.t_min)
        dist_inside = (tx - rec1) * dlen
        u = rng.col(base, m["slot"], a.dtype)
        hit_dist = m["nid"] * torch.log(torch.clamp(u, min=1e-12))
        ok = exists & (rec1 < tx) & (hit_dist <= dist_inside)
        t = torch.where(ok, rec1 + hit_dist / dlen, INF)
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, sc.n_solid + j, best_i)
    return best_t, best_i


def intersect(sc: Scene, rays, kd, ids):
    bt, bi = closest_solid(sc, rays)
    if sc.media:
        bt, bi = merge_media(sc, rays, kd, ids, bt, bi)
    return bt, bi


# --- the light list ----------------------------------------------------------------

def _cols(row, c):
    return (row[..., c], row[..., c + 1], row[..., c + 2])


def toward_light(sc: Scene, j, p, u2, u3, u4, u5):
    """The unnormalised direction from ``p`` toward a point of light ``j``
    (per lane) drawn from (u2, u3) on a rect or (u4, u5) in a sphere's
    cone."""
    row = sc.lights[j]
    c, e1, e2 = (_cols(row, k) for k in (L_CORNER, L_E1, L_E2))
    rect = tuple(c[i] + u2 * e1[i] + u3 * e2[i] - p[i] for i in range(3))
    dc = (c[0] - p[0], c[1] - p[1], c[2] - p[2])
    cone = onb_local(onb_from_w(dc),
                     to_sphere(u4, u5, row[:, L_RADIUS], dot(dc, dc)))
    is_rect = torch.tensor([k == QUAD for k in sc.light_kind],
                           device=row.device)[j]
    return where3(is_rect, rect, cone)


def light_density(sc: Scene, j: int, p, d):
    """Light ``j``'s solid-angle density of the unit directions ``d`` from
    ``p`` (``htblPdfValue``): 0 where the ray misses it."""
    row = sc.lights[j]
    if sc.light_kind[j] == QUAD:
        nrm = _cols(row, L_NORMAL)
        dn = dot(d, nrm)
        t = (row[L_OFFSET] - dot(p, nrm)) / dn
        c = _cols(row, L_CORNER)
        x = tuple(p[i] + t * d[i] - c[i] for i in range(3))
        u, v = dot(x, _cols(row, L_U)), dot(x, _cols(row, L_V))
        hit = ((t > sc.t_min) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
               & (v <= 1.0))
        return torch.where(hit, t * t / (torch.abs(dn) * row[L_AREA]), 0.0)
    c = _cols(row, L_CORNER)
    oc = (p[0] - c[0], p[1] - c[1], p[2] - c[2])
    b = dot(oc, d)
    oc2 = dot(oc, oc)
    r2 = row[L_RADIUS] * row[L_RADIUS]
    disc = b * b - (oc2 - r2)
    sd = sqrt_rn(torch.clamp(disc, min=0.0))
    hit = (disc > 0.0) & ((-b - sd > sc.t_min) | (-b + sd > sc.t_min))
    cos_max = sqrt_rn(torch.clamp(1.0 - r2 / oc2, min=0.0))
    return torch.where(hit, 1.0 / (TWO_PI * (1.0 - cos_max)), 0.0)


def lights_density(sc: Scene, p, d):
    """The light list's density of ``d`` from ``p``: the mean of its
    lights' (their sum in list order, / L)."""
    total = torch.zeros_like(p[0])
    for j in range(len(sc.light_kind)):
        total = total + light_density(sc, j, p, d)
    return total / len(sc.light_kind)


def mixture_scatter(sc: Scene, p, n, cos_dir, att, u):
    """(direction, weight) of a Lambertian hit at ``p`` with normal ``n``
    under the mixture of the light list and the cosine lobe ``cos_dir``
    (unnormalised); ``u(i)`` is the lane's scatter column i."""
    L = sc.flags["n_lights"]
    j = torch.clamp((u(1) * L).to(torch.int64), max=L - 1)
    light = toward_light(sc, j, p, u(2), u(3), u(4), u(5))
    d = normalize(where3(u(0) < 0.5, light, cos_dir))
    cos_pdf = torch.clamp(dot(d, n), min=0.0) * INV_PI
    mix = 0.5 * (lights_density(sc, p, d) + cos_pdf)
    w = torch.where(mix > 0.0, cos_pdf / mix, 0.0)
    return d, (att[0] * w, att[1] * w, att[2] * w)


# --- one bounce -----------------------------------------------------------------

def shade(sc: Scene, o, d, tm, t, idx, ids, kd):
    """Hit record, texture, emission and scatter of each lane's hit."""
    fl = sc.flags
    zero = torch.zeros_like(t)
    g = lambda a: a[idx]
    A, B = g(sc.A), g(sc.B)
    kind = g(sc.kind)
    hit = torch.isfinite(t)
    ts = torch.where(hit, t, 1.0)
    px, py, pz = o[0] + ts * d[0], o[1] + ts * d[1], o[2] + ts * d[2]
    cx, cy, cz = A[:, 0], A[:, 1], A[:, 2]
    if fl["has_moving"]:
        dt = tm - g(sc.C)
        cx = cx + B[:, 0] * dt
        cy = cy + B[:, 1] * dt
        cz = cz + B[:, 2] * dt
    rr = torch.clamp(g(sc.D), min=1e-12)
    n = ((px - cx) / rr, (py - cy) / rr, (pz - cz) / rr)
    if fl["has_quads"]:
        n = where3(kind == QUAD, (B[:, 0], B[:, 1], B[:, 2]), n)
    if fl["has_solid_box"]:
        ix, iy, iz = 1.0 / d[0], 1.0 / d[1], 1.0 / d[2]
        tax, tbx = (A[:, 0] - o[0]) * ix, (B[:, 0] - o[0]) * ix
        tay, tby = (A[:, 1] - o[1]) * iy, (B[:, 1] - o[1]) * iy
        taz, tbz = (A[:, 2] - o[2]) * iz, (B[:, 2] - o[2]) * iz
        t3n = (torch.minimum(tax, tbx), torch.minimum(tay, tby),
               torch.minimum(taz, tbz))
        t3f = (torch.maximum(tax, tbx), torch.maximum(tay, tby),
               torch.maximum(taz, tbz))
        tn_b = torch.maximum(torch.maximum(t3n[0], t3n[1]), t3n[2])
        ax_n = torch.where(t3n[1] > t3n[0], 1, 0)
        ax_n = torch.where(t3n[2] > torch.maximum(t3n[0], t3n[1]), 2, ax_n)
        ax_f = torch.where(t3f[1] < t3f[0], 1, 0)
        ax_f = torch.where(t3f[2] < torch.minimum(t3f[0], t3f[1]), 2, ax_f)
        axis = torch.where(tn_b > sc.t_min, ax_n, ax_f)
        n = where3(kind == BOX, tuple((axis == a).to(t.dtype)
                                      for a in range(3)), n)
    front = dot(d, n) < 0.0
    n = where3(front, n, (-n[0], -n[1], -n[2]))
    if fl["has_media"]:
        is_med = kind >= MEDIUM_SPHERE
        n = where3(is_med, (torch.ones_like(zero), zero, zero), n)
        front = front | is_med

    mkind = g(sc.mkind)
    color = g(sc.color)
    att = (color[:, 0], color[:, 1], color[:, 2])
    if fl["has_perlin"]:
        m = marble(g(sc.salt), g(sc.scale), px, py, pz)
        att = where3(g(sc.tex) == TEX_PERLIN, (m, m, m), att)
    base = rng.lane_base(kd, ids)
    u = lambda i: rng.col(base, i, t.dtype)
    unit_d = normalize(d)
    emitted = (zero, zero, zero)
    if fl["has_emissive"]:
        emitted = where3((mkind == LIGHT) & ~front, att, emitted)
    branches = []
    if fl["has_lambertian"]:
        cos_dir = onb_local(onb_from_w(n), cosine_direction(u(6), u(7)))
        if fl["n_lights"]:
            branches.append((LAMBERTIAN, *mixture_scatter(
                sc, (px, py, pz), n, cos_dir, att, u)))
        else:
            branches.append((LAMBERTIAN, normalize(cos_dir), att))
    if fl["has_metal"]:
        fuzz = g(sc.fuzz)
        refl = reflect(unit_d, n)
        fv = unit_vector(u(8), u(9))
        branches.append((METAL, tuple(refl[i] + fuzz * fv[i]
                                      for i in range(3)), att))
    if fl["has_dielectric"]:
        ri = g(sc.ref_idx)
        ratio = torch.where(front, 1.0 / ri, ri)
        cos_t = torch.clamp(dot((-unit_d[0], -unit_d[1], -unit_d[2]), n),
                            max=1.0)
        sin_t = sqrt_rn(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        q = (1.0 - ratio) / (1.0 + ratio)
        r0 = q * q
        x = 1.0 - cos_t
        x2 = x * x
        refl_prob = r0 + (1.0 - r0) * (x * (x2 * x2))
        flip = (ratio * sin_t > 1.0) | (u(10) < refl_prob)
        branches.append((DIELECTRIC, where3(flip, reflect(unit_d, n),
                                            refract(unit_d, n, ratio)),
                         (torch.ones_like(zero),) * 3))
    if fl["has_isotropic"]:
        branches.append((ISOTROPIC, unit_vector(u(11), u(12)), att))
    _, direction, weight = branches[0]
    for mk, dir_, w_ in branches[1:]:
        sel = mkind == mk
        direction = where3(sel, dir_, direction)
        weight = where3(sel, w_, weight)
    scattered = (mkind != LIGHT) if fl["has_emissive"] \
        else torch.ones_like(hit)
    return hit, (px, py, pz), direction, weight, emitted, scattered


def bounce(sc: Scene, st: dict, ids, kd_isect, kd_scat, max_depth: int):
    """One intersect and one step of the lanes in ``st`` (updated in
    place); returns the lanes whose path ended in this step."""
    o, d, tm, tp = st["o"], st["d"], st["tm"], st["tp"]
    bt, bi = intersect(sc, (*o, *d, tm), kd_isect, ids)
    hit, point, direction, w, em, scattered = shade(sc, o, d, tm, bt, bi,
                                                    ids, kd_scat)
    act = st["active"]
    miss = act & ~hit
    emit = act & hit & ~scattered
    cont = act & hit & scattered
    bg = sc.background
    st["ac"] = tuple(st["ac"][i] + torch.where(miss, tp[i] * bg[i], 0.0)
                     + torch.where(emit, tp[i] * em[i], 0.0)
                     for i in range(3))
    tp = where3(cont, (tp[0] * w[0], tp[1] * w[1], tp[2] * w[2]), tp)
    st["bounce"] = torch.where(cont, st["bounce"] + 1, st["bounce"])
    tp_max = torch.maximum(torch.maximum(tp[0], tp[1]), tp[2])
    dead = act & (miss | emit | (cont & (st["bounce"] >= max_depth))
                  | (cont & (tp_max <= 0.0)))
    st["o"] = where3(cont, point, o)
    st["d"] = where3(cont, direction, d)
    st["tp"] = tp
    st["active"] = act & ~dead
    return dead


def camera_rays(cam, sx, sy, u2, u3, u4):
    """Thin-lens rays through image-plane points (sx, sy) from the lens
    and shutter uniforms (u2, u3, u4)."""
    c = cam.words
    r = c[18] * sqrt_rn(u2)
    phi = TWO_PI * u3
    rc, rs = r * torch.cos(phi), r * torch.sin(phi)
    off = tuple(rc * c[12 + i] + rs * c[15 + i] for i in range(3))
    tm = c[19] + float(f32(c[20]) - f32(c[19])) * u4
    o = tuple(c[i] + off[i] for i in range(3))
    d = tuple(c[3 + i] + sx * c[6 + i] + sy * c[9 + i] - c[i] - off[i]
              for i in range(3))
    return o, d, tm


def camera_uniforms(pid, gs, salt: int, dt):
    base = rng.pair_base(pid, gs ^ (salt & rng.M32))
    return [rng.col(base, i, dt) for i in range(5)]


# --- the two schedules ------------------------------------------------------------

def _largest_divisor_leq(n: int, cap: int) -> int:
    k = max(1, min(cap, n))
    while n % k:
        k -= 1
    return k


def plan_pool(n_prims: int, width: int, height: int, spp: int,
              rays_per_wave: int = 1 << 20, samples_per_wave: int = 64):
    """(slots a pixel, samples a slot a wave, waves) of a pool render of a
    scene of at most 512 prims."""
    if n_prims > 512:
        raise ValueError("the pool plan here covers scenes of <= 512 prims")
    k = _largest_divisor_leq(spp, max(1, rays_per_wave // (width * height)))
    s_total = spp // k
    lanes = width * height * k
    s_budget = max(1, int(2e13 / (lanes * max(n_prims, 1) * 8)))
    s_wave = _largest_divisor_leq(s_total, min(samples_per_wave, s_budget))
    return k, s_wave, s_total // s_wave


def _state(n, dev, dt):
    z = lambda: torch.zeros((n,), dtype=dt, device=dev)
    one = lambda: torch.ones((n,), dtype=dt, device=dev)
    return dict(o=(z(), z(), z()), d=(z(), z(), z()), tm=z(),
                tp=(one(), one(), one()), ac=(z(), z(), z()),
                bounce=torch.zeros((n,), dtype=torch.int64, device=dev),
                active=torch.zeros((n,), dtype=torch.bool, device=dev))


def _take(st: dict, keep):
    return {k: (tuple(x[keep] for x in v) if isinstance(v, tuple) else v[keep])
            for k, v in st.items()}


def render_pool(sc: Scene, cam, width, height, spp, max_depth, seed, pixels,
                dt=torch.float32):
    """(n, 3) estimate of the image's ``pixels`` (flat row-major ids, image
    row 0 at the top) by the pool's schedule."""
    dev = pixels.device
    P = width * height
    k, s_wave, n_waves = plan_pool(sc.n_prims, width, height, spp)
    n = pixels.shape[0]
    pix = pixels.to(torch.int64).repeat(k)
    slot = (torch.arange(k, device=dev).repeat_interleave(n) * P + pix) \
        & rng.M32
    xs = (pix % width).to(torch.float32) / width
    ys = (height - 1 - pix // width).to(torch.float32) / height
    xs, ys = xs.to(dt), ys.to(dt)
    inv_w, inv_h = float(f32(1.0 / width)), float(f32(1.0 / height))
    film = torch.zeros((n, 3), dtype=dt, device=dev)
    for w in range(n_waves):
        k_loop = rng.fold_in(rng.prng_key(seed), w)
        iter_cap = s_wave * max_depth + max_depth
        kb = rng.fold_in(k_loop, np.arange(iter_cap, dtype=np.uint32))
        k_isect, k_scat = rng.fold_in(kb, 0), rng.fold_in(kb, 1)
        sample0 = (w * s_wave) & rng.M32
        st = _state(k * n, dev, dt)
        st["sample"] = torch.zeros((k * n,), dtype=torch.int64, device=dev)
        lane = torch.arange(k * n, device=dev)

        def regen(st, want, lane):
            gs = (sample0 + st["sample"]) & rng.M32
            u0, u1, u2, u3, u4 = camera_uniforms(slot[lane], gs, seed, dt)
            o, d, tm = camera_rays(cam, xs[lane] + u0 * inv_w,
                                   ys[lane] + u1 * inv_h, u2, u3, u4)
            one = torch.ones_like(tm)
            st["o"] = where3(want, o, st["o"])
            st["d"] = where3(want, d, st["d"])
            st["tm"] = torch.where(want, tm, st["tm"])
            st["tp"] = where3(want, (one, one, one), st["tp"])
            st["bounce"] = torch.where(want, 0, st["bounce"])
            st["sample"] = torch.where(want, st["sample"] + 1, st["sample"])
            st["active"] = st["active"] | want

        regen(st, st["sample"] < s_wave, lane)
        acc = torch.zeros((k * n, 3), dtype=dt, device=dev)
        for it in range(iter_cap):
            if it % CHECK == 0:
                alive = st["active"]
                if not bool(alive.any()):
                    break
                if int(alive.sum()) * 2 < alive.shape[0]:
                    done = ~alive
                    acc[lane[done]] = torch.stack(
                        [a[done] for a in st["ac"]], dim=1)
                    st, lane = _take(st, alive), lane[alive]
            dead = bounce(sc, st, slot[lane], k_isect[it], k_scat[it],
                          max_depth)
            regen(st, dead & (st["sample"] < s_wave), lane)
        acc[lane] = torch.stack(st["ac"], dim=1)
        film = film + acc.reshape(k, n, 3).sum(dim=0)
    return film / spp


def render_queue(sc: Scene, cam, width, height, spp, max_depth, seed, pixels,
                 dt=torch.float32):
    """(n, 3) estimate of the image's ``pixels`` by the queue's keys: one
    path per (pixel, sample), its radiance summed over the samples."""
    dev = pixels.device
    P = width * height
    n = pixels.shape[0]
    k_queue = rng.fold_in(rng.prng_key(seed), 0x5EED)
    k_isect, k_scat = rng.fold_in(k_queue, 0), rng.fold_in(k_queue, 1)
    inv_w, inv_h = float(f32(1.0 / width)), float(f32(1.0 / height))
    pix = pixels.to(torch.int64).repeat(spp)
    gs = torch.arange(spp, device=dev).repeat_interleave(n)
    work = gs * P + pix
    u0, u1, u2, u3, u4 = camera_uniforms(pix, gs, seed, dt)
    sx = ((pix % width).to(dt) + u0) * inv_w
    sy = ((height - 1 - pix // width).to(dt) + u1) * inv_h
    st = _state(spp * n, dev, dt)
    st["o"], st["d"], st["tm"] = camera_rays(cam, sx, sy, u2, u3, u4)
    st["active"] = torch.ones_like(st["active"])
    out = torch.zeros((spp * n, 3), dtype=dt, device=dev)
    lane = torch.arange(spp * n, device=dev)
    for b in range(max_depth):
        ids = rng.pair_base(work[lane], st["bounce"])
        dead = bounce(sc, st, ids, k_isect, k_scat, max_depth)
        out[lane[dead]] = torch.stack([a[dead] for a in st["ac"]], dim=1)
        alive = st["active"]
        if not bool(alive.any()):
            break
        st, lane = _take(st, alive), lane[alive]
    return out.reshape(spp, n, 3).sum(dim=0) / spp
