"""Closest-hit sweep over the solid prims: the CUDA kernel and its plain twin.

``csrc/sweep.cu`` replaces the TPU kernels ``tpu_ray/ops/intersect_pallas.py::
_sphere_kernel`` / ``_box_kernel`` / ``_quad_kernel`` (and the XLA
``tpu_ray/ops/intersect.py::_chunk_t`` solid math that the JAX main path
runs at <= 512 prims).  :func:`sweep` launches it for CUDA tensors;
:func:`sweep_plain` is the same function in plain PyTorch, used for CPU
tensors and as the reference the card's kernel is held to.

Rays are one (7, R) float32 tensor, rows ox, oy, oz, dx, dy, dz, time -
the first seven rows of the pool state, so the sweep reads the state in
place.  The prim table is (n_solid, 16) float32, kind-sorted like the
scene rows:

* sphere: cx, cy, cz, vx, vy, vz, time0, radius^2
* box:    min x, y, z, max x, y, z
* quad:   p0 x, y, z, n x, y, z, plane d, inv1 x, y, z, inv2 x, y, z
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.scene_data import SceneData
from .build import load_fn

ROW = 16
INF = float("inf")
RAY_CHUNK = 1 << 16       # plain version: rays per (R, C) temporary block

# fp32 operations per (ray, prim) pair, the sweep's roofline numerator
FLOPS_PER_PAIR = {"sphere": 21, "moving": 27, "box": 24, "quad": 31}


def sweep_table(scene: SceneData) -> torch.Tensor:
    """The (n_solid, 16) float32 prim table on the scene's device."""
    p = scene.prims
    n = scene.n_solid
    g = np.zeros((n, ROW), np.float32)
    ns, nsb = scene.n_sphere, scene.n_sphere + scene.n_box
    cpu = lambda a: a[:n].cpu().numpy()
    center, vel, t0, rad = cpu(p.center), cpu(p.velocity), cpu(p.time0), \
        cpu(p.radius)
    g[:ns, 0:3] = center[:ns]
    g[:ns, 3:6] = vel[:ns]
    g[:ns, 6] = t0[:ns]
    g[:ns, 7] = rad[:ns] * rad[:ns]           # f32 radius**2, as the sweeps
    g[ns:nsb, 0:3] = cpu(p.box_min)[ns:nsb]
    g[ns:nsb, 3:6] = cpu(p.box_max)[ns:nsb]
    g[nsb:, 0:3] = cpu(p.quad_p0)[nsb:]
    g[nsb:, 3:6] = cpu(p.quad_n)[nsb:]
    g[nsb:, 6] = cpu(p.quad_d)[nsb:]
    g[nsb:, 7:10] = cpu(p.quad_inv1)[nsb:]
    g[nsb:, 10:13] = cpu(p.quad_inv2)[nsb:]
    return torch.from_numpy(g).to(scene.device)


def _ranges(scene: SceneData):
    return (scene.n_sphere_static, scene.n_sphere,
            scene.n_sphere + scene.n_box, scene.n_solid)


def _check(rays: torch.Tensor, geo: torch.Tensor):
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be (7, R) float32, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    if rays.stride(1) != 1 or rays.stride(0) != rays.shape[1]:
        raise ValueError("rays must be row-contiguous with row stride R")
    if geo.dtype != torch.float32 or not geo.is_contiguous() \
            or geo.dim() != 2 or geo.shape[1] != ROW:
        raise ValueError("prim table must be a contiguous (n, 16) float32")


def _block_t(rays, geo, lo, hi, kind, t_min):
    """(r, hi - lo) hit distances of a ray block against prim rows
    [lo, hi) of one kind - _chunk_t's solid math, op for op."""
    ox, oy, oz, dx, dy, dz, rt = (rays[i][:, None] for i in range(7))
    g = geo[lo:hi].T[:, None, :]                 # (16, 1, C)
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
        sd = torch.sqrt(torch.clamp(disc, min=0.0))
        inv_a = 1.0 / a
        t1 = (-b - sd) * inv_a
        t2 = (-b + sd) * inv_a
        return torch.where(ok & (t1 > t_min) & (t1 < INF), t1,
                           torch.where(ok & (t2 > t_min) & (t2 < INF), t2,
                                       INF))
    if kind == "box":      # torch.minimum/maximum propagate NaN like jnp's
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


def sweep_plain(rays: torch.Tensor, geo: torch.Tensor, ranges, t_min: float):
    """Plain-PyTorch closest hit: (best_t (R,) with +inf for no hit,
    best_i (R,) int32).  Runs over blocks of RAY_CHUNK rays so the (r, C)
    temporaries stay small at any pool size."""
    _check(rays, geo)
    sweep_plain.calls += 1
    n_ss, n_s, n_sb, n_solid = ranges
    R = rays.shape[1]
    best_t = torch.full((R,), INF, dtype=torch.float32, device=rays.device)
    best_i = torch.zeros((R,), dtype=torch.int32, device=rays.device)
    spans = ((0, n_ss, "sphere"), (n_ss, n_s, "moving"), (n_s, n_sb, "box"),
             (n_sb, n_solid, "quad"))
    t_min = float(np.float32(t_min))
    for r0 in range(0, R, RAY_CHUNK):
        blk = rays[:, r0:r0 + RAY_CHUNK]
        bt, bi = best_t[r0:r0 + RAY_CHUNK], best_i[r0:r0 + RAY_CHUNK]
        for lo, hi, kind in spans:
            if hi <= lo:
                continue
            t = _block_t(blk, geo, lo, hi, kind, t_min)
            ct, cidx = torch.min(t, dim=1)     # first index of the minimum
            closer = ct < bt
            bt.copy_(torch.where(closer, ct, bt))
            bi.copy_(torch.where(closer, cidx.to(torch.int32) + lo, bi))
    return best_t, best_i


sweep_plain.calls = 0


def sweep(rays: torch.Tensor, geo: torch.Tensor, ranges, t_min: float):
    """Closest solid hit of every ray: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Returns (best_t, best_i)."""
    if not rays.is_cuda:
        return sweep_plain(rays, geo, ranges, t_min)
    _check(rays, geo)
    if not geo.is_cuda:
        raise ValueError("prim table must be on the rays' device")
    fn = load_fn("sweep", "tr_sweep", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    R = rays.shape[1]
    best_t = torch.empty((R,), dtype=torch.float32, device=rays.device)
    best_i = torch.empty((R,), dtype=torch.int32, device=rays.device)
    n_ss, n_s, n_sb, n_solid = ranges
    err = fn(rays.data_ptr(), R, geo.data_ptr(), n_ss, n_s, n_sb, n_solid,
             float(np.float32(t_min)), best_t.data_ptr(), best_i.data_ptr(),
             torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed (cudaError {err})")
    sweep.launches += 1
    return best_t, best_i


sweep.launches = 0
