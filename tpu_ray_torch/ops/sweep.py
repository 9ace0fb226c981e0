"""Closest-hit sweeps over the solid prims: the CUDA kernels and their plain
twins.

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

The sorted, compacted-list sweep (``csrc/sweep_compact.cu``, replacing
``intersect_pallas.py::_compact_kernel``) computes the same function for
rays sorted by :func:`sort_key`: the prim table is cut into blocks of at
most 128 rows of one kind (:func:`sweep_blocks`), :func:`tile_lists` finds
for every 256-ray tile the blocks some ray of it can enter, and
:func:`sweep_compact` (kernel) / :func:`sweep_compact_plain` sweep only
those.  Skipping is exact - a hit lies inside its block's box - and a
lower-prim-id tie-break makes ``(t, i)`` bit-equal to the dense sweep's.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..models.scene_data import SceneData
from .build import load_fn

ROW = 16
INF = float("inf")
RAY_CHUNK = 1 << 16       # plain version: rays per (R, C) temporary block
PBLK = 128                # prim rows per block of the compacted sweep
TILE_R = 256              # rays per tile of the compacted sweep
KINDS = ("sphere", "moving", "box", "quad")

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


# --- the sorted, compacted-list sweep ---------------------------------------

def use_sort(sort=None) -> bool:
    """The sorted sweep's switch: an explicit ``sort`` wins, else it is on
    only when the environment says ``TPU_RAY_SORT=1`` (off by default, as
    ``intersect_pallas._use_sort_cull``)."""
    if sort is not None:
        return bool(sort)
    return os.environ.get("TPU_RAY_SORT", "auto") == "1"


def range_aabbs(scene: SceneData, lo: int, hi: int, flavor: str):
    """((n, 3) lo, (n, 3) hi) conservative boxes of prim rows [lo, hi);
    moving spheres take the union over shutter times 0..1."""
    p = scene.prims
    if flavor == "sphere":
        c, v = p.center[lo:hi], p.velocity[lo:hi]
        t0, r = p.time0[lo:hi, None], p.radius[lo:hi, None]
        c0 = c - v * t0
        c1 = c + v * (1.0 - t0)
        return torch.minimum(c0, c1) - r, torch.maximum(c0, c1) + r
    if flavor == "box":
        return p.box_min[lo:hi], p.box_max[lo:hi]
    p0, e1, e2 = p.quad_p0[lo:hi], p.quad_e1[lo:hi], p.quad_e2[lo:hi]
    cs = torch.stack([p0, p0 + e1, p0 + e2, p0 + e1 + e2])
    return cs.min(0).values, cs.max(0).values


def block_aabbs(alo: torch.Tensor, ahi: torch.Tensor):
    """Union per-prim boxes into per-128-row block boxes (B, 3); the rows
    that pad the last block are empty boxes (+inf, -inf)."""
    pad = (-alo.shape[0]) % PBLK
    f = torch.nn.functional.pad
    alo = f(alo, (0, 0, 0, pad), value=INF)
    ahi = f(ahi, (0, 0, 0, pad), value=-INF)
    return (alo.reshape(-1, PBLK, 3).min(1).values,
            ahi.reshape(-1, PBLK, 3).max(1).values)


@dataclass
class SweepBlocks:
    """The prim table cut into blocks of at most 128 rows of one kind."""

    desc: torch.Tensor    # (B, 3) int32: first row, row count, kind 0..3
    blo: torch.Tensor     # (B, 3) block boxes
    bhi: torch.Tensor
    wlo: torch.Tensor     # (3,) box of all solids (the sort key's frame)
    whi: torch.Tensor
    spans: tuple          # per kind range: (first block, last block + 1)

    @property
    def n_blocks(self) -> int:
        return self.desc.shape[0]


def sweep_blocks(scene: SceneData) -> SweepBlocks:
    """Blocks of the four kind ranges, in table order, with their boxes."""
    n_ss, n_s, n_sb, n_solid = _ranges(scene)
    desc, blo, bhi, spans, wlo, whi = [], [], [], [], [], []
    for (lo, hi), kind, flavor in zip(
            ((0, n_ss), (n_ss, n_s), (n_s, n_sb), (n_sb, n_solid)),
            range(4), ("sphere", "sphere", "box", "quad")):
        first = len(desc)
        if hi > lo:
            alo, ahi = range_aabbs(scene, lo, hi, flavor)
            b0, b1 = block_aabbs(alo, ahi)
            blo.append(b0)
            bhi.append(b1)
            desc += [(s, min(PBLK, hi - s), kind)
                     for s in range(lo, hi, PBLK)]
        spans.append((first, len(desc)))
    # the sort key's frame: the box of the sphere, box and quad ranges
    for lo, hi, flavor in ((0, n_s, "sphere"), (n_s, n_sb, "box"),
                           (n_sb, n_solid, "quad")):
        if hi > lo:
            alo, ahi = range_aabbs(scene, lo, hi, flavor)
            wlo.append(alo.min(0).values)
            whi.append(ahi.max(0).values)
    dev = scene.device
    return SweepBlocks(
        desc=torch.tensor(desc, dtype=torch.int32, device=dev).reshape(-1, 3),
        blo=torch.cat(blo), bhi=torch.cat(bhi),
        wlo=torch.stack(wlo).min(0).values,
        whi=torch.stack(whi).max(0).values, spans=tuple(spans))


def _spread10(v: torch.Tensor) -> torch.Tensor:
    """Interleave 10 bits with two zero bits each (a Morton component)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def sort_key(blocks: SweepBlocks, rays: torch.Tensor) -> torch.Tensor:
    """Ray-coherence key (``intersect_pallas._sort_key``): 3-bit direction
    octant major, the top 29 bits of the origin's 30-bit Morton code in the
    solids' box minor.  int64 holding the uint32 key."""
    o, d = rays[0:3], rays[3:6]
    oct_ = ((d[0] < 0).to(torch.int64) * 4 + (d[1] < 0).to(torch.int64) * 2
            + (d[2] < 0).to(torch.int64))
    ext = torch.clamp(blocks.whi - blocks.wlo, min=1e-9)
    q = torch.clamp((o - blocks.wlo[:, None]) / ext[:, None], min=0.0,
                    max=0.999999)
    q = (q * 1024.0).to(torch.int64)
    m = (_spread10(q[0]) << 2) | (_spread10(q[1]) << 1) | _spread10(q[2])
    return (oct_ << 29) | (m >> 1)


def tile_lists(rays: torch.Tensor, blo: torch.Tensor, bhi: torch.Tensor,
               t_min: float):
    """Front-to-back block lists per 256-ray tile
    (``intersect_pallas._tile_lists``): (cnt (T,) int32, lst (T, B) int32);
    ``lst[t, :cnt[t]]`` are the blocks some ray of tile t can enter past
    ``t_min``, by the tile's closest entry distance.  A last tile short of
    256 rays is padded with rays from the origin along (1, 1, 1)."""
    R = rays.shape[1]
    B = blo.shape[0]
    pad = (-R) % TILE_R
    o, d = rays[0:3].T, rays[3:6].T                       # (R, 3)
    if pad:
        o = torch.nn.functional.pad(o, (0, 0, 0, pad))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
    safe = torch.where(d.abs() < 1e-30,
                       torch.where(d < 0, -1e-30, 1e-30), d)
    inv = 1.0 / safe
    tn = torch.full((R + pad, B), -INF, device=rays.device)
    tf = torch.full((R + pad, B), INF, device=rays.device)
    for ax in range(3):
        t0 = (blo[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t1 = (bhi[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    slack = 1e-4 * (1.0 + tn.abs())
    need = (tn - slack <= tf) & (tf > float(np.float32(t_min)))
    T = (R + pad) // TILE_R
    need_t = need.reshape(T, TILE_R, B).any(1)
    key_t = torch.where(need, torch.clamp(tn, min=0.0), INF) \
        .reshape(T, TILE_R, B).min(1).values
    order = torch.argsort(torch.where(need_t, key_t, INF), dim=1, stable=True)
    return (need_t.sum(1, dtype=torch.int32).contiguous(),
            order.to(torch.int32).contiguous())


def _check_lists(rays, blocks, cnt, lst, perm):
    R = rays.shape[1]
    T = -(-R // TILE_R)
    B = blocks.n_blocks
    for x, shape, dtype in ((blocks.desc, (B, 3), torch.int32),
                            (cnt, (T,), torch.int32),
                            (lst, (T, B), torch.int32)):
        if tuple(x.shape) != shape or x.dtype != dtype \
                or not x.is_contiguous() or x.device != rays.device:
            raise ValueError(f"compacted sweep: expected a contiguous {shape} "
                             f"{dtype} on the rays' device")
    if perm is not None and (tuple(perm.shape) != (R,)
                             or perm.dtype != torch.int64
                             or not perm.is_contiguous()
                             or perm.device != rays.device):
        raise ValueError("compacted sweep: perm must be a contiguous (R,) "
                         "int64 on the rays' device")


def sweep_compact_plain(rays, geo, blocks: SweepBlocks, cnt, lst,
                        t_min: float, perm=None):
    """Plain-PyTorch compacted sweep: every listed (tile, block) pair runs
    :func:`_block_t`, unlisted pairs are skipped (their t is +inf), and
    blocks merge with the lower-prim-id tie-break.  Returns (best_t,
    best_i), written to position ``perm[ray]`` when ``perm`` is given."""
    _check(rays, geo)
    _check_lists(rays, blocks, cnt, lst, perm)
    sweep_compact_plain.calls += 1
    R = rays.shape[1]
    B = blocks.n_blocks
    dev = rays.device
    t_min = float(np.float32(t_min))
    listed = torch.zeros((cnt.shape[0], B), dtype=torch.bool, device=dev)
    ranks = torch.arange(B, device=dev)[None, :] < cnt[:, None]
    listed.scatter_(1, lst.to(torch.int64), ranks)            # (T, B)
    tile_of = torch.arange(R, device=dev) // TILE_R
    best_t = torch.full((R,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((R,), dtype=torch.int32, device=dev)
    for b, (start, rows, kind) in enumerate(blocks.desc.tolist()):
        on = listed[:, b][tile_of]
        for r0 in range(0, R, RAY_CHUNK):
            sl = slice(r0, r0 + RAY_CHUNK)
            t = _block_t(rays[:, sl], geo, start, start + rows, KINDS[kind],
                         t_min)
            ct, cidx = torch.min(t, dim=1)
            ct = torch.where(on[sl], ct, INF)
            ci = cidx.to(torch.int32) + start
            bt, bi = best_t[sl], best_i[sl]
            closer = (ct < bt) | ((ct == bt) & (ci < bi))
            bt.copy_(torch.where(closer, ct, bt))
            bi.copy_(torch.where(closer, ci, bi))
    if perm is not None:
        best_t = torch.empty_like(best_t).index_copy_(0, perm, best_t)
        best_i = torch.empty_like(best_i).index_copy_(0, perm, best_i)
    return best_t, best_i


sweep_compact_plain.calls = 0


def sweep_compact(rays, geo, blocks: SweepBlocks, cnt, lst, t_min: float,
                  perm=None):
    """Closest solid hit over the per-tile block lists: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  ``rays`` are the
    sorted rays; with ``perm`` (the sort's permutation) the results land at
    the rays' unsorted positions."""
    if not rays.is_cuda:
        return sweep_compact_plain(rays, geo, blocks, cnt, lst, t_min, perm)
    _check(rays, geo)
    _check_lists(rays, blocks, cnt, lst, perm)
    if not geo.is_cuda:
        raise ValueError("prim table must be on the rays' device")
    fn = load_fn("sweep_compact", "tr_sweep_compact", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    R = rays.shape[1]
    best_t = torch.empty((R,), dtype=torch.float32, device=rays.device)
    best_i = torch.empty((R,), dtype=torch.int32, device=rays.device)
    err = fn(rays.data_ptr(), R, geo.data_ptr(), blocks.desc.data_ptr(),
             cnt.data_ptr(), lst.data_ptr(), blocks.n_blocks,
             float(np.float32(t_min)),
             None if perm is None else perm.data_ptr(), best_t.data_ptr(),
             best_i.data_ptr(),
             torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError("compacted sweep kernel launch failed (cudaError "
                           f"{err})")
    sweep_compact.launches += 1
    return best_t, best_i


sweep_compact.launches = 0


def sweep_sorted(rays, geo, blocks: SweepBlocks, t_min: float):
    """The whole sorted sweep of unsorted ``rays``: key, stable sort, ray
    gather, tile lists, compacted sweep with the un-permute folded into the
    kernel's stores.  Same (best_t, best_i) as :func:`sweep`."""
    perm = torch.sort(sort_key(blocks, rays), stable=True).indices
    srays = rays[:, perm].contiguous()
    cnt, lst = tile_lists(srays, blocks.blo, blocks.bhi, t_min)
    return sweep_compact(srays, geo, blocks, cnt, lst, t_min, perm)
