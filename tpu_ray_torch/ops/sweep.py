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
for every 256-ray tile the blocks some ray of it can enter (on the card the
list pass of the same source, :func:`list_pass`; its plain twin
:func:`tile_lists_plain`), and :func:`sweep_compact` (kernel) /
:func:`sweep_compact_plain` sweep only those.  Skipping is exact - a hit
lies inside its block's box - and a lower-prim-id tie-break makes ``(t,
i)`` bit-equal to the dense sweep's.

Two more sweeps compute the same function.  The mask-gated sweep (the same
kernel of ``csrc/sweep_compact.cu`` in its mask mode, replacing the
``cull=True`` mode of the three TPU kernels) takes the same sorted rays and
blocks with a (tiles, blocks) mask from :func:`needed_mask` instead of lists
(each tile's list is the needed blocks in table order; :func:`tile_mask`
gives the mask and the tiles' launch order in one list-pass launch):
:func:`sweep_masked` / :func:`sweep_masked_plain`, bit-equal to the dense
sweep too.  The matrix-product sphere sweep (``csrc/sweep_mxu.cu``,
replacing ``intersect_pallas.py::_sphere_mxu_kernel``) covers the
static-sphere range with the quadratic expanded around the range centroid:
:func:`sweep_sphere_mxu` / :func:`sweep_sphere_mxu_plain`; it reassociates
the arithmetic, so it agrees with the dense sweep to ~1e-5 relative, not bit
for bit (the kernel, on the tensor cores, gives its plain twin's bits).
:func:`sweep_solids` picks among them as a render's ``SceneKernels`` says.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.vec import sqrt_rn
from ..models.scene_data import SceneData
from .build import load_fn

ROW = 16
INF = float("inf")
RAY_CHUNK = 1 << 16       # plain version: rays per (R, C) temporary block
PBLK = 128                # prim rows per block of the compacted sweep
FILL_THREADS = 512        # dense sweep: threads per SM before rays per thread
PACK_PRIMS = 32           # dense sweep: solid prims before 4 rays per thread
TILE_R = 256              # rays per tile of the compacted sweep
KINDS = ("sphere", "moving", "box", "quad")

# fp32 operations per (ray, prim) pair, the sweep's roofline numerator
FLOPS_PER_PAIR = {"sphere": 21, "moving": 27, "box": 24, "quad": 31,
                  "sphere_mxu": 24}
# the matrix-product sweep's function per pair, with its products on the
# tensor cores: the 7 products of its cross terms (c'.d, o'.(-2c') + k'),
# each split three ways, are 21 multiply-adds (42 flops); b, cc, disc and
# the compare stay 6 flops on the CUDA cores
MXU_CUDA_FLOPS, MXU_TENSOR_FLOPS = 6, 42


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


def _check_rays(rays: torch.Tensor):
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be (7, R) float32, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    if rays.stride(1) != 1 or rays.stride(0) != rays.shape[1]:
        raise ValueError("rays must be row-contiguous with row stride R")


def _check(rays: torch.Tensor, geo: torch.Tensor):
    _check_rays(rays)
    if geo.dtype != torch.float32 or not geo.is_contiguous() \
            or geo.dim() != 2 or geo.shape[1] != ROW:
        raise ValueError("prim table must be a contiguous (n, 16) float32")


def _block_t(rays, geo, lo, hi, kind, t_min):
    """(r, hi - lo) hit distances of a ray block against prim rows
    [lo, hi) of one kind - _chunk_t's solid math, op for op."""
    return pair_t([rays[i][:, None] for i in range(7)],
                  geo[lo:hi].T[:, None, :], kind, t_min)


def pair_t(r, g, kind, t_min):
    """Hit distances of rays against prim rows of one kind, elementwise
    under broadcasting: ``r`` the seven ray rows (ox, oy, oz, dx, dy, dz,
    time), ``g`` the 16 rows of the prim table's columns.  The one copy of
    the solid pair math in plain PyTorch: the sweeps' twins call it on a
    (rays, prims) block (:func:`_block_t`), the BVH traversal's twin on one
    gathered prim per ray, so both give a pair the same bits."""
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


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def pick_rpt(R: int, sms: int, n_solid: int) -> int:
    """Rays per thread of the dense sweep kernel for an R-ray launch over
    ``n_solid`` prims on a card of ``sms`` SMs: the most of 4 and 2 that
    still gives every SM ``FILL_THREADS`` threads, else 1 (partly filled
    pools keep more warps in flight at one ray a thread).  4 only from
    ``PACK_PRIMS`` prims on: below ~30 pair tests a ray's 36 bytes take
    longer than its operations (3.35 TB/s against 67 TFLOP/s), and the
    registers of four rays cost more warps than the shared reads save.
    Every choice gives the same bits."""
    for rpt in (4, 2) if n_solid >= PACK_PRIMS else (2,):
        if R >= rpt * FILL_THREADS * sms:
            return rpt
    return 1


def pick_rpt_compact(R: int, sms: int) -> int:
    """Rays per thread of the sorted sweeps (compacted and mask-gated: one
    kernel) for R sorted rays on a card of ``sms`` SMs: 2 where the grid
    still gives every SM ``FILL_THREADS`` threads at 2, else 1 (the kernel
    has no build for 4: four rays a thread cost 124 registers and were
    slower at next-week-final).  Both choices give the same bits."""
    return 2 if R >= 2 * FILL_THREADS * sms else 1


def sweep(rays: torch.Tensor, geo: torch.Tensor, ranges, t_min: float):
    """Closest solid hit of every ray: the CUDA kernel for CUDA tensors
    (rays per thread by :func:`pick_rpt`), the plain version for CPU
    tensors.  Returns (best_t, best_i)."""
    if not rays.is_cuda:
        return sweep_plain(rays, geo, ranges, t_min)
    return sweep_launch(rays, geo, ranges, t_min,
                        pick_rpt(rays.shape[1], sm_count(rays.device),
                                 ranges[3]))


sweep.launches = 0


def sweep_launch(rays: torch.Tensor, geo: torch.Tensor, ranges,
                 t_min: float, rpt: int):
    """The dense sweep kernel at ``rpt`` rays per thread (1, 2 or 4) on
    CUDA tensors; counts into ``sweep.launches``.  Returns (best_t,
    best_i)."""
    _check(rays, geo)
    if not rays.is_cuda or not geo.is_cuda:
        raise ValueError("the sweep kernel takes CUDA tensors on one device")
    if rpt not in (1, 2, 4):
        raise ValueError(f"rays per thread must be 1, 2 or 4, not {rpt}")
    fn = load_fn("sweep", "tr_sweep", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    R = rays.shape[1]
    best_t = torch.empty((R,), dtype=torch.float32, device=rays.device)
    best_i = torch.empty((R,), dtype=torch.int32, device=rays.device)
    n_ss, n_s, n_sb, n_solid = ranges
    err = fn(rays.data_ptr(), R, geo.data_ptr(), n_ss, n_s, n_sb, n_solid,
             float(np.float32(t_min)), best_t.data_ptr(), best_i.data_ptr(),
             rpt, torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed (cudaError {err})")
    sweep.launches += 1
    return best_t, best_i


# --- the sorted, compacted-list sweep ---------------------------------------

def use_sort(sort=None) -> bool:
    """The sorted sweep's switch: an explicit ``sort`` wins, else it is on
    only when the environment says ``TPU_RAY_SORT=1`` (off by default, as
    ``intersect_pallas._use_sort_cull``)."""
    if sort is not None:
        return bool(sort)
    return os.environ.get("TPU_RAY_SORT", "auto") == "1"


def use_mask_cull() -> bool:
    """With the sorted sweep on, ``TPU_RAY_CULL_STYLE`` set to anything but
    ``compact`` (the default) picks the mask-gated kernel instead of the
    compacted lists, as ``intersect_solids_pallas`` does."""
    return os.environ.get("TPU_RAY_CULL_STYLE", "compact") != "compact"


def use_mxu() -> bool:
    """``TPU_RAY_SWEEP_MXU=1`` sends the static-sphere range through the
    matrix-product sweep (off by default, as
    ``intersect_pallas._use_mxu_spheres``)."""
    return os.environ.get("TPU_RAY_SWEEP_MXU", "0") == "1"


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


def _slab_need(rays: torch.Tensor, blo: torch.Tensor, bhi: torch.Tensor,
               t_min: float):
    """The slab test of every ray against every block box: (need (Rp, B)
    bool, entry distance tn (Rp, B)), Rp = R padded to whole 256-ray tiles
    with rays from the origin along (1, 1, 1).  ``need`` says the ray can
    enter the box past ``t_min``; zero direction components are nudged to
    +-1e-30 and the slack ``1e-4 * (1 + |tn|)`` covers the rounding of the
    slab against the prim tests (``intersect_pallas._needed_mask`` /
    ``_tile_lists``, operation for operation)."""
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
    return need, tn


def tile_lists_plain(rays: torch.Tensor, blo: torch.Tensor,
                     bhi: torch.Tensor, t_min: float):
    """Front-to-back block lists per 256-ray tile in plain PyTorch
    (``intersect_pallas._tile_lists``): (cnt (T,) int32, lst (T, B) int32,
    order (T,) int32); ``lst[t, :cnt[t]]`` are the blocks some ray of tile t
    can enter past ``t_min``, by the tile's closest entry distance, ties to
    the lower block id; ``order`` lists the tiles by descending cnt (the
    compacted sweep's launch order; equal counts in any order).  A last tile
    short of 256 rays is padded with rays from the origin along (1, 1, 1).
    The reference of the card's list pass."""
    tile_lists_plain.calls += 1
    need, tn = _slab_need(rays, blo, bhi, t_min)
    B = blo.shape[0]
    T = need.shape[0] // TILE_R
    need_t = need.reshape(T, TILE_R, B).any(1)
    key_t = torch.where(need, torch.clamp(tn, min=0.0), INF) \
        .reshape(T, TILE_R, B).min(1).values
    lst = torch.argsort(torch.where(need_t, key_t, INF), dim=1, stable=True)
    cnt = need_t.sum(1, dtype=torch.int32)
    return (cnt.contiguous(), lst.to(torch.int32).contiguous(),
            tile_order_plain(cnt))


tile_lists_plain.calls = 0


def tile_order_plain(cnt: torch.Tensor) -> torch.Tensor:
    """(T,) int32 launch order of the sorted sweeps' tiles from their (T,)
    counts of listed or needed blocks: by descending count, ties in tile
    order (the card's list pass leaves ties in any order)."""
    return torch.argsort(cnt, descending=True, stable=True) \
        .to(torch.int32).contiguous()


def needed_mask_plain(rays: torch.Tensor, blo: torch.Tensor,
                      bhi: torch.Tensor, t_min: float) -> torch.Tensor:
    """(T, B) int32 in plain PyTorch: can any ray of 256-ray tile t enter
    block b's box past ``t_min`` (``intersect_pallas._needed_mask``)?  The
    last tile is padded as in :func:`tile_lists_plain`."""
    needed_mask_plain.calls += 1
    need, _ = _slab_need(rays, blo, bhi, t_min)
    return need.reshape(-1, TILE_R, blo.shape[0]).any(1).to(torch.int32) \
        .contiguous()


needed_mask_plain.calls = 0


def _check_boxes(what, rays, blo, bhi):
    B = blo.shape[0]
    for x in (blo, bhi):
        if x.device != rays.device \
                or x.dtype != torch.float32 or not x.is_contiguous() \
                or tuple(x.shape) != (B, 3) or B == 0:
            raise ValueError(f"{what}: block boxes must be contiguous (B, 3) "
                             "float32 on the rays' device, B > 0")


def _require_cuda(what, *xs):
    """The card's entry points take CUDA tensors on one device, and have no
    plain fallback."""
    dev = xs[0].device
    if any(not x.is_cuda or x.device != dev for x in xs):
        raise ValueError(f"the {what} kernel takes CUDA tensors on one "
                         "device")


def list_pass(rays: torch.Tensor, blo: torch.Tensor, bhi: torch.Tensor,
              t_min: float, mask: bool = False):
    """The card's list pass (``csrc/sweep_compact.cu::tile_lists_kernel``) on
    CUDA tensors, one launch: (cnt, lst, order) as :func:`tile_lists_plain`
    gives them or, with ``mask``, (mask, order): the (T, B) needed mask of
    :func:`needed_mask_plain` and the tiles by descending count of needed
    blocks (:func:`tile_order_plain` of ``mask.sum(1)``, ties in any order).
    Counts into ``list_pass.launches``."""
    _check_rays(rays)
    _require_cuda("list pass", rays, blo, bhi)
    _check_boxes("list pass", rays, blo, bhi)
    B = blo.shape[0]
    fn = load_fn("sweep_compact", "tr_tile_lists", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    R = rays.shape[1]
    T = -(-R // TILE_R)
    dev = rays.device
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    cnt, order, sel = i32(T), i32(T), i32(T, B)
    done = torch.zeros((1,), dtype=torch.int32, device=dev)
    msk, lst = (sel, None) if mask else (None, sel)
    ptr = lambda x: None if x is None else x.data_ptr()
    err = fn(rays.data_ptr(), R, blo.data_ptr(), bhi.data_ptr(), B,
             float(np.float32(t_min)), cnt.data_ptr(), ptr(lst), ptr(msk),
             order.data_ptr(), done.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"list pass launch failed (cudaError {err})")
    list_pass.launches += 1
    return (msk, order) if mask else (cnt, lst, order)


list_pass.launches = 0


def tile_lists(rays: torch.Tensor, blo: torch.Tensor, bhi: torch.Tensor,
               t_min: float):
    """Front-to-back block lists per 256-ray tile, (cnt (T,) int32, lst (T,
    B) int32, order (T,) int32): the card's list pass for CUDA tensors, the
    plain version (:func:`tile_lists_plain`) for CPU tensors."""
    if not rays.is_cuda:
        return tile_lists_plain(rays, blo, bhi, t_min)
    return list_pass(rays, blo, bhi, t_min)


def needed_mask(rays: torch.Tensor, blo: torch.Tensor, bhi: torch.Tensor,
                t_min: float) -> torch.Tensor:
    """(T, B) int32 needed mask of 256-ray tiles against block boxes
    (``intersect_pallas._needed_mask``): :func:`tile_mask`'s mask."""
    return tile_mask(rays, blo, bhi, t_min)[0]


def tile_mask(rays: torch.Tensor, blo: torch.Tensor, bhi: torch.Tensor,
              t_min: float):
    """The mask-gated sweep's inputs, (mask (T, B) int32, order (T,)
    int32): the needed mask of :func:`needed_mask` and the tiles by
    descending count of needed blocks.  One list-pass launch for CUDA
    tensors; :func:`needed_mask_plain` and :func:`tile_order_plain` for CPU
    tensors."""
    if rays.is_cuda:
        return list_pass(rays, blo, bhi, t_min, mask=True)
    mask = needed_mask_plain(rays, blo, bhi, t_min)
    return mask, tile_order_plain(mask.sum(1, dtype=torch.int32))


def _check_tiles(what, rays, blocks, tables, perm):
    """``tables``: (tensor, trailing shape) pairs of per-tile int32 tables;
    each must be contiguous (T, *trailing) on the rays' device."""
    R = rays.shape[1]
    T = -(-R // TILE_R)
    B = blocks.n_blocks
    for x, shape in [(blocks.desc, (B, 3))] + [(x, (T, *tr))
                                               for x, tr in tables]:
        if tuple(x.shape) != shape or x.dtype != torch.int32 \
                or not x.is_contiguous() or x.device != rays.device:
            raise ValueError(f"{what}: expected a contiguous {shape} "
                             f"{torch.int32} on the rays' device")
    if perm is not None and (tuple(perm.shape) != (R,)
                             or perm.dtype != torch.int64
                             or not perm.is_contiguous()
                             or perm.device != rays.device):
        raise ValueError(f"{what}: perm must be a contiguous (R,) "
                         "int64 on the rays' device")


def _check_lists(rays, blocks, cnt, lst, order, perm):
    _check_tiles("compacted sweep", rays, blocks,
                 [(cnt, ()), (lst, (blocks.n_blocks,)), (order, ())], perm)


def _check_mask(rays, blocks, mask, order, perm):
    _check_tiles("masked sweep", rays, blocks,
                 [(mask, (blocks.n_blocks,)), (order, ())], perm)


def _sweep_listed_plain(rays, geo, blocks: SweepBlocks, listed, t_min, perm):
    """Plain-PyTorch sweep of the (tile, block) pairs that ``listed`` (T, B)
    bool names: each runs :func:`_block_t`, the others are skipped (their t
    is +inf), and blocks merge with the lower-prim-id tie-break (in table
    order a strict '<' alone)."""
    R = rays.shape[1]
    dev = rays.device
    t_min = float(np.float32(t_min))
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


def sweep_compact_plain(rays, geo, blocks: SweepBlocks, cnt, lst, order,
                        t_min: float, perm=None):
    """Plain-PyTorch compacted sweep: every listed (tile, block) pair runs
    :func:`_block_t`, unlisted pairs are skipped (their t is +inf), and
    blocks merge with the lower-prim-id tie-break, so the tile ``order``
    changes nothing.  Returns (best_t, best_i), written to position
    ``perm[ray]`` when ``perm`` is given."""
    _check(rays, geo)
    _check_lists(rays, blocks, cnt, lst, order, perm)
    sweep_compact_plain.calls += 1
    B = blocks.n_blocks
    dev = rays.device
    listed = torch.zeros((cnt.shape[0], B), dtype=torch.bool, device=dev)
    ranks = torch.arange(B, device=dev)[None, :] < cnt[:, None]
    listed.scatter_(1, lst.to(torch.int64), ranks)            # (T, B)
    return _sweep_listed_plain(rays, geo, blocks, listed, t_min, perm)


sweep_compact_plain.calls = 0


def sweep_compact(rays, geo, blocks: SweepBlocks, cnt, lst, order,
                  t_min: float, perm=None, rpt: int | None = None,
                  stats=None):
    """Closest solid hit over the per-tile block lists (cnt, lst, order) of
    :func:`tile_lists`: the CUDA kernel for CUDA tensors, launching the
    tiles in ``order`` at ``rpt`` rays per thread (1 or 2, by
    :func:`pick_rpt_compact` when omitted; every order and choice gives the
    same bits), the plain version for CPU tensors.  ``rays`` are the sorted
    rays; with ``perm`` (the sort's permutation) the results land at the
    rays' unsorted positions.  ``stats``: an optional (2,) int64 CUDA tensor
    the kernel adds its listed and its skipped (tile, block) pairs to."""
    if not rays.is_cuda:
        return sweep_compact_plain(rays, geo, blocks, cnt, lst, order, t_min,
                                   perm)
    _check(rays, geo)
    _check_lists(rays, blocks, cnt, lst, order, perm)
    out = _launch_tiles("compacted sweep", rays, geo, blocks, cnt, lst, order,
                        t_min, perm, rpt, stats, masked=False)
    sweep_compact.launches += 1
    return out


sweep_compact.launches = 0


def _launch_tiles(what, rays, geo, blocks: SweepBlocks, cnt, sel, order,
                  t_min, perm, rpt, stats, masked: bool):
    """One launch of ``csrc/sweep_compact.cu::sweep_tiles_kernel``: the
    compacted sweep (``sel`` the lists ``lst``, with ``cnt``) or the
    mask-gated sweep (``sel`` the needed mask; ``cnt`` None), tiles in
    ``order``, ``rpt`` rays per thread (by :func:`pick_rpt_compact` when
    None).  Returns (best_t, best_i)."""
    _require_cuda(what, rays, geo, blocks.desc, blocks.blo, blocks.bhi, sel,
                  order, *(x for x in (cnt, perm) if x is not None))
    _check_boxes(what, rays, blocks.blo, blocks.bhi)
    if geo.data_ptr() % 16:
        raise ValueError("prim table must be 16-byte aligned")
    R = rays.shape[1]
    if rpt is None:
        rpt = pick_rpt_compact(R, sm_count(rays.device))
    if rpt not in (1, 2):
        raise ValueError(f"rays per thread must be 1 or 2, not {rpt}")
    if stats is not None and (tuple(stats.shape) != (2,)
                              or stats.dtype != torch.int64
                              or stats.device != rays.device):
        raise ValueError("stats must be a (2,) int64 on the rays' device")
    fn = load_fn("sweep_compact", "tr_sweep_tiles", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    best_t = torch.empty((R,), dtype=torch.float32, device=rays.device)
    best_i = torch.empty((R,), dtype=torch.int32, device=rays.device)
    ptr = lambda x: None if x is None else x.data_ptr()
    err = fn(rays.data_ptr(), R, geo.data_ptr(), blocks.desc.data_ptr(),
             blocks.blo.data_ptr(), blocks.bhi.data_ptr(), ptr(cnt),
             sel.data_ptr(), order.data_ptr(), blocks.n_blocks,
             float(np.float32(t_min)), ptr(perm), best_t.data_ptr(),
             best_i.data_ptr(), rpt, int(masked), ptr(stats),
             torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {err})")
    return best_t, best_i


# --- the mask-gated sweep ----------------------------------------------------

def sweep_masked_plain(rays, geo, blocks: SweepBlocks, mask, order,
                       t_min: float, perm=None):
    """Plain-PyTorch mask-gated sweep of sorted ``rays``: block b is swept
    for tile t only where ``mask[t, b]`` is not 0, and blocks merge with the
    lower-prim-id tie-break, so the tile ``order`` changes nothing.  Returns
    (best_t, best_i), written to position ``perm[ray]`` when ``perm`` is
    given."""
    _check(rays, geo)
    _check_mask(rays, blocks, mask, order, perm)
    sweep_masked_plain.calls += 1
    return _sweep_listed_plain(rays, geo, blocks, mask > 0, t_min, perm)


sweep_masked_plain.calls = 0


def sweep_masked(rays, geo, blocks: SweepBlocks, mask, order, t_min: float,
                 perm=None, rpt: int | None = None, stats=None):
    """Closest solid hit of sorted ``rays`` under the (tiles, blocks) mask
    and tile order of :func:`tile_mask`: the CUDA kernel for CUDA tensors
    (:func:`sweep_masked_launch`), the plain version for CPU tensors.  With
    ``perm`` the results land at the rays' unsorted positions; ``rpt`` and
    ``stats`` are the kernel's (see there)."""
    if not rays.is_cuda:
        return sweep_masked_plain(rays, geo, blocks, mask, order, t_min, perm)
    return sweep_masked_launch(rays, geo, blocks, mask, order, t_min, perm,
                               rpt, stats)


sweep_masked.launches = 0


def sweep_masked_launch(rays, geo, blocks: SweepBlocks, mask, order,
                        t_min: float, perm=None, rpt: int | None = None,
                        stats=None):
    """The mask-gated sweep kernel on CUDA tensors (no plain fallback): the
    tiles launched in ``order`` (a permutation; :func:`tile_mask`'s puts
    the tiles with the most needed blocks first) at ``rpt`` rays per thread
    (1 or 2, by :func:`pick_rpt_compact` when omitted; every order and
    choice gives the same bits).  ``stats``: an optional (2,) int64 CUDA
    tensor the kernel adds its needed and its culled (tile, block) pairs
    to.  Counts into ``sweep_masked.launches``; returns (best_t, best_i)."""
    _check(rays, geo)
    _check_mask(rays, blocks, mask, order, perm)
    out = _launch_tiles("masked sweep", rays, geo, blocks, None, mask, order,
                        t_min, perm, rpt, stats, masked=True)
    sweep_masked.launches += 1
    return out


def sweep_sorted(rays, geo, blocks: SweepBlocks, t_min: float,
                 masked: bool = False):
    """The whole sorted sweep of unsorted ``rays``: key, stable sort, ray
    gather, then the tile lists (with the tiles' launch order) and the
    compacted sweep or, with ``masked``, the needed mask (with the same
    order) and the mask-gated sweep; the un-permute is folded into the
    kernel's stores.  Same (best_t, best_i) as :func:`sweep`."""
    perm = torch.sort(sort_key(blocks, rays), stable=True).indices
    srays = rays[:, perm].contiguous()
    if masked:
        mask, order = tile_mask(srays, blocks.blo, blocks.bhi, t_min)
        return sweep_masked(srays, geo, blocks, mask, order, t_min, perm)
    cnt, lst, order = tile_lists(srays, blocks.blo, blocks.bhi, t_min)
    return sweep_compact(srays, geo, blocks, cnt, lst, order, t_min, perm)


# --- the matrix-product sphere sweep -----------------------------------------

@dataclass
class MxuPack:
    """Static-sphere rows [lo, hi) packed for the matrix-product sweep
    (``intersect_pallas._sweep_sphere_mxu``): the range centroid ``m``, per
    sphere c' = c - m, k' = |c'|^2 - r^2 and -2c', and the tensor cores'
    side of the kernel (``csrc/sweep_mxu.cu``): per sphere the bounds |c'|
    and |k'| of its margin and, per lane of each 8-sphere tile, the split
    operands of the two products."""

    lo: int
    hi: int
    m: tuple              # (mx, my, mz) python floats of the float32 values
    tab: torch.Tensor     # (n, 8): c'x, c'y, c'z, k', -2c'x, -2c'y, -2c'z, 0
    frag: torch.Tensor    # (ceil(n / 8), 32, 8), see mxu_pack
    bound: torch.Tensor   # (n, 2): U = |c'|, W = |k'|
    frag2: torch.Tensor   # (ceil(n / 64), 32, 8): frag of the tile spheres


# the kernel's discriminant margin, per a ((|o'| + U)^2 + W), and the tile
# spheres' slack, the square root of the plain twin's rounding bound
MXU_MARGIN, MXU_SLACK = 2.0 ** -13, 2.0 ** -9


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero: PTX ``cvt.rna.tf32.f32``), as a float32 with the low 13 bits 0."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi)): the three-way split's operands."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _mxu_frag(cs, k, y2, y3) -> torch.Tensor:
    """(ceil(n / 8), 32, 8) operands of the kernel's products for n spheres
    (c' = ``cs``, k' = ``k``), laid out per lane (see :func:`mxu_pack`);
    ``y2`` and ``y3`` (n,) are the margin's columns."""
    n = cs.shape[0]
    G = -(-n // 8)
    zp = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 8 * G - n))
    col = lambda v: v[:, None]
    U, W = cs.norm(dim=1), k.abs()
    q = zp(torch.cat([-2.0 * cs, col(k - MXU_MARGIN * (U * U + W))], dim=1))
    e = zp(torch.cat([cs, col(torch.full_like(k, -1.0))], dim=1))
    one = torch.ones_like(k)
    y = zp(torch.stack([one, one, y2, y3], dim=1))
    qh, ql = tf32_split(q)                                      # (8G, 4)
    eh, el = tf32_split(e)
    z = torch.zeros_like(qh)
    return torch.stack([qh, ql, y, z, eh, el, z, z], dim=-1) \
        .reshape(G, 32, 8).contiguous()


def mxu_pack(geo: torch.Tensor, lo: int, hi: int) -> MxuPack:
    """Pack sphere rows [lo, hi) of the prim table (reads the centroid back
    to the host, so a render packs once).

    ``frag[g, L]``, for lane L of the kernel's warp and sphere s = 8g + L // 4
    (zero past the range), component t = L % 4: the TF32 (hi, lo) of q_t,
    q = (-2c', k' - MXU_MARGIN (U^2 + W)); Y_t = (1, 1, -MXU_MARGIN,
    tf32(-2 MXU_MARGIN U))[t]; 0; the (hi, lo) of e_t, e = (c', -1); 0, 0.
    U and W are the sphere's ``bound``.  The kernel's products are then a cc
    less its margin, and c'.d - o'.d = -b (``csrc/sweep_mxu.cu``).

    ``frag2`` is the same layout for the bounding spheres of the 8-sphere
    tiles, eight tiles to a row (:func:`mxu_tile_spheres`): its margin
    columns also hold the slack that makes the tile test pass wherever the
    plain twin's discriminant of a member sphere is > 0."""
    if not 0 <= lo < hi <= geo.shape[0]:
        raise ValueError(f"mxu_pack: empty or out-of-range rows [{lo}, {hi})")
    c = geo[lo:hi, 0:3]
    m = c.mean(dim=0)
    cs = c - m
    k = (cs * cs).sum(dim=1) - geo[lo:hi, 7]
    col = lambda v: v[:, None]
    tab = torch.cat([cs, col(k), -2.0 * cs, col(torch.zeros_like(k))], dim=1)
    bound = torch.stack([cs.norm(dim=1), k.abs()], dim=1)
    frag = _mxu_frag(cs, k, torch.full_like(k, -MXU_MARGIN),
                     tf32_round(-2.0 * MXU_MARGIN * bound[:, 0]))
    cg, rho = mxu_tile_spheres(cs, geo[lo:hi, 7], bound)
    kg = (cg * cg).sum(dim=1) - rho * rho
    frag2 = _mxu_frag(
        cg, kg, torch.full_like(kg, -(MXU_MARGIN + MXU_SLACK ** 2)),
        tf32_round(-2.0 * (MXU_MARGIN * cg.norm(dim=1) + MXU_SLACK * rho)))
    return MxuPack(lo, hi, tuple(m.tolist()), tab.contiguous(), frag,
                   bound.contiguous(), frag2)


def mxu_tile_spheres(cs, r2, bound):
    """Bounding spheres of the 8-sphere tiles: (G, 3) centers c'_g (the mean
    of the members') and (G,) radii rho_g = max over the members of |c' -
    c'_g| + r + MXU_SLACK (U + sqrt W), taken in float64 and rounded up:
    where the plain twin's discriminant of a member is > 0 (its rounding is
    below 2^-19 a ((|o'| + U)^2 + W)), the ray passes the tile's center
    closer than rho_g + MXU_SLACK |o'|."""
    n = cs.shape[0]
    G = -(-n // 8)
    idx = torch.arange(n, device=cs.device) // 8
    cg = torch.zeros((G, 3), dtype=cs.dtype, device=cs.device) \
        .index_add_(0, idx, cs) / torch.bincount(idx, minlength=G)[:, None]
    d = cs.double() - cg.double()[idx]
    reach = d.norm(dim=1) + r2.double().sqrt() + MXU_SLACK * (
        bound[:, 0].double() + bound[:, 1].double().sqrt())
    rho = torch.zeros(G, dtype=torch.float64, device=cs.device) \
        .scatter_reduce_(0, idx, reach, "amax")
    return cg, (rho * (1.0 + 2.0 ** -20)).float()


def _check_mxu(rays, geo, lo, hi, pack):
    _check(rays, geo)
    if pack is None:
        pack = mxu_pack(geo, lo, hi)
    G = -(-(hi - lo) // 8)
    for x, shape in ((pack.tab, (hi - lo, 8)), (pack.frag, (G, 32, 8)),
                     (pack.bound, (hi - lo, 2)),
                     (pack.frag2, (-(-G // 8), 32, 8))):
        if (pack.lo, pack.hi) != (lo, hi) or x.device != rays.device \
                or tuple(x.shape) != shape or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError("matrix-product sweep: the pack is not "
                             f"mxu_pack's of rows [{lo}, {hi}) on the rays' "
                             "device")
    return pack


def sweep_sphere_mxu_plain(rays, geo, lo: int, hi: int, t_min: float,
                           pack: MxuPack | None = None):
    """Plain-PyTorch matrix-product sweep over static-sphere rows [lo, hi):
    (best_t, best_i), fp32 products and sums in the order of the TPU
    kernel's packing, -2c' and k' from the pack."""
    pack = _check_mxu(rays, geo, lo, hi, pack)
    sweep_sphere_mxu_plain.calls += 1
    R = rays.shape[1]
    t_min = float(np.float32(t_min))
    best_t = torch.empty((R,), dtype=torch.float32, device=rays.device)
    best_i = torch.empty((R,), dtype=torch.int32, device=rays.device)
    c = pack.tab.T[:, None, :]                                # (8, 1, n)
    for r0 in range(0, R, RAY_CHUNK):
        blk = rays[:, r0:r0 + RAY_CHUNK]
        dx, dy, dz = (blk[3 + i][:, None] for i in range(3))
        ox, oy, oz = (blk[i][:, None] - pack.m[i] for i in range(3))
        a = dx * dx + dy * dy + dz * dz
        inv_a = 1.0 / a
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        cd = dx * c[0] + dy * c[1] + dz * c[2]
        ccp = ox * c[4] + oy * c[5] + oz * c[6] + c[3]
        b = od - cd
        cc = oo + ccp
        disc = b * b - a * cc
        ok = disc > 0.0
        sd = sqrt_rn(torch.clamp(disc, min=0.0))
        t1 = (-b - sd) * inv_a
        t2 = (-b + sd) * inv_a
        t = torch.where(ok & (t1 > t_min), t1,
                        torch.where(ok & (t2 > t_min), t2, INF))
        ct, cidx = torch.min(t, dim=1)             # first index of the minimum
        best_t[r0:r0 + RAY_CHUNK] = ct
        best_i[r0:r0 + RAY_CHUNK] = torch.where(
            ct < INF, cidx.to(torch.int32) + lo, 0)
    return best_t, best_i


sweep_sphere_mxu_plain.calls = 0


def sweep_sphere_mxu(rays, geo, lo: int, hi: int, t_min: float,
                     pack: MxuPack | None = None, stats=None):
    """Closest hit over static-sphere rows [lo, hi) in the matrix-product
    form: the CUDA kernel (tensor cores) for CUDA tensors, the plain version
    for CPU tensors.  ``pack``: :func:`mxu_pack` of the same rows (made here
    when omitted).  ``stats``: an optional (1,) int64 CUDA tensor the kernel
    adds the pairs it retested in scalar to.  Returns (best_t, best_i);
    best_i is 0 where nothing is hit."""
    if not rays.is_cuda:
        return sweep_sphere_mxu_plain(rays, geo, lo, hi, t_min, pack)
    pack = _check_mxu(rays, geo, lo, hi, pack)
    if stats is not None and (tuple(stats.shape) != (1,)
                              or stats.dtype != torch.int64
                              or stats.device != rays.device):
        raise ValueError("stats must be a (1,) int64 on the rays' device")
    fn = load_fn("sweep_mxu", "tr_sweep_mxu", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    R = rays.shape[1]
    best_t = torch.empty((R,), dtype=torch.float32, device=rays.device)
    best_i = torch.empty((R,), dtype=torch.int32, device=rays.device)
    err = fn(rays.data_ptr(), R, pack.tab.data_ptr(), pack.frag.data_ptr(),
             pack.frag2.data_ptr(), hi - lo, lo, *pack.m,
             float(np.float32(t_min)), best_t.data_ptr(), best_i.data_ptr(),
             None if stats is None else stats.data_ptr(),
             torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError("matrix-product sweep kernel launch failed "
                           f"(cudaError {err})")
    sweep_sphere_mxu.launches += 1
    return best_t, best_i


sweep_sphere_mxu.launches = 0


def sweep_solids(rays, geo, ranges, t_min: float,
                 blocks: SweepBlocks | None = None, masked: bool = False,
                 mxu: MxuPack | None = None):
    """Closest solid hit through the sweep a render chose: with ``mxu`` the
    static-sphere range goes through the matrix-product sweep and the other
    ranges through the dense one, merged in range order with a strict '<'
    (sorted or not: the sorted sweeps are bit-equal to the dense one, so the
    result is that of the JAX package's combination); else with ``blocks``
    the sorted sweep (mask-gated if ``masked``, else compacted lists); else
    the dense sweep."""
    if mxu is not None:
        n_ss, n_s, n_sb, n_solid = ranges
        best_t, best_i = sweep_sphere_mxu(rays, geo, 0, n_ss, t_min, mxu)
        if n_solid > n_ss:
            rest_t, rest_i = sweep(rays, geo[n_ss:],
                                   (0, n_s - n_ss, n_sb - n_ss,
                                    n_solid - n_ss), t_min)
            closer = rest_t < best_t
            best_t = torch.where(closer, rest_t, best_t)
            best_i = torch.where(closer, rest_i + n_ss, best_i)
        return best_t, best_i
    if blocks is not None:
        return sweep_sorted(rays, geo, blocks, t_min, masked)
    return sweep(rays, geo, ranges, t_min)
