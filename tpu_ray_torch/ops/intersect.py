"""Closest hit of a wavefront against the whole scene.

Port of ``tpu_ray/ops/intersect.py::intersect_ti``: solids go through the
closest-hit sweep (:mod:`tpu_ray_torch.ops.sweep` - the CUDA kernel on the
card), constant media through the free-flight math of ``_chunk_t`` (the
media kernel of ``csrc/media.cu`` on the card, :func:`merge_media_plain`
on the CPU), and the two are min-combined with a strict '<' in the order
solids, then media.  The JAX package keeps media outside its sweep
kernels, in the XLA program around them; the whole-wave megakernel and
the BVH kernel run the same free flight (``csrc/media.cuh``) inside.

Constant media draw their free-flight distance from one uniform per
(ray, medium), keyed by (intersect key words, lane id) - the
``lane_uniforms`` stream - so a lane's draws do not depend on its position.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng
from ..core.vec import sqrt_rn
from ..models.scene_data import PRIM_MEDIUM_SPHERE, SceneData
from .build import load_fn
from .sweep import (MxuPack, SweepBlocks, _check_rays, _ranges, sweep_solids,
                    sweep_table)

INF = float("inf")
MED_EPS = 1e-4
# a medium's row of the (N, 40) prim table (ops/shade.py::build_tables),
# the layout csrc/media.cuh reads: kind col 0, centre or box min cols 2:5,
# box max 5:8, -1/density 8, radius 9, offset 10:13, rotation 30:39
MEDIA_COLS = 40
# the media kernel stages every medium row in 48 KB of shared memory
MAX_MEDIA = 256
# operations of the media merge (csrc/media.cu's bound), each hash word
# operation and each log counted as one: a lane's |d|^2, 1/|d|^2, root and
# stream base; each medium's boundary (sphere; box; box in its own frame),
# clip, draw, log, flight and strict-'<' merge
MEDIA_LANE_OPS = 17
MEDIA_OPS = {"sphere": 61, "box": 63, "box_xf": 96}


def pack_rays(ro: torch.Tensor, rd: torch.Tensor, rt: torch.Tensor):
    """(R, 3), (R, 3), (R,) rays as the sweep's (7, R) row layout."""
    return torch.cat([ro.T, rd.T, rt[None]], dim=0).contiguous()


class MediaRows(list):
    """:func:`media_rows`: one dict of python floats a medium (read by the
    plain twin), and on the scene's device ``table``, the media rows of
    the (N, 40) prim table, and ``slots``, each medium's draw column
    (int32), which the media kernel reads."""

    table: torch.Tensor
    slots: torch.Tensor


def media_rows(scene: SceneData) -> MediaRows:
    """Host copy of the media rows' parameters (python floats of the
    float32 values) and their device table, made once per render."""
    p = scene.prims
    sl = slice(scene.n_solid, scene.n_prims)
    host = {k: getattr(p, k)[sl].cpu().numpy()
            for k in ("kind", "center", "radius", "box_min", "box_max",
                      "xf_rot", "xf_off", "neg_inv_density", "medium_slot")}
    n = scene.n_prims - scene.n_solid
    rows = MediaRows()
    tab = np.zeros((n, MEDIA_COLS), np.float32)
    for j in range(n):
        r = host["radius"][j]
        rows.append(dict(
            kind=int(host["kind"][j]), center=host["center"][j].tolist(),
            r2=float(r * r), box_min=host["box_min"][j].tolist(),
            box_max=host["box_max"][j].tolist(),
            rot=host["xf_rot"][j].tolist(), off=host["xf_off"][j].tolist(),
            nid=float(host["neg_inv_density"][j]),
            slot=int(host["medium_slot"][j])))
        sphere = rows[-1]["kind"] == PRIM_MEDIUM_SPHERE
        tab[j, 0] = rows[-1]["kind"]
        tab[j, 2:5] = host["center" if sphere else "box_min"][j]
        tab[j, 5:8] = host["box_max"][j]
        tab[j, 8] = host["neg_inv_density"][j]
        tab[j, 9] = r
        tab[j, 10:13] = host["xf_off"][j]
        tab[j, 30:39] = np.reshape(host["xf_rot"][j], 9)
    rows.table = torch.from_numpy(tab).to(scene.device)
    rows.slots = torch.from_numpy(host["medium_slot"].astype(np.int32)).to(
        scene.device)
    return rows


def _media_t(scene: SceneData, rays: torch.Tensor, kd, lane_ids, media):
    """Free-flight hit distance (R,) of each media row, with ``_chunk_t``'s
    media math (each medium against t_max = +inf)."""
    ox, oy, oz, dx, dy, dz = (rays[i] for i in range(6))
    t_min = float(np.float32(scene.t_min))
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    dlen = sqrt_rn(a)
    u_med = rng.lane_uniforms(kd, lane_ids, scene.n_media)
    out = []
    for m in media:
        if m["kind"] == PRIM_MEDIUM_SPHERE:
            c = m["center"]
            ocx, ocy, ocz = ox - c[0], oy - c[1], oz - c[2]
            b = ocx * dx + ocy * dy + ocz * dz
            cq = ocx * ocx + ocy * ocy + ocz * ocz - m["r2"]
            disc = b * b - a * cq
            sd = sqrt_rn(torch.clamp(disc, min=0.0))
            te = (-b - sd) * inv_a
            tx = (-b + sd) * inv_a
            exists = disc > 0.0
        else:
            if scene.any_transform:
                rot, off = m["rot"], m["off"]
                w = (ox - off[0], oy - off[1], oz - off[2])
                d = (dx, dy, dz)
                # object-frame ray: x_o = R^T (x_w - off)
                ro_o = [rot[0][q] * w[0] + rot[1][q] * w[1] + rot[2][q] * w[2]
                        for q in range(3)]
                rd_o = [rot[0][q] * d[0] + rot[1][q] * d[1] + rot[2][q] * d[2]
                        for q in range(3)]
            else:
                ro_o, rd_o = [ox, oy, oz], [dx, dy, dz]
            tn, tf = [], []
            for q in range(3):
                inv = 1.0 / rd_o[q]
                ta = (m["box_min"][q] - ro_o[q]) * inv
                tb = (m["box_max"][q] - ro_o[q]) * inv
                tn.append(torch.minimum(ta, tb))
                tf.append(torch.maximum(ta, tb))
            te = torch.maximum(torch.maximum(tn[0], tn[1]), tn[2])
            tx = torch.minimum(torch.minimum(tf[0], tf[1]), tf[2])
            exists = tx > te
        exists = exists & (tx > te + MED_EPS)
        rec1 = torch.clamp(te, min=t_min)
        dist_inside = (tx - rec1) * dlen
        hit_dist = m["nid"] * torch.log(torch.clamp(u_med[:, m["slot"]],
                                                    min=1e-12))
        ok = exists & (rec1 < tx) & (hit_dist <= dist_inside)
        out.append(torch.where(ok, rec1 + hit_dist / dlen, INF))
    return out


def merge_media_plain(scene: SceneData, rays, kd, lane_ids, media, best_t,
                      best_i):
    """Min-combine the solids' (best_t, best_i) with every medium's free
    flight, in row order with a strict '<': the media kernel's plain
    twin."""
    merge_media_plain.calls += 1
    for j, t in enumerate(_media_t(scene, rays, kd, lane_ids, media)):
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, scene.n_solid + j, best_i)
    return best_t, best_i


merge_media_plain.calls = 0


def merge_media(scene: SceneData, rays, kd, lane_ids, media: MediaRows,
                best_t, best_i):
    """Min-combine the solids' (best_t, best_i) with every medium's free
    flight: the media kernel (:func:`merge_media_launch`) for CUDA tensors,
    :func:`merge_media_plain` for CPU tensors.  ``rays``: (7, R) float32
    rows; ``kd``: the intersect key's two words; ``lane_ids``: (R,) int32
    ids keying the draws; ``media``: :func:`media_rows` of the scene."""
    if not rays.is_cuda:
        return merge_media_plain(scene, rays, kd, lane_ids, media, best_t,
                                 best_i)
    return merge_media_launch(scene, rays, kd, lane_ids, media, best_t,
                              best_i)


merge_media.launches = 0


def merge_media_launch(scene: SceneData, rays, kd, lane_ids,
                       media: MediaRows, best_t, best_i):
    """The media kernel (``csrc/media.cu``) on CUDA tensors, one launch into
    fresh (best_t, best_i); counts into ``merge_media.launches``."""
    _check_rays(rays)
    R = rays.shape[1]
    dev = rays.device
    n_media = scene.n_prims - scene.n_solid
    if not rays.is_cuda or not isinstance(media, MediaRows) \
            or media.table.device != dev or media.slots.device != dev:
        raise ValueError("the media kernel takes CUDA tensors on one device "
                         "and media_rows() of the scene")
    for x, dtype in ((lane_ids, torch.int32), (best_t, torch.float32),
                     (best_i, torch.int32)):
        if x.dtype != dtype or tuple(x.shape) != (R,) \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"media kernel: expected a contiguous ({R},) "
                             f"{dtype} on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if tuple(media.table.shape) != (n_media, MEDIA_COLS) \
            or n_media > MAX_MEDIA:
        raise ValueError(f"the media kernel takes up to {MAX_MEDIA} (n, "
                         f"{MEDIA_COLS}) media rows, got "
                         f"{tuple(media.table.shape)}")
    fn = load_fn("media", "tr_media", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    out_t = torch.empty_like(best_t)
    out_i = torch.empty_like(best_i)
    err = fn(rays.data_ptr(), R, lane_ids.data_ptr(), int(kd[0]) & rng.M32,
             int(kd[1]) & rng.M32, media.table.data_ptr(),
             media.slots.data_ptr(), n_media, scene.n_solid,
             int(scene.any_transform), float(np.float32(scene.t_min)),
             best_t.data_ptr(), best_i.data_ptr(), out_t.data_ptr(),
             out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"media kernel launch failed (cudaError {err})")
    merge_media.launches += 1
    return out_t, out_i


def media_ops(media: MediaRows, any_transform: bool) -> int:
    """Operations of the media merge a lane (``MEDIA_LANE_OPS`` and each
    medium's ``MEDIA_OPS``), for the kernel's bound."""
    return MEDIA_LANE_OPS + sum(
        MEDIA_OPS["sphere" if m["kind"] == PRIM_MEDIUM_SPHERE else
                  "box_xf" if any_transform else "box"] for m in media)


def intersect_ti(scene: SceneData, rays: torch.Tensor, kd, lane_ids,
                 geo: torch.Tensor | None = None, media: list | None = None,
                 blocks: SweepBlocks | None = None, masked: bool = False,
                 mxu: MxuPack | None = None):
    """(best_t, best_i) of each ray's closest hit; ``best_t`` is +inf where
    nothing is hit.

    ``rays``: (7, R) float32 rows (origin, direction, time); ``kd``: the
    intersect key's two words (feed the media free-flight draws);
    ``lane_ids``: (R,) slot ids keying those draws; ``geo`` / ``media``:
    the sweep's prim table and :func:`media_rows` (built from the scene
    when omitted; a render builds them once).  With ``blocks``
    (:func:`~tpu_ray_torch.ops.sweep.sweep_blocks`) the solids go through
    the sorted sweep over them instead of the dense one (the JAX package's
    ``sort=True``), by compacted lists or, with ``masked``, the mask-gated
    kernel - the same ``(best_t, best_i)`` bit for bit.  With ``mxu``
    (:func:`~tpu_ray_torch.ops.sweep.mxu_pack` of the static spheres) that
    range goes through the matrix-product sweep.
    """
    R = rays.shape[1]
    if scene.n_solid > 0:
        if geo is None:
            geo = sweep_table(scene)
        best_t, best_i = sweep_solids(rays, geo, _ranges(scene), scene.t_min,
                                      blocks, masked, mxu)
    else:
        best_t = torch.full((R,), INF, dtype=torch.float32,
                            device=rays.device)
        best_i = torch.zeros((R,), dtype=torch.int32, device=rays.device)
    if scene.has_media:
        if media is None:
            media = media_rows(scene)
        best_t, best_i = merge_media(scene, rays, kd, lane_ids, media,
                                     best_t, best_i)
    return best_t, best_i
