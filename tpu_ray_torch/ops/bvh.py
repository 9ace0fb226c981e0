"""BVH: host-side build, flattened arrays, and the closest hit by stack
traversal - the CUDA kernel (``csrc/bvh.cu``) and its plain twin.

Port of ``tpu_ray/ops/bvh.py``.  The build runs on the host in numpy
(:func:`prim_aabbs`, :func:`build_bvh`: median split of the centroids on the
largest-extent axis, leaves of at most four prims), as the JAX package's
numpy builder does; its native C++ builder is not ported (the JAX package
falls back to the same numpy code without it).

The JAX package traverses with one XLA ``while_loop`` in lockstep: every
step tests one node per ray, runs the leaf's prims, then pushes the right
child and descends into the left, or pops.  In torch that loop would be
driven from the host, one sync and ~40 launches a node step.  The card's
form of the same function is one ray per thread, which
:func:`intersect_bvh` launches (``csrc/bvh.cu``; no TPU kernel: JAX runs
XLA here).  :func:`intersect_bvh_plain` is the lockstep loop on tensors,
used for CPU tensors and as the reference the kernel is held to; it can
count each ray's node visits and leaf pairs, the work the kernel's bound
counts.

Both return ``(best_t, best_i)`` in the sweep's format (``ops/intersect.py::
intersect_ti``): +inf where nothing is hit, int32 prim ids, media included
(they sit in the tree like solids).  A leaf pair's distance is the sweep's
pair math (``ops/sweep.py::pair_t``, ``csrc/sweep_pairs.cuh``) on the sweep
table's row, a medium's the free flight of ``ops/intersect.py::_media_t``
(``csrc/media.cuh``) with the same per-lane draws, so a pair gives the bits
the brute-force sweep gives it.  Hits are kept by a strict '<' in visit
order, as in the JAX package, so equal-t ties may name another prim than
the sweep's index order does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..models.scene_data import (PRIM_BOX, PRIM_MEDIUM_BOX,
                                 PRIM_MEDIUM_SPHERE, PRIM_QUAD, PRIM_SPHERE,
                                 SceneData)
from .build import load_fn
from .intersect import INF, MED_EPS, _media_t, media_rows
from .shade import build_tables
from .sweep import FLOPS_PER_PAIR, _check_rays, _ranges, pair_t, sweep_table

STACK_DEPTH = 32
LEAF_SIZE = 4
# fp32 operations of one node's slab test (6 subtractions, 6 products, the
# per-axis min / max, their reductions, the clip against (t_min, best_t)
# and the compare) and of one medium's free flight, for the kernel's bound
FLOPS_PER_VISIT = 25
FLOPS_PER_MEDIUM_PAIR = 40


@dataclass(frozen=True)
class BVHArrays:
    """The flattened tree (``tpu_ray/ops/bvh.py::BVHArrays``)."""

    node_min: torch.Tensor   # (M, 3) float32
    node_max: torch.Tensor   # (M, 3) float32
    child_l: torch.Tensor    # (M,) int32 (internal nodes)
    child_r: torch.Tensor    # (M,) int32
    first: torch.Tensor      # (M,) int32 first index into ``order`` (leaves)
    count: torch.Tensor      # (M,) int32 leaf prim count; 0 = internal
    order: torch.Tensor      # (N,) int32 leaf-contiguous prim ids
    n_nodes: int = 1
    leaf_size: int = LEAF_SIZE

    def to(self, device) -> "BVHArrays":
        return replace(self, **{f.name: getattr(self, f.name).to(device)
                                for f in fields(self)
                                if isinstance(getattr(self, f.name),
                                              torch.Tensor)})

    @property
    def device(self) -> torch.device:
        return self.order.device


def prim_aabbs(scene: SceneData, time0: float = 0.0,
               time1: float = 1.0) -> np.ndarray:
    """World-space AABBs (N, 2, 3) float64 of every prim, media included:
    the JAX package's operations on the host copies of the same float32
    arrays."""
    p = {f.name: getattr(scene.prims, f.name).cpu().numpy()
         for f in fields(scene.prims)}
    n = scene.n_prims
    lo = np.full((n, 3), np.inf, np.float64)
    hi = np.full((n, 3), -np.inf, np.float64)

    kind = p["kind"][:n]
    sph = (kind == PRIM_SPHERE) | (kind == PRIM_MEDIUM_SPHERE)
    if sph.any():
        c0 = p["center"][:n] + p["velocity"][:n] * (
            time0 - p["time0"][:n])[:, None]
        c1 = p["center"][:n] + p["velocity"][:n] * (
            time1 - p["time0"][:n])[:, None]
        r = p["radius"][:n][:, None]
        lo[sph] = np.minimum(c0, c1)[sph] - r[sph]
        hi[sph] = np.maximum(c0, c1)[sph] + r[sph]
    quad = kind == PRIM_QUAD
    if quad.any():
        p0, e1, e2 = p["quad_p0"][:n], p["quad_e1"][:n], p["quad_e2"][:n]
        corners = np.stack([p0, p0 + e1, p0 + e2, p0 + e1 + e2])
        # rects are padded by +-epsilon, as the reference's boxes of them
        lo[quad] = corners.min(0)[quad] - MED_EPS
        hi[quad] = corners.max(0)[quad] + MED_EPS
    sbox = kind == PRIM_BOX
    if sbox.any():
        lo[sbox] = p["box_min"][:n][sbox]
        hi[sbox] = p["box_max"][:n][sbox]
    mbox = kind == PRIM_MEDIUM_BOX
    if mbox.any():
        bmin, bmax = p["box_min"][:n], p["box_max"][:n]
        corners = np.stack([
            np.where(np.array(m)[None, :], bmax, bmin)
            for m in np.ndindex(2, 2, 2)
        ])  # (8, N, 3) object-space corners
        world = (np.einsum("nij,knj->kni", p["xf_rot"][:n], corners)
                 + p["xf_off"][:n])
        lo[mbox] = world.min(0)[mbox]
        hi[mbox] = world.max(0)[mbox]
    return np.stack([lo, hi], axis=1)


def build_bvh(scene: SceneData, leaf_size: int = LEAF_SIZE,
              time0: float = 0.0, time1: float = 1.0) -> BVHArrays:
    """Median-split BVH over the prims' AABB centroids (the JAX package's
    numpy build, node for node), on the scene's device."""
    boxes = prim_aabbs(scene, time0, time1)
    n = boxes.shape[0]
    centroids = boxes.mean(axis=1)

    node_min, node_max = [], []
    child_l, child_r, first, count = [], [], [], []
    order: list[int] = []

    def new_node():
        node_min.append(None)
        node_max.append(None)
        child_l.append(-1)
        child_r.append(-1)
        first.append(0)
        count.append(0)
        return len(node_min) - 1

    root = new_node()
    stack = [(root, np.arange(n))]
    while stack:
        node, ids = stack.pop()
        lo = boxes[ids, 0].min(0)
        hi = boxes[ids, 1].max(0)
        node_min[node], node_max[node] = lo, hi
        if len(ids) <= leaf_size:
            first[node] = len(order)
            count[node] = len(ids)
            order.extend(ids.tolist())
            continue
        axis = int(np.argmax(hi - lo))
        key = centroids[ids, axis]
        half = len(ids) // 2
        part = ids[np.argsort(key, kind="stable")]
        l, r = new_node(), new_node()
        child_l[node], child_r[node] = l, r
        stack.append((l, part[:half]))
        stack.append((r, part[half:]))

    dev = scene.device
    f32 = lambda a: torch.from_numpy(np.stack(a).astype(np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(np.array(a, np.int32)).to(dev)
    return BVHArrays(node_min=f32(node_min), node_max=f32(node_max),
                     child_l=i32(child_l), child_r=i32(child_r),
                     first=i32(first), count=i32(count), order=i32(order),
                     n_nodes=len(node_min), leaf_size=leaf_size)


def pack_nodes(bvh: BVHArrays) -> torch.Tensor:
    """The kernel's (M, 8) float32 node rows: min xyz, max xyz, then the
    bits of two int32 words - (child_l, child_r) of an internal node,
    (first, -count) of a leaf - so one node is two 16-byte loads."""
    cnt = bvh.count.cpu().numpy()
    leaf = cnt > 0
    a = np.where(leaf, bvh.first.cpu().numpy(), bvh.child_l.cpu().numpy())
    b = np.where(leaf, -cnt, bvh.child_r.cpu().numpy())
    rows = np.zeros((bvh.n_nodes, 8), np.float32)
    rows[:, 0:3] = bvh.node_min.cpu().numpy()
    rows[:, 3:6] = bvh.node_max.cpu().numpy()
    rows[:, 6] = a.astype(np.int32).view(np.float32)
    rows[:, 7] = b.astype(np.int32).view(np.float32)
    return torch.from_numpy(rows).to(bvh.device)


@dataclass
class BVHTables:
    """What a traversal reads, built once per render: the tree, its packed
    nodes (kernel), the sweep's prim table, the media rows (twin) and the
    (N, 40) prim table whose media rows the kernel reads (None without
    media)."""

    bvh: BVHArrays
    nodes: torch.Tensor
    geo: torch.Tensor
    media: list
    tab: torch.Tensor | None

    @classmethod
    def create(cls, scene: SceneData, bvh: BVHArrays | None = None,
               geo: torch.Tensor | None = None,
               media: list | None = None) -> "BVHTables":
        """Tables on the scene's device; ``bvh`` is built when omitted,
        ``geo`` and ``media`` are the render's sweep table and media rows
        when it already has them."""
        dev = scene.device
        bvh = build_bvh(scene) if bvh is None else bvh.to(dev)
        if bvh.order.shape[0] != scene.n_prims:
            raise ValueError(f"the BVH orders {bvh.order.shape[0]} prims, "
                             f"the scene has {scene.n_prims}")
        tab = (torch.from_numpy(build_tables(scene)[0]).to(dev)
               if scene.has_media else None)
        return cls(bvh=bvh, nodes=pack_nodes(bvh),
                   geo=sweep_table(scene) if geo is None else geo,
                   media=media_rows(scene) if media is None else media,
                   tab=tab)


def _spans(scene: SceneData):
    n_ss, n_s, n_sb, n_solid = _ranges(scene)
    return ((0, n_ss, "sphere"), (n_ss, n_s, "moving"), (n_s, n_sb, "box"),
            (n_sb, n_solid, "quad"))


def _leaf_pairs(scene, tables, rays, media_ts, lanes, pid, t_min, stats):
    """Hit distances (m,) of rays ``lanes`` against prims ``pid`` (one each,
    any kinds): each kind's pair math on its lanes."""
    t = torch.full(pid.shape, INF, dtype=torch.float32, device=rays.device)
    for lo, hi, kind in _spans(scene):
        if hi <= lo:
            continue
        m = (pid >= lo) & (pid < hi)
        n_m = int(m.sum())
        if n_m == 0:
            continue
        li = lanes[m]
        t[m] = pair_t([rays[j][li] for j in range(7)],
                      tables.geo[pid[m]].T, kind, t_min)
        if stats is not None:
            stats[kind] = stats.get(kind, 0) + n_m
    if media_ts is not None:
        m = pid >= scene.n_solid
        n_m = int(m.sum())
        if n_m:
            t[m] = media_ts[pid[m] - scene.n_solid, lanes[m]]
            if stats is not None:
                stats["medium"] = stats.get("medium", 0) + n_m
    return t


def intersect_bvh_plain(scene: SceneData, tables: BVHTables,
                        rays: torch.Tensor, kd, lane_ids,
                        stats: dict | None = None):
    """Plain-PyTorch closest hit by the JAX package's lockstep traversal:
    (best_t (R,) with +inf for no hit, best_i (R,) int32).  Each step runs
    on the rays not yet done.  ``stats``, if given, gets "visits" (node
    slab tests, summed over rays) and the leaf pairs by kind ("sphere",
    "moving", "box", "quad", "medium")."""
    _check_rays(rays)
    intersect_bvh_plain.calls += 1
    R = rays.shape[1]
    dev = rays.device
    bvh = tables.bvh
    best_t = torch.full((R,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return best_t, best_i
    t_min = float(np.float32(scene.t_min))
    t_min_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    media_ts = (torch.stack(_media_t(scene, rays, kd, lane_ids,
                                     tables.media))
                if scene.has_media else None)          # (n_media, R)
    inv = 1.0 / rays[3:6]
    child_l, child_r = bvh.child_l.long(), bvh.child_r.long()
    first, count, order = bvh.first.long(), bvh.count.long(), bvh.order.long()
    node = torch.zeros((R,), dtype=torch.int64, device=dev)
    sp = torch.zeros((R,), dtype=torch.int64, device=dev)
    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    idx = torch.arange(R, device=dev)
    visits = 0
    while idx.numel():
        visits += idx.numel()
        n = node[idx]
        o, iv = rays[0:3, idx], inv[:, idx]
        ta = (bvh.node_min[n].T - o) * iv
        tb = (bvh.node_max[n].T - o) * iv
        lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
        tn = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
        tf = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
        # slab test clipped to (t_min, best_t); NaN fails it
        hit = torch.minimum(tf, best_t[idx]) > torch.maximum(tn, t_min_t)
        cnt = count[n]
        leaf = cnt > 0
        do_leaf = hit & leaf
        for k in range(bvh.leaf_size):
            sel = do_leaf & (cnt > k)
            li = idx[sel]
            if li.numel() == 0:
                break
            pid = order[first[n[sel]] + k]
            t = _leaf_pairs(scene, tables, rays, media_ts, li, pid, t_min,
                            stats)
            bt = best_t[li]
            closer = t < bt
            best_t[li] = torch.where(closer, t, bt)
            best_i[li] = torch.where(closer, pid.to(torch.int32), best_i[li])
        descend = hit & ~leaf
        spn = sp[idx]
        # push the right child and descend into the left; everyone else
        # pops, or is done on an empty stack
        d = idx[descend]
        dn = n[descend]
        stack[d, spn[descend].clamp(max=STACK_DEPTH - 1)] = child_r[dn]
        sp[d] = spn[descend] + 1
        node[d] = child_l[dn]
        pop = ~descend & (spn > 0)
        p = idx[pop]
        sp_p = spn[pop] - 1
        sp[p] = sp_p
        node[p] = stack[p, sp_p.clamp(max=STACK_DEPTH - 1)]
        idx = idx[descend | pop]
    if stats is not None:
        stats["visits"] = stats.get("visits", 0) + visits
        stats["rays"] = stats.get("rays", 0) + R
    return best_t, best_i


intersect_bvh_plain.calls = 0


def intersect_bvh(scene: SceneData, tables: BVHTables, rays: torch.Tensor,
                  kd, lane_ids):
    """Closest hit of every ray by BVH traversal: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``rays``: (7, R) float32
    rows (origin, direction, time); ``kd``: the intersect key's two words;
    ``lane_ids``: (R,) int32 ids keying the media draws.  Returns
    (best_t, best_i)."""
    if not rays.is_cuda:
        return intersect_bvh_plain(scene, tables, rays, kd, lane_ids)
    return intersect_bvh_launch(scene, tables, rays, kd, lane_ids)


intersect_bvh.launches = 0


def intersect_bvh_launch(scene: SceneData, tables: BVHTables,
                         rays: torch.Tensor, kd, lane_ids):
    """The traversal kernel on CUDA tensors; counts into
    ``intersect_bvh.launches``.  Returns (best_t, best_i)."""
    _check_rays(rays)
    R = rays.shape[1]
    dev = rays.device
    need = [rays, tables.nodes, tables.bvh.order, tables.geo, lane_ids]
    if tables.tab is not None:
        need.append(tables.tab)
    if any(not x.is_cuda or x.device != dev for x in need):
        raise ValueError("the BVH kernel takes CUDA tensors on one device")
    if lane_ids.dtype != torch.int32 or lane_ids.shape != (R,) \
            or not lane_ids.is_contiguous():
        raise ValueError("lane_ids must be a contiguous (R,) int32 tensor")
    if tables.bvh.leaf_size > STACK_DEPTH or tables.nodes.shape[1] != 8:
        raise ValueError("malformed BVH tables")
    if scene.has_media and tables.tab is None:
        raise ValueError("a scene with media needs the (N, 40) prim table")
    fn = load_fn("bvh", "tr_bvh", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    best_t = torch.empty((R,), dtype=torch.float32, device=dev)
    best_i = torch.empty((R,), dtype=torch.int32, device=dev)
    n_ss, n_s, n_sb, n_solid = _ranges(scene)
    err = fn(rays.data_ptr(), R, tables.nodes.data_ptr(),
             tables.bvh.order.data_ptr(),
             tables.geo.data_ptr() if n_solid else None,
             tables.tab.data_ptr() if tables.tab is not None else None,
             n_ss, n_s, n_sb, n_solid, float(np.float32(scene.t_min)),
             int(kd[0]) & 0xFFFFFFFF, int(kd[1]) & 0xFFFFFFFF,
             lane_ids.data_ptr(), int(bool(scene.any_transform)),
             tables.bvh.leaf_size, best_t.data_ptr(), best_i.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"BVH kernel launch failed (cudaError {err})")
    intersect_bvh.launches += 1
    return best_t, best_i


def traversal_flops(stats: dict) -> float:
    """fp32 operations of the traversal the twin counted in ``stats``: its
    node visits and its leaf pairs by kind."""
    pairs = sum(stats.get(k, 0) * FLOPS_PER_PAIR[k]
                for k in ("sphere", "moving", "box", "quad"))
    return (stats.get("visits", 0) * FLOPS_PER_VISIT + pairs
            + stats.get("medium", 0) * FLOPS_PER_MEDIUM_PAIR)
