"""BVH: host-side build, flattened arrays, and the closest hit by stack
traversal - the CUDA kernel (``csrc/bvh.cu``) and its plain twins.

Port of ``tpu_ray/ops/bvh.py``.  The build runs on the host in numpy
(:func:`prim_aabbs`, :func:`build_bvh`: median split of the centroids on the
largest-extent axis, leaves of at most four prims), as the JAX package's
numpy builder does; its native C++ builder is not ported (the JAX package
falls back to the same numpy code without it).

The JAX package traverses with one XLA ``while_loop`` in lockstep: every
step tests one node per ray, runs the leaf's prims, then pushes the right
child and descends into the left, or pops.  In torch that loop would be
driven from the host, one sync and ~40 launches a node step.  The card's
form of the same function is a ray per thread walking its own path, which
:func:`intersect_bvh` launches (``csrc/bvh.cu``; no TPU kernel: JAX runs
XLA here) over the tree packed per rule (:func:`pack_nodes`): pair records
for ``VISIT`` (both children's boxes in one record), four-wide records for
``INDEX`` (up to four descendants' boxes in one record, the tree still
``build_bvh``'s node for node).

The kernel has two tie rules, one template parameter:

- ``VISIT`` (``bvh=True``): the JAX traversal's function - left-first
  visits, its strict node test, hits kept by a strict '<' in visit order,
  so equal-t ties may name another prim than the sweep's index order.
  Its plain twin :func:`intersect_bvh_plain` is the lockstep loop on
  tensors; it can count each ray's node visits and leaf pairs.
- ``INDEX``: the dense sweep's function (``ops/intersect.py::
  intersect_ti``: the sweep, then the media merge) - on equal t the lower
  prim id wins, media ids after the solids.  Its node test is
  conservative (:func:`index_margins`), so it tests every prim the sweep
  could pick; its plain twin is ``intersect_ti`` itself.  Above
  ``integrator.BVH_ROUTE_MIN_PRIMS`` prims the default closest hit on the
  card takes it.

Both return ``(best_t, best_i)`` in the sweep's format: +inf where nothing
is hit, int32 prim ids, media included (they sit in the tree like solids).
A leaf pair's distance is the sweep's pair math (``ops/sweep.py::pair_t``,
``csrc/sweep_pairs.cuh``) on the sweep table's row, a medium's the free
flight of ``ops/intersect.py::_media_t`` (``csrc/media.cuh``) with the same
per-lane draws, so a pair gives the bits the brute-force sweep gives it.
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
from .intersect import INF, MED_EPS, _media_t, intersect_ti, media_rows
from .shade import build_tables
from .sweep import FLOPS_PER_PAIR, _check_rays, _ranges, pair_t, sweep_table

STACK_DEPTH = 32
LEAF_SIZE = 4
WIDTH = 4                       # children a rule-INDEX record holds at most
# rule INDEX's stack: a record pushes at most WIDTH - 1 entries and each
# record on a path from the root is another internal node of the build on
# that path, so a tree at most STACK_DEPTH internal nodes deep fits
INDEX_STACK = (WIDTH - 1) * STACK_DEPTH
VISIT, INDEX = "visit", "index"      # the kernel's tie rules
# fp32 operations of one node's slab test (6 subtractions, 6 products, the
# per-axis min / max, their reductions, the clip against (t_min, best_t)
# and the compare) and of one medium's free flight, for the kernel's bound
FLOPS_PER_VISIT = 25
FLOPS_PER_MEDIUM_PAIR = 40
# the kernel's work per child box tested (rule INDEX adds the per-ray
# margin: 3 differences, 2 maxima, the add of h, m = l (A l + B) and the
# 6 widened faces) and per stack entry popped (a min and the compare)
FLOPS_PER_CHILD = {VISIT: FLOPS_PER_VISIT, INDEX: FLOPS_PER_VISIT + 15}
FLOPS_PER_POP = 2
# rule INDEX's margins (index_margins), in units of u = 2^-24
_U = 2.0 ** -24
MARGIN_QUAD = 128 * _U      # over the least sphere radius: A
MARGIN_LINEAR = 64 * _U     # B
MARGIN_ABS = 128 * _U       # times |centre| + half diagonal, static
# the counts of the kernel's counting form (stats=): records expanded,
# root tests, stack entries popped, pairs by kind, rays that ran out of
# their record budget and tested every prim, child boxes tested (the root
# tests among them), each warp's loop trips (one a trip of the lanes that
# run it together) and the lanes that ran those trips: lane_steps / (32 x
# warp_steps) is the walk's SIMD share
STAT_KEYS = ("records", "roots", "pops", "sphere", "moving", "box", "quad",
             "medium", "brute", "children", "warp_steps", "lane_steps")


def record_budget(n_prims: int) -> int:
    """The internal nodes of the build a lane may expand under rule
    ``INDEX`` before it runs the sweep's loop over every prim instead
    (``csrc/bvh.cu``; a wide record counts the internal nodes it covers,
    its children less one): a ray expands 2-25 on average (chip_smoke.py
    phase 3's counts per ray), but one that starts far from small spheres,
    as one inside book1-final's r = 1000 ground sphere does, has margins
    that swallow them all."""
    return max(64, n_prims // 8)


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


def _post_order_boxes(bvh: BVHArrays, lo: np.ndarray, hi: np.ndarray,
                      rad: np.ndarray):
    """Each node's float64 box and least sphere radius over its subtree,
    from the prims' ``lo`` / ``hi`` (N, 3) and ``rad`` (N,; +inf for a prim
    that is not a sphere).  Children follow their parent in the build's
    node order, so one pass from the last node up fills every node."""
    cl, cr = bvh.child_l.cpu().numpy(), bvh.child_r.cpu().numpy()
    first, count = bvh.first.cpu().numpy(), bvh.count.cpu().numpy()
    order = bvh.order.cpu().numpy()
    M = bvh.n_nodes
    nlo, nhi = np.empty((M, 3)), np.empty((M, 3))
    rmin = np.empty(M)
    for n in range(M - 1, -1, -1):
        if count[n] > 0:
            ids = order[first[n]:first[n] + count[n]]
            nlo[n], nhi[n] = lo[ids].min(0), hi[ids].max(0)
            rmin[n] = rad[ids].min()
        else:
            a, b = cl[n], cr[n]
            if not (a > n and b > n):
                raise ValueError("BVH children must follow their parent")
            nlo[n] = np.minimum(nlo[a], nlo[b])
            nhi[n] = np.maximum(nhi[a], nhi[b])
            rmin[n] = min(rmin[a], rmin[b])
    return nlo, nhi, rmin


def _up(x) -> np.ndarray:
    """float32 of ``x`` (float64), rounded up."""
    return np.nextafter(np.asarray(x, np.float64).astype(np.float32),
                        np.float32(np.inf))


def index_margins(scene: SceneData, bvh: BVHArrays):
    """Rule ``INDEX``'s boxes: each node's float32 box widened outward, and
    the terms of the per-ray margin the kernel adds (``csrc/bvh.cu``).

    A node may be culled only if no prim under it can give a hit the dense
    sweep would keep.  A prim's reported hit point can lie outside its
    float64 box (``prim_aabbs``) by rounding: a grazing ray can hit a
    sphere it misses by up to ~9.5 u (L + r)^2 / r (u = 2^-24, L the
    origin's distance to the centre; the quadratic's ``c`` and ``b`` carry
    errors of order u L^2), and a quad's plane and (u, v) test, a medium's
    frame and free flight, and the node's own slab test are off by a few u
    times the coordinates.  So a node's box is widened in two parts:

    - statically, by ``MARGIN_ABS`` x (|centre| + half diagonal) - the
      errors that grow with the coordinates - and rounded outward to
      float32 (``nextafter``), which also covers the float32 rounding of
      the float64 boxes and the quads past their ``MED_EPS`` pad;
    - per ray, by m = l (A l + B), l = max_i |o_i - c_i| + h (an L-infinity
      bound on the origin's distance to any point of the box: c its
      centre, h its largest half width, so L + r <= sqrt(3) l), A =
      ``MARGIN_QUAD`` / (least sphere radius under the node; 0 without
      spheres), B = ``MARGIN_LINEAR``.

    Each margin is three to four times the error it covers.  A box that is
    too wide costs visits, never bits.  Returns float32 ``lo``, ``hi`` (M,
    3), ``c`` (M, 3), ``h`` (M,) and ``A`` (M,), and the float64 surface
    area (M,) of each node's unwidened float64 box, by which
    :func:`pack_nodes` widens the records."""
    boxes = prim_aabbs(scene)
    kind = scene.prims.kind[:scene.n_prims].cpu().numpy()
    sph = (kind == PRIM_SPHERE) | (kind == PRIM_MEDIUM_SPHERE)
    rad = np.where(sph, scene.prims.radius[:scene.n_prims].cpu().numpy()
                   .astype(np.float64), np.inf)
    lo64, hi64, rmin = _post_order_boxes(bvh, boxes[:, 0], boxes[:, 1], rad)
    c64 = 0.5 * (lo64 + hi64)
    pad = MARGIN_ABS * (np.linalg.norm(c64, axis=1)
                        + 0.5 * np.linalg.norm(hi64 - lo64, axis=1))
    lo = np.nextafter((lo64 - pad[:, None]).astype(np.float32),
                      np.float32(-np.inf))
    hi = _up(hi64 + pad[:, None])
    c = (0.5 * (lo.astype(np.float64) + hi)).astype(np.float32)
    h = _up(np.maximum(hi - c.astype(np.float64),
                       c - lo.astype(np.float64)).max(1))
    A = np.where(np.isfinite(rmin), _up(MARGIN_QUAD / rmin), np.float32(0))
    d = hi64 - lo64
    area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
    return lo, hi, c, h, A.astype(np.float32), area


def tree_depth(bvh: BVHArrays) -> int:
    """The most internal nodes on a path from the root to a leaf: the
    kernel's stack never holds more entries (each internal ancestor of
    the current node pushes at most one)."""
    cl, cr = bvh.child_l.cpu().numpy(), bvh.child_r.cpu().numpy()
    count = bvh.count.cpu().numpy()
    depth, todo = 0, [(0, 0)]
    while todo:
        n, d = todo.pop()
        if count[n] > 0:
            depth = max(depth, d)
        else:
            todo += [(cl[n], d + 1), (cr[n], d + 1)]
    return depth


def wide_children(bvh: BVHArrays, area: np.ndarray,
                  width: int = WIDTH) -> dict:
    """Each kept internal node's record children under rule ``INDEX``:
    {node: [child nodes]}, for the root (when internal) and every internal
    node that is a child of a record.  A record starts from its node's two
    children; while it has fewer than ``width`` and one of them is
    internal, that child is replaced, in its place, by its own two
    children: the internal child of largest ``area`` (float64 surface area
    of its box), the lower node index on a tie.  A leaf is never replaced,
    so a record holds 2 to ``width`` children, as many as its internal
    grandchildren allow, and its children cover its node's subtree in the
    build's left-to-right order.  ``width`` 2 keeps the binary tree, one
    record a node (the pair walk)."""
    cl, cr = bvh.child_l.cpu().numpy(), bvh.child_r.cpu().numpy()
    internal = bvh.count.cpu().numpy() == 0
    out = {}
    todo = [0] if internal[0] else []
    while todo:
        n = todo.pop()
        kids = [int(cl[n]), int(cr[n])]
        while len(kids) < width:
            inner = [k for k in kids if internal[k]]
            if not inner:
                break
            x = max(inner, key=lambda k: (area[k], -k))
            i = kids.index(x)
            kids[i:i + 1] = [int(cl[x]), int(cr[x])]
        out[n] = kids
        todo += [k for k in reversed(kids) if internal[k]]
    return out


def pack_nodes(bvh: BVHArrays, rule: str = VISIT,
               scene: SceneData | None = None,
               width: int = WIDTH) -> torch.Tensor:
    """The kernel's records of the tree for one tie rule.  Per child, three
    float4s - (min xyz, ref), (max xyz, A), (c xyz, h).  A ref is the bits
    of an int32: a record index (> 0) for an internal child, ~(first << 3
    | count) (< 0) for a leaf, 0 for an empty slot.

    - ``VISIT``: pair records, (1 + internal nodes, 24) float32: record k
      holds both children of one internal node, left child first, so one
      fetch tests both; the kernel reads the first two float4s of each
      child (the JAX build's float32 boxes, node for node; A, c, h are 0)
      and the (c, h) pairs sit together at the end.  Internal node n of
      the build is record 1 + its rank among the internal nodes.
    - ``INDEX``: wide records, (1 + kept internal nodes, 12 x ``WIDTH``)
      float32, slot after slot: record k holds the children
      :func:`wide_children` gives its node (2 to ``width``; empty slots
      all zero, at the end), each with the boxes and margins of
      :func:`index_margins` (which needs the scene), so one record tests
      up to four boxes at once.  Records run in depth-first order of the
      kept nodes, a record's children's records after it.  ``width`` 2
      packs the pair walk into the same format (chip_smoke.py counts it
      beside the wide walk).

    Record 0 holds the root as its first child, the rest of it unused."""
    if bvh.leaf_size > 7:
        raise ValueError("leaves of at most 7 prims fit a child ref")
    cl, cr = bvh.child_l.cpu().numpy(), bvh.child_r.cpu().numpy()
    first, count = bvh.first.cpu().numpy(), bvh.count.cpu().numpy()
    internal = count == 0
    M = bvh.n_nodes
    if rule == VISIT:
        lo, hi = bvh.node_min.cpu().numpy(), bvh.node_max.cpu().numpy()
        A, c, h = (np.zeros(M, np.float32), np.zeros((M, 3), np.float32),
                   np.zeros(M, np.float32))
        rec = np.cumsum(internal) * internal      # record of internal node n
    elif rule == INDEX:
        if scene is None:
            raise ValueError("rule INDEX packs the scene's margins")
        lo, hi, c, h, A, area = index_margins(scene, bvh)
        kids = wide_children(bvh, area, width)
        rec = np.zeros(M, np.int64)
        rec[list(kids)] = 1 + np.arange(len(kids))
    else:
        raise ValueError(f"unknown tie rule {rule!r}")
    ref = np.where(internal, rec, ~((first << 3) | count)).astype(np.int32)
    # per node, its 12 floats as a child: (min, ref), (max, A), (c, h)
    child = np.zeros((M, 12), np.float32)
    child[:, 0:3], child[:, 4:7], child[:, 8:11] = lo, hi, c
    child[:, 3] = ref.view(np.float32)
    child[:, 7], child[:, 11] = A, h
    if rule == INDEX:
        rows = np.zeros((1 + len(kids), 12 * WIDTH), np.float32)
        rows[0, 0:12] = child[0]
        for k, ks in enumerate(kids.values(), 1):
            rows[k, :12 * len(ks)] = child[ks].reshape(-1)
        return torch.from_numpy(rows).to(bvh.device)
    ids = np.flatnonzero(internal)
    rows = np.zeros((1 + ids.size, 24), np.float32)
    rows[0, 0:8], rows[0, 16:20] = child[0, 0:8], child[0, 8:12]
    for half, kids in ((0, cl[ids]), (8, cr[ids])):
        rows[1:, half:half + 8] = child[kids, 0:8]
        rows[1:, 16 + half // 2:20 + half // 2] = child[kids, 8:12]
    return torch.from_numpy(rows).to(bvh.device)


def wide_stack_bound(rows: np.ndarray) -> int:
    """The most entries rule ``INDEX``'s stack can hold over the wide
    records ``rows`` (:func:`pack_nodes`): the most, over the paths from
    the root record to a leaf, of the entries each record on the path
    pushes (its children less one).  A record's child records follow it,
    so one pass from the last record up fills every record."""
    width = rows.shape[1] // 12
    refs = np.ascontiguousarray(rows[:, 3::12]).view(np.int32)
    below = np.zeros(rows.shape[0], np.int64)
    for k in range(rows.shape[0] - 1, 0, -1):
        live = refs[k][refs[k] != 0]
        inner = live[live > 0]
        if not (inner > k).all() or live.size > width:
            raise ValueError("malformed wide records")
        below[k] = live.size - 1 + (below[inner].max() if inner.size else 0)
    root = int(refs[0, 0])
    return int(below[root]) if root > 0 else 0


@dataclass
class BVHTables:
    """What a traversal reads, built once per render: the tree, its records
    for one tie rule (kernel), the sweep's prim table, the media rows
    (twin), the (N, 40) prim table whose media rows the kernel reads (None
    without media) and the most entries the rule's walk can hold on its
    stack (at least 1): the tree's internal depth under ``VISIT``,
    :func:`wide_stack_bound` under ``INDEX``."""

    bvh: BVHArrays
    nodes: torch.Tensor
    geo: torch.Tensor
    media: list
    tab: torch.Tensor | None
    rule: str = VISIT
    stack: int = 1

    @classmethod
    def create(cls, scene: SceneData, bvh: BVHArrays | None = None,
               geo: torch.Tensor | None = None,
               media: list | None = None, rule: str = VISIT) -> "BVHTables":
        """Tables on the scene's device; ``bvh`` is built when omitted,
        ``geo`` and ``media`` are the render's sweep table and media rows
        when it already has them.  ``rule``: ``VISIT`` (the JAX package's
        traversal, ``bvh=True``) or ``INDEX`` (the dense sweep's
        function)."""
        dev = scene.device
        bvh = build_bvh(scene) if bvh is None else bvh.to(dev)
        if bvh.order.shape[0] != scene.n_prims:
            raise ValueError(f"the BVH orders {bvh.order.shape[0]} prims, "
                             f"the scene has {scene.n_prims}")
        nodes = pack_nodes(bvh, rule, scene)
        if rule == INDEX:
            stack = wide_stack_bound(nodes.cpu().numpy())
            if stack > INDEX_STACK:
                raise ValueError(f"a BVH whose wide walk holds {stack} "
                                 f"stack entries overflows the kernel's "
                                 f"{INDEX_STACK}")
        else:
            stack = tree_depth(bvh)
            if stack > STACK_DEPTH:
                raise ValueError(f"a BVH {stack} internal nodes deep "
                                 f"overflows the JAX traversal's "
                                 f"{STACK_DEPTH}-entry stack")
        tab = (torch.from_numpy(build_tables(scene)[0]).to(dev)
               if scene.has_media else None)
        return cls(bvh=bvh, nodes=nodes,
                   geo=sweep_table(scene) if geo is None else geo,
                   media=media_rows(scene) if media is None else media,
                   tab=tab, rule=rule, stack=max(stack, 1))


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
                  kd, lane_ids, words: torch.Tensor | None = None):
    """Closest hit of every ray by BVH traversal under ``tables.rule``: the
    CUDA kernel for CUDA tensors; for CPU tensors the plain twin of the
    rule (:func:`intersect_bvh_plain` for ``VISIT``, ``intersect_ti`` for
    ``INDEX``).  ``rays``: (7, R) float32 rows (origin, direction, time);
    ``kd``: the intersect key's two words; ``lane_ids``: (R,) int32 ids
    keying the media draws; ``words``: a work-queue render's block
    (``ops/queue.py::render_words``) on the card, whose intersect key words
    the kernel reads instead of ``kd`` (the twins take ``kd``).  Returns
    (best_t, best_i)."""
    if not rays.is_cuda:
        if tables.rule == INDEX:
            return intersect_ti(scene, rays, kd, lane_ids, tables.geo,
                                tables.media)
        return intersect_bvh_plain(scene, tables, rays, kd, lane_ids)
    return intersect_bvh_launch(scene, tables, rays, kd, lane_ids,
                                words=words)


intersect_bvh.launches = 0


def intersect_bvh_launch(scene: SceneData, tables: BVHTables,
                         rays: torch.Tensor, kd, lane_ids,
                         stats: torch.Tensor | None = None,
                         words: torch.Tensor | None = None):
    """The traversal kernel on CUDA tensors; counts into
    ``intersect_bvh.launches``.  ``stats``, if given, a zeroed (12,) int64
    tensor on the rays' device, gets the kernel's own counts
    (``STAT_KEYS``) from its counting form; ``words`` as
    :func:`intersect_bvh`'s.  Returns (best_t, best_i)."""
    _check_rays(rays)
    R = rays.shape[1]
    dev = rays.device
    need = [rays, tables.nodes, tables.bvh.order, tables.geo, lane_ids]
    if tables.tab is not None:
        need.append(tables.tab)
    if words is not None:
        need.append(words)
        if words.dtype != torch.int64 or words.shape != (4,):
            raise ValueError("the render words must be a (4,) int64 tensor")
    if stats is not None:
        need.append(stats)
        if stats.dtype != torch.int64 or stats.shape != (len(STAT_KEYS),):
            raise ValueError(f"stats must be a ({len(STAT_KEYS)},) int64 "
                             "tensor")
    if any(not x.is_cuda or x.device != dev for x in need):
        raise ValueError("the BVH kernel takes CUDA tensors on one device")
    if lane_ids.dtype != torch.int32 or lane_ids.shape != (R,) \
            or not lane_ids.is_contiguous():
        raise ValueError("lane_ids must be a contiguous (R,) int32 tensor")
    cols, cap = {VISIT: (24, STACK_DEPTH),
                 INDEX: (12 * WIDTH, INDEX_STACK)}.get(tables.rule, (0, 0))
    if tables.nodes.dim() != 2 or tables.nodes.shape[1] != cols \
            or not 1 <= tables.stack <= cap:
        raise ValueError("malformed BVH tables")
    if scene.has_media and tables.tab is None:
        raise ValueError("a scene with media needs the (N, 40) prim table")
    fn = load_fn("bvh", "tr_bvh", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p])
    best_t = torch.empty((R,), dtype=torch.float32, device=dev)
    best_i = torch.empty((R,), dtype=torch.int32, device=dev)
    n_ss, n_s, n_sb, n_solid = _ranges(scene)
    err = fn(rays.data_ptr(), R, tables.nodes.data_ptr(),
             tables.bvh.order.data_ptr(), scene.n_prims,
             tables.geo.data_ptr() if n_solid else None,
             tables.tab.data_ptr() if tables.tab is not None else None,
             n_ss, n_s, n_sb, n_solid, float(np.float32(scene.t_min)),
             int(kd[0]) & 0xFFFFFFFF, int(kd[1]) & 0xFFFFFFFF,
             lane_ids.data_ptr(), int(bool(scene.any_transform)),
             float(_up(MARGIN_LINEAR)), tables.stack,
             record_budget(scene.n_prims), int(tables.rule == INDEX),
             stats.data_ptr() if stats is not None else None,
             words.data_ptr() if words is not None else None,
             best_t.data_ptr(), best_i.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"BVH kernel launch failed (cudaError {err})")
    intersect_bvh.launches += 1
    return best_t, best_i


def kernel_flops(counts: dict, rule: str) -> float:
    """fp32 operations of the kernel's own work under ``rule``, from its
    counters (``STAT_KEYS``): every child box tested (the root tests
    among them), every stack entry popped, the leaf pairs."""
    pairs = sum(counts.get(k, 0) * FLOPS_PER_PAIR[k]
                for k in ("sphere", "moving", "box", "quad"))
    return (counts.get("children", 0) * FLOPS_PER_CHILD[rule]
            + counts.get("pops", 0) * FLOPS_PER_POP
            + pairs + counts.get("medium", 0) * FLOPS_PER_MEDIUM_PAIR)


def traversal_flops(stats: dict) -> float:
    """fp32 operations of the traversal the twin counted in ``stats``: its
    node visits and its leaf pairs by kind."""
    pairs = sum(stats.get(k, 0) * FLOPS_PER_PAIR[k]
                for k in ("sphere", "moving", "box", "quad"))
    return (stats.get("visits", 0) * FLOPS_PER_VISIT + pairs
            + stats.get("medium", 0) * FLOPS_PER_MEDIUM_PAIR)
