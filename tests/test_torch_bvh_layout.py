"""The BVH kernel's packed tree and its two tie rules, on the CPU.

``ops/bvh.py::pack_nodes`` stores both children of an internal node in one
pair record under rule ``VISIT``, and up to four descendants of a node in
one wide record under rule ``INDEX``; ``csrc/bvh.cu`` walks those records.
The kernel cannot run here, so a numpy walk of the packed records in the
kernel's loop order (the same float32 operations, one ray at a time)
stands in for it:

- the pair records decode to ``build_bvh``'s tree (boxes, children, leaf
  ranges), byte for byte as they were before the wide records, and rule
  ``INDEX``'s widened boxes contain rule ``VISIT``'s;
- the wide records decode to ``build_bvh``'s nodes: every leaf in one
  slot, each slot the margins of the node it names, a record's children
  its node's subtree, widened by surface area, empty slots zero;
- under ``VISIT`` the walk equals ``intersect_bvh_plain`` bit for bit and
  the JAX package's ``intersect_scene_bvh``: hits and prims equal, t
  within rtol 2e-5 on cornell; on next-week-final XLA's quadratic and the
  port's differ by up to ~1e-2 in t where the foam's r = 10 spheres are
  met ~1000 units out or grazed from a surface point (cancellation in
  |o - c|^2 - r^2; ROADMAP section C has the same on the r = 1000 ground
  spheres), so t is held there at rtol 2e-2;
- under ``INDEX`` it equals ``intersect_ti``'s plain path, t and prim bit
  for bit - the dense sweep and the media merge, lower prim id on equal t
  - over the wide records and over the pair walk packed in their format
  (width 2), its stack within ``wide_stack_bound``, also on a synthetic
  tree 32 internal nodes deep;
- the rays: next-week-final camera rays and secondaries cast in seeded
  directions from their first hits (the box grid's shared faces give
  equal-t ties, on some of which the visit order names another prim than
  the lowest id), cornell camera rays and the cornell camera ray whose
  tie (prims 4 and 7 at t = 0x1.7564cep+6) the card found in a 500x500
  pool;
- ``SceneKernels.create`` takes the ``INDEX`` traversal only on the card:
  on the CPU a scene above ``BVH_ROUTE_MIN_PRIMS`` keeps ``intersect_ti``.
"""
from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_scene_arrays

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops.bvh import build_bvh as jbuild_bvh
from tpu_ray.ops.bvh import intersect_scene_bvh
from tpu_ray_torch import integrator
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import rng
from tpu_ray_torch.integrator import SceneKernels, init_pool_state
from tpu_ray_torch.models import objects as ob
from tpu_ray_torch.models.compile import build_scene
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import bvh, shade
from tpu_ray_torch.ops.intersect import _media_t, intersect_ti, media_rows
from tpu_ray_torch.ops.sweep import _ranges, pair_t, sweep_table
from tpu_ray_torch.renderer import pixel_grid, slot_ids

KEY = jax.random.fold_in(jax.random.PRNGKey(0), 7)
KD = np.asarray(jax.random.key_data(KEY))
F32 = np.float32
INF = F32(np.inf)
# the cornell camera ray with an equal-t tie (chip_smoke.py's "bvh tie"
# line: lane 523046 of the 500x500 64-spp pool's camera rays)
CORNELL_TIE = ("0x1.16p+8", "0x1.16p+8", "-0x1.9p+9", "0x1.7bd3p+1",
               "0x1.7bd3p+1", "0x1.4p+3", "0x1.cda468p-2")
# book1-final rays inside its r = 1000 ground sphere, from a 600x400 pool
# on the card: their margins swallow the small spheres, so rule INDEX runs
# out of its record budget and tests every prim
BOOK1_INSIDE = (
    ("-0x1.733dcp+6", "-0x1.b83d62p+10", "0x1.41104ep+9", "0x1.c8a9d8p-4",
     "0x1.d66666p-1", "-0x1.83dce4p-2", "0x1.e67d48p-3"),
    ("0x1.a18edcp+9", "-0x1.1a09a6p+9", "-0x1.4f7c7p+8", "-0x1.9706f8p-1",
     "0x1.04bff8p-1", "0x1.5188c2p-2", "0x1.85959cp-1"),
    ("0x1.eab1p+2", "-0x1.da398ap+10", "0x1.ba2b44p+8", "0x1.817f06p-8",
     "0x1.f497e2p-1", "-0x1.adb8cep-3", "0x1.89ef84p-1"),
    ("0x1.f61c9cp+8", "-0x1.2bdc6ap+10", "-0x1.a4bec0p+9", "-0x1.760596p-2",
     "0x1.8ad454p-1", "0x1.0afc04p-1", "0x1.935eb8p-1"))


def _scene(name):
    js = JSCENES[name].build(seed=1024, earth=None)
    return js, scene_from_jax_arrays(jax_scene_arrays(js))


def _camera_rays(ps, name, n, seed):
    """``n`` of a 100x100 pool's camera rays (the plain pool step's
    regen), picked from the seed."""
    cam = SCENES[name].camera(100, 100)
    cfg = shade.StepConfig.create(ps, cam, 100, 100, 8, n_samples=1,
                                  cam_salt=1024)
    st = init_pool_state(pixel_grid(100, 100, 1), slot_ids(100, 100, 1))
    R = st.slot.shape[0]
    f, _ = shade.pool_step(cfg, st.xy, st.slot, st.fstate, st.istate,
                           torch.empty(R), torch.zeros(R, dtype=torch.int32),
                           (0, 0), init=True)
    pick = np.sort(np.random.default_rng(seed).choice(R, n, replace=False))
    return f[:7, torch.from_numpy(pick)].contiguous()


def _secondaries(ps, cam_rays, seed):
    """Rays from the camera rays' first hits in seeded directions."""
    lanes = torch.arange(cam_rays.shape[1], dtype=torch.int32)
    t, _ = intersect_ti(ps, cam_rays, KD, lanes)
    hit = torch.isfinite(t)
    r = cam_rays[:, hit]
    o = r[0:3] + t[hit] * r[3:6]
    d = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(3, o.shape[1])).astype(F32))
    return torch.cat([o, d, r[6:7]]).contiguous()


def _pair_ts(ps, rays):
    """(R, N) float32 hit distances of every (ray, prim) pair: the sweep's
    pair math on each kind range, the media's free flight with lane ids
    0..R-1 - the bits the kernel's leaf loop computes for a pair."""
    R = rays.shape[1]
    geo = sweep_table(ps)
    n_ss, n_s, n_sb, n_solid = _ranges(ps)
    out = np.full((R, ps.n_prims), np.inf, F32)
    for c0 in range(0, R, 256):
        r = [rays[j, c0:c0 + 256][:, None] for j in range(7)]
        for lo, hi, kind in ((0, n_ss, "sphere"), (n_ss, n_s, "moving"),
                             (n_s, n_sb, "box"), (n_sb, n_solid, "quad")):
            if hi > lo:
                out[c0:c0 + 256, lo:hi] = pair_t(
                    r, geo[lo:hi].T[:, None, :], kind, F32(ps.t_min)).numpy()
    if ps.has_media:
        lanes = torch.arange(R, dtype=torch.int32)
        for j, t in enumerate(_media_t(ps, rays, KD, lanes, media_rows(ps))):
            out[:, n_solid + j] = t.numpy()
    return out


def _ref(v) -> int:
    return int(np.asarray(v, F32).view(np.int32))


def _box_test(rows, rec, col, o, inv, rule, t_min, passes):
    """One child box at column ``col`` of record ``rec`` (``csrc/bvh.cu``
    ``child``): (passes, lo, tf, ref)."""
    mn, mx = rows[rec, col:col + 3], rows[rec, col + 4:col + 7]
    if rule == bvh.INDEX:
        ch = rows[rec, col + 8:col + 12]
        lq = np.fmax(np.fmax(np.abs(o[0] - ch[0]), np.abs(o[1] - ch[1])),
                     np.abs(o[2] - ch[2])) + ch[3]
        m = lq * (rows[rec, col + 7] * lq + bvh._up(bvh.MARGIN_LINEAR))
        mn, mx = mn - m, mx + m
    ta, tb = (mn - o) * inv, (mx - o) * inv
    lo_ax, hi_ax = np.minimum(ta, tb), np.maximum(ta, tb)
    tn = np.maximum(np.maximum(lo_ax[0], lo_ax[1]), lo_ax[2])
    tf = np.minimum(np.minimum(hi_ax[0], hi_ax[1]), hi_ax[2])
    lo = np.maximum(tn, F32(t_min))
    return passes(lo, tf), lo, tf, _ref(rows[rec, col + 3])


def _walk(rows, order, tp, ray, rule, t_min, counts=None):
    """One ray through the records as ``csrc/bvh.cu`` walks them:
    (best_t, best_i).  ``tp``: the ray's (N,) pair distances.  ``VISIT``
    walks pair records (``step_pair``), ``INDEX`` wide records
    (``step_wide``: the live children tested, the others that pass pushed
    far-first through the kernel's sorting network as (ref, key), the
    nearest entered; leaves - the one entered, or popped - run in the same
    step until a record is entered).  ``counts``, if given, gets
    "records", "pops", "steps" and the stack's "peak"."""
    o = np.asarray(ray[0:3], F32)
    inv = F32(1) / np.asarray(ray[3:6], F32)
    best = [INF, INF, 0]                      # bt, nextafter(bt), bi
    c = counts if counts is not None else {}
    for k in ("records", "pops", "steps", "peak"):
        c.setdefault(k, 0)
    if rule == bvh.INDEX and np.isnan(ray[0:6]).any():
        return INF, 0

    def passes(lo, tf):
        if rule == bvh.VISIT:
            return bool(np.minimum(tf, best[0]) > lo)
        return not bool(np.minimum(tf, best[1]) <= lo)

    def test(rec, col):
        return _box_test(rows, rec, col, o, inv, rule, t_min, passes)

    def run_leaf(ref):
        first, cnt = (~ref) >> 3, (~ref) & 7
        for pid in order[first:first + cnt]:
            t = tp[pid]
            if rule == bvh.VISIT:
                if t < best[0]:
                    best[0], best[2] = t, pid
            elif t < best[0] or (t == best[0] and pid < best[2]):
                best[:] = t, np.nextafter(t, INF), pid

    def pop():
        """The next entry that passes, or None."""
        while stack:
            r, lo, tf = stack.pop()
            c["pops"] += 1
            # INDEX keeps (ref, key) alone: tf > key held when it was
            # pushed, so min(tf, nb) > key is nb > key
            if (passes(lo, tf) if rule == bvh.VISIT
                    else not bool(best[1] <= lo)):
                return r
        return None

    def push(entry):
        stack.append(entry)
        c["peak"] = max(c["peak"], len(stack))

    live, _, _, ref = test(0, 0)
    stack, left = [], bvh.record_budget(tp.shape[0])
    if not live:
        return best[0], best[2]
    while ref is not None:
        c["steps"] += 1
        if rule == bvh.VISIT:
            if ref > 0:
                c["records"] += 1
                pL, loL, tfL, rL = test(ref, 0)
                pR, loR, tfR, rR = test(ref, 8)
                if pL and pR:
                    push((rR, loR, tfR))
                if pL or pR:
                    ref = rL if pL else rR
                    continue
            else:
                run_leaf(ref)
            ref = pop()
            continue
        if ref > 0:
            refs = [_ref(rows[ref, 12 * k + 3]) for k in range(bvh.WIDTH)]
            left -= sum(r != 0 for r in refs) - 1
            if left < 0:          # past its budget: every prim, index order
                bt, bi = INF, 0
                for pid in range(tp.shape[0]):
                    if tp[pid] < bt:
                        bt, bi = tp[pid], pid
                return bt, bi
            c["records"] += 1
            kids = []                 # (key, ref): the entry, t_min for NaN
            for k, r in enumerate(refs):
                key = INF
                if r != 0:
                    p, lo, _, _ = test(ref, 12 * k)
                    if p:
                        key = np.fmax(lo, F32(t_min))
                kids.append((key, r))
            for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
                if kids[j][0] < kids[i][0]:
                    kids[i], kids[j] = kids[j], kids[i]
            n = sum(k[0] < INF for k in kids)
            for key, r in kids[n - 1:0:-1]:
                push((r, key, None))
            ref = kids[0][1] if n else 0
        while ref is not None and ref <= 0:
            if ref < 0:
                run_leaf(ref)
            ref = pop()
    return best[0], best[2]


def _walk_all(ps, tree, rays, rule, rows=None, counts=None):
    rows = bvh.pack_nodes(tree, rule, ps).numpy() if rows is None else rows
    order = tree.order.numpy()
    tp = _pair_ts(ps, rays)
    r = rays.numpy().T
    with np.errstate(divide="ignore", invalid="ignore"):   # 1/0, inf - inf
        out = [_walk(rows, order, tp[k], r[k], rule, ps.t_min, counts)
               for k in range(r.shape[0])]
    return (np.array([t for t, _ in out], F32),
            np.array([i for _, i in out], np.int32))


@pytest.fixture(scope="module")
def rays_nw():
    """300 camera rays, 300 secondaries and every secondary of 2000 camera
    rays' first hits that holds an equal-t tie between prims."""
    js, ps = _scene("next-week-final")
    cam = _camera_rays(ps, "next-week-final", 2000, 1)
    sec = _secondaries(ps, cam, 2)
    tp = _pair_ts(ps, sec)
    least = tp.min(1, keepdims=True)
    tie = torch.from_numpy(((tp == least).sum(1) > 1)
                           & np.isfinite(least[:, 0]))
    assert int(tie.sum()) >= 20
    return js, ps, torch.cat([cam[:, :300], sec[:, ~tie][:, :300],
                              sec[:, tie]], 1).contiguous()


@pytest.fixture(scope="module")
def rays_cornell():
    """600 camera rays; rays with a NaN in the origin or the direction and
    one with a zero direction (every pair misses; rule INDEX ends a NaN ray
    at once); last, the tie ray."""
    js, ps = _scene("cornell")
    tie = torch.tensor([[float.fromhex(v)] for v in CORNELL_TIE],
                       dtype=torch.float32)
    cam = _camera_rays(ps, "cornell", 600, 3)
    odd = cam[:, :4].clone()
    odd[0, 0] = odd[5, 1] = float("nan")
    odd[3:6, 2] = 0.0
    odd[0:3, 3] = torch.tensor([278.0, 0.0, 100.0])   # on the floor's plane
    odd[3:6, 3] = torch.tensor([1.0, 0.0, 0.0])       # and along it
    return js, ps, torch.cat([cam, odd, tie], 1).contiguous()


@pytest.fixture(scope="module")
def rays_book1():
    """200 camera rays and the rays inside the ground sphere."""
    js, ps = _scene("book1-final")
    inside = torch.tensor([[float.fromhex(v) for v in ray]
                           for ray in BOOK1_INSIDE], dtype=torch.float32).T
    cam = _camera_rays(ps, "book1-final", 200, 4)
    return js, ps, torch.cat([cam, inside], 1).contiguous()


SCENE_NAMES = ["next-week-final", "book1-final", "cornell", "cornell-smoke"]
# sha256 of pack_nodes(build_bvh(scene), VISIT)'s bytes for the library
# scenes at seed 1024, as the pair records were before rule INDEX's went
# four wide: VISIT's records stay byte for byte
VISIT_DIGESTS = {
    "next-week-final": ((512, 24), "fe22522d360d9363f49487dfb83e2696"
                                   "71cc6f7e89dd5c225705364073d77038"),
    "book1-final": ((128, 24), "a109d7cf8329855a0b5301da35ff5f97"
                               "f76715869bc6d726690ce536230e4735"),
    "cornell": ((4, 24), "6c46fe001e89d4d13a702eca743ca22c"
                         "dba616c00f7c9ebecea0c60f2214a035"),
    "cornell-smoke": ((2, 24), "1f72bb1b28cef80e1dfc61c59c888ddf"
                               "bbbd0a7c55077ffb416ef708f137ec50"),
}


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_pair_records_decode_to_the_build(name):
    """Rule VISIT's pair records decode to the build, and each node's rule
    INDEX box (``index_margins``) contains its VISIT box, its centre and
    half width bound the widened box."""
    _, ps = _scene(name)
    tree = bvh.build_bvh(ps)
    vis = bvh.pack_nodes(tree, bvh.VISIT).numpy()
    lo, hi, cen, h, A, _ = bvh.index_margins(ps, tree)
    nmin, nmax = tree.node_min.numpy(), tree.node_max.numpy()
    cl, cr = tree.child_l.numpy(), tree.child_r.numpy()
    first, count = tree.first.numpy(), tree.count.numpy()
    internal = np.flatnonzero(count == 0)
    assert vis.shape == (1 + internal.size, 24)
    rec = {int(n): k + 1 for k, n in enumerate(internal)}
    seen = set()

    def check(r, half, n):
        ref = _ref(vis[r, half + 3])
        np.testing.assert_array_equal(vis[r, half:half + 3], nmin[n])
        np.testing.assert_array_equal(vis[r, half + 4:half + 7], nmax[n])
        assert (vis[r, half + 7] == 0) and (vis[r, 16 + half // 2:
                                                 20 + half // 2] == 0).all()
        if count[n]:
            assert ref < 0 and ((~ref) >> 3, (~ref) & 7) == (first[n],
                                                             count[n])
            seen.update(tree.order.numpy()[first[n]:first[n] + count[n]])
        else:
            assert ref == rec[n]

    check(0, 0, 0)
    for n in internal:
        check(rec[int(n)], 0, cl[n])
        check(rec[int(n)], 8, cr[n])
    assert seen == set(range(ps.n_prims))
    assert 1 <= bvh.tree_depth(tree) <= bvh.STACK_DEPTH
    assert (lo < nmin).all() and (hi > nmax).all() and (A >= 0).all()
    assert (np.abs(cen - lo) <= h[:, None]).all()
    assert (np.abs(hi - cen) <= h[:, None]).all()


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_visit_records_are_unchanged(name):
    _, ps = _scene(name)
    rows = bvh.pack_nodes(bvh.build_bvh(ps), bvh.VISIT).numpy()
    shape, digest = VISIT_DIGESTS[name]
    assert rows.shape == shape
    assert hashlib.sha256(rows.tobytes()).hexdigest() == digest


def _leaf_ranges(tree):
    """Each node's range of ``order`` (its subtree's prims are contiguous
    there): ({(start, end): node}, {node: (start, end)})."""
    cl, cr = tree.child_l.numpy(), tree.child_r.numpy()
    first, count = tree.first.numpy(), tree.count.numpy()
    span = {}
    for n in range(tree.n_nodes - 1, -1, -1):
        if count[n]:
            span[n] = (int(first[n]), int(first[n] + count[n]))
        else:
            a, b = span[cl[n]], span[cr[n]]
            assert a[1] == b[0] or b[1] == a[0]
            span[n] = (min(a[0], b[0]), max(a[1], b[1]))
    return {v: n for n, v in span.items()}, span


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_wide_records_decode_to_the_build(name):
    """Rule INDEX's wide records: every leaf in exactly one slot; each
    slot's box, A, c and h are ``index_margins``' of the node it names; a
    record's children cover its node's subtree exactly, left to right;
    fewer than four children only where none is internal, and the nodes a
    record replaced by their children have surface areas no smaller than
    any internal child it kept; empty slots all zero; the stack bound
    within the kernel's."""
    _, ps = _scene(name)
    tree = bvh.build_bvh(ps)
    rows = bvh.pack_nodes(tree, bvh.INDEX, ps).numpy()
    lo, hi, cen, h, A, area = bvh.index_margins(ps, tree)
    cl, cr = tree.child_l.numpy(), tree.child_r.numpy()
    count = tree.count.numpy()
    node_of, span = _leaf_ranges(tree)
    parent = {int(k): n for n in np.flatnonzero(count == 0)
              for k in (cl[n], cr[n])}
    assert rows.shape[1] == 12 * bvh.WIDTH
    assert (rows[0, 12:] == 0).all()
    leaves, records = [], {}

    def decode(rec, n):
        """Check record ``rec`` as the record of node ``n``."""
        assert rec not in records
        records[rec] = n
        slots = rows[rec].reshape(bvh.WIDTH, 12)
        refs = [_ref(x[3]) for x in slots]
        k = sum(r != 0 for r in refs)
        assert k >= 2 and all(r != 0 for r in refs[:k])
        assert (slots[k:] == 0).all()
        kids = []
        for x, r in zip(slots[:k], refs):
            if r < 0:
                m = node_of[((~r) >> 3, ((~r) >> 3) + ((~r) & 7))]
                assert count[m] == (~r) & 7
                leaves.append(m)
            else:
                assert r > rec
                m = decode_slot(r)
            np.testing.assert_array_equal(x[0:3], lo[m])
            np.testing.assert_array_equal(x[4:7], hi[m])
            np.testing.assert_array_equal(x[8:11], cen[m])
            assert x[7] == A[m] and x[11] == h[m]
            kids.append(m)
        # the children cover n's subtree, left to right (the build lays a
        # right subtree's prims before the left's in ``order``)
        assert span[kids[-1]][0] == span[n][0]
        assert span[kids[0]][1] == span[n][1]
        assert all(span[a][0] == span[b][1] for a, b in zip(kids, kids[1:]))
        inner = [m for m in kids if count[m] == 0]
        assert k == bvh.WIDTH or not inner
        replaced = set()
        for m in kids:
            while parent[m] != n:
                m = parent[m]
                replaced.add(m)
        assert len(replaced) == k - 2
        for x in replaced:
            assert all((area[x], -x) > (area[m], -m) for m in inner)

    def decode_slot(r):
        # the node of record r: the union of its children's ranges
        if r in records:
            return records[r]
        slots = rows[r].reshape(bvh.WIDTH, 12)
        ends = []
        for x in slots:
            q = _ref(x[3])
            if q < 0:
                ends.append((int((~q) >> 3), int(((~q) >> 3) + ((~q) & 7))))
            elif q > 0:
                ends.append(span[decode_slot(q)])
        m = node_of[(min(a for a, _ in ends), max(b for _, b in ends))]
        decode(r, m)
        return m

    root = _ref(rows[0, 3])
    if root > 0:
        decode(root, 0)
    else:
        leaves.append(0)
    assert sorted(leaves) == sorted(np.flatnonzero(count > 0).tolist())
    assert sorted(records) == list(range(1, rows.shape[0]))
    bound = bvh.wide_stack_bound(rows)
    assert 1 <= bound <= bvh.INDEX_STACK
    tables = bvh.BVHTables.create(ps, tree, rule=bvh.INDEX)
    assert tables.stack == max(bound, 1)
    np.testing.assert_array_equal(tables.nodes.numpy().view(np.int32),
                                  rows.view(np.int32))


@pytest.mark.parametrize("which", ["next-week-final", "cornell",
                                   "book1-final"])
def test_walk_visit_equals_twin_and_jax(which, rays_nw, rays_cornell,
                                        rays_book1):
    js, ps, rays = {"next-week-final": rays_nw, "cornell": rays_cornell,
                    "book1-final": rays_book1}[which]
    tree = bvh.build_bvh(ps)
    t, i = _walk_all(ps, tree, rays, bvh.VISIT)
    R = rays.shape[1]
    lanes = torch.arange(R, dtype=torch.int32)
    tables = bvh.BVHTables.create(ps, tree)
    pt, pi = bvh.intersect_bvh_plain(ps, tables, rays, KD, lanes)
    np.testing.assert_array_equal(t.view(np.int32), pt.numpy().view(np.int32))
    np.testing.assert_array_equal(i, pi.numpy())
    r = rays.numpy()
    rec = intersect_scene_bvh(js, jbuild_bvh(js, use_native=False),
                              jnp.asarray(r[0:3].T), jnp.asarray(r[3:6].T),
                              jnp.asarray(r[6]), KEY)
    hit = np.asarray(rec.hit)
    assert hit.sum() > R // 3
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_array_equal(i[hit], np.asarray(rec.prim)[hit])
    np.testing.assert_allclose(t[hit], np.asarray(rec.t)[hit],
                               rtol=2e-2 if which == "next-week-final"
                               else 2e-5)


@pytest.mark.parametrize("which", ["next-week-final", "cornell",
                                   "book1-final"])
def test_walk_index_equals_intersect_ti(which, rays_nw, rays_cornell,
                                        rays_book1):
    _, ps, rays = {"next-week-final": rays_nw, "cornell": rays_cornell,
                   "book1-final": rays_book1}[which]
    tree = bvh.build_bvh(ps)
    t, i = _walk_all(ps, tree, rays, bvh.INDEX)
    lanes = torch.arange(rays.shape[1], dtype=torch.int32)
    ft, fi = (a.numpy() for a in intersect_ti(ps, rays, KD, lanes))
    np.testing.assert_array_equal(t.view(np.int32), ft.view(np.int32))
    np.testing.assert_array_equal(i, fi)
    if which == "book1-final":      # the inside rays hit the ground
        assert (ps.prims.radius[fi[-4:]] == 1000.0).all()
        assert np.isfinite(ft[-4:]).all()
        return
    # the visit order names another prim on some equal-t ties
    vt, vi = _walk_all(ps, tree, rays, bvh.VISIT)
    ties = (vi != fi) & (vt == ft) & np.isfinite(ft)
    assert ties.any() and (fi[ties] < vi[ties]).all()
    if which == "cornell":
        assert (fi[-1], vi[-1]) == (4, 7)
        assert ft[-1] == F32(float.fromhex("0x1.7564cep+6"))


def _grazing_rays(ps, seed):
    """Rays at the cases rule INDEX's margins are sized for
    (``bvh.index_margins``), and the spheres they graze.

    Spheres: for each axis and side, the smallest sphere (r = 10) that
    reaches furthest that way - so its box bounds every node above it on
    that side - grazed from 1000-5000 units out (all inside the scene-wide
    fog) by rays in the plane r + e off its centre, e from 0 to 0.1, with
    no component along the axis: the quadratic's disc is rounding noise
    there, so the sweep reports hits past the sphere, outside its box and
    every box above it.  Then rays at points a few ulps either side of the
    light quad's edges and of box corners, nearly parallel to the face (the
    plane distance divides by a tiny n . d).  Returns (rays, aimed sphere
    of each sphere ray)."""
    g = np.random.default_rng(seed)
    p = ps.prims
    n_ss, n_s, n_sb, n_solid = _ranges(ps)
    rad = p.radius[:n_ss].numpy().astype(np.float64)
    cen = p.center[:n_ss].numpy().astype(np.float64)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    small = np.flatnonzero(rad == rad.min())
    origins, dirs, aimed = [], [], []
    for axis in range(3):
        for sgn in (1.0, -1.0):
            j = small[np.argmax(sgn * cen[small, axis])]
            for L in (1000.0, 2500.0, 5000.0):
                for _ in range(8):
                    d = g.normal(size=3)
                    d[axis] = 0.0
                    if axis != 1:
                        d[1] = -abs(d[1]) - 0.2       # from above the boxes
                    d = unit(d)
                    for e in (0.0, 0.02, 0.05, 0.1):
                        x = cen[j].copy()
                        x[axis] += sgn * (rad[j] + e)
                        origins.append(x - L * d)
                        dirs.append(d)
                        aimed.append(j)
    for j in range(n_sb, n_solid):                    # the quads' edges
        q0, e1, e2 = (x[j].numpy().astype(np.float64)
                      for x in (p.quad_p0, p.quad_e1, p.quad_e2))
        nrm = unit(np.cross(e1, e2))
        for _ in range(60):
            a, b = g.random(2)
            edge = [q0 + a * e1, q0 + e1 + a * e2, q0 + a * e2,
                    q0 + b * e2 + e1 * g.integers(0, 2)][g.integers(4)]
            slope = 10.0 ** -g.uniform(2, 5)
            d = unit(unit(g.normal(size=3) * (1 - np.abs(nrm)))
                     - slope * np.sign(g.normal()) * nrm)
            x = edge * (1 + g.choice([-3, -1, 0, 1, 3]) * 2.0 ** -24)
            origins.append(x - g.uniform(1000.0, 5000.0) * d)
            dirs.append(d)
    bmin, bmax = p.box_min.numpy(), p.box_max.numpy()
    for j in g.choice(np.arange(n_s, n_sb), 60, replace=False):   # corners
        corner = np.where(g.integers(0, 2, 3) > 0, bmax[j], bmin[j])
        axis = g.integers(3)
        d = unit(g.normal(size=3))
        d[axis] = 10.0 ** -g.uniform(2, 5) * np.sign(d[axis])
        d = unit(d)
        x = corner.astype(np.float64) * (1 + g.choice([-1, 0, 1])
                                         * 2.0 ** -24)
        origins.append(x - g.uniform(1000.0, 5000.0) * d)
        dirs.append(d)
    o = np.asarray(origins, F32)
    d = np.asarray(dirs, F32)           # the sphere rays' axis stays 0
    t = g.random((o.shape[0], 1)).astype(F32)
    return (torch.from_numpy(np.concatenate([o, d, t], 1).T.copy()),
            np.asarray(aimed))


def test_walk_index_holds_grazing_rays_from_far_origins():
    """Rule INDEX's walk equals intersect_ti bit for bit on rays that
    graze next-week-final's smallest spheres, quad edges and box corners
    from far out; among them the sweep's hits that lie outside the hit
    sphere's own box, which only the margins keep in the walk."""
    _, ps = _scene("next-week-final")
    rays, aimed = _grazing_rays(ps, 6)
    tree = bvh.build_bvh(ps)
    t, i = _walk_all(ps, tree, rays, bvh.INDEX)
    lanes = torch.arange(rays.shape[1], dtype=torch.int32)
    ft, fi = (a.numpy() for a in intersect_ti(ps, rays, KD, lanes))
    np.testing.assert_array_equal(t.view(np.int32), ft.view(np.int32))
    np.testing.assert_array_equal(i, fi)
    n = aimed.size
    hit = fi[:n] == aimed
    r = rays.numpy().astype(np.float64)
    with np.errstate(invalid="ignore"):               # inf * 0 on a miss
        at = r[0:3, :n] + ft[:n].astype(np.float64) * r[3:6, :n]
    c = ps.prims.center.numpy()[aimed].T.astype(np.float64)
    rad = ps.prims.radius.numpy()[aimed].astype(np.float64)
    outside = (np.abs(at - c) > rad).any(0) & hit
    assert outside.sum() >= 10
    assert (fi[n:] < ps.n_solid).mean() > 0.5      # the rest: mostly solids


@pytest.mark.parametrize("which", ["next-week-final", "cornell", "grazing"])
def test_wide_walk_and_pair_walk_equal_intersect_ti(which, rays_nw,
                                                   rays_cornell):
    """Rule INDEX over the wide records and over the pair walk packed in
    their format (``pack_nodes(..., width=2)``, which chip_smoke.py counts
    beside the wide walk): both bit for bit ``intersect_ti``, each stack's
    peak within its ``wide_stack_bound``, and the wide walk expands fewer
    records in fewer steps."""
    if which == "grazing":
        ps = _scene("next-week-final")[1]
        rays = _grazing_rays(ps, 6)[0]
    else:
        _, ps, rays = {"next-week-final": rays_nw,
                       "cornell": rays_cornell}[which]
    tree = bvh.build_bvh(ps)
    lanes = torch.arange(rays.shape[1], dtype=torch.int32)
    ft, fi = (a.numpy() for a in intersect_ti(ps, rays, KD, lanes))
    counts = {}
    for width in (2, bvh.WIDTH):
        rows = bvh.pack_nodes(tree, bvh.INDEX, ps, width).numpy()
        c = counts[width] = {}
        t, i = _walk_all(ps, tree, rays, bvh.INDEX, rows, c)
        np.testing.assert_array_equal(t.view(np.int32), ft.view(np.int32))
        np.testing.assert_array_equal(i, fi)
        assert c["peak"] <= bvh.wide_stack_bound(rows)
    assert bvh.wide_stack_bound(bvh.pack_nodes(tree, bvh.INDEX, ps, 2)
                                .numpy()) == bvh.tree_depth(tree)
    if which != "cornell":         # cornell's tree: 3 internal nodes
        assert counts[bvh.WIDTH]["records"] < 0.7 * counts[2]["records"]
        assert counts[bvh.WIDTH]["steps"] < 0.8 * counts[2]["steps"]


def _spine_tree(depth):
    """A scene of spheres and a hand-made tree ``depth`` internal nodes
    deep whose wide walk needs a deep stack: spine node i holds a side
    subtree and spine node i + 1; the side subtree (a pair of r = 1
    spheres on the x axis at +-(200 - 3 i), and one inside the first) is
    wider than everything below the spine node, so each spine record
    replaces it and its pair by their children and keeps four, three of
    them pushed.
    Returns (scene, BVHArrays); every child follows its parent."""
    objs, kids, leaf = [], [], []
    white = ob.Lambertian((1, 1, 1))

    def node(k=None):
        kids.append([-1, -1])
        leaf.append(k)
        return len(kids) - 1

    def sphere(c, r):
        objs.append(ob.Sphere(c, r, white))
        return node(len(objs) - 1)

    def inner(make_l, make_r):
        n = node()
        kids[n][0] = make_l()
        kids[n][1] = make_r()
        return n

    def spine(i):
        x = 200.0 - 3 * i
        if i == depth - 1:
            return inner(lambda: sphere((0.0, 0.0, 0.5), 0.4),
                         lambda: sphere((0.0, 0.0, -0.5), 0.4))
        if i == depth - 2:
            return inner(lambda: sphere((0.5, 0.0, 0.0), 0.4),
                         lambda: spine(i + 1))
        side = lambda: inner(lambda: inner(lambda: sphere((x, 0.0, 0.0), 1.0),
                                           lambda: sphere((-x, 0.0, 0.0),
                                                          1.0)),
                             lambda: sphere((x, 0.0, 0.0), 0.5))
        return inner(side, lambda: spine(i + 1))

    spine(0)
    ps = build_scene(objs)          # which orders the prims its own way
    cen = ps.prims.center[:ps.n_prims].numpy()
    rad = ps.prims.radius[:ps.n_prims].numpy()
    pid = [int(np.flatnonzero((cen == np.asarray(o.center, F32)).all(1)
                              & (rad == F32(o.radius)))[0]) for o in objs]
    leaf = [None if k is None else pid[k] for k in leaf]
    order = [k for k in leaf if k is not None]
    first = np.zeros(len(kids), np.int32)
    count = np.zeros(len(kids), np.int32)
    for n, k in enumerate(leaf):
        if k is not None:
            first[n], count[n] = order.index(k), 1
    boxes = bvh.prim_aabbs(ps)
    lo = np.zeros((len(kids), 3))
    hi = np.zeros((len(kids), 3))
    for n in range(len(kids) - 1, -1, -1):
        if leaf[n] is not None:
            lo[n], hi[n] = boxes[leaf[n]]
        else:
            a, b = kids[n]
            lo[n], hi[n] = np.minimum(lo[a], lo[b]), np.maximum(hi[a], hi[b])
    cl, cr = np.array(kids, np.int32).T
    tree = bvh.BVHArrays(
        node_min=torch.from_numpy(lo.astype(F32)),
        node_max=torch.from_numpy(hi.astype(F32)),
        child_l=torch.from_numpy(cl.copy()), child_r=torch.from_numpy(
            cr.copy()), first=torch.from_numpy(first),
        count=torch.from_numpy(count),
        order=torch.tensor(order, dtype=torch.int32), n_nodes=len(kids))
    return ps, tree


def test_wide_stack_holds_a_tree_32_deep():
    """A tree 32 internal nodes deep, as deep as the JAX traversal's stack
    allows, is accepted under rule INDEX though its wide walk may hold
    more than 64 entries; rays aimed at its spheres fill the walk's stack
    past 32 entries and within that bound, and its answer is
    ``intersect_ti``'s."""
    ps, tree = _spine_tree(bvh.STACK_DEPTH)
    assert bvh.tree_depth(tree) == bvh.STACK_DEPTH
    tables = bvh.BVHTables.create(ps, tree, rule=bvh.INDEX)
    rows = tables.nodes.numpy()
    assert rows.shape[0] == bvh.STACK_DEPTH         # one record a spine node
    assert 64 < tables.stack == bvh.wide_stack_bound(rows) <= bvh.INDEX_STACK
    g = np.random.default_rng(9)
    n = 64
    aim = (ps.prims.center[g.integers(0, ps.n_prims, n - 2)].numpy()
           + g.normal(scale=0.5, size=(n - 2, 3)))       # at the spheres
    o = np.concatenate([[[-400.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                        g.uniform(-250, 250, (n - 2, 3))])
    d = np.concatenate([[[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], aim - o[2:]])
    rays = torch.from_numpy(np.concatenate(
        [o, d, g.random((n, 1))], 1).T.astype(F32).copy())
    lanes = torch.arange(n, dtype=torch.int32)
    ft, fi = (a.numpy() for a in intersect_ti(ps, rays, KD, lanes))
    c = {}
    t, i = _walk_all(ps, tree, rays, bvh.INDEX, rows, c)
    np.testing.assert_array_equal(t.view(np.int32), ft.view(np.int32))
    np.testing.assert_array_equal(i, fi)
    assert np.isfinite(ft).sum() > n // 2
    assert bvh.STACK_DEPTH < c["peak"] <= tables.stack   # 63 of 92


def test_index_tables_on_the_cpu_run_intersect_ti(rays_nw):
    _, ps, rays = rays_nw
    lanes = torch.arange(rays.shape[1], dtype=torch.int32)
    tables = bvh.BVHTables.create(ps, rule=bvh.INDEX)
    calls = bvh.intersect_bvh_plain.calls
    t, i = bvh.intersect_bvh(ps, tables, rays, KD, lanes)
    assert bvh.intersect_bvh_plain.calls == calls
    ft, fi = intersect_ti(ps, rays, KD, lanes)
    assert torch.equal(t, ft) and torch.equal(i, fi)


def test_scene_kernels_route_only_on_the_card():
    """A CPU scene above the route's prim count keeps intersect_ti; the
    count lies between the repo's 485- and 1409-prim scenes."""
    _, ps = _scene("next-week-final")
    assert 485 < integrator.BVH_ROUTE_MIN_PRIMS <= 1409
    assert ps.n_prims >= integrator.BVH_ROUTE_MIN_PRIMS
    kern = SceneKernels.create(ps, False)
    assert kern.bvh is None and kern.blocks is None
    rays = _camera_rays(ps, "next-week-final", 64, 5)
    lanes = torch.arange(64, dtype=torch.int32)
    ki = rng.fold_in(rng.prng_key(3), 0)
    a = kern.intersect(ps, rays, ki, lanes)
    b = intersect_ti(ps, rays, ki, lanes)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert SceneKernels.create(ps, False, bvh.build_bvh(ps)).bvh.rule \
        == bvh.VISIT
