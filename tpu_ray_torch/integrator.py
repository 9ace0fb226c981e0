"""The three integrators: the ray pool, the plain wavefront and the work
queue.  The pool also has a one-launch form, the whole-wave megakernel
(:func:`tpu_ray_torch.ops.megakernel.trace_pool_mega`, re-exported here
beside :func:`trace_pool_staged`, which it can stand in for).

**Ray pool** (immediate path regeneration).

Port of the fused pool path of ``tpu_ray/integrator.py`` (``_PoolState``,
``_init_pool_state``, ``_pool_levels``, the fused body of
``_make_pool_loop`` and ``trace_pool_staged``).  Every slot owns one pixel
and renders ``n_samples`` camera samples in turn; each iteration runs the
closest-hit sweep and the fused pool step (the CUDA kernels on the card,
their plain versions on the CPU).  All randomness is keyed by the slot's
global id and the global iteration / sample index, never by lane position.

The host drives the loop:

* each wave's per-iteration key words ``fold_in(fold_in(k_loop, it), 0/1)``
  are precomputed in numpy for the whole iteration cap (the JAX
  megakernel's key-table trick);
* the active count is read every ``CHECK_EVERY`` iterations, not every
  one.  Iterations past the point where the count fell to a ladder level
  change nothing a later level would not do identically (draws are keyed
  by slot and iteration, and the active count never rises), so the
  estimate does not change - only where the radiance is summed;
* compaction gathers the most-active lanes with a stable argsort of
  ``~active`` at each ladder level, as ``integrator.py:506-529`` does.

**Plain wavefront** (:func:`trace`, port of ``integrator.trace``): one
path per lane, traced to completion through the closest-hit sweep and the
unfused hit-record + scatter kernel (:mod:`tpu_ray_torch.ops.hit_scatter`).
Kept as the semantic reference of the estimator.

**Work queue** (:func:`trace_queue`, port of ``integrator.trace_queue``
with fused shading, and with the XLA queue's ``sobol-b0`` first-bounce
scatter draws in the step): one persistent pool of lanes draws (pixel, sample)
work items off a global frontier; the moment a path dies its lane takes
the next item, so the pool stays full until the frontier is spent and the
render pays one survival tail.  Path draws are keyed by (work item,
bounce) through ``rng.path_ids`` and camera draws by (pixel, global
sample), never by lane, iteration or epoch; a dying lane's radiance is
written (not added) into a per-(sample, pixel) plane that is reduced in a
fixed order.  So the image is bit-identical for any lane count, epoch
length, drain ladder and sample chunking.  The JAX package's radiance
log, position map and lagged counter reads served a TPU's slow scatters
and a remote worker's round trip; here the plane is written directly and
the counters are read once per epoch.  On the card a render whose shape
repeats runs each epoch as one replay of a CUDA graph kept across renders
(:class:`QueuePlan`, :func:`replay_key`).  In worklist mode (adaptive
sampling, :mod:`tpu_ray_torch.adaptive`) the work items come from a packed
list of (pixel, absolute sample) entries, and the plane is reduced per
pixel into radiance sums and square sums.  :func:`trace_queue_mesh` and
:func:`trace_queue_wl_mesh` share a chunk's samples or a worklist's items
out over the devices of a mesh (:mod:`tpu_ray_torch.parallel.mesh`).
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from .core import rng
from .models.scene_data import SceneData
from .ops import queue as queue_ops
from .ops.bvh import INDEX, BVHArrays, BVHTables, intersect_bvh
from .ops.hit_scatter import hit_scatter
from .ops.intersect import intersect_ti, media_rows
from .ops.megakernel import trace_pool_mega  # noqa: F401  (re-exported)
from .ops.queue import (  # noqa: F401  (re-exported)
    WL_SAMP_BITS, WL_SAMP_MASK, _to_i32_bits)
from .ops.shade import (N_FSTATE, N_ISTATE, RR_COL, RR_PMIN, StepConfig,
                        pool_step)
from .ops.sweep import (MxuPack, SweepBlocks, mxu_pack, sweep_blocks,
                        sweep_table, use_mask_cull, use_mxu, use_sort)
from .parallel import mesh as mesh_mod
from .utils import profiling
from .utils.profiling import span

# compaction ladder (integrator.py COMPACT_* constants, kept identical:
# the ladder decides nothing about the estimate, but the port keeps the
# reference's schedule until it is retuned for the card)
COMPACT_MIN = 1 << 14
COMPACT_FRACTION = 2
COMPACT_FLOOR = 4096
COMPACT_FRACTION_TINY = 8
COMPACT_FLOOR_TINY = 1024
COMPACT_TINY_PRIMS = 128
CHECK_EVERY = 4


@dataclass
class PoolState:
    """The pool's lanes: float and int state (ops/shade.py layout) plus
    the per-lane constants and each lane's position in the full pool."""

    fstate: torch.Tensor   # (13, R) float32
    istate: torch.Tensor   # (3, R) int32
    xy: torch.Tensor       # (2, R) float32
    slot: torch.Tensor     # (R,) int32 (uint32 bits)
    gids: torch.Tensor     # (R,) int64


def init_pool_state(xy, slot) -> PoolState:
    """``_init_pool_state``: zero state, unit throughput, nothing active."""
    R = slot.shape[0]
    f = torch.zeros((N_FSTATE, R), dtype=torch.float32, device=slot.device)
    f[7:10] = 1.0
    i = torch.zeros((N_ISTATE, R), dtype=torch.int32, device=slot.device)
    return PoolState(f, i, xy, slot,
                     torch.arange(R, dtype=torch.int64, device=slot.device))


def pool_levels(R: int, n_prims: int):
    """Compaction-ladder pool sizes for an R-lane pool."""
    if n_prims > COMPACT_TINY_PRIMS:
        frac, floor = COMPACT_FRACTION, COMPACT_FLOOR
    else:
        frac, floor = COMPACT_FRACTION_TINY, COMPACT_FLOOR_TINY
    levels = []
    m = R
    while R >= COMPACT_MIN and m // frac >= floor:
        m = m // frac
        levels.append(m)
    return levels


# From this many prims up the default closest hit on the card traverses the
# BVH under the sweep's tie rule (ops/bvh.py, rule INDEX: bit for bit the
# dense sweep and the media merge) instead of sweeping every prim: above
# 512, the big scenes the JAX package sends to its queue.  The repo's
# scenes have 1, 2, 4, 8, 13, 485 and 1409 prims.  On one H100 80GB HBM3
# at 700 W (chip_smoke.py phase 3, 1M rays) the dense sweep wins at 13
# (cornell: 0.033 against 0.052 ms) and the traversal at 485 (book1-final:
# 0.395 against ~0.17) and 1409 (next-week-final: 1.35 against ~0.39, the
# media merge included); but book1-final's pool render loses with it
# (chip_smoke.py phase 5, the "route" line; utils/profile.py): most of its
# 200 launches are the tail's small pools, whose time is that of their
# slowest rays - the few inside the r = 1000 ground sphere, whose margins
# cover every small sphere - against the sweep's ~21 us.  next-week-final's
# queue spends half the intersect time or less (PERF.md section 5).
BVH_ROUTE_MIN_PRIMS = 513
# the route's tables by scene object, (weak reference, tables): a render's
# bands, a mesh render's devices and the server's requests each create
# their SceneKernels from the same immutable scene, and the host's build of
# the tree and its margins (tens of ms at 1409 prims) is paid once
_route_tables: dict = {}


def _index_tables(scene: SceneData, geo, media) -> BVHTables:
    """Rule ``INDEX``'s tables of ``scene``, built at its first route."""
    hit = _route_tables.get(id(scene))
    if hit is not None and hit[0]() is scene:
        return hit[1]
    for k in [k for k, (ref, _) in _route_tables.items() if ref() is None]:
        del _route_tables[k]
    tables = BVHTables.create(scene, None, geo, media, rule=INDEX)
    _route_tables[id(scene)] = (weakref.ref(scene), tables)
    return tables


@dataclass
class SceneKernels:
    """Per-render tables of the sweeps and the media rows.  This is the one
    place that decides how a render finds its closest hits: ``bvh`` is set
    when it traverses a BVH (``ops/bvh.py``, no sweep at all: rule
    ``VISIT`` when the render asked for ``bvh``, rule ``INDEX`` when the
    default intersect of a scene of ``BVH_ROUTE_MIN_PRIMS`` prims or more
    on the card takes it), ``blocks`` when it uses a sorted sweep,
    ``masked`` picks the mask-gated kernel over the compacted lists,
    ``mxu`` is set when the static spheres go through the matrix-product
    sweep."""

    geo: torch.Tensor
    media: list
    blocks: SweepBlocks | None = None
    masked: bool = False
    mxu: MxuPack | None = None
    bvh: BVHTables | None = None

    @classmethod
    def create(cls, scene: SceneData, sort: bool | None = None,
               bvh: BVHArrays | None = None,
               engine: str = "xla") -> "SceneKernels":
        """``sort``: the sorted sweep on or off; ``None`` reads
        ``TPU_RAY_SORT`` (off unless ``1``).  The environment is read here,
        once: ``TPU_RAY_CULL_STYLE`` other than ``compact`` makes a sorted
        sweep mask-gated, ``TPU_RAY_SWEEP_MXU=1`` sends the static-sphere
        range through the matrix-product sweep.  ``engine="mxu"`` (the
        resolved engine) does the same on a scene without moving spheres;
        with moving spheres every range keeps the dense sweep, as the JAX
        package's ``mxu`` engine does.  With ``bvh`` (a
        :class:`~tpu_ray_torch.ops.bvh.BVHArrays` of the scene) every
        intersect traverses the tree in the JAX package's visit order and
        the sweep switches are not read.  Otherwise, on the card, with
        neither sort nor matrix-product sweep and ``BVH_ROUTE_MIN_PRIMS``
        prims or more, the intersect traverses the scene's tree under rule
        ``INDEX``: the dense sweep's ``(best_t, best_i)``, bit for bit
        (the tables built once per scene object)."""
        geo = sweep_table(scene)
        media = media_rows(scene)
        if bvh is not None:
            return cls(geo=geo, media=media,
                       bvh=BVHTables.create(scene, bvh, geo, media))
        sort = use_sort(sort) and scene.n_solid > 0
        n_ss = scene.n_sphere_static
        mxu = use_mxu() or (engine == "mxu" and not scene.has_moving)
        if not sort and not (mxu and n_ss > 0) \
                and scene.device.type == "cuda" \
                and scene.n_prims >= BVH_ROUTE_MIN_PRIMS:
            tables = _index_tables(scene, geo, media)
            return cls(geo=tables.geo, media=tables.media, bvh=tables)
        return cls(geo=geo, media=media,
                   blocks=sweep_blocks(scene) if sort else None,
                   masked=sort and use_mask_cull(),
                   mxu=mxu_pack(geo, 0, n_ss) if mxu and n_ss > 0 else None)

    def intersect(self, scene: SceneData, rays, kd, lane_ids, words=None):
        """The closest hits with this render's tables: BVH traversal when
        ``bvh`` is set, else :func:`intersect_ti`.  ``words``: a queue
        render's block on the card (:func:`intersect_bvh`), for the BVH
        only."""
        if self.bvh is not None:
            return intersect_bvh(scene, self.bvh, rays, kd, lane_ids, words)
        if words is not None and rays.is_cuda:
            raise ValueError("render words go with the BVH traversal only")
        return intersect_ti(scene, rays, kd, lane_ids, self.geo, self.media,
                            self.blocks, self.masked, self.mxu)


def _compact(st: PoolState, m: int) -> PoolState:
    """Gather the ``m`` most-active lanes (stable argsort of ~active),
    with a zero radiance accumulator."""
    order = torch.argsort((st.istate[2] == 0).to(torch.int32),
                          stable=True)[:m]
    f = st.fstate[:, order]
    f[10:13] = 0.0
    return PoolState(f, st.istate[:, order].contiguous(),
                     st.xy[:, order].contiguous(),
                     st.slot[order].contiguous(), st.gids[order])


def trace_pool_staged(scene: SceneData, cfg: StepConfig, xy, slot, k_loop,
                      kern: SceneKernels | None = None):
    """Run one wave of the pool: every slot renders ``cfg.n_samples``
    samples starting at global sample ``cfg.sample0``, with loop key
    ``k_loop`` (numpy uint32[2]).

    ``xy``: (2, R) pixel-fraction bases; ``slot``: (R,) int32 global slot
    ids.  Returns (accum (3, R) summed radiance, samples done (R,) int32).
    """
    R = slot.shape[0]
    dev = slot.device
    if cfg.max_depth <= 0:
        return (torch.zeros((3, R), dtype=torch.float32, device=dev),
                torch.full((R,), cfg.n_samples, dtype=torch.int32,
                           device=dev))
    if kern is None:
        kern = SceneKernels.create(scene)
    iter_cap = cfg.n_samples * cfg.max_depth + cfg.max_depth
    k_isect, k_scat = rng.pool_key_tables(np.asarray(k_loop, np.uint32),
                                          iter_cap)
    st = init_pool_state(xy, slot)
    dummy_t = torch.empty((R,), dtype=torch.float32, device=dev)
    dummy_i = torch.zeros((R,), dtype=torch.int32, device=dev)
    st.fstate, st.istate = pool_step(cfg, st.xy, st.slot, st.fstate,
                                     st.istate, dummy_t, dummy_i, (0, 0),
                                     init=True)
    it = 0

    def run_until(st: PoolState, threshold: int) -> PoolState:
        nonlocal it
        k = 0
        while it < iter_cap:
            if k % CHECK_EVERY == 0:
                with span("pool.read"):
                    done = int(st.istate[2].sum()) <= threshold
                if done:
                    break
            with span("pool.iteration"):
                bt, bi = kern.intersect(scene, st.fstate[:7], k_isect[it],
                                        st.slot)
                st.fstate, st.istate = pool_step(cfg, st.xy, st.slot,
                                                 st.fstate, st.istate, bt, bi,
                                                 k_scat[it])
            it += 1
            k += 1
        return st

    levels = pool_levels(R, scene.n_prims)
    st = run_until(st, levels[0] if levels else 0)
    accum = st.fstate[10:13].clone()
    sample = st.istate[1].clone()
    for li, m in enumerate(levels):
        st = _compact(st, m)
        st = run_until(st, levels[li + 1] if li + 1 < len(levels) else 0)
        accum.index_add_(1, st.gids, st.fstate[10:13])
        sample[st.gids] = st.istate[1]
    return accum, sample


# --- the plain wavefront ----------------------------------------------------

def trace(scene: SceneData, cfg: StepConfig, rays: torch.Tensor, key,
          lane_ids=None, kern: SceneKernels | None = None) -> torch.Tensor:
    """Trace a wavefront to completion; returns per-ray radiance (3, R).

    ``rays``: (7, R) origin, direction, shutter time (constant along each
    path); ``key``: numpy uint32[2], folded per bounce as ``fold_in(key,
    bounce)`` then ``fold_in(kb, 0)`` (intersect) / ``fold_in(kb, 1)``
    (scatter); ``lane_ids`` key each lane's draws (default: position).
    ``cfg`` supplies the scene tables, ``max_depth`` and ``rr_depth``
    (Russian roulette after that many bounces, 0 = off); its camera and
    sample fields are not read.  The loop ends at ``max_depth`` or when no
    lane is alive, which the host reads every ``CHECK_EVERY`` bounces: a
    bounce with every lane dead changes nothing.
    """
    R = rays.shape[1]
    dev = rays.device
    if kern is None:
        kern = SceneKernels.create(scene)
    if lane_ids is None:
        lane_ids = torch.arange(R, dtype=torch.int32, device=dev)
    rays = rays.clone()
    tp = torch.ones((3, R), dtype=torch.float32, device=dev)
    rad = torch.zeros((3, R), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    bg = cfg.lights_t.new_tensor(cfg.background)[:, None]
    key = np.asarray(key, np.uint32)
    rr_depth = cfg.rr_depth
    for bounce in range(cfg.max_depth):
        if bounce % CHECK_EVERY == 0 and not bool(alive.any()):
            break
        kb = rng.fold_in(key, bounce)
        k_sc = rng.fold_in(kb, 1)
        bt, bi = kern.intersect(scene, rays, rng.fold_in(kb, 0), lane_ids)
        rec, sc = hit_scatter(cfg, rays, bt, bi, k_sc, lane_ids)
        miss = alive & ~rec.hit
        emit = alive & rec.hit & ~sc.scattered
        cont = alive & rec.hit & sc.scattered
        rad = rad + torch.where(miss, tp * bg, 0.0)
        rad = rad + torch.where(emit, tp * sc.emitted, 0.0)
        tp_new = torch.where(cont, tp * sc.weight, tp)
        kill = torch.zeros_like(cont)
        if rr_depth:
            p = torch.clamp(tp.max(dim=0).values, min=RR_PMIN, max=1.0)
            do_rr = cont & (bounce >= rr_depth)
            kill = do_rr & (rng.lane_uniform_col(k_sc, lane_ids, RR_COL) >= p)
            tp_new = torch.where(do_rr & ~kill, tp_new / p, tp_new)
        tp = tp_new
        alive = cont & ~kill & (tp.max(dim=0).values > 0.0)
        rays[0:3] = torch.where(cont, rec.point, rays[0:3])
        rays[3:6] = torch.where(cont, sc.direction, rays[3:6])
    return rad


# --- the work queue ---------------------------------------------------------

@dataclass
class QueueState:
    """The queue's lanes (pool-state layout: ``fstate`` rows 10:13 hold the
    radiance of the lane's current work item) and the film plane."""

    fstate: torch.Tensor    # (13, m) float32
    istate: torch.Tensor    # (3, m) int32: bounce, 0, active
    work: torch.Tensor      # (m,) int64 chunk-local work item id
    frontier: torch.Tensor  # () int64 next unissued work item
    plane: torch.Tensor     # (3, pad + 1) float32; the last column takes
    #                         the writes of lanes that did not die
    lane: torch.Tensor | None = None  # sobol-b0 only: (2, m) int32 the
    #                         work item's pixel and global sample (uint32
    #                         bits), set at inject for the step's
    #                         first-bounce draws; None for other samplers
    census: torch.Tensor | None = None  # () int64 path vertices: the inject
    #                         adds the lanes it leaves active, the next
    #                         iteration's rays; None counts nothing


def _queue_init(R: int, total: int, dev, pad: int | None = None,
                b0: bool = False) -> QueueState:
    """Fresh lanes and a zero plane of ``pad`` columns (default ``total``)
    plus the sentinel column; columns past ``total`` are never written.
    ``b0`` (the step configuration's) gives the lanes their (pixel, global
    sample) record.  The census starts at 0: no lane is active."""
    pad = total if pad is None else pad
    f = torch.zeros((N_FSTATE, R), dtype=torch.float32, device=dev)
    f[3:6] = 1.0
    f[7:10] = 1.0
    # the frontier and the census cell share one allocation, one fill
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)
    return QueueState(
        fstate=f,
        istate=torch.zeros((N_ISTATE, R), dtype=torch.int32, device=dev),
        work=torch.full((R,), pad, dtype=torch.int64, device=dev),
        frontier=counters[0],
        plane=torch.zeros((3, pad + 1), dtype=torch.float32, device=dev),
        lane=(torch.zeros((2, R), dtype=torch.int32, device=dev) if b0
              else None),
        census=counters[1])


def queue_body(st: QueueState, scene: SceneData, cfg: StepConfig,
               kern: SceneKernels, k_isect, k_scat, cam_salt: int,
               work_base: int, total: int, width: int, height: int,
               worklist: torch.Tensor | None = None,
               work_id0: int | None = None, out: QueueState | None = None,
               words: torch.Tensor | None = None,
               xy: torch.Tensor | None = None) -> QueueState:
    """One queue iteration: trace + fused step + flush dead + inject fresh.

    ``cfg`` is a step configuration with ``n_samples = 0`` (the step
    kernel then never regenerates; the queue injects work itself); with
    ``cfg.b0`` (sampler ``"sobol-b0"``) the step also reads each lane's
    (pixel, global sample), which the inject records in ``st.lane``
    (made by ``_queue_init(..., b0=True)``); other samplers keep no record.
    ``worklist`` ((Wl,) int64 packed entries, Wl >= ``total``) replaces the
    uniform work map: item w renders pixel ``worklist[w] >> WL_SAMP_BITS``
    at absolute sample ``worklist[w] & WL_SAMP_MASK``; path ids stay keyed
    by ``w + work_base``, or by ``w + work_id0`` when that is given (a
    mesh shard's first global work id, ``trace_queue_wl_mesh``).

    ``out``: a second state of the same size, whose lanes, work items,
    frontier and record take the iteration's result in place of fresh
    tensors (the plane and the census are shared); ``words``: the render's
    block (``ops/queue.py::render_words``) on the card, from which the
    kernels read the key words, the camera salt, the first work id and
    the first global sample (:class:`QueuePlan`'s replays); ``xy``: the
    step's (2, m) zero pixel bases, made here when omitted."""
    m = st.work.shape[0]
    dev = st.work.device
    id0 = work_base if work_id0 is None else work_id0
    # the block and the buffers go to the wrappers only when given, so a
    # wrapper's plain twin swapped in for it keeps working
    kw = {} if words is None else {"words": words}
    step_kw, inject_kw = dict(kw), dict(kw)
    if out is not None:
        step_kw["out"] = (out.fstate, out.istate)
        inject_kw["out"] = (out.work, out.frontier, out.lane)
    sid = queue_ops.path_ids(st.work, id0, st.istate[0], **kw)
    bt, bi = kern.intersect(scene, st.fstate[:7], k_isect, sid, **kw)
    if xy is None:
        xy = torch.zeros((2, m), dtype=torch.float32, device=dev)
    f, i = pool_step(cfg, xy, sid, st.fstate, st.istate, bt, bi, k_scat,
                     lane_b0=st.lane, **step_kw)
    f, i, work, frontier, lane = queue_ops.queue_inject(
        cfg, cam_salt, st.istate[2], f, i, st.work, st.frontier, st.plane,
        st.lane, worklist, total, work_base, width, height, census=st.census,
        **inject_kw)
    return QueueState(f, i, work, frontier, st.plane, lane, st.census)


def queue_compact(st: QueueState, m: int,
                  out: QueueState | None = None) -> QueueState:
    """Drain-ladder compaction: gather the ``m`` most-active lanes (a stable
    argsort keeps the work order), into ``out``'s lanes when given (an
    ``m``-lane state sharing ``st``'s frontier, plane and census)."""
    order = torch.argsort((st.istate[2] == 0).to(torch.int32),
                          stable=True)[:m]
    if out is not None:
        torch.index_select(st.fstate, 1, order, out=out.fstate)
        torch.index_select(st.istate, 1, order, out=out.istate)
        torch.index_select(st.work, 0, order, out=out.work)
        if st.lane is not None:
            torch.index_select(st.lane, 1, order, out=out.lane)
        return out
    return QueueState(st.fstate[:, order].contiguous(),
                      st.istate[:, order].contiguous(), st.work[order],
                      st.frontier, st.plane,
                      None if st.lane is None
                      else st.lane[:, order].contiguous(), st.census)


class QueueCounts:
    """The work queue's counters (:func:`tpu_ray_torch.utils.profiling.
    counts`): :func:`trace_queue` calls; path vertices, the census (the sum
    over iterations of the lanes active at the closest hit, as
    ``tools/count_rays.py`` counts: the same for any lane count, epoch
    length and drain ladder); lane slots, the pool size summed over every
    dispatched iteration; iterations dispatched, and of them those run by
    an epoch's replay (:class:`QueuePlan`).  Class attributes, so a caller
    that wraps ``trace_queue`` leaves them counting."""

    calls = 0
    vertices = 0
    lane_slots = 0
    iterations = 0
    replayed = 0


# --- the work queue's epochs as CUDA graphs ----------------------------------
#
# Issued from Python, an iteration costs the host ~8 launches through ctypes
# and their allocations (0.34-0.50 ms), about what the card needs for one at
# 1M lanes and far more than it needs on the drain's smaller pools, so the
# card waits for the host.  A plan keeps, for one shape of render, the
# queue's state in fixed buffers (two a pool size, which the iterations of
# an epoch write in turn) and one CUDA graph a pool size of an epoch's
# iterations; the host then issues one replay an epoch.  What changes from
# render to render without changing the shape (the key words, the camera
# salt, the first work id and sample) lives in a word block on the card
# that the kernels read.  The reads, the exit test, the compactions and the
# schedule stay as they are, so the image and the census are those of the
# eager loop, bit for bit.  A shape's first render runs eagerly, with no
# plan; its second makes the plan, so a shape rendered once (a single CLI
# render, a scene object made for one request) captures nothing and holds
# no buffers.

# plans the cache keeps, the least recently used dropped first (a plan holds
# its film plane and two states a pool size: ~0.5 GB at 400x400 100 spp and
# 1M lanes)
QUEUE_PLANS = 4
_queue_plans: OrderedDict = OrderedDict()
# keys rendered once with no plan, the oldest forgotten first
_queue_seen: OrderedDict = OrderedDict()


def replay_key(scene: SceneData, kern: SceneKernels, camera, width: int,
               height: int, max_depth: int, rr_depth: int, total: int,
               R: int, drain_levels, epoch_iters: int, worklist=None,
               mesh_share: bool = False):
    """The plan cache's key of a :func:`trace_queue` call (whose plans
    are made on the card only), or None where the call runs its
    iterations eagerly: with a worklist
    (adaptive rounds, whose lists and counts change every round), on a
    mesh's share, and where the closest hit's tables are made anew for
    each render (every intersect but the route's, whose tables
    ``_index_tables`` keeps per scene object), so a key would never repeat.
    The key holds what the captured launches read that a render cannot
    change in its word block: the device, the scene object and its tables
    (kept alive by the plan, so their ids are not reused), the inputs of
    ``StepConfig.create`` (the camera's words and sampler, the size, the
    depths), the work count, the pool sizes and the epoch length.  Seeds,
    camera salts and sample offsets are not in it."""
    if worklist is not None or mesh_share or kern.bvh is None:
        return None
    kept = _route_tables.get(id(scene))
    if kept is None or kept[0]() is not scene or kept[1] is not kern.bvh:
        return None
    return (str(scene.device), id(scene), id(kern.bvh), camera.sampler,
            np.asarray(camera.vec(), np.float32).tobytes(), int(width),
            int(height), int(max_depth), int(rr_depth), int(total), int(R),
            tuple(int(m) for m in drain_levels), int(epoch_iters))


class QueuePlan:
    """One shape of work-queue render on the card, kept across renders: the
    queue's state in fixed buffers and each pool size's epoch as a CUDA
    graph.

    ``rungs[m]`` is (a, b, graph, launches) for pool size ``m`` (``R``,
    then the drain levels): two ``m``-lane states sharing one frontier
    cell pair, the census and the film plane.  An epoch runs its
    iterations from a to b, b to a and so on (with an odd count the last
    result is copied back), so it starts and ends in a, where the epoch's
    read finds it.  A size's first epoch runs eagerly (it loads every
    kernel in the form the graph launches), and is then captured without
    running; later epochs replay the capture.  The graphs read the plan's
    word block (:meth:`start` writes it), so one capture serves renders of
    any seed.  The kernels' launch counters count what runs: a capture
    leaves them as they were, and each replay adds the launches it holds
    (``launches``, by counter).  The plan holds the scene, its tables and
    the step configuration, whose tensors the graphs read."""

    def __init__(self, scene: SceneData, kern: SceneKernels, cfg: StepConfig,
                 width: int, height: int, total: int, R: int, drain_levels,
                 epoch_iters: int):
        dev = scene.device
        self.scene, self.kern, self.cfg = scene, kern, cfg
        self.width, self.height, self.total = width, height, total
        self.R, self.epoch_iters = R, epoch_iters
        self.words = torch.zeros((4,), dtype=torch.int64, device=dev)
        # the frontier, the census cell, the frontier's second buffer
        self.counters = torch.zeros((3,), dtype=torch.int64, device=dev)
        self.plane = torch.zeros((3, total + 1), dtype=torch.float32,
                                 device=dev)
        self.xy = torch.zeros((2 * R,), dtype=torch.float32, device=dev)
        self.side = torch.cuda.Stream(dev)
        self.rungs = {}
        for m in (R, *drain_levels):
            a, b = (QueueState(
                fstate=torch.empty((N_FSTATE, m), dtype=torch.float32,
                                   device=dev),
                istate=torch.empty((N_ISTATE, m), dtype=torch.int32,
                                   device=dev),
                work=torch.empty((m,), dtype=torch.int64, device=dev),
                frontier=self.counters[k], plane=self.plane,
                lane=(torch.empty((2, m), dtype=torch.int32, device=dev)
                      if cfg.b0 else None),
                census=self.counters[1]) for k in (0, 2))
            self.rungs[m] = [a, b, None, None]
        self.args = None

    def start(self, k_isect, k_scat, cam_salt: int, work_base: int,
              id0: int) -> QueueState:
        """A render's fresh lanes (``_queue_init``'s) in the full pool's
        buffers, a zero plane and counters, and its word block written to
        the card (the eager epochs pass the same words by value too)."""
        self.args = (k_isect, k_scat, cam_salt, work_base, id0)
        st = self.rungs[self.R][0]
        st.fstate.zero_()
        st.fstate[3:6] = 1.0
        st.fstate[7:10] = 1.0
        st.istate.zero_()
        st.work.fill_(self.total)
        if st.lane is not None:
            st.lane.zero_()
        self.counters.zero_()
        self.plane.zero_()
        words = queue_ops.render_words(k_isect, k_scat, cam_salt, id0,
                                       work_base // (self.width * self.height))
        self.words.copy_(torch.from_numpy(words))
        return st

    def compact(self, st: QueueState, m: int) -> QueueState:
        """:func:`queue_compact` into pool size ``m``'s buffers."""
        return queue_compact(st, m, out=self.rungs[m][0])

    def epoch(self, m: int) -> bool:
        """One epoch on pool size ``m``'s state: its graph's replay under
        one span ``queue.iteration`` (True), or at the size's first epoch
        the iterations issued one by one, each under its span, then the
        capture (False)."""
        rung = self.rungs[m]
        if rung[2] is not None:
            with span("queue.iteration"):
                rung[2].replay()
            profiling.add_launches(rung[3])
            return True
        self._iterate(rung[0], rung[1], spans=True)
        rung[2], rung[3] = self._capture(rung[0], rung[1])
        return False

    def _capture(self, a: QueueState, b: QueueState):
        """A graph of one epoch from ``a``, captured on the plan's side
        stream and not run, and the launches it holds by counter, which
        are taken back off the counters.  ``torch.cuda.graph`` would also
        synchronize, collect and empty the allocator's cache at every
        capture, which this capture does not need: it allocates from the
        graph's own pool and runs nothing."""
        before = profiling.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.side):
            graph.capture_begin()
            try:
                self._iterate(a, b, spans=False)
            finally:
                graph.capture_end()
        held = {k: v - before[k]
                for k, v in profiling.launch_counts().items()}
        profiling.add_launches({k: -v for k, v in held.items()})
        return graph, held

    def _iterate(self, a: QueueState, b: QueueState, spans: bool) -> None:
        k_isect, k_scat, cam_salt, work_base, id0 = self.args
        m = a.work.shape[0]
        xy = self.xy[:2 * m].view(2, m)
        src, dst = a, b
        for _ in range(self.epoch_iters):
            with span("queue.iteration") if spans else nullcontext():
                src, dst = queue_body(
                    src, self.scene, self.cfg, self.kern, k_isect, k_scat,
                    cam_salt, work_base, self.total, self.width, self.height,
                    work_id0=id0, out=dst, words=self.words, xy=xy), src
        if self.epoch_iters % 2:
            for x, y in ((a.fstate, b.fstate), (a.istate, b.istate),
                         (a.work, b.work), (a.frontier, b.frontier),
                         (a.lane, b.lane)):
                if x is not None:
                    x.copy_(y)


def _queue_plan(key):
    """The cached plan of ``key`` (now the most recently used), or None."""
    plan = None if key is None else _queue_plans.get(key)
    if plan is not None:
        _queue_plans.move_to_end(key)
    return plan


def _new_plan(key, make):
    """At ``key``'s second render with no plan cached, the plan ``make()``
    gives, cached (the cache keeps ``QUEUE_PLANS``, the least recently used
    dropped first); None at its first, or with no key: that render runs
    eagerly."""
    if key is None:
        return None
    if _queue_seen.pop(key, None) is None:
        _queue_seen[key] = True
        while len(_queue_seen) > 4 * QUEUE_PLANS:
            _queue_seen.popitem(last=False)
        return None
    plan = _queue_plans[key] = make()
    while len(_queue_plans) > QUEUE_PLANS:
        _queue_plans.popitem(last=False)
    return plan


def trace_queue(scene: SceneData, camera, width: int, height: int,
                chunk_spp: int, chunk_s0: int, key, max_depth: int, R: int,
                cam_salt: int = 0, epoch_iters: int = 8, drain_levels=(),
                progress_cb=None, rr_depth: int = 0, worklist=None,
                n_work=None, wl_block_pix=None,
                kern: SceneKernels | None = None, work_id0: int | None = None,
                phase=None, mesh_share: bool = False):
    """Render ``width * height * chunk_spp`` camera samples with a work-queue
    pool of ``R`` lanes; returns the (H*W, 3) radiance sum over the chunk's
    samples.

    Work item w (chunk-local) is pixel ``w % (W*H)`` (row-major, image row
    0 at the top) at global sample ``chunk_s0 + w // (W*H)``.  ``key``
    (numpy uint32[2]) gives the purpose keys ``fold_in(key, 0 / 1)`` that
    stay constant over the render.  The host reads (frontier, active
    count) once per epoch of ``epoch_iters`` iterations; iterations past
    the exit condition change nothing.  ``drain_levels``: pool sizes of the
    final drain's compaction.  ``kern`` passes a render's prebuilt tables,
    which also pick the sweep (:meth:`SceneKernels.create`; built from the
    scene when omitted).  The scene must be on the device to
    render on.  ``phase`` (a :class:`~tpu_ray_torch.utils.profiling.Phase`
    of the calling render) ends before the first iteration, and begins
    ``render.finish`` after the last.

    Each call adds to :class:`QueueCounts` its path vertices (its census
    cell, read with the counters once an epoch), its lane slots and its
    iterations, and of those the ones a replay ran.

    On the card, where :func:`replay_key` gives a key (a render without a
    worklist, outside a mesh, whose closest hit takes the route's tables)
    and a :class:`QueuePlan` of that key is cached, the iterations run
    from it: one graph replay an epoch, and no step configuration made.
    A key's first render issues every iteration on its own, and its second
    makes the plan; a call with no key, or off the card, issues every
    iteration on its own.  Both give the same image and census, bit for
    bit.  ``mesh_share``: the call renders one device's share of a mesh
    render (:func:`trace_queue_mesh`, :func:`trace_queue_wl_mesh`).

    With ``worklist`` ((Wl,) int64 packed (pixel, absolute sample) entries
    on the scene's device, adaptive sampling) the work map comes from the
    entries (:func:`queue_body`) and ``chunk_spp`` is ignored.  Only the
    first ``n_work`` entries are dispatched (default: all); the plane
    columns of the rest stay zero.  The return value is then the pair
    (radiance sums, radiance square sums), each (H*W, 3) float32, per
    pixel over the dispatched items: :func:`worklist_sums_blocked` when
    ``wl_block_pix`` gives the per-block pixels of a pixel-major,
    ``WL_QUANT``-blocked list, else :func:`worklist_sums`.  ``chunk_s0``
    still offsets the path ids, so callers advance it between rounds;
    ``work_id0`` replaces that offset (``chunk_s0 * W * H``) with the
    first global work id of a mesh shard (:func:`trace_queue_wl_mesh`)."""
    P = width * height
    dev = scene.device
    if worklist is not None:
        pad = int(worklist.shape[0])
        total = pad if n_work is None else int(n_work)
        if not 0 <= total <= pad:
            raise ValueError(f"n_work {total} outside [0, {pad}]")
        chunk_spp = -(-total // P) or 1    # epoch-cap estimate only
        worklist = worklist.to(device=dev, dtype=torch.int64)
    elif n_work is not None or wl_block_pix is not None:
        raise ValueError("n_work and wl_block_pix need a worklist")
    else:
        chunk_spp = int(chunk_spp)
        total = pad = P * chunk_spp
    if max_depth <= 0:
        z = torch.zeros((P, 3), dtype=torch.float32, device=dev)
        return (z, z.clone()) if worklist is not None else z
    if kern is None:
        with span("render.kernels"):
            kern = SceneKernels.create(scene)
    with span("render.plan"):
        key = np.asarray(key, np.uint32)
        k_isect, k_scat = rng.fold_in(key, 0), rng.fold_in(key, 1)
        work_base = (int(chunk_s0) & rng.M32) * P
        epoch_iters = max(1, int(epoch_iters))
        max_epochs = 21 + (total // max(R, 1) + chunk_spp * int(max_depth)
                           + 2 * int(max_depth)) // epoch_iters * 4
        drain_levels = tuple(drain_levels)
        shape = replay_key(scene, kern, camera, width, height, max_depth,
                           rr_depth, total, R, drain_levels, epoch_iters,
                           worklist, mesh_share)
        plan = _queue_plan(shape)
    if plan is None:
        # n_samples = 0: the step kernel never regenerates a camera ray; the
        # camera salt keys the sobol-b0 step's first-bounce draws
        with span("render.step_config"):
            cfg = StepConfig.create(scene, camera, width, height, max_depth,
                                    rr_depth=rr_depth, n_samples=0,
                                    cam_salt=cam_salt, queue=True)
        if dev.type == "cuda":      # graphs are the card's; no plan elsewhere
            plan = _new_plan(shape, lambda: QueuePlan(
                scene, kern, cfg, width, height, total, R, drain_levels,
                epoch_iters))
    else:
        cfg = plan.cfg
    with span("queue.init"):
        if plan is None:
            st = _queue_init(R, total, dev, pad, cfg.b0)
        else:
            st = plan.start(k_isect, k_scat, cam_salt, work_base,
                            work_base if work_id0 is None else work_id0)
    vertices = 0

    def run(st: QueueState, threshold: int) -> QueueState:
        nonlocal vertices
        for _ in range(max_epochs):
            with span("queue.read"):
                frontier, n_active, vertices = torch.stack(
                    [st.frontier, st.istate[2].sum(), st.census]).tolist()
                if progress_cb is not None:
                    progress_cb(frontier, total)
                if frontier >= total and n_active <= threshold:
                    return st
            QueueCounts.lane_slots += epoch_iters * st.work.shape[0]
            QueueCounts.iterations += epoch_iters
            if plan is not None:
                if plan.epoch(st.work.shape[0]):
                    QueueCounts.replayed += epoch_iters
                continue
            for _ in range(epoch_iters):
                with span("queue.iteration"):
                    st = queue_body(st, scene, cfg, kern, k_isect, k_scat,
                                    cam_salt, work_base, total, width, height,
                                    worklist, work_id0)
        raise RuntimeError("trace_queue: epoch cap exceeded")

    if phase is not None:
        phase.end()
    st = run(st, drain_levels[0] if drain_levels else 0)
    for li, m in enumerate(drain_levels):
        with span("queue.compact"):
            st = queue_compact(st, m) if plan is None else plan.compact(st, m)
        st = run(st, drain_levels[li + 1] if li + 1 < len(drain_levels) else 0)
    if phase is not None:
        phase.begin("render.finish")
    QueueCounts.calls += 1
    QueueCounts.vertices += vertices
    if worklist is not None:
        if wl_block_pix is not None:
            return worklist_sums_blocked(st.plane, wl_block_pix, P)
        return worklist_sums(st.plane, worklist, P)
    # sample-major reduction in a fixed order, whatever the schedule was
    return st.plane[:, :total].reshape(3, chunk_spp, P).sum(dim=1).T


# --- the work queue over a device mesh ----------------------------------------
#
# The queue's draws are keyed by global (work item, bounce) and (pixel, global
# sample) ids, and each item's radiance is written, not added, into its own
# plane column.  So sharing a chunk's samples (or a worklist's items) out over
# devices is the same operation as cutting them into chunks on one device:
# device d runs the single-device queue on its own share with its own lanes,
# and the partial sums are folded in device order at the end (the JAX
# package's one psum, ``tpu_ray/integrator.py:1124-1150, :1347-1357``).  The
# host drives the devices one after another, and each device's queue reads
# its counters once an epoch, so on distinct cards the shares do not overlap
# yet; the JAX package steps every device's epoch before it reads any counter.

def trace_queue_mesh(scenes, camera, width: int, height: int, chunk_spp: int,
                     chunk_s0: int, key, max_depth: int, R: int, mesh,
                     kerns: dict | None = None, progress_cb=None, **kw):
    """:func:`trace_queue` over a device mesh: device d renders the chunk's
    global samples ``[chunk_s0 + d * spp_d, chunk_s0 + (d + 1) * spp_d)``,
    ``spp_d = chunk_spp / D``; returns the chunk's (H*W, 3) radiance sum on
    ``mesh[0]``, the single-device chunk's up to f32 summation order.

    ``scenes``: the scene, or its copies by device
    (:func:`~tpu_ray_torch.parallel.mesh.replicate`); ``kerns``: each
    device's :class:`SceneKernels` (made from its copy when omitted).  ``R``
    lanes a device; the other keywords go to :func:`trace_queue`."""
    D = len(mesh)
    if chunk_spp % D:
        raise ValueError(f"chunk_spp {chunk_spp} not divisible by {D} "
                         "devices")
    P = width * height
    spp_d = chunk_spp // D
    scenes = mesh_mod.replicate(scenes, mesh)
    if kerns is None:
        kerns = {dev: SceneKernels.create(sc) for dev, sc in scenes.items()}
    parts = []
    for d, dev in enumerate(mesh):
        cb = None
        if progress_cb is not None:
            def cb(frontier, total, done=d * P * spp_d):
                progress_cb(done + frontier, P * chunk_spp)
        with mesh_mod.device_guard(dev):
            parts.append(trace_queue(
                scenes[dev], camera, width, height, spp_d,
                chunk_s0 + d * spp_d, key, max_depth, R, progress_cb=cb,
                kern=kerns[dev], mesh_share=True, **kw))
    return mesh_mod.reduce_films(parts, mesh)


def trace_queue_wl_mesh(scenes, camera, width: int, height: int,
                        chunk_s0: int, key, max_depth: int, R: int, mesh,
                        worklist: torch.Tensor, n_work: int,
                        wl_block_pix: torch.Tensor,
                        kerns: dict | None = None, drain_levels=(), **kw):
    """:func:`trace_queue` in worklist mode over a device mesh: the (Wl,)
    worklist splits into D contiguous shards of ``wl_d = Wl / D`` items
    (and ``wl_block_pix`` alike); device d dispatches its first
    ``clip(n_work - d * wl_d, 0, wl_d)`` items with path ids keyed from the
    global work id ``chunk_s0 * W * H + d * wl_d``, so every item draws
    what the single-device round draws.  Returns the per-pixel (radiance
    sums, square sums), each (H*W, 3) on ``mesh[0]``: each shard's blocked
    reduction, summed in device order.  ``Wl`` must split into D shards of
    whole ``WL_QUANT`` blocks (``adaptive``'s pad rule sees to it).  ``R``
    caps each device's lanes; the other keywords go to
    :func:`trace_queue`."""
    D = len(mesh)
    Wl, nb = int(worklist.shape[0]), int(wl_block_pix.shape[0])
    if Wl % D or nb % D:
        raise ValueError(f"worklist of {Wl} items in {nb} blocks does not "
                         f"split over {D} devices")
    wl_d, nb_d = Wl // D, nb // D
    P = width * height
    scenes = mesh_mod.replicate(scenes, mesh)
    if kerns is None:
        kerns = {dev: SceneKernels.create(sc) for dev, sc in scenes.items()}
    parts = []
    for d, dev in enumerate(mesh):
        n_d = min(max(int(n_work) - d * wl_d, 0), wl_d)
        R_d = max(1024, min(R, n_d))
        with mesh_mod.device_guard(dev):
            sums = trace_queue(
                scenes[dev], camera, width, height, 0, chunk_s0, key,
                max_depth, R_d, worklist=worklist[d * wl_d:(d + 1) * wl_d
                                                  ].to(dev),
                n_work=n_d,
                wl_block_pix=wl_block_pix[d * nb_d:(d + 1) * nb_d].to(dev),
                drain_levels=tuple(m for m in drain_levels if m < R_d),
                kern=kerns[dev], mesh_share=True,
                work_id0=(int(chunk_s0) * P + d * wl_d) & rng.M32, **kw)
            parts.append(torch.stack(sums))
    out = mesh_mod.reduce_films(parts, mesh)
    return out[0], out[1]


def worklist_sums(plane: torch.Tensor, worklist: torch.Tensor, P: int):
    """Per-pixel (radiance sum, radiance square sum), each (P, 3), of a
    worklist's (3, Wl + 1) plane for any worklist (``_worklist_sums``):
    one scatter-add per item.  Columns never written add 0.  On the card
    the adds run in no fixed order, so this is the tests' oracle; the
    adaptive loop reduces with :func:`worklist_sums_blocked`."""
    pl = plane[:, :worklist.shape[0]]
    pix = worklist.to(device=plane.device, dtype=torch.int64) >> WL_SAMP_BITS
    z = torch.zeros((P, 3), dtype=torch.float32, device=plane.device)
    return z.index_add(0, pix, pl.T), z.index_add(0, pix, (pl * pl).T)


# pixels' block sums gathered per pass of the segmented sum: bounds its
# (pixels, SEGMENT_COLS, 6) float32 intermediate at 100 MB at 2^18 pixels
SEGMENT_COLS = 16


def worklist_sums_blocked(plane: torch.Tensor, block_pix: torch.Tensor,
                          P: int):
    """Per-pixel (radiance sum, radiance square sum), each (P, 3), of a
    PIXEL-MAJOR worklist whose consecutive blocks of Q = Wl / nb items
    belong to one pixel (``_worklist_sums_blocked``): a dense (nb, Q) row
    sum per channel, then each pixel's blocks, which are contiguous, summed
    in block order.  No atomics: the result is the same on every run, which
    the adaptive loop needs (its sums decide every later round's work
    ids).  ``block_pix`` (nb,) must not decrease; entries >= P (padding
    blocks) drop."""
    dev = plane.device
    block_pix = block_pix.to(device=dev, dtype=torch.int64)
    nb = block_pix.shape[0]
    n_items = plane.shape[1] - 1
    out = torch.zeros((P, 6), dtype=torch.float32, device=dev)
    if nb == 0:
        return out[:, :3], out[:, 3:]
    if n_items % nb:
        raise ValueError(f"{n_items} worklist items do not split into {nb} "
                         "equal blocks")
    if bool((block_pix[1:] < block_pix[:-1]).any()):
        raise ValueError("the blocked reduction needs a pixel-major "
                         "worklist (block pixels in ascending order)")
    pl = plane[:, :n_items].reshape(3, nb, -1)
    blocks = torch.cat([pl.sum(dim=2), (pl * pl).sum(dim=2)]).T  # (nb, 6)
    pix, counts = torch.unique_consecutive(block_pix, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    keep = pix < P
    pix, counts, starts = pix[keep], counts[keep], starts[keep]
    acc = torch.zeros((pix.shape[0], 6), dtype=torch.float32, device=dev)
    c_max = int(counts.max()) if pix.numel() else 0
    for j0 in range(0, c_max, SEGMENT_COLS):
        j = torch.arange(j0, min(j0 + SEGMENT_COLS, c_max), device=dev)
        valid = j[None, :] < counts[:, None]
        rows = blocks[torch.where(valid, starts[:, None] + j[None, :], 0)]
        acc = acc + torch.where(valid[..., None], rows, 0.0).sum(dim=1)
    out[pix] = acc
    return out[:, :3], out[:, 3:]
