"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives ``tpu_ray_torch``'s paths (the pool renderer with the wavefront
kernels and with the whole-wave megakernel, the work-queue renderer, the
plain wavefront, BVH traversal, checkpoint / resume, the CLI's
``--supervise`` and ``--progressive``, the render server, the first-hit
AOV pass with the denoiser, device meshes, and the pool plan above 512
prims with its row bands) through its twelve CUDA kernels at full width
(the media free flight and the work queue's path ids, flush and inject
among them), and fails unless every phase passes:

1. the card: its name, and ``nvidia-smi``'s name and power limit; the auto
   checkpoints are cleared, so none shortens a timed render;
2. build the nine sources of ``tpu_ray_torch/csrc`` (one ``nvcc`` each, in
   parallel) and print the build seconds, the register use and the count of
   tensor-core (HMMA) instructions in the matrix-product sweep's SASS;
3. ``torch.sqrt`` on the card correctly rounded (``core.vec.sqrt_rn`` takes
   it there as it is); each kernel against its plain PyTorch version at
   main-path shapes (1M-lane pools), with kernel and plain times from CUDA
   events (kernels from a CUDA graph's replay, the step and ``hit_scatter``
   also launched one by one from the host): the
   dense sweep (also on the first 240k, 60k, 3k and 1 of book1-final's
   bounce-1 rays, the partly filled pools of the pool path; each size with
   the rays per thread the wrapper picks, every instantiation held
   bit-equal to it and timed from a CUDA graph) and the pool step as
   before, the step also on an image
   scene with a seeded image and at the shape the queue gives it (a 1M-lane
   queue state of next-week-final and of the image scene a few iterations
   in: ``n_samples = 0``, zero ``xy``, hashed path ids as slot ids), where
   the skip share of the sorted sweep is read again on those later rays;
   ``hit_scatter`` on cornell and
   two-perlin-spheres; the list pass (tile lists, needed mask, tile order)
   equal to its plain twin, and the sorted, compacted-list sweep at each
   rays-per-thread build on next-week-final, book1-final and the 400-box
   grid against its plain version and bit-equal to the dense sweep kernel,
   with the share of (tile, block) pairs listed and culled, both bounds
   (the dense sweep's, the listed pairs') and the times of the sort, the
   list pass and the whole sorted sweep; the megakernel against its plain
   version (the uncompacted pool loop on tensors) on one wave of cornell at
   1M lanes and of cornell-smoke, two-perlin-spheres and book1-final at
   smaller lane counts, 2 samples per slot and depth 8 (equal sample counts,
   the share of diverged lanes bounded), and timed alone on the full-depth
   waves of phase 5 with its lane-iterations, its warp-iterations and its
   operation bound, each wave launched persistent and at one thread per
   slot (the two bit-equal, with both times, shares and the registers);
   the mask-gated sweep on next-week-final's sorted rays at each
   rays-per-thread build, in the list pass's tile order and in natural
   order, bit-equal to its plain version and to the dense kernel, with the
   list pass's mask and order (against their plain twins) and its time, the
   needed share and the share the cull skipped, and the whole sorted masked
   sweep's time; the tensor-core matrix-product sphere sweep on book1-final
   against its plain version (bit-equal) and against the dense kernel, with
   the share of pairs it retested and its bound beside the scalar form's;
   the step kernel again with the Sobol' camera (cornell) and with the
   strict estimator (two-perlin-spheres and perlin-sky: table noise;
   cornell-smoke: the isotropic phase), ``hit_scatter`` strict (perlin-sky,
   cornell-smoke) and the megakernel with the Sobol' camera (cornell), each
   timed by graph replay beside its uniform, fixed case; the queue's
   sobol-b0 step (the B0 instantiation: first-bounce draws from Sobol' dims
   7-10 of each lane's pixel and sample) on 1M-lane queue states of
   cornell and next-week-final; the step (fixed and strict) and
   ``hit_scatter`` on the textured-checker scene (checkers with textured
   children) and the step on the emissive-image scene (an image dome
   light); the first-hit AOV kernel on 1M camera lanes of cornell and of
   the textured-checker scene, with its bound (68 B a lane); the BVH
   traversal kernel on cornell's 1M camera rays and bounce-1 rays,
   book1-final's 960k bounce-1 rays and next-week-final's 1M bounce-1 rays
   (its fog in the tree), under both tie rules: rule VISIT (``bvh=True``)
   bit-equal to its plain twin and against the brute-force sweep plus
   media (hits equal, prims equal but on equal-t ties, t within rtol
   1e-5), rule INDEX (the route) bit-equal in t and prim to
   ``intersect_ti`` (the dense sweep and media kernels) on every lane and
   to ``intersect_ti``'s plain path (the torch sweep and media merge) at
   the dense sweep's criterion, each rule graph-replayed beside the dense
   sweep and the whole ``intersect_ti`` on the same rays, with its bound
   from the work its counting form counted (the visit rule's also from its
   twin's counts; each
   equal-t tie printed with its ray, for ``tools/torch_bvh_tie.py``, and
   each lane where INDEX differed); the media kernel on the
   1M bounce-1 lanes of cornell-smoke's and next-week-final's pools, bit
   for bit against ``merge_media_plain`` (a differing lane printed with
   its ray), with its bound (48 B a lane); the path-ids kernel and the
   queue's flush and inject kernels on 1M-lane next-week-final queue
   states 6 iterations in (hashed camera, sobol, sobol-b0, and a worklist
   padded past its total), bit for bit against their twins (the plane but
   its trash column), with their bounds from this state's dying and
   refilled lanes;
4. the eight non-strict golden configs rendered on the card (the image
   scenes with the cyan stand-in they were made with), held to the
   cross-engine criterion against ``tests/goldens/<name>.npy``, and an
   image scene with a seeded image rendered on the card against the same
   render on the CPU; the six goldens the megakernel covers again with
   ``engine="mega"``; the four strict goldens at their configs (cornell-smoke
   and simple-light against the golden; book1-final and perlin-sky, whose
   goldens rest on the JAX package's compiled-loop rounding, against the
   CPU's render and the golden's mean), each with its strict-vs-fixed
   margin; the textured-checker scene (pool, strict queue, wave) and the
   emissive-image scene on the card against the CPU, and ``render_aovs`` of
   cornell, cornell-smoke and the textured-checker scene card vs CPU;
5. full width, launch counts set to 0 before each path and read after it:
   pool - cornell 500x500 depth 50 at 64 spp (a 1M-lane pool) and
   book1-final 600x400 at 16 spp; queue - next-week-final (1409 prims)
   400x400, 100 spp, depth 50, unsorted and with the sorted sweep (the two
   images bit-equal); the route (scenes of ``BVH_ROUTE_MIN_PRIMS`` prims
   or more take the BVH kernel under rule INDEX: no sweep or media
   launch) - that queue render bit-equal to the same render with the
   route off (the dense sweep and the media kernel), and book1-final
   600x400 16 spp on the pool (below the count: the dense sweep) bit-equal
   to the same render with the route forced on, each with both walls; the
   queue's epochs replayed from CUDA graphs (``integrator.QueuePlan``):
   next-week-final 400x400 100 spp rendered four times from one scene
   object, a first render that makes no plan, the render that captures, a
   render of another seed that replays every epoch, and that seed again
   with every iteration issued on its own, the last two bit-equal with the
   same launches, with the four walls and the replayed render's
   ``queue_replay_share`` (1);
   wave - cornell 500x500, 64 spp, depth 50; a small
   queue render on the card against the same render on the CPU; megakernel -
   cornell 500x500 64 spp, book1-final 600x400 16 spp and cornell-smoke
   500x500 64 spp with ``engine="mega"`` (one launch per wave, no sweep or
   pool-step launch), each beside the wavefront pool render of the same
   call; a next-week-final queue render with the mask-gated sweep (bit-equal
   to the unsorted one) and a book1-final pool render with the
   matrix-product sphere sweep; with the Sobol' camera, cornell 500x500 64
   spp on the pool and the megakernel (held together, and to the uniform
   image's mean) and next-week-final 400x400 16 spp on the queue; with the
   strict estimator, book1-final 600x400 16 spp, cornell-smoke 500x500 64
   spp, two-perlin-spheres 500x500 16 spp and perlin-sky 600x400 16 spp on
   the pool, cornell-smoke in wave mode and with ``engine="mega"`` (which
   falls back to the wavefront pool); a small sobol queue render and a
   small strict pool render on the card against the CPU; adaptive sampling
   (``render_adaptive``, tol 0.03, depth 50): cornell 500x500 within a
   1000-sample budget on the pool backend and with ``engine="mega"`` (the
   two images under the cross-engine criterion, their count maps apart on
   at most 2% of pixels) and next-week-final 400x400 within 1000 (992
   aligned) on the queue backend, each with its wall, rounds, sample
   counts (within [16, budget], more than one distinct) and image mean
   (within 8% of the uniform render above, the JAX package's own bound:
   pixels that stop at the pilot are darker; over the pixels past the
   pilot within 5%), and the uniform render at the same budget for its
   wall; two adaptive queue renders of
   next-week-final 100x100 (budget 256) bit-equal, and an adaptive pool
   render of cornell 48x48 on the card against the CPU (equal count maps);
   cornell 500x500 64 spp on the queue with ``sobol-b0`` (its mean within
   the spread of four sobol renders' means); the textured-checker scene
   500x500 64 spp on the pool; ``render_aovs`` of cornell 500x500 at 16
   spp and ``denoise`` of the 64-spp pool render on the card, then the
   CLI's ``--aov all`` and ``--denoise`` at that size, each with its wall;
   ``bvh=True``: cornell 500x500 64 spp, book1-final 600x400 16 spp and
   next-week-final 400x400 16 spp (the 160000-lane pool) on the pool, each
   against the brute-force pool render of the same call (cross-engine
   criterion; bit-equal or not is printed) with no sweep launch; the pool
   plan above 512 prims (``bands:``), each render's bands, plans and
   launches printed: (a) next-week-final 400x400 16 spp on the pool, plan
   (1, 2, 8), beside the queue render (one estimator), (b) 600x400 16 spp
   one sample a wave in bands of 266 and 134 rows, bit-equal to the
   unbanded render of the same plan, its rows reported final exact and
   ending at 400, (c) the same with the default plans (1, 2, 8) and (1, 4,
   4), (d) the same with ``bvh=True`` (no sweep launch), (e) cornell
   500x500 16 spp in four forced 125-row bands on the wavefront pool and
   the megakernel, each bit-equal to its unbanded render, (f) a mesh of
   two ``cuda:0`` entries at 600x400 1 spp, demoted from the queue to the
   banded pool, against the single-device render; checkpoint / resume, each
   resumed image bit-equal to the uninterrupted one: cornell 500x500 64 spp
   in 8 waves on the pool and with ``engine="mega"`` (a crash injected by
   ``TPU_RAY_CRASH_AFTER_WAVE=5``, resumed at wave 4) and next-week-final
   400x400 16 spp in 4 queue chunks (an ``on_partial`` that raises after
   chunk 2); the CLI at cornell 500x500 64 spp in 8 waves: ``--supervise
   2`` in a subprocess with a crash before wave 3, its stdout the clean
   run's PPM byte for byte and "retry 1/2" on its stderr, ``--progressive``
   to stdout (the same bytes) and to a PNG rewritten whole after every
   wave; ``serve()`` in this process (ping, warm, two identical cornell
   500x500 64 spp renders, one with ``bvh``, one with ``denoise``, stats,
   quit), each image bit-equal to the direct render, with the first and
   second renders' walls; book1-final 600x400 16 spp with ``engine="mxu"``
   (bit-equal to the ``TPU_RAY_SWEEP_MXU=1`` render, its mean within 2% of
   the dense render's and its share of pixels close at 2e-3 printed) and
   at the JAX package's mxu test configuration (32x24, 8 spp, depth 8) held
   to that test's criteria (more than 95% of pixels close at 2e-3, the
   mean within 2%); then device meshes
   whose entries are all ``cuda:0`` (``make_mesh(device=[...])``; the
   rounds' schedule and keying, not scaling), each against the
   single-device render of the same request at the JAX mesh tests'
   tolerances with both walls: cornell 500x500 64 spp in 8 waves on the
   pool and the megakernel (D = 2, rtol 1e-4 / atol 1e-5),
   next-week-final 400x400 16 spp on the queue (D = 3: a sharded 15-sample
   chunk and a 1-sample chunk on ``mesh[0]``; rtol 1e-5 / atol 1e-6),
   cornell 500x500 adaptive tol 0.03 budget 1000 on the queue backend
   (D = 2, sample counts equal), a per-round resume bit-equal, and
   ``make_mesh(2)`` raising on the one card; last, cornell-smoke 500x500
   64 spp on the pool (media kernel launches counted, its wall beside PR
   12's) and the next-week-final queue renders (unsorted, sorted,
   adaptive) and the cornell sobol-b0 queue render again with
   ``merge_media``, ``path_ids`` and ``queue_inject`` swapped for their
   plain twins by this script (``plain_twins``), each bit-equal to the
   kernels' render; the walls of bands (a), (c) and (d) are printed beside
   their walls before the media and queue kernels (``WALLS_BEFORE``);
6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.  It imports
nothing of JAX.  Without a CUDA device, or outside the repository, it
exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device")

from tpu_ray_torch import adaptive, aov, integrator, renderer  # noqa: E402
from tpu_ray_torch.core import rng, vec  # noqa: E402
from tpu_ray_torch.core.film import to_rgb8  # noqa: E402
from tpu_ray_torch.denoise import denoise  # noqa: E402
from tpu_ray_torch.integrator import (SceneKernels, _queue_init,  # noqa: E402
                                      _to_i32_bits, init_pool_state,
                                      queue_body)
from tpu_ray_torch.models import objects as ob  # noqa: E402
from tpu_ray_torch.models.compile import build_scene  # noqa: E402
from tpu_ray_torch.models.scenes import SCENES  # noqa: E402
from tpu_ray_torch.utils import cli, profiling  # noqa: E402
from tpu_ray_torch.ops import (build, bvh, hit_scatter,  # noqa: E402
                               intersect, megakernel, queue, shade, sweep)
from tpu_ray_torch.ops.intersect import intersect_ti  # noqa: E402
from tpu_ray_torch.renderer import (pick_samples_per_wave, pixel_grid,  # noqa: E402
                                    plan_pool, render, resolve_mode,
                                    slot_ids)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, fp32 outside tensor cores
TF32_FLOPS_PER_S = 495e12       # H100 SXM data sheet, dense TF32 tensor cores
SEED = 1024
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
GOLDENS = {   # tests/test_golden.py CONFIGS: (spp, depth, width, height)
    "two-spheres": (16, 8, 32, 24),
    "cornell": (32, 12, 32, 24),
    "book1-final": (8, 8, 32, 24),
    "cornell-smoke": (16, 8, 24, 16),
    "simple-light": (16, 8, 24, 16),
    "two-perlin-spheres": (4, 4, 24, 16),
    "earth": (4, 4, 24, 16),
    "random-moving": (4, 4, 24, 16),
}
DEV = torch.device("cuda")
# the megakernel's full-width renders: (scene, width, height, spp), depth 50
MEGA_FULL = (("cornell", 500, 500, 64), ("book1-final", 600, 400, 16),
             ("cornell-smoke", 500, 500, 64))
# the strict estimator's full-width pool renders: no lights (book1-final),
# media (cornell-smoke), table-noise marble (two-perlin-spheres is black:
# no emitter, black sky; perlin-sky lights the same spheres)
STRICT_FULL = (("book1-final", 600, 400, 16), ("cornell-smoke", 500, 500, 64),
               ("two-perlin-spheres", 500, 500, 16),
               ("perlin-sky", 600, 400, 16))
# tests/test_torch_strict.py STRICT_GOLDENS: (spp, depth, width, height,
# strict-vs-fixed margin (None: the two perlin-sky goldens'), reference)
STRICT_GOLDENS = {
    "book1-final": (8, 8, 32, 24, 0.120133, "cpu"),
    "cornell-smoke": (16, 8, 24, 16, 0.019782, "golden"),
    "simple-light": (16, 8, 24, 16, 0.001433, "golden"),
    "perlin-sky": (8, 6, 24, 16, None, "cpu"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per launch of the kernel wrapper ``fn``: ``reps``
    launches captured in a CUDA graph and replayed back to back (after a
    warm-up call and a warm-up replay), so the host's per-launch work, which
    exceeds a short kernel's time, does not pace the card."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def box_grid():
    """The 20 x 20 grid of ground boxes of next-week-final (a scene of 400
    solid boxes under its camera): the sweep's box range at main-path
    widths, which no pool-path scene of the library has."""
    r = np.random.default_rng(SEED)
    ground = ob.Lambertian((0.48, 0.83, 0.53))
    boxes = [ob.Box((i * 100.0 - 1000.0, 0.0, j * 100.0 - 1000.0),
                    (i * 100.0 - 900.0, r.uniform(1.0, 101.0),
                     j * 100.0 - 900.0), ground)
             for i in range(20) for j in range(20)]
    return build_scene(boxes, background=(0.7, 0.8, 0.9), t_min=1e-2)


def seeded_image():
    """A 32 x 64 texel image from a numpy seed, for the image scenes (the
    earth map itself is not in the repository)."""
    return np.random.default_rng(3).integers(0, 256, (32, 64, 3), np.uint8)


def perlin_sky():
    """tests/test_perlin_strict.py's perlin-sky scene: two-perlin-spheres'
    marble spheres under a sky, the scene of the perlin-sky goldens."""
    per = ob.Noise(scale=1.5, seed=SEED)
    return build_scene([ob.Sphere((0, -1000, 0), 1000, ob.Lambertian(per)),
                        ob.Sphere((0, 2, 0), 2, ob.Lambertian(per))],
                       background=(0.7, 0.8, 0.9))


def textured_checker():
    """Checkers whose children are textures (``checker_fancy``; the CPU
    tests' ``tests/torch_port_common.py::textured_checker_scene``):
    simple-light's layout with a Checker(SolidColor, Noise) ground and a
    Checker(Noise, ImageTexture) sphere, under a dim sky."""
    ground = ob.Lambertian(ob.Checker(ob.SolidColor((0.2, 0.3, 0.1)),
                                      ob.Noise(scale=4.0, seed=SEED)))
    ball = ob.Lambertian(ob.Checker(ob.Noise(scale=2.0, seed=SEED + 1),
                                    ob.ImageTexture(seeded_image())))
    light = ob.DiffuseLight((4.0, 4.0, 4.0))
    sphere_light = ob.Sphere((0, 7, 0), 2, light)
    rect_light = ob.Rect("xy", 3, 5, 1, 3, -2, light)
    return build_scene([ob.Sphere((0, -1000, 0), 1000, ground),
                        ob.Sphere((0, 2, 0), 2, ball), sphere_light,
                        rect_light], lights=[sphere_light, rect_light],
                       background=(0.2, 0.25, 0.3))


def emissive_image():
    """An image on a light (``image_on_emissive``; the CPU tests'
    ``emissive_image_scene``): an emissive image dome of radius 500 around
    a Lambertian sphere and a metal one."""
    dome = ob.Sphere((0, 0, 0), 500,
                     ob.DiffuseLight(ob.ImageTexture(seeded_image())))
    return build_scene([dome,
                        ob.Sphere((0, 2, 0), 2, ob.Lambertian((0.7, 0.6, 0.5))),
                        ob.Sphere((0, 0.5, 3), 0.5, ob.Metal((0.8, 0.8, 0.8),
                                                            0.1))])


def scene_and_camera(name: str, width: int, height: int, earth=None,
                     sampler="uniform", strict=False):
    """A scene on the card and its camera: ``sampler`` the camera sampler,
    ``strict`` the strict reference estimator.  "checker-tex" and
    "emissive-image" are seen through two-spheres' camera."""
    if name in ("checker-tex", "emissive-image"):
        scene = (textured_checker() if name == "checker-tex"
                 else emissive_image())
        cam = SCENES["two-spheres"].camera(width, height)
    elif name == "box-grid":
        scene, cam = box_grid(), SCENES["next-week-final"].camera(width,
                                                                  height)
    elif name == "perlin-sky":
        scene = perlin_sky()
        cam = SCENES["two-perlin-spheres"].camera(width, height)
    else:
        spec = SCENES[name]
        scene, cam = (spec.build(seed=SEED, earth=earth),
                      spec.camera(width, height))
    return (scene.replace(strict=strict).to(DEV),
            cam.replace(sampler=sampler))


def variant(sampler="uniform", strict=False) -> str:
    """The label of a render's options: " sobol", " strict", ..."""
    return ((f" {sampler}" if sampler != "uniform" else "")
            + (" strict" if strict else ""))


def pool_after(name: str, width: int, height: int, spp: int, iters: int,
               earth=None, sampler="uniform", strict=False):
    """A full-width pool of ``name`` advanced ``iters`` iterations through
    the kernels; returns what the next iteration's two kernels take."""
    scene, cam = scene_and_camera(name, width, height, earth, sampler,
                                  strict)
    k_pool = pick_samples_per_wave(width, height, spp, 1 << 20)
    cfg = shade.StepConfig.create(scene, cam, width, height, 50,
                                  n_samples=spp // k_pool, cam_salt=SEED)
    kern = SceneKernels.create(scene)
    st = init_pool_state(pixel_grid(width, height, k_pool, DEV),
                         slot_ids(width, height, k_pool, DEV))
    R = st.slot.shape[0]
    none_t = torch.empty(R, dtype=torch.float32, device=DEV)
    none_i = torch.zeros(R, dtype=torch.int32, device=DEV)
    st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot, st.fstate,
                                           st.istate, none_t, none_i, (0, 0),
                                           init=True)
    k_isect, k_scat = rng.pool_key_tables(
        rng.fold_in(rng.prng_key(SEED), 0), iters + 1)
    for it in range(iters):
        bt, bi = intersect_ti(scene, st.fstate[:7], k_isect[it], st.slot,
                              kern.geo, kern.media)
        st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot,
                                               st.fstate, st.istate, bt, bi,
                                               k_scat[it])
    return scene, cfg, kern, st, k_isect[iters], k_scat[iters]


def sweep_flops(scene, R: int) -> float:
    n_mov = scene.n_sphere - scene.n_sphere_static
    n_quad = scene.n_solid - scene.n_sphere - scene.n_box
    per_ray = (scene.n_sphere_static * sweep.FLOPS_PER_PAIR["sphere"]
               + n_mov * sweep.FLOPS_PER_PAIR["moving"]
               + scene.n_box * sweep.FLOPS_PER_PAIR["box"]
               + n_quad * sweep.FLOPS_PER_PAIR["quad"])
    return float(R) * per_ray


def hold_sweep(what, R, got, plain, kernel="sweep"):
    """The dense sweep kernel's (t, i), or another ``kernel``'s with the
    sweep's function, against the plain sweep's: at most 1e-5 of the rays
    hit the other way, are out of tolerance in t or name another prim
    (exact ties aside).  Returns the max abs error in t."""
    (bt, bi), (pt, pi) = got, plain
    hit_k, hit_p = torch.isfinite(bt), torch.isfinite(pt)
    hit_mismatch = int((hit_k != hit_p).sum())
    both = hit_k & hit_p
    err = (bt[both] - pt[both]).abs()
    max_abs = float(err.max()) if int(both.sum()) else 0.0
    bad_t = int((err > 1e-5 + 2e-5 * pt[both].abs()).sum())
    idx_diff = both & (bi != pi)
    ties = int((idx_diff & (bt == pt)).sum())
    bad_i = int(idx_diff.sum()) - ties
    log(f"{kernel} {what} R={R}: hits {int(hit_k.sum())}, "
        f"hit mismatches {hit_mismatch}, t max abs err {max_abs:.3e}, "
        f"t out of tol {bad_t}, idx mismatches {bad_i} (+{ties} exact ties)")
    if hit_mismatch > 1e-5 * R or bad_t > 1e-5 * R or bad_i > 1e-5 * R:
        raise AssertionError(f"{kernel} kernel disagrees with plain on "
                             f"{what}")
    return max_abs


def sweep_bound(scene, geo, R):
    """(bound ms, what binds) of the dense sweep over R rays."""
    nbytes = R * (7 * 4 + 8) + geo.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sweep_flops(scene, R) / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_sweep(name, width, height, spp, iters, parts=()):
    """Sweep kernel vs sweep_plain on one full-width pool's rays, and on its
    first ``parts`` rays (the partly filled pools the pool path launches
    the sweep on): each size with the rays per thread the wrapper picks
    and the time of every rays-per-thread instantiation."""
    scene, _, kern, st, _, _ = pool_after(name, width, height, spp, iters)
    ranges = sweep._ranges(scene)
    sms = sweep.sm_count(DEV)
    out = None
    for R in (st.fstate.shape[1],) + tuple(parts):
        rays = st.fstate[:7, :R].contiguous()
        what = f"{name} iters={iters}"
        run = lambda rpt: sweep.sweep_launch(rays, kern.geo, ranges,
                                             scene.t_min, rpt)
        plain = sweep.sweep_plain(rays, kern.geo, ranges, scene.t_min)
        got = sweep.sweep(rays, kern.geo, ranges, scene.t_min)
        max_abs = hold_sweep(what, R, got, plain)
        for rpt in (1, 2, 4):    # every instantiation gives the same bits
            t, i = run(rpt)
            if not (torch.equal(t, got[0]) and torch.equal(i, got[1])):
                raise AssertionError(f"sweep at {rpt} rays per thread differs "
                                     f"on {what} R={R}")
        rpt = sweep.pick_rpt(R, sms, ranges[3])
        dense = lambda: sweep.sweep(rays, kern.geo, ranges, scene.t_min)
        ms = kernel_ms(dense)
        events_ms = cuda_ms(dense, 20)
        by_rpt = {k: kernel_ms(lambda: run(k)) for k in (1, 2, 4)}
        plain_ms = cuda_ms(lambda: sweep.sweep_plain(rays, kern.geo, ranges,
                                                     scene.t_min), 3)
        bound_ms, bound_by = sweep_bound(scene, kern.geo, R)
        log(f"sweep {what} R={R}: kernel {ms:.4f} ms at {rpt} rays/thread "
            f"(1, 2, 4 rays/thread: {by_rpt[1]:.4f}, {by_rpt[2]:.4f}, "
            f"{by_rpt[4]:.4f} ms; launched from the host one by one "
            f"{events_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        got = dict(ms=ms, events_ms=events_ms, rpt=rpt, ms_by_rpt=by_rpt,
                   bound_ms=bound_ms)
        if out is None:
            out = dict(got, plain_ms=plain_ms, bound_by=bound_by,
                       max_abs_err=max_abs, parts={})
        else:
            out["parts"][R] = got
    return out


def plain_ti(scene, kern, rays, ki, lanes):
    """``intersect_ti``'s plain path on card tensors: the dense sweep's and
    the media merge's torch twins (rule INDEX's plain version)."""
    bt, bi = sweep.sweep_plain(rays, kern.geo, sweep._ranges(scene),
                               scene.t_min)
    if scene.has_media:
        bt, bi = intersect.merge_media_plain(scene, rays, ki, lanes,
                                             kern.media, bt, bi)
    return bt, bi


def bvh_bound(scene, R, flops):
    """(bound ms, what binds) of a traversal doing ``flops`` over R rays:
    40 B a ray (7 floats in, t and id out, and the lane id with media)."""
    t_bytes = R * (36 + (4 if scene.has_media else 0)) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_bvh(name, width, height, spp, iters):
    """The BVH kernel's two tie rules on one full-width pool's rays after
    ``iters`` iterations (0: camera rays).

    Rule VISIT (``bvh=True``): bit-equal to its plain twin on every lane;
    against the brute-force sweep plus media (``intersect_ti``: the dense
    sweep and media kernels) ``hit`` equal on every lane, ``prim`` equal on
    every hit lane but equal-t ties (the visit order is not the index
    order), t within rtol 1e-5.  Rule INDEX (the route): bit-equal in t and
    prim to ``intersect_ti`` on every lane, ties included, and held to its
    plain version (``plain_ti``: the torch sweep and media merge) at the
    dense sweep kernel's criterion (``hold_sweep``), its max abs error the
    kernels line's.  Each rule timed by graph replay beside the dense sweep
    and the whole ``intersect_ti`` (sweep and media kernels) on the same
    rays.

    Rule INDEX walks wide records; the pair walk packed in their format
    (``pack_nodes(..., width=2)``: one record a node, each with its two
    children) runs beside it through the same kernel, held
    to the same bits, timed and counted: per ray its records, children
    tested, pops, the share of rays that ran out of their budget (brute)
    and the SIMD share (lane_steps / (32 warp_steps)) against the wide
    walk's.

    Each rule's bound counts the work its kernel did on these rays, which
    its counting form counts (``stats``): ~25 fp32 operations a child box
    tested (~40 under INDEX), 2 a stack entry popped, each leaf pair's
    math (21 a static sphere, 27 moving, 24 box, 31 quad, ~40 a medium)
    over 67 TFLOP/s, against 36 B a ray (7 floats in, t and id out; 4 B
    more for the lane id that keys the media draws) over 3.35 TB/s; the
    larger of the two.  INDEX's bound is reckoned from the pair walk's
    counts (the same work as before the records went wide), the wide
    walk's own beside it.  VISIT's bound from its twin's counts (25 a node
    visit, JAX's lockstep loop) is printed beside it."""
    scene, _, kern, st, ki, _ = pool_after(name, width, height, spp, iters)
    rays, lanes = st.fstate[:7], st.slot
    R = rays.shape[1]
    visit = bvh.BVHTables.create(scene, None, kern.geo, kern.media)
    index = bvh.BVHTables.create(scene, visit.bvh, kern.geo, kern.media,
                                 rule=bvh.INDEX)
    rows = bvh.pack_nodes(visit.bvh, bvh.INDEX, scene, 2)
    pair = dataclasses.replace(index, nodes=rows, stack=max(
        bvh.wide_stack_bound(rows.cpu().numpy()), 1))
    got = bvh.intersect_bvh(scene, visit, rays, ki, lanes)
    twin_stats = {}
    plain = bvh.intersect_bvh_plain(scene, visit, rays, ki, lanes,
                                    twin_stats)
    twin_equal = (torch.equal(got[0], plain[0])
                  and torch.equal(got[1], plain[1]))
    fin = torch.isfinite(got[0]) & torch.isfinite(plain[0])
    visit_err = (float((got[0][fin] - plain[0][fin]).abs().max())
                 if int(fin.sum()) else 0.0)
    ft, fi = intersect_ti(scene, rays, ki, lanes, kern.geo, kern.media)
    (bt, bi) = got
    hit_b, hit_f = torch.isfinite(bt), torch.isfinite(ft)
    hit_mismatch = int((hit_b != hit_f).sum())
    both = hit_b & hit_f
    err = (bt[both] - ft[both]).abs()
    max_abs = float(err.max()) if int(both.sum()) else 0.0
    bad_t = int((err > 1e-5 * ft[both].abs()).sum())
    idx_diff = both & (bi != fi)
    ties = int((idx_diff & (bt == ft)).sum())
    bad_i = int(idx_diff.sum()) - ties
    it, ii = bvh.intersect_bvh(scene, index, rays, ki, lanes)
    index_diff = bits_differ(it, ft) | (ii != fi)
    n_index_diff = int(index_diff.sum())
    pt, pi = bvh.intersect_bvh(scene, pair, rays, ki, lanes)
    n_pair_diff = int((bits_differ(pt, ft) | (pi != fi)).sum())
    index_err = hold_sweep(f"{name} iters={iters}", R, (it, ii),
                           plain_ti(scene, kern, rays, ki, lanes),
                           "bvh INDEX vs plain_ti:")
    walks = {"VISIT": visit, "INDEX": index, "pair": pair}
    counts = {}
    for key, tables in walks.items():
        s = torch.zeros(len(bvh.STAT_KEYS), dtype=torch.int64, device=DEV)
        bvh.intersect_bvh_launch(scene, tables, rays, ki, lanes, s)
        counts[key] = dict(zip(bvh.STAT_KEYS, s.tolist()))
    ms = {key: kernel_ms(lambda: bvh.intersect_bvh(scene, t, rays, ki,
                                                   lanes))
          for key, t in walks.items()}
    ranges = sweep._ranges(scene)
    sweep_ms = kernel_ms(lambda: sweep.sweep(rays, kern.geo, ranges,
                                             scene.t_min))
    ti_ms = kernel_ms(lambda: intersect_ti(scene, rays, ki, lanes, kern.geo,
                                           kern.media))
    plain_ms = cuda_ms(lambda: bvh.intersect_bvh_plain(scene, visit, rays,
                                                       ki, lanes), 1)
    plain_ti_ms = cuda_ms(lambda: plain_ti(scene, kern, rays, ki, lanes), 1)
    bounds = {key: bvh_bound(scene, R, bvh.kernel_flops(
        c, bvh.VISIT if key == "VISIT" else bvh.INDEX))
        for key, c in counts.items()}
    twin_bound = bvh_bound(scene, R, bvh.traversal_flops(twin_stats))
    per_ray = {key: {k: round(v / R, 3) for k, v in c.items()}
               for key, c in counts.items()}
    walk = {key: dict(records=round(c["records"] / R, 3),
                      children=round(c["children"] / R, 3),
                      pops=round(c["pops"] / R, 3),
                      brute_share=c["brute"] / R,
                      simd_share=round(c["lane_steps"]
                                       / (32 * max(c["warp_steps"], 1)), 4))
            for key, c in counts.items()}
    twin_per_ray = {k: round(v / R, 3) for k, v in twin_stats.items()
                    if k != "rays"}
    what = f"{name} iters={iters} R={R}"
    log(f"bvh {what}: VISIT bit-equal to its twin {twin_equal}; against "
        f"the brute-force sweep + media: hits {int(hit_b.sum())}, hit "
        f"mismatches {hit_mismatch}, t max abs err {max_abs:.3e}, t out of "
        f"rtol 1e-5 {bad_t}, prim mismatches {bad_i} (+{ties} exact ties); "
        f"INDEX lanes differing from intersect_ti in t or prim "
        f"{n_index_diff} (the pair walk {n_pair_diff})")
    log(f"bvh {what}: ms VISIT {ms['VISIT']:.4f}, INDEX {ms['INDEX']:.4f} "
        f"(the pair walk {ms['pair']:.4f}); "
        f"dense sweep {sweep_ms:.4f}, intersect_ti (sweep + media) "
        f"{ti_ms:.4f}; plain: lockstep twin {plain_ms:.2f}, intersect_ti's "
        f"{plain_ti_ms:.2f}; bound VISIT {bounds['VISIT'][0]:.4f} "
        f"({bounds['VISIT'][1]}; from its twin's counts "
        f"{twin_bound[0]:.4f}), INDEX {bounds['pair'][0]:.4f} "
        f"({bounds['pair'][1]}; from the wide walk's own counts "
        f"{bounds['INDEX'][0]:.4f}); kernel counts per ray "
        f"{json.dumps(per_ray)}, twin's {json.dumps(twin_per_ray)}")
    log(f"bvh {what}: per ray (records, children, pops, brute share, SIMD "
        f"share) {json.dumps(walk)}; the wide walk's stack bound "
        f"{index.stack}, the pair walk's {pair.stack}")
    # the equal-t ties, each with its ray bit for bit (float.hex), so that
    # tools/torch_bvh_tie.py can run it through the JAX package's traversal
    for lane in (idx_diff & (bt == ft)).nonzero().flatten()[:4].tolist():
        log("bvh tie: " + json.dumps(dict(
            scene=name, iters=iters, lane=lane, slot=int(lanes[lane]),
            key=[int(k) for k in ki],
            ray=[float(v).hex() for v in rays[:, lane].tolist()],
            t=float(bt[lane]).hex(), sweep_prim=int(fi[lane]),
            bvh_prim=int(bi[lane]), index_prim=int(ii[lane]))))
    for lane in index_diff.nonzero().flatten()[:8].tolist():
        log("bvh index differs: " + json.dumps(dict(
            scene=name, iters=iters, lane=lane, slot=int(lanes[lane]),
            ray=[float(v).hex() for v in rays[:, lane].tolist()],
            t=float(it[lane]).hex(), prim=int(ii[lane]),
            sweep_t=float(ft[lane]).hex(), sweep_prim=int(fi[lane]))))
    if not twin_equal:
        raise AssertionError(f"bvh kernel differs from its twin on {what}")
    if hit_mismatch or bad_t or bad_i:
        raise AssertionError(f"bvh disagrees with the brute-force sweep on "
                             f"{what}")
    if n_index_diff or n_pair_diff:
        raise AssertionError(f"bvh rule INDEX differs from intersect_ti on "
                             f"{n_index_diff} lanes of {what} (the pair "
                             f"walk on {n_pair_diff})")
    return dict(rule=bvh.INDEX, ms=ms["INDEX"], plain_ms=plain_ti_ms,
                bound_ms=bounds["pair"][0], bound_by=bounds["pair"][1],
                wide_bound_ms=bounds["INDEX"][0], max_abs_err=index_err,
                sweep_ms=sweep_ms, intersect_ti_ms=ti_ms,
                per_ray=per_ray["INDEX"], walk=walk,
                stack=index.stack,
                pair=dict(ms=ms["pair"], per_ray=per_ray["pair"],
                          stack=pair.stack),
                visit=dict(ms=ms["VISIT"], plain_ms=plain_ms,
                           bound_ms=bounds["VISIT"][0],
                           bound_by=bounds["VISIT"][1],
                           twin_bound_ms=twin_bound[0],
                           max_abs_err=visit_err,
                           max_abs_err_vs_sweep=max_abs, equal_t_ties=ties,
                           per_ray=per_ray["VISIT"],
                           twin_per_ray=twin_per_ray))


STEP_TOL = {   # tests/test_shade_pallas.py:68-86
    "origin": (2e-4, 1e-3), "direction": (1e-3, 1e-4), "time": (2e-4, 1e-5),
    "throughput": (2e-4, 1e-5), "accum": (2e-4, 1e-5),
}
STEP_ROWS = {"origin": slice(0, 3), "direction": slice(3, 6),
             "time": slice(6, 7), "throughput": slice(7, 10),
             "accum": slice(10, 13)}


def queue_after(name: str, width: int, height: int, iters: int, earth=None,
                sampler="uniform", worklist=None):
    """A 1M-lane work queue of ``name`` advanced ``iters`` iterations as
    ``trace_queue`` drives it; returns what the next iteration's kernels
    take: the step configuration with ``n_samples = 0`` (with sampler
    sobol-b0, the first-bounce override under the camera salt), zero
    ``xy``, the hashed path ids as slot ids, and lanes at mixed bounces;
    with sobol-b0, ``st.lane`` holds each lane's (pixel, global sample).
    With ``worklist`` ((Wl,) int64 packed entries, ``worklist_items``) the
    items come from its first Wl - WL_PAD entries, the rest padding."""
    scene, cam = scene_and_camera(name, width, height, earth, sampler)
    R, chunk_spp = 1 << 20, 8
    total = width * height * chunk_spp
    pad = None
    if worklist is not None:
        pad, total = worklist.shape[0], worklist.shape[0] - WL_PAD
    cfg = shade.StepConfig.create(scene, cam, width, height, 50, n_samples=0,
                                  cam_salt=SEED, queue=True)
    kern = SceneKernels.create(scene, False)
    key = rng.fold_in(rng.prng_key(SEED), 0x5EED)
    ki, ks = rng.fold_in(key, 0), rng.fold_in(key, 1)
    st = _queue_init(R, total, DEV, pad, b0=cfg.b0)
    for _ in range(iters):
        st = queue_body(st, scene, cfg, kern, ki, ks, SEED, 0, total, width,
                        height, worklist)
    sid = _to_i32_bits(rng.path_ids(st.work, st.istate[0]))
    xy = torch.zeros((2, R), dtype=torch.float32, device=DEV)
    return scene, cfg, kern, st, ki, ks, xy, sid


# padding entries past a phase-3 worklist's items
WL_PAD = 100000


def worklist_items(width: int, height: int, spp: int):
    """(W * H * spp,) int64 packed worklist entries of random (pixel,
    sample) pairs from the seed, as the adaptive rounds pack them."""
    r = np.random.default_rng(SEED)
    n = width * height * spp
    return torch.from_numpy((r.integers(0, width * height, n)
                             << queue.WL_SAMP_BITS)
                            | r.integers(0, 1 << queue.WL_SAMP_BITS, n)
                            ).to(DEV)


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lanes (last axis) where two tensors differ in any bit."""
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    d = a != b
    return d if d.dim() == 1 else d.any(dim=0)


def check_media(name, width, height, spp, iters):
    """The media kernel against ``merge_media_plain`` on one full-width
    pool's rays after ``iters`` iterations (1M lanes), with the solids'
    hits of the dense sweep kernel and the pool's slot ids: bit-equal on
    every lane (each differing lane printed with its ray, bit for bit), the
    twin on these card tensors launching nothing; the kernel timed by graph
    replay beside the twin.  Bound: 48 B a lane over 3.35 TB/s against
    ``intersect.media_ops`` a lane over 67 TFLOP/s."""
    scene, _, kern, st, ki, _ = pool_after(name, width, height, spp, iters)
    rays, lanes = st.fstate[:7], st.slot
    R = rays.shape[1]
    solids = sweep.sweep(rays, kern.geo, sweep._ranges(scene), scene.t_min)
    run = lambda: intersect.merge_media(scene, rays, ki, lanes, kern.media,
                                        *solids)
    plain = lambda: intersect.merge_media_plain(scene, rays, ki, lanes,
                                                kern.media, *solids)
    got = run()
    launches = intersect.merge_media.launches
    want = plain()
    torch.cuda.synchronize()
    if intersect.merge_media.launches != launches:
        raise AssertionError("the media twin launched the kernel")
    bad = bits_differ(got[0], want[0]) | bits_differ(got[1], want[1])
    n_bad = int(bad.sum())
    fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
    max_abs = float((got[0][fin] - want[0][fin]).abs().max()) \
        if int(fin.sum()) else 0.0
    n_med = int((want[1] >= scene.n_solid).sum())
    what = f"{name} iters={iters} R={R}"
    for lane in bad.nonzero().flatten()[:4].tolist():
        log("media lane: " + json.dumps(dict(
            scene=name, iters=iters, lane=lane, slot=int(lanes[lane]),
            key=[int(k) for k in ki],
            ray=[float(v).hex() for v in rays[:, lane].tolist()],
            kernel=[float(got[0][lane]).hex(), int(got[1][lane])],
            plain=[float(want[0][lane]).hex(), int(want[1][lane])])))
    ms = kernel_ms(run)
    plain_ms = cuda_ms(plain, 3)
    t_bytes = R * 48 / HBM_BYTES_PER_S
    t_ops = R * intersect.media_ops(kern.media, scene.any_transform) \
        / FP32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"media {what}: lanes differing from the twin {n_bad}, lanes in a "
        f"medium {n_med}, t max abs err {max_abs:.3e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if n_bad:
        raise AssertionError(f"the media kernel differs from its twin on "
                             f"{what}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=max_abs, media_lanes=n_med)


def check_inject(name, width, height, iters, sampler="uniform",
                 worklist=False):
    """The path-ids kernel and the queue's flush and inject kernels against
    their twins on a 1M-lane queue state ``iters`` iterations in (with
    ``worklist``, the items of ``worklist_items`` padded by ``WL_PAD``),
    after the next iteration's sweep and step: draw ids (also past 2^32),
    lane state, work items, frontier, sobol-b0 record, the census cell and
    every plane column but the twin's trash column bit for bit.  Timed,
    with the census cell as a render passes it, by graph replay
    (the inject with its step outputs restored before each launch, that
    copy's own time subtracted).  Bounds: path ids 16 B a lane; the inject
    24 B a lane, 24 a lane that died, 60 a lane refilled (+8 with a
    worklist), 16 a lane with sobol-b0, over 3.35 TB/s, against
    ``queue.inject_ops`` over 67 TFLOP/s.  The inject's bound is also
    counted in the 32-byte sectors its scattered accesses touch
    (``inject_sectors``)."""
    wl = worklist_items(width, height, 8) if worklist else None
    scene, cfg, kern, st, ki, ks, xy, sid = queue_after(
        name, width, height, iters, sampler=sampler, worklist=wl)
    m = st.work.shape[0]
    total = wl.shape[0] - WL_PAD if worklist else width * height * 8
    what = (f"{name}{variant(sampler)}{' worklist' if worklist else ''} "
            f"iters={iters} R={m}")
    ids_equal = True
    for id0 in (0, (1 << 32) - 12345):
        ids_equal &= torch.equal(queue.path_ids(st.work, id0, st.istate[0]),
                                 queue.path_ids_plain(st.work, id0,
                                                      st.istate[0]))
    bt, bi = kern.intersect(scene, st.fstate[:7], ki, sid)
    f, i = shade.pool_step(cfg, xy, sid, st.fstate, st.istate, bt, bi, ks,
                           lane_b0=st.lane)
    args = lambda fx, ix, plane: (cfg, SEED, st.istate[2], fx, ix, st.work,
                                  st.frontier, plane, st.lane, wl, total, 0,
                                  width, height)
    fk, ik, pk = f.clone(), i.clone(), st.plane.clone()
    fp, ip, pp = f.clone(), i.clone(), st.plane.clone()
    ck, cp = st.census.clone(), st.census.clone()
    got = queue.queue_inject(*args(fk, ik, pk), census=ck)
    launches = queue.queue_inject.launches, queue.path_ids.launches
    want = queue.queue_inject_plain(*args(fp, ip, pp), census=cp)
    queue.path_ids_plain(st.work, 0, st.istate[0])
    torch.cuda.synchronize()
    if (queue.queue_inject.launches, queue.path_ids.launches) != launches:
        raise AssertionError("the queue twins launched a kernel")
    bad = bits_differ(fk, fp) | bits_differ(ik, ip) | bits_differ(
        got[2], want[2])
    if cfg.b0:
        bad |= bits_differ(got[4], want[4])
    n_bad = int(bad.sum())
    same = (n_bad == 0 and ids_equal and torch.equal(got[3], want[3])
            and torch.equal(pk[:, :-1], pp[:, :-1]) and torch.equal(ck, cp))
    free = i[2] == 0
    died = free & (st.istate[2] > 0)
    refilled = free & (got[2] != st.work)
    n_free, n_died, n_ref = (int(x.sum()) for x in (free, died, refilled))
    for lane in bad.nonzero().flatten()[:4].tolist():
        log("inject lane: " + json.dumps(dict(
            what=what, lane=lane, work=[int(st.work[lane]),
                                        int(got[2][lane]), int(want[2][lane])],
            kernel=[float(v).hex() for v in fk[:, lane].tolist()],
            plain=[float(v).hex() for v in fp[:, lane].tolist()])))
    ids_ms = kernel_ms(lambda: queue.path_ids(st.work, 0, st.istate[0]))
    ids_plain_ms = cuda_ms(lambda: queue.path_ids_plain(st.work, 0,
                                                        st.istate[0]), 3)
    fw, iw, pw, cw = f.clone(), i.clone(), st.plane.clone(), ck.clone()
    restore = lambda: iw.copy_(i)
    ms = kernel_ms(lambda: (restore(), queue.queue_inject(*args(fw, iw, pw),
                                                          census=cw))
                   ) - kernel_ms(restore)
    plain_ms = cuda_ms(lambda: (restore(), queue.queue_inject_plain(
        *args(fw, iw, pw))), 3)
    nbytes = (24 * m + 24 * n_died + (68 if worklist else 60) * n_ref
              + (16 * m if cfg.b0 else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = queue.inject_ops(m, n_ref, cfg.sobol) / FP32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    ids_bound_ms = 1e3 * 16 * m / HBM_BYTES_PER_S
    sec_bytes = inject_sectors(st, pk, died, refilled, got[2], wl,
                               cfg.b0)
    sec_bound_ms = 1e3 * max(sec_bytes / HBM_BYTES_PER_S, t_ops)
    log(f"queue {what}: inject bound in 32-byte sectors {sec_bound_ms:.4f} "
        f"ms ({sec_bytes / m:.1f} B a lane)")
    log(f"queue {what}: frontier {int(st.frontier)} -> {int(want[3])} of "
        f"{total}, free {n_free}, died {n_died}, refilled {n_ref}, census "
        f"{int(st.census)} -> {int(ck)}; "
        f"bit-equal to the twins {same} (lanes differing {n_bad}, path ids "
        f"{ids_equal}); inject {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / m:.1f} B a lane); path "
        f"ids {ids_ms:.4f} ms, plain {ids_plain_ms:.3f} ms, bound "
        f"{ids_bound_ms:.4f} ms")
    if not same:
        raise AssertionError(f"the queue kernels differ from their twins on "
                             f"{what}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=0.0, free=n_free,
                died=n_died, refilled=n_ref, bytes_per_lane=nbytes / m,
                sector_bound_ms=sec_bound_ms,
                sector_bytes_per_lane=sec_bytes / m,
                path_ids=dict(ms=ids_ms, plain_ms=ids_plain_ms,
                              bound_ms=ids_bound_ms, bound_by="bytes",
                              max_abs_err=0.0))


def inject_sectors(st, plane, died, refilled, new_work, worklist, b0):
    """Bytes of the 32-byte sectors the flush and inject move on this
    state: the per-lane arrays whole (24 B a lane: the active flags in,
    the work items in and out; 16 more with sobol-b0's record), and for
    the scattered accesses each sector any lane touches - the dying lanes'
    radiance rows (3) and their plane columns (3 rows, scattered by work
    item), the refilled lanes' ray, throughput and radiance rows (13) and
    bounce and active rows (2), and with a worklist the refilled lanes'
    entries (8 B each)."""
    m = st.work.shape[0]
    sec = lambda idx, per=8: int(torch.unique(idx // per).numel())
    d = died.nonzero().flatten()
    r = refilled.nonzero().flatten()
    stride = plane.stride(0)
    cols = st.work[died]
    nbytes = 24 * m + (16 * m if b0 else 0) + 32 * (
        3 * sec(d) + sum(sec(k * stride + cols) for k in range(3))
        + 15 * sec(r))
    if worklist is not None:
        nbytes += 32 * sec(new_work[refilled], 4)
    return nbytes


def check_step(name, width, height, spp, iters, earth=None,
               sampler="uniform", strict=False):
    """Pool-step kernel vs pool_step_plain on a full-width pool state."""
    scene, cfg, kern, st, ki, ks = pool_after(name, width, height, spp, iters,
                                              earth, sampler, strict)
    bt, bi = intersect_ti(scene, st.fstate[:7], ki, st.slot, kern.geo,
                          kern.media)
    what = (f"{name}{' with a seeded image' if earth is not None else ''}"
            f"{variant(sampler, strict)}")
    return compare_step(f"{what} iters={iters}", cfg, st.xy, st.slot,
                        st.fstate, st.istate, bt, bi, ks)


def check_step_queue(name, width, height, iters, earth=None,
                     sampler="uniform"):
    """Pool-step kernel vs pool_step_plain at the shape the queue gives it,
    and the share of (tile, block) pairs the sorted sweep would skip on
    this later iteration's rays.  With sampler sobol-b0 it is the B0
    instantiation, which reads each lane's (pixel, global sample)."""
    scene, cfg, kern, st, ki, ks, xy, sid = queue_after(name, width, height,
                                                        iters, earth, sampler)
    if cfg.n_samples != 0 or int(st.istate[0].max()) < 2 \
            or int(st.istate[2].sum()) < (1 << 19) \
            or cfg.b0 != (sampler == "sobol-b0"):
        raise AssertionError(f"{name}: not a mid-render queue state")
    rays = st.fstate[:7].contiguous()
    bt, bi = kern.intersect(scene, rays, ki, sid)
    what = (f"{name}{' with a seeded image' if earth is not None else ''}"
            f"{variant(sampler)}")
    out = compare_step(f"{what} queue iters={iters}", cfg, xy, sid, st.fstate,
                       st.istate, bt, bi, ks,
                       lane_b0=st.lane)
    if cfg.b0:
        return out
    blocks = sweep.sweep_blocks(scene)
    perm = torch.sort(sweep.sort_key(blocks, rays), stable=True).indices
    cnt = sweep.tile_lists(rays[:, perm].contiguous(), blocks.blo,
                           blocks.bhi, scene.t_min)[0]
    out["skip_share"] = 1.0 - float(cnt.sum()) / (cnt.numel()
                                                  * blocks.n_blocks)
    log(f"step {what} queue iters={iters}: bounces 0..."
        f"{int(st.istate[0].max())}, skipped (tile, block) pairs of the "
        f"sorted sweep on these rays {out['skip_share']:.4f}")
    return out


def compare_step(what, cfg, xy, slot, fstate, istate, bt, bi, ks,
                 lane_b0=None):
    args = (cfg, xy, slot, fstate, istate, bt, bi, ks)
    kw = {} if lane_b0 is None else dict(lane_b0=lane_b0)
    fk, ik = shade.pool_step(*args, **kw)
    fp, ip = shade.pool_step_plain(*args, **kw)
    torch.cuda.synchronize()
    R = slot.shape[0]
    disc_bad = (ik != ip).any(dim=0)
    n_disc = int(disc_bad.sum())
    ok = ~disc_bad
    worst = 0.0
    n_float = 0
    for key, rows in STEP_ROWS.items():
        rtol, atol = STEP_TOL[key]
        a, b = fk[rows][:, ok], fp[rows][:, ok]
        diff = (a - b).abs()
        n_float += int((diff > atol + rtol * b.abs()).any(dim=0).sum())
        worst = max(worst, float(diff.max()))
    log(f"step {what} R={R}: active "
        f"{int(istate[2].sum())}, discrete mismatches {n_disc}, float "
        f"lanes out of tol {n_float}, max abs err {worst:.3e}")
    if n_disc > 1e-4 * R or n_float > 1e-4 * R:
        raise AssertionError(f"pool-step kernel disagrees with plain on {what}")
    step = lambda: shade.pool_step(*args, **kw)
    ms = kernel_ms(step)
    events_ms = cuda_ms(step, 20)
    plain_ms = cuda_ms(lambda: shade.pool_step_plain(*args, **kw), 3)
    # the strict mode's noise tables and the texture rows are read from the
    # cache: each byte of them counts once; the sobol-b0 step reads 8 B
    # more for each active lane at bounce 0
    first = int(((istate[0] == 0) & (istate[2] > 0)).sum()) if cfg.b0 else 0
    nbytes = R * shade.BYTES_PER_LANE + cfg.tab.numel() * 4 + (
        (cfg.perm.numel() + cfg.ranvec.numel()) * 4 if cfg.strict else 0) + (
        (cfg.texrow.numel() + cfg.kids.numel()) * 4
        if cfg.flags["checker_fancy"] else 0) + 8 * first
    ops = R * shade.OPS_PER_LANE
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(f"step {what}: kernel {ms:.4f} ms (launched from the host one by one "
        f"{events_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms{f', {first} lanes at bounce 0' if cfg.b0 else ''}")
    return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=worst)


def check_hit_scatter(name, width, height, spp, iters, strict=False):
    """hit_scatter kernel vs hit_scatter_plain on a full-width pool's rays
    and sweep results."""
    scene, cfg, kern, st, ki, ks = pool_after(name, width, height, spp, iters,
                                              strict=strict)
    name = f"{name}{variant(strict=strict)}"
    rays = st.fstate[:7].contiguous()
    bt, bi = kern.intersect(scene, rays, ki, st.slot)
    args = (cfg, rays, bt, bi, ks, st.slot)
    rk, sk = hit_scatter.hit_scatter(*args)
    rp, sp = hit_scatter.hit_scatter_plain(*args)
    torch.cuda.synchronize()
    R = rays.shape[1]
    same = ((rk.hit == rp.hit) & (rk.front == rp.front) & (rk.mat == rp.mat)
            & (sk.scattered == sp.scattered))
    n_disc = int((~same).sum())
    cont = same & rp.hit & sp.scattered
    worst, n_float = 0.0, 0
    for a, b, mask, (rtol, atol) in (
            (rk.point, rp.point, same, STEP_TOL["origin"]),
            (rk.normal, rp.normal, same, STEP_TOL["throughput"]),
            (sk.emitted, sp.emitted, same, STEP_TOL["accum"]),
            (sk.direction, sp.direction, cont, STEP_TOL["direction"]),
            (sk.weight, sp.weight, cont, STEP_TOL["throughput"])):
        diff = (a - b).abs()[:, mask]
        n_float += int((diff > atol + rtol * b[:, mask].abs()).any(dim=0).sum())
        worst = max(worst, float(diff.max()))
    log(f"hit_scatter {name} iters={iters} R={R}: hits {int(rp.hit.sum())}, "
        f"scattered {int(cont.sum())}, discrete mismatches {n_disc}, float "
        f"lanes out of tol {n_float}, max abs err {worst:.3e}")
    if n_disc > 1e-4 * R or n_float > 1e-4 * R or int(cont.sum()) < R // 10:
        raise AssertionError(f"hit_scatter kernel disagrees with plain on "
                             f"{name}")
    scatter = lambda: hit_scatter.hit_scatter(*args)
    ms = kernel_ms(scatter)
    events_ms = cuda_ms(scatter, 20)
    plain_ms = cuda_ms(lambda: hit_scatter.hit_scatter_plain(*args), 3)
    nbytes = R * hit_scatter.BYTES_PER_LANE + cfg.tab.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = R * hit_scatter.OPS_PER_LANE / FP32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(f"hit_scatter {name}: kernel {ms:.4f} ms (launched from the host one "
        f"by one {events_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms")
    return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=worst)


def check_aov(name, width, height, samples):
    """The first-hit feature kernel against its plain twin on the rays
    ``render_aovs`` gives it: ``samples`` samples of a ``width`` x
    ``height`` frame in one launch (1M lanes at 500x500 and 4), swept by
    the render's sweep.  Hit flags equal, features within rtol 2e-4 / atol
    1e-4 on all but 1e-4 of the lanes; time from a graph's replay, bound
    68 B a lane over 3.35 TB/s."""
    scene, cam = scene_and_camera(name, width, height)
    cfg = shade.StepConfig.create(scene, cam, width, height, 1)
    kern = SceneKernels.create(scene)
    pix = torch.arange(width * height, dtype=torch.int64, device=DEV)
    rays = torch.cat([aov.camera_rays(cam.to(DEV), width, height, pix, s,
                                      SEED) for s in range(samples)], dim=1)
    lanes = _to_i32_bits(pix.repeat(samples))
    bt, bi = kern.intersect(scene, rays, rng.prng_key(0), lanes)
    bi = bi.to(torch.int32).contiguous()
    args = (cfg, rays, bt, bi)
    fk = aov.aov_features(*args)
    fp = aov.aov_features_plain(*args)
    torch.cuda.synchronize()
    R = rays.shape[1]
    n_disc = int((fk[7] != fp[7]).sum())
    diff = (fk - fp).abs()
    n_float = int((diff > 1e-4 + 2e-4 * fp.abs()).any(dim=0).sum())
    worst = float(diff.max())
    log(f"aov {name} R={R}: hits {int(fp[7].sum())}, hit mismatches "
        f"{n_disc}, lanes out of tol {n_float}, max abs err {worst:.3e}")
    if n_disc or n_float > 1e-4 * R or int(fp[7].sum()) < R // 4:
        raise AssertionError(f"aov kernel disagrees with plain on {name}")
    ms = kernel_ms(lambda: aov.aov_features(*args))
    plain_ms = cuda_ms(lambda: aov.aov_features_plain(*args), 3)
    nbytes = R * aov.BYTES_PER_LANE + cfg.tab.numel() * 4 + (
        (cfg.texrow.numel() + cfg.kids.numel()) * 4
        if cfg.flags["checker_fancy"] else 0)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    log(f"aov {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms (bytes)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", max_abs_err=worst)


def hold_aovs(a, b, what):
    """Two ``render_aovs`` results: coverage and +inf depths equal; albedo
    and normal within 1e-4, depth within rtol 1e-5, on all but 2% of
    pixels (a texel edge, a checker's sign of sines)."""
    np.testing.assert_array_equal(a["coverage"], b["coverage"])
    np.testing.assert_array_equal(np.isinf(a["depth"]), np.isinf(b["depth"]))
    fin = np.isfinite(a["depth"])
    bad = np.zeros(fin.shape, bool)
    bad[fin] = np.abs(a["depth"][fin] - b["depth"][fin]) > \
        1e-5 * np.abs(a["depth"][fin])
    for k in ("albedo", "normal"):
        bad |= (np.abs(a[k] - b[k]) > 1e-4).any(axis=-1)
    log(f"{what}: pixels out of tol {bad.mean():.4%}, coverage mean "
        f"{float(a['coverage'].mean()):.4f}")
    if bad.mean() > 0.02:
        raise AssertionError(f"{what}: the AOVs disagree")


def hold_sorted_sweep(what, name, R, dense, got, plain):
    """A sorted sweep's kernel result ``got`` against the dense sweep
    kernel's (bit-equal t, no index mismatch on hits) and against its plain
    version's; returns the max abs error against the plain version."""
    (dt, di), (ct, ci), (pt, pi) = dense, got, plain
    hit = torch.isfinite(dt)
    t_bits = int((ct.view(torch.int32) != dt.view(torch.int32)).sum())
    bad_i = int(((ci != di) & hit).sum())
    hit_p = torch.isfinite(pt)
    both = hit & hit_p
    err = (ct[both] - pt[both]).abs()
    max_abs = float(err.max()) if int(both.sum()) else 0.0
    bad_t = int((err > 1e-5 + 2e-5 * pt[both].abs()).sum())
    idx_diff = both & (ci != pi)
    ties = int((idx_diff & (ct == pt)).sum())
    log(f"{what} {name} R={R}: hits {int(hit.sum())}; vs dense kernel: t bit "
        f"mismatches {t_bits}, idx mismatches on hits {bad_i}; vs plain: hit "
        f"mismatches {int((hit != hit_p).sum())}, t out of tol {bad_t}, max "
        f"abs err {max_abs:.3e}, idx mismatches "
        f"{int(idx_diff.sum()) - ties} (+{ties} exact ties)")
    if t_bits or bad_i:
        raise AssertionError(f"{what} differs from the dense sweep on {name}")
    if int((hit != hit_p).sum()) > 1e-5 * R or bad_t > 1e-5 * R \
            or int(idx_diff.sum()) - ties > 1e-5 * R:
        raise AssertionError(f"{what} kernel disagrees with plain on {name}")
    return max_abs


def listed_flops(blocks, cnt, lst, R) -> float:
    """Operations of the dense sweep's pair tests over the (tile, block)
    pairs the lists name."""
    T, B = lst.shape
    listed = torch.zeros((T, B), dtype=torch.bool, device=lst.device)
    ranks = torch.arange(B, device=lst.device)[None, :] < cnt[:, None]
    listed.scatter_(1, lst.long(), ranks)
    return pair_flops(blocks, listed, R)


def pair_flops(blocks, listed, R) -> float:
    """Operations of the dense sweep's pair tests over the (tile, block)
    pairs where ``listed`` (T, B) is set, the rays of a short last tile
    counted as they are."""
    T = listed.shape[0]
    rays = torch.full((T,), float(sweep.TILE_R), device=listed.device)
    rays[-1] = R - (T - 1) * sweep.TILE_R
    per_block = (listed.float() * rays[:, None]).sum(0)          # (B,)
    desc = blocks.desc.long()
    flops = torch.tensor([sweep.FLOPS_PER_PAIR[sweep.KINDS[k]]
                          for k in desc[:, 2].tolist()],
                         dtype=torch.float32, device=listed.device)
    return float((per_block * desc[:, 1].float() * flops).sum())


def check_sweep_compact(name, width, height, spp, iters):
    """The sorted, compacted-list sweep on one full-width pool's rays: the
    list pass against its plain twin (equal counts and lists), the kernel
    at each rays-per-thread build, in the list pass's tile order and in
    natural order, against the dense sweep kernel (bit-equal) and against
    its plain version, the share of listed pairs the front-to-back cull
    skipped, and the sort's, the lists' and the whole sorted sweep's times
    beside the kernel's; two bounds: the dense sweep's and that of the
    listed pairs."""
    scene, _, kern, st, _, _ = pool_after(name, width, height, spp, iters)
    rays = st.fstate[:7].contiguous()
    ranges = sweep._ranges(scene)
    blocks = sweep.sweep_blocks(scene)
    t_min = scene.t_min
    R = rays.shape[1]

    def sort_rays():
        perm = torch.sort(sweep.sort_key(blocks, rays), stable=True).indices
        return perm, rays[:, perm].contiguous()

    perm, srays = sort_rays()
    box = (srays, blocks.blo, blocks.bhi, t_min)
    lists = lambda: sweep.tile_lists(*box)
    cnt, lst, order = lists()
    cp, lp, op = sweep.tile_lists_plain(*box)
    natural = torch.arange(cnt.numel(), dtype=torch.int32, device=DEV)
    # the order: a permutation of the tiles by descending count, as the
    # plain twin's (equal counts in any order)
    if not (torch.equal(cnt, cp) and torch.equal(lst, lp)
            and torch.equal(torch.sort(order).values, natural)
            and torch.equal(cnt[order.long()], cp[op.long()])):
        raise AssertionError(f"list pass differs from its plain twin on "
                             f"{name}")
    listed_share = float(cnt.sum()) / (cnt.numel() * blocks.n_blocks)
    rpt = sweep.pick_rpt_compact(R, sweep.sm_count(DEV))
    dt, di = sweep.sweep(rays, kern.geo, ranges, t_min)
    stats = torch.zeros(2, dtype=torch.int64, device=DEV)
    run = lambda k, o=order, s=None: sweep.sweep_compact(
        srays, kern.geo, blocks, cnt, lst, o, t_min, perm, rpt=k, stats=s)
    ct, ci = run(rpt, s=stats)
    pt, pi = sweep.sweep_compact_plain(srays, kern.geo, blocks, cnt, lst,
                                       order, t_min, perm)
    torch.cuda.synchronize()
    listed, skipped = stats.tolist()
    log(f"sweep_compact {name} iters={iters}: {blocks.n_blocks} blocks, "
        f"list pass equal to its plain twin, listed (tile, block) pairs "
        f"{listed_share:.4f}, of them skipped by the front-to-back cull "
        f"{skipped / max(listed, 1):.4f}")
    max_abs = hold_sorted_sweep("sweep_compact", name, R, (dt, di), (ct, ci),
                                (pt, pi))
    for k in (1, 2):              # every build, either order: the same bits
        for o in (order, natural):
            t, i = run(k, o)
            if not (torch.equal(t, ct) and torch.equal(i, ci)):
                raise AssertionError(f"sweep_compact at {k} rays per thread "
                                     f"differs on {name}")
    ms = kernel_ms(lambda: run(rpt))
    by_rpt = {k: kernel_ms(lambda: run(k)) for k in (1, 2)}
    unordered_ms = kernel_ms(lambda: run(rpt, natural))
    dense_ms = kernel_ms(lambda: sweep.sweep(rays, kern.geo, ranges, t_min))
    plain_ms = cuda_ms(lambda: sweep.sweep_compact_plain(
        srays, kern.geo, blocks, cnt, lst, order, t_min, perm), 2)
    sort_ms = cuda_ms(sort_rays, 10)
    lists_ms = kernel_ms(lists)
    lists_plain_ms = cuda_ms(lambda: sweep.tile_lists_plain(*box), 10)
    whole_ms = cuda_ms(lambda: sweep.sweep_sorted(rays, kern.geo, blocks,
                                                  t_min), 10)
    dense_bound_ms, _ = sweep_bound(scene, kern.geo, R)
    t_bytes = (R * (7 * 4 + 8 + 8) + kern.geo.numel() * 4
               + lst.numel() * 4) / HBM_BYTES_PER_S
    t_ops = listed_flops(blocks, cnt, lst, R) / FP32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    # the list pass: 24 B in per ray, cnt, lst and the order out; ~20
    # operations per (ray, block) slab test
    T = cnt.numel()
    lb = (R * 24 + T * (blocks.n_blocks + 2) * 4) / HBM_BYTES_PER_S
    lo_ = T * sweep.TILE_R * blocks.n_blocks * 20 / FP32_FLOPS_PER_S
    lists_bound_ms = 1e3 * max(lb, lo_)
    log(f"sweep_compact {name}: kernel {ms:.4f} ms at {rpt} rays/thread in "
        f"the list pass's order (1, 2 rays/thread: {by_rpt[1]:.4f}, "
        f"{by_rpt[2]:.4f} ms; natural order "
        f"{unordered_ms:.4f} ms), dense kernel {dense_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, sort (key, sort, gather) {sort_ms:.4f} ms, list "
        f"pass {lists_ms:.4f} ms (plain {lists_plain_ms:.4f} ms, bound "
        f"{lists_bound_ms:.4f}), whole sorted sweep {whole_ms:.4f} ms; bound "
        f"of the listed pairs {bound_ms:.4f} ms, dense bound "
        f"{dense_bound_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                dense_bound_ms=dense_bound_ms, max_abs_err=max_abs,
                rpt=rpt, ms_by_rpt=by_rpt, unordered_ms=unordered_ms,
                dense_ms=dense_ms, sort_ms=sort_ms, lists_ms=lists_ms,
                lists_plain_ms=lists_plain_ms, lists_bound_ms=lists_bound_ms,
                lists_bound_by="bytes" if lb >= lo_ else "operations",
                whole_sorted_ms=whole_ms, listed_share=listed_share,
                skip_share=1.0 - listed_share,
                cull_skip_share=skipped / max(listed, 1))


def check_sweep_masked(name, width, height, spp, iters):
    """The mask-gated sweep on one full-width pool's sorted rays: the list
    pass in mask mode against its plain twins (the mask equal, the order a
    permutation of the tiles by non-increasing count of needed blocks), the
    kernel at each rays-per-thread build, in the list pass's tile order and
    in natural order, bit-equal to the dense sweep kernel and to its plain
    version, the share of needed pairs the cull skipped, and the list
    pass's and the whole sorted masked sweep's times beside the kernel's;
    two bounds: the dense sweep's and that of the needed pairs."""
    scene, _, kern, st, _, _ = pool_after(name, width, height, spp, iters)
    rays = st.fstate[:7].contiguous()
    ranges = sweep._ranges(scene)
    blocks = sweep.sweep_blocks(scene)
    t_min = scene.t_min
    R = rays.shape[1]
    perm = torch.sort(sweep.sort_key(blocks, rays), stable=True).indices
    srays = rays[:, perm].contiguous()
    box = (srays, blocks.blo, blocks.bhi, t_min)
    build_mask = lambda: sweep.tile_mask(*box)
    mask, order = build_mask()
    T = mask.shape[0]
    natural = torch.arange(T, dtype=torch.int32, device=DEV)
    need = mask.sum(1)[order.long()]
    if not (torch.equal(mask, sweep.needed_mask_plain(*box))
            and torch.equal(torch.sort(order).values, natural)
            and bool((need[:-1] >= need[1:]).all())):
        raise AssertionError(f"the list pass's mask or tile order differs "
                             f"from its plain twins on {name}")
    needed_share = float(mask.sum()) / mask.numel()
    rpt = sweep.pick_rpt_compact(R, sweep.sm_count(DEV))
    dt, di = sweep.sweep(rays, kern.geo, ranges, t_min)
    stats = torch.zeros(2, dtype=torch.int64, device=DEV)
    run = lambda k=None, o=order, s=None: sweep.sweep_masked(
        srays, kern.geo, blocks, mask, o, t_min, perm, k, s)
    mt, mi = run(s=stats)
    pt, pi = sweep.sweep_masked_plain(srays, kern.geo, blocks, mask, order,
                                      t_min, perm)
    torch.cuda.synchronize()
    needed, skipped = stats.tolist()
    log(f"sweep_masked {name} iters={iters}: {blocks.n_blocks} blocks, "
        f"needed (tile, block) pairs {needed_share:.4f}, of them skipped by "
        f"the cull {skipped / max(needed, 1):.4f}; {rpt} rays/thread")
    max_abs = hold_sorted_sweep("sweep_masked", name, R, (dt, di), (mt, mi),
                                (pt, pi))
    if needed != int(mask.sum()) or not (torch.equal(mt, pt)
                                         and torch.equal(mi, pi)):
        raise AssertionError(f"sweep_masked is not bit-equal to its plain "
                             f"twin on {name}, or counted {needed} needed "
                             f"pairs for the mask's {int(mask.sum())}")
    for k in (1, 2):              # every build, either order: the same bits
        for o in (order, natural):
            t, i = run(k, o)
            if not (torch.equal(t, mt) and torch.equal(i, mi)):
                raise AssertionError(f"sweep_masked at {k} rays per thread "
                                     f"differs on {name}")
    ms = kernel_ms(run)
    by_rpt = {k: kernel_ms(lambda: run(k)) for k in (1, 2)}
    natural_ms = kernel_ms(lambda: run(None, natural))
    dense_ms = kernel_ms(lambda: sweep.sweep(rays, kern.geo, ranges, t_min))
    plain_ms = cuda_ms(lambda: sweep.sweep_masked_plain(
        srays, kern.geo, blocks, mask, order, t_min, perm), 2)
    mask_ms = kernel_ms(build_mask)
    mask_plain_ms = cuda_ms(lambda: sweep.needed_mask_plain(*box), 10)
    whole_ms = cuda_ms(lambda: sweep.sweep_sorted(rays, kern.geo, blocks,
                                                  t_min, masked=True), 10)
    dense_bound_ms, _ = sweep_bound(scene, kern.geo, R)
    t_bytes = (R * (7 * 4 + 8 + 8) + kern.geo.numel() * 4
               + mask.numel() * 4) / HBM_BYTES_PER_S
    t_ops = pair_flops(blocks, mask > 0, R) / FP32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(f"sweep_masked {name}: kernel {ms:.4f} ms at {rpt} rays/thread in "
        f"the list pass's order (1, 2 rays/thread: {by_rpt[1]:.4f}, "
        f"{by_rpt[2]:.4f} ms; natural order {natural_ms:.4f} ms), dense "
        f"kernel {dense_ms:.4f} ms, plain {plain_ms:.3f} ms, list pass in "
        f"mask mode {mask_ms:.4f} ms (plain mask {mask_plain_ms:.4f} ms), "
        f"whole sorted masked sweep {whole_ms:.4f} ms; bound of the needed "
        f"pairs {bound_ms:.4f} ms, dense bound {dense_bound_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                dense_bound_ms=dense_bound_ms, max_abs_err=max_abs, rpt=rpt,
                ms_by_rpt=by_rpt, natural_ms=natural_ms, dense_ms=dense_ms,
                mask_ms=mask_ms, mask_plain_ms=mask_plain_ms,
                whole_sorted_ms=whole_ms, needed_share=needed_share,
                skip_share=1.0 - needed_share,
                cull_skip_share=skipped / max(needed, 1))


def check_sqrt():
    """``core.vec.sqrt_rn`` takes ``torch.sqrt`` as it is on the card: it
    must be the correctly rounded root there, the float64 root rounded to
    float32, on 2^24 random non-negative finite bit patterns (every
    magnitude, subnormals included)."""
    bits = torch.randint(0, 0x7F800000, (1 << 24,), dtype=torch.int32,
                         device=DEV, generator=torch.Generator(DEV)
                         .manual_seed(SEED))
    x = bits.view(torch.float32)
    got = vec.sqrt_rn(x)
    want = torch.sqrt(x.double()).float()
    n_bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    log(f"sqrt_rn on the card: {n_bad} of {x.numel()} roots differ from the "
        f"correctly rounded ones")
    if n_bad:
        raise AssertionError("torch.sqrt on the card is not correctly rounded")


def hmma_count() -> int:
    """HMMA (tensor-core) instructions in the matrix-product sweep's
    library, from ``cuobjdump -sass``."""
    so = build._target("sweep_mxu")[1]
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    return sum(1 for line in sass.splitlines() if "HMMA" in line)


def check_sweep_mxu(name, width, height, spp, iters):
    """The matrix-product sphere sweep over the static spheres of one
    full-width pool's rays: the tensor-core kernel against its plain
    version (its discriminant test and roots repeat the plain twin's
    operations: bit-equal) and against the dense sweep kernel (the classic
    form: equal hit sets but for grazing rays, t to the expansion's
    conditioning), with the share of pairs the kernel retested in scalar."""
    scene, _, kern, st, _, _ = pool_after(name, width, height, spp, iters)
    rays = st.fstate[:7].contiguous()
    n_ss = scene.n_sphere_static
    t_min = scene.t_min
    R = rays.shape[1]
    pack = sweep.mxu_pack(kern.geo, 0, n_ss)
    only = (n_ss, n_ss, n_ss, n_ss)
    args = (rays, kern.geo, 0, n_ss, t_min, pack)
    stats = torch.zeros(1, dtype=torch.int64, device=DEV)
    mt, mi = sweep.sweep_sphere_mxu(*args, stats=stats)
    pt, pi = sweep.sweep_sphere_mxu_plain(*args)
    dt, di = sweep.sweep(rays, kern.geo[:n_ss], only, t_min)
    torch.cuda.synchronize()
    retest = float(stats.item()) / (R * n_ss)
    hit, hit_p, hit_d = (torch.isfinite(x) for x in (mt, pt, dt))
    both = hit & hit_p
    err = (mt[both] - pt[both]).abs()
    max_abs = float(err.max()) if int(both.sum()) else 0.0
    bad_t = int((err > 1e-6 + 2e-5 * pt[both].abs()).sum())
    bad_i = int((mi[both] != pi[both]).sum())
    t_bits = int((mt.view(torch.int32) != pt.view(torch.int32)).sum())
    bd = hit & hit_d
    rel = ((mt[bd] - dt[bd]).abs() / dt[bd].abs())
    loose = int((rel > 2e-5).sum())
    looser = int((rel > 1e-3).sum())
    worst_rel = float(rel.max()) if int(bd.sum()) else 0.0
    same_i = float((mi[bd] == di[bd]).float().mean())
    log(f"sweep_sphere_mxu {name} iters={iters} R={R}, {n_ss} spheres: hits "
        f"{int(hit.sum())}; vs plain: hit mismatches "
        f"{int((hit != hit_p).sum())}, t out of tol {bad_t}, t bit "
        f"mismatches {t_bits}, idx mismatches {bad_i}, max abs err "
        f"{max_abs:.3e}; vs dense kernel: hit mismatches "
        f"{int((hit != hit_d).sum())}, t beyond rtol 2e-5 on {loose} rays, "
        f"beyond 1e-3 on {looser}, worst rel err {worst_rel:.3e}, same idx "
        f"{same_i:.6f}; pairs retested in scalar {retest:.5f}")
    if int((hit != hit_p).sum()) > 1e-5 * R or bad_t > 1e-5 * R \
            or bad_i > 1e-5 * R:
        raise AssertionError(f"matrix-product sweep kernel disagrees with "
                             f"plain on {name}")
    # the kernel retests every pair its filter passes with the plain twin's
    # operations: a pair the filter dropped wrongly shows as a difference
    if t_bits or not torch.equal(mi, pi):
        raise AssertionError(f"matrix-product sweep kernel is not bit-equal "
                             f"to plain on {name}: {t_bits} t, "
                             f"{int((mi != pi).sum())} idx")
    # bounced rays start on sphere surfaces, where the expanded quadratic
    # cancels worst: t is held to 1e-3 on all but 1% of the rays
    if int((hit != hit_d).sum()) > 1e-3 * R or same_i < 0.99 \
            or looser > 1e-2 * R:
        raise AssertionError(f"matrix-product sweep is far from the dense "
                             f"sweep on {name}")
    ms = kernel_ms(lambda: sweep.sweep_sphere_mxu(*args))
    plain_ms = cuda_ms(lambda: sweep.sweep_sphere_mxu_plain(*args), 3)
    dense_ms = kernel_ms(lambda: sweep.sweep(rays, kern.geo[:n_ss], only,
                                             t_min))
    pack_ms = cuda_ms(lambda: sweep.mxu_pack(kern.geo, 0, n_ss), 10)
    pairs = float(R) * n_ss
    t_bytes = (R * (7 * 4 + 8) + pack.tab.numel() * 4
               + pack.frag.numel() * 4) / HBM_BYTES_PER_S
    t_cuda = pairs * sweep.MXU_CUDA_FLOPS / FP32_FLOPS_PER_S
    t_tensor = pairs * sweep.MXU_TENSOR_FLOPS / TF32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_cuda, t_tensor)
    bound_by = "bytes" if t_bytes >= max(t_cuda, t_tensor) else "operations"
    scalar_bound_ms = 1e3 * max(
        t_bytes, pairs * sweep.FLOPS_PER_PAIR["sphere_mxu"]
        / FP32_FLOPS_PER_S)
    log(f"sweep_sphere_mxu {name}: kernel {ms:.4f} ms, dense kernel on the "
        f"same range {dense_ms:.4f} ms, plain {plain_ms:.3f} ms, pack (once "
        f"per render) {pack_ms:.4f} ms, bound {bound_ms:.4f} ms (tensor "
        f"cores {1e3 * t_tensor:.4f}, CUDA cores {1e3 * t_cuda:.4f}; the "
        f"scalar form's {scalar_bound_ms:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, scalar_bound_ms=scalar_bound_ms,
                max_abs_err=max_abs, t_bit_mismatches=t_bits,
                dense_ms=dense_ms, retest_share=retest,
                worst_rel_err_vs_dense=worst_rel)


def mega_wave(name, width, height, spp, depth, plan=None, sampler="uniform"):
    """The first wave of a pool render of ``name``: what ``trace_pool_mega``
    takes.  ``plan``: (slots per pixel, samples per slot); as ``render``
    plans ``spp`` samples when omitted."""
    scene, cam = scene_and_camera(name, width, height, sampler=sampler)
    k_pool, s_wave = plan or plan_pool(scene, width, height, spp)[:2]
    cfg = shade.StepConfig.create(scene, cam, width, height, depth,
                                  n_samples=s_wave, cam_salt=SEED)
    kern = SceneKernels.create(scene, False)
    return (scene, cfg, pixel_grid(width, height, k_pool, DEV),
            slot_ids(width, height, k_pool, DEV),
            rng.fold_in(rng.prng_key(SEED), 0), kern)


def mega_registers() -> str:
    """ptxas's register line for the megakernel, from phase 2's build."""
    for line in build.build_log.get("megakernel", "").splitlines():
        if "registers" in line:
            return line.split("info    :")[-1].strip()
    return "not in the build log (library reused)"


def time_mega(what, args, threads=None):
    """One timed megakernel launch (after a warm-up launch) with the
    iterations it counted: ms, bound and the share of lane slots that
    worked, and the launch's (radiance, sample counts).  ``threads``: the
    launch's thread count (one per slot: the slot count); persistent when
    omitted.  The bound counts what this wave did: its slot-iterations,
    each a sweep over every solid prim plus one pool step."""
    scene, _, _, slot = args[:4]
    R = slot.shape[0]
    if threads is None:
        threads = megakernel.persistent_threads(DEV)
    launch = lambda: megakernel.launch_mega(*args, threads)
    launch()
    megakernel.read_stats(DEV)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    result = launch()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1)
    lane_iters, warp_iters = megakernel.read_stats(DEV)
    ops = lane_iters * (sweep_flops(scene, 1) + shade.OPS_PER_LANE)
    t_ops = ops / FP32_FLOPS_PER_S
    t_bytes = R * megakernel.BYTES_PER_LANE / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    share = lane_iters / (32.0 * warp_iters)
    log(f"megakernel {what} R={R} threads={min(threads, R)}: {ms:.3f} ms, "
        f"{lane_iters} lane-iterations ({lane_iters / R:.2f} per slot), "
        f"{warp_iters} warp-iterations, working share of lane slots "
        f"{share:.4f}, bound {bound_ms:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    return dict(ms=ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                lane_iters=lane_iters, warp_iters=warp_iters,
                lane_share=share, threads=min(threads, R)), result


def mega_schedules(what, args):
    """The megakernel persistent and at one thread per slot on the same
    wave: the two must give the same bits and count the same
    slot-iterations.  Returns the persistent launch's numbers (with the
    other's under ``per_slot``) and its result."""
    out, res = time_mega(what, args)
    one, res1 = time_mega(what, args, threads=args[3].shape[0])
    same = torch.equal(res[0], res1[0]) and torch.equal(res[1], res1[1])
    log(f"megakernel {what}: persistent {out['ms']:.3f} ms (share "
        f"{out['lane_share']:.4f}), one thread per slot {one['ms']:.3f} ms "
        f"(share {one['lane_share']:.4f}), bit-equal {same}; "
        f"{mega_registers()}")
    if not same or out["lane_iters"] != one["lane_iters"]:
        raise AssertionError(f"megakernel schedules differ on {what}")
    out["per_slot"] = one
    return out, res


def check_mega(name, width, height, depth, sampler="uniform"):
    """The megakernel against its plain version on one wave of 4 slots per
    pixel and 2 samples per slot: equal sample
    counts; at most 3% of lanes diverged (a coin flipped at an ulp moves a
    whole path; in the media ``logf`` differs from ``torch.log`` by ulps),
    the rest within rtol 2e-4 / atol 1e-4.  The persistent launch and one
    thread per slot are held bit-equal first."""
    args = mega_wave(name, width, height, 8, depth, plan=(4, 2),
                     sampler=sampler)
    cfg, slot = args[1], args[3]
    R = slot.shape[0]
    what = (f"{name}{variant(sampler)} {cfg.n_samples} samples/slot depth "
            f"{depth}")
    out, (a, a_ns) = mega_schedules(what, args)
    t0 = time.perf_counter()
    b, b_ns = megakernel.trace_pool_mega_plain(*args)
    torch.cuda.synchronize()
    out["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    ns_bad = int((a_ns != b_ns).sum()) + int((a_ns != cfg.n_samples).sum())
    err = (a - b).abs() / (1.0 + b.abs())
    close = (err < 1e-4).all(dim=0)
    share = 1.0 - float(close.float().mean())
    diff = (a - b).abs()[:, close]
    out["max_abs_err"] = float(diff.max())
    bad = int((diff > 1e-4 + 2e-4 * b[:, close].abs()).sum())
    log(f"megakernel {what} R={R}: sample-count mismatches {ns_bad}, "
        f"diverged lanes {share:.4%}, close lanes out of tol {bad}, max abs "
        f"err {out['max_abs_err']:.3e}, plain {out['plain_ms']:.1f} ms, mean "
        f"radiance {float(a.mean()):.4f}")
    if ns_bad or share > 0.03 or bad or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"megakernel disagrees with plain on {name}")
    return out


def cross_engine(a, b, what):
    """At most 2% of pixels diverge, the rest within rtol 2e-4 / atol 1e-4."""
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    share = 1.0 - close.mean()
    bad = np.abs(a - b)[close] > 1e-4 + 2e-4 * np.abs(a)[close]
    log(f"{what}: divergent pixels {share:.4%}, close pixels out of tol "
        f"{int(bad.sum())}")
    if share > 0.02 or bad.any():
        raise AssertionError(f"{what} fails the cross-engine criterion")


def same_estimator(a, b, what, share_cap=0.25):
    """Two renders whose hit distances differ in their last digits (the
    matrix-product sweep reassociates the quadratic): paths branch apart at
    depth 50, so many pixels differ by noise, but the mean must not move.
    At most ``share_cap`` of the pixels diverge and the image means agree
    to 1%."""
    err = np.abs(a - b) / (1.0 + np.abs(a))
    share = 1.0 - (err < 1e-4).all(axis=-1).mean()
    rel = abs(float(a.mean()) - float(b.mean())) / float(a.mean())
    log(f"{what}: divergent pixels {share:.4%}, image means "
        f"{float(a.mean()):.6f} / {float(b.mean()):.6f}")
    if share > share_cap or rel > 0.01:
        raise AssertionError(f"{what}: the two renders are not one estimator")


def check_golden(name, engine="auto"):
    spp, depth, w, h = GOLDENS[name]
    spec = SCENES[name]
    img = render(spec.build(seed=SEED, earth=None), spec.camera(w, h), w, h,
                 spp=spp, max_depth=depth, seed=SEED, engine=engine)
    cross_engine(np.load(os.path.join(GOLDEN_DIR, f"{name}.npy")), img,
                 f"golden {name} engine={engine}")


def check_strict_golden(name):
    """A strict golden rendered on the card at its golden config.  Held to
    the golden by the cross-engine criterion, except where the golden rests
    on the JAX package's compiled-loop rounding of grazing rays
    (tests/test_torch_strict.py: book1-final, perlin-sky), which are held
    to the same render on the CPU (the port's twins, which equal the JAX
    package's op-by-op render) and to the golden's mean within 1%.  Every
    one differs from its fixed-estimator render by the strict-vs-fixed
    margin of the tests within 25%."""
    spp, depth, w, h, margin, ref = STRICT_GOLDENS[name]
    scene, cam = scene_and_camera(name, w, h, strict=True)
    kw = dict(spp=spp, max_depth=depth, seed=SEED)
    img = render(scene, cam, w, h, **kw)
    fixed = render(scene.replace(strict=False), cam, w, h, **kw)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}-strict.npy"))
    if margin is None:
        margin = float(np.abs(golden - np.load(os.path.join(
            GOLDEN_DIR, f"{name}.npy"))).mean())
    if ref == "golden":
        cross_engine(golden, img, f"strict golden {name}")
    else:
        cpu = render(scene.to("cpu"), cam, w, h, device="cpu", **kw)
        cross_engine(cpu, img, f"strict golden {name} card vs cpu")
        rel = abs(float(img.mean()) - float(golden.mean())) / float(
            golden.mean())
        log(f"strict golden {name}: image mean {float(img.mean()):.6f}, "
            f"golden's {float(golden.mean()):.6f}")
        if rel > 0.01:
            raise AssertionError(f"strict golden {name}: the mean moved")
    got = float(np.abs(img - fixed).mean())
    log(f"strict golden {name}: |strict - fixed| mean {got:.6f}, margin "
        f"{margin:.6f}")
    if abs(got - margin) >= 0.25 * margin:
        raise AssertionError(f"strict golden {name}: strict-vs-fixed margin "
                             f"{got:.6f} is not {margin:.6f} within 25%")


def check_card_vs_cpu(what, scene, cam, w, h, **kw):
    """The same render on the card and on the CPU."""
    a = render(scene, cam, w, h, device="cpu", **kw)
    b = render(scene, cam, w, h, **kw)
    cross_engine(a, b, f"{what} card vs cpu")


COUNTERS = {"aov": aov.aov_features, "bvh": bvh.intersect_bvh,
            "sweep": sweep.sweep, "sweep_compact": sweep.sweep_compact,
            "list_pass": sweep.list_pass,
            "pool_step": shade.pool_step,
            "hit_scatter": hit_scatter.hit_scatter,
            "megakernel": megakernel.trace_pool_mega,
            "sweep_masked": sweep.sweep_masked,
            "sweep_sphere_mxu": sweep.sweep_sphere_mxu,
            "media": intersect.merge_media, "path_ids": queue.path_ids,
            "queue_inject": queue.queue_inject}
PLAIN = {"aov": aov.aov_features_plain, "bvh": bvh.intersect_bvh_plain,
         "sweep": sweep.sweep_plain,
         "tile_lists": sweep.tile_lists_plain,
         "needed_mask": sweep.needed_mask_plain,
         "sweep_compact": sweep.sweep_compact_plain,
         "pool_step": shade.pool_step_plain,
         "hit_scatter": hit_scatter.hit_scatter_plain,
         "megakernel": megakernel.trace_pool_mega_plain,
         "sweep_masked": sweep.sweep_masked_plain,
         "sweep_sphere_mxu": sweep.sweep_sphere_mxu_plain,
         "media": intersect.merge_media_plain,
         "path_ids": queue.path_ids_plain,
         "queue_inject": queue.queue_inject_plain}
# the work queue's kernels; the default closest hit of a scene of
# integrator.BVH_ROUTE_MIN_PRIMS prims or more (book1-final, next-week-final:
# the BVH kernel under rule INDEX, media inside it, no sweep or media
# kernel); next-week-final's queue paths
QUEUE = ("path_ids", "queue_inject")
ROUTE = ("bvh", "pool_step")
ROUTE_ABSENT = ("sweep", "sweep_compact", "sweep_masked", "sweep_sphere_mxu",
                "media")
NW_QUEUE = ROUTE + QUEUE


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0
    for fn in PLAIN.values():
        fn.calls = 0


def read_counts(path, expect, absent=()):
    """The launch counts of one path: every kernel in ``expect`` ran, none
    in ``absent`` did, and no plain version did."""
    got = {k: fn.launches for k, fn in COUNTERS.items()}
    plain = {k: fn.calls for k, fn in PLAIN.items()}
    log(f"  {path} launches {got}; plain-version calls {plain}")
    if any(got[k] <= 0 for k in expect) or any(got[k] for k in absent) \
            or max(plain.values()) != 0:
        raise AssertionError(f"the {path} path did not run through its "
                             "kernels")
    return got


def with_env(env, fn):
    """``fn()`` with the environment variables of ``env`` set, restored
    afterwards (the sweep's switches are read when a render starts)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def full_width(name, width, height, spp, sampler="uniform", strict=False,
               seed=SEED, **kw):
    scene, cam = scene_and_camera(name, width, height, sampler=sampler,
                                  strict=strict)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(scene, cam, width, height, spp, max_depth=50, seed=seed,
                 **kw)
    wall = time.perf_counter() - t0
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{name}: bad image {img.shape}")
    bright = float(to_rgb8(img).mean())
    shown = {k: v for k, v in kw.items() if not callable(v)}
    log(f"render {name}{variant(sampler, strict)} {width}x{height} {spp} spp "
        f"depth 50 seed {seed} {shown}: wall "
        f"{wall:.3f} s, {width * height * spp / wall:.4g} samples/s, mean "
        f"8-bit {bright:.2f}")
    return img, wall, bright


def sobol_b0_full():
    """cornell 500x500, 64 spp, depth 50 on the queue with sampler sobol-b0
    (the step's B0 instantiation), beside the sobol render at four seeds:
    the sobol-b0 mean lies within the sobol means' spread, widened by its
    own width on each side."""
    reset_counts()
    img, wall, _ = full_width("cornell", 500, 500, 64, sampler="sobol-b0",
                              mode="queue")
    counts = read_counts("sobol-b0 queue", ("sweep", "pool_step") + QUEUE)
    means = [float(full_width("cornell", 500, 500, 64, sampler="sobol",
                              mode="queue", seed=SEED + k)[0].mean())
             for k in range(4)]
    lo, hi = min(means), max(means)
    mean = float(img.mean())
    log(f"  cornell queue sobol-b0 mean {mean:.6f}, sobol means "
        f"{', '.join(f'{m:.6f}' for m in means)} (seeds {SEED}-{SEED + 3})")
    if not lo - (hi - lo) <= mean <= hi + (hi - lo):
        raise AssertionError("the sobol-b0 queue render's mean is outside "
                             "the sobol renders' spread")
    return img, dict(wall_s=wall, mean=mean, sobol_means=means,
                     counts=counts)


def aov_full(img):
    """``render_aovs`` (16 spp) and ``denoise`` of the 64-spp pool render
    ``img`` on cornell 500x500, then the CLI's ``--aov all`` and
    ``--denoise`` at the same size, each with its wall and its launch
    counts (the CLI's files go to a temporary directory)."""
    import tempfile

    out, counts = {}, {}
    scene, cam = scene_and_camera("cornell", 500, 500)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aovs = aov.render_aovs(scene, cam, 500, 500, spp=16, seed=SEED)
    out["render_aovs_s"] = time.perf_counter() - t0
    counts["aov"] = read_counts("render_aovs", ("sweep", "aov"),
                                ("pool_step",))
    cov = aovs["coverage"]
    if not (all(np.isfinite(aovs[k]).all() for k in ("albedo", "normal",
                                                      "coverage"))
            and 0.5 < float(cov.mean()) < 1.0
            and np.array_equal(np.isinf(aovs["depth"]), cov == 0)):
        raise AssertionError("cornell AOVs: non-finite or inconsistent "
                             "buffers")
    t0 = time.perf_counter()
    den = denoise(img, aovs["albedo"], aovs["normal"], aovs["depth"],
                  device=DEV)
    torch.cuda.synchronize()
    out["denoise_s"] = time.perf_counter() - t0
    den = den.cpu().numpy()
    rel = abs(float(den.mean()) - float(img.mean())) / float(img.mean())
    out["denoised_mean_rel"] = rel
    log(f"  cornell 500x500: render_aovs 16 spp {out['render_aovs_s']:.3f} "
        f"s (coverage {float(cov.mean()):.4f}), denoise r=3 on the card "
        f"{out['denoise_s']:.3f} s, image mean {float(img.mean()):.6f} -> "
        f"{float(den.mean()):.6f}")
    if den.shape != img.shape or not np.isfinite(den).all() or rel > 0.05:
        raise AssertionError("denoised cornell: bad image or moved mean")
    with tempfile.TemporaryDirectory() as d:
        size = ["--scene", "cornell", "--width", "500", "--height", "500"]
        for what, argv, want, files in (
                ("aov_cli", ["--spp", "16", "--aov", "all", "--out",
                             f"{d}/c.png"], ("sweep", "aov"),
                 [f"{d}/c.{n}.png" for n in aov.AOV_NAMES]),
                ("denoise_cli", ["--spp", "64", "--max-depth", "50",
                                 "--denoise", "--out", f"{d}/d.png"],
                 ("sweep", "pool_step", "aov"), [f"{d}/d.png"])):
            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(size + argv)
            out[f"{what}_s"] = time.perf_counter() - t0
            counts[what] = read_counts(what, want)
            if rc != 0 or not all(os.path.getsize(f) > 0 for f in files):
                raise AssertionError(f"{what}: exit {rc} or files missing")
    log(f"  CLI walls: --aov all {out['aov_cli_s']:.3f} s, --denoise "
        f"{out['denoise_cli_s']:.3f} s")
    return out, counts


class RoundLog:
    """The rounds of the adaptive renders: wraps the seams of
    ``tpu_ray_torch.adaptive`` (``trace_queue``, one call a round;
    ``_pool_round``, one call a slab) and records when each round key is
    first seen."""

    def __init__(self):
        self.starts = {}
        for name, at in (("trace_queue", 6), ("_pool_round", 3)):
            orig = getattr(adaptive, name)

            def wrapped(*a, _orig=orig, _at=at, **kw):
                key = tuple(int(x) for x in a[_at])
                self.starts.setdefault(key, time.perf_counter())
                return _orig(*a, **kw)

            setattr(adaptive, name, wrapped)

    def walls(self, t_end: float) -> list:
        """Each round's wall since the last call, in order; then forget."""
        t = sorted(self.starts.values()) + [t_end]
        self.starts = {}
        return [b - a for a, b in zip(t, t[1:])]


# adaptive against uniform image means: the JAX package's own bound for
# this comparison (tests/test_adaptive.py, rtol 0.08).  Pixels that stop at
# the pilot are darker than their uniform mean (their pilot samples missed
# the light, so their variance looked small): the JAX package's
# render_adaptive is 5.4% darker than uniform on next-week-final 24x24 at
# tol 0.03 on the CPU, the port 5.3%.  The pixels past the pilot are held
# to 5%
ADAPTIVE_MEAN_RTOL = 0.08
ADAPTIVE_PAST_PILOT_RTOL = 0.05


def adaptive_full(name, width, height, budget, tol, uniform, rounds,
                  **kw):
    """A full-width adaptive render (``render_adaptive``, the function
    behind ``render(adaptive=tol)``) within a per-pixel budget of
    ``budget`` samples, depth 50: its wall, rounds and sample counts.
    Every count lies within [pilot, aligned budget] and more than one
    count occurs; the image mean is within ``ADAPTIVE_MEAN_RTOL`` of
    ``uniform``'s (a uniform render of the scene), and over the pixels
    sampled past the pilot within ``ADAPTIVE_PAST_PILOT_RTOL``."""
    scene, cam = scene_and_camera(name, width, height)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, n = adaptive.render_adaptive(scene, cam, width, height,
                                      spp_max=budget, tol=tol, max_depth=50,
                                      seed=SEED, return_spp=True, **kw)
    t1 = time.perf_counter()
    per_round = rounds.walls(t1)
    queue = resolve_mode(scene, kw.get("mode", "auto"),
                         kw.get("engine", "auto")) == "queue"
    q = adaptive.WL_QUANT if queue else adaptive.POOL_REPS
    cap = budget // q * q
    past = n > 16

    def rel(a, b):
        return abs(float(a.mean()) - float(b.mean())) / float(b.mean())

    out = dict(wall_s=t1 - t0, rounds=len(per_round),
               round_walls_s=per_round, spp_min=int(n.min()),
               spp_mean=float(n.mean()), spp_max=int(n.max()),
               samples=int(n.sum()), budget_samples=int(cap * n.size),
               mean=float(img.mean()), uniform_mean=float(uniform.mean()),
               mean_rel_diff=rel(img, uniform),
               pilot_share=float(1.0 - past.mean()),
               past_pilot_rel_diff=rel(img[past], uniform[past]))
    log(f"adaptive {name} {width}x{height} tol {tol} budget {budget} "
        f"(aligned {cap}) depth 50 {kw}: wall {out['wall_s']:.3f} s, "
        f"{len(per_round)} rounds ({', '.join(f'{w:.3f}' for w in per_round)}"
        f" s), spp {out['spp_min']}/{out['spp_mean']:.2f}/{out['spp_max']} "
        f"(min/mean/max), {out['samples']} samples of a "
        f"{out['budget_samples']} budget "
        f"({out['samples'] / out['budget_samples']:.4f}), image mean "
        f"{out['mean']:.6f} vs uniform {out['uniform_mean']:.6f} (rel "
        f"{out['mean_rel_diff']:.4%}); {out['pilot_share']:.4%} of pixels "
        f"stopped at the pilot, mean over the rest vs uniform rel "
        f"{out['past_pilot_rel_diff']:.4%}")
    if img.shape != (height, width, 3) or not np.isfinite(img).all() \
            or n.min() < 16 or n.max() > cap or len(np.unique(n)) < 2:
        raise AssertionError(f"adaptive {name}: counts outside [16, {cap}] "
                             "or one count only")
    if out["mean_rel_diff"] > ADAPTIVE_MEAN_RTOL \
            or out["past_pilot_rel_diff"] > ADAPTIVE_PAST_PILOT_RTOL:
        raise AssertionError(f"adaptive {name}: the image mean moved")
    return img, n, out


def uniform_wall(name, width, height, budget, out, **kw):
    """The uniform render at the adaptive render's aligned budget, for its
    wall beside the adaptive one (``out``)."""
    queue = resolve_mode(SCENES[name].build(seed=SEED, earth=None),
                         kw.get("mode", "auto"),
                         kw.get("engine", "auto")) == "queue"
    q = adaptive.WL_QUANT if queue else adaptive.POOL_REPS
    _, out["uniform_wall_s"], _ = full_width(name, width, height,
                                             budget // q * q, **kw)
    log(f"  {name}: adaptive wall {out['wall_s']:.3f} s, uniform at the "
        f"same budget {out['uniform_wall_s']:.3f} s")


# --- around the render: BVH renders, checkpoint / resume, the CLI's
# --supervise and --progressive, the render server -------------------------

# (scene, width, height, spp) of the full-width bvh renders, depth 50
BVH_FULL = (("cornell", 500, 500, 64), ("book1-final", 600, 400, 16),
            ("next-week-final", 400, 400, 16))
BVH_ABSENT = ("sweep", "sweep_compact", "sweep_masked", "sweep_sphere_mxu",
              "megakernel", "media")


def bvh_full():
    """Each ``BVH_FULL`` render with ``bvh=True`` beside the brute-force
    render of the same call on the pool: the cross-engine criterion,
    whether they are bit-equal, and no sweep launch in the bvh render
    (next-week-final's ``bvh`` renders on the 160000-lane pool, as in the
    JAX package)."""
    out, counts = {}, {}
    for name, w, h, spp in BVH_FULL:
        img_f, wall_f, _ = full_width(name, w, h, spp, mode="pool")
        reset_counts()
        img_b, wall_b, _ = full_width(name, w, h, spp, bvh=True)
        counts[f"bvh_{name}"] = read_counts(f"bvh {name}", ("bvh",
                                                            "pool_step"),
                                            BVH_ABSENT)
        cross_engine(img_f, img_b, f"{name} bvh vs brute force")
        same = bool(np.array_equal(img_f, img_b))
        log(f"  {name}: bvh {wall_b:.3f} s, brute force {wall_f:.3f} s; "
            f"images bit-equal {same}")
        out[name] = dict(bvh_s=wall_b, brute_s=wall_f, bit_equal=same)
    return out, counts


@contextlib.contextmanager
def route_at(n_prims):
    """``integrator.BVH_ROUTE_MIN_PRIMS`` set to ``n_prims`` for the renders
    inside (1 << 62: the route off, every closest hit through the sweeps)."""
    old = integrator.BVH_ROUTE_MIN_PRIMS
    integrator.BVH_ROUTE_MIN_PRIMS = n_prims
    try:
        yield
    finally:
        integrator.BVH_ROUTE_MIN_PRIMS = old


def route_full(img_q, wall_q):
    """The route beside the dense sweep, each pair held bit-equal, with
    walls and launches: next-week-final 400x400 100 spp on the queue
    (``img_q``, rendered through the route at ``wall_q``) against the same
    render with the route off (the dense sweep and the media kernel); and
    book1-final 600x400 16 spp on the pool, below the route's prim count,
    against the same render with the route forced on (the count the route
    was not given: this is where the pool's tail launches lose)."""
    out, counts = {}, {}
    nw = ("next-week-final 400x400 100 spp queue", img_q, wall_q,
          ("sweep", "pool_step", "media") + QUEUE, ("bvh",), 1 << 62,
          lambda: full_width("next-week-final", 400, 400, 100, mode="queue",
                             sort=False))
    reset_counts()
    img_b, wall_b, _ = full_width("book1-final", 600, 400, 16)
    counts["book1_pool"] = read_counts("book1-final pool", ("sweep",
                                                            "pool_step"),
                                       ("bvh",))
    book1 = ("book1-final 600x400 16 spp pool", img_b, wall_b, ROUTE,
             ROUTE_ABSENT, 1,
             lambda: full_width("book1-final", 600, 400, 16))
    for what, want, wall, expect, absent, at, fn in (nw, book1):
        reset_counts()
        with route_at(at):
            img, wall_other, _ = fn()
        read_counts(f"{what}, BVH_ROUTE_MIN_PRIMS={at}", expect, absent)
        same = bool(np.array_equal(img, want))
        log(f"  {what}: default {wall:.3f} s, BVH_ROUTE_MIN_PRIMS={at} "
            f"{wall_other:.3f} s; bit-equal {same}")
        if not same:
            share = float((img != want).any(axis=-1).mean())
            raise AssertionError(f"{what}: the route's render differs from "
                                 f"the dense sweep's on {share:.4%} of "
                                 "pixels")
        out[what] = dict(default_s=wall, other_s=wall_other,
                         route_min_prims=at, bit_equal=same)
    return out, counts


def replay_full():
    """next-week-final 400x400 100 spp on the queue, three renders of one
    scene object (the benchmark's shape) and seeds of their own: the first
    runs eagerly and makes no plan, the second makes the plan and captures
    its graphs (each pool size's first epoch issued iteration by
    iteration), the third replays them for every epoch; then the third's
    seed again with no key (``integrator.replay_key`` None), every
    iteration issued on its own.  The two renders of one seed must be
    bit-equal with the same launches by counter, and the replayed render's
    ``queue_replay_share`` (its iterations run by a replay over those
    dispatched) 1; prints the four walls and the shares."""
    scene, cam = scene_and_camera("next-week-final", 400, 400)
    qc = integrator.QueueCounts

    def one(seed):
        torch.cuda.synchronize()
        i0, r0 = qc.iterations, qc.replayed
        l0 = profiling.launch_counts()
        t0 = time.perf_counter()
        img = render(scene, cam, 400, 400, 100, max_depth=50, seed=seed,
                     mode="queue")
        wall = time.perf_counter() - t0
        n = {k: v - l0[k] for k, v in profiling.launch_counts().items()}
        return img, wall, qc.iterations - i0, qc.replayed - r0, n

    _, wall_f, its_f, rep_f, _ = one(SEED)
    _, wall_c, its_c, rep_c, _ = one(SEED + 1)
    img_r, wall_r, its_r, rep_r, n_r = one(SEED + 2)
    saved = integrator.replay_key
    integrator.replay_key = lambda *a, **k: None
    try:
        img_e, wall_e, its_e, rep_e, n_e = one(SEED + 2)
    finally:
        integrator.replay_key = saved
    same = bool(np.array_equal(img_r, img_e))
    out = dict(first_s=wall_f, capture_s=wall_c, replayed_s=wall_r,
               eager_s=wall_e, capture_replay_share=rep_c / its_c,
               queue_replay_share=rep_r / its_r, iterations=its_r,
               launches=n_r, bit_equal=same)
    log(f"  queue replay, next-week-final 400x400 100 spp: first render "
        f"{wall_f:.3f} s ({rep_f} replayed), capturing render {wall_c:.3f} s "
        f"({rep_c} of {its_c} iterations replayed), replayed {wall_r:.3f} s,"
        f" eager {wall_e:.3f} s; queue_replay_share {rep_r / its_r:.4f} "
        f"({rep_r} of {its_r}); launches replayed {n_r}, eager {n_e}; "
        f"replayed vs eager bit-equal {same}")
    if not same or rep_r != its_r or its_e != its_r or rep_e or rep_f \
            or n_r != n_e or not 0 < rep_c < its_c:
        raise AssertionError(f"queue replay: {out}, eager iterations {its_e}"
                             f" replayed {rep_e} launches {n_e}")
    return out


class Stop(Exception):
    """Raised by an ``on_partial`` to interrupt a render."""


def interrupted(what, fn, expect):
    """``fn()`` must raise ``expect`` (the interruption under test)."""
    try:
        fn()
    except expect as e:
        log(f"  {what}: the first call raised {type(e).__name__}: {e}")
        return
    raise AssertionError(f"{what}: the first call was not interrupted")


def said(what, message, fn):
    """``fn()`` with stderr captured: it must say ``message``."""
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        img = fn()
    if message not in err.getvalue():
        raise AssertionError(f"{what}: no {message!r} on stderr")
    log(f"  {what}: stderr said {message!r}")
    return img


def checkpoint_full(d):
    """Checkpoint / resume at full width, each resumed render bit-equal to
    the uninterrupted render of the same call: the pool and the megakernel
    (cornell 500x500 64 spp, ``samples_per_wave=2``: 8 waves, a checkpoint
    every 2, a crash injected before wave 5, resumed at wave 4) and the
    queue (next-week-final 400x400 16 spp in 4 chunks, ``QUEUE_PLANE_BYTES``
    lowered; an ``on_partial`` that raises after chunk 2, which the
    checkpoint saved before it was called)."""
    out, counts = {}, {}
    for engine in ("auto", "mega"):
        what = f"checkpoint pool engine={engine}"
        kw = dict(samples_per_wave=2, engine=engine)
        full, _, _ = full_width("cornell", 500, 500, 64, **kw)
        ck = os.path.join(d, f"pool-{engine}.npz")
        reset_counts()
        interrupted(what, lambda: with_env(
            {"TPU_RAY_CRASH_AFTER_WAVE": "5"},
            lambda: full_width("cornell", 500, 500, 64, checkpoint_path=ck,
                               checkpoint_every=2, **kw)), RuntimeError)
        img = said(what, "resuming at wave 4", lambda: full_width(
            "cornell", 500, 500, 64, checkpoint_path=ck, progress=True,
            **kw)[0])
        counts[f"checkpoint_{'mega' if engine == 'mega' else 'pool'}"] = \
            read_counts(what, ("megakernel",) if engine == "mega"
                        else ("sweep", "pool_step"))
        out[engine] = same = bool(np.array_equal(img, full))
        log(f"  {what}: resumed image bit-equal to the uninterrupted one "
            f"{same}")
        if not same:
            raise AssertionError(f"{what}: the resumed render differs")
    what = "checkpoint queue"
    old = renderer.QUEUE_PLANE_BYTES
    renderer.QUEUE_PLANE_BYTES = 400 * 400 * 12 * 4   # 4 samples a chunk
    try:
        full, _, _ = full_width("next-week-final", 400, 400, 16,
                                mode="queue")
        ck = os.path.join(d, "queue.npz")
        seen = []

        def stop(img, rows_final):
            seen.append(rows_final)
            if len(seen) == 2:
                raise Stop("on_partial after chunk 2")

        reset_counts()
        interrupted(what, lambda: full_width(
            "next-week-final", 400, 400, 16, mode="queue", checkpoint_path=ck,
            checkpoint_every=1, on_partial=stop), Stop)
        img = said(what, "resuming at chunk 2", lambda: full_width(
            "next-week-final", 400, 400, 16, mode="queue", checkpoint_path=ck,
            progress=True)[0])
        counts["checkpoint_queue"] = read_counts(what, NW_QUEUE,
                                                 ROUTE_ABSENT)
    finally:
        renderer.QUEUE_PLANE_BYTES = old
    out["queue"] = same = bool(np.array_equal(img, full))
    log(f"  {what}: resumed image bit-equal to the uninterrupted one {same}")
    if not same:
        raise AssertionError(f"{what}: the resumed render differs")
    return out, counts


def png_pixels(path):
    """(H, W, 3) uint8 of a PNG written by ``film.png_bytes`` (one IDAT of
    filter-0 rows): a torn or partial file fails to decode."""
    import zlib

    data = open(path, "rb").read()
    w, h = (int.from_bytes(data[16 + 4 * k:20 + 4 * k], "big")
            for k in range(2))
    i = data.index(b"IDAT")
    n = int.from_bytes(data[i - 4:i], "big")
    raw = np.frombuffer(zlib.decompress(data[i + 4:i + 4 + n]), np.uint8)
    return raw.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def cli_stdout(argv):
    """``cli.main(argv)`` in this process; returns (exit code, stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def cli_full(d):
    """The CLI on the card, cornell 500x500 64 spp ``--samples-per-wave 2``
    (8 waves): a clean run's PPM; ``--supervise 2`` in a subprocess with a
    checkpoint every wave and a crash injected before wave 3, whose stdout
    must be the clean PPM byte for byte and whose stderr must show the
    retry and the resume; ``--progressive`` to stdout (the same bytes) and
    to a PNG, which must decode whole after every rewrite and end as the
    clean image."""
    from tpu_ray_torch.core import film

    base = ["--scene", "cornell", "--width", "500", "--height", "500",
            "--spp", "64", "--samples-per-wave", "2"]
    out, counts = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    rc, clean = cli_stdout(base)
    out["clean_s"] = time.perf_counter() - t0
    counts["cli"] = read_counts("cli", ("sweep", "pool_step"))
    if rc != 0 or clean.split()[:4] != ["P3", "500", "500", "255"]:
        raise AssertionError("the clean CLI run wrote no PPM")
    pixels = np.array(clean.split()[4:], np.uint8).reshape(500, 500, 3)
    env = dict(os.environ, TPU_RAY_CRASH_AFTER_WAVE="3")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch"] + base
        + ["--checkpoint", os.path.join(d, "sup.npz"), "--checkpoint-every",
           "1", "--supervise", "2"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    out["supervise_s"] = time.perf_counter() - t0
    same = r.stdout == clean
    log(f"  --supervise 2: exit {r.returncode}, {out['supervise_s']:.1f} s; "
        f"stdout byte-identical to the clean run {same}; stderr has "
        f"'retry 1/2' {'retry 1/2' in r.stderr}, 'resuming at wave 3' "
        f"{'resuming at wave 3' in r.stderr}")
    if r.returncode != 0 or not same or "[supervise] retry 1/2" not in \
            r.stderr or "resuming at wave 3" not in r.stderr:
        raise AssertionError("--supervise did not recover the crashed "
                             f"render: {r.stderr[-2000:]}")
    rc, prog = cli_stdout(base + ["--progressive"])
    log(f"  --progressive --out -: byte-identical to the plain PPM "
        f"{prog == clean}")
    if rc != 0 or prog != clean:
        raise AssertionError("--progressive --out - differs from the PPM")
    path = os.path.join(d, "p.png")
    orig, seen = film.ProgressiveOutput.update, []

    def spy(po, img, rows_final):
        orig(po, img, rows_final)
        seen.append(png_pixels(po.path))

    film.ProgressiveOutput.update = spy
    try:
        rc = cli.main(base + ["--progressive", "--out", path])
    finally:
        film.ProgressiveOutput.update = orig
    whole = all(s.shape == (500, 500, 3) for s in seen)
    final = bool(np.array_equal(png_pixels(path), pixels))
    log(f"  --progressive --out p.png: {len(seen)} rewrites (7 waves and "
        f"the finish), each whole {whole}; the last equals the PPM {final}")
    if rc != 0 or len(seen) != 8 or not whole or not final:
        raise AssertionError("--progressive --out p.png was not rewritten "
                             "whole after every wave")
    return out, counts


def read_pfm(path):
    raw = open(path, "rb").read()
    _, dims, _, body = raw.split(b"\n", 3)
    w, h = (int(v) for v in dims.split())
    return np.frombuffer(body, "<f4").reshape(h, w, 3)[::-1]


def serve_full(d):
    """``serve()`` in this process on the card: ping, warm, two identical
    cornell 500x500 64 spp renders, one with ``bvh``, one with
    ``denoise``, stats and quit.  Each image (.pfm, the linear floats) must
    be bit-equal to a direct ``render()`` of the same request (with the
    denoise: ``render_aovs`` at 16 spp and ``denoise`` r=3)."""
    import io

    from tpu_ray_torch.utils.server import serve

    w, h, spp = 500, 500, 64
    req = {"scene": "cornell", "width": w, "height": h, "spp": spp}
    outs = {k: os.path.join(d, f"{k}.pfm") for k in ("a", "b", "bvh", "den")}
    reqs = [{"cmd": "ping", "id": "ping"}, dict(req, cmd="warm", id="warm"),
            dict(req, out=outs["a"], id="a"), dict(req, out=outs["b"], id="b"),
            dict(req, out=outs["bvh"], bvh=True, id="bvh"),
            dict(req, out=outs["den"], denoise=True, id="den"),
            {"cmd": "stats", "id": "stats"}, {"cmd": "quit", "id": "quit"}]
    sink = io.StringIO()
    reset_counts()
    rc = serve(io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n"),
               sink)
    counts = {"serve": read_counts("serve", ("sweep", "pool_step", "bvh",
                                             "aov"))}
    lines = [json.loads(ln) for ln in sink.getvalue().splitlines()]
    by_id = {ln.get("id"): ln for ln in lines[1:]}
    if rc != 0 or lines[0] != {"ok": True, "ready": True} or not all(
            by_id.get(r["id"], {}).get("ok") for r in reqs):
        raise AssertionError(f"serve: a request failed: {lines}")
    scene, cam = scene_and_camera("cornell", w, h)
    img = render(scene, cam, w, h, spp)
    img_bvh = render(scene, cam, w, h, spp, bvh=True)
    aovs = aov.render_aovs(scene, cam, w, h, spp=16, seed=SEED)
    den = denoise(img, aovs["albedo"], aovs["normal"], aovs["depth"],
                  radius=3).cpu().numpy()
    equal = {k: bool(np.array_equal(read_pfm(outs[k]), want))
             for k, want in (("a", img), ("b", img), ("bvh", img_bvh),
                             ("den", den))}
    out = dict(first_s=by_id["a"]["wall_s"], second_s=by_id["b"]["wall_s"],
               warm_s=by_id["warm"]["wall_s"], bvh_s=by_id["bvh"]["wall_s"],
               denoise_s=by_id["den"]["wall_s"], bit_equal=equal,
               kernels_loaded=by_id["stats"]["kernels"]["loaded"])
    log(f"  serve: warm {out['warm_s']} s, first render {out['first_s']} s, "
        f"second {out['second_s']} s, bvh {out['bvh_s']} s, denoise "
        f"{out['denoise_s']} s; bit-equal to direct renders {equal}; "
        f"stats kernels {out['kernels_loaded']}")
    if not all(equal.values()):
        raise AssertionError("serve: an image differs from the direct render")
    return out, counts


# --- the pool plan above 512 prims: lane caps, the per-wave sample budget
# and row bands ---------------------------------------------------------------
def band_plans(name, width, height, spp, rays_per_wave=1 << 20,
               samples_per_wave=64, engine="xla", _band_cap=None):
    """[(row0, rows, (k_pool, s_wave, waves)), ...]: the bands ``render``
    makes of the request (one, the frame, when it does not band) and each
    band's ``plan_pool``."""
    scene = SCENES[name].build(seed=SEED, earth=None)
    cap = (renderer.lane_cap(scene.n_prims, engine) if _band_cap is None
           else _band_cap)
    band_h = height if cap is None or width * height <= cap \
        else max(1, cap // width)
    return [(r0, min(band_h, height - r0),
             plan_pool(scene, width, min(band_h, height - r0), spp,
                       rays_per_wave, samples_per_wave, engine))
            for r0 in range(0, height, band_h)]


def band_render(what, want_plans, expect, absent, name, width, height, spp,
                **kw):
    """A full-width render (depth 50) with its plan checked against
    ``want_plans`` and printed, its launches counted alone, and the rows
    its ``on_partial`` reported final, each equal to the finished image's
    rows: (image, wall, counts, rows)."""
    plans = band_plans(name, width, height, spp, **{
        k: kw[k] for k in ("rays_per_wave", "samples_per_wave", "engine",
                           "_band_cap") if k in kw})
    if [(rows, plan) for _, rows, plan in plans] != want_plans:
        raise AssertionError(f"{what}: bands and plans {plans}, not "
                             f"{want_plans}")
    rows, final = [], []

    def report(im, rf):
        rows.append(rf)
        final.append(im[:rf].copy())

    reset_counts()
    img, wall, _ = full_width(name, width, height, spp, on_partial=report,
                              **kw)
    counts = read_counts(what, expect, absent)
    if not all(np.array_equal(f, img[:len(f)]) for f in final):
        raise AssertionError(f"{what}: a row reported final differs from "
                             "the finished image's")
    log(f"  {what}: {len(plans)} band(s), (rows, (k_pool, s_wave, waves)) "
        f"{[(r, p) for _, r, p in plans]}; sweep launches "
        f"{counts['sweep']}, step launches {counts['pool_step']}, bvh "
        f"{counts['bvh']}, megakernel {counts['megakernel']}; wall "
        f"{wall:.3f} s; rows reported final {sorted(set(rows))}")
    return img, wall, counts, rows


def hold_bits(what, a, b):
    same = bool(np.array_equal(a, b))
    log(f"  {what}: bit-equal {same}")
    if not same:
        raise AssertionError(f"{what}: the images differ")


def bands_full():
    """The JAX package's pool plan above 512 prims at full width, each
    render's plan and launches printed: (a) next-week-final 400x400 16 spp
    on the pool, 160000 lanes, beside the queue render (one estimator,
    other noise); (b) 600x400 16 spp one sample a wave in bands of 266 and
    134 rows, bit-equal to the unbanded render of the same plan
    (``_band_cap``), its reported rows exact and ending at 400; (c) the
    same with the default samples a wave, each band its own plan; (d) the
    same with ``bvh=True`` (no sweep launch) against (c); (e) cornell
    500x500 16 spp forced into four 125-row bands on the wavefront pool
    and the megakernel, each bit-equal to its unbanded render; (f) a mesh
    of two ``cuda:0`` entries at 600x400 1 spp, which the JAX package
    demotes from its queue to its pool, against the single-device banded
    render."""
    from tpu_ray_torch.parallel.mesh import make_mesh

    nw, out, counts = "next-week-final", {}, {}
    pool = ROUTE             # next-week-final's default closest hit
    no_sweep = ("megakernel",) + ROUTE_ABSENT
    img_a, wall_a, counts["bands_a_pool"], _ = band_render(
        "(a) next-week-final 400x400 pool", [(400, (1, 2, 8))], pool,
        no_sweep, nw, 400, 400, 16, mode="pool")
    img_q, wall_q, _ = full_width(nw, 400, 400, 16, mode="queue")
    same_estimator(img_a, img_q, "(a) pool vs queue", share_cap=1.0)
    out["a"] = dict(pool_s=wall_a, queue_s=wall_q)
    kw = dict(mode="pool", samples_per_wave=1)
    img_b, wall_b, counts["bands_b"], rows = band_render(
        "(b) next-week-final 600x400 one sample a wave",
        [(266, (1, 1, 16)), (134, (1, 1, 16))], pool, no_sweep, nw,
        600, 400, 16, **kw)
    img_u, wall_u, counts["bands_b_unbanded"], _ = band_render(
        "(b) unbanded (_band_cap 600*400)", [(400, (1, 1, 16))], pool,
        no_sweep, nw, 600, 400, 16, _band_cap=600 * 400, **kw)
    hold_bits("(b) banded vs unbanded", img_b, img_u)
    if rows != sorted(rows) or rows[-1] != 400 or 266 not in rows:
        raise AssertionError(f"(b): rows reported final {rows}")
    out["b"] = dict(banded_s=wall_b, unbanded_s=wall_u, rows_final=rows[-1])
    img_c, wall_c, counts["bands_c"], _ = band_render(
        "(c) next-week-final 600x400", [(266, (1, 2, 8)), (134, (1, 4, 4))],
        pool, no_sweep, nw, 600, 400, 16, mode="pool")
    img_d, wall_d, counts["bands_d_bvh"], _ = band_render(
        "(d) next-week-final 600x400 bvh",
        [(266, (1, 2, 8)), (134, (1, 4, 4))], ("bvh", "pool_step"),
        BVH_ABSENT, nw, 600, 400, 16, bvh=True)
    cross_engine(img_c, img_d, "(d) bvh vs brute force, banded")
    out["c"] = dict(wall_s=wall_c)
    out["d"] = dict(wall_s=wall_d, bit_equal_c=bool(np.array_equal(img_c,
                                                                    img_d)))
    log(f"  walls: (b) {wall_b:.3f} s, (c) {wall_c:.3f} s, (d) bvh "
        f"{wall_d:.3f} s; (a) pool {wall_a:.3f} s, queue {wall_q:.3f} s")
    for engine, expect, absent in (
            ("auto", ("sweep", "pool_step"), ("megakernel", "bvh")),
            ("mega", ("megakernel",), ("sweep", "pool_step", "bvh"))):
        kw = dict(rays_per_wave=62500, samples_per_wave=1, engine=engine)
        plan = [(125, (1, 1, 16))] * 4
        img_e, wall_e, counts[f"bands_e_{engine}"], _ = band_render(
            f"(e) cornell 500x500 engine={engine} in bands", plan, expect,
            absent, "cornell", 500, 500, 16, _band_cap=62500, **kw)
        img_f, wall_f, _, _ = band_render(
            f"(e) cornell 500x500 engine={engine} unbanded",
            [(500, (1, 1, 16))], expect, absent, "cornell", 500, 500, 16,
            **kw)
        hold_bits(f"(e) engine={engine} banded vs unbanded", img_e, img_f)
        if engine == "mega" and counts["bands_e_mega"]["megakernel"] != 64:
            raise AssertionError("(e): not one megakernel launch a band and "
                                 "wave")
        out[f"e_{engine}"] = dict(banded_s=wall_e, unbanded_s=wall_f)
    mesh2 = make_mesh(device=["cuda:0"] * 2)
    single, wall_1, _, _ = band_render(
        "(f) single device", [(266, (1, 1, 1)), (134, (1, 1, 1))], pool,
        no_sweep, nw, 600, 400, 1, mode="pool")
    meshed, wall, counts["bands_f_mesh"], rows = said(
        "(f) mesh D=2", "demoting mode=queue to the wave pool: sharding",
        lambda: band_render("(f) mesh D=2",
                            [(266, (1, 1, 1)), (134, (1, 1, 1))], pool,
                            no_sweep, nw, 600, 400, 1, mesh=mesh2))
    err, equal = hold_mesh("(f) next-week-final 600x400 1 spp D=2", single,
                           meshed, 1e-4, 1e-5)
    out["f"] = dict(mesh_s=wall, single_s=wall_1, max_abs_diff=err,
                    bit_equal=equal, rows_final=rows[-1])
    return out, counts


# --- device meshes: every entry cuda:0 on the one card, so the walls measure
# the rounds' schedule and keying, not scaling --------------------------------
def mesh_render(what, expect, absent, fn):
    """``fn()`` timed with the launch counts set to 0 before and read after:
    (its result, wall, counts).  ``full_width`` times its render alone and
    returns that wall with the image."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return img, wall, read_counts(what, expect, absent)


def hold_mesh(what, single, meshed, rtol, atol):
    """The mesh render against the single-device render of the same request
    at the JAX package's mesh-test tolerance."""
    a, b = (np.asarray(x[0] if isinstance(x, tuple) else x)
            for x in (single, meshed))
    err = float(np.abs(a - b).max())
    equal = bool(np.array_equal(a, b))
    log(f"  {what}: mesh vs single device max abs diff {err:.3e} "
        f"(rtol {rtol} / atol {atol}), bit-equal {equal}")
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
    return err, equal


def mesh_full(d):
    """Full-width renders on meshes whose entries are all ``cuda:0``, each
    held to the single-device render of the same request, each wall beside
    the single-device wall (one render each): cornell 500x500 64 spp in 8
    waves (``samples_per_wave=2``) on the pool and the megakernel, D = 2 (4
    rounds); next-week-final 400x400 16 spp on the queue, D = 3 (a chunk of
    15 samples, 5 a device, and a 1-sample chunk on ``mesh[0]``); cornell
    500x500 ``adaptive`` tol 0.03 budget 1000 on the queue backend, D = 2
    (equal sample counts); the pool render resumed from a per-round
    checkpoint (a crash injected before round 2), bit-equal; and
    ``make_mesh(2)`` on this one-card machine raises."""
    from tpu_ray_torch.parallel.mesh import make_mesh

    out, counts = {}, {}
    if torch.cuda.device_count() == 1:
        try:
            make_mesh(2)
        except RuntimeError as e:
            log(f"  make_mesh(2) on one card raised: {e}")
        else:
            raise AssertionError("make_mesh(2) on one card did not raise")
    mesh2 = make_mesh(device=["cuda:0"] * 2)
    mesh3 = make_mesh(device=["cuda:0"] * 3)
    for engine, path, expect, absent in (
            ("auto", "mesh_pool", ("sweep", "pool_step"), ("megakernel",)),
            ("mega", "mesh_mega", ("megakernel",), ("sweep", "pool_step"))):
        # an interval with no path: no auto checkpoint, which the 8-wave
        # single-device render would take (a film save a wave) and the
        # 4-round mesh render would not
        kw = dict(samples_per_wave=2, engine=engine, checkpoint_every=1)
        single, _, n_1 = mesh_render(
            f"{path} single device", expect, absent,
            lambda: full_width("cornell", 500, 500, 64, **kw))
        single, wall_1 = single[:2]
        img, _, counts[path] = mesh_render(
            f"{path} D=2", expect, absent,
            lambda: full_width("cornell", 500, 500, 64, mesh=mesh2, **kw))
        img, wall = img[:2]
        if engine == "mega" and counts[path]["megakernel"] != 8:
            raise AssertionError("the mesh megakernel render did not launch "
                                 "one megakernel a wave")
        err, equal = hold_mesh(f"cornell engine={engine} D=2", single, img,
                               1e-4, 1e-5)
        out[path] = dict(wall_s=wall, single_wall_s=wall_1, max_abs_diff=err,
                         bit_equal=equal, single_launches=n_1)
        if engine == "auto":
            full_pool = img
    single, _, n_1 = mesh_render(
        "mesh_queue single device", NW_QUEUE, ("megakernel",) + ROUTE_ABSENT,
        lambda: full_width("next-week-final", 400, 400, 16, mode="queue"))
    single, wall_1 = single[:2]
    img, _, counts["mesh_queue"] = mesh_render(
        "mesh_queue D=3", NW_QUEUE, ("megakernel",) + ROUTE_ABSENT,
        lambda: full_width("next-week-final", 400, 400, 16, mode="queue",
                           mesh=mesh3))
    img, wall = img[:2]
    err, equal = hold_mesh("next-week-final queue D=3", single, img, 1e-5,
                           1e-6)
    out["mesh_queue"] = dict(wall_s=wall, single_wall_s=wall_1,
                             max_abs_diff=err, bit_equal=equal,
                             single_launches=n_1)
    scene, cam = scene_and_camera("cornell", 500, 500)
    kw = dict(spp_max=1000, tol=0.03, max_depth=50, seed=SEED,
              return_spp=True)
    single, wall_1, n_1 = mesh_render(
        "mesh_adaptive_queue single device", ("sweep", "pool_step") + QUEUE,
        ("megakernel",), lambda: adaptive.render_adaptive(
            scene, cam, 500, 500, mode="queue", **kw))
    meshed, wall, counts["mesh_adaptive_queue"] = mesh_render(
        "mesh_adaptive_queue D=2", ("sweep", "pool_step") + QUEUE,
        ("megakernel",),
        lambda: adaptive.render_adaptive(scene, cam, 500, 500, mesh=mesh2,
                                         **kw))
    same_n = bool(np.array_equal(single[1], meshed[1]))
    log(f"  adaptive cornell queue D=2: sample counts equal {same_n} (spp "
        f"{int(single[1].min())}-{int(single[1].max())}, mean "
        f"{float(single[1].mean()):.2f}); walls mesh {wall:.3f} s, single "
        f"{wall_1:.3f} s")
    if not same_n:
        raise AssertionError("adaptive mesh sample counts differ from the "
                             "single-device render's")
    err, equal = hold_mesh("adaptive cornell queue D=2", single, meshed,
                           1e-4, 1e-5)
    out["mesh_adaptive_queue"] = dict(
        wall_s=wall, single_wall_s=wall_1, max_abs_diff=err,
        bit_equal=equal, counts_equal=same_n,
        spp_mean=float(single[1].mean()), single_launches=n_1)
    what = "mesh resume pool D=2"
    ck = os.path.join(d, "mesh.npz")
    kw = dict(samples_per_wave=2, mesh=mesh2)
    reset_counts()
    interrupted(what, lambda: with_env(
        {"TPU_RAY_CRASH_AFTER_WAVE": "2"},
        lambda: full_width("cornell", 500, 500, 64, checkpoint_path=ck,
                           checkpoint_every=1, **kw)), RuntimeError)
    img = said(what, "resuming at round 2", lambda: full_width(
        "cornell", 500, 500, 64, checkpoint_path=ck, progress=True, **kw)[0])
    counts["mesh_resume"] = read_counts(what, ("sweep", "pool_step"))
    out["mesh_resume_bit_equal"] = same = bool(np.array_equal(img,
                                                              full_pool))
    log(f"  {what}: resumed image bit-equal to the uninterrupted one {same}")
    if not same:
        raise AssertionError(f"{what}: the resumed render differs")
    for k, v in out.items():
        if isinstance(v, dict):
            log(f"  {k}: mesh wall {v['wall_s']:.3f} s, single device "
                f"{v['single_wall_s']:.3f} s")
    return out, counts


# walls in s of the renders the media and queue kernels move, as this
# script measured them while the torch twins ran on the card (one H100
# 80GB HBM3 at 700 W, two calls; PERF.md section 6): the cornell-smoke
# wavefront pool and the bands (a), (c), (d)
WALLS_BEFORE = {"cornell-smoke pool": (0.432,),
                "bands (a) pool": (1.446, 2.226),
                "bands (c)": (3.934, 4.277), "bands (d) bvh": (0.444, 0.401)}


@contextlib.contextmanager
def plain_twins():
    """``merge_media``, ``path_ids`` and ``queue_inject`` replaced by their
    plain twins in the modules whose callers look them up at each call
    (``ops.intersect.intersect_ti``, ``integrator.queue_body``), and no
    queue render keyed for a plan (``integrator.replay_key`` None), so each
    queue iteration calls them instead of replaying a captured graph."""
    names = ((intersect, "merge_media", intersect.merge_media_plain),
             (queue, "path_ids", queue.path_ids_plain),
             (queue, "queue_inject", queue.queue_inject_plain),
             (integrator, "replay_key", lambda *a, **k: None))
    saved = [getattr(mod, n) for mod, n, _ in names]
    for mod, n, twin in names:
        setattr(mod, n, twin)
    try:
        yield
    finally:
        for (mod, n, _), fn in zip(names, saved):
            setattr(mod, n, fn)


def twins_full(img_q, img_s, img_aq, n_aq, img_b0):
    """The phase-5 renders whose paths run the media or queue kernels, each
    rendered again with those three wrappers replaced by their plain twins
    (``plain_twins``: torch on the card) and held bit-equal: cornell-smoke
    500x500 64 spp on the pool (rendered here first, its launches counted,
    its wall beside ``WALLS_BEFORE``), next-week-final 400x400 100 spp on
    the queue unsorted and sorted, the adaptive next-week-final queue (tol
    0.03, budget 1000; count maps too) and cornell 500x500 64 spp sobol-b0
    on the queue.  A render that differs is printed with its share of differing
    pixels and held to the cross-engine criterion; the block fails after
    all five."""
    nw = "next-week-final"
    reset_counts()
    img_cs, wall_cs, _ = full_width("cornell-smoke", 500, 500, 64)
    counts = {"media_pool": read_counts(
        "cornell-smoke pool", ("sweep", "pool_step", "media"),
        ("megakernel",) + QUEUE)}
    log(f"  cornell-smoke 500x500 64 spp pool wall {wall_cs:.3f} s (before "
        f"the media kernel: {WALLS_BEFORE['cornell-smoke pool'][0]:.3f} s)")
    scene, cam = scene_and_camera(nw, 400, 400)
    renders = (
        ("cornell-smoke 500x500 64 spp pool", img_cs,
         lambda: full_width("cornell-smoke", 500, 500, 64)[0]),
        ("next-week-final 400x400 100 spp queue", img_q,
         lambda: full_width(nw, 400, 400, 100, mode="queue", sort=False)[0]),
        ("next-week-final 400x400 100 spp sorted queue", img_s,
         lambda: full_width(nw, 400, 400, 100, mode="queue", sort=True)[0]),
        ("adaptive next-week-final 400x400 queue", (img_aq, n_aq),
         lambda: adaptive.render_adaptive(scene, cam, 400, 400, spp_max=1000,
                                          tol=0.03, max_depth=50, seed=SEED,
                                          return_spp=True)),
        ("cornell 500x500 64 spp sobol-b0 queue", img_b0,
         lambda: full_width("cornell", 500, 500, 64, sampler="sobol-b0",
                            mode="queue")[0]))
    out = {"cornell-smoke pool": dict(
        wall_s=wall_cs, walls_before_s=WALLS_BEFORE["cornell-smoke pool"])}
    differ = []
    for what, want, fn in renders:
        reset_counts()
        t0 = time.perf_counter()
        with plain_twins():
            got = fn()
        wall = time.perf_counter() - t0
        twins = {k: PLAIN[k].calls for k in ("media", "path_ids",
                                             "queue_inject")}
        kernels = {k: COUNTERS[k].launches for k in ("media", "path_ids",
                                                     "queue_inject")}
        if max(kernels.values()) or not max(twins.values()):
            raise AssertionError(f"{what}: the twins did not stand in "
                                 f"({kernels}, {twins})")
        pairs = list(zip(want, got)) if isinstance(want, tuple) \
            else [(want, got)]
        same = all(np.array_equal(a, b) for a, b in pairs)
        share = float((pairs[0][0] != pairs[0][1]).any(axis=-1).mean())
        log(f"  {what}: with the plain twins (calls {twins}) {wall:.3f} s; "
            f"bit-equal to the kernels' render {same} (pixels differing "
            f"{share:.4%})")
        if not same:
            cross_engine(pairs[0][0], pairs[0][1], f"{what} kernels vs twins")
            differ.append(what)
        out[what] = dict(bit_equal=same, differing_share=share,
                         twins_wall_s=wall)
    if differ:
        raise AssertionError(f"renders differ from their plain-twin "
                             f"renders: {differ}")
    return out, counts


def main() -> int:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"phase 1: device {kind}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    # no stale auto checkpoint may shorten a timed render
    renderer.clear_auto_checkpoints()

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"phase 2: built {sorted(secs)} in {time.perf_counter() - t0:.2f} s")
    for n, txt in build.build_log.items():
        fn = ""                 # the entry ptxas reports on (mangled)
        for line in txt.splitlines():
            if "Function properties for" in line:
                fn = line.split(" for ", 1)[1].strip()
            if "registers" in line or "spill" in line:
                log(f"  {n}: {fn}: {line.strip()}")
    n_hmma = hmma_count()
    log(f"  sweep_mxu: {n_hmma} HMMA (tensor-core) instructions in its SASS")
    if n_hmma == 0:
        raise AssertionError("the matrix-product sweep has no tensor-core "
                             "instruction")

    log("phase 3: kernels vs plain versions at main-path shapes")
    check_sqrt()
    sw = check_sweep("cornell", 500, 500, 64, 0)
    check_sweep("cornell", 500, 500, 64, 1)
    check_sweep("book1-final", 600, 400, 16, 0)
    sw_book1 = check_sweep("book1-final", 600, 400, 16, 1,
                           parts=(240000, 60000, 3000, 1))
    check_sweep("cornell-smoke", 500, 500, 64, 2)
    sw_box = check_sweep("box-grid", 1000, 1000, 1, 1)
    sw_nw = check_sweep("next-week-final", 1000, 1000, 1, 1)
    st = check_step("cornell", 500, 500, 64, 3)
    check_step("cornell-smoke", 500, 500, 64, 3)
    check_step("two-spheres", 500, 500, 64, 3)
    check_step("two-perlin-spheres", 500, 500, 64, 2)
    st_sobol = check_step("cornell", 500, 500, 64, 3, sampler="sobol")
    st_strict_perlin = check_step("two-perlin-spheres", 500, 500, 64, 2,
                                  strict=True)
    st_strict_sky = check_step("perlin-sky", 500, 500, 64, 2, strict=True)
    st_strict_media = check_step("cornell-smoke", 500, 500, 64, 3,
                                 strict=True)
    st_nw = check_step("next-week-final", 1000, 1000, 1, 2)
    check_step("earth", 500, 500, 64, 2, earth=seeded_image())
    st_queue = check_step_queue("next-week-final", 1000, 1000, 6)
    check_step_queue("earth", 1000, 1000, 4, earth=seeded_image())
    st_b0 = check_step_queue("cornell", 1000, 1000, 4, sampler="sobol-b0")
    st_b0_nw = check_step_queue("next-week-final", 1000, 1000, 6,
                                sampler="sobol-b0")
    st_tex = check_step("checker-tex", 500, 500, 64, 2)
    st_tex_strict = check_step("checker-tex", 500, 500, 64, 2, strict=True)
    st_emissive = check_step("emissive-image", 500, 500, 64, 2)
    hsc = check_hit_scatter("cornell", 500, 500, 64, 3)
    hsc_perlin = check_hit_scatter("two-perlin-spheres", 500, 500, 64, 2)
    hsc_strict = check_hit_scatter("perlin-sky", 500, 500, 64, 2, strict=True)
    hsc_strict_media = check_hit_scatter("cornell-smoke", 500, 500, 64, 3,
                                         strict=True)
    hsc_tex = check_hit_scatter("checker-tex", 500, 500, 64, 2)
    av = check_aov("cornell", 500, 500, 4)
    av_tex = check_aov("checker-tex", 500, 500, 4)
    sc_nw = check_sweep_compact("next-week-final", 1000, 1000, 1, 1)
    sc_book1 = check_sweep_compact("book1-final", 600, 400, 16, 1)
    sc_box = check_sweep_compact("box-grid", 1000, 1000, 1, 1)
    mg = check_mega("cornell", 500, 500, 8)
    mg_smoke = check_mega("cornell-smoke", 250, 250, 8)
    mg_perlin = check_mega("two-perlin-spheres", 250, 250, 8)
    mg_book1 = check_mega("book1-final", 300, 200, 8)
    mg_sobol = check_mega("cornell", 500, 500, 8, sampler="sobol")
    mg_full = {name: mega_schedules(f"{name} {w}x{h} {spp} spp depth 50",
                                    mega_wave(name, w, h, spp, 50))[0]
               for name, w, h, spp in MEGA_FULL}
    sm_nw = check_sweep_masked("next-week-final", 1000, 1000, 1, 1)
    mx_book1 = check_sweep_mxu("book1-final", 600, 400, 16, 1)
    bv = {"cornell camera": check_bvh("cornell", 500, 500, 64, 0),
          "cornell bounce 1": check_bvh("cornell", 500, 500, 64, 1),
          "book1-final bounce 1": check_bvh("book1-final", 600, 400, 16, 1),
          "next-week-final bounce 1": check_bvh("next-week-final", 1000,
                                                1000, 1, 1)}
    md = {"cornell-smoke bounce 1": check_media("cornell-smoke", 500, 500, 64,
                                                1),
          "next-week-final bounce 1": check_media("next-week-final", 1000,
                                                  1000, 1, 1)}
    qi = {"uniform": check_inject("next-week-final", 1000, 1000, 6),
          "sobol": check_inject("next-week-final", 1000, 1000, 6,
                                sampler="sobol"),
          "sobol-b0": check_inject("next-week-final", 1000, 1000, 6,
                                   sampler="sobol-b0"),
          "worklist": check_inject("next-week-final", 1000, 1000, 6,
                                   worklist=True)}

    log("phase 4: goldens on the card; image, textured-checker, "
        "emissive-image scenes and AOVs card vs cpu")
    for name in GOLDENS:
        check_golden(name)
    check_card_vs_cpu("earth with a seeded image",
                      SCENES["earth"].build(seed=SEED, earth=seeded_image()),
                      SCENES["earth"].camera(48, 32), 48, 32, spp=8,
                      max_depth=8, seed=SEED)
    for name in GOLDENS:
        if megakernel.supported(SCENES[name].build(seed=SEED, earth=None)):
            check_golden(name, engine="mega")
    for name in STRICT_GOLDENS:
        check_strict_golden(name)
    for name, mode, strict in (("checker-tex", "pool", False),
                               ("checker-tex", "queue", True),
                               ("checker-tex", "wave", False),
                               ("emissive-image", "pool", False)):
        check_card_vs_cpu(f"{name} 48x32 {mode}{variant(strict=strict)}",
                          *scene_and_camera(name, 48, 32, strict=strict), 48,
                          32, spp=8, max_depth=8, seed=SEED, mode=mode)
    for name in ("cornell", "cornell-smoke", "checker-tex"):
        scene, cam = scene_and_camera(name, 48, 32)
        hold_aovs(aov.render_aovs(scene, cam, 48, 32, spp=4, seed=SEED,
                                  device="cpu"),
                  aov.render_aovs(scene, cam, 48, 32, spp=4, seed=SEED),
                  f"render_aovs {name} 48x32 card vs cpu")

    log("phase 5: full-width renders through the kernels")
    reset_counts()
    img_c, _, bright = full_width("cornell", 500, 500, 64)
    full_width("book1-final", 600, 400, 16)
    n_pool = read_counts("pool", ("sweep", "pool_step"))
    if not 48.0 <= bright <= 80.0:
        raise AssertionError(f"cornell mean brightness {bright:.2f} is far "
                             "from the reference's 64/255")
    reset_counts()
    img_q, wall_q, _ = full_width("next-week-final", 400, 400, 100,
                                  mode="queue", sort=False)
    n_queue = read_counts("queue", NW_QUEUE, ROUTE_ABSENT)
    reset_counts()
    img_s, wall_s, _ = full_width("next-week-final", 400, 400, 100,
                                  mode="queue", sort=True)
    n_sorted = read_counts("sorted queue", ("sweep_compact", "list_pass",
                                            "pool_step", "media") + QUEUE)
    log(f"  queue walls: unsorted {wall_q:.3f} s, sorted {wall_s:.3f} s; "
        f"images bit-equal {np.array_equal(img_q, img_s)}")
    if not np.array_equal(img_q, img_s):
        raise AssertionError("sorted and unsorted queue renders differ")
    route_out, n_route = route_full(img_q, wall_q)
    replay_out = replay_full()
    reset_counts()
    _, _, bright_w = full_width("cornell", 500, 500, 64, mode="wave")
    n_wave = read_counts("wave", ("sweep", "hit_scatter"))
    if not 48.0 <= bright_w <= 80.0:
        raise AssertionError(f"cornell wave-mode mean brightness "
                             f"{bright_w:.2f} is far from 64/255")
    nw = SCENES["next-week-final"]
    check_card_vs_cpu("next-week-final 48x48 queue",
                      nw.build(seed=SEED, earth=None), nw.camera(48, 48), 48,
                      48, spp=8, max_depth=8, seed=SEED, mode="queue")
    walls = {}
    n_mega = {k: 0 for k in COUNTERS}
    for name, w, h, spp in MEGA_FULL:
        reset_counts()
        img_m, wall_m, _ = full_width(name, w, h, spp, engine="mega")
        got = read_counts(f"megakernel {name}", ("megakernel",),
                          ("sweep", "pool_step", "sweep_compact"))
        n_waves = plan_pool(SCENES[name].build(seed=SEED, earth=None), w, h,
                            spp)[2]
        if got["megakernel"] != n_waves:
            raise AssertionError(f"{name}: {got['megakernel']} megakernel "
                                 f"launches for {n_waves} waves")
        n_mega = {k: n_mega[k] + got[k] for k in COUNTERS}
        img_p, wall_p, _ = full_width(name, w, h, spp)
        cross_engine(img_p, img_m, f"{name} megakernel vs wavefront pool")
        walls[name] = dict(mega_s=wall_m, pool_s=wall_p)
        log(f"  {name}: megakernel {wall_m:.3f} s, wavefront pool "
            f"{wall_p:.3f} s")
    img_u, _, _ = full_width("next-week-final", 400, 400, 16, mode="queue",
                             sort=False)
    reset_counts()
    img_k, wall_k, _ = with_env(
        {"TPU_RAY_CULL_STYLE": "mask"},
        lambda: full_width("next-week-final", 400, 400, 16, mode="queue",
                           sort=True))
    n_masked = read_counts("masked queue", ("sweep_masked", "list_pass",
                                            "pool_step", "media") + QUEUE,
                           ("sweep", "sweep_compact"))
    log(f"  masked queue wall {wall_k:.3f} s; image bit-equal to unsorted "
        f"{np.array_equal(img_u, img_k)}")
    if not np.array_equal(img_u, img_k):
        raise AssertionError("masked and unsorted queue renders differ")
    img_b, _, _ = full_width("book1-final", 600, 400, 16)
    reset_counts()
    img_x, wall_x, _ = with_env(
        {"TPU_RAY_SWEEP_MXU": "1"},
        lambda: full_width("book1-final", 600, 400, 16))
    n_mxu = read_counts("mxu pool", ("sweep_sphere_mxu", "pool_step"))
    same_estimator(img_b, img_x, "book1-final matrix-product sweep vs dense")
    mean_b, mean_x = float(img_b.mean()), float(img_x.mean())
    log(f"  book1-final image mean: dense {mean_b:.6f}, matrix-product "
        f"{mean_x:.6f}, difference {abs(mean_b - mean_x):.2e}")
    if abs(mean_b - mean_x) > 1e-4:
        raise AssertionError("the matrix-product render's mean moved")
    log(f"  matrix-product pool wall {wall_x:.3f} s")
    reset_counts()
    img_e, wall_e, _ = full_width("book1-final", 600, 400, 16, engine="mxu")
    n_mxu_engine = read_counts("engine=mxu pool", ("sweep_sphere_mxu",
                                                   "pool_step"))
    close = float(np.isclose(img_b, img_e, rtol=2e-3, atol=2e-3).mean())
    mean_rel = abs(float(img_e.mean()) - mean_b) / mean_b
    # the JAX package's mxu render criteria (tests/test_intersect.py:339-
    # 350: more than 95% of pixels close at 2e-3, the mean within 2%) at
    # that test's configuration; at full width and depth 50 the share of
    # close pixels is printed, and the image must be the one the
    # matrix-product sweep gave above under its environment switch
    b = SCENES["book1-final"]
    small = {e: render(b.build(seed=SEED, earth=None), b.camera(32, 24), 32,
                       24, 8, max_depth=8, seed=5, engine=e)
             for e in ("xla", "mxu")}
    close_s = float(np.isclose(small["xla"], small["mxu"], rtol=2e-3,
                               atol=2e-3).mean())
    mean_rel_s = abs(float(small["mxu"].mean() / small["xla"].mean()) - 1)
    # the size tools/torch_mxu_engine_share.py reads on the CPU
    mid = {e: render(b.build(seed=SEED, earth=None), b.camera(150, 100),
                     150, 100, 16, max_depth=50, seed=SEED, engine=e)
           for e in ("xla", "mxu")}
    mxu_engine = dict(wall_s=wall_e, close_share=close, mean_rel=mean_rel,
                      bit_equal_env_switch=bool(np.array_equal(img_e,
                                                               img_x)),
                      jax_test_config_close_share=close_s,
                      jax_test_config_mean_rel=mean_rel_s,
                      close_share_150x100=float(np.isclose(
                          mid["xla"], mid["mxu"], rtol=2e-3,
                          atol=2e-3).mean()))
    log(f"  book1-final engine=mxu vs dense: {close:.4%} of pixels close "
        f"(rtol/atol 2e-3), mean rel diff {mean_rel:.3e}; bit-equal to the "
        f"TPU_RAY_SWEEP_MXU=1 render {mxu_engine['bit_equal_env_switch']}; "
        f"at 32x24 8 spp depth 8 seed 5 {close_s:.4%} close, mean rel diff "
        f"{mean_rel_s:.3e}; at 150x100 16 spp depth 50 "
        f"{mxu_engine['close_share_150x100']:.4%} close")
    if not mxu_engine["bit_equal_env_switch"] or mean_rel > 0.02 \
            or close_s <= 0.95 or mean_rel_s > 0.02:
        raise AssertionError("engine=mxu fails the JAX package's mxu "
                             "criteria against the dense sweep")
    reset_counts()
    img_sp, _, _ = full_width("cornell", 500, 500, 64, sampler="sobol")
    n_sobol_pool = read_counts("sobol pool", ("sweep", "pool_step"))
    reset_counts()
    img_sm, _, _ = full_width("cornell", 500, 500, 64, sampler="sobol",
                              engine="mega")
    n_sobol_mega = read_counts("sobol megakernel", ("megakernel",),
                               ("sweep", "pool_step"))
    cross_engine(img_sp, img_sm, "cornell sobol megakernel vs wavefront pool")
    # another sample set: every pixel's noise differs, the mean must not
    same_estimator(img_c, img_sp, "cornell sobol vs uniform", share_cap=1.0)
    reset_counts()
    full_width("next-week-final", 400, 400, 16, sampler="sobol",
               mode="queue", sort=False)
    n_sobol_queue = read_counts("sobol queue", NW_QUEUE, ROUTE_ABSENT)
    reset_counts()
    for name, w, h, spp in STRICT_FULL:
        full_width(name, w, h, spp, strict=True)
    n_strict = read_counts("strict pool", ("sweep", "pool_step", "media"))
    reset_counts()
    full_width("cornell-smoke", 500, 500, 64, strict=True, mode="wave")
    n_strict_wave = read_counts("strict wave", ("sweep", "hit_scatter",
                                                "media"))
    reset_counts()
    full_width("cornell-smoke", 250, 250, 16, strict=True, engine="mega")
    n_strict_mega = read_counts("strict with engine=mega (falls back)",
                                ("sweep", "pool_step", "media"),
                                ("megakernel",))
    check_card_vs_cpu("cornell 48x48 sobol queue",
                      *scene_and_camera("cornell", 48, 48, sampler="sobol"),
                      48, 48, spp=8, max_depth=8, seed=SEED, mode="queue")
    check_card_vs_cpu("cornell-smoke 48x32 strict pool",
                      *scene_and_camera("cornell-smoke", 48, 32,
                                        strict=True),
                      48, 32, spp=8, max_depth=8, seed=SEED)
    img_b0, b0 = sobol_b0_full()
    reset_counts()
    full_width("checker-tex", 500, 500, 64)
    n_tex = read_counts("textured-checker pool", ("sweep", "pool_step"))
    aov_out, n_aov = aov_full(img_c)
    rounds = RoundLog()
    reset_counts()
    img_ap, n_ap, ad_pool = adaptive_full("cornell", 500, 500, 1000, 0.03,
                                          img_c, rounds, mode="pool")
    n_adaptive_pool = read_counts("adaptive pool", ("sweep", "pool_step"),
                                  ("megakernel",))
    uniform_wall("cornell", 500, 500, 1000, ad_pool)
    reset_counts()
    img_am, n_am, ad_mega = adaptive_full("cornell", 500, 500, 1000, 0.03,
                                          img_c, rounds, mode="pool",
                                          engine="mega")
    n_adaptive_mega = read_counts("adaptive megakernel", ("megakernel",),
                                  ("sweep", "pool_step"))
    uniform_wall("cornell", 500, 500, 1000, ad_mega, engine="mega")
    cross_engine(img_ap, img_am, "adaptive cornell megakernel vs wavefront "
                                 "pool")
    n_diff = float((n_ap != n_am).mean())
    log(f"  adaptive cornell: count maps of the megakernel and the "
        f"wavefront pool differ on {n_diff:.4%} of pixels")
    if n_diff > 0.02:
        raise AssertionError("adaptive megakernel and wavefront count maps "
                             "differ on more than 2% of pixels")
    reset_counts()
    img_aq, n_aq, ad_queue = adaptive_full("next-week-final", 400, 400, 1000,
                                           0.03, img_q, rounds)
    n_adaptive_queue = read_counts("adaptive queue", NW_QUEUE,
                                   ROUTE_ABSENT)
    uniform_wall("next-week-final", 400, 400, 1000, ad_queue, mode="queue")
    nw_scene, nw_cam = scene_and_camera("next-week-final", 100, 100)
    twice = [adaptive.render_adaptive(nw_scene, nw_cam, 100, 100,
                                      spp_max=256, tol=0.03, max_depth=50,
                                      seed=SEED, return_spp=True)
             for _ in range(2)]
    same = all(np.array_equal(a, b) for a, b in zip(*twice))
    log(f"  adaptive next-week-final 100x100 budget 256, two runs on the "
        f"card: images and count maps bit-equal {same}; spp "
        f"{int(twice[0][1].min())}-{int(twice[0][1].max())}")
    if not same:
        raise AssertionError("two adaptive queue renders differ")
    c_scene, c_cam = scene_and_camera("cornell", 48, 48)
    kw_cpu = dict(spp_max=64, tol=0.05, max_depth=8, seed=SEED, mode="pool",
                  return_spp=True)
    a_cpu, n_cpu = adaptive.render_adaptive(c_scene.to("cpu"), c_cam, 48, 48,
                                            device="cpu", **kw_cpu)
    a_card, n_card = adaptive.render_adaptive(c_scene, c_cam, 48, 48,
                                              **kw_cpu)
    log(f"  adaptive cornell 48x48 pool card vs cpu: count maps equal "
        f"{np.array_equal(n_cpu, n_card)} (spp {int(n_cpu.min())}-"
        f"{int(n_cpu.max())})")
    if not np.array_equal(n_cpu, n_card):
        raise AssertionError("adaptive card and CPU count maps differ")
    cross_engine(a_cpu, a_card, "adaptive cornell 48x48 pool card vs cpu")
    log("adaptive: " + json.dumps(dict(pool=ad_pool, mega=ad_mega,
                                       queue=ad_queue,
                                       mega_vs_pool_count_diff=n_diff)))
    import tempfile

    bvh_out, n_bvh = bvh_full()
    bands_out, n_bands = bands_full()
    band_walls = (("bands (a) pool", bands_out["a"]["pool_s"]),
                  ("bands (c)", bands_out["c"]["wall_s"]),
                  ("bands (d) bvh", bands_out["d"]["wall_s"]))
    log("  walls (s) against those before the media and queue kernels: "
        + ", ".join(f"{k} {v:.3f} (before: "
                    f"{', '.join(f'{w:.3f}' for w in WALLS_BEFORE[k])})"
                    for k, v in band_walls))
    with tempfile.TemporaryDirectory() as d:
        ck_out, n_ck = checkpoint_full(d)
        cli_out, n_cli = cli_full(d)
        serve_out, n_serve = serve_full(d)
        mesh_out, n_mesh = mesh_full(d)
    twins_out, n_twins = twins_full(img_q, img_s, img_aq, n_aq, img_b0)
    paths = {"pool": n_pool, "queue": n_queue, "sorted_queue": n_sorted,
             "wave": n_wave, "mega_pool": n_mega, "masked_queue": n_masked,
             "mxu_pool": n_mxu, "sobol_pool": n_sobol_pool,
             "sobol_mega_pool": n_sobol_mega, "sobol_queue": n_sobol_queue,
             "strict_pool": n_strict, "strict_wave": n_strict_wave,
             "strict_mega_fallback": n_strict_mega,
             "adaptive_pool": n_adaptive_pool,
             "adaptive_mega": n_adaptive_mega,
             "adaptive_queue": n_adaptive_queue,
             "sobol_b0_queue": b0.pop("counts"),
             "checker_tex_pool": n_tex, "mxu_engine_pool": n_mxu_engine,
             **n_aov, **n_bvh, **n_bands, **n_ck, **n_cli, **n_serve,
             **n_mesh, **n_twins, **n_route}
    launches = {k: sum(p[k] for p in paths.values()) for k in COUNTERS}
    by_path = {k: {p: c[k] for p, c in paths.items() if c[k]}
               for k in COUNTERS}

    list_keys = ("lists_ms", "lists_plain_ms", "lists_bound_ms",
                 "lists_bound_by")
    kernels = [
        dict(name="list_pass", route="cuda",
             source="tpu_ray_torch/csrc/sweep_compact.cu",
             replaces="tpu_ray/ops/intersect_pallas.py:462 (_tile_lists) "
                      "and :401 (_needed_mask), the block lists and mask "
                      "of the :505 and cull=True kernels",
             launches=launches["list_pass"],
             launches_by_path=by_path["list_pass"], library_ms=None,
             ms=sc_nw["lists_ms"], plain_ms=sc_nw["lists_plain_ms"],
             bound_ms=sc_nw["lists_bound_ms"],
             bound_by=sc_nw["lists_bound_by"], max_abs_err=0.0),
        dict(name="sweep", route="cuda", source="tpu_ray_torch/csrc/sweep.cu",
             replaces="tpu_ray/ops/intersect_pallas.py:59 (_sphere_kernel), "
                      ":309 (_box_kernel), :256 (_quad_kernel)",
             launches=launches["sweep"], launches_by_path=by_path["sweep"],
             library_ms=None, **sw),
        dict(name="pool_step", route="cuda",
             source="tpu_ray_torch/csrc/pool_step.cu",
             replaces="tpu_ray/ops/shade_pallas.py:401 (_step_kernel)",
             launches=launches["pool_step"],
             launches_by_path=by_path["pool_step"], library_ms=None,
             variants={"sobol cornell": st_sobol,
                       "strict two-perlin-spheres": st_strict_perlin,
                       "strict perlin-sky": st_strict_sky,
                       "strict cornell-smoke": st_strict_media,
                       "sobol-b0 queue cornell": st_b0,
                       "sobol-b0 queue next-week-final": st_b0_nw,
                       "textured checker": st_tex,
                       "strict textured checker": st_tex_strict,
                       "emissive image": st_emissive}, **st),
        dict(name="hit_scatter", route="cuda",
             source="tpu_ray_torch/csrc/pool_step.cu",
             replaces="tpu_ray/ops/shade_pallas.py:370 (_shade_kernel)",
             launches=launches["hit_scatter"],
             launches_by_path=by_path["hit_scatter"], library_ms=None,
             variants={"strict perlin-sky": hsc_strict,
                       "strict cornell-smoke": hsc_strict_media,
                       "textured checker": hsc_tex}, **hsc),
        dict(name="sweep_compact", route="cuda",
             source="tpu_ray_torch/csrc/sweep_compact.cu",
             replaces="tpu_ray/ops/intersect_pallas.py:505 (_compact_kernel)",
             launches=launches["sweep_compact"],
             launches_by_path=by_path["sweep_compact"], library_ms=None,
             **{k: v for k, v in sc_nw.items() if k not in list_keys}),
        dict(name="megakernel", route="cuda",
             source="tpu_ray_torch/csrc/megakernel.cu",
             replaces="tpu_ray/ops/megakernel.py:316 (_kernel)",
             launches=launches["megakernel"],
             launches_by_path=by_path["megakernel"], library_ms=None,
             variants={"sobol cornell": mg_sobol}, **mg),
        dict(name="sweep_masked", route="cuda",
             source="tpu_ray_torch/csrc/sweep_compact.cu",
             replaces="tpu_ray/ops/intersect_pallas.py:59, :309, :256 "
                      "(cull=True with _needed_mask :401)",
             launches=launches["sweep_masked"],
             launches_by_path=by_path["sweep_masked"], library_ms=None,
             **sm_nw),
        dict(name="sweep_sphere_mxu", route="cuda",
             source="tpu_ray_torch/csrc/sweep_mxu.cu",
             replaces="tpu_ray/ops/intersect_pallas.py:125 "
                      "(_sphere_mxu_kernel)",
             launches=launches["sweep_sphere_mxu"],
             launches_by_path=by_path["sweep_sphere_mxu"], library_ms=None,
             **mx_book1),
        dict(name="bvh", route="cuda", source="tpu_ray_torch/csrc/bvh.cu",
             replaces="tpu_ray/ops/bvh.py:270 (intersect_scene_bvh, an XLA "
                      "lax.while_loop: no TPU kernel; port-only)",
             launches=launches["bvh"], launches_by_path=by_path["bvh"],
             library_ms=None,
             variants={k: v for k, v in bv.items()
                       if k != "next-week-final bounce 1"},
             **bv["next-week-final bounce 1"]),
        dict(name="aov", route="cuda", source="tpu_ray_torch/csrc/aov.cu",
             replaces="tpu_ray/aov.py:60 (_aov_step's hit record and "
                      "texture_value, XLA: no TPU kernel; port-only)",
             launches=launches["aov"], launches_by_path=by_path["aov"],
             library_ms=None, variants={"textured checker": av_tex}, **av),
        dict(name="media", route="cuda", source="tpu_ray_torch/csrc/media.cu",
             replaces="tpu_ray/ops/intersect.py:172-230 (the media branch of "
                      "_chunk_t; XLA: no TPU kernel; port-only)",
             launches=launches["media"], launches_by_path=by_path["media"],
             library_ms=None,
             variants={"next-week-final bounce 1":
                       md["next-week-final bounce 1"]},
             **md["cornell-smoke bounce 1"]),
        dict(name="queue_inject", route="cuda",
             source="tpu_ray_torch/csrc/queue.cu",
             replaces="tpu_ray/integrator.py:686, :764-849 (_queue_body's "
                      "path ids, flush and inject; XLA: no TPU kernel; "
                      "port-only)",
             launches=launches["queue_inject"],
             launches_by_path=by_path["queue_inject"],
             path_ids_launches=launches["path_ids"], library_ms=None,
             variants={k: v for k, v in qi.items() if k != "uniform"},
             **qi["uniform"]),
    ]
    log(f"media and queue kernels against their twins' renders: "
        f"{json.dumps(twins_out)}")
    log(f"sobol-b0 queue: {json.dumps(b0)}")
    log(f"aov and denoise: {json.dumps(aov_out)}")
    log(f"bvh renders: {json.dumps(bvh_out)}")
    log(f"route (rule INDEX vs the dense sweep): {json.dumps(route_out)}")
    log(f"queue replay: {json.dumps(replay_out)}")
    log(f"bands: {json.dumps(bands_out)}")
    log(f"checkpoint resumes bit-equal: {json.dumps(ck_out)}")
    log(f"cli: {json.dumps(cli_out)}")
    log(f"serve: {json.dumps(serve_out)}")
    log(f"mesh renders (cuda:0 entries): {json.dumps(mesh_out)}")
    log(f"engine=mxu: {json.dumps(mxu_engine)}")
    log(f"megakernel, one wave, 2 samples/slot depth 8: cornell-smoke "
        f"{json.dumps(mg_smoke)}; two-perlin-spheres "
        f"{json.dumps(mg_perlin)}; book1-final {json.dumps(mg_book1)}")
    log(f"megakernel, full-depth waves alone: {json.dumps(mg_full)}")
    log(f"megakernel vs wavefront pool render walls: {json.dumps(walls)}")
    log(f"next-week-final sweep (1 bounce): {json.dumps(sw_nw)}")
    log(f"next-week-final pool step (2 bounces): {json.dumps(st_nw)}")
    log(f"next-week-final pool step, queue state (6 iterations): "
        f"{json.dumps(st_queue)}")
    log(f"two-perlin-spheres hit_scatter: {json.dumps(hsc_perlin)}")
    log(f"book1-final sweep_compact: {json.dumps(sc_book1)}")
    log(f"box-grid sweep_compact: {json.dumps(sc_box)}")
    log(f"book1-final sweep (1 bounce): {json.dumps(sw_book1)}")
    log(f"box-grid sweep (1 bounce): {json.dumps(sw_box)}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
