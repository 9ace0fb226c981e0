"""Rendering: the schedules of the three modes, waves, chunks and the film.

Port of ``tpu_ray/renderer.py``: ``resolve_engine``, ``resolve_mode``,
``plan_pool`` / ``plan_queue``, ``_pixel_grid``, ``_slot_ids``,
``_film_add``, ``make_wave_fn``, ``_render_queue`` and ``render``, which
hands ``adaptive=TOL`` to :func:`tpu_ray_torch.adaptive.render_adaptive`.

* ``mode="pool"`` (``"auto"`` up to 512 prims): the ray pool.
  ``plan_pool`` and its constants are kept identical to the JAX package's
  even though they were tuned on a TPU: ``k_pool`` decides the global slot
  ids and those key every random stream, so any other plan would change
  the image's noise and the port could no longer be held to the JAX
  renders and goldens.  With ``engine="mega"`` each wave of the pool is one
  launch of the whole-wave megakernel instead of the host's loop over the
  sweep and the pool step; plan, slot ids and keys are the same, so both
  engines trace the same paths.
* ``mode="queue"`` (``"auto"`` above 512 prims): the work queue.  Its
  lane count, epoch length and drain ladder key no stream, so
  ``plan_queue`` chooses them for the card.
* ``mode="wave"``: the plain wavefront, one path per lane per wave, kept
  as the estimator's semantic reference.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a CUDA device they raise.  Inputs outside this port's scope raise
``NotImplementedError``; nothing falls back to another path but
``engine="mega"`` on a scene the megakernel does not cover, which renders
on the wavefront pool and says so, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .adaptive import render_adaptive
from .core import rng
from .core.camera import Camera
from .integrator import (COMPACT_FLOOR, COMPACT_MIN, SceneKernels, trace,
                         trace_pool_mega, trace_pool_staged, trace_queue)
from .models.scene_data import SceneData
from .ops.intersect import pack_rays
from .ops.megakernel import supported as mega_supported
from .ops.shade import StepConfig

QUEUE_MIN_PRIMS = 512    # mode="auto" picks the work queue above this
# the queue's per-(sample, pixel) film plane is 12 bytes a row; chunks of
# samples are sized so it stays under this share of the card's 80 GB
QUEUE_PLANE_BYTES = 8_000_000_000
# iterations per epoch = per host read of (frontier, active count).  A read
# costs one small device-to-host copy, so short epochs are cheap, and every
# iteration past an exit condition is a full-pool iteration wasted
QUEUE_EPOCH_ITERS = 8


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return dev


def _largest_divisor_leq(n: int, cap: int) -> int:
    k = max(1, min(cap, n))
    while n % k:
        k -= 1
    return k


def pick_samples_per_wave(width: int, height: int, spp: int,
                          rays_per_wave: int) -> int:
    """Largest divisor of spp with width*height*k <= rays_per_wave."""
    return _largest_divisor_leq(
        spp, max(1, rays_per_wave // max(width * height, 1)))


ENGINES = ("auto", "xla", "mxu", "pallas", "mega")


def resolve_engine(scene: SceneData, engine: str = "auto") -> str:
    """The JAX package's engine names on this port.  ``"auto"``, ``"xla"``
    and ``"pallas"`` all mean the wavefront path through the one
    hand-written sweep: the port has no second sweep engine, so ``"auto"``
    resolves to ``"xla"`` and the other two come back as given.  ``"mega"``
    is the whole-wave megakernel on scenes it supports; on any other scene
    it falls back to ``"xla"``, as the JAX package does, and says so on
    stderr.  ``"mxu"`` (the JAX package's chunk-centred XLA sweep, not a
    kernel) is not ported and raises ``NotImplementedError``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "mxu":
        raise NotImplementedError("the chunk-centred 'mxu' sweep engine is "
                                  "not ported yet")
    if engine == "mega":
        if mega_supported(scene):
            return "mega"
        print("tpu_ray_torch: engine=mega does not cover this scene (image "
              "textures, checkers with textured children, strict mode or "
              "more than 512 prims); rendering on the wavefront path",
              file=sys.stderr)
        return "xla"
    return "xla" if engine == "auto" else engine


def resolve_mode(scene: SceneData, mode: str = "auto",
                 engine: str = "auto") -> str:
    """``"auto"`` -> the work queue for scenes of more than 512 prims, the
    pool otherwise.  A pool request for a bigger scene is demoted to the
    queue and announced on stderr: the pool's plan above 512 prims is a
    set of lane caps of one TPU worker that key the noise, which this port
    does not carry.  A queue request with the megakernel engine (on a scene
    it supports) is demoted to the pool, where the megakernel runs, and
    announced too.  ``mode="wave"`` keeps the plain wavefront whatever the
    engine, as in the JAX package."""
    if mode not in ("auto", "pool", "queue", "wave"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "auto":
        mode = "queue" if scene.n_prims > QUEUE_MIN_PRIMS else "pool"
    elif mode == "pool" and scene.n_prims > QUEUE_MIN_PRIMS:
        print(f"tpu_ray_torch: demoting mode=pool to the work queue: "
              f"{scene.n_prims} prims (pool mode renders up to "
              f"{QUEUE_MIN_PRIMS})", file=sys.stderr)
        return "queue"
    if mode == "queue" and resolve_engine(scene, engine) == "mega":
        print("tpu_ray_torch: demoting mode=queue to the wave pool: the "
              "megakernel runs on the pool integrator", file=sys.stderr)
        return "pool"
    return mode


def plan_pool(scene: SceneData, width: int, height: int, spp: int,
              rays_per_wave: int = 1 << 20, samples_per_wave: int = 64):
    """Pool-mode schedule (k_pool slots/pixel, samples per slot per wave,
    wave count): the JAX package's plan for scenes of <= 512 prims."""
    if scene.n_prims > QUEUE_MIN_PRIMS:
        raise ValueError("plan_pool plans scenes of at most 512 prims; "
                         "bigger scenes render in queue mode (plan_queue)")
    k_pool = pick_samples_per_wave(width, height, spp, rays_per_wave)
    s_total = spp // k_pool
    lanes = width * height * k_pool
    s_budget = max(1, int(2e13 / (lanes * max(scene.n_prims, 1) * 8)))
    s_wave = _largest_divisor_leq(s_total, min(samples_per_wave, s_budget))
    return k_pool, s_wave, s_total // s_wave


def plan_queue(scene: SceneData, width: int, height: int, spp: int,
               rays_per_wave: int = 1 << 20):
    """Queue-mode schedule: (R lanes, chunk_spp, epoch_iters, drain_levels).

    None of the four keys a random stream (the image is bit-identical for
    any of them), so they are chosen for the card and not carried over
    from the TPU's plan: ``R`` is ``rays_per_wave`` (1M lanes fill the
    card's 132 SMs many times over and keep the per-iteration host cost
    per lane low) with no lane cap by prim count; ``chunk_spp`` keeps the
    film plane under ``QUEUE_PLANE_BYTES``; epochs are
    ``QUEUE_EPOCH_ITERS`` iterations; the drain ladder is the JAX
    package's shape (R/2, then quarter steps down to 4096 lanes)."""
    P = width * height
    R = max(1024, min(rays_per_wave, P * spp))
    chunk_spp = _largest_divisor_leq(
        spp, max(1, QUEUE_PLANE_BYTES // (P * 12)))
    levels = []
    m = R
    if R >= COMPACT_MIN and m // 2 >= COMPACT_FLOOR:
        m //= 2
        levels.append(m)
        while m // 4 >= COMPACT_FLOOR:
            m //= 4
            levels.append(m)
    return R, chunk_spp, QUEUE_EPOCH_ITERS, tuple(levels)


def pixel_grid(width: int, height: int, k: int, device="cpu"):
    """(2, k*H*W) pixel-fraction bases: x = col / W, y = (H-1-row) / H
    (image row 0 is the top of the frame)."""
    ys = torch.arange(height - 1, -1, -1, dtype=torch.float32,
                      device=device)[None, :, None].expand(k, height, width)
    xs = torch.arange(width, dtype=torch.float32,
                      device=device)[None, None, :].expand(k, height, width)
    return torch.stack([xs.reshape(-1) / width, ys.reshape(-1) / height])


def slot_ids(width: int, height: int, k: int, device="cpu") -> torch.Tensor:
    """Global slot ids k*(H*W) + row*W + col as int32 uint32 bits."""
    ids = (torch.arange(k, dtype=torch.int64)[:, None, None] * (width * height)
           + torch.arange(height, dtype=torch.int64)[None, :, None] * width
           + torch.arange(width, dtype=torch.int64)[None, None, :]
           ).reshape(-1) & rng.M32
    ids = torch.where(ids >= 1 << 31, ids - (1 << 32), ids)
    return ids.to(torch.int32).to(device)


def film_add(accum: torch.Tensor, rad: torch.Tensor, k_pool: int,
             height: int, width: int) -> torch.Tensor:
    """Accumulate a wave's (3, R) per-slot radiance into the (H, W, 3) film."""
    return accum + rad.T.reshape(k_pool, height, width, 3).sum(dim=0)


def _render_queue(scene, camera, width, height, spp, max_depth, seed,
                  rays_per_wave, rr_depth, progress, sort):
    """Work-queue render: sample chunks sized by the film-plane budget, one
    key for every chunk (draws are keyed by global work item and bounce)."""
    P = width * height
    R, chunk_spp, epoch_iters, drain = plan_queue(scene, width, height, spp,
                                                  rays_per_wave)
    kern = SceneKernels.create(scene, sort)
    k_queue = rng.fold_in(rng.prng_key(seed), 0x5EED)
    film = torch.zeros((P, 3), dtype=torch.float32, device=scene.device)

    for c in range(spp // chunk_spp):
        def cb(frontier, total, done=c * P * chunk_spp):
            pct = 100.0 * (done + frontier) / (P * spp)
            print(f"\rRendering {pct:5.1f}%", end="", file=sys.stderr)

        film = film + trace_queue(
            scene, camera, width, height, chunk_spp, c * chunk_spp, k_queue,
            max_depth, R, cam_salt=seed, epoch_iters=epoch_iters,
            drain_levels=drain, progress_cb=cb if progress else None,
            rr_depth=rr_depth, kern=kern)
    if progress:
        print("", file=sys.stderr)
    return film.reshape(height, width, 3).cpu().numpy() / spp


def _render_wave(scene, camera, width, height, spp, max_depth, seed,
                 rays_per_wave, rr_depth, progress, sort):
    """Plain-wavefront render (``make_wave_fn``): per wave ``k`` samples per
    pixel, camera samples drawn by lane position from ``jax.random``-equal
    streams of ``split(fold_in(PRNGKey(seed), wave), 3)``, so it takes the
    uniform sampler only."""
    if camera.sampler != "uniform":
        raise ValueError(
            "mode='wave' draws camera samples by lane position, not by "
            "(pixel, sample index), so low-discrepancy samplers do not "
            "apply; use the pool or queue mode with --sampler "
            f"{camera.sampler!r}")
    dev = scene.device
    k = pick_samples_per_wave(width, height, spp, rays_per_wave)
    n_waves = spp // k
    xy = pixel_grid(width, height, k, dev)
    kern = SceneKernels.create(scene, sort)
    cfg = StepConfig.create(scene, camera, width, height, max_depth,
                            rr_depth=rr_depth)
    cam = camera.to(dev)
    base_key = rng.prng_key(seed)
    accum = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    for w in range(n_waves):
        if progress:
            print(f"\rRendering wave {w + 1} of {n_waves}", end="",
                  file=sys.stderr)
        k_jit, k_cam, k_path = rng.split(rng.fold_in(base_key, w), 3)
        R = xy.shape[1]
        jitter = rng.uniform(k_jit, (R, 2), dev)
        u = xy[0] + jitter[:, 0] / width
        v = xy[1] + jitter[:, 1] / height
        ro, rd, rt = cam.rays_from_uniforms(u, v, rng.uniform(k_cam, (R, 3),
                                                              dev))
        rad = trace(scene, cfg, pack_rays(ro, rd, rt), k_path, kern=kern)
        accum = film_add(accum, rad, k, height, width)
    if progress:
        print("", file=sys.stderr)
    return accum.cpu().numpy() / spp


def render(scene: SceneData, camera: Camera, width: int, height: int,
           spp: int, max_depth: int = 50, seed: int = 1024,
           rays_per_wave: int = 1 << 20, samples_per_wave: int = 64,
           rr_depth: int = 0, device=None, progress: bool = False,
           mode: str = "auto", bvh=False, mesh=None, adaptive: float = 0.0,
           checkpoint_path=None, on_partial=None,
           sort: bool | None = None, engine: str = "auto") -> np.ndarray:
    """Render to a linear (H, W, 3) float32 image (mean over spp samples).

    ``mode``: "auto" (the work queue above 512 prims, else the pool),
    "pool", "queue" or "wave".  ``engine``: "auto", "xla" or "pallas" for
    the wavefront kernels, "mega" for one megakernel launch per pool wave
    (:func:`resolve_engine`).  ``sort`` sends the closest-hit sweep
    through the sorted, compacted-list kernel (the same image bit for bit;
    ``None`` reads ``TPU_RAY_SORT``, off unless ``1``).  ``adaptive`` > 0
    renders with per-pixel adaptive sampling at that tone-mapped standard
    error (:func:`tpu_ray_torch.adaptive.render_adaptive`): ``spp`` becomes
    the per-pixel budget cap, and ``mode``, ``samples_per_wave`` and
    ``sort`` are not read.  The remaining arguments of the JAX ``render``
    (BVH traversal, device meshes, checkpoints, progressive output) are
    later slices of the port and raise ``NotImplementedError`` when asked
    for.  ``camera.sampler`` picks the camera sample ("uniform", "sobol",
    "sobol-b0"; the pool and queue modes) and ``scene.strict`` the strict
    reference estimator.
    """
    for name, on in (("bvh", bool(bvh)), ("mesh", mesh is not None),
                     ("checkpointing", checkpoint_path is not None),
                     ("progressive output", on_partial is not None)):
        if on:
            raise NotImplementedError(f"{name} is not ported yet (a later "
                                      "slice of the port)")
    if adaptive and adaptive > 0:
        return render_adaptive(
            scene, camera, width, height, spp_max=spp, tol=adaptive,
            max_depth=max_depth, seed=seed, rays_per_wave=rays_per_wave,
            engine=engine, rr_depth=rr_depth, progress=progress,
            device=device)
    engine = resolve_engine(scene, engine)
    mode = resolve_mode(scene, mode, engine)
    if camera.sampler == "sobol-b0" and mode != "queue":
        # the first-bounce override runs on the work queue only, as in the
        # JAX package; the pool and the megakernel keep the Sobol' camera
        # dims with hashed scatter draws, and say so
        print("tpu_ray_torch: sampler=sobol-b0's bounce-dim override only "
              f"runs on the XLA work-queue path; mode={mode} keeps the sobol "
              "camera dims with hashed scatter draws", file=sys.stderr)
    dev = resolve_device(device)
    scene = scene.to(dev)
    if mode == "queue":
        return _render_queue(scene, camera, width, height, spp, max_depth,
                             seed, rays_per_wave, rr_depth, progress, sort)
    if mode == "wave":
        return _render_wave(scene, camera, width, height, spp, max_depth,
                            seed, rays_per_wave, rr_depth, progress, sort)
    k_pool, s_wave, n_waves = plan_pool(scene, width, height, spp,
                                        rays_per_wave, samples_per_wave)
    xy = pixel_grid(width, height, k_pool, dev)
    sids = slot_ids(width, height, k_pool, dev)
    kern = SceneKernels.create(scene, sort)
    trace_wave = trace_pool_mega if engine == "mega" else trace_pool_staged
    base_key = rng.prng_key(seed)
    accum = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    cfg = StepConfig.create(scene, camera, width, height, max_depth,
                            rr_depth=rr_depth, n_samples=s_wave,
                            cam_salt=seed)
    t0 = time.perf_counter()
    for w in range(n_waves):
        if progress:
            print(f"\rRendering wave {w + 1} of {n_waves}", end="",
                  file=sys.stderr)
        cfg = dataclasses.replace(cfg, sample0=(w * s_wave) & rng.M32)
        rad, _ = trace_wave(scene, cfg, xy, sids, rng.fold_in(base_key, w),
                            kern)
        accum = film_add(accum, rad, k_pool, height, width)
    img = accum.cpu().numpy()
    if progress:
        print(f"\n{n_waves} waves in {time.perf_counter() - t0:.3f}s",
              file=sys.stderr)
    return img / spp
