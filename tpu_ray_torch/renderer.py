"""Rendering: the schedules of the three modes, waves, chunks and the film.

Port of ``tpu_ray/renderer.py``: ``resolve_engine``, ``resolve_mode``,
``plan_pool`` / ``plan_queue``, ``_pixel_grid``, ``_slot_ids``,
``make_wave_fn``, ``_render_queue`` and ``render``, which hands
``adaptive=TOL`` to :func:`tpu_ray_torch.adaptive.render_adaptive`, and
the rounds of its device meshes (``mesh=``, the JAX package's
``make_round_fn``).

* ``mode="pool"`` (``"auto"`` up to 512 prims): the ray pool.
  ``plan_pool`` and its constants, the lane caps and the per-wave sample
  budget above 512 prims included, are kept identical to the JAX
  package's even though they were tuned on a TPU: ``k_pool`` decides the
  global slot ids and those key every random stream, so any other plan
  would change the image's noise and the port could no longer be held to
  the JAX renders and goldens.  A frame whose rows exceed the lane cap
  renders in row bands (``_row0``, ``_rows``, ``_band_cap``, as in the
  JAX package): each band is a pool render of its rows with the frame's
  slot ids and pixel bases, so it draws what the whole frame would draw
  under the band's plan.  With ``engine="mega"`` each wave of the pool is one
  launch of the whole-wave megakernel instead of the host's loop over the
  sweep and the pool step; plan, slot ids and keys are the same, so both
  engines trace the same paths.
* ``mode="queue"`` (``"auto"`` above 512 prims): the work queue.  Its
  lane count, epoch length and drain ladder key no stream, so
  ``plan_queue`` chooses them for the card.
* ``mode="wave"``: the plain wavefront, one path per lane per wave, kept
  as the estimator's semantic reference.

Every mode checkpoints its film (``checkpoint_path``, and by default for
long renders) and reports partial estimates (``on_partial``) after each
wave or chunk, in the JAX package's order: save, then report.  The
accumulator stays on the render's device and comes to the host only for
those two.  A banded render reports, with each estimate, the rows of
the bands already finished as final.

Entry points run on the card unless the caller passes ``device="cpu"``
(or a mesh of ``cpu`` entries); without a CUDA device they raise.  Nothing
falls back to another path but ``engine="mega"`` on a scene the
megakernel does not cover, which renders on the wavefront pool and says
so, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import os
import sys
import threading

import numpy as np
import torch

from .adaptive import render_adaptive
from .core import rng
from .core.camera import Camera
from .integrator import (COMPACT_FLOOR, COMPACT_MIN, SceneKernels, trace,
                         trace_pool_mega, trace_pool_staged, trace_queue,
                         trace_queue_mesh)
from .models.scene_data import SceneData
from .ops.bvh import build_bvh
from .ops.intersect import pack_rays
from .ops.megakernel import supported as mega_supported
from .ops.shade import StepConfig
from .parallel import mesh as mesh_mod
from .utils.profiling import Phase, WaveTimer, span

QUEUE_MIN_PRIMS = 512    # mode="auto" picks the work queue above this
# the JAX package's pool lane caps for scenes of more than 512 prims
# (``tpu_ray/renderer.py:34-47``): 160000 lanes for the "xla" and "mxu"
# engines, lanes x prims within a budget for "pallas".  They were set for
# one TPU worker, but they decide ``k_pool`` and the row bands, so they key
# the noise and are kept as they are.  Read at call time (tests lower them)
XLA_BIG_SCENE_LANES = 160_000
PALLAS_LANE_PRIM_BUDGET = 550_000_000
# the queue's per-(sample, pixel) film plane is 12 bytes a row; chunks of
# samples are sized so it stays under this share of the card's 80 GB
QUEUE_PLANE_BYTES = 8_000_000_000
# iterations per epoch = per host read of (frontier, active count).  A read
# costs one small device-to-host copy, so short epochs are cheap, and every
# iteration past an exit condition is a full-pool iteration wasted
QUEUE_EPOCH_ITERS = 8
# renders of at least this many waves checkpoint by default, so a crash
# loses at most one checkpoint interval
AUTO_CHECKPOINT_WAVES = 8
# the estimator and random streams a checkpoint's film was made with: bump
# when they change (the JAX package's version 4, whose semantics the port
# keeps); CKPT_MARK starts every tag, so neither package resumes the other's
CKPT_MARK = "tpu_ray_torch"
SEMANTICS_VERSION = 4


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


def pallas_lane_cap(n_prims: int) -> int:
    return int(max(160_000,
                   min(1 << 20, PALLAS_LANE_PRIM_BUDGET // max(n_prims, 1))))


def lane_cap(n_prims: int, engine: str) -> int | None:
    """The JAX package's lane cap of a scene of ``n_prims`` for the
    resolved ``engine``: None up to 512 prims, else
    ``XLA_BIG_SCENE_LANES`` ("xla", "mxu") or ``pallas_lane_cap``
    ("pallas")."""
    if n_prims <= 512:
        return None
    if engine in ("xla", "mxu"):
        return XLA_BIG_SCENE_LANES
    if engine == "pallas":
        return pallas_lane_cap(n_prims)
    return None


ENGINES = ("auto", "xla", "mxu", "pallas", "mega")


def resolve_engine(scene: SceneData, engine: str = "auto") -> str:
    """The JAX package's engine names on this port.  ``"auto"``, ``"xla"``
    and ``"pallas"`` all mean the wavefront path through the dense
    hand-written sweep, so ``"auto"`` resolves to ``"xla"`` and the other
    two come back as given.  ``"mxu"`` sends the static spheres through the
    matrix-product sweep (:meth:`~tpu_ray_torch.integrator.SceneKernels.
    create`; the JAX package's chunk-centred expanded quadratic, here
    centred on the range).  ``"mega"`` is the whole-wave megakernel on
    scenes it supports; on any other scene it falls back to ``"xla"``, as
    the JAX package does, and says so on stderr."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
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
                 engine: str = "auto", bvh: bool = False, mesh=None,
                 spp: int | None = None, _rows: int | None = None) -> str:
    """The JAX package's ``resolve_mode``, decision for decision:
    ``"auto"`` -> the work queue for scenes of more than 512 prims, the
    pool otherwise.  A queue request with ``bvh``, with the megakernel
    engine (on a scene it supports) or for a row band (``_rows``) goes to
    the pool; so does one on a ``mesh`` of D devices whose ``spp`` is
    unknown or below D.  The demotion is said on stderr when the queue was
    asked for or the scene has more than 512 prims.  ``"pool"`` and
    ``"wave"`` stay as asked."""
    if mode not in ("auto", "pool", "queue", "wave"):
        raise ValueError(f"unknown mode {mode!r}")
    big = scene.n_prims > QUEUE_MIN_PRIMS
    requested = mode
    if mode == "auto":
        mode = "queue" if big else "pool"
    demote = None
    if mode == "queue" and (bvh or resolve_engine(scene, engine) == "mega"
                            or _rows is not None):
        demote = "bvh / megakernel / band slices run on the pool integrator"
    elif mode == "queue" and mesh is not None and (spp is None
                                                   or spp < len(mesh)):
        demote = (f"sharding the work queue needs spp >= the "
                  f"{len(mesh)}-device mesh (got {spp})")
    if demote:
        if requested == "queue" or big:
            print(f"tpu_ray_torch: demoting mode=queue to the wave pool: "
                  f"{demote}", file=sys.stderr)
        mode = "pool"
    return mode


def plan_pool(scene: SceneData, width: int, height: int, spp: int,
              rays_per_wave: int = 1 << 20, samples_per_wave: int = 64,
              engine: str = "xla"):
    """Pool-mode schedule (k_pool slots/pixel, samples per slot per wave,
    wave count): the JAX package's plan.  Above 512 prims the lanes are
    capped (:func:`lane_cap` for the resolved ``engine``) and the samples
    per wave by its per-wave time budget, 2.5 s at 4.2e-9 s a (lane, prim,
    sample); a row band plans with its own rows as ``height``."""
    engine = resolve_engine(scene, engine)
    cap = lane_cap(scene.n_prims, engine)
    if cap is not None:
        rays_per_wave = min(rays_per_wave, cap)
    k_pool = pick_samples_per_wave(width, height, spp, rays_per_wave)
    s_total = spp // k_pool
    lanes = width * height * k_pool
    n = max(scene.n_prims, 1)
    if scene.n_prims > 512:
        s_budget = max(1, int(2.5 / (lanes * n * 4.2e-9)))
    else:
        s_budget = max(1, int(2e13 / (lanes * n * 8)))
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


def pixel_grid(width: int, height: int, k: int, device="cpu",
               row0: int = 0, rows: int | None = None):
    """(2, k*rows*W) pixel-fraction bases of image rows [row0, row0+rows)
    of the whole frame: x = col / W, y = (H-1-row) / H (image row 0 is the
    top of the frame)."""
    rows = height if rows is None else rows
    ys = torch.arange(height - 1 - row0, height - 1 - row0 - rows, -1,
                      dtype=torch.float32,
                      device=device)[None, :, None].expand(k, rows, width)
    xs = torch.arange(width, dtype=torch.float32,
                      device=device)[None, None, :].expand(k, rows, width)
    return torch.stack([xs.reshape(-1) / width, ys.reshape(-1) / height])


def slot_ids(width: int, height: int, k: int, device="cpu", row0: int = 0,
             rows: int | None = None) -> torch.Tensor:
    """Global slot ids k*(H*W) + row*W + col of image rows [row0,
    row0+rows), as int32 uint32 bits: a band's lanes key the draws they
    would key in the whole frame."""
    rows = height if rows is None else rows
    ids = (torch.arange(k, dtype=torch.int64)[:, None, None] * (width * height)
           + torch.arange(row0, row0 + rows,
                          dtype=torch.int64)[None, :, None] * width
           + torch.arange(width, dtype=torch.int64)[None, None, :]
           ).reshape(-1) & rng.M32
    ids = torch.where(ids >= 1 << 31, ids - (1 << 32), ids)
    return ids.to(torch.int32).to(device)


# --- checkpoints --------------------------------------------------------------

def checkpoint_dir() -> str:
    """Where auto checkpoints go: ``~/.cache/tpu_ray_torch/checkpoints``,
    resolved at call time (so ``HOME`` decides it)."""
    return os.path.join(os.path.expanduser("~"), ".cache", "tpu_ray_torch",
                        "checkpoints")


def _remove(path) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def clear_auto_checkpoints() -> None:
    """Delete the auto checkpoints, so that a timed render renders in full
    instead of resuming a crashed one."""
    for f in glob.glob(os.path.join(checkpoint_dir(), "auto-*.npz")):
        _remove(f)


def _scene_fingerprint(scene: SceneData, camera: Camera) -> str:
    """Short content hash of the scene's payloads, the camera's fields, its
    sampler and the background: editing a material must not resume."""
    h = hashlib.sha1()
    for a in (scene.prim_payload, scene.mat_payload):
        h.update(a.cpu().numpy().tobytes())
    for f in dataclasses.fields(camera):
        v = getattr(camera, f.name)
        if isinstance(v, torch.Tensor):
            h.update(v.cpu().numpy().astype(np.float32).tobytes())
    h.update(camera.sampler.encode())
    h.update(scene.background.cpu().numpy().astype(np.float32).tobytes())
    return h.hexdigest()[:12]


def _config_tag(scene, camera, width, height, spp, max_depth, seed,
                schedule: str) -> str:
    """The render a checkpoint belongs to: the port marker (a JAX package
    checkpoint never matches, nor the other way round), the semantics
    version, the scene and camera contents and every render parameter."""
    return (f"{CKPT_MARK}.v{SEMANTICS_VERSION}.s{int(scene.strict)}"
            f"|{_scene_fingerprint(scene, camera)}|{scene.n_prims}"
            f"|{width}x{height}|{spp}|{max_depth}|{seed}|{schedule}")


def _checkpoint_path(path, every: int, tag: str, n_units: int,
                     auto_min: int, auto_every: int):
    """(path, every, auto): the caller's path with the ``.npz`` suffix, or,
    when no path and no interval is given and the render has at least
    ``auto_min`` units, an auto checkpoint keyed by the tag's hash."""
    auto = path is None and every == 0 and n_units >= auto_min
    if auto:
        d = checkpoint_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"auto-{hashlib.sha1(tag.encode()).hexdigest()[:12]}.npz")
        every = auto_every
    if path and not path.endswith(".npz"):
        path += ".npz"
    return path, every, auto


def _load_checkpoint(path, tag: str, dev, progress: bool, unit: str):
    """(accumulator on ``dev`` or None, units done) from ``path``: None, 0
    when there is no file, another render's file (said on stderr) or one
    that does not read (said too)."""
    try:
        with np.load(path) as ck:
            if str(ck["config"]) == tag:
                done = int(ck["waves_done"])
                if progress:
                    print(f"\nresuming at {unit} {done}", file=sys.stderr)
                return torch.from_numpy(ck["accum"]).to(dev), done
        print(f"checkpoint {path} is for a different render config; "
              "starting fresh", file=sys.stderr)
    except FileNotFoundError:
        pass
    except Exception as e:
        print(f"ignoring unreadable checkpoint {path}: {e}", file=sys.stderr)
    return None, 0


def _save_checkpoint(path, accum: np.ndarray, done: int, tag: str) -> None:
    """Write under a temporary name, then rename: a reader (another
    process rendering the same configuration) never sees a torn file."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, accum=accum, waves_done=done, config=tag)
    os.replace(tmp, path)


# --- the render loops -----------------------------------------------------------

def _render_queue(scenes, kerns, camera, width, height, spp, max_depth, seed,
                  rays_per_wave, rr_depth, progress, engine,
                  checkpoint_path, checkpoint_every, on_partial, mesh,
                  phase):
    """Work-queue render: sample chunks sized by the film-plane budget, one
    key for every chunk (draws are keyed by global work item and bounce),
    a checkpoint and ``on_partial`` after each chunk but the last.

    ``scenes`` / ``kerns``: the scene and its tables by device.  With a
    ``mesh`` of D devices each chunk holds a multiple of D samples, shared
    out by :func:`~tpu_ray_torch.integrator.trace_queue_mesh` (the plane
    budget is a device's); ``spp % D`` samples are left for a last chunk on
    ``mesh[0]``, as in the JAX package (``tpu_ray/renderer.py:406-414``).
    ``phase``: the render's set-up span, handed to each chunk's queue."""
    devs = mesh if mesh is not None else tuple(scenes)
    scene = scenes[devs[0]]
    P = width * height
    with span("render.plan"):
        R, chunk_spp, epoch_iters, drain = plan_queue(scene, width, height,
                                                      spp, rays_per_wave)
        D = 0 if mesh is None else len(mesh)
        if mesh is None:
            chunks = [chunk_spp] * (spp // chunk_spp)
        else:
            chunk_spp = D * _largest_divisor_leq(
                spp // D, max(1, QUEUE_PLANE_BYTES // (P * 12)))
            chunks = [chunk_spp] * (spp // D * D // chunk_spp)
            if spp % D:
                chunks.append(spp % D)
        n_chunks = len(chunks)
        starts = np.cumsum([0] + chunks).tolist()
        k_queue = rng.fold_in(rng.prng_key(seed), 0x5EED)
    with span("render.config_tag"):
        tag = _config_tag(scene, camera, width, height, spp, max_depth, seed,
                          f"queue|{engine}|{chunk_spp}x{n_chunks}"
                          f"r{chunks[-1]}|d{D}|rr{rr_depth}")
        path, every, auto = _checkpoint_path(
            checkpoint_path, checkpoint_every, tag, n_chunks, 2, 1)
        film, start = (None, 0)
        if path:
            film, start = _load_checkpoint(path, tag, devs[0], progress,
                                           "chunk")
        if film is None:
            film = torch.zeros((P, 3), dtype=torch.float32, device=devs[0])

    kw = dict(cam_salt=seed, epoch_iters=epoch_iters, rr_depth=rr_depth,
              phase=phase)
    for c in range(start, n_chunks):
        cs, s0 = chunks[c], starts[c]

        def cb(frontier, total, done=s0 * P):
            pct = 100.0 * (done + frontier) / (P * spp)
            print(f"\rRendering {pct:5.1f}%", end="", file=sys.stderr)

        cb = cb if progress else None
        if mesh is not None and cs % D == 0:
            R_d, _, _, drain_d = plan_queue(scene, width, height, cs // D,
                                            rays_per_wave)
            part = trace_queue_mesh(
                scenes, camera, width, height, cs, s0, k_queue, max_depth,
                R_d, mesh, kerns=kerns, drain_levels=drain_d, progress_cb=cb,
                **kw)
        else:
            with mesh_mod.device_guard(devs[0]):
                part = trace_queue(
                    scene, camera, width, height, cs, s0, k_queue, max_depth,
                    R, drain_levels=drain, progress_cb=cb,
                    kern=kerns[devs[0]], **kw)
        film = film + part
        if path and every and (c + 1) % every == 0 and c + 1 < n_chunks:
            _save_checkpoint(path, film.cpu().numpy(), c + 1, tag)
        if on_partial is not None and c + 1 < n_chunks:
            on_partial(film.cpu().numpy().reshape(height, width, 3)
                       / (s0 + cs), 0)
    if progress:
        print("", file=sys.stderr)
    if auto:
        _remove(path)
    return film.reshape(height, width, 3).cpu().numpy() / spp


def _wave_step(scene, camera, width, height, spp, max_depth, seed,
               rays_per_wave, rr_depth, kern):
    """Plain-wavefront schedule (``make_wave_fn``): (k samples per pixel a
    wave, waves, wave(w) -> the wave's (H, W, 3) film).  Camera samples are
    drawn by lane position from ``jax.random``-equal streams of
    ``split(fold_in(PRNGKey(seed), wave), 3)``, so it takes the uniform
    sampler only."""
    if camera.sampler != "uniform":
        raise ValueError(
            "mode='wave' draws camera samples by lane position, not by "
            "(pixel, sample index), so low-discrepancy samplers do not "
            "apply; use the pool or queue mode with --sampler "
            f"{camera.sampler!r}")
    dev = scene.device
    with span("render.plan"):
        k = pick_samples_per_wave(width, height, spp, rays_per_wave)
        xy = pixel_grid(width, height, k, dev)
    with span("render.step_config"):
        cfg = StepConfig.create(scene, camera, width, height, max_depth,
                                rr_depth=rr_depth)
    cam = camera.to(dev)
    base_key = rng.prng_key(seed)

    def wave(w):
        k_jit, k_cam, k_path = rng.split(rng.fold_in(base_key, w), 3)
        R = xy.shape[1]
        jitter = rng.uniform(k_jit, (R, 2), dev)
        u = xy[0] + jitter[:, 0] / width
        v = xy[1] + jitter[:, 1] / height
        ro, rd, rt = cam.rays_from_uniforms(u, v, rng.uniform(k_cam, (R, 3),
                                                              dev))
        rad = trace(scene, cfg, pack_rays(ro, rd, rt), k_path, kern=kern)
        return rad.T.reshape(k, height, width, 3).sum(dim=0)

    return k, spp // k, wave


def _pool_step(scene, camera, width, height, spp, max_depth, seed,
               rays_per_wave, samples_per_wave, rr_depth, kern, mega, engine,
               row0, rows):
    """Pool schedule of image rows [row0, row0+rows) (``plan_pool`` with
    the band's rows): (samples per pixel a wave, waves, wave(w) -> the
    wave's (rows, W, 3) film); ``mega`` runs each wave as one megakernel
    launch."""
    dev = scene.device
    with span("render.plan"):
        k_pool, s_wave, n_waves = plan_pool(scene, width, rows, spp,
                                            rays_per_wave, samples_per_wave,
                                            engine)
        xy = pixel_grid(width, height, k_pool, dev, row0, rows)
        sids = slot_ids(width, height, k_pool, dev, row0, rows)
    trace_wave = trace_pool_mega if mega else trace_pool_staged
    base_key = rng.prng_key(seed)
    with span("render.step_config"):
        cfg0 = StepConfig.create(scene, camera, width, height, max_depth,
                                 rr_depth=rr_depth, n_samples=s_wave,
                                 cam_salt=seed)

    def wave(w):
        cfg = dataclasses.replace(cfg0, sample0=(w * s_wave) & rng.M32)
        rad, _ = trace_wave(scene, cfg, xy, sids, rng.fold_in(base_key, w),
                            kern)
        return rad.T.reshape(k_pool, rows, width, 3).sum(dim=0)

    return k_pool * s_wave, n_waves, wave


def render(scene: SceneData, camera: Camera, width: int, height: int,
           spp: int, max_depth: int = 50, seed: int = 1024,
           rays_per_wave: int = 1 << 20, samples_per_wave: int = 64,
           rr_depth: int = 0, device=None, progress: bool = False,
           mode: str = "auto", bvh=False, mesh=None, adaptive: float = 0.0,
           checkpoint_path=None, on_partial=None,
           sort: bool | None = None, engine: str = "auto",
           checkpoint_every: int = 0, _row0: int = 0,
           _rows: int | None = None,
           _band_cap: int | None = None) -> np.ndarray:
    """Render to a linear (H, W, 3) float32 image (mean over spp samples).

    ``mode``: "auto" (the work queue above 512 prims, else the pool),
    "pool", "queue" or "wave".  ``engine``: "auto", "xla" or "pallas" for
    the wavefront kernels, "mxu" for the matrix-product sweep of the
    static spheres, "mega" for one megakernel launch per pool wave
    (:func:`resolve_engine`).  ``sort`` sends the closest-hit sweep
    through the sorted, compacted-list kernel (the same image bit for bit;
    ``None`` reads ``TPU_RAY_SORT``, off unless ``1``).  ``bvh``: ``True``
    (or a :class:`~tpu_ray_torch.ops.bvh.BVHArrays`) finds closest hits by
    BVH traversal instead of the sweep on the pool (:func:`resolve_mode`
    demotes a queue request; with ``engine="mega"`` the wavefront pool
    renders).
    ``adaptive`` > 0 renders with per-pixel adaptive sampling at that
    tone-mapped standard error (:func:`tpu_ray_torch.adaptive.
    render_adaptive`): ``spp`` becomes the per-pixel budget cap, and
    ``mode``, ``samples_per_wave``, ``sort``, the checkpoint and
    ``on_partial`` are not read.

    ``mesh`` (:func:`tpu_ray_torch.parallel.mesh.make_mesh`, D devices)
    renders on every device of the mesh, and ``device`` is not read; the
    image is on the host as always.  Pool and wave renders go in rounds:
    round w renders global waves ``w * D + d`` on device d, each drawing
    what the single-device render's wave of that index draws, and adds
    their films summed in device order.  The last round's waves past the
    wave count are skipped; the JAX package renders them at weight 0,
    which adds nothing unless a wave is not finite.  The queue shares each
    chunk's samples out over the devices
    (:func:`~tpu_ray_torch.integrator.trace_queue_mesh`).  So the image is
    the single-device render's up to f32 summation order.  ``scene`` may
    then also be a dict of its copies by device (a caller's cache), so
    that nothing is copied per call.

    ``checkpoint_path`` makes the render resumable: the film is saved every
    ``checkpoint_every`` waves (pool, wave), rounds (on a mesh) or chunks
    (queue), and a later call of the same render resumes from it (a file
    of another render, the mesh's size included, is set aside and said
    so).  Renders of at least ``AUTO_CHECKPOINT_WAVES`` waves or rounds
    (two chunks on the queue) checkpoint by default under
    :func:`checkpoint_dir`, a file removed when the render completes.
    ``on_partial(img, rows_final)`` is called after every wave, round or
    chunk but the last with the current mean estimate of the whole frame;
    ``rows_final`` is the number of top rows that are final (0 unless the
    render is banded).  ``TPU_RAY_CRASH_AFTER_WAVE=N`` in the environment
    makes a fresh (not resumed) pool or wave render raise before wave (on a
    mesh: round) N.  ``camera.sampler`` picks the camera sample
    ("uniform", "sobol", "sobol-b0"; the pool and queue modes) and
    ``scene.strict`` the strict reference estimator.

    Row bands, as in the JAX package: a pool render whose ``width * rows``
    exceeds the lane cap (:func:`lane_cap`, above 512 prims; or
    ``_band_cap``, which forces bands at any size) renders bands of
    ``cap // width`` rows, top to bottom, each a render of its own with
    ``_row0`` / ``_rows`` (its own plan, checkpoint ``{path}.band{row0}``,
    progress and injected crash) and the frame's slot ids.  After each band
    ``on_partial`` gets the frame with ``rows_final`` up to the band's end;
    within a band, the band's rows above its start.
    """
    if adaptive and adaptive > 0:
        return render_adaptive(
            scene, camera, width, height, spp_max=spp, tol=adaptive,
            max_depth=max_depth, seed=seed, rays_per_wave=rays_per_wave,
            engine=engine, rr_depth=rr_depth, progress=progress,
            mesh=mesh, device=device)
    # the render's spans (utils/profiling.py), recorded under a profiler:
    # render.setup until the loop, render.finish after it
    with Phase("render.setup") as phase:
        if mesh is not None:
            with span("render.kernels"):
                scenes = mesh_mod.replicate(scene, mesh)
            scene = scenes[mesh[0]]
        engine = resolve_engine(scene, engine)
        mode = resolve_mode(scene, mode, engine, bvh=bool(bvh), mesh=mesh,
                            spp=spp, _rows=_rows)
        if camera.sampler == "sobol-b0" and mode != "queue" \
                and _rows is None:
            # the first-bounce override runs on the work queue only, as in
            # the JAX package; the pool and the megakernel keep the Sobol'
            # camera dims with hashed scatter draws, and say so
            print("tpu_ray_torch: sampler=sobol-b0's bounce-dim override "
                  f"only runs on the XLA work-queue path; mode={mode} keeps "
                  "the sobol camera dims with hashed scatter draws",
                  file=sys.stderr)
        if mesh is None:
            with span("render.kernels"):
                scene = scene.to(resolve_device(device))
            devs = (scene.device,)
            scenes = {scene.device: scene}
        else:
            devs = mesh
        dev = devs[0]
        tree = bvh if bvh else None
        if bvh is True:
            with span("render.kernels"):
                tree = build_bvh(scenes[dev])
        rows = height if _rows is None else _rows
        cap = (lane_cap(scene.n_prims, engine) if _band_cap is None
               else _band_cap)
        if mode == "pool" and _rows is None and cap is not None \
                and width * rows > cap:
            # each band gets the render's scene copies and tree: nothing is
            # replicated or built once per band
            # (each band a render with spans of its own)
            band_kw = dict(max_depth=max_depth, seed=seed,
                           rays_per_wave=rays_per_wave,
                           samples_per_wave=samples_per_wave,
                           rr_depth=rr_depth, device=dev, progress=progress,
                           mode=mode, bvh=tree, mesh=mesh, sort=sort,
                           engine=engine, checkpoint_every=checkpoint_every)
            phase.end()
            return _render_bands(scenes if mesh is not None else scene,
                                 camera, width, height, spp,
                                 max(1, cap // width), checkpoint_path,
                                 on_partial, band_kw)
        kerns = {}
        with span("render.kernels"):
            for d in mesh_mod.distinct(devs):
                with mesh_mod.device_guard(d):
                    kerns[d] = SceneKernels.create(
                        scenes[d], sort, None if tree is None else tree.to(d),
                        engine)
        if mode == "queue":
            return _render_queue(scenes, kerns, camera, width, height, spp,
                                 max_depth, seed, rays_per_wave, rr_depth,
                                 progress, engine, checkpoint_path,
                                 checkpoint_every, on_partial, mesh, phase)
        waves = {}
        for d in mesh_mod.distinct(devs):
            if mode == "wave":
                wave_spp, n_waves, waves[d] = _wave_step(
                    scenes[d], camera, width, height, spp, max_depth, seed,
                    rays_per_wave, rr_depth, kerns[d])
            else:
                # with a BVH the megakernel's own sweep cannot run: the
                # wavefront pool renders, as the JAX package's trace_pool
                # does
                wave_spp, n_waves, waves[d] = _pool_step(
                    scenes[d], camera, width, height, spp, max_depth, seed,
                    rays_per_wave, samples_per_wave, rr_depth, kerns[d],
                    engine == "mega" and tree is None, engine, _row0, rows)
        D = len(devs)
        n_units = -(-n_waves // D)

        def step(accum, w):
            parts = []
            for d, dv in enumerate(devs):
                if w * D + d < n_waves:
                    with mesh_mod.device_guard(dv):
                        parts.append(waves[dv](w * D + d))
            return accum + mesh_mod.reduce_films(parts, devs)

        unit = "wave" if mesh is None else "round"
        with span("render.config_tag"):
            tag = _config_tag(scene, camera, width, height, spp, max_depth,
                              seed, f"{mode}|{engine}|{wave_spp}|{n_waves}"
                              f"|{_row0}:{rows}|d{0 if mesh is None else D}"
                              f"|rr{rr_depth}|bvh{int(tree is not None)}")
            path, every, auto = _checkpoint_path(
                checkpoint_path, checkpoint_every, tag, n_units,
                AUTO_CHECKPOINT_WAVES, max(1, n_units // 8))
            accum, start = (None, 0)
            if path:
                accum, start = _load_checkpoint(path, tag, dev, progress,
                                                unit)
            if accum is None:
                accum = torch.zeros((rows, width, 3), dtype=torch.float32,
                                    device=dev)
        # fault injection for the supervision tests: a fresh (not resumed)
        # render dies before wave (round) N; a resumed one carries on past
        # it
        crash_after = int(os.environ.get("TPU_RAY_CRASH_AFTER_WAVE", -1))
        timer = WaveTimer(enabled=progress)
        phase.end()
        for w in range(start, n_units):
            if w == crash_after and start == 0:
                raise RuntimeError(f"injected crash before {unit} {w} "
                                   "(TPU_RAY_CRASH_AFTER_WAVE)")
            if progress:
                print(f"\rRendering {unit} {w + 1} of {n_units}", end="",
                      file=sys.stderr)
            timer.start()
            accum = step(accum, w)
            if path and every and (w + 1) % every == 0:
                _save_checkpoint(path, accum.cpu().numpy(), w + 1, tag)
            if on_partial is not None and w + 1 < n_units:
                done = min((w + 1) * D, n_waves)
                on_partial(accum.cpu().numpy() / min(done * wave_spp, spp),
                           0)
            timer.stop()
        phase.begin("render.finish")
        img = accum.cpu().numpy()
        if progress:
            print(f"\n{timer.summary()}", file=sys.stderr)
        if auto:
            _remove(path)
        return img / spp


def _render_bands(scene, camera, width, height, spp, band_h,
                  checkpoint_path, on_partial, kw) -> np.ndarray:
    """The frame in bands of ``band_h`` rows, top to bottom
    (``tpu_ray/renderer.py:600-627``): each band a :func:`render` of rows
    [row0, row0+bh) with its own checkpoint ``{path}.band{row0}``, its
    partial estimates composed into the frame, and the rows up to its end
    reported final once it is done."""
    frame = np.zeros((height, width, 3), np.float32)
    for row0 in range(0, height, band_h):
        bh = min(band_h, height - row0)
        band_cb = None
        if on_partial is not None:
            def band_cb(img, rows_final, r0=row0, bh=bh):
                full = frame.copy()
                full[r0:r0 + bh] = img
                on_partial(full, r0 + rows_final)
        frame[row0:row0 + bh] = render(
            scene, camera, width, height, spp,
            checkpoint_path=(f"{checkpoint_path}.band{row0}"
                             if checkpoint_path else None),
            on_partial=band_cb, _row0=row0, _rows=bh, **kw)
        if on_partial is not None:
            on_partial(frame.copy(), row0 + bh)
    return frame
