"""Rendering: the pool-mode schedule, waves and the film.

Port of the pool path of ``tpu_ray/renderer.py``: ``pick_samples_per_wave``,
``plan_pool``, ``_pixel_grid``, ``_slot_ids``, ``_film_add`` and ``render``
in pool mode.  ``plan_pool`` and its constants are kept identical to the
JAX package's even though they were tuned on a TPU: ``k_pool`` decides the
global slot ids and those key every random stream, so any other plan would
change the image's noise and the port could no longer be held to the JAX
renders and goldens.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a CUDA device they raise.  Inputs outside this port's scope raise
``NotImplementedError``; nothing falls back to another path.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .core import rng
from .core.camera import Camera
from .integrator import SceneKernels, trace_pool_staged
from .models.scene_data import SceneData
from .ops.shade import StepConfig

MAX_POOL_PRIMS = 512     # above this the JAX package renders in queue mode


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


def check_supported(scene: SceneData, camera: Camera) -> None:
    """Raise ``NotImplementedError`` for scenes outside this port."""
    if scene.n_prims > MAX_POOL_PRIMS:
        raise NotImplementedError(
            f"{scene.n_prims} prims: scenes over {MAX_POOL_PRIMS} prims "
            "render in queue mode, which the next slice of the port adds "
            "(next-week-final)")
    if scene.has_image:
        raise NotImplementedError("image textures are not ported yet (a "
                                  "later slice adds the atlas fetch)")
    if scene.strict:
        raise NotImplementedError("the strict reference estimator is not "
                                  "ported yet (a later slice)")
    if scene.checker_fancy:
        raise NotImplementedError("checker textures with non-constant "
                                  "children are not ported yet")
    if camera.sampler != "uniform":
        raise NotImplementedError(f"sampler {camera.sampler!r} is not ported "
                                  "yet (a later slice adds core/qmc.py)")


def plan_pool(scene: SceneData, width: int, height: int, spp: int,
              rays_per_wave: int = 1 << 20, samples_per_wave: int = 64):
    """Pool-mode schedule (k_pool slots/pixel, samples per slot per wave,
    wave count): the JAX package's plan for scenes of <= 512 prims."""
    if scene.n_prims > MAX_POOL_PRIMS:
        raise NotImplementedError("queue-mode schedules are not ported yet")
    k_pool = pick_samples_per_wave(width, height, spp, rays_per_wave)
    s_total = spp // k_pool
    lanes = width * height * k_pool
    s_budget = max(1, int(2e13 / (lanes * max(scene.n_prims, 1) * 8)))
    s_wave = _largest_divisor_leq(s_total, min(samples_per_wave, s_budget))
    return k_pool, s_wave, s_total // s_wave


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


def render(scene: SceneData, camera: Camera, width: int, height: int,
           spp: int, max_depth: int = 50, seed: int = 1024,
           rays_per_wave: int = 1 << 20, samples_per_wave: int = 64,
           rr_depth: int = 0, device=None, progress: bool = False,
           mode: str = "auto", bvh=False, mesh=None, adaptive: float = 0.0,
           checkpoint_path=None, on_partial=None) -> np.ndarray:
    """Render to a linear (H, W, 3) float32 image (mean over spp samples).

    Pool mode only: ``mode`` may be "auto" or "pool".  The remaining
    arguments of the JAX ``render`` (BVH traversal, device meshes, adaptive
    sampling, checkpoints, progressive output) are later slices of the port
    and raise ``NotImplementedError`` when asked for.
    """
    for name, on in (("mode=" + repr(mode), mode not in ("auto", "pool")),
                     ("bvh", bool(bvh)), ("mesh", mesh is not None),
                     ("adaptive sampling", bool(adaptive)),
                     ("checkpointing", checkpoint_path is not None),
                     ("progressive output", on_partial is not None)):
        if on:
            raise NotImplementedError(f"{name} is not ported yet (a later "
                                      "slice of the port)")
    check_supported(scene, camera)
    dev = resolve_device(device)
    scene = scene.to(dev)
    k_pool, s_wave, n_waves = plan_pool(scene, width, height, spp,
                                        rays_per_wave, samples_per_wave)
    xy = pixel_grid(width, height, k_pool, dev)
    sids = slot_ids(width, height, k_pool, dev)
    kern = SceneKernels.create(scene)
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
        rad, _ = trace_pool_staged(scene, cfg, xy, sids,
                                   rng.fold_in(base_key, w), kern)
        accum = film_add(accum, rad, k_pool, height, width)
    img = accum.cpu().numpy()
    if progress:
        print(f"\n{n_waves} waves in {time.perf_counter() - t0:.3f}s",
              file=sys.stderr)
    return img / spp
