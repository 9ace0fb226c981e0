"""First-hit AOV passes: albedo, normal, depth, coverage.

Port of ``tpu_ray/aov.py``.  Each sample draws its camera rays from the
same per-(pixel, sample) streams as the JAX package's AOV pass (the
uniform hash jitter, or with ``sampler="sobol"`` the Owen-scrambled Sobol'
point; ``"sobol-b0"`` takes the hash branch there, as in ``tpu_ray/aov.py::
_camera_rays``), runs the closest-hit sweep (``SceneKernels.intersect``)
and reads shade-free features off the hit record:

  albedo    texture value at the hit (emissive materials give their
            emitted colour) - a miss gives the background
  normal    face-flipped unit shading normal - a miss gives 0; the
            per-pixel mean is re-normalised where it is nonzero
  depth     distance t * |rd| from the ray origin to the hit, averaged over
            the HITTING samples only; a pixel with no hit is +inf
  coverage  fraction of samples that hit anything

The features of a lane come from the CUDA kernel ``csrc/aov.cu`` (the shade
core's hit record and texture code; :func:`aov_features`), or on the CPU
from its plain twin :func:`aov_features_plain`.  Several samples share one
launch of up to ``band_cap`` lanes (one sample a launch in scenes with
media, whose free-flight draws are keyed by sample); the per-pixel sums are
taken sample by sample in sample order, as the JAX package's one wave per
sample does, so batching and band tiling change no bit of the output.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .core import rng
from .core.vec import sqrt_rn
from .integrator import SceneKernels, _to_i32_bits
from .models.scene_data import SceneData
from .ops.build import load_fn
from .ops.intersect import pack_rays
from .ops.shade import (StepConfig, _params, albedo_plain, camera_uniforms,
                        hit_record_plain, table_ptrs, texture_ptrs)

AOV_NAMES = ("albedo", "normal", "depth", "coverage")
# lanes per launch and per band when the caller gives no ``band_cap``: the
# renderer's ``rays_per_wave`` default
BAND_CAP = 1 << 20
N_FEATURES = 8      # albedo rgb, normal xyz, distance, hit
# roofline numerator per lane: 36 B in (7 ray rows, best_t, best_i), 32 B
# out (8 feature rows)
BYTES_PER_LANE = 68


def _check(cfg, rays, best_t, best_i):
    R = rays.shape[1] if rays.dim() == 2 else -1
    for x, shape, dtype in ((rays, (7, R), torch.float32),
                            (best_t, (R,), torch.float32),
                            (best_i, (R,), torch.int32)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"aov: expected {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous() or x.device != rays.device:
            raise ValueError("aov: inputs must be contiguous and on one "
                             "device")
    if cfg.tab.device != rays.device:
        raise ValueError("aov: scene tables are on another device")


def aov_features_plain(cfg: StepConfig, rays, best_t, best_i):
    """(8, R) float32 first-hit features of every lane in plain PyTorch:
    albedo rgb (background on a miss), normal xyz (0 on a miss), t * |rd|
    (0 on a miss) and hit (1/0) - ``tpu_ray/aov.py::_aov_step`` per lane."""
    _check(cfg, rays, best_t, best_i)
    aov_features_plain.calls += 1
    d = (rays[3], rays[4], rays[5])
    h = hit_record_plain(cfg, (rays[0], rays[1], rays[2]), d, rays[6],
                         best_t, best_i)
    att = albedo_plain(cfg, h["rows"], best_i, h["point"], h["u"], h["v"])
    hit = h["hit"]
    bg = cfg.background
    dist = best_t * sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return torch.stack(
        [torch.where(hit, att[c], float(bg[c])) for c in range(3)]
        + [torch.where(hit, h["normal"][c], 0.0) for c in range(3)]
        + [torch.where(hit, dist, 0.0), hit.to(torch.float32)])


aov_features_plain.calls = 0


def aov_features(cfg: StepConfig, rays, best_t, best_i):
    """First-hit features: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Layout as :func:`aov_features_plain`."""
    if not rays.is_cuda:
        return aov_features_plain(cfg, rays, best_t, best_i)
    _check(cfg, rays, best_t, best_i)
    fn = load_fn("aov", "tr_aov",
                 [ctypes.c_void_p] * 15 + [ctypes.c_longlong, ctypes.c_void_p])
    R = rays.shape[1]
    out = torch.empty((N_FEATURES, R), dtype=torch.float32,
                      device=rays.device)
    params = _params(cfg, (0, 0), False)
    err = fn(rays.data_ptr(), best_t.data_ptr(), best_i.data_ptr(),
             *table_ptrs(cfg), *texture_ptrs(cfg), params.ctypes.data,
             out.data_ptr(), R,
             torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"aov kernel launch failed (cudaError {err})")
    aov_features.launches += 1
    return out


aov_features.launches = 0


def camera_rays(camera, width: int, height: int, slot, sample: int,
                cam_salt: int):
    """(7, R) primary rays of pixels ``slot`` ((R,) int64 global pixel
    ids) at sample ``sample`` (``tpu_ray/aov.py::_camera_rays``)."""
    row = (slot // width).to(torch.float32)
    col = (slot % width).to(torch.float32)
    ys = (height - 1 - row) / height
    xs = col / width
    gs = torch.full_like(slot, sample & rng.M32)
    u = camera_uniforms(camera.sampler == "sobol", slot, gs, cam_salt)
    inv_w = float(np.float32(1.0 / width))
    inv_h = float(np.float32(1.0 / height))
    ro, rd, rt = camera.rays_from_uniforms(xs + u[0] * inv_w,
                                           ys + u[1] * inv_h,
                                           torch.stack(u[2:5], dim=-1))
    return pack_rays(ro, rd, rt)


def render_aovs(scene: SceneData, camera, width: int, height: int,
                spp: int = 16, seed: int = 0, engine: str = "xla",
                band_cap: int | None = None, device=None) -> dict:
    """Render the first-hit AOV buffers.

    Returns a dict of float32 numpy arrays: ``albedo`` (H, W, 3),
    ``normal`` (H, W, 3; the mean shading normal, re-normalised; 0 where
    nothing was hit), ``depth`` (H, W; mean hit distance, +inf where
    nothing was hit) and ``coverage`` (H, W; hit fraction).

    The frame is processed in bands of rows of at most ``band_cap`` pixels
    (default ``BAND_CAP``), each band's samples in launches of at most
    ``band_cap`` lanes; ray streams are keyed by global pixel id, so banded
    output is bit-identical to an unbanded pass.  ``engine`` is accepted
    for the JAX signature: the port has one sweep, the one the render's
    :class:`~tpu_ray_torch.integrator.SceneKernels` picks.  Runs on the
    card unless ``device="cpu"``."""
    from .renderer import resolve_device

    dev = resolve_device(device)
    scene = scene.to(dev)
    cam = camera.to(dev)
    band_cap = BAND_CAP if band_cap is None else int(band_cap)
    cfg = StepConfig.create(scene, camera, width, height, 1)
    kern = SceneKernels.create(scene)
    cam_salt = int(seed) & rng.M32
    keys = [rng.fold_in(rng.fold_in(rng.prng_key(0), cam_salt), s)
            for s in range(spp)]
    P = width * height
    band_h = max(1, band_cap // width)
    acc = torch.zeros((N_FEATURES, P), dtype=torch.float32, device=dev)
    for row0 in range(0, height, band_h):
        p0 = row0 * width
        bp = min(band_h, height - row0) * width
        pix = torch.arange(p0, p0 + bp, dtype=torch.int64, device=dev)
        k = 1 if scene.has_media else max(1, min(spp, band_cap // bp))
        for s0 in range(0, spp, k):
            ss = range(s0, min(spp, s0 + k))
            rays = torch.cat([camera_rays(cam, width, height, pix, s,
                                          cam_salt) for s in ss], dim=1)
            lanes = pix.repeat(len(ss))
            bt, bi = kern.intersect(scene, rays, keys[s0],
                                    _to_i32_bits(lanes))
            f = aov_features(cfg, rays, bt, bi.to(torch.int32).contiguous())
            # sample by sample, in sample order: JAX's one wave a sample
            for j in range(len(ss)):
                acc[:, p0:p0 + bp] += f[:, j * bp:(j + 1) * bp]
    return _finish(acc, spp, height, width)


def _finish(acc: torch.Tensor, spp: int, height: int, width: int) -> dict:
    """The per-pixel means of ``render_aovs`` from the (8, P) sums
    (``tpu_ray/aov.py:136-153``)."""
    hits = acc[7]
    some = hits > 0
    n_mean = acc[3:6] / spp
    n_len = sqrt_rn(n_mean[0] * n_mean[0] + n_mean[1] * n_mean[1]
                    + n_mean[2] * n_mean[2])
    normal = torch.where(some & (n_len > 1e-12),
                         n_mean / torch.clamp(n_len, min=1e-12), 0.0)
    depth = torch.where(some, acc[6] / torch.clamp(hits, min=1.0),
                        float("inf"))
    out = {"albedo": (acc[0:3] / spp).T.reshape(height, width, 3),
           "normal": normal.T.reshape(height, width, 3),
           "depth": depth.reshape(height, width),
           "coverage": (hits / spp).reshape(height, width)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def aov_images(aovs: dict) -> dict:
    """Map raw AOV buffers to displayable [0, 1] RGB images
    (``tpu_ray/aov.py::aov_images``): albedo clipped, normals as (n+1)/2,
    depth over its finite maximum (misses 1), coverage grey."""
    albedo = np.clip(np.asarray(aovs["albedo"]), 0.0, 1.0)
    normal = (np.asarray(aovs["normal"]) + 1.0) * 0.5
    depth = np.asarray(aovs["depth"])
    finite = np.isfinite(depth)
    dmax = float(depth[finite].max()) if finite.any() else 1.0
    d01 = np.where(finite, depth / max(dmax, 1e-12), 1.0)
    cov = np.asarray(aovs["coverage"])
    return {
        "albedo": albedo,
        "normal": np.clip(normal, 0.0, 1.0),
        "depth": np.repeat(d01[..., None], 3, axis=-1).astype(np.float32),
        "coverage": np.repeat(cov[..., None], 3, axis=-1).astype(np.float32),
    }
