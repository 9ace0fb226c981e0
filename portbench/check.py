"""Whether the timed renders are the estimator's images.

After the window, the reference (``portbench/reference``, float32) renders
the run's checked pixels of a few of the window's requests, drawn from the
seed, from nothing but the request: scene name and seed, sample seed,
size, spp and depth.  Two numbers are compared, each with its own limit
from ``correct/<cell>.json``:

* ``divergent_share``: the share of checked pixels with a channel off the
  reference by more than ``ATOL + RTOL * |reference|`` (the repository's
  cross-engine test of a pixel);
* ``mean_gap``: |sum of the checked values - the reference's sum| over
  the reference's sum.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import scenes as ref_scenes
from .reference import tracer as ref_tracer

ATOL, RTOL = 1e-4, 2e-4
QUEUE_MIN_PRIMS = 512


def pixel_sample(seed: int, n_pixels: int, n: int) -> np.ndarray:
    """``n`` distinct flat pixel ids of an ``n_pixels`` frame, sorted,
    drawn from ``seed``."""
    g = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5A17])
    return np.sort(g.choice(n_pixels, size=min(n, n_pixels), replace=False))


def pick_renders(seed: int, n_done: int, k: int) -> list:
    """``k`` of the ``n_done`` finished requests, drawn from ``seed``."""
    g = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0xC4EC])
    return sorted(g.choice(n_done, size=min(k, n_done), replace=False)
                  .tolist())


def reference_pixels(config: dict, req, pixels: np.ndarray, device,
                     dt=torch.float32) -> np.ndarray:
    """(n, 3) float32 reference estimate of ``pixels`` of request ``req``."""
    W, H = int(config["width"]), int(config["height"])
    sc = ref_scenes.build(config["scene"], req.scene_seed, device, dt)
    cam = ref_scenes.scene_fns(config["scene"])[1](W, H)
    render = (ref_tracer.render_queue if sc.n_prims > QUEUE_MIN_PRIMS
              else ref_tracer.render_pool)
    px = torch.from_numpy(np.asarray(pixels, np.int64)).to(device)
    out = render(sc, cam, W, H, req.spp, int(config["max_depth"]),
                 req.sample_seed, px, dt)
    return out.float().cpu().numpy()


def compare(got: np.ndarray, ref: np.ndarray) -> dict:
    """The two compared numbers of checked values ``got`` against
    ``ref`` (both (n, 3))."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    off = (np.abs(got - ref) > ATOL + RTOL * np.abs(ref)) | ~np.isfinite(got)
    total = ref.sum()
    return dict(divergent_share=float(off.any(axis=-1).mean()),
                mean_gap=float(abs(got.sum() - total) / max(total, 1e-30)))


def judge(numbers: dict, limits: dict) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
