"""AOV-guided denoiser: cross-bilateral filtering of the beauty pass.

Port of ``tpu_ray/denoise.py``.  Each pixel's radiance becomes a weighted
mean over a (2r+1)^2 window, with weights the product of

  spatial   exp(-(dx^2+dy^2) / 2 sigma_s^2)
  albedo    exp(-||da||^2    / 2 sigma_a^2)   edges in texture/material
  normal    exp(-||dn||^2    / 2 sigma_n^2)   silhouettes and creases
  depth     exp(-(dd/scale)^2 / 2 sigma_d^2)  depth discontinuities
            (dd relative to the window centre's depth; misses (+inf)
            never exchange energy with hits)

The window is (2r+1)^2 shifted copies (``torch.roll``, as the JAX
package's ``jnp.roll``) with the rolled-in wraparound texels masked to
weight zero; the weights are normalised, so a constant image is a fixed
point.  The JAX function is one XLA program and no Pallas kernel, so this
is plain PyTorch tensor code, on the card unless ``device="cpu"``.  An estimator
post-process, biased like every practical denoiser: opt-in
(``--denoise``).
"""
from __future__ import annotations

import torch

from .renderer import resolve_device

__all__ = ["denoise"]


def denoise(img, albedo, normal, depth, radius: int = 3,
            sigma_spatial: float = 2.0, sigma_albedo: float = 0.1,
            sigma_normal: float = 0.25, sigma_depth: float = 0.02,
            device=None) -> torch.Tensor:
    """Cross-bilateral denoise of a linear (H, W, 3) radiance image.

    ``albedo`` / ``normal``: (H, W, 3) first-hit AOVs (``normal`` may be 0
    where nothing was hit); ``depth``: (H, W) mean hit distance, +inf on
    misses; ``sigma_depth`` is relative to the centre depth.  Inputs may be
    numpy arrays or tensors; they are taken to ``device`` (default: the
    card; ``device="cpu"`` filters on the host).  Returns the filtered
    (H, W, 3) float32 tensor on that device."""
    device = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    img, albedo, normal, depth = f32(img), f32(albedo), f32(normal), f32(depth)
    H, W, _ = img.shape
    hit = torch.isfinite(depth)
    safe_depth = torch.where(hit, depth, 0.0)
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    acc = torch.zeros_like(img)
    wsum = torch.zeros((H, W), dtype=torch.float32, device=device)
    inv2_s = 0.5 / (sigma_spatial * sigma_spatial)
    inv2_a = 0.5 / (sigma_albedo * sigma_albedo)
    inv2_n = 0.5 / (sigma_normal * sigma_normal)
    inv2_d = 0.5 / (sigma_depth * sigma_depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sh = lambda a: torch.roll(a, (dy, dx), dims=(0, 1))
            # a texel rolled in from the far edge is not a neighbour
            valid = ((ys - dy >= 0) & (ys - dy < H)
                     & (xs - dx >= 0) & (xs - dx < W))
            da = albedo - sh(albedo)
            dn = normal - sh(normal)
            n_hit = sh(hit)
            dd = torch.where(hit & n_hit,
                             (safe_depth - sh(safe_depth))
                             / torch.clamp(safe_depth, min=1e-6), 0.0)
            w = torch.exp(-(dy * dy + dx * dx) * inv2_s
                          - (da * da).sum(dim=-1) * inv2_a
                          - (dn * dn).sum(dim=-1) * inv2_n
                          - dd * dd * inv2_d)
            # hit / miss boundaries never exchange energy
            w = torch.where((hit == n_hit) & valid, w, 0.0)
            acc = acc + w[..., None] * sh(img)
            wsum = wsum + w
    return acc / torch.clamp(wsum, min=1e-12)[..., None]
