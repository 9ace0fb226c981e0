"""The AOV-guided cross-bilateral denoiser of the port
(tpu_ray_torch/denoise.py) against the JAX package's tpu_ray.denoise on
seeded inputs with +inf depths (the weights' exponentials and the
three-term sums round in other places: rtol 1e-5 / atol 1e-6), and
mirrors of tests/test_denoise.py's properties: constant images are fixed
points, noise on flat regions shrinks, feature edges do not bleed,
hit/miss boundaries exchange no energy."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ray.denoise import denoise as jdenoise
from tpu_ray_torch.denoise import denoise


def _inputs(seed, h=20, w=28):
    r = np.random.default_rng(seed)
    img = r.random((h, w, 3)).astype(np.float32) * 2.0
    alb = r.random((h, w, 3)).astype(np.float32)
    nrm = r.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    depth = r.uniform(1.0, 8.0, (h, w)).astype(np.float32)
    miss = r.random((h, w)) < 0.2
    depth[miss] = np.inf
    nrm[miss] = 0.0
    return img, alb, nrm, depth


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_matches_jax(radius):
    args = _inputs(radius)
    want = np.asarray(jdenoise(*args, radius=radius))
    got = denoise(*args, radius=radius, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.abs(want - args[0]).max() > 0.1     # the filter did work


def test_sigmas_match_jax():
    args = _inputs(9)
    kw = dict(radius=2, sigma_spatial=1.3, sigma_albedo=0.3,
              sigma_normal=0.5, sigma_depth=0.1)
    np.testing.assert_allclose(denoise(*args, **kw, device="cpu").numpy(),
                               np.asarray(jdenoise(*args, **kw)), rtol=1e-5,
                               atol=1e-6)


def _flat_guides(h, w, albedo=(0.5, 0.5, 0.5)):
    a = np.broadcast_to(np.asarray(albedo, np.float32), (h, w, 3)).copy()
    n = np.broadcast_to(np.asarray([0, 0, 1], np.float32), (h, w, 3)).copy()
    d = np.full((h, w), 5.0, np.float32)
    return a, n, d


def test_constant_image_is_fixed_point():
    a, n, d = _flat_guides(16, 20)
    img = np.full((16, 20, 3), 0.37, np.float32)
    np.testing.assert_allclose(denoise(img, a, n, d, device="cpu").numpy(),
                               img, rtol=1e-5, atol=1e-6)


def test_noise_shrinks_mean_preserved():
    rng = np.random.default_rng(5)
    a, n, d = _flat_guides(32, 32)
    img = (0.4 + 0.1 * rng.standard_normal((32, 32, 3))).astype(np.float32)
    out = denoise(img, a, n, d, device="cpu").numpy()
    inner = (slice(6, -6), slice(6, -6))
    assert out[inner].std() < 0.35 * img[inner].std()
    assert abs(out[inner].mean() - img[inner].mean()) < 5e-3


def test_albedo_edge_does_not_bleed():
    rng = np.random.default_rng(7)
    h, w = 24, 40
    a, n, d = _flat_guides(h, w)
    a[:, w // 2:] = (0.9, 0.1, 0.1)
    img = np.empty((h, w, 3), np.float32)
    img[:, : w // 2] = 0.2
    img[:, w // 2:] = 0.8
    img += 0.05 * rng.standard_normal(img.shape).astype(np.float32)
    out = denoise(img, a, n, d, device="cpu").numpy()
    assert abs(out[:, w // 2 - 1].mean() - 0.2) < 0.03
    assert abs(out[:, w // 2].mean() - 0.8) < 0.03


def test_hit_miss_boundary_is_sealed():
    h, w = 16, 16
    a, n, d = _flat_guides(h, w)
    d[:, : w // 2] = np.inf
    img = np.zeros((h, w, 3), np.float32)
    img[:, w // 2:] = 1.0
    out = denoise(img, a, n, d, device="cpu").numpy()
    assert out[:, : w // 2].max() == 0.0
    np.testing.assert_allclose(out[:, w // 2:], 1.0, atol=1e-5)


def test_normal_edge_preserved_same_albedo():
    rng = np.random.default_rng(3)
    h, w = 24, 24
    a, n, d = _flat_guides(h, w)
    n[h // 2:] = (0.0, 1.0, 0.0)
    img = np.empty((h, w, 3), np.float32)
    img[: h // 2] = 0.25
    img[h // 2:] = 0.75
    img += 0.04 * rng.standard_normal(img.shape).astype(np.float32)
    out = denoise(img, a, n, d, device="cpu").numpy()
    assert abs(out[h // 2 - 1].mean() - 0.25) < 0.03
    assert abs(out[h // 2].mean() - 0.75) < 0.03


def test_default_device_is_the_card():
    args = _inputs(4, 8, 8)
    if torch.cuda.is_available():
        assert denoise(*args, radius=1).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            denoise(*args, radius=1)


def test_cli_denoise(tmp_path):
    out = tmp_path / "dn.pfm"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch", "--device", "cpu", "--scene",
         "two-spheres", "--width", "24", "--height", "16", "--spp", "4",
         "--max-depth", "3", "--denoise", "--denoise-radius", "2", "--out",
         str(out)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "denoised (cross-bilateral, AOV-guided, r=2)" in r.stderr
    assert os.path.exists(out)
