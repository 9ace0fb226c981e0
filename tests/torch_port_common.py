"""Shared helpers of the tests that hold tpu_ray_torch against tpu_ray."""
from __future__ import annotations

import dataclasses

import numpy as np

# the six golden configs without image textures (tests/test_golden.py)
GOLDEN_CONFIGS = {
    "two-spheres": (16, 8, 32, 24),
    "cornell": (32, 12, 32, 24),
    "book1-final": (8, 8, 32, 24),
    "cornell-smoke": (16, 8, 24, 16),
    "simple-light": (16, 8, 24, 16),
    "two-perlin-spheres": (4, 4, 24, 16),
}
SCENE_NAMES = sorted(GOLDEN_CONFIGS)


def jax_scene_arrays(scene) -> dict:
    """A JAX SceneData as the dict tpu_ray_torch.convert takes: its
    array leaves keyed "<group>.<field>" plus its static fields."""
    from tpu_ray_torch.models.scene_data import STATIC_FIELDS

    out = {}
    for g in ("prims", "mats", "texs", "lights"):
        sub = getattr(scene, g)
        for f in dataclasses.fields(sub):
            out[f"{g}.{f.name}"] = np.asarray(getattr(sub, f.name))
    for k in ("background", "prim_payload", "mat_payload"):
        out[k] = np.asarray(getattr(scene, k))
    for k in STATIC_FIELDS:
        out[k] = getattr(scene, k)
    return out


def cross_engine(a, b, share=0.02):
    """The cross-engine criterion of tests/test_shade_pallas.py:109-113:
    at most ``share`` of pixels diverge, the rest agree within rtol 2e-4 /
    atol 1e-4.  Returns the divergent share."""
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    div = 1.0 - close.mean()
    assert div <= share, f"{div:.2%} pixels diverged (max {err.max():.2e})"
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)
    return div
