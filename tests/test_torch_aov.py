"""First-hit AOV passes of the port (tpu_ray_torch/aov.py) against the JAX
package's render_aovs on the CPU, band tiling, the features' geometry
(mirrors of tests/test_aov.py) and the ``--aov`` CLI.

Tolerances (the port sums each pixel's samples in the JAX package's order,
sample by sample, so what differs is the features' last digits): coverage
and the positions of +inf depths equal; albedo within 1e-5 (the marble's
last sine); normals within 2e-4 (one ulp of a hit point, divided by the
sphere radius, then re-normalised over a pixel's mean); depth within rtol
2e-5 (the sweep's t against JAX's, times |rd| of several hundred on the
Cornell camera).  The textured-checker scene is held to the JAX package run
op by op: its jitted program rounds the ground's marble otherwise
(tests/test_torch_textures.py)."""
from __future__ import annotations

import subprocess
import sys

import jax
import numpy as np
import pytest
from torch_port_common import seeded_image, textured_checker_scene

from tpu_ray.aov import render_aovs as jrender_aovs
from tpu_ray.models import objects as job
from tpu_ray.models.compile import build_scene as jbuild_scene
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.models.scenes import two_spheres_camera as jcamera
from tpu_ray_torch.aov import AOV_NAMES, aov_images, render_aovs
from tpu_ray_torch.core.camera import Camera
from tpu_ray_torch.models import objects as ob
from tpu_ray_torch.models.compile import build_scene
from tpu_ray_torch.models.scenes import SCENES, two_spheres_camera

BG = (0.1, 0.2, 0.7)
IMG = seeded_image()


def _pair(name, W, H):
    if name == "checker-tex":
        return (textured_checker_scene(job, jbuild_scene, IMG),
                jcamera(W, H), textured_checker_scene(ob, build_scene, IMG),
                two_spheres_camera(W, H))
    earth = IMG if name == "earth" else None
    return (JSCENES[name].build(seed=1024, earth=earth),
            JSCENES[name].camera(W, H),
            SCENES[name].build(seed=1024, earth=earth), SCENES[name].camera(W, H))


def _hold(a, b):
    np.testing.assert_array_equal(np.asarray(a["coverage"]), b["coverage"])
    ad = np.asarray(a["depth"])
    np.testing.assert_array_equal(np.isinf(ad), np.isinf(b["depth"]))
    fin = np.isfinite(ad)
    np.testing.assert_allclose(b["depth"][fin], ad[fin], rtol=2e-5, atol=0)
    np.testing.assert_allclose(b["albedo"], np.asarray(a["albedo"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(b["normal"], np.asarray(a["normal"]), rtol=0,
                               atol=2e-4)


CASES = [(n, s) for n in ("cornell", "two-spheres", "cornell-smoke", "earth")
         for s in ("uniform", "sobol", "sobol-b0")] + [
    ("checker-tex", "uniform"), ("checker-tex", "sobol")]


@pytest.mark.parametrize("name,sampler", CASES)
def test_render_aovs_matches_jax(name, sampler):
    """24x16, 4 spp, seed 5; ``"sobol-b0"`` takes the hash branch of the
    camera draw there, as the JAX package's ``_camera_rays`` does."""
    W, H = 24, 16
    js, jc, ps, pc = _pair(name, W, H)
    kw = dict(spp=4, seed=5)
    if name == "checker-tex":
        with jax.disable_jit():
            a = jrender_aovs(js, jc.replace(sampler=sampler), W, H, **kw)
    else:
        a = jrender_aovs(js, jc.replace(sampler=sampler), W, H, **kw)
    b = render_aovs(ps, pc.replace(sampler=sampler), W, H, device="cpu", **kw)
    assert set(b) == set(AOV_NAMES)
    for k in AOV_NAMES:
        assert b[k].dtype == np.float32 and b[k].shape == np.shape(a[k])
    _hold(a, b)
    assert 0.0 < b["coverage"].mean()


def test_sobol_b0_takes_the_hash_camera_draw():
    ps, pc = SCENES["two-spheres"].build(), SCENES["two-spheres"].camera(16, 8)
    kw = dict(spp=2, seed=3, device="cpu")
    a = render_aovs(ps, pc, 16, 8, **kw)
    b = render_aovs(ps, pc.replace(sampler="sobol-b0"), 16, 8, **kw)
    c = render_aovs(ps, pc.replace(sampler="sobol"), 16, 8, **kw)
    for k in AOV_NAMES:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["depth"], c["depth"])


@pytest.mark.parametrize("name,band_cap", [("cornell", 40 * 3),
                                           ("cornell-smoke", 40 * 7),
                                           ("checker-tex", 40 * 5 + 3)])
def test_banded_aovs_bit_identical(name, band_cap):
    """Bands of rows (and launches of several samples) change no bit:
    ray streams are keyed by global pixel id and each pixel's samples are
    summed in sample order."""
    _, _, ps, pc = _pair(name, 40, 24)
    kw = dict(spp=4, seed=5, device="cpu")
    full = render_aovs(ps, pc, 40, 24, **kw)
    banded = render_aovs(ps, pc, 40, 24, band_cap=band_cap, **kw)
    for k in AOV_NAMES:
        np.testing.assert_array_equal(full[k], banded[k])


# --- mirrors of tests/test_aov.py -------------------------------------------

def _sphere_scene():
    return build_scene([ob.Sphere((0.0, 0.0, -5.0), 1.0,
                                  ob.Lambertian((0.8, 0.2, 0.2)))],
                       background=BG)


def _camera(aperture=0.0):
    return Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 40.0, 1.0,
                         aperture, 5.0)


def test_center_pixel_features():
    aovs = render_aovs(_sphere_scene(), _camera(), 33, 33, spp=8, seed=3,
                       device="cpu")
    np.testing.assert_allclose(aovs["albedo"][16, 16], (0.8, 0.2, 0.2),
                               atol=1e-5)
    np.testing.assert_allclose(aovs["normal"][16, 16], (0, 0, 1), atol=0.05)
    assert abs(float(aovs["depth"][16, 16]) - 4.0) < 0.01
    assert float(aovs["coverage"][16, 16]) == 1.0


def test_miss_pixels():
    aovs = render_aovs(_sphere_scene(), _camera(), 33, 33, spp=4, seed=3,
                       device="cpu")
    for (y, x) in [(0, 0), (0, 32), (32, 0), (32, 32)]:
        np.testing.assert_allclose(aovs["albedo"][y, x], BG, atol=1e-6)
        np.testing.assert_allclose(aovs["normal"][y, x], 0.0, atol=0)
        assert np.isinf(aovs["depth"][y, x])
        assert float(aovs["coverage"][y, x]) == 0.0


def test_deterministic_and_sampler_sensitive():
    cam = _camera(aperture=0.2)
    kw = dict(spp=4, seed=9, device="cpu")
    a = render_aovs(_sphere_scene(), cam, 17, 17, **kw)
    b = render_aovs(_sphere_scene(), cam, 17, 17, **kw)
    for n in AOV_NAMES:
        np.testing.assert_array_equal(a[n], b[n])
    c = render_aovs(_sphere_scene(), cam.replace(sampler="sobol"), 17, 17,
                    **kw)
    assert not np.array_equal(a["coverage"], c["coverage"])
    both = (a["coverage"] == 1.0) & (c["coverage"] == 1.0)
    assert both.any()
    np.testing.assert_allclose(a["depth"][both], c["depth"][both], atol=0.25)


def test_emissive_albedo_is_emitted_color():
    scene = build_scene([ob.Sphere((0.0, 0.0, -5.0), 1.0,
                                   ob.DiffuseLight((4.0, 4.0, 4.0)))])
    aovs = render_aovs(scene, _camera(), 9, 9, spp=4, seed=0, device="cpu")
    np.testing.assert_allclose(aovs["albedo"][4, 4], (4, 4, 4), atol=1e-5)


def test_aov_images_encodings():
    aovs = render_aovs(_sphere_scene(), _camera(), 17, 17, spp=4, seed=1,
                       device="cpu")
    imgs = aov_images(aovs)
    for n in AOV_NAMES:
        assert imgs[n].shape == (17, 17, 3) and np.isfinite(imgs[n]).all()
        assert imgs[n].min() >= 0.0 and imgs[n].max() <= 1.0
    np.testing.assert_allclose(imgs["normal"][0, 0], 0.5, atol=1e-6)
    np.testing.assert_allclose(imgs["depth"][0, 0], 1.0, atol=0)


def _cli(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "tpu_ray_torch", "--device",
                           "cpu", *args], capture_output=True, text=True,
                          timeout=timeout)


def test_cli_aov_png(tmp_path):
    out = tmp_path / "c.png"
    r = _cli("--scene", "cornell", "--width", "12", "--height", "12",
             "--spp", "2", "--aov", "all", "--out", str(out))
    assert r.returncode == 0, r.stderr
    for n in AOV_NAMES:
        assert (tmp_path / f"c.{n}.png").exists()
        assert f"wrote {tmp_path}/c.{n}.png" in r.stderr
    assert not out.exists()     # no beauty pass is rendered under --aov


def test_cli_aov_pfm_raw_floats(tmp_path):
    """--out x.pfm writes raw float PFMs: signed normals, +inf depth misses
    (the Cornell box's open front), equal to render_aovs' buffers."""
    r = _cli("--scene", "cornell", "--width", "12", "--height", "12",
             "--spp", "2", "--aov", "normal,depth", "--out",
             str(tmp_path / "c.pfm"))
    assert r.returncode == 0, r.stderr
    spec = SCENES["cornell"]
    want = render_aovs(spec.build(seed=1024), spec.camera(12, 12), 12, 12,
                       spp=2, seed=1024, device="cpu")
    for n in ("normal", "depth"):
        raw = (tmp_path / f"c.{n}.pfm").read_bytes()
        head, rest = raw.split(b"\n", 1)
        assert head == b"PF"
        _dims, rest = rest.split(b"\n", 1)
        _scale, body = rest.split(b"\n", 1)
        a = np.frombuffer(body, "<f4").reshape(12, 12, 3)[::-1]
        w = want[n] if n == "normal" else np.repeat(want[n][..., None], 3, -1)
        np.testing.assert_array_equal(a, w)
        if n == "normal":
            assert a.min() < 0.0
        else:
            assert np.isinf(a).any() and np.isfinite(a).any()
    assert not (tmp_path / "c.albedo.pfm").exists()


def test_cli_aov_checks_and_ignored_flags(tmp_path):
    bad = _cli("--scene", "two-spheres", "--aov", "albedo,shine", "--out",
               str(tmp_path / "a.png"))
    assert bad.returncode == 2 and "unknown AOV(s) ['shine']" in bad.stderr
    no_out = _cli("--scene", "two-spheres", "--aov", "all")
    assert no_out.returncode == 2 and "pass --out PATH" in no_out.stderr
    r = _cli("--scene", "two-spheres", "--width", "8", "--height", "8",
             "--spp", "1", "--aov", "coverage", "--mode", "queue",
             "--rr-depth", "3", "--out", str(tmp_path / "a.png"))
    assert r.returncode == 0, r.stderr
    assert "[aov] ignoring --mode, --rr-depth" in r.stderr
    assert (tmp_path / "a.coverage.png").exists()
