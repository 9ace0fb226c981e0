"""Checkpoint / resume of tpu_ray_torch.render (tests/test_render.py:169-337
and tests/test_qmc.py:157 on the port).

A render interrupted after a checkpoint and resumed is bit-equal to an
uninterrupted one, on the pool, in wave mode, on the queue and with
``engine="mega"``: the film is saved as it is and every later wave adds
the same numbers.  A checkpoint of another render (another scene content,
sampler or depth, or the JAX package's) starts fresh, an unreadable one is
ignored, and long renders checkpoint by default under
``~/.cache/tpu_ray_torch/checkpoints`` (``HOME`` is patched here)."""
from __future__ import annotations

import os

import numpy as np
import pytest

from tpu_ray_torch import renderer
from tpu_ray_torch.core.camera import Camera
from tpu_ray_torch.models import objects as ob
from tpu_ray_torch.models.compile import build_scene
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.renderer import render

CRASH = "TPU_RAY_CRASH_AFTER_WAVE"


@pytest.fixture(autouse=True)
def home(tmp_path, monkeypatch):
    """A HOME of its own, so auto checkpoints land in the test's tmp dir."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv(CRASH, raising=False)
    return tmp_path / "home"


def _two_spheres(w=16, h=16):
    spec = SCENES["two-spheres"]
    return spec.build(), spec.camera(w, h)


# (mode, engine, render keywords): every schedule has 4 waves or chunks
SCHEDULES = {
    "pool": dict(mode="pool", rays_per_wave=256, samples_per_wave=2),
    "wave": dict(mode="wave", rays_per_wave=256),
    "mega": dict(mode="pool", engine="mega", rays_per_wave=256,
                 samples_per_wave=2),
    "queue": dict(mode="queue"),
}


class Interrupt(Exception):
    pass


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_resume_is_bit_equal(schedule, tmp_path, monkeypatch, capsys):
    scene, cam = _two_spheres()
    spp = 4 if schedule == "wave" else 8
    kw = dict(max_depth=4, seed=5, device="cpu", **SCHEDULES[schedule])
    if schedule == "queue":   # 2 samples a chunk: 4 chunks
        monkeypatch.setattr(renderer, "QUEUE_PLANE_BYTES", 16 * 16 * 12 * 2)
    ck = str(tmp_path / "ck.npz")
    full = render(scene, cam, 16, 16, spp, **kw)
    if schedule == "queue":
        # the queue saves first, then reports: an on_partial that raises
        # after chunk 2 leaves a checkpoint of 2 chunks behind
        seen = []

        def stop(img, rows_final):
            seen.append(rows_final)
            if len(seen) == 2:
                raise Interrupt

        with pytest.raises(Interrupt):
            render(scene, cam, 16, 16, spp, checkpoint_path=ck,
                   checkpoint_every=1, on_partial=stop, **kw)
        unit = "chunk"
    else:
        monkeypatch.setenv(CRASH, "3")
        with pytest.raises(RuntimeError, match="injected crash before wave 3"):
            render(scene, cam, 16, 16, spp, checkpoint_path=ck,
                   checkpoint_every=1, **kw)
        unit = "wave"
    with np.load(ck) as f:
        assert int(f["waves_done"]) == (2 if schedule == "queue" else 3)
    capsys.readouterr()
    resumed = render(scene, cam, 16, 16, spp, checkpoint_path=ck,
                     progress=True, **kw)
    assert f"resuming at {unit} {2 if schedule == 'queue' else 3}" in \
        capsys.readouterr().err
    np.testing.assert_array_equal(resumed, full)


def test_checkpoint_path_without_npz(tmp_path):
    scene, cam = _two_spheres(8, 8)
    ck = str(tmp_path / "film.ckpt")
    kw = dict(max_depth=3, seed=6, rays_per_wave=64, samples_per_wave=2,
              device="cpu")
    full = render(scene, cam, 8, 8, spp=8, **kw)
    render(scene, cam, 8, 8, spp=8, checkpoint_path=ck, checkpoint_every=2,
           **kw)
    assert os.path.exists(ck + ".npz")
    np.testing.assert_array_equal(
        render(scene, cam, 8, 8, spp=8, checkpoint_path=ck, **kw), full)
    # another render's checkpoint (max_depth 4) is set aside, not blended
    kw4 = dict(kw, max_depth=4)
    fresh4 = render(scene, cam, 8, 8, spp=8, **kw4)
    np.testing.assert_array_equal(
        render(scene, cam, 8, 8, spp=8, checkpoint_path=ck, **kw4), fresh4)
    assert np.abs(fresh4 - full).max() > 1e-4


def test_auto_checkpoint_survives_crash(home, monkeypatch, capsys):
    """Long renders checkpoint by default; a crash loses at most one
    interval and an identical re-run resumes; the file goes when the
    render completes."""
    scene, cam = _two_spheres(8, 8)
    kw = dict(max_depth=3, seed=9, rays_per_wave=64, samples_per_wave=1,
              device="cpu")
    monkeypatch.setattr(renderer, "AUTO_CHECKPOINT_WAVES", 2)
    full = render(scene, cam, 8, 8, spp=8, **kw)          # 8 waves
    d = renderer.checkpoint_dir()
    assert d.startswith(str(home)) and os.listdir(d) == []
    monkeypatch.setenv(CRASH, "5")
    with pytest.raises(RuntimeError):
        render(scene, cam, 8, 8, spp=8, **kw)
    monkeypatch.delenv(CRASH)
    (auto,) = os.listdir(d)
    assert auto.startswith("auto-") and auto.endswith(".npz")
    capsys.readouterr()
    resumed = render(scene, cam, 8, 8, spp=8, progress=True, **kw)
    assert "resuming at wave 5" in capsys.readouterr().err
    np.testing.assert_array_equal(resumed, full)
    assert os.listdir(d) == []


def test_checkpoint_rejects_edited_scene(tmp_path, capsys):
    """Same prim count, another material: the checkpoint must not blend."""
    def make(albedo):
        return build_scene([ob.Sphere((0, 0, -3), 1.0, ob.Lambertian(albedo))],
                           background=(0.7, 0.8, 0.9))

    cam = Camera.create((0, 0, 1), (0, 0, -3), (0, 1, 0), 60.0, 1.0, 0.0, 4.0)
    ck = str(tmp_path / "ck.npz")
    kw = dict(max_depth=3, seed=7, rays_per_wave=64, samples_per_wave=2,
              device="cpu")
    render(make((0.9, 0.1, 0.1)), cam, 8, 8, spp=8, checkpoint_path=ck,
           checkpoint_every=2, **kw)
    green = make((0.1, 0.9, 0.1))
    fresh = render(green, cam, 8, 8, spp=8, **kw)
    capsys.readouterr()
    np.testing.assert_array_equal(
        render(green, cam, 8, 8, spp=8, checkpoint_path=ck, **kw), fresh)
    assert "different render config; starting fresh" in \
        capsys.readouterr().err


def test_sampler_invalidates_checkpoint_tag():
    """A sobol render never resumes a uniform film: the fingerprint covers
    the sampler."""
    sc, cm = SCENES["cornell"].build(), SCENES["cornell"].camera(8, 8)
    fp = renderer._scene_fingerprint
    assert fp(sc, cm) != fp(sc, cm.replace(sampler="sobol"))
    assert fp(sc, cm) == fp(SCENES["cornell"].build(), cm)


def test_foreign_and_unreadable_checkpoints_start_fresh(tmp_path, capsys):
    """A file whose tag lacks the port's marker (the JAX package's tags
    start at the version) and a file that does not read both start a
    fresh render, said on stderr."""
    scene, cam = _two_spheres(8, 8)
    kw = dict(max_depth=3, seed=4, rays_per_wave=64, samples_per_wave=2,
              device="cpu")
    ck = str(tmp_path / "ck.npz")
    render(scene, cam, 8, 8, spp=8, checkpoint_path=ck, checkpoint_every=1,
           **kw)
    with np.load(ck) as f:
        tag, accum = str(f["config"]), f["accum"]
    assert tag.startswith(renderer.CKPT_MARK + ".v")
    fresh = render(scene, cam, 8, 8, spp=8, **kw)
    np.savez(ck, accum=accum * 0 + 7.0, waves_done=2,
             config=tag[len(renderer.CKPT_MARK) + 1:])
    capsys.readouterr()
    np.testing.assert_array_equal(
        render(scene, cam, 8, 8, spp=8, checkpoint_path=ck, **kw), fresh)
    assert "different render config" in capsys.readouterr().err
    with open(ck, "wb") as f:
        f.write(b"not a checkpoint")
    np.testing.assert_array_equal(
        render(scene, cam, 8, 8, spp=8, checkpoint_path=ck, **kw), fresh)
    assert "ignoring unreadable checkpoint" in capsys.readouterr().err


def test_clear_auto_checkpoints(home):
    d = renderer.checkpoint_dir()
    os.makedirs(d)
    for name in ("auto-aaa.npz", "auto-bbb.npz", "mine.npz"):
        open(os.path.join(d, name), "wb").close()
    renderer.clear_auto_checkpoints()
    assert os.listdir(d) == ["mine.npz"]
