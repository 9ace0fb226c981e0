"""The port's command line: the flags it shares with the JAX CLI parse with
the JAX CLI's defaults and choices and reach ``render()`` (a stand-in
records the call; ``--adaptive`` too), and a tiny CPU render through
``--sampler sobol --estimator reference`` writes a well-formed PPM."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_ray.utils.cli import build_parser as jax_parser
from tpu_ray_torch import renderer
from tpu_ray_torch.utils import assets, cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("earthmap", "rays_per_wave", "samples_per_wave", "estimator",
          "sampler", "scene", "width", "height", "spp", "max_depth", "seed",
          "out", "rr_depth", "mode", "engine", "adaptive")


def test_shared_flags_have_the_jax_defaults_and_choices():
    ours = {a.dest: a for a in cli.build_parser()._actions}
    theirs = {a.dest: a for a in jax_parser()._actions}
    for dest in SHARED:
        assert ours[dest].default == theirs[dest].default, dest
        assert ours[dest].choices == theirs[dest].choices, dest
        assert ours[dest].type == theirs[dest].type, dest


@pytest.fixture
def calls(monkeypatch):
    """Stand-ins for the earth loader and ``render``: record what the CLI
    passes them, return a black image."""
    seen = {}

    def fake_render(scene, camera, width, height, spp, **kw):
        seen.update(scene=scene, camera=camera, size=(width, height),
                    spp=spp, **kw)
        return np.zeros((height, width, 3), np.float32)

    def fake_earth(path=None):
        seen["earthmap"] = path
        return None

    monkeypatch.setattr(renderer, "render", fake_render)
    monkeypatch.setattr(assets, "load_earth_image", fake_earth)
    return seen


def test_new_flags_reach_render(calls, tmp_path):
    out = str(tmp_path / "x.ppm")
    rc = cli.main(["--device", "cpu", "--scene", "cornell", "--width", "6",
                   "--height", "4", "--spp", "2", "--max-depth", "3",
                   "--earthmap", "maps/earth.jpg", "--rays-per-wave", "4096",
                   "--samples-per-wave", "2", "--estimator", "reference",
                   "--sampler", "sobol-b0", "--out", out])
    assert rc == 0 and os.path.exists(out)
    assert calls["earthmap"] == "maps/earth.jpg"
    assert calls["rays_per_wave"] == 4096 and calls["samples_per_wave"] == 2
    assert calls["scene"].strict and calls["camera"].sampler == "sobol-b0"
    assert calls["size"] == (6, 4) and calls["spp"] == 2


def test_defaults_reach_render(calls, tmp_path):
    rc = cli.main(["--device", "cpu", "--width", "6", "--height", "4",
                   "--spp", "2", "--out", str(tmp_path / "y.ppm")])
    assert rc == 0 and calls["earthmap"] is None
    assert calls["rays_per_wave"] == 1 << 20
    assert calls["samples_per_wave"] == 64
    assert not calls["scene"].strict and calls["camera"].sampler == "uniform"


@pytest.mark.parametrize("argv,tol", [([], 0.0),
                                      (["--adaptive", "0.05"], 0.05)])
def test_adaptive_flag_reaches_render(calls, tmp_path, argv, tol):
    rc = cli.main(["--device", "cpu", "--width", "6", "--height", "4",
                   "--spp", "32", "--out", str(tmp_path / "a.ppm")] + argv)
    assert rc == 0 and calls["adaptive"] == tol and calls["spp"] == 32


@pytest.mark.parametrize("flag,value", [("--estimator", "exact"),
                                        ("--sampler", "halton")])
def test_unknown_choices_are_refused(flag, value):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args([flag, value])


def test_cli_renders_sobol_strict_ppm():
    """``python -m tpu_ray_torch`` end to end on the CPU: P3 header and
    w*h*3 + 4 words."""
    w, h = 8, 6
    out = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch", "--device", "cpu", "--scene",
         "cornell-smoke", "--width", str(w), "--height", str(h), "--spp", "2",
         "--max-depth", "4", "--sampler", "sobol", "--estimator",
         "reference"], cwd=ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    words = out.stdout.split()
    assert words[:4] == ["P3", str(w), str(h), "255"]
    assert len(words) == w * h * 3 + 4
    assert "Done." in out.stderr


RENDER_FLAGS = ("devices", "checkpoint", "checkpoint_every", "bvh", "progressive",
          "profile", "serve", "supervise")


def test_render_flags_have_the_jax_defaults():
    ours = {a.dest: a for a in cli.build_parser()._actions}
    theirs = {a.dest: a for a in jax_parser()._actions}
    for dest in RENDER_FLAGS:
        assert ours[dest].default == theirs[dest].default, dest
        assert ours[dest].type == theirs[dest].type, dest
        assert ours[dest].option_strings == theirs[dest].option_strings


def test_render_flags_reach_render(calls, tmp_path):
    rc = cli.main(["--device", "cpu", "--width", "6", "--height", "4",
                   "--spp", "2", "--bvh", "--checkpoint", "ck.npz",
                   "--checkpoint-every", "3", "--progressive", "--out",
                   str(tmp_path / "p.png")])
    assert rc == 0 and calls["bvh"] is True
    assert calls["checkpoint_path"] == "ck.npz"
    assert calls["checkpoint_every"] == 3
    assert callable(calls["on_partial"])
    rc = cli.main(["--device", "cpu", "--width", "6", "--height", "4",
                   "--spp", "2", "--out", str(tmp_path / "q.png")])
    assert rc == 0 and calls["bvh"] is False and calls["on_partial"] is None
    assert calls["checkpoint_path"] is None and calls["checkpoint_every"] == 0


def test_devices_is_refused(capsys, monkeypatch):
    """--devices N is refused (exit code 2) where N cards are not present;
    tests/test_torch_mesh.py renders it on cpu entries."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["--devices", "2"]) == 2
    assert "2 CUDA devices asked for, 1 present" in capsys.readouterr().err


def test_bvh_flag_renders_the_bvh_image(capsys):
    from tpu_ray_torch.core import film
    from tpu_ray_torch.models.scenes import SCENES

    assert cli.main(["--device", "cpu", "--scene", "cornell", "--width", "8",
                     "--height", "6", "--spp", "2", "--max-depth", "3",
                     "--bvh"]) == 0
    spec = SCENES["cornell"]
    img = renderer.render(spec.build(seed=1024), spec.camera(8, 6), 8, 6,
                          spp=2, max_depth=3, seed=1024, bvh=True,
                          device="cpu")
    assert capsys.readouterr().out == film.ppm_string(film.to_rgb8(img))


def test_aov_names_the_render_flags_it_ignores(capsys, tmp_path):
    assert cli.main(["--device", "cpu", "--width", "6", "--height", "4",
                     "--spp", "1", "--aov", "albedo", "--bvh",
                     "--checkpoint", "ck.npz", "--checkpoint-every", "2",
                     "--out", str(tmp_path / "a.png")]) == 0
    assert ("[aov] ignoring --bvh, --checkpoint, --checkpoint-every"
            in capsys.readouterr().err)


def test_profile_writes_a_trace(tmp_path, capsys):
    import json

    d = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "--scene", "two-spheres", "--width",
                     "4", "--height", "4", "--spp", "1", "--max-depth", "1",
                     "--profile", str(d)]) == 0
    with open(d / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert "profiler trace written to" in capsys.readouterr().err


SUPERVISED = ["--device", "cpu", "--scene", "cornell", "--width", "12",
              "--height", "8", "--spp", "8", "--max-depth", "3",
              "--samples-per-wave", "2", "--rays-per-wave", "96"]


def _supervise(argv, crash_after, tmp_path):
    env = dict(os.environ, TPU_RAY_CRASH_AFTER_WAVE=str(crash_after),
               HOME=str(tmp_path / "home"))
    return subprocess.run([sys.executable, "-m", "tpu_ray_torch"] + argv,
                          cwd=ROOT, capture_output=True, text=True, env=env,
                          timeout=300)


def test_supervise_recovers_from_a_crash(tmp_path, capsys):
    """The first child dies before wave 2 after checkpointing waves 0-1;
    the retry resumes there: stdout is the clean run's, byte for byte."""
    assert cli.main(SUPERVISED) == 0
    clean = capsys.readouterr().out
    r = _supervise(SUPERVISED + ["--supervise", "2", "--checkpoint",
                                 str(tmp_path / "ck"), "--checkpoint-every",
                                 "1"], 2, tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout == clean
    assert "injected crash before wave 2" in r.stderr
    assert "[supervise] retry 1/2" in r.stderr
    assert "resuming at wave 2" in r.stderr
    assert "retry 2/2" not in r.stderr


def test_supervise_gives_up(tmp_path):
    """A crash before the first wave leaves nothing to resume: every
    attempt dies, and the supervisor gives up with exit code 1."""
    r = _supervise(SUPERVISED + ["--supervise=1"], 0, tmp_path)
    assert r.returncode == 1 and r.stdout == ""
    assert "[supervise] retry 1/1" in r.stderr
    assert "[supervise] giving up after 2 attempts" in r.stderr
