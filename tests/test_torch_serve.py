"""The port's render server (``--serve``, tpu_ray_torch/utils/server.py):
tests/test_serve.py on the port.  The handler is tested in process on the
CPU (``RenderServer(device="cpu")``); the stdin/stdout protocol through
one subprocess."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_ray_torch import renderer
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.utils.server import RenderServer, serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def srv():
    return RenderServer(device="cpu")


def _pfm(path):
    raw = open(path, "rb").read()
    head, dims, _, body = raw.split(b"\n", 3)
    w, h = (int(v) for v in dims.split())
    return np.frombuffer(body, "<f4").reshape(h, w, 3)[::-1]


def test_ping_and_unknown_cmd(srv):
    assert srv.handle({"cmd": "ping", "id": 1}) == {
        "ok": True, "pong": True, "id": 1}
    r = srv.handle({"cmd": "explode"})
    assert r["ok"] is False and "explode" in r["error"]


def test_server_needs_a_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        RenderServer()


@pytest.mark.parametrize("bvh", [False, True])
def test_render_matches_direct_render(srv, tmp_path, bvh):
    """Server renders are the direct render's floats, bit for bit (.pfm
    keeps the linear radiance)."""
    out = str(tmp_path / "c.pfm")
    r = srv.handle({"scene": "cornell", "width": 12, "height": 10, "spp": 2,
                    "max_depth": 4, "bvh": bvh, "out": out, "id": "a"})
    assert r["ok"] is True, r
    assert r["id"] == "a" and r["out"] == out and r["wall_s"] >= 0
    assert (r["width"], r["height"]) == (12, 10)
    spec = SCENES["cornell"]
    img = renderer.render(spec.build(seed=1024), spec.camera(12, 10), 12, 10,
                          spp=2, max_depth=4, bvh=bvh, device="cpu")
    np.testing.assert_array_equal(_pfm(out), img)


def test_scene_cache_reused(srv, tmp_path):
    srv.handle({"scene": "two-spheres", "width": 8, "height": 6, "spp": 1,
                "max_depth": 2, "out": str(tmp_path / "x.png")})
    key = ("two-spheres", 1024, "fixed", None)
    before = srv._scenes[key]
    assert before.device.type == "cpu"
    srv.handle({"scene": "two-spheres", "width": 8, "height": 6, "spp": 1,
                "max_depth": 2, "out": str(tmp_path / "y.png")})
    assert srv._scenes[key] is before


def test_errors_never_raise(srv, tmp_path):
    r = srv.handle({"scene": "nope", "out": str(tmp_path / "n.png")})
    assert r["ok"] is False and "nope" in r["error"]
    r = srv.handle({"scene": "cornell"})
    assert r["ok"] is False and "out" in r["error"]
    r = srv.handle({"scene": "cornell", "out": str(tmp_path / "c.png"),
                    "bogus_key": 1})
    assert r["ok"] is False and "bogus_key" in r["error"]
    r = srv.handle({"scene": "cornell", "out": str(tmp_path / "c.png"),
                    "devices": -1})
    assert r["ok"] is False and "devices" in r["error"]


@pytest.mark.parametrize("mode,want", [("auto", "k_pool"), ("queue", "spp")])
def test_warm_renders_one_sample_per_pool_slot(monkeypatch, mode, want):
    """Warm renders spp = k_pool on the pool (the plan, kernels and tables
    of the full render) and the full request on the queue."""
    captured = {}
    real = renderer.render

    def spy(scene, camera, w, h, **kw):
        captured["spp"] = kw.get("spp")
        return real(scene, camera, w, h, **kw)

    monkeypatch.setattr(renderer, "render", spy)
    s = RenderServer(device="cpu")
    scene = SCENES["two-spheres"].build(seed=1024)
    k_pool = renderer.plan_pool(scene, 64, 48, 1000)[0]
    assert k_pool > 1
    spp = 1000 if mode == "auto" else 3
    r = s.handle({"cmd": "warm", "scene": "two-spheres", "width": 64,
                  "height": 48, "spp": spp, "max_depth": 2, "mode": mode})
    assert r["ok"] is True and r["warmed"] is True and "out" not in r, r
    assert captured["spp"] == (k_pool if want == "k_pool" else spp)


def test_stats_reports_cached_scenes_counters_and_kernels(tmp_path):
    s = RenderServer(device="cpu")
    r = s.handle({"cmd": "stats"})
    assert r["ok"] and r["renders"] == 0 and r["cached_scenes"] == []
    assert set(r["kernels"]) == {"loaded", "build_seconds"}
    s.handle({"scene": "two-spheres", "width": 8, "height": 6, "spp": 1,
              "max_depth": 2, "out": str(tmp_path / "s.png")})
    s.handle({"cmd": "warm", "scene": "two-spheres", "width": 8, "height": 6,
              "spp": 1, "max_depth": 2})
    r = s.handle({"cmd": "stats"})
    assert r["renders"] == 1 and r["warms"] == 1
    assert ["two-spheres", 1024, "fixed", None] in r["cached_scenes"]
    assert r["kernels"]["loaded"] == []      # the CPU runs no kernel


def test_denoise_request_equals_the_cli_composition(srv, tmp_path):
    from tpu_ray_torch.aov import render_aovs
    from tpu_ray_torch.denoise import denoise

    raw, den = str(tmp_path / "r.pfm"), str(tmp_path / "d.pfm")
    kw = {"scene": "cornell", "width": 14, "height": 12, "spp": 4,
          "max_depth": 4}
    r1 = srv.handle(dict(kw, out=raw))
    r2 = srv.handle(dict(kw, out=den, denoise=True, denoise_radius=2))
    assert r1["ok"] and r2["ok"], (r1, r2)
    assert r2.get("denoised") is True and "denoised" not in r1
    spec = SCENES["cornell"]
    scene, cam = spec.build(seed=1024), spec.camera(14, 12)
    aovs = render_aovs(scene, cam, 14, 12, spp=4, seed=1024, device="cpu")
    want = denoise(_pfm(raw).copy(), aovs["albedo"], aovs["normal"],
                   aovs["depth"], radius=2, device="cpu").numpy()
    np.testing.assert_array_equal(_pfm(den), want)
    assert np.abs(_pfm(raw) - _pfm(den)).max() > 0


def test_serve_loop_in_process(tmp_path):
    from io import StringIO

    out = str(tmp_path / "a.png")
    reqs = "\n".join([json.dumps({"cmd": "ping", "id": 0}),
                      "not json at all", "[1, 2]",
                      json.dumps({"scene": "two-spheres", "width": 8,
                                  "height": 6, "spp": 1, "max_depth": 2,
                                  "out": out, "id": 1}),
                      json.dumps({"cmd": "quit", "id": 2}),
                      json.dumps({"cmd": "ping", "id": 3})]) + "\n"
    sink = StringIO()
    assert serve(StringIO(reqs), sink, device="cpu") == 0
    lines = [json.loads(ln) for ln in sink.getvalue().splitlines()]
    assert lines[0] == {"ok": True, "ready": True}
    assert lines[1] == {"ok": True, "pong": True, "id": 0}
    assert [ln["ok"] for ln in lines[2:4]] == [False, False]
    assert all("bad request" in ln["error"] for ln in lines[2:4])
    assert lines[4]["ok"] and lines[4]["id"] == 1 and os.path.exists(out)
    assert lines[5] == {"ok": True, "quit": True, "id": 2}
    assert len(lines) == 6        # nothing answered after quit


def test_subprocess_protocol(tmp_path):
    out1, out2 = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    req = {"scene": "two-spheres", "width": 12, "height": 8, "spp": 2,
           "max_depth": 3}
    reqs = "\n".join(json.dumps(r) for r in [
        {"cmd": "ping", "id": 0}, dict(req, out=out1, id=1),
        dict(req, out=out2, id=2), {"cmd": "quit", "id": 3},
    ]) + "\n"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch", "--device", "cpu", "--serve"],
        input=reqs, capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    assert lines[0] == {"ok": True, "ready": True}
    by_id = {ln.get("id"): ln for ln in lines[1:]}
    assert by_id[0]["pong"] is True and by_id[3]["quit"] is True
    assert by_id[1]["ok"] and by_id[2]["ok"]
    np.testing.assert_array_equal(_pfm(out1), _pfm(out2))
    assert "[serve] ready" in r.stderr
