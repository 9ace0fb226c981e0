"""The work-queue integrator: tpu_ray_torch.integrator.trace_queue against
tpu_ray.integrator.trace_queue (fused and XLA shading; queue with queue,
its streams differ from the pool's) under the cross-engine criterion, and
the schedule invariance the queue is built around, exact."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import cross_engine, jax_scene_arrays

from tpu_ray import integrator as jinteg
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.renderer import render as jrender
from tpu_ray_torch import integrator, renderer
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera
from tpu_ray_torch.integrator import SceneKernels, trace_queue
from tpu_ray_torch.models import objects as ob
from tpu_ray_torch.models.compile import build_scene
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import shade
from tpu_ray_torch.ops import sweep as sw
from tpu_ray_torch.renderer import plan_queue, render, resolve_mode

JKEY = jax.random.fold_in(jax.random.PRNGKey(3), 0x5EED)
KEY = rng.fold_in(rng.prng_key(3), 0x5EED)


def _jax_queue(js, name, w, h, spp, s0, depth, shade_, R, rr_depth=0):
    out = jinteg.trace_queue(
        js, JSCENES[name].camera(w, h), w, h, spp, s0, JKEY, depth, R=R,
        engine="xla", shade=shade_, cam_salt=jnp.uint32(3), epoch_iters=16,
        rr_depth=rr_depth)
    return np.asarray(out).reshape(h, w, 3)


def _port_queue(ps, name, w, h, spp, s0, depth, R, sort=False, **kw):
    kw.setdefault("cam_salt", 3)
    kw["kern"] = SceneKernels.create(ps, sort)
    out = trace_queue(ps, SCENES[name].camera(w, h), w, h, spp, s0, KEY,
                      depth, R, **kw)
    return out.numpy().reshape(h, w, 3)


@pytest.mark.parametrize("name,shade_,rr_depth", [
    ("cornell", "fused", 0), ("cornell", "xla", 2),
    ("cornell-smoke", "fused", 0), ("book1-final", "xla", 0)])
def test_queue_matches_jax_queue(name, shade_, rr_depth):
    """A 4-sample chunk that starts at global sample 2, on a pool smaller
    than the chunk, against the JAX queue with either shading."""
    w, h, spp, depth = 12, 12, 4, 6
    js = JSCENES[name].build(seed=1024, earth=None)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    a = _jax_queue(js, name, w, h, spp, 2, depth, shade_, 200, rr_depth)
    steps = shade.pool_step_plain.calls
    b = _port_queue(ps, name, w, h, spp, 2, depth, 200, epoch_iters=5,
                    drain_levels=(64,), rr_depth=rr_depth)
    assert shade.pool_step_plain.calls > steps
    cross_engine(a, b)


def test_queue_next_week_final_matches_jax_queue():
    """The queue's headline scene (1409 prims, JAX-built on the CPU), with
    a seeded image on its earth sphere, against the JAX queue's XLA
    shading (its fused kernel is too slow under the interpreter)."""
    w, h, spp, depth = 24, 24, 2, 6
    img = np.random.default_rng(3).integers(0, 256, (16, 32, 3), np.uint8)
    js = JSCENES["next-week-final"].build(seed=1024, earth=img)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    assert ps.n_prims == 1409 and ps.has_image
    a = _jax_queue(js, "next-week-final", w, h, spp, 0, depth, "xla", 600)
    b = _port_queue(ps, "next-week-final", w, h, spp, 0, depth, 600)
    cross_engine(a, b)
    c = _port_queue(ps, "next-week-final", w, h, spp, 0, depth, 400,
                    epoch_iters=3, sort=True)
    np.testing.assert_array_equal(b, c)


SCHEDULES = {
    "more-lanes-short-epochs-ladder": dict(R=512, epoch_iters=3,
                                           drain_levels=(64, 16)),
    "odd-lanes-long-epochs": dict(R=300, epoch_iters=17),
    "one-lane-per-item": dict(R=12 * 12 * 8, epoch_iters=1),
    "sorted-sweep": dict(R=144, epoch_iters=64, sort=True),
    "sorted-sweep-ladder": dict(R=333, epoch_iters=2, drain_levels=(100,),
                                sort=True),
}


@pytest.fixture(scope="module")
def base_image():
    ps = SCENES["cornell"].build()
    return ps, _port_queue(ps, "cornell", 12, 12, 8, 0, 12, 144,
                           epoch_iters=64, rr_depth=3)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_queue_schedule_invariance_exact(base_image, schedule):
    """Lane count, epoch length, drain ladder and the sweep's variant are
    all bit-invisible."""
    ps, base = base_image
    kw = dict(SCHEDULES[schedule])
    img = _port_queue(ps, "cornell", 12, 12, 8, 0, 12, kw.pop("R"),
                      rr_depth=3, **kw)
    np.testing.assert_array_equal(base, img)


def test_queue_sample_chunking(base_image):
    """Chunks partition the work space: the per-sample radiances are the
    same, only the final sum's association differs."""
    ps, _ = base_image
    run = lambda spp, s0: _port_queue(ps, "cornell", 12, 12, spp, s0, 12, 300,
                                      epoch_iters=17)
    np.testing.assert_allclose(run(4, 0) + run(4, 4), run(8, 0), rtol=1e-5,
                               atol=1e-7)


def _plane_scene(albedo=(0.5, 0.25, 0.125)):
    return build_scene(
        [ob.Rect("xz", -1e5, 1e5, -1e5, 1e5, 0.0, ob.Lambertian(albedo))],
        background=(1.0, 1.0, 1.0))


def _down_camera():
    return Camera.create((0, 5, 0), (0, 0, 0), (1, 0, 0), 60.0, 1.0, 0.0, 5.0)


def test_queue_furnace_exact():
    """Every sample of the albedo-a plane under a white background is
    exactly a: each work item is traced and flushed exactly once."""
    img = render(_plane_scene(), _down_camera(), 8, 8, spp=16, max_depth=8,
                 seed=1, mode="queue", device="cpu")
    np.testing.assert_allclose(
        img, np.broadcast_to([0.5, 0.25, 0.125], img.shape), rtol=1e-5)


@pytest.mark.parametrize("depth,value", [(0, 0.0), (1, 0.0), (2, 0.9)])
def test_queue_depth_semantics(depth, value):
    img = render(_plane_scene((0.9, 0.9, 0.9)), _down_camera(), 8, 8, spp=4,
                 seed=2, mode="queue", max_depth=depth, device="cpu")
    np.testing.assert_allclose(img, value, rtol=1e-5, atol=1e-7)


def test_queue_render_matches_jax_queue_render(monkeypatch):
    """render(mode="queue") end to end: key fold_in(PRNGKey(seed), 0x5EED),
    cam_salt = seed, two sample chunks (a small plane budget)."""
    monkeypatch.setattr(renderer, "QUEUE_PLANE_BYTES", 16 * 12 * 12 * 4)
    ps = SCENES["cornell"].build()
    assert plan_queue(ps, 16, 12, 8)[1] == 4
    kw = dict(spp=8, max_depth=6, seed=13, mode="queue")
    a = np.asarray(jrender(JSCENES["cornell"].build(),
                           JSCENES["cornell"].camera(16, 12), 16, 12, **kw))
    steps = shade.pool_step_plain.calls
    b = render(ps, SCENES["cornell"].camera(16, 12), 16, 12, device="cpu",
               **kw)
    cross_engine(a, b)
    assert shade.pool_step_plain.calls > steps


def test_plan_queue_and_resolve_mode(capsys):
    big = SCENES["next-week-final"].build(earth=None)
    small = SCENES["cornell"].build()
    assert resolve_mode(big) == "queue" and resolve_mode(small) == "pool"
    assert resolve_mode(small, "queue") == "queue"
    assert resolve_mode(small, "wave") == "wave"
    assert capsys.readouterr().err == ""
    assert resolve_mode(big, "pool") == "pool"      # the JAX package's
    assert capsys.readouterr().err == ""
    with pytest.raises(ValueError):
        resolve_mode(small, "mega")
    R, chunk_spp, epoch_iters, levels = plan_queue(big, 400, 400, 100)
    assert (R, chunk_spp) == (1 << 20, 100) and epoch_iters >= 1
    assert levels == (524288, 131072, 32768, 8192)
    assert plan_queue(small, 8, 8, 4)[0] == 1024       # at least 1024 lanes
    assert plan_queue(small, 8, 8, 4)[3] == ()


def test_queue_worklist_padding_is_never_dispatched(monkeypatch):
    """A worklist padded past ``n_work`` with entries of pixel 0, sample 0:
    the padding columns of the plane stay zero (no padding item is ever
    dispatched), and the sums are the unpadded list's, bit for bit."""
    P, n_work, n_pad = 64, 128, 40
    w = np.arange(n_work, dtype=np.int64)
    wl = torch.from_numpy(np.concatenate(
        [((w % P) << integrator.WL_SAMP_BITS) | (w // P),
         np.zeros(n_pad, np.int64)]))
    planes = []
    planar = integrator.worklist_sums

    def keep_plane(plane, worklist, P):
        planes.append(plane.clone())
        return planar(plane, worklist, P)

    monkeypatch.setattr(integrator, "worklist_sums", keep_plane)
    ps = SCENES["cornell"].build()
    run = lambda wl, n: trace_queue(ps, SCENES["cornell"].camera(8, 8), 8, 8,
                                    0, 0, KEY, 4, 48, epoch_iters=3,
                                    worklist=wl, n_work=n)
    padded, exact = run(wl, n_work), run(wl[:n_work], None)
    assert planes[0].shape == (3, n_work + n_pad + 1)
    assert not planes[0][:, n_work:n_work + n_pad].any()
    assert planes[0][:, :n_work].any()
    for a, b in zip(padded, exact):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_sorted_queue_runs_the_compacted_sweep():
    ps = SCENES["book1-final"].build(seed=1024)
    before = sw.sweep_compact_plain.calls, sw.sweep_plain.calls
    _port_queue(ps, "book1-final", 8, 8, 1, 0, 4, 64, sort=True)
    assert sw.sweep_compact_plain.calls > before[0]
    assert sw.sweep_plain.calls == before[1]


@pytest.mark.parametrize("scene,mode", [("next-week-final", "auto"),
                                        ("cornell", "wave")])
def test_cli_renders_queue_and_wave_modes_on_the_cpu(tmp_path, scene, mode):
    """next-week-final goes to the queue by itself (1409 prims)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "img.pfm")
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch", "--scene", scene, "--device",
         "cpu", "--mode", mode, "--width", "32", "--height", "32", "--spp",
         "4", "--max-depth", "6", "--out", out], cwd=root,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "Done." in r.stderr
    assert ("Rendering 100.0%" in r.stderr) == (mode == "auto")
    with open(out, "rb") as f:
        assert f.readline() == b"PF\n" and f.readline() == b"32 32\n"
        f.readline()
        img = np.frombuffer(f.read(), np.float32)
    assert img.size == 32 * 32 * 3 and np.isfinite(img).all() and img.mean() > 0.01
