"""Device meshes on the port (tpu_ray_torch.parallel.mesh, render(mesh=),
render_adaptive(mesh=), --devices, the server's devices) against the JAX
package's mesh renders on its 8 host devices (tests/conftest.py) and
against the port's own single-device renders.

Every draw is keyed by global wave, slot, sample or work-item ids, so a
mesh render is the single-device render up to the f32 order of the sum
over devices: the port's mesh renders are held to its single-device
renders at the JAX mesh tests' tolerances (tests/test_queue.py:208, :221,
tests/test_megakernel.py:119) and to the JAX mesh renders at the
cross-engine criterion (tests/test_shade_pallas.py:109-113).  The meshes
here are of ``cpu`` entries; the card runs the same code under
``chip_smoke.py``.  Each JAX mesh render is made once, in a module
fixture."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch_port_common import cross_engine

from tpu_ray.adaptive import render_adaptive as jrender_adaptive
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.parallel.mesh import make_mesh as jmake_mesh
from tpu_ray.renderer import render as jrender
from tpu_ray_torch import renderer
from tpu_ray_torch.adaptive import jax_queue_lanes, mesh_pad, render_adaptive
from tpu_ray_torch.core import film
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.parallel import mesh as mesh_mod
from tpu_ray_torch.parallel.mesh import make_mesh
from tpu_ray_torch.renderer import render, resolve_mode
from tpu_ray_torch.utils import cli
from tpu_ray_torch.utils.server import RenderServer

CRASH = "TPU_RAY_CRASH_AFTER_WAVE"
# cornell 16x16, one slot a pixel, 2 samples a wave: 12 spp are 6 waves,
# so a 4-device mesh renders 2 rounds, the second with 2 padded waves
POOL = dict(spp=12, max_depth=6, seed=5, rays_per_wave=256,
            samples_per_wave=2)
# wave mode, one sample a wave: 6 waves over 4 devices, as above
WAVE = dict(spp=6, max_depth=6, seed=7, rays_per_wave=256, mode="wave")
# the queue, its film plane budget cut to one sample a device: 10 spp on 4
# devices are two sharded chunks of 4 samples and a 2-sample chunk on one
QUEUE = dict(spp=10, max_depth=6, seed=13, mode="queue")
# adaptive: cornell 40x32 pilots 20480 items, which the 4-device pad rule
# at 1024 lanes (65536 a round, 16384 a device) spreads over two devices
ADAPTIVE = dict(spp_max=64, tol=0.05, max_depth=6, seed=4, return_spp=True,
                rays_per_wave=1024)


def _cornell(w=16, h=16):
    return SCENES["cornell"].build(seed=1024), SCENES["cornell"].camera(w, h)


def _jcornell(w=16, h=16):
    return JSCENES["cornell"].build(seed=1024), JSCENES["cornell"].camera(w,
                                                                          h)


@pytest.fixture(autouse=True)
def home(tmp_path, monkeypatch):
    """A HOME of its own (auto checkpoints), and no crash injection."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv(CRASH, raising=False)


@pytest.fixture(scope="module")
def pool_jax():
    return np.asarray(jrender(*_jcornell(), 16, 16, mesh=jmake_mesh(4),
                              **POOL))


@pytest.fixture(scope="module")
def mega_jax():
    return np.asarray(jrender(*_jcornell(), 16, 16, mesh=jmake_mesh(4),
                              engine="mega", **POOL))


@pytest.fixture(scope="module")
def wave_jax():
    return np.asarray(jrender(*_jcornell(), 16, 16, mesh=jmake_mesh(4),
                              **WAVE))


@pytest.fixture(scope="module")
def queue_jax():
    import tpu_ray.renderer as jr

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "QUEUE_PLANE_BYTES", 10 * 10 * 12)
        return np.asarray(jrender(*_jcornell(10, 10), 10, 10,
                                  mesh=jmake_mesh(4), **QUEUE))


@pytest.fixture(scope="module")
def adaptive_jax():
    img, n = jrender_adaptive(*_jcornell(40, 32), 40, 32, mesh=jmake_mesh(4),
                              **ADAPTIVE)
    return np.asarray(img), np.asarray(n)


@pytest.mark.parametrize("what", ["pool", "mega", "wave"])
def test_rounds_match_jax_mesh_and_single_device(what, request):
    """Pool, megakernel and wave rounds on a 4-device mesh, the last round
    padded: the JAX mesh render at the cross-engine criterion, the port's
    single-device render at rtol 1e-4 / atol 1e-5."""
    kw = dict(WAVE) if what == "wave" else dict(POOL)
    if what == "mega":
        kw["engine"] = "mega"
    img = render(*_cornell(), 16, 16, mesh=make_mesh(4, "cpu"), **kw)
    one = render(*_cornell(), 16, 16, device="cpu", **kw)
    assert np.isfinite(img).all() and img.mean() > 0.05
    np.testing.assert_allclose(img, one, rtol=1e-4, atol=1e-5)
    cross_engine(request.getfixturevalue(f"{what}_jax"), img)


def test_queue_mesh_chunks_and_remainder(queue_jax, monkeypatch):
    """Two sharded chunks and a remainder chunk on mesh[0]: the JAX meshed
    queue at the cross-engine criterion, the single-device queue at the
    JAX test's rtol 1e-4 / atol 1e-5, and each sharded chunk through
    trace_queue_mesh."""
    from tpu_ray_torch import integrator

    monkeypatch.setattr(renderer, "QUEUE_PLANE_BYTES", 10 * 10 * 12)
    seen = []
    orig = integrator.trace_queue_mesh

    def spy(scenes, camera, w, h, chunk_spp, chunk_s0, *a, **kw):
        seen.append((chunk_spp, chunk_s0))
        return orig(scenes, camera, w, h, chunk_spp, chunk_s0, *a, **kw)

    monkeypatch.setattr(renderer, "trace_queue_mesh", spy)
    img = render(*_cornell(10, 10), 10, 10, mesh=make_mesh(4, "cpu"),
                 **QUEUE)
    assert seen == [(4, 0), (4, 4)]
    one = render(*_cornell(10, 10), 10, 10, device="cpu", **QUEUE)
    np.testing.assert_allclose(img, one, rtol=1e-4, atol=1e-5)
    cross_engine(queue_jax, img)


def test_adaptive_mesh_counts_equal_jax(adaptive_jax, monkeypatch):
    """render_adaptive(mesh=): the per-pixel sample counts equal the JAX
    mesh render's exactly, the image meets the cross-engine criterion, and
    both equal the port's single-device queue backend (counts exactly,
    image at rtol 1e-4 / atol 1e-5); render(adaptive=, mesh=) routes
    there."""
    from tpu_ray_torch import integrator

    scene, cam = _cornell(40, 32)
    mesh = make_mesh(4, "cpu")
    shares = []
    orig = integrator.trace_queue

    def spy(*a, n_work=None, **kw):
        shares.append(n_work)
        return orig(*a, n_work=n_work, **kw)

    monkeypatch.setattr(integrator, "trace_queue", spy)
    img, n = render_adaptive(scene, cam, 40, 32, mesh=mesh, **ADAPTIVE)
    monkeypatch.undo()
    assert shares[:4] == [16384, 4096, 0, 0]     # the pilot round
    jimg, jn = adaptive_jax
    np.testing.assert_array_equal(n, jn)
    assert n.min() < n.max()
    cross_engine(jimg, img)
    one, n1 = render_adaptive(scene, cam, 40, 32, mode="queue", device="cpu",
                              **ADAPTIVE)
    np.testing.assert_array_equal(n1, n)
    np.testing.assert_allclose(img, one, rtol=1e-4, atol=1e-5)
    via = render(scene, cam, 40, 32, spp=64, adaptive=0.05, max_depth=6,
                 seed=4, rays_per_wave=1024, mesh=mesh)
    np.testing.assert_array_equal(via, img)


def test_adaptive_pad_rule_is_jax():
    """mesh_pad and the lane count it reads are tpu_ray/adaptive.py:248-265
    and tpu_ray/renderer.py:187-205, case by case."""
    import tpu_ray.renderer as jr

    from tpu_ray.adaptive import PAD_LADDER, WL_QUANT

    nw = SCENES["next-week-final"].build(earth=None)
    jnw = JSCENES["next-week-final"].build(earth=None)
    for (sc, js) in ((_cornell()[0], _jcornell()[0]), (nw, jnw)):
        for engine in ("xla", "mxu", "pallas"):
            for P, spp, rpw in ((1600, 64, 1 << 20), (250000, 992, 1 << 20),
                                (80, 64, 4096)):
                want = jr.plan_queue(js, 1, P, spp, rpw, engine)[0]
                assert jax_queue_lanes(sc.n_prims, P, spp, rpw,
                                       engine) == want
    for n_work in (0, 1, 1280, 20480, 70000, 5_000_000, 100_000_000):
        for R in (1024, 160000, 1 << 20):
            for D in (1, 2, 3, 4, 8):
                unit = D * WL_QUANT
                floor = max(n_work, R * D, unit)
                pad = next((p for p in PAD_LADDER if p >= floor),
                           -(-floor // WL_QUANT) * WL_QUANT)
                assert mesh_pad(n_work, R, D) == -(-pad // unit) * unit


def test_resume_per_round_is_bit_equal(tmp_path, monkeypatch, capsys):
    """A crash injected before round 2 and a resume from the per-round
    checkpoint give the uninterrupted mesh render bit for bit; the tag
    carries D, so a 2-device checkpoint does not resume a 4-device
    render."""
    scene, cam = _cornell()
    mesh2 = make_mesh(2, "cpu")
    full = render(scene, cam, 16, 16, mesh=mesh2, **POOL)
    ck = str(tmp_path / "ck.npz")
    monkeypatch.setenv(CRASH, "2")
    with pytest.raises(RuntimeError, match="injected crash before round 2"):
        render(scene, cam, 16, 16, mesh=mesh2, checkpoint_path=ck,
               checkpoint_every=1, **POOL)
    capsys.readouterr()
    img = render(scene, cam, 16, 16, mesh=mesh2, checkpoint_path=ck,
                 progress=True, **POOL)
    assert "resuming at round 2" in capsys.readouterr().err
    np.testing.assert_array_equal(img, full)
    monkeypatch.delenv(CRASH)
    mesh4 = make_mesh(4, "cpu")
    img4 = render(scene, cam, 16, 16, mesh=mesh4, checkpoint_path=ck,
                  **POOL)
    assert "different render config" in capsys.readouterr().err
    np.testing.assert_array_equal(
        img4, render(scene, cam, 16, 16, mesh=mesh4, **POOL))


def test_resolve_mode_mesh_demotions(capsys):
    """A queue request with spp unknown or below D goes to the pool (said
    on stderr), above 512 prims too, as in the JAX package, and renders as
    the single-device pool does."""
    small = _cornell()[0]
    mesh = make_mesh(4, "cpu")
    assert resolve_mode(small, "queue", mesh=mesh, spp=2) == "pool"
    assert ("demoting mode=queue to the wave pool: sharding the work queue "
            "needs spp >= the 4-device mesh (got 2)") in \
        capsys.readouterr().err
    assert resolve_mode(small, "queue", mesh=mesh) == "pool"
    assert "(got None)" in capsys.readouterr().err
    assert resolve_mode(small, "queue", mesh=mesh, spp=4) == "queue"
    assert resolve_mode(small, "auto", mesh=mesh, spp=2) == "pool"
    assert capsys.readouterr().err == ""
    assert resolve_mode(small, "queue", "mega", mesh=mesh, spp=2) == "pool"
    assert "megakernel" in capsys.readouterr().err
    big = SCENES["next-week-final"].build(earth=None)
    assert resolve_mode(big, "auto", mesh=mesh, spp=2) == "pool"
    assert ("demoting mode=queue to the wave pool: sharding the work queue "
            "needs spp >= the 4-device mesh (got 2)") in \
        capsys.readouterr().err
    cam = SCENES["next-week-final"].camera(8, 6)
    kw = dict(spp=1, max_depth=2, seed=3)
    np.testing.assert_array_equal(
        render(big, cam, 8, 6, mesh=make_mesh(2, "cpu"), **kw),
        render(big, cam, 8, 6, device="cpu", mode="pool", **kw))


def test_each_share_runs_under_its_device_guard(monkeypatch):
    """The mesh loops make each device current around its share (the
    kernels launch on the runtime's current device): a recording stand-in
    for device_guard sees every wave of every round, and every queue
    sub-chunk, inside the guard of its device, in mesh order."""
    events, inside = [], []

    @contextlib.contextmanager
    def guard(dev):
        inside.append(dev)
        try:
            yield
        finally:
            inside.pop()

    def wraps(name, mod):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            events.append((name, inside[-1] if inside else None))
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    from tpu_ray_torch import integrator

    monkeypatch.setattr(mesh_mod, "device_guard", guard)
    wraps("trace_pool_staged", renderer)
    wraps("trace_queue", integrator)
    wraps("trace_queue", renderer)
    mesh = make_mesh(3, "cpu")
    render(*_cornell(8, 8), 8, 8, mesh=mesh, spp=8, max_depth=3,
           rays_per_wave=64, samples_per_wave=2)
    assert events == [("trace_pool_staged", mesh[0])] * 4
    events.clear()
    render(*_cornell(8, 8), 8, 8, mesh=mesh, spp=7, max_depth=3,
           mode="queue")
    # a 6-sample chunk, two samples a device, then one sample on mesh[0]
    assert events == [("trace_queue", mesh[0])] * 4


def test_cli_devices_and_server_devices_render_the_mesh_image(tmp_path):
    """``--devices 2 --device cpu`` writes the PPM of render(mesh=
    make_mesh(2, "cpu")), and a server request with ``devices: 2`` the
    same floats, its scene cached once per device."""
    scene, cam = _cornell(8, 6)
    kw = dict(spp=4, max_depth=3, rays_per_wave=48, samples_per_wave=1)
    img = render(scene, cam, 8, 6, mesh=make_mesh(2, "cpu"), **kw)
    want = str(tmp_path / "want.ppm")
    film.write_image(img, want)
    got = str(tmp_path / "got.ppm")
    assert cli.main(["--device", "cpu", "--devices", "2", "--scene",
                     "cornell", "--width", "8", "--height", "6", "--spp",
                     "4", "--max-depth", "3", "--rays-per-wave", "48",
                     "--samples-per-wave", "1", "--out", got]) == 0
    assert open(got, "rb").read() == open(want, "rb").read()
    srv = RenderServer(device="cpu")
    out = str(tmp_path / "s.pfm")
    r = srv.handle({"scene": "cornell", "width": 8, "height": 6,
                    "devices": 2, "out": out, **kw})
    assert r["ok"] is True, r
    raw = open(out, "rb").read()
    _, dims, _, body = raw.split(b"\n", 3)
    np.testing.assert_array_equal(
        np.frombuffer(body, "<f4").reshape(6, 8, 3)[::-1], img)
    assert len(srv._scenes) == 1 and not srv._copies   # cpu == cpu


def test_make_mesh_needs_the_cards(monkeypatch):
    """make_mesh(n) on the card takes cuda:0 .. cuda:n-1 and raises where
    fewer than n cards are present; cpu meshes and explicit device lists
    (a device may repeat) are taken as given."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA devices asked for, 1"):
        make_mesh(2)
    assert make_mesh(1) == (torch.device("cuda", 0),)
    assert make_mesh(None) == (torch.device("cuda", 0),)
    assert make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert make_mesh(device=["cuda:0", "cuda:0"]) == \
        (torch.device("cuda", 0),) * 2
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="asked for"):
        make_mesh(1)
    assert cli.main(["--devices", "2", "--width", "4", "--height", "4"]) == 2


def test_reduce_films_sums_in_device_order():
    mesh = make_mesh(3, "cpu")
    parts = [torch.full((2,), v) for v in (1e8, -1e8, 1.0)]
    assert mesh_mod.reduce_films(parts, mesh).tolist() == [1.0, 1.0]
    assert mesh_mod.distinct(mesh) == [torch.device("cpu")]
    copies = mesh_mod.replicate(torch.zeros(2), mesh)
    assert list(copies) == [torch.device("cpu")]
    assert mesh_mod.replicate(copies, mesh) is copies
    with pytest.raises(ValueError, match="no copy"):
        mesh_mod.replicate({}, mesh)
