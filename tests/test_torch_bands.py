"""The pool plan above 512 prims on the port: the lane caps and the
per-wave sample budget of ``plan_pool``, row bands (``_row0``, ``_rows``,
``_band_cap``) and ``resolve_mode``'s demotions, held against the JAX
package on the CPU (``tpu_ray/renderer.py:34-173, 259-296, 590-627``).

The band tests are ports of ``tests/test_render.py:339-380`` and
``tests/test_progressive.py:48-87``: both packages' ``XLA_BIG_SCENE_LANES``
are lowered alike so that 16x12 frames band.  A band draws what the whole
frame draws wherever the two plans agree, so banded and unbanded renders
are held equal bit for bit; against the JAX package the criterion is the
cross-engine one (tests/test_shade_pallas.py:109-113)."""
from __future__ import annotations

import functools
from io import StringIO

import numpy as np
import pytest
from torch_port_common import cross_engine

import tpu_ray.renderer as JR
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray_torch import adaptive, renderer
from tpu_ray_torch.core import film
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import megakernel, shade
from tpu_ray_torch.parallel.mesh import make_mesh
from tpu_ray_torch.renderer import render

CRASH = "TPU_RAY_CRASH_AFTER_WAVE"
# the JAX band tests' request: one slot a pixel, 4 waves of one sample
KW = dict(spp=4, max_depth=3, seed=2, rays_per_wave=16 * 12,
          samples_per_wave=1, mode="pool", device="cpu")


@functools.lru_cache(maxsize=None)
def _spheres(pkg: str):
    """600 spheres in a row (``tests/test_render.py:331-336``): a scene
    of more than 512 prims that renders fast."""
    if pkg == "jax":
        from tpu_ray.core.camera import Camera
        from tpu_ray.models import objects as ob
        from tpu_ray.models.compile import build_scene
    else:
        from tpu_ray_torch.core.camera import Camera
        from tpu_ray_torch.models import objects as ob
        from tpu_ray_torch.models.compile import build_scene
    objs = [ob.Sphere((i - 300, 0, -5), 0.45, ob.Lambertian((0.5, 0.5, 0.5)))
            for i in range(600)]
    scene = build_scene(objs, background=(0.3, 0.5, 0.7))
    cam = Camera.create((0, 0, 5), (0, 0, 0), (0, 1, 0), 60.0, 1.0, 0.0, 5.0)
    return scene, cam


@functools.lru_cache(maxsize=None)
def _built(pkg: str, name: str):
    return (JSCENES if pkg == "jax" else SCENES)[name].build(seed=1024,
                                                            earth=None)


@pytest.fixture
def lanes_64(monkeypatch):
    """Both packages' big-scene lane cap at 64: 16-wide frames band in
    4-row bands."""
    monkeypatch.setattr(JR, "XLA_BIG_SCENE_LANES", 64)
    monkeypatch.setattr(renderer, "XLA_BIG_SCENE_LANES", 64)


@pytest.mark.parametrize("engine", ["xla", "mxu", "pallas"])
@pytest.mark.parametrize("w, h, spp", [(400, 400, 100), (400, 400, 16),
                                       (600, 400, 16), (600, 266, 16),
                                       (600, 134, 16)])
def test_plan_pool_matches_jax_above_512_prims(engine, w, h, spp):
    """next-week-final (1409 prims): the lane cap by engine and the
    per-wave budget, the frame's plans and each 600x400 band's."""
    got = renderer.plan_pool(_built("torch", "next-week-final"), w, h, spp,
                             engine=engine)
    assert got == JR.plan_pool(_built("jax", "next-week-final"), w, h, spp,
                               engine=engine)


@pytest.mark.parametrize("w, h, spp, rpw, spw", [(16, 12, 4, 16 * 12, 1),
                                                 (16, 4, 4, 16 * 12, 64),
                                                 (16, 12, 8, 1 << 20, 64)])
def test_plan_pool_matches_jax_under_a_lowered_cap(lanes_64, w, h, spp, rpw,
                                                   spw):
    plan = renderer.plan_pool(_spheres("torch")[0], w, h, spp, rpw, spw)
    assert plan == JR.plan_pool(_spheres("jax")[0], w, h, spp, rpw, spw)


def test_plan_pool_plans_big_scenes():
    """No longer refused above 512 prims: next-week-final at 400x400 16
    spp is one slot a pixel, 2 samples a wave, 8 waves (160000 lanes)."""
    assert renderer.plan_pool(_built("torch", "next-week-final"), 400, 400,
                              16) == (1, 2, 8)
    assert renderer.pallas_lane_cap(1409) == 390347


@pytest.mark.parametrize("row0, rows, k", [(0, None, 1), (0, 4, 2),
                                           (4, 4, 1), (8, 4, 3), (5, 7, 2)])
def test_pixel_grid_and_slot_ids_match_jax(row0, rows, k):
    """The band's bases and global slot ids: bit-equal to the JAX
    package's ``_pixel_grid`` / ``_slot_ids`` run op by op.  Compiled, XLA
    on the CPU turns ``ys``' divide by H into a multiply by the f32
    reciprocal, one ulp off in some rows; the port keeps the divide."""
    import jax

    xy = renderer.pixel_grid(16, 12, k, "cpu", row0, rows)
    ids = renderer.slot_ids(16, 12, k, "cpu", row0, rows)
    with jax.disable_jit():
        jx, jy = JR._pixel_grid(16, 12, k, row0, rows)
        jids = JR._slot_ids(16, 12, k, row0, rows)
    np.testing.assert_array_equal(xy[0].numpy(), np.asarray(jx))
    np.testing.assert_array_equal(xy[1].numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ids.numpy().view(np.uint32),
                                  np.asarray(jids))
    cx, cy = JR._pixel_grid(16, 12, k, row0, rows)
    np.testing.assert_array_equal(xy[0].numpy(), np.asarray(cx))
    np.testing.assert_array_max_ulp(xy[1].numpy(), np.asarray(cy), maxulp=1)
    np.testing.assert_array_equal(
        ids.numpy().view(np.uint32),
        np.asarray(JR._slot_ids(16, 12, k, row0, rows)))


@pytest.mark.parametrize("name", ["cornell", "next-week-final"])
@pytest.mark.parametrize("mode", ["auto", "pool", "queue", "wave"])
def test_resolve_mode_matches_jax(capfd, name, mode):
    """The same mode, and the same demotion line (prefix aside), for bvh
    off and on, engine auto and mega, no mesh and a 2-device mesh with spp
    1 and 4."""
    from tpu_ray.parallel.mesh import make_mesh as jmake_mesh

    meshes = [(None, None, 4), (make_mesh(2, "cpu"), jmake_mesh(2), 1),
              (make_mesh(2, "cpu"), jmake_mesh(2), 4)]
    scene, jscene = _built("torch", name), _built("jax", name)
    for bvh in (False, True):
        for engine in ("auto", "mega"):
            for mesh, jmesh, spp in meshes:
                got = renderer.resolve_mode(scene, mode, engine, bvh=bvh,
                                            mesh=mesh, spp=spp)
                err = capfd.readouterr().err
                want = JR.resolve_mode(jscene, mode, mesh=jmesh, bvh=bvh,
                                       engine=engine, spp=spp)
                jerr = capfd.readouterr().err
                assert got == want, (bvh, engine, spp, mesh)
                lines = [ln for ln in err.splitlines() if "demoting" in ln]
                jlines = [ln.replace("tpu_ray:", "tpu_ray_torch:")
                          for ln in jerr.splitlines() if "demoting" in ln]
                assert lines == jlines
    assert renderer.resolve_mode(scene, "queue", _rows=4) == "pool"


def _banded(*args, **kw):
    """``render(*args, **kw)`` and the rows it reported final: a banded
    render reports each band's end."""
    rows = []
    img = render(*args, on_partial=lambda im, rf: rows.append(rf), **kw)
    return img, rows


def test_band_tiling_matches_unbanded(lanes_64):
    """Three 4-row bands equal the unbanded frame bit for bit, and the JAX
    package's banded render at the cross-engine criterion."""
    scene, cam = _spheres("torch")
    steps = shade.pool_step_plain.calls
    banded, rows = _banded(scene, cam, 16, 12, **KW)
    assert shade.pool_step_plain.calls > steps and rows[-1] == 12
    assert {4, 8, 12} <= set(rows)
    unbanded = render(scene, cam, 16, 12, _band_cap=16 * 12, **KW)
    assert banded.shape == (12, 16, 3)
    np.testing.assert_array_equal(banded, unbanded)
    jkw = {k: v for k, v in KW.items() if k != "device"}
    cross_engine(np.asarray(JR.render(*_spheres("jax"), 16, 12, **jkw)),
                 banded)


def test_band_tiling_with_bvh_matches_unbanded(lanes_64, capsys):
    """bvh on a big scene: auto demotes to the pool (said), which bands."""
    scene, cam = _spheres("torch")
    kw = dict(KW, mode="auto", bvh=True)
    banded, rows = _banded(scene, cam, 16, 12, **kw)
    assert {4, 8, 12} <= set(rows)
    assert "demoting mode=queue to the wave pool: bvh" in \
        capsys.readouterr().err
    np.testing.assert_array_equal(
        banded, render(scene, cam, 16, 12, _band_cap=16 * 12, **kw))


def test_band_tiling_composes_with_mesh(lanes_64):
    """Bands over a 2-entry cpu mesh: bit-equal to the unbanded mesh
    render, and the single-device render at the JAX test's tolerance."""
    scene, cam = _spheres("torch")
    mesh = make_mesh(2, "cpu")
    kw = {k: v for k, v in KW.items() if k != "device"}
    banded, rows = _banded(scene, cam, 16, 12, mesh=mesh, **kw)
    assert {4, 8, 12} <= set(rows)
    np.testing.assert_array_equal(
        banded, render(scene, cam, 16, 12, mesh=mesh, _band_cap=16 * 12,
                       **kw))
    np.testing.assert_allclose(banded, render(scene, cam, 16, 12, **KW),
                               rtol=1e-5, atol=1e-6)


def test_on_partial_banded_rows_final_are_exact(lanes_64):
    scene, cam = _spheres("torch")
    kw = dict(KW, spp=2)
    final = render(scene, cam, 16, 12, **kw)
    calls = []
    banded = render(scene, cam, 16, 12, **kw,
                    on_partial=lambda im, rf: calls.append((im.copy(), rf)))
    np.testing.assert_array_equal(banded, final)
    rfs = [rf for _, rf in calls]
    # per band: one in-band wave (the band's top row) and the band's end
    assert rfs == [0, 4, 4, 8, 8, 12]
    for im, rf in calls:
        assert im.shape == (12, 16, 3)
        np.testing.assert_array_equal(im[:rf], final[:rf])


def test_progressive_stream_equals_plain_ppm(lanes_64):
    """The banded stream is the plain PPM byte for byte, every row of it
    out before ``finish``."""
    scene, cam = _spheres("torch")
    kw = dict(KW, spp=2)
    expected = film.ppm_string(film.to_rgb8(render(scene, cam, 16, 12,
                                                   **kw)))
    po = film.ProgressiveOutput("-", 16, 12, fp=StringIO())
    img = render(scene, cam, 16, 12, **kw, on_partial=po.update)
    mid_stream = po.fp.getvalue()
    po.finish(img)
    assert po.fp.getvalue() == expected == mid_stream
    assert po.rows_emitted == 12


def test_forced_band_cap_on_the_megakernel_twin():
    """A small scene banded by ``_band_cap`` with ``engine="mega"``: one
    megakernel wave per band and wave, bit-equal to the unbanded render
    (the lanes pinned to the cap, so both plan one slot a pixel)."""
    spec = SCENES["cornell"]
    scene, cam = spec.build(), spec.camera(16, 12)
    kw = dict(spp=4, max_depth=4, seed=5, rays_per_wave=64,
              samples_per_wave=1, engine="mega", device="cpu")
    calls = megakernel.trace_pool_mega_plain.calls
    banded = render(scene, cam, 16, 12, _band_cap=64, **kw)
    assert megakernel.trace_pool_mega_plain.calls == calls + 3 * 4
    np.testing.assert_array_equal(banded, render(scene, cam, 16, 12, **kw))


def test_banded_render_resumes_bit_equal(lanes_64, monkeypatch, tmp_path,
                                         capsys):
    """An injected crash before wave 2 stops each band's fresh render in
    turn, as in the JAX package; each rerun resumes from the band's own
    checkpoint, and the third ends bit-equal to the uninterrupted render."""
    scene, cam = _spheres("torch")
    kw = dict(KW, checkpoint_path=str(tmp_path / "ck.npz"),
              checkpoint_every=1, _band_cap=16 * 6)    # two 6-row bands
    full = render(scene, cam, 16, 12, **dict(KW, _band_cap=16 * 6))
    monkeypatch.setenv(CRASH, "2")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected crash"):
            render(scene, cam, 16, 12, **kw)
    assert (tmp_path / "ck.npz.band0.npz").exists()
    assert (tmp_path / "ck.npz.band6.npz").exists()
    img = render(scene, cam, 16, 12, progress=True, **kw)
    assert "resuming at wave 2" in capsys.readouterr().err
    np.testing.assert_array_equal(img, full)


@pytest.mark.parametrize("bvh", [False, True])
def test_next_week_final_banded_pool_matches_jax(lanes_64, bvh):
    """next-week-final on the banded pool (three 4-row bands), brute force
    and BVH, against the JAX package's CPU render of the same request."""
    kw = dict(spp=2, max_depth=4, seed=7, mode="pool", bvh=bvh)
    a = np.asarray(JR.render(_built("jax", "next-week-final"),
                             JSCENES["next-week-final"].camera(16, 12), 16,
                             12, **kw))
    b = render(_built("torch", "next-week-final"),
               SCENES["next-week-final"].camera(16, 12), 16, 12,
               device="cpu", **kw)
    assert np.isfinite(b).all() and b.mean() > 0.0
    cross_engine(a, b)


def test_render_adaptive_keeps_an_explicit_pool(monkeypatch):
    """``render_adaptive(mode="pool")`` on a scene of more than 512 prims
    renders on the pool backend, as the JAX package's does; ``"auto"``
    takes the queue there."""
    seen = []
    for name in ("_render_adaptive_pool", "_render_adaptive_queue"):
        orig = getattr(adaptive, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(adaptive, name, spy)
    scene, cam = _spheres("torch")
    kw = dict(spp_max=16, tol=0.05, max_depth=3, seed=2, pilot_spp=8,
              device="cpu")
    img = adaptive.render_adaptive(scene, cam, 8, 6, mode="pool", **kw)
    adaptive.render_adaptive(scene, cam, 8, 6, **kw)
    assert seen == ["_render_adaptive_pool", "_render_adaptive_queue"]
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
