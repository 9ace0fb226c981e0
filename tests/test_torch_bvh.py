"""BVH: tpu_ray_torch.ops.bvh against tpu_ray.ops.bvh and the brute force.

The port's numpy build equals the JAX package's numpy build array for
array; its traversal twin (the CUDA kernel's plain version) on the very
same tree (carried across with ``convert.bvh_from_arrays``) equals JAX's
``intersect_scene_bvh`` (hit and prim equal, t within rtol 2e-5: the
port's pair math against XLA's) and the port's brute-force
``intersect_ti`` (hit equal, prim equal but on equal-t ties, t within rtol
1e-5, JAX's own tolerance in tests/test_bvh.py); a ``bvh=True`` render
matches the brute-force render at rtol 1e-4 / atol 1e-6 and JAX's
``bvh=True`` render under the cross-engine criterion."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import cross_engine, jax_scene_arrays

from tpu_ray.models import objects as job
from tpu_ray.models.compile import build_scene as jbuild
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops.bvh import build_bvh as jbuild_bvh
from tpu_ray.ops.bvh import intersect_scene_bvh, prim_aabbs as jprim_aabbs
from tpu_ray_torch import renderer
from tpu_ray_torch.convert import bvh_from_arrays, scene_from_jax_arrays
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import bvh
from tpu_ray_torch.ops.intersect import intersect_ti, pack_rays

KEY = jax.random.fold_in(jax.random.PRNGKey(0), 7)
KD = np.asarray(jax.random.key_data(KEY))
FIELDS = ("node_min", "node_max", "child_l", "child_r", "first", "count",
          "order")


def _random_scene(seed=0, n_spheres=60, media=False):
    """tests/test_bvh.py's scene: spheres, rects of every orientation, a
    rotated metal box, a moving sphere, optionally two media (a sphere and
    a rotated box)."""
    r = np.random.default_rng(seed)
    white = job.Lambertian((1, 1, 1))
    objs = [job.Sphere(tuple(r.uniform(-8, 8, 3)), r.uniform(0.2, 1.2),
                       white) for _ in range(n_spheres)]
    for plane in ("xy", "xz", "yz"):
        for _ in range(6):
            a = np.sort(r.uniform(-8, 8, 2))
            b = np.sort(r.uniform(-8, 8, 2))
            objs.append(job.Rect(plane, a[0], a[1], b[0], b[1],
                                 r.uniform(-8, 8), white))
    objs.append(job.Translate((1, 2, 3), job.Rotate(
        "y", 30, job.Box((-1, -1, -1), (1, 1, 1), job.Metal((1, 1, 1),
                                                             0.1)))))
    objs.append(job.MovingSphere((0, 0, 0), (3, 0, 0), 0, 1, 0.5, white))
    if media:
        objs.append(job.ConstantMedium(0.3, (1, 1, 1), job.Sphere(
            (0, 0, 5), 2.0, white)))
        objs.append(job.ConstantMedium(0.2, (1, 1, 1), job.Translate(
            (2, 0, 0), job.Rotate("y", 15, job.Box((0, 0, 0), (2, 2, 2),
                                                   white)))))
    return jbuild(objs)


def _big_scene():
    """tests/test_bvh.py's 600 spheres and 60 rects (over 512 prims)."""
    r = np.random.default_rng(21)
    white = job.Lambertian((1, 1, 1))
    objs = [job.Sphere(tuple(r.uniform(-30, 30, 3)), r.uniform(0.2, 1.0),
                       white) for _ in range(600)]
    for plane in ("xy", "xz", "yz"):
        for _ in range(20):
            a = np.sort(r.uniform(-30, 30, 2))
            b = np.sort(r.uniform(-30, 30, 2))
            objs.append(job.Rect(plane, a[0], a[1], b[0], b[1],
                                 r.uniform(-30, 30), white))
    return jbuild(objs)


def _rays(seed, n=512, scale=1.0):
    r = np.random.default_rng(seed)
    ro = (r.uniform(-10, 10, (n, 3)) * scale).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rt = r.random(n).astype(np.float32)
    return ro, rd, rt


def _both(js):
    return js, scene_from_jax_arrays(jax_scene_arrays(js))


def _tree(jtree):
    return bvh_from_arrays({f: np.asarray(getattr(jtree, f)) for f in FIELDS}
                           | {"n_nodes": jtree.n_nodes,
                              "leaf_size": jtree.leaf_size})


def _twin(ps, tree, ro, rd, rt, stats=None):
    tables = bvh.BVHTables.create(ps, tree)
    rays = pack_rays(*(torch.from_numpy(a) for a in (ro, rd, rt)))
    lanes = torch.arange(ro.shape[0], dtype=torch.int32)
    t, i = bvh.intersect_bvh(ps, tables, rays, KD, lanes)
    if stats is not None:
        bvh.intersect_bvh_plain(ps, tables, rays, KD, lanes, stats)
    return t.numpy(), i.numpy(), rays, lanes


@pytest.mark.parametrize("which", ["random", "random-media", "book1-final",
                                   "next-week-final"])
def test_build_equals_jax_numpy_build(which):
    if which.startswith("random"):
        js = _random_scene(3, media=which.endswith("media"))
    else:
        js = JSCENES[which].build(seed=7, earth=None)
    js, ps = _both(js)
    np.testing.assert_array_equal(bvh.prim_aabbs(ps), jprim_aabbs(js))
    ours, theirs = bvh.build_bvh(ps), jbuild_bvh(js, use_native=False)
    assert ours.n_nodes == theirs.n_nodes
    assert ours.leaf_size == theirs.leaf_size == bvh.LEAF_SIZE
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(theirs, f)), f)
    np.testing.assert_array_equal(np.sort(ours.order.numpy()),
                                  np.arange(ps.n_prims))


@pytest.mark.parametrize("media", [False, True])
def test_twin_matches_jax_traversal(media):
    js, ps = _both(_random_scene(3, media=media))
    jtree = jbuild_bvh(js, use_native=False)
    ro, rd, rt = _rays(4)
    rec = intersect_scene_bvh(js, jtree, jnp.asarray(ro), jnp.asarray(rd),
                              jnp.asarray(rt), KEY)
    t, i, _, _ = _twin(ps, _tree(jtree), ro, rd, rt)
    hit = np.asarray(rec.hit)
    assert hit.sum() > 100
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_array_equal(i[hit], np.asarray(rec.prim)[hit])
    np.testing.assert_allclose(t[hit], np.asarray(rec.t)[hit], rtol=2e-5)
    if media:   # free flights hit inside the media
        assert (i[hit] >= ps.n_solid).any()


@pytest.mark.parametrize("which", ["big", "random-media"])
def test_twin_matches_brute_force(which):
    js = _big_scene() if which == "big" else _random_scene(5, media=True)
    _, ps = _both(js)
    ro, rd, rt = _rays(22, 1024, 3.0 if which == "big" else 1.0)
    stats = {}
    t, i, rays, lanes = _twin(ps, bvh.build_bvh(ps), ro, rd, rt, stats)
    ft, fi = (a.numpy() for a in intersect_ti(ps, rays, KD, lanes))
    hit = np.isfinite(ft)
    assert hit.sum() > 100
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], ft[hit], rtol=1e-5)
    differ = hit & (i != fi)
    assert (t[differ] == ft[differ]).all()      # equal-t ties only
    # the twin counts the work: a node visit a step, a pair a leaf prim
    assert stats["rays"] == 1024 and stats["visits"] >= 1024
    assert bvh.traversal_flops(stats) > 25 * stats["visits"]


def test_bvh_render_matches_brute_force():
    """tests/test_bvh.py::test_bvh_render_matches_brute_force on the port."""
    spec = SCENES["cornell"]
    scene, cam = spec.build(), spec.camera(12, 12)
    kw = dict(spp=8, max_depth=6, seed=9, device="cpu")
    calls = bvh.intersect_bvh_plain.calls
    img_a = renderer.render(scene, cam, 12, 12, **kw)
    img_b = renderer.render(scene, cam, 12, 12, bvh=True, **kw)
    assert bvh.intersect_bvh_plain.calls > calls
    np.testing.assert_allclose(img_a, img_b, rtol=1e-4, atol=1e-6)


def test_bvh_render_matches_jax_bvh_render():
    from tpu_ray.renderer import render as jrender

    jspec, spec = JSCENES["cornell-smoke"], SCENES["cornell-smoke"]
    kw = dict(spp=4, max_depth=6, seed=11, bvh=True)
    a = np.asarray(jrender(jspec.build(seed=1024), jspec.camera(16, 12), 16,
                           12, **kw))
    b = renderer.render(spec.build(seed=1024), spec.camera(16, 12), 16, 12,
                        device="cpu", **kw)
    cross_engine(a, b)


def test_queue_request_with_bvh(capsys, monkeypatch):
    """A queue request with bvh renders on the pool, as in the JAX
    package: silently for auto up to 512 prims, with a line saying so
    above, where the pool bands (the lane cap lowered to 16 here: three
    2-row bands) and equals the unbanded render bit for bit."""
    small = SCENES["cornell"].build()
    big = SCENES["next-week-final"].build(earth=None)
    assert renderer.resolve_mode(small, "queue", bvh=True) == "pool"
    assert "demoting mode=queue to the wave pool: bvh" in \
        capsys.readouterr().err
    assert renderer.resolve_mode(small, "auto", bvh=True) == "pool"
    assert capsys.readouterr().err == ""
    assert renderer.resolve_mode(big, "auto", bvh=True) == "pool"
    assert "demoting mode=queue to the wave pool: bvh" in \
        capsys.readouterr().err
    cam = SCENES["next-week-final"].camera(8, 6)
    kw = dict(spp=1, max_depth=2, device="cpu", bvh=True)
    unbanded = renderer.render(big, cam, 8, 6, **kw)
    monkeypatch.setattr(renderer, "XLA_BIG_SCENE_LANES", 16)
    rows = []
    img = renderer.render(big, cam, 8, 6,
                          on_partial=lambda im, rf: rows.append(rf), **kw)
    assert rows == [2, 4, 6]
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(img, unbanded)
