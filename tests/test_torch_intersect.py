"""Closest hit: tpu_ray_torch's sweep and intersect_ti against tpu_ray.

The port's plain sweep (the CUDA kernel's CPU twin) and its intersect_ti
(sweep + constant media) are held to tpu_ray.ops.intersect.intersect_ti
(the XLA sweep of the JAX main path) and to the Pallas per-kind sweeps
(intersect_solids_pallas in interpret mode), on the very same scene arrays
(carried across with tpu_ray_torch.convert): the hit sets and prim ids are
exact, t within rtol 2e-5."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_scene_arrays

from tpu_ray.models import objects as job
from tpu_ray.models.compile import build_scene as jbuild
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops.intersect import intersect_ti as j_intersect_ti
from tpu_ray.ops.intersect_pallas import intersect_solids_pallas
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.ops import sweep as sw
from tpu_ray_torch.ops.intersect import intersect_ti, pack_rays

KEY = jax.random.fold_in(jax.random.PRNGKey(0), 7)
KD = np.asarray(jax.random.key_data(KEY))


def _rays(seed, n, lo, hi):
    r = np.random.default_rng(seed)
    ro = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rt = r.random(n).astype(np.float32)
    return ro, rd, rt


def _port_rays(ro, rd, rt):
    return pack_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                     torch.from_numpy(rt))


def _assert_hits_equal(t, i, t_ref, i_ref, min_hits=20):
    t, i = np.asarray(t), np.asarray(i)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    hit = np.isfinite(t_ref)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    assert hit.sum() >= min_hits
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=2e-5)
    np.testing.assert_array_equal(i[hit], i_ref[hit])


def _mixed_scene():
    """Spheres (static and moving), axis-aligned boxes and quads of every
    orientation: every sweep range is non-empty."""
    r = np.random.default_rng(31)
    white = job.Lambertian((1, 1, 1))
    objs = [job.Sphere(tuple(r.uniform(-20, 20, 3)), r.uniform(0.3, 1.5),
                       white) for _ in range(60)]
    for _ in range(20):
        c = r.uniform(-20, 20, 3)
        objs.append(job.MovingSphere(tuple(c), tuple(c + r.uniform(-2, 2, 3)),
                                     0.0, 1.0, r.uniform(0.3, 1.5), white))
    for _ in range(20):
        lo3 = r.uniform(-20, 20, 3)
        objs.append(job.Box(tuple(lo3), tuple(lo3 + r.uniform(0.5, 4.0, 3)),
                            white))
    for plane in ("xy", "xz", "yz"):
        for _ in range(10):
            a = np.sort(r.uniform(-20, 20, 2))
            b = np.sort(r.uniform(-20, 20, 2))
            objs.append(job.Rect(plane, a[0], a[1], b[0], b[1],
                                 r.uniform(-20, 20), white))
    return jbuild(objs)


CASES = [("cornell", 0, 555), ("book1-final", -12, 12),
         ("two-spheres", -15, 15), ("cornell-smoke", 0, 555),
         ("simple-light", -10, 10), ("mixed", -40, 40)]


def _jscene(name):
    return (_mixed_scene() if name == "mixed"
            else JSCENES[name].build(seed=1024, earth=None))


@pytest.mark.parametrize("name,lo,hi", CASES)
def test_sweep_plain_matches_pallas_sweeps(name, lo, hi):
    js = _jscene(name)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    ro, rd, rt = _rays(1, 384, lo, hi)
    bt, bi = intersect_solids_pallas(js, jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.asarray(rt), interpret=True)
    t, i = sw.sweep_plain(_port_rays(ro, rd, rt), sw.sweep_table(ps),
                          sw._ranges(ps), ps.t_min)
    t, i, bt, bi = t.numpy(), i.numpy(), np.asarray(bt), np.asarray(bi)
    hit = np.isfinite(bt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_array_equal(i[hit], bi[hit])
    # Grazing hits of the r=1000 ground spheres cancel catastrophically,
    # and the interpreted Pallas sweep rounds them differently from the
    # XLA sweep (tests/test_pallas.py allows 5e-4 between the two).  The
    # port rounds op for op like XLA: on lanes where the two JAX engines
    # disagree, hold it to the XLA sweep (lanes whose XLA winner is a
    # medium have no XLA solid t and stay held to Pallas).
    xt, xi = j_intersect_ti(js, jnp.asarray(ro), jnp.asarray(rd),
                            jnp.asarray(rt), KEY)
    xt, xi = np.asarray(xt), np.asarray(xi)
    with np.errstate(invalid="ignore"):          # inf - inf on misses
        engines_agree = ((xi >= js.n_solid)
                         | (np.abs(xt - bt) <= 2e-5 * np.abs(bt)))
    np.testing.assert_allclose(t[hit & engines_agree],
                               bt[hit & engines_agree], rtol=2e-5)
    np.testing.assert_allclose(t[hit & ~engines_agree],
                               xt[hit & ~engines_agree], rtol=2e-5)
    assert (hit & engines_agree).mean() > 0.5 * hit.mean()


@pytest.mark.parametrize("name,lo,hi", CASES)
def test_intersect_ti_matches_jax(name, lo, hi):
    js = _jscene(name)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    ro, rd, rt = _rays(2, 512, lo, hi)
    ids = np.random.default_rng(3).integers(0, 1 << 32, 512, dtype=np.uint32)
    bt, bi = j_intersect_ti(js, jnp.asarray(ro), jnp.asarray(rd),
                            jnp.asarray(rt), KEY, lane_ids=jnp.asarray(ids))
    t, i = intersect_ti(ps, _port_rays(ro, rd, rt), KD,
                        torch.from_numpy(ids.view(np.int32)))
    _assert_hits_equal(t.numpy(), i.numpy(), bt, bi)
    if ps.has_media:
        assert (i.numpy() >= ps.n_solid).sum() > 0, "no medium was hit"


def test_sweep_matches_jax_on_camera_rays():
    """Coherent camera rays through the cornell box (the main path's first
    bounce), at the scene's own t_min."""
    from tpu_ray_torch.models.scenes import SCENES

    spec, jspec = SCENES["cornell"], JSCENES["cornell"]
    cam = jspec.camera(64, 48)
    xs = jnp.tile(jnp.linspace(0.02, 0.98, 64), 48)
    ys = jnp.repeat(jnp.linspace(0.02, 0.98, 48), 64)
    ro, rd, rt = cam.get_rays(jax.random.PRNGKey(5), xs, ys)
    js = jspec.build(seed=1024)
    bt, bi = j_intersect_ti(js, ro, rd, rt, KEY)
    ps = spec.build(seed=1024)
    t, i = intersect_ti(ps, _port_rays(*(np.array(a) for a in (ro, rd, rt))),
                        KD, torch.arange(64 * 48, dtype=torch.int32))
    _assert_hits_equal(t.numpy(), i.numpy(), bt, bi, min_hits=1500)


def test_box_far_from_origin_gives_no_phantom_hits():
    """The padded-box regression of tests/test_pallas.py:135: one box far
    from the origin and rays aimed at the origin hit nothing (the port
    pads no prim range; the sweep stops at n_solid)."""
    js = jbuild([job.Box((50, 50, 50), (52, 52, 52), job.Lambertian((1, 1, 1)))])
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    assert ps.n_box == 1
    r = np.random.default_rng(99)
    ro = r.uniform(-8, 8, (256, 3)).astype(np.float32)
    rd = (-ro + r.normal(0, 0.05, (256, 3))).astype(np.float32)
    rt = np.zeros(256, np.float32)
    t, _ = sw.sweep_plain(_port_rays(ro, rd, rt), sw.sweep_table(ps),
                          sw._ranges(ps), ps.t_min)
    assert not torch.isfinite(t).any()


def test_sweep_plain_ray_blocks_are_invisible():
    """Chunking the rays (RAY_CHUNK) changes nothing."""
    js = _mixed_scene()
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    rays = _port_rays(*_rays(4, 1000, -40, 40))
    geo, ranges = sw.sweep_table(ps), sw._ranges(ps)
    t0, i0 = sw.sweep_plain(rays, geo, ranges, ps.t_min)
    old = sw.RAY_CHUNK
    try:
        sw.RAY_CHUNK = 96
        t1, i1 = sw.sweep_plain(rays, geo, ranges, ps.t_min)
    finally:
        sw.RAY_CHUNK = old
    assert torch.equal(t0, t1) and torch.equal(i0, i1)


def test_sweep_wrapper_takes_plain_path_on_cpu_only():
    ps = scene_from_jax_arrays(jax_scene_arrays(_jscene("cornell")))
    rays = _port_rays(*_rays(5, 64, 0, 555))
    before = sw.sweep.launches, sw.sweep_plain.calls
    sw.sweep(rays, sw.sweep_table(ps), sw._ranges(ps), ps.t_min)
    assert sw.sweep.launches == before[0]
    assert sw.sweep_plain.calls == before[1] + 1
    with pytest.raises(ValueError):
        sw.sweep(rays.T.contiguous(), sw.sweep_table(ps), sw._ranges(ps),
                 ps.t_min)
    with pytest.raises(ValueError, match="CUDA"):      # no plain fallback
        sw.sweep_launch(rays, sw.sweep_table(ps), sw._ranges(ps), ps.t_min, 1)
    assert sw.sweep.launches == before[0]


@pytest.mark.parametrize("sms", [1, 78, 132])
@pytest.mark.parametrize("n_solid", [13, 485])
def test_pick_rpt_fills_every_sm_before_it_packs_rays(sms, n_solid):
    """Rays per thread of the dense kernel: 1 until the grid would give
    every SM FILL_THREADS threads at 2, then 2, then 4 where the scene has
    PACK_PRIMS solid prims or more; never fewer threads per SM than that."""
    full = sw.FILL_THREADS * sms
    top = 4 if n_solid >= sw.PACK_PRIMS else 2
    picks = {R: sw.pick_rpt(R, sms, n_solid)
             for R in (1, 255, full - 1, 2 * full - 1, 2 * full,
                       4 * full - 1, 4 * full, 10 ** 7)}
    assert picks[1] == picks[255] == picks[full - 1] == 1
    assert picks[2 * full - 1] == 1 and picks[2 * full] == 2
    assert picks[4 * full - 1] == 2
    assert picks[4 * full] == picks[10 ** 7] == top
    for R, rpt in picks.items():
        assert rpt in (1, 2, 4) and (rpt == 1 or R // rpt >= full)
    assert sw.pick_rpt(10 ** 7, sms, sw.PACK_PRIMS - 1) == 2
    assert sw.pick_rpt(10 ** 7, sms, sw.PACK_PRIMS) == 4

