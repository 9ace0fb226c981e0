"""The fused pool step: tpu_ray_torch's plain version against the JAX
kernel it ports (shade_pallas.pool_step_pallas, interpret mode).

Both take the very same 2048-lane pool state (a few iterations into a
render, so bounces, deaths, regenerations and finished slots all occur),
the same scene arrays and the same key words.  Discrete outputs (bounce,
sample, active) are exact; floats agree at the tolerances of
tests/test_shade_pallas.py:68-86."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import SCENE_NAMES, jax_scene_arrays

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops import shade_pallas
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import rng
from tpu_ray_torch.integrator import SceneKernels, init_pool_state
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import shade
from tpu_ray_torch.ops.intersect import intersect_ti
from tpu_ray_torch.renderer import pixel_grid, slot_ids

W, H, K = 32, 16, 4      # 2048 lanes
N_SAMPLES, SAMPLE0, DEPTH = 3, 6, 6


def _advance(ps, cfg, iters):
    """A pool ``iters`` iterations in, and the next iteration's inputs."""
    kern = SceneKernels.create(ps)
    st = init_pool_state(pixel_grid(W, H, K), slot_ids(W, H, K))
    R = st.slot.shape[0]
    st.fstate, st.istate = shade.pool_step(
        cfg, st.xy, st.slot, st.fstate, st.istate,
        torch.empty(R), torch.zeros(R, dtype=torch.int32), (0, 0), init=True)
    ki, ks = rng.pool_key_tables(rng.fold_in(rng.prng_key(1024), 2),
                                 iters + 1)
    for it in range(iters + 1):
        bt, bi = intersect_ti(ps, st.fstate[:7], ki[it], st.slot, kern.geo,
                              kern.media)
        if it == iters:
            return st, bt, bi, ks[it]
        st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot,
                                               st.fstate, st.istate, bt, bi,
                                               ks[it])


def _close_lanes(a, b, rtol, atol, perlin_lanes=0):
    """assert_allclose, except that up to ``perlin_lanes`` lanes may be off
    by 10x the tolerance.  The marble texture turns a 1-ulp difference of
    the hit point into ~1e-4 of its sine's argument (10 |turbulence| summed
    over 7 octaves, the finest at 64x the point's scale), and the
    interpreted Pallas kernel's XLA:CPU body rounds o + t*d differently
    from the op-for-op plain version."""
    bad = (np.abs(a - b) > atol + rtol * np.abs(b)).any(axis=-1)
    assert bad.sum() <= perlin_lanes, f"{bad.sum()} lanes out of tolerance"
    np.testing.assert_allclose(a[~bad], b[~bad], rtol=rtol, atol=atol)
    np.testing.assert_allclose(a[bad], b[bad], rtol=10 * rtol, atol=10 * atol)


def _compare(name, rr_depth=0, iters=4):
    js = JSCENES[name].build(seed=1024, earth=None)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    cam = SCENES[name].camera(W, H)
    cfg = shade.StepConfig.create(ps, cam, W, H, DEPTH, rr_depth=rr_depth,
                                  n_samples=N_SAMPLES, sample0=SAMPLE0,
                                  cam_salt=1024)
    st, bt, bi, kd = _advance(ps, cfg, iters)
    fk, ik = shade.pool_step_plain(cfg, st.xy, st.slot, st.fstate, st.istate,
                                   bt, bi, kd)

    f = st.fstate.numpy()
    i = st.istate.numpy()
    J = lambda a: jnp.asarray(np.ascontiguousarray(a))
    out = shade_pallas.pool_step_pallas(
        js, JSCENES[name].camera(W, H), J(st.xy[0].numpy()),
        J(st.xy[1].numpy()), J(st.slot.numpy().view(np.uint32)),
        J(f[0:3].T), J(f[3:6].T), J(f[6]), J(f[7:10].T), J(f[10:13].T),
        J(i[0]), J(i[1]), J(i[2] > 0), J(bt.numpy()), J(bi.numpy()),
        J(np.asarray(kd, np.uint32)), N_SAMPLES, np.uint32(SAMPLE0),
        np.uint32(1024), (1.0 / W, 1.0 / H), DEPTH, rr_depth=rr_depth,
        interpret=True)
    o2, d2, tm2, tp2, ac2, bo2, sa2, av2 = (np.asarray(a) for a in out)
    perlin_lanes = 2 if js.has_perlin else 0     # of 2048
    fk, ik = fk.numpy(), ik.numpy()
    np.testing.assert_array_equal(ik[0], bo2)
    np.testing.assert_array_equal(ik[1], sa2)
    np.testing.assert_array_equal(ik[2], av2.astype(np.int32))
    tol = dict(rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(fk[0:3].T, o2, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(fk[3:6].T, d2, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(fk[6], tm2, **tol)
    _close_lanes(fk[7:10].T, tp2, perlin_lanes=perlin_lanes, **tol)
    _close_lanes(fk[10:13].T, ac2, perlin_lanes=perlin_lanes, **tol)
    # the state exercised what it should
    assert (i[2] > 0).any() and (ik[1] > i[1]).any(), "no regeneration"
    return i, ik


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_pool_step_plain_matches_pallas(name):
    _compare(name)


def test_pool_step_plain_matches_pallas_with_roulette():
    i, ik = _compare("cornell", rr_depth=3, iters=8)
    assert (i[0] >= 3).sum() > 20, "too few lanes reach the roulette depth"


def test_pool_step_init_regenerates_every_lane():
    ps = SCENES["cornell"].build()
    cfg = shade.StepConfig.create(ps, SCENES["cornell"].camera(W, H), W, H,
                                  DEPTH, n_samples=2)
    st = init_pool_state(pixel_grid(W, H, K), slot_ids(W, H, K))
    R = st.slot.shape[0]
    f, i = shade.pool_step(cfg, st.xy, st.slot, st.fstate, st.istate,
                           torch.empty(R), torch.zeros(R, dtype=torch.int32),
                           (0, 0), init=True)
    assert (i[2] == 1).all() and (i[1] == 1).all() and (i[0] == 0).all()
    assert torch.equal(f[7:10], torch.ones_like(f[7:10]))
    assert torch.equal(f[10:13], torch.zeros_like(f[10:13]))


def test_pool_step_wrapper_counts_and_checks():
    ps = SCENES["two-spheres"].build()
    cfg = shade.StepConfig.create(ps, SCENES["two-spheres"].camera(W, H), W,
                                  H, DEPTH, n_samples=2)
    st = init_pool_state(pixel_grid(W, H, K), slot_ids(W, H, K))
    R = st.slot.shape[0]
    args = (cfg, st.xy, st.slot, st.fstate, st.istate, torch.empty(R),
            torch.zeros(R, dtype=torch.int32), (0, 0))
    before = shade.pool_step.launches, shade.pool_step_plain.calls
    shade.pool_step(*args, init=True)
    assert shade.pool_step.launches == before[0]       # CPU: no kernel
    assert shade.pool_step_plain.calls == before[1] + 1
    with pytest.raises(ValueError):
        shade.pool_step(cfg, st.xy, st.slot, st.fstate, st.istate.long(),
                        *args[5:])


def test_tables_match_megakernel_tables():
    """build_tables reproduces megakernel._build_tables (the table the JAX
    kernels pull from) bit for bit."""
    from tpu_ray.ops.megakernel import _build_tables

    for name in ("cornell-smoke", "two-perlin-spheres", "simple-light"):
        js = JSCENES[name].build(seed=1024, earth=None)
        geo, salt, lights = _build_tables(js)
        g2, s2, l2 = shade.build_tables(
            scene_from_jax_arrays(jax_scene_arrays(js)))
        np.testing.assert_array_equal(g2, np.asarray(geo))
        np.testing.assert_array_equal(s2, np.asarray(salt))
        np.testing.assert_array_equal(l2, np.asarray(lights))

