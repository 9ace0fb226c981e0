"""The Sobol' camera samplers of the port: tpu_ray_torch.core.qmc bit for bit
against tpu_ray.core.qmc, the device tables of csrc/qmc.cuh against it, the
fused step's Sobol' regeneration against the interpreted Pallas step, and
sobol renders of the pool, queue and megakernel paths against the JAX
package's sobol renders (cross-engine criterion)."""
from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import cross_engine, jax_scene_arrays

from tpu_ray.core import qmc as jqmc
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops import shade_pallas
from tpu_ray.renderer import render as jrender
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import qmc, rng
from tpu_ray_torch.integrator import SceneKernels, init_pool_state
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import shade
from tpu_ray_torch.renderer import pixel_grid, render, slot_ids

QMC_CUH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "tpu_ray_torch", "csrc", "qmc.cuh")
N = 1 << 12


def _inputs():
    r = np.random.default_rng(7)
    u32 = lambda: r.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    return u32(), u32(), np.uint32(r.integers(0, 1 << 32))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


@pytest.mark.parametrize("fn", ["pixel_uniforms", "lens_time_uniforms",
                                "bounce0_uniforms"])
def test_uniforms_bit_equal_to_jax(fn):
    slot, sidx, salt = _inputs()
    want = getattr(jqmc, fn)(jnp.asarray(slot), jnp.asarray(sidx), salt)
    got = getattr(qmc, fn)(_t(slot), _t(sidx), int(salt))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


@pytest.mark.parametrize("fn", ["bitrev32", "sobol2_bits", "owen_scramble",
                                "sobol_bits"])
def test_bit_functions_bit_equal_to_jax(fn):
    slot, sidx, _ = _inputs()
    if fn == "owen_scramble":
        want = jqmc.owen_scramble(jnp.asarray(slot), jnp.asarray(sidx))
        got = qmc.owen_scramble(_t(slot), _t(sidx))
    elif fn == "sobol_bits":
        for d in range(2, 11):
            dirs, jdirs = (getattr(m, f"_SOBOL{d}_V") for m in (qmc, jqmc))
            assert dirs == [int(v) for v in jdirs]
            np.testing.assert_array_equal(
                qmc.sobol_bits(_t(sidx), dirs).numpy(),
                _bits(jqmc.sobol_bits(jnp.asarray(sidx), jdirs)))
        return
    else:
        want = getattr(jqmc, fn)(jnp.asarray(slot))
        got = getattr(qmc, fn)(_t(slot))
    np.testing.assert_array_equal(got.numpy(), _bits(want))


def test_device_direction_tables_match():
    """csrc/qmc.cuh's SOBOL_V holds dims 2-5 as core/qmc.py computes them."""
    with open(QMC_CUH) as f:
        src = f.read()
    body = src[src.index("SOBOL_V[4][32]"):]
    body = body[:body.index("};")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9A-F]{8})u", body)]
    assert words == [v for dims in qmc.DEVICE_DIRS for v in dims]
    assert len(words) == 4 * 32


W, H, K = 16, 8, 2     # 256 lanes


def test_step_sobol_regen_matches_pallas():
    """The plain step with ``sampler="sobol"`` against the interpreted
    Pallas step kernel on a 256-lane pool two iterations in: the Sobol'
    regeneration keyed by (slot, plain global sample) with the salt in the
    scrambles; discrete outputs exact, floats at tests/test_torch_shade.py's
    tolerances."""
    name = "cornell"
    js = JSCENES[name].build(seed=1024, earth=None)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    cam = SCENES[name].camera(W, H).replace(sampler="sobol")
    cfg = shade.StepConfig.create(ps, cam, W, H, 4, n_samples=3, sample0=6,
                                  cam_salt=1024)
    assert cfg.sobol and shade._params(cfg, (0, 0), False)[24 + 11] & \
        shade.SAMPLER_SOBOL_BIT
    kern = SceneKernels.create(ps)
    st = init_pool_state(pixel_grid(W, H, K), slot_ids(W, H, K))
    R = st.slot.shape[0]
    st.fstate, st.istate = shade.pool_step(
        cfg, st.xy, st.slot, st.fstate, st.istate, torch.empty(R),
        torch.zeros(R, dtype=torch.int32), (0, 0), init=True)
    ki, ks = rng.pool_key_tables(rng.fold_in(rng.prng_key(1024), 2), 3)
    for it in range(2):
        bt, bi = kern.intersect(ps, st.fstate[:7], ki[it], st.slot)
        st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot,
                                               st.fstate, st.istate, bt, bi,
                                               ks[it])
    bt, bi = kern.intersect(ps, st.fstate[:7], ki[2], st.slot)
    fk, ik = shade.pool_step_plain(cfg, st.xy, st.slot, st.fstate, st.istate,
                                   bt, bi, ks[2])
    f, i = st.fstate.numpy(), st.istate.numpy()
    J = lambda a: jnp.asarray(np.ascontiguousarray(a))
    out = shade_pallas.pool_step_pallas(
        js, JSCENES[name].camera(W, H).replace(sampler="sobol"),
        J(st.xy[0].numpy()), J(st.xy[1].numpy()),
        J(st.slot.numpy().view(np.uint32)), J(f[0:3].T), J(f[3:6].T),
        J(f[6]), J(f[7:10].T), J(f[10:13].T), J(i[0]), J(i[1]), J(i[2] > 0),
        J(bt.numpy()), J(bi.numpy()), J(np.asarray(ks[2], np.uint32)), 3,
        np.uint32(6), np.uint32(1024), (1.0 / W, 1.0 / H), 4, interpret=True)
    o2, d2, tm2, tp2, ac2, bo2, sa2, av2 = (np.asarray(a) for a in out)
    fk, ik = fk.numpy(), ik.numpy()
    np.testing.assert_array_equal(ik[0], bo2)
    np.testing.assert_array_equal(ik[1], sa2)
    np.testing.assert_array_equal(ik[2], av2.astype(np.int32))
    regen = ik[1] > i[1]
    assert regen.sum() > 16, "too few lanes regenerated"
    np.testing.assert_allclose(fk[0:3].T, o2, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(fk[3:6].T, d2, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(fk[6], tm2, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(fk[7:10].T, tp2, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(fk[10:13].T, ac2, rtol=2e-4, atol=1e-5)
    # the regenerated rays are the Sobol' ones, not the hashed ones
    hashed = shade.camera_uniforms(False, st.slot, (6 + _t(i[1])) & rng.M32,
                                   1024)
    sob = shade.camera_uniforms(True, st.slot, (6 + _t(i[1])) & rng.M32, 1024)
    assert not torch.equal(hashed[0], sob[0])


def _sobol_pair(mode, engine="auto", sampler="sobol"):
    w, h = 10, 10
    kw = dict(spp=8, max_depth=6, seed=11)
    spec = SCENES["cornell"]
    b = render(spec.build(seed=1024), spec.camera(w, h).replace(
        sampler=sampler), w, h, device="cpu", mode=mode, engine=engine, **kw)
    return b, (w, h, kw)


@pytest.mark.parametrize("mode", ["pool", "queue"])
def test_sobol_render_matches_jax(mode):
    """The port's sobol pool and queue renders against the JAX package's
    sobol render of the same mode; both differ from the uniform render."""
    b, (w, h, kw) = _sobol_pair(mode)
    jspec = JSCENES["cornell"]
    a = np.asarray(jrender(jspec.build(seed=1024), jspec.camera(w, h).replace(
        sampler="sobol"), w, h, mode=mode, **kw))
    cross_engine(a, b)
    spec = SCENES["cornell"]
    u = render(spec.build(seed=1024), spec.camera(w, h), w, h, device="cpu",
               mode=mode, **kw)
    assert not np.array_equal(b, u)


def test_sobol_megakernel_matches_jax_pool():
    """The megakernel's plain twin with the Sobol' camera (its pool's
    regeneration) against the JAX package's sobol pool render: one
    estimator, the cross-engine criterion."""
    b, (w, h, kw) = _sobol_pair("pool", engine="mega")
    jspec = JSCENES["cornell"]
    a = np.asarray(jrender(jspec.build(seed=1024), jspec.camera(w, h).replace(
        sampler="sobol"), w, h, mode="pool", **kw))
    cross_engine(a, b)


@pytest.mark.parametrize("mode", ["pool", "queue"])
def test_sobol_b0_is_sobol_and_says_so(mode, capsys):
    """On the pool, sobol-b0 renders the sobol image bit for bit (the pool
    keeps the Sobol' camera dims with hashed scatter draws, as the JAX
    package's does) and prints the JAX package's stderr line.  On the work
    queue it is sobol plus the first-bounce override
    (tests/test_torch_sobol_b0.py holds it to the JAX XLA queue): another
    image, and no line."""
    a, _ = _sobol_pair(mode)
    capsys.readouterr()
    b, _ = _sobol_pair(mode, sampler="sobol-b0")
    err = capsys.readouterr().err
    said = "sampler=sobol-b0's bounce-dim override only runs on the XLA " \
           "work-queue path" in err
    if mode == "queue":
        assert not said
        assert (np.abs(a - b) > 1e-4).any(axis=-1).mean() > 0.5
    else:
        np.testing.assert_array_equal(a, b)
        assert said and "mode=pool" in err


@pytest.mark.parametrize("sampler", ["sobol", "sobol-b0"])
def test_wave_mode_refuses_low_discrepancy_samplers(sampler):
    spec = SCENES["cornell"]
    with pytest.raises(ValueError, match="mode='wave' draws camera samples"):
        render(spec.build(), spec.camera(8, 6).replace(sampler=sampler), 8,
               6, spp=1, max_depth=2, device="cpu", mode="wave")
    with pytest.raises(ValueError, match="unknown sampler"):
        render(spec.build(), spec.camera(8, 6).replace(sampler="halton"), 8,
               6, spp=1, max_depth=2, device="cpu")
