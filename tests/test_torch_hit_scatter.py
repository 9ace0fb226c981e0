"""The unfused hit record + scatter: tpu_ray_torch's plain version against
the JAX kernel it ports (shade_pallas.hit_scatter_pallas, interpret mode)
and against the XLA pair it stands in for (_hit_record + scatter).

All three take the same 1024 rays (512 camera rays, then the continuation
rays of the lanes that scattered), the same (best_t, best_i) from JAX's
intersect_ti, the same scene arrays and the same key words.  Discrete
outputs (hit, front, material, scattered) are exact; floats agree at the
tolerances of tests/test_shade_pallas.py:39-88."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_scene_arrays

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops import shade_pallas
from tpu_ray.ops.intersect import _hit_record, intersect_ti
from tpu_ray.ops.scatter import scatter
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import rng
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import hit_scatter as hs
from tpu_ray_torch.ops.intersect import intersect_ti as port_intersect_ti
from tpu_ray_torch.ops.intersect import pack_rays
from tpu_ray_torch.ops.shade import StepConfig

NAMES = ["book1-final", "two-spheres", "cornell", "cornell-smoke",
         "next-week-final", "earth"]
R, W, H = 512, 64, 48


def _jax_scene(name):
    if name == "earth":       # a seeded image: earthmap.jpg is not shipped
        img = np.random.default_rng(3).integers(0, 256, (32, 64, 3), np.uint8)
        return JSCENES[name].build(seed=1024, earth=img)
    return JSCENES[name].build(seed=1024, earth=None)


@functools.lru_cache(maxsize=None)
def _results(name):
    """The three results on R camera rays followed by the R continuation
    rays of the lanes that scattered (one interpreted kernel call)."""
    js = _jax_scene(name)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    cfg = StepConfig.create(ps, SCENES[name].camera(W, H), W, H, 8)
    xs = jnp.tile(jnp.linspace(0.05, 0.95, 64), R // 64)
    ys = jnp.repeat(jnp.linspace(0.05, 0.95, R // 64), 64)
    ro, rd, rt = JSCENES[name].camera(W, H).get_rays(jax.random.PRNGKey(5),
                                                     xs, ys)
    ids = jnp.arange(2 * R, dtype=jnp.uint32) * jnp.uint32(2654435761)
    key = jax.random.PRNGKey(11)
    k0, k1 = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
    T = lambda a: torch.from_numpy(np.array(a))
    # the continuation rays are only inputs: the port makes them
    rays = pack_rays(T(ro), T(rd), T(rt))
    lanes = T(np.asarray(ids[:R]).view(np.int32))
    bt, bi = port_intersect_ti(ps, rays, (7, 9), lanes)
    rec, sc = hs.hit_scatter_plain(cfg, rays, bt, bi, (3, 5), lanes)
    cont = (rec.hit & sc.scattered).numpy()[:, None]
    ro = jnp.concatenate([ro, jnp.where(cont, rec.point.numpy().T, ro)])
    rd = jnp.concatenate([rd, jnp.where(cont, sc.direction.numpy().T, rd)])
    rt = jnp.concatenate([rt, rt])

    bt, bi = intersect_ti(js, ro, rd, rt, k0, lane_ids=ids)
    rec_x = _hit_record(js, ro, rd, rt, bt, bi)
    sc_x = scatter(js, k1, rd, rec_x, ids)
    rec_k, sc_k = shade_pallas.hit_scatter_pallas(js, ro, rd, rt, bt, bi, k1,
                                                  ids, interpret=True)
    rec_p, sc_p = hs.hit_scatter_plain(
        cfg, pack_rays(T(ro), T(rd), T(rt)), T(bt), T(bi),
        rng.fold_in(rng.prng_key(11), 1), T(np.asarray(ids).view(np.int32)))
    return js, ((rec_p, sc_p), (rec_k, sc_k), (rec_x, sc_x))


def _close_lanes(a, b, rtol, atol, loose_lanes=0):
    """assert_allclose, except that up to ``loose_lanes`` lanes may be off
    by 10x the tolerance (the marble texture amplifies a 1-ulp difference
    of the hit point, see tests/test_torch_shade.py)."""
    bad = (np.abs(a - b) > atol + rtol * np.abs(b)).any(axis=-1)
    assert bad.sum() <= loose_lanes, f"{bad.sum()} lanes out of tolerance"
    np.testing.assert_allclose(a[~bad], b[~bad], rtol=rtol, atol=atol)
    np.testing.assert_allclose(a[bad], b[bad], rtol=10 * rtol, atol=10 * atol)


def _hold(name, which):
    js, res = _results(name)
    n_cont = 0
    for (rec, sc), (rec_r, sc_r) in ((res[0], res[which]),):
        N = lambda a: np.asarray(a)
        np.testing.assert_array_equal(rec.hit.numpy(), N(rec_r.hit))
        np.testing.assert_array_equal(rec.front.numpy(), N(rec_r.front))
        np.testing.assert_array_equal(rec.mat.numpy(), N(rec_r.mat))
        np.testing.assert_array_equal(sc.scattered.numpy(), N(sc_r.scattered))
        tol = dict(rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(rec.point.numpy().T, N(rec_r.point),
                                   rtol=2e-4, atol=1e-3)
        np.testing.assert_allclose(rec.normal.numpy().T, N(rec_r.normal),
                                   **tol)
        if js.has_image:
            np.testing.assert_allclose(rec.u.numpy(), N(rec_r.u), **tol)
            np.testing.assert_allclose(rec.v.numpy(), N(rec_r.v), **tol)
        np.testing.assert_allclose(sc.direction.numpy().T, N(sc_r.direction),
                                   rtol=1e-3, atol=1e-4)
        loose = 2 if js.has_perlin else 0
        _close_lanes(sc.weight.numpy().T, N(sc_r.weight), loose_lanes=loose,
                     **tol)
        _close_lanes(sc.emitted.numpy().T, N(sc_r.emitted),
                     loose_lanes=loose, **tol)
        n_cont += int((rec.hit & sc.scattered).sum())
    assert n_cont > 32, "too few lanes hit and scattered"


@pytest.mark.parametrize("name", NAMES)
def test_hit_scatter_plain_matches_pallas(name):
    _hold(name, 1)


@pytest.mark.parametrize("name", NAMES)
def test_hit_scatter_plain_matches_hit_record_and_scatter(name):
    _hold(name, 2)


def test_hit_scatter_wrapper_counts_and_checks():
    ps = SCENES["two-spheres"].build()
    cfg = StepConfig.create(ps, SCENES["two-spheres"].camera(W, H), W, H, 8)
    rays = torch.zeros((7, 64))
    rays[3:6] = 1.0
    args = (rays, torch.full((64,), float("inf")),
            torch.zeros(64, dtype=torch.int32), (1, 2),
            torch.arange(64, dtype=torch.int32))
    before = hs.hit_scatter.launches, hs.hit_scatter_plain.calls
    rec, sc = hs.hit_scatter(cfg, *args)
    assert hs.hit_scatter.launches == before[0]         # CPU: no kernel
    assert hs.hit_scatter_plain.calls == before[1] + 1
    assert not rec.hit.any() and rec.point.shape == (3, 64)
    assert sc.emitted.shape == (3, 64) and sc.scattered.dtype == torch.bool
    with pytest.raises(ValueError):
        hs.hit_scatter(cfg, rays, args[1], args[2].long(), *args[3:])
    with pytest.raises(ValueError):
        hs.hit_scatter(cfg, rays[:, ::2], *args[1:])
