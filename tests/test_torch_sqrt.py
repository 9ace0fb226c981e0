"""Correctly rounded square roots in the port's float32 plain versions.

``torch.sqrt`` on the CPU is not correctly rounded (a vector library; 1 ulp
off on a fraction of a percent of float32 inputs), while ``jnp.sqrt`` and
the CUDA kernels' ``sqrtf`` are.  The port's plain versions take their roots
from ``core.vec.sqrt_rn``.  Each function that takes a root is held here to
its JAX counterpart bit for bit, on seeded inputs where only the root could
differ: angles of 0 wherever a cosine or sine follows (both libraries give
exactly 1 and 0 there), and for the media only the lanes whose free-flight
logarithm the two libraries round alike."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_scene_arrays

from tpu_ray.core import vec as jvec
from tpu_ray.models import objects as job
from tpu_ray.models.compile import build_scene as jbuild
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops import megakernel as jmk
from tpu_ray.ops.intersect import intersect_ti as j_intersect_ti
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import rng, vec
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import shade
from tpu_ray_torch.ops.intersect import intersect_ti, pack_rays

N = 1 << 16


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    assert a.shape == b.shape
    diff = a.view(np.int32) != b.view(np.int32)
    assert not diff.any(), f"{int(diff.sum())} of {diff.size} values differ"


def _vectors(seed, n=N, scale=10.0):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale) \
        .astype(np.float32)


def test_sqrt_rn_is_correctly_rounded_where_torch_sqrt_is_not():
    r = np.random.default_rng(0)
    x = np.concatenate([
        (r.random(N - 6, dtype=np.float32) * 100.0).astype(np.float32),
        np.array([0.0, -0.0, np.inf, 1e-45, 1e-38, 3.4e38], np.float32)])
    want = np.sqrt(x)
    _bits_equal(vec.sqrt_rn(torch.from_numpy(x)).numpy(), want)
    assert (torch.sqrt(torch.from_numpy(x)).numpy().view(np.int32)
            != want.view(np.int32)).any(), "torch.sqrt is correctly rounded"
    # float64 and the card take torch.sqrt as it is
    xd = torch.from_numpy(x.astype(np.float64))
    assert vec.sqrt_rn(xd).dtype == torch.float64
    assert torch.equal(vec.sqrt_rn(xd), torch.sqrt(xd))


def _pair_vec_length():
    a = _vectors(1)
    return vec.length(torch.from_numpy(a)).numpy(), jvec.length(a)


def _pair_vec_normalize():
    a = _vectors(2)
    a[:16] = 0.0                                       # zero-safe lanes
    return vec.normalize(torch.from_numpy(a)).numpy(), jvec.normalize(a)


def _refract_inputs(seed):
    r = np.random.default_rng(seed)
    uv = jvec.normalize(r.normal(size=(N, 3)).astype(np.float32))
    n = jvec.normalize(r.normal(size=(N, 3)).astype(np.float32))
    ratio = r.uniform(0.5, 1.6, N).astype(np.float32)
    return np.array(uv), np.array(n), ratio


def _pair_vec_refract():
    uv, n, ratio = _refract_inputs(3)
    got = vec.refract(*(torch.from_numpy(x) for x in (uv, n, ratio)))
    return got.numpy(), jvec.refract(uv, n, ratio)


def _pair_camera_defocus():
    """The lens-disk sample of the camera: r = lens radius x sqrt(u), at
    phi = 0."""
    W, H = 64, 48
    tcam = SCENES["book1-final"].camera(W, H)
    jcam = JSCENES["book1-final"].camera(W, H)
    assert float(tcam.lens_radius) > 0.0
    r = np.random.default_rng(4)
    s, t = (r.random(N, dtype=np.float32) for _ in range(2))
    u3 = r.random((N, 3), dtype=np.float32)
    u3[:, 1] = 0.0
    got = tcam.rays_from_uniforms(*(torch.from_numpy(x) for x in (s, t, u3)))
    want = jcam.rays_from_uniforms(s, t, u3)
    return (np.concatenate([g.numpy().reshape(N, -1) for g in got], 1),
            np.concatenate([np.asarray(w).reshape(N, -1) for w in want], 1))


def _stack(xs):
    return np.stack([np.asarray(x) for x in xs])


def _pair_shade_normalize():
    a = _vectors(5).T
    got = shade._normalize(tuple(torch.from_numpy(x.copy()) for x in a))
    return _stack(got), _stack(jmk._normalize(tuple(a)))


def _pair_shade_refract():
    uv, n, ratio = _refract_inputs(6)
    T = lambda x: tuple(torch.from_numpy(c.copy()) for c in x.T)
    got = shade._refract(T(uv), T(n), torch.from_numpy(ratio))
    want = jmk._refract(tuple(uv.T), tuple(n.T), ratio)
    return _stack(got), _stack(want)


def _pair_shade_unit_vector():
    u1 = np.random.default_rng(7).random(N, dtype=np.float32)
    u0 = np.zeros_like(u1)
    got = shade._unit_vector_from(torch.from_numpy(u0), torch.from_numpy(u1))
    return _stack(got), _stack(jmk._unit_vector_from(u0, u1))


def _pair_shade_cosine_direction():
    u1 = np.random.default_rng(8).random(N, dtype=np.float32)
    u0 = np.zeros_like(u1)
    got = shade._cosine_direction_from(torch.from_numpy(u0),
                                       torch.from_numpy(u1))
    return _stack(got), _stack(jmk._cosine_direction_from(u0, u1))


def _pair_shade_to_sphere():
    r = np.random.default_rng(9)
    u1 = r.random(N, dtype=np.float32)
    u0 = np.zeros_like(u1)
    radius = r.uniform(0.1, 5.0, N).astype(np.float32)
    d2 = (radius * radius * r.uniform(1.0, 50.0, N)).astype(np.float32)
    got = shade._to_sphere_from(*(torch.from_numpy(x)
                                  for x in (u0, u1, radius, d2)))
    return _stack(got), _stack(jmk._to_sphere_from(u0, u1, radius, d2))


def _pair_media_free_flight():
    """A sphere medium and a box medium (untransformed: the JAX package
    rotates rays into a box's frame by a matrix product), rays from inside
    and outside both: (t, i) of the port's intersect_ti and of the JAX one
    on the lanes whose free-flight logarithms agree."""
    fog = job.Isotropic((1, 1, 1))
    objs = [job.ConstantMedium(1.0, (1, 1, 1),
                               job.Sphere((0.0, 0.0, 0.0), 7.0, fog)),
            job.ConstantMedium(0.5, (1, 1, 1), job.Box(
                (-1.0, -6.0, -3.0), (7.0, 2.0, 5.0), fog))]
    js = jbuild(objs)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    n = 4096
    r = np.random.default_rng(10)
    ro = r.uniform(-9, 9, (n, 3)).astype(np.float32)
    rd = (r.normal(size=(n, 3)) * r.uniform(0.2, 3.0, (n, 1))) \
        .astype(np.float32)
    rt = r.random(n, dtype=np.float32)
    ids = r.integers(0, 1 << 32, n, dtype=np.uint32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 11)
    kd = np.asarray(jax.random.key_data(key))
    lanes = torch.from_numpy(ids.view(np.int32))
    t, i = intersect_ti(ps, pack_rays(*(torch.from_numpy(x)
                                        for x in (ro, rd, rt))), kd, lanes)
    jt, ji = j_intersect_ti(js, jnp.asarray(ro), jnp.asarray(rd),
                            jnp.asarray(rt), key, lane_ids=jnp.asarray(ids))
    u = rng.lane_uniforms(kd, lanes, ps.n_media).clamp(min=1e-12)
    same_log = (torch.log(u).numpy().view(np.int32)
                == np.asarray(jnp.log(u.numpy())).view(np.int32)).all(1)
    assert same_log.mean() > 0.5
    assert (np.isfinite(np.asarray(jt)) & same_log).sum() > n // 4
    assert (i.numpy() == np.asarray(ji)).all()
    return t.numpy()[same_log], np.asarray(jt)[same_log]


PAIRS = {
    "core.vec.length~tpu_ray.core.vec.length": _pair_vec_length,
    "core.vec.normalize~tpu_ray.core.vec.normalize": _pair_vec_normalize,
    "core.vec.refract~tpu_ray.core.vec.refract": _pair_vec_refract,
    "core.camera.rays_from_uniforms~tpu_ray.core.camera.rays_from_uniforms":
        _pair_camera_defocus,
    "ops.shade._normalize~tpu_ray.ops.megakernel._normalize":
        _pair_shade_normalize,
    "ops.shade._refract~tpu_ray.ops.megakernel._refract": _pair_shade_refract,
    "ops.shade._unit_vector_from~tpu_ray.ops.megakernel._unit_vector_from":
        _pair_shade_unit_vector,
    "ops.shade._cosine_direction_from~"
    "tpu_ray.ops.megakernel._cosine_direction_from":
        _pair_shade_cosine_direction,
    "ops.shade._to_sphere_from~tpu_ray.ops.megakernel._to_sphere_from":
        _pair_shade_to_sphere,
    "ops.intersect._media_t~tpu_ray.ops.intersect.intersect_ti (media)":
        _pair_media_free_flight,
}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_root_taking_function_is_bit_equal_to_jax(pair):
    got, want = PAIRS[pair]()
    _bits_equal(got, want)
