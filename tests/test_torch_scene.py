"""Scene build, conversion and camera: tpu_ray_torch against tpu_ray.

Every port SceneData array is bit-equal to the JAX leaf (same dtype, same
bits) and every static field equal; a JAX scene carried across with
tpu_ray_torch.convert renders the very same arrays; camera frames are
bit-equal and camera rays agree to the last ulp class."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import SCENE_NAMES, jax_scene_arrays

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray_torch.convert import scene_from_jax_arrays, scene_to_arrays
from tpu_ray_torch.models.scene_data import STATIC_FIELDS
from tpu_ray_torch.models.scenes import SCENES


def _assert_same(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k in STATIC_FIELDS:
            assert port[k] == v, k
            continue
        p = port[k]
        assert p.dtype == v.dtype, (k, p.dtype, v.dtype)
        assert p.shape == v.shape, (k, p.shape, v.shape)
        np.testing.assert_array_equal(p.view(np.uint8), v.view(np.uint8),
                                      err_msg=k)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_scene_arrays_bit_equal(name):
    ref = jax_scene_arrays(JSCENES[name].build(seed=1024, earth=None))
    port = scene_to_arrays(SCENES[name].build(seed=1024, earth=None))
    _assert_same(port, ref)


@pytest.mark.parametrize("name", ["cornell", "book1-final"])
def test_convert_round_trip(name):
    ref = jax_scene_arrays(JSCENES[name].build(seed=1024, earth=None))
    scene = scene_from_jax_arrays(ref)
    assert scene.prims.center.dtype == torch.float32
    assert scene.texs.perlin_salt.dtype == torch.uint32
    _assert_same(scene_to_arrays(scene), ref)
    _assert_same(scene_to_arrays(scene_from_jax_arrays(
        scene_to_arrays(scene))), ref)


def test_scene_moves_between_devices():
    scene = SCENES["cornell"].build()
    moved = scene.to("cpu")
    assert moved.n_prims == scene.n_prims and moved.t_min == scene.t_min
    assert moved.prims.quad_n.device.type == "cpu"
    assert moved.device.type == "cpu"


def test_next_week_final_builds_bit_equal_on_cpu():
    """The >512-prim scene builds here too (it renders in a later slice);
    both packages on the CPU give the same arrays."""
    ref = jax_scene_arrays(JSCENES["next-week-final"].build(seed=1024,
                                                            earth=None))
    port = scene_to_arrays(SCENES["next-week-final"].build(seed=1024,
                                                           earth=None))
    _assert_same(port, ref)


@pytest.mark.parametrize("name,w,h", [("cornell", 500, 500),
                                      ("book1-final", 600, 400),
                                      ("two-spheres", 32, 24)])
def test_camera_frame_bit_equal(name, w, h):
    jc = JSCENES[name].camera(w, h)
    pc = SCENES[name].camera(w, h)
    for f in ("origin", "lower_left", "horizontal", "vertical", "u", "v",
              "w", "lens_radius", "time0", "time1"):
        a = np.asarray(getattr(jc, f))
        b = getattr(pc, f).numpy()
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_camera_rays_from_uniforms_match():
    jc = JSCENES["book1-final"].camera(64, 48)
    pc = SCENES["book1-final"].camera(64, 48)
    r = np.random.default_rng(4)
    s, t = r.random(512, np.float32), r.random(512, np.float32)
    u3 = r.random((512, 3), np.float32)
    ja = [np.asarray(x) for x in jc.rays_from_uniforms(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(u3))]
    pa = [x.numpy() for x in pc.rays_from_uniforms(
        torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(u3))]
    for a, b in zip(ja, pa):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_camera_vec_layout():
    """The 21 camera words the pool step reads (megakernel._camera_vec)."""
    from tpu_ray.ops.megakernel import _camera_vec

    jc = JSCENES["cornell"].camera(32, 24)
    want = np.asarray(_camera_vec(jc))[0]
    np.testing.assert_array_equal(SCENES["cornell"].camera(32, 24).vec(),
                                  want)
    assert jax.devices()[0].platform == "cpu"


def test_vec_matches_jax():
    """tpu_ray_torch.core.vec against tpu_ray.core.vec on random vectors."""
    from tpu_ray.core import vec as jvec
    from tpu_ray_torch.core import vec

    r = np.random.default_rng(8)
    a, b = (r.normal(size=(256, 3)).astype(np.float32) for _ in range(2))
    a[0] = 0.0                                     # zero-safe normalize
    ratio = r.uniform(0.5, 1.6, 256).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), \
        torch.from_numpy(b)
    un = vec.normalize(tb)
    pairs = [
        (vec.dot(ta, tb), jvec.dot(ja, jb)),
        (vec.cross(ta, tb), jvec.cross(ja, jb)),
        (vec.normalize(ta), jvec.normalize(ja)),
        (vec.reflect(ta, tb), jvec.reflect(ja, jb)),
        (vec.refract(un, vec.normalize(ta), torch.from_numpy(ratio)),
         jvec.refract(jvec.normalize(jb), jvec.normalize(ja),
                      jnp.asarray(ratio))),
        (vec.onb_local(vec.onb_from_w(ta), tb),
         jvec.onb_local(jvec.onb_from_w(ja), jb)),
        (vec.take_rows(ta, torch.tensor([3, 1, 3])),
         jvec.take_rows(ja, jnp.asarray([3, 1, 3]))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
