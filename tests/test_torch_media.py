"""The wavefront's media free flight: tpu_ray_torch.ops.intersect's
merge_media_plain (the media kernel's CPU twin) against the media branch of
tpu_ray.ops.intersect.intersect_ti (``_chunk_t`` over the media rows, then
its merge), on rays that start inside, outside and on the boundary of each
medium of cornell-smoke (two boxes under a transform) and next-week-final
(two spheres); and the wrapper's dispatch.  The whole intersect_ti,
solids and media, is held to JAX in test_torch_intersect.py; here both
sides merge the same solids, so rays that start on a solid's surface (a
medium's boundary can be one) test the media alone.

Hits and prim ids are exact, t within rtol 2e-5 (the tolerance of
test_torch_intersect.py); lane ids come from numpy."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_scene_arrays

from tpu_ray.core import rng as jrng
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops.intersect import _chunk_t
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.models.scene_data import PRIM_MEDIUM_SPHERE
from tpu_ray_torch.ops import intersect as isect
from tpu_ray_torch.ops import sweep as sw
from tpu_ray_torch.ops.shade import build_tables

KEY = jax.random.fold_in(jax.random.PRNGKey(0), 9)
KD = np.asarray(jax.random.key_data(KEY))
N_CLASS = 256       # rays per (medium, start class)


@pytest.fixture(scope="module", params=["cornell-smoke", "next-week-final"])
def scenes(request):
    js = JSCENES[request.param].build(seed=1024, earth=None)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    assert ps.n_prims - ps.n_solid == 2
    return request.param, js, ps


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _starts(ps, r):
    """Origins inside, on the boundary of and outside each medium, with
    directions (outside: aimed near the medium's centre)."""
    p = ps.prims
    ro, rd, cls = [], [], []
    for j in range(ps.n_solid, ps.n_prims):
        if int(p.kind[j]) == PRIM_MEDIUM_SPHERE:
            c = p.center[j].numpy().astype(np.float64)
            rad = float(p.radius[j])
            ins = c + rad * r.random((N_CLASS, 1)) ** (1 / 3) \
                * _unit(r, N_CLASS)
            bnd = c + rad * _unit(r, N_CLASS)
            out = c + rad * r.uniform(1.2, 3.0, (N_CLASS, 1)) \
                * _unit(r, N_CLASS)
            aim = c + 0.5 * rad * _unit(r, N_CLASS)
        else:
            lo, hi = p.box_min[j].numpy(), p.box_max[j].numpy()
            rot = p.xf_rot[j].numpy().reshape(3, 3)
            off = p.xf_off[j].numpy()
            world = lambda x: x @ rot.T + off      # x_w = R x_o + off
            ins = world(r.uniform(lo, hi, (N_CLASS, 3)))
            face = r.uniform(lo, hi, (N_CLASS, 3))
            axis = r.integers(0, 3, N_CLASS)
            side = r.integers(0, 2, N_CLASS)
            face[np.arange(N_CLASS), axis] = np.where(side, hi[axis],
                                                      lo[axis])
            bnd = world(face)
            ext = float(np.linalg.norm(hi - lo))
            centre = world((lo + hi) / 2)
            out = centre + ext * r.uniform(0.8, 2.0, (N_CLASS, 1)) \
                * _unit(r, N_CLASS)
            aim = world(r.uniform(lo, hi, (N_CLASS, 3)))
        for k, (o, d) in enumerate(((ins, _unit(r, N_CLASS)),
                                    (bnd, _unit(r, N_CLASS)),
                                    (out, aim - out))):
            ro.append(o)
            rd.append(d * r.uniform(0.3, 2.0, (N_CLASS, 1)))
            cls.append(np.full(N_CLASS, k))
    n = len(cls) * N_CLASS
    return (np.concatenate(ro).astype(np.float32),
            np.concatenate(rd).astype(np.float32),
            r.random(n, dtype=np.float32), np.concatenate(cls))


def _jax_media(js, ro, rd, rt, ids):
    """The JAX package's media sweep alone: ``_chunk_t`` over the media
    rows as ``intersect_ti`` runs it, (R, n_media) free-flight distances."""
    u_med = jrng.lane_uniforms(KEY, jnp.asarray(ids), js.n_media)
    rows = jax.tree.map(lambda a: a[js.n_solid:js.n_prims], js.prims)
    return np.asarray(_chunk_t(js, rows, jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(rt), u_med,
                               jnp.float32(js.t_min), float("inf"),
                               do_spheres=False, do_quads=False,
                               do_media=True, do_boxes=False))


def test_merge_media_plain_matches_jax(scenes):
    """Against nothing solid (best_t = +inf) and against the solids' sweep,
    each merged by intersect_ti's rule (the first medium of least t,
    replacing the solid where strictly closer)."""
    name, js, ps = scenes
    r = np.random.default_rng(12)
    ro, rd, rt, cls = _starts(ps, r)
    ids = r.integers(0, 1 << 32, ro.shape[0], dtype=np.uint32)
    tm = _jax_media(js, ro, rd, rt, ids)
    ct = tm.min(axis=1)
    cidx = tm.argmin(axis=1).astype(np.int32) + ps.n_solid
    rays = isect.pack_rays(*(torch.from_numpy(x) for x in (ro, rd, rt)))
    lanes = torch.from_numpy(ids.view(np.int32))
    media = isect.media_rows(ps)
    R = rays.shape[1]
    solids = sw.sweep_plain(rays, sw.sweep_table(ps), sw._ranges(ps),
                            ps.t_min)
    for bt, bi in ((torch.full((R,), float("inf")),
                    torch.zeros((R,), dtype=torch.int32)), solids):
        closer = ct < bt.numpy()
        want_t = np.where(closer, ct, bt.numpy())
        want_i = np.where(closer, cidx, bi.numpy())
        calls = isect.merge_media_plain.calls
        t, i = isect.merge_media_plain(ps, rays, KD, lanes, media, bt, bi)
        assert isect.merge_media_plain.calls == calls + 1
        t, i = t.numpy(), i.numpy()
        hit = np.isfinite(want_t)
        np.testing.assert_array_equal(np.isfinite(t), hit)
        np.testing.assert_array_equal(i[hit], want_i[hit])
        np.testing.assert_allclose(t[hit], want_t[hit], rtol=2e-5)
        in_medium = hit & (want_i >= ps.n_solid)
        for k in range(3):      # each start class has free flights ending
            assert in_medium[cls == k].sum() >= 10, (name, k)


def test_media_rows_table_is_the_prim_tables(scenes):
    """The rows the media kernel reads are the (N, 40) prim table's media
    rows (the BVH kernel's and the megakernel's input) in every column
    csrc/media.cuh reads, and the slots are the media's draw columns."""
    _, _, ps = scenes
    media = isect.media_rows(ps)
    tab = build_tables(ps)[0][ps.n_solid:]
    cols = [0, *range(2, 13), *range(30, 39)]
    np.testing.assert_array_equal(media.table.numpy()[:, cols], tab[:, cols])
    np.testing.assert_array_equal(media.slots.numpy(),
                                  [m["slot"] for m in media])
    assert media.table.dtype == torch.float32
    assert media.slots.dtype == torch.int32


def test_merge_media_takes_plain_path_on_cpu_only(scenes):
    """On CPU tensors the wrapper runs the twin and counts no launch; the
    kernel's launch has no plain fallback: it raises on CPU tensors."""
    _, _, ps = scenes
    r = np.random.default_rng(13)
    ro, rd, rt, _ = _starts(ps, r)
    rays = isect.pack_rays(*(torch.from_numpy(x) for x in (ro, rd, rt)))
    R = rays.shape[1]
    lanes = torch.arange(R, dtype=torch.int32)
    bt, bi = sw.sweep_plain(rays, sw.sweep_table(ps), sw._ranges(ps),
                            ps.t_min)
    media = isect.media_rows(ps)
    before = isect.merge_media.launches, isect.merge_media_plain.calls
    got = isect.merge_media(ps, rays, KD, lanes, media, bt, bi)
    want = isect.merge_media_plain(ps, rays, KD, lanes, media, bt, bi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert isect.merge_media.launches == before[0]
    assert isect.merge_media_plain.calls == before[1] + 2
    with pytest.raises(ValueError, match="CUDA"):
        isect.merge_media_launch(ps, rays, KD, lanes, media, bt, bi)
    assert isect.merge_media.launches == before[0]


def test_media_ops_counts_each_kind():
    """The operation count of the kernel's bound: a lane's share and each
    medium's by its kind."""
    sphere = {"kind": PRIM_MEDIUM_SPHERE}
    box = {"kind": PRIM_MEDIUM_SPHERE + 1}
    ops = isect.MEDIA_OPS
    assert isect.media_ops([sphere, box], False) == \
        isect.MEDIA_LANE_OPS + ops["sphere"] + ops["box"]
    assert isect.media_ops([box, box], True) == \
        isect.MEDIA_LANE_OPS + 2 * ops["box_xf"]
