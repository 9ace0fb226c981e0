"""The sorted, compacted-list sweep: tpu_ray_torch's plain version against
the port's dense sweep (bit for bit) and against the JAX package's sorted
Pallas sweep (intersect_solids_pallas(sort=True), interpret mode), and its
host-side pieces (sort key, block boxes, tile lists) bit-equal to JAX's."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_scene_arrays, mixed_scene

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops import intersect_pallas as ip
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.integrator import SceneKernels
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import sweep as sw
from tpu_ray_torch.ops.intersect import intersect_ti, pack_rays

NAMES = ["next-week-final", "book1-final", "random-moving", "cornell"]


def _rays(name, n=700, seed=5):
    """Half camera rays (coherent: whole tiles skip blocks), half rays
    scattered about the scene; n is not a multiple of the 256-ray tile."""
    r = np.random.default_rng(seed)
    cam = SCENES[name].camera(40, 30)
    u = torch.from_numpy(r.random((n, 5)).astype(np.float32))
    ro, rd, rt = cam.rays_from_uniforms(u[:, 0], u[:, 1], u[:, 2:5])
    ro, rd, rt = ro.numpy().copy(), rd.numpy().copy(), rt.numpy().copy()
    span = 500.0 if name in ("next-week-final", "cornell") else 12.0
    ro[n // 2:] = r.uniform(-span, span, (n - n // 2, 3))
    rd[n // 2:] = r.normal(size=(n - n // 2, 3))
    return ro.astype(np.float32), rd.astype(np.float32), rt


def _scenes(name):
    js = JSCENES[name].build(seed=1024, earth=None)
    return js, scene_from_jax_arrays(jax_scene_arrays(js))


@pytest.mark.parametrize("name", NAMES)
def test_sort_key_and_tile_lists_bit_equal_to_jax(name):
    js, ps = _scenes(name)
    ro, rd, rt = _rays(name)
    rays = pack_rays(*(torch.from_numpy(a) for a in (ro, rd, rt)))
    blocks = sw.sweep_blocks(ps)
    key = sw.sort_key(blocks, rays)
    np.testing.assert_array_equal(
        key.numpy().astype(np.uint32),
        np.asarray(ip._sort_key(js, jnp.asarray(ro), jnp.asarray(rd))))
    perm = torch.sort(key, stable=True).indices
    srays = rays[:, perm].contiguous()
    pad = (-ro.shape[0]) % sw.TILE_R
    sro = jnp.pad(jnp.asarray(ro[perm.numpy()]), ((0, pad), (0, 0)))
    srd = jnp.pad(jnp.asarray(rd[perm.numpy()]), ((0, pad), (0, 0)),
                  constant_values=1.0)
    n_sb = js.n_sphere + js.n_box
    spans = ((0, js.n_sphere_static, "sphere"),
             (js.n_sphere_static, js.n_sphere, "sphere"),
             (js.n_sphere, n_sb, "box"), (n_sb, js.n_solid, "quad"))
    skipped = total = 0
    for (lo, hi, flavor), (b0, b1) in zip(spans, blocks.spans):
        assert b1 - b0 == -(-(hi - lo) // sw.PBLK)
        if hi <= lo:
            continue
        alo, ahi = ip._range_aabbs(js, lo, hi, flavor)
        blo, bhi = ip._block_aabbs(alo, ahi, (-(hi - lo)) % sw.PBLK)
        np.testing.assert_array_equal(blocks.blo[b0:b1].numpy(),
                                      np.asarray(blo))
        np.testing.assert_array_equal(blocks.bhi[b0:b1].numpy(),
                                      np.asarray(bhi))
        cnt_j, lst_j = ip._tile_lists(sro, srd, blo, bhi, float(js.t_min))
        cnt, lst, _ = sw.tile_lists(srays, blocks.blo[b0:b1],
                                    blocks.bhi[b0:b1], ps.t_min)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j)[:, 0])
        np.testing.assert_array_equal(lst.numpy(), np.asarray(lst_j))
        total += cnt.numel() * (b1 - b0)
        skipped += cnt.numel() * (b1 - b0) - int(cnt.sum())
    if name == "next-week-final":
        assert blocks.n_blocks == 14 and skipped > 0.1 * total


@pytest.mark.parametrize("n", [77, 1000])
@pytest.mark.parametrize("name", ["next-week-final", "book1-final"])
def test_tile_lists_bit_equal_to_jax_at_ragged_ray_counts(name, n):
    """The reference of the card's list pass at ray counts that leave a
    short last tile (77: one tile, mostly pad rays), over all blocks at
    once: the plain twin equals JAX's per kind range and the mask's row
    sums are the counts."""
    js, ps = _scenes(name)
    ro, rd, rt = _rays(name, n=n, seed=n)
    rays = pack_rays(*(torch.from_numpy(a) for a in (ro, rd, rt)))
    blocks = sw.sweep_blocks(ps)
    perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
    srays = rays[:, perm].contiguous()
    calls = sw.tile_lists_plain.calls
    cnt, lst, order = sw.tile_lists(srays, blocks.blo, blocks.bhi, ps.t_min)
    assert sw.tile_lists_plain.calls == calls + 1        # CPU: the plain twin
    T = -(-n // sw.TILE_R)
    assert cnt.shape == (T,) and lst.shape == (T, blocks.n_blocks)
    # the launch order: the tiles by descending count
    assert torch.equal(torch.sort(order).values,
                       torch.arange(T, dtype=torch.int32))
    assert bool((cnt[order.long()].diff() <= 0).all())
    pad = T * sw.TILE_R - n
    sro = jnp.pad(jnp.asarray(ro[perm.numpy()]), ((0, pad), (0, 0)))
    srd = jnp.pad(jnp.asarray(rd[perm.numpy()]), ((0, pad), (0, 0)),
                  constant_values=1.0)
    alo = np.concatenate([np.asarray(ip._block_aabbs(
        *ip._range_aabbs(js, lo, hi, fl), (-(hi - lo)) % sw.PBLK)[0])
        for lo, hi, fl in _spans(js) if hi > lo])
    ahi = np.concatenate([np.asarray(ip._block_aabbs(
        *ip._range_aabbs(js, lo, hi, fl), (-(hi - lo)) % sw.PBLK)[1])
        for lo, hi, fl in _spans(js) if hi > lo])
    cnt_j, lst_j = ip._tile_lists(sro, srd, jnp.asarray(alo),
                                  jnp.asarray(ahi), float(js.t_min))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j)[:, 0])
    np.testing.assert_array_equal(lst.numpy(), np.asarray(lst_j))
    mask = sw.needed_mask(srays, blocks.blo, blocks.bhi, ps.t_min)
    np.testing.assert_array_equal(mask.sum(1).numpy(), cnt.numpy())


def _spans(js):
    n_sb = js.n_sphere + js.n_box
    return ((0, js.n_sphere_static, "sphere"),
            (js.n_sphere_static, js.n_sphere, "sphere"),
            (js.n_sphere, n_sb, "box"), (n_sb, js.n_solid, "quad"))


def test_list_pass_and_compacted_kernel_take_cuda_tensors_only():
    """No plain fallback: the card's entry points raise on CPU tensors,
    while the dispatching wrappers take the plain twins there."""
    ps = mixed_scene()
    rays = torch.zeros((7, 300))
    rays[3:6] = 1.0
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    launches = sw.list_pass.launches
    with pytest.raises(ValueError, match="CUDA"):
        sw.list_pass(rays, blocks.blo, blocks.bhi, ps.t_min)
    calls = sw.needed_mask_plain.calls, sw.tile_lists_plain.calls
    sw.needed_mask(rays, blocks.blo, blocks.bhi, ps.t_min)
    cnt, lst, order = sw.tile_lists(rays, blocks.blo, blocks.bhi, ps.t_min)
    assert (sw.needed_mask_plain.calls, sw.tile_lists_plain.calls) == \
        (calls[0] + 1, calls[1] + 1)
    assert sw.list_pass.launches == launches
    # the sweep's options belong to the kernel; on the CPU the plain twin
    # gives the same result whatever they say
    a = sw.sweep_compact(rays, geo, blocks, cnt, lst, order, ps.t_min)
    b = sw.sweep_compact(rays, geo, blocks, cnt, lst, order.flip(0),
                         ps.t_min, rpt=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_pick_rpt_compact_fills_every_sm_before_it_packs_rays(sms):
    full = sw.FILL_THREADS * sms
    assert sw.pick_rpt_compact(1, sms) == 1
    assert sw.pick_rpt_compact(2 * full - 1, sms) == 1
    assert sw.pick_rpt_compact(2 * full, sms) == 2
    assert sw.pick_rpt_compact(10 ** 7, sms) == 2


@pytest.mark.parametrize("name", NAMES)
def test_sweep_compact_plain_bit_equal_to_dense_and_close_to_jax(name):
    js, ps = _scenes(name)
    ro, rd, rt = _rays(name)
    rays = pack_rays(*(torch.from_numpy(a) for a in (ro, rd, rt)))
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    dt, di = sw.sweep_plain(rays, geo, sw._ranges(ps), ps.t_min)
    ct, ci = sw.sweep_sorted(rays, geo, blocks, ps.t_min)
    assert torch.equal(dt, ct) and torch.equal(di, ci)
    hit = torch.isfinite(dt).numpy()
    assert hit.sum() > 100
    jt, ji = ip.intersect_solids_pallas(
        js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rt),
        interpret=True, sort=True)
    jt, ji = np.asarray(jt), np.asarray(ji)
    np.testing.assert_array_equal(np.isfinite(jt), hit)
    np.testing.assert_array_equal(ji[hit], ci.numpy()[hit])
    # rtol 2e-5, except on grazing hits of the r=1000 ground spheres: they
    # cancel catastrophically and the interpreted Pallas sweep rounds them
    # unlike the XLA sweep, which the port follows op for op
    # (tests/test_pallas.py allows 5e-4 between the two JAX engines)
    t = ct.numpy()
    with np.errstate(invalid="ignore"):          # inf - inf on misses
        loose = hit & (np.abs(t - jt) > 2e-5 * np.abs(jt))
    assert loose.sum() <= 0.02 * hit.sum()
    np.testing.assert_allclose(t[hit & ~loose], jt[hit & ~loose], rtol=2e-5)
    np.testing.assert_allclose(t[loose], jt[loose], rtol=5e-4)


@pytest.mark.parametrize("n", [256, 1000, 77])
def test_sweep_compact_all_kinds_any_ray_count(n):
    """Coherent rays (one origin, a narrow cone) so tiles skip blocks; the
    results still equal the dense sweep's bit for bit, in sorted order and
    un-permuted."""
    ps = mixed_scene()
    r = np.random.default_rng(n)
    ro = np.tile(np.float32([-40, 14, 13]), (n, 1)) \
        + r.normal(size=(n, 3)).astype(np.float32)
    rd = np.float32([1, 0, 0]) + 0.02 * r.normal(size=(n, 3)).astype(np.float32)
    rays = pack_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                     torch.from_numpy(r.random(n).astype(np.float32)))
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    assert [b - a for a, b in blocks.spans] == [3, 1, 2, 1]
    dt, di = sw.sweep_plain(rays, geo, sw._ranges(ps), ps.t_min)
    perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
    srays = rays[:, perm].contiguous()
    cnt, lst, order = sw.tile_lists(srays, blocks.blo, blocks.bhi, ps.t_min)
    if n >= sw.TILE_R:      # a short tile's pad rays cross the whole scene
        assert int(cnt.sum()) < cnt.numel() * blocks.n_blocks  # some skipped
    st, si = sw.sweep_compact(srays, geo, blocks, cnt, lst, order, ps.t_min)
    assert torch.equal(st, dt[perm]) and torch.equal(si, di[perm])
    ut, ui = sw.sweep_compact(srays, geo, blocks, cnt, lst, order, ps.t_min,
                              perm)
    assert torch.equal(ut, dt) and torch.equal(ui, di)
    assert int(torch.isfinite(dt).sum()) > n // 8


def test_intersect_ti_sorted_equals_unsorted_and_reads_the_switch(monkeypatch):
    ps = SCENES["next-week-final"].build(seed=1024, earth=None)
    ro, rd, rt = _rays("next-week-final", n=300)
    rays = pack_rays(*(torch.from_numpy(a) for a in (ro, rd, rt)))
    ids = torch.arange(300, dtype=torch.int32)
    a = intersect_ti(ps, rays, (3, 4), ids)
    calls = sw.sweep_compact_plain.calls
    b = intersect_ti(ps, rays, (3, 4), ids, blocks=sw.sweep_blocks(ps))
    assert sw.sweep_compact_plain.calls == calls + 1
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # TPU_RAY_SORT: off unless "1"
    for value, on in ((None, False), ("0", False), ("auto", False),
                      ("1", True)):
        if value is None:
            monkeypatch.delenv("TPU_RAY_SORT", raising=False)
        else:
            monkeypatch.setenv("TPU_RAY_SORT", value)
        assert sw.use_sort() is on
        assert (SceneKernels.create(ps).blocks is not None) is on
    assert sw.use_sort(False) is False and sw.use_sort(True) is True
    monkeypatch.setenv("TPU_RAY_SORT", "1")
    assert SceneKernels.create(ps, False).blocks is None
    monkeypatch.delenv("TPU_RAY_SORT")
    assert SceneKernels.create(ps, True).blocks is not None


def test_sweep_compact_wrapper_checks_its_inputs():
    ps = mixed_scene()
    rays = torch.zeros((7, 300))
    rays[3:6] = 1.0
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    cnt, lst, order = sw.tile_lists(rays, blocks.blo, blocks.bhi, ps.t_min)
    launches = sw.sweep_compact.launches
    sw.sweep_compact(rays, geo, blocks, cnt, lst, order, ps.t_min)
    assert sw.sweep_compact.launches == launches        # CPU: no kernel
    with pytest.raises(ValueError):
        sw.sweep_compact(rays, geo, blocks, cnt[:1], lst, order, ps.t_min)
    with pytest.raises(ValueError):
        sw.sweep_compact(rays, geo, blocks, cnt, lst.long(), order, ps.t_min)
    with pytest.raises(ValueError):
        sw.sweep_compact(rays, geo, blocks, cnt, lst, order[:1], ps.t_min)
    with pytest.raises(ValueError):
        sw.sweep_compact(rays, geo, blocks, cnt, lst, order, ps.t_min,
                         torch.arange(300, dtype=torch.int32))
