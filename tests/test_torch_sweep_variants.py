"""The two sweep variants of the port on the CPU (their plain versions)
against the JAX package's kernels in interpret mode and against the port's
dense sweep: the mask-gated sorted sweep (needed_mask, sweep_masked) and the
matrix-product sphere sweep (sweep_sphere_mxu)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import cross_engine, jax_scene_arrays, mixed_scene

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops import intersect_pallas as ip
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.integrator import SceneKernels
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import sweep as sw
from tpu_ray_torch.ops.intersect import intersect_ti, pack_rays
from tpu_ray_torch.renderer import render

# the scenes and ray boxes of tests/test_pallas.py::
# test_sorted_cull_sweep_matches_plain
CULL_CASES = [("next-week-final", -100, 600), ("cornell", 0, 555)]


def _rays(seed, n, lo, hi):
    """tests/test_pallas.py::_rays: uniform origins, normal directions."""
    r = np.random.default_rng(seed)
    return (r.uniform(lo, hi, (n, 3)).astype(np.float32),
            r.normal(size=(n, 3)).astype(np.float32),
            r.random(n).astype(np.float32))


def _scenes(name):
    js = JSCENES[name].build(seed=1024, earth=None)
    return js, scene_from_jax_arrays(jax_scene_arrays(js))


def _sorted(blocks, rays):
    perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
    return perm, rays[:, perm].contiguous()


@pytest.mark.parametrize("name,lo,hi", CULL_CASES)
def test_needed_mask_bit_equal_to_jax(name, lo, hi):
    """Per kind range, on the sorted rays (coherent tiles) and on the
    unsorted ones."""
    js, ps = _scenes(name)
    ro, rd, rt = _rays(11, 1280, lo, hi)
    rays = pack_rays(*(torch.from_numpy(a) for a in (ro, rd, rt)))
    blocks = sw.sweep_blocks(ps)
    perm, srays = _sorted(blocks, rays)
    n_sb = js.n_sphere + js.n_box
    spans = ((0, js.n_sphere_static, "sphere"),
             (js.n_sphere_static, js.n_sphere, "sphere"),
             (js.n_sphere, n_sb, "box"), (n_sb, js.n_solid, "quad"))
    p = perm.numpy()
    skipped = 0
    for x, o, d in ((srays, ro[p], rd[p]), (rays, ro, rd)):
        whole = sw.needed_mask(x, blocks.blo, blocks.bhi, ps.t_min)
        assert whole.shape == (5, blocks.n_blocks) \
            and whole.dtype == torch.int32
        for (a, b, flavor), (b0, b1) in zip(spans, blocks.spans):
            if b <= a:
                continue
            blo, bhi = ip._block_aabbs(*ip._range_aabbs(js, a, b, flavor),
                                       (-(b - a)) % sw.PBLK)
            want = np.asarray(ip._needed_mask(jnp.asarray(o), jnp.asarray(d),
                                              blo, bhi, float(js.t_min)))
            np.testing.assert_array_equal(whole[:, b0:b1].numpy(), want)
        skipped += int((whole == 0).sum())
    if name == "next-week-final":
        assert skipped > 0


@pytest.mark.parametrize("name,lo,hi", CULL_CASES)
def test_sweep_masked_plain_bit_equal_to_dense_and_close_to_jax(
        name, lo, hi, monkeypatch):
    js, ps = _scenes(name)
    ro, rd, rt = _rays(11, 1280, lo, hi)
    rays = pack_rays(*(torch.from_numpy(a) for a in (ro, rd, rt)))
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    dt, di = sw.sweep_plain(rays, geo, sw._ranges(ps), ps.t_min)
    calls, launches = sw.sweep_masked_plain.calls, sw.sweep_masked.launches
    mt, mi = sw.sweep_sorted(rays, geo, blocks, ps.t_min, masked=True)
    assert sw.sweep_masked_plain.calls == calls + 1
    assert sw.sweep_masked.launches == launches           # CPU: no kernel
    assert torch.equal(dt, mt) and torch.equal(di, mi)
    hit = torch.isfinite(dt).numpy()
    assert hit.sum() > 300
    monkeypatch.setenv("TPU_RAY_CULL_STYLE", "mask")
    jt, ji = ip.intersect_solids_pallas(
        js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rt),
        interpret=True, sort=True)
    jt, ji = np.asarray(jt), np.asarray(ji)
    np.testing.assert_array_equal(np.isfinite(jt), hit)
    np.testing.assert_array_equal(ji[hit], mi.numpy()[hit])
    # the tolerances of tests/test_torch_sort_sweep.py against JAX: rtol
    # 2e-5, except grazing hits of the r=1000 ground spheres at 5e-4
    t = mt.numpy()
    with np.errstate(invalid="ignore"):          # inf - inf on misses
        loose = hit & (np.abs(t - jt) > 2e-5 * np.abs(jt))
    assert loose.sum() <= 0.02 * hit.sum()
    np.testing.assert_allclose(t[hit & ~loose], jt[hit & ~loose], rtol=2e-5)
    np.testing.assert_allclose(t[loose], jt[loose], rtol=5e-4)


def _cone_rays(n):
    r = np.random.default_rng(n)
    ro = np.tile(np.float32([-40, 14, 13]), (n, 1)) \
        + r.normal(size=(n, 3)).astype(np.float32)
    rd = np.float32([1, 0, 0]) + 0.02 * r.normal(size=(n, 3)).astype(np.float32)
    return pack_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                     torch.from_numpy(r.random(n).astype(np.float32)))


@pytest.mark.parametrize("n", [256, 1000, 77])
def test_sweep_masked_all_kinds_any_ray_count(n):
    """Coherent rays so tiles skip blocks; sorted order and un-permuted."""
    ps = mixed_scene()
    rays = _cone_rays(n)
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    dt, di = sw.sweep_plain(rays, geo, sw._ranges(ps), ps.t_min)
    perm, srays = _sorted(blocks, rays)
    mask, order = sw.tile_mask(srays, blocks.blo, blocks.bhi, ps.t_min)
    cnt = sw.tile_lists(srays, blocks.blo, blocks.bhi, ps.t_min)[0]
    np.testing.assert_array_equal(mask.sum(1).numpy(), cnt.numpy())
    if n >= sw.TILE_R:
        assert int(mask.sum()) < mask.numel()              # some skipped
    st, si = sw.sweep_masked(srays, geo, blocks, mask, order, ps.t_min)
    assert torch.equal(st, dt[perm]) and torch.equal(si, di[perm])
    ut, ui = sw.sweep_masked(srays, geo, blocks, mask, order, ps.t_min, perm)
    assert torch.equal(ut, dt) and torch.equal(ui, di)
    assert int(torch.isfinite(dt).sum()) > n // 8


def test_sweep_masked_wrapper_checks_its_inputs():
    ps = mixed_scene()
    rays = _cone_rays(300)
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    mask, order = sw.tile_mask(rays, blocks.blo, blocks.bhi, ps.t_min)
    sw.sweep_masked(rays, geo, blocks, mask, order, ps.t_min)
    with pytest.raises(ValueError):
        sw.sweep_masked(rays, geo, blocks, mask[:1], order, ps.t_min)
    with pytest.raises(ValueError):
        sw.sweep_masked(rays, geo, blocks, mask.long(), order, ps.t_min)
    with pytest.raises(ValueError):
        sw.sweep_masked(rays, geo, blocks, mask, order, ps.t_min,
                        torch.arange(300, dtype=torch.int32))


@pytest.mark.parametrize("n", [77, 1000, 4096])
def test_tile_mask_order_is_a_permutation_by_needed_count(n):
    """The mask-mode list pass's plain twin: the mask is needed_mask's and
    the launch order lists every tile once, by non-increasing count of
    needed blocks (the card's ties may come in any order, so this is what
    its tests hold)."""
    ps = mixed_scene()
    rays = _cone_rays(n)
    blocks = sw.sweep_blocks(ps)
    _, srays = _sorted(blocks, rays)
    box = (srays, blocks.blo, blocks.bhi, ps.t_min)
    mask, order = sw.tile_mask(*box)
    assert torch.equal(mask, sw.needed_mask(*box))
    T = -(-n // sw.TILE_R)
    assert order.dtype == torch.int32 and order.shape == (T,)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(T, dtype=torch.int32))
    cnt = mask.sum(1)
    assert bool((cnt[order.long()].diff() <= 0).all())
    assert torch.equal(order, sw.tile_order_plain(cnt.to(torch.int32)))
    # any launch order gives the same bits
    dt, di = sw.sweep_masked(srays, sw.sweep_table(ps), blocks, mask, order,
                             ps.t_min)
    ot, oi = sw.sweep_masked(srays, sw.sweep_table(ps), blocks, mask,
                             order.flip(0), ps.t_min)
    assert torch.equal(dt, ot) and torch.equal(di, oi)


def test_sweep_masked_rejects_a_bad_order_and_cpu_tensors_for_the_kernel():
    ps = mixed_scene()
    rays = _cone_rays(600)
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    mask, order = sw.tile_mask(rays, blocks.blo, blocks.bhi, ps.t_min)
    sw.sweep_masked(rays, geo, blocks, mask, order, ps.t_min)
    for bad in (order[:-1], order.long(), order[None],
                torch.empty(order.shape, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError):
            sw.sweep_masked(rays, geo, blocks, mask, bad, ps.t_min)
    launches = sw.sweep_masked.launches
    with pytest.raises(ValueError, match="CUDA"):
        sw.sweep_masked_launch(rays, geo, blocks, mask, order, ps.t_min)
    assert sw.sweep_masked.launches == launches


def test_sweep_masked_wrapper_picks_rpt_compact(monkeypatch):
    """The masked kernel's wrapper takes its rays per thread from
    pick_rpt_compact (the compacted sweep's rule: it is the same kernel),
    and hands the kernel the order, the mask and its mode.  The launch is
    recorded instead of made; the tensors stay on the CPU."""
    ps = mixed_scene()
    geo, blocks = sw.sweep_table(ps), sw.sweep_blocks(ps)
    sms = 132
    seen = []

    def entry(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(sw, "_require_cuda", lambda what, *xs: None)
    monkeypatch.setattr(sw, "sm_count", lambda device: sms)
    monkeypatch.setattr(sw, "load_fn", lambda name, symbol, argtypes: entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    for R in (1000, 2 * sw.FILL_THREADS * sms, 4 * sw.FILL_THREADS * sms):
        rays = torch.zeros((7, R))
        rays[3:6] = 1.0
        T = -(-R // sw.TILE_R)
        mask = torch.ones((T, blocks.n_blocks), dtype=torch.int32)
        order = torch.arange(T, dtype=torch.int32)
        launches = sw.sweep_masked.launches
        sw.sweep_masked_launch(rays, geo, blocks, mask, order, ps.t_min)
        assert sw.sweep_masked.launches == launches + 1
        args = seen[-1]
        assert args[14] == sw.pick_rpt_compact(R, sms)      # rays per thread
        assert args[15] == 1                                 # mask mode
        assert args[6] is None and args[7] == mask.data_ptr()
        assert args[8] == order.data_ptr()
    assert [a[14] for a in seen] == [1, 2, 2]     # dense: pick_rpt's 4


def test_sweep_sphere_mxu_plain_matches_jax_and_the_dense_sweep():
    """book1-final's static spheres, the 512 rays of tests/test_pallas.py::
    test_mxu_sphere_sweep_matches_classic."""
    js, ps = _scenes("book1-final")
    n = ps.n_sphere_static
    assert n > 400
    ro, rd, _ = _rays(7, 512, -12, 12)
    rays = pack_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                     torch.zeros(512))
    geo = sw.sweep_table(ps)
    calls, launches = sw.sweep_sphere_mxu_plain.calls, \
        sw.sweep_sphere_mxu.launches
    mt, mi = sw.sweep_sphere_mxu(rays, geo, 0, n, ps.t_min)
    assert sw.sweep_sphere_mxu_plain.calls == calls + 1
    assert sw.sweep_sphere_mxu.launches == launches       # CPU: no kernel
    jt, ji = ip._sweep_sphere_mxu(js, jnp.asarray(ro), jnp.asarray(rd),
                                  jnp.zeros((512, 1), jnp.float32), 0, n,
                                  True)
    jt, ji = np.asarray(jt), np.asarray(ji)
    hit = np.isfinite(mt.numpy())
    np.testing.assert_array_equal(hit, jt < 3e38)
    assert hit.sum() > 50
    # same expansion on both sides: rtol 2e-5, grazing hits (where the
    # expansion cancels) held to 1e-3
    t = mt.numpy()
    loose = hit & (np.abs(t - jt) > 2e-5 * np.abs(jt))
    assert loose.sum() <= 0.02 * hit.sum()
    np.testing.assert_allclose(t[hit & ~loose], jt[hit & ~loose], rtol=2e-5)
    np.testing.assert_allclose(t[loose], jt[loose], rtol=1e-3)
    assert (mi.numpy()[hit] == ji[hit]).mean() > 0.99
    # against the port's dense sweep at the JAX test's own limits
    dt, di = sw.sweep_plain(rays, geo, (n, n, n, n), ps.t_min)
    np.testing.assert_array_equal(torch.isfinite(dt).numpy(), hit)
    np.testing.assert_allclose(t[hit], dt.numpy()[hit], rtol=1e-3)
    assert (mi.numpy()[hit] == di.numpy()[hit]).mean() > 0.99


def test_mxu_pack_is_the_jax_packing_and_is_checked():
    js, ps = _scenes("book1-final")
    n = ps.n_sphere_static
    geo = sw.sweep_table(ps)
    pack = sw.mxu_pack(geo, 0, n)
    c = np.asarray(js.prims.center)[:n].astype(np.float64)
    # the centroid is a float32 mean over 485 centers, one of them the
    # ground sphere's at y = -1000: good to a few 1e-6 of the sum's size
    np.testing.assert_allclose(pack.m, c.mean(0), atol=5e-5)
    m = np.float32(pack.m).astype(np.float64)
    np.testing.assert_allclose(pack.tab[:, :3].numpy(), c - m, rtol=1e-6,
                               atol=1e-6)
    r = np.asarray(js.prims.radius)[:n].astype(np.float64)
    c2 = ((c - m) ** 2).sum(1)
    # k' = |c'|^2 - r^2 cancels on the r = 1000 ground sphere: float32
    # rounding of the two terms, not of their difference
    assert (np.abs(pack.tab[:, 3].numpy() - (c2 - r * r))
            <= 4e-7 * (c2 + r * r) + 1e-6).all()
    # -2c' is exactly -2 x the c' column, as JAX's c2 rows
    # (intersect_pallas.py:203-210); the last column is 0
    assert torch.equal(pack.tab[:, 4:7], -2.0 * pack.tab[:, 0:3])
    assert not pack.tab[:, 7].any()
    # the tensor cores' side: per sphere the margin's bounds, per lane the
    # TF32 split (hi has 13 low bits 0; hi + lo is x to 2^-21 relative)
    assert torch.equal(pack.bound[:, 0], pack.tab[:, 0:3].norm(dim=1))
    assert torch.equal(pack.bound[:, 1], pack.tab[:, 3].abs())
    G = -(-n // 8)
    assert pack.frag.shape == (G, 32, 8)
    f = pack.frag.reshape(8 * G, 4, 8)
    assert not f[n:].any()                              # no sphere past n
    for h, lo_, x in ((f[:n, :, 0], f[:n, :, 1], torch.cat([
            pack.tab[:, 4:7], (pack.tab[:, 3] - sw.MXU_MARGIN * (
                pack.bound[:, 0] ** 2 + pack.bound[:, 1]))[:, None]], 1)),
                      (f[:n, :, 4], f[:n, :, 5], torch.cat([
                          pack.tab[:, 0:3], -torch.ones(n, 1)], 1))):
        assert not (h.view(torch.int32) & 0x1FFF).any()
        assert not (lo_.view(torch.int32) & 0x1FFF).any()
        assert ((h.double() + lo_.double() - x.double()).abs()
                <= 2.0 ** -21 * x.double().abs()).all()
    assert torch.equal(f[:n, :2, 2], torch.ones(n, 2))
    assert (f[:n, 2, 2] == -sw.MXU_MARGIN).all()
    assert torch.equal(f[:n, 3, 2],
                       sw.tf32_round(-2.0 * sw.MXU_MARGIN * pack.bound[:, 0]))
    # the plain twin reads -2c' from the pack and gives the bits of the
    # form it had before the pack carried the column
    rays = _cone_rays(64)
    t, i = sw.sweep_sphere_mxu_plain(rays, geo, 0, n, ps.t_min, pack)
    c = pack.tab.T[:, None, :]
    dx, dy, dz = (rays[3 + j][:, None] for j in range(3))
    ox, oy, oz = (rays[j][:, None] - pack.m[j] for j in range(3))
    a = dx * dx + dy * dy + dz * dz
    b = ox * dx + oy * dy + oz * dz - (dx * c[0] + dy * c[1] + dz * c[2])
    cc = ox * ox + oy * oy + oz * oz + (ox * (-2.0 * c[0]) + oy * (
        -2.0 * c[1]) + oz * (-2.0 * c[2]) + c[3])
    disc = b * b - a * cc
    sd = sw.sqrt_rn(torch.clamp(disc, min=0.0))
    t1, t2 = (-b - sd) * (1.0 / a), (-b + sd) * (1.0 / a)
    tt = torch.where((disc > 0) & (t1 > ps.t_min), t1, torch.where(
        (disc > 0) & (t2 > ps.t_min), t2, float("inf")))
    assert torch.equal(t, tt.min(dim=1).values)
    with pytest.raises(ValueError):
        sw.sweep_sphere_mxu(rays, geo, 0, n - 1, ps.t_min, pack)
    with pytest.raises(ValueError):
        sw.mxu_pack(geo, 5, 5)


@pytest.mark.parametrize("case", ["book1-final", "mixed", "far"])
def test_mxu_split_filter_keeps_every_pair_the_plain_twin_can_hit(case):
    """The tensor-core kernel retests only the pairs its split products
    pick (b^2 > a cc - M); emulated with the products summed exactly,
    that set must hold every pair whose plain discriminant is > 0, and stay
    a small share of the pairs.  book1-final's rays of the JAX test, the
    mixed scene's cone, and rays from 2000 units away (a large |o'|)."""
    from tpu_ray_torch.utils import mxu_split_study as study

    if case == "book1-final":
        ps = _scenes("book1-final")[1]
        ro, rd, _ = _rays(7, 512, -12, 12)
        rays = pack_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                         torch.zeros(512))
    else:
        ps = mixed_scene()
        rays = _cone_rays(700)
        if case == "far":
            rays = rays.clone()
            rays[0] -= 2000.0
    geo = sw.sweep_table(ps)
    n = ps.n_sphere_static
    pack = sw.mxu_pack(geo, 0, n)
    pick = study.split_filter(rays, pack)
    need = study.plain_disc(rays, pack) > 0.0
    assert int(need.sum()) > 0
    assert not (need & ~pick).any()
    if case != "far":        # far origins widen the margin with |o'|^2
        assert float(pick.float().mean()) < 0.05
    # the tile spheres pass wherever a member sphere's plain discriminant
    # is > 0
    tiles = study.split_filter(rays, pack, tiles=True)
    G = tiles.shape[1]
    assert G == -(-n // 8) and pack.frag2.shape == (-(-G // 8), 32, 8)
    member = torch.nn.functional.pad(need, (0, 8 * G - n)) \
        .reshape(-1, G, 8).any(-1)
    assert not (member & ~tiles).any()
    if case == "mixed":
        assert not tiles.all()                  # the cone misses some tiles


def test_sweep_solids_merges_the_mxu_range_with_the_dense_ranges():
    """All four ranges: static spheres through the matrix-product sweep, the
    rest dense, merged in range order."""
    ps = mixed_scene()
    r = np.random.default_rng(4)
    n = 600
    rays = pack_rays(*(torch.from_numpy(a) for a in (
        r.uniform(-25, 25, (n, 3)).astype(np.float32),
        r.normal(size=(n, 3)).astype(np.float32),
        r.random(n).astype(np.float32))))
    geo, ranges = sw.sweep_table(ps), sw._ranges(ps)
    dt, di = sw.sweep_plain(rays, geo, ranges, ps.t_min)
    mt, mi = sw.sweep_solids(rays, geo, ranges, ps.t_min,
                             mxu=sw.mxu_pack(geo, 0, ranges[0]))
    hit = torch.isfinite(dt)
    assert torch.equal(torch.isfinite(mt), hit) and int(hit.sum()) > 200
    torch.testing.assert_close(mt[hit], dt[hit], rtol=1e-3, atol=0)
    assert float((mi[hit] == di[hit]).float().mean()) > 0.99
    assert int((mi[hit] >= ranges[0]).sum()) > 20           # other ranges won


def test_scene_kernels_reads_the_two_switches_once(monkeypatch):
    ps = SCENES["book1-final"].build(seed=1024)
    for k in ("TPU_RAY_SORT", "TPU_RAY_CULL_STYLE", "TPU_RAY_SWEEP_MXU"):
        monkeypatch.delenv(k, raising=False)
    kern = SceneKernels.create(ps)
    assert kern.blocks is None and not kern.masked and kern.mxu is None
    assert not SceneKernels.create(ps, True).masked          # compact lists
    monkeypatch.setenv("TPU_RAY_CULL_STYLE", "mask")
    assert not SceneKernels.create(ps).masked                # sort is off
    kern = SceneKernels.create(ps, True)
    assert kern.masked and kern.blocks is not None
    monkeypatch.setenv("TPU_RAY_CULL_STYLE", "compact")
    assert not SceneKernels.create(ps, True).masked
    monkeypatch.setenv("TPU_RAY_SWEEP_MXU", "1")
    kern = SceneKernels.create(ps)
    assert kern.mxu is not None and kern.mxu.hi == ps.n_sphere_static
    monkeypatch.setenv("TPU_RAY_SWEEP_MXU", "0")
    assert SceneKernels.create(ps).mxu is None
    # a scene without static spheres has nothing to pack
    monkeypatch.setenv("TPU_RAY_SWEEP_MXU", "1")
    assert SceneKernels.create(SCENES["cornell-smoke"].build()).mxu is None
    # the render's tables decide, not the environment at sweep time
    rays = _cone_rays(64)
    ids = torch.arange(64, dtype=torch.int32)
    calls = sw.sweep_sphere_mxu_plain.calls
    monkeypatch.setenv("TPU_RAY_SWEEP_MXU", "0")
    kern.intersect(ps, rays, (1, 2), ids)
    assert sw.sweep_sphere_mxu_plain.calls == calls + 1
    intersect_ti(ps, rays, (1, 2), ids)
    assert sw.sweep_sphere_mxu_plain.calls == calls + 1


def test_queue_render_with_the_masked_sweep_is_bit_equal(monkeypatch):
    spec = SCENES["next-week-final"]
    args = (spec.build(seed=1024, earth=None), spec.camera(24, 24), 24, 24)
    kw = dict(spp=2, max_depth=4, seed=3, device="cpu", mode="queue")
    monkeypatch.delenv("TPU_RAY_CULL_STYLE", raising=False)
    a = render(*args, sort=False, **kw)
    monkeypatch.setenv("TPU_RAY_CULL_STYLE", "mask")
    calls = sw.sweep_masked_plain.calls, sw.sweep_compact_plain.calls
    b = render(*args, sort=True, **kw)
    assert sw.sweep_masked_plain.calls > calls[0]
    assert sw.sweep_compact_plain.calls == calls[1]
    np.testing.assert_array_equal(a, b)


def test_book1_render_with_the_mxu_sweep_passes_cross_engine(monkeypatch):
    spec = SCENES["book1-final"]
    args = (spec.build(seed=1024), spec.camera(24, 16), 24, 16)
    kw = dict(spp=4, max_depth=6, seed=3, device="cpu")
    monkeypatch.delenv("TPU_RAY_SWEEP_MXU", raising=False)
    a = render(*args, **kw)
    monkeypatch.setenv("TPU_RAY_SWEEP_MXU", "1")
    calls = sw.sweep_sphere_mxu_plain.calls
    b = render(*args, **kw)
    assert sw.sweep_sphere_mxu_plain.calls > calls
    cross_engine(a, b)
