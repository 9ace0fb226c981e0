"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: on a machine without a CUDA device every test skips (the
kernels have no CPU mode; the CPU tests hold the plain twins to the JAX
package instead).  This file imports neither JAX nor tpu_ray, so it runs
where only the port is installed:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from torch_port_common import (emissive_image_scene, seeded_image,
                               textured_checker_scene)

from tpu_ray_torch import aov
from tpu_ray_torch.denoise import denoise
from tpu_ray_torch.integrator import (SceneKernels, _queue_init, _to_i32_bits,
                                      init_pool_state, queue_body)
from tpu_ray_torch.models import objects as ob
from tpu_ray_torch.models.compile import build_scene
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.core import rng
from tpu_ray_torch.ops import hit_scatter as hs
from tpu_ray_torch.ops import megakernel as mega
from tpu_ray_torch.ops import shade
from tpu_ray_torch.ops import sweep as sw
from tpu_ray_torch.ops.intersect import intersect_ti, pack_rays
from tpu_ray_torch.renderer import pixel_grid, render, slot_ids

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _mixed_scene():
    """Static and moving spheres, axis-aligned boxes, quads of every
    orientation: every range of the sweep is non-empty."""
    r = np.random.default_rng(31)
    white = ob.Lambertian((1, 1, 1))
    objs = [ob.Sphere(tuple(r.uniform(-20, 20, 3)), r.uniform(0.3, 1.5),
                      white) for _ in range(300)]
    for _ in range(40):
        c = r.uniform(-20, 20, 3)
        objs.append(ob.MovingSphere(tuple(c), tuple(c + r.uniform(-2, 2, 3)),
                                    0.0, 1.0, r.uniform(0.3, 1.5), white))
    for _ in range(60):
        lo3 = r.uniform(-20, 20, 3)
        objs.append(ob.Box(tuple(lo3), tuple(lo3 + r.uniform(0.5, 4.0, 3)),
                           white))
    for plane in ("xy", "xz", "yz"):
        for _ in range(40):
            a = np.sort(r.uniform(-20, 20, 2))
            b = np.sort(r.uniform(-20, 20, 2))
            objs.append(ob.Rect(plane, a[0], a[1], b[0], b[1],
                                r.uniform(-20, 20), white))
    return build_scene(objs)


def test_sweep_kernel_matches_plain(card):
    """All four prim ranges, more prims than one shared-memory chunk."""
    ps = _mixed_scene().to(card)
    assert ps.n_solid > 256
    r = np.random.default_rng(6)
    n = 1 << 16
    rays = pack_rays(*(torch.from_numpy(a).to(card) for a in (
        r.uniform(-40, 40, (n, 3)).astype(np.float32),
        r.normal(size=(n, 3)).astype(np.float32),
        r.random(n).astype(np.float32))))
    geo, ranges = sw.sweep_table(ps), sw._ranges(ps)
    t, i = sw.sweep(rays, geo, ranges, ps.t_min)
    tp, ip = sw.sweep_plain(rays, geo, ranges, ps.t_min)
    hit = torch.isfinite(tp)
    assert torch.equal(torch.isfinite(t), hit) and int(hit.sum()) > 1000
    assert torch.equal(i[hit], ip[hit])
    torch.testing.assert_close(t[hit], tp[hit], rtol=2e-5, atol=0)


def _build(name, card):
    """A library scene on the card; "earth-image" carries a seeded image,
    "checker-tex" has checkers with textured children and "emissive-image"
    an image on a light (tests/torch_port_common.py, seen through
    two-spheres' camera); a "strict " prefix asks for the strict reference
    estimator."""
    img = seeded_image()
    if name == "earth-image":
        return SCENES["earth"], SCENES["earth"].build(earth=img).to(card)
    if name in ("checker-tex", "emissive-image"):
        make = (textured_checker_scene if name == "checker-tex"
                else emissive_image_scene)
        return SCENES["two-spheres"], make(ob, build_scene, img).to(card)
    if name.startswith("strict "):
        spec, ps = _build(name[len("strict "):], card)
        return spec, ps.replace(strict=True)
    return SCENES[name], SCENES[name].build(seed=1024, earth=None).to(card)


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke",
                                  "two-perlin-spheres", "simple-light",
                                  "earth-image", "checker-tex",
                                  "strict checker-tex", "emissive-image"])
def test_pool_step_kernel_matches_plain(card, name):
    _hold_pool_step(card, name)


@pytest.mark.parametrize("name,sampler", [
    ("cornell", "sobol"), ("two-perlin-spheres", "sobol"),
    ("strict two-perlin-spheres", "uniform"),
    ("strict cornell-smoke", "uniform"), ("strict book1-final", "sobol")])
def test_pool_step_kernel_sobol_and_strict_match_plain(card, name, sampler):
    """The Sobol' regeneration and the strict branches.  The first camera
    sample's shutter time is time0 + (time1 - time0) u4, exact: bit-equal
    in every scene; on cornell (no lens) the whole sample is, its
    direction taking the pixel jitter u0, u1 in exact operations."""
    f0, fp0 = _hold_pool_step(card, name, sampler)
    assert torch.equal(f0[6], fp0[6]) and int(torch.unique(f0[6]).numel()) > 1
    if name == "cornell":
        assert torch.equal(f0, fp0)


def _hold_pool_step(card, name, sampler="uniform"):
    """The step kernel against its twin over a pool's first iterations;
    returns both first camera samples (the init launches' float state)."""
    W, H, K = 64, 32, 4
    spec, ps = _build(name, card)
    cam = spec.camera(W, H).replace(sampler=sampler)
    cfg = shade.StepConfig.create(ps, cam, W, H, 8, rr_depth=2, n_samples=3,
                                  cam_salt=7)
    st = init_pool_state(pixel_grid(W, H, K, card), slot_ids(W, H, K, card))
    R = st.slot.shape[0]
    none = (torch.empty(R, device=card),
            torch.zeros(R, dtype=torch.int32, device=card))
    init = (cfg, st.xy, st.slot, st.fstate, st.istate, *none, (0, 0))
    fp0, _ = shade.pool_step_plain(*init, init=True)
    st.fstate, st.istate = shade.pool_step(*init, init=True)
    f0 = st.fstate
    kern = SceneKernels.create(ps)
    for it in range(4):
        bt, bi = intersect_ti(ps, st.fstate[:7], (it, 1), st.slot, kern.geo,
                              kern.media)
        args = (cfg, st.xy, st.slot, st.fstate, st.istate, bt, bi, (it, 2))
        fk, ik = shade.pool_step(*args)
        fp, ip = shade.pool_step_plain(*args)
        same = (ik == ip).all(dim=0)
        assert int((~same).sum()) <= 1e-3 * R
        torch.testing.assert_close(fk[:, same], fp[:, same], rtol=2e-4,
                                   atol=1e-3)
        st.fstate, st.istate = fk, ik
    return f0, fp0


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke",
                                  "two-perlin-spheres", "random-moving",
                                  "earth-image", "checker-tex",
                                  "emissive-image"])
def test_hit_scatter_kernel_matches_plain(card, name):
    """Camera rays, then two rounds of continuation rays."""
    _hold_hit_scatter(card, name)


@pytest.mark.parametrize("name", ["strict cornell-smoke",
                                  "strict two-perlin-spheres",
                                  "strict book1-final",
                                  "strict checker-tex"])
def test_hit_scatter_kernel_strict_matches_plain(card, name):
    """The strict branches of the shared core in the wave path's kernel."""
    _hold_hit_scatter(card, name)


def _hold_hit_scatter(card, name):
    W, H = 96, 64
    spec, ps = _build(name, card)
    cam = spec.camera(W, H).to(card)
    cfg = shade.StepConfig.create(ps, cam, W, H, 8)
    kern = SceneKernels.create(ps)
    R = W * H
    u = torch.from_numpy(np.random.default_rng(2).random((R, 5))
                         .astype(np.float32)).to(card)
    rays = pack_rays(*cam.rays_from_uniforms(u[:, 0], u[:, 1], u[:, 2:5]))
    ids = slot_ids(W, H, 1, card)
    for rnd in range(3):
        bt, bi = kern.intersect(ps, rays, (rnd, 1), ids)
        rk, sk = hs.hit_scatter(cfg, rays, bt, bi, (rnd, 2), ids)
        rp, sp = hs.hit_scatter_plain(cfg, rays, bt, bi, (rnd, 2), ids)
        same = (rk.hit == rp.hit) & (rk.front == rp.front) \
            & (rk.mat == rp.mat) & (sk.scattered == sp.scattered)
        assert int((~same).sum()) <= 1e-3 * R
        tol = dict(rtol=2e-4, atol=1e-3)
        torch.testing.assert_close(rk.point[:, same], rp.point[:, same], **tol)
        torch.testing.assert_close(rk.normal[:, same], rp.normal[:, same],
                                   **tol)
        torch.testing.assert_close(rk.u[same], rp.u[same], **tol)
        torch.testing.assert_close(rk.v[same], rp.v[same], **tol)
        torch.testing.assert_close(sk.emitted[:, same], sp.emitted[:, same],
                                   **tol)
        cont = same & rp.hit & sp.scattered
        assert rnd > 0 or int(cont.sum()) > 100
        # a few lanes land on the other side of a texel edge or of the MIS
        # coin's rounding: they may differ freely
        wd = ((sk.weight - sp.weight).abs() > 1e-3 + 2e-4 * sp.weight.abs()) \
            .any(dim=0) | ((sk.direction - sp.direction).abs() > 1e-3).any(dim=0)
        assert int((wd & cont).sum()) <= 1e-3 * R
        rays = rays.clone()
        rays[0:3] = torch.where(cont, rp.point, rays[0:3])
        rays[3:6] = torch.where(cont, sp.direction, rays[3:6])


@pytest.mark.parametrize("n", [1 << 16, 1000])
def test_sweep_compact_kernel_bit_equal_to_dense(card, n):
    """All four kinds, coherent and scattered rays, a ragged last tile."""
    ps = _mixed_scene().to(card)
    r = np.random.default_rng(n)
    ro = r.uniform(-40, 40, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    ro[: n // 2] = np.float32([-40, 14, 13]) + r.normal(size=(n // 2, 3))
    rd[: n // 2] = np.float32([1, 0, 0]) + 0.02 * r.normal(size=(n // 2, 3))
    rays = pack_rays(*(torch.from_numpy(a).to(card) for a in (
        ro, rd, r.random(n).astype(np.float32))))
    geo, ranges, blocks = sw.sweep_table(ps), sw._ranges(ps), \
        sw.sweep_blocks(ps)
    dt, di = sw.sweep(rays, geo, ranges, ps.t_min)
    perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
    srays = rays[:, perm].contiguous()
    cnt, lst, order = sw.tile_lists(srays, blocks.blo, blocks.bhi, ps.t_min)
    if n > 1000:     # whole tiles of coherent rays skip blocks
        assert int(cnt.sum()) < cnt.numel() * blocks.n_blocks
    launches = sw.sweep_compact.launches
    ct, ci = sw.sweep_compact(srays, geo, blocks, cnt, lst, order, ps.t_min,
                              perm)
    assert sw.sweep_compact.launches == launches + 1
    pt, pi = sw.sweep_compact_plain(srays, geo, blocks, cnt, lst, order,
                                    ps.t_min, perm)
    hit = torch.isfinite(dt)
    assert int(hit.sum()) > n // 8
    assert torch.equal(ct, dt) and torch.equal(ci[hit], di[hit])
    assert torch.equal(torch.isfinite(pt), hit) and torch.equal(pi[hit],
                                                                di[hit])
    torch.testing.assert_close(pt[hit], dt[hit], rtol=2e-5, atol=0)
    st, si = sw.sweep_sorted(rays, geo, blocks, ps.t_min)
    assert torch.equal(st, dt) and torch.equal(si[hit], di[hit])


@pytest.mark.parametrize("mode,name", [("queue", "next-week-final"),
                                       ("queue", "cornell-smoke"),
                                       ("wave", "cornell")])
def test_render_on_the_card_matches_the_cpu(card, mode, name):
    """Cross-engine criterion: at most 2% of pixels diverge, the rest agree
    within rtol 2e-4 / atol 1e-4."""
    spec = SCENES[name]
    args = (spec.build(seed=1024, earth=None), spec.camera(32, 24), 32, 24)
    kw = dict(spp=4, max_depth=6, seed=5, mode=mode)
    a = render(*args, device="cpu", **kw)
    b = render(*args, device=card, **kw)
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    assert 1.0 - close.mean() <= 0.02
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)
    if mode == "queue":
        c = render(*args, device=card, sort=True, **kw)
        np.testing.assert_array_equal(b, c)


def _scattered_and_coherent_rays(card, n):
    r = np.random.default_rng(n)
    ro = r.uniform(-40, 40, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    ro[: n // 2] = np.float32([-40, 14, 13]) + r.normal(size=(n // 2, 3))
    rd[: n // 2] = np.float32([1, 0, 0]) + 0.02 * r.normal(size=(n // 2, 3))
    return pack_rays(*(torch.from_numpy(a).to(card) for a in (
        ro, rd, r.random(n).astype(np.float32))))


@pytest.mark.parametrize("n", [1 << 16, 1000, 77])
def test_sweep_masked_kernel_bit_equal_to_dense(card, n):
    """All four kinds, coherent and scattered rays, a ragged last tile: each
    rays-per-thread build, tiles in natural (identity) order and in the list
    pass's order, gives the dense kernel's and the plain twin's (t, i) bit
    for bit, and the cull tests no more blocks than the mask names."""
    ps = _mixed_scene().to(card)
    rays = _scattered_and_coherent_rays(card, n)
    geo, ranges, blocks = sw.sweep_table(ps), sw._ranges(ps), \
        sw.sweep_blocks(ps)
    dt, di = sw.sweep(rays, geo, ranges, ps.t_min)
    perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
    srays = rays[:, perm].contiguous()
    box = (srays, blocks.blo, blocks.bhi, ps.t_min)
    mask, order = sw.tile_mask(*box)
    assert torch.equal(mask, sw.needed_mask_plain(*box))
    T = mask.shape[0]
    identity = torch.arange(T, dtype=torch.int32, device=card)
    assert torch.equal(torch.sort(order).values, identity)
    needed = mask.sum(1)[order.long()]
    assert bool((needed[:-1] >= needed[1:]).all())
    if n > 1000:
        assert int(mask.sum()) < mask.numel()
    pt, pi = sw.sweep_masked_plain(srays, geo, blocks, mask, order, ps.t_min,
                                   perm)
    hit = torch.isfinite(dt)
    assert int(hit.sum()) > n // 8
    assert torch.equal(pt, dt) and torch.equal(pi[hit], di[hit])
    for rpt in (1, 2):
        for o in (identity, order):
            stats = torch.zeros(2, dtype=torch.int64, device=card)
            launches = sw.sweep_masked.launches
            mt, mi = sw.sweep_masked(srays, geo, blocks, mask, o, ps.t_min,
                                     perm, rpt, stats)
            assert sw.sweep_masked.launches == launches + 1
            assert torch.equal(mt, dt) and torch.equal(mi[hit], di[hit])
            assert torch.equal(mt, pt) and torch.equal(mi, pi)
            listed, skipped = stats.tolist()
            assert listed == int(mask.sum()) and 0 <= skipped <= listed
    mt, mi = sw.sweep_masked(srays, geo, blocks, mask, order, ps.t_min, perm)
    assert torch.equal(mt, dt) and torch.equal(mi, pi)
    st, si = sw.sweep_sorted(rays, geo, blocks, ps.t_min, masked=True)
    assert torch.equal(st, dt) and torch.equal(si[hit], di[hit])
    with pytest.raises(ValueError):
        sw.sweep_masked(srays, geo, blocks, mask, order, ps.t_min, perm, 4)


@pytest.mark.parametrize("n", [1, 255, 257, 4097, 65537])
def test_sweep_kernel_every_rays_per_thread(card, n):
    """Each rays-per-thread instantiation of the dense kernel, ragged edges
    included: bit-equal to the compacted sweep (the same pair math) and
    within the plain version's tolerance."""
    ps = _mixed_scene().to(card)
    rays = _scattered_and_coherent_rays(card, n)
    geo, ranges, blocks = sw.sweep_table(ps), sw._ranges(ps), \
        sw.sweep_blocks(ps)
    ct, ci = sw.sweep_sorted(rays, geo, blocks, ps.t_min)
    pt, pi = sw.sweep_plain(rays, geo, ranges, ps.t_min)
    hit = torch.isfinite(pt)
    assert n < 4097 or int(hit.sum()) > n // 8
    for rpt in (1, 2, 4):
        launches = sw.sweep.launches
        t, i = sw.sweep_launch(rays, geo, ranges, ps.t_min, rpt)
        assert sw.sweep.launches == launches + 1
        assert torch.equal(t, ct) and torch.equal(i[hit], ci[hit])
        assert torch.equal(torch.isfinite(t), hit)
        assert torch.equal(i[hit], pi[hit])
        torch.testing.assert_close(t[hit], pt[hit], rtol=2e-5, atol=0)
    with pytest.raises(ValueError):
        sw.sweep_launch(rays, geo, ranges, ps.t_min, 3)


@pytest.mark.parametrize("n", [77, 256, 1000, 1 << 16])
def test_list_pass_equals_the_plain_tile_lists(card, n):
    """The card's list pass against its plain twin (torch on the card) on
    sorted and unsorted rays: the same counts, lists (whole rows, so
    lst[:cnt] too) and needed mask; the order is a permutation of the tiles
    by descending count.  next-week-final's 14 blocks and the mixed scene's
    7."""
    for ps in (_mixed_scene().to(card),
               SCENES["next-week-final"].build(seed=1024).to(card)):
        rays = _scattered_and_coherent_rays(card, n)
        blocks = sw.sweep_blocks(ps)
        perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
        for x in (rays[:, perm].contiguous(), rays):
            args = (x, blocks.blo, blocks.bhi, ps.t_min)
            cp, lp, op = sw.tile_lists_plain(*args)
            mp = sw.needed_mask_plain(*args)
            launches = sw.list_pass.launches
            ck, lk, order = sw.tile_lists(*args)
            assert sw.list_pass.launches == launches + 1
            assert torch.equal(ck, cp) and torch.equal(lk, lp)
            T = ck.numel()
            assert torch.equal(torch.sort(order).values,
                               torch.arange(T, dtype=torch.int32,
                                            device=card))
            oc = ck[order.long()]
            assert bool((oc[:-1] >= oc[1:]).all())
            assert torch.equal(oc, cp[op.long()])
            assert torch.equal(sw.needed_mask(*args), mp)
            assert sw.list_pass.launches == launches + 2


def _coherent_rays(card, n):
    r = np.random.default_rng(n + 1)
    ro = np.float32([-40, 14, 13]) + r.normal(size=(n, 3))
    rd = np.float32([1, 0, 0]) + 0.02 * r.normal(size=(n, 3))
    return pack_rays(*(torch.from_numpy(a.astype(np.float32)).to(card)
                       for a in (ro, rd, r.random(n))))


@pytest.mark.parametrize("n", [1, 255, 1000, 4097, 1 << 16])
def test_sweep_compact_every_rays_per_thread_bit_equal_to_dense(card, n):
    """Each rays-per-thread build of the compacted kernel, in list-pass
    order and in natural order, with the front-to-back cull always on:
    (t, i) bit-equal to the dense kernel's on scattered, coherent and
    ragged rays; the kernel counts the listed pairs and skips some on
    coherent rays."""
    ps = _mixed_scene().to(card)
    geo, ranges, blocks = sw.sweep_table(ps), sw._ranges(ps), \
        sw.sweep_blocks(ps)
    for rays in (_scattered_and_coherent_rays(card, n),
                 _coherent_rays(card, n)):
        dt, di = sw.sweep(rays, geo, ranges, ps.t_min)
        perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
        srays = rays[:, perm].contiguous()
        cnt, lst, order = sw.tile_lists(srays, blocks.blo, blocks.bhi,
                                        ps.t_min)
        natural = torch.arange(cnt.numel(), dtype=torch.int32, device=card)
        skipped = 0
        for rpt in (1, 2):
            for o in (natural, order):
                stats = torch.zeros(2, dtype=torch.int64, device=card)
                launches = sw.sweep_compact.launches
                t, i = sw.sweep_compact(srays, geo, blocks, cnt, lst, o,
                                        ps.t_min, perm, rpt=rpt,
                                        stats=stats)
                assert sw.sweep_compact.launches == launches + 1
                assert torch.equal(t, dt) and torch.equal(i, di)
                listed, skip = stats.tolist()
                assert listed == int(cnt.sum()) and 0 <= skip <= listed
                skipped = skip
        st, si = sw.sweep_sorted(rays, geo, blocks, ps.t_min)
        assert torch.equal(st, dt) and torch.equal(si, di)
    if n >= 4097:
        assert skipped > 0                 # coherent tiles cull far blocks
    for rpt in (3, 4):
        with pytest.raises(ValueError):
            sw.sweep_compact(srays, geo, blocks, cnt, lst, order, ps.t_min,
                             rpt=rpt)


@pytest.mark.parametrize("n", [77, 1000, 1 << 16])
@pytest.mark.parametrize("hi", [13, 301])
def test_sweep_mxu_tensor_core_kernel_bit_equal_to_plain(card, n, hi):
    """The tensor cores pick the pairs, the plain twin's operations decide
    them: (t, i) bit-equal to the plain twin's, with a sphere count that is
    no multiple of 8 (13, 301: more than one 128-sphere chunk) and ray
    counts that are no multiple of 16; every pair whose plain discriminant
    is > 0 is among the retested ones (their count bounds it)."""
    from tpu_ray_torch.utils import mxu_split_study as study

    ps = _mixed_scene().to(card)
    geo = sw.sweep_table(ps)
    rays = _scattered_and_coherent_rays(card, n)
    pack = sw.mxu_pack(geo, 0, hi)
    stats = torch.zeros(1, dtype=torch.int64, device=card)
    t, i = sw.sweep_sphere_mxu(rays, geo, 0, hi, ps.t_min, pack,
                               stats=stats)
    tp, ip = sw.sweep_sphere_mxu_plain(rays, geo, 0, hi, ps.t_min, pack)
    assert torch.equal(t.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(i, ip)
    need = int((study.plain_disc(rays, pack) > 0).sum())
    retested = int(stats.item())
    assert need <= retested <= 0.05 * n * hi + need
    if hi == 301:     # 13 spheres are there for the ragged tile: few hits
        assert int(torch.isfinite(tp).sum()) > n // 20


def test_sweep_mxu_kernel_matches_plain_and_dense(card):
    """More spheres than one shared-memory chunk; the kernel follows its
    plain version's operations, and both the dense sweep to the expansion's
    conditioning."""
    ps = _mixed_scene().to(card)
    n_ss = ps.n_sphere_static
    assert n_ss > 256
    rays = _scattered_and_coherent_rays(card, 1 << 16)
    geo = sw.sweep_table(ps)
    pack = sw.mxu_pack(geo, 0, n_ss)
    launches = sw.sweep_sphere_mxu.launches
    t, i = sw.sweep_sphere_mxu(rays, geo, 0, n_ss, ps.t_min, pack)
    assert sw.sweep_sphere_mxu.launches == launches + 1
    tp, ip = sw.sweep_sphere_mxu_plain(rays, geo, 0, n_ss, ps.t_min, pack)
    hit = torch.isfinite(tp)
    R = rays.shape[1]
    assert int(hit.sum()) > 1000
    assert int((torch.isfinite(t) != hit).sum()) <= 1e-4 * R
    both = hit & torch.isfinite(t)
    assert int((i[both] != ip[both]).sum()) <= 1e-4 * R
    torch.testing.assert_close(t[both], tp[both], rtol=2e-5, atol=1e-6)
    dt, di = sw.sweep(rays, geo, (n_ss, n_ss, n_ss, n_ss), ps.t_min)
    dhit = torch.isfinite(dt)
    assert int((dhit != torch.isfinite(t)).sum()) <= 1e-3 * R
    both = dhit & torch.isfinite(t)
    assert float((i[both] == di[both]).float().mean()) > 0.99
    same = both & (i == di)
    torch.testing.assert_close(t[same], dt[same], rtol=1e-3, atol=1e-4)
    # with the other ranges merged in
    mt, mi = sw.sweep_solids(rays, geo, sw._ranges(ps), ps.t_min, mxu=pack)
    at, ai = sw.sweep(rays, geo, sw._ranges(ps), ps.t_min)
    ahit = torch.isfinite(at)
    assert int((torch.isfinite(mt) != ahit).sum()) <= 1e-3 * R
    assert float((mi[ahit] == ai[ahit]).float().mean()) > 0.99


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke",
                                  "two-perlin-spheres", "book1-final",
                                  "random-moving", "two-spheres"])
def test_megakernel_matches_plain(card, name):
    """One wave: equal sample counts; at most 3% of lanes diverged
    (|a - b| / (1 + |a|) >= 1e-4), the rest within rtol 2e-4 / atol 1e-4."""
    _hold_megakernel(card, name)


@pytest.mark.parametrize("name", ["cornell", "two-perlin-spheres",
                                  "cornell-smoke"])
def test_megakernel_sobol_matches_plain(card, name):
    """The Sobol' camera through the megakernel's pool iteration."""
    _hold_megakernel(card, name, "sobol")


def _hold_megakernel(card, name, sampler="uniform"):
    W, H, K = 64, 32, 4
    spec, ps = _build(name, card)
    cfg = shade.StepConfig.create(ps, spec.camera(W, H).replace(
        sampler=sampler), W, H, 8, rr_depth=3, n_samples=3, sample0=5,
        cam_salt=7)
    xy, slot = pixel_grid(W, H, K, card), slot_ids(W, H, K, card)
    key = rng.fold_in(rng.prng_key(11), 2)
    launches = mega.trace_pool_mega.launches
    mega.read_stats(card)
    a, a_ns = mega.trace_pool_mega(ps, cfg, xy, slot, key)
    assert mega.trace_pool_mega.launches == launches + 1
    lane_iters, warp_iters = mega.read_stats(card)
    R = slot.shape[0]
    assert 3 * R <= lane_iters <= 32 * warp_iters
    assert warp_iters <= (R // 32) * (3 * 8 + 8)
    b, b_ns = mega.trace_pool_mega_plain(ps, cfg, xy, slot, key)
    assert torch.equal(a_ns, b_ns) and int((a_ns != 3).sum()) == 0
    a, b = a.T.cpu().numpy(), b.T.cpu().numpy()
    err = np.abs(a - b) / (1.0 + np.abs(b))
    close = (err < 1e-4).all(axis=-1)
    assert 1.0 - close.mean() <= 0.03
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke", "book1-final"])
def test_megakernel_persistent_bit_equal_to_one_thread_per_slot(card, name):
    """The slot queue changes no bit: the persistent launch, one thread per
    slot and one block of 256 threads (16 slots a thread) give the same
    radiance and sample counts, and count the same slot-iterations."""
    W, H, K = 64, 32, 2
    spec, ps = _build(name, card)
    cfg = shade.StepConfig.create(ps, spec.camera(W, H), W, H, 8, rr_depth=3,
                                  n_samples=3, sample0=5, cam_salt=7)
    xy, slot = pixel_grid(W, H, K, card), slot_ids(W, H, K, card)
    key = rng.fold_in(rng.prng_key(11), 2)
    R = slot.shape[0]
    mega.read_stats(card)
    a, a_ns = mega.trace_pool_mega(ps, cfg, xy, slot, key)
    lanes_a, _ = mega.read_stats(card)
    for threads in (R, 256):
        launches = mega.trace_pool_mega.launches
        b, b_ns = mega.launch_mega(ps, cfg, xy, slot, key, None, threads)
        assert mega.trace_pool_mega.launches == launches + 1
        lanes_b, trips_b = mega.read_stats(card)
        assert torch.equal(a, b) and torch.equal(a_ns, b_ns)
        assert lanes_b == lanes_a and lanes_b <= 32 * trips_b
    assert int((a_ns != 3).sum()) == 0 and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke"])
def test_mega_render_on_the_card_matches_the_cpu_and_the_wavefront(card,
                                                                   name):
    spec = SCENES[name]
    args = (spec.build(seed=1024, earth=None), spec.camera(32, 24), 32, 24)
    kw = dict(spp=8, max_depth=6, seed=5, samples_per_wave=2,
              rays_per_wave=1 << 10)
    launches = mega.trace_pool_mega.launches, shade.pool_step.launches
    b = render(*args, device=card, engine="mega", **kw)
    assert mega.trace_pool_mega.launches == launches[0] + 4
    assert shade.pool_step.launches == launches[1]
    for other in (render(*args, device="cpu", engine="mega", **kw),
                  render(*args, device=card, **kw)):
        err = np.abs(other - b) / (1.0 + np.abs(other))
        close = (err < 1e-4).all(axis=-1)
        assert 1.0 - close.mean() <= 0.02
        np.testing.assert_allclose(other[close], b[close], rtol=2e-4,
                                   atol=1e-4)


def test_masked_and_mxu_renders_on_the_card(card, monkeypatch):
    spec = SCENES["next-week-final"]
    args = (spec.build(seed=1024, earth=None), spec.camera(32, 24), 32, 24)
    kw = dict(spp=4, max_depth=6, seed=5, mode="queue", device=card)
    a = render(*args, sort=False, **kw)
    monkeypatch.setenv("TPU_RAY_CULL_STYLE", "mask")
    launches = sw.sweep_masked.launches
    np.testing.assert_array_equal(a, render(*args, sort=True, **kw))
    assert sw.sweep_masked.launches > launches
    spec = SCENES["book1-final"]
    args = (spec.build(seed=1024), spec.camera(32, 24), 32, 24)
    kw = dict(spp=4, max_depth=6, seed=5, device=card)
    a = render(*args, **kw)
    monkeypatch.setenv("TPU_RAY_SWEEP_MXU", "1")
    launches = sw.sweep_sphere_mxu.launches
    b = render(*args, **kw)
    assert sw.sweep_sphere_mxu.launches > launches
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    assert 1.0 - close.mean() <= 0.02
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("name,mode,engine,sampler,strict", [
    ("cornell", "pool", "auto", "sobol", False),
    ("cornell", "queue", "auto", "sobol", False),
    ("cornell", "pool", "mega", "sobol", False),
    ("cornell-smoke", "pool", "auto", "uniform", True),
    ("two-perlin-spheres", "wave", "auto", "uniform", True),
    ("book1-final", "queue", "auto", "sobol-b0", True),
    ("cornell", "queue", "auto", "sobol-b0", False),
    ("checker-tex", "pool", "auto", "uniform", False),
    ("checker-tex", "queue", "auto", "sobol-b0", True),
    ("emissive-image", "wave", "auto", "uniform", False)])
def test_sobol_and_strict_renders_on_the_card_match_the_cpu(
        card, name, mode, engine, sampler, strict):
    """Cross-engine criterion between the card's kernels and the CPU's
    plain twins on every path that takes a Sobol' camera or the strict
    estimator; the kernel that path runs launched."""
    spec, scene = _build(name, "cpu")
    scene = scene.replace(strict=strict)
    args = (scene, spec.camera(32, 24).replace(sampler=sampler), 32, 24)
    kw = dict(spp=4, max_depth=6, seed=5, mode=mode, engine=engine)
    counter = {"wave": hs.hit_scatter, "mega": mega.trace_pool_mega}.get(
        mode if mode == "wave" else engine, shade.pool_step)
    launches = counter.launches
    b = render(*args, device=card, **kw)
    assert counter.launches > launches
    a = render(*args, device="cpu", **kw)
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    assert 1.0 - close.mean() <= 0.02
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("name,mode,engine", [
    ("cornell", "pool", "auto"), ("cornell", "pool", "mega"),
    ("two-spheres", "queue", "auto"), ("next-week-final", "queue", "auto")])
def test_adaptive_renders_on_the_card_match_the_cpu(card, name, mode,
                                                    engine):
    """Adaptive sampling on the card against the CPU's plain twins: equal
    count maps, images under the cross-engine criterion, the path's kernel
    launched; a second card render is bit-equal (the queue's per-pixel
    reduction has a fixed order)."""
    from tpu_ray_torch.adaptive import render_adaptive

    spec = SCENES[name]
    args = (spec.build(seed=1024, earth=None), spec.camera(32, 24), 32, 24)
    kw = dict(spp_max=64, tol=0.05, max_depth=6, seed=5, mode=mode,
              engine=engine, return_spp=True)
    counter = mega.trace_pool_mega if engine == "mega" else shade.pool_step
    launches = counter.launches
    b, nb = render_adaptive(*args, device=card, **kw)
    assert counter.launches > launches
    c, nc = render_adaptive(*args, device=card, **kw)
    np.testing.assert_array_equal(b, c)
    np.testing.assert_array_equal(nb, nc)
    a, na = render_adaptive(*args, device="cpu", **kw)
    np.testing.assert_array_equal(na, nb)
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    assert 1.0 - close.mean() <= 0.02
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)


def test_pool_step_kernel_sobol_b0_queue_matches_plain(card):
    """The queue's sobol-b0 step (the B0 instantiation) against its twin on
    queue states a few iterations in: lanes at bounce 0 take dims 7-10 of
    their (pixel, global sample), the others hashed draws."""
    W, H = 32, 24
    spec, ps = _build("cornell", card)
    cam = spec.camera(W, H).replace(sampler="sobol-b0")
    cfg = shade.StepConfig.create(ps, cam, W, H, 8, n_samples=0, cam_salt=7,
                                  queue=True)
    assert cfg.b0
    kern = SceneKernels.create(ps)
    total = W * H * 4
    st = _queue_init(2048, total, card, b0=True)
    key = rng.fold_in(rng.prng_key(5), 0x5EED)
    ki, ks = rng.fold_in(key, 0), rng.fold_in(key, 1)
    zeros2 = torch.zeros((2, 2048), dtype=torch.float32, device=card)
    first = 0
    for it in range(5):
        st = queue_body(st, ps, cfg, kern, ki, ks, 7, 0, total, W, H)
        sid = _to_i32_bits(rng.path_ids(st.work, st.istate[0]))
        bt, bi = kern.intersect(ps, st.fstate[:7], ki, sid)
        args = (cfg, zeros2, sid, st.fstate, st.istate, bt, bi, ks)
        fk, ik = shade.pool_step(*args, lane_b0=st.lane)
        fp, ip = shade.pool_step_plain(*args, lane_b0=st.lane)
        same = (ik == ip).all(dim=0)
        assert int((~same).sum()) <= 2
        torch.testing.assert_close(fk[:, same], fp[:, same], rtol=2e-4,
                                   atol=1e-3)
        first += int(((st.istate[0] == 0) & (st.istate[2] > 0)).sum())
    assert first > 1000


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke", "checker-tex",
                                  "strict checker-tex", "earth-image"])
def test_aov_kernel_matches_plain(card, name):
    """The first-hit feature kernel against its twin on camera rays:
    hit flags equal, features within rtol 2e-4 / atol 1e-4 on all but a
    few lanes (a texel edge or a checker's sign of sines)."""
    W, H = 96, 64
    spec, ps = _build(name, card)
    cam = spec.camera(W, H).to(card)
    cfg = shade.StepConfig.create(ps, cam, W, H, 1)
    kern = SceneKernels.create(ps)
    R = W * H
    u = torch.from_numpy(np.random.default_rng(4).random((R, 5))
                         .astype(np.float32)).to(card)
    rays = pack_rays(*cam.rays_from_uniforms(u[:, 0], u[:, 1], u[:, 2:5]))
    ids = slot_ids(W, H, 1, card)
    bt, bi = kern.intersect(ps, rays, (0, 1), ids)
    bi = bi.to(torch.int32).contiguous()
    launches = aov.aov_features.launches
    fk = aov.aov_features(cfg, rays, bt, bi)
    assert aov.aov_features.launches == launches + 1
    fp = aov.aov_features_plain(cfg, rays, bt, bi)
    assert torch.equal(fk[7], fp[7]) and int(fp[7].sum()) > R // 20
    bad = ((fk - fp).abs() > 1e-4 + 2e-4 * fp.abs()).any(dim=0)
    assert int(bad.sum()) <= 1e-3 * R


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke", "checker-tex"])
def test_render_aovs_on_the_card_matches_the_cpu(card, name):
    """render_aovs on the card against the CPU's plain twin: coverage
    equal, albedo and normal within 1e-4 and depth within rtol 1e-5 on all
    but 2% of pixels; banded card output bit-equal to unbanded."""
    spec, ps = _build(name, "cpu")
    cam = spec.camera(40, 24)
    kw = dict(spp=4, seed=5)
    a = aov.render_aovs(ps, cam, 40, 24, device="cpu", **kw)
    b = aov.render_aovs(ps, cam, 40, 24, device=card, **kw)
    c = aov.render_aovs(ps, cam, 40, 24, device=card, band_cap=200, **kw)
    for k in aov.AOV_NAMES:
        np.testing.assert_array_equal(b[k], c[k])
    np.testing.assert_array_equal(a["coverage"], b["coverage"])
    np.testing.assert_array_equal(np.isinf(a["depth"]), np.isinf(b["depth"]))
    fin = np.isfinite(a["depth"])
    bad = np.zeros(a["depth"].shape, bool)
    bad[fin] = np.abs(a["depth"][fin] - b["depth"][fin]) > \
        1e-5 * np.abs(a["depth"][fin])
    for k in ("albedo", "normal"):
        bad |= (np.abs(a[k] - b[k]) > 1e-4).any(axis=-1)
    assert bad.mean() <= 0.02


def test_denoise_on_the_card_matches_the_cpu(card):
    r = np.random.default_rng(8)
    img = r.random((24, 32, 3)).astype(np.float32)
    alb = r.random((24, 32, 3)).astype(np.float32)
    nrm = r.normal(size=(24, 32, 3)).astype(np.float32)
    depth = r.uniform(1, 5, (24, 32)).astype(np.float32)
    depth[::5, ::3] = np.inf
    a = denoise(img, alb, nrm, depth, radius=2, device="cpu")
    b = denoise(img, alb, nrm, depth, radius=2)
    assert b.is_cuda
    torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["cornell-smoke", "next-week-final",
                                  "mixed"])
def test_bvh_kernel_bit_equal_to_plain(card, name):
    """The traversal kernel against its twin on the card, every lane: both
    run the sweeps' pair math and media.cuh's free flight, and the twin's
    lockstep loop visits the nodes in the kernel's order.  Against the
    brute-force sweep: the same hits, prims but on equal-t ties."""
    from tpu_ray_torch.ops import bvh

    ps = (_mixed_scene() if name == "mixed"
          else SCENES[name].build(seed=1024, earth=None)).to(card)
    r = np.random.default_rng(12)
    n = 1 << 16
    # origins over the scene: the mixed scene's +-20 box, the library
    # scenes' ~555-unit rooms
    c, half = (0.0, 40.0) if name == "mixed" else (278.0, 300.0)
    rays = pack_rays(*(torch.from_numpy(a).to(card) for a in (
        (c + r.uniform(-half, half, (n, 3))).astype(np.float32),
        r.normal(size=(n, 3)).astype(np.float32),
        r.random(n).astype(np.float32))))
    lanes = torch.arange(n, dtype=torch.int32, device=card)
    kd = (0x1234, 0x9876)
    tables = bvh.BVHTables.create(ps)
    launches = bvh.intersect_bvh.launches
    t, i = bvh.intersect_bvh(ps, tables, rays, kd, lanes)
    assert bvh.intersect_bvh.launches == launches + 1
    tp, ip = bvh.intersect_bvh_plain(ps, tables, rays, kd, lanes)
    assert torch.equal(t, tp) and torch.equal(i, ip)
    ft, fi = intersect_ti(ps, rays, kd, lanes)
    hit = torch.isfinite(ft)
    assert torch.equal(torch.isfinite(t), hit) and int(hit.sum()) > 1000
    differ = hit & (i != fi)
    assert bool((t[differ] == ft[differ]).all())       # equal-t ties only
    torch.testing.assert_close(t[hit], ft[hit], rtol=1e-5, atol=0)


def _bvh_rays(ps, card, name):
    """2^15 rays with origins over the scene, rays from their hits in
    seeded directions (box faces shared by neighbours give equal-t ties)
    and three whose every pair misses (NaN origin or direction, zero
    direction)."""
    r = np.random.default_rng(13)
    n = 1 << 15
    c, half = (0.0, 40.0) if name == "mixed" else (278.0, 300.0)
    rays = pack_rays(*(torch.from_numpy(a).to(card) for a in (
        (c + r.uniform(-half, half, (n, 3))).astype(np.float32),
        r.normal(size=(n, 3)).astype(np.float32),
        r.random(n).astype(np.float32))))
    lanes = torch.arange(n, dtype=torch.int32, device=card)
    t, _ = intersect_ti(ps, rays, (5, 6), lanes)
    hit = torch.isfinite(t)
    o = rays[0:3, hit] + t[hit] * rays[3:6, hit]
    d = torch.from_numpy(r.normal(size=(3, o.shape[1])).astype(
        np.float32)).to(card)
    sec = torch.cat([o, d, rays[6:7, hit]])
    odd = rays[:, :3].clone()         # a NaN origin, a NaN direction, a
    odd[0, 0] = odd[4, 1] = float("nan")          # zero direction
    odd[3:6, 2] = 0.0
    return torch.cat([rays, sec, odd], 1).contiguous()


@pytest.mark.parametrize("name", ["next-week-final", "book1-final",
                                  "cornell-smoke", "mixed"])
def test_bvh_kernel_both_rules(card, name):
    """Rule VISIT bit-equal to its lockstep twin and rule INDEX bit-equal
    to intersect_ti (the dense sweep and media kernels), t and prim on
    every lane, ties included, in the render's form and the counting form,
    over the wide records and over the pair walk in their format (width
    2); the counting form counts one root test a ray, each a child box
    tested, and no more lanes a warp trip than the warp has."""
    from tpu_ray_torch.ops import bvh

    ps = (_mixed_scene() if name == "mixed"
          else SCENES[name].build(seed=1024, earth=None)).to(card)
    rays = _bvh_rays(ps, card, name)
    R = rays.shape[1]
    lanes = torch.arange(R, dtype=torch.int32, device=card)
    kd = (0x1234, 0x9876)
    visit = bvh.BVHTables.create(ps)
    index = bvh.BVHTables.create(ps, visit.bvh, visit.geo, visit.media,
                                 rule=bvh.INDEX)
    rows = bvh.pack_nodes(visit.bvh, bvh.INDEX, ps, 2)
    pair = replace(index, nodes=rows, stack=max(
        bvh.wide_stack_bound(rows.cpu().numpy()), 1))
    tp, ip = bvh.intersect_bvh_plain(ps, visit, rays, kd, lanes)
    ft, fi = intersect_ti(ps, rays, kd, lanes)
    for tables, (wt, wi) in ((visit, (tp, ip)), (index, (ft, fi)),
                             (pair, (ft, fi))):
        for counting in (False, True):
            stats = (torch.zeros(len(bvh.STAT_KEYS), dtype=torch.int64,
                                 device=card) if counting else None)
            t, i = bvh.intersect_bvh_launch(ps, tables, rays, kd, lanes,
                                            stats)
            assert torch.equal(t.view(torch.int32), wt.view(torch.int32)), \
                (tables.rule, counting)
            assert torch.equal(i, wi), (tables.rule, counting)
            if counting:
                counts = dict(zip(bvh.STAT_KEYS, stats.tolist()))
                assert counts["roots"] == R and counts["records"] > 0
                assert counts["children"] >= R + 2 * counts["records"]
                assert counts["warp_steps"] <= counts["lane_steps"] \
                    <= 32 * counts["warp_steps"]


def test_scene_kernels_route_big_scenes_through_the_index_rule(card):
    """On the card the default intersect of a scene of
    BVH_ROUTE_MIN_PRIMS prims or more traverses the BVH under rule INDEX
    and gives intersect_ti's bits; cornell (13 prims) and the sorted sweep
    keep the sweeps; book1-final (485) too."""
    from tpu_ray_torch import integrator
    from tpu_ray_torch.ops import bvh

    ps = SCENES["next-week-final"].build(seed=1024, earth=None).to(card)
    kern = SceneKernels.create(ps, False)
    assert kern.bvh is not None and kern.bvh.rule == bvh.INDEX
    assert SceneKernels.create(ps, True).bvh is None
    small = SCENES["cornell"].build(seed=1024).to(card)
    assert small.n_prims < integrator.BVH_ROUTE_MIN_PRIMS
    assert SceneKernels.create(small, False).bvh is None
    book1 = SCENES["book1-final"].build(seed=1024).to(card)
    assert SceneKernels.create(book1, False).bvh is None
    rays = _bvh_rays(ps, card, "next-week-final")
    lanes = torch.arange(rays.shape[1], dtype=torch.int32, device=card)
    launches = bvh.intersect_bvh.launches, sw.sweep.launches
    t, i = kern.intersect(ps, rays, (7, 8), lanes)
    assert (bvh.intersect_bvh.launches, sw.sweep.launches) == (
        launches[0] + 1, launches[1])
    ft, fi = intersect_ti(ps, rays, (7, 8), lanes)
    assert torch.equal(t.view(torch.int32), ft.view(torch.int32))
    assert torch.equal(i, fi)


@pytest.mark.parametrize("engine,mode", [("auto", "pool"), ("mega", "pool"),
                                         ("auto", "queue")])
def test_resume_on_the_card_is_bit_equal(card, monkeypatch, tmp_path,
                                         engine, mode):
    """A render interrupted after its checkpoints and resumed on the card
    equals the uninterrupted card render bit for bit (the pool's sums run
    over unique lane ids, the queue's plane in a fixed order)."""
    from tpu_ray_torch import renderer

    monkeypatch.setenv("HOME", str(tmp_path))
    spec = SCENES["cornell"]
    args = (spec.build(seed=1024), spec.camera(32, 32), 32, 32)
    kw = dict(spp=8, max_depth=8, seed=5, mode=mode, engine=engine,
              rays_per_wave=1024, samples_per_wave=2)
    if mode == "queue":
        monkeypatch.setattr(renderer, "QUEUE_PLANE_BYTES", 32 * 32 * 12 * 2)
    full = render(*args, **kw)
    ck = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def stop(img, rows_final):
        raise Stop

    with pytest.raises(Stop):
        render(*args, checkpoint_path=ck, checkpoint_every=1,
               on_partial=stop, **kw)
    np.testing.assert_array_equal(render(*args, checkpoint_path=ck, **kw),
                                  full)


def test_bvh_render_on_the_card_matches_the_cpu(card):
    from tpu_ray_torch.ops import bvh

    spec = SCENES["cornell-smoke"]
    args = (spec.build(seed=1024), spec.camera(32, 24), 32, 24)
    kw = dict(spp=4, max_depth=6, seed=5, bvh=True)
    launches = bvh.intersect_bvh.launches
    b = render(*args, device=card, **kw)
    assert bvh.intersect_bvh.launches > launches
    a = render(*args, device="cpu", **kw)
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    assert 1.0 - close.mean() <= 0.02
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("mode,engine", [("pool", "auto"), ("pool", "mega"),
                                         ("queue", "auto"), ("wave", "auto")])
def test_mesh_render_on_the_card_matches_one_device(card, mode, engine):
    """A mesh of two ``cuda:0`` entries (the mesh schedule on one card)
    renders the single-device image up to the f32 order of the sum over
    devices (tests/test_megakernel.py:119's tolerance), through the
    kernels."""
    from tpu_ray_torch.parallel.mesh import make_mesh

    spec = SCENES["cornell"]
    scene, cam = spec.build(seed=1024), spec.camera(32, 24)
    kw = dict(spp=6, max_depth=6, seed=5, mode=mode, engine=engine,
              rays_per_wave=32 * 24, samples_per_wave=2)
    one = render(scene, cam, 32, 24, **kw)
    launches = sw.sweep.launches + mega.trace_pool_mega.launches
    meshed = render(scene, cam, 32, 24,
                    mesh=make_mesh(device=["cuda:0", "cuda:0"]), **kw)
    assert sw.sweep.launches + mega.trace_pool_mega.launches > launches
    np.testing.assert_allclose(meshed, one, rtol=1e-4, atol=1e-5)


def test_adaptive_mesh_on_the_card_counts_equal_one_device(card):
    from tpu_ray_torch.adaptive import render_adaptive
    from tpu_ray_torch.parallel.mesh import make_mesh

    spec = SCENES["cornell"]
    scene, cam = spec.build(seed=1024), spec.camera(40, 32)
    kw = dict(spp_max=64, tol=0.05, max_depth=6, seed=4, return_spp=True,
              rays_per_wave=1024)
    a, na = render_adaptive(scene, cam, 40, 32, mode="queue", **kw)
    b, nb = render_adaptive(scene, cam, 40, 32,
                            mesh=make_mesh(device=["cuda:0"] * 4), **kw)
    np.testing.assert_array_equal(nb, na)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bvh", [False, True])
def test_banded_pool_on_the_card_matches_the_cpu(card, monkeypatch, bvh):
    """next-week-final on the pool with the lane cap lowered to 256 (three
    8-row bands at 32x24, one sample a wave; the lanes pinned to 256, so
    the frame too plans one slot a pixel): bit-equal to the unbanded
    render of the same plan on the card, and the CPU's banded render at the
    cross-engine criterion.  Both renders traverse the BVH kernel: with
    ``bvh`` under the visit order, without it under the sweep's tie rule
    (the default closest hit of a scene this large on the card)."""
    from tpu_ray_torch import renderer
    from tpu_ray_torch.ops import bvh as bvh_ops

    spec = SCENES["next-week-final"]
    args = (spec.build(seed=1024, earth=None), spec.camera(32, 24), 32, 24)
    kw = dict(spp=4, max_depth=6, seed=5, mode="pool", bvh=bvh,
              rays_per_wave=256, samples_per_wave=1)
    unbanded = render(*args, device=card, **kw)
    monkeypatch.setattr(renderer, "XLA_BIG_SCENE_LANES", 256)
    counter = bvh_ops.intersect_bvh
    launches, rows = counter.launches, []
    b = render(*args, device=card,
               on_partial=lambda im, rf: rows.append(rf), **kw)
    assert counter.launches > launches and rows[-1] == 24 and 8 in rows
    np.testing.assert_array_equal(b, unbanded)
    a = render(*args, device="cpu", **kw)
    err = np.abs(a - b) / (1.0 + np.abs(a))
    close = (err < 1e-4).all(axis=-1)
    assert 1.0 - close.mean() <= 0.02
    np.testing.assert_allclose(a[close], b[close], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["cornell-smoke", "next-week-final"])
def test_media_kernel_bit_equal_to_plain(card, name):
    """The media kernel against its twin on 1M bounce-1 lanes of a pool
    (the rays, lane ids and solids' hits the pool path gives it), every
    lane bit for bit; the twin on card tensors launches nothing."""
    from tpu_ray_torch.ops import intersect as isect

    W, H, K = (500, 500, 4) if name == "cornell-smoke" else (1000, 1000, 1)
    spec, ps = _build(name, card)
    cfg = shade.StepConfig.create(ps, spec.camera(W, H), W, H, 8,
                                  n_samples=1, cam_salt=7)
    st = init_pool_state(pixel_grid(W, H, K, card), slot_ids(W, H, K, card))
    R = st.slot.shape[0]
    none = (torch.empty(R, device=card),
            torch.zeros(R, dtype=torch.int32, device=card))
    st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot, st.fstate,
                                           st.istate, *none, (0, 0),
                                           init=True)
    kern = SceneKernels.create(ps)
    bt, bi = kern.intersect(ps, st.fstate[:7], (3, 4), st.slot)
    st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot, st.fstate,
                                           st.istate, bt, bi, (5, 6))
    rays = st.fstate[:7]
    solids = sw.sweep(rays, kern.geo, sw._ranges(ps), ps.t_min)
    launches = isect.merge_media.launches
    t, i = isect.merge_media(ps, rays, (7, 8), st.slot, kern.media, *solids)
    assert isect.merge_media.launches == launches + 1
    tp, ip = isect.merge_media_plain(ps, rays, (7, 8), st.slot, kern.media,
                                     *solids)
    assert isect.merge_media.launches == launches + 1
    assert torch.equal(t, tp) and torch.equal(i, ip)
    assert int((i >= ps.n_solid).sum()) > 1000


def _queue_state(card, sampler, worklist_mode):
    """A 4096-lane cornell queue a few iterations into a render on the
    card, and what its next queue_inject takes: uniform, sobol, sobol-b0
    or (``worklist_mode``) a worklist of random (pixel, sample) entries
    whose last 1000 are padding past its total."""
    from tpu_ray_torch.integrator import WL_SAMP_BITS
    from tpu_ray_torch.ops import queue as q

    W, H, m = 48, 32, 4096
    spec, ps = _build("cornell", card)
    cam = spec.camera(W, H).replace(sampler=sampler)
    cfg = shade.StepConfig.create(ps, cam, W, H, 8, n_samples=0, cam_salt=7,
                                  queue=True)
    kern = SceneKernels.create(ps)
    worklist = None
    total = pad = W * H * 8
    if worklist_mode:
        r = np.random.default_rng(9)
        worklist = torch.from_numpy(
            (r.integers(0, W * H, pad) << WL_SAMP_BITS)
            | r.integers(0, 1 << WL_SAMP_BITS, pad)).to(card)
        total = pad - 1000
    st = _queue_init(m, total, card, pad, b0=cfg.b0)
    key = rng.fold_in(rng.prng_key(5), 0x5EED)
    ki, ks = rng.fold_in(key, 0), rng.fold_in(key, 1)
    for _ in range(4):
        st = queue_body(st, ps, cfg, kern, ki, ks, 7, 3 * W * H, total, W, H,
                        worklist)
    sid = q.path_ids(st.work, 3 * W * H, st.istate[0])
    bt, bi = kern.intersect(ps, st.fstate[:7], ki, sid)
    zeros2 = torch.zeros((2, m), dtype=torch.float32, device=card)
    f, i = shade.pool_step(cfg, zeros2, sid, st.fstate, st.istate, bt, bi,
                           ks, lane_b0=st.lane)
    return cfg, st, f, i, worklist, total, W, H


@pytest.mark.parametrize("sampler,worklist_mode", [
    ("uniform", False), ("sobol", False), ("sobol-b0", False),
    ("uniform", True)])
def test_queue_kernels_bit_equal_to_plain(card, sampler, worklist_mode):
    """path_ids and queue_inject against their twins on a queue state a few
    iterations in: the draw ids, the lane state, the work items, the
    frontier, the sobol-b0 record and every plane column but the twin's
    trash column, bit for bit."""
    from tpu_ray_torch.ops import queue as q

    cfg, st, f, i, worklist, total, W, H = _queue_state(card, sampler,
                                                        worklist_mode)
    for id0 in (3 * W * H, (1 << 32) - 5):
        launches = q.path_ids.launches
        sid = q.path_ids(st.work, id0, st.istate[0])
        assert q.path_ids.launches == launches + 1
        assert torch.equal(sid, q.path_ids_plain(st.work, id0, st.istate[0]))
    args = lambda fx, ix, plane: (
        cfg, 7, st.istate[2], fx, ix, st.work, st.frontier, plane, st.lane,
        worklist, total, 3 * W * H, W, H)
    pk, pp = st.plane.clone(), st.plane.clone()
    launches = q.queue_inject.launches
    got = q.queue_inject(*args(f.clone(), i.clone(), pk))
    assert q.queue_inject.launches == launches + 1
    want = q.queue_inject_plain(*args(f.clone(), i.clone(), pp))
    assert q.queue_inject.launches == launches + 1
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    if cfg.b0:
        assert torch.equal(got[4], want[4])
    assert torch.equal(pk[:, :-1], pp[:, :-1])
    free = i[2] == 0
    assert int(free.sum()) > 100 and int(want[3]) > int(st.frontier)
    # the census cell gains the lanes left active, in the kernel and the twin
    ck, cp = (torch.full((), 5, dtype=torch.int64, device=card)
              for _ in range(2))
    got = q.queue_inject(*args(f.clone(), i.clone(), st.plane.clone()),
                         census=ck)
    want = q.queue_inject_plain(*args(f.clone(), i.clone(), st.plane.clone()),
                                census=cp)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert int(ck) == int(cp) == 5 + int(want[1][2].sum())


@pytest.mark.parametrize("sampler,worklist_mode", [
    ("uniform", False), ("sobol-b0", False), ("uniform", True)])
def test_queue_census_kernel_equals_twin(card, sampler, worklist_mode,
                                         monkeypatch):
    """Eight queue iterations from a fresh queue with the kernels and with
    their plain twins: the same lanes, the same census, and the census is
    the sum of the active lanes at each later iteration's entry."""
    from tpu_ray_torch import integrator
    from tpu_ray_torch.ops import queue as q

    cfg, st0, _, _, worklist, total, W, H = _queue_state(card, sampler,
                                                         worklist_mode)
    ps = _build("cornell", card)[1]
    kern = SceneKernels.create(ps)
    key = rng.fold_in(rng.prng_key(5), 0x5EED)
    ki, ks = rng.fold_in(key, 0), rng.fold_in(key, 1)

    def run():
        st = _queue_init(st0.work.shape[0], total, card,
                         st0.plane.shape[1] - 1, b0=cfg.b0)
        entries = 0
        for _ in range(8):
            entries += int(st.istate[2].sum())
            st = integrator.queue_body(st, ps, cfg, kern, ki, ks, 7,
                                       3 * W * H, total, W, H, worklist)
        return st, entries + int(st.istate[2].sum())

    launches = q.queue_inject.launches
    got, n_got = run()
    assert q.queue_inject.launches == launches + 8
    monkeypatch.setattr(q, "queue_inject", q.queue_inject_plain)
    monkeypatch.setattr(q, "path_ids", q.path_ids_plain)
    want, n_want = run()
    assert torch.equal(got.work, want.work)
    assert torch.equal(got.istate, want.istate)
    assert int(got.census) == int(want.census) == n_got == n_want > 0


# the work queue's epochs replayed from CUDA graphs (integrator.QueuePlan):
# next-week-final (the route: its media read the intersect key) at 64x64,
# 16 spp, on a 32768-lane pool with plan_queue's drain ladder (16384, 4096)
QW = QH = 64


def _words(ki, ks, salt, id0, gs0, dev):
    from tpu_ray_torch.ops import queue as q
    return torch.from_numpy(q.render_words(ki, ks, salt, id0, gs0)).to(dev)


@pytest.mark.parametrize("sampler", ["uniform", "sobol", "sobol-b0"])
def test_kernels_read_the_render_words_bit_for_bit(card, sampler):
    """Each C entry given a render's word block against its by-value form
    on a next-week-final queue state a few iterations in: the block's words
    decide, bit for bit, and the by-value words launched beside it (another
    render's, which alone give other bits) are not read."""
    from tpu_ray_torch.ops import queue as q

    W, H, m, salt, s0 = 48, 32, 4096, 7, 3
    spec, ps = _build("next-week-final", card)
    cam = spec.camera(W, H).replace(sampler=sampler)
    cfg = shade.StepConfig.create(ps, cam, W, H, 8, n_samples=0,
                                  cam_salt=salt, queue=True)
    kern = SceneKernels.create(ps)
    assert kern.bvh is not None and ps.has_media
    total, wb = W * H * 8, s0 * W * H
    st = _queue_init(m, total, card, b0=cfg.b0)
    key = rng.fold_in(rng.prng_key(5), 0x5EED)
    ki, ks = rng.fold_in(key, 0), rng.fold_in(key, 1)
    for _ in range(4):
        st = queue_body(st, ps, cfg, kern, ki, ks, salt, wb, total, W, H)
    words = _words(ki, ks, salt, wb, s0, card)
    key2 = rng.fold_in(rng.prng_key(6), 0x5EED)
    ki2, ks2 = rng.fold_in(key2, 0), rng.fold_in(key2, 1)
    cfg2 = replace(cfg, cam_salt=salt + 1)

    sid = q.path_ids(st.work, wb, st.istate[0])
    assert not torch.equal(q.path_ids(st.work, wb + 1, st.istate[0]), sid)
    assert torch.equal(q.path_ids(st.work, wb + 1, st.istate[0], words), sid)

    bt, bi = kern.intersect(ps, st.fstate[:7], ki, sid)
    other = kern.intersect(ps, st.fstate[:7], ki2, sid)
    got = kern.intersect(ps, st.fstate[:7], ki2, sid, words)
    assert not torch.equal(other[0], bt)
    assert torch.equal(got[0], bt) and torch.equal(got[1], bi)

    zeros2 = torch.zeros((2, m), dtype=torch.float32, device=card)
    step = (zeros2, sid, st.fstate, st.istate, bt, bi)
    f, i = shade.pool_step(cfg, *step, ks, lane_b0=st.lane)
    other = shade.pool_step(cfg2, *step, ks2, lane_b0=st.lane)
    got = shade.pool_step(cfg2, *step, ks2, lane_b0=st.lane, words=words)
    assert not torch.equal(other[0], f)
    assert torch.equal(got[0], f) and torch.equal(got[1], i)
    if cfg.b0:      # the salt alone moves the first-bounce draws
        other = shade.pool_step(cfg2, *step, ks, lane_b0=st.lane)
        assert not torch.equal(other[0], f)

    def inject(salt_, wb_, **kw):
        plane = st.plane.clone()
        out = q.queue_inject(cfg, salt_, st.istate[2], f.clone(), i.clone(),
                             st.work, st.frontier, plane, st.lane, None,
                             total, wb_, W, H, **kw)
        return (*out, plane)

    want = inject(salt, wb)
    other = inject(salt + 1, wb + W * H)
    got = inject(salt + 1, wb + W * H, words=words)
    assert not torch.equal(other[0], want[0])
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def _queue_render(scene, cam, kern, seed, salt, s0, max_depth=8, spp=16):
    """(image, census, iterations, replayed, launches by counter) of one
    QW x QH queue call on a 32768-lane pool with plan_queue's drain
    ladder."""
    from tpu_ray_torch.integrator import QueueCounts, trace_queue
    from tpu_ray_torch.renderer import plan_queue
    from tpu_ray_torch.utils import profiling

    R, _, epoch_iters, drain = plan_queue(scene, QW, QH, spp, 1 << 15)
    assert drain == (16384, 4096)
    c0 = (QueueCounts.vertices, QueueCounts.iterations, QueueCounts.replayed)
    l0 = profiling.launch_counts()
    img = trace_queue(scene, cam, QW, QH, spp, s0,
                      rng.fold_in(rng.prng_key(seed), 0x5EED), max_depth, R,
                      cam_salt=salt, epoch_iters=epoch_iters,
                      drain_levels=drain, kern=kern)
    launches = {k: v - l0[k] for k, v in profiling.launch_counts().items()}
    return (img, QueueCounts.vertices - c0[0],
            QueueCounts.iterations - c0[1], QueueCounts.replayed - c0[2],
            launches)


@pytest.fixture
def queue_plans(monkeypatch):
    """An empty plan cache and record of keys seen, restored (their plans
    dropped) afterwards."""
    from collections import OrderedDict

    from tpu_ray_torch import integrator
    monkeypatch.setattr(integrator, "_queue_plans", OrderedDict())
    monkeypatch.setattr(integrator, "_queue_seen", OrderedDict())
    return integrator._queue_plans


@pytest.mark.parametrize("sampler", ["uniform", "sobol-b0"])
def test_replayed_queue_equals_the_eager_loop(card, sampler, queue_plans,
                                              monkeypatch):
    """Three renders of other seeds, camera salts and sample offsets of one
    shape: the first runs eagerly and makes no plan, the second makes the
    plan and captures each pool size's epoch at its first epoch there
    (at this size every pool size runs one epoch, so nothing of the second
    is replayed), the third replays those graphs for every iteration.  Each render's image,
    census, iterations and launches by counter equal the same render with
    no key (every iteration issued on its own), bit for bit, and the
    second's and third's film plane that render's."""
    from tpu_ray_torch import integrator

    spec, ps = _build("next-week-final", card)
    cam = spec.camera(QW, QH).replace(sampler=sampler)
    kern = SceneKernels.create(ps)
    runs = []
    for seed, salt, s0 in ((5, 3, 0), (9, 2 ** 32 - 5, 7), (11, 17, 2)):
        got = _queue_render(ps, cam, kern, seed, salt, s0)
        plan = next(iter(queue_plans.values()), None)
        graphs = plan and [r[2] for r in plan.rungs.values()]
        plane = plan and plan.plane.clone()
        with monkeypatch.context() as eager:
            eager.setattr(integrator, "replay_key", lambda *a, **k: None)
            made = []
            init = integrator._queue_init
            eager.setattr(integrator, "_queue_init",
                          lambda *a, **k: made.append(init(*a, **k))
                          or made[-1])
            want = _queue_render(ps, cam, kern, seed, salt, s0)
        assert torch.equal(got[0], want[0])
        assert got[1:3] == want[1:3] and got[1] > 0
        assert got[4] == want[4] and got[4]["bvh"] == got[2] > 0
        assert want[3] == 0
        if plan is not None:
            assert torch.equal(plane, made[0].plane)
        runs.append((got, plan, graphs))
    (first, plan1, _), (second, plan2, graphs2), (third, plan3, graphs3) = \
        runs
    assert plan1 is None and first[3] == 0
    # the full pool's graph and every other one the second render captured
    # serve the third
    assert len(queue_plans) == 1 and plan2 is plan3
    assert graphs2[0] is not None
    assert all(a is b for a, b in zip(graphs2, graphs3) if a is not None)
    assert second[3] < second[2] and third[3] == third[2] > 0
    assert not torch.equal(second[0], third[0])


def test_queue_plan_misses_on_a_new_scene_camera_or_depth(card, queue_plans):
    """A new scene object, another camera or another depth finds no plan:
    its first render runs eagerly and makes none, its second makes a plan
    of its own (its first epochs issued one by one); the first shape again
    replays every iteration."""
    spec, ps = _build("next-week-final", card)
    cam = spec.camera(QW, QH)
    kern = SceneKernels.create(ps)
    for _ in range(2):
        _queue_render(ps, cam, kern, 5, 3, 0)
    assert len(queue_plans) == 1
    ps2 = spec.build(seed=1024, earth=None).to(card)
    for scene, camera, depth in ((ps2, cam, 8),
                                 (ps, spec.camera(2 * QW, QH), 8),
                                 (ps, cam, 9)):
        n = len(queue_plans)
        k = kern if scene is ps else SceneKernels.create(scene)
        _, _, its, replayed, _ = _queue_render(scene, camera, k, 9, 4, 2,
                                               max_depth=depth)
        assert len(queue_plans) == n and replayed == 0
        _, _, its, replayed, _ = _queue_render(scene, camera, k, 9, 4, 2,
                                               max_depth=depth)
        assert len(queue_plans) == n + 1 and replayed < its
    _, _, its, replayed, _ = _queue_render(ps, cam, kern, 9, 4, 2)
    assert len(queue_plans) == 4 and replayed == its > 0
