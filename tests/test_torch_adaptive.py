"""Adaptive sampling: tpu_ray_torch.adaptive and the queue's worklist mode
against tpu_ray.adaptive and tpu_ray.integrator.trace_queue(worklist=...).

The host helpers and the worklist expansion are held bit-equal; one
worklist round is held to the JAX queue (fused and XLA shading) under the
cross-engine criterion; both adaptive loops are held bit-equal under one
stand-in round (a seeded function of the dispatched items), which checks
the whole allocation logic free of render noise; whole renders of both
backends are held to JAX's with equal sample-count maps."""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_queue import _down_camera, _plane_scene
from torch_port_common import cross_engine, jax_scene_arrays

from tpu_ray import adaptive as jad
from tpu_ray import integrator as jinteg
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.renderer import render as jrender
from tpu_ray_torch import adaptive as pad
from tpu_ray_torch.convert import scene_from_jax_arrays
from tpu_ray_torch.core import rng
from tpu_ray_torch.integrator import (WL_SAMP_BITS, WL_SAMP_MASK,
                                      SceneKernels, trace_queue,
                                      worklist_sums_blocked)
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import megakernel
from tpu_ray_torch.ops.shade import StepConfig
from tpu_ray_torch.renderer import render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = pad.WL_QUANT


def test_constants_match_jax():
    assert (WL_SAMP_BITS, WL_SAMP_MASK) == (jinteg.WL_SAMP_BITS,
                                            jinteg.WL_SAMP_MASK)
    for name in ("DISPLAY_FLOOR", "WL_QUANT", "ROUND_ITEMS", "PAD_LADDER",
                 "POOL_REPS"):
        assert getattr(pad, name) == getattr(jad, name), name


def _stats(P, seed, n_hi=40, zero_share=0.2):
    """Seeded running statistics: counts in WL_QUANT steps (some zero, some
    at the budget), sums and square sums with pixel-dependent variance."""
    r = np.random.default_rng(seed)
    n = r.integers(1, n_hi, P).astype(np.int64) * Q
    n[r.random(P) < zero_share] = 0
    n[r.random(P) < 0.1] = n_hi * Q
    mean = r.uniform(0.0, 1.5, (P, 3))
    var = r.uniform(0.0, 0.3, (P, 3)) * r.integers(0, 2, (P, 1))
    s = mean * n[:, None]
    s2 = (var + mean * mean) * n[:, None]
    return n, s, s2, n_hi * Q


@pytest.mark.parametrize("case", ["mixed", "converged-and-budget",
                                  "round-items-rescale"])
def test_host_helpers_bit_equal_to_jax(case):
    """_round_sizes, _compact_alloc and _build_worklist, numpy on both
    sides, as written: bit-equal outputs."""
    if case == "mixed":
        n, s, s2, cap = _stats(997, 1)
        args = (0.01, cap, 16, 512)
    elif case == "converged-and-budget":
        n, s, s2, cap = _stats(500, 2, zero_share=0.5)
        args = (0.2, cap, 32, 64)
    else:   # 70,000 pixels asking 512 each: 35.8M items > ROUND_ITEMS
        n, s, s2, _ = _stats(70_000, 3, zero_share=0.0)
        n[:] = 16
        s2 = s2 * 50.0
        args = (1e-4, 4096, 16, 512)
    extra_j, err_j = jad._round_sizes(n, s, s2, *args)
    extra_p, err_p = pad._round_sizes(n, s, s2, *args)
    np.testing.assert_array_equal(extra_p, extra_j)
    np.testing.assert_array_equal(err_p, err_j)
    if case == "round-items-rescale":
        assert extra_p.sum() <= pad.ROUND_ITEMS < 70_000 * 512
    else:
        assert extra_p.any() and (extra_p == 0).any()
    for a, b in zip(pad._compact_alloc(extra_p, n, extra_p.size + 7),
                    jad._compact_alloc(extra_j, n, extra_j.size + 7)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if case != "round-items-rescale":
        for a, b in zip(pad._build_worklist(extra_p, n),
                        jad._build_worklist(extra_j, n)):
            np.testing.assert_array_equal(a, b)


def _expansion_case(case):
    r = np.random.default_rng(7 if case == "jax-test-case" else 11)
    P = 101 if case == "jax-test-case" else 4096
    hi = 5 if case == "jax-test-case" else 33
    extra = r.integers(0, hi, P).astype(np.int64) * Q
    n = r.integers(0, 40, P).astype(np.int64) * Q
    return P, extra, n


@pytest.mark.parametrize("case", ["jax-test-case", "wide"])
def test_expand_worklist_bit_equal_to_jax_and_host(case):
    """The torch expansion against JAX's _expand_worklist and the host
    oracle, with zero-count rows and padding blocks past the allocation
    (tests/test_adaptive.py's case, and a wider one)."""
    P, extra, n = _expansion_case(case)
    ref_packed, ref_bp = pad._build_worklist(extra, n)
    nb = ref_bp.size + 9
    k_pad = int((extra > 0).sum()) + 27
    alloc = pad._compact_alloc(extra, n, k_pad)
    packed, bp = pad._expand_worklist(
        *(torch.from_numpy(a).to(torch.int64) for a in alloc), nb, P)
    jpacked, jbp = jad._expand_worklist(*map(jnp.asarray, alloc), nb, P)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpacked).astype(np.int64))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jbp))
    np.testing.assert_array_equal(bp.numpy()[: ref_bp.size], ref_bp)
    assert (bp.numpy()[ref_bp.size:] == P).all()
    np.testing.assert_array_equal(packed.numpy()[: ref_packed.size],
                                  ref_packed)
    # without zero-count rows or padding blocks: the same list
    packed2, bp2 = pad._expand_worklist(
        *(torch.from_numpy(a).to(torch.int64)
          for a in pad._compact_alloc(extra, n, int((extra > 0).sum()))),
        ref_bp.size, P)
    np.testing.assert_array_equal(packed2.numpy(), ref_packed)
    np.testing.assert_array_equal(bp2.numpy(), ref_bp)


# --- one worklist round -----------------------------------------------------

W8 = H8 = 8
P8 = W8 * H8
S0 = 3          # chunk_s0 > 0: path ids offset by 3 * P
SALT = 7
N_PAD = 3 * Q   # padding items past n_work, pointing at pixel 0 sample 0
JKEY = jax.random.fold_in(jax.random.PRNGKey(5), 2)
KEY = rng.fold_in(rng.prng_key(5), 2)


def _round_worklist():
    """Non-uniform counts (0, 16 or 32 items a pixel) at nonzero absolute
    samples, pixel-major, then N_PAD padding items and 3 padding blocks."""
    r = np.random.default_rng(4)
    extra = r.choice([0, Q, 2 * Q], P8, p=[0.2, 0.5, 0.3]).astype(np.int64)
    n = r.integers(0, 6, P8).astype(np.int64) * Q
    packed, bp = pad._build_worklist(extra, n)
    wl = np.concatenate([packed, np.zeros(N_PAD, np.uint32)])
    bp = np.concatenate([bp, np.full(N_PAD // Q, P8, np.int32)])
    return wl, bp, int(packed.size)


@pytest.fixture(scope="module")
def cornell8():
    js = JSCENES["cornell"].build(seed=1024)
    return js, scene_from_jax_arrays(jax_scene_arrays(js))


def _port_round(ps, wl, n_work, bp=None, R=100, sort=False, **kw):
    kw.setdefault("epoch_iters", 5)
    sums, sqs = trace_queue(
        ps, SCENES["cornell"].camera(W8, H8), W8, H8, 0, S0, KEY, 6, R,
        cam_salt=SALT, worklist=torch.from_numpy(wl.astype(np.int64)),
        n_work=n_work, kern=SceneKernels.create(ps, sort),
        wl_block_pix=None if bp is None else torch.from_numpy(
            bp.astype(np.int64)), **kw)
    return sums.numpy(), sqs.numpy()


@pytest.fixture(scope="module")
def port_round(cornell8):
    wl, bp, n_work = _round_worklist()
    return _port_round(cornell8[1], wl, n_work, bp)


@pytest.mark.parametrize("shade_", ["fused", "xla"])
def test_worklist_round_matches_jax_queue(cornell8, port_round, shade_):
    """The port's worklist round (blocked reduction) against the JAX
    queue's, sums and square sums each under the cross-engine criterion."""
    js, _ = cornell8
    wl, bp, n_work = _round_worklist()
    sums, sqs = jinteg.trace_queue(
        js, JSCENES["cornell"].camera(W8, H8), W8, H8, 0, jnp.uint32(S0),
        JKEY, 6, R=100, engine="xla", shade=shade_,
        cam_salt=jnp.uint32(SALT), epoch_iters=16,
        worklist=jnp.asarray(wl), n_work=n_work,
        wl_block_pix=jnp.asarray(bp))
    cross_engine(np.asarray(sums).reshape(H8, W8, 3),
                 port_round[0].reshape(H8, W8, 3))
    cross_engine(np.asarray(sqs).reshape(H8, W8, 3),
                 port_round[1].reshape(H8, W8, 3))
    assert (port_round[0].reshape(-1, 3).sum(1) > 0).sum() > P8 // 2


def test_worklist_padding_is_inert(cornell8, port_round):
    """Items past n_work are never dispatched: the padded list's sums are
    the exact list's, bit for bit (planar reduction, where a dispatched
    padding item would add to pixel 0)."""
    wl, _, n_work = _round_worklist()
    exact = _port_round(cornell8[1], wl[:n_work], None)
    padded = _port_round(cornell8[1], wl, n_work)
    for a, b in zip(exact, padded):
        np.testing.assert_array_equal(a, b)


def test_blocked_reduction_close_to_planar(cornell8, port_round):
    wl, _, n_work = _round_worklist()
    planar = _port_round(cornell8[1], wl, n_work)
    for a, b in zip(planar, port_round):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_uniform_worklist_matches_plain_queue(cornell8):
    """A uniform worklist at chunk_s0 = 0 (item w: pixel w % P, sample
    w // P) gives the plain queue's sums: same items, same draws."""
    ps = cornell8[1]
    cam = SCENES["cornell"].camera(W8, H8)
    w = np.arange(P8 * 4, dtype=np.int64)
    wl = ((w % P8) << WL_SAMP_BITS) | (w // P8)
    plain = trace_queue(ps, cam, W8, H8, 4, 0, KEY, 6, 100, cam_salt=SALT,
                        epoch_iters=5).numpy()
    sums, sqs = trace_queue(ps, cam, W8, H8, 0, 0, KEY, 6, 100,
                            cam_salt=SALT, epoch_iters=5,
                            worklist=torch.from_numpy(wl))
    np.testing.assert_allclose(sums.numpy(), plain, rtol=1e-5, atol=1e-6)
    assert (sqs.numpy() >= 0).all() and np.isfinite(sqs.numpy()).all()


@pytest.mark.parametrize("schedule", [
    dict(R=333), dict(epoch_iters=1), dict(R=400, drain_levels=(128, 32)),
    dict(sort=True, R=77, epoch_iters=3)],
    ids=["lanes", "epoch", "drain-ladder", "sorted-sweep"])
def test_worklist_schedule_invariance_exact(cornell8, port_round, schedule):
    wl, bp, n_work = _round_worklist()
    got = _port_round(cornell8[1], wl, n_work, bp, **schedule)
    for a, b in zip(port_round, got):
        np.testing.assert_array_equal(a, b)


def test_blocked_reduction_needs_a_pixel_major_list():
    plane = torch.zeros((3, 4 * Q + 1))
    with pytest.raises(ValueError, match="pixel-major"):
        worklist_sums_blocked(plane, torch.tensor([0, 2, 1, 3]), 4)


# --- both adaptive loops under one stand-in round ----------------------------

def _hash_u(a, b):
    """A seeded uniform in [0, 1) per (a, b) (murmur3's finaliser)."""
    h = (a.astype(np.uint64) * np.uint64(0x9E3779B1)
         + b.astype(np.uint64) * np.uint64(0x85EBCA77)) & np.uint64(
        0xFFFFFFFF)
    for sh, mul in ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, None)):
        h ^= h >> np.uint64(sh)
        if mul is not None:
            h = (h * np.uint64(mul)) & np.uint64(0xFFFFFFFF)
    return h.astype(np.float64) / 2.0**32


def _radiance(pix, u):
    """Per-item (N, 3) radiance: a pixel-dependent mean and spread (a
    fifth of the pixels have none and converge at the pilot)."""
    mean = 0.05 + 0.8 * (pix % 7) / 7.0
    spread = (pix % 5) / 2.0
    v = mean + spread * (u - 0.5)
    return np.stack([v, 0.5 * v, 0.25 * v + 0.1 * u], axis=-1)


def _stand_in_queue(packed, n_work, work_s0, P, log):
    items = np.asarray(packed).astype(np.int64)[:n_work]
    pix, samp = items >> WL_SAMP_BITS, items & WL_SAMP_MASK
    log.append((items, int(work_s0)))
    rad = _radiance(pix, _hash_u(pix, samp + 7919 * int(work_s0)))
    sums = np.stack([np.bincount(pix, rad[:, c], P) for c in range(3)], -1)
    sqs = np.stack([np.bincount(pix, rad[:, c] ** 2, P) for c in range(3)],
                   -1)
    return sums.astype(np.float32), sqs.astype(np.float32)


def _stand_in_pool(act, m, slot_base, P, log):
    act = np.asarray(act).astype(np.int64)
    log.append((act, int(m), int(slot_base)))
    reps = np.arange(pad.POOL_REPS, dtype=np.int64)
    slot = act[:, None] + reps[None, :] * P                  # (A, Q)
    j = int(slot_base) + np.arange(int(m))
    u = _hash_u(slot[..., None], j[None, None, :])           # (A, Q, m)
    pix = np.broadcast_to(act[:, None, None], u.shape)
    acc = _radiance(pix, u).sum(axis=2)                      # (A, Q, 3)
    return np.stack([acc.sum(axis=1), (acc * acc).sum(axis=1)]
                    ).astype(np.float32)


@pytest.mark.parametrize("backend", ["queue", "queue-round-items", "pool"])
def test_adaptive_loops_bit_equal_under_a_stand_in_round(monkeypatch,
                                                        backend):
    """Monkeypatch the round of both adaptive loops with one seeded
    function of the dispatched items: every round's dispatched items (or
    active pixels, samples per slot and slot base), the count map and the
    image are bit-equal between tpu_ray.adaptive and
    tpu_ray_torch.adaptive."""
    W, H = 32, 24
    P = W * H
    jlog, plog = [], []
    if backend == "pool":
        monkeypatch.setattr(
            jad, "_pool_round",
            lambda scene, camera, act, key, width, height, max_depth,
            engine, shade, rr_depth, n_slot, sample0: _stand_in_pool(
                act, n_slot, sample0, P, jlog))
        monkeypatch.setattr(
            pad, "_pool_round",
            lambda scene, cfg, act, key, width, height, engine, kern:
            torch.from_numpy(_stand_in_pool(act, cfg.n_samples, cfg.sample0,
                                            P, plog)))
    else:
        if backend == "queue-round-items":
            monkeypatch.setattr(jad, "ROUND_ITEMS", 5000)
            monkeypatch.setattr(pad, "ROUND_ITEMS", 5000)

        def jstub(scene, camera, width, height, chunk_spp, chunk_s0, key,
                  *a, worklist=None, n_work=None, **kw):
            return _stand_in_queue(worklist, n_work, chunk_s0, P, jlog)

        def pstub(scene, camera, width, height, chunk_spp, chunk_s0, key,
                  *a, worklist=None, n_work=None, **kw):
            return tuple(torch.from_numpy(x) for x in _stand_in_queue(
                worklist, n_work, chunk_s0, P, plog))

        monkeypatch.setattr(jad, "trace_queue", jstub)
        monkeypatch.setattr(pad, "trace_queue", pstub)
    mode = "pool" if backend == "pool" else "queue"
    kw = dict(spp_max=520, tol=0.004, max_depth=4, seed=9, mode=mode,
              return_spp=True)
    a, na = jad.render_adaptive(JSCENES["cornell"].build(),
                                JSCENES["cornell"].camera(W, H), W, H, **kw)
    b, nb = pad.render_adaptive(SCENES["cornell"].build(),
                                SCENES["cornell"].camera(W, H), W, H,
                                device="cpu", **kw)
    assert len(plog) == len(jlog) >= 3
    for x, y in zip(plog, jlog):
        np.testing.assert_array_equal(x[0], y[0])
        assert x[1:] == y[1:]
    np.testing.assert_array_equal(nb, na)
    np.testing.assert_array_equal(b, a)
    assert len(np.unique(nb)) > 2 and nb.min() < nb.max() <= 520


# --- whole renders ----------------------------------------------------------

@pytest.mark.parametrize("mode,pilot", [("queue", 4), ("pool", 8)])
def test_furnace_plane_stops_at_the_pilot(mode, pilot):
    """Every sample of the albedo plane under a white sky is exactly the
    albedo: zero variance, so every pixel stops at the quantised pilot with
    the exact mean."""
    img, n = pad.render_adaptive(
        _plane_scene(), _down_camera(), 8, 8, spp_max=256, tol=0.01,
        max_depth=8, seed=2, pilot_spp=pilot, mode=mode, return_spp=True,
        device="cpu")
    assert (n == (Q if mode == "queue" else pad.POOL_REPS)).all()
    np.testing.assert_allclose(
        img, np.broadcast_to([0.5, 0.25, 0.125], img.shape), rtol=1e-5)


def _both_renders(name, W, H, **kw):
    kw.update(return_spp=True)
    a, na = jad.render_adaptive(JSCENES[name].build(seed=1024),
                                JSCENES[name].camera(W, H), W, H, **kw)
    b, nb = pad.render_adaptive(SCENES[name].build(seed=1024),
                                SCENES[name].camera(W, H), W, H,
                                device="cpu", **kw)
    return a, na, b, nb


def test_pool_round_matches_jax_op_by_op():
    """One pool round (36 pixels of a 12x12 image, 1 sample a slot from
    per-slot sample 1, depth 6) against the JAX round run op by op: every
    pixel within the criterion's tolerance.  JAX's jitted round rounds
    differently on ~3e-4 of its depth-8 samples (ROADMAP section C)."""
    W, H, m, sb, depth = 12, 12, 1, 1, 6
    act = np.arange(36)
    with jax.disable_jit():
        a = np.asarray(jad._pool_round(
            JSCENES["cornell"].build(seed=1024),
            JSCENES["cornell"].camera(W, H), jnp.asarray(act, jnp.int32),
            jax.random.fold_in(jax.random.PRNGKey(5), 1), W, H, depth, "xla",
            "xla", 0, jnp.int32(m), jnp.uint32(sb)))
    ps = SCENES["cornell"].build(seed=1024)
    cfg = StepConfig.create(ps, SCENES["cornell"].camera(W, H), W, H,
                            depth, n_samples=m, sample0=sb)
    b = pad._pool_round(ps, cfg, torch.from_numpy(act),
                        rng.fold_in(rng.prng_key(5), 1), W, H, "xla",
                        SceneKernels.create(ps)).numpy()
    cross_engine(a, b, share=0.0)


@pytest.fixture(scope="module")
def pool_renders():
    return _both_renders("cornell", 16, 16, spp_max=64, tol=0.02,
                         max_depth=8, seed=5, mode="pool")


def test_pool_backend_render_matches_jax(pool_renders):
    """At 16x16: JAX's jitted pool round diverges from its own op-by-op
    run, which the port equals, and whole renders at 12x12 diverge on up
    to 3 pixels, 2.08% (tools/torch_adaptive_study.py)."""
    a, na, b, nb = pool_renders
    np.testing.assert_array_equal(nb, na)
    assert na.min() >= 16 and na.max() <= 64 and len(np.unique(na)) > 1
    cross_engine(a, b)


def test_queue_backend_render_matches_jax():
    """Hazard: the queue keys draws by list position, so one pixel
    allocated differently moves every later draw.  So first the uniform
    queue renders agree on every pixel at this size; then the count maps
    are equal and the images meet the cross-engine criterion."""
    W, H = 10, 8
    uni = dict(spp=16, max_depth=8, seed=4, mode="queue")
    a = np.asarray(jrender(JSCENES["two-spheres"].build(seed=1024),
                           JSCENES["two-spheres"].camera(W, H), W, H, **uni))
    b = render(SCENES["two-spheres"].build(seed=1024),
               SCENES["two-spheres"].camera(W, H), W, H, device="cpu", **uni)
    cross_engine(a, b, share=0.0)
    a, na, b, nb = _both_renders("two-spheres", W, H, spp_max=64, tol=0.03,
                                 max_depth=8, seed=4, mode="queue")
    np.testing.assert_array_equal(nb, na)
    assert na.min() >= 16 and na.max() <= 64 and len(np.unique(na)) > 1
    cross_engine(a, b)


def test_megakernel_pool_backend_matches_wavefront_pool(pool_renders):
    """engine="mega" (the megakernel's plain twin here) against the
    wavefront pool backend: the same slots and draws."""
    _, _, b, nb = pool_renders
    calls = megakernel.trace_pool_mega_plain.calls
    c, nc = pad.render_adaptive(
        SCENES["cornell"].build(seed=1024), SCENES["cornell"].camera(16, 16),
        16, 16, spp_max=64, tol=0.02, max_depth=8, seed=5, mode="pool",
        engine="mega", return_spp=True, device="cpu")
    assert megakernel.trace_pool_mega_plain.calls > calls
    np.testing.assert_array_equal(nc, nb)
    cross_engine(b, c)


def test_render_adaptive_entry_points():
    """render(adaptive=TOL) is render_adaptive with spp as the budget (mode
    not read); a mesh renders on the queue backend
    (tests/test_torch_mesh.py); the packing bounds raise."""
    spec = SCENES["two-spheres"]
    args = (spec.build(), spec.camera(10, 8), 10, 8)
    img = render(*args, spp=32, max_depth=4, seed=3, adaptive=0.05,
                 mode="wave", device="cpu")
    assert img.shape == (8, 10, 3) and np.isfinite(img).all()
    ref = pad.render_adaptive(*args, spp_max=32, tol=0.05, max_depth=4,
                              seed=3, device="cpu")
    np.testing.assert_array_equal(img, ref)
    from tpu_ray_torch.parallel.mesh import make_mesh

    meshed = pad.render_adaptive(*args, spp_max=32, tol=0.05, max_depth=4,
                                 seed=3, mesh=make_mesh(2, "cpu"))
    assert meshed.shape == (8, 10, 3) and np.isfinite(meshed).all()
    with pytest.raises(ValueError, match="pixels"):
        pad.render_adaptive(args[0], args[1], 1024, 257, device="cpu")
    with pytest.raises(ValueError, match="spp"):
        pad.render_adaptive(*args, spp_max=WL_SAMP_MASK + 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pad.render_adaptive(*args, spp_max=16)


def test_cli_adaptive_ppm():
    """``python -m tpu_ray_torch --adaptive`` end to end on the CPU: P3
    header and w*h*3 + 4 words."""
    w, h = 8, 6
    out = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch", "--device", "cpu", "--scene",
         "cornell", "--width", str(w), "--height", str(h), "--spp", "32",
         "--max-depth", "4", "--adaptive", "0.05"], cwd=ROOT,
        capture_output=True, text=True, check=True, timeout=300)
    words = out.stdout.split()
    assert words[:4] == ["P3", str(w), str(h), "255"]
    assert len(words) == w * h * 3 + 4
    assert "[adaptive/pool] round 1" in out.stderr and "Done." in out.stderr
