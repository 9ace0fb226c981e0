"""The whole-wave megakernel of the port: tpu_ray_torch.ops.megakernel on the
CPU (its plain version) against tpu_ray.ops.megakernel.trace_pool_mega (the
Pallas kernel in interpret mode), against the port's own wavefront pool, and
the renderer's engine switch.

The yardstick is that of tests/test_megakernel.py: sample counts equal; at
most 3% of lanes diverged (|a - b| / (1 + |a|) >= 1e-4: a specular coin
flipped at the ulp boundary moves a whole path), the rest within rtol 2e-4 /
atol 1e-4.  Images use the cross-engine criterion (at most 2% of pixels).
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import cross_engine

from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.ops import megakernel as jmega
from tpu_ray.renderer import render as jrender
from tpu_ray_torch.core import rng
from tpu_ray_torch.integrator import trace_pool_mega, trace_pool_staged
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import megakernel as mega
from tpu_ray_torch.ops.shade import StepConfig
from tpu_ray_torch.renderer import render, resolve_engine, resolve_mode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPPORTED = ["cornell", "two-spheres", "two-perlin-spheres", "simple-light",
             "cornell-smoke", "book1-final"]
W, H = 16, 12


def _agree(ref, got, ref_ns, got_ns, diverged=0.03):
    """ref, got: (R, 3) radiance sums; the yardstick above."""
    ref, got = np.asarray(ref), np.asarray(got)
    np.testing.assert_array_equal(np.asarray(ref_ns), np.asarray(got_ns))
    err = np.abs(ref - got) / (1.0 + np.abs(ref))
    close = (err < 1e-4).all(axis=-1)
    frac = 1.0 - close.mean()
    assert frac <= diverged, f"{frac:.2%} lanes diverged (max {err.max():.2e})"
    np.testing.assert_allclose(ref[close], got[close], rtol=2e-4, atol=1e-4)


def _grid():
    xs = np.tile(np.arange(W, dtype=np.float32) / W, H)
    ys = np.repeat(np.arange(H - 1, -1, -1, dtype=np.float32) / H, W)
    return xs, ys


def _port_wave(name, fn, seed, n_samples, depth, sample0=0, cam_salt=0,
               rr_depth=0):
    spec = SCENES[name]
    scene = spec.build(seed=1024, earth=None)
    cfg = StepConfig.create(scene, spec.camera(W, H), W, H, depth,
                            rr_depth=rr_depth, n_samples=n_samples,
                            sample0=sample0, cam_salt=cam_salt)
    xs, ys = _grid()
    xy = torch.from_numpy(np.stack([xs, ys]))
    slot = torch.arange(W * H, dtype=torch.int32)
    acc, ns = fn(scene, cfg, xy, slot, rng.prng_key(seed))
    return acc.T.numpy(), ns.numpy()


def _jax_wave(name, seed, n_samples, depth, sample0=0, cam_salt=0,
              rr_depth=0):
    spec = JSCENES[name]
    scene = spec.build(seed=1024, earth=None)
    xs, ys = _grid()
    return jmega.trace_pool_mega(
        scene, spec.camera(W, H), jnp.asarray(xs), jnp.asarray(ys),
        (1.0 / W, 1.0 / H), jax.random.PRNGKey(seed), n_samples,
        jnp.uint32(sample0), depth, cam_salt=jnp.uint32(cam_salt),
        rr_depth=rr_depth, interpret=True)


@pytest.mark.parametrize("name", SUPPORTED)
def test_trace_pool_mega_matches_jax_megakernel(name):
    calls, launches = mega.trace_pool_mega_plain.calls, \
        mega.trace_pool_mega.launches
    got, got_ns = _port_wave(name, trace_pool_mega, 7, 4, 8)
    assert mega.trace_pool_mega_plain.calls == calls + 1   # CPU: plain version
    assert mega.trace_pool_mega.launches == launches
    ref, ref_ns = _jax_wave(name, 7, 4, 8)
    assert (got_ns == 4).all() and np.isfinite(got).all()
    assert got.any() or name == "two-perlin-spheres"   # black sky, no light
    _agree(ref, got, ref_ns, got_ns)


@pytest.mark.parametrize("kw", [
    dict(n_samples=2, depth=6, sample0=6, cam_salt=0xABCD1234),
    dict(n_samples=3, depth=8, rr_depth=3)], ids=["sample0-salt", "rr-depth"])
def test_trace_pool_mega_sample0_salt_and_roulette(kw):
    got, got_ns = _port_wave("cornell", trace_pool_mega, 3, **kw)
    ref, ref_ns = _jax_wave("cornell", 3, **kw)
    _agree(ref, got, ref_ns, got_ns)


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke",
                                  "two-perlin-spheres", "book1-final"])
def test_mega_plain_matches_the_ports_wavefront_pool(name):
    """Same inputs through the uncompacted one-sum loop and through the
    staged pool: same paths, sums equal to reassociation."""
    kw = dict(seed=5, n_samples=3, depth=6, sample0=2, cam_salt=9)
    a, a_ns = _port_wave(name, trace_pool_staged, **kw)
    b, b_ns = _port_wave(name, mega.trace_pool_mega_plain, **kw)
    _agree(a, b, a_ns, b_ns)


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke"])
def test_mega_plain_lane_results_follow_their_slots(name):
    """The invariant the persistent megakernel rests on: a lane's result is
    a function of its (xy, slot id), not of its position, so the same wave
    with its lanes permuted gives the same bits, permuted."""
    spec = SCENES[name]
    scene = spec.build(seed=1024, earth=None)
    cfg = StepConfig.create(scene, spec.camera(W, H), W, H, 6, n_samples=3,
                            sample0=2, cam_salt=9)
    xs, ys = _grid()
    xy = torch.from_numpy(np.stack([xs, ys]))
    slot = torch.arange(W * H, dtype=torch.int32)
    perm = torch.from_numpy(np.random.default_rng(4).permutation(W * H))
    key = rng.prng_key(5)
    a, a_ns = mega.trace_pool_mega_plain(scene, cfg, xy, slot, key)
    b, b_ns = mega.trace_pool_mega_plain(scene, cfg, xy[:, perm].contiguous(),
                                         slot[perm].contiguous(), key)
    assert torch.equal(b, a[:, perm]) and torch.equal(b_ns, a_ns[perm])
    assert (a_ns == 3).all() and a.any()


def test_mega_depth_zero_and_input_checks():
    spec = SCENES["cornell"]
    scene = spec.build(seed=1024)
    cfg = StepConfig.create(scene, spec.camera(W, H), W, H, 0, n_samples=2)
    xy = torch.zeros((2, 8))
    slot = torch.arange(8, dtype=torch.int32)
    acc, ns = trace_pool_mega(scene, cfg, xy, slot, rng.prng_key(1))
    assert not acc.any() and (ns == 2).all()
    with pytest.raises(ValueError):
        trace_pool_mega(scene, cfg, xy[:, :4], slot, rng.prng_key(1))
    with pytest.raises(ValueError):
        trace_pool_mega(scene, cfg, xy, slot.long(), rng.prng_key(1))
    big = SCENES["next-week-final"].build(seed=1024, earth=None)
    with pytest.raises(ValueError, match="scope"):
        trace_pool_mega(big, cfg, xy, slot, rng.prng_key(1))


@pytest.mark.parametrize("threads", [1, 8, 256])
def test_launch_mega_takes_cuda_tensors_only(threads):
    """The kernel's launch at any thread count has no plain fallback: on
    CPU tensors it raises and counts no launch."""
    spec = SCENES["cornell"]
    scene = spec.build(seed=1024)
    cfg = StepConfig.create(scene, spec.camera(W, H), W, H, 4, n_samples=2)
    xy = torch.zeros((2, 8))
    slot = torch.arange(8, dtype=torch.int32)
    launches = mega.trace_pool_mega.launches
    with pytest.raises(ValueError, match="CUDA"):
        mega.launch_mega(scene, cfg, xy, slot, rng.prng_key(1), None, threads)
    assert mega.trace_pool_mega.launches == launches


def test_key_table_is_the_jax_megakernels():
    """Columns 0:2 the scatter key, 2:4 the intersect key of iteration it."""
    key = jax.random.PRNGKey(7)
    tab = mega.key_table(rng.prng_key(7), 5)
    assert tab.shape == (5, 4) and tab.dtype == np.uint32
    for it in range(5):
        kb = jax.random.fold_in(key, it)
        want = np.concatenate([
            np.asarray(jax.random.key_data(jax.random.fold_in(kb, 1))),
            np.asarray(jax.random.key_data(jax.random.fold_in(kb, 0)))])
        np.testing.assert_array_equal(tab[it], want.astype(np.uint32))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_supported_agrees_with_jax(name):
    img = np.zeros((4, 4, 3), np.uint8)
    a = jmega.supported(JSCENES[name].build(seed=1024, earth=img))
    b = mega.supported(SCENES[name].build(seed=1024, earth=img))
    assert a == b
    if name in ("earth", "next-week-final"):
        assert not b
    if name in SUPPORTED:
        assert b
    assert mega.MAX_PRIMS == jmega.MAX_PRIMS == 512


def test_render_engine_mega_matches_jax_and_the_wavefront():
    """Several waves, nonzero sample0: the port's megakernel render against
    the JAX package's and against the port's own wavefront pool."""
    kw = dict(spp=8, max_depth=6, seed=11, samples_per_wave=2,
              rays_per_wave=256)        # one slot per pixel, four waves
    jspec, spec = JSCENES["cornell"], SCENES["cornell"]
    args = (spec.build(seed=1024), spec.camera(W, H), W, H)
    calls = mega.trace_pool_mega_plain.calls
    b = render(*args, device="cpu", engine="mega", **kw)
    assert mega.trace_pool_mega_plain.calls == calls + 4
    a = np.asarray(jrender(jspec.build(seed=1024), jspec.camera(W, H), W, H,
                           engine="mega", **kw))
    c = render(*args, device="cpu", engine="auto", **kw)
    assert b.shape == (H, W, 3) and np.isfinite(b).all()
    cross_engine(a, b)
    cross_engine(c, b)


def test_engine_mega_on_an_unsupported_scene_falls_to_the_wavefront(capsys):
    big = SCENES["next-week-final"].build(seed=1024, earth=None)
    assert resolve_engine(big, "mega") == "xla"
    assert "wavefront" in capsys.readouterr().err
    assert resolve_mode(big, "auto", "xla") == "queue"
    small = SCENES["cornell"].build(seed=1024)
    assert resolve_engine(small, "mega") == "mega"
    assert resolve_engine(small, "auto") == "xla"
    assert resolve_engine(small, "pallas") == "pallas"
    assert capsys.readouterr().err == ""
    calls = mega.trace_pool_mega_plain.calls
    img = render(big, SCENES["next-week-final"].camera(8, 6), 8, 6, spp=1,
                 max_depth=2, device="cpu", engine="mega")
    assert mega.trace_pool_mega_plain.calls == calls
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()


def test_queue_request_with_mega_is_demoted_to_the_pool(capsys):
    small = SCENES["cornell"].build(seed=1024)
    assert resolve_mode(small, "queue", "mega") == "pool"
    assert "demoting mode=queue" in capsys.readouterr().err
    assert resolve_mode(small, "queue", "auto") == "queue"
    assert resolve_mode(small, "wave", "mega") == "wave"
    assert resolve_mode(small, "auto", "mega") == "pool"
    assert capsys.readouterr().err == ""
    cam = SCENES["cornell"].camera(8, 6)
    kw = dict(spp=2, max_depth=3, seed=3, device="cpu", engine="mega")
    calls = mega.trace_pool_mega_plain.calls
    a = render(small, cam, 8, 6, mode="queue", **kw)
    assert mega.trace_pool_mega_plain.calls == calls + 1
    np.testing.assert_array_equal(a, render(small, cam, 8, 6, mode="pool",
                                            **kw))


def test_engine_mxu_and_unknown_engines_raise():
    """Unknown engines raise; ``"mxu"`` resolves to itself and renders
    (tests/test_torch_engine_mxu.py holds it to the JAX package's)."""
    small = SCENES["cornell"].build(seed=1024)
    assert resolve_engine(small, "mxu") == "mxu"
    img = render(small, SCENES["cornell"].camera(8, 6), 8, 6, spp=1,
                 max_depth=2, device="cpu", engine="mxu")
    assert np.isfinite(img).all()
    with pytest.raises(ValueError):
        resolve_engine(small, "fast")


def test_cli_engine_mega_renders_a_ppm_on_the_cpu():
    w, h = 32, 24
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch", "--device", "cpu", "--scene",
         "cornell", "--engine", "mega", "--width", str(w), "--height", str(h),
         "--spp", "8", "--max-depth", "6"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    words = r.stdout.split()
    assert words[:4] == ["P3", str(w), str(h), "255"]
    assert len(words) == w * h * 3 + 4
    assert np.array(words[4:], int).mean() > 5
