"""The ``sobol-b0`` sampler's first-bounce override in the port's work
queue: the device direction words of Sobol' dims 6-10 against
core/qmc.py's, the queue render and the adaptive queue backend against
the JAX package's XLA queue (which overrides scatter columns 2, 3, 6 and
7 with dims 7-10 at bounce 0, tpu_ray/integrator.py:707-735), and the
pool, which keeps hashed scatter draws, bit-equal to ``sobol`` with the
JAX package's stderr line."""
from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch
from torch_port_common import cross_engine

from tpu_ray import adaptive as jad
from tpu_ray.core import qmc as jqmc
from tpu_ray.models.scenes import SCENES as JSCENES
from tpu_ray.renderer import render as jrender
from tpu_ray_torch import adaptive as pad
from tpu_ray_torch.core import qmc
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import shade
from tpu_ray_torch.renderer import render

QMC_CUH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "tpu_ray_torch", "csrc", "qmc.cuh")
LINE = "sampler=sobol-b0's bounce-dim override only runs on the XLA"


def test_device_b0_direction_words_match():
    """csrc/qmc.cuh's SOBOL_B0_V holds dims 6-10 as core/qmc.py computes
    them, which are the JAX package's."""
    with open(QMC_CUH) as f:
        src = f.read()
    body = src[src.index("SOBOL_B0_V[5][32]"):]
    body = body[:body.index("};")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9A-F]{8})u", body)]
    assert words == [v for dims in qmc.DEVICE_B0_DIRS for v in dims]
    assert len(words) == 5 * 32
    for d, dirs in zip(range(6, 11), qmc.DEVICE_B0_DIRS):
        assert dirs == [int(v) for v in getattr(jqmc, f"_SOBOL{d}_V")]


def test_queue_step_config_takes_the_override():
    """Only the queue's step configuration with sampler sobol-b0 sets the
    override; the pool's does not, and neither does sobol."""
    spec = SCENES["cornell"]
    scene = spec.build()
    for sampler, queue, want in (("sobol-b0", True, True),
                                 ("sobol-b0", False, False),
                                 ("sobol", True, False)):
        cam = spec.camera(8, 6).replace(sampler=sampler)
        cfg = shade.StepConfig.create(scene, cam, 8, 6, 4, queue=queue)
        assert cfg.b0 is want
        assert bool(shade._params(cfg, (0, 0), False)[24 + 11]
                    & shade.SAMPLER_B0_BIT) is want


def _cornell(sampler, W, H, **kw):
    a = np.asarray(jrender(JSCENES["cornell"].build(seed=1024),
                           JSCENES["cornell"].camera(W, H).replace(
                               sampler=sampler), W, H, **kw))
    b = render(SCENES["cornell"].build(seed=1024),
               SCENES["cornell"].camera(W, H).replace(sampler=sampler), W, H,
               device="cpu", **kw)
    return a, b


def test_queue_render_matches_jax(capsys):
    """cornell 12x12, 16 spp, depth 6, seed 3 on the queue: the cross-engine
    criterion against the JAX XLA queue's sobol-b0 render (95.14% of pixels
    diverged while the port rendered it as sobol), no stderr line, and an
    image other than the sobol render's."""
    kw = dict(spp=16, max_depth=6, seed=3, mode="queue")
    capsys.readouterr()
    a, b = _cornell("sobol-b0", 12, 12, **kw)
    assert LINE not in capsys.readouterr().err
    cross_engine(a, b)
    _, s = _cornell("sobol", 12, 12, **kw)
    assert (np.abs(b - s) > 1e-4).any(axis=-1).mean() > 0.5


def test_adaptive_queue_backend_matches_jax(capsys):
    """The adaptive queue backend's worklist rounds take the override too:
    equal count maps and the cross-engine criterion against the JAX
    package's adaptive queue backend, no stderr line."""
    W, H = 10, 8
    kw = dict(spp_max=64, tol=0.03, max_depth=8, seed=4, mode="queue",
              return_spp=True)
    spec, jspec = SCENES["two-spheres"], JSCENES["two-spheres"]
    capsys.readouterr()
    a, na = jad.render_adaptive(jspec.build(seed=1024), jspec.camera(W, H)
                                .replace(sampler="sobol-b0"), W, H, **kw)
    b, nb = pad.render_adaptive(spec.build(seed=1024), spec.camera(W, H)
                                .replace(sampler="sobol-b0"), W, H,
                                device="cpu", **kw)
    assert LINE not in capsys.readouterr().err
    np.testing.assert_array_equal(nb, na)
    assert len(np.unique(na)) > 1
    cross_engine(a, b)


@pytest.mark.parametrize("backend", ["render", "adaptive"])
def test_pool_sobol_b0_is_pool_sobol_and_says_so(backend, capsys):
    """The pool keeps the Sobol' camera dims with hashed scatter draws, as
    the JAX package's pool does: bit-equal to sobol, with its stderr line
    (the adaptive pool backend's too)."""
    spec = SCENES["cornell"]
    out = []
    for sampler in ("sobol", "sobol-b0"):
        args = (spec.build(seed=1024), spec.camera(12, 8).replace(
            sampler=sampler), 12, 8)
        capsys.readouterr()
        if backend == "render":
            out.append(render(*args, spp=4, max_depth=4, seed=2, mode="pool",
                              device="cpu"))
        else:
            out.append(pad.render_adaptive(*args, spp_max=32, tol=0.05,
                                           max_depth=4, seed=2, mode="pool",
                                           device="cpu"))
        err = capsys.readouterr().err
        assert (LINE in err) is (sampler == "sobol-b0")
    np.testing.assert_array_equal(out[0], out[1])
    if backend == "render":
        assert "mode=pool keeps the sobol camera dims" in err
    else:
        assert "the adaptive pool backend keeps" in err


def test_queue_step_plain_draws_dims_7_to_10_at_bounce_0():
    """The plain step's first-bounce draws: a Lambertian lane at bounce 0
    with the override and a cosine-lobe draw (coin >= 0.5) scatters along
    the direction of Sobol' dims 9-10, and the same lane at bounce 1 along
    the hashed one."""
    from tpu_ray_torch.core.rng import as_u32, fmix, hash_col

    spec = SCENES["cornell"]
    scene = spec.build()
    cam = spec.camera(8, 8).replace(sampler="sobol-b0")
    cfg = shade.StepConfig.create(scene, cam, 8, 8, 8, n_samples=0,
                                  cam_salt=11, queue=True)
    R = 256
    r = np.random.default_rng(1)
    slot = torch.from_numpy(r.integers(0, 1 << 31, R).astype(np.int32))
    lane = torch.from_numpy(np.stack([r.integers(0, 64, R),
                                      r.integers(0, 100, R)]).astype(np.int32))
    f = torch.zeros((shade.N_FSTATE, R))
    f[0:3] = torch.tensor([278.0, 278.0, -800.0])[:, None]
    f[3:6] = torch.tensor([0.0, -0.2, 1.0])[:, None]     # to the floor
    f[7:10] = 1.0
    kd = (5, 9)
    # the white floor: the quad in the plane y = 0 (normal +-y)
    p = scene.prims
    floor = int(np.flatnonzero((p.kind.numpy() == 2)
                               & (np.abs(p.quad_n.numpy()[:, 1]) == 1.0)
                               & (p.quad_d.numpy() == 0.0))[0])
    outs = []
    for bounce in (0, 1):
        i = torch.zeros((shade.N_ISTATE, R), dtype=torch.int32)
        i[0], i[2] = bounce, 1
        bt = torch.full((R,), 1000.0)
        bi = torch.full((R,), floor, dtype=torch.int32)
        fo, _ = shade.pool_step_plain(cfg, torch.zeros((2, R)), slot,
                                      f.clone(), i, bt, bi, kd, lane_b0=lane)
        outs.append(fo[3:6])
    base = fmix((as_u32(slot) + kd[0]) & 0xFFFFFFFF) ^ kd[1]
    cosine = hash_col(base, 0) >= 0.5
    assert int(cosine.sum()) > 50
    q = qmc.bounce0_uniforms(as_u32(lane[0]), as_u32(lane[1]), 11)
    # the floor's normal is +y: the cosine lobe's local z; its local x, y
    # come from the lobe's two draws, so the draws decide the direction
    phi_b0 = torch.atan2(outs[0][2], outs[0][0])
    phi_h = torch.atan2(outs[1][2], outs[1][0])
    assert not torch.allclose(phi_b0[cosine], phi_h[cosine])
    z_b0 = torch.sqrt(torch.clamp(1.0 - q[4], min=0.0))
    torch.testing.assert_close(outs[0][1][cosine], z_b0[cosine], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("sampler", ["uniform", "sobol", "sobol-b0"])
def test_queue_records_lanes_only_for_sobol_b0(sampler):
    """Only the sobol-b0 queue keeps each lane's (pixel, global sample):
    the other samplers' iterations and drain compactions carry no record,
    so their queue dispatches no operation for it.  The record holds the
    inject's pixel and global sample of every active lane."""
    from tpu_ray_torch.core import rng
    from tpu_ray_torch.integrator import (SceneKernels, _queue_init,
                                          queue_body, queue_compact)

    spec = SCENES["cornell"]
    scene = spec.build()
    W, H = 6, 4
    cam = spec.camera(W, H).replace(sampler=sampler)
    cfg = shade.StepConfig.create(scene, cam, W, H, 6, n_samples=0,
                                  cam_salt=3, queue=True)
    kern = SceneKernels.create(scene)
    key = rng.fold_in(rng.prng_key(3), 7)
    ki, ks = rng.fold_in(key, 0), rng.fold_in(key, 1)
    total, P, s0 = W * H * 3, W * H, 5
    st = _queue_init(32, total, "cpu", b0=cfg.b0)
    for _ in range(4):
        st = queue_body(st, scene, cfg, kern, ki, ks, 3, s0 * P, total, W, H)
        if sampler != "sobol-b0":
            assert st.lane is None
            continue
        act = st.istate[2] > 0
        assert bool(act.any())
        np.testing.assert_array_equal(st.lane[0][act].numpy(),
                                      (st.work[act] % P).numpy())
        np.testing.assert_array_equal(st.lane[1][act].numpy(),
                                      (s0 + st.work[act] // P).numpy())
    small = queue_compact(st, 16)
    assert (small.lane is None) == (sampler != "sobol-b0")
    if small.lane is not None:
        assert tuple(small.lane.shape) == (2, 16)
