"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: on a machine without a CUDA device every test skips (the
kernels have no CPU mode; the CPU tests hold the plain twins to the JAX
package instead).  This file imports neither JAX nor tpu_ray, so it runs
where only the port is installed:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_ray_torch.integrator import SceneKernels, init_pool_state
from tpu_ray_torch.models import objects as ob
from tpu_ray_torch.models.compile import build_scene
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.ops import shade
from tpu_ray_torch.ops import sweep as sw
from tpu_ray_torch.ops.intersect import intersect_ti, pack_rays
from tpu_ray_torch.renderer import pixel_grid, slot_ids

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


@pytest.mark.parametrize("name", ["cornell", "cornell-smoke",
                                  "two-perlin-spheres", "simple-light"])
def test_pool_step_kernel_matches_plain(card, name):
    W, H, K = 64, 32, 4
    spec = SCENES[name]
    ps = spec.build(seed=1024, earth=None).to(card)
    cfg = shade.StepConfig.create(ps, spec.camera(W, H), W, H, 8,
                                  rr_depth=2, n_samples=3, cam_salt=7)
    st = init_pool_state(pixel_grid(W, H, K, card), slot_ids(W, H, K, card))
    R = st.slot.shape[0]
    none = (torch.empty(R, device=card),
            torch.zeros(R, dtype=torch.int32, device=card))
    st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot, st.fstate,
                                           st.istate, *none, (0, 0),
                                           init=True)
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
