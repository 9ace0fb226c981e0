"""The plain reference against the port's images on the CPU at a tiny size:
book 1's cover, The Next Week's final scene and book 3's Cornell box (its
light list and mixture scatter), each under the pool, the megakernel and
a second scene seed, every pixel; the bfloat16 control refused; and the
reference's light densities against their published description.

On the CPU the port runs its kernels' plain twins, whose arithmetic the
card's kernels keep bit for bit; the reference is written apart from them
and imports nothing of the port.  Run: ``python -m pytest portbench/tests``.
"""
import numpy as np
import pytest
import torch

from portbench import check, spec
from portbench.reference import scenes as ref_scenes
from portbench.reference import tracer
from portbench.traffic import request
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.renderer import render

W, H, SPP, DEPTH = 32, 24, 4, 8
MIXES = {"same_scene_100spp": dict(scene="same", scene_seed=1024,
                                   engine="auto"),
         "same_scene_100spp_mega": dict(scene="same", scene_seed=1024,
                                        engine="mega"),
         "same_scene_other_seed": dict(scene="same", scene_seed=2**31 - 5,
                                       engine="auto")}


@pytest.mark.parametrize("scene", ["book1-final", "next-week-final",
                                   "cornell"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_reference_holds_the_port_image(scene, mix):
    conf = dict(scene=scene, width=W, height=H, max_depth=DEPTH)
    req = request(dict(MIXES[mix], spp=SPP), 2**31 + 99, 3)
    spec = SCENES[scene]
    img = render(spec.build(seed=req.scene_seed, earth=None),
                 spec.camera(W, H), W, H, SPP, max_depth=DEPTH,
                 seed=req.sample_seed, engine=req.engine, device="cpu")
    pix = np.arange(W * H)
    ref = check.reference_pixels(conf, req, pix, "cpu")
    got = img.reshape(-1, 3)
    nums = check.compare(got, ref)
    assert nums["divergent_share"] == 0.0
    assert nums["mean_gap"] < 1e-6
    assert np.abs(got - ref).max() < 1e-6
    assert got.mean() > 0.01


def test_control_in_bfloat16_is_refused():
    """The control, the reference in bfloat16 in the program's place,
    fails the cell's limits on every scene (the pool's and the queue's
    schedule, and the Cornell box's light mixture)."""
    limits = spec.load_cell("nextweek.queue").correct["limits"]
    for scene in ("book1-final", "next-week-final", "cornell"):
        conf = dict(scene=scene, width=W, height=H, max_depth=DEPTH)
        req = request(dict(MIXES["same_scene_100spp"], spp=16), 5, 0)
        pix = np.arange(W * H)
        ref = check.reference_pixels(conf, req, pix, "cpu")
        low = check.reference_pixels(conf, req, pix, "cpu", torch.bfloat16)
        assert not check.judge(check.compare(low, ref), limits)


def _uniform(g, n):
    return torch.rand(n, generator=g, dtype=torch.float64).float()


def test_light_densities_integrate_to_one_and_draws_meet_their_light():
    """At a point inside the Cornell box, against the published description
    (``htblPdfValue``, ``htblRandom``), not the port: each light's density
    integrates to 1 over the directions that meet it (2^20 uniform
    directions on the sphere, one in each cell of a 1024 x 1024 grid in
    (z, phi)), and the directions drawn toward the rect and toward the
    sphere (a light picked per lane) meet that light."""
    sc = ref_scenes.build("cornell", 1024, "cpu")
    assert sc.flags["n_lights"] == 2
    assert sc.light_kind == (ref_scenes.QUAD, ref_scenes.SPHERE)
    k = 1 << 10
    n = k * k
    g = torch.Generator().manual_seed(20260419)
    o = np.array([250.0, 400.0, 250.0])
    p = tuple(torch.full((n,), v) for v in o)
    cell = torch.arange(n, dtype=torch.float64)
    z = (2.0 * (torch.div(cell, k, rounding_mode="floor")
                + _uniform(g, n).double()) / k - 1.0)
    phi = 2.0 * np.pi * (cell % k + _uniform(g, n).double()) / k
    s = torch.sqrt(1.0 - z * z)
    d = tuple(x.float() for x in (s * torch.cos(phi), s * torch.sin(phi), z))
    for j in range(2):
        pdf = tracer.light_density(sc, j, p, d).double()
        assert (pdf > 0).double().mean() > 0.01    # the light is in view
        assert abs(4.0 * np.pi * pdf.mean().item() - 1.0) < 0.02

    u = [_uniform(g, n) for _ in range(6)]
    j = torch.clamp((u[1] * 2).long(), max=1)
    w = tracer.toward_light(sc, j, p, *u[2:])
    w = np.stack([x.double().numpy() for x in w], axis=1)
    rect_w, sph_w = w[j.numpy() == 0], w[j.numpy() == 1]
    assert len(rect_w) > n // 3 and len(sph_w) > n // 3
    # the rect: xz 213..343 x 227..332 at y = 554, met ahead of the point
    t = (554.0 - o[1]) / rect_w[:, 1]
    x, zz = o[0] + t * rect_w[:, 0], o[2] + t * rect_w[:, 2]
    eps = 1e-3
    assert (t > 0).all()
    assert ((x > 213 - eps) & (x < 343 + eps)).all()
    assert ((zz > 227 - eps) & (zz < 332 + eps)).all()
    # the sphere: centre (190, 90, 190), radius 90, met ahead of the point
    c = np.array([190.0, 90.0, 190.0])
    unit = sph_w / np.linalg.norm(sph_w, axis=1, keepdims=True)
    along = unit @ (c - o)
    miss2 = np.sum((c - o) ** 2) - along ** 2
    assert (along > 0).all()
    assert (miss2 < (90.0 * (1 + 1e-5)) ** 2).all()
