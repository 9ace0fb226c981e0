"""The plain reference against the port's images on the CPU at a tiny size:
both configurations, both traffic mixes and a second scene seed, every
pixel.

On the CPU the port runs its kernels' plain twins, whose arithmetic the
card's kernels keep bit for bit; the reference is written apart from them
and imports nothing of the port.  Run: ``python -m pytest portbench/tests``.
"""
import numpy as np
import pytest
import torch

from portbench import check, spec
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


@pytest.mark.parametrize("scene", ["book1-final", "next-week-final"])
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
    fails the cell's limits on both scenes (the pool's and the queue's
    schedule)."""
    limits = spec.load_cell("nextweek.queue").correct["limits"]
    for scene in ("book1-final", "next-week-final"):
        conf = dict(scene=scene, width=W, height=H, max_depth=DEPTH)
        req = request(dict(MIXES["same_scene_100spp"], spp=16), 5, 0)
        pix = np.arange(W * H)
        ref = check.reference_pixels(conf, req, pix, "cpu")
        low = check.reference_pixels(conf, req, pix, "cpu", torch.bfloat16)
        assert not check.judge(check.compare(low, ref), limits)
