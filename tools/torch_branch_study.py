"""The shade core's new branches against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_branch_study.py

(about three minutes).  Prints one JSON line.  ``sobol_b0``: cornell
12x12, 16 spp, depth 6, seed 3 on the queue with sampler sobol-b0, the JAX
package's XLA queue render against the port's (``port``) and against the
port's sobol render, which is what the port rendered for sobol-b0 before
its queue took the first-bounce override (``port_as_sobol``): the shares
of divergent pixels and the means.

The textured-checker scene is ``tests/torch_port_common.py::
textured_checker_scene`` (simple-light's layout, a Checker(SolidColor,
Noise(scale 4)) ground and a Checker(Noise, ImageTexture) sphere).  Prints
one JSON line with, for each case, the share of divergent pixels
(|a - b| / (1 + |a|) >= 1e-4) between the JAX package's jitted render, its
op-by-op render (``jax.disable_jit``) and the port's plain render, with
the image means:

* ``render``: pool, queue and wave modes and the strict pool, 16x12, 8 spp,
  depth 6, seed 3 (op by op only for the pool, the slowest to run so);
* ``wave_depth2``: the wave mode at depth 2, 4 spp, where the first
  divergent pixels appear (camera ray to the ground, one bounce);
* ``ground_scale``: the pool at 16x12 with the ground's Noise at scale 0.5,
  1, 2 and 4, the jitted render against the port's: the split grows with
  the marble's frequency.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from torch_port_common import seeded_image  # noqa: E402
from tpu_ray.models import objects as job  # noqa: E402
from tpu_ray.models.compile import build_scene as jbuild_scene  # noqa: E402
from tpu_ray.models.scenes import two_spheres_camera as jcamera  # noqa: E402
from tpu_ray.renderer import render as jrender  # noqa: E402
from tpu_ray_torch.models import objects as ob  # noqa: E402
from tpu_ray_torch.models.compile import build_scene  # noqa: E402
from tpu_ray_torch.models.scenes import two_spheres_camera  # noqa: E402
from tpu_ray_torch.renderer import render  # noqa: E402

IMG = seeded_image()


def scene(o, build, scale=4.0):
    """tests/torch_port_common.py::textured_checker_scene with the
    ground's Noise scale as a knob (4 there)."""
    ground = o.Lambertian(o.Checker(o.SolidColor((0.2, 0.3, 0.1)),
                                    o.Noise(scale=scale, seed=1024)))
    ball = o.Lambertian(o.Checker(o.Noise(scale=2.0, seed=1025),
                                  o.ImageTexture(IMG)))
    light = o.DiffuseLight((4.0, 4.0, 4.0))
    sphere_light = o.Sphere((0, 7, 0), 2, light)
    rect_light = o.Rect("xy", 3, 5, 1, 3, -2, light)
    return build([o.Sphere((0, -1000, 0), 1000, ground),
                  o.Sphere((0, 2, 0), 2, ball), sphere_light, rect_light],
                 lights=[sphere_light, rect_light],
                 background=(0.2, 0.25, 0.3))


def divergent(a, b) -> float:
    err = np.abs(a - b) / (1.0 + np.abs(a))
    return float(1.0 - (err < 1e-4).all(axis=-1).mean())


def renders(scale, w, h, op_by_op, strict=False, **kw):
    js = scene(job, jbuild_scene, scale).replace(strict=strict)
    ps = scene(ob, build_scene, scale).replace(strict=strict)
    jit = np.asarray(jrender(js, jcamera(w, h), w, h, **kw))
    port = render(ps, two_spheres_camera(w, h), w, h, device="cpu", **kw)
    out = dict(jit_vs_port=divergent(jit, port), mean_jit=float(jit.mean()),
               mean_port=float(port.mean()))
    if op_by_op:
        with jax.disable_jit():
            obo = np.asarray(jrender(js, jcamera(w, h), w, h, **kw))
        out.update(op_by_op_vs_port=divergent(obo, port),
                   jit_vs_op_by_op=divergent(jit, obo))
    return out


def sobol_b0() -> dict:
    from tpu_ray.models.scenes import SCENES as JSCENES
    from tpu_ray_torch.models.scenes import SCENES

    w = h = 12
    kw = dict(spp=16, max_depth=6, seed=3, mode="queue")
    jax_img = np.asarray(jrender(
        JSCENES["cornell"].build(seed=1024),
        JSCENES["cornell"].camera(w, h).replace(sampler="sobol-b0"), w, h,
        **kw))
    out = dict(mean_jax=float(jax_img.mean()))
    for what, sampler in (("port", "sobol-b0"), ("port_as_sobol", "sobol")):
        img = render(SCENES["cornell"].build(seed=1024),
                     SCENES["cornell"].camera(w, h).replace(sampler=sampler),
                     w, h, device="cpu", **kw)
        out[what] = dict(divergent=divergent(jax_img, img),
                         mean=float(img.mean()))
    return out


def main() -> int:
    kw = dict(spp=8, max_depth=6, seed=3)
    out = {"sobol_b0": sobol_b0(), "render": {
        f"{mode}{' strict' if strict else ''}": renders(
            4.0, 16, 12, mode == "pool", strict=strict, mode=mode, **kw)
        for mode, strict in (("pool", False), ("queue", False),
                             ("wave", False), ("pool", True))}}
    out["wave_depth2"] = renders(4.0, 16, 12, True, spp=4, max_depth=2,
                                 seed=3, mode="wave")
    out["ground_scale"] = {str(s): renders(s, 16, 12, False, mode="pool",
                                           **kw)
                           for s in (0.5, 1.0, 2.0, 4.0)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
