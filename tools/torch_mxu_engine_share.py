"""Share of pixels close (rtol / atol 2e-3) between the matrix-product
and the dense sphere sweep, in both packages, on the CPU.

tests/test_intersect.py::test_mxu_render_statistically_identical holds
the JAX package's ``engine="mxu"`` render of book1-final at 32x24, 8 spp,
depth 8, to more than 95% of pixels close to its ``engine="xla"``
render.  This script renders book1-final at a given size, spp and depth
with both engines in both packages (the port's plain twins) and prints
the four shares: JAX mxu vs xla, the port's mxu vs dense, and each port
engine vs its JAX counterpart, with the image means.

    python tools/torch_mxu_engine_share.py 48 32 16 50
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from tpu_ray.models.scenes import SCENES as JSCENES  # noqa: E402
from tpu_ray.renderer import render as jrender  # noqa: E402
from tpu_ray_torch.models.scenes import SCENES  # noqa: E402
from tpu_ray_torch.renderer import render  # noqa: E402


def close(a, b) -> float:
    return float(np.isclose(a, b, rtol=2e-3, atol=2e-3).mean())


def main(argv=None) -> int:
    w, h, spp, depth = (int(v) for v in (argv or sys.argv[1:]))
    kw = dict(spp=spp, max_depth=depth, seed=1024)
    img = {}
    for engine in ("xla", "mxu"):
        js, ps = JSCENES["book1-final"], SCENES["book1-final"]
        img[f"jax_{engine}"] = np.asarray(jrender(
            js.build(seed=1024, earth=None), js.camera(w, h), w, h,
            engine=engine, **kw))
        img[f"port_{engine}"] = render(
            ps.build(seed=1024, earth=None), ps.camera(w, h), w, h,
            engine=engine, device="cpu", **kw)
    print(json.dumps(dict(
        width=w, height=h, spp=spp, depth=depth,
        jax_mxu_vs_xla=close(img["jax_xla"], img["jax_mxu"]),
        port_mxu_vs_dense=close(img["port_xla"], img["port_mxu"]),
        port_vs_jax_dense=close(img["jax_xla"], img["port_xla"]),
        port_vs_jax_mxu=close(img["jax_mxu"], img["port_mxu"]),
        means={k: float(v.mean()) for k, v in img.items()})))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
