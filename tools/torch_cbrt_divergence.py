"""The strict estimator's divergences from the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_cbrt_divergence.py

(about a minute).  Reads two things and prints one JSON line:

* on 2^16 seeded float32 inputs, the share on which ``jnp.cbrt`` (op by op
  and compiled) differs from ``core.vec.cbrt_rn``, the float64 root rounded
  to float32 that the plain twins and the kernels take (the isotropic
  phase's ball radius ``cbrt(max(u, 1e-6))``, u on the 2^-24 grid), and for
  contrast a float32 ``torch.pow(x, 1/3)``;
* for each of the four strict goldens (``tests/goldens/*-strict.npy``, made
  by the JAX package's compiled pool loop), the share of divergent pixels
  (cross-engine criterion) of the port's CPU render and of the JAX
  package's op-by-op render (``jax.disable_jit``) against the golden, and
  of the port against that op-by-op render.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_strict as ts  # noqa: E402
from tpu_ray.models.scenes import SCENES as JSCENES  # noqa: E402
from tpu_ray.renderer import render as jrender  # noqa: E402
from tpu_ray_torch.core.vec import cbrt_rn  # noqa: E402
from tpu_ray_torch.models.scenes import SCENES  # noqa: E402
from tpu_ray_torch.renderer import render  # noqa: E402


def root_disagreement(n: int = 1 << 16) -> dict:
    r = np.random.default_rng(0)
    u = (r.integers(0, 1 << 24, n) * np.float32(2.0 ** -24)).astype(
        np.float32)
    u = np.maximum(u, np.float32(1e-6))
    wide = (r.random(n, dtype=np.float32) * 1e3).astype(np.float32)
    out = {}
    for label, x in (("ball radius u", u), ("x in [0, 1000)", wide)):
        want = cbrt_rn(torch.from_numpy(x)).numpy().view(np.int32)
        eager = np.asarray(jnp.cbrt(x)).view(np.int32)
        jitted = np.asarray(jax.jit(jnp.cbrt)(x)).view(np.int32)
        pow32 = torch.from_numpy(x).pow(1.0 / 3.0).numpy().view(np.int32)
        out[label] = {"jnp.cbrt": float((eager != want).mean()),
                      "jit(jnp.cbrt)": float((jitted != want).mean()),
                      "float32 pow(x, 1/3)": float((pow32 != want).mean())}
    return out


def divergent(a, b) -> float:
    err = np.abs(a - b) / (1.0 + np.abs(a))
    return float(1.0 - (err < 1e-4).all(axis=-1).mean())


def golden_divergence() -> dict:
    out = {}
    for name, (spp, depth, w, h, _, _) in ts.STRICT_GOLDENS.items():
        cam = ts._camera_name(name)
        kw = dict(spp=spp, max_depth=depth, seed=1024)
        port = render(ts._port_scene(name).replace(strict=True),
                      SCENES[cam].camera(w, h), w, h, device="cpu", **kw)
        with jax.disable_jit():
            eager = np.asarray(jrender(ts._jax_scene(name),
                                       JSCENES[cam].camera(w, h), w, h, **kw))
        golden = np.load(os.path.join(ts.GOLDEN_DIR, f"{name}-strict.npy"))
        out[name] = {"port_vs_golden": divergent(golden, port),
                     "jax_op_by_op_vs_golden": divergent(golden, eager),
                     "port_vs_jax_op_by_op": divergent(eager, port)}
    return out


def main() -> int:
    print(json.dumps({"cbrt_disagreement": root_disagreement(),
                      "strict_goldens_divergent_share": golden_divergence()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
