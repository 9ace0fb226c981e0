"""Adaptive sampling against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_adaptive_study.py

(about five minutes).  Reads three things and prints one JSON line:

* ``bias``: the image mean of ``render_adaptive`` (tol 0.03, depth 50,
  seed 1024) of the JAX package and of the port against the port's uniform
  render at the same budget: cornell 40x40 on the pool backend (budget
  256) and next-week-final 24x24 on the queue backend (budget 128); with
  the share of equal sample counts, the share of pixels that stopped at
  the pilot and the means over those pixels and over the rest;
* ``pool_round``: one pool round (cornell 12x12, all 144 pixels, 8 samples
  a slot from per-slot sample 2, depth 8): the pixels on which the JAX
  package's jitted ``_pool_round``, its op-by-op run
  (``jax.disable_jit``) and the port's round diverge (cross-engine
  criterion);
* ``pool_render``: whole pool-backend renders of cornell (budget 64, tol
  0.02, depth 8) at 12x12 and 16x16 for seeds 1, 2, 5 and 7: equal count
  maps, and the share of pixels where the port's image diverges from the
  JAX package's.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from tpu_ray import adaptive as jad  # noqa: E402
from tpu_ray.models.scenes import SCENES as JSCENES  # noqa: E402
from tpu_ray_torch import adaptive as pad  # noqa: E402
from tpu_ray_torch.core import rng  # noqa: E402
from tpu_ray_torch.integrator import SceneKernels  # noqa: E402
from tpu_ray_torch.models.scenes import SCENES  # noqa: E402
from tpu_ray_torch.ops.shade import StepConfig  # noqa: E402
from tpu_ray_torch.renderer import render  # noqa: E402


def divergent(a, b):
    """Pixels outside the cross-engine criterion's 1e-4 relative error."""
    err = np.abs(a - b) / (1.0 + np.abs(a))
    return (err >= 1e-4).any(axis=-1)


def both(name, W, H, **kw):
    kw.update(return_spp=True)
    a, na = jad.render_adaptive(JSCENES[name].build(seed=1024, earth=None),
                                JSCENES[name].camera(W, H), W, H, **kw)
    b, nb = pad.render_adaptive(SCENES[name].build(seed=1024, earth=None),
                                SCENES[name].camera(W, H), W, H,
                                device="cpu", **kw)
    return np.asarray(a), na, b, nb


def bias(name, W, H, budget, mode):
    a, na, b, nb = both(name, W, H, spp_max=budget, tol=0.03, max_depth=50,
                        seed=1024, mode=mode)
    u = render(SCENES[name].build(seed=1024, earth=None),
               SCENES[name].camera(W, H), W, H, spp=budget, max_depth=50,
               seed=1024, mode=mode, device="cpu")
    pilot = nb == nb.min()
    return dict(size=f"{W}x{H}", budget=budget, mode=mode,
                counts_equal=float((na == nb).mean()),
                mean_spp=float(nb.mean()),
                jax_rel=float(a.mean() / u.mean() - 1.0),
                port_rel=float(b.mean() / u.mean() - 1.0),
                pilot_share=float(pilot.mean()),
                pilot_adaptive=float(b[pilot].mean()),
                pilot_uniform=float(u[pilot].mean()),
                rest_adaptive=float(b[~pilot].mean()),
                rest_uniform=float(u[~pilot].mean()))


def pool_round():
    W = H = 12
    m, sb = 8, 2
    act = np.arange(W * H)
    args = (JSCENES["cornell"].build(seed=1024),
            JSCENES["cornell"].camera(W, H), jnp.asarray(act, jnp.int32),
            jax.random.fold_in(jax.random.PRNGKey(5), 1), W, H, 8, "xla",
            "xla", 0, jnp.int32(m), jnp.uint32(sb))
    jit = np.asarray(jad._pool_round(*args))[0]
    with jax.disable_jit():
        eager = np.asarray(jad._pool_round(*args))[0]
    ps = SCENES["cornell"].build(seed=1024)
    cfg = StepConfig.create(ps, SCENES["cornell"].camera(W, H), W, H, 8,
                            n_samples=m, sample0=sb)
    port = pad._pool_round(ps, cfg, torch.from_numpy(act),
                           rng.fold_in(rng.prng_key(5), 1), W, H, "xla",
                           SceneKernels.create(ps)).numpy()[0]
    ix = lambda m_: [int(i) for i in np.nonzero(m_)[0]]  # noqa: E731
    return dict(samples=int(act.size * pad.POOL_REPS * m),
                jit_vs_port=ix(divergent(jit, port)),
                op_by_op_vs_port=ix(divergent(eager, port)),
                jit_vs_op_by_op=ix(divergent(jit, eager)))


def pool_render():
    out = {}
    for side in (12, 16):
        for seed in (1, 2, 5, 7):
            a, na, b, nb = both("cornell", side, side, spp_max=64, tol=0.02,
                                max_depth=8, seed=seed, mode="pool")
            out[f"{side}x{side} seed {seed}"] = dict(
                counts_equal=bool((na == nb).all()),
                divergent_share=float(divergent(a, b).mean()))
    return out


if __name__ == "__main__":
    print(json.dumps(dict(
        bias=[bias("cornell", 40, 40, 256, "pool"),
              bias("next-week-final", 24, 24, 128, "queue")],
        pool_round=pool_round(), pool_render=pool_render())))
