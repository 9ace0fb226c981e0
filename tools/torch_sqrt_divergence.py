"""The port's logged divergences from the JAX package, with its float32
plain twins' roots taken correctly rounded (``core.vec.sqrt_rn``) and, for
comparison, from ``torch.sqrt`` as before the repair (the name swapped in
each module that took ``torch.sqrt`` until then, for the run's second
half).

    JAX_PLATFORMS=cpu python tools/torch_sqrt_divergence.py

on the CPU (about two minutes).  Reads two divergences, each with the
inputs of the test that allows for it:

* the next-week-final queue render at 24x24, 2 spp, depth 6 against the
  JAX queue's (``tests/test_torch_queue.py::
  test_queue_next_week_final_matches_jax_queue``): divergent pixels under
  the cross-engine criterion;
* the pool step on two-perlin-spheres against the interpreted Pallas kernel
  (``tests/test_torch_shade.py::test_pool_step_plain_matches_pallas``):
  throughput and radiance lanes out of rtol 2e-4 / atol 1e-5, and the
  largest difference;

how many of the port's pixels and step lanes the repair changed at all,
and on what share of 2^16 seeded float32 inputs torch's CPU ``sqrt``,
``sqrt_rn``, ``log``, ``cos`` and ``sin`` differ from jnp's.  Prints one
JSON line.
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

import test_torch_queue as tq  # noqa: E402
import test_torch_shade as ts  # noqa: E402
from torch_port_common import jax_scene_arrays  # noqa: E402
from tpu_ray.models.scenes import SCENES as JSCENES  # noqa: E402
from tpu_ray.ops import shade_pallas  # noqa: E402
from tpu_ray_torch import integrator  # noqa: E402
from tpu_ray_torch.convert import scene_from_jax_arrays  # noqa: E402
from tpu_ray_torch.core import camera, vec  # noqa: E402
from tpu_ray_torch.models.scenes import SCENES  # noqa: E402
from tpu_ray_torch.ops import intersect, shade  # noqa: E402

# the modules whose float32 roots moved onto sqrt_rn here; the sweep's own
# _block_t took it earlier and keeps it in both halves
ROOT_TAKERS = (vec, camera, intersect, shade, integrator)


def use_sqrt(fn):
    for m in ROOT_TAKERS:
        m.sqrt_rn = fn


def queue_divergence(jax_img):
    w, h, spp, depth = 24, 24, 2, 6
    img = np.random.default_rng(3).integers(0, 256, (16, 32, 3), np.uint8)
    js = JSCENES["next-week-final"].build(seed=1024, earth=img)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    if jax_img is None:
        jax_img = tq._jax_queue(js, "next-week-final", w, h, spp, 0, depth,
                                "xla", 600)
    b = tq._port_queue(ps, "next-week-final", w, h, spp, 0, depth, 600)
    err = np.abs(jax_img - b) / (1.0 + np.abs(jax_img))
    div = int((~(err < 1e-4).all(axis=-1)).sum())
    return jax_img, b, dict(divergent_pixels=div, pixels=w * h)


def perlin_lanes(jax_out):
    name = "two-perlin-spheres"
    js = JSCENES[name].build(seed=1024, earth=None)
    ps = scene_from_jax_arrays(jax_scene_arrays(js))
    cfg = shade.StepConfig.create(ps, SCENES[name].camera(ts.W, ts.H), ts.W,
                                  ts.H, ts.DEPTH, n_samples=ts.N_SAMPLES,
                                  sample0=ts.SAMPLE0, cam_salt=1024)
    st, bt, bi, kd = ts._advance(ps, cfg, 4)
    fk, _ = shade.pool_step_plain(cfg, st.xy, st.slot, st.fstate, st.istate,
                                  bt, bi, kd)
    if jax_out is None:
        f, i = st.fstate.numpy(), st.istate.numpy()
        J = lambda a: jnp.asarray(np.ascontiguousarray(a))
        out = shade_pallas.pool_step_pallas(
            js, JSCENES[name].camera(ts.W, ts.H), J(st.xy[0].numpy()),
            J(st.xy[1].numpy()), J(st.slot.numpy().view(np.uint32)),
            J(f[0:3].T), J(f[3:6].T), J(f[6]), J(f[7:10].T), J(f[10:13].T),
            J(i[0]), J(i[1]), J(i[2] > 0), J(bt.numpy()), J(bi.numpy()),
            J(np.asarray(kd, np.uint32)), ts.N_SAMPLES,
            np.uint32(ts.SAMPLE0), np.uint32(1024), (1.0 / ts.W, 1.0 / ts.H),
            ts.DEPTH, interpret=True)
        jax_out = (np.asarray(out[3]), np.asarray(out[4]))
    fk = fk.numpy()
    res = {}
    for key, a, b in (("throughput", fk[7:10].T, jax_out[0]),
                      ("accum", fk[10:13].T, jax_out[1])):
        d = np.abs(a - b)
        bad = (d > 1e-5 + 2e-4 * np.abs(b)).any(axis=-1)
        res[key] = dict(lanes_out_of_tol=int(bad.sum()), lanes=len(bad),
                        max_abs_diff=float(d.max()))
    return jax_out, fk, res


def elementary_disagreement(n: int = 1 << 16) -> dict:
    """Share of seeded float32 inputs on which torch's CPU result differs
    from jnp's in any bit: the roots (plain and through ``sqrt_rn``) and
    the other functions the plain twins share with the JAX package."""
    r = np.random.default_rng(0)
    x = (r.random(n, dtype=np.float32) * 100.0).astype(np.float32)
    u = r.random(n, dtype=np.float32)
    ph = (np.float32(2.0 * np.pi) * u).astype(np.float32)
    cases = {"torch.sqrt": (torch.sqrt, jnp.sqrt, x),
             "sqrt_rn": (vec.sqrt_rn, jnp.sqrt, x),
             "log(u)": (torch.log, jnp.log, u),
             "cos(2 pi u)": (torch.cos, jnp.cos, ph),
             "sin(2 pi u)": (torch.sin, jnp.sin, ph)}
    out = {}
    for name, (tf, jf, a) in cases.items():
        t = tf(torch.from_numpy(a)).numpy().view(np.int32)
        j = np.asarray(jf(a)).view(np.int32)
        out[name] = float((t != j).mean())
    return out


def main() -> int:
    out = {"elementwise_disagreement": elementary_disagreement()}
    jq = jp = None
    rn = vec.sqrt_rn
    ports = []
    for label, fn in (("sqrt_rn", rn), ("torch.sqrt", torch.sqrt)):
        use_sqrt(fn)
        jq, img, q = queue_divergence(jq)
        jp, step, p = perlin_lanes(jp)
        out[label] = dict(next_week_final_queue_24x24=q,
                          two_perlin_spheres_pool_step=p)
        ports.append((img, step))
    use_sqrt(rn)
    # how far the repair moved the port's own results
    (ia, sa), (ib, sb) = ports
    out["port_changed"] = dict(
        queue_pixels=int((ia != ib).any(axis=-1).sum()),
        step_lanes=int((sa != sb).any(axis=0).sum()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
