"""Which prim the JAX package's BVH traversal names on an equal-t tie.

``chip_smoke.py`` (phase 3, ``check_bvh``) holds the port's BVH kernel to
the brute-force sweep and prints each ray where the two name different
prims at the same t as a ``bvh tie: {...}`` line, with the ray's seven
floats bit for bit.  This script runs such a ray, on the CPU, through:

- the JAX package's lockstep traversal, ``tpu_ray.ops.bvh.
  intersect_scene_bvh``, on its numpy-built tree (the tree the port builds,
  node for node);
- the JAX package's brute-force ``intersect_ti`` (engine ``xla``);
- the port's BVH twin (``ops/bvh.py::intersect_bvh_plain``) and its dense
  sweep's twin (``ops/sweep.py::sweep_plain``).

If the JAX traversal names the port's BVH prim, the tie is the
traversal's visit order, not a fault of the port.  Without a log, the
script searches the camera rays of a cornell pool built on the CPU by the
plain pool step (``--search``), which need not be the card's rays bit for
bit.  One JSON line per ray on stdout.

    python tools/torch_bvh_tie.py --log smoke.log   # chip_smoke.py's output
    python tools/torch_bvh_tie.py --search 500 500 64
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

SEED = 1024


def ties_from_log(path):
    with open(path) as f:
        for line in f:
            if line.startswith("bvh tie: "):
                yield json.loads(line[len("bvh tie: "):])


def search(width, height, spp):
    """Ties among a cornell pool's camera rays made on the CPU."""
    from tpu_ray_torch.core import rng
    from tpu_ray_torch.integrator import init_pool_state
    from tpu_ray_torch.models.scenes import SCENES
    from tpu_ray_torch.ops import bvh, shade, sweep
    from tpu_ray_torch.renderer import (pick_samples_per_wave, pixel_grid,
                                        slot_ids)

    spec = SCENES["cornell"]
    scene, cam = spec.build(seed=SEED), spec.camera(width, height)
    k_pool = pick_samples_per_wave(width, height, spp, 1 << 20)
    cfg = shade.StepConfig.create(scene, cam, width, height, 50,
                                  n_samples=spp // k_pool, cam_salt=SEED)
    st = init_pool_state(pixel_grid(width, height, k_pool),
                         slot_ids(width, height, k_pool))
    R = st.slot.shape[0]
    st.fstate, st.istate = shade.pool_step(
        cfg, st.xy, st.slot, st.fstate, st.istate,
        torch.empty(R), torch.zeros(R, dtype=torch.int32), (0, 0), init=True)
    ki = rng.pool_key_tables(rng.fold_in(rng.prng_key(SEED), 0), 1)[0][0]
    rays = st.fstate[:7]
    geo = sweep.sweep_table(scene)
    ft, fi = sweep.sweep_plain(rays, geo, sweep._ranges(scene), scene.t_min)
    tables = bvh.BVHTables.create(scene)
    bt, bi = bvh.intersect_bvh_plain(scene, tables, rays, ki, st.slot)
    for lane in ((bi != fi) & (bt == ft)).nonzero().flatten().tolist():
        yield dict(scene="cornell", iters=0, lane=lane,
                   slot=int(st.slot[lane]), key=[int(k) for k in ki],
                   ray=[float(v).hex() for v in rays[:, lane].tolist()],
                   t=float(bt[lane]).hex(), sweep_prim=int(fi[lane]),
                   bvh_prim=int(bi[lane]))


def verdict(tie):
    from tpu_ray.models.scenes import SCENES as JSCENES
    from tpu_ray.ops.bvh import build_bvh as jbuild_bvh
    from tpu_ray.ops.bvh import intersect_scene_bvh
    from tpu_ray.ops.intersect import intersect_ti as jintersect_ti
    from tpu_ray_torch.models.scenes import SCENES
    from tpu_ray_torch.ops import bvh, sweep

    if tie["scene"] != "cornell":
        raise SystemExit(f"only cornell ties are handled, not {tie['scene']}")
    ray = np.array([float.fromhex(v) for v in tie["ray"]], np.float32)
    js = JSCENES["cornell"].build(seed=SEED)
    key = jnp.asarray(np.array(tie["key"], np.uint32))
    ro, rd, rt = (jnp.asarray(ray[None, 0:3]), jnp.asarray(ray[None, 3:6]),
                  jnp.asarray(ray[6:7]))
    lane = jnp.asarray(np.array([tie["slot"]], np.uint32))
    rec = intersect_scene_bvh(js, jbuild_bvh(js, use_native=False), ro, rd,
                              rt, key, lane_ids=lane)
    jt, ji = jintersect_ti(js, ro, rd, rt, key, engine="xla", lane_ids=lane)
    ps = SCENES["cornell"].build(seed=SEED)
    rays = torch.from_numpy(ray[:, None].copy())
    lanes = torch.tensor([tie["slot"]], dtype=torch.int32)
    kd = np.array(tie["key"], np.uint32)
    pt, pi = bvh.intersect_bvh_plain(ps, bvh.BVHTables.create(ps), rays, kd,
                                     lanes)
    st, si = sweep.sweep_plain(rays, sweep.sweep_table(ps),
                               sweep._ranges(ps), ps.t_min)
    out = dict(lane=tie["lane"], tie_t=tie["t"],
               tie_bvh_prim=tie["bvh_prim"],
               tie_sweep_prim=tie["sweep_prim"],
               jax_bvh_prim=int(rec.prim[0]), jax_bvh_t=float(rec.t[0]).hex(),
               jax_sweep_prim=int(np.asarray(ji)[0]),
               jax_sweep_t=float(np.asarray(jt)[0]).hex(),
               port_bvh_prim=int(pi[0]), port_bvh_t=float(pt[0]).hex(),
               port_sweep_prim=int(si[0]), port_sweep_t=float(st[0]).hex())
    out["jax_bvh_names_the_port_bvh_prim"] = (out["jax_bvh_prim"]
                                              == tie["bvh_prim"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log", help="a chip_smoke.py output with 'bvh tie:' "
                                 "lines")
    p.add_argument("--search", nargs=3, type=int, metavar=("W", "H", "SPP"),
                   help="search a cornell pool's camera rays on the CPU")
    args = p.parse_args(argv)
    if bool(args.log) == bool(args.search):
        p.error("give one of --log and --search")
    ties = list(ties_from_log(args.log) if args.log
                else search(*args.search))
    print(f"{len(ties)} tie rays", file=sys.stderr)
    ok = True
    for tie in ties:
        v = verdict(tie)
        ok &= v["jax_bvh_names_the_port_bvh_prim"]
        print(json.dumps(v))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
