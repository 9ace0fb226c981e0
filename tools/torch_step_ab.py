"""Time the default (uniform, fixed) path of the step, ``hit_scatter`` and
the megakernel of one checkout of the port, on the card, and digest their
outputs.

    python tools/torch_step_ab.py [TREE]

``TREE`` (default: this checkout) is the root of a checkout whose
``tpu_ray_torch`` is imported and built.  Run it on the parent commit's tree
and on this one in turns - parent, change, change, parent - in one call:
equal digests show that the two give the same bits, and the times compare
the kernels on one card.  Inputs are ``chip_smoke.py``'s: cornell at
500x500, 64 spp, seed 1024 (a 1M-lane pool), three iterations in for the
step and ``hit_scatter`` (20 launches replayed from a CUDA graph, three
readings each), and the first full-depth wave of the pool with the
megakernel (CUDA events around one launch after a warm-up, three
readings).  Prints one JSON line with the card and its power limit, and
ptxas's register and spill lines of the libraries it built.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, TREE)

import torch  # noqa: E402

from tpu_ray_torch.core import rng  # noqa: E402
from tpu_ray_torch.integrator import SceneKernels, init_pool_state  # noqa: E402
from tpu_ray_torch.models.scenes import SCENES  # noqa: E402
from tpu_ray_torch.ops import build, hit_scatter, megakernel, shade  # noqa: E402
from tpu_ray_torch.renderer import (pick_samples_per_wave,  # noqa: E402
                                    pixel_grid, plan_pool, slot_ids)

SEED = 1024
W = H = 500
SPP = 64


def graph_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of ``fn``, ``reps`` calls replayed from a CUDA
    graph after a warm-up call and a warm-up replay."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_ab: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    spec = SCENES["cornell"]
    scene = spec.build(seed=SEED, earth=None).to(dev)
    k = pick_samples_per_wave(W, H, SPP, 1 << 20)
    cfg = shade.StepConfig.create(scene, spec.camera(W, H), W, H, 50,
                                  n_samples=SPP // k, cam_salt=SEED)
    kern = SceneKernels.create(scene, False)
    st = init_pool_state(pixel_grid(W, H, k, dev), slot_ids(W, H, k, dev))
    R = st.slot.shape[0]
    st.fstate, st.istate = shade.pool_step(
        cfg, st.xy, st.slot, st.fstate, st.istate,
        torch.empty(R, device=dev), torch.zeros(R, dtype=torch.int32,
                                                device=dev), (0, 0),
        init=True)
    ki, ks = rng.pool_key_tables(rng.fold_in(rng.prng_key(SEED), 0), 4)
    for it in range(3):
        bt, bi = kern.intersect(scene, st.fstate[:7], ki[it], st.slot)
        st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot,
                                               st.fstate, st.istate, bt, bi,
                                               ks[it])
    rays = st.fstate[:7].contiguous()
    bt, bi = kern.intersect(scene, rays, ki[3], st.slot)
    args = (cfg, st.xy, st.slot, st.fstate, st.istate, bt, bi, ks[3])
    f, i = shade.pool_step(*args)
    rec, sc = hit_scatter.hit_scatter(cfg, rays, bt, bi, ks[3], st.slot)
    k_pool, s_wave = plan_pool(scene, W, H, SPP)[:2]
    wave_cfg = shade.StepConfig.create(scene, spec.camera(W, H), W, H, 50,
                                       n_samples=s_wave, cam_salt=SEED)
    wave = (scene, wave_cfg, pixel_grid(W, H, k_pool, dev),
            slot_ids(W, H, k_pool, dev), rng.fold_in(rng.prng_key(SEED), 0),
            kern)
    acc, ns = megakernel.trace_pool_mega(*wave)
    torch.cuda.synchronize()
    digest = hashlib.sha1()
    for t in (f, i, rec.point, rec.normal, sc.direction, sc.weight,
              sc.emitted, acc, ns):
        digest.update(t.contiguous().cpu().numpy().tobytes())
    out = dict(
        device=smi, tree=TREE, lanes=R,
        step_ms=[graph_ms(lambda: shade.pool_step(*args)) for _ in range(3)],
        hit_scatter_ms=[graph_ms(lambda: hit_scatter.hit_scatter(
            cfg, rays, bt, bi, ks[3], st.slot)) for _ in range(3)],
        mega_wave_ms=[event_ms(lambda: megakernel.trace_pool_mega(*wave))
                      for _ in range(3)],
        digest=digest.hexdigest(),
        # ptxas's register and spill lines where this process built them
        ptxas={n: [ln.split("info    :")[-1].strip() for ln in t.splitlines()
                   if "registers" in ln or "spill" in ln]
               for n, t in build.build_log.items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
