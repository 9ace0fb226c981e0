"""Time the mask-gated sweep kernel of one checkout of the port, on the card.

    python tools/torch_masked_ab.py [TREE]

``TREE`` (default: this checkout) is the root of a checkout whose
``tpu_ray_torch`` is imported and built.  Run it on the parent commit's tree
and on this one in turns - parent, change, change, parent - in one call, so
that the two kernels are compared on one card.  The rays are
next-week-final's at 1000x1000, 1 spp, seed 1024, after one bounce (the 1M
bounce-1 rays of ``chip_smoke.py``'s masked check), sorted by the sort key;
the mask (and, where the checkout has it, the tile order) comes from the
list pass.  Prints one JSON line: the card and its power limit, the tree,
the kernel's mean ms per launch over 20 launches replayed from a CUDA graph
(three readings), and whether its (t, i) equal the dense sweep kernel's.
"""
from __future__ import annotations

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
from tpu_ray_torch.ops import shade, sweep as sw  # noqa: E402
from tpu_ray_torch.ops.intersect import intersect_ti  # noqa: E402
from tpu_ray_torch.renderer import (pick_samples_per_wave,  # noqa: E402
                                    pixel_grid, slot_ids)

SEED = 1024


def bounce_rays(name, width, height, spp):
    """A full-width pool of ``name`` on the card after one bounce."""
    dev = torch.device("cuda")
    spec = SCENES[name]
    scene = spec.build(seed=SEED, earth=None).to(dev)
    k = pick_samples_per_wave(width, height, spp, 1 << 20)
    cfg = shade.StepConfig.create(scene, spec.camera(width, height), width,
                                  height, 50, n_samples=spp // k,
                                  cam_salt=SEED)
    kern = SceneKernels.create(scene, False)
    st = init_pool_state(pixel_grid(width, height, k, dev),
                         slot_ids(width, height, k, dev))
    R = st.slot.shape[0]
    st.fstate, st.istate = shade.pool_step(
        cfg, st.xy, st.slot, st.fstate, st.istate,
        torch.empty(R, device=dev), torch.zeros(R, dtype=torch.int32,
                                                device=dev), (0, 0),
        init=True)
    ki, ks = rng.pool_key_tables(rng.fold_in(rng.prng_key(SEED), 0), 2)
    bt, bi = intersect_ti(scene, st.fstate[:7], ki[0], st.slot, kern.geo,
                          kern.media)
    st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot, st.fstate,
                                           st.istate, bt, bi, ks[0])
    return scene, kern.geo, st.fstate[:7].contiguous()


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_masked_ab: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    scene, geo, rays = bounce_rays("next-week-final", 1000, 1000, 1)
    blocks = sw.sweep_blocks(scene)
    perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
    srays = rays[:, perm].contiguous()
    box = (srays, blocks.blo, blocks.bhi, scene.t_min)
    if hasattr(sw, "tile_mask"):
        mask, order = sw.tile_mask(*box)
        run = lambda: sw.sweep_masked(srays, geo, blocks, mask, order,
                                      scene.t_min, perm)
    else:
        mask = sw.needed_mask(*box)
        run = lambda: sw.sweep_masked(srays, geo, blocks, mask, scene.t_min,
                                      perm)
    dt, di = sw.sweep(rays, geo, sw._ranges(scene), scene.t_min)
    mt, mi = run()
    same = bool(torch.equal(mt, dt) and torch.equal(mi, di))
    ms = [graph_ms(run) for _ in range(3)]
    print(json.dumps(dict(device=smi, tree=TREE, rays=rays.shape[1],
                          needed_share=float(mask.sum()) / mask.numel(),
                          masked_ms=ms, equal_to_dense=same)))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
