"""The compacted sweep with and without its front-to-back cull, on the card.

``tpu_ray_torch/csrc/sweep_compact.cu`` skips a listed block when no live
ray of the tile can reach it before its best hit so far (a vote of the
tile's threads).  This study builds a second copy of that source whose vote
always passes (the one line of the vote replaced; nothing in the package
can turn the cull off), sweeps the same sorted bounce-1 rays with both
through ``ops/sweep.py::sweep_compact`` (the copy's entry point stands in
for the kernel's while it runs), checks that their (t, i) are equal, and
times them in turns - with, without, without, with - each the mean of 20
launches replayed from a CUDA graph.

    python tools/torch_cull_study.py

on a machine with the card (next-week-final 1000x1000 at 1 spp and
book1-final 600x400 at 16 spp, seed 1024; about half a minute).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from tpu_ray_torch.ops import build, sweep as sw  # noqa: E402

VOTE = "if (__syncthreads_or(want)) {"
ENTRY = ("sweep_compact", "tr_sweep_tiles")


def build_without_cull():
    """The compacted sweep's entry point, from a copy of its source whose
    cull vote is always true, with the argument types of the kernel's."""
    src = open(os.path.join(build.CSRC, "sweep_compact.cu")).read()
    if src.count(VOTE) != 1:
        raise RuntimeError("the cull's vote is not where the study expects it")
    d = build.build_dir()
    path = os.path.join(d, "sweep_compact_nocull.cu")
    with open(path, "w") as f:
        f.write(src.replace(VOTE, "if (__syncthreads_or(1)) {"))
    so = os.path.join(d, "libsweep_compact_nocull.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
                    "-o", so, path], check=True, capture_output=True)
    fn = ctypes.CDLL(so).tr_sweep_tiles
    fn.argtypes = build._fns[ENTRY].argtypes
    fn.restype = ctypes.c_int
    return fn


def bounce_rays(name: str, width: int, height: int, spp: int,
                seed: int = 1024):
    """A full-width pool of ``name`` on the card after one bounce: (scene,
    prim table, (7, R) rays)."""
    from tpu_ray_torch.core import rng
    from tpu_ray_torch.integrator import SceneKernels, init_pool_state
    from tpu_ray_torch.models.scenes import SCENES
    from tpu_ray_torch.ops import shade
    from tpu_ray_torch.ops.intersect import intersect_ti
    from tpu_ray_torch.renderer import pick_samples_per_wave, pixel_grid, \
        slot_ids

    dev = torch.device("cuda")
    spec = SCENES[name]
    scene = spec.build(seed=seed, earth=None).to(dev)
    k = pick_samples_per_wave(width, height, spp, 1 << 20)
    cfg = shade.StepConfig.create(scene, spec.camera(width, height), width,
                                  height, 50, n_samples=spp // k,
                                  cam_salt=seed)
    kern = SceneKernels.create(scene, False)
    st = init_pool_state(pixel_grid(width, height, k, dev),
                         slot_ids(width, height, k, dev))
    R = st.slot.shape[0]
    st.fstate, st.istate = shade.pool_step(
        cfg, st.xy, st.slot, st.fstate, st.istate,
        torch.empty(R, device=dev), torch.zeros(R, dtype=torch.int32,
                                                device=dev), (0, 0),
        init=True)
    ki, ks = rng.pool_key_tables(rng.fold_in(rng.prng_key(seed), 0), 2)
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
        raise SystemExit("torch_cull_study: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}")
    nocull = None
    for name, w, h, spp in (("next-week-final", 1000, 1000, 1),
                            ("book1-final", 600, 400, 16)):
        scene, geo, rays = bounce_rays(name, w, h, spp)
        blocks = sw.sweep_blocks(scene)
        perm = torch.sort(sw.sort_key(blocks, rays), stable=True).indices
        srays = rays[:, perm].contiguous()
        cnt, lst, order = sw.tile_lists(srays, blocks.blo, blocks.bhi,
                                        scene.t_min)
        R = rays.shape[1]
        rpt = sw.pick_rpt_compact(R, sw.sm_count(rays.device))
        stats = torch.zeros(2, dtype=torch.int64, device=rays.device)
        with_cull = lambda s=None: sw.sweep_compact(
            srays, geo, blocks, cnt, lst, order, scene.t_min, perm, rpt=rpt,
            stats=s)
        a = with_cull(stats)
        if nocull is None:
            nocull = build_without_cull()
        kernel = build._fns[ENTRY]

        def without_cull():
            build._fns[ENTRY] = nocull
            try:
                return with_cull()
            finally:
                build._fns[ENTRY] = kernel

        b = without_cull()
        torch.cuda.synchronize()
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        listed, skipped = stats.tolist()
        times = [graph_ms(f) for f in (with_cull, without_cull,
                                       without_cull, with_cull)]
        print(f"{name} R={R}, {rpt} rays/thread: cull skipped {skipped} of "
              f"{listed} listed (tile, block) pairs ({skipped / listed:.4f}); "
              f"results equal {same}; ms with / without / without / with: "
              + ", ".join(f"{t:.4f}" for t in times))
        if not same:
            raise AssertionError(f"the cull changed a result on {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
