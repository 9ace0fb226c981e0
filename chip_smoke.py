"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives ``tpu_ray_torch``'s main path (the pool renderer through the
closest-hit sweep and fused pool-step CUDA kernels) at full width, and
fails unless every phase passes:

1. the card: its name, and ``nvidia-smi``'s name and power limit;
2. build both kernels from ``tpu_ray_torch/csrc`` (one ``nvcc`` each, in
   parallel) and print the build seconds and register use;
3. each kernel against its plain PyTorch version at main-path shapes
   (1M-lane pools), with kernel and plain times from CUDA events;
4. the six non-image golden configs rendered on the card, held to the
   cross-engine criterion against ``tests/goldens/<name>.npy``;
5. full width: cornell 500x500 depth 50 at 64 spp (a 1M-lane pool) and
   book1-final 600x400 depth 50 at 16 spp, with launch counts read from
   the kernels' wrappers (reset just before, read just after);
6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.  It imports
nothing of JAX.  Without a CUDA device, or outside the repository, it
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device")

from tpu_ray_torch.core import rng  # noqa: E402
from tpu_ray_torch.core.film import to_rgb8  # noqa: E402
from tpu_ray_torch.integrator import SceneKernels, init_pool_state  # noqa: E402
from tpu_ray_torch.models import objects as ob  # noqa: E402
from tpu_ray_torch.models.compile import build_scene  # noqa: E402
from tpu_ray_torch.models.scenes import SCENES  # noqa: E402
from tpu_ray_torch.ops import build, shade, sweep  # noqa: E402
from tpu_ray_torch.ops.intersect import intersect_ti  # noqa: E402
from tpu_ray_torch.renderer import (pixel_grid, plan_pool, render,  # noqa: E402
                                    slot_ids)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, fp32 outside tensor cores
SEED = 1024
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "goldens")
GOLDENS = {   # tests/test_golden.py CONFIGS: (spp, depth, width, height)
    "two-spheres": (16, 8, 32, 24),
    "cornell": (32, 12, 32, 24),
    "book1-final": (8, 8, 32, 24),
    "cornell-smoke": (16, 8, 24, 16),
    "simple-light": (16, 8, 24, 16),
    "two-perlin-spheres": (4, 4, 24, 16),
}
DEV = torch.device("cuda")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def box_grid():
    """The 20 x 20 grid of ground boxes of next-week-final (a scene of 400
    solid boxes under its camera): the sweep's box range at main-path
    widths, which no pool-path scene of the library has."""
    r = np.random.default_rng(SEED)
    ground = ob.Lambertian((0.48, 0.83, 0.53))
    boxes = [ob.Box((i * 100.0 - 1000.0, 0.0, j * 100.0 - 1000.0),
                    (i * 100.0 - 900.0, r.uniform(1.0, 101.0),
                     j * 100.0 - 900.0), ground)
             for i in range(20) for j in range(20)]
    return build_scene(boxes, background=(0.7, 0.8, 0.9), t_min=1e-2)


def pool_after(name: str, width: int, height: int, spp: int, iters: int):
    """A full-width pool of ``name`` advanced ``iters`` iterations through
    the kernels; returns what the next iteration's two kernels take."""
    if name == "box-grid":
        scene = box_grid().to(DEV)
        cam = SCENES["next-week-final"].camera(width, height)
    else:
        spec = SCENES[name]
        scene = spec.build(seed=SEED, earth=None).to(DEV)
        cam = spec.camera(width, height)
    k_pool, s_wave, _ = plan_pool(scene, width, height, spp)
    cfg = shade.StepConfig.create(scene, cam, width, height, 50,
                                  n_samples=s_wave, cam_salt=SEED)
    kern = SceneKernels.create(scene)
    st = init_pool_state(pixel_grid(width, height, k_pool, DEV),
                         slot_ids(width, height, k_pool, DEV))
    R = st.slot.shape[0]
    none_t = torch.empty(R, dtype=torch.float32, device=DEV)
    none_i = torch.zeros(R, dtype=torch.int32, device=DEV)
    st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot, st.fstate,
                                           st.istate, none_t, none_i, (0, 0),
                                           init=True)
    k_isect, k_scat = rng.pool_key_tables(
        rng.fold_in(rng.prng_key(SEED), 0), iters + 1)
    for it in range(iters):
        bt, bi = intersect_ti(scene, st.fstate[:7], k_isect[it], st.slot,
                              kern.geo, kern.media)
        st.fstate, st.istate = shade.pool_step(cfg, st.xy, st.slot,
                                               st.fstate, st.istate, bt, bi,
                                               k_scat[it])
    return scene, cfg, kern, st, k_isect[iters], k_scat[iters]


def sweep_flops(scene, R: int) -> float:
    n_mov = scene.n_sphere - scene.n_sphere_static
    n_quad = scene.n_solid - scene.n_sphere - scene.n_box
    per_ray = (scene.n_sphere_static * sweep.FLOPS_PER_PAIR["sphere"]
               + n_mov * sweep.FLOPS_PER_PAIR["moving"]
               + scene.n_box * sweep.FLOPS_PER_PAIR["box"]
               + n_quad * sweep.FLOPS_PER_PAIR["quad"])
    return float(R) * per_ray


def check_sweep(name, width, height, spp, iters):
    """Sweep kernel vs sweep_plain on one full-width pool's rays."""
    scene, _, kern, st, _, _ = pool_after(name, width, height, spp, iters)
    rays = st.fstate[:7]
    ranges = sweep._ranges(scene)
    bt, bi = sweep.sweep(rays, kern.geo, ranges, scene.t_min)
    pt, pi = sweep.sweep_plain(rays, kern.geo, ranges, scene.t_min)
    torch.cuda.synchronize()
    R = rays.shape[1]
    hit_k, hit_p = torch.isfinite(bt), torch.isfinite(pt)
    hit_mismatch = int((hit_k != hit_p).sum())
    both = hit_k & hit_p
    err = (bt[both] - pt[both]).abs()
    max_abs = float(err.max()) if int(both.sum()) else 0.0
    bad_t = int((err > 1e-5 + 2e-5 * pt[both].abs()).sum())
    idx_diff = both & (bi != pi)
    ties = int((idx_diff & (bt == pt)).sum())
    bad_i = int(idx_diff.sum()) - ties
    log(f"sweep {name} iters={iters} R={R}: hits {int(hit_k.sum())}, "
        f"hit mismatches {hit_mismatch}, t max abs err {max_abs:.3e}, "
        f"t out of tol {bad_t}, idx mismatches {bad_i} (+{ties} exact ties)")
    if hit_mismatch > 1e-5 * R or bad_t > 1e-5 * R or bad_i > 1e-5 * R:
        raise AssertionError(f"sweep kernel disagrees with plain on {name}")
    ms = cuda_ms(lambda: sweep.sweep(rays, kern.geo, ranges, scene.t_min), 20)
    plain_ms = cuda_ms(lambda: sweep.sweep_plain(rays, kern.geo, ranges,
                                                 scene.t_min), 3)
    nbytes = R * (7 * 4 + 8) + kern.geo.numel() * 4
    flops = sweep_flops(scene, R)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(f"sweep {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=max_abs)


STEP_TOL = {   # tests/test_shade_pallas.py:68-86
    "origin": (2e-4, 1e-3), "direction": (1e-3, 1e-4), "time": (2e-4, 1e-5),
    "throughput": (2e-4, 1e-5), "accum": (2e-4, 1e-5),
}
STEP_ROWS = {"origin": slice(0, 3), "direction": slice(3, 6),
             "time": slice(6, 7), "throughput": slice(7, 10),
             "accum": slice(10, 13)}


def check_step(name, width, height, spp, iters):
    """Pool-step kernel vs pool_step_plain on a full-width pool state."""
    scene, cfg, kern, st, ki, ks = pool_after(name, width, height, spp, iters)
    bt, bi = intersect_ti(scene, st.fstate[:7], ki, st.slot, kern.geo,
                          kern.media)
    args = (cfg, st.xy, st.slot, st.fstate, st.istate, bt, bi, ks)
    fk, ik = shade.pool_step(*args)
    fp, ip = shade.pool_step_plain(*args)
    torch.cuda.synchronize()
    R = st.slot.shape[0]
    disc_bad = (ik != ip).any(dim=0)
    n_disc = int(disc_bad.sum())
    ok = ~disc_bad
    worst = 0.0
    n_float = 0
    for key, rows in STEP_ROWS.items():
        rtol, atol = STEP_TOL[key]
        a, b = fk[rows][:, ok], fp[rows][:, ok]
        diff = (a - b).abs()
        n_float += int((diff > atol + rtol * b.abs()).any(dim=0).sum())
        worst = max(worst, float(diff.max()))
    log(f"step {name} iters={iters} R={R}: active "
        f"{int(st.istate[2].sum())}, discrete mismatches {n_disc}, float "
        f"lanes out of tol {n_float}, max abs err {worst:.3e}")
    if n_disc > 1e-4 * R or n_float > 1e-4 * R:
        raise AssertionError(f"pool-step kernel disagrees with plain on {name}")
    ms = cuda_ms(lambda: shade.pool_step(*args), 20)
    plain_ms = cuda_ms(lambda: shade.pool_step_plain(*args), 3)
    nbytes = R * shade.BYTES_PER_LANE + cfg.tab.numel() * 4
    ops = R * shade.OPS_PER_LANE
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(f"step {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=worst)


def check_golden(name):
    spp, depth, w, h = GOLDENS[name]
    spec = SCENES[name]
    img = render(spec.build(seed=SEED, earth=None), spec.camera(w, h), w, h,
                 spp=spp, max_depth=depth, seed=SEED)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    err = np.abs(img - golden) / (1.0 + np.abs(golden))
    close = (err < 1e-4).all(axis=-1)
    share = 1.0 - close.mean()
    bad = np.abs(img - golden)[close] > 1e-4 + 2e-4 * np.abs(golden)[close]
    log(f"golden {name}: divergent pixels {share:.4%}, close pixels out of "
        f"tol {int(bad.sum())}")
    if share > 0.02 or bad.any():
        raise AssertionError(f"golden {name} fails the cross-engine criterion")


def full_width(name, width, height, spp):
    spec = SCENES[name]
    scene = spec.build(seed=SEED, earth=None)
    cam = spec.camera(width, height)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(scene, cam, width, height, spp, max_depth=50, seed=SEED)
    wall = time.perf_counter() - t0
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{name}: bad image {img.shape}")
    bright = float(to_rgb8(img).mean())
    log(f"render {name} {width}x{height} {spp} spp depth 50: wall "
        f"{wall:.3f} s, {width * height * spp / wall:.4g} samples/s, mean "
        f"8-bit {bright:.2f}")
    return img, wall, bright


def main() -> int:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"phase 1: device {kind}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"phase 2: built {sorted(secs)} in {time.perf_counter() - t0:.2f} s")
    for n, txt in build.build_log.items():
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {n}: {line.strip()}")

    log("phase 3: kernels vs plain versions at main-path shapes")
    sw = check_sweep("cornell", 500, 500, 64, 0)
    check_sweep("cornell", 500, 500, 64, 1)
    check_sweep("book1-final", 600, 400, 16, 0)
    sw_book1 = check_sweep("book1-final", 600, 400, 16, 1)
    check_sweep("cornell-smoke", 500, 500, 64, 2)
    sw_box = check_sweep("box-grid", 1000, 1000, 1, 1)
    st = check_step("cornell", 500, 500, 64, 3)
    check_step("cornell-smoke", 500, 500, 64, 3)
    check_step("two-spheres", 500, 500, 64, 3)
    check_step("two-perlin-spheres", 500, 500, 64, 2)

    log("phase 4: goldens on the card")
    for name in GOLDENS:
        check_golden(name)

    log("phase 5: full-width renders through the kernels")
    sweep.sweep.launches = 0
    shade.pool_step.launches = 0
    sweep.sweep_plain.calls = 0
    shade.pool_step_plain.calls = 0
    _, _, bright = full_width("cornell", 500, 500, 64)
    log(f"  cornell launches: sweep {sweep.sweep.launches}, pool_step "
        f"{shade.pool_step.launches}")
    full_width("book1-final", 600, 400, 16)
    launches = {"sweep": sweep.sweep.launches,
                "pool_step": shade.pool_step.launches}
    plain = {"sweep": sweep.sweep_plain.calls,
             "pool_step": shade.pool_step_plain.calls}
    log(f"launches {launches}; plain-version calls {plain}")
    if min(launches.values()) <= 0 or max(plain.values()) != 0:
        raise AssertionError("the main path did not run through the kernels")
    if not 48.0 <= bright <= 80.0:
        raise AssertionError(f"cornell mean brightness {bright:.2f} is far "
                             "from the reference's 64/255")

    kernels = [
        dict(name="sweep", route="cuda", source="tpu_ray_torch/csrc/sweep.cu",
             replaces="tpu_ray/ops/intersect_pallas.py:59 (_sphere_kernel), "
                      ":309 (_box_kernel), :256 (_quad_kernel)",
             launches=launches["sweep"], library_ms=None, **sw),
        dict(name="pool_step", route="cuda",
             source="tpu_ray_torch/csrc/pool_step.cu",
             replaces="tpu_ray/ops/shade_pallas.py:401 (_step_kernel)",
             launches=launches["pool_step"], library_ms=None, **st),
    ]
    log(f"book1-final sweep (1 bounce): {json.dumps(sw_book1)}")
    log(f"box-grid sweep (1 bounce): {json.dumps(sw_box)}")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
