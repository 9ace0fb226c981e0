"""Where a render's time goes on the card.

    python -m tpu_ray_torch.utils.profile --scene cornell --width 500 \\
        --height 500 --spp 64 --max-depth 50
    python -m tpu_ray_torch.utils.profile --scene next-week-final \\
        --width 400 --height 400 --spp 100 --mode queue

    python -m tpu_ray_torch.utils.profile --scene cornell --engine mega

(``TPU_RAY_SORT=1`` in the environment profiles the sorted sweep, with
``TPU_RAY_CULL_STYLE=mask`` its mask-gated kernel; ``TPU_RAY_SWEEP_MXU=1``
the matrix-product sphere sweep.)

Builds the kernels, renders once to warm up, then renders again under
``torch.profiler`` (CPU + CUDA activities) and prints the wall time, the
device busy time summed over kernels, the device's idle share
(1 - busy / wall), each kernel's total time, launches and mean time, and
the wrappers' launch counts (kernel names cut to 80 characters; only the
``--top`` kernels by time are printed, all are summed), and the work
queue's path vertices, lane slots and their ratio (the share of the lane
slots dispatched that traced a ray; ``utils/profiling.py::counts`` holds
every counter).  With ``--engine mega`` it also prints the megakernel's
lane-iterations, warp-iterations and their ratio over 32 (the share of
lane slots that did work).  The last line is the same as one JSON object.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpu_ray_torch.utils.profile")
    p.add_argument("--scene", default="cornell")
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--mode", default="auto",
                   choices=("auto", "pool", "queue", "wave"))
    p.add_argument("--engine", default="auto",
                   choices=("auto", "xla", "pallas", "mega"))
    p.add_argument("--top", type=int, default=12,
                   help="kernels to print, by device time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1

    from ..models.scenes import SCENES
    from ..ops import build, megakernel, sweep
    from ..renderer import render
    from .profiling import LAUNCHES, counts

    build.build_all()
    spec = SCENES[args.scene]
    scene = spec.build(seed=args.seed, earth=None)
    cam = spec.camera(args.width, args.height)
    kw = dict(max_depth=args.max_depth, seed=args.seed, mode=args.mode,
              engine=args.engine)
    render(scene, cam, args.width, args.height, args.spp, **kw)   # warm-up
    before = counts()
    megakernel.read_stats("cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render(scene, cam, args.width, args.height, args.spp, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lane_iters, warp_iters = megakernel.read_stats("cuda")
    delta = {k: v - before[k] for k, v in counts().items()}
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e):
            us, n = kernels.get(e.key[:80], (0.0, 0))
            kernels[e.key[:80]] = (us + _device_us(e), n + e.count)
    busy = sum(us for us, _ in kernels.values()) / 1e6
    out = dict(scene=args.scene, width=args.width, height=args.height,
               spp=args.spp, max_depth=args.max_depth, mode=args.mode,
               engine=args.engine, sort=sweep.use_sort(),
               mega_lane_iters=lane_iters, mega_warp_iters=warp_iters,
               mega_lane_share=(lane_iters / (32.0 * warp_iters)
                                if warp_iters else None),
               device=torch.cuda.get_device_name(0), wall_s=wall,
               device_busy_s=busy,
               idle_share=(1.0 - busy / wall) if busy else None,
               launches={k: delta[k] for k in LAUNCHES},
               vertices=delta["vertices"], lane_slots=delta["lane_slots"],
               queue_lane_share=(delta["vertices"] / delta["lane_slots"]
                                 if delta["lane_slots"] else None),
               n_kernel_names=len(kernels),
               n_kernel_launches=sum(n for _, n in kernels.values()),
               kernels={k: dict(total_ms=us / 1e3, count=n,
                                mean_us=us / max(n, 1))
                        for k, (us, n) in sorted(
                            kernels.items(),
                            key=lambda kv: -kv[1][0])[:args.top]})
    print(f"{args.scene} {args.width}x{args.height} {args.spp} spp "
          f"mode={args.mode} engine={args.engine} sort={sweep.use_sort()}: "
          f"wall {wall:.4f} s (profiled), "
          f"device busy {busy:.4f} s, {out['n_kernel_launches']} launches")
    print("  launches: " + ", ".join(f"{k} {v}" for k, v in
                                     out["launches"].items() if v))
    if delta["lane_slots"]:
        print(f"  queue: {delta['vertices']} path vertices in "
              f"{delta['lane_slots']} lane slots, share "
              f"{out['queue_lane_share']:.4f}")
    for k, v in out["kernels"].items():
        print(f"  {v['total_ms']:10.3f} ms {v['count']:6d} x "
              f"{v['mean_us']:9.2f} us  {k}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
