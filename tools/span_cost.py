"""What the renderer's spans cost, with a profiler running and without.

    python3 tools/span_cost.py --scene next-week-final --width 400 \\
        --height 400 --spp 100 --rounds 4 --renders 8

on a machine with a CUDA card.  First a micro-timing of one
``with span(...)`` block (``tpu_ray_torch/utils/profiling.py``): no
profiler, then under ``torch.profiler`` (CPU and CUDA activities).  Then,
in one process so that the host's speed is the same for all three, rounds
of ``--renders`` renders in each of three modes, their order rotated each
round: untraced; traced with the spans; traced with the spans switched off
(the profiler's flag test patched to read false).  Each mode's median
render wall, and for the traced modes the device's idle share (1 - the
operations' device time / the renders' wall).  The last line is the same
as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from tpu_ray_torch.models.scenes import SCENES  # noqa: E402
from tpu_ray_torch.ops import build  # noqa: E402
from tpu_ray_torch.renderer import render  # noqa: E402
from tpu_ray_torch.utils import profiling  # noqa: E402

ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]


def span_ns(n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        with profiling.span("queue.iteration"):
            pass
    return (time.perf_counter() - t) / n * 1e9


def device_s(prof) -> float:
    """Device seconds of every operation the profiler saw."""
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us += float(getattr(e, "self_device_time_total", 0.0))
    return us / 1e6


def block(mode: str, n: int, do) -> dict:
    """``n`` renders in ``mode``: their walls, and the device seconds."""
    enabled = profiling._enabled
    prof = None
    if mode != "untraced":
        if mode == "no_spans":
            profiling._enabled = lambda: False
        prof = torch.profiler.profile(activities=ACTS)
        prof.start()
    walls = []
    try:
        for _ in range(n):
            t = time.perf_counter()
            do()
            walls.append(time.perf_counter() - t)
    finally:
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
        profiling._enabled = enabled
    return dict(walls=walls, device_s=device_s(prof) if prof else None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 tools/span_cost.py")
    p.add_argument("--scene", default="next-week-final")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--spp", type=int, default=100)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--renders", type=int, default=8)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    spec = SCENES[a.scene]
    scene = spec.build(seed=1024, earth=None).to("cuda")
    cam = spec.camera(a.width, a.height)
    seed = [0]

    def do():
        seed[0] += 1
        render(scene, cam, a.width, a.height, a.spp, seed=seed[0])

    do()
    block("spans", 1, do)            # the profiler's first use
    micro = dict(off_ns=span_ns(200000))
    prof = torch.profiler.profile(activities=ACTS)
    prof.start()
    micro["on_ns"] = span_ns(20000)
    prof.stop()
    modes = ["untraced", "spans", "no_spans"]
    runs = {m: [] for m in modes}
    for r in range(a.rounds):
        for m in modes[r % 3:] + modes[:r % 3]:
            runs[m].append(block(m, a.renders, do))
    out = dict(device=torch.cuda.get_device_name(0), scene=a.scene,
               width=a.width, height=a.height, spp=a.spp, span=micro)
    for m, blocks in runs.items():
        walls = [w for b in blocks for w in b["walls"]]
        res = dict(median_wall_s=statistics.median(walls), renders=len(walls))
        if m != "untraced":
            res["idle_share"] = [1.0 - b["device_s"] / sum(b["walls"])
                                 for b in blocks]
        out[m] = res
        print(f"{m:>9}: median render {res['median_wall_s'] * 1e3:.3f} ms "
              f"over {len(walls)} renders"
              + (f", idle share by round "
                 f"{' '.join(f'{x:.4f}' for x in res['idle_share'])}"
                 if "idle_share" in res else ""))
    print(f"span: off {micro['off_ns']:.1f} ns, under a profiler "
          f"{micro['on_ns']:.1f} ns")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
