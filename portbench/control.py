"""Readings that the limits of ``correct/<cell>.json`` are set from, at the
cell's own size, in one process:

    python3 portbench/control.py --workload nextweek.queue --seeds 1-12 \\
        --control-seeds 1-3

For each of ``--seeds``: request 0 of a run with that seed, rendered by
the program (``renderer.render`` on the card), its checked pixels against
the float32 reference: the lower readings.  For each of
``--control-seeds``: the reference computed in bfloat16 in the program's
place, against the float32 reference: the control's readings, which the
limits must refuse.  One JSON line a reading, then the largest program
reading and the smallest control reading of each number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seed-base", type=int, default=0,
                   help="added to every seed (large seeds: 2**31)")
    a = p.parse_args(argv)
    import numpy as np
    import torch
    from portbench import check, spec
    from portbench.traffic import request
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    from tpu_ray_torch.models.scenes import SCENES
    from tpu_ray_torch.ops import build
    from tpu_ray_torch.renderer import render
    build.build_all()
    cell = spec.load_cell(a.workload)
    conf, mix = cell.config, cell.traffic
    W, H = int(conf["width"]), int(conf["height"])
    sc_spec = SCENES[conf["scene"]]
    n_pix = int(cell.correct["pixels"])
    worst, least = {}, {}
    for kind, seeds in (("program", _seeds(a.seeds) if a.seeds else []),
                        ("control", _seeds(a.control_seeds)
                         if a.control_seeds else [])):
        for s in seeds:
            seed = s + a.seed_base
            req = request(mix, seed, 0)
            pix = check.pixel_sample(seed, W * H, n_pix)
            t0 = time.perf_counter()
            if kind == "program":
                img = render(sc_spec.build(seed=req.scene_seed, earth=None),
                             sc_spec.camera(W, H), W, H, req.spp,
                             max_depth=int(conf["max_depth"]),
                             seed=req.sample_seed, engine=req.engine,
                             device="cuda")
                got = np.asarray(img, np.float32).reshape(-1, 3)[pix]
            else:
                got = check.reference_pixels(conf, req, pix, "cuda",
                                             torch.bfloat16)
            ref = check.reference_pixels(conf, req, pix, "cuda")
            nums = check.compare(got, ref)
            agg = worst if kind == "program" else least
            pick = max if kind == "program" else min
            for k, v in nums.items():
                agg[k] = pick(agg.get(k, v), v)
            print(json.dumps(dict(kind=kind, workload=a.workload, seed=seed,
                                  seconds=time.perf_counter() - t0, **nums)))
            sys.stdout.flush()
    print(json.dumps(dict(workload=a.workload, device=torch.cuda.
                          get_device_name(0), program_max=worst,
                          control_min=least)))
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
