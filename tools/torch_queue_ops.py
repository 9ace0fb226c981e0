"""Torch operations a work-queue iteration dispatches around its kernels.

    python tools/torch_queue_ops.py [--root DIR]

Renders cornell 16x12, 4 spp, depth 6 on the port's work queue on the CPU,
uniform and (where ``DIR``'s port takes it on the queue) sobol-b0, and
counts the aten operations that ``integrator.queue_body`` dispatches
outside the sweep (``SceneKernels.intersect``) and the step
(``pool_step``), each of which is its own kernel launch on the card.  On
the card every counted operation is one launch or less (a view launches
nothing), so the count bounds the host-launched work an iteration adds
around the kernels.  ``--root`` imports the port from another checkout
(a parent commit unpacked with ``git archive``), so two trees compare in
one run.  Prints one JSON line: per sampler, iterations, counted
operations and their mean per iteration, and the package directory that
was imported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


class _Count:
    """Counts aten operations while ``on``."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if outer.on:
                    outer.n += 1
                return func(*args, **(kwargs or {}))

        self.mode, self.n, self.on = Mode(), 0, False


def run(sampler: str) -> dict:
    from tpu_ray_torch import integrator
    from tpu_ray_torch.core import rng
    from tpu_ray_torch.models.scenes import SCENES

    W, H = 16, 12
    cam = SCENES["cornell"].camera(W, H)
    if sampler != "uniform":
        cam = cam.replace(sampler=sampler)
    ps = SCENES["cornell"].build(seed=1024, earth=None)
    c = _Count()
    body, step = integrator.queue_body, integrator.pool_step
    isect = integrator.SceneKernels.intersect
    iters = [0]

    def off(fn):
        def wrapped(*a, **k):
            was, c.on = c.on, False
            try:
                return fn(*a, **k)
            finally:
                c.on = was
        return wrapped

    def counted_body(*a, **k):
        iters[0] += 1
        c.on = True
        try:
            return body(*a, **k)
        finally:
            c.on = False

    integrator.queue_body = counted_body
    integrator.pool_step = off(step)
    integrator.SceneKernels.intersect = off(isect)
    try:
        with c.mode:
            integrator.trace_queue(ps, cam, W, H, 4, 0,
                                   rng.fold_in(rng.prng_key(3), 7), 6, 256,
                                   cam_salt=3)
    finally:
        integrator.queue_body, integrator.pool_step = body, step
        integrator.SceneKernels.intersect = isect
    return dict(iterations=iters[0], ops=c.n,
                ops_per_iteration=c.n / max(iters[0], 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    out = {s: run(s) for s in ("uniform", "sobol-b0")}
    import tpu_ray_torch
    out["package"] = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
