"""Command-line renderer: ``python -m tpu_ray_torch``.

The flags of the JAX CLI (``--scene``, ``--width``, ``--height``,
``--spp``, ``--max-depth``, ``--seed``, ``--out``, ``--earthmap``,
``--rays-per-wave``, ``--samples-per-wave``, ``--list-scenes``,
``--rr-depth``, ``--mode``, ``--engine``, ``--estimator``, ``--sampler``,
``--adaptive``, ``--aov``, ``--denoise``, ``--denoise-radius``, ``--bvh``,
``--checkpoint``, ``--checkpoint-every``, ``--progressive``,
``--profile``, ``--serve``, ``--supervise``, ``--time``) with the same
defaults, choices, checks and file names, plus ``--device``: the card by
default, ``cpu`` for the plain PyTorch versions.  ``--devices N`` renders
on a mesh of the first N cards (N ``cpu`` entries with ``--device cpu``;
fewer cards than N exit with code 2).
The image goes to ``--out`` (.png/.ppm tone-mapped, .pfm/.hdr linear) or
as a P3 PPM to stdout; progress and "Done." go to stderr.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-ray-torch",
        description="wavefront path tracer (RTIOW trilogy scenes), "
                    "PyTorch + CUDA")
    p.add_argument("--scene", default="cornell",
                   help="scene name (see --list-scenes)")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--spp", type=int, default=1000, help="samples per pixel")
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--out", default="-",
                   help="output path: .png/.ppm tone-mapped, .pfm/.hdr "
                        "linear radiance; '-' = PPM on stdout")
    p.add_argument("--earthmap", default=None,
                   help="path to the earth texture image")
    p.add_argument("--rays-per-wave", type=int, default=1 << 20)
    p.add_argument("--samples-per-wave", type=int, default=64,
                   help="most samples per slot per wave of the pool")
    p.add_argument("--estimator", default="fixed",
                   choices=("fixed", "reference"),
                   help="'reference' reproduces the reference's estimator "
                        "quirks (the unhittable-light mixture in scenes "
                        "without lights, cos/pi isotropic weighting, table "
                        "Perlin noise) instead of the documented fixes")
    p.add_argument("--sampler", default="uniform",
                   choices=("uniform", "sobol", "sobol-b0"),
                   help="camera sample generator: 'uniform' is the "
                        "reference's per-sample jitter; 'sobol' a scrambled "
                        "Sobol' point per (pixel, sample); 'sobol-b0' "
                        "extends it to the first bounce's light and cosine "
                        "scatter draws on the work queue (the pool and the "
                        "megakernel keep hashed scatter draws and say so); "
                        "pool and queue modes")
    p.add_argument("--rr-depth", type=int, default=0, metavar="N",
                   help="Russian-roulette path termination after N bounces "
                        "(0 = off)")
    p.add_argument("--adaptive", type=float, default=0.0, metavar="TOL",
                   help="per-pixel adaptive sampling: stop each pixel once "
                        "the standard error of its tone-mapped value is "
                        "below TOL (try 0.01); --spp becomes the per-pixel "
                        "budget cap.  A different quality contract than the "
                        "reference's fixed spp (tpu_ray_torch/adaptive.py); "
                        "with --devices, each round's worklist shards over "
                        "the mesh")
    p.add_argument("--mode", default="auto",
                   choices=("auto", "pool", "queue", "wave"),
                   help="integrator: persistent work queue, ray pool with "
                        "regeneration, or plain one-sample wavefront; auto = "
                        "queue for scenes over 512 prims, else pool")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "xla", "mxu", "pallas", "mega"),
                   help="auto / xla / pallas: the wavefront kernels; mega: "
                        "one whole-wave megakernel launch per pool wave "
                        "(scenes of at most 512 prims without image "
                        "textures); mxu: the static spheres through the "
                        "matrix-product (tensor-core) sweep")
    p.add_argument("--aov", default=None, metavar="LIST",
                   help="render first-hit feature buffers instead of the "
                        "beauty pass: comma list from albedo,normal,depth,"
                        "coverage, or 'all' (tpu_ray_torch/aov.py).  Each "
                        "buffer is written to <out stem>.<name>.png; with "
                        "--out *.pfm, raw float buffers (signed normals, "
                        "+inf depth misses) instead.  Requires --out.  Use "
                        "a small --spp (e.g. 16)")
    p.add_argument("--denoise", action="store_true",
                   help="cross-bilateral denoise of the beauty pass guided "
                        "by the first-hit AOVs (tpu_ray_torch/denoise.py; "
                        "biased like every practical denoiser, so never the "
                        "default).  Renders the albedo/normal/depth guides "
                        "at <=16 spp on top of the beauty pass")
    p.add_argument("--denoise-radius", type=int, default=3, metavar="R",
                   help="denoiser window radius (window is (2R+1)^2)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard sample waves over N devices (0 = single "
                        "device)")
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the accumulator every N waves")
    p.add_argument("--bvh", action="store_true",
                   help="intersect via BVH traversal instead of brute force")
    p.add_argument("--progressive", action="store_true",
                   help="emit output as it renders: with --out -, the PPM "
                        "streams its rows as they are final (as each row "
                        "band finishes; unbanded renders at the end); with "
                        "--out PATH, PATH is rewritten atomically with the "
                        "current estimate after every wave, chunk or band")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render to "
                        "DIR/trace.json")
    p.add_argument("--serve", action="store_true",
                   help="run as a long-lived render server: JSONL requests "
                        "on stdin, responses on stdout (utils/server.py); "
                        "renders after the first reuse the built kernels "
                        "and scenes")
    p.add_argument("--supervise", type=int, default=0, metavar="N",
                   help="run the render in a child process and retry up to "
                        "N times if it crashes; long renders auto-checkpoint, "
                        "so each retry resumes mid-render")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda runs the CUDA kernels; cpu their plain "
                        "PyTorch versions")
    p.add_argument("--time", action="store_true",
                   help="print the render wall time to stderr")
    return p


def _supervised(args, argv) -> int:
    """Re-run the same render in child processes (``python -m
    tpu_ray_torch`` without ``--supervise``) until one succeeds.

    A crashed child leaves its checkpoint behind (the auto checkpoint, keyed
    by the render's configuration, or ``--checkpoint``), so the next
    identical attempt resumes instead of restarting.  A child writes its
    image only after a successful render, so a crash emits nothing."""
    import subprocess

    out = []
    skip = False
    for a in (argv if argv is not None else sys.argv[1:]):
        if skip:
            skip = False
        elif a == "--supervise":
            skip = True
        elif not a.startswith("--supervise="):
            out.append(a)
    for attempt in range(args.supervise + 1):
        if attempt:
            print(f"[supervise] retry {attempt}/{args.supervise} "
                  "(resuming from auto checkpoint if one was written)",
                  file=sys.stderr)
        rc = subprocess.call([sys.executable, "-m", "tpu_ray_torch"] + out)
        if rc == 0:
            return 0
    print(f"[supervise] giving up after {args.supervise + 1} attempts",
          file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.supervise > 0 and not args.list_scenes:
        return _supervised(args, argv)
    if args.serve:
        from .server import serve

        return serve(device=args.device)

    from ..core import film
    from ..models.scenes import SCENES
    from ..renderer import render

    if args.list_scenes:
        for name, spec in SCENES.items():
            print(f"{name:20s} {spec.description}")
        return 0
    if args.scene not in SCENES:
        print(f"unknown scene {args.scene!r}; try --list-scenes",
              file=sys.stderr)
        return 2
    if args.spp < 1 or args.width < 1 or args.height < 1 or args.max_depth < 0:
        print("--spp/--width/--height must be >= 1 and --max-depth >= 0",
              file=sys.stderr)
        return 2

    from .assets import load_earth_image

    spec = SCENES[args.scene]
    scene = spec.build(seed=args.seed, earth=load_earth_image(args.earthmap))
    if args.estimator == "reference":
        scene = scene.replace(strict=True)
    camera = spec.camera(args.width, args.height)
    if args.sampler != "uniform":
        camera = camera.replace(sampler=args.sampler)
    # the AOV passes' engine argument, as the JAX CLI coerces it
    aov_engine = args.engine if args.engine in ("xla", "pallas") else "xla"
    if args.aov:
        return _write_aovs(args, scene, camera, aov_engine)
    mesh = None
    if args.devices:
        from ..parallel.mesh import make_mesh

        try:
            mesh = make_mesh(args.devices, args.device)
        except (RuntimeError, ValueError) as e:
            print(f"--devices: {e}", file=sys.stderr)
            return 2

    from .profiling import profile_trace

    prog = None
    if args.progressive:
        if args.adaptive:
            print("[progressive] ignoring --progressive: adaptive renders "
                  "have no fixed wave schedule", file=sys.stderr)
        else:
            prog = film.ProgressiveOutput(args.out, args.width, args.height)
    t_start = time.perf_counter()
    with profile_trace(args.profile):
        img = render(scene, camera, args.width, args.height, args.spp,
                     max_depth=args.max_depth, seed=args.seed,
                     rays_per_wave=args.rays_per_wave,
                     samples_per_wave=args.samples_per_wave,
                     rr_depth=args.rr_depth, device=args.device,
                     progress=True, mode=args.mode, engine=args.engine,
                     adaptive=args.adaptive, bvh=args.bvh, mesh=mesh,
                     checkpoint_path=args.checkpoint,
                     checkpoint_every=args.checkpoint_every,
                     on_partial=prog.update if prog else None)
    elapsed = time.perf_counter() - t_start
    if args.denoise:
        from ..aov import render_aovs
        from ..denoise import denoise

        aovs = render_aovs(scene, camera, args.width, args.height,
                           spp=min(args.spp, 16), seed=args.seed,
                           engine=aov_engine, device=args.device)
        img = denoise(img, aovs["albedo"], aovs["normal"], aovs["depth"],
                      radius=args.denoise_radius,
                      device=args.device).cpu().numpy()
        print("denoised (cross-bilateral, AOV-guided, "
              f"r={args.denoise_radius})", file=sys.stderr)
    if prog is not None:
        prog.finish(img)
    else:
        film.write_image(img, None if args.out == "-" else args.out)
    if args.time:
        print(f"render wall time: {elapsed:.3f}s", file=sys.stderr)
    print("Done.", file=sys.stderr)
    return 0


def _write_aovs(args, scene, camera, engine) -> int:
    """``--aov``: render the first-hit buffers and write one file per
    buffer (``tpu_ray/utils/cli.py``'s checks, messages and names)."""
    import numpy as np

    from ..aov import AOV_NAMES, aov_images, render_aovs
    from ..core import film

    names = AOV_NAMES if args.aov == "all" else tuple(
        n.strip() for n in args.aov.split(",") if n.strip())
    bad = [n for n in names if n not in AOV_NAMES]
    if bad:
        print(f"unknown AOV(s) {bad}; choose from {list(AOV_NAMES)}",
              file=sys.stderr)
        return 2
    if args.out == "-":
        print("--aov writes one PNG per buffer; pass --out PATH",
              file=sys.stderr)
        return 2
    ignored = [flag for flag, on in (
        ("--bvh", args.bvh),
        ("--checkpoint", args.checkpoint),
        ("--checkpoint-every", args.checkpoint_every),
        ("--adaptive", args.adaptive),
        ("--mode", args.mode != "auto"),
        ("--rr-depth", args.rr_depth),
    ) if on]
    if ignored:
        print(f"[aov] ignoring {', '.join(ignored)}: AOV passes are "
              "single-device first-hit sweeps (band-tiled under the "
              "beauty pass's lane caps)", file=sys.stderr)
    t_start = time.perf_counter()
    aovs = render_aovs(scene, camera, args.width, args.height, spp=args.spp,
                       seed=args.seed, engine=engine, device=args.device)
    stem = args.out
    if stem.lower().endswith(".pfm"):
        # raw float buffers: albedo linear, normal signed, depth with +inf
        # misses, coverage a fraction
        stem = stem[:-4]
        for n in names:
            a = np.asarray(aovs[n], np.float32)
            if a.ndim == 2:
                a = np.repeat(a[..., None], 3, axis=-1)
            film.write_pfm(a, f"{stem}.{n}.pfm")
            print(f"wrote {stem}.{n}.pfm", file=sys.stderr)
    else:
        imgs = aov_images(aovs)
        for suffix in (".png", ".ppm", ".hdr"):
            if stem.lower().endswith(suffix):
                stem = stem[: -len(suffix)]
        for n in names:
            rgb8 = (np.clip(imgs[n], 0.0, 1.0) * 255.999).astype(np.uint8)
            film.write_png(rgb8, f"{stem}.{n}.png")
            print(f"wrote {stem}.{n}.png", file=sys.stderr)
    if args.time:
        print(f"aov wall time: {time.perf_counter() - t_start:.3f}s",
              file=sys.stderr)
    print("Done.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
