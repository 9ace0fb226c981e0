"""Long-lived render server: JSONL requests on stdin, responses on stdout.

Port of ``tpu_ray/utils/server.py``.  A process pays once for its start:
importing torch, building the CUDA kernels with ``nvcc`` and building the
scenes.  ``python -m tpu_ray_torch --serve`` keeps one process resident, so
every render after the first reuses the loaded kernels and the scenes it
has already built, cached on the card.

Protocol (one JSON object per line), the JAX package's:

    request:  {"scene": "cornell", "width": 500, "height": 500, "spp": 1000,
               "out": "/tmp/c.png", "id": 7, ...}
    response: {"id": 7, "ok": true, "out": "/tmp/c.png", "wall_s": 3.8,
               "width": 500, "height": 500}

Any CLI render flag is accepted as a key (max_depth, seed, engine, mode,
sampler, estimator, rr_depth, adaptive, bvh, devices, rays_per_wave,
samples_per_wave, denoise, denoise_radius), with the CLI's defaults;
``devices`` N renders on a mesh of N devices of the server's kind (the
first N cards, or N ``cpu`` entries), with the scene cached on each.
``out`` is required (stdout is the response channel, so images
go to files).  Control requests: {"cmd": "ping"} -> liveness, {"cmd":
"warm", "scene": ...} -> render one sample per pool slot (the queue: the
full request) without writing an image, so the kernels are built and the
scene is cached; {"cmd": "stats"} -> cached scenes, request counters and
the built kernels; {"cmd": "quit"} -> clean exit.  Malformed or failing
requests answer {"ok": false, "error": ...} and never stop the server.
Progress and diagnostics stay on stderr.
"""
from __future__ import annotations

import json
import sys
import time

_RENDER_KEYS = (
    "spp", "max_depth", "seed", "rays_per_wave", "samples_per_wave",
    "engine", "mode", "rr_depth", "adaptive", "bvh",
)

_DEFAULTS = dict(
    width=500, height=500, spp=1000, max_depth=50, seed=1024,
    rays_per_wave=1 << 20, samples_per_wave=64, engine="auto", mode="auto",
    sampler="uniform", estimator="fixed", rr_depth=0, adaptive=0.0,
    bvh=False, devices=0, denoise=False, denoise_radius=3,
)


class RenderServer:
    """Caches built scenes by (name, seed, estimator, earthmap), on the
    render device (``device``: the card by default, ``"cpu"`` for the
    plain PyTorch versions), and their copies on the other devices of the
    meshes requests ask for."""

    def __init__(self, device=None):
        from ..renderer import resolve_device

        self.device = resolve_device(device)
        self._scenes = {}
        self._copies = {}    # (scene key, device) -> the scene there
        self._earth = {}
        self._renders = 0
        self._warms = 0

    def _get_scene(self, name, seed, estimator, earthmap):
        from ..models.scenes import SCENES
        from .assets import load_earth_image

        if name not in SCENES:
            raise ValueError(f"unknown scene {name!r}")
        key = (name, seed, estimator, earthmap)
        if key not in self._scenes:
            if earthmap not in self._earth:
                self._earth[earthmap] = load_earth_image(earthmap)
            scene = SCENES[name].build(seed=seed, earth=self._earth[earthmap])
            if estimator == "reference":
                scene = scene.replace(strict=True)
            self._scenes[key] = scene.to(self.device)
        return self._scenes[key]

    def _on_mesh(self, key, mesh) -> dict:
        """The cached scene ``key`` on every device of ``mesh``, each copy
        made once."""
        from ..parallel.mesh import distinct

        scene = self._scenes[key]
        out = {}
        for dev in distinct(mesh):
            if dev == scene.device:
                out[dev] = scene
            else:
                if (key, dev) not in self._copies:
                    self._copies[(key, dev)] = scene.to(dev)
                out[dev] = self._copies[(key, dev)]
        return out

    def handle(self, req: dict) -> dict:
        """One request -> one response dict (never raises)."""
        rid = req.get("id")
        try:
            resp = self._dispatch(req)
        except Exception as e:  # a bad request must not stop the server
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if rid is not None:
            resp["id"] = rid
        return resp

    def _dispatch(self, req: dict) -> dict:
        cmd = req.get("cmd", "render")
        if cmd == "ping":
            return {"ok": True, "pong": True}
        if cmd == "quit":
            return {"ok": True, "quit": True}
        if cmd == "stats":
            from ..ops import build

            return {"ok": True,
                    "cached_scenes": [list(k) for k in self._scenes],
                    "renders": self._renders, "warms": self._warms,
                    "kernels": {"loaded": build.loaded(),
                                "build_seconds": dict(build.build_seconds)}}
        if cmd not in ("render", "warm"):
            raise ValueError(f"unknown cmd {cmd!r}")

        cfg = dict(_DEFAULTS)
        unknown = set(req) - set(_DEFAULTS) - {
            "cmd", "id", "scene", "out", "earthmap"}
        if unknown:
            raise ValueError(f"unknown keys {sorted(unknown)}")
        cfg.update({k: req[k] for k in _DEFAULTS if k in req})
        if "scene" not in req:
            raise ValueError("missing 'scene'")
        out = req.get("out")
        if cmd == "render" and not out:
            raise ValueError("missing 'out' (images go to files; "
                             "stdout is the response channel)")
        from .. import renderer
        from ..core import film
        from ..models.scenes import SCENES
        from ..parallel.mesh import make_mesh

        mesh = (make_mesh(cfg["devices"], self.device.type)
                if cfg["devices"] else None)
        key = (req["scene"], cfg["seed"], cfg["estimator"],
               req.get("earthmap"))
        scene = self._get_scene(*key)
        camera = SCENES[req["scene"]].camera(cfg["width"], cfg["height"])
        if cfg["sampler"] != "uniform":
            camera = camera.replace(sampler=cfg["sampler"])

        kw = {k: cfg[k] for k in _RENDER_KEYS}
        if cmd == "warm":
            # one sample per pool slot: the same kernels, tables and plan
            # as the full render; the queue's warm is the full request
            engine = renderer.resolve_engine(scene, cfg["engine"])
            mode = renderer.resolve_mode(
                scene, cfg["mode"], engine, bvh=bool(cfg["bvh"]), mesh=mesh,
                spp=kw["spp"])
            if mode != "queue":
                kw["spp"] = renderer.plan_pool(
                    scene, cfg["width"], cfg["height"], kw["spp"],
                    cfg["rays_per_wave"], cfg["samples_per_wave"],
                    engine=engine)[0]
        t0 = time.perf_counter()
        img = renderer.render(
            scene if mesh is None else self._on_mesh(key, mesh), camera,
            cfg["width"], cfg["height"], device=self.device, mesh=mesh,
            progress=False, **kw)
        wall = time.perf_counter() - t0
        resp = {"ok": True, "wall_s": round(wall, 4),
                "width": cfg["width"], "height": cfg["height"]}
        if cmd == "warm":
            resp["warmed"] = True
            self._warms += 1
            return resp
        if cfg["denoise"]:
            # the CLI's --denoise composition: the first-hit AOV pass and
            # the AOV-guided cross-bilateral filter
            from ..aov import render_aovs
            from ..denoise import denoise

            aov_engine = (cfg["engine"] if cfg["engine"] in ("xla", "pallas")
                          else "xla")
            aovs = render_aovs(scene, camera, cfg["width"], cfg["height"],
                               spp=min(kw["spp"], 16), seed=cfg["seed"],
                               engine=aov_engine, device=self.device)
            img = denoise(img, aovs["albedo"], aovs["normal"], aovs["depth"],
                          radius=cfg["denoise_radius"],
                          device=self.device).cpu().numpy()
            resp["denoised"] = True
        film.write_image(img, out)
        resp["out"] = out
        self._renders += 1
        return resp


def serve(stdin=None, stdout=None, device=None) -> int:
    """Run the request loop until EOF or {"cmd": "quit"}."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    srv = RenderServer(device)
    print("[serve] ready (one JSON request per line; "
          '{"cmd": "quit"} exits)', file=sys.stderr)
    print(json.dumps({"ok": True, "ready": True}), file=stdout, flush=True)
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            print(json.dumps({"ok": False, "error": f"bad request: {e}"}),
                  file=stdout, flush=True)
            continue
        resp = srv.handle(req)
        print(json.dumps(resp), file=stdout, flush=True)
        if resp.get("quit"):
            return 0
    return 0
