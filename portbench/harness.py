"""One run of one cell: set-up, the measured window, the traced stretch,
the check of the images, and the result line.

The window drives ``tpu_ray_torch.renderer.render``, the entry of the
CLI, the render server and library callers, in a closed loop of one
client: request ``i + 1`` is issued when request ``i``'s image is on the
host.  The window runs from the first request's issue to the end of the
last render issued within ``--seconds``.

* ``msamples_per_s``: W x H x spp of every render completed in the
  window, over the window, / 1e6;
* ``render_p95_s``: the 95th percentile (nearest rank) of every render's
  time from issue to image on the host;
* ``setup_s``: the process's start to the first timed request: imports,
  the CUDA context, the kernel libraries (built on a checkout's first run,
  loaded from ``tpu_ray_torch/_build/`` after), the scene and one warm-up
  request of the cell's own shape.

Python's collector is frozen and off over the window, so no collection
of the set-up's objects lands inside it.

With ``--trace 1`` a stretch of the window (from its third request, about
``TRACE_S`` seconds of whole requests) runs under ``torch.profiler``, and
the cell's per-layer metrics are read from it by ``metrics/<name>.py``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np

from . import check, spec, trace
from .traffic import request

BANNED = ("jax", "jaxlib", "flax", "tpu_ray")
TRACE_S = 3.0
TRACE_FROM = 2          # untraced requests at the window's start


def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started (``/proc/self/stat``), or since
    ``fallback_t0`` on the ``perf_counter`` clock where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - fallback_t0


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of ``BANNED``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(BANNED))


def p95(values) -> float:
    """95th percentile by nearest rank."""
    v = sorted(values)
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])


def power_limit_w():
    """The card's power limit in watts (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclass
class RunData:
    """What the per-layer readers see (``metrics/<name>.py``'s ``read``)."""

    trace: trace.Trace | None = None


class BannedModule(RuntimeError):
    pass


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        render=None, t_start: float | None = None) -> tuple:
    """Run ``cell``; returns (result dict, compared numbers with limits).
    ``render`` replaces ``tpu_ray_torch.renderer.render`` (the tests plant
    faults through it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from tpu_ray_torch import renderer
    from tpu_ray_torch.models.scenes import SCENES
    from tpu_ray_torch.ops import build

    render = render or renderer.render
    conf, mix = cell.config, cell.traffic
    W, H, depth = int(conf["width"]), int(conf["height"]), int(
        conf["max_depth"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    scene_spec = SCENES[conf["scene"]]
    cam = scene_spec.camera(W, H)
    if cuda:
        build.build_all()
    renderer.clear_auto_checkpoints()
    data = RunData()
    annotate = contextlib.nullcontext

    req0 = request(mix, seed, 0)
    scene = scene_spec.build(seed=req0.scene_seed, earth=None).to(dev)

    def one(req):
        with annotate("portbench.request"), annotate("portbench.render"):
            return render(scene, cam, W, H, req.spp, max_depth=depth,
                          seed=req.sample_seed, engine=req.engine,
                          device=dev)

    one(request(mix, seed, -1))
    if traced:     # the profiler's first use initialises its tracer
        warm = _start_profile(torch, cuda)
        one(request(mix, seed, -2))
        _stop_profile(*warm, parse=False)
    pix = check.pixel_sample(seed, W * H, int(cell.correct["pixels"]))
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = process_age_s(t_start)

    prof, tmp = None, None
    lat, kept, done, failed, first_error = [], [], [], 0, None
    gc.collect()
    gc.freeze()
    gc.disable()
    t_w0 = time.perf_counter()
    t_end = t_w0
    i = 0
    while True:
        t_issue = time.perf_counter()
        over = t_issue - t_w0 >= seconds
        if prof is not None and (over or t_issue - t_trace >= TRACE_S):
            data.trace = _stop_profile(prof, tmp)
            prof, annotate = None, contextlib.nullcontext
            t_issue = time.perf_counter()
            over = t_issue - t_w0 >= seconds
        if over:
            break
        if traced and i == TRACE_FROM:
            prof, tmp = _start_profile(torch, cuda)
            annotate = torch.profiler.record_function
            t_trace = t_issue
        req = request(mix, seed, i)
        try:
            img = one(req)
        except Exception:           # a failed request: counted, reported
            failed += 1
            first_error = first_error or traceback.format_exc()
        else:
            t_end = time.perf_counter()
            lat.append(t_end - t_issue)
            done.append(req)
            kept.append(np.asarray(img, np.float32).reshape(-1, 3)[pix])
        i += 1
    window_s = t_end - t_w0
    gc.enable()
    gc.unfreeze()
    if first_error:
        print(first_error, file=sys.stderr)
    banned = banned_modules()
    if banned:
        raise BannedModule(f"modules loaded by the run: {banned}")
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    power = power_limit_w() if cuda else None

    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(data)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        samples = sum(W * H * r.spp for r in done)
        e2e = dict(msamples_per_s=samples / window_s / 1e6 if done else 0.0,
                   render_p95_s=p95(lat) if lat else None, setup_s=setup_s)
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=float(e2e[m["name"]]),
                                          unit=m["unit"])

    scene = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    picks = check.pick_renders(seed, len(done), int(cell.correct["renders"]))
    got, ref = [], []
    for k in picks:
        got.append(kept[k])
        ref.append(check.reference_pixels(conf, done[k], pix, dev))
    limits = cell.correct["limits"]
    if got:
        numbers = check.compare(np.concatenate(got), np.concatenate(ref))
    else:
        numbers = {k: float("nan") for k in limits}
    correct = bool(got) and failed == 0 and check.judge(numbers, limits)
    q = np.percentile(lat, [0, 25, 50, 75, 100]) if lat else []
    print(f"portbench: {cell.name} seed {seed}: {len(done)} renders in "
          f"{window_s:.3f} s (render s min/q1/median/q3/max "
          f"{' '.join(f'{x:.4f}' for x in q)}), setup {setup_s:.3f} s, "
          f"check {len(picks)} renders x {len(pix)} pixels in "
          f"{time.perf_counter() - t_c:.1f} s", file=sys.stderr)

    dev_out = dict(platform="gpu" if cuda else dev.type, kind=name,
                   count=cell.chips, memory_peak_bytes=peak,
                   power_limit_w=power)
    result = dict(correct=correct, attempted=i, failed=failed,
                  metrics=metrics, device=dev_out)
    if traced and data.trace is not None:
        dev_out.update(busy_s=data.trace.busy_s(),
                       window_s=data.trace.window_s)
        result["breakdown"] = data.trace.breakdown()
        result["unmatched_kernels"] = unmatched(data.trace)
    checked = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    result["checked"] = checked
    return result, checked


def unmatched(tr: trace.Trace, share: float = 0.01) -> list:
    """[name, seconds] of every device operation with more than ``share``
    of the stretch's device time that no per-layer metric file's
    ``PATTERNS`` names."""
    with open(os.path.join(spec.root_of(), "BENCHMARK.json")) as f:
        bench = json.load(f)
    pats = []
    for m in bench["per_layer"]:
        pats += list(getattr(spec.metric_reader(m["name"]), "PATTERNS", ()))
    rows = tr.by_name()
    total = sum(s for _, s, _ in rows) or 1.0
    return [[n, s] for n, s, _ in rows
            if s > share * total and not any(p in n for p in pats)]


def _start_profile(torch, cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof, tempfile.mkdtemp(prefix="portbench-")


def _stop_profile(prof, tmp: str, parse: bool = True):
    prof.stop()
    path = os.path.join(tmp, "trace.json")
    try:
        if parse:
            prof.export_chrome_trace(path)
            return trace.from_file(path)
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="python3 portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 3
    try:
        result, checked = run(cell, a.seed, a.seconds, bool(a.trace),
                              "cuda", t_start=t_start)
    except BannedModule as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    unmatched_k = result.pop("unmatched_kernels", None)
    if unmatched_k is not None:
        print(json.dumps(dict(unmatched_kernels=unmatched_k)))
    for k, v in checked.items():
        print(f"checked {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
