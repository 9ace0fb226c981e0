"""The renderer's spans and counters (tpu_ray_torch.utils.profiling) on the
CPU: a span is the shared no-op without a profiler and a ``cpu_op`` event
named ``tpu_ray_torch.<name>`` under one; renders give the same bits with
and without a profiler, and their spans nest as documented; the work
queue's path-vertex census equals the sum of the active lanes at each
iteration's entry, whatever the lane count and epoch length; the lane
slots are the pool sizes dispatched; ``counts()`` holds every counter the
package keeps.  Small shapes: the file takes a few seconds."""
from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

from tpu_ray_torch import integrator
from tpu_ray_torch.core import rng
from tpu_ray_torch.integrator import SceneKernels, trace_queue
from tpu_ray_torch.models.scenes import SCENES
from tpu_ray_torch.renderer import render
from tpu_ray_torch.utils import profiling

PKG = os.path.dirname(os.path.abspath(profiling.__file__)).rsplit(os.sep,
                                                                  1)[0]
W = H = 16
KEY = rng.fold_in(rng.prng_key(5), 0x5EED)


@pytest.fixture(scope="module")
def smoke():
    spec = SCENES["cornell-smoke"]
    return spec.build(seed=1024, earth=None), spec.camera(W, H)


def _traced(fn, tmp_path):
    """(fn's result, the program's spans (name, start, end) in time order)
    from a CPU profiler's Chrome trace."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((e["name"][len(profiling.PREFIX):], e.get("cat"),
                     float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in events if e.get("ph") == "X"
                    and e.get("name", "").startswith(profiling.PREFIX)),
                   key=lambda s: s[2])
    assert {c for _, c, _, _ in spans} <= {"cpu_op"}
    return out, [(n, s, e) for n, _, s, e in spans]


def test_span_is_a_shared_noop_without_a_profiler(tmp_path):
    assert profiling.span("queue.read") is profiling.span("render.setup")
    with profiling.Phase("render.setup") as ph:
        assert ph._open is None

    def block():
        with profiling.span("queue.read"):
            torch.ones(4).sum()
        ph = profiling.Phase("render.setup")
        ph.begin("render.finish")
        ph.end()
        ph.end()
    _, spans = _traced(block, tmp_path)
    assert [n for n, _, _ in spans] == ["queue.read", "render.setup",
                                        "render.finish"]
    assert spans[1][2] <= spans[2][1]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_queue_render_same_bits_under_a_profiler_and_spans_nest(smoke,
                                                                tmp_path):
    scene, cam = smoke
    kw = dict(max_depth=6, mode="queue", device="cpu", seed=3)
    plain = render(scene, cam, W, H, 4, **kw)
    img, spans = _traced(lambda: render(scene, cam, W, H, 4, **kw), tmp_path)
    assert np.array_equal(plain, img)
    names = [n for n, _, _ in spans]
    assert set(names) <= set(profiling.SPANS)
    (setup,) = [s for s in spans if s[0] == "render.setup"]
    (finish,) = [s for s in spans if s[0] == "render.finish"]
    its = [s for s in spans if s[0] == "queue.iteration"]
    reads = [s for s in spans if s[0] == "queue.read"]
    assert its and reads and len(its) % 8 == 0
    for child in ("render.kernels", "render.plan", "render.config_tag",
                  "render.step_config", "queue.init"):
        inner = [s for s in spans if s[0] == child]
        assert inner and all(_within(sp, setup) for sp in inner), child
    assert setup[2] <= min(s[1] for s in its + reads)
    assert finish[1] >= max(s[2] for s in its + reads)
    # one thread: every pair of spans is nested or disjoint
    for a in spans:
        for b in spans:
            assert (_within(a, b) or _within(b, a) or a[2] <= b[1]
                    or b[2] <= a[1])


def test_pool_render_same_bits_under_a_profiler(smoke, tmp_path):
    scene, cam = smoke
    kw = dict(max_depth=6, mode="pool", device="cpu", seed=3)
    plain = render(scene, cam, W, H, 4, **kw)
    img, spans = _traced(lambda: render(scene, cam, W, H, 4, **kw), tmp_path)
    assert np.array_equal(plain, img)
    names = {n for n, _, _ in spans}
    assert {"render.setup", "render.plan", "render.step_config",
            "render.config_tag", "pool.read", "pool.iteration",
            "render.finish"} <= names
    (setup,) = [s for s in spans if s[0] == "render.setup"]
    assert setup[2] <= min(s[1] for s in spans if s[0] == "pool.iteration")


def _census(scene, cam, R, epoch_iters, drain, monkeypatch):
    """(image, census, lane slots, twin's census, twin's lane slots) of a
    two-sample chunk: the twin sums the active lanes and the pool size at
    each queue_body's entry."""
    twin = [0, 0]
    body = integrator.queue_body

    def counting(st, *a, **kw):
        twin[0] += int(st.istate[2].sum())
        twin[1] += st.work.shape[0]
        return body(st, *a, **kw)
    monkeypatch.setattr(integrator, "queue_body", counting)
    before = profiling.counts()
    img = trace_queue(scene, cam, W, H, 2, 1, KEY, 6, R, cam_salt=3,
                      epoch_iters=epoch_iters, drain_levels=drain,
                      kern=SceneKernels.create(scene))
    after = profiling.counts()
    monkeypatch.undo()
    assert after["queue_calls"] == before["queue_calls"] + 1
    return (img, after["vertices"] - before["vertices"],
            after["lane_slots"] - before["lane_slots"], *twin)


@pytest.mark.parametrize("R,epoch_iters,drain", [
    (512, 8, ()), (512, 3, (256, 64)), (200, 8, ()), (200, 3, (100,))])
def test_census_is_the_active_lanes_at_each_iteration(smoke, R, epoch_iters,
                                                       drain, monkeypatch):
    """The census equals the twin's sum at each entry, the lane slots the
    pool sizes dispatched, and both lane counts and both epoch lengths (with
    and without a drain ladder) count the same vertices and the same
    image."""
    scene, cam = smoke
    img, vertices, slots, twin_v, twin_s = _census(
        scene, cam, R, epoch_iters, drain, monkeypatch)
    ref, ref_v, _, _, _ = _census(scene, cam, 512, 8, (), monkeypatch)
    assert vertices == twin_v > W * H * 2
    assert slots == twin_s >= vertices
    assert vertices == ref_v
    assert torch.equal(img, ref)


def test_counts_holds_every_counter_of_the_package():
    """Each ``<function>.launches = 0`` in the package's sources is one
    entry of ``profiling.COUNTERS``, and ``counts()`` reads it live."""
    found = set()
    for d, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            mod = os.path.relpath(path, PKG)[:-3].replace(os.sep, ".")
            with open(path) as fh:
                for fn in re.findall(r"^(\w+)\.launches = 0$", fh.read(),
                                     re.M):
                    found.add((mod, fn))
    listed = {(m, fn) for m, fn, attr in profiling.COUNTERS.values()
              if attr == "launches"}
    assert found == listed and len(found) >= 13
    from tpu_ray_torch.ops import queue
    c0 = profiling.counts()
    queue.queue_inject.launches += 7
    try:
        assert profiling.counts()["queue_inject"] == c0["queue_inject"] + 7
    finally:
        queue.queue_inject.launches -= 7
    assert set(c0) == set(profiling.COUNTERS)
