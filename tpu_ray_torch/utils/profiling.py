"""Tracing hooks of the renderer: a profiler trace around a render,
per-wave wall times, the renderer's own spans and its counters.

Port of ``tpu_ray/utils/profiling.py``:

* :func:`profile_trace` wraps a block in a ``torch.profiler`` trace (CPU
  and, where there is a card, CUDA activities) and writes it into
  ``log_dir`` as a Chrome trace (``python -m tpu_ray_torch --profile DIR``;
  open it in ``chrome://tracing`` or Perfetto);
* :class:`WaveTimer` records per-wave wall times and prints a summary
  (``render(progress=True)``).

Added in the port:

* :func:`span` and :class:`Phase` mark the renderer's layers on the
  profiler's CPU timeline, which shares its clock with the CUDA kernels
  and copies, so each stretch of idle device time can be read against the
  span open over it.  They record only while a ``torch.profiler`` runs
  (``--profile DIR``, ``utils/profile.py``, ``portbench --trace 1``);
  otherwise a span is one flag test and a shared no-op.  A span is a
  ``cpu_op`` event named ``tpu_ray_torch.<name>`` (the profiler's fast
  record: a few microseconds where ``record_function`` takes ~15, and the
  category whose events ``portbench/trace.py`` keeps by name).  One
  thread, so spans nest; :data:`SPANS` lists every name.
* :func:`counts` is a snapshot of every counter the package keeps: each
  kernel wrapper's ``.launches`` and the work queue's path-vertex census
  (:data:`COUNTERS`).

``tpu_ray_torch/utils/profile.py`` is the other tool: it renders twice and
prints device time by kernel, the card's idle share and the counters.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import sys
import time
from typing import List

import torch

PREFIX = "tpu_ray_torch."
# every span the renderer opens: where it starts and ends
SPANS = {
    "render.setup": "renderer.render from its entry to the first iteration "
                    "of the loop it runs (a Phase; its children below)",
    "render.kernels": "the scene on the device (SceneData.to, a mesh's "
                      "copies), SceneKernels.create (the route's "
                      "BVHTables.create at a scene's first render), "
                      "build_bvh for bvh=True",
    "render.plan": "plan_queue / plan_pool, the chunk plan, the key words, "
                   "the pool's pixel grid and slot ids, the queue's epoch "
                   "cap and its plan's lookup (integrator.replay_key)",
    "render.config_tag": "_config_tag (the checkpoint tag's scene hash), "
                         "the checkpoint's path and film (loaded or zero)",
    "render.step_config": "StepConfig.create",
    "queue.init": "integrator._queue_init",
    "queue.read": "trace_queue's read of (frontier, active, census) once an "
                  "epoch, the progress callback and the exit test",
    "queue.iteration": "one dispatch of queue work: a queue_body call, or "
                       "an epoch's replay from integrator.QueuePlan's CUDA "
                       "graph (no span inside it)",
    "queue.compact": "queue_compact at a drain level",
    "render.finish": "from a queue call's or the pool's loop end to the "
                     "next call's first iteration or the image on the host "
                     "(a Phase)",
    "pool.read": "trace_pool_staged's read of the active count",
    "pool.iteration": "one pool iteration: closest hit and pool step",
}
# every counter of the package: name -> (module, function or class,
# attribute)
COUNTERS = {
    "sweep": ("ops.sweep", "sweep", "launches"),
    "sweep_compact": ("ops.sweep", "sweep_compact", "launches"),
    "list_pass": ("ops.sweep", "list_pass", "launches"),
    "sweep_masked": ("ops.sweep", "sweep_masked", "launches"),
    "sweep_sphere_mxu": ("ops.sweep", "sweep_sphere_mxu", "launches"),
    "pool_step": ("ops.shade", "pool_step", "launches"),
    "hit_scatter": ("ops.hit_scatter", "hit_scatter", "launches"),
    "megakernel": ("ops.megakernel", "trace_pool_mega", "launches"),
    "media": ("ops.intersect", "merge_media", "launches"),
    "path_ids": ("ops.queue", "path_ids", "launches"),
    "queue_inject": ("ops.queue", "queue_inject", "launches"),
    "bvh": ("ops.bvh", "intersect_bvh", "launches"),
    "aov": ("aov", "aov_features", "launches"),
    # the work queue (integrator.trace_queue): calls; path vertices, the sum
    # over iterations of the lanes active at the closest hit; lane slots,
    # the sum of the pool size over every dispatched iteration; iterations
    # dispatched, and of them those an epoch's replay ran
    "queue_calls": ("integrator", "QueueCounts", "calls"),
    "vertices": ("integrator", "QueueCounts", "vertices"),
    "lane_slots": ("integrator", "QueueCounts", "lane_slots"),
    "iterations": ("integrator", "QueueCounts", "iterations"),
    "replayed": ("integrator", "QueueCounts", "replayed"),
}
LAUNCHES = tuple(k for k, v in COUNTERS.items() if v[2] == "launches")

_enabled = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span ``tpu_ray_torch.<name>`` over a ``with`` block while a
    profiler runs, else the shared no-op."""
    if _enabled():
        return _record(PREFIX + name)
    return _NO_SPAN


class Phase:
    """The span of a render that begins in one function and ends in
    another (``render.setup`` ends inside the work queue's call, before its
    first iteration; ``render.finish`` begins after its loop).  At most one
    span is open: :meth:`begin` ends it first.  As a context manager it
    ends the open span on exit, an exception's too."""

    def __init__(self, name: str):
        self._open = None
        self.begin(name)

    def begin(self, name: str) -> None:
        self.end()
        if _enabled():
            rec = _record(PREFIX + name)
            rec.__enter__()
            self._open = rec

    def end(self) -> None:
        rec, self._open = self._open, None
        if rec is not None:
            rec.__exit__(None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()


def _holder(name: str):
    """The object that holds counter ``name``, and its attribute."""
    mod, fn, attr = COUNTERS[name]
    m = importlib.import_module(f"{__package__.rpartition('.')[0]}.{mod}")
    return getattr(m, fn), attr


def counts() -> dict:
    """A snapshot of every counter in :data:`COUNTERS`, by name."""
    out = {}
    for name in COUNTERS:
        holder, attr = _holder(name)
        out[name] = getattr(holder, attr)
    return out


def launch_counts() -> dict:
    """A snapshot of the launch counters (:data:`LAUNCHES`), by name."""
    return {k: getattr(*_holder(k)) for k in LAUNCHES}


def add_launches(delta: dict) -> None:
    """Add ``delta[name]`` to each launch counter it names: the launches a
    replayed CUDA graph ran, whose wrappers counted at its capture
    (``integrator.QueuePlan``)."""
    for name, n in delta.items():
        holder, attr = _holder(name)
        setattr(holder, attr, getattr(holder, attr) + n)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block, exported to
    ``<log_dir>/trace.json``, if ``log_dir`` is given; else a no-op."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", file=sys.stderr)


class WaveTimer:
    """Wall time per wave (the host's clock around each wave's work)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: List[float] = []
        self._t0 = None

    def start(self):
        if self.enabled:
            self._t0 = time.perf_counter()

    def stop(self):
        if self.enabled and self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> str:
        if not self.times:
            return "no waves timed"
        t = self.times
        return (f"{len(t)} waves: total {sum(t):.3f}s, "
                f"mean {sum(t) / len(t) * 1e3:.1f}ms, "
                f"min {min(t) * 1e3:.1f}ms, max {max(t) * 1e3:.1f}ms")
