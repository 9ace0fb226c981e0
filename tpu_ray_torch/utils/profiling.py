"""Tracing hooks of the renderer: a profiler trace around a render,
and per-wave wall times.

Port of ``tpu_ray/utils/profiling.py``:

* :func:`profile_trace` wraps a block in a ``torch.profiler`` trace (CPU
  and, where there is a card, CUDA activities) and writes it into
  ``log_dir`` as a Chrome trace (``python -m tpu_ray_torch --profile DIR``;
  open it in ``chrome://tracing`` or Perfetto);
* :class:`WaveTimer` records per-wave wall times and prints a summary
  (``render(progress=True)``).

``tpu_ray_torch/utils/profile.py`` is the other tool: it renders twice and
prints device time by kernel and the card's idle share.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import List


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block, exported to
    ``<log_dir>/trace.json``, if ``log_dir`` is given; else a no-op."""
    if not log_dir:
        yield
        return
    import torch
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
